"""Seconds from the process's start to the first timed job: imports, the
card's start, the pool, the kernel libraries, the warm-up job."""


def read(r):
    return r.setup_s
