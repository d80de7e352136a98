"""Seconds the job's thread spent in the program's ``chunk.dispatch`` spans
(the chunk's copy to the card and the step's launches) over the jobs'
input GB (1e9 bytes), from the program traces of a traced run's second
window, which runs under the harness's profiler."""


def read(r):
    gb = sum(j.stats["bytes_in"] for j in r.traced) / 1e9
    if r.trace is None or not gb or "chunk.dispatch" not in r.trace.span_s:
        return None
    return r.trace.span_s["chunk.dispatch"] / gb
