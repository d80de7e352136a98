"""Sum of the jobs' finalize and egress phase seconds over their input GB
(1e9 bytes)."""


def read(r):
    gb = sum(j.stats["bytes_in"] for j in r.done) / 1e9
    if not gb:
        return None
    return sum(j.stats["phase_seconds"].get("finalize", 0.0)
               + j.stats["phase_seconds"].get("egress", 0.0) for j in r.done) / gb
