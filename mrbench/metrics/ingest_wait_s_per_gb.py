"""Sum of the jobs' ``JobStats.ingest_wait_s`` over their input GB (1e9 bytes)."""


def read(r):
    gb = sum(j.stats["bytes_in"] for j in r.done) / 1e9
    return sum(j.stats["ingest_wait_s"] for j in r.done) / gb if gb else None
