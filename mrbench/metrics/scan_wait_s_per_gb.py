"""Sum of the jobs' ``JobStats.scan_wait_s`` (the host-map router blocked on
the oldest scan of the pool) over their input GB (1e9 bytes); None where
the program keeps no such field."""


def read(r):
    gb = sum(j.stats["bytes_in"] for j in r.done) / 1e9
    if not gb or any("scan_wait_s" not in j.stats for j in r.done):
        return None
    return sum(j.stats["scan_wait_s"] for j in r.done) / gb
