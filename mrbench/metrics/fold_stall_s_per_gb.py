"""Sum of the jobs' ``JobStats.fold_stall_s`` (the host-map router blocked
on full fold-shard queues, and the fold threads' end-of-stream join) over
their input GB (1e9 bytes); None where the program keeps no such field."""


def read(r):
    gb = sum(j.stats["bytes_in"] for j in r.done) / 1e9
    if not gb or any("fold_stall_s" not in j.stats for j in r.done):
        return None
    return sum(j.stats["fold_stall_s"] for j in r.done) / gb
