"""Sum of the jobs' ``JobStats.coalesce_s`` (the dispatch thread's sort and
native staging combine) over their input GB (1e9 bytes); None where the
program keeps no such field."""


def read(r):
    gb = sum(j.stats["bytes_in"] for j in r.done) / 1e9
    if not gb or any("coalesce_s" not in j.stats for j in r.done):
        return None
    return sum(j.stats["coalesce_s"] for j in r.done) / gb
