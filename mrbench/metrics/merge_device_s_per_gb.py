"""Sum of the jobs' ``JobStats.merge_device_s`` (the card's seconds in the
packed merges, from a CUDA event pair around each) over their input GB
(1e9 bytes); None where the program keeps no such field, and where every
job reads 0.0, as on the CPU, where no event is made."""


def read(r):
    gb = sum(j.stats["bytes_in"] for j in r.done) / 1e9
    if not gb or any("merge_device_s" not in j.stats for j in r.done):
        return None
    s = sum(j.stats["merge_device_s"] for j in r.done)
    return s / gb if s > 0 else None
