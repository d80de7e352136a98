"""Input GB (1e9 bytes) of every job of the window over the window's wall
seconds, first job's start to last job's end (host clock)."""


def read(r):
    if r.window_s <= 0 or not r.done:
        return None
    return sum(j.nbytes for j in r.done) / r.window_s / 1e9
