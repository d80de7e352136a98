"""Share of the traced window in which no kernel, copy or memset ran on
the card (the harness's torch.profiler trace)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return 1.0 - r.trace.busy_s / r.trace.window_s
