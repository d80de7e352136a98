"""The token-hash scan kernel's share of its memory roofline, in percent:
the least time the traced window's scan work needs at the card's published
memory bandwidth, per launch, over the kernel's mean time per launch in
the device trace. The work is counted from the jobs' bytes
(counting.scan_bytes: each byte read once, an 8-byte key written per
token) and spread over the jobs' chunks; the kernel is the fused entry,
``scan_kernel<true>`` (csrc/hash_scan.cu)."""

from mrbench.counting import scan_bytes
from mrbench.peaks import peak

KERNEL = "scan_kernel<true>"


def read(r):
    bw = peak(r.kind, "hbm_bytes_per_s")
    if r.trace is None or bw is None or not r.traced:
        return None
    rows = [v for name, v in r.trace.ops.items() if KERNEL in name]
    launches = sum(n for n, _s in rows)
    seconds = sum(s for _n, s in rows)
    chunks = sum(j.stats["chunks"] for j in r.traced)
    if not launches or not seconds or not chunks:
        return None
    need = sum(scan_bytes(j.nbytes, r.tokens(j)) for j in r.traced) / chunks / bw
    return 100.0 * need / (seconds / launches)
