#!/usr/bin/env python3
"""Time the token-hash scan kernel's entries on one CUDA card, and split
their device time by GPU kernel with torch.profiler.

    python3 kernel_profile.py [--root DIR]

``--root`` names the checkout whose ``mapreduce_rust_tpu_torch`` is
measured (default: this one), so one call can hold two commits side by
side on the same card. For each entry the checkout has (``hash_scan``
always, ``tokenize_hash`` where it exists) on a seeded random chunk of
4 MiB (the main path's chunk), it prints one JSON line with:

- ``graph_ms``: 20 calls replayed from one CUDA graph (device only);
- ``eager_ms``: 20 calls back to back from the host;
- ``split``: every GPU activity the profiler saw over 20 eager calls
  (kernels and memsets), with its device µs per wrapper call.

Then the card's ``nvidia-smi`` name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from chip_smoke import emit, nvidia_smi_line, time_ms  # noqa: E402

REPS = 20


def device_split(fn, reps: int) -> list[dict]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append({"name": e.key[:100], "count": e.count,
                         "us_per_call": us / reps})
    return sorted(rows, key=lambda r: -r["us_per_call"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_profile: no CUDA device visible", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from mapreduce_rust_tpu_torch.ops import tokenize_cuda as tc

    n = 4 << 20
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (n,), dtype=torch.uint8, generator=gen).cuda()
    entries = {"hash_scan": lambda: tc.hash_scan(x)}
    if hasattr(tc, "tokenize_hash"):
        entries["tokenize_hash"] = lambda: tc.tokenize_hash(x, True)
    for name, fn in entries.items():
        emit({"entry": name, "root": str(root), "n_bytes": n,
              "graph_ms": time_ms(fn, warmup=5, reps=REPS, graph=True),
              "eager_ms": time_ms(fn, warmup=5, reps=REPS),
              "split": device_split(fn, REPS)})
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
