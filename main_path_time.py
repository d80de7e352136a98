#!/usr/bin/env python3
"""Time the device-engine main path of one checkout on one CUDA card.

    python3 main_path_time.py [--root DIR] [--corpus DIR] [--out FILE]

Runs ``run_job`` with the default Config (device engine, 4 MiB chunks,
reduce_n=8) of the ``mapreduce_rust_tpu_torch`` package found at ``--root``
(default: this checkout; e.g. a ``git archive`` of another commit unpacked
into the gitignored ``_parent/``) on chip_smoke.py's seeded 256 MiB Zipf
corpus, checks every output line against the generator's counts, and
prints one JSON line: wall, stream/finalize/egress seconds, host ms per
4 MiB chunk, device wait, scan-kernel launches. ``--corpus`` keeps the
corpus in DIR (written once, with its counts) so several runs in one call
share it. Run two checkouts in turns (A, B, B, A) within one call to
compare them on one card and host.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--corpus", default=None)
    parser.add_argument("--out", default=None, help="append the JSON line here too")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("main_path_time: no CUDA device visible", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # the corpus generator and the exactness check

    corpus = pathlib.Path(args.corpus or tempfile.mkdtemp(prefix="zipf-"))
    truth_file = corpus / "truth.npy"
    if not truth_file.exists():
        corpus.mkdir(parents=True, exist_ok=True)
        np.save(truth_file, cs.write_zipf_corpus(corpus))
    truth = np.load(truth_file)

    sys.path.insert(0, str(root))
    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.ops.tokenize_cuda import tokenize_hash
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    work = pathlib.Path(tempfile.mkdtemp(prefix="main-path-"))
    cfg = Config(input_dir=str(corpus), input_pattern="part-*.txt",
                 output_dir=str(work / "out"), work_dir=str(work / "work"), reduce_n=8)
    tokenize_hash.launches = 0
    t0 = time.perf_counter()
    res = run_job(cfg)
    wall = time.perf_counter() - t0
    s = res.stats
    cs.check(s.unknown_keys == 0 and s.hash_collisions == 0, "unknown keys or collisions")
    lines = cs.check_zipf_outputs(res.output_files, truth)
    row = {"root": str(root), "exact": True, "output_lines": lines, "wall_s": wall,
           "phase_seconds": s.phase_seconds, "chunks": s.chunks,
           "host_ms_per_chunk": s.phase_seconds["stream"] / s.chunks * 1e3,
           "device_wait_s": s.device_wait_s, "ingest_wait_s": s.ingest_wait_s,
           "fold_s": getattr(s, "fold_s", None),
           "tokenize_hash_launches": tokenize_hash.launches,
           "card": cs.nvidia_smi_line()}
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
