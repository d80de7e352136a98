"""CLI entry points of the port — the ``run`` and ``merge`` subcommands of
``python -m mapreduce_rust_tpu``, with the reference's flags for the
fields this package implements:

    python -m mapreduce_rust_tpu_torch run --input DIR --output DIR --work DIR
        [--map-engine host [--host-workers N] [--fold-shards S]
         [--sync-dispatch] [--no-dispatch-coalesce] [--dispatch-fill F]]
    python -m mapreduce_rust_tpu_torch merge --output DIR

``run`` needs a CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

from mapreduce_rust_tpu_torch.config import DEVICES, Config


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input", default="data", metavar="DIR",
                   help="input corpus directory")
    p.add_argument("--pattern", default="*.txt")
    p.add_argument("--output", default="mr-out")
    p.add_argument("--work", default="mr-work")
    p.add_argument("--app", default="word_count", choices=["word_count"])
    p.add_argument("--reduce-n", type=int, default=4)
    p.add_argument("-v", "--verbose", action="store_true")


def _cfg(args) -> Config:
    return Config(
        reduce_n=args.reduce_n,
        chunk_bytes=int(args.chunk_mb * (1 << 20)),
        device=args.device,
        map_engine=args.map_engine,
        host_map_workers=args.host_workers,
        fold_shards=args.fold_shards,
        dispatch_async=not args.sync_dispatch,
        dispatch_coalesce=not args.no_dispatch_coalesce,
        dispatch_fill_frac=args.dispatch_fill,
        input_dir=args.input,
        input_pattern=args.pattern,
        work_dir=args.work,
        output_dir=args.output,
    )


def _app(args):
    from mapreduce_rust_tpu_torch.apps import get_app

    return get_app(args.app)


def cmd_run(args) -> int:
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    res = run_job(_cfg(args), app=_app(args))
    print(res.stats.summary())
    print(f"outputs: {', '.join(res.output_files)}")
    return 0


def cmd_merge(args) -> int:
    app = _app(args)
    lines: list[bytes] = []
    files = sorted(glob.glob(os.path.join(args.output, "mr-*.txt")))
    for path in files:
        with open(path, "rb") as f:
            lines.extend(f.read().splitlines())
    out = os.path.join(args.output, "final.txt")
    with open(out, "wb") as f:
        for line in app.merge_lines(lines):
            f.write(line + b"\n")
    print(f"{out}: {len(files)} partitions merged")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="mapreduce_rust_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="single-process end-to-end job (CUDA path)")
    _add_common(p)
    p.add_argument("--chunk-mb", type=float, default=4.0)
    p.add_argument("--device", default="cuda", choices=list(DEVICES))
    p.add_argument("--map-engine", default="device", choices=["device", "host"],
                   dest="map_engine",
                   help="device: tokenize/combine on the card; host: the fused "
                   "native scan maps on the host, the card merges")
    p.add_argument("--host-workers", type=int, default=None, dest="host_workers",
                   help="host engine scan threads (default: usable cores minus "
                   "one); outputs are identical for any value")
    p.add_argument("--fold-shards", type=int, default=None, dest="fold_shards",
                   help="host engine egress-fold shards (default: 1 below 4 "
                   "usable cores, else min(4, cores//2)); outputs identical")
    p.add_argument("--sync-dispatch", action="store_true", dest="sync_dispatch",
                   help="host engine: run the merge dispatch inline on the "
                   "router thread (MR_DISPATCH_SYNC=1 does the same)")
    p.add_argument("--no-dispatch-coalesce", action="store_true",
                   dest="no_dispatch_coalesce",
                   help="host engine: every window dispatches its own merges")
    p.add_argument("--dispatch-fill", "--dispatch-fill-frac", type=float,
                   default=0.5, dest="dispatch_fill",
                   help="host engine: staging fill fraction that triggers a "
                   "coalesced merge (default 0.5)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("merge", help="mr-*.txt → final.txt")
    _add_common(p)
    p.set_defaults(fn=cmd_merge)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
