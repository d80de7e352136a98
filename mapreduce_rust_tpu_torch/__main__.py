"""CLI entry points of the port — the ``run``, ``merge`` and ``clean``
subcommands of ``python -m mapreduce_rust_tpu``, with the reference's
flags for the fields this package implements:

    python -m mapreduce_rust_tpu_torch run --input DIR --output DIR --work DIR
        [--app {word_count,inverted_index,grep,join,top_k,sort}]
        [--query w1,w2] [--k K] [--split-samples N]
        [--merge-capacity N] [--partial-capacity N]
        [--map-engine host [--host-workers N] [--fold-shards S]
         [--sync-dispatch] [--no-dispatch-coalesce] [--dispatch-fill F]]
        [--accum-budget-mb MB] [--dict-budget-words N] [--sync-spill]
    python -m mapreduce_rust_tpu_torch run --app join --input a=DIR b=DIR ...
    python -m mapreduce_rust_tpu_torch merge --output DIR [--app top_k --k K]
    python -m mapreduce_rust_tpu_torch clean --work DIR --output DIR

``run`` needs a CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

from mapreduce_rust_tpu_torch.config import DEVICES, Config

#: The registry's names, kept here so that parsing imports no app module.
_APP_NAMES = ("grep", "inverted_index", "join", "sort", "top_k", "word_count")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input", nargs="+", default=["data"], metavar="DIR",
                   help="input corpus: one directory, or N named corpora as "
                   "name=DIR pairs (e.g. --input a=left-dir b=right-dir; join "
                   "needs exactly two; corpora are ordered by name)")
    p.add_argument("--pattern", default="*.txt")
    p.add_argument("--output", default="mr-out")
    p.add_argument("--work", default="mr-work")
    p.add_argument("--app", default="word_count", choices=list(_APP_NAMES))
    p.add_argument("--k", type=int, default=20, help="top_k selection size")
    p.add_argument("--query", default="",
                   help="grep: comma-separated words to search for")
    p.add_argument("--split-samples", type=int, default=512,
                   dest="split_samples", metavar="N",
                   help="range apps (sort): tokens the seeded splitter "
                   "pre-pass samples per input file (default 512)")
    p.add_argument("--reduce-n", type=int, default=4)
    p.add_argument("-v", "--verbose", action="store_true")


def _usage_error(args, e: ValueError):
    """A bad --input or --query is an argparse usage error (exit 2), not a
    traceback from inside the job."""
    parser = getattr(args, "_parser", None)
    if parser is not None:
        parser.error(str(e))
    raise e


def _parse_inputs(args) -> tuple:
    """``--input`` → (input_dir, input_dirs)."""
    from mapreduce_rust_tpu_torch.runtime.chunker import parse_input_spec

    try:
        return parse_input_spec(args.input)
    except ValueError as e:
        _usage_error(args, e)


def _cfg(args) -> Config:
    input_dir, input_dirs = _parse_inputs(args)
    return Config(
        reduce_n=args.reduce_n,
        split_samples=args.split_samples,
        chunk_bytes=int(args.chunk_mb * (1 << 20)),
        merge_capacity=args.merge_capacity,
        partial_capacity=args.partial_capacity,
        device=args.device,
        map_engine=args.map_engine,
        host_map_workers=args.host_workers,
        fold_shards=args.fold_shards,
        dispatch_async=not args.sync_dispatch,
        dispatch_coalesce=not args.no_dispatch_coalesce,
        dispatch_fill_frac=args.dispatch_fill,
        host_accum_budget_mb=args.accum_budget_mb,
        dictionary_budget_words=args.dict_budget_words,
        spill_async=not args.sync_spill,
        input_dir=input_dir,
        input_dirs=input_dirs,
        input_pattern=args.pattern,
        work_dir=args.work,
        output_dir=args.output,
    )


def _app(args):
    from mapreduce_rust_tpu_torch.apps import get_app

    if args.app == "top_k":
        return get_app(args.app, k=args.k)
    if args.app == "grep":
        from mapreduce_rust_tpu_torch.apps.grep import _query_keys

        query = tuple(w for w in args.query.split(",") if w)
        try:
            _query_keys(query)  # validate at parse time
        except ValueError as e:
            _usage_error(args, e)
        return get_app(args.app, query=query)
    return get_app(args.app)


def cmd_run(args) -> int:
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    cfg = _cfg(args)
    res = run_job(cfg, app=_app(args))
    print(res.stats.summary())
    print(f"outputs: {', '.join(res.output_files)}")
    return 0


def cmd_merge(args) -> int:
    """``cat mr-* | sort > final.txt`` through ``app.merge_lines``, which
    selects across partitions for top_k."""
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


def cmd_clean(args) -> int:
    """Remove a job's intermediates and outputs (reference src/clean.sh):
    spill runs (``accrun-*``, ``dictrun-*``, and what the reference's
    other engines leave in a work dir) and ``mr-*.txt`` / ``final.txt``."""
    removed = 0
    journal = os.path.join(args.work, "coordinator.journal")
    if os.path.exists(journal):
        os.remove(journal)
        removed += 1
    for pattern in ("mr-*.npz", "dict-*", "driver.ckpt*", "accrun-*",
                    "dictrun-*", "job_report.json"):
        for p in glob.glob(os.path.join(args.work, pattern)):
            os.remove(p)
            removed += 1
    for pattern in ("mr-*.txt", "final.txt"):
        for p in glob.glob(os.path.join(args.output, pattern)):
            os.remove(p)
            removed += 1
    print(f"removed {removed} files")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="mapreduce_rust_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="single-process end-to-end job (CUDA path)")
    _add_common(p)
    p.add_argument("--chunk-mb", type=float, default=4.0)
    p.add_argument("--merge-capacity", type=int, default=Config.merge_capacity,
                   dest="merge_capacity", metavar="N",
                   help="distinct records the device state holds before it "
                   "evicts to the host (default 2^21); outputs identical")
    p.add_argument("--partial-capacity", type=int, default=None,
                   dest="partial_capacity", metavar="N",
                   help="per-chunk distinct keys before a chunk replays "
                   "full-width (default chunk bytes / 8); outputs identical")
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
    p.add_argument("--accum-budget-mb", type=int, default=None,
                   dest="accum_budget_mb",
                   help="host accumulator RAM budget (MiB); above it, sorted "
                   "runs go to --work and finalize streams (exact)")
    p.add_argument("--dict-budget-words", type=int, default=None,
                   dest="dict_budget_words",
                   help="egress dictionary RAM budget (words); above it, "
                   "sorted runs go to --work and finalize streams")
    p.add_argument("--sync-spill", action="store_true", dest="sync_spill",
                   help="write spill runs inline on their owner thread instead "
                   "of the background writer (outputs identical; "
                   "MR_SPILL_SYNC=1 does the same)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("merge", help="mr-*.txt → final.txt")
    _add_common(p)
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser("clean", help="remove intermediates and outputs")
    _add_common(p)
    p.set_defaults(fn=cmd_clean)

    args = parser.parse_args(argv)
    args._parser = parser
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
