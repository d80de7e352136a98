"""CLI entry points of the port — the ``run``, ``coordinator``, ``worker``,
``service``, ``submit``, ``jobs``, ``merge`` and ``clean`` subcommands of
``python -m mapreduce_rust_tpu``, with the reference's flags for the
fields this package implements:

    python -m mapreduce_rust_tpu_torch run --input DIR --output DIR --work DIR
        [--app {word_count,inverted_index,grep,join,top_k,sort}]
        [--query w1,w2] [--k K] [--split-samples N]
        [--merge-capacity N] [--partial-capacity N]
        [--map-engine host [--host-workers N] [--fold-shards S]
         [--sync-dispatch] [--no-dispatch-coalesce] [--dispatch-fill F]]
        [--accum-budget-mb MB] [--dict-budget-words N] [--sync-spill]
    python -m mapreduce_rust_tpu_torch run --app join --input a=DIR b=DIR ...
    python -m mapreduce_rust_tpu_torch coordinator --worker-n N [--port P]
        [--speculate [--speculate-after-frac F]] [--metrics-port P] ...
    python -m mapreduce_rust_tpu_torch worker [--engine {device,host}]
        [--service] [--chaos SPEC] ...
    python -m mapreduce_rust_tpu_torch service [--max-jobs N]
        [--inflight-budget-mb MB] [--cache-entries N] [--metrics-port P]
        [--speculate [--speculate-after-frac F]] ...
    python -m mapreduce_rust_tpu_torch submit --app APP --input DIR
        [--priority P] [--wait [--wait-timeout S] [--interval S]] ...
    python -m mapreduce_rust_tpu_torch jobs [--json] [--port P]
    python -m mapreduce_rust_tpu_torch merge --output DIR [--app top_k --k K]
    python -m mapreduce_rust_tpu_torch clean --work DIR --output DIR

Every command takes ``--trace PATH`` and ``--manifest PATH``; the
coordinator, the service and the workers suffix them per process.
``run`` and ``worker`` (``--service`` too) map on the device engine by
default and then need a CUDA device unless ``--device cpu`` is given. The
``service``, ``submit`` and ``jobs`` processes never import torch.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
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
    p.add_argument("--chunk-mb", type=float, default=4.0)
    p.add_argument("--device", default="cuda", choices=list(DEVICES))
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1040)
    p.add_argument("--lease-timeout", type=float, default=5.0,
                   dest="lease_timeout",
                   help="seconds before an unrenewed task lease expires and "
                   "the task re-executes (coordinator + workers must agree)")
    p.add_argument("--lease-check-period", type=float, default=5.0,
                   dest="lease_check_period",
                   help="coordinator lease-detector scan period (seconds)")
    p.add_argument("--renew-period", type=float, default=1.0,
                   dest="renew_period",
                   help="worker lease-renewal period (seconds)")
    p.add_argument("--poll-retry", type=float, default=1.0,
                   dest="poll_retry",
                   help="worker base sleep on the -2/-3 sentinels (seconds), "
                   "backing off up to 4x")
    p.add_argument("--sched", default="fifo", choices=["fifo", "pipeline"],
                   help="fifo: a global map barrier; pipeline: reduce task r "
                   "is granted once every map task reported bytes for "
                   "partition r. Coordinator and workers must agree")
    p.add_argument("--trace", default=None, metavar="PATH", dest="trace",
                   help="write a Chrome trace-event JSON of the job (Perfetto "
                   "/ chrome://tracing)")
    p.add_argument("--manifest", default=None, metavar="PATH", dest="manifest",
                   help="write the machine-readable run manifest (config, "
                   "platform, git rev, JobStats, phase times, trace path)")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="deterministic fault injection (analysis/chaos.py "
                   "grammar), e.g. 'kill:map:*' or "
                   "'seed=7;pause:map:0:2.0;kill:reduce:1'. Sites: pause, "
                   "kill, drop_finish, delay_finish, wedge_renewal, "
                   "slow_scan. MR_CHAOS in the environment overrides")
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


#: Config fields of the flags that only some subcommands define:
#: field → (argparse dest, True where the flag negates the field). A
#: subcommand without the flag leaves the field at Config's own default.
_SUBCOMMAND_FIELDS = {
    "merge_capacity": ("merge_capacity", False),
    "partial_capacity": ("partial_capacity", False),
    "map_engine": ("map_engine", False),
    "host_map_workers": ("host_workers", False),
    "fold_shards": ("fold_shards", False),
    "dispatch_async": ("sync_dispatch", True),
    "dispatch_coalesce": ("no_dispatch_coalesce", True),
    "dispatch_fill_frac": ("dispatch_fill", False),
    "host_accum_budget_mb": ("accum_budget_mb", False),
    "dictionary_budget_words": ("dict_budget_words", False),
    "spill_async": ("sync_spill", True),
    "speculate": ("speculate", False),
    "speculate_after_frac": ("speculate_after_frac", False),
    "metrics_port": ("metrics_port", False),
    "service_max_jobs": ("max_jobs", False),
    "service_inflight_budget_mb": ("inflight_budget_mb", False),
    "service_cache_entries": ("cache_entries", False),
}


def _cfg(args, worker_n: int = 1) -> Config:
    """Config of a command's flags; the callers set ``map_n`` from the
    resolved inputs."""
    chaos = args.chaos
    if chaos:
        from mapreduce_rust_tpu_torch.analysis.chaos import ChaosPlan

        try:
            ChaosPlan.parse(chaos)  # a typo'd spec is a usage error
        except ValueError as e:
            _usage_error(args, e)
    input_dir, input_dirs = _parse_inputs(args)
    present = {field: (not getattr(args, dest)) if negated else getattr(args, dest)
               for field, (dest, negated) in _SUBCOMMAND_FIELDS.items()
               if hasattr(args, dest)}
    return Config(
        map_n=1,
        reduce_n=args.reduce_n,
        worker_n=worker_n,
        split_samples=args.split_samples,
        chunk_bytes=int(args.chunk_mb * (1 << 20)),
        device=args.device,
        **present,
        trace_path=args.trace,
        manifest_path=args.manifest,
        host=args.host,
        port=args.port,
        lease_timeout_s=args.lease_timeout,
        lease_check_period_s=args.lease_check_period,
        lease_renew_period_s=args.renew_period,
        poll_retry_s=args.poll_retry,
        sched=args.sched,
        chaos=chaos,
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


def _arm_crash_dump(args) -> None:
    """CLI processes that trace also dump their flight-recorder snapshot on
    atexit/SIGTERM — installed here (not in library code) so embedded use
    and tests never have their signal handlers stolen."""
    if args.trace:
        from mapreduce_rust_tpu_torch.runtime.trace import install_crash_dump

        install_crash_dump()


def _arm_worker_drain(worker) -> None:
    """SIGTERM = graceful drain for a CLI worker: finish the current task,
    report it, deregister, exit 0 (the flight-recorder snapshot still
    happens). A SECOND SIGTERM falls through to the default disposition.
    Installed only by the CLI — embedded workers keep their own signal
    handling."""
    import signal

    from mapreduce_rust_tpu_torch.runtime.trace import active_tracer

    def _on_term(signum, frame):
        tr = active_tracer()
        if tr is not None:
            try:
                tr.maybe_snapshot(force=True)
            except Exception:
                pass  # draining must not die on a telemetry error
        worker.request_drain()
        signal.signal(signum, signal.SIG_DFL)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass  # not the main thread: drain stays reachable via request_drain()


def cmd_run(args) -> int:
    from mapreduce_rust_tpu_torch.runtime.chunker import resolve_corpora
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    _arm_crash_dump(args)
    cfg = _cfg(args)
    inputs, bounds, _names = resolve_corpora(cfg)
    cfg = dataclasses.replace(cfg, map_n=max(len(inputs), 1))
    res = run_job(cfg, inputs, app=_app(args), corpus_bounds=bounds)
    print(res.stats.summary())
    print(f"outputs: {', '.join(res.output_files)}")
    return 0


def cmd_coordinator(args) -> int:
    from mapreduce_rust_tpu_torch.coordinator.server import Coordinator
    from mapreduce_rust_tpu_torch.runtime.chunker import resolve_corpora

    _arm_crash_dump(args)
    cfg = _cfg(args, worker_n=args.worker_n)
    inputs, _bounds, _names = resolve_corpora(cfg)
    if not inputs:
        dirs = ", ".join(d for _n, d in cfg.corpora())
        print(f"no inputs matching {args.pattern} in {dirs}", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(cfg, map_n=len(inputs))
    asyncio.run(Coordinator(cfg).serve())
    return 0


def cmd_worker(args) -> int:
    from mapreduce_rust_tpu_torch.runtime.chunker import resolve_corpora
    from mapreduce_rust_tpu_torch.worker.runtime import ServiceWorker, Worker

    _arm_crash_dump(args)
    cfg = _cfg(args)
    inputs, _bounds, _names = resolve_corpora(cfg)
    # A classic worker against an empty dir registers and exits with the
    # job; a service worker's app/inputs/dirs arrive per job from the
    # service's job_spec RPC, so --app/--input only seed its idle baseline.
    cfg = dataclasses.replace(cfg, map_n=max(len(inputs), 1))
    if args.service:
        worker = ServiceWorker(cfg, engine=args.engine)
    else:
        worker = Worker(cfg, app=_app(args), engine=args.engine)
    _arm_worker_drain(worker)
    asyncio.run(worker.run())
    return 0


def cmd_service(args) -> int:
    """Long-lived multi-job service: job submission RPCs, N concurrent
    jobs over a shared worker fleet, admission control, result cache,
    graceful drain. SIGTERM = drain (stop admitting, finish running jobs,
    journal the queue for restart). Imports no torch."""
    import signal

    from mapreduce_rust_tpu_torch.service.server import JobService

    _arm_crash_dump(args)
    svc = JobService(_cfg(args))

    async def go() -> None:
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(signal.SIGTERM, svc.request_drain)
        except (NotImplementedError, RuntimeError):
            pass  # non-Unix / nested loop: drain stays reachable via RPC
        await svc.serve()

    asyncio.run(go())
    return 0


def _service_spec(args) -> dict:
    """Job spec from the submit CLI's flags — the submit_job payload."""
    app_args: dict = {}
    if args.app == "top_k":
        app_args["k"] = args.k
    elif args.app == "grep":
        app_args["query"] = [w for w in args.query.split(",") if w]
    input_dir, input_dirs = _parse_inputs(args)
    spec = {
        "app": args.app,
        "app_args": app_args,
        "input_dir": input_dir,
        "input_pattern": args.pattern,
        "reduce_n": args.reduce_n,
        # Output-determining for range apps (splitter derivation input):
        # rides the spec so the whole fleet samples identically.
        "split_samples": args.split_samples,
    }
    if input_dirs:
        # Multi-corpus submission: the ordered (name, dir) list rides the
        # spec; the service digests every corpus.
        spec["inputs"] = [[n, d] for n, d in input_dirs]
    return spec


def cmd_submit(args) -> int:
    """``submit``: one job into a running service. Prints the submission
    result as one JSON line; ``--wait`` polls job_status until the job
    settles (done/failed/cancelled) and prints the final status too.
    Exit 0 = submitted (and, with --wait, completed), 1 = rejected or
    failed, 2 = no service."""
    import json

    from mapreduce_rust_tpu_torch.coordinator.server import (
        CoordinatorClient,
        RpcTimeout,
    )

    spec = _service_spec(args)

    async def go() -> int:
        client = CoordinatorClient(args.host, args.port, timeout_s=10.0)
        try:
            await client.connect(retries=args.connect_retries, delay=0.2)
        except (OSError, RpcTimeout) as e:
            print(f"submit: no service at {args.host}:{args.port} ({e})",
                  file=sys.stderr)
            return 2
        try:
            res = await client.call("submit_job", spec, args.priority)
            print(json.dumps(res, sort_keys=True), flush=True)
            if not isinstance(res, dict) or not res.get("ok"):
                return 1
            if not args.wait:
                return 0
            jid = res["job"]
            deadline = (
                asyncio.get_running_loop().time() + args.wait_timeout
            )
            while True:
                st = await client.call("job_status", jid)
                state = st.get("state") if isinstance(st, dict) else None
                if state in ("done", "failed", "cancelled"):
                    print(json.dumps(st, sort_keys=True), flush=True)
                    return 0 if state == "done" else 1
                if asyncio.get_running_loop().time() > deadline:
                    print(f"submit: {jid} still {state} after "
                          f"{args.wait_timeout}s", file=sys.stderr)
                    return 1
                await asyncio.sleep(args.interval)
        except (ConnectionError, RpcTimeout) as e:
            print(f"submit: service went away ({e})", file=sys.stderr)
            return 2
        finally:
            await client.close()

    return asyncio.run(go())


def cmd_jobs(args) -> int:
    """``jobs``: the service-wide queue/running/done table (one
    ``list_jobs`` call; ``--json`` prints the raw RPC response)."""
    import json

    from mapreduce_rust_tpu_torch.coordinator.server import (
        CoordinatorClient,
        RpcTimeout,
    )
    from mapreduce_rust_tpu_torch.runtime.telemetry import format_jobs

    async def go() -> int:
        client = CoordinatorClient(args.host, args.port, timeout_s=10.0)
        try:
            await client.connect(retries=args.connect_retries, delay=0.2)
        except (OSError, RpcTimeout) as e:
            print(f"jobs: no service at {args.host}:{args.port} ({e})",
                  file=sys.stderr)
            return 1
        try:
            view = await client.call("list_jobs")
        except (ConnectionError, RpcTimeout) as e:
            print(f"jobs: service went away ({e})", file=sys.stderr)
            return 1
        finally:
            await client.close()
        if args.json:
            print(json.dumps(view, sort_keys=True))
        else:
            print(format_jobs(view))
        return 0

    return asyncio.run(go())


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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mapreduce_rust_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="single-process end-to-end job (CUDA path)")
    _add_common(p)
    p.add_argument("--merge-capacity", type=int, default=Config.merge_capacity,
                   dest="merge_capacity", metavar="N",
                   help="distinct records the device state holds before it "
                   "evicts to the host (default 2^21); outputs identical")
    p.add_argument("--partial-capacity", type=int, default=None,
                   dest="partial_capacity", metavar="N",
                   help="per-chunk distinct keys before a chunk replays "
                   "full-width (default chunk bytes / 8); outputs identical")
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
                   default=Config.dispatch_fill_frac, dest="dispatch_fill",
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

    p = sub.add_parser("coordinator", help="control-plane scheduler")
    _add_common(p)
    p.add_argument("--worker-n", type=int, default=1, dest="worker_n")
    p.add_argument("--metrics-port", type=int, default=Config.metrics_port,
                   dest="metrics_port",
                   help="serve Prometheus text exposition (GET /metrics) on "
                   "this port; 0 (default) = off")
    p.add_argument("--speculate", action="store_true",
                   help="speculative re-execution: near phase end, re-issue "
                   "the slowest in-flight task to an idle worker — first "
                   "finish wins (outputs stay identical)")
    p.add_argument("--speculate-after-frac", type=float,
                   default=Config.speculate_after_frac,
                   dest="speculate_after_frac",
                   help="fraction of a phase's tasks done before speculation "
                   "arms (default 0.75)")
    p.set_defaults(fn=cmd_coordinator)

    p = sub.add_parser("worker", help="pull-based worker process")
    _add_common(p)
    p.add_argument("--engine", default="device", choices=["device", "host"],
                   help="device (default): the device engine, the CUDA scan "
                   "kernel per chunk; host: the native scan maps each file")
    p.add_argument("--service", action="store_true",
                   help="join a multi-job service fleet: pull job-tagged "
                   "tasks across every running job (app/inputs/dirs come "
                   "per job from the service's job_spec RPC; --app/--input "
                   "here only seed the idle baseline)")
    p.set_defaults(fn=cmd_worker)

    p = sub.add_parser(
        "service",
        help="long-lived multi-job service: submission queue, N concurrent "
        "jobs over one worker fleet, admission control, result cache, "
        "graceful drain (SIGTERM)",
    )
    _add_common(p)
    p.add_argument("--max-jobs", type=int, default=Config.service_max_jobs,
                   dest="max_jobs",
                   help="concurrent RUNNING jobs; further submissions queue "
                   "FIFO within priority (default 3)")
    p.add_argument("--inflight-budget-mb", type=float,
                   default=Config.service_inflight_budget_mb,
                   dest="inflight_budget_mb",
                   help="admission budget: total input MiB across running "
                   "jobs — a job that would exceed it stays queued (the live "
                   "doctor reports service-saturated). Default 256")
    p.add_argument("--cache-entries", type=int,
                   default=Config.service_cache_entries, dest="cache_entries",
                   help="result-cache capacity (LRU, keyed on app + corpus "
                   "digest + config digest; 0 = off): a repeated identical "
                   "submission is served with zero new task grants. "
                   "Default 64")
    p.add_argument("--metrics-port", type=int, default=Config.metrics_port,
                   dest="metrics_port",
                   help="Prometheus endpoint (GET /metrics) with per-job "
                   "job=<id> labels; 0 (default) = off")
    p.add_argument("--speculate", action="store_true",
                   help="per-job speculative re-execution (the coordinator "
                   "flag, applied to every admitted job)")
    p.add_argument("--speculate-after-frac", type=float,
                   default=Config.speculate_after_frac,
                   dest="speculate_after_frac",
                   help="fraction of a phase done before speculation arms")
    p.set_defaults(fn=cmd_service)

    p = sub.add_parser(
        "submit",
        help="submit one job to a running service (prints the job id; "
        "--wait polls until it settles)",
    )
    _add_common(p)
    p.add_argument("--priority", type=int, default=0,
                   help="admission priority (higher admits first; FIFO "
                   "within a priority). Default 0")
    p.add_argument("--wait", action="store_true",
                   help="poll job_status until done/failed/cancelled and "
                   "print the final status (exit 0 only on done)")
    p.add_argument("--wait-timeout", type=float, default=600.0,
                   dest="wait_timeout",
                   help="--wait deadline in seconds (default 600)")
    p.add_argument("--interval", type=float, default=0.5,
                   help="--wait poll period in seconds (default 0.5)")
    p.add_argument("--connect-retries", type=int, default=5,
                   dest="connect_retries")
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser(
        "jobs", help="service-wide queue/running/done table (one list_jobs call)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=Config.port)
    p.add_argument("--json", action="store_true",
                   help="print the raw list_jobs RPC response")
    p.add_argument("--connect-retries", type=int, default=5,
                   dest="connect_retries")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_jobs)

    p = sub.add_parser("merge", help="mr-*.txt → final.txt")
    _add_common(p)
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser("clean", help="remove intermediates and outputs")
    _add_common(p)
    p.set_defaults(fn=cmd_clean)
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    args._parser = parser
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
