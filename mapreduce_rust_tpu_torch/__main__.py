"""CLI entry points of the port — the ``run``, ``coordinator``, ``worker``,
``service``, ``submit``, ``jobs``, ``merge`` and ``clean`` subcommands of
``python -m mapreduce_rust_tpu`` and its analysis commands (``stats``,
``doctor``, ``trace``, ``watch``, ``prof``, ``lineage``, ``fleet``,
``check``, ``model``, ``lint``), with
the reference's flags for the fields this package implements:

    python -m mapreduce_rust_tpu_torch run --input DIR --output DIR --work DIR
        [--app {word_count,inverted_index,grep,join,top_k,sort}]
        [--query w1,w2] [--k K] [--split-samples N]
        [--merge-capacity N] [--partial-capacity N]
        [--map-engine host [--host-workers N] [--fold-shards S]
         [--sync-dispatch] [--no-dispatch-coalesce] [--dispatch-fill F]]
        [--accum-budget-mb MB] [--dict-budget-words N] [--sync-spill]
        [--profile [--profile-hz HZ]] [--profile-dir DIR] [--lineage]
        [--mesh D [--sharded | --checkpoint-every N] [--resume]]
        [--distributed --coordinator HOST:PORT --num-processes N
         --process-id R [--dist-backend {nccl,gloo}]]
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
    python -m mapreduce_rust_tpu_torch stats M.json [M2.json [--no-gate]]
    python -m mapreduce_rust_tpu_torch doctor M.json [--trace T] [--job-report R]
    python -m mapreduce_rust_tpu_torch trace merge OUT T1.json [T2.json ...]
    python -m mapreduce_rust_tpu_torch watch [--once] [--json] [--job ID]
    python -m mapreduce_rust_tpu_torch prof M.json [--folded OUT] [--roofline]
    python -m mapreduce_rust_tpu_torch lineage WORK [--forward C] [--backward R]
    python -m mapreduce_rust_tpu_torch fleet SERVICE_ROOT
    python -m mapreduce_rust_tpu_torch check WORK [--trace T] [--format json]
    python -m mapreduce_rust_tpu_torch model [--focus {lease,pipeline,service}]
        [--budget N] [--depth N] [--seed S] [--mutate CLASS]
    python -m mapreduce_rust_tpu_torch lint [PATH ...] [--format json]
        [--baseline B [--strict-baseline]] [--check-trace T]

Every job command takes ``--trace PATH`` and ``--manifest PATH``; the
coordinator, the service and the workers suffix them per process.
``run`` and ``worker`` (``--service`` too) map on the device engine by
default and then need a CUDA device unless ``--device cpu`` is given. The
``service``, ``submit`` and ``jobs`` processes and every analysis command
never import torch: their handlers import lazily and reach no module of
``apps/``, ``ops/`` or ``runtime/driver.py``.
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
    "profile": ("profile", False),
    "profile_hz": ("profile_hz", False),
    "profile_dir": ("profile_dir", False),
    "lineage": ("lineage", False),
    "mesh_shape": ("mesh", False),
    "sharded_stream": ("sharded", False),
    "checkpoint_every_groups": ("checkpoint_every", False),
    "resume": ("resume", False),
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
    if args.distributed:
        # Before the job touches the card: the process group picks the
        # card's backend (NCCL) unless --dist-backend says otherwise.
        from mapreduce_rust_tpu_torch.parallel.distributed import initialize

        initialize(args.coordinator, args.num_processes, args.process_id,
                   backend=args.dist_backend, device=cfg.device)
    try:
        inputs, bounds, _names = resolve_corpora(cfg)
        cfg = dataclasses.replace(cfg, map_n=max(len(inputs), 1))
        res = run_job(cfg, inputs, app=_app(args), corpus_bounds=bounds)
    finally:
        if args.distributed:
            from mapreduce_rust_tpu_torch.parallel.distributed import shutdown

            shutdown()
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


def cmd_stats(args) -> int:
    """Pretty-print a run manifest — or, with a second path, diff two
    (numeric fields with deltas): the BENCH round-over-round comparison
    without scraping log tails. The diff also runs the doctor's
    watched-metric regression gate (a -> b, a is the baseline): exit 3
    when a watched metric regressed beyond its threshold, so CI can gate
    on `stats old.json new.json`. --threshold-scale loosens/tightens every
    threshold; --no-gate restores the unconditional exit 0."""
    from mapreduce_rust_tpu_torch.runtime.telemetry import (
        diff_manifests,
        format_manifest,
        load_manifest,
    )

    a = load_manifest(args.manifest)
    if args.other is None:
        print(format_manifest(a))
        return 0
    b = load_manifest(args.other)
    lines = diff_manifests(a, b)
    if not lines:
        print(f"{args.manifest} and {args.other}: no differences")
        return 0
    print(f"diff {args.manifest} -> {args.other}:")
    for line in lines:
        print(line)
    if getattr(args, "no_gate", False):
        return 0
    from mapreduce_rust_tpu_torch.analysis.doctor import compare_manifests

    regressions = compare_manifests(
        a, b, threshold_scale=getattr(args, "threshold_scale", 1.0)
    )
    if regressions:
        print(f"REGRESSIONS ({len(regressions)} watched metric(s)):")
        for r in regressions:
            chg = "new" if r["change"] is None else f"{r['change']:+.1%}"
            print(
                f"  {r['metric']}: {r['baseline']} -> {r['current']} "
                f"[{chg}, threshold {r['threshold']:.0%} {r['direction']}]"
            )
        return 3
    return 0


def cmd_doctor(args) -> int:
    """Automated run diagnosis: bottleneck attribution, latency
    percentiles, skew + straggler detection, lease advice, crash
    forensics, and a --baseline regression gate. Backend-free, like every
    analysis tool."""
    from mapreduce_rust_tpu_torch.analysis.doctor import run_cli

    return run_cli(args)


def cmd_trace(args) -> int:
    """``trace merge <out> <traces...>``: stitch per-process trace files
    (flight-recorder partials included) onto one timeline — the
    coordinator's clock when RPC offsets exist, the wall clock otherwise —
    and write a single Perfetto-loadable file. Backend-free."""
    from mapreduce_rust_tpu_torch.runtime.trace import merge_traces

    if args.action != "merge":
        print(f"unknown trace action {args.action!r}", file=sys.stderr)
        return 2
    import json

    try:
        summary = merge_traces(args.out, args.traces,
                               out_format=getattr(args, "format", "json"))
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
        print(f"trace merge: {e}", file=sys.stderr)
        return 1
    procs = summary["processes"]
    print(
        f"{summary['out']}: {summary['events']} events from "
        f"{len(procs)} process(es) over {summary['span_s']:.3f}s "
        f"(reference: {summary['reference']})"
    )
    for p in procs:
        flag = " [partial]" if p["partial"] else ""
        print(f"  pid {p['pid']:>7}  {p['tag']:<12} clock={p['clock_domain']}"
              f"{flag}  {p['path']}")
    return 0


def cmd_watch(args) -> int:
    """Live plain-text job view: polls the coordinator's ``stats`` RPC at
    ``--interval`` (default 1 Hz) and repaints per-phase progress + lease
    liveness until the job completes or the coordinator goes away.
    ``--doctor`` adds the streaming doctor's live findings + fleet
    samples (the ``metrics`` RPC); ``--json`` streams one machine-readable
    NDJSON object per poll instead of the TUI (``--once --json`` is the
    scripting form: one object, exit)."""
    import json
    import time as _time

    from mapreduce_rust_tpu_torch.coordinator.server import CoordinatorClient, RpcTimeout
    from mapreduce_rust_tpu_torch.runtime.telemetry import format_jobs, format_progress

    job = getattr(args, "job", None)

    async def go() -> int:
        client = CoordinatorClient(
            args.host, args.port, timeout_s=max(args.interval * 5, 3.0)
        )
        try:
            await client.connect(retries=args.connect_retries, delay=0.2)
        except (OSError, RpcTimeout) as e:
            print(f"watch: no coordinator at {args.host}:{args.port} ({e})",
                  file=sys.stderr)
            return 1
        as_json = getattr(args, "json", False)
        clear = sys.stdout.isatty() and not args.once and not as_json
        # Against a JobService: --job <id> polls that job's status (the
        # coordinator stats shape — the classic renderer applies);
        # without an id the service-wide queue/running/done table
        # renders. A pre-service coordinator answers "unknown method" to
        # the probe and the classic stats loop takes over.
        service_mode = False
        if job is None:
            try:
                await client.call("list_jobs")
                service_mode = True
            except RuntimeError as e:
                if "unknown method" not in str(e):
                    raise
            except (ConnectionError, RpcTimeout):
                print("watch: coordinator gone — job finished or stopped")
                await client.close()
                return 0
        try:
            while True:
                try:
                    if job is not None:
                        rep = await client.call("job_status", job)
                    elif service_mode:
                        rep = await client.call("list_jobs")
                    else:
                        rep = await client.call("stats")
                    live = (
                        await client.call("metrics")
                        if getattr(args, "doctor", False) else None
                    )
                except RpcTimeout as e:
                    # Alive-but-not-answering is the wedge the RPC
                    # timeouts exist to expose — it must never render as
                    # "job finished" (exit 0).
                    print(f"watch: coordinator not answering — wedged? ({e})",
                          file=sys.stderr)
                    return 1
                except (ConnectionError, RuntimeError) as e:
                    if isinstance(e, RuntimeError):
                        if "unknown method" not in str(e):
                            raise
                        if job is not None:
                            # --job against a pre-service coordinator:
                            # there is no job_status RPC to poll — error
                            # out once, never spin on the unknown-method
                            # reply.
                            print("watch: coordinator has no job_status "
                                  "RPC — not a job service (drop --job)",
                                  file=sys.stderr)
                            return 2
                        # --doctor against a pre-metrics coordinator:
                        # degrade to the plain view, loudly once.
                        print("watch: coordinator predates the metrics RPC "
                              "— --doctor unavailable", file=sys.stderr)
                        args.doctor = False
                        continue
                    print("watch: coordinator gone — job finished or stopped")
                    return 0
                if job is not None and isinstance(rep, dict) \
                        and rep.get("ok") is False:
                    print(f"watch: {rep.get('error')}", file=sys.stderr)
                    return 2
                if as_json:
                    # One NDJSON object per poll: everything the TUI
                    # renders, machine-readable for external tooling.
                    row = {"t": round(_time.time(), 3), "stats": rep}
                    if live is not None:
                        row["metrics"] = live
                    print(json.dumps(row, sort_keys=True), flush=True)
                else:
                    if service_mode and job is None:
                        text = format_jobs(rep)
                    elif job is not None and "progress" not in rep:
                        # Queued/cached/done service job: no live
                        # coordinator state to render — the summary row
                        # says everything.
                        text = json.dumps(rep, sort_keys=True, indent=2)
                    else:
                        text = (f"job {job} [{rep.get('state')}]\n"
                                if job is not None else "") \
                            + format_progress(rep)
                    if live is not None:
                        from mapreduce_rust_tpu_torch.analysis.doctor import format_live

                        text += "\n" + format_live(live, rep)
                    print(("\x1b[H\x1b[2J" + text) if clear else text,
                          flush=True)
                if job is not None:
                    done = rep.get("state") in ("done", "failed",
                                                "cancelled")
                elif service_mode:
                    sv = rep.get("service") or {}
                    done = sv.get("draining") and not sv.get("running")
                else:
                    done = (rep.get("progress") or {}).get("done")
                if args.once or done:
                    return 0
                await asyncio.sleep(args.interval)
        finally:
            await client.close()

    return asyncio.run(go())


def cmd_prof(args) -> int:
    """mrprof: render a manifest's sampling profile (per-plane
    self-time split, top frames), export its collapsed stacks as a
    .folded file, and attach roofline attribution (achieved-vs-roof per
    stage from the .bench/machine.json calibration). Torch-free, like
    every analysis command."""
    from mapreduce_rust_tpu_torch.analysis.roofline import run_cli

    return run_cli(args)


def cmd_lineage(args) -> int:
    """mrlineage: provenance queries + recompute blast radius
    over a run's lineage ledger. Torch-free, like every analysis
    command: reads jsonl/manifest/partial artifacts only."""
    from mapreduce_rust_tpu_torch.analysis.lineage import run_cli

    return run_cli(args)


def cmd_fleet(args) -> int:
    """Fleet profiler: cross-job utilization timeline,
    barrier-bubble accounting, pipelining opportunity. Torch-free, like
    every analysis command: joins on-disk artifacts, never dials a
    server."""
    from mapreduce_rust_tpu_torch.runtime.fleet import run_cli

    return run_cli(args)


def cmd_lint(args) -> int:
    """mrlint: the framework-invariant static analyzer (analysis/lint.py,
    rules.py, dataflow.py). Pure ast + stdlib — torch-free like every
    analysis command, so it runs in any process in milliseconds;
    tests/test_torch_lint_clean.py gates tier-1 on exit 0. Exit 0 clean,
    1 findings, 2 config error."""
    from mapreduce_rust_tpu_torch.analysis.lint import run_cli

    return run_cli(args)


def cmd_check(args) -> int:
    """mrcheck: protocol conformance + happens-before race detection over
    a run's control-plane artifacts (journal, job report, merged trace).
    Torch-free, like every analysis command."""
    from mapreduce_rust_tpu_torch.analysis.mrcheck import run_cli

    return run_cli(args)


def cmd_model(args) -> int:
    """mrmodel: exhaustive bounded exploration of control-plane schedules
    — the port's Coordinator/JobService under a virtual clock — with DPOR
    pruning, fault injection at every step, and counterexample shrinking
    to a chaos-grammar repro. Torch-free, like every analysis command."""
    from mapreduce_rust_tpu_torch.analysis.mrmodel import run_cli

    return run_cli(args)


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
    p.add_argument("--mesh", type=int, default=None, metavar="D",
                   help="shards of the 1-D mesh (shard i on cuda:(i %% the "
                   "card count); D > 1 runs the mesh driver, which tokenizes "
                   "on the device whatever --map-engine says)")
    p.add_argument("--sharded", action="store_true", dest="sharded",
                   help="with --mesh: sequence-parallel ingestion — the byte "
                   "stream is cut at arbitrary offsets across the shards and "
                   "a halo exchange reconstructs straddling tokens")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   dest="checkpoint_every", metavar="N",
                   help="with --mesh: write an atomic data-plane checkpoint "
                   "every N groups (work dir driver.ckpt.*)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the work dir's driver checkpoint when "
                   "it matches this job's fingerprint")
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
    p.add_argument("--profile", action="store_true",
                   help="in-process sampling profiler (runtime/prof.py): "
                   "one thread walks sys._current_frames() at ~97 Hz, "
                   "collapsed stacks keyed by plane-thread names, into "
                   "the manifest as stats.profile + a .folded export "
                   "beside it; inspect with the `prof` subcommand "
                   "(MR_PROFILE=1 for a process tree)")
    p.add_argument("--profile-hz", type=float, default=Config.profile_hz,
                   dest="profile_hz", metavar="HZ",
                   help="sampler rate (default 97 — prime, never "
                   "phase-locks with periodic work)")
    p.add_argument("--profile-dir", default=None, dest="profile_dir",
                   metavar="DIR",
                   help="write a torch.profiler Chrome trace of the stream "
                   "phase into DIR, with the card's kernels and copies")
    p.add_argument("--lineage", action="store_true",
                   help="chunk-level provenance ledger (runtime/"
                   "lineage.py): per-chunk content digests + partition "
                   "routing to {work}/lineage.jsonl, summarized in the "
                   "manifest as stats.lineage; query with the `lineage` "
                   "subcommand. Observational only — outputs are "
                   "byte-identical (MR_LINEAGE=1 for a process tree)")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed process group before the "
                   "job; the mesh's shards then split over the processes and "
                   "its all_to_all crosses them")
    p.add_argument("--coordinator", default="127.0.0.1:12321",
                   help="--distributed: rendezvous address host:port")
    p.add_argument("--num-processes", type=int, default=1, dest="num_processes")
    p.add_argument("--process-id", type=int, default=0, dest="process_id")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   dest="dist_backend",
                   help="--distributed: collective backend (default nccl on "
                   "the card, gloo with --device cpu; ranks that share one "
                   "card need gloo)")
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

    p = sub.add_parser(
        "lint",
        help="mrlint: framework-invariant static analysis of the source tree",
    )
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the installed package, "
                   "tests/, bench_torch.py and __graft_entry_torch__.py)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="json: one machine-readable document (findings + "
                   "suppression accounting) for CI diffs")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="suppression file (.mrlint.json is auto-loaded from "
                   "the CWD when present): {\"suppressions\": [{\"rule\", "
                   "\"path\", \"reason\"}]} — every entry needs a reason")
    p.add_argument("--check-trace", default=None, metavar="TRACE",
                   dest="check_trace",
                   help="validate a written Chrome trace file instead of "
                   "linting source (span nesting, B/E balance, counter "
                   "value types)")
    p.add_argument("--strict-baseline", action="store_true",
                   dest="strict_baseline",
                   help="promote unused baseline entries from a warning to "
                   "exit 1 — stale suppressions must not accumulate (an "
                   "unused entry will happily swallow a real finding at "
                   "that path later)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser(
        "fleet",
        help="fleet profiler: cross-job per-worker busy/idle timeline, "
        "barrier-bubble accounting and pipelining opportunity from a "
        "service root (service.journal + job-*/) or a single workdir",
    )
    p.add_argument("target",
                   help="service work root (service.journal + job-* dirs) "
                   "or a single-job work dir (job_report.json)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="json: the full fleet report for CI diffs")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="prior fleet report (JSON): exit 1 when "
                   "fleet_bubble_frac regressed beyond the guard band")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="text format: print every timeline interval")
    p.set_defaults(fn=cmd_fleet)

    p = sub.add_parser(
        "check",
        help="mrcheck: lease/attempt protocol conformance + happens-before "
        "race detection over a run's control-plane artifacts",
    )
    p.add_argument("target",
                   help="work dir (coordinator.journal + job_report.json), "
                   "or a coordinator manifest / job_report.json")
    p.add_argument("--trace", default=None, metavar="TRACE",
                   help="merged (or per-process) trace: enables the "
                   "happens-before race detector and the flow-terminator "
                   "conformance check")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="explicit coordinator.journal path (default: "
                   "resolved from the work dir / manifest config)")
    p.add_argument("--job-report", default=None, metavar="PATH",
                   dest="job_report",
                   help="explicit job_report.json path")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="json: the full conformance document for CI diffs")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser(
        "model",
        help="mrmodel: exhaustive bounded control-plane schedule "
        "exploration (real coordinator/service logic under a virtual "
        "clock), DPOR-pruned, with counterexample shrinking and "
        "chaos-grammar repro export",
    )
    p.add_argument("--budget", type=int, default=5000,
                   help="maximum complete schedules to explore "
                   "(default 5000)")
    p.add_argument("--depth", type=int, default=12,
                   help="maximum events per schedule (default 12)")
    p.add_argument("--seed", type=int, default=0,
                   help="rotation seed: which subtrees a truncated budget "
                   "reaches first (the explored SET under an exhaustive "
                   "budget is seed-independent)")
    p.add_argument("--focus", choices=["pipeline", "lease", "service"],
                   default="lease",
                   help="which control-plane surface to explore: lease = "
                   "fifo + speculation + expiry races, pipeline = "
                   "per-partition readiness, service = multi-job "
                   "queue/cancel lifecycle (default lease)")
    p.add_argument("--mutate", default=None, metavar="CLASS",
                   help="mutation-teeth mode: arm this mrcheck.MUTATIONS "
                   "class as a seeded fault event and search for a "
                   "schedule whose corrupted artifacts the invariant "
                   "catalog flags (exit 1 + shrunk counterexample = the "
                   "checker has teeth)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="json: the full model document for CI diffs")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_model)

    p = sub.add_parser(
        "prof",
        help="mrprof: render a run's sampling profile (per-plane "
        "self-time, top frames), export collapsed stacks for "
        "flamegraph.pl/speedscope, and attach roofline attribution "
        "(achieved-vs-roof per stage)",
    )
    p.add_argument("manifest",
                   help="run manifest (stats.profile) or a flight-recorder "
                   "*.partial.json (its embedded live profile)")
    p.add_argument("--folded", default=None, metavar="OUT",
                   help="write the collapsed stacks as a .folded file "
                   "(flamegraph.pl / speedscope both load it)")
    p.add_argument("--roofline", action="store_true",
                   help="attach per-stage achieved-vs-roof attribution; "
                   "calibrates .bench/machine.json on first use (host "
                   "memcpy micro-probe; device peaks only when CUDA is "
                   "already initialized in the process)")
    p.add_argument("--machine", default=None, metavar="PATH",
                   help="calibration file (default .bench/machine.json)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="json: the full document for CI diffs")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_prof)

    p = sub.add_parser(
        "lineage",
        help="mrlineage: chunk-level provenance queries over a run's "
        "lineage.jsonl — forward (chunk → partitions), backward "
        "(partition → chunks + attempt chain), and `lineage diff "
        "<old> <new>` recompute blast radius (memo_hit_frac)",
    )
    p.add_argument("target", nargs="+",
                   help="a lineage.jsonl, a work dir holding one, a run "
                   "manifest (stats.lineage), or a flight-recorder "
                   "*.partial.json (its embedded tail) — or the literal "
                   "'diff' followed by two such targets (old, new)")
    p.add_argument("--forward", default=None, metavar="CHUNK",
                   help="forward query: ledger seq or digest prefix → "
                   "the reduce partitions the chunk contributed to")
    p.add_argument("--backward", default=None, metavar="R", type=int,
                   help="backward query: reduce partition → contributing "
                   "chunks (digests, bytes, docs) + attempt chain; "
                   "exit 2 when the set is empty")
    p.add_argument("--stamp", action="store_true",
                   help="(diff) write memo_hit_frac / blast radius into "
                   "the NEW target's manifest stats.lineage block — the "
                   "doctor's incremental-opportunity finding cites it")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="json: the full document for CI diffs")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_lineage)

    p = sub.add_parser("stats", help="pretty-print a run manifest, or diff two")
    p.add_argument("manifest", help="manifest.json of a run")
    p.add_argument("other", nargs="?", default=None,
                   help="second manifest: print a field-level diff and run "
                   "the watched-metric regression gate (exit 3 on a "
                   "regression; manifest = baseline, other = current)")
    p.add_argument("--threshold-scale", type=float, default=1.0,
                   dest="threshold_scale",
                   help="multiply every watched-metric threshold "
                   "(analysis/doctor.WATCHED_METRICS) by this factor; "
                   "2.0 = twice as tolerant, 0.5 = twice as strict")
    p.add_argument("--no-gate", action="store_true", dest="no_gate",
                   help="diff only — always exit 0, as before the gate")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser(
        "doctor",
        help="automated run diagnosis: bottleneck attribution, latency "
        "percentiles, skew/straggler/lease findings, regression gate",
    )
    p.add_argument("manifest", nargs="?", default=None,
                   help="run (or coordinator/bench) manifest to "
                   "diagnose — or the literal 'trend' to analyze a bench "
                   "history for sustained drift (omit with --live)")
    p.add_argument("--live", default=None, metavar="HOST:PORT",
                   help="streaming doctor against a RUNNING coordinator: "
                   "poll its stats+metrics RPCs and print findings as "
                   "they first appear, until the job completes")
    p.add_argument("--job", default=None, metavar="ID",
                   help="with --live against a multi-job service: stream "
                   "ONE job's view (its job_status RPC; findings filtered "
                   "to that job plus the service-plane codes)")
    p.add_argument("--interval", type=float, default=1.0,
                   help="--live poll period in seconds (default 1.0)")
    p.add_argument("--once", action="store_true",
                   help="--live: print one snapshot and exit")
    p.add_argument("history", nargs="?", default=None,
                   help="with 'trend': the history file (default "
                   ".bench/history.jsonl) — exit 1 on sustained drift of a "
                   "watched series (slope + last-vs-median over --window "
                   "rounds), the regression class the pairwise gate misses")
    p.add_argument("--window", type=int, default=8,
                   help="trend: rounds to analyze (default 8)")
    p.add_argument("--drift-threshold", type=float, default=0.10,
                   dest="drift_threshold",
                   help="trend: relative drift across the window that "
                   "counts as sustained (default 0.10)")
    p.add_argument("--trace", default=None, metavar="TRACE",
                   help="trace file (merged or per-process, partials "
                   "accepted): enables attempt-chain crash forensics")
    p.add_argument("--job-report", default=None, metavar="REPORT",
                   dest="job_report",
                   help="job_report.json (or a manifest embedding one): "
                   "enables straggler/lease/re-execution analysis")
    p.add_argument("--baseline", default=None, metavar="MANIFEST2",
                   help="prior run's manifest: compare watched metrics and "
                   "exit 1 when one regressed beyond threshold (CI gate)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   help="json: the full diagnosis document for CI diffs")
    p.add_argument("--straggler-factor", type=float, default=2.0,
                   dest="straggler_factor",
                   help="flag workers whose task p50 exceeds this multiple "
                   "of the fleet median (default 2.0)")
    p.add_argument("--threshold-scale", type=float, default=1.0,
                   dest="threshold_scale",
                   help="scale every --baseline threshold (2.0 = twice as "
                   "tolerant)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser(
        "trace",
        help="trace-file tooling: merge per-process traces onto one timeline",
    )
    p.add_argument("action", choices=["merge"],
                   help="merge: stitch trace files (partials included) onto "
                   "the coordinator clock and write one Perfetto-loadable "
                   "timeline")
    p.add_argument("--format", choices=["json", "perfetto"], default="json",
                   dest="format",
                   help="json (default): Chrome trace-event JSON; "
                   "perfetto: binary track_event protobuf (.pftrace, "
                   "hand-rolled varint writer, no deps) — for >100 MB "
                   "timelines the JSON loader chokes on")
    p.add_argument("out", help="output path for the merged trace")
    p.add_argument("traces", nargs="+",
                   help="per-process trace files (trace-coord.json, "
                   "trace-w*.json, *.partial.json, driver traces)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "watch",
        help="live plain-text job view against a running coordinator "
        "(polls the stats RPC)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1040)
    p.add_argument("--job", default=None, metavar="ID",
                   help="against a multi-job service: watch ONE job "
                   "(its job_status view); without it a service renders "
                   "the queue/running/done table instead of single-job "
                   "progress")
    p.add_argument("--interval", type=float, default=1.0,
                   help="poll period in seconds (default 1 Hz)")
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit (scripting/tests); "
                   "--once --json is the scripting form: one "
                   "machine-readable object on stdout, exit 0")
    p.add_argument("--json", action="store_true",
                   help="stream one NDJSON object per poll ({t, stats"
                   "[, metrics]}) instead of the TUI — external tooling "
                   "consumes exactly what the TUI shows")
    p.add_argument("--doctor", action="store_true",
                   help="streaming doctor: append the coordinator's live "
                   "findings (straggler, lease advice, skew, bottleneck "
                   "attribution — with first-seen timestamps) and the "
                   "fleet's renewal-envelope samples to every poll")
    p.add_argument("--connect-retries", type=int, default=5,
                   dest="connect_retries")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_watch)
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
