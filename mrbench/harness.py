"""One run of one cell: set-up, the measured window, the check of every
job's answer against the plain reference, the metrics and the result line.

The window drives the port only through its public entry,
``mapreduce_rust_tpu_torch.runtime.driver.run_job``: one client submits
one job after another (a closed loop), each job one input file of the
pool, until ``seconds`` have passed since the first job started; the job
running then finishes and counts. The window runs from the first job's
start to the last job's end.

Every run measures that window with nothing traced; the end-to-end
metrics and the per-layer metrics that the program's counters and the
host's clock give come from it. A traced run then goes on with a second,
shorter window (``TRACED_SHARE`` of ``seconds``) under the harness's
profiler and the program's own spans, and reads the metrics of the device
trace and of the spans from that one alone, so the profiler's cost never
reaches the first window's readings.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

from mrbench import devtrace, pool as pool_mod

PACKAGE = pathlib.Path(__file__).resolve().parent
#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "mapreduce_rust_tpu")
#: Length of a traced run's second window, as a share of ``--seconds``.
TRACED_SHARE = 1 / 3
#: The keys a traffic mix may hold; a key nothing reads is refused.
TRAFFIC_KEYS = {"why", "job_bytes", "pool_files", "warmup_bytes"}


class Refused(RuntimeError):
    """The run prints no result and exits with a non-zero code."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _for_cell(metrics: list, workload: str) -> list:
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def load_cell(root: str, workload: str) -> Cell:
    """The cell called ``workload`` of ``<root>/BENCHMARK.json``, with its
    configuration file and ``<root>/mrbench/traffic/<mix>.json``."""
    rootp = pathlib.Path(root)
    with open(rootp / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    with open(rootp / files[w["config"]]) as f:
        config = json.load(f)
    with open(rootp / "mrbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    unknown = sorted(set(traffic) - TRAFFIC_KEYS)
    if unknown:
        raise Refused(f"traffic {w['traffic']!r}: the harness reads no {unknown}")
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=_for_cell(bench["end_to_end"], workload),
                per_layer=_for_cell(bench["per_layer"], workload))


@dataclasses.dataclass
class Job:
    index: int
    file: int          # index of the pool file it read
    path: str
    nbytes: int
    t0: float          # perf_counter at submission
    t1: float          # perf_counter when run_job returned or raised
    output_dir: str
    trace_path: "str | None"
    stats: "dict | None"   # JobStats fields; None when the job raised
    error: "str | None"

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Readings:
    """What a metric reader reads: the window's jobs, the times the harness
    took, and in a traced run the second window's jobs and device trace."""
    jobs: list
    window_s: float
    setup_s: float
    trace: "devtrace.DeviceTrace | None"
    kind: str
    traced_jobs: list = dataclasses.field(default_factory=list)
    _tokens: dict = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> list:
        """The window's jobs that returned."""
        return [j for j in self.jobs if j.stats is not None]

    @property
    def traced(self) -> list:
        """The traced window's jobs that returned."""
        return [j for j in self.traced_jobs if j.stats is not None]

    def tokens(self, job: Job) -> int:
        """Tokens in the job's input, counted from its bytes."""
        if job.path not in self._tokens:
            import numpy as np

            from mrbench.counting import count_tokens

            self._tokens[job.path] = count_tokens(np.fromfile(job.path, dtype=np.uint8))
        return self._tokens[job.path]


def read_metric(name: str, readings: Readings):
    """``mrbench/metrics/<name>.py``'s ``read(readings)``: a number, or None
    where the run holds nothing to read."""
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mrbench.metrics.{name}", path)
    if spec is None or spec.loader is None:
        raise Refused(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(readings)


def stats_dict(stats) -> dict:
    """The JobStats fields a reader may use: numbers, strings, the phase
    seconds and the per-partition bytes."""
    out = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, (int, float, str)) or f.name in ("phase_seconds",
                                                          "partition_bytes"):
            out[f.name] = v if not isinstance(v, (dict, list)) else type(v)(v)
    return out


def leaked_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def check_answers(cell: Cell, pool, jobs: list) -> tuple[dict, int]:
    """The numbers compared over every job, each with its limit, and the
    failed jobs."""
    ref = importlib.import_module(f"mrbench.reference.{cell.config['app']}")
    reduce_n = int(cell.config["program"]["reduce_n"])
    raised = [j for j in jobs if j.error is not None]
    done = [j for j in jobs if j.error is None]
    wants: dict = {}
    bad_jobs = 0
    totals = {"mismatched_lines": 0, "unknown_keys": 0, "hash_collisions": 0}
    for j in done:
        if j.file not in wants:
            ids, counts = pool.truth[j.file]
            wants[j.file] = ref.expected(pool.words, pool.parts, ids, counts, reduce_n)
        bad = ref.mismatched_lines(ref.read_outputs(j.output_dir, reduce_n), wants[j.file])
        unknown, coll = int(j.stats["unknown_keys"]), int(j.stats["hash_collisions"])
        totals["mismatched_lines"] += bad
        totals["unknown_keys"] += unknown
        totals["hash_collisions"] += coll
        bad_jobs += int(bad > 0 or unknown > 0 or coll > 0)
    checks = {"jobs_raised": {"value": len(raised), "limit": 0}}
    checks.update({k: {"value": v, "limit": 0} for k, v in totals.items()})
    checks["jobs_checked"] = {"value": len(done), "min": 1}
    return checks, len(raised) + bad_jobs


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if "limit" in c else c["value"] >= c["min"]
               for c in checks.values())


def run_window(run_job, cfg_for, app, pool, seconds: float, mark, first: int = 0) -> list:
    """Jobs back to back until ``seconds`` have passed since the first
    started; the one running then finishes. ``mark()`` returns the time at
    each job's start and end (and marks the device trace in a traced run).
    ``first``: the index of the first job in the pool's order."""
    jobs: list = []
    w0 = None
    while w0 is None or time.perf_counter() - w0 < seconds:
        k = first + len(jobs)
        f = pool.file_for(k)
        cfg = cfg_for(f"job-{k:05d}")
        t0 = mark()
        w0 = t0 if w0 is None else w0
        stats, err = None, None
        try:
            res = run_job(cfg, [pool.files[f]], app=app, write_outputs=True)
            stats = stats_dict(res.stats)
            del res
        except Exception as e:  # a job that raises is a failed job; the loop goes on
            err = repr(e)
        jobs.append(Job(index=k, file=f, path=pool.files[f], nbytes=pool.nbytes(f),
                        t0=t0, t1=mark(), output_dir=cfg.output_dir,
                        trace_path=cfg.trace_path, stats=stats, error=err))
    return jobs


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             card) -> dict:
    """One run; returns the result line's object."""
    from mapreduce_rust_tpu_torch.apps import get_app
    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    tmp = tempfile.mkdtemp(prefix="mrbench-")
    pool = None
    try:
        program = dict(cell.config["program"])
        t_pool = time.perf_counter()
        pool = pool_mod.build(cell.config, cell.traffic, seed, card.generator_device,
                              int(program["reduce_n"]))
        t_warm = time.perf_counter()
        base = Config(device=card.device, **program)
        app = get_app(cell.config["app"])

        def cfg_for(tag: str, traced: bool = False) -> Config:
            return dataclasses.replace(
                base, work_dir=os.path.join(tmp, "work", tag),
                output_dir=os.path.join(tmp, "out", tag),
                trace_path=os.path.join(tmp, "trace", f"{tag}.json") if traced else None)

        warm = cfg_for("warmup")
        run_job(warm, [pool.warmup], app=app, write_outputs=True)
        shutil.rmtree(warm.output_dir, ignore_errors=True)
        card.synchronize()
        card.reset_peak()
        print(f"mrbench: set-up {t_pool - t_start:.2f} s to the pool, pool "
              f"{t_warm - t_pool:.2f} s, warm-up job {time.perf_counter() - t_warm:.2f} s",
              file=sys.stderr)

        gc.collect()
        gc.freeze()  # the harness's own objects stay out of the window's collections
        try:
            setup_s = time.perf_counter() - t_start
            jobs = run_window(run_job, cfg_for, app, pool, seconds, time.perf_counter)
            card.synchronize()
        finally:
            gc.unfreeze()
        print("mrbench: job walls s " + " ".join(f"{j.wall_s:.3f}" for j in jobs),
              file=sys.stderr)
        window_s = jobs[-1].t1 - jobs[0].t0

        dtrace, traced_jobs = None, []
        if trace:
            import torch.profiler

            prof = torch.profiler.profile(activities=card.profiler_activities(),
                                          record_shapes=False, with_stack=False)
            prof.start()
            try:
                traced_jobs = run_window(run_job, lambda tag: cfg_for(tag, True), app,
                                         pool, seconds * TRACED_SHARE, card.mark,
                                         first=len(jobs))
            finally:
                prof.stop()
            print("mrbench: traced job walls s "
                  + " ".join(f"{j.wall_s:.3f}" for j in traced_jobs), file=sys.stderr)
        peak = card.memory_peak()
        if trace:
            t0 = time.perf_counter()
            events = devtrace.device_events(prof)
            del prof
            dtrace = devtrace.read(events,
                                   [(j.t0, j.t1, j.trace_path) for j in traced_jobs])
            print(f"mrbench: device trace of {len(events)} events read in "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
            del events

        checks, failed = check_answers(cell, pool, jobs + traced_jobs)
        readings = Readings(jobs=jobs, window_s=window_s, setup_s=setup_s,
                            trace=dtrace, kind=card.kind, traced_jobs=traced_jobs)
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = read_metric(m["name"], readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = {"platform": card.platform, "kind": card.kind, "count": card.count,
                  "memory_peak_bytes": peak, "power_limit": card.power_limit()}
        result = {"correct": passed(checks) and failed == 0,
                  "attempted": len(jobs) + len(traced_jobs),
                  "failed": failed, "metrics": metrics, "device": device}
        if dtrace is not None:
            device["busy_s"] = dtrace.busy_s
            device["window_s"] = dtrace.window_s
            result["breakdown"] = devtrace.breakdown(dtrace)
        errors = sorted({j.error for j in jobs + traced_jobs if j.error})
        if errors:
            result["errors"] = errors[:5]
        result["checks"] = checks
        return result
    finally:
        if pool is not None:
            pool.close()
        shutil.rmtree(tmp, ignore_errors=True)
