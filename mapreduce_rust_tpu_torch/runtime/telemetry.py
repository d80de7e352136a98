"""Control-plane telemetry + the machine-readable run manifest.

The port of ``mapreduce_rust_tpu/runtime/telemetry.py``: the same job
report and manifest schema, so the reference's own tools read the port's
artifacts; the platform stamp names torch, CUDA and the card.

Two consumers, one module:

- **JobReport** — per-task control-plane accounting shared by the
  coordinator and the worker: state transitions (grant → renew → finish),
  lease expiries, re-executions (grants beyond the first), task durations,
  and RPC latencies. The coordinator serves its report over the new
  ``stats`` RPC and dumps it to ``{work_dir}/job_report.json`` when the
  job completes, so a BENCH probe reads structured state instead of
  re-reading stderr. Everything is plain ints/floats — JSON-serializable
  by construction, like the RPC plane it describes.

- **Run manifest** — one ``manifest.json`` per driver/bench run: config,
  platform, git rev, the full ``JobStats`` (including the
  ingest/device/host-map/host-glue wait split and ``shuffle_wire_bytes``),
  phase times, trace path, probe outcomes. ``python -m mapreduce_rust_tpu_torch
  stats <manifest> [other]`` pretty-prints one or diffs two.

No torch import anywhere here: the coordinator process must be able to
build reports without dragging in a backend (same rule as runtime/trace).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

from mapreduce_rust_tpu_torch.runtime.histogram import Histogram

MANIFEST_SCHEMA = 1


# ---------------------------------------------------------------------------
# Control-plane job report
# ---------------------------------------------------------------------------

class JobReport:
    """Per-task control-plane event log, aggregated — not per-RPC rows.

    Counters only: each record_* call is a dict update on the (phase, tid)
    slot, so a chatty renewal loop costs O(1) memory, in keeping with the
    aggregate-counters doctrine of runtime/metrics.py.
    """

    #: Ordered-event-log cap: the log exists for mrcheck's state-machine
    #: replay, and state-CHANGING events (grants, expiries, finishes,
    #: revocations — never renewals) are bounded by task count × attempts,
    #: so a real job sits far under this. The cap is a backstop against a
    #: pathological grant storm turning the report into the hot path;
    #: overflow is counted, never silent.
    EVENT_CAP = 20000

    def __init__(self, job_id: "str | None" = None, now=None) -> None:
        # Injectable clock seam: every wall-clock read in this
        # report goes through ``self._now`` so mrmodel can drive the real
        # control plane under a virtual clock. ``now=None`` keeps the
        # monotonic default — real runs are bit-identical.
        self._now = now if now is not None else time.monotonic
        # Multi-tenant job service: a per-job report carries
        # its job id on every event-log row, so a combined/multi-job
        # artifact stays per-job replayable (mrcheck keys its machines by
        # (job, phase, tid)) and a mis-routed cross-job event is
        # detectable (the grant-across-jobs invariant). None = the
        # single-job coordinator's report — rows stay unstamped, exactly
        # the pre-service wire format.
        self.job_id = job_id
        # ``row_job`` is the job stamped onto event ROWS (defaults to the
        # report identity). A multi-job WRITER — the ServiceWorker, whose
        # one report spans every job it serves — switches this per job so
        # its grant/finish rows replay under per-job machines, while its
        # report identity stays None (the report is the worker's, not any
        # one job's).
        self.row_job = job_id
        self._tasks: dict[tuple, dict] = {}  # (job-dim, phase, tid) → slot
        self._rpc: dict[str, Histogram] = {}
        # The ordered control-plane event log (mrcheck's replay substrate):
        # one row per STATE TRANSITION of the lease/attempt machine —
        # grant/speculate/expire/finish/late_finish/revoke/deregister, each
        # with (t, phase, tid, attempt, wid). Renewals are deliberately NOT
        # logged (renewed* is unbounded and extends a lease without
        # changing its state), so the log stays O(tasks), in keeping with
        # the aggregate-counters doctrine.
        self._events: list[dict] = []
        self._events_dropped = 0
        # Per-worker attribution:
        # wid → counters + an attempt-duration histogram. Grants, renewals
        # and finish reports carry the worker id, so `watch` shows a
        # per-worker column and the doctor's straggler pass compares each
        # worker's p50 against the fleet median.
        self._workers: dict[int, dict] = {}
        self._phase_hist: dict[str, Histogram] = {}  # attempt durations
        # Speculation accounting: per-phase attempts issued, the
        # won/wasted split once races settle, and the estimated time saved
        # vs the lease-expiry-only recovery — the doctor's
        # speculation-effectiveness input.
        self._speculation: dict[str, dict] = {}
        # Per-reduce-partition readiness: r → {bytes, shards,
        # ready_s}. Fed by map finish reports that ship their per-partition
        # intermediate-bytes vector; ``ready_s`` is the report-epoch
        # instant the LAST byte-contributing map shard for r landed — the
        # fleet profiler's pipelining-opportunity input.
        self._partitions: dict[int, dict] = {}
        # Scheduling mode stamp: "pipeline" when the producing
        # coordinator granted reduce tasks per-partition (no global map
        # barrier). Offline consumers key off this — the fleet profiler
        # stops counting the barrier window as a bubble, and the doctor's
        # barrier-bubble advice goes quiet (the opportunity is realized).
        self.sched: "str | None" = None
        self._t0 = self._now()

    def _jdim(self) -> "str | None":
        """Job dimension of the per-task aggregation: only a MULTI-job
        writer (row_job switched away from the report identity — the
        ServiceWorker) splits task slots by job; a per-job coordinator
        report (job_id == row_job) and the classic single-job world keep
        plain (phase, tid) slots. Without this a fleet member serving
        two jobs' task 0 would merge them into one row — grants=2 reads
        as a re-execution that never happened and the second job's
        duration is never recorded."""
        return self.row_job if self.row_job != self.job_id else None

    def _task(self, phase: str, tid: int) -> dict:
        key = (self._jdim(), phase, tid)
        t = self._tasks.get(key)
        if t is None:
            t = self._tasks[key] = {
                "grants": 0,
                "speculations": 0,
                "renewals": 0,
                "stale_renewals": 0,
                "expiries": 0,
                "reports": 0,
                "late_reports": 0,
                "first_grant_s": None,
                "last_grant_s": None,
                "done_s": None,
                "wid": None,
            }
        return t

    def _worker(self, wid) -> "dict | None":
        if wid is None or (isinstance(wid, int) and wid < 0):
            return None  # pre-wid client / in-process caller: per-task only
        w = self._workers.get(wid)
        if w is None:
            w = self._workers[wid] = {
                "grants": 0,
                "renewals": 0,
                "stale_renewals": 0,
                "reports": 0,
                "late_reports": 0,
                "task_s": Histogram(),
            }
        return w

    def record_event(self, ev: str, phase=None, tid=None, attempt=None,
                     wid=None) -> None:
        """Append one state-transition row to the ordered event log. The
        wall-clock context (``t``, seconds since this report's epoch) is
        what mrcheck prints next to an offending event pair."""
        if len(self._events) >= self.EVENT_CAP:
            self._events_dropped += 1
            return
        row: dict = {"t": round(self._now() - self._t0, 6), "ev": ev}
        if self.row_job is not None:
            row["job"] = self.row_job
        if phase is not None:
            row["phase"] = phase
        if tid is not None:
            row["tid"] = tid
        if attempt is not None:
            row["attempt"] = attempt
        if wid is not None and not (isinstance(wid, int) and wid < 0):
            row["wid"] = wid
        self._events.append(row)

    def events(self) -> list[dict]:
        return list(self._events)

    def attempts(self, phase: str, tid: int) -> int:
        """How many times (phase, tid) has been granted — the attempt
        number of the CURRENT grant, and the suffix of its flow id."""
        t = self._tasks.get((self._jdim(), phase, tid))
        return t["grants"] if t is not None else 0

    def task_wid(self, phase: str, tid: int) -> "int | None":
        """The worker id of the task's most recent grant (None when the
        grant was anonymous) — the speculation picker's don't-speculate-
        to-the-holder check."""
        t = self._tasks.get((self._jdim(), phase, tid))
        return t["wid"] if t is not None else None

    def phase_task_p50(self, phase: str, min_count: int = 1) -> "float | None":
        """The live attempt-duration median of a phase, or None until the
        histogram holds at least ``min_count`` samples — the speculation
        picker's slowness yardstick."""
        h = self._phase_hist.get(phase)
        if h is None or h.count < min_count:
            return None
        return h.percentile(0.5)

    def record_speculation(self, phase: str, tid: int, wid=None) -> None:
        """Mark the NEXT grant of (phase, tid) as speculative. The grant
        itself still goes through record_grant — a speculative grant IS a
        grant (the attempt number bumps, the flow chain forks); this only
        adds the speculation accounting on top."""
        self._task(phase, tid)["speculations"] += 1
        self._spec_phase(phase)["attempts"] += 1
        # Logged BEFORE the grant it arms: the replay reads "speculate then
        # grant" as one lease-SHARING attempt, not a grant-over-live-lease.
        self.record_event("speculate", phase, tid,
                          attempt=self.attempts(phase, tid) + 1, wid=wid)

    def record_revocation(self, phase: str, tid: int, wid=None) -> None:
        """A renewal was answered revoked=True: the renewing attempt lost
        a speculation race (the task is already reported). State-changing
        for that attempt (→ revoked), so it is logged."""
        self.record_event("revoke", phase, tid, wid=wid)

    def record_deregister(self, wid) -> None:
        """Graceful drain: the wid must never be granted again."""
        self.record_event("deregister", wid=wid)

    def record_speculation_result(self, phase: str, won: bool,
                                  time_saved_s: float = 0.0) -> None:
        s = self._spec_phase(phase)
        s["won" if won else "wasted"] += 1
        if won:
            s["time_saved_s"] += max(time_saved_s, 0.0)

    def _spec_phase(self, phase: str) -> dict:
        s = self._speculation.get(phase)
        if s is None:
            s = self._speculation[phase] = {
                "attempts": 0, "won": 0, "wasted": 0, "time_saved_s": 0.0,
            }
        return s

    def phase_expiries(self, phase: str) -> int:
        return sum(
            t["expiries"]
            for (_j, p, _tid), t in self._tasks.items() if p == phase
        )

    def phase_late_reports(self, phase: str) -> int:
        return sum(
            t["late_reports"]
            for (_j, p, _tid), t in self._tasks.items()
            if p == phase
        )

    def uptime_s(self) -> float:
        return self._now() - self._t0

    def record_grant(self, phase: str, tid: int, wid=None,
                     attempt=None) -> None:
        # ``attempt`` overrides the local grant count on the event row: a
        # worker's side of the log must carry the COORDINATOR's attempt
        # number (a re-execution grant arrives as attempt 2 even though it
        # is this worker's first grant of the tid).
        t = self._task(phase, tid)
        t["grants"] += 1
        now = self._now() - self._t0
        if t["first_grant_s"] is None:
            t["first_grant_s"] = now
        t["last_grant_s"] = now
        if wid is not None and not (isinstance(wid, int) and wid < 0):
            t["wid"] = wid
        w = self._worker(wid)
        if w is not None:
            w["grants"] += 1
        self.record_event("grant", phase, tid,
                          attempt=attempt or t["grants"], wid=wid)

    def record_renewal(self, phase: str, tid: int, ok: bool, wid=None) -> None:
        # Update-only: a renewal for a task this incarnation never granted
        # (a surviving worker's lease after a journal-resume restart) must
        # not fabricate a grants=0/incomplete phantom entry in the report.
        t = self._tasks.get((self._jdim(), phase, tid))
        if t is not None:
            t["renewals" if ok else "stale_renewals"] += 1
        w = self._worker(wid)
        if w is not None:
            w["renewals" if ok else "stale_renewals"] += 1

    def record_expiry(self, phase: str, tid: int) -> None:
        t = self._task(phase, tid)
        t["expiries"] += 1
        self.record_event("expire", phase, tid, attempt=t["grants"])

    def record_finish(self, phase: str, tid: int, late: bool = False,
                      wid=None, attempt=None) -> None:
        # Update-only, like record_renewal: a finish report for a task this
        # incarnation never granted (journal-resume restart) must not
        # fabricate a completed-but-never-granted entry whose duration_s
        # would be null.
        t = self._tasks.get((self._jdim(), phase, tid))
        if t is None:
            return
        self.record_event("late_finish" if late else "finish", phase, tid,
                          attempt=attempt, wid=wid)
        w = self._worker(wid)
        if late:
            # A duplicate completion (original + re-executed worker both
            # reporting the same tid) is a DISTINCT stat, not a second
            # "reports" tick: double-counting skewed task durations and
            # completion totals.
            t["late_reports"] += 1
            if w is not None:
                w["late_reports"] += 1
            return
        t["reports"] += 1
        if t["done_s"] is None:
            now = self._now() - self._t0
            t["done_s"] = now
            # Attempt duration: this grant → this (first) finish. Under a
            # re-execution the last grant belongs to the attempt that is
            # reporting, so per-worker attribution stays honest even when
            # attempt 1's worker is dead.
            if t["last_grant_s"] is not None:
                dur = max(now - t["last_grant_s"], 0.0)
                h = self._phase_hist.get(phase)
                if h is None:
                    h = self._phase_hist[phase] = Histogram()
                h.add(dur)
                if w is not None:
                    w["task_s"].add(dur)
        if w is not None:
            w["reports"] += 1

    #: Remote-input backstop: a part_bytes vector longer than this is a
    #: malformed (or hostile) report, not a real reduce_n — dropped.
    PARTITIONS_CAP = 4096

    def record_partition_ready(self, tid: int, part_bytes) -> None:
        """Fold one map task's per-reduce-partition intermediate-bytes
        vector (the trailing-default finish-report field) into the
        readiness table. Only shards that carry bytes advance ``ready_s``
        — an all-empty shard for r never gates r's pipeline start. The
        caller (report_map_task_finish) invokes this on FIRST reports
        only; duplicates re-wrote identical shard files."""
        if not isinstance(part_bytes, (list, tuple)) \
                or len(part_bytes) > self.PARTITIONS_CAP:
            return
        now = round(self._now() - self._t0, 6)
        for r, b in enumerate(part_bytes):
            if isinstance(b, bool) or not isinstance(b, (int, float)):
                return  # malformed vector: drop whole report, half a
                # vector folded in would under-count some partitions
        for r, b in enumerate(part_bytes):
            slot = self._partitions.get(r)
            if slot is None:
                slot = self._partitions[r] = {
                    "bytes": 0, "shards": 0, "ready_s": None,
                }
            slot["shards"] += 1
            if b > 0:
                slot["bytes"] += int(b)
                slot["ready_s"] = now

    def partitions_summary(self) -> dict:
        return {
            str(r): dict(slot)
            for r, slot in sorted(self._partitions.items())
        }

    def in_flight(self) -> list[tuple]:
        """(phase, tid) — or (job, phase, tid) for a multi-job writer's
        job-split slots — of tasks granted but not yet reported finished:
        leases currently held, as this side observed them."""
        return [
            key[1:] if key[0] is None else key
            for key, t in self._tasks.items()
            if t["grants"] > 0 and t["done_s"] is None
        ]

    def record_rpc(self, method: str, seconds: float) -> None:
        h = self._rpc.get(method)
        if h is None:
            h = self._rpc[method] = Histogram()
        h.add(seconds)

    def workers_summary(self) -> dict:
        """wid → counters + attempt-duration percentiles (ms): the live
        per-worker view `watch` renders and the doctor's straggler input."""
        out: dict = {}
        for wid, w in sorted(self._workers.items(), key=lambda kv: str(kv[0])):
            out[str(wid)] = {
                "grants": w["grants"],
                "renewals": w["renewals"],
                "stale_renewals": w["stale_renewals"],
                "reports": w["reports"],
                "late_reports": w["late_reports"],
                "task_s": w["task_s"].to_dict(),
            }
        return out

    def to_dict(self) -> dict:
        phases: dict[str, dict] = {}
        # Multi-job writers' slots render as "job:tid" keys (single-job
        # and per-job-coordinator reports keep plain tids — the shape
        # every existing consumer parses).
        for (jk, phase, tid), t in sorted(
            self._tasks.items(), key=lambda kv: (kv[0][0] or "", *kv[0][1:])
        ):
            duration = (
                round(t["done_s"] - t["first_grant_s"], 6)
                if t["done_s"] is not None and t["first_grant_s"] is not None
                else None
            )
            tid_key = f"{jk}:{tid}" if jk else str(tid)
            phases.setdefault(phase, {})[tid_key] = {
                "grants": t["grants"],
                "re_executions": max(t["grants"] - 1, 0),
                "speculations": t["speculations"],
                "expiries": t["expiries"],
                "renewals": t["renewals"],
                "stale_renewals": t["stale_renewals"],
                "reports": t["reports"],
                "late_reports": t["late_reports"],
                "duration_s": duration,
                "completed": t["done_s"] is not None,
                "wid": t["wid"],
            }
        totals = {
            phase: {
                "tasks": len(tasks),
                "completed": sum(1 for t in tasks.values() if t["completed"]),
                "re_executions": sum(t["re_executions"] for t in tasks.values()),
                "expiries": sum(t["expiries"] for t in tasks.values()),
                "late_reports": sum(t["late_reports"] for t in tasks.values()),
            }
            for phase, tasks in phases.items()
        }
        for phase, h in self._phase_hist.items():
            if phase in totals:
                # Attempt-duration distribution (seconds): the doctor's
                # lease-tuning input (expiries vs task p99).
                totals[phase]["task_s"] = h.to_dict()
        for phase, s in self._speculation.items():
            if phase in totals:
                totals[phase]["speculation"] = {
                    "attempts": s["attempts"],
                    "won": s["won"],
                    "wasted": s["wasted"],
                    "time_saved_s": round(s["time_saved_s"], 6),
                }
        rpc = {
            m: {
                # Keys preserved from the aggregate-counter era (count /
                # total_s / mean_ms / max_ms) plus the percentile tail the
                # doctor reads — all derived from one mergeable histogram.
                "count": h.count,
                "total_s": round(h.total, 6),
                "mean_ms": round(h.mean * 1e3, 3),
                "p50_ms": round((h.percentile(0.50) or 0.0) * 1e3, 3),
                "p95_ms": round((h.percentile(0.95) or 0.0) * 1e3, 3),
                "p99_ms": round((h.percentile(0.99) or 0.0) * 1e3, 3),
                "max_ms": round(h.max * 1e3, 3),
                "hist": h.to_dict(),
            }
            for m, h in sorted(self._rpc.items())
        }
        out = {"tasks": phases, "totals": totals, "rpc": rpc,
               "events": self.events()}
        if self.job_id is not None:
            out["job"] = self.job_id
        if self._events_dropped:
            out["events_dropped"] = self._events_dropped
        if self._workers:
            out["workers"] = self.workers_summary()
        if self._partitions:
            out["partitions"] = self.partitions_summary()
        if self.sched is not None:
            out["sched"] = self.sched
        return out

    def summary(self) -> str:
        d = self.to_dict()
        parts = []
        for phase, tot in d["totals"].items():
            parts.append(
                f"{phase}: {tot['completed']}/{tot['tasks']} done, "
                f"{tot['expiries']} expiries, {tot['re_executions']} re-execs"
            )
        n_rpc = sum(r["count"] for r in d["rpc"].values())
        parts.append(f"{n_rpc} RPCs")
        return "; ".join(parts)


def format_progress(stats: dict) -> str:
    """Plain-text live job view of a coordinator ``stats`` RPC response —
    what the ``watch`` subcommand repaints at 1 Hz. Degrades gracefully on
    a pre-progress coordinator (totals only)."""
    prog = stats.get("progress") or {}
    workers = prog.get("workers") or {}
    drained = workers.get("drained") or []
    lines = [
        f"coordinator: phase {prog.get('phase', '?')}"
        f" · workers {workers.get('registered', '?')}/{workers.get('expected', '?')}"
        + (
            f" ({len(drained)} drained: "
            + ", ".join(f"w{w}" for w in drained) + ")"
            if drained else ""
        )
        + f" · up {prog.get('uptime_s', 0.0):.1f}s"
    ]
    totals = stats.get("totals") or {}
    for name in ("map", "reduce"):
        spec = (totals.get(name) or {}).get("speculation")
        ph = (prog.get("phases") or {}).get(name)
        if ph is None:
            tot = totals.get(name)
            if tot:
                lines.append(
                    f"  {name:<7} {tot['completed']}/{tot['tasks']} done"
                )
            continue
        n = ph["tasks_total"]
        done = ph["done"]
        width = 24
        filled = int(width * done / n) if n else width
        bar = "#" * filled + "-" * (width - filled)
        lines.append(
            f"  {name:<7} [{bar}] {done}/{n} done · "
            f"{ph['in_flight']} in-flight · {ph['pending']} pending · "
            f"{ph['expired']} expired · {ph['late_reports']} late"
            + (
                f" · spec {spec['won']}w/{spec['wasted']}x"
                f"/{spec['attempts']}a"
                if spec and spec.get("attempts") else ""
            )
        )
        for tid, lease in sorted(
            (ph.get("leases") or {}).items(), key=lambda kv: int(kv[0])
        ):
            since = lease.get("since_activity_s")
            since_s = f"{since:.1f}s ago" if since is not None else "never"
            state = "live" if lease.get("live") else "STALE"
            lines.append(
                f"    task {tid:>3}  attempt {lease['attempt']}  "
                f"lease {lease['lease_remaining_s']:+.1f}s  "
                f"renewed {since_s}  [{state}]"
            )
    by_worker = stats.get("workers") or {}
    for wid, w in sorted(by_worker.items(), key=lambda kv: str(kv[0])):
        ts = w.get("task_s") or {}
        p50 = ts.get("p50")
        lines.append(
            f"  w{wid}: {w.get('reports', 0)} done · "
            f"{w.get('grants', 0)} grants · {w.get('renewals', 0)} renewals"
            + (f" · task p50 {p50:.2f}s" if p50 is not None else "")
        )
    rpc = stats.get("rpc") or {}
    if rpc:
        calls = sum(r["count"] for r in rpc.values())
        total_s = sum(r["total_s"] for r in rpc.values())
        max_ms = max(r["max_ms"] for r in rpc.values())
        lines.append(
            f"  rpc: {calls} calls · mean "
            f"{total_s / calls * 1e3 if calls else 0.0:.2f} ms · "
            f"max {max_ms:.2f} ms"
        )
    if prog.get("done"):
        lines.append("  job complete")
    return "\n".join(lines)


def format_jobs(view: dict) -> str:
    """Plain-text service-wide queue/running/done table of a JobService
    ``list_jobs`` RPC response — what ``watch`` (no --job) and the
    ``jobs`` subcommand render. One row per job, newest done last."""
    sv = view.get("service") or {}
    cache = sv.get("cache") or {}
    lines = [
        f"service: {sv.get('running', 0)} running · "
        f"{sv.get('queued', 0)} queued · {sv.get('done', 0)} done · "
        f"workers {sv.get('workers', 0)}"
        + (f" ({len(sv['drained'])} drained)" if sv.get("drained") else "")
        # MiB, matching the service_inflight_budget_mb knob (mb << 20):
        # the displayed budget must equal the configured number.
        + f" · inflight {sv.get('inflight_bytes', 0) / (1 << 20):.1f}"
        f"/{sv.get('budget_bytes', 0) / (1 << 20):.1f} MB"
        + (" [SATURATED]" if sv.get("admission_blocked") else "")
        + (" [DRAINING]" if sv.get("draining") else "")
        + f" · cache {cache.get('hits', 0)}h/{cache.get('misses', 0)}m"
        f"/{cache.get('entries', 0)}e"
        + f" · up {sv.get('uptime_s', 0.0):.1f}s"
    ]
    rows = view.get("jobs") or []
    if rows:
        lines.append(
            f"  {'JOB':<8} {'STATE':<9} {'APP':<15} {'PRI':>3} "
            f"{'WAIT':>7} {'RUN':>7}  TASKS"
        )
    for j in rows:
        tasks = j.get("tasks") or {}
        task_s = " ".join(
            f"{p} {t.get('done', 0)}/{t.get('total', 0)}"
            for p, t in sorted(tasks.items())
        ) or ("cache hit" if j.get("cached") else "-")
        wait = j.get("queue_wait_s")
        run = j.get("run_s")
        lines.append(
            f"  {j.get('job', '?'):<8} {j.get('state', '?'):<9} "
            f"{j.get('app', '?'):<15} {j.get('priority', 0):>3} "
            f"{(f'{wait:.1f}s' if wait is not None else '-'):>7} "
            f"{(f'{run:.1f}s' if run is not None else '-'):>7}  {task_s}"
            + (f"  [{j['error']}]" if j.get("error") else "")
        )
    # Live fleet series: per-worker utilization + current job
    # from the service's fleet_view(). Absent on pre-fleet services —
    # the table renders without the block.
    fl = sv.get("fleet_util") or {}
    workers = fl.get("workers") or {}
    if workers:
        lines.append(
            f"  fleet: util {fl.get('util_frac', 0.0):.0%} · "
            f"bubble {fl.get('bubble_frac', 0.0):.0%}"
        )
        lines.append(f"  {'WID':>5} {'UTIL':>5} {'GRANTS':>6}  CURRENT")
        for wid in sorted(workers, key=lambda w: int(w)):
            row = workers[wid]
            cur = "-"
            if row.get("drained"):
                cur = "(drained)"
            elif row.get("job") is not None:
                cur = f"{row['job']}:{row.get('phase', '?')}"
            lines.append(
                f"  {wid:>5} {row.get('util_frac', 0.0):>5.0%} "
                f"{row.get('grants', 0):>6}  {cur}"
            )
    return "\n".join(lines)


def write_job_report(path: str, report) -> str:
    """``report`` is a JobReport or an already-snapshotted to_dict()
    dict — the latter lets a server snapshot ON its event loop (where
    the report mutates) and ship only the JSON dump + file write to an
    executor thread (blocking-in-async doctrine)."""
    return write_manifest(path, {
        "schema": MANIFEST_SCHEMA,
        "kind": "job_report",
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "report": report.to_dict() if isinstance(report, JobReport)
        else report,
    })


# ---------------------------------------------------------------------------
# Run manifest
# ---------------------------------------------------------------------------

def git_rev(repo_dir: str | None = None) -> str | None:
    """Current commit hash, or None outside a repo / without git."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=repo_dir or os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=5,
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def platform_info() -> dict:
    """Host + (when already imported) torch/CUDA device identity. Never
    initializes CUDA itself: a control-plane manifest must not create a
    device context, so the device fields appear only in a process where
    CUDA is already initialized."""
    import platform as _platform

    info: dict = {
        "python": sys.version.split()[0],
        "machine": _platform.machine(),
        "system": _platform.system(),
        "hostname": _platform.node(),
        "pid": os.getpid(),
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        try:
            if not torch.cuda.is_initialized():
                # torch imported but no CUDA context: a device query here
                # would CREATE one. A manifest from such a process simply
                # omits device identity.
                return info
            dev = torch.cuda.current_device()
            info["backend"] = "cuda"
            info["device_count"] = torch.cuda.device_count()
            info["device_name"] = torch.cuda.get_device_name(dev)
            info["device_memory_bytes"] = int(
                torch.cuda.get_device_properties(dev).total_memory)
            dist = torch.distributed
            info["process_count"] = (
                dist.get_world_size()
                if dist.is_available() and dist.is_initialized() else 1)
        except Exception:  # device query failed — manifest still writes
            info["backend"] = "unavailable"
    return info


def stats_to_dict(stats) -> dict:
    """Every JobStats field (the full dataclass — including the
    ingest/device/host-map/host-glue wait split and shuffle_wire_bytes)
    plus the derived properties and two structured attributions:

    - ``host_map_split`` (host-map engine runs): scan vs glue vs device,
      with the worker count, the consumer's scan-stall time and the scan
      arenas' resident bytes — what the next BENCH round reads to see
      where the ceiling moved after the fan-out.
    - ``ici_split`` (mesh runs): all_to_all block seconds vs the rest of
      the stream phase, with rounds and wire bytes — interconnect vs
      compute, before any multi-chip perf claim.
    """
    d = dataclasses.asdict(stats)
    # The raw hists field holds Histogram objects (asdict deep-copies them
    # verbatim); serialize into the manifest's "histograms" block instead —
    # sparse buckets + precomputed p50/p95/p99, mergeable across runs.
    d.pop("hists", None)
    d["histograms"] = {
        name: h.to_dict() for name, h in sorted(stats.hists.items())
    }
    if stats.compile_count:
        d["compile"] = {
            "count": stats.compile_count,
            "total_s": round(stats.compile_s, 6),
            "cache_hits": stats.compile_cache_hits,
            "cache_misses": stats.compile_cache_misses,
        }
    d["gb_per_s"] = stats.gb_per_s
    d["bottleneck"] = stats.bottleneck
    stream_s = stats.phase_seconds.get("stream", 0.0)
    if stats.host_map_workers > 0:
        d["host_map_split"] = {
            "workers": stats.host_map_workers,
            "scan_s": round(stats.host_map_s, 6),          # aggregate, all workers
            "scan_stall_s": round(stats.scan_wait_s, 6),   # consumer starved
            "glue_s": round(stats.host_glue_s, 6),
            "device_wait_s": round(stats.device_wait_s, 6),
            "arena_bytes": stats.host_arena_bytes,
            # scan seconds actually overlapped per worker per stream second;
            # ~1.0 at W=1, → W when the fan-out scales perfectly
            "scan_parallelism": (
                round(stats.host_map_s / stream_s, 3) if stream_s else None
            ),
        }
    if stats.fold_shards > 1:
        shard_s = [round(v, 6) for v in stats.fold_shard_s]
        mean = (sum(shard_s) / len(shard_s)) if shard_s else 0.0
        d["fold_split"] = {
            "shards": stats.fold_shards,
            # per_shard_s sums to fold_s by construction: the per-shard
            # balance the doctor's fold-shard-skew finding scores.
            "fold_s": round(stats.fold_s, 6),
            "fold_stall_s": round(stats.fold_stall_s, 6),
            "per_shard_s": shard_s,
            "per_shard_idle_s": [round(v, 6) for v in stats.fold_shard_idle_s],
            # 1.0 = perfectly balanced; 2.0 = the hottest shard folds twice
            # its fair share (same convention as the doctor's skew scores).
            "balance": (
                round(max(shard_s) / mean, 3) if shard_s and mean else None
            ),
            # fold seconds overlapped per stream second — → S when the
            # sharded fold scales perfectly (the host_map_split twin).
            "fold_parallelism": (
                round(stats.fold_s / stream_s, 3) if stream_s else None
            ),
        }
    if stats.merge_dispatches > 0:
        # Device-merge dispatch plane: which plane ran (async /
        # sync, coalesced or not), dispatch-thread seconds (overlapped
        # time made visible), router backpressure, dispatch count and the
        # mean update fill — the raise-cap-vs-threshold evidence the
        # doctor's merge-dispatch finding reads.
        d["dispatch_split"] = {
            "mode": stats.dispatch_mode,
            "dispatch_s": round(stats.dispatch_s, 6),
            "stall_s": round(stats.dispatch_stall_s, 6),
            "dispatches": stats.merge_dispatches,
            "fill_frac": round(stats.merge_fill_frac, 6),
            # dispatch seconds overlapped per stream second — >0 on the
            # async plane means the sync plane would have added that
            # fraction to the router's wall (the spill write_overlap twin).
            "dispatch_overlap": (
                round(stats.dispatch_s / stream_s, 3) if stream_s else None
            ),
        }
    if stats.dict_spill_runs or stats.accum_spill_runs or stats.spill_bytes:
        # Binary async spill plane: the disk-tier attribution —
        # writer seconds (overlapped with compute), owner stall seconds
        # (backpressure = "the disk is the ceiling"), bytes, run counts,
        # the egress merge fan-in, and the run format so every manifest
        # says which plane produced its numbers.
        from mapreduce_rust_tpu_torch.runtime.spill import RUN_FORMAT

        d["spill_split"] = {
            "format": RUN_FORMAT,
            "write_s": round(stats.spill_s, 6),
            "stall_s": round(stats.spill_stall_s, 6),
            "bytes": stats.spill_bytes,
            "dict_runs": stats.dict_spill_runs,
            "accum_runs": stats.accum_spill_runs,
            "merge_fanin": stats.merge_fanin,
            # writer seconds overlapped per stream second — >0 means the
            # old sync plane would have added that fraction to the wall.
            "write_overlap": (
                round(stats.spill_s / stream_s, 3) if stream_s else None
            ),
        }
    if stats.mesh_rounds > 0:
        d["ici_split"] = {
            "rounds": stats.mesh_rounds,
            "all_to_all_s": round(stats.all_to_all_s, 6),
            "device_wait_s": round(stats.device_wait_s, 6),
            "stream_s": round(stream_s, 6),
            "stream_other_s": round(
                max(stream_s - stats.all_to_all_s - stats.device_wait_s, 0.0), 6
            ),
            "wire_bytes": stats.shuffle_wire_bytes,
            "wire_mb_per_s": (
                round(stats.shuffle_wire_bytes / stats.all_to_all_s / 1e6, 3)
                if stats.all_to_all_s else None
            ),
        }
    return d


def build_manifest(cfg, stats=None, app_name: str | None = None,
                   inputs=None, output_files=None, trace_path: str | None = None,
                   probes=None, extra: dict | None = None) -> dict:
    """Assemble one run's manifest dict. ``cfg`` may be a Config (asdict'd)
    or a plain dict (bench harness config); everything else is optional so
    partial failures still produce a manifest naming what ran."""
    m: dict = {
        "schema": MANIFEST_SCHEMA,
        "kind": "run_manifest",
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_rev": git_rev(),
        "platform": platform_info(),
        "argv": list(sys.argv),
    }
    if cfg is not None:
        m["config"] = cfg if isinstance(cfg, dict) else dataclasses.asdict(cfg)
    if app_name is not None:
        m["app"] = app_name
    if inputs is not None:
        m["inputs"] = [str(p) for p in inputs]
    if output_files is not None:
        m["output_files"] = [str(p) for p in output_files]
    if stats is not None:
        m["stats"] = stats_to_dict(stats)
        m["phase_seconds"] = dict(stats.phase_seconds)
    if trace_path is not None:
        m["trace_path"] = os.path.abspath(trace_path)
    if probes is not None:
        m["probes"] = probes
    if extra:
        m.update(extra)
    # Live metrics ring: whatever registry is active in THIS
    # process serializes into stats.timeseries — for the driver beside the
    # full JobStats dict, for the coordinator/worker (no JobStats in their
    # manifests) as the stats block's only member. A final forced sample
    # first, so even a sub-period run carries at least one point.
    try:
        from mapreduce_rust_tpu_torch.runtime.metrics import active_registry

        reg = active_registry()
        if reg is not None:
            stats_block = m.setdefault("stats", {})
            if "timeseries" not in stats_block:
                # An explicit ring in ``extra`` wins: the coordinator owns
                # an instance registry (in-process clusters share this
                # process with workers, whose rings own the global slot).
                reg.maybe_sample(force=True)
                stats_block["timeseries"] = reg.timeseries_dict()
    except Exception:
        pass  # telemetry stays best-effort
    # Sampling profile — same pattern: whatever profiler is active in
    # THIS process lands as stats.profile (per-plane self-time split,
    # top-N frames, collapsed stacks), read back by the torch-free
    # `prof` subcommand and the doctor's roofline findings.
    try:
        from mapreduce_rust_tpu_torch.runtime.prof import active_profiler

        p = active_profiler()
        if p is not None:
            stats_block = m.setdefault("stats", {})
            if "profile" not in stats_block:
                stats_block["profile"] = p.profile_dict()
    except Exception:
        pass  # telemetry stays best-effort
    # Provenance ledger — same pattern: whatever ledger is
    # active in THIS process lands as stats.lineage (counts + folded
    # corpus digests + the jsonl path), read back by the jax-free
    # `lineage` subcommand and the doctor's incremental-opportunity
    # finding. Summary only: the per-chunk records stay in the jsonl.
    try:
        from mapreduce_rust_tpu_torch.runtime.lineage import active_ledger

        led = active_ledger()
        if led is not None:
            stats_block = m.setdefault("stats", {})
            if "lineage" not in stats_block:
                stats_block["lineage"] = led.lineage_dict()
    except Exception:
        pass  # telemetry stays best-effort
    return m


def write_manifest(path: str, manifest: dict) -> str:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_manifest(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def flush_run_artifacts(cfg, tracer=None, tag: str | None = None,
                        logger=None, **manifest_fields) -> str | None:
    """End-of-run teardown shared by the driver, worker and coordinator:
    write the tracer's buffer to ``cfg.trace_path`` and a manifest to
    ``cfg.manifest_path`` (both suffixed per-process when ``tag`` is given
    — co-hosted processes must never clobber each other's files). Strictly
    best-effort: nothing here may raise, or telemetry would mask the run's
    real outcome. Returns the trace file path (or None)."""
    from mapreduce_rust_tpu_torch.runtime.trace import per_process_path

    if tracer is not None:
        # Per-round mesh.all_to_all span durations, aggregated (count /
        # total / mean / max): the traced complement of stats.ici_split —
        # wall attribution per collective round, not just the stream total.
        try:
            rounds = tracer.summarize("mesh.all_to_all")
            if rounds:
                extra = dict(manifest_fields.get("extra") or {})
                extra["mesh_round_spans"] = rounds
                manifest_fields["extra"] = extra
        except Exception:
            pass  # telemetry stays best-effort

    trace_file = None
    if tracer is not None and cfg.trace_path:
        try:
            path = per_process_path(cfg.trace_path, tag) if tag else cfg.trace_path
            trace_file = tracer.write(path)
            if logger:
                logger.info("trace: %d spans → %s", len(tracer), trace_file)
        except Exception as e:
            if logger:
                logger.warning("trace write failed: %s", e)
    if cfg.manifest_path:
        try:
            path = (
                per_process_path(cfg.manifest_path, tag) if tag
                else cfg.manifest_path
            )
            write_manifest(path, build_manifest(
                cfg, trace_path=trace_file, **manifest_fields
            ))
            if logger:
                logger.info("manifest → %s", path)
            # Collapsed-stack export beside the manifest: flamegraph.pl /
            # speedscope load the .folded directly; `prof --folded`
            # re-derives the same lines from the manifest's stats.profile
            # for files shipped elsewhere.
            try:
                from mapreduce_rust_tpu_torch.runtime.prof import active_profiler

                p = active_profiler()
                if p is not None:
                    folded = os.path.splitext(path)[0] + ".folded"
                    p.write_folded(folded)
                    if logger:
                        logger.info("profile → %s", folded)
            except Exception:
                pass  # telemetry stays best-effort
        except Exception as e:
            if logger:
                logger.warning("manifest write failed: %s", e)
    return trace_file


def _flatten(d: dict, prefix: str = "") -> dict:
    out: dict = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def format_manifest(m: dict) -> str:
    """Human view of one manifest: identity header, then the stats that
    decide a BENCH verdict, then phase times."""
    lines = [
        f"run manifest (schema {m.get('schema')}) — {m.get('created')}",
        f"  app: {m.get('app', '?')}  git: {str(m.get('git_rev'))[:12]}",
    ]
    p = m.get("platform", {})
    lines.append(
        f"  platform: {p.get('backend', 'none')} x{p.get('device_count', '?')} "
        f"torch={p.get('torch', '-')} python={p.get('python', '?')} ({p.get('machine', '?')})"
    )
    s = m.get("stats")
    if s:
        lines.append(
            f"  {s['bytes_in'] / 1e6:.2f} MB in {s['wall_seconds']:.3f}s "
            f"({s['gb_per_s']:.4f} GB/s) — bottleneck: {s['bottleneck']}"
        )
        lines.append(
            f"  distinct={s['distinct_keys']} chunks={s['chunks']} "
            f"spills={s['spill_events']}({s['spilled_keys']} keys) "
            f"replays={s['partial_overflow_replays']}+{s['bucket_skew_replays']}skew "
            f"collisions={s['hash_collisions']} unknown={s['unknown_keys']}"
        )
        lines.append(
            f"  shuffle: {s['mesh_rounds']} rounds, "
            f"{s['shuffle_wire_bytes'] / 1e6:.1f} MB wire"
        )
        lines.append(
            f"  waits: ingest={s['ingest_wait_s']:.3f}s device={s['device_wait_s']:.3f}s "
            f"host_map={s['host_map_s']:.3f}s host_glue={s['host_glue_s']:.3f}s"
        )
        hm = s.get("host_map_split")
        if hm:
            lines.append(
                f"  host-map split: {hm['workers']} workers, "
                f"scan={hm['scan_s']:.3f}s (x{hm['scan_parallelism'] or 0:.2f} "
                f"parallel), stall={hm['scan_stall_s']:.3f}s "
                f"glue={hm['glue_s']:.3f}s device={hm['device_wait_s']:.3f}s "
                f"arenas={hm['arena_bytes'] / 1e6:.0f} MB"
            )
        fs = s.get("fold_split")
        if fs:
            lines.append(
                f"  fold split: {fs['shards']} shards, "
                f"fold={fs['fold_s']:.3f}s "
                f"(x{fs['fold_parallelism'] or 0:.2f} parallel, "
                f"balance {fs['balance'] or 0:.2f}) "
                f"stall={fs['fold_stall_s']:.3f}s"
            )
        dp = s.get("dispatch_split")
        if dp:
            lines.append(
                f"  dispatch split [{dp['mode']}]: "
                f"dispatch={dp['dispatch_s']:.3f}s "
                f"stall={dp['stall_s']:.3f}s "
                f"{dp['dispatches']} merges "
                f"(fill {dp['fill_frac']:.2f})"
            )
        sp = s.get("spill_split")
        if sp:
            lines.append(
                f"  spill split [{sp.get('format')}]: "
                f"write={sp['write_s']:.3f}s stall={sp['stall_s']:.3f}s "
                f"{sp['bytes'] / 1e6:.1f} MB in "
                f"{sp['dict_runs']}+{sp['accum_runs']} runs "
                f"(egress fan-in {sp['merge_fanin']})"
            )
        ici = s.get("ici_split")
        if ici:
            lines.append(
                f"  ICI split: all_to_all={ici['all_to_all_s']:.3f}s "
                f"drain={ici['device_wait_s']:.3f}s "
                f"other={ici['stream_other_s']:.3f}s of {ici['stream_s']:.3f}s "
                f"stream ({ici['rounds']} rounds, "
                f"{ici['wire_bytes'] / 1e6:.1f} MB wire)"
            )
        comp = s.get("compile")
        if comp:
            lines.append(
                f"  compile: {comp['count']} XLA compiles, "
                f"{comp['total_s']:.2f}s ({comp['cache_hits']} cache hits, "
                f"{comp['cache_misses']} misses)"
            )
        if s.get("device_mem_high_bytes"):
            lines.append(
                f"  device memory high-water: "
                f"{s['device_mem_high_bytes'] / 1e6:.1f} MB"
            )
        for name, h in sorted((s.get("histograms") or {}).items()):
            if not h.get("count"):
                continue
            unit = 1e3 if name.endswith("_s") else 1.0  # seconds → ms
            lines.append(
                f"  hist {name:<18} n={h['count']:<6} "
                f"p50={h['p50'] * unit:.3g} p95={h['p95'] * unit:.3g} "
                f"p99={h['p99'] * unit:.3g} max={h['max'] * unit:.3g}"
                + (" ms" if unit == 1e3 else "")
            )
    for name, secs in (m.get("phase_seconds") or {}).items():
        lines.append(f"  phase {name:<10} {secs:8.3f}s")
    if m.get("trace_path"):
        lines.append(f"  trace: {m['trace_path']}")
    for probe in m.get("probes") or []:
        status = "ok" if probe.get("ok") else f"FAILED ({probe.get('error', '?')})"
        lines.append(f"  probe {probe.get('leg', '?'):<14} {status}")
    return "\n".join(lines)


def diff_manifests(a: dict, b: dict) -> list[str]:
    """Field-level diff of two manifests, numeric fields with deltas —
    the BENCH round-over-round comparison, machine-checkable."""
    fa, fb = _flatten(a), _flatten(b)
    skip = ("created", "argv", "platform.pid", "platform.hostname")
    lines = []
    for key in sorted(set(fa) | set(fb)):
        if key.startswith(skip) or key in skip:
            continue
        # Raw histogram internals (sparse bucket maps, embedded hist
        # copies), the ordered event log (mrcheck's replay substrate) and
        # the live time-series ring (wall-clock-stamped points — they
        # differ every run by construction): the aggregate fields beside
        # them carry the comparable signal.
        if any(seg in ("buckets", "hist", "events", "timeseries")
               for seg in key.split(".")):
            continue
        va, vb = fa.get(key, "<absent>"), fb.get(key, "<absent>")
        if va == vb:
            continue
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)) \
                and not isinstance(va, bool) and not isinstance(vb, bool):
            delta = vb - va
            rel = f" ({delta / va:+.1%})" if va else ""
            lines.append(f"  {key}: {va} -> {vb} [{delta:+g}{rel}]")
        else:
            lines.append(f"  {key}: {va!r} -> {vb!r}")
    return lines
