"""Fleet profiler: the cross-job, per-worker busy/idle
timeline and its derived numbers — fleet utilization, barrier-bubble
seconds, and per-job pipelining opportunity.

A copy of ``mapreduce_rust_tpu/runtime/fleet.py`` (stdlib only).

Every observability plane before this one is a single-job view. This
module JOINS the artifacts the existing planes already leave on disk —

- ``{service-root}/service.journal``: the job-lifecycle rows (submit /
  start / done / cancel) whose ``t`` stamps live on the service-uptime
  axis. The LAST ``start`` row of a job is its per-job report's epoch
  (the Coordinator — and its JobReport clock — is created at admission),
  so job-local event times rebase onto the service axis by adding it.
- ``{service-root}/job-*/job_report.json``: each job's ordered
  control-plane event log (grant / expire / finish / late_finish /
  revoke, with ``t``/``phase``/``tid``/``attempt``/``wid``) plus the
  per-reduce-partition readiness table fed by the
  map finish reports' trailing ``part_bytes`` vector.
- a single-job workdir's ``job_report.json``, when pointed at one.

and computes, per worker: busy intervals (grant → finish), **dead**
intervals (grant → lease expiry with no finish — the SIGKILLed attempt's
window, excluded from the idle denominator instead of counted as idle),
idle = presence − busy − dead; and fleet-wide: ``util_frac``,
``idle_frac``, ``bubble_frac`` (idle worker-seconds that overlap a
*bubble window* — any span where a job sat queued, or a running job's
reduce work existed but was blocked behind the global map barrier), and
``pipelining_opportunity_s`` = Σ_r max(reduce-r first grant −
readiness-r, 0) per job — the headroom a phase-pipelining scheduler
(``--sched pipeline``) reclaims.

Crash-tolerant by construction: torn journal tails are skipped, a
missing/partial ``job_report.json`` degrades that job to a
journal-only row instead of failing the report, and every such
degradation is listed under ``errors``. No torch import anywhere — the
profiler is an offline control-plane tool (``python -m
mapreduce_rust_tpu_torch fleet``) and must start in milliseconds.
"""

from __future__ import annotations

import glob
import json
import os

__all__ = [
    "build_fleet_report",
    "fleet_history_row",
    "format_fleet_report",
    "run_cli",
]


# ---------------------------------------------------------------------------
# Interval arithmetic (closed-open [t0, t1) spans)
# ---------------------------------------------------------------------------

def _merge(intervals: list) -> list:
    """Sorted union of [t0, t1) spans."""
    out: list = []
    for t0, t1 in sorted(intervals):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]

def _total(intervals: list) -> float:
    return sum(t1 - t0 for t0, t1 in intervals)

def _subtract(base: list, holes: list) -> list:
    """base − holes, both merged-sorted span lists."""
    out: list = []
    holes = list(holes)
    for t0, t1 in base:
        cur = t0
        for h0, h1 in holes:
            if h1 <= cur or h0 >= t1:
                continue
            if h0 > cur:
                out.append((cur, min(h0, t1)))
            cur = max(cur, h1)
            if cur >= t1:
                break
        if cur < t1:
            out.append((cur, t1))
    return out

def _intersect(a: list, b: list) -> list:
    out: list = []
    for x0, x1 in a:
        for y0, y1 in b:
            lo, hi = max(x0, y0), min(x1, y1)
            if hi > lo:
                out.append((lo, hi))
    return _merge(out)


# ---------------------------------------------------------------------------
# Artifact loading (crash-tolerant: every failure degrades, none raise)
# ---------------------------------------------------------------------------

def _load_service_journal(path: str, errors: list) -> list:
    try:
        with open(path) as f:
            raw = f.read()
    except OSError as e:
        errors.append(f"service.journal unreadable: {e}")
        return []
    rows: list = []
    for line in raw.splitlines():
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail from a crashed append
        if isinstance(row, dict) and row.get("job") and "op" in row:
            rows.append(row)
    return rows

def _load_job_report(path: str, errors: list) -> "dict | None":
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError:
        return None  # never flushed (job mid-flight at crash): caller
        # degrades to a journal-only row — absence is not an error here
    except json.JSONDecodeError as e:
        errors.append(f"{path}: torn/partial report ({e}) — skipped")
        return None
    if not isinstance(doc, dict):
        errors.append(f"{path}: not a report object — skipped")
        return None
    rep = doc.get("report", doc)
    return rep if isinstance(rep, dict) else None


# ---------------------------------------------------------------------------
# Timeline construction
# ---------------------------------------------------------------------------

def _job_intervals(jid: "str | None", events: list, base: float,
                   end_hint: float) -> tuple:
    """One job's event log → (timeline rows, last event t). Busy rows
    span grant → finish/late_finish/revoke of the same (wid, phase,
    tid); a grant settled only by a lease ``expire`` — or never settled
    at all — becomes a **dead** row (the attempt's worker stopped
    reporting: crash, SIGKILL, or wedge), which the caller excludes
    from that worker's idle denominator. Times are rebased onto the
    caller's axis by ``base``."""
    open_grants: dict = {}   # (phase, tid) → [t, attempt, wid]
    rows: list = []
    t_max = 0.0

    def _row(t0: float, t1: float, state: str, phase, tid, wid) -> None:
        if t1 <= t0 or wid is None:
            return
        rows.append({
            "wid": wid, "t0": round(base + t0, 6), "t1": round(base + t1, 6),
            "state": state, "job": jid, "phase": phase, "tid": tid,
        })

    for ev in events:
        if not isinstance(ev, dict):
            continue
        t = ev.get("t")
        kind = ev.get("ev")
        if not isinstance(t, (int, float)) or not isinstance(kind, str):
            continue
        t_max = max(t_max, t)
        phase, tid, wid = ev.get("phase"), ev.get("tid"), ev.get("wid")
        key = (phase, tid)
        if kind == "grant":
            prev = open_grants.pop(key, None)
            if prev is not None:
                # Re-grant over a still-open attempt (expiry row raced or
                # was dropped at the event cap): the old attempt is dead.
                _row(prev[0], t, "dead", phase, tid, prev[2])
            open_grants[key] = [t, ev.get("attempt"), wid]
        elif kind in ("finish", "late_finish", "revoke"):
            g = open_grants.pop(key, None)
            if g is not None:
                # Revoked losers still COMPUTED until the revocation —
                # the worker was busy, just uselessly so.
                _row(g[0], t, "busy", phase, tid,
                     wid if wid is not None else g[2])
        elif kind == "expire":
            g = open_grants.pop(key, None)
            if g is not None:
                _row(g[0], t, "dead", phase, tid, g[2])
    for (phase, tid), g in open_grants.items():
        # Open at end of log: the job (or the service) went down with the
        # attempt in flight.
        _row(g[0], max(end_hint - base, t_max), "dead", phase, tid, g[2])
    return rows, t_max


def _job_pipelining(report: dict) -> tuple:
    """(pipelining_opportunity_s, per-partition detail) from one job's
    readiness table + its reduce grant events. Job-local axis — both
    sides share the report epoch, no rebase needed."""
    parts = report.get("partitions")
    if not isinstance(parts, dict) or not parts:
        return 0.0, {}
    first_reduce_grant: dict = {}
    for ev in report.get("events") or []:
        if (isinstance(ev, dict) and ev.get("ev") == "grant"
                and ev.get("phase") == "reduce"
                and isinstance(ev.get("t"), (int, float))
                and ev.get("tid") is not None):
            first_reduce_grant.setdefault(ev["tid"], ev["t"])
    total = 0.0
    detail: dict = {}
    for r_key, slot in parts.items():
        if not isinstance(slot, dict):
            continue
        ready = slot.get("ready_s")
        try:
            r = int(r_key)
        except (TypeError, ValueError):
            continue
        start = first_reduce_grant.get(r)
        if ready is None or start is None:
            continue
        gap = max(start - ready, 0.0)
        total += gap
        detail[str(r)] = {
            "ready_s": round(ready, 6),
            "reduce_start_s": round(start, 6),
            "gap_s": round(gap, 6),
            "bytes": slot.get("bytes", 0),
        }
    return round(total, 6), detail


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

def build_fleet_report(target: str) -> dict:
    """Join the artifacts under ``target`` (a service root or a
    single-job workdir) into one fleet report dict. Crash-tolerant:
    partial artifacts degrade into ``errors`` entries, never exceptions
    (short of the target simply not existing)."""
    errors: list = []
    journal_path = os.path.join(target, "service.journal")
    job_dirs = sorted(glob.glob(os.path.join(target, "job-*")))
    service_mode = os.path.isfile(journal_path) or bool(job_dirs)

    jobs: dict = {}          # jid → job row (lifecycle + metrics)
    timeline: list = []
    end = 0.0

    if service_mode:
        for row in _load_service_journal(journal_path, errors):
            jid, op, t = row["job"], row["op"], row.get("t")
            if not isinstance(t, (int, float)):
                continue
            end = max(end, t)
            j = jobs.setdefault(jid, {"state": "unknown"})
            if op == "submit":
                j["submit_t"] = t
                j["priority"] = row.get("priority", 0)
                spec = row.get("spec")
                if isinstance(spec, dict):
                    j["app"] = spec.get("app")
            elif op == "start":
                j["start_t"] = t   # LAST start wins: restart re-admission
                j["state"] = "running"
            elif op == "done":
                j["done_t"] = t
                j["state"] = row.get("state", "done")
                if row.get("cached"):
                    j["cached"] = True
            elif op == "cancel":
                j.setdefault("done_t", t)
                j["state"] = "cancelled"
        report_dirs = {os.path.basename(d)[len("job-"):]: d
                       for d in job_dirs if os.path.isdir(d)}
    else:
        report_dirs = {None: target}

    for jid, d in sorted(report_dirs.items(), key=lambda kv: str(kv[0])):
        rep = _load_job_report(os.path.join(d, "job_report.json"), errors)
        if not service_mode:
            # Single-job mode: name the row after the report's own job
            # id (None for the classic coordinator — render as "job").
            jid = (rep or {}).get("job") or "job"
        j = jobs.setdefault(jid, {"state": "unknown"})
        if rep is None:
            j["partial"] = True
            errors.append(
                f"job {jid or os.path.basename(d)}: no readable "
                "job_report.json — journal-only row"
            )
            continue
        base = j.get("start_t", j.get("submit_t", 0.0)) if service_mode \
            else 0.0
        rows, t_max = _job_intervals(jid, rep.get("events") or [],
                                     base, end)
        timeline.extend(rows)
        end = max(end, base + t_max)
        opp, parts = _job_pipelining(rep)
        j["pipelining_opportunity_s"] = opp
        if parts:
            j["partitions"] = parts
        # Barrier window (job-local → rebased): from the first map finish
        # (reduce work EXISTS from here) to the last map finish (the
        # barrier opens). Map-only jobs have no reduce phase — no window.
        map_fin = [ev["t"] for ev in rep.get("events") or []
                   if isinstance(ev, dict)
                   and ev.get("ev") in ("finish", "late_finish")
                   and ev.get("phase") == "map"
                   and isinstance(ev.get("t"), (int, float))]
        has_reduce = "reduce" in (rep.get("totals") or {})
        if rep.get("sched") == "pipeline":
            # The scheduler dissolved the barrier: reduce
            # tasks were grantable per partition throughout the map
            # window, so idle inside it is plain idle, not a structural
            # bubble — no barrier_window, and the sched stamp rides the
            # job row so readers can tell why it's absent.
            j["sched"] = "pipeline"
        elif len(map_fin) > 1 and has_reduce:
            j["barrier_window"] = (round(base + min(map_fin), 6),
                                   round(base + max(map_fin), 6))

    # --- bubble windows on the shared axis ---
    bubble_windows: list = []
    for jid, j in jobs.items():
        sub = j.get("submit_t")
        if sub is not None and not j.get("cached"):
            start = j.get("start_t")
            t1 = start if start is not None else j.get("done_t", end)
            if t1 is not None and t1 > sub:
                bubble_windows.append((sub, t1))      # job sat queued
        bw = j.get("barrier_window")
        if bw:
            bubble_windows.append(bw)                 # map-barrier tail
        if sub is not None:
            q = (j.get("start_t") if j.get("start_t") is not None
                 else j.get("done_t", end)) or 0.0
            j["queue_wait_s"] = round(max(q - sub, 0.0), 6)
    bubble_windows = _merge(bubble_windows)

    # --- per-worker accounting ---
    by_wid: dict = {}
    for row in timeline:
        by_wid.setdefault(row["wid"], []).append(row)
    workers: dict = {}
    tot = {"busy_ws": 0.0, "idle_ws": 0.0, "dead_ws": 0.0,
           "bubble_ws": 0.0, "active_ws": 0.0}
    for wid, rows in sorted(by_wid.items(), key=lambda kv: str(kv[0])):
        first = min(r["t0"] for r in rows)
        busy = _merge([(r["t0"], r["t1"]) for r in rows
                       if r["state"] == "busy"])
        dead = _merge([(r["t0"], r["t1"]) for r in rows
                       if r["state"] == "dead"])
        dead = _subtract(dead, busy)  # overlap reads as busy: the worker
        # demonstrably worked there (speculation twins share (phase,tid))
        present = [(first, max(end, first))]
        idle = _subtract(_subtract(present, busy), dead)
        bubble = _intersect(idle, bubble_windows)
        busy_s, dead_s = _total(busy), _total(dead)
        idle_s, bubble_s = _total(idle), _total(bubble)
        active_s = _total(present) - dead_s  # crash windows leave the
        # denominator: a dead worker can't be "wasted idle"
        workers[str(wid)] = {
            "present_s": round(_total(present), 3),
            "busy_s": round(busy_s, 3),
            "idle_s": round(idle_s, 3),
            "dead_s": round(dead_s, 3),
            "bubble_s": round(bubble_s, 3),
            "util_frac": round(busy_s / active_s, 4) if active_s > 0
            else 0.0,
        }
        tot["busy_ws"] += busy_s
        tot["idle_ws"] += idle_s
        tot["dead_ws"] += dead_s
        tot["bubble_ws"] += bubble_s
        tot["active_ws"] += max(active_s, 0.0)

    active = tot["active_ws"]
    opp_total = sum(j.get("pipelining_opportunity_s", 0.0)
                    for j in jobs.values())
    fleet = {
        "workers": len(workers),
        "jobs": len(jobs),
        **{k: round(v, 3) for k, v in tot.items()},
        "util_frac": round(tot["busy_ws"] / active, 4) if active > 0
        else 0.0,
        "idle_frac": round(tot["idle_ws"] / active, 4) if active > 0
        else 0.0,
        "bubble_frac": round(tot["bubble_ws"] / active, 4) if active > 0
        else 0.0,
        "pipelining_opportunity_s": round(opp_total, 6),
    }
    out = {
        "kind": "fleet_report",
        "mode": "service" if service_mode else "job",
        "target": os.path.abspath(target),
        "window_s": round(end, 3),
        "fleet": fleet,
        "workers": workers,
        "jobs": {str(k): v for k, v in sorted(jobs.items(),
                                              key=lambda kv: str(kv[0]))},
        "bubble_windows": [(round(a, 3), round(b, 3))
                           for a, b in bubble_windows],
        "timeline": sorted(timeline,
                           key=lambda r: (str(r["wid"]), r["t0"])),
    }
    if errors:
        out["errors"] = errors
    return out


def fleet_history_row(report: dict) -> dict:
    """The three trend-watched series the bench history records — one
    place, so bench.py and any future caller agree on the names doctor
    trend follows."""
    f = report.get("fleet") or {}
    return {
        "fleet_bubble_frac": f.get("bubble_frac", 0.0),
        "fleet_util_frac": f.get("util_frac", 0.0),
        "pipelining_opportunity_s": f.get("pipelining_opportunity_s", 0.0),
    }


# ---------------------------------------------------------------------------
# Rendering + CLI
# ---------------------------------------------------------------------------

def format_fleet_report(report: dict, verbose: bool = False) -> str:
    f = report["fleet"]
    lines = [
        f"fleet: {f['workers']} worker(s) · {f['jobs']} job(s) · window "
        f"{report['window_s']:.1f}s [{report['mode']}]",
        f"  util {f['util_frac']:.1%} · idle {f['idle_frac']:.1%} · "
        f"bubble {f['bubble_frac']:.1%} ({f['bubble_ws']:.1f} "
        f"worker-s) · dead {f['dead_ws']:.1f} worker-s",
        f"  pipelining opportunity: {f['pipelining_opportunity_s']:.2f}s "
        "(Σ reduce-start − partition-readiness)",
    ]
    if report["workers"]:
        lines.append("  WID   BUSY      IDLE      BUBBLE    DEAD      UTIL")
        for wid, w in report["workers"].items():
            lines.append(
                f"  w{wid:<4} {w['busy_s']:<9.2f} {w['idle_s']:<9.2f} "
                f"{w['bubble_s']:<9.2f} {w['dead_s']:<9.2f} "
                f"{w['util_frac']:.1%}"
            )
    for jid, j in report["jobs"].items():
        bits = [f"  job {jid}: {j.get('state', '?')}"]
        if j.get("app"):
            bits.append(j["app"])
        if "queue_wait_s" in j:
            bits.append(f"wait {j['queue_wait_s']:.2f}s")
        if j.get("pipelining_opportunity_s"):
            bits.append(f"pipelining {j['pipelining_opportunity_s']:.2f}s")
        if j.get("cached"):
            bits.append("cached")
        if j.get("partial"):
            bits.append("PARTIAL (no report artifact)")
        lines.append(" · ".join(bits))
    dead_rows = [r for r in report["timeline"] if r["state"] == "dead"]
    if dead_rows:
        lines.append(f"  {len(dead_rows)} dead interval(s) — lease-expired"
                     " / crashed attempts, excluded from idle:")
        for r in dead_rows:
            lines.append(
                f"    w{r['wid']} {r['t0']:.2f}–{r['t1']:.2f}s "
                f"{(r['job'] + ':') if r['job'] else ''}"
                f"{r['phase']}:{r['tid']}"
            )
    if verbose:
        lines.append("  timeline:")
        for r in report["timeline"]:
            lines.append(
                f"    w{r['wid']} {r['t0']:8.3f}–{r['t1']:8.3f}  "
                f"{r['state']:<5} "
                f"{(r['job'] + ':') if r['job'] else ''}"
                f"{r['phase']}:{r['tid']}"
            )
    for e in report.get("errors") or []:
        lines.append(f"  warning: {e}")
    return "\n".join(lines)


def compare_baseline(report: dict, baseline: dict) -> dict:
    """Regression check against a prior fleet report: bubble_frac is the
    watched series (bad = up), with the doctor-trend style guard band —
    2 points absolute plus 10% relative."""
    cur = report["fleet"].get("bubble_frac", 0.0)
    base = (baseline.get("fleet") or {}).get("bubble_frac", 0.0)
    regressed = cur > base + 0.02 + 0.10 * abs(base)
    return {
        "bubble_frac": cur,
        "baseline_bubble_frac": base,
        "delta": round(cur - base, 4),
        "regressed": regressed,
    }


def run_cli(args) -> int:
    target = args.target
    if not os.path.isdir(target):
        print(f"fleet: {target!r} is not a directory")
        return 2
    report = build_fleet_report(target)
    rc = 0
    if getattr(args, "baseline", None):
        errors: list = []
        base = _load_job_report(args.baseline, errors) \
            if os.path.isfile(args.baseline) else None
        # _load_job_report unwraps {"report": ...}; a fleet report has no
        # such envelope, so it comes back verbatim.
        if base is None or base.get("kind") != "fleet_report":
            print(f"fleet: baseline {args.baseline!r} is not a fleet "
                  "report")
            return 2
        report["baseline"] = compare_baseline(report, base)
        if report["baseline"]["regressed"]:
            rc = 1
    if getattr(args, "format", "text") == "json":
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(format_fleet_report(report,
                                  verbose=getattr(args, "verbose", False)))
        if "baseline" in report:
            b = report["baseline"]
            print(f"  baseline: bubble {b['baseline_bubble_frac']:.1%} → "
                  f"{b['bubble_frac']:.1%} "
                  f"({'REGRESSED' if b['regressed'] else 'ok'})")
    return rc
