"""Exhaustive control-plane schedule exploration.

The port of ``mapreduce_rust_tpu/analysis/mrmodel.py``, copied whole: it
drives the port's ``Coordinator`` and ``JobService`` and checks its
counterexamples' chaos specs with the port's ``analysis/chaos.py``.

mrcheck replays invariants over schedules that actually happened; chaos
samples a handful more. This module enumerates them: the **real**
``Coordinator``/``JobService`` grant/finish/expiry/readiness/speculation/
cancel logic — driven through its existing RPC entry points, never a
model rewrite — runs under a virtual clock and an explicit event queue,
and a bounded DFS explores every interleaving of worker and fault events
up to ``--depth``, DPOR-style pruning collapsing commuting pairs
(finishes/renewals/deregisters on distinct workers touching distinct
(phase, tid) machines) into one representative order.

Every explored schedule is validated per-step against mrcheck's
``INVARIANTS`` catalog (via :func:`mrcheck.check_stream` — pure
in-memory, no tempfile round-trips) and at the leaf against the
model-only invariants in :data:`MODEL_INVARIANTS`. A failing schedule is
shrunk (delta debugging: drop events while the same violation code
reproduces) and emitted two ways — a human-readable counterexample trace
and a seeded chaos-grammar spec, so the counterexample replays on
the real OS-process cluster.

Event vocabulary (``(kind, *args)`` tuples; every apply also advances
the virtual clock one small tick, so timestamps order deterministically):

- ``("poll", wid)``      worker pulls its next task (map first, then
  reduce — the worker loop's order); a grant is remembered as held work
- ``("finish", wid)``    worker reports its held task (correct attempt +
  part_bytes vector — the pipelined-readiness input)
- ``("renew", wid)``     heartbeat for the held task, including the
  response-envelope revoke check (a revoked worker drops its work)
- ``("expire",)``        fault: the virtual clock jumps past the lease
  timeout and the real detector scan runs; workers do NOT learn — their
  later finishes become the duplicate/late-report races
- ``("deregister", wid)`` fault: graceful drain of an idle worker
- ``("cancel", jid)``    fault (service focus): cancel a queued or
  running job mid-schedule
- ``("replay",)``        fault: journal-truncate-and-replay — a fresh
  coordinator is rebuilt from the journal minus its torn tail and must
  still drain to completion (replay-convergence)
- ``("mutate",)``        armed by ``--mutate CLASS``: marks the point at
  which the corresponding in-memory artifact corruption (mirroring
  ``mrcheck.MUTATIONS``) is applied at leaf validation — the
  mutation-teeth gate's seeded fault event

No torch import, no sockets, no real sleeps: importable and runnable from
any analysis context (the torch-free CLI doctrine of the analysis
commands).
"""

from __future__ import annotations

import contextlib
import json
import logging
import random
import sys
import time

from mapreduce_rust_tpu_torch.analysis import chaos as chaos_mod
from mapreduce_rust_tpu_torch.analysis.mrcheck import (
    INVARIANTS,
    JournalLine,
    MUTATIONS,
    Violation,
    check_lineage,
    check_service_journal,
    check_stream,
    check_trace,
    parse_journal,
)
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.coordinator.server import Coordinator

MODEL_SCHEMA = 1

#: Model-only invariants — properties of SCHEDULES, not artifacts, so
#: they live here rather than in mrcheck.INVARIANTS (whose codes are the
#: artifact-replay catalog the README documents one-for-one).
MODEL_INVARIANTS: dict = {
    "no-grant-starvation": (
        "from any explored prefix, the deterministic drain loop (poll/"
        "finish every live worker, expire when wedged) must still reach "
        "done() — no schedule may paint the scheduler into a corner "
        "where work exists but is never grantable"
    ),
    "readiness-monotone-per-attempt": (
        "a part_retract for partition r is legal only when a map lease "
        "expiry (a dead attempt) intervened since r's part_ready — "
        "readiness never regresses while its establishing attempt is "
        "live (the partial-order dispatch contract)"
    ),
    "replay-convergence": (
        "a fresh coordinator replaying ANY journal prefix (truncate-"
        "and-replay fault) must reach a state from which the drain loop "
        "still completes the job — the failover precondition of a "
        "coordinator failover"
    ),
}


@contextlib.contextmanager
def _quiet():
    """Model runs replay thousands of lease expiries on purpose — the
    control plane's own warn-level chatter would drown the report."""
    logging.disable(logging.CRITICAL)
    try:
        yield
    finally:
        logging.disable(logging.NOTSET)


class VirtualClock:
    """Deterministic monotonic stand-in: callable like time.monotonic,
    advanced explicitly by the explorer. Starts at a non-zero epoch so
    uptime arithmetic never special-cases 0."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# Harnesses: the real state machines under the virtual clock
# ---------------------------------------------------------------------------

class _ModelCoordinator(Coordinator):
    """Real Coordinator with its journal captured in memory (same line
    format byte-for-byte, minus the header/fsync plumbing) — nothing
    else overridden: every grant/finish/expiry/speculation decision is
    the shipped code path."""

    def __init__(self, cfg: Config, now=None) -> None:
        self.journal_lines: list[str] = []
        super().__init__(cfg, resume=False, job_id=None, now=now)

    def _journal(self, phase_name: str, tid: int, attempt: int = 0,
                 wid: int = -1) -> None:
        self.journal_lines.append(
            f"{phase_name} {tid} a{attempt} w{wid} "
            f"t{self.report.uptime_s():.3f}"
        )


#: Per-event clock tick: small enough that no lease expires from event
#: flow alone (timeouts are >= 1s), large enough for distinct rounded
#: timestamps on every event row.
_TICK = 0.01


class CoordinatorHarness:
    """One schedule's worth of real-Coordinator state plus the worker
    fiction around it (who holds what, who drained). ``apply`` is total:
    an event that is not applicable in the current state is a no-op
    (``changed=False``) — what lets the shrinker drop arbitrary events
    and still replay."""

    kind = "coordinator"

    def __init__(self, cfg: Config, clock: "VirtualClock | None" = None):
        self.cfg = cfg
        self.clock = clock or VirtualClock()
        self.coord = _ModelCoordinator(cfg, now=self.clock)
        for _ in range(cfg.worker_n):
            self.coord.get_worker_id()
        self.held: dict[int, tuple] = {}    # wid -> (phase, tid, attempt)
        self.gone: set[int] = set()
        self.mutated = False
        self.replay_violations: list[Violation] = []

    # -- state --

    def finished(self) -> bool:
        return self.coord.done()

    def fingerprint(self) -> tuple:
        c = self.coord
        return (
            len(c.report._events), len(self.coord.journal_lines),
            tuple(sorted(self.held.items())),
            tuple(sorted(c.map.leases)), tuple(sorted(c.reduce.leases)),
            c.map.finished, c.reduce.finished,
            tuple(sorted(c.map.reported)), tuple(sorted(c.reduce.reported)),
            tuple(sorted(self.gone)), self.mutated,
            len(self.replay_violations),
        )

    def enabled(self, mutate: "str | None" = None) -> list[tuple]:
        evs: list[tuple] = []
        c = self.coord
        for wid in range(self.cfg.worker_n):
            if wid in self.gone:
                continue
            if wid in self.held:
                evs.append(("finish", wid))
                evs.append(("renew", wid))
            elif not c.done():
                evs.append(("poll", wid))
        if c.map.leases or c.reduce.leases:
            evs.append(("expire",))
        alive = [w for w in range(self.cfg.worker_n) if w not in self.gone]
        if len(alive) > 1:
            for wid in alive:
                if wid not in self.held:
                    evs.append(("deregister", wid))
        if self.coord.journal_lines:
            evs.append(("replay",))
        if mutate and not self.mutated:
            evs.append(("mutate",))
        return evs

    # -- event application --

    def apply(self, ev: tuple) -> dict:
        """Apply one event to the real state machine. Returns an info
        dict: ``changed`` (did any model-visible state move — the
        stutter-pruning input), ``task`` (the (phase, tid) the event
        touched, the DPOR commute key) and ``desc`` (human trace)."""
        self.clock.advance(_TICK)
        kind = ev[0]
        info = {"changed": False, "task": None, "desc": " ".join(
            str(x) for x in ev)}
        before = self.fingerprint()
        if kind == "poll":
            wid = ev[1]
            if wid in self.gone or wid in self.held:
                return info
            phase, tid = "map", self.coord.get_map_task(wid)
            if not (isinstance(tid, int) and tid >= 0):
                phase, tid = "reduce", self.coord.get_reduce_task(wid)
            if isinstance(tid, int) and tid >= 0:
                attempt = self.coord.report.attempts(phase, tid)
                self.held[wid] = (phase, tid, attempt)
                info["task"] = (phase, tid)
                info["desc"] = (
                    f"poll w{wid} -> grant {phase}:{tid} a{attempt}")
        elif kind == "finish":
            wid = ev[1]
            held = self.held.pop(wid, None)
            if held is None:
                return info
            phase, tid, attempt = held
            info["task"] = (phase, tid)
            late = tid in (self.coord.map if phase == "map"
                           else self.coord.reduce).reported
            if phase == "map":
                self.coord.report_map_task_finish(
                    tid, attempt=attempt, wid=wid,
                    part_bytes=[1] * self.cfg.reduce_n)
            else:
                self.coord.report_reduce_task_finish(
                    tid, attempt=attempt, wid=wid)
            info["late"] = late
            info["desc"] = (f"finish w{wid} {phase}:{tid} a{attempt}"
                            + (" (late)" if late else ""))
        elif kind == "renew":
            wid = ev[1]
            held = self.held.get(wid)
            if held is None:
                return info
            phase, tid, attempt = held
            info["task"] = (phase, tid)
            method = ("renew_map_lease" if phase == "map"
                      else "renew_reduce_lease")
            ok = getattr(self.coord, method)(tid, wid)
            resp: dict = {}
            self.coord._enrich_response(
                method, {"params": [tid, wid]}, ok, resp)
            if resp.get("revoked"):
                # The worker learned it lost the race: drop the work.
                self.held.pop(wid, None)
                info["revoked"] = True
                info["desc"] = f"renew w{wid} {phase}:{tid} -> revoked"
            else:
                info["desc"] = (f"renew w{wid} {phase}:{tid} "
                                f"-> {'ok' if ok else 'stale'}")
        elif kind == "expire":
            self.clock.advance(self.cfg.lease_timeout_s + _TICK)
            expired = self._live_leases()
            self.coord.check_lease()
            info["expired"] = expired
            info["desc"] = "expire " + (", ".join(
                f"{p}:{t}" for p, t in expired) or "(nothing live)")
            if expired:
                info["task"] = expired[0]
        elif kind == "deregister":
            wid = ev[1]
            if wid in self.gone or wid in self.held:
                return info
            alive = [w for w in range(self.cfg.worker_n)
                     if w not in self.gone]
            if len(alive) <= 1:
                return info  # never drain the last worker: starvation
                # by construction is not a scheduler bug
            self.coord.deregister_worker(wid)
            self.gone.add(wid)
            info["desc"] = f"deregister w{wid}"
        elif kind == "replay":
            self.replay_violations += self._check_replay()
            info["desc"] = (
                f"replay journal[:{max(len(self.coord.journal_lines) - 1, 0)}]"
                " -> fresh coordinator must still drain")
        elif kind == "mutate":
            if self.mutated:
                return info
            self.mutated = True
            info["desc"] = "mutate (arm artifact corruption)"
        info["changed"] = self.fingerprint() != before
        return info

    def _live_leases(self) -> list[tuple]:
        out = []
        for name, ph in (("map", self.coord.map),
                         ("reduce", self.coord.reduce)):
            if self.cfg.sched_pipeline or (
                    (ph is self.coord.reduce) == self.coord.map.finished):
                out += [(name, tid) for tid in sorted(ph.leases)]
        return out

    # -- model-only invariants --

    def drain(self) -> bool:
        """Deterministically run the job to completion from the current
        state: every live worker finishes held work or polls; when a
        round moves nothing, the detector runs. Bounded — a full round
        with no state motion twice in a row means wedged."""
        cap = 8 * (self.cfg.map_n + self.cfg.reduce_n) + 24
        for _ in range(cap):
            if self.coord.done():
                return True
            fp = self.fingerprint()
            for wid in range(self.cfg.worker_n):
                if wid in self.gone:
                    continue
                self.apply(("finish", wid) if wid in self.held
                           else ("poll", wid))
            if self.fingerprint() == fp:
                self.apply(("expire",))
                if self.fingerprint() == fp:
                    return self.coord.done()
        return self.coord.done()

    def _check_replay(self) -> list[Violation]:
        """Journal-truncate-and-replay: rebuild a fresh coordinator from
        the journal minus its last line (the torn tail the real replay
        drops) and prove the job still drains — replay-convergence."""
        prefix = self.coord.journal_lines[:-1]
        fresh = CoordinatorHarness(self.cfg, clock=VirtualClock(self.clock.t))
        fresh.coord._replay_journal_lines(prefix)
        if not fresh.drain():
            return [Violation(
                "replay-convergence",
                f"a coordinator replaying {len(prefix)} journal line(s) "
                "could not drain the job to completion — a restart at "
                "this point wedges the run",
                [{"ev": "journal-prefix", "lines": prefix},
                 {"ev": "drain-wedged"}],
            )]
        return []

    # -- validation --

    def step_violations(self) -> list[Violation]:
        """Cheap per-step pass: the event-log replay plus the model-only
        readiness monotonicity — what localizes a failure to its
        earliest step."""
        events = self.coord.report.events()
        return (check_stream(events)
                + _check_readiness_monotone(events)
                + self.replay_violations)

    def artifacts(self) -> dict:
        """Leaf snapshot in mrcheck's in-memory shapes."""
        report = self.coord.report.to_dict()
        journal = parse_journal(
            "".join(line + "\n" for line in self.coord.journal_lines))
        return {"events": report.get("events") or [], "journal": journal,
                "report": report, "rows": None, "trace": None}

    def leaf_violations(self) -> list[Violation]:
        a = self.artifacts()
        v = check_stream(a["events"], a["journal"], a["report"])
        v += _check_readiness_monotone(a["events"])
        v += self.replay_violations
        if not self.mutated:
            if not self.drain():
                v.append(Violation(
                    "no-grant-starvation",
                    "the deterministic drain loop could not complete the "
                    "job from this schedule's final state — grantable "
                    "work exists that no worker can obtain",
                    [{"ev": "drain-wedged"},
                     a["events"][-1] if a["events"]
                     else {"ev": "empty-log"}],
                ))
            v += self._check_replay() if self.coord.journal_lines else []
        return v


def _check_readiness_monotone(events: list) -> list[Violation]:
    """readiness-monotone-per-attempt: a part_retract for r requires a
    map lease expiry since r's latest part_ready — retracting readiness
    under live attempts would re-gate partitions whose inputs are final."""
    v: list[Violation] = []
    last_ready: dict = {}          # (job, r) -> index of latest part_ready
    last_map_expire: dict = {}     # job -> index of latest map expire
    for i, e in enumerate(events or []):
        ev, job = e.get("ev"), e.get("job")
        if ev == "part_ready" and e.get("phase") == "reduce":
            last_ready[(job, e.get("tid"))] = i
        elif ev == "expire" and e.get("phase") == "map":
            last_map_expire[job] = i
        elif ev == "part_retract" and e.get("phase") == "reduce":
            ready_i = last_ready.get((job, e.get("tid")))
            expire_i = last_map_expire.get(job)
            if ready_i is not None and (expire_i is None
                                        or expire_i < ready_i):
                v.append(Violation(
                    "readiness-monotone-per-attempt",
                    f"reduce {e.get('tid')} readiness retracted with no "
                    "map lease expiry since it was established — "
                    "readiness regressed under live attempts",
                    [events[ready_i], e],
                ))
    return v


class _ModelService:
    """JobService harness (focus=service): two submitted jobs over a one-
    worker fleet with service_max_jobs=1, so job B queues behind A — the
    mid-queue-cancel surface. Journals (service rows + per-job
    coordinator journals) captured in memory."""

    kind = "service"

    def __init__(self, cfg: Config, specs: list,
                 clock: "VirtualClock | None" = None):
        # Local import: service/server pulls the app registry — still
        # torch-free, but heavier than the coordinator path.
        from mapreduce_rust_tpu_torch.service.server import JobService

        self.cfg = cfg
        self.specs = specs
        self.clock = clock or VirtualClock()
        self.rows: list[dict] = []
        self.job_journals: dict[str, list[str]] = {}
        harness = self

        class _Svc(JobService):
            def _journal(self, op, jid, **fields):
                row = {"op": op, "job": jid,
                       "t": round(self.report.uptime_s(), 3)}
                row.update({k: v for k, v in fields.items()
                            if isinstance(v, (str, int, float, bool))})
                harness.rows.append(row)

            def _admit(self, job):
                super()._admit(job)
                if job.coord is not None:
                    harness._capture_job_journal(job)

        self.svc = _Svc(cfg, resume=False, now=self.clock)
        self.svc.get_worker_id()
        self.jids = []
        for spec in specs:
            res = self.svc.submit_job(dict(spec))
            if not res.get("ok"):
                raise RuntimeError(f"model submit failed: {res}")
            self.jids.append(res["job"])
        self.held: dict[int, tuple] = {}  # wid -> (jid, phase, tid,
        #                                          attempt, reduce_n)
        self.mutated = False
        self.replay_violations: list[Violation] = []

    def _capture_job_journal(self, job) -> None:
        mem = self.job_journals.setdefault(job.jid, [])
        coord = job.coord

        def _mem_journal(phase_name, tid, attempt=0, wid=-1,
                         _coord=coord, _mem=mem):
            suffix = f" j{_coord.job_id}" if _coord.job_id else ""
            _mem.append(
                f"{phase_name} {tid} a{attempt} w{wid} "
                f"t{_coord.report.uptime_s():.3f}{suffix}")

        coord._journal = _mem_journal

    # -- state --

    def finished(self) -> bool:
        return all(j.state in ("done", "cancelled", "failed")
                   for j in self.svc.jobs.values())

    def fingerprint(self) -> tuple:
        leases = []
        for jid, job in sorted(self.svc.jobs.items()):
            if job.coord is not None:
                leases.append((jid, tuple(sorted(job.coord.map.leases)),
                               tuple(sorted(job.coord.reduce.leases)),
                               tuple(sorted(job.coord.map.reported)),
                               tuple(sorted(job.coord.reduce.reported))))
        return (
            len(self.rows), tuple(sorted(self.held.items())),
            tuple((jid, j.state) for jid, j in sorted(self.svc.jobs.items())),
            tuple(leases),
            tuple((jid, len(m)) for jid, m
                  in sorted(self.job_journals.items())),
            self.mutated,
        )

    def enabled(self, mutate: "str | None" = None) -> list[tuple]:
        evs: list[tuple] = []
        if 0 in self.held:
            evs.append(("finish", 0))
            evs.append(("renew", 0))
        elif not self.finished():
            evs.append(("poll", 0))
        if any(j.coord is not None
               and (j.coord.map.leases or j.coord.reduce.leases)
               for j in self.svc.running.values()):
            evs.append(("expire",))
        for jid in self.jids:
            job = self.svc.jobs.get(jid)
            if job is not None and job.state in ("queued", "joined",
                                                 "running"):
                evs.append(("cancel", jid))
        if mutate and not self.mutated:
            evs.append(("mutate",))
        return evs

    # -- event application --

    def apply(self, ev: tuple) -> dict:
        self.clock.advance(_TICK)
        kind = ev[0]
        info = {"changed": False, "task": None,
                "desc": " ".join(str(x) for x in ev)}
        before = self.fingerprint()
        if kind == "poll":
            wid = 0
            if wid in self.held:
                return info
            grant = self.svc.get_task(wid)
            if isinstance(grant, dict):
                jid, phase, tid = grant["job"], grant["phase"], grant["tid"]
                job = self.svc.jobs[jid]
                self.held[wid] = (jid, phase, tid, grant["attempt"],
                                  job.cfg.reduce_n)
                info["task"] = (phase, tid)
                info["desc"] = (f"poll w{wid} -> grant {jid} {phase}:{tid} "
                                f"a{grant['attempt']}")
        elif kind == "finish":
            held = self.held.pop(0, None)
            if held is None:
                return info
            jid, phase, tid, attempt, reduce_n = held
            info["task"] = (phase, tid)
            if phase == "map":
                self.svc.report_map_task_finish(
                    tid, attempt=attempt, wid=0, job=jid,
                    part_bytes=[1] * reduce_n)
            else:
                self.svc.report_reduce_task_finish(
                    tid, attempt=attempt, wid=0, job=jid)
            info["desc"] = f"finish w0 {jid} {phase}:{tid} a{attempt}"
        elif kind == "renew":
            held = self.held.get(0)
            if held is None:
                return info
            jid, phase, tid, attempt, _rn = held
            info["task"] = (phase, tid)
            method = ("renew_map_lease" if phase == "map"
                      else "renew_reduce_lease")
            ok = getattr(self.svc, method)(tid, 0, None, jid)
            resp: dict = {}
            self.svc._enrich_response(
                method, {"params": [tid, 0, None, jid]}, ok, resp)
            if resp.get("revoked"):
                self.held.pop(0, None)
                info["revoked"] = True
                info["desc"] = f"renew w0 {jid} {phase}:{tid} -> revoked"
        elif kind == "expire":
            self.clock.advance(self.cfg.lease_timeout_s + _TICK)
            for job in list(self.svc.running.values()):
                if job.coord is not None:
                    job.coord.check_lease()
            info["desc"] = "expire (all running jobs' detectors)"
        elif kind == "cancel":
            jid = ev[1]
            job = self.svc.jobs.get(jid)
            if job is None or job.state not in ("queued", "joined",
                                                "running"):
                return info
            st = job.state
            self.svc.cancel_job(jid)
            info["desc"] = f"cancel {jid} (was {st})"
        elif kind == "mutate":
            if self.mutated:
                return info
            self.mutated = True
            info["desc"] = "mutate (arm artifact corruption)"
        info["changed"] = self.fingerprint() != before
        return info

    # -- model-only invariants / validation --

    def drain(self) -> bool:
        cap = 16 * (len(self.jids) + 1) * (self.cfg.reduce_n + 2) + 32
        for _ in range(cap):
            if self.finished():
                return True
            fp = self.fingerprint()
            self.apply(("finish", 0) if 0 in self.held else ("poll", 0))
            if self.fingerprint() == fp:
                self.apply(("expire",))
                if self.fingerprint() == fp:
                    return self.finished()
        return self.finished()

    def step_violations(self) -> list[Violation]:
        v = check_service_journal(self.rows)
        for jid, job in sorted(self.svc.jobs.items()):
            rep = (job.coord.report.to_dict() if job.coord is not None
                   else job.report_dict)
            if rep:
                v += check_stream(rep.get("events") or [])
        return v

    def artifacts(self) -> dict:
        events: list = []
        journal: list = []
        report = None
        for jid, job in sorted(self.svc.jobs.items()):
            rep = (job.coord.report.to_dict() if job.coord is not None
                   else job.report_dict)
            if rep:
                events += rep.get("events") or []
                if report is None:
                    report = rep
            journal += parse_journal("".join(
                line + "\n" for line in self.job_journals.get(jid, [])))
        return {"events": events, "journal": journal, "report": report,
                "rows": list(self.rows), "trace": None}

    def leaf_violations(self) -> list[Violation]:
        v = check_service_journal(self.rows)
        for jid, job in sorted(self.svc.jobs.items()):
            rep = (job.coord.report.to_dict() if job.coord is not None
                   else job.report_dict)
            journal = parse_journal("".join(
                line + "\n" for line in self.job_journals.get(jid, [])))
            if rep:
                v += check_stream(rep.get("events") or [], journal, rep)
        if not self.mutated and not self.drain():
            v.append(Violation(
                "no-grant-starvation",
                "the service drain loop could not settle every job from "
                "this schedule's final state",
                [{"ev": "drain-wedged"},
                 {"ev": "jobs", "states": {
                     jid: j.state
                     for jid, j in sorted(self.svc.jobs.items())}}],
            ))
        return v


# ---------------------------------------------------------------------------
# In-memory mutation table (mirrors mrcheck.MUTATIONS file mutators)
# ---------------------------------------------------------------------------

def _last(rows: list, ev: str) -> "dict | None":
    for e in reversed(rows):
        if e.get("ev") == ev:
            return e
    return None


def _row(ev: str, base: dict, **over) -> dict:
    row = {k: base[k] for k in ("t", "job", "phase", "tid", "attempt",
                                "wid") if k in base}
    row["ev"] = ev
    row.update(over)
    return row


def _mut_double_win(a: dict) -> bool:
    f = _last(a["events"], "finish")
    if f is None:
        return False
    a["events"].append(_row("finish", f,
                            attempt=(f.get("attempt") or 1) + 1))
    return True


def _mut_report_after_revoke(a: dict) -> bool:
    for i, e in enumerate(a["events"]):
        if e.get("ev") == "finish":
            a["events"].insert(i, _row("revoke", e))
            return True
    return False


def _mut_grant_over_live_lease(a: dict) -> bool:
    for i, e in enumerate(a["events"]):
        if e.get("ev") == "grant":
            a["events"].insert(
                i + 1, _row("grant", e, attempt=(e.get("attempt") or 1) + 1))
            return True
    return False


def _mut_expire_without_lease(a: dict) -> bool:
    for i, e in enumerate(a["events"]):
        if e.get("ev") == "finish":
            a["events"].insert(i + 1, _row("expire", e))
            return True
    return False


def _mut_finish_without_grant(a: dict) -> bool:
    g = _last(a["events"], "grant") or _last(a["events"], "finish")
    if g is None:
        return False
    a["events"].append(_row("finish", g, tid=(g.get("tid") or 0) + 9001))
    return True


def _mut_grant_after_deregister(a: dict) -> bool:
    for i, e in enumerate(a["events"]):
        if e.get("ev") == "grant" and e.get("wid") is not None:
            a["events"].insert(i, {"t": e.get("t"), "ev": "deregister",
                                   "wid": e["wid"]})
            return True
    return False


def _mut_truncate_event_log(a: dict) -> bool:
    if a.get("report") is None:
        return False
    a["report"] = dict(a["report"])
    a["report"]["events_dropped"] = (
        a["report"].get("events_dropped") or 0) + 3
    return True


def _mut_journal_without_finish(a: dict) -> bool:
    rep = a.get("report") or {}
    for phase, tasks in sorted((rep.get("tasks") or {}).items()):
        for tid_s, entry in sorted(tasks.items()):
            if not entry.get("reports", 0):
                try:
                    tid = int(tid_s)
                except ValueError:
                    continue
                raw = f"{phase} {tid} a1 w0 t9.999"
                a["journal"] = list(a["journal"] or []) + [JournalLine(
                    phase, tid, 1, 0, 9.999,
                    len(a["journal"] or []) + 1, raw)]
                return True
    return False


def _mut_finish_without_journal(a: dict) -> bool:
    if not a.get("journal"):
        return False
    a["journal"] = list(a["journal"])[:-1]
    return True


def _mut_grant_across_jobs(a: dict) -> bool:
    if not a.get("journal") or a.get("report") is None:
        return False
    a["report"] = dict(a["report"])
    a["report"]["job"] = "jA"
    a["journal"] = list(a["journal"])
    ln = a["journal"][-1]
    a["journal"][-1] = JournalLine(ln.phase, ln.tid, ln.attempt, ln.wid,
                                   ln.t, ln.line, ln.raw, job="jB")
    return True


def _mut_job_lifecycle(a: dict) -> bool:
    rows = a.get("rows")
    if not rows:
        return False
    for row in rows:
        if row.get("op") in ("done", "cancel"):
            a["rows"] = list(rows) + [dict(row)]
            return True
    return False


def _mut_drop_terminator(a: dict) -> bool:
    for ln in reversed(a.get("journal") or []):
        if ln.attempt:
            fid = f"{ln.phase}:{ln.tid}:{ln.attempt}"
            if ln.job:
                fid = f"{ln.job}:{fid}"
            a["trace"] = [{
                "name": "task", "ph": "s", "id": fid, "ts": 1,
                "pid": 1, "tid": 1,
                "args": {"phase": ln.phase, "tid": ln.tid},
            }]
            return True
    return False


def _mut_write_race(a: dict) -> bool:
    ln = (a.get("journal") or [None])[-1]
    if ln is None:
        return False
    args = {"phase": ln.phase, "tid": ln.tid}
    a["trace"] = [
        {"name": "coordinator.journal", "ph": "i", "ts": 1, "pid": 1,
         "tid": 1, "args": dict(args)},
        {"name": "coordinator.journal", "ph": "i", "ts": 1, "pid": 2,
         "tid": 1, "args": dict(args)},
    ]
    return True


def _mut_early_reduce_grant(a: dict) -> bool:
    # Mirrors mrcheck.mutate_early_reduce_grant: clone a reduce grant to
    # BEFORE the first map finish (no part_ready can cover it there),
    # with a matching expire so the recording's real grant of the same
    # tid doesn't cross-fire grant-over-live-lease. Needs a schedule
    # that reached both a map finish and a reduce grant.
    events = a["events"]
    mf = next(((i, e) for i, e in enumerate(events)
               if e.get("ev") == "finish" and e.get("phase") == "map"),
              None)
    g = next((e for e in events
              if e.get("ev") == "grant" and e.get("phase") == "reduce"),
             None)
    if mf is None or g is None:
        return False
    i, first_map_fin = mf
    t = max((first_map_fin.get("t") or 0.0) - 0.002, 0.0)
    ghost = dict(g)
    ghost["t"] = t
    exp = {"t": t + 0.001, "ev": "expire", "phase": "reduce",
           "tid": g.get("tid"), "attempt": g.get("attempt")}
    if g.get("job") is not None:
        exp["job"] = g["job"]
    a["events"] = events[:i] + [ghost, exp] + events[i:]
    return True


def _mut_lineage_claim(a: dict) -> bool:
    # Mirrors mrcheck.mutate_lineage_conservation: a partition claims a
    # chunk digest no scan or attempt ever produced. The model has no
    # data plane, so the ledger is synthesized in load_ledger's parsed
    # shape (the file mutator's synthesize precedent) — one honestly
    # scanned chunk plus a part record smuggling a ghost digest into its
    # claim. Any leaf can host it, so the shrunk schedule is just the
    # arming event.
    a["lineage"] = {
        "chunks": [{"t": "chunk", "seq": 0, "doc": 0, "bytes": 64,
                    "dg": "ab" * 16, "parts": [0]}],
        "attempts": [],
        "parts": [{"t": "part", "r": 0, "bytes": 64,
                   "chunks": ["ab" * 16, "deadbeef" * 4]}],
    }
    return True


#: In-memory corruption per mrcheck.MUTATIONS class: same keys, same
#: violation codes, applied to a leaf's captured artifacts instead of
#: files on disk. A mutator returns False when the schedule cannot host
#: the corruption yet (e.g. no journal line to drop) — exploration keeps
#: looking for one that can.
MODEL_MUTATORS: dict = {
    "double-win": _mut_double_win,
    "report-after-revoke": _mut_report_after_revoke,
    "grant-over-live-lease": _mut_grant_over_live_lease,
    "expire-without-lease": _mut_expire_without_lease,
    "finish-without-grant": _mut_finish_without_grant,
    "grant-after-deregister": _mut_grant_after_deregister,
    "truncated-event-log": _mut_truncate_event_log,
    "journal-without-finish": _mut_journal_without_finish,
    "finish-without-journal": _mut_finish_without_journal,
    "grant-across-jobs": _mut_grant_across_jobs,
    "job-lifecycle": _mut_job_lifecycle,
    "missing-terminator": _mut_drop_terminator,
    "write-race": _mut_write_race,
    "early-reduce-grant": _mut_early_reduce_grant,
    "lineage-conservation": _mut_lineage_claim,
}

#: Which focus hosts each mutation class (the teeth test's routing):
#: service-journal classes need the JobService harness, the readiness
#: class needs the pipelined scheduler, everything else the lease focus.
MUTATION_FOCUS: dict = {
    "job-lifecycle": "service",
    "early-reduce-grant": "pipeline",
}


def _validate_mutated(a: dict) -> list[Violation]:
    v = check_stream(a["events"], a.get("journal"), a.get("report"))
    v += _check_readiness_monotone(a["events"])
    if a.get("rows") is not None:
        v += check_service_journal(a["rows"])
    if a.get("trace") is not None:
        try:
            v += check_trace(a["trace"], a.get("journal"))
        except ValueError:
            pass
    if a.get("lineage") is not None:
        v += check_lineage(a["lineage"])
    return v


# ---------------------------------------------------------------------------
# Explorer: bounded DFS with DPOR-style pruning
# ---------------------------------------------------------------------------

#: Canonical event order — the DPOR representative: of two adjacent
#: commuting events, only the canonically-ordered interleaving is
#: explored; the transposed one is pruned (same Mazurkiewicz trace).
_KIND_RANK = {"poll": 0, "finish": 1, "renew": 2, "deregister": 3,
              "cancel": 4, "expire": 5, "replay": 6, "mutate": 7}
_COMMUTING = ("finish", "renew", "deregister")


def _key(ev: tuple) -> tuple:
    return (_KIND_RANK.get(ev[0], 9), *[str(x) for x in ev[1:]])


def _commutes(last_ev: tuple, last_task, cand: tuple, cand_task) -> bool:
    """Two worker-local operations on distinct workers touching distinct
    (phase, tid) machines commute: both orders yield the same state and
    the same Mazurkiewicz trace. Anything global (poll's grant counter,
    expire's clock jump, cancel/replay/mutate) commutes with nothing."""
    if last_ev[0] not in _COMMUTING or cand[0] not in _COMMUTING:
        return False
    if last_ev[1:2] == cand[1:2]:
        return False  # same worker: program order
    if last_task is not None and cand_task is not None \
            and last_task == cand_task:
        return False  # same (phase, tid): first-wins races don't commute
    return True


class _Budget(Exception):
    pass


class _Explorer:
    def __init__(self, make_harness, budget: int, depth: int, seed: int,
                 mutate: "str | None"):
        self.make_harness = make_harness
        self.budget = budget
        self.depth = depth
        self.rng = random.Random(seed)
        self.mutate = mutate
        self.explored = 0
        self.pruned = 0
        self.steps = 0
        self.counterexample: "dict | None" = None

    def replay(self, schedule: list):
        h = self.make_harness()
        infos = []
        for ev in schedule:
            infos.append(h.apply(ev))
            self.steps += 1
        return h, infos

    def run(self) -> None:
        try:
            self._explore([])
        except _Budget:
            pass

    def _leaf(self, h, schedule: list) -> None:
        self.explored += 1
        violations = h.leaf_violations()
        if self.mutate:
            if h.mutated:
                a = h.artifacts()
                if MODEL_MUTATORS[self.mutate](a):
                    mv = [x for x in _validate_mutated(a)
                          if x.code == self.mutate]
                    if mv:
                        self._record(schedule, mv[0])
                        return
        elif violations:
            self._record(schedule, violations[0])
            return
        if self.explored >= self.budget:
            raise _Budget

    def _record(self, schedule: list, violation: Violation) -> None:
        self.counterexample = {"schedule": list(schedule),
                               "violation": violation}
        raise _Budget

    def _explore(self, prefix: list, last: "tuple | None" = None,
                 last_task=None) -> None:
        h, _infos = self.replay(prefix)
        if not self.mutate:
            v = h.step_violations()
            if v:
                self._record(prefix, v[0])
        if len(prefix) >= self.depth or h.finished():
            self._leaf(h, prefix)
            return
        cands = sorted(h.enabled(mutate=self.mutate), key=_key)
        if not cands:
            self._leaf(h, prefix)
            return
        # Seeded rotation: the canonical candidate SET is explored in
        # full either way; the starting point only decides which
        # subtrees a truncated budget reaches first.
        rot = self.rng.randrange(len(cands))
        cands = cands[rot:] + cands[:rot]
        for ev in cands:
            cand_task = None
            if ev[0] in _COMMUTING and len(ev) > 1:
                held = h.held.get(ev[1])
                cand_task = held[-4:-2] if h.kind == "service" and held \
                    else (held[0], held[1]) if held else None
            if last is not None and _commutes(last, last_task, ev,
                                              cand_task) \
                    and _key(ev) < _key(last):
                # The transposed order was (or will be) explored from
                # this node's parent — same Mazurkiewicz trace.
                self.pruned += 1
                continue
            h2, infos = self.replay(prefix + [ev])
            if not infos[-1]["changed"]:
                # Stutter pruning: the event moved nothing, so the
                # subtree duplicates this node's other branches.
                self.pruned += 1
                continue
            self._explore(prefix + [ev], ev, infos[-1]["task"])


# ---------------------------------------------------------------------------
# Focus configurations
# ---------------------------------------------------------------------------

def _lease_cfg() -> Config:
    return Config(map_n=2, reduce_n=2, worker_n=2, lease_timeout_s=5.0,
                  speculate=True, speculate_after_frac=0.5,
                  metrics_enabled=False)


def _pipeline_cfg() -> Config:
    return Config(map_n=2, reduce_n=2, worker_n=2, lease_timeout_s=5.0,
                  sched="pipeline", metrics_enabled=False)


def _service_setup(workdir: str):
    """(cfg, specs) for the service focus: a tiny real corpus (submit
    scans it), one worker, max_jobs=1 so the second submission queues."""
    import os

    corpus = os.path.join(workdir, "model-corpus")
    os.makedirs(corpus, exist_ok=True)
    doc = os.path.join(corpus, "doc-0.txt")
    if not os.path.exists(doc):
        with open(doc, "w") as f:
            f.write("alpha beta beta gamma\n")
    cfg = Config(map_n=1, reduce_n=2, worker_n=1, lease_timeout_s=5.0,
                 service_max_jobs=1, metrics_enabled=False,
                 input_dir=corpus,
                 work_dir=os.path.join(workdir, "model-work"),
                 output_dir=os.path.join(workdir, "model-out"))
    specs = [
        {"app": "word_count", "input_dir": corpus, "reduce_n": 2},
        {"app": "grep", "app_args": {"query": ["beta"]},
         "input_dir": corpus, "reduce_n": 2},
    ]
    return cfg, specs


def make_harness_factory(focus: str, workdir: "str | None" = None):
    """A zero-arg callable minting a fresh harness (one per explored
    schedule). Configs are built once; service corpus written once."""
    if focus == "lease":
        cfg = _lease_cfg()
        return lambda: CoordinatorHarness(cfg)
    if focus == "pipeline":
        cfg = _pipeline_cfg()
        return lambda: CoordinatorHarness(cfg)
    if focus == "service":
        if workdir is None:
            raise ValueError("service focus needs a workdir "
                             "(run_model provides one)")
        cfg, specs = _service_setup(workdir)
        return lambda: _ModelService(cfg, specs)
    raise ValueError(f"unknown focus {focus!r} "
                     "(choose pipeline, lease or service)")


# ---------------------------------------------------------------------------
# Counterexample shrinking + chaos export
# ---------------------------------------------------------------------------

def shrink(schedule: list, fails) -> list:
    """Delta debugging by single-event removal to a 1-minimal sequence:
    every remaining event is necessary (dropping any one of them makes
    the violation vanish). ``fails(candidate)`` replays from scratch."""
    changed = True
    while changed:
        changed = False
        i = 0
        while i < len(schedule):
            cand = schedule[:i] + schedule[i + 1:]
            if fails(cand):
                schedule = cand
                changed = True
            else:
                i += 1
    return schedule


def chaos_spec(seed: int, infos: list, lease_timeout_s: float) -> str:
    """Render a shrunk schedule's fault content in the chaos
    grammar, so the counterexample replays on the real OS-process
    cluster: an expired task maps to ``kill`` (the attempt dies and the
    detector recovers it), a revoked renewal to ``wedge_renewal`` (the
    heartbeat goes quiet under a live task), a late duplicate finish to
    ``delay_finish`` past the lease window. Validated by round-tripping
    through ChaosPlan.parse."""
    faults: list[str] = []

    def add(f: str) -> None:
        if f not in faults:
            faults.append(f)

    for info in infos:
        for phase, tid in info.get("expired") or []:
            add(f"kill:{phase}:{tid}")
        if info.get("revoked") and info.get("task"):
            phase, tid = info["task"]
            add(f"wedge_renewal:{phase}:{tid}")
        if info.get("late") and info.get("task"):
            phase, tid = info["task"]
            add(f"delay_finish:{phase}:{tid}:{lease_timeout_s * 1.5:.1f}"
                ":attempt=*")
    if not faults:
        # Schedule-only counterexample (ordering, cancel, mutation):
        # anchor the repro with a benign straggler pause so the spec
        # still parses and perturbs the same schedule region.
        faults.append("pause:map:0:0.1")
    return chaos_mod.build_spec(seed, faults)


# ---------------------------------------------------------------------------
# Driver + CLI
# ---------------------------------------------------------------------------

def run_model(focus: str = "lease", budget: int = 5000, depth: int = 12,
              seed: int = 0, mutate: "str | None" = None,
              workdir: "str | None" = None) -> dict:
    """Explore one focus. Returns the mrmodel document; deterministic
    for a given (focus, budget, depth, seed, mutate) except the timing
    fields (``elapsed_s``/``schedules_per_s``)."""
    if mutate is not None and mutate not in MODEL_MUTATORS:
        raise ValueError(
            f"unknown mutation class {mutate!r} "
            f"(have: {', '.join(sorted(MODEL_MUTATORS))})")
    if mutate is not None and mutate not in MUTATIONS:
        raise ValueError(f"{mutate!r} not in mrcheck.MUTATIONS")
    tmp = None
    if focus == "service" and workdir is None:
        import shutil
        import tempfile

        tmp = workdir = tempfile.mkdtemp(prefix="mrmodel-")
    try:
        factory = make_harness_factory(focus, workdir=workdir)
        ex = _Explorer(factory, budget=budget, depth=depth, seed=seed,
                       mutate=mutate)
        t0 = time.perf_counter()
        with _quiet():
            ex.run()
        elapsed = time.perf_counter() - t0

        counterexamples = []
        if ex.counterexample is not None:
            sched = ex.counterexample["schedule"]
            target = ex.counterexample["violation"].code

            def fails(cand: list) -> bool:
                h, _infos = ex.replay(cand)
                if mutate:
                    if not h.mutated:
                        return False
                    a = h.artifacts()
                    if not MODEL_MUTATORS[mutate](a):
                        return False
                    return any(x.code == target for x in _validate_mutated(a))
                v = h.step_violations() + h.leaf_violations()
                return any(x.code == target for x in v)

            with _quiet():
                minimal = shrink(sched, fails)
                h, infos = ex.replay(minimal)
                if mutate:
                    a = h.artifacts()
                    MODEL_MUTATORS[mutate](a)
                    violation = next(x for x in _validate_mutated(a)
                                     if x.code == target)
                else:
                    violation = next(x for x in h.step_violations()
                                     + h.leaf_violations()
                                     if x.code == target)
            lease_s = h.cfg.lease_timeout_s
            counterexamples.append({
                "code": violation.code,
                "message": violation.message,
                "events": violation.events,  # the offending pair
                "schedule": [list(ev) for ev in minimal],
                "length": len(minimal),
                "trace": [i["desc"] for i in infos],
                "chaos_spec": chaos_spec(seed, infos, lease_s),
            })

        return {
            "tool": "mrmodel",
            "schema": MODEL_SCHEMA,
            "focus": focus,
            "budget": budget,
            "depth": depth,
            "seed": seed,
            "mutate": mutate,
            "explored": ex.explored,
            "pruned": ex.pruned,
            "steps": ex.steps,
            "elapsed_s": round(elapsed, 3),
            "schedules_per_s": round(ex.explored / elapsed, 1) if elapsed > 0
            else None,
            "ok": not counterexamples,
            "counterexamples": counterexamples,
            "invariants": sorted(INVARIANTS),
            "model_invariants": sorted(MODEL_INVARIANTS),
        }
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def format_doc(doc: dict) -> str:
    lines = [
        f"mrmodel: focus={doc['focus']} explored {doc['explored']} "
        f"schedule(s), pruned {doc['pruned']}, {doc['steps']} step(s) "
        f"in {doc['elapsed_s']}s"
        + (f" ({doc['schedules_per_s']}/s)"
           if doc.get("schedules_per_s") else "")
        + (f" [mutate={doc['mutate']}]" if doc.get("mutate") else ""),
    ]
    for ce in doc["counterexamples"]:
        lines.append(f"COUNTEREXAMPLE [{ce['code']}] {ce['message']}")
        for step, desc in enumerate(ce["trace"], start=1):
            lines.append(f"  {step:2d}. {desc}")
        for e in ce["events"]:
            lines.append(f"  offending: {json.dumps(e, sort_keys=True)}")
        lines.append(f"  chaos repro: {ce['chaos_spec']}")
    lines.append(
        f"mrmodel: {'ok' if doc['ok'] else 'FAILED'} "
        f"({len(doc['counterexamples'])} counterexample(s), "
        f"{len(doc['invariants'])} + {len(doc['model_invariants'])} "
        "invariants checked)")
    return "\n".join(lines)


def run_cli(args) -> int:
    """``model`` subcommand body. Exit 0 = every explored schedule
    conformant, 1 = counterexample found, 2 = unusable arguments."""
    try:
        doc = run_model(
            focus=getattr(args, "focus", "lease"),
            budget=getattr(args, "budget", 5000),
            depth=getattr(args, "depth", 12),
            seed=getattr(args, "seed", 0),
            mutate=getattr(args, "mutate", None),
        )
    except (ValueError, RuntimeError, OSError) as e:
        print(f"mrmodel: {e}", file=sys.stderr)
        return 2
    if getattr(args, "format", "text") == "json":
        print(json.dumps(doc, indent=2, sort_keys=True, default=str))
    else:
        print(format_doc(doc))
    return 0 if doc["ok"] else 1
