"""mrcheck: distributed protocol conformance checker + happens-before
race detector.

The port of ``mapreduce_rust_tpu/analysis/mrcheck.py``, copied whole (it
is stdlib only); its lineage pass reads the port's ``analysis/lineage.py``.

The chaos harness proves recovery *end-to-end* but judges only
final bytes — a protocol violation that happens to produce correct output
(a double-granted lease, a report accepted after revocation, a journal
line racing a re-execution) sails through silently. This module replays
the control-plane artifacts a run already writes — the coordinator
journal, the job report's ordered event log, the coordinator
manifest and (optionally) a merged trace — against an explicit model of
the coordinator protocol, and reports every violation with the offending
event pair and its wall-clock context.

**The protocol model.** Per (phase, tid) the lease/attempt machine is::

    granted -> renewed* -> { finished | expired | revoked | drained }

with the invariants below (the catalog README's "Correctness tooling"
section documents, each traced to the bug class that motivated it):

- ``double-win``            at most one winner per (phase, tid): the
                            journal holds exactly one line, the event log
                            exactly one journaling finish (the idempotent-
                            finish bug class).
- ``report-after-revoke``   a revoked attempt never journals: revocation
                            means another attempt already won
                            (speculation); its report may land only as a
                            late report, never as the winner.
- ``grant-over-live-lease`` no grant while a live lease holds the tid —
                            except a speculation grant, which SHARES the
                            existing lease (never forks a second one).
- ``expire-without-lease``  an expiry needs a live lease: a second expiry
                            for one tid, or an expiry after its finish, is
                            how a forked speculation lease (or a lease
                            surviving its task) shows up in the log.
- ``finish-without-grant``  a completion for a task never granted.
- ``grant-after-deregister`` a drained (deregistered) worker is never
                            granted again (SIGTERM drain).
- ``truncated-event-log``   the report's event log hit its cap and
                            dropped rows — a replay against an incomplete
                            log must never read as fully conformant.
- ``journal-without-finish`` a journal line whose task the report says
                            never completed (the journal-line-racing-a-
                            re-execution class).
- ``finish-without-journal`` a completed task with no journal line (a
                            winner that never journaled cannot seed a
                            resume).
- ``missing-terminator``    the journal-winning attempt's flow chain must
                            be terminated in the trace (a dropped "f" is a
                            finish report the timeline never saw land).
- ``write-race``            two writes to the same (phase, tid)
                            journal/report state with no happens-before
                            path between them — flagged even when the
                            idempotence guard made the outcome benign.

**The happens-before model** (``--trace``, a merged or per-process trace):
program order within each (pid, tid) thread; flow chains ``s -> t -> f``
(grant -> task -> finish); and RPC request/response pairs — the
client's ``rpc.send``/``rpc.recv`` instants bracket the coordinator's
``rpc.*`` span through a shared call id (``cid``), giving send ≤ handle
and handle-end ≤ recv. Writes are the events that mutate authoritative
(phase, tid) completion state: ``coordinator.journal`` instants and
non-revoked flow terminators (a worker's report *send* is a message, and
a revoked terminator mutates nothing). Vector clocks over that DAG decide
concurrency. In today's single-threaded coordinator every write is
program-ordered, so a conformant run can never race — the detector exists
for corrupted/reordered artifacts and for the multi-tenant,
multi-threaded coordinator would make real.

**Seeded-violation fixtures.** ``MUTATIONS`` corrupts a recorded run's
artifacts — double-win, report-after-revoke, grant-over-live-lease,
dropped flow terminator, write race — so every invariant has a known-bad
fixture proving it fires (tests/test_torch_mrcheck.py), while the fault-free
run proves zero false positives.

Pure stdlib, no torch — importable from any control-plane process
(package rule).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

CHECK_SCHEMA = 1

#: code -> (source artifacts, one-line description). The catalog is data,
#: not prose, so tests can assert every invariant has a seeded-violation
#: fixture and README can render it without drifting.
INVARIANTS: dict[str, tuple[str, str]] = {
    "double-win": (
        "journal+events",
        "at most one winner per (phase, tid): one journal line, one "
        "journaling finish",
    ),
    "report-after-revoke": (
        "events+trace",
        "a revoked attempt never journals — its report lands late or not "
        "at all",
    ),
    "grant-over-live-lease": (
        "events",
        "no grant while a live lease holds the tid (speculation shares "
        "the lease, never forks one)",
    ),
    "expire-without-lease": (
        "events",
        "an expiry needs a live lease: double expiry / expiry-after-"
        "finish means a forked or leaked lease",
    ),
    "finish-without-grant": (
        "events",
        "a completion for a task never granted",
    ),
    "grant-after-deregister": (
        "events",
        "a deregistered (drained) worker is never granted again",
    ),
    "truncated-event-log": (
        "events",
        "the event log hit its cap and dropped rows — every event-backed "
        "invariant was checked against an incomplete log",
    ),
    "journal-without-finish": (
        "journal+report",
        "every journal line names a task the report saw complete",
    ),
    "finish-without-journal": (
        "journal+report",
        "every completed task journaled exactly once (resume depends on "
        "it)",
    ),
    "missing-terminator": (
        "trace+journal",
        "the journal-winning attempt's flow chain is terminated (a "
        "dropped 'f' is a finish the timeline never saw)",
    ),
    "write-race": (
        "trace",
        "two journal/report-state writes for one (phase, tid) with no "
        "happens-before path between them",
    ),
    "grant-across-jobs": (
        "events+journal",
        "a lease granted under job A is never renewed/finished/expired "
        "under job B — job state is strictly per-job (the "
        "multi-tenant service's cross-job misroute class)",
    ),
    "job-lifecycle": (
        "service-journal",
        "every job's service-journal rows follow the lifecycle machine: "
        "submit before start/done/cancel, at most one terminal row, no "
        "rows after a terminal (double start = restart re-admission and "
        "done-without-start = cache hit are legal)",
    ),
    "early-reduce-grant": (
        "events",
        "a reduce task granted before the map barrier opens must be "
        "covered by a live part_ready — every map task reported bytes "
        "for its partition, net of part_retract (the pipelined "
        "per-partition release can never hand a reducer a partition "
        "whose inputs are still being written)",
    ),
    "lineage-conservation": (
        "lineage",
        "provenance conserves data: every partition's claimed chunk set "
        "⊆ the chunks some finished attempt (or the driver's scan) "
        "actually digested — an output claiming an unscanned chunk is "
        "fabricated provenance — and a re-executed attempt's chunk list "
        "equals its expired predecessor's (determinism is what "
        "makes re-execution a recovery, not a different job)",
    ),
}


@dataclasses.dataclass
class Violation:
    """One invariant violation, with the offending event pair."""

    code: str
    message: str
    events: list  # the offending pair (journal lines / event-log rows /
                  # trace events), each rendered as a dict with context

    def format(self) -> str:
        lines = [f"VIOLATION [{self.code}] {self.message}"]
        for e in self.events:
            lines.append(f"  - {_fmt_event(e)}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"code": self.code, "message": self.message,
                "events": self.events}


def _fmt_event(e) -> str:
    if not isinstance(e, dict):
        return repr(e)
    if "raw" in e:  # journal line
        return f"journal:{e.get('line', '?')} {e['raw']!r}"
    if "ev" in e:   # report event-log row
        ctx = " ".join(
            f"{k}={e[k]}" for k in ("job", "phase", "tid", "attempt", "wid")
            if k in e
        )
        return f"event t={e.get('t', '?')}s {e['ev']} {ctx}".rstrip()
    if "ph" in e:   # trace event
        args = e.get("args") or {}
        ctx = " ".join(f"{k}={v}" for k, v in sorted(args.items()))
        return (f"trace ts={e.get('ts', '?')}us pid={e.get('pid', '?')} "
                f"{e.get('ph')}:{e.get('name')} {ctx}").rstrip()
    return repr(e)


# ---------------------------------------------------------------------------
# Artifact loading
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JournalLine:
    phase: str
    tid: int
    attempt: "int | None"
    wid: "int | None"
    t: "float | None"
    line: int      # 1-based line number in the journal file
    raw: str
    job: "str | None" = None  # service jobs annotate ``j<id>``

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def parse_journal(text: str) -> list[JournalLine]:
    """Task-completion lines of a coordinator journal. Annotation fields
    (``a2 w1 t12.345 jj3``) are optional — a pre-annotation journal
    parses with them None, exactly like ``_replay_journal`` ignores
    them. The ``j`` annotation is the owning job id of a multi-tenant
    service's per-job journal."""
    out: list[JournalLine] = []
    lines = text.splitlines()
    if text and not text.endswith("\n") and lines:
        lines.pop()  # torn tail — the coordinator distrusts it too
    for i, line in enumerate(lines, start=1):
        parts = line.split()
        if len(parts) < 2 or parts[0] not in ("map", "reduce"):
            continue  # header / corrupt record
        try:
            tid = int(parts[1])
        except ValueError:
            continue
        attempt = wid = t = job = None
        for p in parts[2:]:
            try:
                if p.startswith("a"):
                    attempt = int(p[1:])
                elif p.startswith("w"):
                    wid = int(p[1:])
                elif p.startswith("t"):
                    t = float(p[1:])
                elif p.startswith("j") and len(p) > 1:
                    job = p[1:]
            except ValueError:
                pass  # annotation noise never invalidates the record
        out.append(JournalLine(parts[0], tid, attempt, wid, t, i, line, job))
    return out


def _validate_report(rep, src: str) -> None:
    """A torn or hand-corrupted report must map to exit 2 (unusable
    target), never an AttributeError traceback — which exits 1 and reads
    as 'violations found' to a CI gate that treats 1 and 2 differently."""
    if not isinstance(rep, dict):
        raise ValueError(f"{src}: job report is not a JSON object")
    tasks = rep.get("tasks")
    if tasks is not None:
        if not isinstance(tasks, dict):
            raise ValueError(f"{src}: report 'tasks' is not an object")
        for phase, ts in tasks.items():
            if not isinstance(ts, dict):
                raise ValueError(
                    f"{src}: report tasks[{phase!r}] is not an object")
            for tid_s, entry in ts.items():
                if not isinstance(entry, dict):
                    raise ValueError(
                        f"{src}: report tasks[{phase!r}][{tid_s!r}] is "
                        "not an object")
                try:
                    int(tid_s)
                except (TypeError, ValueError):
                    # Multi-job WRITERS (a ServiceWorker's report spans
                    # every job it served) key task slots "job:tid".
                    _job, sep, tail = str(tid_s).rpartition(":")
                    if not (sep and tail.isdigit()):
                        raise ValueError(
                            f"{src}: report tasks[{phase!r}] key {tid_s!r} "
                            "is not a task id") from None
    events = rep.get("events")
    if events is not None and (
            not isinstance(events, list)
            or not all(isinstance(e, dict) for e in events)):
        raise ValueError(f"{src}: report 'events' is not a list of objects")


def load_artifacts(target: str, journal: "str | None" = None,
                   job_report: "str | None" = None) -> dict:
    """Resolve (journal lines, report dict, source names) from a work dir
    or a manifest/job_report JSON file. Raises FileNotFoundError/ValueError
    on an unusable target — the CLI maps those to exit 2."""
    art: dict = {"journal": None, "report": None, "sources": {},
                 "authoritative": True}
    # EXPLICIT paths must exist: a mistyped --journal/--job-report that
    # silently drops its artifact would skip those invariants and pass as
    # clean — the exact failure mode exit 2 exists to prevent. Only the
    # derived defaults (work-dir / manifest-config lookups) are optional.
    for label, p in (("--journal", journal), ("--job-report", job_report)):
        if p and not os.path.exists(p):
            raise FileNotFoundError(f"{p}: explicit {label} path not found")
    explicit_report = job_report
    if os.path.isdir(target):
        journal = journal or os.path.join(target, "coordinator.journal")
        job_report = job_report or os.path.join(target, "job_report.json")
    else:
        with open(target) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            # A JSON array (e.g. a raw trace fed as the target) must map
            # to exit 2, not an AttributeError traceback — which exits 1
            # and reads as "violations found" to a CI gate.
            raise ValueError(
                f"{target}: not a manifest/job_report object (traces go "
                "under --trace)"
            )
        rep = None
        if doc.get("kind") == "job_report":
            rep = doc.get("report")
        elif "job_report" in doc:        # coordinator manifest
            rep = doc["job_report"]
        elif "report" in doc:            # worker manifest
            rep = doc["report"]
            # A worker's report is its LOCAL view, not the protocol
            # authority: it logs a finish even when the report RPC was
            # dropped (chaos) and a re-granted task as a second
            # grant/finish pair — all legal, none journaling. The
            # state-machine replay and journal cross-checks only run
            # against coordinator-side artifacts; a worker target still
            # gets the journal's internal checks and the trace passes.
            art["authoritative"] = False
        if rep is None and explicit_report is None:
            raise ValueError(
                f"{target}: no job report inside (expected a work dir, a "
                "job_report.json, or a manifest embedding one)"
            )
        if rep is not None:
            art["report"] = rep
            art["sources"]["report"] = target
        work = (doc.get("config") or {}).get("work_dir")
        if journal is None and work \
                and os.path.exists(os.path.join(work, "coordinator.journal")):
            journal = os.path.join(work, "coordinator.journal")
    if journal and os.path.exists(journal):
        with open(journal) as f:
            art["journal"] = parse_journal(f.read())
        art["sources"]["journal"] = journal
    # An EXPLICIT --job-report always wins over whatever the target
    # embedded (its validated path was named on the command line to be
    # checked — silently preferring the manifest's copy would be the
    # skipped-artifact failure mode again), and it is the coordinator's
    # own artifact, so it restores protocol authority even when the
    # target was a worker manifest.
    if job_report and os.path.exists(job_report) and (
            art["report"] is None or explicit_report):
        with open(job_report) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"{job_report}: job report is not a JSON object")
        art["report"] = doc.get("report", doc)
        art["sources"]["report"] = job_report
        if explicit_report:
            art["authoritative"] = True
    if art["report"] is None and art["journal"] is None:
        raise FileNotFoundError(
            f"{target}: neither a coordinator.journal nor a job report "
            "found — nothing to check"
        )
    if art["report"] is not None:
        _validate_report(art["report"], art["sources"].get("report", target))
    return art


# ---------------------------------------------------------------------------
# (a) Lease/attempt state-machine conformance
# ---------------------------------------------------------------------------

def check_events(events: list) -> list[Violation]:
    """Replay the ordered event log against the protocol model. Every
    event must be legal in its machine's current state. Machines are
    keyed ``(job, phase, tid)``: a multi-job service's rows
    carry a ``job`` field and two jobs' task 0 are DIFFERENT machines —
    while a continuation event whose job differs from the job holding
    the (phase, tid) grant is the cross-job misroute the
    ``grant-across-jobs`` invariant names. Single-job logs (no job
    field) replay exactly as before: every key shares job None."""
    v: list[Violation] = []
    lease: dict = {}      # (job, phase, tid) -> grant event holding the lease
    spec_armed: dict = {} # (job, phase, tid) -> pending speculate event
    finished: dict = {}   # (job, phase, tid) -> first (journaling) finish
    revoked: dict = {}    # (job, phase, tid) -> [revoke events]
    deregistered: dict = {}  # wid -> deregister event
    granted: dict = {}    # (job, phase, tid) -> last grant event
    granted_pt: dict = {} # (phase, tid) -> {job: last grant event}
    ready: dict = {}      # job -> reduce tids ready (net of part_retract)

    # Pre-pass: per job, the log position of the LAST first
    # map finish. A reduce grant positioned before it provably preceded
    # the barrier opening — the only schedule that makes that legal is
    # the per-partition release, so a live part_ready must cover it.
    # Late/duplicate map reports (ev "late_finish", or a repeated tid)
    # don't extend the window: the barrier opened at the first reports.
    evs = list(events or [])
    last_map_first_finish: dict = {}
    _seen_map_fin: set = set()
    for i, e in enumerate(evs):
        if (e.get("ev") == "finish" and e.get("phase") == "map"
                and (e.get("job"), e.get("tid")) not in _seen_map_fin):
            _seen_map_fin.add((e.get("job"), e.get("tid")))
            last_map_first_finish[e.get("job")] = i

    def _cross_job(key, pt) -> "dict | None":
        """The other-job grant a job-mismatched continuation event points
        at: a live lease on (phase, tid) under a DIFFERENT job wins;
        any other job's grant is the fallback evidence."""
        by_job = granted_pt.get(pt) or {}
        for other_job, g in by_job.items():
            if other_job != key[0] and (other_job, *pt) in lease:
                return g
        for other_job, g in by_job.items():
            if other_job != key[0]:
                return g
        return None

    for i, e in enumerate(evs):
        ev = e.get("ev")
        job = e.get("job")
        pt = (e.get("phase"), e.get("tid"))
        key = (job, *pt)
        label = f"{pt[0]} {pt[1]}" + (f" [job {job}]" if job else "")
        if ev == "speculate":
            spec_armed[key] = e
        elif ev == "part_ready":
            if pt[0] == "reduce":
                ready.setdefault(job, set()).add(pt[1])
        elif ev == "part_retract":
            if pt[0] == "reduce":
                ready.setdefault(job, set()).discard(pt[1])
        elif ev == "grant":
            if (pt[0] == "reduce"
                    and i < last_map_first_finish.get(job, -1)
                    and pt[1] not in ready.get(job, ())):
                v.append(Violation(
                    "early-reduce-grant",
                    f"{label} granted before readiness — map finish "
                    "reports were still landing and no live part_ready "
                    "covers the partition (its inputs may still be "
                    "written)",
                    [e, evs[last_map_first_finish[job]]],
                ))
            wid = e.get("wid")
            if wid in deregistered:
                v.append(Violation(
                    "grant-after-deregister",
                    f"{label} granted to worker {wid} after it "
                    "deregistered (drained workers are out of the fleet)",
                    [deregistered[wid], e],
                ))
            if key in lease:
                spec = spec_armed.pop(key, None)
                if spec is None:
                    v.append(Violation(
                        "grant-over-live-lease",
                        f"{label} granted while attempt "
                        f"{lease[key].get('attempt')} still holds a live "
                        "lease (only a speculation may share it)",
                        [lease[key], e],
                    ))
                # Shared lease either way: the model keeps ONE entry.
            else:
                spec_armed.pop(key, None)
                lease[key] = e
            granted[key] = e
            granted_pt.setdefault(pt, {})[job] = e
        elif ev == "expire":
            if key not in lease:
                other = _cross_job(key, pt)
                if other is not None:
                    v.append(Violation(
                        "grant-across-jobs",
                        f"{label} lease expired under a job that never "
                        f"granted it — job {other.get('job')!r} holds "
                        "(phase, tid): job state misrouted across "
                        "tenants",
                        [other, e],
                    ))
                else:
                    prior = finished.get(key) or e
                    v.append(Violation(
                        "expire-without-lease",
                        f"{label} lease expired with no live lease "
                        "— a forked speculation lease or an expiry after "
                        "the task finished",
                        [prior, e],
                    ))
            lease.pop(key, None)
        elif ev == "finish":
            if key not in granted:
                other = _cross_job(key, pt)
                if other is not None:
                    v.append(Violation(
                        "grant-across-jobs",
                        f"{label} reported finished under a job that "
                        f"never granted it — job {other.get('job')!r} "
                        "owns the (phase, tid) lease: a lease granted "
                        "under job A must never be finished under job B",
                        [other, e],
                    ))
                else:
                    v.append(Violation(
                        "finish-without-grant",
                        f"{label} reported finished but was never "
                        "granted in this log",
                        [e],
                    ))
            if key in finished:
                v.append(Violation(
                    "double-win",
                    f"{label} journaled twice — attempt "
                    f"{finished[key].get('attempt')} already won",
                    [finished[key], e],
                ))
            else:
                finished[key] = e
                for r in revoked.get(key, []):
                    v.append(Violation(
                        "report-after-revoke",
                        f"{label} accepted a journaling report "
                        "after the attempt was revoked — the winner must "
                        "be decided before any revocation",
                        [r, e],
                    ))
            lease.pop(key, None)
        elif ev == "revoke":
            revoked.setdefault(key, []).append(e)
        elif ev == "deregister":
            if e.get("wid") is not None:
                deregistered[e["wid"]] = e
        # "late_finish" is legal anywhere after a finish: the idempotence
        # guard's whole point. A late finish with NO prior finish would be
        # a first finish — the coordinator cannot emit that.
    return v


def check_journal(journal: list, report: "dict | None") -> list[Violation]:
    """Cross-check the journal against the report's per-task view."""
    v: list[Violation] = []
    # Job-scoped journals: every line of a service job's
    # journal is annotated with the OWNING job id, and the report says
    # whose report it is — a line claiming another job is a completion
    # journaled into the wrong tenant's resume state.
    report_job = (report or {}).get("job")
    if report_job:
        for ln in journal or []:
            if ln.job and ln.job != report_job:
                v.append(Violation(
                    "grant-across-jobs",
                    f"{ln.phase} {ln.tid} journaled under job {ln.job!r} "
                    f"inside job {report_job!r}'s journal — a completion "
                    "written into the wrong tenant's resume state",
                    [ln.to_dict(), {"ev": "report-job", "job": report_job}],
                ))
    seen: dict = {}
    for ln in journal or []:
        key = (ln.phase, ln.tid)
        if key in seen:
            v.append(Violation(
                "double-win",
                f"{ln.phase} {ln.tid} journaled twice (resume would "
                "replay a task two coordinators both claim to own)",
                [seen[key].to_dict(), ln.to_dict()],
            ))
        else:
            seen[key] = ln
    tasks = (report or {}).get("tasks") or {}
    for key, ln in seen.items():
        entry = tasks.get(key[0], {}).get(str(key[1]))
        if entry is not None and not entry.get("reports", 0):
            v.append(Violation(
                "journal-without-finish",
                f"{key[0]} {key[1]} has a journal line but the report "
                "never saw it complete — a journal write raced the task "
                "state",
                [ln.to_dict(), {"ev": "report-entry", **entry,
                                "phase": key[0], "tid": key[1]}],
            ))
    if journal is not None:
        for phase, ts in tasks.items():
            for tid_s, entry in ts.items():
                if entry.get("reports", 0) and \
                        (phase, int(tid_s)) not in seen:
                    v.append(Violation(
                        "finish-without-journal",
                        f"{phase} {tid_s} completed but never journaled — "
                        "a restart would re-run a task whose outputs "
                        "already exist",
                        [{"ev": "report-entry", **entry, "phase": phase,
                          "tid": int(tid_s)}],
                    ))
    return v


# ---------------------------------------------------------------------------
# (b) Happens-before race detection over a (merged) trace
# ---------------------------------------------------------------------------

def _hb_vector_clocks(events: list) -> "tuple[list, list] | None":
    """(nodes, vector clocks) for a trace-event list, or None when a
    cycle prevents the topological pass (broken artifact — the caller
    reports it instead of guessing).

    Nodes are the real events plus one synthetic end-node per cid-carrying
    RPC span (the response leaves AFTER the handler body, so the recv edge
    must originate at span end — an edge from span start would lose the
    journal append that happened inside the handler)."""
    nodes: list[dict] = []
    for seq, ev in enumerate(events):
        if ev.get("ph") == "M":
            continue
        n = dict(ev)
        n["_seq"] = seq
        nodes.append(n)
        if ev.get("ph") == "X" and (ev.get("args") or {}).get("cid"):
            nodes.append({
                "name": ev["name"], "ph": "_span_end",
                "ts": ev["ts"] + ev.get("dur", 0),
                "pid": ev["pid"], "tid": ev["tid"],
                "args": ev.get("args"), "_seq": seq,
            })
    # Program order per (pid, tid).
    threads: dict = {}
    for i, n in enumerate(nodes):
        threads.setdefault((n["pid"], n["tid"]), []).append(i)
    for idxs in threads.values():
        idxs.sort(key=lambda i: (nodes[i]["ts"], nodes[i]["_seq"]))
    tindex = {key: t for t, key in enumerate(sorted(threads, key=str))}

    edges: dict[int, list[int]] = {i: [] for i in range(len(nodes))}
    indeg = [0] * len(nodes)

    def add_edge(a: int, b: int) -> None:
        edges[a].append(b)
        indeg[b] += 1

    for idxs in threads.values():
        for a, b in zip(idxs, idxs[1:]):
            add_edge(a, b)
    # RPC pairs: send -> span start; span end -> recv.
    spans: dict = {}
    ends: dict = {}
    sends: dict = {}
    recvs: dict = {}
    for i, n in enumerate(nodes):
        cid = (n.get("args") or {}).get("cid")
        if not cid:
            continue
        if n.get("ph") == "X":
            spans[cid] = i
        elif n.get("ph") == "_span_end":
            ends[cid] = i
        elif n.get("name") == "rpc.send":
            sends[cid] = i
        elif n.get("name") == "rpc.recv":
            recvs[cid] = i
    for cid, s in sends.items():
        if cid in spans:
            add_edge(s, spans[cid])
    for cid, r in recvs.items():
        if cid in ends:
            add_edge(ends[cid], r)
    # Flow chains: consecutive s -> t -> f order each chain's events.
    order = {"s": 0, "t": 1, "f": 2}
    chains: dict = {}
    for i, n in enumerate(nodes):
        if n.get("ph") in ("s", "t", "f"):
            chains.setdefault(n.get("id"), []).append(i)
    for idxs in chains.values():
        idxs.sort(key=lambda i: (
            nodes[i]["ts"], order[nodes[i]["ph"]], nodes[i]["_seq"]
        ))
        for a, b in zip(idxs, idxs[1:]):
            add_edge(a, b)

    # Kahn + vector clocks: vc[b] = max over preds, then tick own thread.
    from collections import deque

    T = len(tindex)
    vcs: list = [None] * len(nodes)
    counters = [0] * T  # per-thread event count = the clock tick
    ready = deque(sorted(
        (i for i in range(len(nodes)) if indeg[i] == 0),
        key=lambda i: (nodes[i]["ts"], nodes[i]["_seq"]),
    ))
    done = 0
    while ready:
        i = ready.popleft()
        t = tindex[(nodes[i]["pid"], nodes[i]["tid"])]
        # Incoming joins were folded into vcs[i] as predecessors finished;
        # ticking the own component makes this node's clock.
        vc = vcs[i] if vcs[i] is not None else [0] * T
        vcs[i] = vc
        counters[t] += 1
        vc[t] = max(vc[t], counters[t])
        for j in edges[i]:
            if vcs[j] is None:
                vcs[j] = [0] * T
            vcs[j] = [max(a, b) for a, b in zip(vcs[j], vc)]
            indeg[j] -= 1
            if indeg[j] == 0:
                ready.append(j)
        done += 1
    if done != len(nodes):
        return None  # cycle: corrupted artifact
    for i, n in enumerate(nodes):
        n["_thread"] = tindex[(n["pid"], n["tid"])]
        n["_vc"] = vcs[i]
    return nodes, vcs


def _happens_before(a: dict, b: dict) -> bool:
    return b["_vc"][a["_thread"]] >= a["_vc"][a["_thread"]]


def _strip_internal(n: dict) -> dict:
    return {k: v for k, v in n.items() if not k.startswith("_")}


def check_trace(events: list, journal: "list | None" = None) -> list[Violation]:
    """Happens-before race detection + flow-terminator conformance over a
    trace-event list (merged or per-process)."""
    v: list[Violation] = []
    built = _hb_vector_clocks(events)
    if built is None:
        # A cyclic happens-before graph is an UNUSABLE artifact, not a
        # race: reporting it under an invariant code would let a broken
        # trace masquerade as a detector finding. ValueError maps to the
        # CLI's exit 2 (same class as a torn report), and bench counts an
        # uncheckable leg as failed.
        raise ValueError(
            "trace happens-before graph contains a cycle — the artifact "
            "is corrupt; race analysis impossible"
        )
    nodes, _vcs = built

    # Writes to (phase, tid) journal/report state: the journal append and
    # the non-revoked flow terminator (report acceptance). A revoked
    # terminator mutates nothing; a worker's report SEND is a message.
    writes: dict = {}
    for n in nodes:
        args = n.get("args") or {}
        # Job-scoped: service events carry a ``job`` arg, and
        # two jobs' writes to their own task 0 are DISJOINT state — only
        # same-job (phase, tid) pairs can race. Single-job traces have no
        # job arg; every key shares None, exactly the old behavior.
        key = (args.get("job"), args.get("phase"), args.get("tid"))
        if key[1] is None or key[2] is None:
            continue
        if n.get("name") == "coordinator.journal" or (
            n.get("ph") == "f" and not args.get("revoked")
        ):
            writes.setdefault(key, []).append(n)
    for key, ws in sorted(writes.items(), key=str):
        for i in range(len(ws)):
            for j in range(i + 1, len(ws)):
                a, b = ws[i], ws[j]
                if not (_happens_before(a, b) or _happens_before(b, a)):
                    v.append(Violation(
                        "write-race",
                        f"{key[1]} {key[2]}"
                        + (f" [job {key[0]}]" if key[0] else "")
                        + ": two journal/report-state "
                        "writes with no happens-before path between them "
                        "(benign under today's idempotence guard, but a "
                        "real race)",
                        [_strip_internal(a), _strip_internal(b)],
                    ))

    # Dropped flow terminator: the journal-winning attempt's chain must
    # carry an "f". Non-winning chains may legally stay unterminated (a
    # crashed attempt looks exactly like that).
    if journal:
        chains: dict = {}
        starts: dict = {}
        for n in nodes:
            if n.get("ph") in ("s", "t", "f"):
                chains.setdefault(n.get("id"), set()).add(n["ph"])
                starts.setdefault(n.get("id"), _strip_internal(n))
        for ln in journal:
            if not ln.attempt:  # 0/None = unattributed (pre-annotation)
                continue
            # Service chains carry the job prefix (Coordinator._fid).
            fid = f"{ln.phase}:{ln.tid}:{ln.attempt}"
            if ln.job:
                fid = f"{ln.job}:{fid}"
            phs = chains.get(fid)
            # Only chains whose START ("s") is in THIS artifact owe a
            # terminator: the coordinator emits both s and f, so a start
            # without a finish is a dropped terminator — while a
            # worker-side per-process trace legally carries only the "t"
            # steps of chains it participated in.
            if phs and "s" in phs and "f" not in phs:
                v.append(Violation(
                    "missing-terminator",
                    f"{ln.phase} {ln.tid} attempt {ln.attempt} won the "
                    "journal but its flow chain was never terminated — "
                    "the finish report this line records never appears "
                    "in the timeline",
                    [ln.to_dict(), starts[fid]],
                ))
    return v


# ---------------------------------------------------------------------------
# Driver + CLI
# ---------------------------------------------------------------------------

def load_service_journal(path: str) -> list:
    """Rows of a JobService admission journal (JSONL). Torn tail and
    non-row lines are skipped — the service's own replay distrusts them
    the same way."""
    with open(path) as f:
        text = f.read()
    lines = text.splitlines()
    if text and not text.endswith("\n") and lines:
        lines.pop()  # torn tail
    rows = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(row, dict) and row.get("job") and row.get("op"):
            rows.append(row)
    return rows


def check_service_journal(rows: list) -> "list[Violation]":
    """Job-lifecycle state machine over a service admission journal
    submit -> start -> done|cancel per job, in file order.

    Legal shapes the machine must NOT flag: a second ``start`` (service
    restart re-admits a requeued job), ``done`` without ``start`` (cache
    hit / joined twin settles a job straight from the queue), ``cancel``
    from the queue. Violations: any row for a job never submitted, a
    second terminal row, and any row after a terminal one.
    """
    violations: list[Violation] = []
    state: dict = {}  # jid -> "queued" | "running" | terminal op

    def _ev(row: dict) -> dict:
        return {"ev": "service-journal", "op": row.get("op"),
                "job": row.get("job"), "t": row.get("t")}

    first: dict = {}  # jid -> first row (for violation context)
    for row in rows:
        jid, op = row["job"], row["op"]
        st = state.get(jid)
        if st in ("done", "cancel"):
            violations.append(Violation(
                "job-lifecycle",
                f"job {jid}: '{op}' row after terminal '{st}' — a settled "
                "job's lifecycle is closed (no grants, no re-settling)",
                [first[jid], _ev(row)],
            ))
            continue
        if op == "submit":
            if st is not None:
                violations.append(Violation(
                    "job-lifecycle",
                    f"job {jid}: duplicate submit — job ids are single-"
                    "use",
                    [first[jid], _ev(row)],
                ))
                continue
            state[jid] = "queued"
            first[jid] = _ev(row)
        elif op in ("start", "done", "cancel"):
            if st is None:
                violations.append(Violation(
                    "job-lifecycle",
                    f"job {jid}: '{op}' without a prior submit — the "
                    "admission journal is the single source of job "
                    "existence",
                    [_ev(row)],
                ))
                continue
            state[jid] = "running" if op == "start" else op
            # first[] already set by submit
    return violations


def _service_journal_pass(target: str, checked: dict,
                          violations: list) -> None:
    """Run the job-lifecycle machine over ``<target>/service.journal``
    when present (service root, or a single-job dir checked alongside
    the service journal that admitted it). Appends Violation dicts and
    records the row count under ``checked['service_journal_lines']`` —
    a separate counter, so per-job ``journal_lines`` stays comparable
    across single-job and service runs."""
    spath = os.path.join(target, "service.journal")
    if not os.path.isfile(spath):
        return
    rows = load_service_journal(spath)
    checked["service_journal_lines"] = len(rows)
    checked["sources"]["service_journal"] = spath
    violations.extend(x.to_dict() for x in check_service_journal(rows))


def check_lineage(led: dict) -> list[Violation]:
    """Conservation pass over one parsed ledger: claims must
    be scanned, re-executions must agree. Takes analysis.lineage's
    load_ledger dict so mrcheck and the query CLI share one parser."""
    out: list[Violation] = []
    scanned: set = {c.get("dg") for c in led["chunks"] if c.get("dg")}
    for a in led["attempts"]:
        scanned.update(a.get("chunks") or [])
    for p in led["parts"]:
        ghost = sorted(set(p.get("chunks") or []) - scanned)
        if ghost:
            out.append(Violation(
                "lineage-conservation",
                f"partition {p.get('r')} claims {len(ghost)} chunk(s) no "
                "attempt or scan ever digested (fabricated provenance): "
                f"{ghost[:3]}{'…' if len(ghost) > 3 else ''}",
                [p],
            ))
    by_task: dict = {}
    for a in led["attempts"]:
        by_task.setdefault((a.get("phase"), a.get("tid")), []).append(a)
    for (phase, tid), atts in by_task.items():
        base = atts[0]
        for a in atts[1:]:
            if a.get("chunks") != base.get("chunks"):
                out.append(Violation(
                    "lineage-conservation",
                    f"{phase} {tid}: attempt {a.get('attempt')} scanned a "
                    f"different chunk list than attempt "
                    f"{base.get('attempt')} — re-execution diverged from "
                    "its predecessor (nondeterministic ingest or wrong "
                    "inputs)",
                    [base, a],
                ))
    return out


def _lineage_pass(target: str, checked: dict, violations: list) -> None:
    """Run the lineage-conservation invariant over ``<target>/
    lineage.jsonl`` when present (a --lineage run's work dir — driver or
    cluster). Appends Violation dicts; torn/partial ledgers check
    whatever records survived (the recorder's crash-durability contract
    means a SIGKILLed run's ledger is still a valid, shorter ledger)."""
    lpath = os.path.join(target, "lineage.jsonl")
    if not os.path.isfile(lpath):
        return
    from mapreduce_rust_tpu_torch.analysis.lineage import LineageError, load_ledger

    try:
        led = load_ledger(lpath)
    except LineageError:
        return  # unreadable ledger — nothing checkable
    checked["lineage_records"] = (len(led["chunks"]) + len(led["attempts"])
                                  + len(led["parts"]))
    checked["sources"]["lineage"] = lpath
    violations.extend(x.to_dict() for x in check_lineage(led))


def _service_job_dirs(target: str) -> list:
    """job-* subdirs of a JobService work root that hold checkable
    artifacts (per-job journal or job report)."""
    import glob as _glob

    return sorted(
        d for d in _glob.glob(os.path.join(target, "job-*"))
        if os.path.isdir(d) and (
            os.path.exists(os.path.join(d, "coordinator.journal"))
            or os.path.exists(os.path.join(d, "job_report.json"))
        )
    )


def _violation_job(x: dict) -> "str | None":
    """Best-effort job attribution of a trace-pass violation: the job id
    its offending events carry (event-log rows and journal lines hold it
    top-level, trace events under args)."""
    for e in x.get("events") or []:
        if not isinstance(e, dict):
            continue
        job = e.get("job") or (e.get("args") or {}).get("job")
        if job:
            return str(job)
    return None


def run_check_service(target: str, job_dirs: list,
                      trace: "str | None" = None) -> dict:
    """Multi-job conformance: replay every job's artifacts
    under the SAME invariant catalog — each job dir is one machine set
    (its rows are job-stamped, so the cross-job invariant stays armed) —
    and aggregate into one document. A shared service trace is checked
    ONCE, against the union of every job's journal lines (flow ids and
    write keys are job-scoped, so chains never alias): per-job re-scans
    would report each trace violation N times and stamp it with every
    innocent job's id."""
    violations: list[dict] = []
    jobs: dict = {}
    checked: dict = {"events": 0, "journal_lines": 0, "jobs": len(job_dirs),
                     "sources": {"service_root": target}}
    all_journal: list = []
    for d in job_dirs:
        jid = os.path.basename(d)[len("job-"):]
        doc = run_check(d)
        jobs[jid] = {"ok": doc["ok"],
                     "violations": len(doc["violations"])}
        for x in doc["violations"]:
            violations.append({**x, "job": jid})
        checked["events"] += doc["checked"]["events"]
        checked["journal_lines"] += doc["checked"]["journal_lines"]
        jpath = os.path.join(d, "coordinator.journal")
        if os.path.exists(jpath):
            with open(jpath) as f:
                all_journal.extend(parse_journal(f.read()))
    if trace:
        with open(trace) as f:
            doc = json.load(f)
        trace_events = doc.get("traceEvents") if isinstance(doc, dict) \
            else doc
        if not isinstance(trace_events, list):
            raise ValueError(f"{trace}: no traceEvents list")
        for x in check_trace(trace_events, all_journal):
            row = x.to_dict()
            job = _violation_job(row)
            if job is not None:
                row["job"] = job
                if job in jobs:
                    jobs[job]["ok"] = False
                    jobs[job]["violations"] += 1
            violations.append(row)
        checked["trace_events"] = len(trace_events)
        checked["sources"]["trace"] = trace
    _service_journal_pass(target, checked, violations)
    return {
        "tool": "mrcheck",
        "schema": CHECK_SCHEMA,
        "kind": "service",
        "ok": not violations,
        "violations": violations,
        "invariants": sorted(INVARIANTS),
        "jobs": jobs,
        "checked": checked,
    }


def check_stream(events: list, journal: "list | None" = None,
                 report: "dict | None" = None,
                 events_dropped: "int | None" = None) -> list[Violation]:
    """Schedule-callable invariant pass over IN-MEMORY artifacts: the ordered event rows, optionally the parsed journal lines and
    the report dict — no files, no tempfile round-trips, so mrmodel can
    validate every explored prefix per-step. run_check's authoritative
    file-backed pass routes through here; ``events_dropped`` defaults to
    the report's own counter."""
    violations = check_events(events or [])
    violations += check_journal(journal, report)
    if events_dropped is None:
        events_dropped = (report or {}).get("events_dropped") or 0
    if events_dropped:
        # The cap's contract is "counted, never silent" — and mrcheck
        # is the counter's one consumer. A truncated log means any
        # event-backed violation AFTER the cap is invisible, so an
        # exit-0 here would be the oracle silently not running.
        violations.append(Violation(
            "truncated-event-log",
            f"the event log dropped {events_dropped} row(s) at its cap — "
            "the event-backed invariants were replayed against an "
            "incomplete log (a violation past the cap is invisible)",
            [{"ev": "events_dropped", "count": events_dropped},
             events[-1] if events else {"ev": "empty-log"}],
        ))
    return violations


def run_check(target: str, trace: "str | None" = None,
              journal: "str | None" = None,
              job_report: "str | None" = None) -> dict:
    """Full conformance document for one run's artifacts. A JobService
    work root (job-* subdirs, no top-level coordinator.journal) fans out
    to every job's artifact set — see run_check_service."""
    if (os.path.isdir(target) and journal is None and job_report is None
            and not os.path.exists(
                os.path.join(target, "coordinator.journal"))):
        job_dirs = _service_job_dirs(target)
        if job_dirs:
            return run_check_service(target, job_dirs, trace=trace)
    art = load_artifacts(target, journal=journal, job_report=job_report)
    report = art["report"] or {}
    violations: list[Violation] = []
    events = report.get("events") or []
    dropped = report.get("events_dropped") or 0
    if art["authoritative"]:
        violations += check_stream(events, art["journal"], report,
                                   events_dropped=dropped)
    else:
        # Worker-side target: its local event log is not the protocol
        # authority (see load_artifacts) — replaying it would call a
        # dropped-RPC retry a double-win. The journal keeps its internal
        # invariant; the report-backed cross-checks stand down.
        violations += check_journal(art["journal"], None)
    trace_events = None
    if trace:
        with open(trace) as f:
            doc = json.load(f)
        trace_events = doc.get("traceEvents") if isinstance(doc, dict) else doc
        if not isinstance(trace_events, list):
            raise ValueError(f"{trace}: no traceEvents list")
        try:
            violations += check_trace(trace_events, art["journal"])
        except ValueError as e:
            raise ValueError(f"{trace}: {e}") from None
        art["sources"]["trace"] = trace
    vdicts = [x.to_dict() for x in violations]
    checked = {
        "events": len(events),
        "events_dropped": dropped,
        "authoritative": art["authoritative"],
        "journal_lines": len(art["journal"] or []),
        "trace_events": len(trace_events) if trace_events is not None
        else None,
        "sources": art["sources"],
    }
    if os.path.isdir(target):
        # A single-job work dir can carry the admission journal that
        # admitted it (mutation fixtures, copied service legs) — the
        # lifecycle machine runs wherever the artifact lands. Same for a
        # --lineage run's provenance ledger.
        _service_journal_pass(target, checked, vdicts)
        _lineage_pass(target, checked, vdicts)
    return {
        "tool": "mrcheck",
        "schema": CHECK_SCHEMA,
        "ok": not vdicts,
        "violations": vdicts,
        "invariants": sorted(INVARIANTS),
        "checked": checked,
    }


def run_cli(args) -> int:
    """``check`` subcommand body. Exit 0 = conformant, 1 = violations,
    2 = unusable target (a mistyped path must not pass as clean)."""
    try:
        doc = run_check(
            args.target,
            trace=getattr(args, "trace", None),
            journal=getattr(args, "journal", None),
            job_report=getattr(args, "job_report", None),
        )
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"mrcheck: {e}", file=sys.stderr)
        return 2
    if getattr(args, "format", "text") == "json":
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0 if doc["ok"] else 1
    c = doc["checked"]
    srcs = ", ".join(f"{k}={v}" for k, v in sorted(c["sources"].items()))
    print(f"mrcheck: {c['events']} event(s), {c['journal_lines']} journal "
          f"line(s)"
          + (f", {c['jobs']} job(s)" if c.get("jobs") is not None else "")
          + (f", {c['trace_events']} trace event(s)"
             if c.get("trace_events") is not None else "")
          + f" [{srcs}]")
    for x in doc["violations"]:
        print(Violation(x["code"], x["message"], x["events"]).format())
    print(f"mrcheck: {'ok' if doc['ok'] else 'FAILED'} "
          f"({len(doc['violations'])} violation(s), "
          f"{len(doc['invariants'])} invariants checked)")
    return 0 if doc["ok"] else 1


# ---------------------------------------------------------------------------
# Seeded-violation mutation harness
# ---------------------------------------------------------------------------

def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _dump_json(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f)


def _report_doc(workdir: str) -> tuple[str, dict, dict]:
    """(path, document, report-dict-inside) of a work dir's job report."""
    path = os.path.join(workdir, "job_report.json")
    doc = _load_json(path)
    return path, doc, doc.get("report", doc)


def mutate_double_win(workdir: str) -> str:
    """Duplicate the last completion line of the journal — two winners."""
    path = os.path.join(workdir, "coordinator.journal")
    with open(path) as f:
        lines = f.read().splitlines()
    task_lines = [ln for ln in lines if ln.startswith(("map ", "reduce "))]
    dup = task_lines[-1].split()
    # The duplicate claims the NEXT attempt: the classic double-win is the
    # re-executed attempt's report also journaling.
    if len(dup) >= 3 and dup[2].startswith("a"):
        dup[2] = f"a{int(dup[2][1:] or 0) + 1}"
    with open(path, "a") as f:
        f.write(" ".join(dup) + "\n")
    return "double-win"


def mutate_report_after_revoke(workdir: str) -> str:
    """Insert a revocation of the winning attempt BEFORE its finish in
    the event log — the checker must refuse the finish."""
    path, doc, rep = _report_doc(workdir)
    events = rep.get("events") or []
    i, fin = next(
        (i, e) for i, e in enumerate(events) if e.get("ev") == "finish"
    )
    revoke = {"t": max(fin.get("t", 0.0) - 0.001, 0.0), "ev": "revoke",
              "phase": fin.get("phase"), "tid": fin.get("tid")}
    rep["events"] = events[:i] + [revoke] + events[i:]
    _dump_json(path, doc)
    return "report-after-revoke"


def mutate_grant_over_live_lease(workdir: str) -> str:
    """Insert a second, non-speculative grant of a tid while its first
    lease is live (between grant and finish)."""
    path, doc, rep = _report_doc(workdir)
    events = rep.get("events") or []
    i, g = next((i, e) for i, e in enumerate(events) if e.get("ev") == "grant")
    dup = dict(g)
    dup["attempt"] = (g.get("attempt") or 1) + 1
    dup["t"] = g.get("t", 0.0) + 0.001
    rep["events"] = events[:i + 1] + [dup] + events[i + 1:]
    _dump_json(path, doc)
    return "grant-over-live-lease"


def mutate_drop_terminator(workdir: str, trace_path: str) -> str:
    """Remove the flow terminator of a journal-winning attempt from the
    trace — the finish the journal records never lands in the timeline."""
    with open(os.path.join(workdir, "coordinator.journal")) as f:
        journal = parse_journal(f.read())
    winners = {
        f"{ln.phase}:{ln.tid}:{ln.attempt}" for ln in journal if ln.attempt
    }
    doc = _load_json(trace_path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    victim = next(
        e for e in events if e.get("ph") == "f" and e.get("id") in winners
    )
    events.remove(victim)
    _dump_json(trace_path, doc)
    return "missing-terminator"


def mutate_write_race(workdir: str, trace_path: str) -> str:
    """Clone a journal-state write onto a foreign thread with no
    happens-before edges — the duplicate-write race the idempotence guard
    would silently absorb."""
    doc = _load_json(trace_path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    src = next(
        e for e in events
        if e.get("name") == "coordinator.journal" and e.get("ph") == "i"
    )
    ghost = dict(src)
    ghost["pid"] = 999999  # a process the trace has no edges to
    ghost["tid"] = 1
    events.append(ghost)
    _dump_json(trace_path, doc)
    return "write-race"


def mutate_expire_without_lease(workdir: str) -> str:
    """Insert a lease expiry AFTER a task's finish — the leaked/forked
    lease signature (a finish settles the lease; nothing is left to
    expire)."""
    path, doc, rep = _report_doc(workdir)
    events = rep.get("events") or []
    i, fin = next(
        (i, e) for i, e in enumerate(events) if e.get("ev") == "finish"
    )
    exp = {"t": fin.get("t", 0.0) + 0.001, "ev": "expire",
           "phase": fin.get("phase"), "tid": fin.get("tid"),
           "attempt": fin.get("attempt")}
    rep["events"] = events[:i + 1] + [exp] + events[i + 1:]
    _dump_json(path, doc)
    return "expire-without-lease"


def mutate_finish_without_grant(workdir: str) -> str:
    """Insert a completion for a tid the log never granted — a report the
    coordinator should have had no lease to accept."""
    path, doc, rep = _report_doc(workdir)
    events = rep.get("events") or []
    i, fin = next(
        (i, e) for i, e in enumerate(events) if e.get("ev") == "finish"
    )
    ghost = dict(fin)
    ghost["tid"] = 999999  # never granted anywhere in the log
    rep["events"] = events[:i + 1] + [ghost] + events[i + 1:]
    _dump_json(path, doc)
    return "finish-without-grant"


def mutate_grant_after_deregister(workdir: str) -> str:
    """Deregister a worker BEFORE its grant in the event log — a drained
    worker handed a lease anyway."""
    path, doc, rep = _report_doc(workdir)
    events = rep.get("events") or []
    i, g = next(
        (i, e) for i, e in enumerate(events)
        if e.get("ev") == "grant" and e.get("wid") is not None
    )
    dereg = {"t": max(g.get("t", 0.0) - 0.001, 0.0), "ev": "deregister",
             "wid": g["wid"]}
    rep["events"] = events[:i] + [dereg] + events[i:]
    _dump_json(path, doc)
    return "grant-after-deregister"


def mutate_truncate_event_log(workdir: str) -> str:
    """Drop the event log's tail and count it in events_dropped — the
    EVENT_CAP overflow signature (telemetry.record_event drops rows past
    the cap and only counts them). A checker that trusts a truncated log
    calls an incomplete replay conformant."""
    path, doc, rep = _report_doc(workdir)
    events = rep.get("events") or []
    # The recorded run ends with the two deregisters: dropping exactly
    # those simulates the cap without tripping any OTHER invariant (the
    # cross-fire test depends on that).
    rep["events"] = events[:-2]
    rep["events_dropped"] = (rep.get("events_dropped") or 0) + 2
    _dump_json(path, doc)
    return "truncated-event-log"


def mutate_journal_without_finish(workdir: str) -> str:
    """Zero a journaled task's report count — the journal line now races
    a completion the report never saw (the journal-write-racing-task-state
    class)."""
    path, doc, rep = _report_doc(workdir)
    with open(os.path.join(workdir, "coordinator.journal")) as f:
        ln = parse_journal(f.read())[0]
    entry = rep["tasks"][ln.phase][str(ln.tid)]
    entry["reports"] = 0
    # The matching event-log rows must go too, or the corruption would be
    # (correctly) self-inconsistent rather than the targeted violation.
    rep["events"] = [
        e for e in rep.get("events") or []
        if not (e.get("ev") in ("finish", "late_finish")
                and (e.get("phase"), e.get("tid")) == (ln.phase, ln.tid))
    ]
    _dump_json(path, doc)
    return "journal-without-finish"


def mutate_grant_across_jobs(workdir: str) -> str:
    """Re-stamp a finish event's ``job`` field to a foreign job id — the
    cross-job misroute: the (phase, tid) lease was granted under one job
    and its completion lands under another. The grant keeps
    its own job (None on a single-job recording — still a mismatch: the
    machines are keyed by job, and a finish arriving under job 'j999'
    for a lease job None holds fires exactly this invariant)."""
    path, doc, rep = _report_doc(workdir)
    events = rep.get("events") or []
    i, fin = next(
        (i, e) for i, e in enumerate(events) if e.get("ev") == "finish"
    )
    fin["job"] = "j999"
    _dump_json(path, doc)
    return "grant-across-jobs"


def mutate_finish_without_journal(workdir: str) -> str:
    """Drop a completed task's journal line — a restart would re-run a
    task whose outputs already exist."""
    path = os.path.join(workdir, "coordinator.journal")
    with open(path) as f:
        lines = f.read().splitlines()
    victim = next(
        ln for ln in lines if ln.startswith(("map ", "reduce "))
    )
    lines.remove(victim)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return "finish-without-journal"


def mutate_job_lifecycle(workdir: str) -> str:
    """Synthesize a corrupt service admission journal beside the run's
    artifacts: a 'start' row for a job never submitted, then a row after
    the job settles. The single-job fixture has no service.journal of its
    own — the lifecycle machine runs wherever the artifact lands, so a
    planted one exercises it end to end."""
    rows = [
        {"op": "start", "job": "ghost", "t": 0.5},       # never submitted
        {"op": "submit", "job": "j1", "t": 1.0},
        {"op": "start", "job": "j1", "t": 1.1},
        {"op": "done", "job": "j1", "t": 2.0, "state": "done"},
        {"op": "start", "job": "j1", "t": 2.5},          # after terminal
    ]
    with open(os.path.join(workdir, "service.journal"), "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return "job-lifecycle"


def mutate_early_reduce_grant(workdir: str) -> str:
    """Clone a reduce grant to BEFORE the first map finish — a reduce
    task handed out while its partition's map inputs were still being
    written (no part_ready can cover it at that position, and map finish
    reports are provably still landing after it). A matching expire
    follows the ghost so the recording's real grant of the same tid
    doesn't cross-fire grant-over-live-lease."""
    path, doc, rep = _report_doc(workdir)
    events = rep.get("events") or []
    i, first_map_fin = next(
        (i, e) for i, e in enumerate(events)
        if e.get("ev") == "finish" and e.get("phase") == "map"
    )
    g = next(e for e in events
             if e.get("ev") == "grant" and e.get("phase") == "reduce")
    t = max(first_map_fin.get("t", 0.0) - 0.002, 0.0)
    ghost = dict(g)
    ghost["t"] = t
    exp = {"t": t + 0.001, "ev": "expire", "phase": "reduce",
           "tid": g.get("tid"), "attempt": g.get("attempt")}
    if g.get("job") is not None:
        exp["job"] = g["job"]
    rep["events"] = events[:i] + [ghost, exp] + events[i:]
    _dump_json(path, doc)
    return "early-reduce-grant"


def mutate_lineage_conservation(workdir: str) -> str:
    """Corrupt (or synthesize) the work dir's provenance ledger so a
    partition claims a chunk digest nothing ever scanned — the
    fabricated-provenance half of the invariant. Runs on recordings made
    without --lineage too (the job-lifecycle synthesize precedent): the
    pass arms on the file's presence, not on how the run was configured."""
    path = os.path.join(workdir, "lineage.jsonl")
    ghost = "deadbeef" * 4  # 32 hex chars no scan could have produced
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = [line.rstrip("\n") for line in f if line.strip()]
    if not rows:
        rows = [
            json.dumps({"t": "start", "schema": 1,
                        "corpus_meta_digest": "0" * 16,
                        "corpus_bytes": 64, "reduce_n": 1,
                        "inputs": ["doc0.txt"], "pid": 0}),
            json.dumps({"t": "chunk", "seq": 0, "doc": 0, "bytes": 64,
                        "dg": "ab" * 16, "parts": [0]}),
        ]
    rows.append(json.dumps({"t": "part", "r": 0, "bytes": 64,
                            "chunks": [ghost]}))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return "lineage-conservation"


#: name -> (needs_trace, mutator). The seeded-violation fixture table:
#: every entry corrupts a RECORDED run's artifacts so the named invariant
#: fires with the offending event pair — proving the checker detects it —
#: while the unmutated run proves zero false positives.
#: tests/test_mrcheck.py asserts this table covers EVERY invariant in the
#: catalog: an invariant without a known-bad fixture is an invariant
#: nobody has proven fires.
MUTATIONS: dict = {
    "double-win": (False, mutate_double_win),
    "report-after-revoke": (False, mutate_report_after_revoke),
    "grant-over-live-lease": (False, mutate_grant_over_live_lease),
    "expire-without-lease": (False, mutate_expire_without_lease),
    "finish-without-grant": (False, mutate_finish_without_grant),
    "grant-after-deregister": (False, mutate_grant_after_deregister),
    "truncated-event-log": (False, mutate_truncate_event_log),
    "journal-without-finish": (False, mutate_journal_without_finish),
    "finish-without-journal": (False, mutate_finish_without_journal),
    "missing-terminator": (True, mutate_drop_terminator),
    "write-race": (True, mutate_write_race),
    "grant-across-jobs": (False, mutate_grant_across_jobs),
    "job-lifecycle": (False, mutate_job_lifecycle),
    "early-reduce-grant": (False, mutate_early_reduce_grant),
    "lineage-conservation": (False, mutate_lineage_conservation),
}
