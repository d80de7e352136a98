"""Control-plane coordinator: scheduler + lease-based failure detector.

A copy of ``mapreduce_rust_tpu/coordinator/server.py``: the same RPCs,
sentinels, leases, journal and job report, so port and reference
workers and coordinators interoperate.

Behavioral port of the reference coordinator (src/mr/coordinator.rs) with
its scheduler semantics preserved exactly and its two crash bugs fixed:

- 7-RPC surface (coordinator.rs:102-111): get_worker_id, get_map_task,
  get_reduce_task, renew_{map,reduce}_lease, report_{map,reduce}_task_finish.
- Sentinels (coordinator.rs:143,159,161): **-2** phase not ready (workers
  missing / map unfinished), **-3** all tasks assigned but leases
  outstanding (straggler wait), **-1** phase complete.
- Registration barrier: no map task is issued until worker_n workers
  registered (prepare(), coordinator.rs:42-44).
- Leases: granting a task stamps a deadline; the detector scan expires
  stale leases and flips the task back to unassigned for re-execution
  (check_lease, coordinator.rs:50-97). Phase finish flips only when every
  issued task reported, no task is pending reassignment, and the lease
  table is empty (coordinator.rs:252-258,285-291).

Bug fixes (SURVEY.md §3-D, deliberately not reproduced):
- renew_*_lease on a lease that was just reported returns False instead of
  panicking (reference ``assert!(contains_key)``, coordinator.rs:125,132);
- a worker beyond worker_n gets -1 ("not needed") instead of crashing the
  coordinator (reference assert, coordinator.rs:220).

The RPC plane carries only small integers — the control/data separation
the reference establishes by not deriving Serialize on KeyValue
(src/lib.rs:9). Data moves through spilled partition files (worker/) or
ICI collectives (parallel/), never through here.

Transport: newline-delimited JSON-RPC over asyncio TCP — the Python
counterpart of tarpc's Json TCP transport (src/bin/mrcoordinator.rs:31-43).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import uuid
import time

from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.runtime.metrics import (
    MetricsHTTPServer,
    MetricsRegistry,
)
from mapreduce_rust_tpu_torch.runtime.telemetry import JobReport, write_job_report
from mapreduce_rust_tpu_torch.runtime.backoff import Backoff, BackoffExhausted
from mapreduce_rust_tpu_torch.runtime.trace import (
    active_tracer,
    partial_path,
    per_process_path,
    start_tracing,
    stop_tracing,
    trace_flow,
    trace_instant,
    trace_span,
)

log = logging.getLogger("mapreduce_rust_tpu_torch.coordinator")

NOT_READY = -2   # phase gate / registration barrier
WAIT = -3        # all assigned, leases outstanding — straggler wait
DONE = -1        # phase complete

# Per-process RPC call-id mint (see CoordinatorClient.call): the client
# half of the happens-before bracket mrcheck traverses. The prefix is a
# RANDOM process token, deliberately not the pid: trace merge accepts
# files from different hosts whose pids collide (it remaps the pids, but
# cids ride inside event args), and a collided cid would fabricate
# send→handle edges between unrelated processes — ordering two genuinely
# concurrent writes is exactly how a race detector goes blind.
_rpc_run = uuid.uuid4().hex[:12]
_rpc_cid = itertools.count(1)


class RpcTimeout(RuntimeError):
    """A control-plane RPC exceeded Config.rpc_timeout_s. Deliberately NOT
    a ConnectionError: the worker treats a vanished coordinator as "job
    complete", and a WEDGED coordinator must never be mistaken for that."""


class ClockSync:
    """NTP-style offset estimate to the coordinator's ``perf_counter``
    clock, fed by RPC round trips: the coordinator stamps its monotonic
    ``now`` into every response, the client brackets the call with its own
    clock, and ``offset = server_now - (t0 + t1) / 2`` with uncertainty
    ±RTT/2. The minimum-RTT sample wins (standard NTP filtering — the
    tightest bracket has the least queueing noise). Lands in the worker
    manifest and in the trace metadata, where ``trace merge`` uses it to
    rebase the worker's timeline onto the coordinator's."""

    def __init__(self) -> None:
        self.offset_s: "float | None" = None
        self.rtt_s: "float | None" = None
        self.samples = 0

    def add(self, offset_s: float, rtt_s: float) -> None:
        self.samples += 1
        if self.rtt_s is None or rtt_s < self.rtt_s:
            self.offset_s, self.rtt_s = offset_s, rtt_s

    def best(self) -> "dict | None":
        if self.offset_s is None:
            return None
        return {
            "offset_s": self.offset_s,
            "rtt_s": self.rtt_s,
            "samples": self.samples,
        }


class _Phase:
    """Task table of one phase: assignment flags, fresh-id counter, leases."""

    def __init__(self, n: int, lease_timeout_s: float, now=None) -> None:
        # Injectable clock seam: lease arithmetic reads
        # ``self._now`` so mrmodel drives the real table under a virtual
        # clock. ``now=None`` keeps the monotonic default unchanged.
        self._now = now if now is not None else time.monotonic
        self.n = n
        self.assigned: dict[int, bool] = {i: False for i in range(n)}
        self.next_id = 0
        self.finished = False
        self.leases: dict[int, float] = {}
        self.lease_timeout_s = lease_timeout_s
        self.reported: set[int] = set()        # tids with a completion report
        self.last_activity: dict[int, float] = {}  # tid → last grant/renew
        self.grant_time: dict[int, float] = {}  # tid → ORIGINAL attempt start
        # (not overwritten by a speculative grant: the speculation picker
        # and the time-saved estimate both need the older attempt's age)
        self.spec_live: dict[int, int] = {}     # tid → live speculative copies

    def grant(self, eligible=None) -> int:
        """Next task id per the reference grant path (coordinator.rs:137-176):
        fresh ids first, then a rescan for expired-and-reset tasks, then
        WAIT while leases are outstanding, DONE once finished.

        ``eligible``: restrict the grant to this id set — the
        pipelined per-partition reduce release. Grants the lowest
        unassigned eligible id; NOT_READY while ungranted ids exist but
        none is eligible yet (readiness-gated, the same sentinel as the
        classic barrier), WAIT once every id is assigned (stragglers)."""
        if self.finished:
            return DONE
        if eligible is None:
            if self.next_id < self.n:
                tid = self.next_id
                self.next_id += 1
            else:
                tid = next((i for i, a in self.assigned.items() if not a), None)
                if tid is None:
                    return WAIT  # all assigned, leases outstanding — stragglers
        else:
            tid = next((i for i, a in self.assigned.items()
                        if not a and i in eligible), None)
            if tid is None:
                return WAIT if all(self.assigned.values()) else NOT_READY
            # Out-of-order issue: keep the issued counter ahead of every
            # granted id so report_finish's all-issued finish condition
            # stays truthful; ids jumped over remain assigned=False and
            # are served by the rescan path once they become eligible.
            self.next_id = max(self.next_id, tid + 1)
        self.assigned[tid] = True
        now = self._now()
        self.leases[tid] = now + self.lease_timeout_s
        self.last_activity[tid] = now
        self.grant_time[tid] = now
        return tid

    def renew(self, tid: int) -> bool:
        """False (not a crash) when the lease is gone — the renewal-vs-report
        race the reference asserts on (coordinator.rs:125,132)."""
        if tid not in self.leases:
            return False
        now = self._now()
        self.leases[tid] = now + self.lease_timeout_s
        self.last_activity[tid] = now
        return True

    def report_finish(self, tid: int) -> bool:
        self.reported.add(tid)
        self.leases.pop(tid, None)
        self.last_activity.pop(tid, None)
        self.grant_time.pop(tid, None)
        self.spec_live.pop(tid, None)
        # Finish iff all ids issued, nothing awaiting reassignment, and no
        # lease outstanding (coordinator.rs:252-258).
        if (
            self.next_id >= self.n
            and all(self.assigned.values())
            and not self.leases
        ):
            self.finished = True
        return self.finished

    def expire_stale(self) -> list[int]:
        now = self._now()
        dead = [tid for tid, deadline in self.leases.items() if deadline <= now]
        for tid in dead:
            del self.leases[tid]
            self.last_activity.pop(tid, None)
            self.grant_time.pop(tid, None)
            self.spec_live.pop(tid, None)
            self.assigned[tid] = False  # eligible for re-grant
        return dead


def _log_new_finding(key: str, f: dict) -> None:
    """First-appearance hook for the streaming doctor's fold (shared by
    the Coordinator and the JobService): stamp the trace and the log."""
    trace_instant("doctor.finding", code=f["code"], key=key,
                  severity=f["severity"])
    log.info("doctor[live] NEW [%s] %s: %s",
             f["severity"], f["code"], f["message"])


def ingest_fleet_sample(registry, fleet: dict, worker_count: int,
                        uptime_s: float, wid, sample) -> None:
    """Fold one renewal-envelope sample into a fleet view and a metrics
    registry (as per-worker labeled gauges, so the scrape endpoint and
    the ring carry the same series). Defensive by construction: an
    envelope is remote input — non-numeric values are dropped and the
    per-sample series count is capped so a confused worker cannot balloon
    the registry. Shared by the single-job Coordinator and the multi-job
    JobService (service/server.py): only wids the server actually issued
    are accepted — the wid is an unauthenticated RPC param, and an
    arbitrary int per call would grow the fleet map + per-wid gauge
    label-sets without bound on a long-lived server."""
    if (
        sample is None or registry is None
        or not isinstance(sample, dict)
        or not isinstance(wid, int)
        or not (0 <= wid < worker_count)
    ):
        return
    values = sample.get("v")
    if not isinstance(values, dict):
        return
    kept: dict = {}
    for k, v in list(values.items())[:64]:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        kept[str(k)] = v
        try:
            registry.gauge(str(k)).set(v, wid=str(wid))
        except ValueError:
            # Remote-named series colliding with a server-owned
            # counter/histogram name: keep it in the fleet view, skip
            # the registry — a confused worker must never crash the
            # renewal handler (the lease was already renewed).
            continue
    fleet[wid] = {
        "t": sample.get("t"),
        "age_s": 0.0,  # refreshed at serve time in metrics()
        "recv_uptime_s": round(uptime_s, 3),
        "v": kept,
    }


async def rpc_serve_connection(server, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
    """The newline-delimited JSON-RPC transport loop, shared by the
    single-job :class:`Coordinator` and the multi-job JobService
    (service/server.py — same wire format, wider method table).
    ``server`` provides ``_METHODS`` (the dispatch allowlist), ``report``
    (server-side RPC latency accounting) and ``_enrich_response(method,
    req, result, resp)`` (envelope extras: grant attempt numbers, renewal
    revocation, job routing)."""
    try:
        while True:
            line = await reader.readline()
            if not line:
                return
            req = json.loads(line)
            method = req.get("method")
            if method not in server._METHODS:
                resp = {"id": req.get("id"),
                        "error": f"unknown method {method!r}"}
            else:
                # Server-side RPC latency (dispatch + handler, excluding
                # socket writes): the server-health number a stats probe
                # reads instead of timing its own round trips. Per-RPC
                # spans are control-plane rate (worker polls + renewals),
                # not data-plane rate — bounded, not per-record.
                t0 = time.perf_counter()
                # ``cid`` is the client's per-call id (rpc.send /
                # rpc.recv instants carry the same one): the span
                # becomes the server half of a request/response
                # happens-before pair mrcheck can traverse.
                span_args = (
                    {"cid": req["cid"]} if req.get("cid") else {}
                )
                with trace_span(f"rpc.{method}", **span_args):
                    result = getattr(server, method)(*req.get("params", []))
                server.report.record_rpc(method, time.perf_counter() - t0)
                # "now" is the NTP-style timestamp ClockSync brackets:
                # the server's perf_counter — the clock its own trace
                # timestamps are measured against, which is what lets
                # `trace merge` rebase worker files onto it.
                resp = {
                    "id": req.get("id"),
                    "result": result,
                    "now": time.perf_counter(),
                }
                server._enrich_response(method, req, result, resp)
            writer.write(json.dumps(resp).encode() + b"\n")
            await writer.drain()
    except (ConnectionResetError, asyncio.IncompleteReadError,
            json.JSONDecodeError):
        pass
    finally:
        # Full teardown, not just close(): wait_closed() reaps the
        # transport so a burst of short-lived clients (renewal
        # connections, probes) can't accumulate half-closed sockets in
        # the event loop — same leak class as executor teardown
        # (mrlint: executor-teardown), applied to the RPC plane.
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass


class Coordinator:
    """In-process scheduler state; serve() exposes it over TCP.

    Checkpoint/resume (SURVEY.md §5): the reference has no coordinator
    persistence — coordinator death loses the run even though the
    materialized mr-{m}-{r}.txt files could seed a restart. Here completed
    task ids are journaled to ``{work_dir}/coordinator.journal`` (one line
    per completion, fsync-free append — the spill files themselves are the
    ground truth and are written atomically); a restarted coordinator
    pre-marks journaled tasks done, so the job resumes from the last
    completed task instead of from scratch.
    """

    def __init__(self, cfg: Config, resume: bool = True,
                 job_id: "str | None" = None, now=None) -> None:
        self.cfg = cfg
        # Injectable clock seam: ONE trailing hook threaded to
        # both phase tables and the report, so mrmodel explores the real
        # grant/finish/expiry logic under a virtual clock. Default keeps
        # ``time.monotonic`` — real runs are bit-identical.
        self._now = now if now is not None else time.monotonic
        # Multi-tenant job service: when this scheduler is one
        # job of a JobService, ``job_id`` namespaces everything that would
        # otherwise collide across co-hosted jobs — journal lines carry a
        # ``j<id>`` annotation, event-log rows a ``job`` field, and flow
        # ids a ``<id>:`` prefix (per-job coordinators share ONE process
        # tracer, and an un-prefixed ``map:0:1`` chain would merge two
        # jobs' attempts into one). None = the classic single-job
        # coordinator, wire- and artifact-identical to before.
        self.job_id = job_id
        self.map = _Phase(cfg.map_n, cfg.lease_timeout_s, now=self._now)
        self.reduce = _Phase(cfg.reduce_n, cfg.lease_timeout_s,
                             now=self._now)
        self.worker_count = 0
        # Control-plane telemetry: grants, renewals, expiries, re-executions
        # and task durations per (phase, tid), plus RPC latencies — served
        # over the `stats` RPC and dumped as work_dir/job_report.json at
        # done(). Aggregate counters only (runtime/metrics.py doctrine).
        self.report = JobReport(job_id=job_id, now=self._now)
        if cfg.sched_pipeline:
            # Stamp the artifact so offline consumers (fleet profiler,
            # doctor) know the barrier was dissolved on this run; fifo
            # runs stay byte-identical to the pre-sched wire format.
            self.report.sched = cfg.sched
        # Per-partition readiness: which map tids
        # have covered reduce partition r with a finish-report bytes
        # vector. ``_parts_ready`` is the pipelined reduce release's grant
        # filter; maintained in BOTH sched modes so the event log always
        # carries part_ready/part_retract evidence for mrcheck's
        # early-reduce-grant replay (fifo grants trivially satisfy it).
        self._part_cover: dict[int, set[int]] = {
            r: set() for r in range(cfg.reduce_n)
        }
        self._map_cover: dict[int, tuple] = {}  # map tid → covered r's
        self._parts_ready: set[int] = set()
        self._flow_finished: set[str] = set()  # flow ids already terminated
        self.drained: set[int] = set()  # wids that deregistered gracefully
        # Live speculation records: (phase, tid) → the original/speculative
        # attempt pair, kept until first finish (winner decided) or lease
        # expiry (both attempts dead).
        self._spec: dict[tuple[str, int], dict] = {}
        # Live telemetry plane. INSTANCE registry, deliberately
        # not the process-global slot: in-process clusters co-host workers
        # whose runs own the global one, and the fleet view must survive
        # them. Workers ship their latest sample in the renewal envelope;
        # the serve tick republishes everything as gauges/counters/hists,
        # samples the ring, renders the scrape text, and evaluates the
        # live doctor.
        self.registry = (
            MetricsRegistry(cfg.metrics_sample_period_s,
                            cfg.metrics_ring_points)
            if cfg.metrics_enabled else None
        )
        self.fleet: dict[int, dict] = {}  # wid → latest envelope sample
        self._live_findings: dict[str, dict] = {}  # key → finding+first_seen
        self._journal_path = os.path.join(cfg.work_dir, "coordinator.journal")
        # Provenance ledger, cluster side: armed by the first
        # finish report that carries a lineage payload (workers opt in via
        # Config.lineage / MR_LINEAGE — the coordinator needs no flag of
        # its own). Attempt records are appended for EVERY report, late
        # duplicates included: two reports for the same (tid) naming
        # different chunk lists is exactly the re-execution-divergence
        # evidence mrcheck's lineage-conservation invariant looks for.
        self._lineage_path = os.path.join(cfg.work_dir, "lineage.jsonl")
        self._lineage_started = False
        self._lineage_chunks: dict[int, list] = {}  # tid → first-report chunks
        self._lineage_pb: dict[int, list] = {}      # tid → first part_bytes
        if resume:
            self._replay_journal()

    # ---- journal (checkpoint/resume) ----

    def _header(self) -> str:
        """Job identity line: shape + a fingerprint of the input listing
        (name, size, mtime per file) — a rerun over different inputs in the
        same work_dir must start fresh, not resume the stale journal.
        The fingerprint is runtime.lineage.corpus_fingerprint — the SAME
        formula the service's result-cache corpus key and the lineage
        ledger header use, so all
        three agree byte-for-byte about corpus identity."""
        import glob

        from mapreduce_rust_tpu_torch.runtime.lineage import corpus_fingerprint

        paths = sorted(glob.glob(os.path.join(self.cfg.input_dir, self.cfg.input_pattern)))
        dg, _total = corpus_fingerprint(paths)
        return f"job {self.cfg.map_n} {self.cfg.reduce_n} {dg}"

    def _replay_journal(self) -> None:
        try:
            with open(self._journal_path, "r") as f:
                data = f.read()
        except OSError:
            return
        lines = data.splitlines()
        if lines and not data.endswith("\n"):
            lines.pop()  # torn tail from a crashed append — never trust it
        # A journal from a different job must not seed this one.
        if not lines or lines[0] != self._header():
            if lines:
                log.warning("journal is for a different job (%r) — ignoring", lines[0])
                try:
                    os.remove(self._journal_path)
                except OSError:
                    pass
            return
        self._replay_journal_lines(lines[1:])

    def _replay_journal_lines(self, lines) -> None:
        """Seed phase tables from journal BODY lines (header already
        validated/stripped). Split out of _replay_journal so mrmodel's
        replay-convergence invariant can rebuild a coordinator from any
        in-memory journal prefix without a file round-trip."""
        for line in lines:
            try:
                # Two fields is the original record; later fields (attempt,
                # wid, wall-clock — `map 3 a2 w1 t12.345`) are mrcheck
                # context and ignored here, so a pre-annotation journal
                # resumes under this coordinator. (The reverse does NOT
                # hold: a pre-annotation coordinator's strict 2-tuple
                # unpack skips annotated lines, so a rollback re-executes
                # from scratch — resume value lost, never corrupted.)
                parts = line.split()
                phase_name, tid_s = parts[0], parts[1]
                tid = int(tid_s)
            except (ValueError, IndexError):
                continue
            if phase_name not in ("map", "reduce"):
                continue  # corrupt record — never guess a phase
            phase = self.map if phase_name == "map" else self.reduce
            if 0 <= tid < phase.n:
                phase.assigned[tid] = True
                phase.reported.add(tid)  # journaled = completed: a late
                # duplicate report after resume must count as late, not
                # re-journal
                phase.next_id = max(phase.next_id, tid + 1)
        # Recompute finish flags; grant() then serves only the gaps.
        for phase in (self.map, self.reduce):
            if phase.next_id >= phase.n and all(phase.assigned.values()):
                phase.finished = True
        if self.map.finished or any(self.map.assigned.values()):
            log.info(
                "journal: resumed %d/%d map, %d/%d reduce completions",
                sum(self.map.assigned.values()), self.map.n,
                sum(self.reduce.assigned.values()), self.reduce.n,
            )

    def _journal(self, phase_name: str, tid: int, attempt: int = 0,
                 wid: int = -1) -> None:
        # The line carries the WINNING attempt, the reporting worker and
        # the report-clock timestamp beside the completion record — the
        # annotations mrcheck replays (revoked attempt never journals,
        # at-most-one winner) and prints as wall-clock context. Replay
        # reads only the first two fields, so this coordinator still
        # resumes pre-annotation journals (see _replay_journal for why
        # the reverse is forward-only).
        try:
            os.makedirs(self.cfg.work_dir, exist_ok=True)
            fresh = not os.path.exists(self._journal_path)
            # The ``j<id>`` annotation (service jobs only) is how a
            # journal stays attributable when job artifacts are read side
            # by side — mrcheck parses it like a/w/t; replay still reads
            # only the first two fields.
            job_suffix = f" j{self.job_id}" if self.job_id else ""
            with open(self._journal_path, "a") as f:
                if fresh:
                    f.write(self._header() + "\n")
                f.write(f"{phase_name} {tid} a{attempt} w{wid} "
                        f"t{self.report.uptime_s():.3f}{job_suffix}\n")
            # The journal append IS the authoritative (phase, tid) state
            # write: an instant beside the rpc span makes it a node the
            # happens-before race detector can order.
            trace_instant("coordinator.journal", phase=phase_name, tid=tid,
                          attempt=attempt, wid=wid, **self._job_args())
        except OSError as e:
            log.warning("journal write failed: %s", e)

    # ---- provenance ledger, cluster side ----

    @staticmethod
    def _valid_chunks(lineage) -> "list | None":
        """Validate a report's lineage payload (remote input, same
        posture as _record_readiness: malformed ⇒ drop, never raise).
        Expected shape: {"chunks": [hex digest, ...]}."""
        if not isinstance(lineage, dict):
            return None
        chunks = lineage.get("chunks")
        if not isinstance(chunks, list) or len(chunks) > (1 << 16):
            return None
        for dg in chunks:
            if not isinstance(dg, str) or not (8 <= len(dg) <= 128):
                return None
        return list(chunks)

    def _lineage_append(self, rec: dict) -> None:
        """Append one ledger record, writing the start header first on
        this incarnation's first append (truncating — like the journal, a
        fresh coordinator owns its work dir's provenance). Best-effort:
        an unwritable ledger must never fail a finish report."""
        from mapreduce_rust_tpu_torch.runtime import lineage as _lin

        try:
            os.makedirs(self.cfg.work_dir, exist_ok=True)
            if not self._lineage_started:
                import glob

                paths = sorted(glob.glob(os.path.join(
                    self.cfg.input_dir, self.cfg.input_pattern)))
                meta_dg, total = _lin.corpus_fingerprint(paths)
                with open(self._lineage_path, "w") as f:
                    f.write(json.dumps({
                        "t": "start", "schema": _lin.SCHEMA,
                        "corpus_meta_digest": meta_dg,
                        "corpus_bytes": total,
                        "reduce_n": self.cfg.reduce_n,
                        "inputs": [os.path.basename(p) for p in paths],
                        "pid": os.getpid(),
                    }, separators=(",", ":")) + "\n")
                self._lineage_started = True
            _lin.append_record(self._lineage_path, rec)
        except OSError as e:
            log.warning("lineage append failed: %s", e)

    # ---- the 7 RPCs (coordinator.rs:102-111) ----

    def get_worker_id(self) -> int:
        if self.worker_count >= self.cfg.worker_n:
            # Reference panics here (assert, coordinator.rs:220); extra
            # workers are simply not needed.
            return DONE
        wid = self.worker_count
        self.worker_count += 1
        log.info("worker %d registered (%d/%d)", wid, self.worker_count, self.cfg.worker_n)
        return wid

    def _job_args(self) -> dict:
        """Trace-event args identifying this scheduler's job — empty for
        the single-job coordinator, so pre-service traces stay
        byte-compatible (no ``job: null`` noise in every event)."""
        return {"job": self.job_id} if self.job_id else {}

    def _fid(self, name: str, tid: int, attempt: int) -> str:
        """Flow-chain id of one attempt. Service jobs prefix the job id:
        per-job coordinators share one process tracer, and without the
        prefix two jobs' ``map:0:1`` chains would merge into one
        arrow (and one mrcheck write node)."""
        base = f"{name}:{tid}:{attempt}"
        return f"{self.job_id}:{base}" if self.job_id else base

    def _grant(self, phase: "_Phase", name: str, wid: int = -1,
               eligible=None) -> int:
        tid = phase.grant(eligible)
        if tid == WAIT and self.cfg.speculate:
            tid = self._maybe_speculate(phase, name, wid)
        if tid >= 0:
            self.report.record_grant(name, tid, wid=wid)
            # Flow chain start: the grant span forks an arrow the worker's
            # task span steps and the finish-report RPC terminates. The
            # attempt suffix makes a re-execution a SECOND chain.
            trace_flow(
                "task", "s",
                self._fid(name, tid, self.report.attempts(name, tid)),
                phase=name, tid=tid, **self._job_args(),
            )
        return tid

    def _maybe_speculate(self, phase: "_Phase", name: str, wid: int) -> int:
        """Speculative re-execution: the caller is an
        IDLE worker (grant() just said WAIT — every task is issued, leases
        outstanding). Near phase end, re-issue the slowest in-flight task
        to it as a NEW attempt: first finish wins (the idempotent journal
        dedups, outputs are atomic-rename so bit-identical either way) and
        the loser is revoked on its next renewal. Returns a tid or WAIT."""
        if wid < 0:
            return WAIT  # anonymous caller: can't prove it isn't the holder
        done = len(phase.reported)
        if phase.n == 0 or done / phase.n < self.cfg.speculate_after_frac:
            return WAIT
        # Only attempts slower than speculate_slow_factor x the phase task
        # p50 qualify once the live histogram has signal; before that, any
        # in-flight task is eligible (the fleet is idle — duplication is
        # the cheap side of the trade, per Coded TeraSort).
        p50 = self.report.phase_task_p50(name, min_count=3)
        now = self._now()
        best_tid, best_age = None, -1.0
        for tid in phase.leases:
            holder = self._tasks_wid(name, tid)
            if holder is None or holder == wid:
                continue  # unknown holder, or the caller already runs it
            if 1 + phase.spec_live.get(tid, 0) >= self.cfg.speculate_max_attempts:
                continue
            age = now - phase.grant_time.get(tid, now)
            if p50 is not None and age <= self.cfg.speculate_slow_factor * p50:
                continue
            if age > best_age:
                best_tid, best_age = tid, age
        if best_tid is None:
            return WAIT
        orig_attempt = self.report.attempts(name, best_tid)
        phase.spec_live[best_tid] = phase.spec_live.get(best_tid, 0) + 1
        # Extend the (shared) lease: both attempts renew the same entry, so
        # the detector only fires once BOTH are dead.
        phase.leases[best_tid] = now + phase.lease_timeout_s
        phase.last_activity[best_tid] = now
        self._spec[(name, best_tid)] = {
            "orig_attempt": orig_attempt,
            "orig_age_s": best_age,
            "spec_attempt": orig_attempt + 1,
            "spec_start": now,
            "spec_wid": wid,
        }
        self.report.record_speculation(name, best_tid, wid=wid)
        trace_instant("coordinator.speculate", phase=name, tid=best_tid,
                      attempt=orig_attempt + 1, wid=wid, **self._job_args())
        log.info(
            "speculating %s %d (attempt %d, original running %.2fs) to "
            "worker %d", name, best_tid, orig_attempt + 1, best_age, wid,
        )
        return best_tid

    def _tasks_wid(self, name: str, tid: int) -> "int | None":
        return self.report.task_wid(name, tid)

    # ``wid`` on the task RPCs: grants/renewals/finishes attribute per WORKER as well as
    # per task, so `watch` shows a per-worker column and the doctor's
    # straggler pass can compare workers. Trailing-with-default keeps the
    # wire format compatible with pre-wid clients (params [tid] still
    # parse) and with every in-process test caller.

    def get_map_task(self, wid: int = -1) -> int:
        if not self.prepare():
            return NOT_READY  # registration barrier (coordinator.rs:142-144)
        return self._grant(self.map, "map", wid)

    def get_reduce_task(self, wid: int = -1) -> int:
        if not self.map.finished:
            if not self.cfg.sched_pipeline:
                return NOT_READY  # phase gate (coordinator.rs:183-185)
            # Per-partition release: before the barrier only
            # partitions every map task has covered with reported bytes
            # are grantable; the rest answer NOT_READY exactly like the
            # classic gate. Inputs for a ready partition are final (all
            # m spill files written via atomic rename), so reduce output
            # is bit-identical to the barriered schedule.
            return self._grant(self.reduce, "reduce", wid,
                               eligible=self._parts_ready)
        return self._grant(self.reduce, "reduce", wid)

    # ``sample`` on the renewal RPCs: the worker's latest live
    # metrics point rides the heartbeat it already sends — trailing with
    # default, like ``wid``, so pre-metrics clients and in-process test
    # callers stay wire-valid. This is the fleet-wide live view the
    # multi-tenant service will need for admission control.

    def renew_map_lease(self, tid: int, wid: int = -1, sample=None) -> bool:
        ok = self.map.renew(tid)
        self.report.record_renewal("map", tid, ok, wid=wid)
        self._ingest_sample(wid, sample)
        return ok

    def renew_reduce_lease(self, tid: int, wid: int = -1, sample=None) -> bool:
        ok = self.reduce.renew(tid)
        self.report.record_renewal("reduce", tid, ok, wid=wid)
        self._ingest_sample(wid, sample)
        return ok

    def _ingest_sample(self, wid, sample) -> None:
        ingest_fleet_sample(self.registry, self.fleet, self.worker_count,
                            self.report.uptime_s(), wid, sample)

    def metrics(self) -> dict:
        """The 10th RPC: the live telemetry view — the coordinator's
        latest ring point + series catalog, the per-worker fleet samples,
        and the streaming doctor's findings with first-seen timestamps.
        Plain JSON scalars/dicts, same transport as everything else."""
        now = self.report.uptime_s()
        fleet = {}
        for wid, s in self.fleet.items():
            fleet[str(wid)] = {
                **s, "age_s": round(now - s["recv_uptime_s"], 3),
            }
        out: dict = {
            "enabled": self.registry is not None,
            "uptime_s": round(now, 3),
            "findings": sorted(
                self._live_findings.values(),
                key=lambda f: f["first_seen_s"],
            ),
            "fleet": fleet,
        }
        if self.registry is not None:
            out["latest"] = self.registry.latest()
            out["series"] = self.registry.series_catalog()
        return out

    def _finish(self, phase: "_Phase", name: str, tid: int, attempt: int,
                wid: int = -1) -> bool:
        # Idempotent per (phase, tid): the duplicate completion of a
        # re-executed task (original + replacement both report) used to
        # double-journal and double-count — now it lands as a distinct
        # late_reports stat and journals exactly once.
        first = tid not in phase.reported
        # Speculation race settled: the FIRST report of a speculated task
        # decides won vs wasted. Read the shared lease deadline BEFORE
        # report_finish pops it — the time-saved estimate is against the
        # lease-expiry-only recovery the reference has (the loser's lease
        # would still have had to run out before a re-grant even started).
        lease_remaining = max(phase.leases.get(tid, 0.0) - self._now(), 0.0)
        done = phase.report_finish(tid)
        if first:
            spec = self._spec.pop((name, tid), None)
            if spec is not None:
                now = self._now()
                # The reporter's own attempt number decides the race. An
                # attempt-less report (0: pre-attempt client / default
                # caller) is UNATTRIBUTABLE — falling back to attempts()
                # would equal spec_attempt (the speculative grant already
                # bumped it) and score an original's finish as a win with
                # a fabricated time saved. Unknown ⇒ score conservatively
                # as the original winning (wasted).
                won = attempt >= spec["spec_attempt"]
                saved = (
                    lease_remaining + (now - spec["spec_start"]) if won else 0.0
                )
                self.report.record_speculation_result(
                    name, won=won, time_saved_s=saved
                )
                log.info(
                    "%s %d speculation %s (attempt %d reported first%s)",
                    name, tid, "won" if won else "wasted", attempt,
                    f", ~{saved:.2f}s saved vs lease expiry" if won else "",
                )
        self.report.record_finish(name, tid, late=not first, wid=wid,
                                  attempt=attempt or None)
        fid = self._fid(name, tid, attempt or self.report.attempts(name, tid))
        if fid not in self._flow_finished:
            # Guard the flow chain's single-finish invariant even if two
            # reports name the same attempt (validate_events rejects a
            # chain continuing past its "f").
            self._flow_finished.add(fid)
            trace_flow("task", "f", fid, phase=name, tid=tid,
                       **self._job_args())
        if first:
            self._journal(name, tid, attempt=attempt, wid=wid)
        return done

    # ---- per-partition readiness ----

    def _record_readiness(self, tid: int, part_bytes, wid: int = -1) -> None:
        """Fold one map task's FIRST finish report into per-partition
        coverage. Partition r is ready once every map task has reported a
        bytes entry for it (zero bytes counts — the shard file exists and
        is final); becoming ready logs a ``part_ready`` event, the
        evidence mrcheck's early-reduce-grant replay checks reduce grants
        against. Same validation posture as record_partition_ready: the
        vector is remote input, malformed ⇒ drop the whole report
        (coverage stays conservative — an uncovered partition just keeps
        its reduce task gated)."""
        if not isinstance(part_bytes, (list, tuple)) \
                or len(part_bytes) > JobReport.PARTITIONS_CAP:
            return
        if tid in self._map_cover or not (0 <= tid < self.cfg.map_n):
            return
        for b in part_bytes:
            if isinstance(b, bool) or not isinstance(b, (int, float)):
                return
        covered = tuple(range(min(len(part_bytes), self.cfg.reduce_n)))
        self._map_cover[tid] = covered
        for r in covered:
            cov = self._part_cover[r]
            cov.add(tid)
            if len(cov) >= self.cfg.map_n and r not in self._parts_ready:
                self._parts_ready.add(r)
                self.report.record_event("part_ready", "reduce", r, wid=wid)

    def _retract_readiness(self, tid: int) -> None:
        """A map attempt's lease expired with coverage on the books: the
        re-executed attempt will rewrite its shard files, so whatever
        readiness this tid established is no longer grant-worthy. Pull it
        out of every partition's cover set and close any partition that
        drops below full coverage, logging ``part_retract`` so the replay
        re-gates its readiness watermark; the re-report re-establishes
        coverage through _record_readiness. (Structurally defensive today
        — a lease only exists for UNreported tids and coverage only comes
        from first reports, which pop the lease — but the lease/attempt
        machine is extended under that assumption rather than relying on
        it, and mrcheck replays the net-of-retractions watermark.)"""
        covered = self._map_cover.pop(tid, None)
        if covered is None:
            return
        for r in covered:
            self._part_cover[r].discard(tid)
            if r in self._parts_ready:
                self._parts_ready.discard(r)
                self.report.record_event("part_retract", "reduce", r)

    def reduce_ready_backlog(self) -> int:
        """READY-but-ungranted reduce partitions — work a pipelined fleet
        could start this instant. The service's bubble accounting
        counts fleet idle against this instead of against the map
        barrier window, which pipelining dissolved as a bubble."""
        if self.reduce.finished:
            return 0
        if self.map.finished:
            return sum(1 for a in self.reduce.assigned.values() if not a)
        return sum(1 for r in self._parts_ready
                   if not self.reduce.assigned.get(r, False))

    def report_map_task_finish(self, tid: int, attempt: int = 0,
                               wid: int = -1, job=None,
                               part_bytes=None, lineage=None) -> bool:
        # ``job``/``part_bytes``/``lineage`` are trailing default RPC
        # fields (the wid/sample wire-compat pattern): old clients omit
        # all three. job is accepted-and-ignored here so the 5-positional
        # service-worker report stays valid against a classic coordinator;
        # part_bytes is the map task's per-reduce-partition
        # intermediate-bytes vector — recorded on the FIRST report only
        # (a late duplicate re-wrote identical shard files; readiness was
        # already achieved). lineage ({"chunks": [digest, ...]})
        # is appended to the ledger for EVERY report — a late duplicate's
        # chunk list is the re-execution-equality evidence mrcheck
        # replays, so it must land beside the winner's, not be dropped.
        first = tid not in self.map.reported
        if part_bytes is not None and first:
            self.report.record_partition_ready(tid, part_bytes)
            self._record_readiness(tid, part_bytes, wid=wid)
        if lineage is not None and 0 <= tid < self.cfg.map_n:
            chunks = self._valid_chunks(lineage)
            if chunks is not None:
                pb = list(part_bytes) if isinstance(
                    part_bytes, (list, tuple)) else []
                if first:
                    self._lineage_chunks[tid] = chunks
                    self._lineage_pb[tid] = pb
                self._lineage_append({
                    "t": "attempt", "phase": "map", "tid": tid,
                    "attempt": attempt, "wid": wid,
                    "chunks": chunks, "part_bytes": pb,
                })
        done = self._finish(self.map, "map", tid, attempt, wid)
        log.info("map %d finished (phase done=%s)", tid, done)
        return done

    def report_reduce_task_finish(self, tid: int, attempt: int = 0,
                                  wid: int = -1) -> bool:
        # Partition claim record, first report only: partition
        # tid's contributing chunks = the union of every first-reported
        # map attempt's chunks whose part_bytes vector shows bytes for
        # this partition (a missing/short vector claims conservatively —
        # over-approximation never hides a dependency), bytes = the summed
        # intermediate contribution.
        if self._lineage_chunks and tid not in self.reduce.reported \
                and 0 <= tid < self.cfg.reduce_n:
            claims: set = set()
            rbytes = 0
            for mtid, chunks in self._lineage_chunks.items():
                pb = self._lineage_pb.get(mtid) or []
                if tid < len(pb):
                    if not pb[tid]:
                        continue  # exact: zero bytes shipped to tid
                    rbytes += int(pb[tid])
                claims.update(chunks)
            self._lineage_append({
                "t": "part", "r": tid, "bytes": rbytes,
                "chunks": sorted(claims),
            })
        done = self._finish(self.reduce, "reduce", tid, attempt, wid)
        log.info("reduce %d finished (job done=%s)", tid, done)
        return done

    def deregister_worker(self, wid: int = -1) -> bool:
        """Graceful drain: a SIGTERM'd worker finishes
        its current task, reports it, then calls this — so `watch` and
        `progress` show it as DRAINED, not as a crash the lease detector
        will eventually notice. Holds no scheduler state: a drained
        worker's tasks were already reported (it drains between tasks)."""
        if not isinstance(wid, int) or wid < 0 or wid >= self.worker_count:
            return False
        self.drained.add(wid)
        self.report.record_deregister(wid)
        log.info("worker %d deregistered (graceful drain)", wid)
        return True

    def stats(self) -> dict:
        """The 8th RPC: the live control-plane job report — task states,
        re-executions, lease expiries, durations, RPC latencies — plus the
        ``progress`` view `watch` renders. Plain ints/floats, so it rides
        the same JSON transport as the sentinels."""
        return {**self.report.to_dict(), "progress": self.progress()}

    def progress(self) -> dict:
        """Live per-phase issued/done/in-flight/expired counts plus lease
        liveness from renewal recency: a lease with no grant/renewal inside
        ~3 renew periods belongs to a worker that is wedged or dead — the
        thing `watch` exists to show while the lease detector counts down."""
        now = self._now()
        live_window = max(3 * self.cfg.lease_renew_period_s, 1.5)
        phases: dict = {}
        for name, ph in (("map", self.map), ("reduce", self.reduce)):
            leases = {}
            for tid, deadline in ph.leases.items():
                last = ph.last_activity.get(tid)
                since = round(now - last, 3) if last is not None else None
                leases[str(tid)] = {
                    "attempt": self.report.attempts(name, tid),
                    "lease_remaining_s": round(deadline - now, 3),
                    "since_activity_s": since,
                    "live": since is not None and since <= live_window,
                }
            done = len(ph.reported)
            phases[name] = {
                "tasks_total": ph.n,
                "issued": ph.next_id,
                "done": done,
                "in_flight": len(ph.leases),
                "pending": max(ph.n - done - len(ph.leases), 0),
                "expired": self.report.phase_expiries(name),
                "late_reports": self.report.phase_late_reports(name),
                "stale": sum(
                    1 for lease in leases.values() if not lease["live"]
                ),
                "finished": ph.finished,
                "leases": leases,
            }
        return {
            "phase": "done" if self.done()
            else ("reduce" if self.map.finished else "map"),
            "done": self.done(),
            "workers": {
                "registered": self.worker_count,
                "expected": self.cfg.worker_n,
                # Drained ≠ crashed: these wids deregistered gracefully
                # (SIGTERM drain); a crashed worker instead shows up as a
                # STALE lease above until the detector expires it.
                "drained": sorted(self.drained),
                "active": self.worker_count - len(self.drained),
                # Per-worker detail lives ONCE in the response: the stats
                # RPC's top-level "workers" block (JobReport.to_dict) —
                # what `watch` renders as the worker column. Duplicating
                # it here would recompute every percentile per poll tick.
            },
            "uptime_s": round(self.report.uptime_s(), 3),
            "phases": phases,
        }

    # ---- in-process methods (coordinator.rs:25-97) ----

    def prepare(self) -> bool:
        return self.worker_count >= self.cfg.worker_n

    def done(self) -> bool:
        return self.map.finished and self.reduce.finished

    def check_lease(self) -> None:
        # FIFO scans the phase the barrier says is active; pipeline mode
        # scans BOTH — reduce leases legally exist before the
        # map barrier, and a dead map attempt must retract the readiness
        # it established (see _retract_readiness) before the re-grant.
        if self.cfg.sched_pipeline:
            pairs = ((self.map, "map"), (self.reduce, "reduce"))
        else:
            pairs = ((self.reduce, "reduce") if self.map.finished
                     else (self.map, "map"),)
        for phase, name in pairs:
            for tid in phase.expire_stale():
                self.report.record_expiry(name, tid)
                if name == "map":
                    self._retract_readiness(tid)
                if self._spec.pop((name, tid), None) is not None:
                    # The shared lease ran out: BOTH the original and its
                    # speculative copy went silent — the speculation bought
                    # nothing and the normal expiry path re-grants from
                    # scratch.
                    self.report.record_speculation_result(name, won=False)
                log.warning("%s task %d lease expired — rescheduling",
                            name, tid)

    # ---- transport ----

    _METHODS = frozenset({
        "get_worker_id", "get_map_task", "get_reduce_task",
        "renew_map_lease", "renew_reduce_lease",
        "report_map_task_finish", "report_reduce_task_finish",
        "deregister_worker", "stats", "metrics",
    })

    # ---- live telemetry ticks (serve loop — never the RPC hot path) ----

    def _metrics_tick(self, http_srv=None, force: bool = False) -> None:
        """Republish the control plane into the registry, sample the ring,
        and hand the scrape endpoint its next body. Runs ON the event loop
        (serialized with every handler), so reading the report is safe;
        the HTTP thread only ever serves pre-rendered bytes. Gated on the
        ring's bucket cadence: the serve loop passes several times per
        second, and the republish (histogram copies) + text render are
        only worth doing when a point will actually land."""
        g = self.registry
        if g is None or not (force or g.due()):
            return
        prog = self.progress()
        g.gauge("coordinator.uptime_s").set(prog["uptime_s"])
        workers = prog["workers"]
        g.gauge("coordinator.workers_registered").set(workers["registered"])
        g.gauge("coordinator.workers_active").set(workers["active"])
        g.gauge("coordinator.job_done").set(int(prog["done"]))
        for name, ph in prog["phases"].items():
            for field in ("issued", "done", "in_flight", "pending",
                          "expired", "late_reports", "stale"):
                g.gauge(f"phase.{field}").set(ph[field], phase=name)
        for method, h in self.report._rpc.items():
            g.counter("rpc.calls").set_total(h.count, method=method)
            g.histogram("rpc.latency_s").set_hist(h, method=method)
        for phase, h in self.report._phase_hist.items():
            g.histogram("task.duration_s").set_hist(h, phase=phase)
        g.maybe_sample()
        if http_srv is not None:
            http_srv.publish(g.prometheus_text())

    def _doctor_tick(self) -> None:
        """Streaming doctor: evaluate the existing finding
        catalog against the LIVE report + fleet samples. A finding's first
        appearance is stamped (coordinator uptime) and dropped into the
        trace as an instant, so the merged timeline shows WHEN the
        diagnosis became true — not just that the corpse had it."""
        from mapreduce_rust_tpu_torch.analysis.doctor import (
            deactivate_stale_findings,
            diagnose_live,
            fold_live_findings,
        )

        try:
            diag = diagnose_live(
                self.stats(),
                lease_timeout_s=self.cfg.lease_timeout_s,
                fleet=self.fleet,
            )
        except Exception as e:  # diagnosis must never wedge the scheduler
            log.warning("live doctor tick failed: %r", e)
            return
        current = fold_live_findings(
            self._live_findings, diag.get("findings") or [],
            round(self.report.uptime_s(), 3), on_new=_log_new_finding,
        )
        deactivate_stale_findings(self._live_findings, current)

    def _enrich_response(self, method: str, req: dict, result,
                         resp: dict) -> None:
        """Response-envelope extras beyond the bare result (the
        :func:`rpc_serve_connection` hook — the JobService carries its
        own version of this for job-routed methods)."""
        if (
            method in ("get_map_task", "get_reduce_task")
            and isinstance(result, int) and result >= 0
        ):
            # The grant's attempt number rides back so the
            # worker can stamp its task span into the same
            # flow chain (still just small integers).
            phase = "map" if method == "get_map_task" else "reduce"
            resp["attempt"] = self.report.attempts(phase, result)
        elif (
            method in ("renew_map_lease", "renew_reduce_lease")
            and result is False
        ):
            # A failed renewal is one of two very different
            # things, and the envelope says which: REVOKED —
            # the task already completed (another attempt won
            # the race); stop computing, never report. Not
            # revoked — the lease merely expired but the task
            # is still wanted; keep computing, a late report
            # is a genuine completion that may still win.
            ph = self.map if method == "renew_map_lease" \
                else self.reduce
            params = req.get("params") or [None]
            resp["revoked"] = params[0] in ph.reported
            if resp["revoked"]:
                # The renewing attempt just learned it lost
                # the race — a state transition (→ revoked)
                # the conformance replay needs on the log.
                self.report.record_revocation(
                    "map" if ph is self.map else "reduce",
                    params[0],
                    wid=params[1] if len(params) > 1 else None,
                )

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        await rpc_serve_connection(self, reader, writer)

    async def serve(self) -> None:
        """Listen + poll loop: 1 Hz done() check, detector every
        lease_check_period_s (src/bin/mrcoordinator.rs:47-57). Returns when
        the job completes."""
        # The coordinator honors Config.trace_path too: per-RPC spans (see
        # _handle) make the control-plane timeline inspectable in Perfetto
        # next to the workers' and driver's traces. The "coord" tag marks
        # this file as the reference clock for `trace merge`.
        tracer = start_tracing(tag="coord") if self.cfg.trace_path else None
        if tracer is not None:
            tracer.enable_flight_recorder(
                partial_path(per_process_path(self.cfg.trace_path, "coord")),
                period_s=self.cfg.flight_record_period_s,
            )
            if self.registry is not None:
                tracer.metrics_registry = self.registry  # partials keep
                # the fleet series a SIGKILL would otherwise take down
        http_srv = None
        if self.cfg.metrics_port and self.registry is not None:
            try:
                http_srv = MetricsHTTPServer(self.cfg.metrics_port,
                                             host=self.cfg.host)
                log.info("metrics: Prometheus endpoint on http://%s:%d/metrics",
                         http_srv.host, http_srv.port)
            except OSError as e:
                # A taken port must not cost the job — the scheduler is
                # the product, the scrape endpoint is telemetry.
                log.warning("metrics endpoint failed to bind port %d: %s",
                            self.cfg.metrics_port, e)
        self.metrics_http = http_srv  # tests read the bound (ephemeral) port
        server = await asyncio.start_server(self._handle, self.cfg.host, self.cfg.port)
        log.info("coordinator on %s:%d (map_n=%d reduce_n=%d worker_n=%d)",
                 self.cfg.host, self.cfg.port, self.cfg.map_n, self.cfg.reduce_n, self.cfg.worker_n)
        try:
            last_check = self._now()
            while not self.done():
                await asyncio.sleep(min(1.0, self.cfg.lease_check_period_s))
                if self._now() - last_check >= self.cfg.lease_check_period_s:
                    self.check_lease()
                    # Streaming doctor at the detector's cadence: the
                    # straggler/lease/skew catalog over the live report,
                    # findings surfaced mid-run.
                    self._doctor_tick()
                    last_check = self._now()
                # Registry republish + ring sample + scrape-text publish
                # from the existing poll loop — never the RPC hot path.
                self._metrics_tick(http_srv)
                if tracer is not None:
                    tracer.maybe_snapshot()
            # Job done: dump the control-plane report where a BENCH probe
            # (or a human) finds structured state instead of log tails.
            try:
                path = write_job_report(
                    os.path.join(self.cfg.work_dir, "job_report.json"), self.report
                )
                log.info("job report (%s) → %s", self.report.summary(), path)
            except OSError as e:
                log.warning("job report write failed: %s", e)
            log.info("job complete — results in %s/mr-*.txt", self.cfg.output_dir)
        finally:
            if tracer is not None:
                stop_tracing()
            from mapreduce_rust_tpu_torch.runtime.telemetry import flush_run_artifacts

            # Snapshot ON the loop thread: straggler workers are still
            # polling this loop, and their handlers mutate the report —
            # to_dict() here is serialized with them; on the pool thread
            # it would race a late deregister/record and tear the
            # manifest (or die mid-iteration on a dict resize).
            extra = {
                "kind": "coordinator_manifest",
                "job_report": self.report.to_dict(),
            }
            if self.registry is not None:
                # Republish the FINAL control-plane state (the cadence
                # gate may have skipped the last serve passes), then a
                # forced sample, then the ring rides the manifest as
                # stats.timeseries — the acceptance artifact the scrape
                # endpoint's series are checked against. Snapshotted ON
                # the loop like the report (instance registry: the global
                # slot may belong to a co-hosted worker).
                self._metrics_tick(force=True)
                self.registry.maybe_sample(force=True)
                extra["stats"] = {
                    "timeseries": self.registry.timeseries_dict(),
                }
            if self._live_findings:
                extra["live_findings"] = sorted(
                    self._live_findings.values(),
                    key=lambda f: f["first_seen_s"],
                )

            def _flush() -> None:
                flush_run_artifacts(self.cfg, tracer, tag="coord",
                                    logger=log, extra=extra)

            # Only the I/O leaves the loop: the flush shells out to git
            # (git_rev) and writes files, and a blocked loop here reads
            # as a wedged coordinator to the pollers
            # (mrlint: blocking-in-async).
            await asyncio.get_running_loop().run_in_executor(None, _flush)
            if http_srv is not None:
                # close() blocks on ThreadingHTTPServer.shutdown (up to
                # its 0.5 s poll) + a thread join — off the loop, like
                # _flush (mrlint: blocking-in-async).
                await asyncio.get_running_loop().run_in_executor(
                    None, http_srv.close
                )
            server.close()
            await server.wait_closed()


class CoordinatorClient:
    """Tiny JSON-RPC client used by workers (and tests).

    ``timeout_s`` bounds every connect attempt and every call: a wedged
    coordinator (process alive, event loop stuck) used to block a worker
    forever inside ``readline()`` — the renewal loop then never expired
    client-side. A timed-out call raises :class:`RpcTimeout`.

    ``sync`` (a :class:`ClockSync`) accumulates NTP-style offset samples
    from the coordinator's ``now`` response stamps — share one instance
    across a worker's clients so the renewal connection's chatty round
    trips tighten the estimate the trace merge uses.
    """

    def __init__(self, host: str, port: int,
                 timeout_s: "float | None" = None,
                 sync: "ClockSync | None" = None) -> None:
        self.host, self.port = host, port
        self.timeout_s = timeout_s
        self.sync = sync
        self.last_attempt = 0  # attempt number of the last task grant
        self.last_revoked = False  # the last failed renewal was a revocation
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._next_id = 0

    async def connect(self, retries: int = 50, delay: float = 0.1,
                      budget_s: "float | None" = None) -> None:
        """Connect with jittered exponential backoff between attempts
        (``delay`` is the BASE delay now, not the fixed one): bounded by
        both the attempt count and a total-sleep ``budget_s`` — a fleet
        restarting against a coming-up coordinator spreads out instead of
        arriving in lockstep. ``budget_s`` defaults to ``retries * delay``,
        the fixed-delay era's total wait, so a dead coordinator still
        surfaces its ConnectionError on the old clock (~5 s at the
        defaults) rather than after the full grown-delay sum."""
        if budget_s is None:
            budget_s = retries * delay
        backoff = Backoff(base_s=delay, cap_s=max(2.0, delay),
                          budget_s=budget_s)
        for attempt in range(retries):
            try:
                coro = asyncio.open_connection(self.host, self.port)
                if self.timeout_s:
                    coro = asyncio.wait_for(coro, self.timeout_s)
                self._reader, self._writer = await coro
                return
            except asyncio.TimeoutError:
                if attempt == retries - 1:
                    raise RpcTimeout(
                        f"connect to coordinator {self.host}:{self.port} "
                        f"timed out after {self.timeout_s}s"
                    ) from None
            except OSError:
                if attempt == retries - 1:
                    raise
            try:
                await asyncio.sleep(backoff.next_delay())
            except BackoffExhausted:
                raise ConnectionError(
                    f"connect to coordinator {self.host}:{self.port}: retry "
                    f"budget ({budget_s}s) exhausted after "
                    f"{attempt + 1} attempts"
                ) from None

    async def call(self, method: str, *params) -> int | bool:
        assert self._writer is not None, "connect() first"
        self._next_id += 1
        req = {"id": self._next_id, "method": method, "params": list(params)}
        # Happens-before bracket (only when this process traces): a
        # globally unique call id links the client's send/recv instants to
        # the coordinator's rpc span, giving mrcheck the two HB edges an
        # RPC defines — send ≤ handle and handle ≤ recv. Instants, not
        # spans: several asyncio tasks (task loop + renewal loop) await
        # calls on ONE thread, and interleaved spans would partially
        # overlap, which validate_events rejects.
        cid = None
        if active_tracer() is not None:
            # Process-global counter, not per-client: renewal clients are
            # created per task and a freed client's successor must never
            # mint the same id (a collided cid would fabricate HB edges).
            cid = f"{_rpc_run}:{next(_rpc_cid)}"
            req["cid"] = cid
            trace_instant("rpc.send", cid=cid, method=method)
        t0 = time.perf_counter()
        self._writer.write(json.dumps(req).encode() + b"\n")
        try:
            if self.timeout_s:
                await asyncio.wait_for(self._writer.drain(), self.timeout_s)
                line = await asyncio.wait_for(
                    self._reader.readline(), self.timeout_s
                )
            else:
                await self._writer.drain()
                line = await self._reader.readline()
        except asyncio.TimeoutError:
            raise RpcTimeout(
                f"coordinator RPC {method!r} timed out after "
                f"{self.timeout_s}s (wedged coordinator?)"
            ) from None
        t1 = time.perf_counter()
        if not line:
            raise ConnectionResetError("coordinator closed")
        if cid is not None:
            # After the response is in hand: everything the handler did
            # (journal append, report mutation) happens-before this point.
            trace_instant("rpc.recv", cid=cid, method=method)
        resp = json.loads(line)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        now = resp.get("now")
        if now is not None and self.sync is not None:
            # offset maps THIS process's perf_counter onto the
            # coordinator's, assuming the server stamped mid-flight.
            self.sync.add(now - (t0 + t1) / 2, t1 - t0)
        if "attempt" in resp:
            self.last_attempt = int(resp["attempt"])
        self.last_revoked = bool(resp.get("revoked", False))
        return resp["result"]

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass
