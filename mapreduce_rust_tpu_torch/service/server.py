"""Multi-tenant job service: one long-lived coordinator process, many
concurrent jobs, continuous traffic.

The port of ``mapreduce_rust_tpu/service/server.py``, copied with the
imports switched to this package: the same RPCs, grant format,
``service.journal`` records, per-job journals and reports, and the same
cache keys, so a journal written by either service replays in the other
and a key does not depend on which package computed it.

The reference coordinator lives and dies with a single batch job. This
module promotes it to a *service*: a :class:`JobService` owns the TCP
endpoint and a shared worker fleet, and every submitted job becomes one
:class:`~mapreduce_rust_tpu_torch.coordinator.server.Coordinator` instance —
the existing ``_Phase``/grant/renew/finish machinery, now *per-job state*
keyed by a job id that rides every task RPC as a trailing default arg
(the ``wid``/``sample`` wire-compat pattern). Four planes:

- **Job lifecycle** — ``submit_job`` / ``job_status`` / ``cancel_job`` /
  ``list_jobs`` / ``get_result`` RPCs on the existing newline-JSON
  transport (:func:`~mapreduce_rust_tpu_torch.coordinator.server.rpc_serve_connection`).
  Submissions enter a FIFO-with-priority admission queue; an admitted job
  gets a namespaced work dir (``{work}/job-<id>``), output dir, journal,
  lease table and JobReport. The shared fleet pulls work through
  ``get_task`` (job-tagged grants across all running jobs, admission
  order = priority order); ``renew_*_lease`` / ``report_*_task_finish``
  carry the job id and dispatch to that job's coordinator.
- **Admission control + backpressure** — a bounded in-flight-bytes
  budget across running jobs (``Config.service_inflight_budget_mb``):
  a job that would exceed it stays QUEUED, and the live doctor surfaces
  a ``service-saturated`` finding (analysis/doctor.py) while the queue
  backs up. One exception keeps the service live: when nothing is
  running, the head job admits regardless — an oversized corpus must
  fail or run, never wedge the queue forever.
- **Result serving** — completed jobs land in an LRU cache keyed on
  ``(app, corpus-digest, config-digest)``; a repeated identical
  submission is answered from cache with ZERO new task grants (its
  ``job_status`` says ``cached`` and carries no task counts). Hits,
  misses and evictions are metrics series.
- **Graceful drain / restart** — SIGTERM (or the ``shutdown`` RPC) stops
  admitting, lets running jobs finish, flushes per-job journals and
  reports, and exits; queued jobs stay in the SERVICE journal
  (``{work}/service.journal``, JSONL) and a restarted service re-queues
  them, while a job that was mid-flight resumes from its per-job
  coordinator journal.

Job-isolation audit: state that is process-global in the single-job
world and what became of it here —

- metrics registry global slot (runtime/metrics.py ``start_metrics``):
  *documented as shared* — the service, like the coordinator, uses an
  INSTANCE registry (the global belongs to co-hosted workers); per-job
  series are label-scoped (``job=<id>``), never separate registries.
- per-job device caches of the workers (grep's query tensors): the
  service worker trims them at every job switch (worker/runtime.py
  ``ServiceWorker._job_teardown``), not only at process exit.
- coordinator ``_rpc_run``/``_rpc_cid`` (happens-before call ids):
  process-global *by design* — cids must be unique across every client
  in the process, jobs included.
- the active tracer (runtime/trace.py): per process by design; per-job
  attribution rides flow-id prefixes and ``job=`` event args instead.

No torch import anywhere in this module, nor in anything it imports: the
service is a control-plane process (it must start in milliseconds and
never touch a device; the data plane lives in the workers).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import hashlib
import heapq
import itertools
import json
import logging
import os
import time

from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.coordinator.server import (
    DONE,
    NOT_READY,
    WAIT,
    Coordinator,
    ingest_fleet_sample,
    rpc_serve_connection,
)
from mapreduce_rust_tpu_torch.runtime.histogram import Histogram
from mapreduce_rust_tpu_torch.runtime.metrics import (
    MetricsHTTPServer,
    MetricsRegistry,
)
from mapreduce_rust_tpu_torch.runtime.telemetry import JobReport, write_job_report
from mapreduce_rust_tpu_torch.runtime.trace import (
    partial_path,
    per_process_path,
    start_tracing,
    stop_tracing,
    trace_instant,
)

log = logging.getLogger("mapreduce_rust_tpu_torch.service")

#: App names a spec may name. A static list, NOT the registry import: the
#: registry pulls in the torch-importing app modules, and spec validation
#: runs inside the backend-free service process.
APP_NAMES = ("grep", "inverted_index", "join", "sort", "top_k", "word_count")

#: Spec fields that change a job's OUTPUT — the config-digest input. A
#: field outside this set (priority, labels) must never split the cache.
#: split_samples IS output-determining: different sample counts derive
#: different splitters, which move range-partition boundaries.
_CONFIG_KEYS = ("app", "app_args", "reduce_n", "input_pattern",
                "split_samples")


def scan_corpus(input_dir: str, pattern: str) -> tuple:
    """ONE listing pass over a job's corpus: (sorted paths, total bytes,
    digest). The digest is runtime.lineage.corpus_fingerprint — the same
    (name, size, mtime) formula the per-job coordinator journal header
    and the lineage ledger header use (the one-digest-seam
    contract), so "same corpus" means the same thing to the cache, to
    resume and to provenance; _finalize_job cross-checks the submit-time
    value against the ledger's copy. Submission validation, the cache
    key and the admission byte count all reuse a single call — the
    submit handler runs ON the event loop, and its cost must be bounded
    by one directory scan, not three (blocking-in-async doctrine)."""
    import glob

    from mapreduce_rust_tpu_torch.runtime.lineage import corpus_fingerprint

    if not input_dir or not os.path.isdir(input_dir):
        # A missing/empty dir must not glob relative to the service's
        # CWD (os.path.join("", "*.txt") == "*.txt") — the submit
        # handler runs on the event loop and a malformed spec must cost
        # O(1), not a directory scan of wherever the service started.
        return [], 0, hashlib.sha256().hexdigest()[:16]
    paths = sorted(glob.glob(os.path.join(input_dir, pattern)))
    dg, total = corpus_fingerprint(paths)
    return paths, total, dg


def spec_corpora(spec: dict) -> list:
    """The spec's ordered (name, dir) corpus list — multi-corpus specs
    carry ``inputs`` ([[name, dir], ...]); classic specs are one unnamed
    corpus at ``input_dir``. Shared by validation, digesting and the
    per-job config, so 'which corpora' has exactly one reading."""
    corp = spec.get("inputs")
    if corp:
        return [(str(n), str(d)) for n, d in corp]
    return [("corpus", spec.get("input_dir") or "")]


def scan_corpus_spec(spec: dict) -> tuple:
    """scan_corpus over EVERY corpus of a spec: (flat sorted paths, total
    bytes, combined digest). Single-corpus specs reuse scan_corpus's
    digest unchanged (cache entries from before the multi-corpus API stay
    valid); N corpora combine per-corpus digests UNDER THEIR NAMES, so
    the same directories grouped differently — a=X b=Y vs a=Y b=X — are
    different jobs (they are: join's sides swap)."""
    pattern = spec.get("input_pattern") or "*.txt"
    corpora = spec_corpora(spec)
    if len(corpora) == 1:
        return scan_corpus(corpora[0][1], pattern)
    sig = hashlib.sha256()
    total = 0
    all_paths: list = []
    # Canonical NAME order, whatever order the submitter listed — this is
    # where a=X b=Y and b=Y a=X become one digest (validate_spec sorts
    # the spec the same way, so pre- and post-validation scans agree).
    for name, d in sorted(corpora):
        paths, nbytes, dg = scan_corpus(d, pattern)
        sig.update(f"{name}={dg};".encode())
        total += nbytes
        all_paths.extend(paths)
    return all_paths, total, sig.hexdigest()[:16]


def validate_spec(spec, inputs: "list | None" = None) -> dict:
    """Normalize + validate one job spec (the ``submit_job`` payload).
    Returns the canonical spec dict; raises ValueError on a bad one —
    submission-time, never mid-task inside a worker. ``inputs`` is an
    already-scanned listing (scan_corpus) when the caller has one; None
    lists here."""
    if not isinstance(spec, dict):
        raise ValueError("job spec must be an object")
    app = spec.get("app")
    if app not in APP_NAMES:
        raise ValueError(f"unknown app {app!r}; have {sorted(APP_NAMES)}")
    pattern = spec.get("input_pattern") or "*.txt"
    # Multi-corpus input API: ``inputs`` = [[name, dir], ...],
    # canonically SORTED BY NAME (a=X b=Y and b=Y a=X are the same job —
    # the digest-stability contract) — or the classic single input_dir.
    corpora = spec.get("inputs")
    if corpora is not None:
        if (not isinstance(corpora, (list, tuple)) or not corpora
                or not all(
                    isinstance(p, (list, tuple)) and len(p) == 2
                    and all(isinstance(x, str) and x for x in p)
                    for p in corpora
                )):
            raise ValueError(
                "inputs must be a non-empty list of [name, dir] pairs"
            )
        names = [n for n, _ in corpora]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate corpus names {names}")
        corpora = sorted(
            (n, os.path.abspath(d)) for n, d in corpora
        )
        for name, d in corpora:
            if not os.path.isdir(d):
                raise ValueError(f"corpus {name!r}: {d!r} is not a directory")
        input_dir = corpora[0][1]
    else:
        input_dir = spec.get("input_dir")
        if not input_dir or not os.path.isdir(input_dir):
            raise ValueError(f"input_dir {input_dir!r} is not a directory")
    if app == "join" and len(corpora or []) != 2:
        raise ValueError(
            "join needs exactly two named corpora "
            '(inputs: [["a", DIR], ["b", DIR]])'
        )
    if inputs is None:
        probe = dict(spec)
        if corpora is not None:
            probe["inputs"] = corpora
        inputs = scan_corpus_spec(probe)[0]
    if not inputs:
        raise ValueError(f"no inputs matching {pattern!r} in {input_dir!r}")
    reduce_n = spec.get("reduce_n", 4)
    if not isinstance(reduce_n, int) or reduce_n < 1:
        raise ValueError("reduce_n must be a positive integer")
    # Canonicalized to an EXPLICIT value: splitter derivation must be a
    # pure function of the spec alone — a fleet member falling back to
    # its own CLI default here could derive different splitters than its
    # peers for the same sort job, routing one key to two partitions.
    split_samples = spec.get("split_samples", 512)
    if not isinstance(split_samples, int) or isinstance(split_samples, bool) \
            or split_samples < 1:
        raise ValueError("split_samples must be a positive integer")
    app_args = spec.get("app_args") or {}
    if not isinstance(app_args, dict):
        raise ValueError("app_args must be an object")
    # Per-app argument contracts, enforced HERE: a bad submission must be
    # the submitter's error, never an uncaught TypeError inside every
    # fleet worker that pulls the grant — and a silently-miscoerced arg
    # (query="fox" tuple-ing to ('f','o','x')) would compute a wrong
    # result and then CACHE it for every future identical submission.
    allowed = {"top_k": {"k"}, "grep": {"query"}}.get(app, set())
    unknown = set(app_args) - allowed
    if unknown:
        raise ValueError(
            f"{app} takes no app_args {sorted(unknown)}"
            + (f" (allowed: {sorted(allowed)})" if allowed else "")
        )
    if app == "top_k" and "k" in app_args:
        k = app_args["k"]
        if isinstance(k, bool) or not isinstance(k, int) or k < 1:
            raise ValueError("top_k app_args.k must be a positive integer")
    if app == "grep":
        q = app_args.get("query")
        if (not isinstance(q, (list, tuple)) or not q
                or not all(isinstance(w, str) and w for w in q)):
            raise ValueError(
                "grep needs app_args.query: a non-empty list of words"
            )
        app_args = {**app_args, "query": list(q)}
    out = {
        "app": app,
        "app_args": app_args,
        "input_dir": os.path.abspath(input_dir),
        "input_pattern": pattern,
        "reduce_n": reduce_n,
        "split_samples": split_samples,
    }
    if corpora is not None:
        out["inputs"] = [[n, d] for n, d in corpora]
    return out


def corpus_digest(input_dir: str, pattern: str) -> str:
    return scan_corpus(input_dir, pattern)[2]


def config_digest(spec: dict) -> str:
    """Digest of the output-determining spec fields (see _CONFIG_KEYS)."""
    canon = json.dumps({k: spec.get(k) for k in _CONFIG_KEYS},
                       sort_keys=True)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


class _ResultCache:
    """LRU result cache keyed on (app, corpus-digest, config-digest).
    Values are {job, outputs} records; a hit re-validates that every
    output file still exists (a wiped output dir is a miss, recompute —
    the cache must never serve paths that are gone). Hit/miss/eviction
    counters feed the metrics registry."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._d: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # In-flight dedup tier: identical submissions
        # that JOINED a still-running twin instead of recomputing. Counted
        # beside the done-hits so a hit rate can split hit_done vs
        # hit_inflight.
        self.hits_inflight = 0

    @staticmethod
    def key(spec: dict, digest: "str | None" = None) -> str:
        """THE cache-key constructor — every writer and prober builds the
        key here (a second hand-rolled join would silently de-sync put
        and get). ``digest`` is an already-scanned corpus digest
        (scan_corpus_spec); None rescans (every corpus of the spec)."""
        if digest is None:
            digest = scan_corpus_spec(spec)[2]
        return ":".join((spec["app"], digest, config_digest(spec)))

    def get(self, key: str) -> "dict | None":
        rec = self._d.get(key)
        if rec is not None and all(os.path.exists(p) for p in rec["outputs"]):
            self._d.move_to_end(key)
            self.hits += 1
            return rec
        if rec is not None:
            del self._d[key]  # outputs gone: a stale entry must not linger
        self.misses += 1
        return None

    def put(self, key: str, record: dict) -> None:
        if self.capacity <= 0:
            return
        if not record.get("outputs"):
            # A "done" job with ZERO output files is a misconfigured or
            # corrupted run (e.g. a mis-pointed classic worker writing
            # elsewhere) — caching it would serve the empty result to
            # every future identical submission. Recompute instead.
            return
        self._d[key] = record
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def stats(self) -> dict:
        # "hits" stays the done-hit counter pre-dedup consumers read;
        # hit_done aliases it, hit_inflight is the join-the-twin tier.
        return {"hits": self.hits, "hit_done": self.hits,
                "hit_inflight": self.hits_inflight,
                "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._d)}


@dataclasses.dataclass
class Job:
    """One submitted job's service-side record. ``coord`` is the per-job
    Coordinator — the lease/attempt state machine — and exists only while
    the job is RUNNING (queued/cached/done jobs hold no scheduler
    state)."""

    jid: str
    spec: dict
    priority: int
    seq: int
    state: str = "queued"        # queued|joined|running|done|cancelled|failed
    cached: bool = False
    cache_key: str = ""
    joined: "str | None" = None  # in-flight dedup:
    # the still-queued/running twin this identical submission joined
    # instead of recomputing. A joined job holds NO scheduler state and
    # grants NOTHING; it completes (state done, cached=True, the twin's
    # outputs) when the twin does, and re-queues for real computation if
    # the twin fails or is cancelled.
    bytes_in: int = 0
    # Submit-time corpus digest (runtime.lineage.corpus_fingerprint over
    # the job's listing — the result-cache key's corpus half). On
    # lineage-enabled runs _finalize_job cross-checks it against the
    # ledger header: the cache key and the provenance plane must name the
    # same corpus, or the cache is keyed on bytes nobody scanned.
    corpus_digest: str = ""
    grants: int = 0              # tenant attribution: task grants served
    task_seconds: float = 0.0    # Σ attempt durations (final snapshot)
    submitted_s: float = 0.0     # service-uptime stamps
    started_s: "float | None" = None
    done_s: "float | None" = None
    cfg: "Config | None" = None
    coord: "Coordinator | None" = None
    outputs: list = dataclasses.field(default_factory=list)
    error: "str | None" = None
    # Loop-time snapshot of the final JobReport (to_dict): job_status
    # serves THIS for done jobs — the file write happens on an executor
    # thread and must never gate a status poll.
    report_dict: "dict | None" = None

    def queue_wait_s(self, now: float) -> float:
        end = self.started_s if self.started_s is not None else (
            self.done_s if self.done_s is not None else now
        )
        return max(end - self.submitted_s, 0.0)

    def summary(self, now: float) -> dict:
        out: dict = {
            "job": self.jid,
            "state": self.state,
            "app": self.spec.get("app"),
            "priority": self.priority,
            "cached": self.cached,
            "queue_wait_s": round(self.queue_wait_s(now), 3),
            "bytes_in": self.bytes_in,
        }
        if self.joined is not None:
            # The dedup contract: job_status names the twin.
            out["joined"] = self.joined
        if self.started_s is not None:
            end = self.done_s if self.done_s is not None else now
            out["run_s"] = round(max(end - self.started_s, 0.0), 3)
        if self.coord is not None:
            prog = self.coord.progress()
            out["tasks"] = {
                name: {"done": ph["done"], "total": ph["tasks_total"],
                       "in_flight": ph["in_flight"]}
                for name, ph in prog["phases"].items()
            }
        if self.error:
            out["error"] = self.error
        return out


class JobService:
    """The long-lived multi-job control plane. Same event-loop discipline
    as the Coordinator it hosts: every RPC handler and every tick runs ON
    the loop, so per-job state needs no locks; only file/HTTP teardown
    I/O leaves it."""

    #: Finished-job records retained in memory (job_status/list_jobs
    #: horizon). Beyond it the oldest terminal jobs drop from self.jobs —
    #: their artifacts (journal rows, job_report.json, outputs, the
    #: result-cache entry) all outlive the record, so nothing durable is
    #: lost; unbounded retention of per-job report snapshots is the OOM
    #: a continuously-traded service would otherwise walk into.
    DONE_JOBS_MAX = 256

    def __init__(self, cfg: Config, resume: bool = True,
                 now=None) -> None:
        self.cfg = cfg
        # Injectable clock seam: one trailing hook, threaded to
        # the service report and every per-job Coordinator it admits, so
        # mrmodel explores the real admit/cancel/finalize logic under a
        # virtual clock. Default keeps ``time.monotonic`` unchanged.
        self._now = now if now is not None else time.monotonic
        self.report = JobReport(now=self._now)  # service-level RPC latencies + uptime
        self.jobs: dict[str, Job] = {}
        self.running: dict[str, Job] = {}   # insertion = admission order
        self._queue: list = []              # heap of (-priority, seq, jid)
        self._seq = itertools.count()
        self._next_jid = 1
        self.worker_count = 0
        self.drained: set[int] = set()
        self.draining = False
        self.admission_blocked = False
        self.fleet: dict[int, dict] = {}
        self._live_findings: dict[str, dict] = {}
        self._queue_wait_hist = Histogram()
        self._job_wall_hist = Histogram()
        # Per-priority-class SLO histograms: class →
        # {queue_wait_s, exec_s, e2e_s}. Class = high/normal/low from the
        # submission priority sign — the admission-starvation doctor
        # finding compares low vs high queue-wait tails.
        self._slo: dict[str, dict] = {}
        # Live fleet-utilization state: wid → {job, phase,
        # since, busy_s, grants}. Busy intervals open at task grant and
        # close at the finish report; the integrator below folds
        # idle/bubble worker-seconds on every observation (serve ticks,
        # summaries), so `watch` can show per-worker utilization and the
        # doctor can price the barrier bubble while jobs still run.
        self._worker_state: dict[int, dict] = {}
        self._fleet_last_s = 0.0
        self._fleet_idle_ws = 0.0     # idle worker-seconds
        self._fleet_bubble_ws = 0.0   # idle ∩ (queued job | map barrier)
        self._fleet_active_ws = 0.0   # registered-and-not-drained w-s
        self.jobs_completed = 0
        # Provenance cross-check failures: done jobs whose
        # lineage ledger header disagrees with the submit-time corpus
        # digest the result-cache key was minted from. Nonzero means the
        # cache could serve outputs for a corpus that changed mid-run.
        self.lineage_mismatches = 0
        self.cache = _ResultCache(cfg.service_cache_entries)
        self._pending_io: list = []  # executor futures (job-report
        # writes) the serve teardown must reap before the manifest flush;
        # done entries are pruned on every append
        self._done_order: list[str] = []  # terminal jobs, oldest first
        # INSTANCE registry, same doctrine as the Coordinator: the global
        # slot belongs to co-hosted workers. Per-job series are
        # label-scoped (job=<id>) on THIS registry — never one registry
        # per job, or the scrape endpoint would fragment.
        self.registry = (
            MetricsRegistry(cfg.metrics_sample_period_s,
                            cfg.metrics_ring_points)
            if cfg.metrics_enabled else None
        )
        self._journal_path = os.path.join(cfg.work_dir, "service.journal")
        if resume:
            self._replay_journal()
            # Re-queued jobs admit immediately (a restarted service must
            # not wait for the first new submission to resume work).
            self._admit_tick()

    # ---- service journal (drain/restart) ----

    def _journal(self, op: str, jid: str, **fields) -> None:
        """One JSONL row per lifecycle transition (submit/start/done/
        cancel). Append-only, torn tails skipped on replay — the per-job
        coordinator journals stay the task-level ground truth; this one
        only has to remember WHICH jobs exist and how they ended."""
        try:
            os.makedirs(self.cfg.work_dir, exist_ok=True)
            row = {"op": op, "job": jid,
                   "t": round(self.report.uptime_s(), 3), **fields}
            with open(self._journal_path, "a") as f:
                f.write(json.dumps(row, sort_keys=True) + "\n")
            trace_instant("service.journal", op=op, job=jid)
        except OSError as e:
            log.warning("service journal write failed: %s", e)

    def _replay_journal(self) -> None:
        try:
            with open(self._journal_path) as f:
                raw = f.read()
        except OSError:
            return
        rows: list[dict] = []
        for line in raw.splitlines():
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail from a crashed append
            if isinstance(row, dict) and row.get("job"):
                rows.append(row)
        submitted: dict[str, dict] = {}
        ended: dict[str, dict] = {}
        for row in rows:
            jid = row["job"]
            if row["op"] == "submit":
                submitted[jid] = row
            elif row["op"] in ("done", "cancel"):
                ended[jid] = row
            try:
                n = int(jid.lstrip("j"))
                self._next_jid = max(self._next_jid, n + 1)
            except ValueError:
                pass
        requeued = 0
        for jid, row in submitted.items():
            spec = row.get("spec")
            if not isinstance(spec, dict):
                continue
            end = ended.get(jid)
            if end is None:
                # Submitted, never finished: re-queue. A job that was
                # mid-flight resumes from its per-job coordinator journal
                # when admission re-creates its Coordinator(resume=True).
                try:
                    self._enqueue(jid, validate_spec(spec),
                                  int(row.get("priority") or 0))
                    requeued += 1
                except ValueError as e:
                    # Corpus gone since the crash: record the failure
                    # instead of resurrecting an unrunnable job.
                    job = Job(jid=jid, spec=spec,
                              priority=int(row.get("priority") or 0),
                              seq=next(self._seq), state="failed",
                              error=str(e))
                    self.jobs[jid] = job
                    self._note_done(jid)
                    self._journal("done", jid, state="failed", error=str(e))
            else:
                state = end.get("state", "done") \
                    if end["op"] == "done" else "cancelled"
                job = Job(jid=jid, spec=spec,
                          priority=int(row.get("priority") or 0),
                          seq=next(self._seq), state=state,
                          cached=bool(end.get("cached")),
                          cache_key=end.get("cache_key") or "",
                          outputs=list(end.get("outputs") or []))
                self.jobs[jid] = job
                self._note_done(jid)
                # Re-seed the result cache from completed jobs whose
                # outputs survived — a restart must not forget what it
                # already computed (that IS the cache's whole value to a
                # long-lived service).
                if (job.state == "done" and job.cache_key and job.outputs
                        and all(os.path.exists(p) for p in job.outputs)):
                    self.cache.put(job.cache_key, {
                        "job": jid, "outputs": list(job.outputs),
                    })
        if requeued or self.jobs:
            log.info("service journal: %d job(s) replayed, %d re-queued",
                     len(submitted), requeued)

    # ---- lifecycle RPCs ----

    def _note_done(self, jid: str) -> None:
        """Record a terminal transition and bound in-memory retention:
        past DONE_JOBS_MAX the oldest terminal job's record (and its
        report snapshot) drops — disk artifacts and the cache keep the
        durable state."""
        self._done_order.append(jid)
        while len(self._done_order) > self.DONE_JOBS_MAX:
            self.jobs.pop(self._done_order.pop(0), None)

    def _enqueue(self, jid: str, spec: dict, priority: int,
                 nbytes: "int | None" = None,
                 cache_key: "str | None" = None,
                 digest: str = "") -> Job:
        if nbytes is None or cache_key is None:
            # Replay/direct callers arrive without a scan; submit_job
            # threads its single pass through. scan_corpus_spec, not
            # scan_corpus: a replayed multi-corpus job digested over its
            # first corpus only would mint a key its own completion row
            # can never hit.
            _paths, nbytes, digest = scan_corpus_spec(spec)
            cache_key = _ResultCache.key(spec, digest)
        job = Job(jid=jid, spec=spec, priority=priority,
                  seq=next(self._seq), bytes_in=nbytes,
                  submitted_s=self.report.uptime_s(),
                  cache_key=cache_key, corpus_digest=digest)
        self.jobs[jid] = job
        heapq.heappush(self._queue, (-priority, job.seq, jid))
        return job

    def submit_job(self, spec=None, priority: int = 0) -> dict:
        """Admit one job submission: validate, consult the result cache,
        queue on a miss. Returns {"ok", "job", "state", "cached"} or
        {"ok": False, "error"} — a bad spec is the SUBMITTER's error and
        must never read as a service crash. One corpus scan serves
        validation, the cache key and the admission byte count (the
        handler runs on the event loop beside every tenant's renewals)."""
        if self.draining:
            return {"ok": False, "error": "service draining — not admitting"}
        try:
            if not isinstance(spec, dict):
                raise ValueError("job spec must be an object")
            # ONE listing pass over every corpus of the spec (the
            # blocking-in-async doctrine): scan_corpus_spec iterates
            # canonical name order and digests by (basename, size,
            # mtime), so the pre-validation scan equals the canonical
            # spec's — validate_spec then reuses the listing.
            paths, nbytes, digest = scan_corpus_spec(spec)
            spec = validate_spec(spec, inputs=paths)
            priority = int(priority or 0)
        except (ValueError, TypeError) as e:
            return {"ok": False, "error": str(e)}
        jid = f"j{self._next_jid}"
        self._next_jid += 1
        key = _ResultCache.key(spec, digest)
        hit = self.cache.get(key)
        if hit is not None:
            # Served from cache: the job completes at submission time with
            # ZERO task grants — no coordinator, no leases, no report
            # rows. job_status carries cached=True and the source job id.
            now = self.report.uptime_s()
            job = Job(jid=jid, spec=spec, priority=priority,
                      seq=next(self._seq), state="done", cached=True,
                      cache_key=key, outputs=list(hit["outputs"]),
                      submitted_s=now, done_s=now)
            self.jobs[jid] = job
            self._note_done(jid)
            self._slo_hists(priority)["e2e_s"].add(0.0)
            self._journal("submit", jid, spec=spec, priority=priority)
            self._journal("done", jid, state="done", cached=True,
                          cache_key=key, outputs=job.outputs,
                          source_job=hit.get("job"))
            log.info("job %s: cache hit (source %s) — served without "
                     "computing", jid, hit.get("job"))
            return {"ok": True, "job": jid, "state": "done", "cached": True}
        twin = self._inflight_twin(key)
        if twin is not None:
            # In-flight dedup: an identical submission whose twin
            # is still queued/running JOINS it instead of recomputing —
            # zero new grants, no coordinator, no admission bytes. The
            # twin's completion completes this job with the same outputs
            # (_propagate_joined); its failure re-queues this one for
            # real computation.
            now = self.report.uptime_s()
            job = Job(jid=jid, spec=spec, priority=priority,
                      seq=next(self._seq), state="joined", cache_key=key,
                      joined=twin.jid, bytes_in=nbytes, submitted_s=now)
            self.jobs[jid] = job
            if twin.state == "queued" and priority > twin.priority:
                # Priority inheritance: a high-priority duplicate must
                # not inherit its low-priority twin's queue position
                # (pre-dedup it would have ADMITTED ahead). Raise the
                # twin and push a fresh heap entry — the stale lower-
                # priority entry pops harmlessly later (its job is no
                # longer queued by then, or the fresh entry admitted it
                # first).
                twin.priority = priority
                heapq.heappush(self._queue,
                               (-priority, twin.seq, twin.jid))
            self.cache.hits_inflight += 1
            self._journal("submit", jid, spec=spec, priority=priority,
                          joined=twin.jid)
            log.info("job %s: joined in-flight twin %s (%s) — zero new "
                     "grants", jid, twin.jid, twin.state)
            return {"ok": True, "job": jid, "state": "joined",
                    "cached": False, "joined": twin.jid}
        job = self._enqueue(jid, spec, priority, nbytes=nbytes,
                            cache_key=key, digest=digest)
        self._journal("submit", jid, spec=spec, priority=priority)
        log.info("job %s: queued (%s, %.1f MB, priority %d)", jid,
                 spec["app"], job.bytes_in / (1 << 20), priority)
        self._admit_tick()
        return {"ok": True, "job": jid, "state": job.state, "cached": False}

    def _inflight_twin(self, key: str) -> "Job | None":
        """A queued/running job with the same result-cache key — the
        dedup probe. Joined jobs themselves never match (no chains: every
        duplicate attaches to the ONE computing twin)."""
        if not key:
            return None
        for j in self.jobs.values():
            if j.cache_key == key and j.state in ("queued", "running"):
                return j
        return None

    def _propagate_joined(self, src: Job) -> None:
        """Settle every job that joined ``src`` now that src is terminal:
        done → the joined jobs complete with src's outputs (an inflight
        cache hit, journaled like one); failed/cancelled → they re-queue
        as real computations (the submitter still wants a result — the
        dedup must never amplify one twin's failure)."""
        for j in list(self.jobs.values()):
            if j.state != "joined" or j.joined != src.jid:
                continue
            now = self.report.uptime_s()
            if src.state == "done":
                j.state = "done"
                j.cached = True
                j.outputs = list(src.outputs)
                j.done_s = now
                self._note_done(j.jid)
                self._slo_hists(j.priority)["e2e_s"].add(
                    max(now - j.submitted_s, 0.0)
                )
                self._journal("done", j.jid, state="done", cached=True,
                              cache_key=j.cache_key, outputs=j.outputs,
                              source_job=src.jid)
                log.info("job %s: completed by joined twin %s",
                         j.jid, src.jid)
            else:
                j.joined = None
                j.state = "queued"
                heapq.heappush(self._queue, (-j.priority, j.seq, j.jid))
                log.info("job %s: twin %s %s — re-queued for real "
                         "computation", j.jid, src.jid, src.state)

    def job_status(self, jid=None) -> dict:
        """Per-job view. For a RUNNING job this is the coordinator
        ``stats`` shape (report + progress) under the service envelope,
        so `watch --job` renders it with the existing formatter."""
        job = self.jobs.get(jid) if isinstance(jid, str) else None
        if job is None:
            return {"ok": False, "error": f"unknown job {jid!r}"}
        now = self.report.uptime_s()
        out: dict = {"ok": True, **job.summary(now)}
        if job.coord is not None:
            out.update(job.coord.stats())
        elif job.state == "done":
            # Completed (or cache-served): report totals from the
            # loop-time snapshot (the file write may still be in flight
            # on the executor); the on-disk report is the restart
            # fallback. A cached job legitimately has neither — zero
            # task counts IS the cache-hit evidence.
            rep = job.report_dict or self._load_job_report(job)
            if rep is not None:
                out.update(rep)
            out["outputs"] = list(job.outputs)
        return out

    def _load_job_report(self, job: Job) -> "dict | None":
        if job.cached or job.cfg is None:
            return None
        path = os.path.join(job.cfg.work_dir, "job_report.json")
        try:
            with open(path) as f:
                doc = json.load(f)
            return doc.get("report", doc) if isinstance(doc, dict) else None
        except (OSError, json.JSONDecodeError):
            return None

    def cancel_job(self, jid=None) -> dict:
        job = self.jobs.get(jid) if isinstance(jid, str) else None
        if job is None:
            return {"ok": False, "error": f"unknown job {jid!r}"}
        if job.state in ("queued", "joined"):
            job.state = "cancelled"
            job.done_s = self.report.uptime_s()
            self._note_done(jid)
            self._journal("cancel", jid)
            # The heap entry (if any) stays; _admit_tick skips cancelled
            # jobs. A cancelled QUEUED twin must settle its joiners too.
            self._propagate_joined(job)
            self._admit_tick()
            return {"ok": True, "job": jid, "state": "cancelled"}
        if job.state == "running":
            # Stop granting from this job; outstanding leases answer
            # their next renewal revoked=True (the job is gone — workers
            # must drop the work, not report it).
            self._finalize_job(job, state="cancelled")
            self._journal("cancel", jid)
            return {"ok": True, "job": jid, "state": "cancelled"}
        return {"ok": False,
                "error": f"job {jid} already {job.state} — nothing to cancel"}

    def list_jobs(self) -> dict:
        now = self.report.uptime_s()
        rows = [j.summary(now) for j in sorted(
            self.jobs.values(), key=lambda j: j.seq
        )]
        return {"ok": True, "service": self.service_summary(), "jobs": rows}

    def get_result(self, jid=None) -> dict:
        """Result serving: the completed job's output files (and where
        they came from). A running/queued job answers not-ready rather
        than blocking the RPC plane."""
        job = self.jobs.get(jid) if isinstance(jid, str) else None
        if job is None:
            return {"ok": False, "error": f"unknown job {jid!r}"}
        if job.state != "done":
            return {"ok": False, "job": jid, "state": job.state,
                    "error": f"job {jid} is {job.state} — no result yet"}
        return {"ok": True, "job": jid, "cached": job.cached,
                "outputs": list(job.outputs)}

    def shutdown(self) -> dict:
        """Graceful drain over RPC (the SIGTERM handler calls the same
        method): stop admitting, finish running jobs, exit. Queued jobs
        stay journaled for the next incarnation."""
        self.request_drain()
        return {"ok": True, "draining": True,
                "running": len(self.running), "queued": self.queued_count()}

    def request_drain(self) -> None:
        if not self.draining:
            self.draining = True
            trace_instant("service.drain_requested")
            log.info("service draining: %d running, %d queued (queued jobs "
                     "stay journaled for restart)",
                     len(self.running), self.queued_count())

    # ---- SLO classes + live fleet utilization ----

    @staticmethod
    def _slo_class(priority: int) -> str:
        return "high" if priority > 0 else ("low" if priority < 0 else
                                            "normal")

    def _slo_hists(self, priority: int) -> dict:
        cls = self._slo_class(priority)
        h = self._slo.get(cls)
        if h is None:
            h = self._slo[cls] = {
                "queue_wait_s": Histogram(),
                "exec_s": Histogram(),
                "e2e_s": Histogram(),
            }
        return h

    def _fleet_accumulate(self) -> None:
        """Integrate idle/bubble worker-seconds since the last
        observation. Bubble = idle while either a job sat queued or a
        running job was blocked at the map barrier with at least one map
        task already reported (reduce work EXISTED but could not start)
        — the live counterpart of the fleet CLI's offline accounting."""
        now = self.report.uptime_s()
        dt = now - self._fleet_last_s
        if dt <= 0:
            return
        self._fleet_last_s = now
        active = [wid for wid in range(self.worker_count)
                  if wid not in self.drained]
        if not active:
            return
        self._fleet_active_ws += len(active) * dt
        idle = sum(
            1 for wid in active
            if self._worker_state.get(wid) is None
            or self._worker_state[wid]["job"] is None
        )
        if not idle:
            return
        self._fleet_idle_ws += idle * dt
        bubble = self.queued_count() > 0
        if not bubble:
            for job in self.running.values():
                c = job.coord
                if c is None:
                    continue
                if self.cfg.sched_pipeline:
                    # Pipelining dissolved the barrier as a bubble:
                    # idle is a bubble only against READY-but-
                    # ungranted reduce partitions — work the scheduler
                    # could have placed this instant but didn't.
                    if c.reduce_ready_backlog() > 0:
                        bubble = True
                        break
                elif not c.map.finished and c.map.reported:
                    bubble = True
                    break
        if bubble:
            self._fleet_bubble_ws += idle * dt

    def _fleet_grant(self, wid, jid: str, phase: str) -> None:
        if not isinstance(wid, int) or wid < 0:
            return
        self._fleet_accumulate()  # close out the idle stretch FIRST
        ws = self._worker_state.get(wid)
        if ws is None:
            ws = self._worker_state[wid] = {
                "job": None, "phase": None, "since": 0.0,
                "busy_s": 0.0, "grants": 0, "last_job": None,
            }
        if ws["job"] is None:
            ws["since"] = self.report.uptime_s()
        ws["job"], ws["phase"] = jid, phase
        # Affinity signal for the pipeline scheduler: survives
        # release, so a worker between tasks still prefers the job whose
        # spec/dictionary caches it holds.
        ws["last_job"] = jid
        ws["grants"] += 1

    def _fleet_release(self, wid) -> None:
        if not isinstance(wid, int) or wid < 0:
            return
        ws = self._worker_state.get(wid)
        if ws is None or ws["job"] is None:
            return
        self._fleet_accumulate()
        ws["busy_s"] += max(self.report.uptime_s() - ws["since"], 0.0)
        ws["job"] = ws["phase"] = None

    def fleet_view(self) -> dict:
        """The live fleet-utilization block of service_summary: per-worker
        busy seconds / utilization / current job, plus the integrated
        fleet idle and bubble worker-seconds — what `watch` renders as
        per-worker columns and `doctor trend` follows as
        fleet_bubble_frac."""
        self._fleet_accumulate()
        now = self.report.uptime_s()
        workers: dict = {}
        busy_total = 0.0
        for wid in range(self.worker_count):
            ws = self._worker_state.get(wid)
            busy = ws["busy_s"] if ws else 0.0
            row: dict = {"grants": ws["grants"] if ws else 0}
            if ws and ws["job"] is not None:
                busy += max(now - ws["since"], 0.0)
                row["job"] = ws["job"]
                row["phase"] = ws["phase"]
            row["busy_s"] = round(busy, 3)
            row["util_frac"] = round(busy / now, 4) if now > 0 else 0.0
            if wid in self.drained:
                row["drained"] = True
            busy_total += busy
            workers[str(wid)] = row
        denom = self._fleet_active_ws
        return {
            "workers": workers,
            "busy_ws": round(busy_total, 3),
            "active_ws": round(denom, 3),
            "idle_ws": round(self._fleet_idle_ws, 3),
            "bubble_ws": round(self._fleet_bubble_ws, 3),
            "util_frac": round(busy_total / denom, 4) if denom > 0 else 0.0,
            "bubble_frac": round(self._fleet_bubble_ws / denom, 4)
            if denom > 0 else 0.0,
        }

    def _tenant_row(self, job: Job) -> dict:
        ts = job.task_seconds
        if job.coord is not None:
            ts = sum(
                h.total for h in job.coord.report._phase_hist.values()
            )
        return {
            "state": job.state,
            "priority": job.priority,
            "grants": job.grants,
            "bytes_in": job.bytes_in,
            "task_seconds": round(ts, 3),
        }

    # ---- admission control ----

    def queued_count(self) -> int:
        # .get, not [..]: a cancelled-while-queued job's heap entry
        # outlives its record once DONE_JOBS_MAX retention evicts it — a
        # stale entry must read as "not queued", never KeyError a stats
        # RPC on a long-lived service. Distinct jids: priority
        # inheritance (in-flight dedup) can leave a job two heap entries.
        return len({
            jid for (_p, _s, jid) in self._queue
            if (j := self.jobs.get(jid)) is not None and j.state == "queued"
        })

    def inflight_bytes(self) -> int:
        return sum(j.bytes_in for j in self.running.values())

    def budget_bytes(self) -> int:
        return int(self.cfg.service_inflight_budget_mb * (1 << 20))

    def _admit_tick(self) -> None:
        """Move queued jobs to running while the concurrency cap and the
        in-flight-bytes budget allow. Priority first, FIFO within a
        priority (heap order). Sets ``admission_blocked`` when the head
        job is held back by the budget — the signal the
        ``service-saturated`` doctor finding reads."""
        self.admission_blocked = False
        if self.draining:
            return
        while self._queue:
            _p, _s, jid = self._queue[0]
            job = self.jobs.get(jid)
            if job is None or job.state != "queued":
                # Cancelled while queued — possibly so long ago that
                # retention already evicted the record (see _note_done).
                heapq.heappop(self._queue)
                continue
            if len(self.running) >= self.cfg.service_max_jobs:
                break
            if (self.running
                    and self.inflight_bytes() + job.bytes_in
                    > self.budget_bytes()):
                # Backpressure: queue, don't grant. The no-running
                # exception lets an oversized single job through — it
                # will fail or run, but never wedge the queue.
                self.admission_blocked = True
                break
            heapq.heappop(self._queue)
            self._admit(job)

    def _admit(self, job: Job) -> None:
        try:
            job.cfg = self._job_cfg(job)
            # resume=True: a re-queued in-flight job replays its per-job
            # coordinator journal and serves only the gaps.
            job.coord = Coordinator(job.cfg, resume=True, job_id=job.jid,
                                    now=self._now)
        except (ValueError, OSError) as e:
            job.state = "failed"
            job.error = str(e)
            job.done_s = self.report.uptime_s()
            self._note_done(job.jid)
            self._journal("done", job.jid, state="failed", error=str(e))
            log.warning("job %s: admission failed: %s", job.jid, e)
            self._propagate_joined(job)
            return
        # The service owns worker registration; the per-job barrier is
        # open by construction (worker_n=1, count synced to the fleet).
        job.coord.worker_count = max(self.worker_count, 1)
        job.state = "running"
        job.started_s = self.report.uptime_s()
        self._queue_wait_hist.add(job.queue_wait_s(job.started_s))
        self._slo_hists(job.priority)["queue_wait_s"].add(
            job.queue_wait_s(job.started_s)
        )
        self.running[job.jid] = job
        self._journal("start", job.jid)
        trace_instant("service.job_start", job=job.jid)
        log.info("job %s: running (%s, map_n=%d, reduce_n=%d, %.1f MB)",
                 job.jid, job.spec["app"], job.cfg.map_n, job.cfg.reduce_n,
                 job.bytes_in / (1 << 20))

    def _job_cfg(self, job: Job) -> Config:
        from mapreduce_rust_tpu_torch.runtime.chunker import resolve_corpora

        spec = job.spec
        corp = spec.get("inputs")
        probe = dataclasses.replace(
            self.cfg,
            input_dir=spec["input_dir"],
            input_dirs=(tuple((n, d) for n, d in corp) if corp else None),
            input_pattern=spec["input_pattern"],
        )
        inputs, _bounds, _names = resolve_corpora(probe)
        if not inputs:
            raise ValueError(
                f"no inputs matching {spec['input_pattern']!r} in "
                f"{spec['input_dir']!r} (corpus removed since submit?)"
            )
        return dataclasses.replace(
            probe,
            map_n=len(inputs),
            reduce_n=spec["reduce_n"],
            split_samples=int(spec.get("split_samples") or 512),
            worker_n=1,
            work_dir=os.path.join(self.cfg.work_dir, f"job-{job.jid}"),
            output_dir=os.path.join(self.cfg.output_dir, f"job-{job.jid}"),
            # Per-job coordinators are embedded state machines: the
            # SERVICE owns the one registry/endpoint/trace/manifest.
            metrics_enabled=False,
            metrics_port=0,
            trace_path=None,
            manifest_path=None,
            chaos=None,
        )

    # ---- worker-plane RPCs ----

    def get_worker_id(self) -> int:
        wid = self.worker_count
        self.worker_count += 1
        for job in self.running.values():
            if job.coord is not None:
                job.coord.worker_count = self.worker_count
        log.info("worker %d registered (fleet of %d)", wid, self.worker_count)
        return wid

    def deregister_worker(self, wid: int = -1) -> bool:
        if not isinstance(wid, int) or wid < 0 or wid >= self.worker_count:
            return False
        self.drained.add(wid)
        self.report.record_event("deregister", wid=wid)
        log.info("worker %d deregistered (graceful drain)", wid)
        return True

    def _running_in_order(self) -> list:
        return list(self.running.values())  # dict preserves admission order

    def _sched_order(self, wid) -> list:
        """The scoring seam: the ordered (job, phase)
        candidates get_task tries. FIFO mode reproduces the reference
        semantics exactly — one phase per running job (map until the
        barrier opens, then reduce), admission order, so a WAITing map
        phase also gates that job's reduce. Pipeline mode scores every
        grantable (job, phase) pair instead: priority class first, then
        phase criticality — ready reduce partitions (the job's exit path)
        beat a near-done map wave beat a fresh one — then the worker's
        recent-job affinity (its spec/dictionary caches are warm), with
        admission order as the deterministic tiebreak. Job B's map
        windows fill job A's barrier bubbles; what each phase may grant
        is still the per-job coordinator's call (per-partition release
        included), so outputs stay bit-identical across modes."""
        jobs = [j for j in self._running_in_order()
                if j.coord is not None and j.state == "running"]
        if not self.cfg.sched_pipeline:
            return [(j, "map" if not j.coord.map.finished else "reduce")
                    for j in jobs]
        last_job = None
        if isinstance(wid, int) and wid >= 0:
            ws = self._worker_state.get(wid)
            if ws is not None:
                last_job = ws.get("last_job")
        cands = []
        for seq, j in enumerate(jobs):
            c = j.coord
            phases = []
            if not c.map.finished:
                phases.append("map")
                if c.reduce_ready_backlog() > 0:
                    phases.append("reduce")  # per-partition release
            elif not c.reduce.finished:
                phases.append("reduce")
            for phase in phases:
                if phase == "reduce":
                    crit = 3
                else:
                    done = len(c.map.reported)
                    crit = 2 if c.map.n and done * 2 >= c.map.n else 1
                affinity = 1 if j.jid == last_job else 0
                cands.append((-j.priority, -crit, -affinity, seq, phase, j))
        cands.sort(key=lambda t: t[:4])
        return [(t[5], t[4]) for t in cands]

    def get_task(self, wid: int = -1):
        """The fleet's combined pull: one grant from the best-scored
        (job, phase) candidate that has work (see _sched_order — FIFO
        mode is verbatim admission-order polling), tagged with its job id
        — the service worker's single polling RPC. Returns a dict grant,
        WAIT (nothing grantable right now), or DONE (drained and empty:
        the fleet can go home)."""
        if self.draining and not self.running:
            return DONE
        for job, phase in self._sched_order(wid):
            c = job.coord
            tid = (c.get_map_task(wid) if phase == "map"
                   else c.get_reduce_task(wid))
            if isinstance(tid, int) and tid >= 0:
                job.grants += 1
                self._fleet_grant(wid, job.jid, phase)
                return {"job": job.jid, "phase": phase, "tid": tid,
                        "attempt": c.report.attempts(phase, tid)}
        return WAIT

    def job_spec(self, jid=None) -> dict:
        """Everything a service worker needs to run one job's tasks:
        app + args, inputs, shape, and the job-namespaced dirs. Small
        strings and ints — the control/data separation holds."""
        # Gate on STATE, not just cfg presence: a finalized job keeps its
        # cfg (job_status needs it) but its spec must answer not-ok — the
        # worker's "job vanished between grant and fetch" guard depends
        # on it (executing a cancelled job's task would write into a
        # closed job's dirs).
        job = self.jobs.get(jid) if isinstance(jid, str) else None
        if job is None or job.cfg is None or job.state != "running":
            return {"ok": False, "error": f"unknown or not-running job {jid!r}"}
        out = {
            "ok": True,
            "job": job.jid,
            "app": job.spec["app"],
            "app_args": job.spec["app_args"],
            "input_dir": job.cfg.input_dir,
            "input_pattern": job.cfg.input_pattern,
            "map_n": job.cfg.map_n,
            "reduce_n": job.cfg.reduce_n,
            # The splitter-derivation input rides the spec so EVERY
            # fleet member samples identically, whatever its own CLI
            # defaults (range apps' cross-worker determinism contract).
            "split_samples": job.cfg.split_samples,
            "work_dir": job.cfg.work_dir,
            "output_dir": job.cfg.output_dir,
        }
        if job.spec.get("inputs"):
            # Multi-corpus job: the worker re-resolves the same ordered
            # corpora (join's sides, sort's sample listing).
            out["inputs"] = [[n, d] for n, d in job.spec["inputs"]]
        return out

    def _job_for(self, jid) -> "Job | None":
        job = self.jobs.get(jid) if isinstance(jid, str) else None
        return job if job is not None and job.coord is not None \
            and job.state == "running" else None

    # Classic single-job wire compat: a pre-service worker polls
    # get_map_task/get_reduce_task with no job tag. When exactly one job
    # is running the call routes to it (grant attempts ride back via
    # _enrich_response, exactly the Coordinator envelope); with zero
    # routable jobs the worker WAITs (one may admit), and with SEVERAL
    # running an un-tagged worker cannot participate safely — DONE sends
    # it home instead of granting ambiguously. Config contract (same as
    # every classic coordinator+worker cluster): the OPERATOR must start
    # the worker with the routed job's app/input/work/output — an old
    # client has no job_spec fetch to self-configure with, and the
    # server cannot audit a wire format that predates the handshake. A
    # mis-pointed worker's empty "completion" is at least kept out of
    # the result cache (_ResultCache.put rejects output-less records);
    # the self-configuring path is `worker --service`.

    def get_map_task(self, wid: int = -1, job=None) -> int:
        j = self._route(job)
        if j is None:
            if self.draining or len(self.running) > 1:
                return DONE
            return WAIT
        tid = j.coord.get_map_task(wid)
        if isinstance(tid, int) and tid >= 0:
            j.grants += 1
            self._fleet_grant(wid, j.jid, "map")
        return tid

    def get_reduce_task(self, wid: int = -1, job=None) -> int:
        j = self._route(job)
        if j is None:
            if self.draining or len(self.running) > 1:
                return DONE
            return WAIT
        tid = j.coord.get_reduce_task(wid)
        if isinstance(tid, int) and tid >= 0:
            j.grants += 1
            self._fleet_grant(wid, j.jid, "reduce")
        return tid

    # The job id rides every task RPC as a TRAILING default arg — the
    # wid/sample wire-compat pattern: a single-job client (or test
    # caller) omits it and, when exactly one job is running, the service
    # routes to it. With several jobs live an un-tagged call is
    # unroutable and answers stale/ignored rather than guessing.

    def _route(self, job) -> "Job | None":
        j = self._job_for(job)
        if j is not None:
            return j
        if job is None and len(self.running) == 1:
            return next(iter(self.running.values()))
        return None

    def renew_map_lease(self, tid: int, wid: int = -1, sample=None,
                        job=None) -> bool:
        j = self._route(job)
        self._ingest_sample(wid, sample)
        if j is None:
            return False  # job done/cancelled/unknown: stale — and the
            # envelope (see _enrich_response) says revoked, so the worker
            # drops work nobody will collect
        return j.coord.renew_map_lease(tid, wid)

    def renew_reduce_lease(self, tid: int, wid: int = -1, sample=None,
                           job=None) -> bool:
        j = self._route(job)
        self._ingest_sample(wid, sample)
        if j is None:
            return False
        return j.coord.renew_reduce_lease(tid, wid)

    def report_map_task_finish(self, tid: int, attempt: int = 0,
                               wid: int = -1, job=None,
                               part_bytes=None, lineage=None) -> bool:
        # ``part_bytes`` is the trailing-default per-partition
        # intermediate-bytes vector — forwarded to the job's
        # coordinator, which folds it into partition readiness; ``lineage``
        # is the attempt's chunk-digest payload, forwarded the
        # same way into the job's lineage.jsonl. Old 3/4/5-positional
        # clients stay wire-valid.
        j = self._route(job)
        self._fleet_release(wid)
        if j is None:
            return True  # job already closed: the report is moot
        done = j.coord.report_map_task_finish(tid, attempt=attempt, wid=wid,
                                              part_bytes=part_bytes,
                                              lineage=lineage)
        return done

    def report_reduce_task_finish(self, tid: int, attempt: int = 0,
                                  wid: int = -1, job=None) -> bool:
        j = self._route(job)
        self._fleet_release(wid)
        if j is None:
            return True
        done = j.coord.report_reduce_task_finish(tid, attempt=attempt,
                                                 wid=wid)
        if done:
            self._finalize_job(j, state="done")
        return done

    def _ingest_sample(self, wid, sample) -> None:
        ingest_fleet_sample(self.registry, self.fleet, self.worker_count,
                            self.report.uptime_s(), wid, sample)

    # ---- completion ----

    def _finalize_job(self, job: Job, state: str) -> None:
        if job.state not in ("running",):
            return
        job.state = state
        job.done_s = self.report.uptime_s()
        self.running.pop(job.jid, None)
        self._note_done(job.jid)
        # Close the fleet view's busy intervals for workers still holding
        # this job (their leases are revoked; the next grant reopens).
        self._fleet_accumulate()
        for ws in self._worker_state.values():
            if ws["job"] == job.jid:
                ws["busy_s"] += max(job.done_s - ws["since"], 0.0)
                ws["job"] = ws["phase"] = None
        if job.coord is not None:
            # Flush the per-job report where mrcheck finds it — the same
            # artifact a single-job coordinator leaves. Snapshot ON the
            # loop (handlers mutate the report here); only the JSON dump
            # + file write leave it — this runs inside the finish-report
            # RPC handler, and a multi-MB report serialized inline would
            # stall every OTHER tenant's renewals (blocking-in-async).
            # job_status serves the in-memory snapshot, so a status poll
            # never races the write.
            job.report_dict = job.coord.report.to_dict()
            job.task_seconds = sum(
                h.total for h in job.coord.report._phase_hist.values()
            )
            path = os.path.join(job.cfg.work_dir, "job_report.json")

            def _write(path=path, doc=job.report_dict, jid=job.jid) -> None:
                try:
                    write_job_report(path, doc)
                except OSError as e:
                    log.warning("job %s: report write failed: %s", jid, e)

            try:
                loop = asyncio.get_running_loop()
                # Prune reaped futures on every append — the list must
                # not grow one dead entry per job served.
                self._pending_io = [
                    f for f in self._pending_io if not f.done()
                ]
                self._pending_io.append(
                    loop.run_in_executor(None, _write)
                )
            except RuntimeError:
                _write()  # direct (loop-less) callers: tests, embedders
        if state == "done":
            import glob

            job.outputs = sorted(glob.glob(
                os.path.join(job.cfg.output_dir, "mr-*.txt")
            ))
            self._lineage_crosscheck(job)
            self.cache.put(job.cache_key, {
                "job": job.jid, "outputs": list(job.outputs),
            })
            self.jobs_completed += 1
            if job.started_s is not None:
                self._job_wall_hist.add(job.done_s - job.started_s)
                self._slo_hists(job.priority)["exec_s"].add(
                    job.done_s - job.started_s
                )
            self._slo_hists(job.priority)["e2e_s"].add(
                max(job.done_s - job.submitted_s, 0.0)
            )
            self._journal("done", job.jid, state="done",
                          cache_key=job.cache_key, outputs=job.outputs)
        trace_instant("service.job_done", job=job.jid, state=state)
        log.info("job %s: %s (%s)", job.jid, state,
                 job.coord.report.summary() if job.coord else "no report")
        # Settle in-flight-dedup joiners now the twin is terminal: done →
        # they complete with these outputs; failed/cancelled → re-queue
        # (the _admit_tick below picks them up).
        self._propagate_joined(job)
        # Late RPCs for a closed job answer stale/moot (_job_for filters
        # on running), so the scheduler state can die with the job.
        job.coord = None
        if self.registry is not None:
            # Registry hygiene (long-lived service): drop the finished
            # job's labeled series, or the label-sets — and the scrape
            # body — grow one set per job forever while exporting the
            # corpse's stale last values. The tenant-attribution gauges
            # reap here too.
            for name in ("job.phase_issued", "job.phase_done",
                         "job.phase_in_flight", "job.phase_expired",
                         "job.grants", "job.bytes_in", "job.task_seconds"):
                self.registry.gauge(name).remove_labels(job=job.jid)
        self._admit_tick()

    def _lineage_crosscheck(self, job: Job) -> None:
        """Result-cache ↔ provenance agreement: on a
        lineage-enabled done job, the ledger header's corpus fingerprint
        — written by the coordinator from the SAME corpus_fingerprint
        seam the cache key's digest came from — must equal the
        submit-time digest, and the ledger's byte count must equal the
        admission scan's. A mismatch means the corpus changed between
        submit and scan: the result-cache entry being minted right after
        this would serve THOSE outputs for a key naming DIFFERENT bytes.
        Single-corpus specs only (the multi-corpus digest combines
        per-corpus digests under their names — not the ledger's flat
        listing); best-effort, the finalize must never fail on it."""
        if not job.corpus_digest or job.cfg is None \
                or job.spec.get("inputs"):
            return
        path = os.path.join(job.cfg.work_dir, "lineage.jsonl")
        try:
            with open(path) as f:
                hdr = json.loads(f.readline())
        except (OSError, ValueError):
            return  # no ledger (lineage off) or torn header — nothing to check
        if hdr.get("t") != "start":
            return
        ok_dg = hdr.get("corpus_meta_digest") == job.corpus_digest
        ok_bytes = hdr.get("corpus_bytes") == job.bytes_in
        if not (ok_dg and ok_bytes):
            self.lineage_mismatches += 1
            log.error(
                "job %s: lineage/cache corpus disagreement — ledger "
                "%s/%sB vs submit %s/%sB (corpus changed between submit "
                "and scan; cache entry is suspect)",
                job.jid, hdr.get("corpus_meta_digest"),
                hdr.get("corpus_bytes"), job.corpus_digest, job.bytes_in,
            )

    # ---- observability RPCs + ticks ----

    def service_summary(self) -> dict:
        return {
            "sched": self.cfg.sched,
            "uptime_s": round(self.report.uptime_s(), 3),
            "queued": self.queued_count(),
            "running": len(self.running),
            "done": sum(1 for j in self.jobs.values()
                        if j.state in ("done", "cancelled", "failed")),
            "jobs_completed": self.jobs_completed,
            "workers": self.worker_count,
            "drained": sorted(self.drained),
            "draining": self.draining,
            "inflight_bytes": self.inflight_bytes(),
            "budget_bytes": self.budget_bytes(),
            "max_jobs": self.cfg.service_max_jobs,
            "admission_blocked": self.admission_blocked,
            "lineage_mismatches": self.lineage_mismatches,
            "cache": self.cache.stats(),
            "queue_wait_s": self._queue_wait_hist.to_dict(),
            "job_wall_s": self._job_wall_hist.to_dict(),
            # Per-priority-class SLO hists, the live fleet
            # utilization/bubble view, and per-job tenant attribution —
            # the manifest + doctor + `watch` inputs.
            "slo": {
                cls: {k: h.to_dict() for k, h in hists.items()}
                for cls, hists in sorted(self._slo.items())
            },
            "fleet_util": self.fleet_view(),
            "tenants": {
                jid: self._tenant_row(j)
                for jid, j in sorted(self.jobs.items())
                if j.state in ("running", "done", "cancelled", "failed")
            },
        }

    def stats(self) -> dict:
        """Service-wide ``stats``: the summary plus per-job rows. The
        ``progress.done`` field keeps pre-service tooling's "is it over"
        probe meaningful (drained and empty = over)."""
        now = self.report.uptime_s()
        return {
            "service": self.service_summary(),
            "jobs": [j.summary(now) for j in sorted(
                self.jobs.values(), key=lambda j: j.seq
            )],
            "rpc": self.report.to_dict()["rpc"],
            "progress": {
                "done": self.draining and not self.running,
                "phase": "service",
            },
        }

    def metrics(self) -> dict:
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

    def _metrics_tick(self, http_srv=None, force: bool = False) -> None:
        """Republish service + per-job state into the registry (per-job
        series are ``job=<id>``-labeled on the Prometheus endpoint) and
        hand the scrape thread its next body. Loop-serialized, cadence-
        gated — the Coordinator._metrics_tick doctrine."""
        g = self.registry
        if g is None or not (force or g.due()):
            return
        sv = self.service_summary()
        g.gauge("service.uptime_s").set(sv["uptime_s"])
        g.gauge("service.jobs_queued").set(sv["queued"])
        g.gauge("service.jobs_running").set(sv["running"])
        g.counter("service.jobs_completed").set_total(sv["jobs_completed"])
        g.gauge("service.inflight_bytes").set(sv["inflight_bytes"])
        g.gauge("service.budget_bytes").set(sv["budget_bytes"])
        g.gauge("service.admission_blocked").set(int(sv["admission_blocked"]))
        g.gauge("service.workers").set(sv["workers"])
        cache = sv["cache"]
        g.counter("service.cache_hits").set_total(cache["hits"])
        g.counter("service.cache_hits_inflight").set_total(
            cache["hit_inflight"]
        )
        g.counter("service.cache_misses").set_total(cache["misses"])
        g.counter("service.cache_evictions").set_total(cache["evictions"])
        g.histogram("service.queue_wait_s").set_hist(self._queue_wait_hist)
        g.histogram("service.job_wall_s").set_hist(self._job_wall_hist)
        # Per-priority-class SLO histograms, cls-labeled on
        # the scrape endpoint.
        for cls, hists in self._slo.items():
            for k, h in hists.items():
                g.histogram(f"service.slo_{k}").set_hist(h, cls=cls)
        fl = sv["fleet_util"]
        g.gauge("fleet.util_frac").set(fl["util_frac"])
        g.gauge("fleet.bubble_frac").set(fl["bubble_frac"])
        g.gauge("fleet.bubble_ws").set(fl["bubble_ws"])
        for wid, row in fl["workers"].items():
            g.gauge("fleet.worker_util_frac").set(
                row["util_frac"], wid=wid
            )
        for job in self.running.values():
            if job.coord is None:
                continue
            prog = job.coord.progress()
            for name, ph in prog["phases"].items():
                for field in ("issued", "done", "in_flight", "expired"):
                    g.gauge(f"job.phase_{field}").set(
                        ph[field], job=job.jid, phase=name
                    )
            # Tenant attribution, job-labeled and reaped with
            # the phase gauges when the job finalizes.
            tr = self._tenant_row(job)
            g.gauge("job.grants").set(tr["grants"], job=job.jid)
            g.gauge("job.bytes_in").set(tr["bytes_in"], job=job.jid)
            g.gauge("job.task_seconds").set(tr["task_seconds"], job=job.jid)
        for method, h in self.report._rpc.items():
            g.counter("rpc.calls").set_total(h.count, method=method)
            g.histogram("rpc.latency_s").set_hist(h, method=method)
        g.maybe_sample()
        if http_srv is not None:
            http_srv.publish(g.prometheus_text())

    def _doctor_tick(self) -> None:
        """Streaming doctor across every running job plus the service
        plane: per-job findings carry a ``<jid>:`` key prefix (so `watch
        --job`/`doctor --live --job` can filter) and the admission plane
        contributes ``service-saturated`` when the budget holds the
        queue back (analysis/doctor.service_findings). The fold itself
        is the shared streaming-doctor dedup
        (doctor.fold_live_findings — one lifecycle, coordinator and
        service alike)."""
        from mapreduce_rust_tpu_torch.analysis.doctor import (
            deactivate_stale_findings,
            diagnose_live,
            fold_live_findings,
            service_findings,
        )
        from mapreduce_rust_tpu_torch.coordinator.server import _log_new_finding

        now = round(self.report.uptime_s(), 3)
        current = fold_live_findings(
            self._live_findings, service_findings(self.service_summary()),
            now, on_new=_log_new_finding,
        )
        for job in list(self.running.values()):
            if job.coord is None:
                continue
            try:
                diag = diagnose_live(
                    job.coord.stats(),
                    lease_timeout_s=self.cfg.lease_timeout_s,
                    fleet=self.fleet,
                )
            except Exception as e:  # diagnosis must never wedge the plane
                log.warning("live doctor tick (job %s) failed: %r",
                            job.jid, e)
                continue
            findings = [
                {**f, "job": job.jid} for f in diag.get("findings") or []
            ]
            current |= fold_live_findings(
                self._live_findings, findings, now,
                prefix=f"{job.jid}:", on_new=_log_new_finding,
            )
        deactivate_stale_findings(self._live_findings, current)

    # ---- response envelope (rpc_serve_connection hook) ----

    def _enrich_response(self, method: str, req: dict, result,
                         resp: dict) -> None:
        if (
            method in ("get_map_task", "get_reduce_task")
            and isinstance(result, int) and result >= 0
        ):
            # Classic-worker grant envelope: the attempt number rides
            # back so the flow chain joins the right attempt — same
            # contract as Coordinator._enrich_response, routed.
            params = req.get("params") or []
            j = self._route(params[1] if len(params) > 1 else None)
            if j is not None:
                phase = "map" if method == "get_map_task" else "reduce"
                resp["attempt"] = j.coord.report.attempts(phase, result)
            return
        if method in ("renew_map_lease", "renew_reduce_lease") \
                and result is False:
            params = req.get("params") or [None]
            tid = params[0]
            jid = params[3] if len(params) > 3 else None
            j = self._route(jid)
            if j is None:
                # The whole JOB is gone (done/cancelled/unknown): the
                # attempt's work has no collector — revoked, drop it.
                resp["revoked"] = True
                return
            ph = j.coord.map if method == "renew_map_lease" \
                else j.coord.reduce
            resp["revoked"] = tid in ph.reported
            if resp["revoked"]:
                j.coord.report.record_revocation(
                    "map" if ph is j.coord.map else "reduce", tid,
                    wid=params[1] if len(params) > 1 else None,
                )

    _METHODS = frozenset({
        # worker plane (the Coordinator surface, job-routed; the classic
        # get_*_task pair stays wire-valid for pre-service workers)
        "get_worker_id", "get_task", "job_spec",
        "get_map_task", "get_reduce_task",
        "renew_map_lease", "renew_reduce_lease",
        "report_map_task_finish", "report_reduce_task_finish",
        "deregister_worker",
        # lifecycle + result plane
        "submit_job", "job_status", "cancel_job", "list_jobs",
        "get_result", "shutdown",
        # observability plane
        "stats", "metrics",
    })

    # ---- serve loop ----

    async def serve(self) -> None:
        """Listen + tick loop. Unlike Coordinator.serve this does NOT end
        when a job completes — it runs until drained (SIGTERM or the
        ``shutdown`` RPC) AND no job is running. Queued jobs at drain
        stay in the service journal for the next incarnation."""
        tracer = start_tracing(tag="svc") if self.cfg.trace_path else None
        if tracer is not None:
            tracer.enable_flight_recorder(
                partial_path(per_process_path(self.cfg.trace_path, "svc")),
                period_s=self.cfg.flight_record_period_s,
            )
            if self.registry is not None:
                tracer.metrics_registry = self.registry
        http_srv = None
        if self.cfg.metrics_port and self.registry is not None:
            try:
                http_srv = MetricsHTTPServer(self.cfg.metrics_port,
                                             host=self.cfg.host)
                log.info("metrics: Prometheus endpoint on http://%s:%d"
                         "/metrics", http_srv.host, http_srv.port)
            except OSError as e:
                log.warning("metrics endpoint failed to bind port %d: %s",
                            self.cfg.metrics_port, e)
        self.metrics_http = http_srv
        self._admit_tick()
        server = await asyncio.start_server(
            self._handle, self.cfg.host, self.cfg.port
        )
        log.info(
            "job service on %s:%d (max_jobs=%d, budget=%.1f MB, cache=%d)",
            self.cfg.host, self.cfg.port, self.cfg.service_max_jobs,
            self.cfg.service_inflight_budget_mb, self.cfg.service_cache_entries,
        )
        try:
            last_check = self._now()
            while not (self.draining and not self.running):
                await asyncio.sleep(min(0.2, self.cfg.lease_check_period_s))
                if self._now() - last_check \
                        >= self.cfg.lease_check_period_s:
                    for job in list(self.running.values()):
                        if job.coord is not None:
                            job.coord.check_lease()
                    self._doctor_tick()
                    last_check = self._now()
                # Completion scan: a job whose last finish report raced a
                # connection drop still closes here, and map-only apps'
                # phase flips are picked up between reports.
                for job in list(self.running.values()):
                    if job.coord is not None and job.coord.done():
                        self._finalize_job(job, state="done")
                self._admit_tick()
                self._metrics_tick(http_srv)
                if tracer is not None:
                    tracer.maybe_snapshot()
            log.info("service drained: %d job(s) completed this "
                     "incarnation, %d still queued (journaled)",
                     self.jobs_completed, self.queued_count())
        finally:
            # Reap in-flight job-report writes BEFORE the manifest flush:
            # an exiting service must leave every finished job's artifact
            # on disk (mrcheck and the restart path read them).
            if self._pending_io:
                await asyncio.gather(*self._pending_io,
                                     return_exceptions=True)
                self._pending_io.clear()
            if tracer is not None:
                stop_tracing()
            from mapreduce_rust_tpu_torch.runtime.telemetry import (
                flush_run_artifacts,
            )

            extra: dict = {
                "kind": "service_manifest",
                "service": self.service_summary(),
            }
            if self.registry is not None:
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
                flush_run_artifacts(self.cfg, tracer, tag="svc",
                                    logger=log, extra=extra)

            # Only the I/O leaves the loop (blocking-in-async).
            await asyncio.get_running_loop().run_in_executor(None, _flush)
            if http_srv is not None:
                await asyncio.get_running_loop().run_in_executor(
                    None, http_srv.close
                )
            server.close()
            await server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        await rpc_serve_connection(self, reader, writer)
