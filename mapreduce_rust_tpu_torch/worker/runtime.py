"""Worker runtime: pull-based task loop + map/reduce task execution.

The port of ``mapreduce_rust_tpu/worker/runtime.py``'s ``Worker`` and
``ServiceWorker`` (the job service's multi-job fleet member): the same
pull loops, renewal heartbeat, retrying RPCs, drain and chaos sites, the
same intermediate files, and the port's engines underneath. There is no
Python fallback: the host engine needs the native library, the device
engine needs a card (or ``Config.device="cpu"``), and ``Worker`` raises
at construction, before it registers or holds a lease, when the device
engine has no card.

Behavioral port of the reference worker (src/bin/mrworker.rs:43-151 loop,
src/mr/worker.rs:65-193 engines), with the data plane swapped for this
framework's kernels and one reference bug class fixed throughout:

- Task loop: register (get_worker_id), then a two-state machine — map
  phase until get_map_task returns -1, then reduce phase until
  get_reduce_task returns -1, then exit (mrworker.rs:115-118). Sentinels
  -2/-3 sleep poll_retry_s and retry (mrworker.rs:51-58).
- Lease renewal: an asyncio task renewing every lease_renew_period_s —
  including on the map side, fixing the reference's no-sleep busy flood
  (mrworker.rs:87-93); a False renewal (stale) just stops the loop.
- Map task m: stream input file m through the chunker, tokenize+combine
  (device engine: ``_stream_single`` with the CUDA scan kernel per chunk;
  host engine: the fused native scan per window), partition the final
  per-task table by k1 % reduce_n, and write one spill file per partition
  plus a dictionary shard — the mr-{m}-{r}.txt protocol of the reference
  (worker.rs:117-140) with npz arrays instead of text lines, written
  temp+rename so task re-execution is atomic (the reference's
  File::create truncation can interleave with a replacement worker,
  SURVEY.md §3-D).
- Reduce task r: load every map's partition-r spill, fold exactly
  (HostAccumulator), merge dictionary shards, emit sorted lines to
  mr-{r}.txt (worker.rs:157-193 — including the last key group, which the
  reference drops).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import pathlib
import signal as _signal
import sys
import threading
import time
import uuid

import numpy as np

from mapreduce_rust_tpu_torch.analysis.chaos import ChaosPlan
from mapreduce_rust_tpu_torch.apps import get_app
from mapreduce_rust_tpu_torch.apps.base import App
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.coordinator.server import (
    DONE,
    NOT_READY,
    WAIT,
    ClockSync,
    CoordinatorClient,
    RpcTimeout,
)
from mapreduce_rust_tpu_torch.runtime.backoff import Backoff, BackoffExhausted
from mapreduce_rust_tpu_torch.runtime.dictionary import Dictionary
from mapreduce_rust_tpu_torch.runtime.metrics import (
    start_metrics,
    stop_metrics,
)
from mapreduce_rust_tpu_torch.runtime.telemetry import JobReport
from mapreduce_rust_tpu_torch.runtime.trace import (
    maybe_snapshot,
    partial_path,
    per_process_path,
    start_tracing,
    stop_tracing,
    trace_flow,
    trace_instant,
    trace_span,
)

log = logging.getLogger("mapreduce_rust_tpu_torch.worker")


def _atomic_write(path: pathlib.Path, write_fn) -> None:
    """Write-temp-then-rename with a per-writer-unique temp name: a lease
    straggler and its replacement can execute the same task concurrently
    (SURVEY.md §3-D), so the temp file must never be shared."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
    write_fn(tmp)
    os.replace(tmp, path)


def _atomic_savez(path: pathlib.Path, **arrays) -> None:
    def _w(tmp: pathlib.Path) -> None:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)

    _atomic_write(path, _w)


class Worker:
    def __init__(self, cfg: Config, app: App | None = None,
                 engine: str = "device") -> None:
        if engine not in ("host", "device"):
            raise ValueError(f"unknown engine {engine!r}")
        self.cfg = cfg
        self.app = app or get_app("word_count")
        self.engine = engine
        # The device engine runs on the card: without one (and without an
        # explicit device="cpu") this raises HERE, before the worker
        # registers or holds a lease.
        self.device = None
        if engine == "device":
            from mapreduce_rust_tpu_torch.runtime.driver import select_device

            self.device = select_device(cfg.device)
        elif self.app.combine_op not in ("sum", "distinct"):
            raise ValueError(
                f"the host engine's fused scan folds sum and distinct, not "
                f"{self.app.combine_op!r}")
        # Multi-corpus input API: the flat doc_id space
        # concatenates every corpus's sorted listing; prepare_app binds
        # the boundaries (join's side split) and — for range apps —
        # derives splitters from the SHARED seeded sampler, so every
        # worker process and every re-executed attempt routes keys
        # identically (the chaos kill leg's determinism contract).
        from mapreduce_rust_tpu_torch.runtime.chunker import resolve_corpora
        from mapreduce_rust_tpu_torch.runtime.splitter import prepare_app

        self.inputs, bounds, _names = resolve_corpora(cfg)
        self.app = prepare_app(self.app, cfg, self.inputs, bounds)
        self.work = pathlib.Path(cfg.work_dir)
        self.out = pathlib.Path(cfg.output_dir)
        self.worker_id: int | None = None
        # Worker-side control-plane telemetry, symmetric with the
        # coordinator's: tasks this worker ran (grant → finish, durations)
        # and CLIENT-observed RPC latencies — which include the network and
        # the coordinator's event loop, so comparing against the server-side
        # numbers in the `stats` RPC isolates where a slow RPC spends.
        self.report = JobReport()
        # NTP-style offset to the coordinator's clock, shared by every
        # client this worker opens (renewal connections included): lands in
        # the manifest and trace metadata for `trace merge`.
        self.sync = ClockSync()
        self._attempts: dict[tuple[str, int], int] = {}  # (phase, tid) → n
        # Deterministic fault injection (analysis/chaos.py): None unless
        # Config.chaos / MR_CHAOS carries a spec. Every site below calls
        # self._chaos(...) — one checkpoint, one trigger log.
        self.chaos = ChaosPlan.from_config(cfg)
        # Graceful drain (SIGTERM): set (thread-safely — signal handlers
        # and executor threads both touch it) to finish the current task,
        # report it, deregister, and exit cleanly between tasks.
        self._drain = threading.Event()
        self.drained = False
        # Tasks whose lease was REVOKED mid-compute (a speculative race
        # lost): their finish report is skipped — the winner already
        # journaled — and the manifest lists them.
        self.revoked_tasks: list[str] = []
        # Worker-side data-plane stats (a real JobStats, sanitized under
        # MR_SANITIZE): bytes mapped, per-task wall histogram, and the
        # device-memory high water _sample_device_memory records. Written
        # from the event-loop thread (memory samples between tasks) AND
        # from executor pool threads (per-task accounting) — every one of
        # which must register_writer first; see _execute_task.
        from mapreduce_rust_tpu_torch.analysis.sanitize import new_job_stats

        self.stats = new_job_stats(cfg)
        self.registry = None  # THIS worker's live registry;
        # the process-global slot is unreliable under in-process
        # co-hosted workers, so every worker-side tick/ship uses this.
        # Job-service context: the job id of the task currently being
        # executed. None for the classic single-job worker; the
        # ServiceWorker sets it per job so task flow-chain ids carry the
        # same ``<jid>:`` prefix the service-side coordinator emits (two
        # jobs' ``map:0:1`` chains must never merge into one arrow).
        self._job_ctx: "str | None" = None
        # Per-reduce-partition intermediate bytes of the map task just
        # executed: stashed by _run_map_task on the executor
        # thread, popped by _execute_granted and shipped on the finish
        # report as a TRAILING default RPC field — the coordinator turns
        # it into partition-readiness instants for the fleet profiler.
        # MR_FLEET=0 disables the shipping (telemetry only: outputs are
        # bit-identical either way).
        self._part_bytes: dict[int, list] = {}
        self._fleet_enabled = os.environ.get("MR_FLEET", "1") != "0"
        # Provenance: per-map-task chunk content digests,
        # stashed like _part_bytes and shipped as one more trailing
        # default field on the finish report — the coordinator appends
        # them to {work}/lineage.jsonl as attempt records. Opt-in
        # (Config.lineage / MR_LINEAGE); observational only.
        from mapreduce_rust_tpu_torch.runtime.lineage import lineage_forced

        self._task_chunks: dict[int, list] = {}
        self._lineage_on = cfg.lineage or lineage_forced()
        self._scan_digests: list = []  # executor thread, reset per task

    def _metrics_tick(self) -> None:
        """Sampler tick on this worker's own registry (the global
        metrics_tick() would sample whichever co-hosted worker installed
        the slot last)."""
        reg = self.registry
        if reg is not None:
            reg.maybe_sample()

    def _metrics_collect(self) -> dict:
        """Pull source for the live registry: the worker-side
        series that ship to the coordinator in the renewal envelope and
        land in this worker's manifest ring. Plain attribute/dict reads —
        benign against the executor threads that write them."""
        h = self.stats.hists.get("worker.task_s")
        return {
            "worker.bytes_in": self.stats.bytes_in,
            "worker.tasks_done": h.count if h is not None else 0,
            "worker.task_s_sum": round(h.total, 6) if h is not None else 0.0,
            "worker.device_mem_high_bytes": self.stats.device_mem_high_bytes,
            "worker.revoked_tasks": len(self.revoked_tasks),
            # Wait split (folded per task, executor thread): the live
            # doctor aggregates these fleet-wide into its bottleneck
            # attribution (diagnose_live._WAIT_FIELDS).
            "worker.host_map_s": round(self.stats.host_map_s, 6),
            "worker.host_glue_s": round(self.stats.host_glue_s, 6),
            "worker.ingest_wait_s": round(self.stats.ingest_wait_s, 6),
            "worker.device_wait_s": round(self.stats.device_wait_s, 6),
            "worker.scan_wait_s": round(self.stats.scan_wait_s, 6),
            "worker.all_to_all_s": round(self.stats.all_to_all_s, 6),
        }

    @property
    def _wid(self) -> int:
        """Worker id for RPC attribution (-1 = not yet registered: the
        coordinator treats it as anonymous, never a phantom worker row)."""
        return self.worker_id if self.worker_id is not None else -1

    def request_drain(self) -> None:
        """Graceful drain: finish the current task, report it, deregister,
        exit 0. Thread- and signal-safe (a threading.Event, checked at
        task boundaries — never mid-compute). The CLI wires SIGTERM here."""
        # The requester may be a signal handler or an embedding's watcher
        # thread the stats object has never seen; the drain bookkeeping it
        # triggers (final memory sample, manifest fields) must not trip
        # the sanitizer's registered-writer gate.
        self.stats.register_writer()
        trace_instant("worker.drain_requested")
        self._drain.set()

    def _chaos_pick(self, site: str, **ctx):
        """The single chaos checkpoint: returns the matching Fault (or
        None), logging + tracing every trigger so the injected fault is
        visible in the timeline next to its recovery."""
        if self.chaos is None:
            return None
        f = self.chaos.pick(site, **ctx)
        if f is not None:
            trace_instant(f"chaos.{site}",
                          **{k: v for k, v in ctx.items() if v is not None})
            log.warning("chaos: injecting %s (%s)", site, ctx)
        return f

    def _sample_memory(self) -> None:
        """Device-memory gauge from the worker task loop: only where CUDA
        is ALREADY initialized in this process (the device engine's first
        task does that). A telemetry gauge must never be what creates a
        device context in a host-engine worker."""
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return
        from mapreduce_rust_tpu_torch.runtime.driver import _sample_device_memory

        _sample_device_memory(self.stats)

    # ---- map/reduce engines ----

    def _map_table(self, doc_id: int, path: str) -> tuple[dict, Dictionary]:
        """(key-pair → combined value, dictionary shard) for one input file."""
        from mapreduce_rust_tpu_torch.analysis.sanitize import new_dictionary

        dictionary = new_dictionary(self.cfg)
        self._scan_digests = []  # fresh provenance per task
        if self.engine == "device":
            # Device-engine tasks ship no chunk list: windows stream
            # through _IngestStream, whose recorder is the driver-side
            # process-global ledger (absent in a worker process).
            return self._map_table_device(doc_id, path, dictionary)
        return self._map_table_host_native(doc_id, path, dictionary), dictionary

    def _map_table_host_native(self, doc_id: int, path: str,
                               dictionary: Dictionary):
        """Map one input with the fused native scan (the driver host-map
        engine's kernel, native/loader.cpp mr_scan_count): one pass over
        raw bytes per window instead of normalize+extract+Counter. Raises
        when the native library cannot be built (no Python fallback)."""
        from mapreduce_rust_tpu_torch.native.host import scan_count_raw
        from mapreduce_rust_tpu_torch.runtime.driver import _iter_windows
        from mapreduce_rust_tpu_torch.runtime.metrics import JobStats

        op = self.app.combine_op
        table: dict = {}
        from mapreduce_rust_tpu_torch.runtime.driver import fold_scan_into_dictionary

        for _doc, window in _iter_windows(self.cfg, [path], JobStats()):
            if self._lineage_on:
                # Same raw-window digest the driver's host-map engine
                # records — a re-executed attempt (same cfg, same file)
                # must produce the identical chunk list, which is what
                # mrcheck's lineage-conservation equality checks.
                from mapreduce_rust_tpu_torch.runtime.lineage import chunk_digest

                self._scan_digests.append(chunk_digest(window))
            raw, ends, keys, counts = scan_count_raw(window)
            mask = self.app.host_mask(keys)
            fold_scan_into_dictionary(dictionary, mask, "raw", (raw, ends, keys))
            if mask is not None:  # filtering app: keep query keys only
                keys, counts = keys[mask], counts[mask]
            if op == "sum":
                for (k1, k2), c in zip(keys.tolist(), counts.tolist()):
                    key = (k1, k2)
                    table[key] = table.get(key, 0) + c
            else:  # distinct: the value set is this doc id
                for k1, k2 in keys.tolist():
                    table.setdefault((k1, k2), set()).add(doc_id)
        return table

    def _map_table_device(self, doc_id: int, path: str, dictionary: Dictionary):
        from mapreduce_rust_tpu_torch.analysis.sanitize import new_job_stats
        from mapreduce_rust_tpu_torch.runtime.driver import HostAccumulator, _stream_single

        acc = HostAccumulator(self.app.combine_op)
        task_stats = new_job_stats(self.cfg)
        _stream_single(self.cfg, self.app, [path], task_stats, acc,
                       dictionary, doc_id_offset=doc_id, device=self.device)
        # Fold the task-local wait split into the worker's stats (executor
        # thread: a registered writer) so the renewal envelope ships a real
        # per-worker wait breakdown — the live doctor's fleet-wide
        # bottleneck attribution reads exactly these fields.
        for field in ("host_map_s", "host_glue_s", "ingest_wait_s",
                      "device_wait_s", "scan_wait_s", "all_to_all_s"):
            setattr(self.stats, field,
                    getattr(self.stats, field) + getattr(task_stats, field))
        return acc.table, dictionary

    def _chaos_task_entry(self, phase: str, tid: int, att: int) -> None:
        """Injection sites at task entry (runs on the executor thread, so
        sleeps here never starve the event loop or the renewal heartbeat):
        ``slow_scan`` — this worker computes N s slower per task (the
        heterogeneous-fleet straggler); ``kill`` — SIGKILL mid-task, lease
        held, nothing reported (the crash the lease detector exists for)."""
        f = self._chaos_pick("slow_scan", phase=phase, tid=tid, attempt=att,
                             wid=self._wid)
        if f is not None:
            time.sleep(f.seconds)
        f = self._chaos_pick("kill", phase=phase, tid=tid, attempt=att,
                             wid=self._wid)
        if f is not None:
            maybe_snapshot()  # the flight recorder keeps what we had
            os.kill(os.getpid(), _signal.SIGKILL)

    def _chaos_before_finish(self, phase: str, tid: int, att: int) -> None:
        """``pause`` site: sleep before the task returns — the task is
        DONE computing but holds its lease, renewals keep flowing. The
        slow-but-alive straggler only speculation (or patience) beats."""
        f = self._chaos_pick("pause", phase=phase, tid=tid, attempt=att,
                             wid=self._wid)
        if f is not None:
            time.sleep(f.seconds)

    def _task_fid(self, phase: str, tid: int, att: int) -> str:
        """Flow-chain id of this attempt — job-prefixed under the service
        (mirrors Coordinator._fid, the other end of the same arrow)."""
        base = f"{phase}:{tid}:{att}"
        return f"{self._job_ctx}:{base}" if self._job_ctx else base

    def _job_args(self) -> dict:
        return {"job": self._job_ctx} if self._job_ctx else {}

    def run_map_task(self, tid: int) -> None:
        att = self._attempts.get(("map", tid), 1)
        with trace_span("worker.map_task", tid=tid, attempt=att):
            # The flow step links this span into the coordinator's grant →
            # ... → finish-report chain; the instant survives in a flight-
            # recorder partial even though the span itself is only recorded
            # at task exit (a SIGKILLed attempt leaves the begin mark).
            trace_flow("task", "t", self._task_fid("map", tid, att),
                       phase="map", tid=tid, **self._job_args())
            trace_instant("worker.task_begin", phase="map", tid=tid, attempt=att)
            self._chaos_task_entry("map", tid, att)
            self._run_map_task(tid)
            self._chaos_before_finish("map", tid, att)

    def _run_map_task(self, tid: int) -> None:
        path = self.inputs[tid]
        # Data-plane accounting on the executor thread (the sanitizer's
        # registered-writer gate covers this — _execute_task registered).
        try:
            self.stats.bytes_in += os.path.getsize(path)
        except OSError:
            pass
        t_map = time.perf_counter()
        table, dictionary = self._map_table(tid, path)
        if self.engine != "device":
            # Per-task (never per-record) scan accounting: the device path
            # folds its own exact wait split in _map_table_device; the
            # host/python paths book the whole table build as scan time so
            # the renewal envelope still ships a usable host_map_s series.
            self.stats.host_map_s += time.perf_counter() - t_map
        self.work.mkdir(parents=True, exist_ok=True)
        op = self.app.combine_op
        reduce_n = self.cfg.reduce_n
        # Partition routing goes through the app seam: hash
        # apps keep k1 % reduce_n; range apps (sort) need the WORD to
        # searchsorted their sampler-bound splitters — resolved in one
        # vectorized route_block sweep over the task dictionary's sorted
        # stream (iter_sorted serves spilled dictionaries too), keeping
        # only a hash→partition INT per key, never a second copy of the
        # word bytes. A key the dictionary somehow lost routes to
        # partition 0 — the same key would be an unknown_keys count at
        # egress.
        route = self.app.route
        part_of: "dict | None" = None
        if self.app.partition_mode == "range":
            part_of = {}
            blk_keys: list = []
            blk_words: list = []

            def _route_blk() -> None:
                if blk_words:
                    rr = self.app.route_block(
                        blk_words, [k1 for k1, _ in blk_keys], reduce_n
                    )
                    part_of.update(zip(blk_keys, rr))
                    blk_keys.clear()
                    blk_words.clear()

            for _packed, k1, k2, word in dictionary.iter_sorted():
                blk_keys.append((k1, k2))
                blk_words.append(word)
                if len(blk_words) >= (1 << 16):
                    _route_blk()
            _route_blk()
        parts: dict[int, list] = {r: [] for r in range(reduce_n)}
        for (k1, k2), v in table.items():
            r = part_of.get((k1, k2), 0) if part_of is not None \
                else route(None, k1, reduce_n)
            if op == "distinct":
                for d in sorted(v):
                    parts[r].append((k1, k2, d))
            else:
                parts[r].append((k1, k2, v))
        part_bytes = [0] * reduce_n
        for r, rows in parts.items():
            arr = np.asarray(rows, dtype=np.int64).reshape(-1, 3)
            # 4+4+8 bytes per row as written (k1/k2 uint32, value int64) —
            # the intermediate-shard payload this map task contributes to
            # partition r, independent of npz container overhead.
            part_bytes[r] = 16 * arr.shape[0]
            _atomic_savez(
                self.work / f"mr-{tid}-{r}.npz",
                k1=arr[:, 0].astype(np.uint32),
                k2=arr[:, 1].astype(np.uint32),
                value=arr[:, 2].astype(np.int64),
            )
        if self._fleet_enabled:
            self._part_bytes[tid] = part_bytes
        if self._lineage_on and self._scan_digests:
            self._task_chunks[tid] = list(self._scan_digests)
        # Dictionary shards are partitioned by the same app route as the
        # spills, so reduce task r reads exactly its own words —
        # mirroring the mr-{m}-{r} protocol (src/mr/worker.rs:121).
        # iter_sorted, not items(): it serves the WHOLE dictionary whether
        # or not a budget flush spilled words to disk runs (items() raises
        # on a spilled instance — mrlint rule spilled-dict-api caught this).
        dict_parts: dict[int, Dictionary] = {r: Dictionary() for r in range(reduce_n)}
        for _packed, k1, k2, word in dictionary.iter_sorted():
            r = part_of.get((k1, k2), 0) if part_of is not None \
                else route(word, k1, reduce_n)
            dict_parts[r]._word_of[(k1, k2)] = word
        for r, dp in dict_parts.items():
            dp.collisions = list(dictionary.collisions) if r == 0 else []
            _atomic_write(self.work / f"dict-{tid}-{r}.txt", dp.save)
        log.info("map %d: %s → %d keys, %d dict words", tid, path, len(table), len(dictionary))

    def run_reduce_task(self, tid: int) -> None:
        att = self._attempts.get(("reduce", tid), 1)
        with trace_span("worker.reduce_task", tid=tid, attempt=att):
            trace_flow("task", "t", self._task_fid("reduce", tid, att),
                       phase="reduce", tid=tid, **self._job_args())
            trace_instant("worker.task_begin", phase="reduce", tid=tid, attempt=att)
            self._chaos_task_entry("reduce", tid, att)
            self._run_reduce_task(tid)
            self._chaos_before_finish("reduce", tid, att)

    def _run_reduce_task(self, tid: int) -> None:
        from mapreduce_rust_tpu_torch.analysis.sanitize import new_dictionary
        from mapreduce_rust_tpu_torch.runtime.driver import HostAccumulator

        acc = HostAccumulator(self.app.combine_op)
        dictionary = new_dictionary(self.cfg)
        for m in range(len(self.inputs)):
            spill = self.work / f"mr-{m}-{tid}.npz"
            with np.load(spill) as z:
                keys = np.stack([z["k1"], z["k2"]], axis=1)
                acc.add(keys, z["value"])
            dictionary.merge(Dictionary.load(self.work / f"dict-{m}-{tid}.txt"))
        is_distinct = self.app.combine_op == "distinct"
        items = []
        for key, v in acc.table.items():
            word = dictionary.lookup(*key)
            if word is None:
                continue
            items.append((word, sorted(v) if is_distinct else v, key))
        lines = self.app.finalize_partition(items, tid)
        self.out.mkdir(parents=True, exist_ok=True)
        tmp = self.out / f"mr-{tid}.txt.tmp"
        with open(tmp, "wb") as f:
            for line in lines:
                f.write(line + b"\n")
        os.replace(tmp, self.out / f"mr-{tid}.txt")
        log.info("reduce %d: %d keys → mr-%d.txt", tid, len(items), tid)

    # ---- task loop ----

    async def _main(self, client: CoordinatorClient) -> bool:
        """The pull loop proper — between registration and teardown.
        Returns True when the worker exited because a DRAIN was
        requested. The classic two-phase machine here; the ServiceWorker
        overrides this with the multi-job loop (same setup/teardown).
        Under ``--sched pipeline`` the two phases interleave instead —
        coordinator and workers must agree on the mode."""
        wid = self.worker_id
        if self.cfg.sched_pipeline:
            log.info("worker %d: pipelined map+reduce loop", wid)
            return await self._run_pipelined(client)
        log.info("worker %d: map phase", wid)
        draining = await self._run_phase(
            client, "get_map_task", "renew_map_lease",
            "report_map_task_finish", self.run_map_task)
        if not draining:
            log.info("worker %d: reduce phase", wid)
            draining = await self._run_phase(
                client, "get_reduce_task", "renew_reduce_lease",
                "report_reduce_task_finish", self.run_reduce_task)
        return draining

    async def _run_pipelined(self, client: CoordinatorClient) -> bool:
        """Interleaved pull loop (``--sched pipeline``): one
        poll round asks the map side first and, when it has nothing to
        give right now (WAIT — every map issued, stragglers in flight),
        asks for per-partition-released reduce work, so this worker
        starts reducing ready partitions while other workers' map tasks
        are still running. DONE from the reduce side ends the job; DONE
        from the map side just stops asking it. Same drain/backoff/
        teardown contract as _run_phase."""
        poll = Backoff(
            base_s=self.cfg.poll_retry_s,
            cap_s=self.cfg.effective_poll_retry_cap_s(),
            jitter=0.25,
        )
        map_done = False
        while True:
            if self._drain.is_set():
                return True  # between tasks: nothing held, nothing owed
            try:
                if not map_done:
                    tid = await self._call_with_retry(
                        client, "get_map_task", self._wid)
                    if tid == DONE:
                        map_done = True
                    elif tid not in (NOT_READY, WAIT):
                        poll.reset()
                        att = client.last_attempt or 1
                        if not await self._execute_granted(
                                client, "map", tid, att, "renew_map_lease",
                                "report_map_task_finish", self.run_map_task):
                            return False
                        continue  # map side is hot — ask it again first
                tid = await self._call_with_retry(
                    client, "get_reduce_task", self._wid)
            except ConnectionError:
                log.info("coordinator gone — assuming job complete")
                return False
            if tid == DONE:
                return False
            if tid not in (NOT_READY, WAIT):
                poll.reset()
                att = client.last_attempt or 1
                if not await self._execute_granted(
                        client, "reduce", tid, att, "renew_reduce_lease",
                        "report_reduce_task_finish", self.run_reduce_task):
                    return False
                continue
            maybe_snapshot()
            self._metrics_tick()
            self._sample_memory()
            await asyncio.sleep(poll.next_delay())

    def _execute_task(self, run_task, tid: int) -> None:
        """Executor-thread task wrapper: per-task data-plane accounting +
        the post-task device-memory sample, from the thread that just ran
        the compute. The pool hands SPECULATIVE attempts to whatever
        thread is free — often one the stats object has never seen — so
        each task registers its own thread as a writer."""
        self.stats.register_writer()
        t0 = time.perf_counter()
        run_task(tid)
        self.stats.record_hist("worker.task_s", time.perf_counter() - t0)
        # Post-compute sample on THIS thread: the device engine's high
        # water peaks during the task, which the between-task event-loop
        # sample misses.
        self._sample_memory()

    async def _call(self, client: CoordinatorClient, method: str, *params):
        """client.call with the round-trip latency recorded (client-observed:
        network + coordinator event loop + handler)."""
        t0 = time.perf_counter()
        try:
            return await client.call(method, *params)
        finally:
            self.report.record_rpc(method, time.perf_counter() - t0)

    def _phase_name(self, method: str) -> str:
        return "map" if "map" in method else "reduce"

    async def _renewal_loop(self, client: CoordinatorClient, method: str,
                            tid: int, stop: asyncio.Event,
                            revoked: "asyncio.Event | None" = None,
                            job: "str | None" = None) -> None:
        # ``stop`` backs up task cancellation: on Python < 3.12,
        # asyncio.wait_for SWALLOWS a cancel that lands just as its inner
        # future completes (bpo-42130) — with the per-call rpc timeout
        # wrapping readline in wait_for, a renewal loop cancelled at
        # exactly a response boundary would keep renewing forever, the
        # lease would never expire, and the task's finish report would
        # never be sent: a distributed deadlock. The flag makes the exit
        # condition level-triggered instead of edge-triggered.
        #
        # ``revoked`` is the speculation-loser signal: a failed
        # renewal whose envelope says revoked=True means another attempt
        # already COMPLETED this task — set the event so the task loop
        # skips the finish report (the winner journaled; ours would only
        # land as a late report of work nobody needs).
        phase = self._phase_name(method)
        att = self._attempts.get((phase, tid), 1)
        try:
            if self._chaos_pick("wedge_renewal", phase=phase, tid=tid,
                                attempt=att, wid=self._wid) is not None:
                # Wedged heartbeat thread: the task keeps computing but no
                # renewal ever goes out — the lease expires under a LIVE
                # task and our eventual report lands late. stop.wait()
                # (not a sleep loop) so teardown stays immediate.
                await stop.wait()
                return
            while not stop.is_set():
                await asyncio.sleep(self.cfg.lease_renew_period_s)
                if stop.is_set():
                    return
                # Latest metrics sample rides the renewal envelope as a
                # TRAILING arg — same wire-compat trick as wid:
                # an in-process/pre-metrics caller omits it and the
                # coordinator's default applies. Computed before the call
                # (cheap flat dict), shipped only when metrics are on.
                # THIS worker's registry, never the process-global slot:
                # in-process co-hosted workers replace the global, and a
                # sample shipped under the wrong wid would show every
                # worker with the last-started worker's stats.
                # ``job`` is the OUTERMOST trailing arg — a service
                # renewal always ships 4 params (sample may be None) so
                # the job id keeps its position; the single-job wire
                # format below is untouched.
                reg = self.registry
                if job is not None:
                    ok = await self._call(
                        client, method, tid, self._wid,
                        reg.ship_sample() if reg is not None else None, job,
                    )
                elif reg is not None:
                    ok = await self._call(client, method, tid, self._wid,
                                          reg.ship_sample())
                else:
                    ok = await self._call(client, method, tid, self._wid)
                if stop.is_set():
                    return  # a swallowed cancel still exits here
                self.report.record_renewal(phase, tid, bool(ok), wid=self._wid)
                # Snapshot AFTER the renewal is on the wire: under GIL
                # contention with the compute thread the snapshot's IO can
                # take 100s of ms, and the heartbeat must never queue
                # behind telemetry (a delayed renewal is a lease expiry).
                maybe_snapshot()
                self._metrics_tick()
                if not ok:
                    if revoked is not None and client.last_revoked:
                        revoked.set()
                        log.info("%s %d attempt %d revoked — another "
                                 "attempt won", phase, tid, att)
                    return  # stale lease (already reported) — just stop
        except (asyncio.CancelledError, ConnectionResetError):
            pass
        except RpcTimeout as e:
            # A wedged coordinator: stop renewing — the lease expires
            # server-side (if the coordinator ever recovers) and our own
            # eventual finish report lands as a late_report. The task
            # itself keeps computing; only the heartbeat is dead.
            log.warning("renewal loop for %s %d stopped: %s", phase, tid, e)

    async def _call_with_retry(self, client: CoordinatorClient, method: str,
                               *params):
        """Task-loop RPC with transient-failure hardening: an RpcTimeout
        (wedged or momentarily stalled coordinator) retries on a fresh
        connection under jittered exponential backoff with a budget —
        then surfaces the timeout. ConnectionError is NOT retried: a
        vanished coordinator means the job completed (the caller's
        long-standing heuristic), and retrying it for a full budget would
        turn every clean shutdown into a minute-long stall. Safe to
        retry: grants self-heal via lease expiry, finish reports are
        idempotent per (phase, tid)."""
        backoff = Backoff(
            self.cfg.rpc_backoff_base_s, self.cfg.rpc_backoff_cap_s,
            budget_s=self.cfg.rpc_backoff_budget_s,
        )
        while True:
            try:
                return await self._call(client, method, *params)
            except RpcTimeout as e:
                try:
                    delay = backoff.next_delay()
                except BackoffExhausted:
                    raise e from None
                log.warning("%s: %s — retrying in %.2fs (attempt %d)",
                            method, e, delay, backoff.attempts)
                await asyncio.sleep(delay)
                # The old connection is poisoned (a late response would
                # desync request ids): reconnect before the retry. A
                # refused reconnect = coordinator genuinely gone — the
                # ConnectionError propagates to the caller's done path.
                await client.close()
                await client.connect(
                    budget_s=self.cfg.rpc_backoff_budget_s
                )

    async def _run_phase(self, client: CoordinatorClient, get: str, renew: str,
                         report: str, run_task) -> bool:
        """One phase of the pull loop. Returns True when the worker exited
        because a DRAIN was requested (the caller then deregisters and
        skips any remaining phase) — False on normal phase completion."""
        phase = self._phase_name(get)
        # Sentinel (-2/-3) polling backs off exponentially from
        # poll_retry_s up to the cap instead of hammering at a fixed rate;
        # a real grant resets the envelope.
        poll = Backoff(
            base_s=self.cfg.poll_retry_s,
            cap_s=self.cfg.effective_poll_retry_cap_s(),
            jitter=0.25,
        )
        while True:
            if self._drain.is_set():
                return True  # between tasks: nothing held, nothing owed
            try:
                # The worker id rides on every task RPC so the coordinator
                # attributes grants/renewals/finishes per worker (the
                # `watch` worker column + doctor straggler input).
                tid = await self._call_with_retry(client, get, self._wid)
            except ConnectionError:
                # Coordinator exited between our WAIT poll and this call —
                # the job completed while we slept. A clean end, not a crash.
                # (ConnectionError only: other OSErrors — fd exhaustion,
                # network flaps — must surface, not fake success. An
                # RpcTimeout — wedged, not gone — propagates once the
                # retry budget is spent.)
                log.info("coordinator gone — assuming job complete")
                return False
            if tid == DONE:
                return False
            if tid in (NOT_READY, WAIT):
                maybe_snapshot()
                self._metrics_tick()
                self._sample_memory()
                await asyncio.sleep(poll.next_delay())
                continue
            poll.reset()
            # The grant response carried the coordinator's attempt number:
            # the task span joins that attempt's flow chain, and the
            # worker's own event log records the same attempt the
            # coordinator's does (mrcheck reads either side uniformly).
            att = client.last_attempt or 1
            if not await self._execute_granted(client, phase, tid, att,
                                               renew, report, run_task):
                return False

    async def _execute_granted(self, client: CoordinatorClient, phase: str,
                               tid: int, att: int, renew: str, report: str,
                               run_task, job: "str | None" = None) -> bool:
        """One granted task end to end — renewal heartbeat on its own
        connection, compute on the executor, speculation-revocation
        handling, the chaos finish sites, and the idempotent finish
        report. Shared by the single-job phase loop and the ServiceWorker
        (``job`` = the service job id, threaded onto the renewal/report
        RPCs as the trailing arg). Returns False when the coordinator
        vanished mid-report — job complete, the caller stops its loop."""
        self.report.record_grant(phase, tid, wid=self._wid, attempt=att)
        self._attempts[(phase, tid)] = att
        fid = self._task_fid(phase, tid, att)
        # Separate connection for renewals, like the reference's
        # spawned renewal task (mrworker.rs:70-94) — but paced.
        renew_client = CoordinatorClient(
            self.cfg.host, self.cfg.port,
            timeout_s=self.cfg.rpc_timeout_s, sync=self.sync,
        )
        await renew_client.connect()
        stop_renewal = asyncio.Event()
        revoked = asyncio.Event()
        renewal = asyncio.create_task(
            self._renewal_loop(renew_client, renew, tid, stop_renewal,
                               revoked, job=job)
        )
        try:
            # Heavy compute off the event loop so renewals keep flowing.
            await asyncio.get_running_loop().run_in_executor(
                None, self._execute_task, run_task, tid
            )
        finally:
            # Flag first, then cancel: see _renewal_loop on why cancel
            # alone can be swallowed mid-RPC on Python < 3.12.
            stop_renewal.set()
            renewal.cancel()
            await asyncio.gather(renewal, return_exceptions=True)
            await renew_client.close()
        self._sample_memory()
        if revoked.is_set():
            # Speculation loser: another attempt already completed and
            # journaled this task. Terminate OUR flow chain (the lost
            # race stays visible in the merged timeline) and never
            # send the finish report — the coordinator-side journal
            # must hold exactly one line per task.
            trace_flow("task", "f", fid, phase=phase, tid=tid, revoked=True,
                       **self._job_args())
            self.revoked_tasks.append(fid)
            log.info("%s %d: dropping finish report (revoked)", phase, tid)
            maybe_snapshot()
            return True
        f = self._chaos_pick("delay_finish", phase=phase, tid=tid,
                             attempt=att, wid=self._wid)
        if f is not None:
            await asyncio.sleep(f.seconds)
        if self._chaos_pick("drop_finish", phase=phase, tid=tid,
                            attempt=att, wid=self._wid) is not None:
            # The report never leaves this worker: the coordinator
            # sees only silence, the lease expires, the task re-runs
            # (atomic spill rewrites keep the rerun bit-identical).
            log.warning("%s %d: finish report dropped (chaos)", phase, tid)
        else:
            params = [tid, self._attempts.get((phase, tid), 0), self._wid]
            part_bytes = self._part_bytes.pop(tid, None) \
                if phase == "map" else None
            lineage = self._task_chunks.pop(tid, None) \
                if phase == "map" else None
            if lineage is not None:
                # One more trailing default after part_bytes:
                # the attempt's chunk digests, appended by the
                # coordinator to the job's lineage.jsonl. part_bytes
                # must fill its slot (possibly None — MR_FLEET=0).
                params.extend([job, part_bytes, {"chunks": lineage}])
            elif part_bytes is not None:
                # Trailing default fields, wid/sample-style: old servers
                # never see them, old clients stay wire-valid. ``job``
                # (the service's job id, None for the one job a
                # Coordinator runs) must fill its slot so part_bytes lands
                # as the 5th positional on both Coordinator and service.
                params.extend([job, part_bytes])
            elif job is not None:
                params.append(job)
            try:
                await self._call_with_retry(client, report, *params)
            except ConnectionError:
                # The coordinator exited while we computed: under
                # speculation a revoked loser can outlive the whole
                # JOB (another attempt won, every phase closed, the
                # coordinator left before our renewal could observe
                # the revocation). Our result is unneeded — terminate
                # the chain as revoked and end like the poll path.
                trace_flow("task", "f", fid, phase=phase, tid=tid,
                           revoked=True, **self._job_args())
                self.revoked_tasks.append(fid)
                log.info("%s %d: coordinator gone before finish report "
                         "— job complete, dropping it", phase, tid)
                return False
        self.report.record_finish(phase, tid, wid=self._wid,
                                  attempt=self._attempts.get((phase, tid)))
        maybe_snapshot()
        self._metrics_tick()
        return True

    async def run(self) -> None:
        # The loop thread may not be the thread that CONSTRUCTED this
        # worker (embedding harnesses run asyncio off-thread): its
        # between-task memory samples write stats, so it registers.
        self.stats.register_writer()
        # The worker honors Config.trace_path/manifest_path like the driver
        # does, under per-process names (several workers share one Config).
        tag = f"w{os.getpid()}"
        tracer = start_tracing(tag=tag) if self.cfg.trace_path else None
        if tracer is not None:
            tracer.clock_sync = self.sync  # live object: snapshots carry
            # whatever offset estimate exists at snapshot time
            tracer.enable_flight_recorder(
                partial_path(per_process_path(self.cfg.trace_path, tag)),
                period_s=self.cfg.flight_record_period_s,
            )
        # Live metrics: sampled from the renewal/poll loops into
        # this worker's ring (→ manifest stats.timeseries) and shipped to
        # the coordinator in the renewal envelope for the fleet-wide view.
        registry = None
        if self.cfg.metrics_enabled:
            # start_metrics installs the global slot too (the OS-process
            # case: build_manifest and engine-side ticks read it), but
            # every worker-side use goes through self.registry — the
            # global is last-writer-wins under in-process co-hosting.
            registry = self.registry = start_metrics(
                self.cfg.metrics_sample_period_s,
                self.cfg.metrics_ring_points,
            )
            registry.add_collector(self._metrics_collect)
            if tracer is not None:
                tracer.metrics_registry = registry
        client = CoordinatorClient(
            self.cfg.host, self.cfg.port,
            timeout_s=self.cfg.rpc_timeout_s, sync=self.sync,
        )
        await client.connect()
        try:
            wid = await client.call("get_worker_id")
            if wid == DONE:
                log.info("coordinator full — exiting")
                return
            self.worker_id = wid
            draining = await self._main(client)
            if draining:
                # Graceful drain: the current task is finished and
                # reported; deregister so watch/progress show DRAINED
                # instead of a silence the lease detector must diagnose.
                self.drained = True
                try:
                    await self._call(client, "deregister_worker", self._wid)
                except (ConnectionError, RpcTimeout):
                    pass  # coordinator gone/wedged: drain proceeds anyway
                log.info("worker %d: drained (%s)", wid, self.report.summary())
            else:
                log.info("worker %d: done (%s)", wid, self.report.summary())
        finally:
            await client.close()
            if tracer is not None:
                stop_tracing()
            from mapreduce_rust_tpu_torch.runtime.telemetry import flush_run_artifacts

            extra = {
                "kind": "worker_manifest",
                "worker_id": self.worker_id,
                "engine": self.engine,
                "report": self.report.to_dict(),
                # NTP-style offset to the coordinator clock (offset ±
                # RTT/2): the stitcher's cross-process rebase evidence.
                "clock_sync": self.sync.best(),
                "drained": self.drained,
                # Worker-loop device-memory high water (0 when CUDA was
                # never initialized in this process).
                "device_mem_high_bytes": self.stats.device_mem_high_bytes,
                # Worker data-plane stats: bytes this
                # worker mapped + its per-task wall histogram — written
                # from registered executor threads only.
                "worker_stats": {
                    "bytes_in": self.stats.bytes_in,
                    "task_s": {
                        name: h.to_dict()
                        for name, h in sorted(self.stats.hists.items())
                    },
                },
            }
            if self.engine == "device":
                # The scan kernel's launch count in this PROCESS (every
                # worker it hosts): evidence that the map tasks ran on the
                # card, beside device_mem_high_bytes.
                from mapreduce_rust_tpu_torch.ops.tokenize_cuda import tokenize_hash

                extra["kernel_launches"] = {"tokenize_hash": tokenize_hash.launches}
            # The library builds and loads of this PROCESS: a fleet started
            # after the libraries were built shows hits only.
            from mapreduce_rust_tpu_torch.ops.cuda_build import BUILD_LOG, build_totals

            extra["kernel_builds"] = build_totals(list(BUILD_LOG))
            if self.revoked_tasks:
                extra["revoked_tasks"] = self.revoked_tasks
            if self.chaos is not None:
                # The honest record of which injected faults actually
                # fired (a SIGKILLed worker can't write this — its faults
                # are visible as the crash itself).
                extra["chaos"] = {
                    "spec": self.chaos.spec,
                    "fired": self.chaos.fired(),
                }

            def _flush() -> None:
                flush_run_artifacts(
                    self.cfg, tracer, tag=f"w{os.getpid()}", logger=log,
                    extra=extra,
                )

            # Off the event loop (mrlint: blocking-in-async): the flush
            # shells out to git and writes trace/manifest files — nothing
            # else on this loop should stall behind teardown telemetry.
            await asyncio.get_running_loop().run_in_executor(None, _flush)
            if registry is not None:
                # After the flush: build_manifest serialized the ring from
                # the still-active registry. Compare-and-clear — a
                # co-hosted worker may own the global slot by now.
                stop_metrics(registry)
                self.registry = None


class ServiceWorker(Worker):
    """Multi-job worker for the JobService: one registration, then a
    single ``get_task`` pull across EVERY running job — the grant arrives
    job-tagged ({job, phase, tid, attempt}) and the worker switches its
    task context (app, inputs, namespaced work/output dirs, reduce_n) per
    job from a cached ``job_spec`` fetch. Task execution, renewal
    heartbeats, speculation revocation, chaos sites and the manifest
    teardown are the inherited single-job machinery — only the loop shape
    changes (jobs interleave instead of phases sequencing).

    The device engine is the default, as for ``Worker``: without a card
    (and without ``device="cpu"``) construction raises before the worker
    registers. The device ``Worker.__init__`` resolved is kept in
    ``self.device`` and survives every job switch (``_apply_spec``
    rebuilds ``self.cfg`` only), so no job's map task falls to the CPU.

    Per-job-end teardown: switching jobs drops the per-job device caches
    (grep's query tensors), which a long-lived multi-job worker would
    otherwise hold until process exit."""

    #: Spec-cache bound: a fleet member that serves thousands of jobs
    #: over days must not hoard one spec dict per job forever. LRU — a
    #: dropped spec is just one job_spec RPC away.
    SPEC_CACHE_MAX = 64

    def __init__(self, cfg: Config, engine: str = "device") -> None:
        super().__init__(cfg, engine=engine)
        self._base_cfg = cfg
        self._specs: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._current_job: "str | None" = None

    async def _main(self, client: CoordinatorClient) -> bool:
        wid = self.worker_id
        log.info("worker %d: service loop", wid)
        poll = Backoff(
            base_s=self.cfg.poll_retry_s,
            cap_s=self.cfg.effective_poll_retry_cap_s(),
            jitter=0.25,
        )
        while True:
            if self._drain.is_set():
                return True  # between tasks: nothing held, nothing owed
            try:
                grant = await self._call_with_retry(client, "get_task",
                                                    self._wid)
            except ConnectionError:
                # Service exited (drained) between polls — a clean end.
                log.info("service gone — exiting")
                return False
            if grant == DONE:
                return False  # drained and empty: the fleet goes home
            if not isinstance(grant, dict):
                # WAIT/NOT_READY: nothing grantable across any job.
                maybe_snapshot()
                self._metrics_tick()
                self._sample_memory()
                await asyncio.sleep(poll.next_delay())
                continue
            poll.reset()
            jid = grant.get("job")
            phase = grant.get("phase")
            tid = grant.get("tid")
            att = int(grant.get("attempt") or 1)
            if not isinstance(jid, str) or phase not in ("map", "reduce") \
                    or not isinstance(tid, int):
                log.warning("malformed grant %r — skipping", grant)
                await asyncio.sleep(poll.next_delay())
                continue
            if not await self._enter_job(client, jid):
                continue  # job closed between grant and spec fetch
            is_map = phase == "map"
            ok = await self._execute_granted(
                client, phase, tid, att,
                "renew_map_lease" if is_map else "renew_reduce_lease",
                "report_map_task_finish" if is_map
                else "report_reduce_task_finish",
                self.run_map_task if is_map else self.run_reduce_task,
                job=jid,
            )
            if not ok:
                return False

    async def _enter_job(self, client: CoordinatorClient, jid: str) -> bool:
        """Switch the task context to ``jid`` (no-op when already there):
        fetch + cache its spec, tear down the previous job's jit cache,
        and swap app/inputs/dirs. False = the job vanished (done or
        cancelled between the grant and this fetch) — skip the grant; its
        lease expires server-side."""
        if jid == self._current_job:
            return True
        spec = self._specs.get(jid)
        if spec is None:
            try:
                spec = await self._call_with_retry(client, "job_spec", jid)
            except ConnectionError:
                return False
            if not isinstance(spec, dict) or not spec.get("ok"):
                log.warning("job %s: spec unavailable (%s) — skipping grant",
                            jid, (spec or {}).get("error"))
                await asyncio.sleep(self.cfg.poll_retry_s)
                return False
            self._specs[jid] = spec
            while len(self._specs) > self.SPEC_CACHE_MAX:
                self._specs.popitem(last=False)
        else:
            self._specs.move_to_end(jid)  # LRU: reuse refreshes recency
        if self._current_job is not None:
            self._job_teardown()
        self._apply_spec(spec)
        self._current_job = jid
        return True

    def _job_teardown(self) -> None:
        """Per-job-end teardown: drop the device-resident per-job cache the
        port keeps, grep's query tensors (``apps/grep._query_tensors``, an
        LRU keyed on (query, device)), now rather than at process exit;
        the next grep chunk rebuilds its own in one small copy. Looked up
        in ``sys.modules``: a worker that never ran grep has nothing
        cached and imports nothing here (not the driver either)."""
        grep = sys.modules.get("mapreduce_rust_tpu_torch.apps.grep")
        if grep is not None:
            grep._query_tensors.cache_clear()

    def _apply_spec(self, spec: dict) -> None:
        import dataclasses

        from mapreduce_rust_tpu_torch.apps import get_app
        from mapreduce_rust_tpu_torch.runtime.chunker import resolve_corpora
        from mapreduce_rust_tpu_torch.runtime.splitter import prepare_app

        kwargs = dict(spec.get("app_args") or {})
        if spec["app"] == "grep":
            kwargs["query"] = tuple(kwargs.get("query") or ())
        if spec["app"] == "top_k" and "k" in kwargs:
            kwargs["k"] = int(kwargs["k"])
        self.app = get_app(spec["app"], **kwargs)
        # Multi-corpus jobs ship their ordered (name, dir) list in the
        # spec; classic jobs keep the single input_dir form.
        corpora = spec.get("inputs")
        self.cfg = dataclasses.replace(
            self._base_cfg,
            map_n=max(int(spec["map_n"]), 1),
            reduce_n=int(spec["reduce_n"]),
            # From the SPEC, never this worker's CLI default: two fleet
            # members sampling different counts would derive different
            # splitters for one sort job and route one key two ways.
            split_samples=int(spec.get("split_samples") or 512),
            input_dir=spec["input_dir"],
            input_dirs=(
                tuple((str(n), str(d)) for n, d in corpora)
                if corpora else None
            ),
            input_pattern=spec["input_pattern"],
            work_dir=spec["work_dir"],
            output_dir=spec["output_dir"],
        )
        self.inputs, bounds, _names = resolve_corpora(self.cfg)
        # Range apps re-derive splitters HERE, from the same seeded
        # sampler as every other fleet member — no splitter exchange RPC,
        # no divergence: the sample is a pure function of the listing.
        self.app = prepare_app(self.app, self.cfg, self.inputs, bounds)
        self.work = pathlib.Path(spec["work_dir"])
        self.out = pathlib.Path(spec["output_dir"])
        self._job_ctx = spec["job"]
        # Stamp this job onto the worker's OWN event-log rows too: the
        # report spans every job this worker serves, and un-stamped rows
        # would interleave two jobs' (phase, tid) histories under one
        # machine in mrcheck's replay (report identity stays the
        # worker's — row_job, not job_id).
        self.report.row_job = spec["job"]
