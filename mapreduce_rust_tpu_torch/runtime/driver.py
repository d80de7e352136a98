"""Chunked streaming driver — the end-to-end engines.

The port of ``mapreduce_rust_tpu/runtime/driver.py``'s engines. ``run_job``
picks one: the multi-process mesh when this process is one of several in a
``torch.distributed`` process group, the mesh when ``Config.mesh_shape`` >
1, else the engine ``Config.map_engine`` names.

**Device engine** (``"device"``, the default: ``_stream_single``). A host
loop streams whitespace-aligned chunks (runtime/chunker.py) through a
per-chunk step and keeps the running distinct-key state on the device:

    chunk bytes ──pinned, non_blocking──▶ tokenize_and_hash (CUDA kernel)
        ─▶ compact_front ─▶ app.device_map ─▶ count_unique ─▶ merge into state
                                                                  │
         evicted tail ◀───────────────────────────────────────────┘
              └─▶ host accumulator (exact, nothing dropped)

PyTorch runs asynchronously on the card: while the device works on chunk
k the host reads, normalizes and chunks k+1, and an ingest pool runs the
native dictionary scan (native/host.scan_unique_raw) whose results fold
into the egress dictionary. The overflow and eviction counters of a whole
``Config.pipeline_depth`` window come back in ONE device→host copy. On a
card the step is captured once into a CUDA graph and each chunk replays
it from a ring of pinned staging buffers (runtime/step_graph.py); on the
CPU it runs op by op.

Capacity faults are handled, not asserted:
- per-chunk distinct keys > partial_capacity → the step clamps its update
  to empty on the device (so merging before the host sees the flag is
  safe) and the chunk is *replayed* through the full-width step (counted,
  exact);
- merged distinct keys > merge_capacity → the evicted tail spills whole to
  the host accumulator (ops/groupby.merge_batches; counted, exact).

**Host-map engine** (``"host"``: ``_stream_host_map``). The map runs on
the host: scan workers run the fused native normalize+tokenize+hash+count
pass over memory-mapped windows, the router folds the scan into the
dictionary (or hands key-hash shards to fold threads) and hands each
window's (key, count) update to the dispatch plane, which coalesces
updates across windows and merges them into the same device state with
``merge_batches``. No scan kernel runs on the card in this engine.

**Mesh engines** (``mesh_shape`` = D > 1; parallel/shuffle.py). D chunks
make a group, one per shard; each group is one round of per-shard scan
kernel launches, the combine, a bucket scatter by the unsigned ``k1 % D``,
the all_to_all and per-shard merges (``_stream_mesh``, with its
checkpoint and resume). ``sharded_stream`` lays each host window across
the shards as one byte stream cut anywhere and repairs the seams with a
halo exchange (``_stream_sharded``, parallel/halo.py). Overflowing groups
replay through wider tiers; the state is sharded by hash class, so its
shards fold into the host accumulator independently (top_k fetches only
per-shard candidates when that is exact, parallel/topk.py).

**Multi-process mesh** (a process group of N > 1 ranks,
parallel/distributed.py: ``_stream_multihost``). Rank r owns shards
``[r * D/N, (r+1) * D/N)`` of the global mesh and reads every N-th input;
the rounds run in lockstep over ``torch.distributed`` collectives, each
rank folds and writes only its own hash classes (``mr-{r}.p{rank}.txt``),
and the ranks exchange dictionary shards through the work dir.

At egress the final table joins the hash→word dictionary and the app
formats its partitions, written as ``mr-{r}.txt``.

Observability is the reference's: the same ``trace_span`` names at the
same places (``Config.trace_path``), the live metrics registry ticked from
the consumer loops, the flight recorder, and a run manifest
(``Config.manifest_path``) written even when the job fails.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence
from zipfile import BadZipFile

import numpy as np
import torch

from mapreduce_rust_tpu_torch.apps.base import App
from mapreduce_rust_tpu_torch.apps.word_count import WordCount
from mapreduce_rust_tpu_torch.config import (
    Config,
    profile_forced,
    sync_dispatch_forced,
)
from mapreduce_rust_tpu_torch.core.hashing import hash_words
from mapreduce_rust_tpu_torch.core.kv import SENTINEL_I32, KVBatch
from mapreduce_rust_tpu_torch.core.normalize import normalize_python, normalize_unicode
from mapreduce_rust_tpu_torch.native.host import (
    arena_bytes,
    coalesce_updates_into,
    scan_count_raw,
    scan_count_sharded_raw,
    scan_unique_raw,
)
from mapreduce_rust_tpu_torch.ops.cuda_build import BUILD_LOG
from mapreduce_rust_tpu_torch.ops.groupby import (
    clamp_batch,
    compact_front,
    compaction_cap,
    count_unique,
    merge_batches,
)
from mapreduce_rust_tpu_torch.ops.tokenize import tokenize_and_hash
from mapreduce_rust_tpu_torch.runtime.chunker import (
    _ws_cut,
    chunk_stream,
    resolve_corpora,
    utf8_safe_cut,
)
from mapreduce_rust_tpu_torch.runtime import spill as spill_io
from mapreduce_rust_tpu_torch.runtime import step_graph
from mapreduce_rust_tpu_torch.runtime.dictionary import (
    Dictionary,
    ShardedDictionary,
    extract_words,
    new_run_token,
    remove_run_files,
)
from mapreduce_rust_tpu_torch.runtime.histogram import Histogram
from mapreduce_rust_tpu_torch.runtime.lineage import (
    active_ledger,
    chunk_digest,
    lineage_forced,
)
from mapreduce_rust_tpu_torch.runtime.metrics import (
    JobStats,
    jobstats_collector,
    log,
    metrics_tick,
    start_metrics,
    stop_metrics,
)
from mapreduce_rust_tpu_torch.runtime.splitter import prepare_app
from mapreduce_rust_tpu_torch.runtime.trace import (
    maybe_snapshot,
    partial_path,
    start_tracing,
    stop_tracing,
    trace_counter,
    trace_span,
)


#: Synthetic trace track of the kernel-build spans (ops/cuda_build
#: BUILD_LOG): their intervals were timed around nvcc, g++ or a library
#: load, maybe on another thread, so on a track of their own they never
#: partially overlap a thread's call-structured spans.
_BUILD_TRACK_TID = -2


def select_device(kind: str = "cuda") -> torch.device:
    """cfg.device → a torch.device. "auto" and "cuda" need a card and raise
    without one: the CPU runs only when the caller asks for "cpu"."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind not in ("auto", "cuda"):
        raise ValueError(f"unknown device {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (--device cpu) to "
            "run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


_MEM_SAMPLE_PERIOD_S = 0.5
_mem_last_sample = [0.0]
_mem_lock = threading.Lock()


def _sample_device_memory(stats) -> None:
    """Device-memory gauge, fed from the existing drain loops (never per
    record): the high water of ``torch.cuda.max_memory_allocated`` into
    ``stats.device_mem_high_bytes``, plus a throttled Chrome "C" counter
    sample per device when tracing. Only where CUDA is ALREADY
    initialized: a telemetry gauge must never be what creates a device
    context (the coordinator, a host-engine worker). The throttle is
    process state shared by every job of the process, so it holds a lock
    and gates only the counter track; each caller's own high water is
    always read."""
    try:
        if not torch.cuda.is_initialized():
            return
        n = torch.cuda.device_count()
        high = max(int(torch.cuda.max_memory_allocated(i)) for i in range(n))
        if high > stats.device_mem_high_bytes:
            stats.device_mem_high_bytes = high
        now = time.monotonic()
        with _mem_lock:
            if now - _mem_last_sample[0] < _MEM_SAMPLE_PERIOD_S:
                return
            _mem_last_sample[0] = now
        for i in range(n):
            trace_counter(f"device.mem.d{i}",
                          bytes_in_use=int(torch.cuda.memory_allocated(i)))
    except Exception:  # a telemetry probe must never fail the run
        pass


def make_step_fns(app: App, u_cap: int):
    """(map_combine, merge) for one app + update capacity.

    map_combine: chunk bytes → per-chunk partial of at most u_cap distinct
    keys + overflow count. merge: fold the partial into the running state,
    returning the evicted tail and its record count. Neither copies to the
    host or waits for the device.
    """
    op = app.combine_op

    def map_combine(chunk: torch.Tensor, doc_id: int):
        kv = tokenize_and_hash(chunk)
        # Compact before sorting: count_unique pays for tokens, not bytes.
        # The overflow below covers BOTH distinct keys > u_cap AND raw
        # tokens > the compaction cap — either replays the chunk.
        kv, c_ovf = compact_front(kv, compaction_cap(u_cap, chunk.shape[0]))
        kv = app.device_map(kv, doc_id)
        partial = count_unique(kv, op=op)
        update = partial.take_front(u_cap)
        ovf = partial.valid[u_cap:].sum(dtype=torch.int32) + c_ovf
        # An overflowing chunk contributes NOTHING (update clamps to empty,
        # keys included): the driver replays it full-width later. This is
        # what makes merging safe before the flag ever reaches the host.
        update = clamp_batch(update, ovf == 0)
        return update, ovf

    def merge(state: KVBatch, update: KVBatch):
        # update is a count_unique output — already key-sorted.
        new_state, evicted = merge_batches(state, update, op=op, update_sorted=True)
        ev_count = evicted.valid.sum(dtype=torch.int32)
        return new_state, evicted, ev_count

    return map_combine, merge


def _pack_key_cols(keys: np.ndarray) -> np.ndarray:
    """[n, 2] (k1, k2) int64 columns holding uint32 values → one uint64
    packed column, whose order is the (k1, k2) lexicographic order."""
    return (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1].astype(
        np.uint64
    )


def _unpack_rows(packed: np.ndarray, vals: np.ndarray) -> np.ndarray:
    return np.column_stack([
        (packed >> np.uint64(32)).astype(np.int64),
        (packed & np.uint64(0xFFFFFFFF)).astype(np.int64),
        vals.astype(np.int64),
    ])


def _combine_rows(op: str, keys: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """(keys [n,2], vals [n]) → sorted rows [m, 3] (k1, k2, value): one per
    distinct (key, value) pair for "distinct", else one per distinct key
    with values folded by ``op`` (reference ``driver.py:348-373``)."""
    packed = _pack_key_cols(keys)
    if op == "distinct":
        # Sort by (key, value), then mask repeats.
        order = np.lexsort((vals, packed))
        p_s, v_s = packed[order], vals[order]
        if len(p_s):
            keep = np.empty(len(p_s), dtype=bool)
            keep[0] = True
            keep[1:] = (p_s[1:] != p_s[:-1]) | (v_s[1:] != v_s[:-1])
            p_s, v_s = p_s[keep], v_s[keep]
        return _unpack_rows(p_s, v_s)
    uniq, inv = np.unique(packed, return_inverse=True)
    inv = inv.reshape(-1)
    if op == "sum":
        folded = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(folded, inv, vals)
    elif op == "max":
        folded = np.full(len(uniq), np.iinfo(np.int64).min)
        np.maximum.at(folded, inv, vals)
    else:
        folded = np.full(len(uniq), np.iinfo(np.int64).max)
        np.minimum.at(folded, inv, vals)
    return _unpack_rows(uniq, folded)


def _combine_pending(op: str, keys_list, vals_list) -> np.ndarray:
    """Combine pending (keys, vals) batches into sorted deduped rows
    [n, 3] (k1, k2, value) — value-keyed for "distinct", else folded.
    Module-level and pure, so the spill writer runs it against a frozen
    snapshot off the owner thread."""
    return _combine_rows(op, np.concatenate(keys_list), np.concatenate(vals_list))


class HostAccumulator:
    """Exact host-side fold of device spills + the final state, per op.

    Adds are O(1) array appends; the fold is deferred and vectorized
    (np.unique over the concatenated batches + ufunc.at). Keys arrive as
    uint32 views (KVBatch.to_host), so the int64 cast keeps them unsigned
    and ``k1 % reduce_n`` routes them as the reference does. Under
    "distinct" the rows are one per (key, value) pair and ``table`` maps
    each key to the SET of its values: spills and the final state are
    unioned, so a key that an eviction cut in two comes back whole.

    Bounded-memory tier: with ``budget_bytes`` set, pending arrays above
    the budget are combined into a SORTED, deduped run on disk
    (``spill_dir/accrun-*.npy``) by a background
    :class:`~mapreduce_rust_tpu_torch.runtime.spill.AsyncSpillWriter` and
    dropped from RAM; ``fold_arrays()`` drains the writer and merges the
    runs back exactly.
    """

    def __init__(self, op: str, budget_bytes: int | None = None,
                 spill_dir: str | None = None,
                 async_spill: bool = True) -> None:
        if budget_bytes is not None and not spill_dir:
            raise ValueError("budget_bytes needs a spill_dir")
        self.op = op
        self.budget_bytes = budget_bytes
        self.spill_dir = spill_dir
        self.async_spill = async_spill
        self._keys: list[np.ndarray] = []   # each [N, 2] int64
        self._vals: list[np.ndarray] = []   # each [N] int64
        self._pending_bytes = 0
        self._runs: list[str] = []          # sorted, deduped [n,3] .npy files
        self._table: dict | None = None
        self._run_token = new_run_token()
        self._writer: "spill_io.AsyncSpillWriter | None" = None

    def add(self, keys: np.ndarray, vals: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.int64).reshape(-1, 2)
        if len(keys):
            vals = np.asarray(vals, dtype=np.int64).reshape(-1)
            self._keys.append(keys)
            self._vals.append(vals)
            self._pending_bytes += keys.nbytes + vals.nbytes
            self._table = None
            if self.budget_bytes is not None and self._pending_bytes > self.budget_bytes:
                self._flush_run()

    def add_batch(self, batch: KVBatch) -> None:
        self.add(*batch.to_host())

    @property
    def has_runs(self) -> bool:
        return bool(self._runs)

    @property
    def run_count(self) -> int:
        return len(self._runs)

    def _flush_run(self) -> None:
        """Freeze the pending batches and hand the combine + write to the
        background writer; this thread only swaps in fresh lists and
        enqueues."""
        keys, vals = self._keys, self._vals
        self._keys, self._vals = [], []
        self._pending_bytes = 0
        os.makedirs(self.spill_dir, exist_ok=True)
        run_index = len(self._runs)
        path = os.path.join(
            self.spill_dir,
            spill_io.run_file_name("accrun", self._run_token, run_index, "npy"),
        )
        self._runs.append(path)
        op = self.op

        def task() -> int:
            with trace_span("accumulator.flush_run", run=run_index):
                rows = _combine_pending(op, keys, vals)
                written = spill_io.write_npy_run(path, rows, run_index=run_index)
            log.info("host accumulator: spilled run %d (%d rows)", run_index + 1, len(rows))
            return written

        self._writer = spill_io.ensure_writer(
            self._writer, f"mr/spill-acc-{self._run_token}", sync=not self.async_spill)
        self._writer.submit(task)

    def drain_spills(self) -> None:
        """Barrier before any read of the run files (fold_arrays) or the
        final accounting; re-raises a recorded writer error."""
        if self._writer is not None:
            self._writer.drain()

    def close_spills(self, abort: bool = True) -> None:
        if self._writer is not None:
            self._writer.close(abort=abort)

    def spill_stats(self) -> dict:
        return spill_io.tier_spill_stats(self._writer, len(self._runs))

    def spill_snapshot(self) -> "tuple[float, float, int] | None":
        """(write_s, stall_s, bytes) right now, or None if never spilled —
        benign-stale reads for the live metrics ring."""
        return spill_io.tier_spill_snapshot(self._writer)

    def remove_runs(self) -> None:
        """Job-end cleanup of this accumulator's run files. Closes the
        writer first so no run lands after its unlink."""
        self.close_spills(abort=True)
        remove_run_files(self._runs)

    def _combine_sorted(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Merge two sorted deduped [n,3] row arrays into one (the same
        packed-column kernel as the pending fold, so the run merge and the
        pending combine cannot order differently). "distinct" rows stay
        keyed on (key, value)."""
        rows = np.concatenate([a, b])
        return _combine_rows(self.op, rows[:, :2], rows[:, 2])

    def fold_arrays(self) -> np.ndarray:
        """The exact fold as sorted rows [n, 3] (k1, k2, value) — one row
        per distinct key (scalar ops) or per distinct (key, value) pair
        ("distinct"). Runs merge through a binary-counter tree (equal-size
        partials first), so a K-run fold costs O(total log K) combine
        work; peak memory stays O(result)."""
        self.drain_spills()  # every enqueued run must be on disk first
        stack: list[tuple[int, np.ndarray]] = []  # (level, rows)

        def push(rows: np.ndarray) -> None:
            level = 0
            while stack and stack[-1][0] == level:
                _, prev = stack.pop()
                rows = self._combine_sorted(prev, rows)
                level += 1
            stack.append((level, rows))

        for path in self._runs:
            push(np.load(path))
        if self._keys:
            push(_combine_pending(self.op, self._keys, self._vals))
        rows = np.empty((0, 3), np.int64)
        for _, r in stack:
            rows = self._combine_sorted(rows, r)
        return rows

    def snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys [n, 2], vals [n]) of everything accumulated so far, folded —
        the mesh checkpoint's accumulator. Every op is associative, so
        adding them back resumes exactly."""
        if not self._keys and not self._runs:
            return np.empty((0, 2), np.int64), np.empty(0, np.int64)
        rows = self.fold_arrays()
        return rows[:, :2], rows[:, 2]

    @property
    def table(self) -> dict:
        if self._table is None:
            rows = self.fold_arrays()
            if self.op == "distinct":
                t: dict = collections.defaultdict(set)
                for a, b, v in rows.tolist():
                    t[(a, b)].add(v)
                self._table = t
            else:
                self._table = dict(zip(
                    zip(rows[:, 0].tolist(), rows[:, 1].tolist()), rows[:, 2].tolist()
                ))
        return self._table


@dataclasses.dataclass
class JobResult:
    stats: JobStats
    table: dict            # word bytes → final value (int or sorted doc list)
    output_files: list[str]


def _scan_payload(payload: bytes):
    """Tagged scan result ("raw", raw, ends, keys) of one chunk's normalized
    payload — runs on the ingest pool. The native C pass releases the GIL,
    so scans of consecutive chunks overlap each other, the chunker thread
    and the device steps."""
    return ("raw", *scan_unique_raw(payload))


def _scan_payload_python(payload: bytes) -> tuple[list[bytes], np.ndarray]:
    """Plain version of :func:`_scan_payload`: (distinct words in first
    occurrence order, their hash pairs uint32 [n, 2]). Tests hold the
    native scan to it; no production path calls it."""
    seen: set = set()
    words = [w for w in extract_words(payload) if not (w in seen or seen.add(w))]
    return words, hash_words(words)


def _slice_words(raw: bytes, ends: np.ndarray, idx) -> list[bytes]:
    """Materialize words idx (ascending indices) of a concatenated
    (raw, ends) scan result."""
    ends_l = ends.tolist()
    return [raw[(ends_l[i - 1] if i else 0): ends_l[i]] for i in idx]


def scan_keys(kind, parts) -> np.ndarray:
    """The hash-pair array of a tagged scan result."""
    if kind != "raw":
        raise ValueError(f"unknown scan result kind {kind!r}")
    return parts[2]


def _routed_parts(keys, mask, reduce_n: int, range_mode: bool = False):
    """Reduce partitions one chunk's (masked) keys route to — the
    provenance ledger's chunk→partition edge. Hash apps route
    k1 % reduce_n, so one vectorized unique over the scan's key column
    answers it exactly; range apps route through sampler-derived
    splitters on the WORD, which the scan result no longer carries — a
    range chunk claims every partition (conservative: the blast radius
    can only over-approximate, never miss a dependent partition)."""
    if range_mode:
        return list(range(reduce_n))
    k1 = keys[:, 0] if getattr(keys, "ndim", 1) > 1 else keys
    if mask is not None:
        k1 = k1[mask]
    n = len(k1)
    if n == 0:
        return []
    # Exact answer, sampled fast path: a strided sample that already
    # shows every partition proves the full set (an observed residue is
    # definitely present; more than reduce_n is impossible) without
    # touching the other keys. Only a skewed chunk that genuinely misses
    # partitions pays the full bincount pass.
    if n > 4096:
        sample = np.asarray(k1[:: n // 2048], dtype=np.int64) % reduce_n
        if len(np.unique(sample)) == reduce_n:
            return list(range(reduce_n))
    hits = np.bincount(
        (np.asarray(k1, dtype=np.int64) % reduce_n).astype(np.intp),
        minlength=reduce_n,
    )
    return [int(r) for r in np.flatnonzero(hits)]


def fold_scan_into_dictionary(dictionary: Dictionary, mask, kind, parts) -> None:
    """Fold one tagged scan result ("raw", raw, ends, keys[, ...]) into the
    egress dictionary, restricted to the keys a filtering app keeps. mask
    is the precomputed ``App.host_mask(scan_keys(...))``, or None for
    keep-everything, which folds through the vectorized fast path."""
    raw, ends, keys = parts[0], parts[1], scan_keys(kind, parts)
    if mask is None:
        dictionary.add_scanned_raw(raw, ends, keys)
        return
    idx = np.nonzero(mask)[0].tolist()
    if idx:
        dictionary.add_scanned(_slice_words(raw, ends, idx), keys[idx])


_END = object()


class _IngestStream:
    """Shared ingest: a prefetch thread runs read→normalize→chunk ahead of
    the consumer (bounded queue), and a thread pool runs the dictionary
    scans; scan results fold into the Dictionary only on the consumer
    thread. doc_id = doc_id_offset + position in inputs (the flat listing
    of every corpus; a worker's map task passes its task id), or
    ``doc_ids[position]`` when given (a rank of the multi-process mesh
    reads every N-th input and keeps the global ids). The first
    ``skip_chunks`` chunks are read and dropped unscanned: a resumed mesh
    job's checkpoint already holds them.

    With a provenance ledger active, each chunk's content digest is taken
    on the pool thread that scans it (the payload is hot there) and
    recorded in chunk order on the consumer, with the partitions its
    keys route to."""

    def __init__(self, cfg: Config, inputs: Sequence[str], stats: JobStats,
                 dictionary: Dictionary, host_mask, doc_id_offset: int = 0,
                 lineage_range: bool = False, skip_chunks: int = 0,
                 doc_ids: "Sequence[int] | None" = None) -> None:
        self.cfg = cfg
        self.skip_chunks = skip_chunks
        self.stats = stats
        self._ledger = active_ledger()  # None when the ledger is off
        self._lineage_range = lineage_range
        self.dictionary = dictionary
        # Filtering apps (App.host_mask) restrict dictionary growth to
        # their query keys; the default keep-all mask folds via fast paths.
        self.host_mask = host_mask
        self.workers = max(cfg.ingest_threads, 1)
        self.pool = ThreadPoolExecutor(max_workers=self.workers,
                                       thread_name_prefix="mr/ingest-io")
        self.scans: collections.deque = collections.deque()
        self.q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch_chunks, 1))
        self.err: BaseException | None = None
        self._stop = False
        self._doc_ids = list(doc_ids) if doc_ids is not None else None
        self._thread = threading.Thread(
            target=self._produce, args=(list(inputs), doc_id_offset),
            name="mr/ingest", daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        while True:
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                if self._stop:
                    return False

    def _produce(self, inputs, doc_id_offset) -> None:
        # This thread owns bytes_in/chunks/forced_cuts; the consumer owns
        # every other stats field. Under the sanitizer it must say so.
        stats = self.stats
        stats.register_writer()
        try:
            for i, path in enumerate(inputs):
                doc = self._doc_ids[i] if self._doc_ids else doc_id_offset + i
                stats.bytes_in += os.path.getsize(path)
                with open(path, "rb") as f:
                    for chunk in chunk_stream(f, doc, self.cfg.chunk_bytes):
                        stats.chunks += 1
                        stats.forced_cuts += int(chunk.forced_cut)
                        if not self._put(chunk):
                            return
        except BaseException as e:  # re-raised on the consumer thread
            self.err = e
        finally:
            self._put(_END)

    @staticmethod
    def _scan_lineage(payload: bytes):
        """_scan_payload plus the chunk's content digest and size, both on
        the pool thread; _fold_done strips the (dg, nbytes) prefix."""
        return (chunk_digest(payload), len(payload), *_scan_payload(payload))

    def _fold_done(self, block: bool = False) -> None:
        while self.scans and (block or self.scans[0][0].done()):
            # Dictionary state is only ever touched here, on the consumer.
            fut, doc_id = self.scans.popleft()
            res = fut.result()
            if self._ledger is not None:
                dg, nb, kind, *rest = res
            else:
                kind, *rest = res
            t0 = time.perf_counter()
            keys = scan_keys(kind, rest)
            mask = self.host_mask(keys)
            fold_scan_into_dictionary(self.dictionary, mask, kind, rest)
            self.stats.fold_s += time.perf_counter() - t0
            if self._ledger is not None:
                self._ledger.record_chunk(
                    doc_id, nb, dg,
                    parts=_routed_parts(keys, mask, self.cfg.reduce_n,
                                        self._lineage_range),
                )
            block = False  # a blocking drain pops exactly one

    def __iter__(self):
        scan = self._scan_lineage if self._ledger is not None else _scan_payload
        while True:
            t0 = time.perf_counter()
            with trace_span("ingest.wait"):
                chunk = self.q.get()
            dt = time.perf_counter() - t0
            self.stats.ingest_wait_s += dt
            self.stats.record_hist("ingest.wait_s", dt)
            if chunk is _END:
                if self.err is not None:
                    raise self.err
                return
            if self.skip_chunks > 0:
                self.skip_chunks -= 1
                continue
            self.scans.append(
                (self.pool.submit(scan, bytes(chunk.data[: chunk.nbytes])),
                 chunk.doc_id)
            )
            # Backpressure: each pending future pins a chunk-sized payload;
            # fold the oldest (blocking) once the backlog exceeds the pool.
            self._fold_done(block=len(self.scans) > 2 * self.workers + 4)
            maybe_snapshot()  # flight-recorder tick: per chunk, off-hot-path
            metrics_tick()    # live-metrics sampler, same piggyback contract
            yield chunk

    def close(self, abort: bool = False) -> None:
        """Fold remaining scans and release threads. abort=True (exception
        path) skips folding and just unblocks + reaps the producer."""
        self._stop = True
        if abort:
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            for f, _doc in self.scans:
                f.cancel()
            self.scans.clear()
        else:
            while self.scans:
                self._fold_done(block=True)
        self.pool.shutdown(wait=True, cancel_futures=True)
        self._thread.join(timeout=5)


def _stream_single(cfg: Config, app: App, inputs, stats: JobStats,
                   acc: HostAccumulator, dictionary: Dictionary,
                   doc_id_offset: int = 0,
                   device: "torch.device | None" = None) -> None:
    """The device engine over ``inputs``; doc ids start at
    ``doc_id_offset`` (a worker's map task streams one file, its task id).
    The device comes from ``cfg.device`` unless the caller resolved it.
    On a card the step of each chunk replays a captured CUDA graph that
    this job checks out for its whole stream; on the CPU it runs op by op
    (runtime/step_graph.py)."""
    if device is None:
        device = select_device(cfg.device)
    u_cap = cfg.effective_partial_capacity()
    depth = max(cfg.pipeline_depth, 1)
    if device.type == "cuda":
        key = (device, step_graph.app_key(app), u_cap, cfg.chunk_bytes,
               cfg.merge_capacity, depth)
        launcher = step_graph.checkout(key, lambda: step_graph.GraphStep(
            *make_step_fns(app, u_cap), chunk_bytes=cfg.chunk_bytes,
            merge_capacity=cfg.merge_capacity, slots=2 * depth + 1, device=device))
    else:
        launcher = contextlib.nullcontext((step_graph.EagerStep(
            *make_step_fns(app, u_cap), cfg.merge_capacity, device), False))
    with launcher as (step, captured):
        stats.step_graph_captures += int(captured)
        _stream_steps(cfg, app, inputs, stats, acc, dictionary, doc_id_offset,
                      step, depth)
        stats.step_graph_replays += step.replays
    trace_counter("step_graph", replays=stats.step_graph_replays,
                  captures=stats.step_graph_captures)


def _stream_steps(cfg: Config, app: App, inputs, stats: JobStats,
                  acc: HostAccumulator, dictionary: Dictionary,
                  doc_id_offset: int, step, depth: int) -> None:
    """``_stream_single``'s loop: dispatch each chunk's step through
    ``step`` and resolve them a window at a time."""
    slow_fns = None  # full-width replay step, built only if ever needed
    # (handle, doc_id) per dispatched chunk; the handle keeps what the
    # drain reads (counters, evicted tail, the chunk's host bytes) alive.
    pending: collections.deque = collections.deque()

    def spill(evicted: KVBatch, ev_n: int) -> None:
        stats.spill_events += 1
        stats.spilled_keys += ev_n
        acc.add_batch(evicted)

    def replay_chunk(chunk_host: torch.Tensor, doc_id: int) -> None:
        # More distinct keys in the chunk than partial_capacity: the fast
        # step clamped its update to empty, so re-run the whole chunk at
        # full width, op by op. Exact, never silent.
        nonlocal slow_fns
        stats.partial_overflow_replays += 1
        if slow_fns is None:
            slow_fns = make_step_fns(app, cfg.chunk_bytes)
        with trace_span("chunk.replay"):
            update, _ = slow_fns[0](chunk_host.to(step.device, non_blocking=True),
                                    doc_id)
            step.state, evicted, ev_count = slow_fns[1](step.state, update)
            ev_n = int(ev_count)
            if ev_n > 0:
                spill(evicted, ev_n)

    def drain(n: int) -> None:
        # Resolve the oldest n steps with ONE device→host copy of all their
        # counters; this is where the host waits for the device.
        if n <= 0:
            return
        batch = [pending.popleft() for _ in range(n)]
        t0 = time.perf_counter()
        with trace_span("device.drain", steps=n):
            counts = step.counts([h for h, _doc in batch])
        dt = time.perf_counter() - t0
        stats.device_wait_s += dt
        stats.record_hist("device.drain_s", dt)
        _sample_device_memory(stats)
        for (h, doc_id), (ovf_n, ev_n) in zip(batch, counts):
            if ev_n > 0:
                with trace_span("spill", keys=int(ev_n)):
                    spill(step.evicted(h), ev_n)
            if ovf_n > 0:
                replay_chunk(step.chunk_host(h), doc_id)
            step.release(h)

    ingest = _IngestStream(cfg, inputs, stats, dictionary, app.host_mask,
                           doc_id_offset,
                           lineage_range=app.partition_mode == "range")
    try:
        for chunk in ingest:
            with trace_span("chunk.dispatch"):
                pending.append((step.dispatch(chunk.data, chunk.doc_id), chunk.doc_id))
            # Keep one window in flight while draining the previous one.
            if len(pending) >= 2 * depth:
                drain(depth)
        drain(len(pending))
    except BaseException:
        ingest.close(abort=True)
        raise
    ingest.close()
    acc.add_batch(step.state)


# ---------------------------------------------------------------------------
# The host-map engine (map_engine="host")
# ---------------------------------------------------------------------------


def make_packed_merge_fn(app: App, cap: int):
    """Merge one host-mapped update, shipped as ONE flat int32 tensor (one
    host→device copy, not four):

        flat[0]                n — number of real records
        flat[1 : 1+cap]        k1 (SENTINEL-padded so padding sorts last)
        flat[1+cap : 1+2cap]   k2
        flat[1+2cap : 1+3cap]  value

    each lane the int32 bit pattern of the reference's uint32 layout.
    Returns (new_state, evicted, evicted_count), all on the device; nothing
    here waits for the card."""
    op = app.combine_op

    def merge_packed(state: KVBatch, flat: torch.Tensor):
        update = KVBatch(
            k1=flat[1: 1 + cap],
            k2=flat[1 + cap: 1 + 2 * cap],
            value=flat[1 + 2 * cap: 1 + 3 * cap],
            valid=torch.arange(cap, dtype=torch.int32, device=flat.device) < flat[0],
        )
        new_state, evicted = merge_batches(state, update, op=op)
        return new_state, evicted, evicted.valid.sum(dtype=torch.int32)

    return merge_packed


#: aten ops (overload packets, in-place "_" dropped) that count one
#: operation per element they produce.
_ELEMENTWISE_OPS = frozenset({
    "add", "sub", "mul", "div", "neg", "abs", "where", "clamp", "clamp_min",
    "clamp_max", "maximum", "minimum", "eq", "ne", "lt", "le", "gt", "ge",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
    "logical_or", "logical_not", "bitwise_left_shift", "bitwise_right_shift",
    "__and__", "__or__", "__xor__", "__lshift__", "__rshift__", "cumsum",
})
#: aten ops that combine their input elements: one operation per element
#: of the first tensor argument (reductions) or of the source (scatters).
_REDUCTION_OPS = frozenset({"sum", "any", "all", "amax", "amin", "max", "min"})
_SCATTER_REDUCE_OPS = {"index_add": 3, "scatter_add": 3, "scatter_reduce": 3}
_merge_costs: dict = {}


def _count_merge_ops(app: App, cap: int, n: int, device: str) -> dict:
    """{"flops", "bytes_accessed"} of one packed-merge dispatch: every
    aten op that ``make_packed_merge_fn(app, cap)`` runs on a state of
    ``n`` records and a flat update of ``1 + 3·cap`` words, seen through a
    ``TorchDispatchMode`` on ``device``.

    - ``bytes_accessed``: each op's input tensors' bytes plus its output
      tensors' bytes; views (slices, aliases) move nothing and count 0;
    - ``flops``: one per output element of each elementwise arithmetic or
      compare op (``_ELEMENTWISE_OPS``); one per input element of each
      reduction and per source element of each accumulating scatter
      (``index_add_``); ``n·⌈log2 n⌉`` for each sort of n rows and
      ``m·⌈log2(n + 1)⌉`` for each binary search of m queries over n rows.
      Moves (gathers, plain scatters, fills, copies) count 0.

    Both depend only on the shapes and the merge's ops, never on the data,
    the device or the clock."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    def log2_ceil(x: int) -> int:
        return max(int(x) - 1, 0).bit_length()

    class Counter(TorchDispatchMode):
        flops = 0
        bytes_accessed = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.is_view:
                return out
            self.bytes_accessed += nbytes((args, kwargs)) + nbytes(out)
            name = func.overloadpacket.__name__
            if name.endswith("_") and not name.endswith("__"):
                name = name[:-1]  # in place: index_add_ → index_add
            first = args[0] if args and isinstance(args[0], torch.Tensor) else None
            if name in _ELEMENTWISE_OPS:
                self.flops += sum(t.numel() for t in tree_leaves(out)
                                  if isinstance(t, torch.Tensor))
            elif name in _REDUCTION_OPS and first is not None:
                self.flops += first.numel()
            elif name in _SCATTER_REDUCE_OPS:
                self.flops += args[_SCATTER_REDUCE_OPS[name]].numel()
            elif name == "sort" and first is not None:
                rows = first.shape[-1] if first.dim() else 1
                self.flops += first.numel() * log2_ceil(rows)
            elif name == "searchsorted" and first is not None:
                self.flops += args[1].numel() * log2_ceil(first.shape[-1] + 1)
            return out

    state = KVBatch(*(torch.zeros(n, dtype=dt, device=device)
                      for dt in (torch.int32, torch.int32, torch.int32, torch.bool)))
    flat = torch.zeros(1 + 3 * cap, dtype=torch.int32, device=device)
    merge = make_packed_merge_fn(app, cap)
    with Counter() as c:
        merge(state, flat)
    return {"flops": float(c.flops), "bytes_accessed": float(c.bytes_accessed)}


def _merge_cost_analysis(app: App, cfg: Config) -> dict:
    """Flops and bytes accessed PER DISPATCH of the packed merge at the
    shapes the run used (state of ``merge_capacity``, flat of
    ``1 + 3·host_update_cap``): the roofline's device-merge intensity.
    Counted by :func:`_count_merge_ops` on the meta device (no memory, no
    card), or on the CPU where an op has no meta kernel; never on the card.
    Cached per (combine op, cap, merge_capacity)."""
    key = (app.combine_op, cfg.host_update_cap, cfg.merge_capacity)
    if key not in _merge_costs:
        try:
            cost = _count_merge_ops(app, *key[1:], device="meta")
        except NotImplementedError:
            cost = _count_merge_ops(app, *key[1:], device="cpu")
        _merge_costs[key] = cost
    return dict(_merge_costs[key])


def _pack_update(keys: np.ndarray, values: np.ndarray, cap: int) -> np.ndarray:
    """Lay one window's (keys uint32[n,2], values) into the flat layout
    make_packed_merge_fn expects, in a fresh buffer — the plain packer the
    tests hold :class:`_PackStager` to, byte for byte."""
    n = len(keys)
    flat = np.full(1 + 3 * cap, 0xFFFFFFFF, dtype=np.uint32)  # SENTINEL pad
    flat[0] = n
    flat[1: 1 + n] = keys[:, 0]
    flat[1 + cap: 1 + cap + n] = keys[:, 1]
    flat[1 + 2 * cap: 1 + 2 * cap + n] = np.asarray(values, dtype=np.uint32)
    return flat


class _PackStager:
    """Zero-memset packed-update staging: ONE persistent ``1 + 3·cap``
    buffer reused across dispatches, re-sentineling only the stale tail
    the previous pack left beyond the new fill — byte-identical to
    :func:`_pack_update` by construction.

    On a card the buffer is pinned host memory, written through a numpy
    view and copied with ``non_blocking=True``. That copy reads the buffer
    after the call returns, so a CUDA event recorded right after it is
    the reuse barrier: the next ``pack`` waits on it before touching the
    buffer. On the CPU a device "copy" would alias the buffer, so
    ``to_device`` clones it instead and no barrier is needed."""

    SENTINEL = np.uint32(0xFFFFFFFF)

    def __init__(self, cap: int, device: torch.device) -> None:
        self.cap = cap
        self.device = device
        self.needs_barrier = device.type != "cpu"
        self.host = torch.full((1 + 3 * cap,), SENTINEL_I32, dtype=torch.int32,
                               pin_memory=self.needs_barrier)
        self.flat = self.host.numpy().view(np.uint32)
        self.dirty = 0  # records of the previous pack still in the buffer
        self._copied = torch.cuda.Event() if self.needs_barrier else None
        self._pending = False  # a copy was recorded and not yet waited on

    def pack(self, k1: np.ndarray, k2: np.ndarray, vals: np.ndarray) -> np.ndarray:
        if self._pending:
            self._copied.synchronize()  # the last copy has read the buffer
            self._pending = False
        n = len(k1)
        cap, flat, dirty = self.cap, self.flat, self.dirty
        if dirty > n:  # re-sentinel ONLY the stale tail of each section
            flat[1 + n: 1 + dirty] = self.SENTINEL
            flat[1 + cap + n: 1 + cap + dirty] = self.SENTINEL
            flat[1 + 2 * cap + n: 1 + 2 * cap + dirty] = self.SENTINEL
        flat[0] = n
        flat[1: 1 + n] = k1
        flat[1 + cap: 1 + cap + n] = k2
        flat[1 + 2 * cap: 1 + 2 * cap + n] = vals
        self.dirty = n
        return flat

    def to_device(self) -> torch.Tensor:
        """The packed buffer on the job's device (see the class note on
        reuse)."""
        if not self.needs_barrier:
            return self.host.clone()
        flat_dev = self.host.to(self.device, non_blocking=True)
        self._copied.record()
        self._pending = True
        return flat_dev


def _coalesce_updates_py(a_keys, a_vals, m, b_keys, b_vals):
    """Plain version of ``coalesce_updates_into``: merge two sorted
    unique-key columns, summing counts on duplicate keys, by one
    concatenate + argsort. Tests hold the native merge to it."""
    keys = np.concatenate([a_keys[:m], b_keys])
    vals = np.concatenate([a_vals[:m], b_vals])
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order]
    if not len(ks):
        return ks, vs
    first = np.empty(len(ks), dtype=bool)
    first[0] = True
    first[1:] = ks[1:] != ks[:-1]
    idx = np.nonzero(first)[0]
    return ks[idx], np.add.reduceat(vs, idx)


# ---------------------------------------------------------------------------
# slow_dispatch chaos checkpoint — the spill plane's slow_disk pattern:
# seeded per-merge-dispatch delay, MR_CHAOS only (the env form rides a
# whole process tree), cached per spec string.
# ---------------------------------------------------------------------------

_dispatch_chaos_cache: dict = {}


def _chaos_slow_dispatch(dispatch_index: int) -> None:
    """The ``slow_dispatch`` injection checkpoint: ONE site in the dispatch
    plane (fires per merge dispatch, so ``p=`` samples by dispatch index
    and reruns delay the same dispatches). The async plane hides the delay
    on the dispatch thread; the sync plane eats it on the router's wall."""
    spec = os.environ.get("MR_CHAOS")
    if not spec:
        return
    plan = _dispatch_chaos_cache.get(spec)
    if plan is None:
        try:
            from mapreduce_rust_tpu_torch.analysis.chaos import ChaosPlan

            plan = ChaosPlan.parse(spec)
        except Exception:
            plan = False  # a bad ambient spec must not fail dispatches
        _dispatch_chaos_cache[spec] = plan
    if not plan:
        return
    f = plan.pick("slow_dispatch", tid=dispatch_index)
    if f is not None and f.seconds > 0:
        time.sleep(f.seconds)


def dispatch_chaos_fired(spec: str) -> list:
    """Fired slow_dispatch events for ``spec`` (test/bench introspection)."""
    plan = _dispatch_chaos_cache.get(spec)
    return plan.fired() if plan else []


class _DispatchPlane:
    """The device-merge dispatch plane: scan-order scatter-back, update
    pack, host→device copy and the packed merge, on ONE dedicated
    depth-bounded dispatch thread (or inline on the router with
    ``dispatch_async=False`` / ``MR_DISPATCH_SYNC=1``). The router hands
    off O(1) per window and goes back to routing.

    - **Cross-window coalescing** (``Config.dispatch_coalesce``, "sum"
      apps only — pre-summing any other op would be wrong): successive
      windows' (packed-key, count) columns merge into a staging combine
      buffer (native ``mr_coalesce_updates``), and a device merge
      dispatches only when the fill crosses ``dispatch_fill_frac`` of the
      stage cap or the stream ends.
    - **Zero-memset staging** (:class:`_PackStager`).

    Exactness: the dispatch stream is a pure function of the window
    sequence and the dispatch config — never of (host_map_workers,
    fold_shards) — so outputs and spill counters are identical across the
    (W, S) matrix at a fixed dispatch config. Coalescing changes which
    merges the device sees, not what they sum to.

    Failure containment: a dispatch error poisons the plane; the dead
    thread keeps draining its queue so the router's bounded ``submit``
    never deadlocks; the original error re-raises on the router at the
    next submit or at ``finish``; ``abort`` forces the sentinel past a
    full queue.
    """

    _SENTINEL = object()
    _QUEUE_DEPTH = 8  # windows in flight router→dispatch; each pins one
    # window's scan arrays (shared read-only with the fold plane's slices)

    def __init__(self, cfg: Config, app: App, stats: JobStats, acc,
                 device: torch.device) -> None:
        self.app = app
        self.acc = acc
        self.stats = stats
        self.device = device
        self.cap = cfg.host_update_cap
        self.depth = max(cfg.pipeline_depth, 1)
        self.sync = (not cfg.dispatch_async) or sync_dispatch_forced()
        self.coalesce = bool(cfg.dispatch_coalesce) and app.combine_op == "sum"
        self.stage_cap = cfg.effective_dispatch_stage_cap()
        self.fill_threshold = max(
            1, min(self.stage_cap,
                   int(round(cfg.dispatch_fill_frac * self.stage_cap)))
        )
        self.merge_packed = make_packed_merge_fn(app, self.cap)
        self.state = KVBatch.empty(cfg.merge_capacity, device)
        self.pending: collections.deque = collections.deque()  # (ev, evicted, events)
        self._stager = _PackStager(self.cap, device)
        if self.coalesce:
            # Ping-pong staging pair: the native merge writes into the
            # OTHER buffer (inputs must not alias outputs), then the roles
            # swap — no allocation per window.
            self._skeys = [np.empty(self.stage_cap, np.uint64) for _ in range(2)]
            self._svals = [np.empty(self.stage_cap, np.int64) for _ in range(2)]
            self._scur = 0
            self._sn = 0
        # Plane-local tallies: the dispatch thread owns them; the router
        # publishes copies per window and collect() writes the finals.
        self.dispatch_s = 0.0        # thread seconds in scatter/pack/copy/merge
        self.coalesce_s = 0.0        # of which: sort + native staging combine
        self.merge_device_s = 0.0    # card seconds in the packed merges
        self.stall_s = 0.0           # router blocked on a full queue + join
        self.idle_s = 0.0            # thread seconds waiting for windows
        self.device_wait_s = 0.0
        self.spill_events = 0
        self.spilled_keys = 0
        self.merge_dispatches = 0
        self.records_shipped = 0
        self.submit_hist = Histogram()   # per-dispatch pack+copy+merge seconds
        self.drain_hist = Histogram()    # per-drain blocking readback
        self.error: "BaseException | None" = None
        self.poisoned = threading.Event()
        self._finished = False
        stats.dispatch_mode = ("sync" if self.sync else "async") \
            + ("+coalesce" if self.coalesce else "")
        if self.sync:
            self._q = None
            self._thread = None
            return
        self._q: queue.Queue = queue.Queue(maxsize=self._QUEUE_DEPTH)
        self._thread = threading.Thread(target=self._loop, name="mr/dispatch",
                                        daemon=True)
        self._thread.start()

    # ---- dispatch thread ----

    def _loop(self) -> None:
        # Sanitizer registration: this thread writes device_mem_high_bytes
        # (via _sample_device_memory); every other tally is plane-local
        # until collect().
        self.stats.register_writer()
        q = self._q
        saw_sentinel = False
        try:
            if self.device.type == "cuda":
                # This thread launches the merges and reads ev_count back:
                # it must run on the job's card, whatever the default.
                torch.cuda.set_device(self.device)
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.idle_s += time.perf_counter() - t0
                if item is self._SENTINEL:
                    saw_sentinel = True
                    if not self.poisoned.is_set():
                        self._finalize()
                    return
                if self.poisoned.is_set():
                    continue  # poisoned: drain, don't dispatch
                self._handle(item)
        except BaseException as e:
            self.error = e
            self.poisoned.set()
            if not saw_sentinel:
                # Keep consuming (discarding) until the sentinel: the
                # router's bounded put must never deadlock against a dead
                # dispatch thread.
                while q.get() is not self._SENTINEL:
                    pass

    def _handle(self, item) -> None:
        """One window: scatter back to exact scan order, apply the
        filtering app's mask, stamp values, then coalesce or dispatch."""
        doc_id, kind, keys, counts, pos, mask = item
        t0 = time.perf_counter()
        with trace_span("dispatch.window", doc=doc_id, n=len(keys)):
            if kind == "sharded":
                # Grouped scan result: scatter keys/counts (and the mask,
                # computed on grouped rows) back to EXACT scan order so
                # the merge stream matches the unsharded engine's.
                keys_d = np.empty_like(keys)
                keys_d[pos] = keys
                counts_d = np.empty_like(counts)
                counts_d[pos] = counts
                if mask is not None:
                    mask_d = np.empty(len(pos), dtype=bool)
                    mask_d[pos] = mask
                    keys_d, counts_d = keys_d[mask_d], counts_d[mask_d]
                keys, counts = keys_d, counts_d
            elif mask is not None:
                keys, counts = keys[mask], counts[mask]
            values = self.app.host_values(counts, doc_id)
            if self.coalesce:
                self._coalesce_window(keys, values)
            else:
                # Scan order, split at cap.
                cap = self.cap
                for start in range(0, len(keys), cap):
                    ks = keys[start: start + cap]
                    self._dispatch(ks[:, 0], ks[:, 1],
                                   np.asarray(values[start: start + cap],
                                              dtype=np.uint32))
        self.dispatch_s += time.perf_counter() - t0

    def _coalesce_window(self, keys: np.ndarray, values) -> None:
        n = len(keys)
        if self._sn + n > self.stage_cap:
            # The merged result may not fit: flush first. Conservative
            # (duplicates could have made it fit), but deterministic.
            self._flush_staging()
        t0 = time.perf_counter()
        with trace_span("dispatch.coalesce", n=n):
            packed = (keys[:, 0].astype(np.uint64) << np.uint64(32)) \
                | keys[:, 1].astype(np.uint64)
            order = np.argsort(packed, kind="stable")
            pk = np.ascontiguousarray(packed[order])
            pv = np.ascontiguousarray(np.asarray(values, dtype=np.int64)[order])
            if n < self.stage_cap:
                cur, nxt = self._scur, 1 - self._scur
                m = coalesce_updates_into(
                    self._skeys[cur], self._svals[cur], self._sn, pk, pv,
                    self._skeys[nxt], self._svals[nxt],
                )
                self._scur, self._sn = nxt, m
        self.coalesce_s += time.perf_counter() - t0
        if n >= self.stage_cap:
            # A window wider than the whole staging buffer ships directly,
            # in sorted cap-sized slices.
            for start in range(0, n, self.cap):
                self._dispatch_packed(pk[start: start + self.cap],
                                      pv[start: start + self.cap])
            return
        if self._sn >= self.fill_threshold:
            self._flush_staging()

    def _flush_staging(self) -> None:
        """Ship the staging buffer as cap-sized packed merges (sorted,
        pre-summed): every merge but the tail goes out full."""
        if not self.coalesce or self._sn == 0:
            return
        cur, n = self._scur, self._sn
        self._sn = 0
        with trace_span("dispatch.flush", n=n):
            for start in range(0, n, self.cap):
                # Clip the tail at the FILL, not the buffer: slots beyond n
                # are stale and must never ship as records.
                end = min(start + self.cap, n)
                self._dispatch_packed(self._skeys[cur][start:end],
                                      self._svals[cur][start:end])

    def _dispatch_packed(self, pk: np.ndarray, pv: np.ndarray) -> None:
        # int64 staging counts → the uint32 bit pattern the packed layout
        # carries (the device accumulates in int32 two's complement, so
        # pre-summing mod 2^32 is bit-exact against per-window merges).
        self._dispatch(
            (pk >> np.uint64(32)).astype(np.uint32),
            (pk & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            pv.astype(np.uint32),
        )

    def _dispatch(self, k1: np.ndarray, k2: np.ndarray, vals: np.ndarray) -> None:
        t0 = time.perf_counter()
        _chaos_slow_dispatch(self.merge_dispatches)
        self._stager.pack(k1, k2, vals)
        with trace_span("dispatch.submit", n=len(k1)):
            flat = self._stager.to_device()
            # One event pair on this thread's stream around the merge's
            # ops (the copy before them left out), read in _drain.
            timed = None
            if self.device.type == "cuda":
                timed = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                timed[0].record()
            self.state, evicted, ev_count = self.merge_packed(self.state, flat)
            if timed is not None:
                timed[1].record()
        self.pending.append((ev_count, evicted, timed))
        self.merge_dispatches += 1
        self.records_shipped += len(k1)
        self.submit_hist.add(time.perf_counter() - t0)
        if len(self.pending) >= 2 * self.depth:
            self._drain(self.depth)

    def _drain(self, n: int) -> None:
        # One batched readback of n merges' eviction counts: where the
        # dispatch side waits for the device.
        if n <= 0:
            return
        batch = [self.pending.popleft() for _ in range(n)]
        t0 = time.perf_counter()
        with trace_span("device.drain", steps=n):
            counts = torch.stack([ev for ev, _, _ in batch]).cpu().tolist()
        dt = time.perf_counter() - t0
        self.device_wait_s += dt
        self.drain_hist.add(dt)
        # The readback above waited for every op launched before it, so
        # each drained merge's end event has completed: no further wait.
        self.merge_device_s += sum(t[0].elapsed_time(t[1]) for _, _, t in batch
                                   if t is not None) / 1e3
        _sample_device_memory(self.stats)
        for (_ev, evicted, _timed), ev_n in zip(batch, counts):
            if ev_n > 0:
                self.spill_events += 1
                self.spilled_keys += ev_n
                with trace_span("spill", keys=int(ev_n)):
                    self.acc.add_batch(evicted)

    def _finalize(self) -> None:
        """End of stream: flush staging, resolve every pending merge. After
        it ``self.state`` is the complete device fold."""
        self._flush_staging()
        self._drain(len(self.pending))

    # ---- router side ----

    def _raise_error(self) -> None:
        if self.error is not None:
            raise self.error
        raise RuntimeError("dispatch plane poisoned without a recorded error")

    def submit(self, item) -> None:
        """Hand one window to the plane — O(1) for the router (sync mode
        runs it inline). Time blocked on a full queue is dispatch
        backpressure, booked into ``stall_s``."""
        if self.sync:
            self._handle(item)
            return
        if self.poisoned.is_set():
            self._raise_error()
        try:
            self._q.put_nowait(item)
            return
        except queue.Full:
            pass
        t0 = time.perf_counter()
        try:
            with trace_span("host_map.dispatch_stall"):
                while True:
                    if self.poisoned.is_set():
                        self._raise_error()
                    try:
                        self._q.put(item, timeout=0.05)
                        return
                    except queue.Full:
                        continue
        finally:
            self.stall_s += time.perf_counter() - t0

    def finish(self) -> None:
        """Clean end of stream: sentinel, join, surface any dispatch error.
        The join wall counts as dispatch stall."""
        if self._finished:
            return
        self._finished = True
        if self.sync:
            self._finalize()
            return
        t0 = time.perf_counter()
        self._q.put(self._SENTINEL)
        self._thread.join()
        self.stall_s += time.perf_counter() - t0
        if self.poisoned.is_set():
            self._raise_error()

    def abort(self) -> None:
        """Exception-path teardown: poison, force a sentinel past a full
        queue by displacing one item, reap the thread. Idempotent, never
        raises, never blocks forever."""
        self.poisoned.set()
        if self._finished:
            return
        self._finished = True
        if self.sync:
            return
        while True:
            try:
                self._q.put_nowait(self._SENTINEL)
                break
            except queue.Full:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass
        self._thread.join(timeout=10)

    def mean_fill_frac(self) -> float:
        if not self.merge_dispatches:
            return 0.0
        return self.records_shipped / (self.merge_dispatches * self.cap)

    def publish_live(self, stats: JobStats) -> None:
        """Per-window live publication (router thread): the plane's cells
        are benign-stale at worst, so the live ring sees a dispatch-bound
        job DURING the run. collect() writes the exact finals."""
        stats.dispatch_s = self.dispatch_s
        stats.coalesce_s = self.coalesce_s
        stats.merge_device_s = self.merge_device_s
        stats.dispatch_stall_s = self.stall_s
        stats.merge_dispatches = self.merge_dispatches
        stats.merge_fill_frac = round(self.mean_fill_frac(), 6)
        stats.device_wait_s = self.device_wait_s
        stats.spill_events = self.spill_events
        stats.spilled_keys = self.spilled_keys

    def collect(self, stats: JobStats) -> None:
        """Write the plane's tallies into JobStats. Router thread only;
        called with the dispatch thread finished or reaped (its counters
        are plain cells written by that thread alone)."""
        self.publish_live(stats)
        trace_counter("dispatch", coalesce_s=self.coalesce_s,
                      merge_device_s=self.merge_device_s)
        for name, h in (("dispatch.submit_s", self.submit_hist),
                        ("device.drain_s", self.drain_hist)):
            if h.count:
                stats.hists.setdefault(name, Histogram()).merge(h)


class _FoldShardPlane:
    """The sharded egress fold: S fold threads, each the SOLE owner of one
    key-hash-disjoint dictionary shard (runtime/dictionary
    .ShardedDictionary), fed per-window per-shard slices by the router
    over bounded queues. The router never touches shard state (it only
    enqueues read-only slices of the scan result); a fold thread never
    touches another shard.

    Failure containment: a fold thread that raises records its error,
    flips the shared poison flag and keeps draining its queue until the
    sentinel, so the router's bounded put never deadlocks; the router
    surfaces the error at its next route or at ``finish``. ``abort``
    poisons every shard, forces sentinels past full queues and reaps the
    threads without ever blocking forever.
    """

    _SENTINEL = object()

    def __init__(self, cfg: Config, stats: JobStats, shards) -> None:
        from mapreduce_rust_tpu_torch.analysis.sanitize import sanitize_enabled

        self.n = len(shards)
        self.stats = stats
        self.shards = shards
        self._sanitize = sanitize_enabled(cfg)
        # Bounded per-shard queues: each entry pins one window's grouped
        # scan arrays (shared read-only across shards), so fold memory is
        # O(depth × window result), never O(corpus).
        self.queues = [queue.Queue(maxsize=8) for _ in range(self.n)]
        self.errors: list = [None] * self.n
        self.poisoned = threading.Event()
        self.fold_s = [0.0] * self.n
        self.idle_s = [0.0] * self.n  # per-shard seconds waiting for work
        self.hists = [Histogram() for _ in range(self.n)]
        self.stall_s = 0.0  # router side: blocked puts + end-of-stream join
        self._finished = False
        self.threads = [
            threading.Thread(target=self._loop, args=(s,), name=f"mr/fold-{s}",
                             daemon=True)
            for s in range(self.n)
        ]
        for t in self.threads:
            t.start()

    # ---- fold threads ----

    def _loop(self, s: int) -> None:
        shard = self.shards[s]
        # Sanitizer registration: this thread becomes the shard
        # dictionary's owner and a registered stats writer — no-ops
        # unsanitized, asserts armed under MR_SANITIZE=1.
        self.stats.register_writer()
        set_owner = getattr(shard, "set_owner", None)
        if set_owner is not None:
            set_owner()
        q = self.queues[s]
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.idle_s[s] += time.perf_counter() - t0
                if item is self._SENTINEL:
                    return
                if self.poisoned.is_set():
                    continue  # another shard failed: drain, don't fold
                t0 = time.perf_counter()
                if self._sanitize:
                    # Every key routed here must route to this shard.
                    from mapreduce_rust_tpu_torch.analysis.sanitize import (
                        check_shard_route,
                    )

                    _raw, _ends, keys, lo, hi, _mask = item
                    check_shard_route(keys[lo:hi], self.n, s)
                with trace_span("host_map.fold", shard=s):
                    self._fold_one(shard, item)
                dt = time.perf_counter() - t0
                self.fold_s[s] += dt
                self.hists[s].add(dt)
        except BaseException as e:
            self.errors[s] = e
            self.poisoned.set()
            while q.get() is not self._SENTINEL:
                pass

    @staticmethod
    def _fold_one(shard: Dictionary, item) -> None:
        # Pre-partitioned native scan: rows [lo, hi) and one contiguous
        # word-bytes span belong to this shard.
        raw, ends, keys, lo, hi, mask = item
        base = int(ends[lo - 1]) if lo else 0
        fold_scan_into_dictionary(
            shard, mask[lo:hi] if mask is not None else None, "raw",
            (raw[base:int(ends[hi - 1])], ends[lo:hi] - base, keys[lo:hi]),
        )

    # ---- router side ----

    def _raise_error(self) -> None:
        for e in self.errors:
            if e is not None:
                raise e
        raise RuntimeError("fold plane poisoned without a recorded error")

    def _put(self, s: int, item) -> None:
        if self.poisoned.is_set():
            self._raise_error()
        q = self.queues[s]
        try:
            q.put_nowait(item)
            return
        except queue.Full:
            pass
        # Blocked = fold backpressure, timed apart from glue.
        t0 = time.perf_counter()
        try:
            with trace_span("host_map.fold_stall", shard=s):
                while True:
                    if self.poisoned.is_set():
                        self._raise_error()
                    try:
                        q.put(item, timeout=0.05)
                        return
                    except queue.Full:
                        continue
        finally:
            self.stall_s += time.perf_counter() - t0

    def route_raw(self, raw, ends, keys, shard_counts, mask) -> None:
        """Hand each shard its slice of one pre-partitioned scan result:
        O(shards) router work per window."""
        cum = 0
        for s, c in enumerate(shard_counts.tolist()):
            lo, hi = cum, cum + c
            cum = hi
            if c:
                self._put(s, (raw, ends, keys, lo, hi, mask))

    def finish(self) -> None:
        """Clean end of stream: sentinel every queue, join every thread,
        surface any fold error."""
        if self._finished:
            return
        self._finished = True
        t0 = time.perf_counter()
        for q in self.queues:
            q.put(self._SENTINEL)
        for t in self.threads:
            t.join()
        self.stall_s += time.perf_counter() - t0
        if self.poisoned.is_set():
            self._raise_error()

    def abort(self) -> None:
        """Exception-path teardown. Idempotent, never raises, never blocks
        forever."""
        self.poisoned.set()
        if self._finished:
            return
        self._finished = True
        for q in self.queues:
            while True:
                try:
                    q.put_nowait(self._SENTINEL)
                    break
                except queue.Full:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
        for t in self.threads:
            t.join(timeout=10)

    def collect(self, stats: JobStats) -> None:
        """Per-thread tallies into JobStats — router thread only, after
        finish/abort joined the threads."""
        stats.fold_s = sum(self.fold_s)
        stats.fold_stall_s = self.stall_s
        stats.fold_shard_s = [round(v, 6) for v in self.fold_s]
        stats.fold_shard_idle_s = [round(v, 6) for v in self.idle_s]
        agg = stats.hists.setdefault("host_map.fold_s", Histogram())
        for h in self.hists:
            if h.count:
                agg.merge(h)


_CUT_PROBE = 1 << 16  # how far back a window cut searches for whitespace


def _iter_windows(cfg: Config, inputs, stats: JobStats):
    """(doc_id, raw window view) stream — zero-copy uint8 views over each
    memory-mapped input, cut at ASCII whitespace (safe before
    normalization, which never alters ASCII bytes). Only the last
    _CUT_PROBE bytes of a window are materialized to find the cut; a
    window whose final 64 KiB holds no whitespace is force-cut at a UTF-8
    sequence boundary and counted in stats.forced_cuts."""
    import mmap

    for doc_id, path in enumerate(inputs):
        size = os.path.getsize(path)
        stats.bytes_in += size
        if size == 0:
            continue
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        try:  # sequential readahead: fault whole extents, not page by page
            mm._mmap.madvise(mmap.MADV_SEQUENTIAL)
        except (AttributeError, OSError, ValueError):
            pass
        start = 0
        while start < size:
            end = min(start + cfg.host_window_bytes, size)
            if end < size:
                probe_at = max(start, end - _CUT_PROBE)
                tail = mm[probe_at:end].tobytes()
                off, forced = _ws_cut(tail, 0, len(tail))
                if forced:
                    stats.forced_cuts += 1
                    off = utf8_safe_cut(tail, off)
                cut = probe_at + off
            else:
                cut = end
            yield doc_id, mm[start:cut]
            start = cut


def _py_scan_count(window: bytes):
    """Plain version of scan_count_raw: (unique words in first occurrence
    order, hash pairs uint32 [n, 2], counts uint32 [n]) of RAW bytes.
    Tests hold the native scan to it; no production path calls it."""
    counter = collections.Counter(extract_words(normalize_python(bytes(window))))
    words = list(counter.keys())
    keys = hash_words(words)
    counts = np.asarray([counter[w] for w in words], dtype=np.uint32)
    return words, keys, counts


def _stream_host_map(cfg: Config, app: App, inputs, stats: JobStats,
                     acc: HostAccumulator, dictionary, device: torch.device) -> None:
    """The host-map engine: one fused native pass per window normalizes,
    tokenizes, dedupes, hashes and counts on the host — the very scan that
    feeds the egress dictionary — and the device merges the compacted
    updates. The map runs where the Rust original's map runs, on the CPU
    (src/app/wc.rs:6-13); the card holds the running combine state.

    The scan fans out: ``host_map_workers`` threads run the GIL-releasing
    native scan concurrently (per-thread scratch arenas isolate them)
    while THIS thread, the router, consumes results strictly in window
    order, so outputs are identical for any worker count. In-flight scans
    are bounded (2 × workers + 2), so host memory stays flat.

    With a ShardedDictionary the fold fans out too: the native scan
    returns each window pre-partitioned by key-hash shard, the router
    hands shard s its slice, and S fold threads (each the sole owner of
    one shard) fold in window order. The device merge stream is scattered
    back to exact scan order by the dispatch plane, so merges, evictions
    and outputs are identical for every (workers, shards) pair."""
    workers = cfg.effective_host_map_workers()
    stats.host_map_workers = workers
    fold_n = dictionary.n_shards if isinstance(dictionary, ShardedDictionary) else 1
    stats.fold_shards = fold_n
    fold: "_FoldShardPlane | None" = None  # started right before the try
    dispatch = _DispatchPlane(cfg, app, stats, acc, device)
    # Provenance: digest each window on ITS scan thread (the bytes are hot
    # there), record on the router in window order, so the ledger is
    # identical for any (workers, shards) combination.
    ledger = active_ledger()
    lineage_range = app.partition_mode == "range"

    def lineage_record(doc_id, lin, keys, mask) -> None:
        if lin is None:
            return
        dg, nb = lin
        ledger.record_chunk(
            doc_id, nb, dg,
            parts=_routed_parts(keys, mask, cfg.reduce_n, lineage_range),
        )

    def scan_window(item):
        # PURE: reads its window, returns its result and its own duration.
        # No shared state is written off the router thread, so an
        # abandoned scan (exception teardown) cannot touch stats.
        doc_id, window = item
        t0 = time.perf_counter()
        with trace_span("host_map.scan", doc=doc_id, bytes=int(window.size)):
            if fold is not None:
                out = (doc_id, "raw_sharded", scan_count_sharded_raw(window, fold.n))
            else:
                out = (doc_id, "raw", scan_count_raw(window))
            # Digest after the scan: the scan just faulted every window
            # page in, so the sampled blake2b reads hot memory.
            lin = (
                (chunk_digest(window), int(window.size))
                if ledger is not None else None
            )
        return (*out, lin, time.perf_counter() - t0)

    def consume(result) -> None:
        doc_id, kind, res, lin, scan_s = result
        stats.host_map_s += scan_s  # summed over workers
        stats.record_hist("host_map.scan_s", scan_s)
        t_glue = time.perf_counter()
        stall0 = fold.stall_s if fold is not None else 0.0
        dstall0 = dispatch.stall_s
        dwait0 = dispatch.device_wait_s
        with trace_span("host_glue"):
            stats.chunks += 1
            if kind == "raw_sharded":
                raw, ends, keys, counts, pos, shard_counts = res
                mask = app.host_mask(keys)  # grouped rows; per-row exact
                lineage_record(doc_id, lin, keys, mask)
                fold.route_raw(raw, ends, keys, shard_counts, mask)
                dispatch.submit((doc_id, "sharded", keys, counts, pos, mask))
            else:
                raw, ends, keys, counts = res
                mask = app.host_mask(keys)
                lineage_record(doc_id, lin, keys, mask)
                fold_scan_into_dictionary(dictionary, mask, "raw", (raw, ends, keys))
                dispatch.submit((doc_id, "flat", keys, counts, None, mask))
        # Glue is the router's own work: time blocked on full shard or
        # dispatch queues is backpressure (fold_stall_s, dispatch_stall_s).
        # In sync mode the inline dispatch is glue, less its blocking
        # readback, which device_wait_s owns.
        glue_dt = time.perf_counter() - t_glue
        if fold is not None:
            glue_dt = max(glue_dt - (fold.stall_s - stall0), 0.0)
        if dispatch.sync:
            glue_dt = max(glue_dt - (dispatch.device_wait_s - dwait0), 0.0)
        else:
            glue_dt = max(glue_dt - (dispatch.stall_s - dstall0), 0.0)
        stats.host_glue_s += glue_dt
        stats.record_hist("host_map.glue_s", glue_dt)
        # Running totals of the off-router planes, published per window
        # (benign-stale reads of their cells) so the live ring names a
        # fold-, dispatch- or spill-bound job during the run; collect()
        # writes the exact finals at teardown.
        if fold is not None:
            stats.fold_s = sum(fold.fold_s)
            stats.fold_stall_s = fold.stall_s
        dispatch.publish_live(stats)
        _publish_spill_live(stats, dictionary, acc)
        maybe_snapshot()  # flight-recorder tick: per window, router thread
        metrics_tick()    # live-metrics sampler, same piggyback contract

    inflight: collections.deque = collections.deque()
    budget = 2 * workers + 2

    def next_result():
        fut = inflight.popleft()
        t0 = time.perf_counter()
        with trace_span("host_map.stall"):
            res = fut.result()
        dt = time.perf_counter() - t0
        stats.scan_wait_s += dt
        stats.record_hist("host_map.stall_s", dt)
        trace_counter("host_map.inflight", scans=len(inflight),
                      merges=len(dispatch.pending))  # benign-stale len read
        return res

    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="mr/scan")
    if fold_n > 1:
        # Started HERE: everything that can raise during setup is behind
        # us, and the very next statement is the try that owns teardown.
        try:
            fold = _FoldShardPlane(cfg, stats, dictionary.shards)
        except BaseException:
            dispatch.abort()
            pool.shutdown(wait=True, cancel_futures=True)
            raise
    try:
        for item in _iter_windows(cfg, inputs, stats):
            inflight.append(pool.submit(scan_window, item))
            if len(inflight) >= budget:
                consume(next_result())
        while inflight:
            consume(next_result())
        stats.host_arena_bytes = arena_bytes()
        if fold is not None:
            # Teardown order: the router has routed every scan result,
            # THEN the fold threads flush and join, THEN the dispatch plane
            # flushes its staging buffer and drains the device merges.
            fold.finish()
        dispatch.finish()
    except BaseException:
        if fold is not None:
            fold.abort()
        dispatch.abort()
        raise
    finally:
        if fold is not None:
            fold.collect(stats)  # threads joined by finish()/abort()
        dispatch.collect(stats)
        # Queued scans cancel; the running ones finish their pure work and
        # are reaped before the stream frame exits.
        pool.shutdown(wait=True, cancel_futures=True)
    acc.add_batch(dispatch.state)


# ---------------------------------------------------------------------------
# The mesh engines (mesh_shape > 1)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _a2a_span(stats: JobStats, **span_args):
    """One mesh.all_to_all block: the trace span plus a wall-clock
    accumulation into stats.all_to_all_s and its per-round histograms, so
    the manifest's interconnect split exists in untraced runs too. It
    covers tokenize, bucket scatter, the all_to_all and the merge dispatch
    of the round: host-side time on an asynchronous device, whose waiting
    lands in device_wait_s."""
    t0 = time.perf_counter()
    try:
        with trace_span("mesh.all_to_all", **span_args):
            yield
    finally:
        dt = time.perf_counter() - t0
        stats.all_to_all_s += dt
        stats.record_hist("a2a.round_s", dt)
        wb = span_args.get("wire_bytes")
        if wb:
            stats.record_hist("a2a.wire_bytes", wb)


def _ship(host: torch.Tensor, mesh) -> list:
    """Row i of a ``[d_local, N]`` host tensor onto this process's shard
    i's device, as an asynchronous copy; the caller keeps ``host`` alive
    until the copy is known to be done (a drain)."""
    return [host[i].to(dev, non_blocking=True)
            for i, dev in enumerate(mesh.local_devices)]


def _pinned(arr: np.ndarray, mesh) -> torch.Tensor:
    """The host tensor of a ``[D, N]`` group, pinned when the mesh is on
    cards so that its copies run asynchronously."""
    host = torch.from_numpy(arr)
    return host.pin_memory() if mesh.devices[0].type == "cuda" else host


def _spill_shards(stats: JobStats, acc: HostAccumulator, evicted, ev_n: int) -> None:
    stats.spill_events += 1
    stats.spilled_keys += ev_n
    for ev in evicted:
        acc.add_batch(ev)


def _replay_readback(stats: JobStats, acc: HostAccumulator, evicted, ev_counts) -> None:
    """A replay round's blocking eviction readback and spill, outside its
    a2a block: they are device wait and host work, and inside it they
    would count as interconnect time."""
    t0 = time.perf_counter()
    with trace_span("device.drain", steps=1):
        ev_n = int(ev_counts.sum())
    stats.device_wait_s += time.perf_counter() - t0
    if ev_n > 0:
        _spill_shards(stats, acc, evicted, ev_n)


def _ckpt_paths(cfg: Config) -> tuple[str, str]:
    return (
        os.path.join(cfg.work_dir, "driver.ckpt.npz"),
        os.path.join(cfg.work_dir, "driver.ckpt.dict"),
    )


def _job_fingerprint(cfg: Config, app: App, inputs, d: int) -> str:
    """Ties a checkpoint to (inputs, app, every shape-determining knob): a
    mismatch on resume is ignored, never trusted. The string is the
    reference's, so either package resumes the other's checkpoint."""
    import hashlib

    h = hashlib.sha256()
    for p in inputs:
        st = os.stat(p)
        h.update(f"{p}:{st.st_size}:{st.st_mtime_ns};".encode())
    # state-v2: the rank merge needs a sorted state; a checkpoint of the
    # reference's validity-only-clamp era may hold SENTINEL holes.
    h.update(
        f"state-v2:{app.name}:{app.combine_op}:{cfg.chunk_bytes}:{d}:"
        f"{cfg.effective_partial_capacity()}:{cfg.merge_capacity}".encode()
    )
    return h.hexdigest()


def _write_ckpt(cfg: Config, fingerprint: str, state, groups_done: int,
                acc: HostAccumulator, dictionary, stats: JobStats) -> None:
    """Atomic driver checkpoint: per-shard state (uint32 ``[D, cap]`` keys,
    the reference's layout), host accumulator and progress in one npz (the
    commit point), the dictionary beside it. The dictionary renames
    FIRST: it only grows, so a dictionary newer than the npz is a superset,
    and the npz's commit guarantees a complete one exists."""
    from mapreduce_rust_tpu_torch.parallel.shuffle import local_batch

    npz_path, dict_path = _ckpt_paths(cfg)
    os.makedirs(cfg.work_dir, exist_ok=True)
    tmp_d = dict_path + f".{os.getpid()}.tmp"
    dictionary.save(tmp_d)
    os.replace(tmp_d, dict_path)
    k1, k2, value, valid = local_batch(state)
    acc_keys, acc_vals = acc.snapshot()
    tmp_n = npz_path + f".{os.getpid()}.tmp"
    with open(tmp_n, "wb") as f:
        np.savez(
            f,
            fingerprint=np.frombuffer(fingerprint.encode(), dtype=np.uint8),
            k1=k1, k2=k2, value=value, valid=valid,
            groups_done=np.int64(groups_done),
            acc_keys=acc_keys, acc_vals=acc_vals,
            spill_events=np.int64(stats.spill_events),
            spilled_keys=np.int64(stats.spilled_keys),
        )
    os.replace(tmp_n, npz_path)
    log.info("checkpoint: %d groups done", groups_done)


def _load_ckpt(cfg: Config, fingerprint: str):
    """(state arrays as a host KVBatch of ``[D, cap]``, groups_done,
    acc_keys, acc_vals, spill_events, spilled_keys, dict_path), or None
    when the checkpoint is absent, torn or another job's."""
    npz_path, dict_path = _ckpt_paths(cfg)
    if not (os.path.exists(npz_path) and os.path.exists(dict_path)):
        return None
    try:
        with np.load(npz_path) as z:
            if bytes(z["fingerprint"]).decode() != fingerprint:
                log.warning("checkpoint fingerprint mismatch — starting fresh")
                return None
            return (
                KVBatch(z["k1"], z["k2"], z["value"], z["valid"]),
                int(z["groups_done"]),
                z["acc_keys"], z["acc_vals"],
                int(z["spill_events"]), int(z["spilled_keys"]),
                dict_path,
            )
    except (OSError, ValueError, KeyError, BadZipFile) as e:
        log.warning("unreadable checkpoint (%s) — starting fresh", e)
        return None


def _finish_mesh_state(app: App, state, stats: JobStats, acc: HostAccumulator) -> None:
    """Fold the final per-shard state into the host accumulator. A top-k
    app fetches only per-shard candidates (parallel/topk.py) when that is
    provably exact: no spill (a spilled key's device value is partial) and
    no value tie at any shard's k boundary (the word tie-break needs the
    bytes, which the device does not have)."""
    from mapreduce_rust_tpu_torch.parallel.shuffle import shard_fill_counts
    from mapreduce_rust_tpu_torch.parallel.topk import topk_candidates

    # Per-shard distinct keys: the hash-class skew signal, read once here.
    stats.mesh_shard_rows = shard_fill_counts(state)
    k = app.device_select_k
    if k and stats.spill_events == 0:
        res = topk_candidates(state, k)
        if res is not None:
            keys, vals = res
            acc.add(keys, vals)
            log.info("device top-%d selection: %d candidates fetched", k, len(vals))
            return
        log.info("device top-%d selection ambiguous (value tie at boundary) "
                 "— falling back to full state fetch", k)
    for st in state:
        acc.add_batch(st)


def _stream_sharded(cfg: Config, app: App, inputs, stats: JobStats,
                    acc: HostAccumulator, dictionary) -> None:
    """Sequence-parallel mesh ingestion: each normalized window rides the
    mesh as ONE contiguous byte stream cut at arbitrary equal offsets (mid
    word, even mid UTF-8 sequence), one shard each. The halo exchange
    (parallel/halo.py) hashes every straddling token exactly once, owned by
    the shard where it ends; the records then take the combine → bucket
    scatter → all_to_all → merge pipeline.

    Tokens longer than the halo (cfg.max_word_len) may hash truncated; they
    are detected on the device and counted in stats.halo_truncations."""
    from mapreduce_rust_tpu_torch.parallel.halo import make_sharded_tokenizer, shard_stream
    from mapreduce_rust_tpu_torch.parallel.shuffle import (
        default_bucket_cap,
        make_kv_shuffle_step_fns,
        make_mesh,
        make_shuffle_step_fns,
        sharded_empty_state,
        wire_bytes_per_round,
    )

    if cfg.checkpoint_every_groups or cfg.resume:
        raise ValueError(
            "checkpoint/resume is not supported in sharded-stream mode "
            "(use the chunked mesh path, or run without sharded_stream)"
        )
    mesh = make_mesh(cfg.mesh_shape, cfg.device)
    d = mesh.size
    u_cap = cfg.effective_partial_capacity()
    bucket_cap = default_bucket_cap(u_cap, d, cfg.bucket_capacity_factor)
    tokenize = make_sharded_tokenizer(mesh, halo=cfg.max_word_len)
    kv_shuffle = make_kv_shuffle_step_fns(app, u_cap, bucket_cap, mesh)
    merge = make_shuffle_step_fns(app, u_cap, bucket_cap, mesh)[1]
    state = sharded_empty_state(mesh, max(cfg.merge_capacity // d, 16))
    depth = max(max(cfg.pipeline_depth, 1) // d, 4)
    pending: collections.deque = collections.deque()
    shard_bytes = max(cfg.chunk_bytes, 2 * cfg.max_word_len + 8)
    # The full-width replay tier: u_cap = bucket_cap = the whole window, so
    # neither overflow can recur.
    w_cap = cfg.max_word_len + shard_bytes + 1

    def replay_group(group: bytes, doc_id: int, p_n: int) -> None:
        # The fast round clamped the whole group to empty on the device, so
        # re-run it through the full-width tier and merge that. Exact.
        nonlocal state
        stats.partial_overflow_replays += int(p_n > 0)
        stats.bucket_skew_replays += int(p_n == 0)
        wide = make_kv_shuffle_step_fns(app, w_cap, w_cap, mesh)
        wide_merge = make_shuffle_step_fns(app, w_cap, w_cap, mesh)[1]
        host = _pinned(shard_stream(group, mesh, pad=shard_bytes), mesh)
        stats.mesh_rounds += 1
        wb = wire_bytes_per_round(d, w_cap)
        stats.shuffle_wire_bytes += wb
        with _a2a_span(stats, round=stats.mesh_rounds, tier="replay", wire_bytes=wb):
            kvs, _trunc = tokenize(_ship(host, mesh))
            local, _p, _b = wide(kvs, [doc_id] * d)
            state, evicted, ev_counts = wide_merge(state, local)
        _replay_readback(stats, acc, evicted, ev_counts)

    def drain(n: int) -> None:
        # One batched readback of every counter of the window's rounds.
        if n <= 0:
            return
        batch = [pending.popleft() for _ in range(n)]
        t0 = time.perf_counter()
        with trace_span("device.drain", steps=n):
            counts = torch.stack([x for row in batch for x in row[:4]]).cpu().numpy()
        dt = time.perf_counter() - t0
        stats.device_wait_s += dt
        stats.record_hist("device.drain_s", dt)
        _sample_device_memory(stats)
        for row, trunc, p_ovf, b_ovf, ev in zip(
            batch, counts[0::4], counts[1::4], counts[2::4], counts[3::4]
        ):
            stats.halo_truncations += int(trunc.sum())
            ev_n = int(ev.sum())
            if ev_n > 0:
                with trace_span("spill", keys=ev_n):
                    _spill_shards(stats, acc, row[4], ev_n)
            p_n, b_n = int(p_ovf.sum()), int(b_ovf.sum())
            if p_n or b_n:
                replay_group(row[5], row[6], p_n)

    ledger = active_ledger()
    lineage_range = app.partition_mode == "range"
    for doc_id, window in _iter_windows(cfg, inputs, stats):
        stats.chunks += 1
        raw = bytes(window)
        norm = normalize_unicode(raw)
        kind, *scan = _scan_payload(norm)
        keys = scan_keys(kind, scan)
        mask = app.host_mask(keys)
        fold_scan_into_dictionary(dictionary, mask, kind, scan)
        if ledger is not None:
            # The RAW window's digest: the bytes every other engine hashes.
            ledger.record_chunk(
                doc_id, len(raw), chunk_digest(raw),
                parts=_routed_parts(keys, mask, cfg.reduce_n, lineage_range),
            )
        # Group seams are host-side cuts like window seams, so they align to
        # whitespace: a token split there would fragment into keys no
        # dictionary entry matches. The arbitrary (mid-word) cuts are the
        # D-1 shard seams inside each group, which the halo repairs.
        off = 0
        while off < len(norm):
            end = min(off + d * shard_bytes, len(norm))
            if end < len(norm):
                probe = norm[max(off, end - cfg.max_word_len - 1): end]
                o, forced = _ws_cut(probe, 0, len(probe))
                if forced:
                    stats.forced_cuts += 1
                else:
                    end -= len(probe) - o
            group = norm[off:end]
            off = end
            stats.mesh_rounds += 1
            wb = wire_bytes_per_round(d, bucket_cap)
            stats.shuffle_wire_bytes += wb
            with _a2a_span(stats, round=stats.mesh_rounds, tier="fast", wire_bytes=wb):
                host = _pinned(shard_stream(group, mesh, pad=shard_bytes), mesh)
                kvs, trunc = tokenize(_ship(host, mesh))
                local, p_ovf, b_ovf = kv_shuffle(kvs, [doc_id] * d)
                state, evicted, ev_counts = merge(state, local)
                pending.append((trunc, p_ovf, b_ovf, ev_counts, evicted, group,
                                doc_id, host))
            if len(pending) >= 2 * depth:
                drain(depth)
        maybe_snapshot()
        metrics_tick()
    drain(len(pending))
    _finish_mesh_state(app, state, stats, acc)


def _stream_mesh(cfg: Config, app: App, inputs, stats: JobStats,
                 acc: HostAccumulator, dictionary) -> None:
    """The group-of-D-chunks pipeline over the 1-D mesh
    (parallel/shuffle.py): D consecutive chunks make a group, one per
    shard, and each group is one map → all_to_all → merge round. With
    ``checkpoint_every_groups`` the pipeline drains and writes an atomic
    checkpoint every N groups; with ``resume`` a matching checkpoint's
    state, accumulator and dictionary are loaded and its groups' chunks
    skipped."""
    from mapreduce_rust_tpu_torch.parallel.shuffle import (
        default_bucket_cap,
        make_mesh,
        make_shuffle_step_fns,
        sharded_empty_state,
        wire_bytes_per_round,
    )

    mesh = make_mesh(cfg.mesh_shape, cfg.device)
    d = mesh.size
    u_cap = cfg.effective_partial_capacity()
    bucket_cap = default_bucket_cap(u_cap, d, cfg.bucket_capacity_factor)
    fast = make_shuffle_step_fns(app, u_cap, bucket_cap, mesh)
    state = sharded_empty_state(mesh, max(cfg.merge_capacity // d, 16))
    # Each in-flight group pins D chunks for the rare replay, so the window
    # shrinks by D to keep pending memory at the single-device engine's.
    depth = max(max(cfg.pipeline_depth, 1) // d, 4)
    pending: collections.deque = collections.deque()

    fingerprint = _job_fingerprint(cfg, app, inputs, d)
    groups_done = 0
    skip_chunks = 0
    if cfg.resume:
        ck = _load_ckpt(cfg, fingerprint)
        if ck is not None:
            st_host, groups_done, ak, av, sev, skk, dict_path = ck
            state = [KVBatch.from_numpy(*(lane[i] for lane in st_host), device=dev)
                     for i, dev in enumerate(mesh.devices)]
            skip_chunks = groups_done * d
            acc.add(ak, av)
            dictionary.merge(Dictionary.load(dict_path))
            stats.spill_events, stats.spilled_keys = sev, skk
            log.info("resumed from checkpoint: %d groups already merged", groups_done)

    def replay_group(host: torch.Tensor, docs: list, p_n: int) -> None:
        # The fast round clamped this whole group to empty on the device,
        # so re-run it through a tier wide enough that the overflow cannot
        # recur, and merge that.
        nonlocal state
        if p_n > 0:
            # A chunk had more distinct keys than u_cap: the widest tier.
            stats.partial_overflow_replays += 1
            tier_cap = cfg.chunk_bytes
            fns = make_shuffle_step_fns(app, tier_cap, tier_cap, mesh)
        else:
            # Bucket skew: bucket_cap = u_cap makes overflow impossible.
            stats.bucket_skew_replays += 1
            tier_cap = u_cap
            fns = make_shuffle_step_fns(app, u_cap, u_cap, mesh)
        stats.mesh_rounds += 1
        wb = wire_bytes_per_round(d, tier_cap)
        stats.shuffle_wire_bytes += wb
        with _a2a_span(stats, round=stats.mesh_rounds, tier="replay", wire_bytes=wb):
            local, _p, _b = fns[0](_ship(host, mesh), docs)
            state, evicted, ev_counts = fns[1](state, local)
        _replay_readback(stats, acc, evicted, ev_counts)

    def drain(n: int) -> None:
        # One batched readback per window, as _stream_single's drain.
        if n <= 0:
            return
        batch = [pending.popleft() for _ in range(n)]
        t0 = time.perf_counter()
        with trace_span("device.drain", steps=n):
            counts = torch.stack([x for row in batch for x in row[:3]]).cpu().numpy()
        dt = time.perf_counter() - t0
        stats.device_wait_s += dt
        stats.record_hist("device.drain_s", dt)
        _sample_device_memory(stats)
        for row, p_ovf, b_ovf, ev in zip(batch, counts[0::3], counts[1::3], counts[2::3]):
            ev_n = int(ev.sum())
            if ev_n > 0:
                with trace_span("spill", keys=ev_n):
                    _spill_shards(stats, acc, row[3], ev_n)
            p_n = int(p_ovf.sum())
            if p_n > 0 or int(b_ovf.sum()) > 0:
                replay_group(row[4], row[5], p_n)

    group_chunks: list[np.ndarray] = []
    group_docs: list[int] = []

    def submit_group() -> None:
        nonlocal state, groups_done
        while len(group_chunks) < d:  # pad the tail group with space chunks
            group_chunks.append(np.full(cfg.chunk_bytes, 0x20, dtype=np.uint8))
            group_docs.append(0)
        host = _pinned(np.stack(group_chunks), mesh)
        docs = list(group_docs)
        group_chunks.clear()
        group_docs.clear()
        stats.mesh_rounds += 1
        wb = wire_bytes_per_round(d, bucket_cap)
        stats.shuffle_wire_bytes += wb
        with _a2a_span(stats, round=stats.mesh_rounds, tier="fast", wire_bytes=wb):
            local, p_ovf, b_ovf = fast[0](_ship(host, mesh), docs)
            # Merge dispatches at once: an overflowed group is empty on the
            # device, so merging before the counters reach the host is safe.
            # The host tensor stays pending for the rare replay.
            state, evicted, ev_counts = fast[1](state, local)
            pending.append((p_ovf, b_ovf, ev_counts, evicted, host, docs))
        groups_done += 1
        if (cfg.checkpoint_every_groups > 0
                and groups_done % cfg.checkpoint_every_groups == 0):
            drain(len(pending))  # the state must hold every submitted group
            # ...and so must the dictionary: a checkpointed count whose word
            # never reached the saved dictionary would resume unknown.
            while ingest.scans:
                ingest._fold_done(block=True)
            _write_ckpt(cfg, fingerprint, state, groups_done, acc, dictionary, stats)
        elif len(pending) >= 2 * depth:
            drain(depth)

    ingest = _IngestStream(cfg, inputs, stats, dictionary, app.host_mask,
                           lineage_range=app.partition_mode == "range",
                           skip_chunks=skip_chunks)
    try:
        for chunk in ingest:
            group_chunks.append(chunk.data)
            group_docs.append(chunk.doc_id)
            if len(group_chunks) == d:
                submit_group()
        if group_chunks:
            submit_group()
        drain(len(pending))
    except BaseException:
        ingest.close(abort=True)
        raise
    ingest.close()
    _finish_mesh_state(app, state, stats, acc)


def _stream_multihost(cfg: Config, app: App, inputs, stats: JobStats,
                      acc: HostAccumulator, dictionary) -> None:
    """The mesh pipeline over several processes (parallel/distributed.py):
    control stays on the coordinator's RPC plane, data rides
    ``torch.distributed`` collectives, and the shared work dir carries
    only egress artifacts (dictionary shards and partition files).

    Per process: ingest ONLY the inputs assigned to it (round-robin by
    global doc id), feed one chunk to each of its own shards per round,
    and run the same step functions every other process runs. Per-round
    decisions (replay? continue?) come back summed over every rank, so
    every process agrees without seeing another's shards. Rounds are in
    lockstep: a process whose inputs are exhausted keeps contributing
    space-padded groups until the summed have-data count reaches zero (a
    rank that left early would leave its peers stuck in a collective). At
    the end each process folds only its own state shards (its hash
    classes), publishes its dictionary shard, and merges everyone's — so a
    process can print words whose bytes only another process read."""
    from mapreduce_rust_tpu_torch.parallel.distributed import (
        process_count,
        process_index,
    )
    from mapreduce_rust_tpu_torch.parallel.shuffle import (
        default_bucket_cap,
        make_mesh,
        make_mh_shuffle_step_fns,
        sharded_empty_state,
        wire_bytes_per_round,
    )

    if cfg.checkpoint_every_groups or cfg.resume or cfg.sharded_stream:
        raise ValueError(
            "checkpoint/resume and sharded_stream are single-process features"
        )
    pid, nproc = process_index(), process_count()
    mesh = make_mesh(cfg.mesh_shape, cfg.device, world=nproc, rank=pid)
    d, d_local = mesh.size, mesh.d_local
    u_cap = cfg.effective_partial_capacity()
    bucket_cap = default_bucket_cap(u_cap, d, cfg.bucket_capacity_factor)
    fast = make_mh_shuffle_step_fns(app, u_cap, bucket_cap, mesh)
    state = sharded_empty_state(mesh, max(cfg.merge_capacity // d, 16))

    # Inputs round-robin by GLOBAL doc id, so inverted_index doc ids match
    # a single-process run over the same sorted listing.
    my_inputs = [(i, p) for i, p in enumerate(inputs) if i % nproc == pid]
    ingest = _IngestStream(
        cfg, [p for _i, p in my_inputs], stats, dictionary, app.host_mask,
        lineage_range=app.partition_mode == "range",
        doc_ids=[i for i, _p in my_inputs],
    )

    def run_round(host: torch.Tensor, docs: list, have: int) -> bool:
        nonlocal state
        stats.mesh_rounds += 1
        wb = wire_bytes_per_round(d, bucket_cap)
        stats.shuffle_wire_bytes += wb
        with _a2a_span(stats, round=stats.mesh_rounds, tier="fast", wire_bytes=wb):
            local, totals = fast[0](_ship(host, mesh), docs, have)
            state, evicted, ev_counts = fast[1](state, local)
        # ONE readback per round: the summed flags (every rank reads the
        # same) and this process's eviction counts.
        t0 = time.perf_counter()
        with trace_span("device.drain", steps=1):
            got = torch.cat([totals, ev_counts]).cpu().numpy()
        dt = time.perf_counter() - t0
        stats.device_wait_s += dt
        stats.record_hist("device.drain_s", dt)
        _sample_device_memory(stats)
        have_n, p_n, b_n = (int(x) for x in got[:3])
        if p_n > 0 or b_n > 0:
            # Every rank saw the same sums, so every rank replays together.
            if p_n > 0:
                stats.partial_overflow_replays += 1
                tier_cap = cfg.chunk_bytes
                fns = make_mh_shuffle_step_fns(app, tier_cap, tier_cap, mesh)
            else:
                stats.bucket_skew_replays += 1
                tier_cap = u_cap
                fns = make_mh_shuffle_step_fns(app, u_cap, u_cap, mesh)
            stats.mesh_rounds += 1
            wb = wire_bytes_per_round(d, tier_cap)
            stats.shuffle_wire_bytes += wb
            with _a2a_span(stats, round=stats.mesh_rounds, tier="replay",
                           wire_bytes=wb):
                local, _totals = fns[0](_ship(host, mesh), docs, have)
                state, evicted2, ev2 = fns[1](state, local)
            _replay_readback(stats, acc, evicted2, ev2)
        ev_n = int(got[3:].sum())
        if ev_n > 0:
            _spill_shards(stats, acc, evicted, ev_n)
        return have_n > 0

    it = iter(ingest)
    exhausted = False
    try:
        while True:
            rows: list[np.ndarray] = []
            docs: list[int] = []
            while not exhausted and len(rows) < d_local:
                try:
                    chunk = next(it)
                except StopIteration:
                    exhausted = True
                    break
                rows.append(chunk.data)
                docs.append(chunk.doc_id)
            have = 1 if rows else 0
            while len(rows) < d_local:  # pad this rank's share with spaces
                rows.append(np.full(cfg.chunk_bytes, 0x20, dtype=np.uint8))
                docs.append(0)
            if not run_round(_pinned(np.stack(rows), mesh), docs, have):
                break
    except BaseException:
        ingest.close(abort=True)
        raise
    ingest.close()
    for st in state:
        acc.add_batch(st)

    # Dictionary exchange over the shared work dir: each process publishes
    # its shard and a done marker, then merges everyone's (a shard may own
    # keys whose bytes only another process read). The names carry the
    # job fingerprint and the process count, so a leftover marker of
    # another job (or of the same inputs split over another number of
    # processes) can never satisfy, or break, the barrier; a leftover of
    # the same job holds the same shard. `clean` removes dict-*.
    fp = f"{_job_fingerprint(cfg, app, inputs, d)[:16]}-n{nproc}"

    def shard_path(proc: int) -> str:
        return os.path.join(cfg.work_dir, f"dict-proc-{proc}-{fp}.txt")

    os.makedirs(cfg.work_dir, exist_ok=True)
    tmp = shard_path(pid) + ".tmp"
    dictionary.save(tmp)
    os.replace(tmp, shard_path(pid))
    open(shard_path(pid) + ".done", "w").close()
    _await_shard_files(shard_path, nproc, cfg.multihost_barrier_timeout_s)
    for other in range(nproc):
        if other != pid:
            dictionary.merge(Dictionary.load(shard_path(other)))


def _await_shard_files(shard_path, nproc: int, timeout_s: float) -> None:
    """The dictionary-exchange barrier of the multi-process mesh: wait for
    every process's published shard and done marker. A peer that died
    before publishing cannot be waited out (its hash classes died with
    it), so the job fails promptly, naming every missing rank; the timeout
    is ``Config.multihost_barrier_timeout_s`` (a slow shared filesystem
    may need more than the default)."""
    deadline = time.monotonic() + timeout_s  # immune to wall-clock steps
    waiting = set(range(nproc))
    while waiting:
        waiting -= {
            other for other in waiting
            if os.path.exists(shard_path(other) + ".done")
            and os.path.exists(shard_path(other))
        }
        if not waiting:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"dictionary shards from process(es) {sorted(waiting)} never "
                f"arrived within {timeout_s:.0f}s (multihost_barrier_timeout_s)"
                " — peer death or a stalled shared work dir; results would be"
                " missing those hash classes, so the job fails instead."
                " Re-run the job."
            )
        time.sleep(0.05)


#: Chrome-trace categories of device activity in a torch.profiler trace.
DEVICE_TRACE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def _device_trace(profile_dir: "str | None", device: torch.device):
    """``Config.profile_dir``: a ``torch.profiler`` trace of the block,
    exported as a Chrome trace (``stream-p{pid}-{ns}.pt.trace.json``)
    into ``profile_dir`` when it exits, also on failure. No shapes and
    no stacks are recorded, so a long job's trace stays small.

    It records CPU activity, and CUDA activity (kernels, copies, sets)
    when ``device`` is a card. Kineto's device tracing covers the whole
    process, so every kernel of the job is in the trace, whichever
    thread launched it; CPU operators are recorded from the thread that
    entered the profiler (the consumer or router) only, so the host
    engine's merges show as kernels without the ``mr/dispatch``
    thread's operators. On a card the trace must hold device activity:
    a torch build that cannot record it (no CUPTI) raises before the job
    streams, and a trace that comes back without a device event raises
    after it, rather than passing off a CPU-only trace."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU]
    on_card = device.type == "cuda"
    if on_card:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "profile_dir: this torch build cannot record CUDA activity "
                "(no CUPTI); refusing to write a CPU-only device trace")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir,
                        f"stream-p{os.getpid()}-{time.time_ns()}.pt.trace.json")
    prof = profile(activities=activities, record_shapes=False, with_stack=False)
    try:
        with prof:
            yield
            if on_card:
                torch.cuda.synchronize(device)  # every kernel lands in the trace
    finally:
        prof.export_chrome_trace(path)
        log.info("device trace → %s", path)
    if on_card and not count_device_events(path):
        raise RuntimeError(
            f"profile_dir: {path} holds no CUDA activity; the profiler did "
            "not record the card")


def count_device_events(trace_path: str) -> int:
    """Device activity events (kernels, copies, sets) in a torch.profiler
    Chrome trace."""
    import json

    with open(trace_path) as f:
        events = json.load(f).get("traceEvents") or []
    return sum(1 for e in events if e.get("cat") in DEVICE_TRACE_CATS)


def run_job(
    cfg: Config,
    inputs: Sequence[str] | None = None,
    app: App | None = None,
    write_outputs: bool = True,
    corpus_bounds: Sequence[int] | None = None,
) -> JobResult:
    """Run one job end-to-end on ``cfg.device``; exact results.

    With ``inputs=None`` the corpora come from ``Config.corpora()``
    (``input_dirs``) and the flat doc_id space concatenates their sorted
    listings; a caller that passes ``inputs`` passes the matching
    ``corpus_bounds`` (resolve_corpora's) too.

    With a spill budget set (``host_accum_budget_mb``,
    ``dictionary_budget_words``) the tiers that pass it write sorted runs
    to ``work_dir`` and the job ends through the streaming merge-join
    egress (``_stream_finalize``), which delivers results only through the
    output files: ``JobResult.table`` is then empty. The run files are
    removed when the job ends, whether it succeeds or raises."""
    t0 = time.perf_counter()
    build_log_start = len(BUILD_LOG)
    device = select_device(cfg.device)
    app = app or WordCount()
    if inputs is None:
        inputs, auto_bounds, _names = resolve_corpora(cfg)
        if corpus_bounds is None:
            corpus_bounds = auto_bounds
    else:
        inputs = list(inputs)
    if not inputs:
        raise ValueError("no input files")
    from mapreduce_rust_tpu_torch.parallel.distributed import (
        process_count,
        process_index,
    )

    nproc = process_count()
    budgeted = (cfg.host_accum_budget_mb is not None
                or cfg.dictionary_budget_words is not None)
    if budgeted and (cfg.checkpoint_every_groups or cfg.resume or nproc > 1):
        # A checkpoint snapshots the accumulator and dictionary in RAM, and
        # the ranks' dictionary exchange is of whole in-RAM shards.
        raise ValueError(
            "egress budgets are incompatible with checkpoint/resume and "
            "multi-process runs"
        )
    if budgeted and not write_outputs:
        # The streaming egress delivers results only through output files:
        # without them a budgeted run would compute everything and return
        # an empty table.
        raise ValueError("egress budgets require write_outputs=True")

    # Sanitize-aware construction (analysis/sanitize.py): plain instances
    # unless Config.sanitize / MR_SANITIZE=1, in which case cross-thread
    # writes to stats or dictionary raise at the write site.
    from mapreduce_rust_tpu_torch.analysis.sanitize import (
        new_dictionary,
        new_job_stats,
    )

    stats = new_job_stats(cfg)
    # Bind corpus bounds and, for range apps, sampled splitters onto the
    # app before anything streams (reference driver.py:2916-2922): a join
    # with one corpus fails here, and every engine routes identically.
    app = prepare_app(app, cfg, inputs, corpus_bounds or (), stats=stats)
    # A killed job's remove_runs never ran: reclaim the run files whose
    # writer pid is gone before this job's own tiers exist.
    spill_io.scavenge_stale_runs(cfg.work_dir, logger=log)
    acc = HostAccumulator(
        app.combine_op,
        budget_bytes=(cfg.host_accum_budget_mb << 20
                      if cfg.host_accum_budget_mb is not None else None),
        spill_dir=cfg.work_dir, async_spill=cfg.spill_async,
    )
    # The host-map engine splits the dictionary into key-hash-disjoint
    # shards, one per fold thread; the device engine and the meshes (which
    # tokenize on the device whatever map_engine says, checkpoint a plain
    # Dictionary, or exchange per-process shards) fold on their consumer.
    # The word budget splits across the shards, so it bounds the job, not
    # each shard.
    mesh = bool(cfg.mesh_shape and cfg.mesh_shape > 1)
    fold_shards = (cfg.effective_fold_shards()
                   if cfg.map_engine == "host" and not mesh and nproc == 1 else 1)
    if fold_shards > 1:
        per_shard = (max(1, cfg.dictionary_budget_words // fold_shards)
                     if cfg.dictionary_budget_words is not None else None)
        dictionary = ShardedDictionary([
            new_dictionary(cfg, budget_words=per_shard, spill_dir=cfg.work_dir,
                           async_spill=cfg.spill_async)
            for _ in range(fold_shards)
        ])
    else:
        dictionary = new_dictionary(
            cfg, budget_words=cfg.dictionary_budget_words,
            spill_dir=cfg.work_dir, async_spill=cfg.spill_async)
    tracer = start_tracing(tag="driver") if cfg.trace_path else None
    if tracer is not None:
        # Flight recorder: the stream loops tick maybe_snapshot() per
        # chunk/window, so a killed driver still leaves an atomic
        # *.partial.json that trace merge accepts.
        tracer.enable_flight_recorder(partial_path(cfg.trace_path),
                                      period_s=cfg.flight_record_period_s)
    # Live metrics: the registry pulls JobStats aggregates into its ring
    # when the loops that tick the flight recorder call metrics_tick();
    # build_manifest serializes it as stats.timeseries.
    registry = None
    if cfg.metrics_enabled:
        registry = start_metrics(cfg.metrics_sample_period_s,
                                 cfg.metrics_ring_points)
        registry.add_collector(jobstats_collector(stats))
        if tracer is not None:
            tracer.metrics_registry = registry  # partials keep the series
    # Sampling profiler: one thread walks sys._current_frames() at
    # profile_hz, collapsed stacks keyed by the mr/ plane-thread names.
    # Observational only — outputs stay byte-identical on and off. Lands
    # in the manifest as stats.profile (build_manifest reads the
    # still-active profiler).
    sprof = None
    if cfg.profile or profile_forced():
        from mapreduce_rust_tpu_torch.runtime.prof import start_profiler

        sprof = start_profiler(cfg.profile_hz)
        if tracer is not None:
            tracer.profiler = sprof  # partials keep the flamegraph
            sprof.tracer = tracer    # per-plane self-time counter tracks
    # Provenance ledger: per-chunk content digests + partition routing
    # recorded from the loops that tick the flight recorder. Observational
    # only. Lands in the manifest as stats.lineage (build_manifest reads
    # the still-active ledger) and in partials as body["lineage"].
    ledger = None
    if cfg.lineage or lineage_forced():
        from mapreduce_rust_tpu_torch.runtime.lineage import (
            LEDGER_NAME,
            start_ledger,
        )

        os.makedirs(cfg.work_dir, exist_ok=True)
        ledger = start_ledger(os.path.join(cfg.work_dir, LEDGER_NAME),
                              inputs=inputs, reduce_n=cfg.reduce_n)
        if tracer is not None:
            tracer.lineage = ledger  # partials keep the provenance tail
    table: dict = {}
    output_files: list[str] = []

    try:
        # The device trace wraps the stream phase, so its export is not
        # counted in the phase's seconds.
        with _device_trace(cfg.profile_dir, device), stats.phase("stream"):
            if mesh and cfg.map_engine == "host":
                log.warning(
                    "map_engine='host' applies to the single-device driver only; "
                    "mesh runs tokenize on the device (the mesh IS the map engine)"
                )
            if nproc > 1:
                _stream_multihost(cfg, app, inputs, stats, acc, dictionary)
            elif mesh and cfg.sharded_stream:
                _stream_sharded(cfg, app, inputs, stats, acc, dictionary)
            elif mesh:
                _stream_mesh(cfg, app, inputs, stats, acc, dictionary)
            elif cfg.map_engine == "host":
                _stream_host_map(cfg, app, inputs, stats, acc, dictionary, device)
            else:
                _stream_single(cfg, app, inputs, stats, acc, dictionary,
                               device=device)

        spilled = acc.has_runs or dictionary.spilled
        streaming = spilled and type(app).finalize is App.finalize
        if spilled and not streaming:
            log.warning(
                "app %s overrides finalize — rehydrating spilled egress tiers "
                "into RAM (exact, but unbounded)", app.name
            )
        if streaming:
            table, output_files = {}, _stream_finalize(cfg, app, stats, acc, dictionary)
        else:
            # Several processes: each writes ITS hash classes' lines under a
            # process-suffixed name; `merge` reads them all (for top_k,
            # App.merge_lines is the cross-process selection).
            suffix = f".p{process_index()}" if nproc > 1 else ""
            table, output_files = _ram_finalize(cfg, app, stats, acc, dictionary,
                                                write_outputs, suffix)
        stats.wall_seconds = time.perf_counter() - t0
        log.info("job %s done: %s", app.name, stats.summary())
    finally:
        # A failed run still gets its real wall time: its manifest is
        # written too, and a 0.0 s crashed run would corrupt comparisons.
        if not stats.wall_seconds:
            stats.wall_seconds = time.perf_counter() - t0
        _fold_builds(stats, tracer, build_log_start)
        # Run files are job-scoped scratch: their counts survive in the
        # stats as the proof the disk tiers engaged. remove_runs joins
        # every writer, so the collection below reads final counters.
        stats.accum_spill_runs = acc.run_count
        stats.dict_spill_runs = dictionary.run_count
        acc.remove_runs()
        dictionary.remove_runs()
        _collect_spill_stats(stats, dictionary, acc)
        if sprof is not None:
            # Freeze sampling before the artifact flush: the profile
            # covers the job, not manifest serialization. The stopped
            # profiler stays in the global slot so build_manifest embeds
            # its final aggregate.
            sprof.stop()
        if ledger is not None:
            # Seal the jsonl (end record: folded corpus content digest)
            # before the flush; the closed ledger stays in the global
            # slot so build_manifest embeds stats.lineage.
            try:
                ledger.close()
            except Exception:
                log.warning("lineage ledger close failed", exc_info=True)
        if tracer is not None:
            stop_tracing()
        if tracer is not None or cfg.manifest_path:
            # Written even on failure (with an "error" field): a crashed
            # run's manifest names what ran. Best-effort — telemetry must
            # never mask the job's real exception.
            import sys as _sys

            from mapreduce_rust_tpu_torch.runtime.telemetry import (
                flush_run_artifacts,
            )

            exc = _sys.exc_info()[1]
            extra = {"error": repr(exc)} if exc is not None else {}
            if stats.merge_dispatches:
                # Per-dispatch merge cost for the roofline's device-merge
                # row; telemetry stays best-effort.
                try:
                    extra["merge_cost"] = _merge_cost_analysis(app, cfg)
                except Exception:
                    log.warning("merge cost analysis failed", exc_info=True)
            if device.type == "cuda":
                # The scan kernel's launches in this process: the evidence
                # that the job's map ran on the card (a worker's manifest
                # carries the same field).
                from mapreduce_rust_tpu_torch.ops.tokenize_cuda import tokenize_hash

                extra["kernel_launches"] = {"tokenize_hash": tokenize_hash.launches}
            tag = None
            if nproc > 1:
                from mapreduce_rust_tpu_torch.parallel.distributed import cluster_info

                extra["cluster"] = cluster_info(cfg.mesh_shape)
                # Per-process file names, like the .p{rank} outputs:
                # co-hosted ranks must not clobber each other's files.
                tag = f"p{process_index()}"
            flush_run_artifacts(
                cfg, tracer, tag=tag, logger=log, stats=stats, app_name=app.name,
                inputs=inputs, output_files=output_files, extra=extra or None,
            )
        if registry is not None:
            # After the flush (build_manifest read the still-active ring);
            # compare-and-clear, a co-hosted worker may own the slot now.
            stop_metrics(registry)
        if sprof is not None:
            # Same order and compare-and-clear discipline as the registry.
            from mapreduce_rust_tpu_torch.runtime.prof import stop_profiler

            stop_profiler(sprof)
        if ledger is not None:
            from mapreduce_rust_tpu_torch.runtime.lineage import stop_ledger

            stop_ledger(ledger)
    return JobResult(stats=stats, table=table, output_files=output_files)


def _fold_builds(stats: JobStats, tracer, start: int) -> None:
    """Fold the kernel-build records made since ``start``, the job's own
    start (ops/cuda_build.BUILD_LOG), into the stats: count, seconds, the
    hit/miss split and the ``kernel.build_s`` histogram, which the
    manifest writes as its "compile" block. Under a tracer each record
    becomes a ``kernel.build`` span on a track of its own."""
    for rec in BUILD_LOG[start:]:
        stats.compile_count += 1
        stats.compile_s += rec["dur_s"]
        if rec["cache"] == "hit":
            stats.compile_cache_hits += 1
        else:
            stats.compile_cache_misses += 1
        stats.record_hist("kernel.build_s", rec["dur_s"])
        if tracer is not None:
            tracer.add_span("kernel.build", rec["t0"], rec["t1"],
                            {"tool": rec["tool"], "source": rec["source"],
                             "cache": rec["cache"], "seconds": round(rec["dur_s"], 3)},
                            tid=_BUILD_TRACK_TID)


def _ram_finalize(cfg: Config, app: App, stats: JobStats, acc: HostAccumulator,
                  dictionary, write_outputs: bool,
                  suffix: str = "") -> tuple[dict, list[str]]:
    """The in-RAM egress: one (word, value) item per key through
    ``app.finalize``; returns the word → value table and the output files
    ``mr-{r}{suffix}.txt``.
    A spilled dictionary (an app that overrides finalize, like top_k) is
    rehydrated once from its sorted stream — exact, but unbounded."""
    ledger = active_ledger()
    table: dict = {}
    output_files: list[str] = []
    with stats.phase("finalize"):
        stats.distinct_keys = len(acc.table)
        stats.dictionary_words = len(dictionary)
        stats.hash_collisions = len(dictionary.collisions)
        items = []
        is_distinct = app.combine_op == "distinct"
        lookup = dictionary.lookup
        if dictionary.spilled:
            full = {(k1, k2): w for _p, k1, k2, w in dictionary.iter_sorted()}
            lookup = lambda k1, k2: full.get((k1, k2))  # noqa: E731
        for key, v in acc.table.items():
            word = lookup(*key)
            if word is None:
                stats.unknown_keys += 1
                continue
            value = sorted(v) if is_distinct else v
            items.append((word, value, key))
            table[word] = value

    with stats.phase("egress"):
        parts = app.finalize(items, cfg.reduce_n)
        if write_outputs:
            os.makedirs(cfg.output_dir, exist_ok=True)
            for r in range(cfg.reduce_n):
                path = os.path.join(cfg.output_dir, f"mr-{r}{suffix}.txt")
                written = 0
                with open(path, "wb") as f:
                    for line in parts.get(r, []):
                        f.write(line + b"\n")
                        written += len(line) + 1
                # Per-partition output bytes: the reduce-side skew signal.
                stats.partition_bytes.append(written)
                if ledger is not None:
                    # Egress claim: partition r's bytes + the chunks whose
                    # routed keys contributed.
                    ledger.record_partition(r, written)
                output_files.append(path)
    return table, output_files


def _stream_finalize(cfg: Config, app: App, stats: JobStats, acc: HostAccumulator,
                     dictionary) -> list[str]:
    """Bounded-memory egress (reference ``driver.py:3219-3375``): one
    merge-join of the accumulator's sorted fold against the dictionary's
    sorted word stream, routed into per-partition line files, each sorted
    on its own at the end. Peak RAM is O(fold rows + one partition's
    lines), never O(vocabulary) of Python objects.

    The dictionary's sources (every run, every shard, the RAM tiers;
    key-disjoint) merge in key blocks through the native loser tree, and
    each block joins the fold with one ``searchsorted`` over the fold's
    packed keys. All three key columns — the fold rows packed as
    ``uint64 (k1<<32)|k2``, the runs' key column and the merge's output —
    are unsigned, so they sort alike. Implements the default egress
    contract (``app.route_block``, ``app.emit_lines``, bytewise sort per
    partition); run_job takes the in-RAM path for apps that override
    ``App.finalize``."""
    import shutil
    import tempfile

    ledger = active_ledger()
    with stats.phase("finalize"):
        rows = acc.fold_arrays()  # sorted by (k1, k2[, value])
        is_distinct = app.combine_op == "distinct"
        packed_rows = _pack_key_cols(rows[:, :2])
        n = len(rows)
        if is_distinct:
            key_change = np.empty(n, dtype=bool)
            if n:
                key_change[0] = True
                key_change[1:] = packed_rows[1:] != packed_rows[:-1]
            stats.distinct_keys = int(key_change.sum())
        else:
            stats.distinct_keys = n
        stats.dictionary_words = len(dictionary)
        stats.hash_collisions = len(dictionary.collisions)

    with stats.phase("egress"):
        os.makedirs(cfg.output_dir, exist_ok=True)
        tmpdir = tempfile.mkdtemp(prefix="egress-", dir=cfg.output_dir)
        # One try/finally spans the merge-join and the per-partition sort,
        # so a failure in either still removes the part files.
        try:
            parts = [open(os.path.join(tmpdir, f"part-{r}"), "wb")
                     for r in range(cfg.reduce_n)]
            matched = 0
            try:
                sources = dictionary.run_sources()
                stats.merge_fanin = len(sources)
                for keys_b, src_b, idx_b in spill_io.merge_sources(sources):
                    ends_g = None
                    if n:
                        pos = np.searchsorted(packed_rows, keys_b)
                        posc = np.minimum(pos, n - 1)
                        hit = (pos < n) & (packed_rows[posc] == keys_b)
                        if is_distinct:
                            # Fold rows repeat per (key, value): each
                            # group's exclusive end.
                            ends_g = np.searchsorted(packed_rows, keys_b, side="right")
                    else:
                        hit = np.zeros(len(keys_b), dtype=bool)
                    hits = np.nonzero(hit)[0]
                    if not len(hits):
                        continue  # dictionary words absent from the fold
                    # Word bytes only for keys the fold holds.
                    words = spill_io.slice_block_words(sources, src_b[hits], idx_b[hits])
                    rr = app.route_block(
                        words, (keys_b[hits] >> np.uint64(32)).astype(np.int64),
                        cfg.reduce_n)
                    pos_h = pos[hits]
                    emit = app.emit_lines
                    # One buffered write per (block, partition).
                    blk_lines: list[list] = [[] for _ in range(cfg.reduce_n)]
                    if is_distinct:
                        for w, r, i, j in zip(words, rr, pos_h.tolist(),
                                              ends_g[hits].tolist()):
                            blk_lines[r].extend(emit(w, sorted(rows[i:j, 2].tolist())))
                    else:
                        for w, r, v in zip(words, rr, rows[pos_h, 2].tolist()):
                            blk_lines[r].extend(emit(w, v))
                    for r, ls in enumerate(blk_lines):
                        if ls:
                            parts[r].write(b"\n".join(ls) + b"\n")
                    matched += len(hits)
            finally:
                for f in parts:
                    f.close()
            stats.unknown_keys = stats.distinct_keys - matched

            output_files: list[str] = []
            for r in range(cfg.reduce_n):
                with open(os.path.join(tmpdir, f"part-{r}"), "rb") as f:
                    lines = f.read().splitlines()
                lines.sort()
                buf = b"\n".join(lines) + b"\n" if lines else b""
                stats.partition_bytes.append(len(buf))
                if ledger is not None:
                    # Egress claim, streaming tier: same contract as the
                    # in-RAM path's record_partition.
                    ledger.record_partition(r, len(buf))
                path = os.path.join(cfg.output_dir, f"mr-{r}.txt")
                with open(path, "wb") as f:
                    f.write(buf)
                output_files.append(path)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return output_files


def _publish_spill_live(stats: JobStats, dictionary, acc) -> None:
    """Per-window live publication of the running spill totals (router
    thread): the writers' float cells are benign-stale at worst, so the
    live ring sees a spill-bound job during the run. Exact finals land in
    _collect_spill_stats at teardown."""
    total_w = total_st = 0.0
    total_b = 0
    seen = False
    for tier in (dictionary, acc):
        snap = tier.spill_snapshot()
        if snap is None:
            continue
        seen = True
        total_w += snap[0]
        total_st += snap[1]
        total_b += snap[2]
    if seen:
        stats.spill_s = total_w
        stats.spill_stall_s = total_st
        stats.spill_bytes = total_b


def _collect_spill_stats(stats: JobStats, dictionary, acc: HostAccumulator) -> None:
    """Fold the spill writers' final tallies into JobStats — run_job's
    thread only, after remove_runs joined the writers. The per-run
    write_s histograms merge into one ``spill.write_s`` distribution."""
    d = dictionary.spill_stats()
    a = acc.spill_stats()
    stats.spill_s = d["write_s"] + a["write_s"]
    stats.spill_stall_s = d["stall_s"] + a["stall_s"]
    stats.spill_bytes = d["bytes"] + a["bytes"]
    for h in (d["hist"], a["hist"]):
        if h is not None and h.count:
            stats.hists.setdefault("spill.write_s", Histogram()).merge(h)


def merge_outputs(output_files: Sequence[str], out_path: str) -> None:
    """`cat mr-* | sort > final.txt` (reference src/run.sh:17-21)."""
    lines: list[bytes] = []
    for path in output_files:
        with open(path, "rb") as f:
            lines.extend(f.read().splitlines())
    lines.sort()
    with open(out_path, "wb") as f:
        for line in lines:
            f.write(line + b"\n")
