"""Spill runs on disk: the run format, the async writers, the k-way merge.

The port of ``mapreduce_rust_tpu/runtime/spill.py`` (no jax there either),
without its ``slow_disk`` chaos checkpoint, which comes with the chaos
slice. Three layers:

- **Run format** — a spill run is a 40-byte header (magic ``MRSP``,
  schema version, run token, key count, length-section bytes, collision
  count), a SORTED packed-uint64 key column, LEB128 varint word lengths
  and the concatenated word bytes. The merge memory-maps the key column
  and touches word bytes only for keys the egress join matches.
  Accumulator runs are ``.npy`` files of sorted, deduped [n, 3] rows.

- **AsyncSpillWriter** — one bounded background writer thread per
  spilling tier (each dictionary shard, the host accumulator): the owner
  freezes a snapshot, enqueues it and keeps going while the writer sorts,
  packs and writes it. A dead writer keeps draining its queue so the
  bounded ``submit`` never deadlocks, its error re-raises on the owner
  thread, and ``close(abort=True)`` never blocks. ``MR_SPILL_SYNC=1`` (or
  ``Config.spill_async=False``) runs every task inline at submit.

- **k-way merge** — ``merge_sources`` yields (keys, src, idx) BLOCKS,
  globally sorted by packed key, over key-disjoint sorted sources (disk
  runs, RAM tiers, every shard at once). More than one live source goes
  through the native loser tree (``native/host.merge_runs_stream``); a
  native library that fails to build or load raises, there is no other
  merge. The egress merge-join and ``Dictionary.iter_sorted`` are built
  on it.
"""

from __future__ import annotations

import os
import queue
import re
import threading
import time

import numpy as np

from mapreduce_rust_tpu_torch.runtime.histogram import Histogram

#: Run-format identity: the header magic + schema version every reader
#: checks before trusting a byte.
RUN_MAGIC = b"MRSP"
RUN_VERSION = 1
#: The run format a manifest's spill_split names.
RUN_FORMAT = f"binary-v{RUN_VERSION}"
_HEADER_BYTES = 40

#: Merge block size: large enough that the per-block Python overhead
#: (searchsorted + mask) amortizes, small enough that a block's scratch
#: stays cache-resident. The merge is O(block) memory regardless of the
#: total key count.
DEFAULT_BLOCK = 1 << 16

_TRUTHY = ("1", "true", "on", "yes")


def sync_spill_forced() -> bool:
    """``MR_SPILL_SYNC`` — process-tree opt-out of the async writer: every
    spill run is written inline on its owner thread."""
    return os.environ.get("MR_SPILL_SYNC", "").strip().lower() in _TRUTHY


# ---------------------------------------------------------------------------
# Vectorized LEB128 varints (word lengths; save-container collision records)
# ---------------------------------------------------------------------------

def encode_varints(values) -> bytes:
    """LEB128-encode an array of unsigned ints — vectorized over GROUPS
    (≤10 rounds for uint64), never over values: word lengths are almost
    always single-byte, so round 1 handles the whole array at once."""
    v = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    n = len(v)
    if n == 0:
        return b""
    ngroups = np.ones(n, dtype=np.int64)
    x = v >> np.uint64(7)
    while x.any():
        ngroups += x > 0
        x >>= np.uint64(7)
    ends = np.cumsum(ngroups)
    starts = ends - ngroups
    out = np.zeros(int(ends[-1]), dtype=np.uint8)
    rem = v.copy()
    active = np.arange(n)
    g = 0
    while len(active):
        byte = (rem[active] & np.uint64(0x7F)).astype(np.uint8)
        more = ngroups[active] > (g + 1)
        out[starts[active] + g] = byte | (more.astype(np.uint8) << 7)
        rem[active] >>= np.uint64(7)
        active = active[more]
        g += 1
    return out.tobytes()


def decode_varints(buf, count: int) -> np.ndarray:
    """Decode exactly ``count`` LEB128 varints from ``buf`` — vectorized:
    terminator bytes (MSB clear) delimit groups, per-byte shifts come from
    the group starts, and ``np.add.reduceat`` folds the 7-bit limbs (the
    limbs are bit-disjoint, so add == or). Raises ValueError on a
    truncated or miscounted section — a torn run must fail loudly."""
    data = np.frombuffer(buf, dtype=np.uint8) if not isinstance(
        buf, np.ndarray) else buf.astype(np.uint8, copy=False)
    if count == 0:
        if len(data):
            raise ValueError("varint section: trailing bytes after 0 values")
        return np.zeros(0, dtype=np.uint64)
    term = (data & 0x80) == 0
    term_pos = np.nonzero(term)[0]
    if len(term_pos) != count or (len(data) and not term[-1]):
        raise ValueError(
            f"varint section: {len(term_pos)} terminators for {count} values"
        )
    group_start = np.empty(count, dtype=np.int64)
    group_start[0] = 0
    group_start[1:] = term_pos[:-1] + 1
    gid = np.zeros(len(data), dtype=np.int64)
    gid[1:] = np.cumsum(term[:-1])
    shift = ((np.arange(len(data)) - group_start[gid]) * 7).astype(np.uint64)
    contrib = (data.astype(np.uint64) & np.uint64(0x7F)) << shift
    return np.add.reduceat(contrib, group_start)


# ---------------------------------------------------------------------------
# Run files
# ---------------------------------------------------------------------------

class RunSource:
    """One sorted key-disjoint merge source: a memory-mapped disk run or a
    packed RAM tier. ``keys`` is the sorted packed-uint64 column, ``ends``
    the exclusive word-byte end offsets, ``data`` the concatenated word
    bytes (bytes for RAM tiers, a memmap slice for disk runs — sliced
    lazily, only for keys the join actually matches)."""

    __slots__ = ("keys", "ends", "data", "path", "collisions")

    def __init__(self, keys, ends, data, path=None, collisions=()):
        self.keys = keys
        self.ends = ends
        self.data = data
        self.path = path
        self.collisions = list(collisions)

    def __len__(self) -> int:
        return len(self.keys)

    def word(self, i: int) -> bytes:
        s = int(self.ends[i - 1]) if i else 0
        w = self.data[s:int(self.ends[i])]
        return w if isinstance(w, bytes) else bytes(w)


def pack_word_map(word_of: dict) -> tuple:
    """(sorted packed keys uint64[n], ends int64[n], word bytes) of a
    ``{(k1, k2): word}`` map — the vectorized ``np.argsort`` that replaces
    the Python ``sorted()`` over dict items in the flush path. Shared by
    the run writer and the RAM-tier merge source, so the on-disk order and
    the in-RAM order can never disagree."""
    n = len(word_of)
    if n == 0:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int64), b"")
    packed = np.fromiter(
        ((k1 << 32) | k2 for (k1, k2) in word_of.keys()),
        dtype=np.uint64, count=n,
    )
    lens = np.fromiter((len(w) for w in word_of.values()),
                       dtype=np.int64, count=n)
    order = np.argsort(packed, kind="stable")
    words = list(word_of.values())
    buf = b"".join(words[i] for i in order.tolist())
    return packed[order], np.cumsum(lens[order]), buf


def _pack_header(token: str, n: int, lens_bytes: int, n_collisions: int) -> bytes:
    head = np.zeros(_HEADER_BYTES, dtype=np.uint8)
    head[0:4] = np.frombuffer(RUN_MAGIC, dtype=np.uint8)
    head[4:6] = np.frombuffer(
        np.uint16(RUN_VERSION).tobytes(), dtype=np.uint8)
    tok = token.encode()[:8].ljust(8, b"\0")
    head[8:16] = np.frombuffer(tok, dtype=np.uint8)
    head[16:40] = np.frombuffer(
        np.asarray([n, lens_bytes, n_collisions], dtype="<u8").tobytes(),
        dtype=np.uint8,
    )
    return head.tobytes()


def pack_header_for_save(token: str, n: int, lens_bytes: int,
                         n_collisions: int) -> bytes:
    """The container header for streaming writers (Dictionary.save pipes
    the sections itself so word bytes never materialize whole)."""
    return _pack_header(token, n, lens_bytes, n_collisions)


def write_run_container(f, token: str, keys, ends, buf: bytes,
                        collisions=()) -> int:
    """Write one run/save container to an open binary file; returns bytes
    written. ``keys`` must already be sorted ascending (pack_word_map's
    contract). Spill runs carry no collision records — a dictionary keeps
    its collisions in RAM (the flush never clears ``Dictionary.collisions``);
    the section exists for the reference's save containers, which share
    the format."""
    keys = np.ascontiguousarray(keys, dtype="<u8")
    n = len(keys)
    lens = np.diff(np.asarray(ends, dtype=np.int64), prepend=np.int64(0))
    lens_b = encode_varints(lens)
    coll_parts = []
    for kept, rejected in collisions:
        coll_parts.append(encode_varints(np.asarray([len(kept)])))
        coll_parts.append(kept)
        coll_parts.append(encode_varints(np.asarray([len(rejected)])))
        coll_parts.append(rejected)
    written = 0
    for part in (_pack_header(token, n, len(lens_b), len(collisions)),
                 keys.tobytes(), lens_b, buf, *coll_parts):
        f.write(part)
        written += len(part)
    return written


def write_run_file(path: str, token: str, keys, ends, buf: bytes,
                   run_index: int = 0, collisions=()) -> int:
    """Atomic (tmp + rename) run write — the writer-thread task body.
    Returns bytes written. The seeded ``slow_disk`` chaos site fires here:
    one injection point covers every spill tier."""
    _chaos_slow_disk(run_index)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        written = write_run_container(f, token, keys, ends, buf, collisions)
    os.replace(tmp, path)
    return written


def write_npy_run(path: str, rows: np.ndarray, run_index: int = 0) -> int:
    """Atomic accumulator-run write (sorted deduped [n,3] rows, .npy) —
    the accumulator writer's task body, behind the same chaos site.
    Returns bytes written."""
    _chaos_slow_disk(run_index)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, rows)
    size = os.path.getsize(tmp)
    os.replace(tmp, path)
    return size


def read_run_header(mm) -> tuple:
    """(n, lens_bytes, n_collisions) after validating magic + version.
    An unknown version is a LOUD exit path, never a silent misparse —
    the schema field exists so a future format can migrate instead."""
    if len(mm) < _HEADER_BYTES:
        raise ValueError("spill run: truncated header")
    if bytes(mm[0:4]) != RUN_MAGIC:
        raise ValueError("spill run: bad magic (not a binary spill run)")
    version = int(np.frombuffer(mm, dtype="<u2", count=1, offset=4)[0])
    if version != RUN_VERSION:
        raise ValueError(
            f"spill run: unsupported schema version {version} "
            f"(this build reads v{RUN_VERSION})"
        )
    n, lens_bytes, n_coll = np.frombuffer(
        mm, dtype="<u8", count=3, offset=16).tolist()
    return int(n), int(lens_bytes), int(n_coll)


def read_run_file(path: str) -> RunSource:
    """Memory-map one binary run: the key column and word bytes stay on
    disk (the OS pages them); only the varint lengths decode eagerly into
    the offsets the merge needs."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    n, lens_bytes, n_coll = read_run_header(mm)
    keys_off = _HEADER_BYTES
    lens_off = keys_off + 8 * n
    words_off = lens_off + lens_bytes
    keys = np.frombuffer(mm, dtype="<u8", count=n, offset=keys_off)
    lens = decode_varints(
        np.frombuffer(mm, dtype=np.uint8, count=lens_bytes, offset=lens_off),
        n,
    )
    ends = np.cumsum(lens.astype(np.int64))
    total = int(ends[-1]) if n else 0
    data = mm[words_off:words_off + total]
    collisions = []
    if n_coll:
        pos = words_off + total
        raw = bytes(mm[pos:])
        o = 0
        for _ in range(n_coll):
            ln, o = _read_one_varint(raw, o)
            kept = raw[o:o + ln]
            o += ln
            ln, o = _read_one_varint(raw, o)
            rejected = raw[o:o + ln]
            o += ln
            collisions.append((kept, rejected))
    return RunSource(keys, ends, data, path=path, collisions=collisions)


def _read_one_varint(raw: bytes, o: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = raw[o]
        o += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, o
        shift += 7


# ---------------------------------------------------------------------------
# k-way merge over key-disjoint sorted sources
# ---------------------------------------------------------------------------

def merge_sources(sources, block: int = DEFAULT_BLOCK):
    """Yield ``(keys uint64[b], src int32[b], idx int64[b])`` blocks,
    globally sorted by packed key, over key-disjoint sorted sources.
    ``src``/``idx`` index into the CALLER's sources list — empty sources
    keep their slot so the indices never shift. One live source is sliced
    in place; more go through the native loser tree (O(block) memory over
    memory-mapped key columns), which raises if the native library cannot
    be built or loaded."""
    key_arrays = [np.ascontiguousarray(s.keys, dtype=np.uint64)
                  for s in sources]
    live = [i for i, a in enumerate(key_arrays) if len(a)]
    if not live:
        return
    if len(live) == 1:
        i = live[0]
        a = key_arrays[i]
        for start in range(0, len(a), block):
            end = min(start + block, len(a))
            yield (a[start:end].copy(),
                   np.full(end - start, i, dtype=np.int32),
                   np.arange(start, end, dtype=np.int64))
        return
    from mapreduce_rust_tpu_torch.native.host import merge_runs_stream

    yield from merge_runs_stream(key_arrays, block)


def slice_block_words(sources, src, idx) -> list:
    """Word bytes for one merged block's (src, idx) rows, in row order —
    the batched slicer shared by the egress join and the streaming save:
    per source, the byte ranges come out of ONE vectorized offsets pass
    (and one contiguous bytes() copy for memory-mapped runs, legal
    because idx is ascending per source within a block) instead of a
    method call + numpy scalar indexing per word."""
    words: list = [None] * len(src)
    for s in np.unique(src).tolist():
        sel = np.nonzero(src == s)[0]
        source = sources[s]
        ii = idx[sel]
        ends_arr = source.ends
        starts = np.where(ii > 0, ends_arr[ii - 1], 0)
        ends_i = ends_arr[ii]
        data = source.data
        base = 0
        if not isinstance(data, bytes) and len(ii):
            base = int(starts[0])
            data = bytes(memoryview(data[base:int(ends_i[-1])]))
        for o, s0, e0 in zip(sel.tolist(), (starts - base).tolist(),
                             (ends_i - base).tolist()):
            words[o] = data[s0:e0]
    return words


def iter_sources_sorted(sources, block: int = DEFAULT_BLOCK):
    """(packed, k1, k2, word) tuples in ascending packed-key order — the
    legacy ``iter_sorted`` surface, generated from the block merge so the
    per-tuple and the batched consumers can never disagree on order."""
    for keys, src, idx in merge_sources(sources, block):
        for packed, s, i in zip(keys.tolist(), src.tolist(), idx.tolist()):
            yield (packed, packed >> 32, packed & 0xFFFFFFFF,
                   sources[s].word(i))


# ---------------------------------------------------------------------------
# Async writer
# ---------------------------------------------------------------------------

class SpillWriterError(RuntimeError):
    """Re-raise wrapper is NOT used — the original exception surfaces
    verbatim on the owner thread (fold-plane doctrine); this type exists
    only for the poisoned-without-error impossibility."""


class AsyncSpillWriter:
    """One background thread writing spill runs off the fold/consumer hot
    path, double-buffered: at most ``depth`` frozen snapshots in flight,
    so memory stays O(depth × budget) while the owner keeps scanning.

    Failure containment (the fold plane's pattern): a task that raises
    records its error, flips the poison flag and the loop keeps DRAINING
    the queue — the owner's bounded ``submit`` can therefore never
    deadlock against a dead writer; the recorded error re-raises on the
    owner thread at the next ``submit``/``drain``. ``close(abort=True)``
    (exception-path teardown) forces the sentinel past a full queue by
    displacing entries and never blocks forever.

    ``sync=True`` (or ``MR_SPILL_SYNC=1``) executes every task inline at
    submit — the legacy synchronous plane, same accounting, no thread.
    """

    _SENTINEL = object()

    def __init__(self, name: str = "mr/spill", depth: int = 2,
                 sync: bool = False) -> None:
        self.sync = bool(sync) or sync_spill_forced()
        self.write_s = 0.0        # writer-thread seconds inside tasks
        self.stall_s = 0.0        # owner-thread seconds blocked on submit
        self.bytes_written = 0
        self.runs_written = 0
        self.hist = Histogram()   # per-run write_s distribution
        self.error: "BaseException | None" = None
        self._poisoned = threading.Event()
        self._closed = False
        if self.sync:
            self._q = None
            self._thread = None
            return
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    # ---- writer thread ----

    def _run_task(self, task) -> None:
        t0 = time.perf_counter()
        written = task()
        dt = time.perf_counter() - t0
        self.write_s += dt
        self.hist.add(dt)
        self.bytes_written += int(written or 0)
        self.runs_written += 1

    def _loop(self) -> None:
        q = self._q
        while True:
            task = q.get()
            try:
                if task is self._SENTINEL:
                    return
                if not self._poisoned.is_set():
                    try:
                        self._run_task(task)
                    except BaseException as e:
                        # Error recorded BEFORE task_done (the finally):
                        # drain()'s q.join() may wake at that task_done,
                        # and it must observe the error — a failed final
                        # run that drained "clean" would surface later as
                        # a FileNotFoundError instead of the real cause.
                        # Poisoned, the loop keeps consuming (discarding)
                        # until the sentinel, so the owner's bounded put
                        # can never deadlock against a dead writer.
                        self.error = e
                        self._poisoned.set()
            finally:
                q.task_done()

    # ---- owner side ----

    def _raise_error(self) -> None:
        if self.error is not None:
            raise self.error
        raise SpillWriterError("spill writer poisoned without an error")

    def submit(self, task) -> None:
        """Hand one frozen snapshot task (callable → bytes written) to the
        writer. Blocked = spill backpressure, timed into ``stall_s`` — the
        wall-clock 'the disk is the ceiling' signal, exactly as
        fold_stall_s is for the fold."""
        if self._poisoned.is_set():
            self._raise_error()
        if self.sync:
            if self._closed:
                raise RuntimeError("spill writer already closed")
            try:
                self._run_task(task)
            except BaseException as e:
                self.error = e
                self._poisoned.set()
                raise
            return
        try:
            self._q.put_nowait(task)
            return
        except queue.Full:
            pass
        t0 = time.perf_counter()
        try:
            while True:
                if self._poisoned.is_set():
                    self._raise_error()
                try:
                    self._q.put(task, timeout=0.05)
                    return
                except queue.Full:
                    continue
        finally:
            self.stall_s += time.perf_counter() - t0

    def drain(self) -> None:
        """Block until every submitted run is on disk; re-raise a recorded
        writer error. The barrier before any read of the runs (egress
        merge, iter_sorted, fold_arrays) and before final accounting."""
        if not self.sync and not self._closed:
            # task_done fires for every entry — poisoned loops included —
            # so join() cannot deadlock.
            self._q.join()
        if self.error is not None:
            raise self.error

    def stats_dict(self, runs: int) -> dict:
        """Final accounting shape shared by every spilling tier (collect
        AFTER drain/close — the counters are writer-thread cells)."""
        return {"write_s": self.write_s, "stall_s": self.stall_s,
                "bytes": self.bytes_written, "runs": runs,
                "hist": self.hist}

    def snapshot(self) -> tuple:
        """(write_s, stall_s, bytes) right now — benign-stale reads for
        the live metrics ring (exact finals come from stats_dict)."""
        return (self.write_s, self.stall_s, self.bytes_written)

    def close(self, abort: bool = False) -> None:
        """Stop the writer thread. ``abort=True`` poisons first (pending
        snapshots are discarded — the caller is deleting the run files
        anyway) and forces the sentinel past a full queue. Idempotent,
        never raises, never blocks forever."""
        if self.sync or self._closed:
            self._closed = True
            return
        self._closed = True
        if abort:
            self._poisoned.set()
            while True:
                try:
                    self._q.put_nowait(self._SENTINEL)
                    break
                except queue.Full:
                    try:
                        self._q.get_nowait()
                        self._q.task_done()
                    except queue.Empty:
                        pass
        else:
            self._q.put(self._SENTINEL)
        self._thread.join(timeout=30)


def ensure_writer(current: "AsyncSpillWriter | None", name: str,
                  sync: bool) -> AsyncSpillWriter:
    """Lazy writer slot shared by every spilling tier: create on first
    flush; replace a CLOSED writer (remove_runs already ran — a fresh
    spill after job-end cleanup, test-only in practice, must not enqueue
    into a thread that already exited)."""
    if current is None or current._closed:
        return AsyncSpillWriter(name=name, sync=sync)
    return current


def tier_spill_stats(writer: "AsyncSpillWriter | None", runs: int) -> dict:
    """stats_dict with the never-spilled zeros — one shape for both
    tiers, so _collect_spill_stats can't drift between them."""
    if writer is None:
        return {"write_s": 0.0, "stall_s": 0.0, "bytes": 0, "runs": runs,
                "hist": None}
    return writer.stats_dict(runs)


def tier_spill_snapshot(writer: "AsyncSpillWriter | None"):
    return None if writer is None else writer.snapshot()


# ---------------------------------------------------------------------------
# Chaos: seeded per-spill write delay (slow_disk)
# ---------------------------------------------------------------------------

_chaos_cache: dict = {}


def _chaos_slow_disk(run_index: int) -> None:
    """The ``slow_disk`` injection checkpoint: one site covers every spill
    tier (dictionary runs, accumulator runs, shard or not). Seeded p=
    sampling keys on the run index, so reruns delay the same runs. Cached
    per spec string — tests flip MR_CHAOS between jobs."""
    spec = os.environ.get("MR_CHAOS")
    if not spec:
        return
    plan = _chaos_cache.get(spec)
    if plan is None:
        try:
            from mapreduce_rust_tpu_torch.analysis.chaos import ChaosPlan

            plan = ChaosPlan.parse(spec)
        except Exception:
            plan = False  # a bad ambient spec must not fail spill writes
        _chaos_cache[spec] = plan
    if not plan:
        return
    f = plan.pick("slow_disk", tid=run_index)
    if f is not None and f.seconds > 0:
        time.sleep(f.seconds)


def chaos_fired(spec: str) -> list:
    """Fired slow_disk events for ``spec`` (test/bench introspection)."""
    plan = _chaos_cache.get(spec)
    return plan.fired() if plan else []


# ---------------------------------------------------------------------------
# Crash-safe run scavenging
# ---------------------------------------------------------------------------

#: accrun-*/dictrun-* naming policy: kind, host tag (``h`` + 8-hex hash
#: of the hostname — pid liveness is only checkable on the writer's own
#: machine, and shared-filesystem work dirs are a supported deployment),
#: the writer's pid, the per-instance token (dictionary.new_run_token),
#: the run index, the tier's extension — plus the atomic-write .tmp
#: suffix a SIGKILL can strand. The host tag group is optional so
#: pre-tag leftovers still parse (they scavenge under the legacy
#: same-host assumption).
_RUN_NAME_RE = re.compile(
    r"^(dictrun|accrun)-(?:h([0-9a-f]{8})-)?(\d+)-([0-9a-f]{8})-\d+"
    r"\.(bin|txt|npy)(\.tmp)?$"
)

_host_tag_cache: "str | None" = None


def host_tag() -> str:
    """``h`` + 8-hex hash of this machine's hostname — the run-name
    fragment that scopes scavenging to files THIS host's pids wrote."""
    global _host_tag_cache
    if _host_tag_cache is None:
        import hashlib
        import socket

        _host_tag_cache = "h" + hashlib.sha256(
            socket.gethostname().encode()
        ).hexdigest()[:8]
    return _host_tag_cache


def run_file_name(kind: str, token: str, run_index: int, ext: str) -> str:
    """THE spill-run naming policy, one definition for both tiers and the
    scavenger's parser."""
    return f"{kind}-{host_tag()}-{os.getpid()}-{token}-{run_index}.{ext}"

#: Files younger than this are never scavenged even when their writer pid
#: is gone — belt and braces against pid-recycling races around process
#: startup. A leaked run is reclaimed on the NEXT job in the work dir,
#: which is exactly when the space matters.
SCAVENGE_MIN_AGE_S = 60.0


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True  # exists but not ours (EPERM) / unknown: keep the file


def scavenge_stale_runs(spill_dir: str, live_tokens=(),
                        min_age_s: float = SCAVENGE_MIN_AGE_S,
                        logger=None) -> list[str]:
    """Delete orphaned spill runs a SIGKILLed job left behind
    (``remove_run_files`` only runs at job end, so a killed job would
    leak its ``dictrun-*``/``accrun-*`` files). Guarded four
    ways so a CONCURRENT job's live runs are never touched: the file must
    match the run naming policy exactly, its host tag must be THIS
    machine's (pid liveness means nothing for a peer host on a shared
    filesystem — foreign-host files are never touched), its embedded
    token must not be one of ours (``live_tokens``), and its writer pid
    must be gone — a pid that still answers ``kill(pid, 0)`` may be a
    live job sharing the work dir, so its files stay. Age is the
    pid-recycling backstop. Best-effort by contract: returns the removed
    names, never raises."""
    removed: list[str] = []
    try:
        names = os.listdir(spill_dir)
    except OSError:
        return removed
    now = time.time()
    own = os.getpid()
    tokens = set(live_tokens)
    tag = host_tag()[1:]
    for name in names:
        m = _RUN_NAME_RE.match(name)
        if m is None:
            continue
        host, pid, token = m.group(2), int(m.group(3)), m.group(4)
        if host is not None and host != tag:
            continue  # another host's file: its liveness is unknowable here
        if token in tokens or pid == own or _pid_alive(pid):
            continue
        path = os.path.join(spill_dir, name)
        try:
            if now - os.path.getmtime(path) < min_age_s:
                continue
            os.unlink(path)
            removed.append(name)
        except OSError:
            continue
    if removed and logger is not None:
        logger.info(
            "scavenged %d stale spill run(s) from %s (dead writers)",
            len(removed), spill_dir,
        )
    return removed
