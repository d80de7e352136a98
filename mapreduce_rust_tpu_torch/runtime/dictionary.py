"""Host-side hash→word dictionary — the egress join table.

The port of ``mapreduce_rust_tpu/runtime/dictionary.py``: its RAM tier,
its disk word tier, and the ``save``/``load``/``merge`` persistence of the
worker's dictionary shards. The device computes on hash pairs only; to
print words at egress, every chunk's distinct words are hashed on the host during ingest
with the same two polynomial lanes (core/hashing.py), so the
``hash pair → word`` join is exact. A new word landing on an existing
pair is a collision: counted, and the first word wins.

Ingest folds native scan results (native/host.scan_unique_raw and the
host-map engine's scan_count_raw) through :meth:`Dictionary.add_scanned_raw`:
a sorted packed-key table answers membership for a whole batch with one
``searchsorted``, and word bytes are sliced only for keys not seen yet.
:class:`ShardedDictionary` splits the table into key-hash-disjoint shards,
one per fold thread of the host-map engine.

With ``budget_words`` set, the word store flushes to a sorted run file on
disk (``dictrun-*.bin``, the format of runtime/spill.py) whenever it
reaches the budget, keeping only the packed-key/length arrays in RAM for
membership and collision probes; egress then reads the whole dictionary
through ``iter_sorted()`` / ``run_sources()``.

``extract_words`` is the plain tokenizer of *normalized* bytes (ASCII
punctuation deleted with ``bytes.translate``, split on ASCII whitespace),
which the tests hold the native scan against.
"""

from __future__ import annotations

import os
import uuid
from typing import Iterator

import numpy as np

from mapreduce_rust_tpu_torch.core.hashing import byte_class_tables
from mapreduce_rust_tpu_torch.runtime import spill as spill_io


def _delete_table() -> bytes:
    """ASCII bytes that are neither whitespace nor word chars — deleted by
    tokenization without splitting the token."""
    ws, wc = byte_class_tables()
    return bytes(b for b in range(0x80) if not ws[b] and not wc[b])


_DELETE = _delete_table()


def extract_words(normalized: bytes) -> list[bytes]:
    """Cleaned words of a normalized byte chunk, in order, duplicates kept
    (the semantics of core/hashing.tokenize_host, in two C-level passes)."""
    return normalized.translate(None, _DELETE).split()


def new_run_token() -> str:
    """Per-instance spill-run filename token, shared by both disk tiers
    (dictionary ``dictrun-*`` and accumulator ``accrun-*``). The pid alone
    is not unique: two tiers in one process, or a crashed job's leftovers
    in a shared work_dir, must never collide on run names."""
    return uuid.uuid4().hex[:8]


def remove_run_files(runs: list) -> None:
    """Delete spill run files and clear the list (job-end cleanup: runs
    must not accumulate in a shared work_dir). Idempotent; missing files
    are fine."""
    for path in runs:
        try:
            os.unlink(path)
        except OSError:
            pass
    runs.clear()


_SHARD_MIX = 0x9E3779B97F4A7C15  # splitmix64 finalizer multiplier
_U64 = (1 << 64) - 1


def shard_of_packed(packed: int, n_shards: int) -> int:
    """THE fold-shard routing function: xor-shift + odd-multiply bit mix of
    the packed key, then high-bits modulo. The native sharded scan
    (loader.cpp ``shard_of_packed``) computes the identical expression;
    egress lookups route through this one. A bare ``packed % S`` would be
    the low bits of the h2 polynomial lane, where structurally correlated
    token classes collapse onto one shard."""
    packed = int(packed) & _U64
    x = ((packed ^ (packed >> 33)) * _SHARD_MIX) & _U64
    return (x >> 32) % int(n_shards)


def shard_ids_of_packed(packed, n_shards: int):
    """Vectorized :func:`shard_of_packed` over a uint64 array (numpy
    uint64 arithmetic wraps exactly like the C kernel's)."""
    packed = np.asarray(packed, dtype=np.uint64)
    x = (packed ^ (packed >> np.uint64(33))) * np.uint64(_SHARD_MIX)
    return (x >> np.uint64(32)) % np.uint64(n_shards)


class Dictionary:
    """hash pair → word bytes, built incrementally at ingest.

    Bounded-memory tier: with ``budget_words`` set, the word store flushes
    to a SORTED run file (``spill_dir/dictrun-*.bin``) whenever it reaches
    the budget. The flush is a handoff, not a write: the RAM tier freezes
    into a snapshot and a background
    :class:`~mapreduce_rust_tpu_torch.runtime.spill.AsyncSpillWriter`
    sorts, packs and writes it while this thread keeps folding
    (``async_spill=False`` / ``MR_SPILL_SYNC=1`` writes inline). A spilled
    dictionary no longer serves point probes for flushed words — egress
    consumes ``iter_sorted()`` / ``run_sources()``. Equal-length pair
    collisions on flushed words pass undetected, the same degradation
    add_scanned_raw documents.
    """

    def __init__(self, budget_words: int | None = None,
                 spill_dir: str | None = None,
                 async_spill: bool = True) -> None:
        if budget_words is not None and not spill_dir:
            raise ValueError("budget_words needs a spill_dir")
        self.budget_words = budget_words
        self.spill_dir = spill_dir
        self.async_spill = async_spill
        self._writer: "spill_io.AsyncSpillWriter | None" = None
        self._word_of: dict[tuple[int, int], bytes] = {}
        self._seen: set[bytes] = set()
        # (k1<<32)|k2 → stored word length: the per-key membership filter
        # AND the cheap collision probe (a same-pair different-length word
        # is caught without slicing).
        self._len_of: dict[int, int] = {}
        self.collisions: list[tuple[bytes, bytes]] = []  # (kept, rejected)
        # Vectorized steady-state filter for add_scanned_raw: sorted packed
        # keys + aligned stored lengths. Keys inserted since the last merge
        # wait in _fresh_*, so membership for a saturated vocabulary is one
        # searchsorted instead of 10^4-10^5 dict lookups per window. It
        # spans both tiers, which keeps dedup exact after a flush.
        self._packed_sorted = np.empty(0, dtype=np.uint64)
        self._sorted_lens = np.empty(0, dtype=np.int64)
        self._fresh_keys: list[int] = []
        self._fresh_lens: list[int] = []
        self._runs: list[str] = []
        self._total_words = 0  # RAM + flushed distinct words
        self._run_token = new_run_token()

    def __len__(self) -> int:
        return self._total_words

    def _guard_ram_only(self, what: str) -> None:
        """After a budget flush a RAM-tier probe would answer from a
        partial store (flushed words absent): raise instead."""
        if self._runs:
            raise RuntimeError(
                f"Dictionary.{what} after a budget flush would only see the "
                "RAM tier (flushed words live in disk runs) — consume "
                "iter_sorted() instead"
            )

    def __contains__(self, key: tuple[int, int]) -> bool:
        self._guard_ram_only("__contains__")
        return key in self._word_of

    def items(self) -> Iterator[tuple[tuple[int, int], bytes]]:
        """RAM-resident entries; raises once any run was flushed (a
        partial iteration would silently drop flushed words)."""
        self._guard_ram_only("items")
        return iter(self._word_of.items())

    @property
    def spilled(self) -> bool:
        return bool(self._runs)

    @property
    def run_count(self) -> int:
        return len(self._runs)

    def lookup(self, k1: int, k2: int) -> bytes | None:
        """Point lookup — RAM-resident words only. A spilled dictionary
        serves flushed words through iter_sorted()."""
        return self._word_of.get((k1, k2))

    def _maybe_flush(self) -> None:
        if self.budget_words is not None and len(self._word_of) >= self.budget_words:
            self._flush_words()

    def _flush_words(self) -> None:
        """Spill the in-RAM word store as one sorted binary run; keep only
        the packed-key/length arrays for membership + collision probes.
        The argsort, the varint pack and the write run on the background
        writer against a FROZEN snapshot; this thread only swaps in fresh
        containers and enqueues (backpressure, when the writer falls two
        runs behind, is timed into the writer's ``stall_s``)."""
        if not self._word_of:
            return
        self._merge_fresh()
        os.makedirs(self.spill_dir, exist_ok=True)
        run_index = len(self._runs)
        path = os.path.join(
            self.spill_dir,
            spill_io.run_file_name("dictrun", self._run_token, run_index, "bin"),
        )
        # Freeze the RAM tier: this thread never touches the snapshot
        # again, so the writer reads it without a lock. Membership stays
        # exact via _packed_sorted.
        snapshot = self._word_of
        self._word_of = {}
        self._seen = set()
        self._len_of = {}
        self._runs.append(path)
        token = self._run_token

        def task() -> int:
            from mapreduce_rust_tpu_torch.runtime.trace import trace_span

            with trace_span("dictionary.flush", words=len(snapshot),
                            run=run_index):
                keys, ends, buf = spill_io.pack_word_map(snapshot)
                return spill_io.write_run_file(
                    path, token, keys, ends, buf, run_index=run_index
                )

        self._ensure_writer().submit(task)

    def _ensure_writer(self) -> "spill_io.AsyncSpillWriter":
        self._writer = spill_io.ensure_writer(
            self._writer, f"mr/spill-dict-{self._run_token}",
            sync=not self.async_spill,
        )
        return self._writer

    def drain_spills(self) -> None:
        """Barrier: every enqueued run is on disk (or the writer's error
        re-raises here, on the owner thread)."""
        if self._writer is not None:
            self._writer.drain()

    def close_spills(self, abort: bool = True) -> None:
        """Stop the writer thread; pending snapshots are discarded on
        abort. Idempotent, never raises."""
        if self._writer is not None:
            self._writer.close(abort=abort)

    def spill_stats(self) -> dict:
        """Final spill accounting (collect AFTER drain/close): writer
        seconds, owner stall seconds, bytes, runs, the per-run write_s
        histogram. Zeros when this dictionary never spilled."""
        return spill_io.tier_spill_stats(self._writer, len(self._runs))

    def spill_snapshot(self) -> "tuple[float, float, int] | None":
        """(write_s, stall_s, bytes) right now, or None if never spilled."""
        return spill_io.tier_spill_snapshot(self._writer)

    def remove_runs(self) -> None:
        """Job-end cleanup of this dictionary's run files. Closes the
        writer first — a run mid-write must finish (or be discarded)
        before its file is unlinked."""
        self.close_spills(abort=True)
        remove_run_files(self._runs)

    def run_sources(self) -> "list[spill_io.RunSource]":
        """The key-disjoint sorted merge sources of this dictionary: every
        disk run memory-mapped, plus the RAM tier packed by the same
        argsort the flush uses. Drains the writer first."""
        self.drain_spills()
        sources = [spill_io.read_run_file(p) for p in self._runs]
        if self._word_of:
            keys, ends, buf = spill_io.pack_word_map(self._word_of)
            sources.append(spill_io.RunSource(keys, ends, buf))
        return sources

    def iter_sorted(self) -> Iterator[tuple[int, int, int, bytes]]:
        """(packed, k1, k2, word) over the WHOLE dictionary — disk runs
        plus the RAM tier — in ascending packed-key order. Tiers are
        key-disjoint (membership spans both), so this is a plain k-way
        merge with no dedup."""
        return spill_io.iter_sources_sorted(self.run_sources())

    def _stored_len(self, packed: int) -> "int | None":
        """Stored word length for a packed key, or None if unseen — exact
        membership across BOTH tiers (fresh dict + merged sorted arrays)."""
        v = self._len_of.get(packed)
        if v is not None:
            return v
        if len(self._packed_sorted):
            p = np.uint64(packed)
            i = int(np.searchsorted(self._packed_sorted, p))
            if i < len(self._packed_sorted) and self._packed_sorted[i] == p:
                return int(self._sorted_lens[i])
        return None

    def _insert_hashed(self, words, keys) -> int:
        """Insert (words, hash pairs uint32 [n, 2]) one by one: first word
        wins; a differing word on an existing pair is a recorded collision.
        Returns the number of new entries."""
        added = 0
        seen, word_of = self._seen, self._word_of
        for w, (k1, k2) in zip(words, keys.tolist()):
            if w in seen:
                continue
            seen.add(w)
            key = (k1, k2)
            packed = (k1 << 32) | k2
            if self._stored_len(packed) is None:
                self._len_of[packed] = len(w)
                # Every insert path must feed the vectorized filter, or the
                # key stays permanently "suspicious" to add_scanned_raw.
                self._fresh_keys.append(packed)
                self._fresh_lens.append(len(w))
                word_of[key] = w
                added += 1
                self._total_words += 1
            else:
                prev = word_of.get(key)
                if prev is not None and prev != w:
                    self.collisions.append((prev, w))
                elif prev is None:
                    # A flushed word recurring after a budget flush: dedup
                    # held via _stored_len, but it must NOT rejoin _seen,
                    # which would regrow toward the whole vocabulary and
                    # defeat the budget.
                    seen.discard(w)
        self._maybe_flush()
        return added

    def add_scanned(self, words: list[bytes], keys: np.ndarray) -> int:
        """Insert a pre-scanned (words, hash pairs) batch."""
        return self._insert_hashed(words, keys)

    def add_scanned_raw(self, raw: bytes, ends: np.ndarray, keys: np.ndarray) -> int:
        """Fold a scan_unique_raw result. Keys are filtered against the
        packed-key table first; word bytes are sliced only for unseen keys,
        so in steady state (saturated vocabulary) this touches almost
        nothing. Collision checking on this path: a repeated pair whose
        word LENGTH differs from the stored word's is sliced and verified
        (recorded if different); an equal-length different-word pair
        collision passes undetected — covered by the same ~2^-64 birthday
        bound as the pair keying itself."""
        n = len(ends)
        if n == 0:
            return 0
        packed = (
            (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1].astype(np.uint64)
        )
        wlens = np.diff(ends, prepend=np.int64(0))
        # Steady-state fast path: a key already in the sorted table with a
        # matching length needs no Python at all.
        if len(self._packed_sorted):
            idx = np.searchsorted(self._packed_sorted, packed)
            idx_c = np.minimum(idx, len(self._packed_sorted) - 1)
            known = (self._packed_sorted[idx_c] == packed) & (
                self._sorted_lens[idx_c] == wlens
            )
        else:
            known = np.zeros(n, dtype=bool)
        suspicious = np.nonzero(~known)[0]
        added = 0
        if len(suspicious):
            # Vectorized tier membership for the whole suspicious batch:
            # merged tier via the bisection above, unmerged tier via
            # np.isin over the fresh buffer. Their union IS _len_of's key
            # set, so no per-key dict probe is needed to find NEW keys.
            p_sus = packed[suspicious]
            if len(self._packed_sorted):
                in_sorted = self._packed_sorted[idx_c[suspicious]] == p_sus
            else:
                in_sorted = np.zeros(len(p_sus), dtype=bool)
            if self._fresh_keys:
                in_fresh = np.isin(p_sus, np.asarray(self._fresh_keys, dtype=np.uint64))
            else:
                in_fresh = np.zeros(len(p_sus), dtype=bool)
            new_mask = ~in_sorted & ~in_fresh

            new_i = suspicious[new_mask]
            if len(new_i):
                # Intra-batch pair collisions (two DIFFERENT words, equal
                # packed key, in one batch): keep the FIRST occurrence
                # (scan order) and record the rest.
                _uniq, first_pos = np.unique(packed[new_i], return_index=True)
                if len(first_pos) != len(new_i):
                    keep = np.zeros(len(new_i), dtype=bool)
                    keep[first_pos] = True
                    dup_i = new_i[~keep]
                    new_i = new_i[keep]
                else:
                    dup_i = new_i[:0]
                starts = np.where(new_i > 0, ends[new_i - 1], 0)
                words = [
                    raw[s:e]
                    for s, e in zip(starts.tolist(), ends[new_i].tolist())
                ]
                key_pairs = list(
                    zip(keys[new_i, 0].tolist(), keys[new_i, 1].tolist())
                )
                p_new = packed[new_i].tolist()
                w_new = wlens[new_i].tolist()
                # Batch C-loop updates (keys unique within the batch after
                # the dedup above and new to both tiers — no clobbering).
                self._word_of.update(zip(key_pairs, words))
                self._seen.update(words)
                self._len_of.update(zip(p_new, w_new))
                self._fresh_keys.extend(p_new)
                self._fresh_lens.extend(w_new)
                added += len(words)
                self._total_words += len(words)
                for i, s in zip(dup_i.tolist(),
                                np.where(dup_i > 0, ends[dup_i - 1], 0).tolist()):
                    w = raw[s:ends[i]]
                    prev = self._word_of.get((int(keys[i, 0]), int(keys[i, 1])))
                    if prev is not None and prev != w:
                        self._seen.add(w)
                        self.collisions.append((prev, w))

            # Known keys with a length mismatch: the rare collision-candidate
            # set — per-key work is fine here.
            mm = suspicious[in_sorted | in_fresh]
            if len(mm):
                mm_starts = np.where(mm > 0, ends[mm - 1], 0)
                word_of, seen = self._word_of, self._seen
                for i, s in zip(mm.tolist(), mm_starts.tolist()):
                    e = int(ends[i])
                    stored = self._stored_len(int(packed[i]))
                    if stored is None or stored == e - s:
                        continue
                    w = raw[s:e]
                    prev = word_of.get((int(keys[i, 0]), int(keys[i, 1])))
                    if prev is not None and prev != w and w not in seen:
                        seen.add(w)
                        self.collisions.append((prev, w))
            # Geometric threshold: rebuilding the sorted table costs O(V),
            # so amortize it against a constant fraction of V.
            if len(self._fresh_keys) >= max(1024, len(self._packed_sorted) // 4):
                self._merge_fresh()
            self._maybe_flush()
        return added

    def _merge_fresh(self) -> None:
        if not self._fresh_keys:
            return
        pk = np.concatenate(
            [self._packed_sorted, np.asarray(self._fresh_keys, dtype=np.uint64)]
        )
        ln = np.concatenate(
            [self._sorted_lens, np.asarray(self._fresh_lens, dtype=np.int64)]
        )
        order = np.argsort(pk, kind="stable")
        self._packed_sorted = pk[order]
        self._sorted_lens = ln[order]
        self._fresh_keys.clear()
        self._fresh_lens.clear()

    def merge(self, other: "Dictionary") -> None:
        if other.spilled:
            raise ValueError("cannot merge a disk-spilled dictionary")
        self.collisions.extend(other.collisions)
        for key, w in other._word_of.items():
            packed = (key[0] << 32) | key[1]
            if self._stored_len(packed) is None:
                self._word_of[key] = w
                self._seen.add(w)
                self._len_of[packed] = len(w)
                self._fresh_keys.append(packed)
                self._fresh_lens.append(len(w))
                self._total_words += 1
            else:
                prev = self._word_of.get(key)
                if prev is not None and prev != w:
                    self.collisions.append((prev, w))
        self._maybe_flush()

    # ---- persistence (the multi-process control-plane path: map tasks
    # write dictionary shards next to their spilled partials, reduce tasks
    # merge them — the analog of the Rust reference's mr-{m}-{r}.txt files) --

    def save(self, path: str | os.PathLike) -> None:
        """One binary container (the runtime/spill run format + a
        collision section): the tiers merge into a single globally sorted
        key column, and the word bytes STREAM to disk per merge block in
        a second pass — a spilled dictionary saves in O(keys + block)
        memory, never rehydrated into a Python dict (the bounded-memory
        contract that made it spill in the first place). ``load`` sniffs
        the magic, so pre-binary text saves (the 'k1 k2 word' /
        '! kept rejected' line format) still load."""
        sources = self.run_sources()  # drains the writer
        # Pass 1: ONE k-way merge; the key/length columns plus the
        # (src, idx) streams are retained (~28 B/key — small next to the
        # word bytes, which never materialize whole). The header needs
        # the totals up front, so the word bytes stream in pass 2 from
        # the retained blocks without re-running the merge.
        key_parts: list[np.ndarray] = []
        len_parts: list[np.ndarray] = []
        blocks: list[tuple] = []
        for keys, src, idx in spill_io.merge_sources(sources):
            key_parts.append(keys)
            blocks.append((src, idx))
            lens = np.empty(len(keys), dtype=np.int64)
            for s in np.unique(src).tolist():
                sel = np.nonzero(src == s)[0]
                ends_arr = sources[s].ends
                ii = idx[sel]
                lens[sel] = ends_arr[ii] - np.where(
                    ii > 0, ends_arr[ii - 1], 0
                )
            len_parts.append(lens)
        if key_parts:
            all_keys = np.ascontiguousarray(
                np.concatenate(key_parts), dtype="<u8")
            all_lens = np.concatenate(len_parts)
        else:
            all_keys = np.empty(0, dtype="<u8")
            all_lens = np.empty(0, dtype=np.int64)
        lens_b = spill_io.encode_varints(all_lens)
        with open(path, "wb") as f:
            f.write(spill_io.pack_header_for_save(
                self._run_token, len(all_keys), len(lens_b),
                len(self.collisions),
            ))
            f.write(all_keys.tobytes())
            f.write(lens_b)
            # Pass 2: word bytes, one joined buffer per retained block.
            for src, idx in blocks:
                f.write(b"".join(
                    spill_io.slice_block_words(sources, src, idx)
                ))
            for kept, rejected in self.collisions:
                f.write(spill_io.encode_varints(
                    np.asarray([len(kept)], dtype=np.uint64)))
                f.write(kept)
                f.write(spill_io.encode_varints(
                    np.asarray([len(rejected)], dtype=np.uint64)))
                f.write(rejected)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "Dictionary":
        """Version-sniffing load: the binary magic
        selects the columnar parse; anything else takes the legacy text
        parse, so dictionaries saved by the text plane still load. An
        unknown BINARY schema version fails loudly in read_run_header —
        the migration exit path, never a silent misparse."""
        with open(path, "rb") as f:
            head = f.read(4)
        if head == spill_io.RUN_MAGIC:
            return cls._load_binary(path)
        return cls._load_text(path)

    @classmethod
    def _load_binary(cls, path) -> "Dictionary":
        d = cls()
        src = spill_io.read_run_file(str(path))
        d.collisions.extend(src.collisions)
        keys = src.keys
        ends = src.ends.tolist()
        data = src.data
        data_b = data if isinstance(data, bytes) else bytes(
            memoryview(data))
        start = 0
        for packed, end in zip(keys.tolist(), ends):
            w = data_b[start:end]
            start = end
            k1, k2 = packed >> 32, packed & 0xFFFFFFFF
            if (k1, k2) not in d._word_of:
                d._total_words += 1
            d._insert_loaded(k1, k2, packed, w)
        return d

    @classmethod
    def _load_text(cls, path) -> "Dictionary":
        d = cls()
        with open(path, "rb") as f:
            for line in f:
                if line.startswith(b"! "):
                    _, kept, rejected = line.rstrip(b"\n").split(b" ", 2)
                    d.collisions.append((kept, rejected))
                    continue
                a, b, w = line.rstrip(b"\n").split(b" ", 2)
                k1, k2 = int(a), int(b)
                if (k1, k2) not in d._word_of:
                    d._total_words += 1
                d._insert_loaded(k1, k2, (k1 << 32) | k2, w)
        return d

    def _insert_loaded(self, k1: int, k2: int, packed: int, w: bytes) -> None:
        self._word_of[(k1, k2)] = w
        self._seen.add(w)
        if packed not in self._len_of:
            self._len_of[packed] = len(w)
            # Every insert path must feed the vectorized tiers:
            # add_scanned_raw's membership is (merged | fresh), so a
            # loaded key that skipped them would be re-insertable.
            self._fresh_keys.append(packed)
            self._fresh_lens.append(len(w))


class ShardedDictionary:
    """Key-hash-sharded egress dictionary: S independent
    :class:`Dictionary` shards, each owned by exactly one fold thread of
    the host-map engine's fold plane (runtime/driver._FoldShardPlane),
    read together only at egress.

    Shards are key-DISJOINT by construction — a key lives on shard
    ``shard_of_packed(packed, S)`` and nowhere else — so no cross-shard
    dedup exists, and the spill tiers compose: every shard's runs and RAM
    tier are sources of one flat k-way merge. Word totals, collisions and
    spill runs aggregate over the shards. Mutations go through the shards
    directly (each on its owner thread); this wrapper exposes the read
    and lifecycle surface run_job's finalize consumes.
    """

    def __init__(self, shards: "list[Dictionary]") -> None:
        if not shards:
            raise ValueError("ShardedDictionary needs at least one shard")
        self.shards = list(shards)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_of(self, k1: int, k2: int) -> int:
        return shard_of_packed((k1 << 32) | k2, len(self.shards))

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    @property
    def collisions(self) -> list:
        return [c for s in self.shards for c in s.collisions]

    def lookup(self, k1: int, k2: int) -> "bytes | None":
        return self.shards[self.shard_of(k1, k2)].lookup(k1, k2)

    @property
    def spilled(self) -> bool:
        return any(s.spilled for s in self.shards)

    @property
    def run_count(self) -> int:
        return sum(s.run_count for s in self.shards)

    def remove_runs(self) -> None:
        for s in self.shards:
            s.remove_runs()

    def drain_spills(self) -> None:
        for s in self.shards:
            s.drain_spills()

    def close_spills(self, abort: bool = True) -> None:
        for s in self.shards:
            s.close_spills(abort=abort)

    def spill_stats(self) -> dict:
        """Spill accounting summed over the shards (one writer each); the
        per-run write histograms merge into one."""
        from mapreduce_rust_tpu_torch.runtime.histogram import Histogram

        out = {"write_s": 0.0, "stall_s": 0.0, "bytes": 0, "runs": 0,
               "hist": None}
        for s in self.shards:
            st = s.spill_stats()
            for k in ("write_s", "stall_s", "bytes", "runs"):
                out[k] += st[k]
            h = st["hist"]
            if h is not None and h.count:
                if out["hist"] is None:
                    out["hist"] = Histogram()
                out["hist"].merge(h)
        return out

    def spill_snapshot(self) -> "tuple[float, float, int] | None":
        snaps = [x for x in (s.spill_snapshot() for s in self.shards) if x is not None]
        if not snaps:
            return None
        return (sum(x[0] for x in snaps), sum(x[1] for x in snaps),
                sum(x[2] for x in snaps))

    def run_sources(self) -> list:
        """Every shard's merge sources in one flat list (shards are
        key-disjoint like tiers)."""
        return [src for s in self.shards for src in s.run_sources()]

    def items(self):
        """RAM-resident entries across all shards; each shard raises its
        own spilled guard."""
        for s in self.shards:
            yield from s.items()

    def iter_sorted(self):
        """(packed, k1, k2, word) over ALL shards in ascending packed-key
        order — the contract of Dictionary.iter_sorted."""
        return spill_io.iter_sources_sorted(self.run_sources())
