"""Host-side hash→word dictionary — the egress join table (RAM tier).

The port of ``mapreduce_rust_tpu/runtime/dictionary.py`` without its disk
spill tier. The device computes on hash pairs only; to print words at
egress, every chunk's distinct words are hashed on the host during ingest
with the same two polynomial lanes (core/hashing.py), so the
``hash pair → word`` join is exact. A new word landing on an existing
pair is a collision: counted, and the first word wins.

Ingest folds native scan results (native/host.scan_unique_raw and the
host-map engine's scan_count_raw) through :meth:`Dictionary.add_scanned_raw`:
a sorted packed-key table answers membership for a whole batch with one
``searchsorted``, and word bytes are sliced only for keys not seen yet.
:class:`ShardedDictionary` splits the table into key-hash-disjoint shards,
one per fold thread of the host-map engine.

``extract_words`` is the plain tokenizer of *normalized* bytes (ASCII
punctuation deleted with ``bytes.translate``, split on ASCII whitespace),
which the tests hold the native scan against.
"""

from __future__ import annotations

import numpy as np

from mapreduce_rust_tpu_torch.core.hashing import byte_class_tables


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
    """hash pair → word bytes, built incrementally at ingest, all in RAM."""

    def __init__(self) -> None:
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
        # searchsorted instead of 10^4-10^5 dict lookups per window.
        self._packed_sorted = np.empty(0, dtype=np.uint64)
        self._sorted_lens = np.empty(0, dtype=np.int64)
        self._fresh_keys: list[int] = []
        self._fresh_lens: list[int] = []

    def __len__(self) -> int:
        return len(self._word_of)

    def lookup(self, k1: int, k2: int) -> bytes | None:
        return self._word_of.get((k1, k2))

    def _stored_len(self, packed: int) -> "int | None":
        """Stored word length for a packed key, or None if unseen (fresh
        dict + merged sorted arrays)."""
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
            else:
                prev = word_of.get(key)
                if prev is not None and prev != w:
                    self.collisions.append((prev, w))
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


class ShardedDictionary:
    """Key-hash-sharded egress dictionary: S independent
    :class:`Dictionary` shards, each owned by exactly one fold thread of
    the host-map engine's fold plane (runtime/driver._FoldShardPlane),
    read together only at egress.

    Shards are key-DISJOINT by construction — a key lives on shard
    ``shard_of_packed(packed, S)`` and nowhere else — so no cross-shard
    dedup exists. Mutations go through the shards directly (each on its
    owner thread); this wrapper exposes the read surface run_job's
    finalize consumes.
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
