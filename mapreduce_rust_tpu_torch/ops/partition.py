"""Partitioning, host half: hash mode and range mode (the port of the host
functions of ``mapreduce_rust_tpu/ops/partition.py:43-86``).

- **hash** — ``k1 % reduce_n`` on the unsigned k1, the reference's
  partitioner (apps/base.App.route).
- **range** — ``searchsorted`` over R-1 packed-uint64 splitters derived by
  the sampled-splitter subsystem (runtime/splitter.py). The packed key is
  the word's big-endian 8-byte prefix (:func:`pack_word_prefix`), which is
  order-preserving: ``a < b`` bytewise implies ``prefix(a) <= prefix(b)``,
  so partition order plus the bytewise line sort within each partition is
  global order across the ``mr-{r}.txt`` files (apps/sort.py).

The device half of the reference module (``_range_bucket_ids`` and
``bucket_scatter``, which feed the mesh shuffle) comes with the multi-GPU
engine.
"""

from __future__ import annotations

import numpy as np

#: The two partition modes an app may declare (apps/base.App.partition_mode).
PARTITION_MODES = ("hash", "range")


def pack_word_prefix(words) -> np.ndarray:
    """uint64[n] big-endian first-8-bytes pack of each word — the
    order-preserving key of range mode. Zero-padded on the right, so the
    numeric order of the packed values equals the bytewise order of the
    8-byte prefixes; equal-prefix words are ordered by the per-partition
    line sort (searchsorted is constant on equal keys, so they share one
    partition). One vectorized byte-matrix reduction."""
    n = len(words)
    if not n:
        return np.zeros(0, dtype=np.uint64)
    buf = b"".join(bytes(w[:8]).ljust(8, b"\x00") for w in words)
    mat = np.frombuffer(buf, dtype=np.uint8).reshape(n, 8).astype(np.uint64)
    place = np.uint64(1) << (np.uint64(8) * np.arange(7, -1, -1,
                                                      dtype=np.uint64))
    return (mat * place).sum(axis=1, dtype=np.uint64)


def range_partition(packed: np.ndarray, splitters: np.ndarray) -> np.ndarray:
    """Partition ids for packed-uint64 keys against sorted splitters:
    ``searchsorted(splitters, key, side='right')`` — the count of splitters
    <= key, so R-1 splitters induce R partitions and equal keys always
    share one. The splitters come from the shared sampler
    (runtime/splitter.derive_splitters)."""
    spl = np.asarray(splitters, dtype=np.uint64)
    return np.searchsorted(spl, np.asarray(packed, dtype=np.uint64),
                           side="right").astype(np.int64)


def splitter_pairs(splitters) -> np.ndarray:
    """uint32[R-1, 2] lane split of packed-uint64 splitters — the form a
    device-side range route compares against, without a 64-bit lane."""
    spl = np.asarray(splitters, dtype=np.uint64)
    hi = (spl >> np.uint64(32)).astype(np.uint32)
    lo = (spl & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo], axis=1)
