"""Partitioning: hash mode and range mode (the port of
``mapreduce_rust_tpu/ops/partition.py``).

- **hash** — ``k1 % reduce_n`` on the unsigned k1, the reference's
  partitioner (apps/base.App.route).
- **range** — ``searchsorted`` over R-1 packed-uint64 splitters derived by
  the sampled-splitter subsystem (runtime/splitter.py). The packed key is
  the word's big-endian 8-byte prefix (:func:`pack_word_prefix`), which is
  order-preserving: ``a < b`` bytewise implies ``prefix(a) <= prefix(b)``,
  so partition order plus the bytewise line sort within each partition is
  global order across the ``mr-{r}.txt`` files (apps/sort.py).

The device half, :func:`bucket_scatter`, routes a record batch into the
``[num_buckets, capacity]`` layout the mesh's all_to_all sends
(parallel/shuffle.py), by hash or by range. Its records past a bucket's
capacity are dropped and *counted*; the mesh driver replays the group.
"""

from __future__ import annotations

import numpy as np
import torch

from mapreduce_rust_tpu_torch.core.kv import SENTINEL_I32, KVBatch

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


def _unsigned(lane: torch.Tensor) -> torch.Tensor:
    """int64 value of an int32 lane that holds uint32 bit patterns."""
    return lane.to(torch.int64) & 0xFFFFFFFF


def _range_bucket_ids(k1: torch.Tensor, k2: torch.Tensor, pairs) -> torch.Tensor:
    """Device-side searchsorted over splitter lane pairs: partition =
    #splitters <= (k1, k2) lexicographically, on the unsigned lanes —
    exactly range_partition's side='right' on the packed form."""
    pairs = torch.as_tensor(np.asarray(pairs, dtype=np.int64).reshape(-1, 2),
                            device=k1.device)
    s1, s2 = pairs[:, 0][None, :], pairs[:, 1][None, :]
    u1, u2 = _unsigned(k1)[:, None], _unsigned(k2)[:, None]
    le = (s1 < u1) | ((s1 == u1) & (s2 <= u2))
    return le.sum(dim=1)


def _scatter(x: torch.Tensor, dest: torch.Tensor, n: int, fill) -> torch.Tensor:
    """out[dest[i]] = x[i] into n + 1 slots pre-filled with ``fill``; slot n
    is the dump slot where dropped records collide, sliced away."""
    out = torch.full((n + 1,), fill, dtype=x.dtype, device=x.device)
    return out.scatter_(0, dest, x)[:n]


def bucket_scatter(batch: KVBatch, num_buckets: int, capacity: int,
                   mode: str = "hash", splitters=None) -> tuple[KVBatch, torch.Tensor]:
    """Scatter records into bucket-major layout.

    Returns (KVBatch of ``[num_buckets, capacity]`` tensors, overflow) with
    overflow an int32 scalar tensor: the valid records minus those kept.
    Invalid records go nowhere; a bucket's records fill its row from the
    front, the rest of the row is SENTINEL keys with value 0 and valid
    False. ``mode="hash"`` routes by the unsigned ``k1 % num_buckets`` (the
    mesh's state-ownership route); ``mode="range"`` by lexicographic
    searchsorted over ``splitters`` lane pairs (uint32 ``[num_buckets-1,
    2]``, see :func:`splitter_pairs`).

    Within a bucket the records keep their input order (a stable sort by
    bucket). The reference sorts unstably, so its order within a bucket —
    and which records a full bucket keeps — is its sort's; any overflow
    replays the whole group, so only the overflow count is ever read from
    a full bucket.
    """
    if mode == "range":
        ids = _range_bucket_ids(batch.k1, batch.k2, splitters)
    elif mode == "hash":
        ids = _unsigned(batch.k1) % num_buckets
    else:
        raise ValueError(f"unknown partition mode {mode!r}; have {PARTITION_MODES}")
    # Invalid records go to a virtual bucket past the last, never kept.
    bucket = torch.where(batch.valid, ids, num_buckets)
    sb, order = torch.sort(bucket, stable=True)
    # First slot of each bucket in sorted order (searchsorted, not
    # bincount: bincount on a card reads its max back to the host).
    first = torch.searchsorted(sb, torch.arange(num_buckets + 1, device=sb.device))
    rank = torch.arange(sb.numel(), device=sb.device) - first[sb]
    keep = (sb < num_buckets) & (rank < capacity)
    flat = num_buckets * capacity
    dest = torch.where(keep, sb * capacity + rank, flat)
    shape = (num_buckets, capacity)
    out = KVBatch(
        k1=_scatter(batch.k1[order], dest, flat, SENTINEL_I32).view(shape),
        k2=_scatter(batch.k2[order], dest, flat, SENTINEL_I32).view(shape),
        value=_scatter(batch.value[order], dest, flat, 0).view(shape),
        valid=_scatter(keep, dest, flat, False).view(shape),
    )
    overflow = (batch.valid.sum(dtype=torch.int32)
                - keep.sum(dtype=torch.int32))
    return out, overflow
