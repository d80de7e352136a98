"""The mesh all_to_all shuffle, of one process or of several.

The port of ``mapreduce_rust_tpu/parallel/shuffle.py``. The reference's
"files" of the Rust partitioner (``DefaultHasher(key) % reduce_n``,
src/mr/worker.rs:117-140) are rows of a bucket-major array, and one
all_to_all routes them:

    per shard:  tokenize → app.device_map → count_unique (map-side combiner)
                → bucket_scatter into D buckets (bucket = unsigned k1 % D)
    all shards: all_to_all — bucket d of every shard lands on shard d
    per shard:  count_unique over the received records → the shard's
                distinct keys (its hash class) → merge into its state

Keys are disjoint across shards after the shuffle (shard d owns exactly
the keys with k1 % D == d), so shard states merge and spill independently
and the job's table is the union of theirs.

Where the reference runs one SPMD program under ``shard_map``, this module
is plain functions over per-shard tensors: shard i's chunk, records and
state live on ``Mesh.devices[i]``, and the all_to_all is D concatenations
of rows (a copy between cards when the shards sit on different cards,
nothing but a gather on one card). Every op of a step is a torch op or the
scan kernel (ops/tokenize_cuda.tokenize_hash, one launch per shard), and
nothing in a step waits for the device or copies to the host.

Across processes (``Mesh.world`` > 1, parallel/distributed.py) each rank
holds its own ``d_local = D / world`` shards, and the all_to_all is one
``dist.all_to_all_single`` of the bucket-major block; the overflow
counters and the round's "have data" flag are summed over every rank by
one ``dist.all_reduce`` before the clamp (``make_mh_shuffle_step_fns``),
so every rank agrees on a replay and on its last round.

Fixed bucket capacity means a skewed bucket can overflow. Overflow is
counted before the merge, and then every shard's result is clamped to
empty (the clamp contract of the reference's psum): the merge may run
before any counter reaches the host, and the driver replays the group
through a wider tier, so results are always exact.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from mapreduce_rust_tpu_torch.apps.base import App
from mapreduce_rust_tpu_torch.core.kv import KVBatch
from mapreduce_rust_tpu_torch.ops.groupby import (
    clamp_batch,
    compact_front,
    compaction_cap,
    count_unique,
    merge_batches,
)
from mapreduce_rust_tpu_torch.ops.partition import bucket_scatter
from mapreduce_rust_tpu_torch.ops.tokenize import tokenize_and_hash


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` global shards: shard i lives on
    ``devices[i]``. Process ``rank`` of ``world`` owns the shards
    ``[rank * d_local, (rank + 1) * d_local)`` (``local_devices``), in
    global order; a one-process mesh owns them all. Hashable by value, so
    the step builders below cache per mesh."""

    devices: tuple
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def d_local(self) -> int:
        return self.size // self.world

    @property
    def local_devices(self) -> tuple:
        return self.devices[self.rank * self.d_local:(self.rank + 1) * self.d_local]

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard: where its counters
        and collectives live."""
        return self.local_devices[0]


def make_mesh(n_devices: "int | None" = None, device: str = "cuda",
              world: int = 1, rank: int = 0) -> Mesh:
    """The mesh of ``n_devices`` global shards, of which process ``rank``
    of ``world`` owns an equal share (a remainder raises). On ``"cuda"``
    (or ``"auto"``) shard i goes to ``cuda:(i % torch.cuda.device_count())``
    — several shards share a card when there are fewer cards than shards —
    and there must be a card; ``None`` means one shard per card, or one
    per process when ``world`` > 1. On ``"cpu"`` every shard is a CPU
    tensor (``None`` means one shard per process)."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n_devices}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not one of {world} processes")
    if device == "cpu":
        n = n_devices or world
        devices = (torch.device("cpu"),) * n
    elif device not in ("auto", "cuda"):
        raise ValueError(f"unknown device {device!r}")
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available for the mesh; pass "
                           "device='cpu' (--device cpu) to run it on the CPU")
    else:
        cards = torch.cuda.device_count()
        n = n_devices or (world if world > 1 else cards)
        devices = tuple(torch.device("cuda", i % cards) for i in range(n))
    if n % world:
        raise ValueError(f"a mesh of {n} shards does not split evenly over "
                         f"{world} processes")
    return Mesh(devices, rank, world)


def sharded_empty_state(mesh: Mesh, capacity_per_shard: int) -> list:
    """One empty KVBatch[capacity_per_shard] per shard of this process, on
    its device."""
    return [KVBatch.empty(capacity_per_shard, dev) for dev in mesh.local_devices]


def _map_combine(kv: KVBatch, doc_id: int, app: App, u_cap: int,
                 bucket_cap: int, d: int):
    """One shard's map side: compact → device_map → combine → bucket
    scatter. (buckets [d, bucket_cap], p_ovf, b_ovf): p_ovf counts
    distinct keys past u_cap plus tokens past the compaction cap, b_ovf
    records dropped by a full bucket."""
    # Compact before sorting: count_unique pays for tokens, not bytes.
    kv, c_ovf = compact_front(kv, compaction_cap(u_cap, kv.capacity))
    partial = count_unique(app.device_map(kv, doc_id), op=app.combine_op)
    update = partial.take_front(u_cap)
    p_ovf = partial.valid[u_cap:].sum(dtype=torch.int32) + c_ovf
    # The shuffle routes state ownership by hash for every app; range apps
    # (sort) get their order at the host egress, where the words are.
    buckets, b_ovf = bucket_scatter(update, num_buckets=d, capacity=bucket_cap,
                                    mode="hash")
    return buckets, p_ovf, b_ovf


def _all_to_all(buckets: Sequence[KVBatch], mesh: Mesh) -> list:
    """Shard d receives row d of every shard's buckets, concatenated in
    source-shard order — ``lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=True)``: KVBatch[D * bucket_cap] per shard."""
    return [
        KVBatch(*(torch.cat([lane[d].to(dev) for lane in lanes])
                  for lanes in zip(*buckets)))
        for d, dev in enumerate(mesh.devices)
    ]


def _all_to_all_procs(buckets: Sequence[KVBatch], mesh: Mesh) -> list:
    """The all_to_all of a multi-process mesh: the same routing as
    ``_all_to_all``, with this rank's shards only. The local shards'
    buckets make one bucket-major int32 block ``[d_local, 4 lanes, D,
    cap]`` on the home device (valid widened to int32, so one collective
    carries every lane); its destination axis splits by owning rank into
    equal parts (the buckets have a fixed capacity), and one
    ``dist.all_to_all_single`` swaps them. Local shard t then reads its
    rows from every source shard in global order."""
    import torch.distributed as dist

    dl, world, home = mesh.d_local, mesh.world, mesh.home
    block = torch.stack([
        torch.stack([b.k1, b.k2, b.value, b.valid.to(torch.int32)]).to(home)
        for b in buckets
    ])
    cap = block.shape[-1]
    # [src, lane, rank * dl + t, cap] -> [rank, src, lane, t, cap]
    send = block.view(dl, 4, world, dl, cap).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    # recv[q, s] came from global shard q * dl + s: [t, lane, (q, s) * cap]
    per_dst = recv.permute(3, 2, 0, 1, 4).reshape(dl, 4, mesh.size * cap)
    return [
        KVBatch(x[0].to(dev), x[1].to(dev), x[2].to(dev), x[3].to(dev) != 0)
        for x, dev in zip(per_dst, mesh.local_devices)
    ]


def _map_side(kvs: Sequence[KVBatch], doc_ids: Sequence[int], app: App,
              u_cap: int, bucket_cap: int, mesh: Mesh):
    """Every local shard's map side: (buckets per shard, p_ovf int32[d_local],
    b_ovf int32[d_local] on the home device)."""
    sides = [_map_combine(kv, int(doc), app, u_cap, bucket_cap, mesh.size)
             for kv, doc in zip(kvs, doc_ids)]
    p_ovf = torch.stack([s[1].to(mesh.home) for s in sides])
    b_ovf = torch.stack([s[2].to(mesh.home) for s in sides])
    return [s[0] for s in sides], p_ovf, b_ovf


def _reduce_side(recv: Sequence[KVBatch], ok: torch.Tensor, app: App,
                 mesh: Mesh) -> list:
    """Every local shard's combine of its received records, clamped to
    empty unless ``ok`` (a device bool). Clamp keys too, not just
    validity: a state shard stays sorted only if clamped records become
    SENTINEL padding (ops/groupby.clamp_batch)."""
    return [clamp_batch(count_unique(r, op=app.combine_op), ok.to(dev))
            for r, dev in zip(recv, mesh.local_devices)]


def _shuffle_tail(kvs: Sequence[KVBatch], doc_ids: Sequence[int], app: App,
                  u_cap: int, bucket_cap: int, mesh: Mesh):
    """THE shuffle body of a one-process mesh, shared by both map_shuffle
    forms: per-shard map side → all_to_all → per-shard combine, with the
    clamp contract: if ANY shard overflowed, every shard's result is
    clamped to empty (the sum is taken on the device, so the merge
    dispatches before a counter reaches the host) and the driver replays
    the group through a wider tier.

    Returns (local results, p_ovf int32[D], b_ovf int32[D]), the counters
    per shard on the first shard's device."""
    buckets, p_ovf, b_ovf = _map_side(kvs, doc_ids, app, u_cap, bucket_cap, mesh)
    ok = (p_ovf.sum() + b_ovf.sum()) == 0
    return _reduce_side(_all_to_all(buckets, mesh), ok, app, mesh), p_ovf, b_ovf


@functools.lru_cache(maxsize=64)
def make_shuffle_step_fns(app: App, u_cap: int, bucket_cap: int, mesh: Mesh):
    """(map_shuffle, merge) — the group-of-D-chunks mesh pipeline, cached
    by (app, u_cap, bucket_cap, mesh) as the reference caches its jitted
    closures.

    map_shuffle(chunks, doc_ids): one uint8 chunk per shard on its device
        and one doc id per shard → (local results, one KVBatch[D *
        bucket_cap] per shard; partial_ovf int32[D]; bucket_ovf int32[D]).
        Either counter nonzero → the driver replays the group through a
        wider tier (bucket_cap = u_cap ends bucket overflow, u_cap = the
        chunk's bytes ends partial overflow).
    merge(state, local): per local shard, ``merge_batches`` of the
        key-sorted local result into the sorted state → (state, evicted
        per shard, evicted counts int32[d_local] on the home device).
    """
    op = app.combine_op

    def map_shuffle(chunks: Sequence[torch.Tensor], doc_ids: Sequence[int]):
        return _shuffle_tail([tokenize_and_hash(c) for c in chunks], doc_ids,
                             app, u_cap, bucket_cap, mesh)

    def merge(state: Sequence[KVBatch], local: Sequence[KVBatch]):
        # local is a count_unique output — key-sorted — so the rank merge
        # inserts it into the (always sorted) state shard without a sort.
        out = [merge_batches(st, lc, op=op, update_sorted=True)
               for st, lc in zip(state, local)]
        ev_counts = torch.stack([ev.valid.sum(dtype=torch.int32).to(mesh.home)
                                 for _st, ev in out])
        return [st for st, _ev in out], [ev for _st, ev in out], ev_counts

    return map_shuffle, merge


@functools.lru_cache(maxsize=64)
def make_kv_shuffle_step_fns(app: App, u_cap: int, bucket_cap: int, mesh: Mesh):
    """map_shuffle over PRE-TOKENIZED records: one KVBatch per shard (e.g.
    parallel/halo.make_sharded_tokenizer's) and one doc id per shard → the
    same (local, partial_ovf, bucket_ovf) as make_shuffle_step_fns's.
    Pair with make_shuffle_step_fns(...)[1] for the merge."""

    def map_shuffle_kv(kvs: Sequence[KVBatch], doc_ids: Sequence[int]):
        return _shuffle_tail(kvs, doc_ids, app, u_cap, bucket_cap, mesh)

    return map_shuffle_kv


# ---- the multi-process mesh -----------------------------------------------
#
# No process sees another's shards, so every per-round decision the driver
# makes (replay? keep going?) comes back summed over every rank: one
# all_reduce of [have, p_ovf, b_ovf] per round, taken BEFORE the clamp, so
# that no rank merges a group another rank replays.


@functools.lru_cache(maxsize=8)
def make_round_fn(mesh: Mesh):
    """round_sum(vec): ``dist.all_reduce`` (sum) of a small int32 vector on
    the home device over every process, in place — the psum of the
    reference's round flag, and, being a collective, the round barrier."""
    import torch.distributed as dist

    def round_sum(vec: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(vec)
        return vec

    return round_sum


@functools.lru_cache(maxsize=64)
def make_mh_shuffle_step_fns(app: App, u_cap: int, bucket_cap: int, mesh: Mesh):
    """(map_shuffle, merge) for a multi-process mesh — the reference's
    ``replicate_flags=True`` step functions.

    map_shuffle(chunks, doc_ids, have): this rank's chunks (one per local
        shard), their doc ids and whether this rank fed real data (0/1) →
        (local results per local shard, totals int32[3] on the home
        device = [ranks with data, partial_ovf, bucket_ovf] summed over
        every process). Every rank reads the same totals, so all replay a
        group together and leave the loop in the same round.
    merge: make_shuffle_step_fns(...)[1], over the local shards.
    """
    round_sum = make_round_fn(mesh)

    def map_shuffle(chunks: Sequence[torch.Tensor], doc_ids: Sequence[int],
                    have: int):
        buckets, p_ovf, b_ovf = _map_side(
            [tokenize_and_hash(c) for c in chunks], doc_ids, app, u_cap,
            bucket_cap, mesh)
        flag = torch.tensor(have, dtype=torch.int32).to(mesh.home, non_blocking=True)
        totals = round_sum(torch.stack([flag, p_ovf.sum(dtype=torch.int32),
                                        b_ovf.sum(dtype=torch.int32)]))
        ok = (totals[1] + totals[2]) == 0
        recv = _all_to_all_procs(buckets, mesh)
        return _reduce_side(recv, ok, app, mesh), totals

    return map_shuffle, make_shuffle_step_fns(app, u_cap, bucket_cap, mesh)[1]


#: Wire size of one KVBatch record through the all_to_all:
#: k1 (4) + k2 (4) + value (4) + valid (1).
RECORD_WIRE_BYTES = 13


def wire_bytes_per_round(n_devices: int, bucket_cap: int) -> int:
    """Bytes one all_to_all round moves: every shard sends D fixed-capacity
    buckets, padding included (the capacity is fixed, so padding crosses
    the interconnect too)."""
    return n_devices * n_devices * bucket_cap * RECORD_WIRE_BYTES


def default_bucket_cap(u_cap: int, n_devices: int, factor: float) -> int:
    """Per-(src, dst) bucket capacity: even split × slack factor, padded to
    the next multiple of 8 (the reference's layout; the wire metric counts
    the padding), at most u_cap."""
    cap = math.ceil(u_cap / n_devices * factor)
    return min(u_cap, (cap + 7) // 8 * 8)


def local_rows(xs: Sequence[torch.Tensor]) -> np.ndarray:
    """The per-shard tensors of one lane of this process's shards as a host
    ``[d_local, ...]`` array, in global shard order."""
    return np.stack([x.cpu().numpy() for x in xs])


def local_batch(batch: Sequence[KVBatch]) -> KVBatch:
    """local_rows over every lane of a per-shard state, in the reference's
    dtypes: k1/k2 uint32 ``[d_local, cap]``, value int32, valid bool."""
    k1, k2, value, valid = (local_rows(lane) for lane in zip(*batch))
    return KVBatch(k1.view(np.uint32), k2.view(np.uint32), value, valid)


def shard_fill_counts(state: Sequence[KVBatch]) -> "list[int]":
    """Valid records per shard of this process, in global shard order —
    the hash-class skew signal. One blocking readback; call at finalize,
    never from the stream loop."""
    home = state[0].valid.device
    return torch.stack([s.valid.sum().to(home) for s in state]).cpu().tolist()
