"""Sort + segment group-by reduce, as torch ops.

The port of ``mapreduce_rust_tpu/ops/groupby.py``. Reduce ops:

- ``"sum"`` — word count: total occurrences per key;
- ``"max"`` / ``"min"`` — extremal value per key;
- ``"distinct"`` — the value joins the sort key; one output record per
  distinct (key, value) pair. inverted_index, grep and join build their
  doc-id posting sets this way: dedup is associative, so per-chunk sets
  merge into a global set exactly like partial counts merge into totals.

The reference leaves these to XLA, outside any Pallas kernel; here they
are PyTorch operators on the card. Every function keeps the reference's
static-capacity contract and returns the same arrays slot for slot, so
counters such as ``spilled_keys`` compare one to one.

Keys are int32 bit patterns of uint32 lanes (core/kv.py). Every order
decision goes through :func:`pack_keys`: ``(k1_u32 - 2^31) * 2^32 + k2_u32``
in int64, whose signed order is the reference's unsigned ``(k1, k2)``
order with the SENTINEL pair last (int64 max). The value lane is int32
and orders signed, as the reference's ``lax.sort`` orders it. A
(key, value) order is never packed into one wider integer: its sort is two
stable passes and the rank merge's binary search compares both columns.
Nothing here copies to the host or waits for the device: shapes are
static, and records are placed by scatter into a buffer with one extra
dump slot that is sliced away.
"""

from __future__ import annotations

import torch

from mapreduce_rust_tpu_torch.core.kv import SENTINEL_I32, KVBatch

#: Ops whose combiner is idempotent per (key, value) — the value is part of
#: the sort key and duplicates collapse to one record.
_VALUE_KEYED_OPS = frozenset({"distinct"})
REDUCE_OPS = frozenset({"sum", "max", "min", "distinct"})

_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1
_OP_IDENTITY = {"sum": 0, "max": _I32_MIN, "min": _I32_MAX}


def _check_op(op: str) -> None:
    if op not in REDUCE_OPS:
        raise ValueError(f"unknown reduce op: {op!r}")


def pack_keys(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """int64 sort key of the (k1, k2) uint32 pair; signed order == the
    unsigned lexicographic order."""
    hi = (k1 ^ _I32_MIN).to(torch.int64)  # k1_u32 - 2^31, in [-2^31, 2^31)
    lo = k2.to(torch.int64) & 0xFFFFFFFF
    return hi * (1 << 32) + lo


def _place(x: torch.Tensor, dest: torch.Tensor, n: int, fill) -> torch.Tensor:
    """out[dest[i]] = x[i] into n slots pre-filled with ``fill``; dest == n
    is the dump slot, where any number of records may collide."""
    buf = torch.full((n + 1,), fill, dtype=x.dtype, device=x.device)
    return buf.scatter_(0, dest, x)[:n]


def sort_kv(batch: KVBatch, by_value: bool = False) -> KVBatch:
    """Sort records by the unsigned (k1, k2), or by (k1, k2, value) when
    ``by_value`` (reference ``groupby.py:40-57``). SENTINEL padding sorts
    last either way. The key sort is unstable, like the reference's: every
    consumer aggregates whole segments, so the order of records tied on
    the full sort key is immaterial. The 3-key order is a stable sort on
    the value followed by a stable sort on the packed key."""
    pk = pack_keys(batch.k1, batch.k2)
    if by_value:
        by_val = torch.sort(batch.value, stable=True).indices
        order = by_val[torch.sort(pk[by_val], stable=True).indices]
    else:
        order = torch.sort(pk).indices
    return KVBatch(batch.k1[order], batch.k2[order], batch.value[order],
                   batch.valid[order])


def segment_reduce_sorted(batch: KVBatch, op: str = "sum") -> KVBatch:
    """Reduce a sorted batch: slot j holds the j-th segment's key and
    combined value, valid iff the segment holds a valid record; SENTINEL
    fill past the last segment. For ``"distinct"`` the batch must be
    sorted with ``by_value=True``; a segment is then one (key, value) pair
    and keeps its value (reference ``groupby.py:224-289``)."""
    _check_op(op)
    n = batch.capacity
    by_value = op in _VALUE_KEYED_OPS
    pk = pack_keys(batch.k1, batch.k2)
    boundary = torch.ones(n, dtype=torch.bool, device=pk.device)
    boundary[1:] = pk[1:] != pk[:-1]
    if by_value:
        boundary[1:] |= batch.value[1:] != batch.value[:-1]
    seg = torch.cumsum(boundary, 0) - 1
    # The segment's key (and for "distinct" its value) is the one at its
    # head — never a signed max over the int32 bit patterns, which would
    # misorder keys >= 2^31.
    head = torch.where(boundary, seg, n)
    if by_value:
        totals = _place(batch.value, head, n, 0)
    else:
        ident = _OP_IDENTITY[op]
        vals = torch.where(batch.valid, batch.value, ident)
        totals = torch.full((n,), ident, dtype=torch.int32, device=pk.device)
        if op == "sum":
            totals.index_add_(0, seg, vals)
        else:
            totals.scatter_reduce_(0, seg, vals,
                                   reduce="amax" if op == "max" else "amin")
    live = torch.zeros(n, dtype=torch.int32, device=pk.device)
    live.index_add_(0, seg, batch.valid.to(torch.int32))
    uk1 = _place(batch.k1, head, n, SENTINEL_I32)
    uk2 = _place(batch.k2, head, n, SENTINEL_I32)
    slot_valid = live > 0
    return KVBatch(
        k1=torch.where(slot_valid, uk1, SENTINEL_I32),
        k2=torch.where(slot_valid, uk2, SENTINEL_I32),
        value=torch.where(slot_valid, totals, 0),
        valid=slot_valid,
    )


def count_unique(batch: KVBatch, op: str = "sum") -> KVBatch:
    """Sort + reduce: (distinct keys, combined values), front-packed. The
    map-side combiner (word count: partial sums; inverted_index: distinct
    (term, doc) pairs)."""
    return segment_reduce_sorted(
        sort_kv(batch, by_value=op in _VALUE_KEYED_OPS), op=op)


def compaction_cap(u_cap: int, capacity: int) -> int:
    """Token-slot budget for compact_front in the map step (copied from the
    reference): scales with the distinct-key budget (2*u_cap) and a
    token-density floor (capacity/4), capped at the structural worst case
    (ceil(capacity/2) one-char tokens), which is what makes the full-width
    replay tier unable to re-overflow."""
    return min(max(2 * u_cap, capacity // 4, 1024), capacity // 2 + 1)


def compact_front(batch: KVBatch, cap: int) -> tuple[KVBatch, torch.Tensor]:
    """(packed KVBatch[cap], overflow_count int32 scalar tensor): the valid
    records scattered, in order, into the front of a cap-sized batch, so
    the sort pays for tokens, not bytes. Records past cap are counted in
    the overflow, never dropped silently: the driver replays the chunk."""
    idx = torch.cumsum(batch.valid, 0, dtype=torch.int32) - 1
    total = idx[-1] + 1
    ovf = torch.clamp(total - cap, min=0)
    dest = torch.where(batch.valid & (idx < cap), idx, cap).to(torch.int64)
    packed = KVBatch(
        k1=_place(batch.k1, dest, cap, SENTINEL_I32),
        k2=_place(batch.k2, dest, cap, SENTINEL_I32),
        value=_place(batch.value, dest, cap, 0),
        valid=torch.arange(cap, dtype=torch.int32, device=idx.device)
        < torch.clamp(total, max=cap),
    )
    return packed, ovf


def clamp_batch(batch: KVBatch, keep: torch.Tensor) -> KVBatch:
    """Clamp a batch to empty unless ``keep`` (bool scalar tensor) holds:
    validity drops AND keys become SENTINEL, so a clamped update merged
    into the sorted state leaves no mid-array hole."""
    return KVBatch(
        k1=torch.where(keep, batch.k1, SENTINEL_I32),
        k2=torch.where(keep, batch.k2, SENTINEL_I32),
        value=torch.where(keep, batch.value, 0),
        valid=batch.valid & keep,
    )


def _searchsorted_right(hay: tuple, q: tuple) -> torch.Tensor:
    """For each query key tuple, the count of haystack records
    lexicographically <= it: the reference's vectorized binary search
    (``groupby.py:59-84``) round for round — ``max(n, 1).bit_length()``
    rounds of one gather per column — so it answers as the reference does
    on every haystack, including a sentinel tail that is not in
    (key, value) order. ``hay`` / ``q`` are matching tuples of 1-D
    tensors, most significant column first."""
    n = hay[0].shape[0]
    dev = q[0].device
    lo = torch.zeros(q[0].shape, dtype=torch.int64, device=dev)
    hi = torch.full(q[0].shape, n, dtype=torch.int64, device=dev)
    for _ in range(max(n, 1).bit_length()):
        active = lo < hi
        # An inactive lane may sit at n: clamp its gather (its answer is
        # kept whatever it reads), as the reference's gather clamps.
        mid = torch.clamp((lo + hi) >> 1, max=n - 1)
        lt = torch.zeros(q[0].shape, dtype=torch.bool, device=dev)
        eq = torch.ones(q[0].shape, dtype=torch.bool, device=dev)
        for h, x in zip(hay, q):
            hm = h[mid]
            lt = lt | (eq & (hm < x))
            eq = eq & (hm == x)
        go_right = active & (lt | eq)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def merge_sorted_runs(a: KVBatch, b: KVBatch, by_value: bool = False) -> KVBatch:
    """Stable interleave of two sorted batches into one sorted batch of
    capacity ``a.capacity + b.capacity`` without a sort: b[j] goes to
    j + |a <= b[j]| (one binary search), a's records fill the rest in
    order; records of ``a`` precede equal records of ``b``. ``by_value``
    orders by (key, value), the order of the ``distinct`` op."""
    na, nb = a.capacity, b.capacity
    if na == 0:
        raise ValueError("merge_sorted_runs: haystack batch `a` has zero capacity")
    m = na + nb
    dev = a.k1.device
    ka = pack_keys(a.k1, a.k2)
    kb = pack_keys(b.k1, b.k2)
    if by_value:
        rank = _searchsorted_right((ka, a.value), (kb, b.value))
    else:
        rank = torch.searchsorted(ka, kb, right=True)
    pos_b = torch.arange(nb, device=dev) + rank
    # Slot s > 0 marks a b-slot; s - 1 is the b index there.
    s = torch.zeros(m, dtype=torch.int64, device=dev)
    s.scatter_(0, pos_b, torch.arange(1, nb + 1, device=dev))
    tb = s > 0
    b_src = torch.clamp(s - 1, min=0)
    a_idx = torch.clamp(torch.arange(m, device=dev) - torch.cumsum(tb, 0), 0, na - 1)

    def pick(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        return torch.where(tb, xb[b_src], xa[a_idx])

    return KVBatch(pick(a.k1, b.k1), pick(a.k2, b.k2), pick(a.value, b.value),
                   pick(a.valid, b.valid))


def combine_adjacent_unique(merged: KVBatch, op: str = "sum") -> KVBatch:
    """Reduce a sorted batch in which every key (for ``"distinct"`` every
    (key, value) pair) appears AT MOST TWICE among valid records, the two
    adjacent (a merge_sorted_runs output of two key-distinct sides):
    shifted compares plus one compaction scatter. Same output contract as
    segment_reduce_sorted (reference ``groupby.py:144-220``)."""
    _check_op(op)
    n = merged.capacity
    k1, k2, val, valid = merged
    dev = k1.device
    by_value = op in _VALUE_KEYED_OPS
    eq = (k1[:-1] == k1[1:]) & (k2[:-1] == k2[1:])
    if by_value:
        eq = eq & (val[:-1] == val[1:])
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    eq_next = torch.cat([eq, false1])       # i equals i+1
    first = torch.cat([~false1, ~eq])       # run head mask
    nxt_valid = torch.cat([valid[1:], false1])
    if by_value:
        pairv = val  # the value is part of the key: every run member has it
    else:
        ident = _OP_IDENTITY[op]
        v = torch.where(valid, val, ident)
        nxt_v = torch.cat([v[1:], torch.full((1,), ident, dtype=v.dtype, device=dev)])
        other = torch.where(eq_next, nxt_v, ident)
        if op == "sum":
            pairv = v + other
        elif op == "max":
            pairv = torch.maximum(v, other)
        else:
            pairv = torch.minimum(v, other)
    # A run is live iff its head or the head's twin is valid.
    live = first & (valid | (eq_next & nxt_valid))
    # The one run that can mix valid records with padding is the
    # (SENTINEL, SENTINEL) run: a real word hashing to the sentinel pair
    # lands inside it, possibly apart from its cross-side twin. Fix that
    # run with one masked reduction.
    is_sent = (k1 == SENTINEL_I32) & (k2 == SENTINEL_I32)
    if by_value:
        # The value joins the key, so only the padding-valued (0) sentinel
        # run can hold padding; a valid member keeps it alive.
        sent0 = is_sent & (val == 0)
        head = first & sent0
        live = live | (head & (valid & sent0).any())
    else:
        sent_vals = torch.where(valid & is_sent, val, ident)
        if op == "sum":
            sent_total = sent_vals.sum(dtype=torch.int32)
        elif op == "max":
            sent_total = sent_vals.max()
        else:
            sent_total = sent_vals.min()
        head = first & is_sent
        live = live | (head & (valid & is_sent).any())
        pairv = torch.where(head, sent_total, pairv)
    # Compact run heads to the front, in order; the rest hit the dump slot.
    dest = torch.where(first, torch.cumsum(first, 0) - 1, n)
    return KVBatch(
        k1=_place(torch.where(live, k1, SENTINEL_I32), dest, n, SENTINEL_I32),
        k2=_place(torch.where(live, k2, SENTINEL_I32), dest, n, SENTINEL_I32),
        value=_place(torch.where(live, pairv, 0), dest, n, 0),
        valid=_place(live, dest, n, False),
    )


def merge_batches(state: KVBatch, update: KVBatch, op: str = "sum",
                  update_sorted: bool = False) -> tuple[KVBatch, KVBatch]:
    """Merge per-chunk partials into a running distinct-key state.

    ``state`` is sorted and key-distinct (SENTINEL padding last);
    ``update_sorted=True`` promises the same of ``update`` (every
    count_unique output), otherwise it is count_unique'd first. The update
    is rank-merged in and adjacent twins combined — the state is never
    re-sorted.

    Returns ``(new_state, evicted)``: the smallest ``state.capacity``
    distinct records, and the largest tail (capacity ``update.capacity``)
    with its full merged values, which the driver moves to the host
    accumulator — nothing is dropped. For scalar ops a key never lands in
    both halves. For ``"distinct"`` the cut can land inside a key —
    (k, v1) kept, (k, v2) evicted — so the host folds spills by set union
    per key and never takes an evicted key as final (HostAccumulator).
    """
    cap = state.capacity
    if not update_sorted:
        # count_unique, not a bare sort: it also dedups, establishing the
        # key-distinct side contract combine_adjacent_unique needs.
        update = count_unique(update, op=op)
    merged = combine_adjacent_unique(
        merge_sorted_runs(state, update, by_value=op in _VALUE_KEYED_OPS), op=op)
    head = KVBatch(*(x[:cap] for x in merged))
    evicted = KVBatch(*(x[cap:] for x in merged))
    return head, evicted
