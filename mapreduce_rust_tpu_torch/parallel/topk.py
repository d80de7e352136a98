"""Per-shard top-k selection over the mesh's state.

The port of ``mapreduce_rust_tpu/parallel/topk.py``. After the stream,
shard d's state holds the FULL merged value of every key of its hash class
(keys are disjoint across shards, parallel/shuffle.py), so the global top-k
is a subset of the union of the per-shard top-k's, and the host fetches D*k
candidate records instead of the whole state.

Exactness: the app's tie-break is bytewise on the WORD (apps/top_k.py),
which the device cannot see (it holds hashes). A value tie AT a shard's k
boundary could cut a candidate that would win the word-order tie-break, so
``torch.topk`` takes k+1 values: a shard whose kth and (k+1)th values are
equal and real is ambiguous, and any ambiguous shard makes the driver fetch
the full state instead (the reference's exactness rule, not a fallback
from the device). Among equal values ``torch.topk``'s order is not
``lax.top_k``'s; only the candidate set is used, and it is the same.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mapreduce_rust_tpu_torch.core.kv import KVBatch

_I32_MIN = -(1 << 31)


def _select(st: KVBatch, k: int):
    """One shard's selection: (keys int32[k', 2], values int32[k'], valid
    bool[k'], ambiguous bool) with k' = min(k, capacity)."""
    kk = min(k + 1, st.capacity)  # +1 probes the boundary tie
    vals = torch.where(st.valid, st.value, _I32_MIN)
    top_vals, idx = torch.topk(vals, kk)
    if kk > k:
        # kth and (k+1)th equal AND real → the cut is word-order ambiguous
        # on this shard (the INT32_MIN padding never counts as a tie).
        ambiguous = (top_vals[k - 1] == top_vals[k]) & (top_vals[k] > _I32_MIN)
        top_vals, idx = top_vals[:k], idx[:k]
    else:
        ambiguous = torch.zeros((), dtype=torch.bool, device=vals.device)
    valid = top_vals > _I32_MIN
    keys = torch.stack([st.k1[idx], st.k2[idx]], dim=1)
    return keys, torch.where(valid, top_vals, 0), valid, ambiguous


def topk_candidates(state: Sequence[KVBatch], k: int):
    """(keys uint32[n, 2], values int32[n]) — the union of the per-shard
    top-k's, fetched in one copy — or None when any shard's k boundary is
    value-tied (the caller then fetches the full state)."""
    home = state[0].k1.device
    picks = [_select(st, k) for st in state]
    block = torch.cat([
        torch.cat([keys, vals[:, None], valid[:, None].to(torch.int32),
                   amb.expand(len(vals))[:, None].to(torch.int32)], dim=1).to(home)
        for keys, vals, valid, amb in picks
    ]).cpu().numpy()
    if block[:, 4].any():
        return None
    mask = block[:, 3].astype(bool)
    keys = np.ascontiguousarray(block[mask, :2]).view(np.uint32)
    return keys, block[mask, 2]
