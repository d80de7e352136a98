"""The port's group-by ops against their JAX counterparts.

Each case builds one numpy state from a seed and feeds it to the JAX
function (as a jax KVBatch) and to the port's (through
``KVBatch.from_numpy``). Outputs are integer arrays, compared slot for
slot with exact equality — padding included, since the driver's counters
(spilled keys, replays) depend on the exact layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mapreduce_rust_tpu.core.hashing import SENTINEL
from mapreduce_rust_tpu.core.kv import KVBatch as JaxKV
from mapreduce_rust_tpu.ops import groupby as jg
from mapreduce_rust_tpu_torch.core.kv import KVBatch
from mapreduce_rust_tpu_torch.ops import groupby as tg

S = int(SENTINEL)


def batch(k1, k2, value, valid):
    """(jax batch, port batch) of one numpy state."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    value, valid = np.asarray(value, np.int32), np.asarray(valid, bool)
    jax_b = JaxKV(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(value), jnp.asarray(valid))
    return jax_b, KVBatch.from_numpy(k1, k2, value, valid, "cpu")


def assert_same(jax_b, port_b):
    for name, w, g in zip(("k1", "k2", "value", "valid"), jax_b, port_b.to_numpy()):
        assert np.array_equal(np.asarray(w), g), name


def records(rng, cap, n_valid, key_pool=64, sentinel_pad=True):
    """A batch of n_valid records over a small key pool (duplicates),
    keys on both sides of 2^31, padding SENTINEL-keyed (or real-keyed
    garbage when not sentinel_pad)."""
    pool = rng.integers(0, 1 << 32, (key_pool, 2), dtype=np.uint64).astype(np.uint32)
    pool[: key_pool // 2, 0] |= np.uint32(0x80000000)  # half the keys >= 2^31
    pick = pool[rng.integers(0, key_pool, cap)]
    valid = np.zeros(cap, bool)
    valid[rng.choice(cap, n_valid, replace=False)] = True
    k1, k2 = pick[:, 0].copy(), pick[:, 1].copy()
    if sentinel_pad:
        k1[~valid] = S
        k2[~valid] = S
    value = rng.integers(-50, 50, cap).astype(np.int32)
    return k1, k2, value, valid


def reduced(rng, cap, n_valid, op="sum", key_pool=64):
    """A count_unique'd (sorted, key-distinct) numpy state."""
    j, _ = batch(*records(rng, cap, n_valid, key_pool))
    return [np.asarray(x) for x in jg.count_unique(j, op=op)]


@pytest.mark.parametrize("n_valid,cap", [(300, 256), (100, 256), (0, 64)])
def test_compact_front(n_valid, cap):
    rng = np.random.default_rng(n_valid)
    j, t = batch(*records(rng, 512, n_valid))
    jp, jovf = jg.compact_front(j, cap)
    tp, tovf = tg.compact_front(t, cap)
    assert_same(jp, tp)
    assert int(jovf) == int(tovf) == max(n_valid - cap, 0)


@pytest.mark.parametrize("op", ["sum", "max", "min", "distinct"])
@pytest.mark.parametrize("sentinel_pad", [True, False])
def test_count_unique(op, sentinel_pad):
    rng = np.random.default_rng(len(op) + sentinel_pad)
    state = list(records(rng, 512, 400, sentinel_pad=sentinel_pad))
    if op == "distinct":
        # Few values per key: duplicate (key, value) pairs and value ties
        # across keys, negative values included.
        state[2] = (state[2] % 5 - 1).astype(np.int32)
    assert (state[0][state[3]] >= 1 << 31).any()
    j, t = batch(*state)
    assert_same(jg.count_unique(j, op=op), tg.count_unique(t, op=op))


@pytest.mark.parametrize("keep", [True, False])
def test_clamp_batch(keep):
    import torch

    j, t = batch(*records(np.random.default_rng(2), 64, 40))
    assert_same(jg.clamp_batch(j, jnp.bool_(keep)), tg.clamp_batch(t, torch.tensor(keep)))


#: Every merge case has these capacities: one shape per JAX op, compiled once.
STATE_CAP, UPDATE_CAP = 64, 32


def padded(keys, values, cap):
    """Sorted distinct (k1 == k2 == key) records, SENTINEL padding to cap."""
    n = len(keys)
    k = np.full(cap, S, np.uint32)
    k[:n] = keys
    v = np.zeros(cap, np.int32)
    v[:n] = values
    return [k, k.copy(), v, np.arange(cap) < n]


def merge_case(name: str, op: str):
    """(state, update) numpy states of one merge scenario."""
    rng = np.random.default_rng(len(name))
    if name == "evict":
        # A full state; the update overlaps it and adds keys beyond it, so
        # a tail is evicted.
        return (reduced(rng, STATE_CAP, STATE_CAP, op, key_pool=200),
                reduced(rng, UPDATE_CAP, UPDATE_CAP, op, key_pool=200))
    if name == "cut_in_run":
        # A full state of keys 0..63; the update repeats the LAST state key
        # plus larger ones, so that key's two records straddle the capacity
        # cut of the rank-merged array.
        st = padded(np.arange(STATE_CAP), np.arange(1, STATE_CAP + 1), STATE_CAP)
        return st, padded([STATE_CAP - 1, 100, 101], [5, 1, 2], UPDATE_CAP)
    if name == "sentinel_word":
        # A real word hashing to (SENTINEL, SENTINEL) on both sides, inside
        # the padding run.
        return (padded([3, S], [1, 5], STATE_CAP), padded([4, S], [1, 7], UPDATE_CAP))
    if name == "sentinel_doc0":
        # The same word with value 0 (doc 0 under "distinct"): inside the
        # padding-valued sentinel run on the state side only.
        return (padded([3, S], [1, 0], STATE_CAP), padded([4, 5], [1, 0], UPDATE_CAP))
    if name == "empty_update":
        return reduced(rng, STATE_CAP, 40, op), padded([], [], UPDATE_CAP)
    if name == "high_keys":
        return (reduced(rng, STATE_CAP, 45, op, key_pool=120),
                reduced(rng, UPDATE_CAP, 25, op, key_pool=120))
    raise ValueError(name)


@pytest.mark.parametrize("op", ["sum", "max", "min", "distinct"])
@pytest.mark.parametrize(
    "name", ["evict", "cut_in_run", "sentinel_word", "empty_update", "high_keys",
             "sentinel_doc0"]
)
def test_merge_batches(name, op):
    st, up = merge_case(name, op)
    js, ts = batch(*st)
    ju, tu = batch(*up)
    jhead, jev = jg.merge_batches(js, ju, op=op, update_sorted=True)
    thead, tev = tg.merge_batches(ts, tu, op=op, update_sorted=True)
    assert_same(jhead, thead)
    assert_same(jev, tev)
    if name in ("evict", "cut_in_run"):
        assert np.asarray(jev.valid).any()


def test_merge_batches_unsorted_update():
    rng = np.random.default_rng(9)
    st = reduced(rng, STATE_CAP, 30)
    js, ts = batch(*st)
    ju, tu = batch(*records(rng, UPDATE_CAP, 20))
    for w, g in zip(jg.merge_batches(js, ju), tg.merge_batches(ts, tu)):
        assert_same(w, g)


def _distinct_update(rng, n: int, sentinel_doc0: bool):
    """n records over 8 keys (half of them >= 2^31) x 5 doc ids in u_cap
    slots, duplicate pairs included; optionally one real record on the
    SENTINEL pair with value 0, the padding's own value."""
    pool = rng.integers(0, 1 << 32, (8, 2), dtype=np.uint64).astype(np.uint32)
    pool[:4, 0] |= np.uint32(0x80000000)
    keys = pool[rng.integers(0, 8, n)]
    docs = rng.integers(0, 5, n).astype(np.int32)
    if sentinel_doc0 and n:
        keys[0] = S
        docs[0] = 0
    return keys, docs


def test_merge_batches_fuzz_distinct_op():
    """The reference's distinct-op fuzz (tests/test_groupby.py:259),
    slot for slot: rounds of count_unique'd updates — a fifth of them
    clamped, as an overflowing chunk is — merged into a small state that
    evicts, on both packages, with a posting-set oracle beside them."""
    rng = np.random.default_rng(7)
    cap, u_cap = 32, 16
    js, ts = batch(*padded([], [], cap))
    oracle: dict = {}
    spilled: set = set()
    clamped_any = False
    for r in range(12):
        n = int(rng.integers(0, u_cap + 1))
        keys, docs = _distinct_update(rng, n, sentinel_doc0=r in (2, 7))
        valid = np.arange(u_cap) < n
        k = np.full((u_cap, 2), S, np.uint32)
        k[:n] = keys
        v = np.zeros(u_cap, np.int32)
        v[:n] = docs
        ju, tu = batch(k[:, 0], k[:, 1], v, valid)
        ju, tu = jg.count_unique(ju, op="distinct"), tg.count_unique(tu, op="distinct")
        assert_same(ju, tu)
        if r in (4, 9):
            clamped_any = True
            keep = jnp.bool_(False)
            import torch

            ju, tu = jg.clamp_batch(ju, keep), tg.clamp_batch(tu, torch.tensor(False))
        else:
            for (a, b), d in zip(keys.tolist(), docs.tolist()):
                oracle.setdefault((a, b), set()).add(d)
        js, jev = jg.merge_batches(js, ju, op="distinct", update_sorted=True)
        ts, tev = tg.merge_batches(ts, tu, op="distinct", update_sorted=True)
        assert_same(js, ts)
        assert_same(jev, tev)
        ekeys, evals = tev.to_host()
        for (a, b), d in zip(map(tuple, ekeys.tolist()), evals.tolist()):
            spilled.add((a, b, d))
            oracle[(a, b)].remove(d)  # KeyError = a wrong eviction
            if not oracle[(a, b)]:
                del oracle[(a, b)]
    got: dict = {}
    skeys, svals = ts.to_host()
    for (a, b), d in zip(map(tuple, skeys.tolist()), svals.tolist()):
        got.setdefault((a, b), set()).add(d)
    assert got == oracle
    assert spilled and clamped_any
    # The doc-0 record on the SENTINEL pair survived, in state or spilled.
    assert (S, S, 0) in spilled or 0 in got.get((S, S), ())


def test_merge_batches_distinct_unsorted_update():
    """The host engine's packed merge: an unsorted update whose padding
    carries SENTINEL values, count_unique'd by (key, value) inside."""
    rng = np.random.default_rng(11)
    st = reduced(rng, STATE_CAP, 30, op="distinct")
    js, ts = batch(*st)
    keys, docs = _distinct_update(rng, 20, sentinel_doc0=True)
    k = np.full((UPDATE_CAP, 2), S, np.uint32)
    k[:20] = keys
    v = np.full(UPDATE_CAP, -1, np.int32)
    v[:20] = docs
    ju, tu = batch(k[:, 0], k[:, 1], v, np.arange(UPDATE_CAP) < 20)
    for w, g in zip(jg.merge_batches(js, ju, op="distinct"),
                    tg.merge_batches(ts, tu, op="distinct")):
        assert_same(w, g)


def test_combine_adjacent_unique_distinct():
    """combine_adjacent_unique on a rank-merged (state, update) pair that
    shares (key, value) pairs, differs in value on shared keys, and holds
    a doc-0 record on the SENTINEL pair on the update side."""
    op = "distinct"
    rng = np.random.default_rng(5)
    st = reduced(rng, STATE_CAP, 50, op=op, key_pool=20)
    keys, docs = _distinct_update(rng, UPDATE_CAP, sentinel_doc0=True)
    j, _ = batch(keys[:, 0], keys[:, 1], docs, np.ones(UPDATE_CAP, bool))
    up = [np.asarray(x) for x in jg.count_unique(j, op=op)]
    js, ts = batch(*st)
    ju, tu = batch(*up)
    jm = jg.merge_sorted_runs(js, ju, by_value=True)
    tm = tg.merge_sorted_runs(ts, tu, by_value=True)
    assert_same(jm, tm)
    assert_same(jg.combine_adjacent_unique(jm, op=op), tg.combine_adjacent_unique(tm, op=op))


def test_pack_keys_orders_unsigned_pairs():
    import torch

    k = np.array([[0, 0], [0, S], [1, 0], [0x7FFFFFFF, S], [0x80000000, 0],
                  [S, S - 1], [S, S]], np.uint32)
    t = KVBatch.from_numpy(k[:, 0], k[:, 1], np.zeros(7), np.ones(7), "cpu")
    packed = tg.pack_keys(t.k1, t.k2)
    assert torch.equal(torch.sort(packed).values, packed)
    assert packed[-1].item() == torch.iinfo(torch.int64).max


def test_kvbatch_round_trip_keeps_uint32():
    k1 = np.array([0, 1, 0x80000000, S], np.uint32)
    t = KVBatch.from_numpy(k1, k1[::-1], [1, 2, 3, 4], [1, 0, 1, 1], "cpu")
    back = t.to_numpy()
    assert back[0].dtype == np.uint32 and np.array_equal(back[0], k1)
    keys, vals = t.to_host()
    assert keys.dtype == np.uint32
    assert keys.tolist() == [[0, S], [0x80000000, 1], [S, 0]]
    assert vals.tolist() == [1, 3, 4]
