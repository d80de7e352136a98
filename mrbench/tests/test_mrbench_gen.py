"""The generators and the pool: one seed gives one set of bytes, the
generator's counts are the file's counts, every seed gets the same sizes."""

from __future__ import annotations

import collections
import json

import numpy as np
import pytest

from mrbench import gen, pool
from mrbench.tests.conftest import ROOT, TINY_TRAFFIC, TINY_ZIPF_RANKS

SEED = 2**33 + 1234567  # a seed may need more than 32 bits


def _params(config: str) -> dict:
    with open(ROOT / "mrbench" / "configs" / f"{config}.json") as f:
        c = json.load(f)
    p = dict(c["generator_params"])
    if c["generator"] == "zipf":
        p["ranks"] = TINY_ZIPF_RANKS
    return c["generator"], p


CONFIGS = ["wordcount-zipf", "wordcount-hibench"]


@pytest.mark.parametrize("config", CONFIGS)
def test_same_seed_same_bytes(config):
    name, params = _params(config)
    g = gen.load(name)
    a = g.generate(params, SEED, 3, 200_000, "cpu")
    b = g.generate(params, SEED, 3, 200_000, "cpu")
    c = g.generate(params, SEED + 1, 3, 200_000, "cpu")
    d = g.generate(params, SEED, 4, 200_000, "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0][:1000], c[0][:1000])
    assert not np.array_equal(a[0][:1000], d[0][:1000])
    assert g.vocabulary(params, SEED) == g.vocabulary(params, SEED)


@pytest.mark.parametrize("config", CONFIGS)
def test_counts_equal_a_recount(config):
    name, params = _params(config)
    g = gen.load(name)
    data, ids, counts = g.generate(params, SEED, 0, 300_000, "cpu")
    assert 0.99 * 300_000 < len(data) <= 300_000
    words = g.vocabulary(params, SEED)
    recount = collections.Counter(data.tobytes().split())
    assert recount == {words[i]: c for i, c in zip(ids.tolist(), counts.tolist())}
    assert (counts > 0).all()


def test_randomtext_lines_and_words():
    name, params = _params("wordcount-hibench")
    g = gen.load(name)
    words = g.vocabulary(params, SEED)
    other = g.vocabulary(params, SEED + 7)
    assert len(words) == len(set(words)) == 1000
    assert sorted(map(len, words)) == sorted(map(len, other))  # same work per seed
    assert words != other
    assert all(w.isalpha() and 2 <= len(w) <= 20 for w in words)
    capitals = [w for w in words if not w.islower()]
    assert len(capitals) == params["capitalised"]
    assert all(w[:1].isupper() and w[1:].islower() for w in capitals)
    assert 9.5 < np.mean([len(w) for w in words]) < 9.8
    data, _, _ = g.generate(params, SEED, 0, 400_000, "cpu")
    text = data.tobytes()
    assert text.endswith(b"\n")
    keys, values = set(), set()
    for line in text.split(b"\n")[:-1]:
        key, value = line.split(b"\t")
        keys.add(len(key.split(b" ")))
        values.add(len(value.split(b" ")))
    # lo + nextInt(hi - lo): the upper end is never drawn.
    assert keys == set(range(5, 10)) and values == set(range(20, 100))


def test_zipf_words_take_natural_lengths():
    name, params = _params("wordcount-zipf")
    g = gen.load(name)
    full = dict(params, ranks=2**21)
    lens = g.lengths(full)
    assert (np.diff(lens) >= 0).all()        # the more frequent, the shorter
    p = np.arange(1, 2**21 + 1, dtype=np.float64) ** -full["s"]
    assert 4.7 < float((lens * p).sum() / p.sum()) < 4.95  # the table's 4.79
    data, ids, counts = g.generate(params, SEED, 0, 80_000, "cpu")
    text = data.tobytes()
    assert 79_900 < len(data) <= 80_000 and text.endswith(b" ")
    assert {len(w) for w in text.split()} == set(g.lengths(params)[ids].tolist())
    assert 5.2 < len(data) / counts.sum() < 6.4  # bytes a token, its space with it
    assert ids.max() < TINY_ZIPF_RANKS
    # A chunk cut falls inside a word as often as in prose.
    cuts = np.arange(1000, len(data), 1000)
    inside = (data[cuts - 1] != ord(" ")) & (data[cuts] != ord(" "))
    assert 0.5 < inside.mean() < 0.95


def test_zipf_vocabulary_has_distinct_keys():
    # The configuration's own 2**21 words: the program tells them apart by key.
    name, params = _params("wordcount-zipf")
    params["ranks"] = 2**21
    words = gen.load(name).vocabulary(params, SEED)
    assert len(words) == 2**21 == len(set(words))
    assert all(w.isalpha() and w.islower() for w in words)
    from mrbench.reference import hashing

    key = (hashing.lane(words, 0).astype(np.uint64) << np.uint64(32)) | hashing.lane(words, 1)
    assert len(np.unique(key)) == len(words)


@pytest.mark.parametrize("mix", sorted(TINY_TRAFFIC))
def test_pool_sizes_and_order(mix):
    sizes = pool.plan_sizes(TINY_TRAFFIC[mix])
    assert sizes == pool.plan_sizes(TINY_TRAFFIC[mix])
    n = len(sizes)
    step = pool.stride(n)
    p = pool.Pool(files=[""] * n, truth=[], words=[], parts=np.zeros(0), warmup="",
                  offset=5 % n, step=step)
    order = [p.file_for(k) for k in range(2 * n)]
    assert sorted(order[:n]) == list(range(n))       # each file once a cycle
    if n > 1:
        assert all(a != b for a, b in zip(order, order[1:]))


@pytest.mark.parametrize("config", CONFIGS)
def test_pool_build_holds_files_and_truth(config):
    with open(ROOT / "mrbench" / "configs" / f"{config}.json") as f:
        c = json.load(f)
    if c["generator"] == "zipf":
        c["generator_params"]["ranks"] = TINY_ZIPF_RANKS
    p = pool.build(c, TINY_TRAFFIC["64m"], SEED, "cpu", 4)
    assert len(p.files) == TINY_TRAFFIC["64m"]["pool_files"]
    for path, (ids, counts) in zip(p.files, p.truth):
        raw = open(path, "rb").read()
        assert p.nbytes(p.files.index(path)) == len(raw)
        assert collections.Counter(raw.split()) == {
            p.words[i]: c for i, c in zip(ids.tolist(), counts.tolist())}
    assert (p.parts >= 0).all() and (p.parts < 4).all()
    p.close()
    assert not p.fds
