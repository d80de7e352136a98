"""The port's halo exchange and with-length tokenizer against the JAX
package's, on the CPU.

Same seeded inputs through both packages, exact throughout: the
token-length lane at every position, the sharded tokenizer's per-shard
records and truncation counts for D = 1..4 with words straddling every
seam and unicode, the truncation guard, empty and all-space shards, and
``sharded_stream`` jobs byte-identical with equal halo counters.
"""

import collections
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from mapreduce_rust_tpu.apps import get_app as jax_get_app
from mapreduce_rust_tpu.config import Config as JaxConfig
from mapreduce_rust_tpu.ops.tokenize import (
    tokenize_and_hash_with_len as jax_tokenize_with_len,
    tokenize_reference_host,
)
from mapreduce_rust_tpu.parallel import halo as jax_halo
from mapreduce_rust_tpu.parallel.shuffle import make_mesh as jax_make_mesh
from mapreduce_rust_tpu.runtime.driver import enable_compilation_cache
from mapreduce_rust_tpu.runtime.driver import run_job as jax_run_job
from mapreduce_rust_tpu_torch.apps import get_app
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.core.normalize import normalize_unicode
from mapreduce_rust_tpu_torch.ops.tokenize import (
    token_len,
    token_len_reference,
    tokenize_and_hash_with_len,
)
from mapreduce_rust_tpu_torch.parallel import halo
from mapreduce_rust_tpu_torch.parallel.shuffle import make_mesh
from mapreduce_rust_tpu_torch.runtime.driver import run_job

_jax_with_len = jax.jit(jax_tokenize_with_len)


@pytest.fixture(scope="module", autouse=True)
def _xla_cache():
    """The reference's persistent XLA compile cache (the checkout's
    .jax_cache), on before this file's first jit as its run_job would turn
    it on: the direct shard_map calls here then compile once per machine."""
    enable_compilation_cache()

TEXT = (b"alpha bravo charlie delta echo foxtrot golf hotel india juliet "
        b"kilo lima mike november oscar papa quebec romeo sierra tango ") * 8
UNICODE = normalize_unicode(
    "naïve café — don’t “stop” straddle Ωmega ".encode() * 30)


def _noise(seed: int, n: int) -> bytes:
    """Bytes of words, punctuation, runs of whitespace and long tokens."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcxyz09_'-.,  \t\n\r\xc3\xa9", dtype=np.uint8)
    data = alphabet[rng.integers(0, len(alphabet), n)].tobytes()
    return data[: n // 2] + b"z" * 90 + data[n // 2:]


@pytest.mark.parametrize("last_is_boundary", [True, False])
def test_with_len_matches_reference_at_every_position(last_is_boundary):
    for data in (_noise(1, 5000), UNICODE, b"word", b"   ", b"x"):
        kv, tlen = _jax_with_len(np.frombuffer(data, dtype=np.uint8),
                                 last_is_boundary=last_is_boundary)
        chunk = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        pkv, ptlen = tokenize_and_hash_with_len(chunk, last_is_boundary)
        assert np.array_equal(ptlen.numpy(), np.asarray(tlen))
        assert np.array_equal(token_len_reference(chunk).numpy(), np.asarray(tlen))
        assert np.array_equal(pkv.k1.numpy().view(np.uint32), np.asarray(kv.k1))
        assert np.array_equal(pkv.k2.numpy().view(np.uint32), np.asarray(kv.k2))
        assert np.array_equal(pkv.value.numpy(), np.asarray(kv.value))
        assert np.array_equal(pkv.valid.numpy(), np.asarray(kv.valid))
    assert token_len(torch.frombuffer(bytearray(b"ab  c"), dtype=torch.uint8)).tolist() \
        == [1, 2, 0, 0, 1]


def _both_tokenize(data: bytes, d: int, halo_bytes: int, pad=None):
    """(port per-shard arrays + trunc, reference's), as host arrays [D, W]."""
    jmesh = jax_make_mesh(d, "cpu")
    jkv, jtrunc = jax_halo.make_sharded_tokenizer(jmesh, halo_bytes)(
        jax_halo.shard_stream(data, jmesh, pad))
    mesh = make_mesh(d, "cpu")
    shards = halo.shard_stream(data, mesh, pad)
    kvs, trunc = halo.make_sharded_tokenizer(mesh, halo_bytes)(list(torch.from_numpy(shards)))
    got = (np.stack([kv.k1.numpy().view(np.uint32) for kv in kvs]),
           np.stack([kv.k2.numpy().view(np.uint32) for kv in kvs]),
           np.stack([kv.value.numpy() for kv in kvs]),
           np.stack([kv.valid.numpy() for kv in kvs]), trunc.numpy())
    want = (*(np.asarray(x) for x in jkv), np.asarray(jtrunc))
    return got, want


def _counts(arrays) -> dict:
    k1, k2, _v, valid, _t = arrays
    out: dict = collections.defaultdict(int)
    for a, b in zip(k1[valid].tolist(), k2[valid].tolist()):
        out[(a, b)] += 1
    return dict(out)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_sharded_tokenizer_matches_reference(d):
    # A 65-byte unit against shard widths that put edges mid-word, and
    # multi-byte UTF-8 sequences cut anywhere.
    word = b"straddlingword"
    data = (b"x " * 25 + word + b" ") * 20 + UNICODE + TEXT
    base = -(-len(data) // d)
    for delta in (0, 7):
        got, want = _both_tokenize(data, d, 32, pad=base + delta)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert _counts(got) == tokenize_reference_host(data)
        assert not got[4].any()


def test_truncation_guard_fires():
    data = b"a " + b"y" * 40 + b" b c d e f g h i j k l m n o p q r s t"
    got, want = _both_tokenize(data, 4, 8, pad=32)  # the 40-byte token spans shards
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[4].sum() > 0


@pytest.mark.parametrize("data,d", [(b"", 4), (b"   \n\t  ", 3)])
def test_empty_and_all_space_shards(data, d):
    got, want = _both_tokenize(data, d, 16, pad=32)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert not got[3].any() and not got[4].any()
    with pytest.raises(ValueError, match="halo"):
        halo.make_sharded_tokenizer(make_mesh(d, "cpu"), 64)(
            list(torch.from_numpy(halo.shard_stream(data, make_mesh(d, "cpu"), 32))))


def _run(package, d, out, app="word_count", **kw):
    cfg_kw = dict(device="cpu", input_dir=str(d), output_dir=str(out / "out"),
                  work_dir=str(out / "work"), reduce_n=3, mesh_shape=4,
                  sharded_stream=True, **kw)
    inputs = sorted(str(p) for p in pathlib.Path(d).glob("*.txt"))
    if package == "jax":
        return jax_run_job(JaxConfig(**cfg_kw), inputs, app=jax_get_app(app))
    return run_job(Config(**cfg_kw), inputs, app=get_app(app))


def _files(res) -> list:
    return [(os.path.basename(p), pathlib.Path(p).read_bytes()) for p in res.output_files]


HALO_FIELDS = ("halo_truncations", "mesh_rounds", "forced_cuts", "shuffle_wire_bytes",
               "mesh_shard_rows", "distinct_keys", "partial_overflow_replays",
               "bucket_skew_replays", "chunks", "unknown_keys")


@pytest.mark.parametrize("case", ["exact", "truncating"])
def test_sharded_stream_job_matches_reference(tmp_path, case):
    # "exact": unicode and punctuation over several 4 KiB groups, windows
    # of 16 KiB, an inverted index; "truncating": an 8-byte halo against
    # 18- to 42-byte words, which straddle shard seams and are counted.
    d = tmp_path / "in"
    d.mkdir()
    rng = np.random.default_rng(5)
    if case == "exact":
        vocab = [b"w%d" % i for i in range(900)] + [
            w.encode() for w in ("café", "naïve", "Ωmega", "don’t", "“q”")]
        for name in ("a", "b"):
            ws = rng.integers(0, len(vocab), 7000).tolist()
            (d / f"{name}.txt").write_bytes(b" ".join(vocab[w] for w in ws) + b"\n")
        kw = dict(chunk_bytes=1 << 12, host_window_bytes=1 << 14, merge_capacity=1 << 12)
        app = "inverted_index"
    else:
        vocab = [(b"long%02d" % i) * (3 + i % 5) for i in range(40)]
        ws = rng.integers(0, len(vocab), 2000).tolist()
        (d / "a.txt").write_bytes(b" ".join(vocab[w] for w in ws))
        kw = dict(chunk_bytes=1 << 10, max_word_len=8)
        app = "word_count"
    want = _run("jax", d, tmp_path / "ref", app, **kw)
    got = _run("port", d, tmp_path / "port", app, **kw)
    assert _files(got) == _files(want)
    for field in HALO_FIELDS:
        assert getattr(got.stats, field) == getattr(want.stats, field), field
    if case == "exact":
        assert got.stats.halo_truncations == 0 and got.stats.mesh_rounds > 4
        one = run_job(Config(device="cpu", input_dir=str(d), reduce_n=3,
                             output_dir=str(tmp_path / "one"),
                             work_dir=str(tmp_path / "onew"), **kw),
                      app=get_app(app))
        assert _files(got) == _files(one)
    else:
        assert got.stats.halo_truncations > 0
