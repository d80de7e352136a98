"""The port's single-process mesh against the JAX package's, on the CPU.

The reference runs its mesh on conftest's 8 virtual CPU devices, the port
puts every shard on the CPU (``device="cpu"``). Inputs are seeded numpy
corpora, and every comparison is exact: the partitioner's arrays and
overflow counts, one map_shuffle + merge step shard by shard, whole
``run_job`` outputs (byte-identical ``mr-{r}.txt``) and the mesh counters
at D = 2 and 4, the replay tiers, a state spill, the top-k selection and
its tie fallback, and checkpoints written by either package and resumed
by the other. Reference results are computed once per module.
"""

import logging
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from mapreduce_rust_tpu.apps import get_app as jax_get_app
from mapreduce_rust_tpu.config import Config as JaxConfig
from mapreduce_rust_tpu.core.kv import KVBatch as JaxKVBatch
from mapreduce_rust_tpu.ops.partition import bucket_scatter as jax_bucket_scatter
from mapreduce_rust_tpu.parallel import shuffle as jax_shuffle
from mapreduce_rust_tpu.runtime import driver as jax_driver
from mapreduce_rust_tpu_torch.apps import get_app
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.core.kv import KVBatch
from mapreduce_rust_tpu_torch.ops.partition import bucket_scatter, splitter_pairs
from mapreduce_rust_tpu_torch.parallel import shuffle
from mapreduce_rust_tpu_torch.runtime import driver
from mapreduce_rust_tpu_torch.runtime.driver import run_job

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _xla_cache():
    """The reference's persistent XLA compile cache (the checkout's
    .jax_cache), on before this file's first jit as its run_job would turn
    it on: the direct shard_map calls here then compile once per machine."""
    jax_driver.enable_compilation_cache()
SENT = 0xFFFFFFFF
#: Config fields every mesh run of this file shares (one XLA compile per
#: app and mesh size on the reference side).
BASE = dict(chunk_bytes=1 << 14, merge_capacity=1 << 14, reduce_n=4)


def _words(rng, vocab, n: int) -> bytes:
    seps = [b" ", b" ", b"\n", b"\t", b"  ", b"\r\n"]
    ws = rng.integers(0, len(vocab), n).tolist()
    ss = rng.integers(0, len(seps), n).tolist()
    return b"".join(vocab[w] + seps[s] for w, s in zip(ws, ss))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three files: high and low cardinality, and unicode with punctuation."""
    rng = np.random.default_rng(20261017)
    d = tmp_path_factory.mktemp("mesh-corpus")
    extra = ["café", "naïve", "Ωmega", "don’t", "“quoted”", "it's", "x,y", "end."]
    (d / "a.txt").write_bytes(_words(rng, [b"w%d" % i for i in range(6000)], 14_000))
    (d / "b.txt").write_bytes(_words(rng, [b"v%d" % i for i in range(150)], 9_000))
    (d / "c.txt").write_bytes(_words(rng, [w.encode() for w in extra] + [b"w7", b"v3"],
                                     6_000))
    return d


def _inputs(d: pathlib.Path) -> list:
    return sorted(str(p) for p in d.glob("*.txt"))


def _run(package: str, d, out, app="word_count", inputs=None, **kw):
    """run_job of one package on corpus dir ``d`` into ``out``."""
    cfg_kw = {**BASE, **kw, "device": "cpu", "input_dir": str(d),
              "output_dir": str(out / "out"), "work_dir": str(out / "work")}
    if package == "jax":
        app_kw = {"k": 20} if app == "top_k" else {}
        return jax_driver.run_job(JaxConfig(**cfg_kw), inputs or _inputs(d),
                                  app=jax_get_app(app, **app_kw))
    return run_job(Config(**cfg_kw), inputs or _inputs(d), app=get_app(app))


def _files(res) -> list:
    return [(os.path.basename(p), pathlib.Path(p).read_bytes()) for p in res.output_files]


MESH_FIELDS = ("distinct_keys", "mesh_rounds", "shuffle_wire_bytes", "mesh_shard_rows",
               "partial_overflow_replays", "bucket_skew_replays", "spill_events",
               "spilled_keys", "unknown_keys", "chunks", "bytes_in")


def assert_same_run(got, want):
    assert _files(got) == _files(want)
    for field in MESH_FIELDS:
        assert getattr(got.stats, field) == getattr(want.stats, field), field
    assert got.stats.unknown_keys == 0


@pytest.fixture(scope="module")
def reference(corpus, tmp_path_factory):
    """(app, D, extra Config items) → the JAX package's mesh run, lazily."""
    cache = {}

    def get(app: str, d: int, **kw):
        key = (app, d, tuple(sorted(kw.items())))
        if key not in cache:
            out = tmp_path_factory.mktemp(f"ref-{app}-{d}")
            cache[key] = _run("jax", corpus, out, app, mesh_shape=d, **kw)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def single(corpus, tmp_path_factory):
    """app → the port's single-device run of the corpus."""
    cache = {}

    def get(app: str):
        if app not in cache:
            cache[app] = _run("port", corpus, tmp_path_factory.mktemp(f"one-{app}"), app)
        return cache[app]

    return get


# ---- the partitioner ------------------------------------------------------


def _batch(n: int, seed: int):
    """(k1, k2, value, valid) host arrays: keys on both sides of 2^31 (and
    the all-ones pattern), a fifth of the records invalid."""
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    k1[: n // 4] = rng.integers(1 << 31, 1 << 32, n // 4, dtype=np.uint64)
    k1[0] = SENT - 1
    k2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    value = rng.integers(-5, 100, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    return k1, k2, value, valid


def _both_scatter(arrays, num_buckets, capacity, mode, splitters=None):
    jb = JaxKVBatch(*(jax.numpy.asarray(a) for a in arrays))
    want, want_ovf = jax_bucket_scatter(
        jb, num_buckets=num_buckets, capacity=capacity, mode=mode,
        splitters=None if splitters is None else splitter_pairs(splitters))
    got, got_ovf = bucket_scatter(
        KVBatch.from_numpy(*arrays, device="cpu"), num_buckets, capacity, mode=mode,
        splitters=None if splitters is None else splitter_pairs(splitters))
    want = tuple(np.asarray(x) for x in want)
    got = (got.k1.numpy().view(np.uint32), got.k2.numpy().view(np.uint32),
           got.value.numpy(), got.valid.numpy())
    assert int(got_ovf) == int(want_ovf)
    return got, want


def _splitters(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2))


@pytest.mark.parametrize("mode", ["hash", "range"])
def test_bucket_scatter_bit_exact(mode):
    # 16 records: the reference's unstable sort keeps input order at this
    # size, so every array compares bit for bit. Capacity 3 fills buckets.
    arrays = _batch(16, 1)
    spl = _splitters(2, 3) if mode == "range" else None
    for capacity in (3, 16):
        got, want = _both_scatter(arrays, 4, capacity, mode, spl)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert got[3].sum() > 0


@pytest.mark.parametrize("mode", ["hash", "range"])
def test_bucket_scatter_matches_reference(mode):
    # 3000 records: the reference's order within a bucket is its unstable
    # sort's, so each bucket's rows compare as a set; validity, padding and
    # the overflow count compare bit for bit. At capacity 600 the buckets
    # overflow, and the kept records are the bucket's own.
    k1, k2, value, valid = arrays = _batch(3000, 3)
    spl = _splitters(4, 5) if mode == "range" else None
    nb = 6
    for capacity in (600, 3000):
        got, want = _both_scatter(arrays, nb, capacity, mode, spl)
        assert np.array_equal(got[3], want[3])
        if mode == "hash":
            route = k1.astype(np.int64) % nb
        else:
            packed = (k1.astype(np.uint64) << np.uint64(32)) | k2.astype(np.uint64)
            route = np.searchsorted(spl, packed, side="right")
        for b in range(nb):
            rows = {tuple(r) for r in zip(k1[valid & (route == b)].tolist(),
                                          k2[valid & (route == b)].tolist(),
                                          value[valid & (route == b)].tolist())}
            keep = got[3][b]
            g = sorted(zip(got[0][b][keep].tolist(), got[1][b][keep].tolist(),
                           got[2][b][keep].tolist()))
            w = sorted(zip(want[0][b][keep].tolist(), want[1][b][keep].tolist(),
                           want[2][b][keep].tolist()))
            assert len(g) == min(len(rows), capacity)
            assert set(g) <= rows and set(w) <= rows
            if len(rows) <= capacity:
                assert g == w
            for lane, fill in ((0, SENT), (1, SENT), (2, 0)):
                assert (got[lane][b][~keep] == fill).all()
                assert (want[lane][b][~keep] == fill).all()


# ---- one shuffle step, shard by shard -------------------------------------


def _chunks(corpus, d: int, n: int) -> np.ndarray:
    raw = b"".join((corpus / f).read_bytes() for f in ("a.txt", "c.txt"))
    out = np.full((d, n), 0x20, dtype=np.uint8)
    for i in range(d):
        piece = raw[i * (n - 64): (i + 1) * (n - 64)]
        piece = piece[: piece.rfind(b" ") + 1]
        out[i, : len(piece)] = np.frombuffer(piece, dtype=np.uint8)
    return out


@pytest.mark.parametrize("app,d,bucket_cap", [
    ("word_count", 4, None), ("inverted_index", 2, None), ("word_count", 4, 8)])
def test_step_state_bit_exact(corpus, app, d, bucket_cap):
    n, cap, u_cap = 1 << 12, 1 << 10, 1 << 10
    bucket_cap = bucket_cap or shuffle.default_bucket_cap(u_cap, d, 2.0)
    chunks = _chunks(corpus, d, n)
    docs = np.arange(1, d + 1, dtype=np.int32)
    mesh = jax_shuffle.make_mesh(d, "cpu")
    shard = NamedSharding(mesh, PartitionSpec(jax_shuffle.AXIS))
    jm, jmerge = jax_shuffle.make_shuffle_step_fns(jax_get_app(app), u_cap, bucket_cap, mesh)
    jlocal, jp, jb = jm(jax.device_put(chunks, shard), jax.device_put(docs, shard))
    jstate, jev, jevc = jmerge(jax_shuffle.sharded_empty_state(mesh, cap), jlocal)

    pmesh = shuffle.make_mesh(d, "cpu")
    pm, pmerge = shuffle.make_shuffle_step_fns(get_app(app), u_cap, bucket_cap, pmesh)
    plocal, pp, pb = pm(list(torch.from_numpy(chunks)), docs.tolist())
    pstate, pev, pevc = pmerge(shuffle.sharded_empty_state(pmesh, cap), plocal)

    assert np.array_equal(pp.numpy(), jax_shuffle.local_rows(jp))
    assert np.array_equal(pb.numpy(), jax_shuffle.local_rows(jb))
    assert np.array_equal(pevc.numpy(), jax_shuffle.local_rows(jevc))
    for want, got in ((jlocal, plocal), (jstate, pstate), (jev, pev)):
        for w, g in zip(jax_shuffle.local_batch(want), shuffle.local_batch(got)):
            assert np.array_equal(g, w)
    k1, _k2, _v, valid = shuffle.local_batch(pstate)
    overflowed = int(pp.sum() + pb.sum()) > 0
    assert overflowed == (bucket_cap == 8)
    if overflowed:
        # The clamp contract: every shard's result is empty, keys included.
        assert not valid.any() and (k1 == SENT).all()
    else:
        assert valid.sum() > 0
        for i in range(d):  # shard i holds only its hash class
            assert (k1[i][valid[i]].astype(np.int64) % d == i).all()
    assert shuffle.shard_fill_counts(pstate) == valid.sum(axis=1).tolist()


def test_make_mesh_places_shards():
    mesh = shuffle.make_mesh(4, "cpu")
    assert mesh.size == 4 and set(mesh.devices) == {torch.device("cpu")}
    assert shuffle.make_mesh(4, "cpu") == mesh and hash(mesh)
    with pytest.raises(ValueError):
        shuffle.make_mesh(0, "cpu")
    assert shuffle.wire_bytes_per_round(4, 24) == jax_shuffle.wire_bytes_per_round(4, 24)
    for u_cap, d, f in ((2048, 4, 2.0), (1000, 3, 0.05), (64, 2, 5.0)):
        assert shuffle.default_bucket_cap(u_cap, d, f) == \
            jax_shuffle.default_bucket_cap(u_cap, d, f)


def test_make_mesh_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shuffle.make_mesh(2, device)


def test_make_mesh_wraps_shards_over_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = shuffle.make_mesh(4, "cuda")
    assert [dev.index for dev in mesh.devices] == [0, 1, 0, 1]
    assert shuffle.make_mesh(None, "cuda").size == 2


# ---- whole jobs -------------------------------------------------------------


@pytest.mark.parametrize("app,d", [
    ("word_count", 2), ("word_count", 4), ("inverted_index", 4), ("top_k", 2)])
def test_mesh_run_matches_reference(corpus, reference, single, tmp_path, app, d):
    want = reference(app, d)
    got = _run("port", corpus, tmp_path, app, mesh_shape=d)
    assert_same_run(got, want)
    s = got.stats
    assert s.mesh_rounds == -(-s.chunks // d) + s.partial_overflow_replays \
        + s.bucket_skew_replays
    assert sum(got.stats.mesh_shard_rows) >= got.stats.distinct_keys
    # ...and the port's own single-device run.
    assert _files(got) == _files(single(app))
    assert got.table == single(app).table


def test_mesh_replays_and_spill_match_reference(tmp_path):
    # a.txt: thousands of distinct words, so its chunks pass a 64-key
    # partial capacity; b.txt: 40 words, whose chunks fit it but overflow
    # 8-record buckets. 512 keys of state spill.
    rng = np.random.default_rng(7)
    d = tmp_path / "in"
    d.mkdir()
    (d / "a.txt").write_bytes(_words(rng, [b"k%05d" % i for i in range(3000)], 3000))
    (d / "b.txt").write_bytes(_words(rng, [b"q%d" % i for i in range(40)], 6000))
    kw = dict(mesh_shape=4, chunk_bytes=2048, partial_capacity=64,
              bucket_capacity_factor=0.5, merge_capacity=512)
    want = _run("jax", d, tmp_path / "ref", **kw)
    got = _run("port", d, tmp_path / "port", **kw)
    assert_same_run(got, want)
    s = got.stats
    assert s.partial_overflow_replays > 0 and s.bucket_skew_replays > 0
    assert s.spill_events > 0
    one = _run("port", d, tmp_path / "one", chunk_bytes=2048)
    assert _files(got) == _files(one)


def test_mesh_top_k_selection_and_tie_fallback(tmp_path, caplog):
    # "sel": word i appears i + 1 times, so no value ties at any shard's
    # k boundary and the per-shard candidates are fetched; "tie": 100
    # words of 7 each, so every boundary ties and the full state is.
    rng = np.random.default_rng(11)
    texts = {
        "sel": b" ".join(b"t%d" % i for i in rng.permutation(
            np.repeat(np.arange(200), np.arange(1, 201))).tolist()),
        "tie": b" ".join(b"u%d" % i for i in rng.permutation(
            np.repeat(np.arange(100), 7)).tolist()),
    }
    for name, text in texts.items():
        d = tmp_path / name
        d.mkdir()
        (d / "x.txt").write_bytes(text + b"\n")
        want = _run("jax", d, tmp_path / f"ref-{name}", "top_k", mesh_shape=2)
        with caplog.at_level(logging.INFO, logger="mapreduce_rust_tpu_torch"):
            caplog.clear()
            got = _run("port", d, tmp_path / f"port-{name}", "top_k", mesh_shape=2)
        assert _files(got) == _files(want)
        one = _run("port", d, tmp_path / f"one-{name}", "top_k")
        assert _files(got) == _files(one)
        said = "candidates fetched" if name == "sel" else "ambiguous"
        assert any(said in r.getMessage() for r in caplog.records), name


def test_mesh_map_engine_host_warns_and_tokenizes_on_device(corpus, single, tmp_path,
                                                             caplog):
    with caplog.at_level(logging.WARNING, logger="mapreduce_rust_tpu_torch"):
        got = _run("port", corpus, tmp_path, mesh_shape=2, map_engine="host")
    assert any("mesh IS the map engine" in r.getMessage() for r in caplog.records)
    assert got.stats.mesh_rounds > 0 and got.stats.fold_shards <= 1
    assert _files(got) == _files(single("word_count"))


# ---- checkpoint / resume ------------------------------------------------------


class _Crash(Exception):
    pass


def _crash_after(module, monkeypatch, n: int) -> list:
    """Make ``module._write_ckpt`` raise right after its n-th checkpoint."""
    real = module._write_ckpt
    written = []

    def wrapper(*args, **kw):
        real(*args, **kw)
        written.append(args[3])  # groups_done
        if len(written) == n:
            raise _Crash()

    monkeypatch.setattr(module, "_write_ckpt", wrapper)
    return written


CKPT = dict(mesh_shape=2, checkpoint_every_groups=1)


@pytest.mark.parametrize("writer,resumer", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_checkpoint_resume(corpus, reference, tmp_path, monkeypatch, caplog,
                           writer, resumer):
    modules = {"port": driver, "jax": jax_driver}
    want = reference("word_count", 2)
    with monkeypatch.context() as m:
        written = _crash_after(modules[writer], m, 2)
        with pytest.raises(_Crash):
            _run(writer, corpus, tmp_path, **CKPT)
    assert written == [1, 2]
    with np.load(tmp_path / "work" / "driver.ckpt.npz") as z:
        assert z["k1"].dtype == z["k2"].dtype == np.uint32
        assert z["k1"].shape == (2, BASE["merge_capacity"] // 2)
        assert int(z["groups_done"]) == 2
    with caplog.at_level(logging.INFO):
        caplog.clear()
        got = _run(resumer, corpus, tmp_path, resume=True, **CKPT)
    assert any("resumed from checkpoint: 2 groups" in r.getMessage()
               for r in caplog.records)
    assert _files(got) == _files(want)
    assert got.stats.distinct_keys == want.stats.distinct_keys
    assert got.stats.mesh_rounds < want.stats.mesh_rounds


def test_checkpoint_of_another_job_starts_fresh(corpus, reference, tmp_path, monkeypatch,
                                                caplog):
    with monkeypatch.context() as m:
        _crash_after(driver, m, 1)
        with pytest.raises(_Crash):
            _run("port", corpus, tmp_path, **{**CKPT, "merge_capacity": 1 << 13})
    with caplog.at_level(logging.WARNING, logger="mapreduce_rust_tpu_torch"):
        got = _run("port", corpus, tmp_path, resume=True, **CKPT)
    assert any("fingerprint mismatch" in r.getMessage() for r in caplog.records)
    want = reference("word_count", 2)
    assert _files(got) == _files(want)
    assert got.stats.mesh_rounds == want.stats.mesh_rounds


@pytest.mark.parametrize("op", ["sum", "distinct"])
def test_accumulator_snapshot_matches_reference(op):
    rng = np.random.default_rng(13)
    port, ref = driver.HostAccumulator(op), jax_driver.HostAccumulator(op)
    for _ in range(4):  # empty first, then keys whose two halves repeat
        for g, w in zip(port.snapshot(), ref.snapshot()):
            assert np.array_equal(g, w) and g.dtype == w.dtype
        keys = rng.integers(0, 1 << 32, (200, 2), dtype=np.uint64).astype(np.uint32)
        keys[100:] = keys[:100]
        vals = rng.integers(0, 9, 200)
        port.add(keys, vals)
        ref.add(keys, vals)


def test_checkpoint_refuses_budgets_and_sharded(corpus, tmp_path):
    with pytest.raises(ValueError, match="checkpoint/resume"):
        _run("port", corpus, tmp_path, host_accum_budget_mb=1, **CKPT)
    with pytest.raises(ValueError, match="sharded-stream"):
        _run("port", corpus, tmp_path, mesh_shape=2, sharded_stream=True, resume=True)


# ---- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("flags", [["--mesh", "4"], ["--mesh", "4", "--sharded"]])
def test_cli_mesh(corpus, single, tmp_path, flags):
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "mapreduce_rust_tpu_torch", "run", "--device", "cpu",
         "--input", str(corpus), "--output", str(out), "--work", str(tmp_path / "work"),
         "--reduce-n", "4", "--chunk-mb", "0.015625", *flags],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "unknown=0" in r.stdout
    got = [(p.name, p.read_bytes()) for p in sorted(out.glob("mr-*.txt"))]
    assert got == _files(single("word_count"))
