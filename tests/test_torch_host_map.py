"""The port's host-map engine (map_engine="host") against the JAX package's.

One seeded corpus (two text files with unicode, punctuation and CRLF, and a
whitespace-free run that forces window cuts) goes through both packages'
``run_job(map_engine="host", device="cpu")`` in two configurations:
"coalesce" (default dispatch: async, coalescing) and "evict" (a state small
enough to evict on most merges, sync dispatch, no coalescing). The
``mr-{r}.txt`` files must be byte-identical and the merge-stream counters
equal: the dispatch stream is a pure function of the windows and the
config. Among port runs, outputs and counters are equal across
(host_map_workers, fold_shards) ∈ {1, 2, 4}² and across the four dispatch
modes.

The reference runs with its plain packer ``_pack_update`` in place of its
``_PackStager``: on the CPU, ``jax.device_put`` may alias the stager's
reused buffer, which the next pack then overwrites under a merge still in
flight, so the reference's own stager gives wrong counts on this machine
(seen on two cores in most runs). The port's stager copies on the CPU.
"""

import pathlib
import threading

import numpy as np
import pytest
import torch

from mapreduce_rust_tpu.config import Config as JaxConfig
from mapreduce_rust_tpu.runtime import driver as jax_driver
from mapreduce_rust_tpu_torch.__main__ import main as cli_main
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.core.normalize import reference_word_counts
from mapreduce_rust_tpu_torch.ops.tokenize_cuda import hash_scan, tokenize_hash
from mapreduce_rust_tpu_torch.runtime import driver
from mapreduce_rust_tpu_torch.runtime.driver import _pack_update, _PackStager, run_job

REPO = pathlib.Path(__file__).resolve().parents[1]

#: Config fields both packages run with (small windows and update cap, so
#: a window splits into several merges and the reference's XLA compile of
#: its packed merge stays small).
BASE = dict(map_engine="host", host_update_cap=1 << 10, host_window_bytes=1 << 16,
            reduce_n=4, device="cpu")
CONFIGS = {
    "coalesce": dict(merge_capacity=1 << 15),
    "evict": dict(merge_capacity=1 << 12, dispatch_coalesce=False,
                  dispatch_async=False),
}
COUNTERS = ("distinct_keys", "spilled_keys", "spill_events", "merge_dispatches",
            "merge_fill_frac")


def _text(seed: int, n_words: int, vocab_size: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"w%d" % i for i in range(vocab_size)] + [
        "café".encode(), "naïve".encode(), "Ωmega".encode(), "don’t".encode(),
        "“quoted”".encode(), "end—dash".encode(), "日本語".encode(), b"it's",
        b"x,y", b"--", b"end."]
    seps = [b" ", b" ", b"\t", b"\r\n", b"\n", b"  ", " ".encode()]
    ws = rng.integers(0, len(vocab), n_words).tolist()
    ss = rng.integers(0, len(seps), n_words).tolist()
    return b"".join(vocab[w] + seps[s] for w, s in zip(ws, ss))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("host-corpus")
    (d / "a.txt").write_bytes(_text(1, 90_000, 20_000))
    (d / "b.txt").write_bytes(_text(2, 70_000, 300))
    # 96 KiB of 2-byte letters with no whitespace: a window cut must be
    # forced, at a UTF-8 boundary.
    (d / "c.txt").write_bytes(b"head " + "é".encode() * (48 << 10) + b" tail\n")
    return d


def short(table: dict) -> dict:
    """The table without the pieces of c.txt's 96 KiB token: a forced cut
    splits it where a window ends, which reference_word_counts does not."""
    return {w: c for w, c in table.items() if len(w) < 1024}


@pytest.fixture(scope="module")
def oracle(corpus):
    want = {}
    for path in sorted(corpus.glob("*.txt")):
        for w, c in reference_word_counts(path.read_bytes()).items():
            want[w.encode()] = want.get(w.encode(), 0) + c
    return short(want)


@pytest.fixture(scope="module")
def reference(corpus, tmp_path_factory):
    """config name → the JAX package's host-engine result, computed lazily."""
    cache = {}

    def plain_pack(self, k1, k2, vals):
        return _ref_pack_update(np.stack([k1, k2], axis=1), vals, self.cap)

    _ref_pack_update = jax_driver._pack_update

    def get(name: str):
        if name not in cache:
            out = tmp_path_factory.mktemp(f"ref-host-{name}")
            cfg = JaxConfig(input_dir=str(corpus), output_dir=str(out / "out"),
                            work_dir=str(out / "work"), host_map_workers=2,
                            fold_shards=2, **BASE, **CONFIGS[name])
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_driver._PackStager, "pack", plain_pack)
                cache[name] = jax_driver.run_job(cfg)
        return cache[name]

    return get


def port_run(corpus, out, name: str, **kw):
    cfg = Config(input_dir=str(corpus), output_dir=str(out / "out"),
                 work_dir=str(out / "work"), **{**BASE, **CONFIGS[name], **kw})
    return run_job(cfg)


#: Port-only configurations: default dispatch with a state small enough to
#: evict, for the (W, S) matrix, and each of the four dispatch modes.
MATRIX = dict(merge_capacity=1 << 13)
DISPATCH = {
    "async+coalesce": dict(dispatch_async=True, dispatch_coalesce=True),
    "async": dict(dispatch_async=True, dispatch_coalesce=False),
    "sync+coalesce": dict(dispatch_async=False, dispatch_coalesce=True),
    "sync": dict(dispatch_async=False, dispatch_coalesce=False),
}


@pytest.fixture(scope="module")
def baseline(corpus, tmp_path_factory):
    """dispatch mode → the port's result at (W, S) = (1, 1) with the small
    MATRIX state, computed lazily."""
    cache = {}

    def get(mode: str):
        if mode not in cache:
            out = tmp_path_factory.mktemp(f"port-host-{mode.replace('+', '-')}")
            cache[mode] = port_run(corpus, out, "coalesce", host_map_workers=1,
                                   fold_shards=1, **MATRIX, **DISPATCH[mode])
        return cache[mode]

    return get


def file_bytes(res) -> list[bytes]:
    return [pathlib.Path(p).read_bytes() for p in res.output_files]


def assert_same_run(got, want, counters=COUNTERS):
    assert [pathlib.Path(p).name for p in got.output_files] == \
        [pathlib.Path(p).name for p in want.output_files]
    assert file_bytes(got) == file_bytes(want)
    for field in counters:
        assert getattr(got.stats, field) == getattr(want.stats, field), field


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_matches_reference(corpus, oracle, reference, tmp_path, name):
    ref = reference(name)
    before = hash_scan.launches, tokenize_hash.launches
    res = port_run(corpus, tmp_path, name, host_map_workers=2, fold_shards=2)
    assert (hash_scan.launches, tokenize_hash.launches) == before  # no scan kernel
    assert_same_run(res, ref)
    s = res.stats
    assert res.table == ref.table and short(res.table) == oracle
    assert s.unknown_keys == 0 and s.hash_collisions == 0
    assert s.forced_cuts == ref.stats.forced_cuts > 0
    assert s.chunks == ref.stats.chunks and s.bytes_in == ref.stats.bytes_in
    assert s.dictionary_words == ref.stats.dictionary_words
    assert s.dispatch_mode == ref.stats.dispatch_mode
    assert s.host_arena_bytes > 0 and s.host_map_s > 0
    assert (s.host_map_workers, s.fold_shards) == (2, 2)
    if name == "evict":
        assert s.spilled_keys > 0 and s.merge_dispatches > s.chunks


@pytest.mark.parametrize("workers,shards", [(w, s) for w in (1, 2, 4) for s in (1, 2, 4)])
def test_worker_shard_matrix(corpus, oracle, baseline, tmp_path, workers, shards):
    """Default dispatch: the same outputs and merge stream for any (W, S)."""
    res = port_run(corpus, tmp_path, "coalesce", host_map_workers=workers,
                   fold_shards=shards, **MATRIX)
    assert_same_run(res, baseline("async+coalesce"))
    assert short(res.table) == oracle and res.stats.spilled_keys > 0
    assert (res.stats.host_map_workers, res.stats.fold_shards) == (workers, shards)


@pytest.mark.parametrize("mode", sorted(DISPATCH))
def test_dispatch_matrix(corpus, oracle, baseline, tmp_path, mode):
    """Each dispatch mode: (1, 1) and (4, 4) give the same merge stream;
    every mode gives the same outputs; coalescing ships fewer merges."""
    base = baseline(mode)
    res = port_run(corpus, tmp_path, "coalesce", host_map_workers=4, fold_shards=4,
                   **MATRIX, **DISPATCH[mode])
    assert_same_run(res, base)
    assert_same_run(res, baseline("async+coalesce"), counters=("distinct_keys",))
    assert short(res.table) == oracle and res.stats.unknown_keys == 0
    assert res.stats.dispatch_mode == mode
    if DISPATCH[mode]["dispatch_coalesce"]:
        plain = baseline(mode.replace("+coalesce", ""))
        assert res.stats.merge_dispatches < plain.stats.merge_dispatches


def test_pack_stager_matches_pack_update():
    cap = 64
    rng = np.random.default_rng(7)
    stager = _PackStager(cap, torch.device("cpu"))
    assert not stager.needs_barrier
    # Big, then small, then empty, then mid, full, tiny: the re-sentineled
    # tail must make every pack byte-identical to the fresh-buffer packer.
    for n in (60, 3, 0, 17, 64, 1, 40):
        keys = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
        vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        got = stager.pack(keys[:, 0], keys[:, 1], vals)
        want = _pack_update(keys, vals, cap)
        assert got.dtype == want.dtype and np.array_equal(got, want), n
        assert np.array_equal(want, jax_driver._pack_update(keys, vals, cap))
        dev = stager.to_device()
        assert dev.dtype == torch.int32
        assert np.array_equal(dev.numpy().view(np.uint32), want)
        stager.flat[:] = 0  # the device copy must not alias the buffer
        assert np.array_equal(dev.numpy().view(np.uint32), want)
        stager.flat[:] = want


def test_packed_merge_valid_mask_and_sentinel_pad():
    from mapreduce_rust_tpu_torch.apps.word_count import WordCount
    from mapreduce_rust_tpu_torch.core.kv import KVBatch

    cap = 8
    merge = driver.make_packed_merge_fn(WordCount(), cap)
    keys = np.array([[5, 1], [2, 7], [5, 1]], dtype=np.uint32)
    flat = torch.from_numpy(_pack_update(keys, np.array([1, 2, 3], np.uint32), cap)
                            .view(np.int32).copy())
    state, evicted, ev = merge(KVBatch.empty(4, "cpu"), flat)
    k1, k2, v, valid = state.to_numpy()
    assert valid.tolist() == [True, True, False, False]
    assert [(int(a), int(b), int(c)) for a, b, c in zip(k1[:2], k2[:2], v[:2])] == \
        [(2, 7, 2), (5, 1, 4)]
    assert int(ev) == 0 and not evicted.valid.any()


def test_dispatch_failure_surfaces_and_unwinds(corpus, tmp_path, monkeypatch):
    calls = [0]
    real = driver._DispatchPlane._dispatch

    def boom(self, *args):
        calls[0] += 1
        if calls[0] >= 3:
            raise ValueError("seeded dispatch failure")
        return real(self, *args)

    monkeypatch.setattr(driver._DispatchPlane, "_dispatch", boom)
    before = {t.name for t in threading.enumerate()}
    for mode in ("async", "sync"):
        calls[0] = 0
        with pytest.raises(ValueError, match="seeded dispatch failure"):
            port_run(corpus, tmp_path / mode, "coalesce", host_map_workers=2,
                     fold_shards=2, **MATRIX, **DISPATCH[mode])
    left = {t.name for t in threading.enumerate()} - before
    assert not {n for n in left if n.startswith(("mr/dispatch", "mr/fold", "mr/scan"))}


def test_fold_failure_surfaces_and_unwinds(corpus, tmp_path, monkeypatch):
    def boom(shard, item):
        raise KeyError("seeded fold failure")

    monkeypatch.setattr(driver._FoldShardPlane, "_fold_one", staticmethod(boom))
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(KeyError, match="seeded fold failure"):
        port_run(corpus, tmp_path, "coalesce", host_map_workers=2, fold_shards=3)
    left = {t.name for t in threading.enumerate()} - before
    assert not {n for n in left if n.startswith(("mr/dispatch", "mr/fold", "mr/scan"))}


def test_cli_host_engine(corpus, reference, tmp_path, capsys):
    ref = reference("coalesce")
    out = tmp_path / "out"
    assert cli_main(["run", "--device", "cpu", "--map-engine", "host",
                     "--input", str(corpus), "--output", str(out),
                     "--work", str(tmp_path / "work"), "--reduce-n", "4",
                     "--host-workers", "2", "--fold-shards", "2",
                     "--no-dispatch-coalesce", "--sync-dispatch",
                     "--dispatch-fill-frac", "0.25"]) == 0
    printed = capsys.readouterr().out
    assert "unknown=0" in printed and "sync]" in printed
    # The CLI's default 16 MiB window cuts c.txt's long token elsewhere:
    # compare every other word.
    got = {}
    for path in sorted(out.glob("mr-*.txt")):
        for line in path.read_bytes().splitlines():
            w, v = line.rsplit(b" ", 1)
            got[w] = int(v)
    assert short(got) == short(ref.table)
    assert [p.name for p in sorted(out.glob("mr-*.txt"))] == \
        [pathlib.Path(p).name for p in ref.output_files]


@pytest.mark.parametrize("field,value", [
    ("map_engine", "bogus"), ("host_map_workers", 0), ("fold_shards", 0),
    ("dispatch_fill_frac", 0.0), ("dispatch_fill_frac", 1.5),
    ("dispatch_stage_cap", 0), ("host_update_cap", 0),
])
def test_config_validates_host_fields(field, value):
    with pytest.raises(ValueError, match=field):
        Config(**{field: value})


def test_config_resolves_like_reference(monkeypatch):
    for kw in (dict(), dict(host_map_workers=3, fold_shards=5),
               dict(dispatch_stage_cap=10), dict(dispatch_stage_cap=1 << 20)):
        port, ref = Config(**kw), JaxConfig(**kw)
        for fn in ("effective_host_map_workers", "effective_fold_shards",
                   "effective_dispatch_stage_cap"):
            assert getattr(port, fn)() == getattr(ref, fn)(), (kw, fn)
    monkeypatch.setenv("MR_DISPATCH_SYNC", "1")
    from mapreduce_rust_tpu_torch.config import sync_dispatch_forced

    assert sync_dispatch_forced()
