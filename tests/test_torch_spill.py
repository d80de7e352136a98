"""The port's spill tiers and streaming egress against the JAX package's.

- Run format: the same word map and token give byte-identical
  ``dictrun``/``accrun`` files through both packages, each reads the
  other's, and varints round-trip.
- Merge: ``merge_sources`` over key-disjoint sources (empty ones and keys
  of 2^63 and above included) yields the reference's blocks.
- Tiers: a budgeted ``HostAccumulator`` folds to the reference's rows for
  every op; a budgeted ``Dictionary`` holds the reference's sorted words
  and count; point probes on a spilled dictionary raise.
- Jobs: ``run_job`` with ``host_accum_budget_mb=0`` and
  ``dictionary_budget_words=512`` writes ``mr-*.txt`` byte-identical to
  the reference's budgeted run and to the port's unbudgeted run, for every
  app (word_count on both engines; top_k through the rehydrate path),
  with both tiers engaged, the same counters, and no run file or writer
  thread left behind — also when the job raises mid-stream.

The reference's host engine runs with its plain packer ``_pack_update``
in place of its ``_PackStager`` (see tests/test_torch_host_map.py). Its
reference runs are computed once per module, at a merge capacity of 2^9.
"""

import glob
import pathlib
import threading

import numpy as np
import pytest

from mapreduce_rust_tpu.apps import get_app as jax_get_app
from mapreduce_rust_tpu.config import Config as JaxConfig
from mapreduce_rust_tpu.runtime import driver as jax_driver
from mapreduce_rust_tpu.runtime import spill as jax_spill
from mapreduce_rust_tpu.runtime.dictionary import Dictionary as JaxDictionary
from mapreduce_rust_tpu_torch.__main__ import main as cli_main
from mapreduce_rust_tpu_torch.apps import get_app
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.runtime import driver
from mapreduce_rust_tpu_torch.runtime import spill
from mapreduce_rust_tpu_torch.runtime.dictionary import Dictionary, ShardedDictionary
from mapreduce_rust_tpu_torch.runtime.driver import HostAccumulator, run_job

BUDGETS = dict(host_accum_budget_mb=0, dictionary_budget_words=512)
BASE = dict(chunk_bytes=8192, merge_capacity=1 << 9, reduce_n=4, device="cpu")
HOST = dict(map_engine="host", host_update_cap=1 << 10, host_window_bytes=1 << 14,
            host_map_workers=2, fold_shards=2)
#: case → (app name, app kwargs, engine fields, join?)
CASES = {
    "word_count-device": ("word_count", {}, {}, False),
    "word_count-host": ("word_count", {}, HOST, False),
    "inverted_index": ("inverted_index", {}, {}, False),
    "grep": ("grep", {"query": ("w7", "w1234", "café", "nothere")}, {}, False),
    "join": ("join", {}, HOST, True),
    "sort": ("sort", {}, {}, False),
    "top_k": ("top_k", {"k": 25}, {}, False),
}
#: grep's dictionary holds only its query words: a budget of 2 spills it.
GREP_BUDGETS = dict(host_accum_budget_mb=0, dictionary_budget_words=2)
COUNTERS = ("distinct_keys", "dictionary_words", "unknown_keys", "hash_collisions",
            "spilled_keys", "spill_events", "chunks", "bytes_in")


def _text(seed: int, n_words: int, vocab_size: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"w%d" % i for i in range(vocab_size)] + [
        "café".encode(), "naïve".encode(), "Ωmega".encode(), "don’t".encode(),
        b"it's", b"x,y", b"--", b"end."]
    seps = [b" ", b" ", b"\t", b"\r\n", b"\n"]
    ws = rng.integers(0, len(vocab), n_words).tolist()
    ss = rng.integers(0, len(seps), n_words).tolist()
    return b"".join(vocab[w] + seps[s] for w, s in zip(ws, ss))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three files in ``all/``; ``a/`` holds the first two, ``b/`` the third
    (join's two corpora)."""
    d = tmp_path_factory.mktemp("spill-corpus")
    for sub in ("all", "a", "b"):
        (d / sub).mkdir()
    for i, (seed, n, v) in enumerate(((1, 12_000, 3000), (2, 9_000, 2000), (3, 6_000, 400))):
        blob = _text(seed, n, v)
        (d / "all" / f"doc-{i}.txt").write_bytes(blob)
        (d / ("a" if i < 2 else "b") / f"doc-{i}.txt").write_bytes(blob)
    return d


def _cfg_kw(corpus, out: pathlib.Path, case: str, **kw) -> dict:
    _app, _akw, engine, join = CASES[case]
    where = (dict(input_dirs=(("a", str(corpus / "a")), ("b", str(corpus / "b"))))
             if join else dict(input_dir=str(corpus / "all")))
    return dict(**BASE, **engine, **where, output_dir=str(out / "out"),
                work_dir=str(out / "work"), **kw)


@pytest.fixture(scope="module")
def reference(corpus, tmp_path_factory):
    """case → the JAX package's budgeted run, computed lazily."""
    cache = {}
    ref_pack = jax_driver._pack_update

    def plain_pack(self, k1, k2, vals):
        return ref_pack(np.stack([k1, k2], axis=1), vals, self.cap)

    def get(case: str):
        if case not in cache:
            name, akw, _engine, _join = CASES[case]
            out = tmp_path_factory.mktemp(f"ref-spill-{case}")
            cfg = JaxConfig(**_cfg_kw(corpus, out, case, **budgets_of(case)))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_driver._PackStager, "pack", plain_pack)
                cache[case] = jax_driver.run_job(cfg, app=jax_get_app(name, **akw))
        return cache[case]

    return get


def budgets_of(case: str) -> dict:
    return GREP_BUDGETS if case == "grep" else BUDGETS


def port_run(corpus, out: pathlib.Path, case: str, **kw):
    name, akw, _engine, _join = CASES[case]
    return run_job(Config(**_cfg_kw(corpus, out, case, **kw)), app=get_app(name, **akw))


def read_outputs(res) -> list:
    return [(pathlib.Path(p).name, pathlib.Path(p).read_bytes()) for p in res.output_files]


def run_files(work) -> list:
    return glob.glob(str(pathlib.Path(work) / "accrun-*")) + \
        glob.glob(str(pathlib.Path(work) / "dictrun-*"))


def spill_threads() -> set:
    return {t.name for t in threading.enumerate() if t.name.startswith("mr/spill")}


# ---------------------------------------------------------------- run format


def _word_map(seed: int, n: int) -> dict:
    """{(k1, k2): word} with keys across the whole uint32 range (k1 of 2^31
    and above included) and words from 1 to 300 bytes (2-byte varints)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 32, size=(n, 2), dtype=np.uint64).tolist()
    k[0] = [0xFFFFFFFF, 0xFFFFFFFF]
    k[1] = [1 << 31, 0]
    lens = rng.integers(1, 300, n).tolist()
    return {(int(a), int(b)): bytes(rng.integers(97, 123, ln, dtype=np.uint8))
            for (a, b), ln in zip(k, lens)}


def test_run_format_bytes_match_reference(tmp_path):
    wm = _word_map(0, 500)
    got, want = spill.pack_word_map(wm), jax_spill.pack_word_map(wm)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert (got[0] >= np.uint64(1 << 63)).any()
    lens = np.diff(got[1], prepend=0)
    assert spill.encode_varints(lens) == jax_spill.encode_varints(lens)
    port_bin, ref_bin = tmp_path / "port.bin", tmp_path / "ref.bin"
    n_port = spill.write_run_file(str(port_bin), "abcd1234", *got, run_index=3)
    n_ref = jax_spill.write_run_file(str(ref_bin), "abcd1234", *want, run_index=3)
    assert n_port == n_ref == port_bin.stat().st_size
    assert port_bin.read_bytes() == ref_bin.read_bytes()
    # Each side reads the other's run.
    for reader, path in ((spill.read_run_file, ref_bin), (jax_spill.read_run_file, port_bin)):
        src = reader(str(path))
        assert np.array_equal(src.keys, got[0]) and np.array_equal(src.ends, got[1])
        assert [src.word(i) for i in range(len(src))] == [wm[(int(p) >> 32, int(p) & 0xFFFFFFFF)]
                                                          for p in got[0]]
    rows = np.column_stack([got[0] >> np.uint64(32), got[0] & np.uint64(0xFFFFFFFF),
                            lens]).astype(np.int64)
    assert spill.write_npy_run(str(tmp_path / "p.npy"), rows) == \
        jax_spill.write_npy_run(str(tmp_path / "r.npy"), rows)
    assert (tmp_path / "p.npy").read_bytes() == (tmp_path / "r.npy").read_bytes()
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("values", [
    [], [0], [127, 128, 300, 16383, 16384], [(1 << 63), (1 << 64) - 1, 1 << 35]])
def test_varints_round_trip(values):
    v = np.asarray(values, dtype=np.uint64)
    enc = spill.encode_varints(v)
    assert enc == jax_spill.encode_varints(v)
    assert np.array_equal(spill.decode_varints(enc, len(v)), v)
    if len(v):
        with pytest.raises(ValueError):
            spill.decode_varints(enc[:-1], len(v))


def test_read_run_rejects_bad_header(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"NOPE" + bytes(60))
    with pytest.raises(ValueError, match="magic"):
        spill.read_run_file(str(p))
    wm = _word_map(1, 3)
    spill.write_run_file(str(p), "t", *spill.pack_word_map(wm))
    raw = bytearray(p.read_bytes())
    raw[4] = 9  # schema version
    p.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="version 9"):
        spill.read_run_file(str(p))


# ---------------------------------------------------------------- merge


def _sources(mod, layout: str):
    """Key-disjoint sorted sources (a fresh RunSource per package), empty
    ones kept in their slots, keys of 2^63 and above included."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 64, 3000, dtype=np.uint64, endpoint=False))
    keys = np.concatenate([keys, [np.uint64((1 << 64) - 1)]])
    if layout == "one_live":
        parts = [keys[:0], keys, keys[:0]]
    else:
        owner = rng.integers(0, 4, len(keys))
        parts = [keys[:0]] + [keys[owner == s] for s in range(4)] + [keys[:0]]
    out = []
    for p in parts:
        words = [b"k%x" % int(k) for k in p.tolist()]
        ends = np.cumsum([len(w) for w in words]).astype(np.int64) if words \
            else np.empty(0, np.int64)
        out.append(mod.RunSource(np.ascontiguousarray(p), ends, b"".join(words)))
    return out


@pytest.mark.parametrize("layout", ["disjoint", "one_live"])
@pytest.mark.parametrize("block", [7, 1 << 16])
def test_merge_sources_matches_reference(layout, block):
    got = list(spill.merge_sources(_sources(spill, layout), block))
    want = list(jax_spill.merge_sources(_sources(jax_spill, layout), block))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    keys = np.concatenate([g[0] for g in got])
    assert (np.diff(keys) > 0).all() and keys[-1] == np.uint64((1 << 64) - 1)
    srcs = _sources(spill, layout)
    assert list(spill.iter_sources_sorted(srcs, block)) == \
        list(jax_spill.iter_sources_sorted(_sources(jax_spill, layout), block))
    assert list(spill.merge_sources([spill.RunSource(np.empty(0, np.uint64),
                                                     np.empty(0, np.int64), b"")])) == []


def test_merge_of_many_sources_is_native_only(monkeypatch):
    """More than one live source goes through the native merge; a native
    library that fails raises — there is no other merge."""
    from mapreduce_rust_tpu_torch.native import host

    calls = []
    real = host.merge_runs_stream
    monkeypatch.setattr(host, "merge_runs_stream",
                        lambda arrays, block: calls.append(len(arrays)) or real(arrays, block))
    assert list(spill.merge_sources(_sources(spill, "disjoint")))
    assert calls == [6]

    def broken():
        raise OSError("seeded native load failure")

    monkeypatch.setattr(host, "get_lib", broken)
    monkeypatch.setattr(host, "merge_runs_stream", real)
    with pytest.raises(OSError, match="seeded native load failure"):
        list(spill.merge_sources(_sources(spill, "disjoint")))


# ---------------------------------------------------------------- tiers


def _acc_batches(op: str):
    rng = np.random.default_rng(11)
    out = []
    for i in range(12):
        n = 40 + 7 * i
        keys = rng.integers(0, 60, (n, 2)).astype(np.int64)
        keys[:, 0] = np.where(keys[:, 0] % 2 == 0, keys[:, 0] + (1 << 31), keys[:, 0])
        keys[:3] = [0xFFFFFFFF, 0xFFFFFFFF]
        vals = rng.integers(0, 8 if op == "distinct" else 1000, n).astype(np.int64)
        out.append((keys, vals))
    return out


@pytest.mark.parametrize("budget", [0, 1024])
@pytest.mark.parametrize("op", ["sum", "max", "min", "distinct"])
def test_accumulator_tier_matches_reference(tmp_path, op, budget):
    port = HostAccumulator(op, budget_bytes=budget, spill_dir=str(tmp_path / "p"))
    ref = jax_driver.HostAccumulator(op, budget_bytes=budget, spill_dir=str(tmp_path / "r"))
    plain = HostAccumulator(op)
    for keys, vals in _acc_batches(op):
        for acc in (port, ref, plain):
            acc.add(keys, vals)
    rows = port.fold_arrays()
    assert port.run_count == ref.run_count > 0
    assert np.array_equal(rows, ref.fold_arrays())
    assert np.array_equal(rows, plain.fold_arrays())
    assert (rows[:, 0] >= 1 << 31).any()
    assert port.table == plain.table
    files = run_files(tmp_path / "p")
    assert len(files) == port.run_count
    port.remove_runs()
    ref.remove_runs()
    assert not run_files(tmp_path / "p") and port.run_count == 0


def _scan_batches(n_batches: int):
    """(raw, ends, keys) native scan results of overlapping word windows."""
    from mapreduce_rust_tpu_torch.native.host import scan_unique_raw

    words = [b"w%d" % i for i in range(2500)] + ["café".encode(), "Ωmega".encode()]
    rng = np.random.default_rng(3)
    for _ in range(n_batches):
        picks = rng.integers(0, len(words), 700).tolist()
        yield scan_unique_raw(b" ".join(words[i] for i in picks))


@pytest.mark.parametrize("async_spill", [True, False])
def test_dictionary_tier_matches_reference(tmp_path, async_spill):
    port = Dictionary(budget_words=300, spill_dir=str(tmp_path), async_spill=async_spill)
    ref = JaxDictionary(budget_words=300, spill_dir=str(tmp_path / "r"))
    plain = Dictionary()
    seen_max = 0
    for i, (raw, ends, keys) in enumerate(_scan_batches(12)):
        if i % 3 == 2:
            # The per-word path: a filtering app's fold.
            starts = np.concatenate([[0], ends[:-1]])
            words = [raw[s:e] for s, e in zip(starts.tolist(), ends.tolist())]
            for d in (port, ref, plain):
                d.add_scanned(words, keys)
        else:
            for d in (port, ref, plain):
                d.add_scanned_raw(raw, ends, keys)
        seen_max = max(seen_max, len(port._seen), len(port._word_of))
    assert port.spilled and port.run_count == ref.run_count > 1
    assert len(port) == len(ref) == len(plain) > 300
    # Flushed words that came back did not regrow the RAM tier past the budget.
    assert seen_max < 300 + 700
    got = list(port.iter_sorted())
    assert got == list(ref.iter_sorted()) == list(plain.iter_sorted())
    assert [p for p, *_ in got] == sorted(p for p, *_ in got)
    assert port.collisions == ref.collisions == []
    with pytest.raises(RuntimeError, match="budget flush"):
        # mrlint: ignore[spilled-dict-api] -- the forbidden probe IS the test
        (got[0][1], got[0][2]) in port
    with pytest.raises(RuntimeError, match="budget flush"):
        # mrlint: ignore[spilled-dict-api] -- the forbidden probe IS the test
        port.items()
    stats = port.spill_stats()
    assert stats["runs"] == port.run_count and stats["bytes"] > 0
    assert stats["hist"].count == port.run_count
    port.remove_runs()
    ref.remove_runs()
    assert not run_files(tmp_path)


def test_sharded_dictionary_aggregates(tmp_path):
    from mapreduce_rust_tpu_torch.runtime.dictionary import shard_ids_of_packed

    shards = [Dictionary(budget_words=100, spill_dir=str(tmp_path)) for _ in range(3)]
    sd = ShardedDictionary(shards)
    plain = Dictionary()
    for raw, ends, keys in _scan_batches(4):
        packed = (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1].astype(np.uint64)
        sid = shard_ids_of_packed(packed, 3)
        starts = np.concatenate([[0], ends[:-1]])
        words = [raw[s:e] for s, e in zip(starts.tolist(), ends.tolist())]
        for s in range(3):
            idx = np.nonzero(sid == s)[0].tolist()
            shards[s].add_scanned([words[i] for i in idx], keys[idx])
        plain.add_scanned(words, keys)
    assert sd.spilled and sd.run_count == sum(s.run_count for s in shards)
    assert len(sd) == len(plain)
    assert list(sd.iter_sorted()) == list(plain.iter_sorted())
    assert len(sd.run_sources()) == sd.run_count + sum(bool(s._word_of) for s in shards)
    st = sd.spill_stats()
    assert st["runs"] == sd.run_count and st["hist"].count == sd.run_count
    assert sd.spill_snapshot()[2] == st["bytes"] > 0
    with pytest.raises(RuntimeError, match="budget flush"):
        # mrlint: ignore[spilled-dict-api] -- the forbidden probe IS the test
        list(sd.items())
    sd.remove_runs()
    assert not run_files(tmp_path) and not spill_threads()


def test_spill_writer_failure_and_abort(monkeypatch):
    w = spill.AsyncSpillWriter(name="mr/spill-test")
    gate = threading.Event()
    w.submit(lambda: gate.wait(5) and 0)
    w.submit(lambda: 1)
    w.submit(lambda: 2)  # queue full behind the blocked task
    threading.Timer(0.2, gate.set).start()
    w.close(abort=True)  # forces the sentinel past the full queue
    assert not w._thread.is_alive() and w.runs_written == 1

    w = spill.AsyncSpillWriter(name="mr/spill-test")

    def boom():
        raise OSError("seeded write failure")

    w.submit(boom)
    with pytest.raises(OSError, match="seeded write failure"):
        w.drain()
    with pytest.raises(OSError, match="seeded write failure"):
        w.submit(lambda: 0)
    w.close(abort=True)
    monkeypatch.setenv("MR_SPILL_SYNC", "1")
    assert spill.AsyncSpillWriter().sync
    assert not spill_threads()


# ---------------------------------------------------------------- jobs


@pytest.mark.parametrize("case", list(CASES))
def test_budgeted_job_matches_reference_and_unbudgeted(corpus, reference, tmp_path, case):
    ref = reference(case)
    res = port_run(corpus, tmp_path / "budget", case, **budgets_of(case))
    plain = port_run(corpus, tmp_path / "plain", case)
    s, r, p = res.stats, ref.stats, plain.stats
    assert s.accum_spill_runs > 0 and s.dict_spill_runs > 0
    assert (s.accum_spill_runs, s.dict_spill_runs) == (r.accum_spill_runs, r.dict_spill_runs)
    assert read_outputs(res) == read_outputs(ref) == read_outputs(plain)
    for field in COUNTERS:
        assert getattr(s, field) == getattr(r, field) == getattr(p, field), field
    assert s.unknown_keys == 0 and s.hash_collisions == 0
    assert s.partition_bytes == r.partition_bytes == p.partition_bytes
    assert s.spill_bytes > 0 and s.spill_s > 0
    assert s.hists["spill.write_s"].count == s.accum_spill_runs + s.dict_spill_runs
    if case == "top_k":
        # top_k overrides App.finalize: the rehydrate path returns its table.
        assert res.table == ref.table == plain.table and s.merge_fanin == 0
    else:
        assert res.table == ref.table == {} and plain.table
        assert s.merge_fanin == r.merge_fanin > 1
    assert not run_files(tmp_path / "budget" / "work")
    assert not list((tmp_path / "budget" / "out").glob("egress-*"))
    assert not spill_threads()


@pytest.mark.parametrize("case", ["word_count-device", "word_count-host"])
def test_sync_spill_equals_async(corpus, reference, tmp_path, case, monkeypatch):
    ref = reference(case)
    sync = port_run(corpus, tmp_path / "sync", case, spill_async=False, **BUDGETS)
    assert read_outputs(sync) == read_outputs(ref)
    assert (sync.stats.accum_spill_runs, sync.stats.dict_spill_runs) == \
        (ref.stats.accum_spill_runs, ref.stats.dict_spill_runs)
    assert sync.stats.spill_stall_s == 0.0
    monkeypatch.setenv("MR_SPILL_SYNC", "1")
    forced = port_run(corpus, tmp_path / "env", case, **BUDGETS)
    assert read_outputs(forced) == read_outputs(ref)


@pytest.mark.parametrize("where", ["fold", "writer"])
@pytest.mark.parametrize("case", ["word_count-device", "word_count-host"])
def test_failed_job_leaves_no_runs_or_threads(corpus, tmp_path, monkeypatch, case, where):
    if where == "fold":
        # The dictionary fold raises mid-stream, after runs of both tiers
        # exist (the host engine's fold runs on its shard threads).
        calls = [0]
        real = driver.fold_scan_into_dictionary

        def boom(dictionary, *args):
            calls[0] += 1
            if calls[0] == 8:
                assert dictionary.run_count > 0
                raise KeyError("seeded fold failure")
            return real(dictionary, *args)

        monkeypatch.setattr(driver, "fold_scan_into_dictionary", boom)
        err = KeyError
    else:
        # The accumulator's writer fails: the error re-raises on its owner.
        real_write = spill.write_npy_run

        def boom(path, rows, run_index=0):
            if run_index == 2:
                raise OSError("seeded disk failure")
            return real_write(path, rows, run_index)

        monkeypatch.setattr(spill, "write_npy_run", boom)
        err = OSError
    with pytest.raises(err, match="seeded"):
        port_run(corpus, tmp_path, case, **BUDGETS)
    assert not run_files(tmp_path / "work")
    assert not list((tmp_path / "work").glob("*.tmp"))
    assert not spill_threads()


def test_budgets_need_write_outputs(corpus, tmp_path):
    cfg = Config(**_cfg_kw(corpus, tmp_path, "word_count-device", **BUDGETS))
    with pytest.raises(ValueError, match="write_outputs"):
        run_job(cfg, write_outputs=False)
    assert not (tmp_path / "out").exists()


def test_fold_shards_budget_branch(monkeypatch):
    monkeypatch.setattr("os.sched_getaffinity", lambda _pid: {0, 1})
    for kw in (dict(), dict(dictionary_budget_words=1 << 19),
               dict(dictionary_budget_words=1 << 19, dispatch_async=False)):
        assert Config(**kw).effective_fold_shards() == \
            JaxConfig(**kw).effective_fold_shards() == (2 if len(kw) == 1 else 1)


def test_scavenges_dead_writers_runs(corpus, tmp_path):
    work = tmp_path / "work"
    work.mkdir()
    tag = spill.host_tag()
    stale = work / f"dictrun-{tag}-999999999-deadbeef-0.bin"
    stale.write_bytes(b"x")
    import os

    os.utime(stale, (1, 1))
    port_run(corpus, tmp_path, "word_count-device", **BUDGETS)
    assert not stale.exists()


def test_cli_budget_flags_and_clean(corpus, reference, tmp_path, capsys):
    ref = reference("word_count-device")
    out, work = tmp_path / "out", tmp_path / "work"
    assert cli_main(["run", "--device", "cpu", "--input", str(corpus / "all"),
                     "--output", str(out), "--work", str(work), "--reduce-n", "4",
                     "--chunk-mb", str(8192 / (1 << 20)), "--merge-capacity", "512",
                     "--accum-budget-mb", "0", "--dict-budget-words", "512",
                     "--sync-spill"]) == 0
    printed = capsys.readouterr().out
    assert "unknown=0" in printed and "spill[runs acc=" in printed
    assert [(p.name, p.read_bytes()) for p in sorted(out.glob("mr-*.txt"))] == \
        read_outputs(ref)
    (work / f"accrun-{spill.host_tag()}-1-0000abcd-0.npy").write_bytes(b"x")
    assert cli_main(["clean", "--work", str(work), "--output", str(out)]) == 0
    assert "removed 5 files" in capsys.readouterr().out
    assert not list(out.glob("mr-*")) and not run_files(work)
