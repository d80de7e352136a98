"""The port's five other apps (inverted_index, grep, join, top_k, sort)
against the JAX package, on both of the port's engines.

One seeded corpus of four documents (ASCII words, document-specific words,
café/naïve/Ωmega, curly quotes, tabs and CRLF) serves every app; join
reads documents 0-1 and 2-3 as two corpora. Each app's reference result
is computed once per module, on the reference's device engine (its host
engine is not exact on the CPU, see tests/test_torch_host_map.py). The
port runs each app through its CLI (``python -m mapreduce_rust_tpu_torch
run``, called in-process) on the device engine and on the host engine:
its ``mr-{r}.txt`` files must be byte-identical to the reference's, and on
the device engine its exactness and spill counters equal too.

The device state is small (2^14 records) so the reference compiles fast;
inverted_index and join run with capacities that make the state evict on
most merges and the dense chunks of document 0 replay full-width.
"""

import pathlib

import numpy as np
import pytest
import torch

from mapreduce_rust_tpu.apps import get_app as jax_get_app
from mapreduce_rust_tpu.config import Config as JaxConfig
from mapreduce_rust_tpu.ops import partition as jax_partition
from mapreduce_rust_tpu.runtime import splitter as jax_splitter
from mapreduce_rust_tpu.runtime.driver import run_job as jax_run_job
from mapreduce_rust_tpu_torch.__main__ import main as cli_main
from mapreduce_rust_tpu_torch.apps import REGISTRY, get_app
from mapreduce_rust_tpu_torch.apps.grep import Grep
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.core.normalize import reference_word_counts
from mapreduce_rust_tpu_torch.ops import partition
from mapreduce_rust_tpu_torch.ops.tokenize_cuda import tokenize_hash
from mapreduce_rust_tpu_torch.runtime import driver, splitter
from mapreduce_rust_tpu_torch.runtime.chunker import parse_input_spec, resolve_corpora
from mapreduce_rust_tpu_torch.runtime.driver import run_job

#: Chunk size of every run here: 64 KiB, so each document is several chunks.
CHUNK = 1 << 16
#: grep's queries: common words, a document-specific one, unicode, an
#: apostrophe the normalizer strips, and a word no document holds.
QUERY = ("w3", "w77", "d2x5", "café", "don’t", "absent")
#: Device capacities of every run: a small state, so the reference
#: compiles fast...
SMALL = dict(merge_capacity=1 << 14, partial_capacity=None)
#: ...and for inverted_index and join, capacities small enough that the
#: state evicts on most merges and the dense chunks of document 0
#: overflow their partial.
EVICT = dict(merge_capacity=1 << 12, partial_capacity=1 << 10)


def _caps(app: str) -> dict:
    return EVICT if app in ("inverted_index", "join") else SMALL


def _doc(seed: int, n_words: int, vocab_size: int, own: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"w%d" % i for i in range(vocab_size)] + [
        b"d%dx%d" % (seed, i) for i in range(own)] + [
        "café".encode(), "naïve".encode(), "Ωmega".encode(), "don’t".encode(),
        "“quoted”".encode(), b"it's", b"x,y", b"--", b"end."]
    seps = [b" ", b" ", b"\t", b"\r\n", b"\n", b"  ", " ".encode()]
    ws = rng.integers(0, len(vocab), n_words).tolist()
    ss = rng.integers(0, len(seps), n_words).tolist()
    return b"".join(vocab[w] + seps[s] for w, s in zip(ws, ss))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """all/ holds the four documents; a/ and b/ hold 0-1 and 2-3, join's
    two sides. Document 0 is high-cardinality, the rest are not."""
    root = tmp_path_factory.mktemp("apps-corpus")
    docs = [_doc(0, 60_000, 15_000, 50), _doc(1, 40_000, 400, 50),
            _doc(2, 40_000, 300, 50), _doc(3, 30_000, 400, 30)]
    for sub, idx in (("all", range(4)), ("a", (0, 1)), ("b", (2, 3))):
        (root / sub).mkdir()
        for i in idx:
            (root / sub / f"doc-{i}.txt").write_bytes(docs[i])
    return root


def _inputs(app: str, root: pathlib.Path) -> dict:
    if app == "join":
        return {"input_dirs": (("a", str(root / "a")), ("b", str(root / "b")))}
    return {"input_dir": str(root / "all")}


def _app_kw(app: str) -> dict:
    return {"grep": {"query": QUERY}, "top_k": {"k": 25}}.get(app, {})


@pytest.fixture(scope="module")
def reference(corpus, tmp_path_factory):
    """app → the JAX package's device-engine result, lazily."""
    cache = {}

    def get(app: str):
        if app not in cache:
            out = tmp_path_factory.mktemp(f"ref-{app}")
            cfg = JaxConfig(device="cpu", reduce_n=4, chunk_bytes=CHUNK,
                            output_dir=str(out / "out"), work_dir=str(out / "work"),
                            **_inputs(app, corpus), **_caps(app))
            cache[app] = jax_run_job(cfg, app=jax_get_app(app, **_app_kw(app)))
        return cache[app]

    return get


def _cli_run(monkeypatch, tmp_path, corpus, app: str, engine: str):
    """The port's ``run`` subcommand in-process; returns its JobResult."""
    results = []
    real = driver.run_job

    def spy(*a, **kw):
        results.append(real(*a, **kw))
        return results[-1]

    monkeypatch.setattr(driver, "run_job", spy)
    if app == "join":
        inputs = [f"a={corpus / 'a'}", f"b={corpus / 'b'}"]
    else:
        inputs = [str(corpus / "all")]
    argv = ["run", "--device", "cpu", "--app", app, "--input", *inputs,
            "--output", str(tmp_path / "out"), "--work", str(tmp_path / "work"),
            "--reduce-n", "4", "--chunk-mb", str(CHUNK / (1 << 20)),
            "--map-engine", engine, "--merge-capacity", str(_caps(app)["merge_capacity"])]
    if _caps(app)["partial_capacity"]:
        argv += ["--partial-capacity", str(_caps(app)["partial_capacity"])]
    if app == "grep":
        argv += ["--query", ",".join(QUERY)]
    if app == "top_k":
        argv += ["--k", "25"]
    assert cli_main(argv) == 0
    (res,) = results
    return res


def assert_same_files(want, got):
    assert [pathlib.Path(p).name for p in want] == [pathlib.Path(p).name for p in got]
    for w, g in zip(want, got):
        assert pathlib.Path(w).read_bytes() == pathlib.Path(g).read_bytes(), g


APPS = ["inverted_index", "grep", "join", "top_k", "sort"]


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("app", APPS)
def test_app_parity(corpus, reference, tmp_path, monkeypatch, app, engine):
    ref = reference(app)
    launches = tokenize_hash.launches
    res = _cli_run(monkeypatch, tmp_path, corpus, app, engine)
    assert tokenize_hash.launches == launches  # the CPU path never launches it
    assert_same_files(ref.output_files, res.output_files)
    assert res.table == ref.table
    s, r = res.stats, ref.stats
    assert s.unknown_keys == r.unknown_keys == 0
    assert s.hash_collisions == r.hash_collisions == 0
    assert s.distinct_keys == r.distinct_keys
    assert s.partition_bytes == r.partition_bytes
    assert (s.partition_mode, s.splitter_samples) == (r.partition_mode, r.splitter_samples)
    if engine == "device":
        for field in ("spilled_keys", "spill_events", "partial_overflow_replays",
                      "chunks", "dictionary_words"):
            assert getattr(s, field) == getattr(r, field), field
    assert any(pathlib.Path(p).stat().st_size for p in res.output_files)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_join_evict_and_replay(corpus, reference, tmp_path, engine):
    """Evictions cut posting sets in two (one part kept, one spilled) and
    dense chunks replay full-width; the host folds the parts back, and
    join's cross product comes out whole."""
    ref = reference("join")
    cfg = Config(device="cpu", reduce_n=4, chunk_bytes=CHUNK, map_engine=engine,
                 output_dir=str(tmp_path / "out"), work_dir=str(tmp_path / "work"),
                 host_update_cap=1 << 11, **_inputs("join", corpus), **EVICT)
    res = run_job(cfg, app=get_app("join"))
    assert_same_files(ref.output_files, res.output_files)
    s, r = res.stats, ref.stats
    assert s.spilled_keys > 0 and s.distinct_keys == r.distinct_keys
    if engine == "device":
        assert 0 < s.partial_overflow_replays < s.chunks
        for field in ("spilled_keys", "spill_events", "partial_overflow_replays"):
            assert getattr(s, field) == getattr(r, field), field
    # Against the documents themselves: every posting list, and the join.
    posting: dict = {}
    for d, path in enumerate(sorted((corpus / "all").glob("*.txt"))):
        for w in reference_word_counts(path.read_bytes()):
            posting.setdefault(w.encode(), []).append(d)
    assert res.table == posting
    want = sorted(b"%s %d %d" % (w, a, b - 2) for w, ds in posting.items()
                  for a in ds if a < 2 for b in ds if b >= 2)
    got = sorted(line for p in res.output_files
                 for line in pathlib.Path(p).read_bytes().splitlines())
    assert got == want and want


def test_sort_output_is_sorted_multiset(corpus, reference):
    res = reference("sort")
    lines = []
    for p in res.output_files:
        lines.extend(pathlib.Path(p).read_bytes().splitlines())
    toks = []
    for p in sorted((corpus / "all").glob("*.txt")):
        for w, c in reference_word_counts(p.read_bytes()).items():
            toks.extend([w.encode()] * c)
    assert lines == sorted(toks)


def test_top_k_merge_selects_across_partitions(corpus, tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    (out / "mr-0.txt").write_bytes(b"b 5\na 3\n")
    (out / "mr-1.txt").write_bytes(b"c 5\nd 9\ne 1\n")
    assert cli_main(["merge", "--output", str(out), "--app", "top_k", "--k", "3"]) == 0
    assert (out / "final.txt").read_bytes() == b"d 9\nb 5\nc 5\n"


# ---------------------------------------------------------------- partition


def test_pack_word_prefix_and_range_partition_match_reference():
    words = [b"", b"a", b"ab", b"abcdefgh", b"abcdefghi", b"b", b"zzzzzzzzzz",
             "café".encode(), "Ωmega".encode(), b"\xff\xff"]
    packed = partition.pack_word_prefix(words)
    assert np.array_equal(packed, jax_partition.pack_word_prefix(words))
    assert packed.dtype == np.uint64
    # Splitters from the shared sampler's order statistics, over the words
    # themselves: every partition boundary falls on a real key.
    spl = splitter.derive_splitters(packed, 4)
    assert len(set(partition.range_partition(packed, spl).tolist())) > 1
    assert np.array_equal(partition.range_partition(packed, spl),
                          jax_partition.range_partition(packed, spl))
    assert np.array_equal(partition.splitter_pairs(spl), jax_partition.splitter_pairs(spl))


@pytest.mark.parametrize("reduce_n", [1, 4, 7])
def test_derive_splitters_match_reference(reduce_n):
    rng = np.random.default_rng(reduce_n)
    samples = rng.integers(0, 1 << 63, 1000, dtype=np.uint64) * np.uint64(2)
    for s in (samples, samples[:3], np.zeros(0, np.uint64)):
        assert np.array_equal(splitter.derive_splitters(s, reduce_n),
                              jax_splitter.derive_splitters(s, reduce_n))


def test_splitters_for_job_bit_identical(corpus):
    cfg = Config(device="cpu", reduce_n=8, split_samples=97, input_dir=str(corpus / "all"))
    jcfg = JaxConfig(device="cpu", reduce_n=8, split_samples=97)
    inputs, _b, _n = resolve_corpora(cfg)
    got = splitter.splitters_for_job(cfg, inputs)
    assert got.dtype == np.uint64 and len(got) == 7
    assert np.array_equal(got, jax_splitter.splitters_for_job(jcfg, inputs))
    for i, path in enumerate(inputs):
        assert splitter.sample_file(path, 50, file_index=i) == \
            jax_splitter.sample_file(path, 50, file_index=i)
    app = splitter.prepare_app(get_app("sort"), cfg, inputs)
    assert app.splitters == tuple(int(x) for x in got)
    assert splitter.prepare_app(app, cfg, inputs) is app  # bound once


# ---------------------------------------------------------------- inputs


def test_parse_input_spec_forms():
    assert parse_input_spec(["data"]) == ("data", None)
    assert parse_input_spec(["data/run=5"]) == ("data/run=5", None)
    d, pairs = parse_input_spec(["b=y", "a=x"])
    assert pairs == (("a", "x"), ("b", "y"))  # canonical name order
    assert d == "x"
    with pytest.raises(ValueError, match="name=DIR"):
        parse_input_spec(["x", "y"])
    with pytest.raises(ValueError, match="duplicate"):
        parse_input_spec(["a=x", "a=y"])


def test_resolve_corpora_bounds(corpus):
    cfg = Config(device="cpu", input_dirs=[("b", str(corpus / "b")), ("a", str(corpus / "a"))])
    inputs, bounds, names = resolve_corpora(cfg)
    assert [pathlib.Path(p).name for p in inputs] == ["doc-2.txt", "doc-3.txt",
                                                      "doc-0.txt", "doc-1.txt"]
    assert bounds == (2,) and names == ("b", "a")
    inputs, bounds, names = resolve_corpora(Config(device="cpu", input_dir=str(corpus / "all")))
    assert len(inputs) == 4 and bounds == () and names == ("corpus",)


def test_config_input_dirs_validation():
    with pytest.raises(ValueError, match="string pairs"):
        Config(input_dirs=(("a",),))
    with pytest.raises(ValueError, match="string pairs"):
        Config(input_dirs=())
    with pytest.raises(ValueError, match="duplicate"):
        Config(input_dirs=(("a", "x"), ("a", "y")))
    with pytest.raises(ValueError, match="split_samples"):
        Config(split_samples=0)
    cfg = Config(input_dirs=[("a", "x"), ("b", "y")])
    assert cfg.input_dirs == (("a", "x"), ("b", "y"))
    assert cfg.corpora() == (("a", "x"), ("b", "y"))
    assert Config(input_dir="z").corpora() == (("corpus", "z"),)


def test_join_requires_two_corpora(corpus, tmp_path, monkeypatch):
    def never(*a, **kw):
        raise AssertionError("the stream started")

    monkeypatch.setattr(driver, "_stream_single", never)
    monkeypatch.setattr(driver, "_stream_host_map", never)
    cfg = Config(device="cpu", input_dir=str(corpus / "all"),
                 output_dir=str(tmp_path / "out"))
    with pytest.raises(ValueError, match="exactly 2 input corpora"):
        run_job(cfg, app=get_app("join"))
    three = Config(device="cpu", output_dir=str(tmp_path / "out"), input_dirs=(
        ("a", str(corpus / "a")), ("b", str(corpus / "b")), ("c", str(corpus / "a"))))
    with pytest.raises(ValueError, match="exactly 2 input corpora"):
        run_job(three, app=get_app("join"))
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------- apps


def test_grep_bad_queries_fail_loudly(corpus, tmp_path, capsys):
    some_keys = np.zeros((1, 2), dtype=np.uint32)
    for query in ((), ("two words",), ("...",)):
        with pytest.raises(ValueError):
            Grep(query=query).host_mask(some_keys)
    with pytest.raises(ValueError):
        Grep(query=("two words",)).device_map(
            driver.KVBatch.empty(4, "cpu"), 0)
    with pytest.raises(SystemExit) as e:
        cli_main(["run", "--device", "cpu", "--app", "grep", "--query", "a b",
                  "--input", str(corpus / "all"), "--output", str(tmp_path / "o")])
    assert e.value.code == 2
    assert "exactly one word" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_registry_holds_six_apps():
    assert sorted(REGISTRY) == sorted(APPS + ["word_count"])
    assert get_app("grep", query=("abc",)).combine_op == "distinct"
    assert get_app("top_k", k=3).device_select_k == 3
    assert get_app("word_count").device_select_k is None
    assert get_app("sort").partition_mode == "range"
    assert get_app("join").requires_corpora == 2
    with pytest.raises(ValueError, match="unknown app"):
        get_app("nope")


def test_grep_query_keys_built_once_per_device():
    from mapreduce_rust_tpu_torch.apps.grep import _query_tensors

    app = Grep(query=("w1", "café"))
    kv = driver.KVBatch.empty(8, "cpu")
    app.device_map(kv, 1)
    before = _query_tensors.cache_info().hits
    app.device_map(kv, 2)
    assert _query_tensors.cache_info().hits == before + 1


def test_join_emits_cross_product():
    app = get_app("join").__class__(corpus_bounds=(3,))
    assert app.emit_lines(b"w", [0, 2, 3, 5]) == [b"w 0 0", b"w 0 2", b"w 2 0", b"w 2 2"]
    assert app.emit_lines(b"w", [0, 1]) == []
    assert app.emit_lines(b"w", [4]) == []
    assert [app.corpus_of(d) for d in (0, 2, 3, 9)] == [0, 0, 1, 1]


def test_inverted_index_device_map_stamps_doc_id():
    kv = driver.KVBatch(torch.tensor([1, 2, -1], dtype=torch.int32),
                        torch.tensor([1, 2, -1], dtype=torch.int32),
                        torch.ones(3, dtype=torch.int32),
                        torch.tensor([True, True, False]))
    out = get_app("inverted_index").device_map(kv, 7)
    assert out.value.dtype == torch.int32
    assert out.value.tolist() == [7, 7, 0]


def test_cli_join_rejects_mixed_inputs(corpus, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli_main(["run", "--device", "cpu", "--app", "join", "--input",
                  str(corpus / "a"), f"b={corpus / 'b'}", "--output", str(tmp_path / "o")])
    assert e.value.code == 2
    assert not (tmp_path / "o").exists()
