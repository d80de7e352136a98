"""The port's native host library against the JAX package's and against
the port's own plain versions.

Every entry of ``mapreduce_rust_tpu_torch.native.host`` is fed the same
seeded inputs as ``mapreduce_rust_tpu.native.host`` (random text with
unicode letters, punctuation, unicode whitespace and invalid UTF-8, plus
edge cases) and must return equal arrays and bytes; each is also held to
its pure-Python version. Both libraries are built with g++ here.
"""

import pathlib

import numpy as np
import pytest

from mapreduce_rust_tpu.native import host as ref
from mapreduce_rust_tpu_torch.core.normalize import normalize_python, normalize_unicode
from mapreduce_rust_tpu_torch.native import host
from mapreduce_rust_tpu_torch.runtime.dictionary import (
    extract_words,
    shard_ids_of_packed,
    shard_of_packed,
)
from mapreduce_rust_tpu_torch.runtime.driver import (
    _coalesce_updates_py,
    _py_scan_count,
    _scan_payload_python,
)

PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "mapreduce_rust_tpu_torch"

#: Tokens of the seeded random text: ASCII words and punctuation, accented
#: and non-Latin letters, curly quotes and dashes (deleted inside a word),
#: unicode whitespace (splits), combining marks, astral letters and
#: malformed UTF-8.
_TOKENS = [b"alpha", b"beta", b"w42", b"x_y", b"it's", b"x,y", b"--", b"end.",
           "café".encode(), "naïve".encode(), "Ωmega".encode(), "don’t".encode(),
           "“quoted”".encode(), "end—dash".encode(), "日本語".encode(),
           "ｗｉｄｅ".encode(), "combin̸ing".encode(), "\U0001d400math".encode(),
           b"bad\xff\xfebytes", b"trunc\xe2\x80", "a b".encode(), "c　d".encode()]
_SEPS = [b" ", b" ", b"\t", b"\r\n", b"\n", b"  ", " ".encode(), " ".encode()]


def _random_text(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, len(_TOKENS), n).tolist()
    ss = rng.integers(0, len(_SEPS), n).tolist()
    nums = rng.integers(0, 3000, n).tolist()
    # Every third token is a numbered word, so the vocabulary is large.
    return b"".join((_TOKENS[t] if i % 3 else b"v%d" % k) + _SEPS[s]
                    for i, (t, s, k) in enumerate(zip(ts, ss, nums)))


#: The edge cases of tests/test_native.py plus two seeded random texts.
CASES = {
    "empty": b"",
    "ws_only": b"   \t\n ",
    "one_word": b"hello",
    "repeats": b"the cat sat on the mat the cat",
    "punct": b"don't-stop ... !!! -- foo_bar42 a b c a",
    "lead_trail": b"  leading and trailing   ",
    "accents": b"caf\xc3\xa9 caf\xc3\xa9 na\xc3\xafve",
    "malformed": b"a\xff\xfeb c\xc3",
    "cjk": "日本 語 日本".encode(),
    "quotes": "naïve café — don’t “stop”".encode(),
    "uni_ws": "tab\tnbsp emsp splits".encode(),
    "digits": b"don't stop-me_now 42 42 42",
    "random_small": _random_text(1, 2_000),
    "random_large": _random_text(2, 60_000),
}


def _words(raw: bytes, ends: np.ndarray) -> list[bytes]:
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    return [raw[s:e] for s, e in zip(starts.tolist(), ends.tolist())]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)
        else:
            assert g == w


def test_library_is_the_ports_own():
    path = host.loaded_path()
    assert path.resolve().is_relative_to(PORT_ROOT.resolve())
    assert path.name != "_mrnative.so" and path.name.startswith("mrnative-")
    assert host.get_lib() is not ref.get_lib()


@pytest.mark.parametrize("name", sorted(CASES))
def test_normalize_native(name):
    raw = CASES[name]
    got = host.normalize_native(raw)
    assert got == ref.normalize_native(raw)
    assert got == normalize_python(raw)
    assert normalize_unicode(raw) == got


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_unique_raw(name):
    norm = normalize_python(CASES[name])
    got = host.scan_unique_raw(norm)
    _assert_same(got, ref.scan_unique_raw(norm))
    words, keys = _scan_payload_python(norm)
    assert _words(got[0], got[1]) == words
    assert np.array_equal(got[2], keys)


@pytest.mark.parametrize("as_view", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_count_raw(name, as_view):
    raw = CASES[name]
    data = np.frombuffer(raw, dtype=np.uint8) if as_view else raw
    got = host.scan_count_raw(data)
    _assert_same(got, ref.scan_count_raw(raw))
    words, keys, counts = _py_scan_count(raw)
    assert _words(got[0], got[1]) == words
    assert np.array_equal(got[2].reshape(-1, 2), keys.reshape(-1, 2))
    assert np.array_equal(got[3], counts)
    assert int(got[3].sum()) == len(extract_words(normalize_python(raw)))


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_count_sharded_raw(name, n_shards):
    raw = CASES[name]
    got = host.scan_count_sharded_raw(raw, n_shards)
    _assert_same(got, ref.scan_count_sharded_raw(raw, n_shards))
    # Plain version: the unsharded plain scan, grouped by shard with scan
    # order kept inside each shard.
    words, keys, counts = _py_scan_count(raw)
    keys = keys.reshape(-1, 2)
    packed = (keys[:, 0].astype(np.uint64) << np.uint64(32)) | keys[:, 1].astype(np.uint64)
    shard = shard_ids_of_packed(packed, n_shards).astype(np.int64)
    order = np.argsort(shard, kind="stable")
    raw_g, ends_g, keys_g, counts_g, pos, shard_counts = got
    assert _words(raw_g, ends_g) == [words[i] for i in order.tolist()]
    assert np.array_equal(keys_g.reshape(-1, 2), keys[order])
    assert np.array_equal(counts_g, counts[order])
    assert np.array_equal(pos, order)
    assert np.array_equal(shard_counts, np.bincount(shard, minlength=n_shards))
    assert [shard_of_packed(p, n_shards) for p in packed[:50].tolist()] == \
        shard[:50].tolist()


@pytest.mark.parametrize("trial", range(4))
def test_coalesce_updates_into(trial):
    rng = np.random.default_rng(11 + trial)
    for _ in range(10):
        # Keys across the whole uint64 range, including the top bit.
        pool = rng.integers(0, 2**63, size=200, dtype=np.uint64) * np.uint64(2)
        a = np.unique(rng.choice(pool, size=rng.integers(0, 60)))
        b = np.unique(rng.choice(pool, size=rng.integers(1, 60)))
        av = rng.integers(1, 2**40, size=len(a)).astype(np.int64)
        bv = rng.integers(1, 2**40, size=len(b)).astype(np.int64)
        m = max(len(a) - int(rng.integers(0, 3)), 0)  # a prefix of a only
        outs = []
        for lib in (host, ref):
            out_k = np.empty(len(a) + len(b), dtype=np.uint64)
            out_v = np.empty(len(a) + len(b), dtype=np.int64)
            n = lib.coalesce_updates_into(a, av, m, b, bv, out_k, out_v)
            outs.append((out_k[:n], out_v[:n]))
        want_k, want_v = _coalesce_updates_py(a, av, m, b, bv)
        for k, v in outs:
            assert np.array_equal(k, want_k) and np.array_equal(v, want_v)


def test_coalesce_updates_into_rejects_bad_buffers():
    k = np.arange(4, dtype=np.uint64)
    v = np.ones(4, dtype=np.int64)
    with pytest.raises(ValueError, match="contiguous"):
        host.coalesce_updates_into(k, v.astype(np.int32), 4, k, v, k.copy(), v.copy())
    with pytest.raises(ValueError, match="lengths"):
        host.coalesce_updates_into(k, v, 4, k, v, np.empty(5, np.uint64),
                                   np.empty(5, np.int64))


@pytest.mark.parametrize("block", [1, 7, 1 << 16])
def test_merge_runs_stream(block):
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 2**64 - 1, size=3000, dtype=np.uint64))
    owner = rng.integers(0, 5, size=len(keys))
    runs = [keys[owner == s] for s in range(5)] + [np.empty(0, np.uint64)]

    def collect(stream):
        parts = list(stream)
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))

    got = collect(host.merge_runs_stream(runs, block=block))
    _assert_same(got, collect(ref.merge_runs_stream(runs, block=block)))
    src = np.concatenate([np.full(len(r), s, np.int32) for s, r in enumerate(runs)])
    idx = np.concatenate([np.arange(len(r), dtype=np.int64) for r in runs])
    order = np.argsort(np.concatenate(runs), kind="stable")
    assert np.array_equal(got[0], keys)
    assert np.array_equal(got[1], src[order]) and np.array_equal(got[2], idx[order])


def test_arenas_are_counted():
    host.scan_count_raw(CASES["random_small"])
    assert host.arena_count() >= 1 and host.arena_bytes() > 0


def test_no_gxx_raises(monkeypatch):
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(host.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        host.scan_count_raw(b"a b")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        normalize_unicode("café".encode())


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(host, "_SRC", bad)
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host.get_lib()
    assert not any((tmp_path / "_build").glob("*.so"))
