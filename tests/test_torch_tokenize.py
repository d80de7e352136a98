"""The port's token-hash scan and tokenize_and_hash against the JAX package.

Same inputs, made with numpy from a seed, go through the JAX function and
its PyTorch counterpart; every output is an integer array, so the
tolerance is exact equality. The JAX Pallas kernel runs in interpret mode
on the CPU, as tests/test_tokenize.py runs it; the port runs the kernel's
plain version (CPU tensors). The CUDA kernel itself is held against the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapreduce_rust_tpu.core.hashing import byte_class_tables
from mapreduce_rust_tpu.ops.tokenize import tokenize_and_hash as jax_tokenize
from mapreduce_rust_tpu.ops.tokenize_pallas import BLOCK, hash_scan_pallas
from mapreduce_rust_tpu_torch.core import hashing as port_hashing
from mapreduce_rust_tpu_torch.ops.tokenize import tokenize_and_hash
from mapreduce_rust_tpu_torch.ops.tokenize_cuda import (
    TILE_BYTES,
    byte_classes,
    hash_scan,
    hash_scan_reference,
    tokenize_hash,
    tokenize_hash_reference,
)


def _straddle_block() -> np.ndarray:
    """Two 16 KiB blocks, a 40-byte token centred on the block edge."""
    data = np.full(2 * BLOCK, ord(" "), dtype=np.uint8)
    tok = np.frombuffer(b"straddler_token_across_the_block_edge_xy", np.uint8)
    data[BLOCK - 20: BLOCK - 20 + len(tok)] = tok
    data[100:103] = np.frombuffer(b"abc", np.uint8)
    return data


def _no_space(n: int, seed: int) -> np.ndarray:
    """Random bytes with every whitespace byte made a word char."""
    data = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
    data[np.isin(data, np.frombuffer(port_hashing.WHITESPACE_BYTES, np.uint8))] = ord("a")
    return data


def _tile_edge_spaces(n: int, where: str) -> np.ndarray:
    """Whitespace only in the first, or only in the last, byte of each of
    the CUDA kernel's tiles: the carry crosses every tile edge, and every
    tile's reset sits at an end of it."""
    data = _no_space(n, seed=17)
    data[(0 if where == "first" else TILE_BYTES - 1):: TILE_BYTES] = ord(" ")
    return data


def _scan_input(kind: str) -> np.ndarray:
    # All inputs span two blocks (one interpret-mode compile, whose time
    # grows with the grid).
    if kind == "random":  # every byte value
        return np.random.default_rng(3).integers(0, 256, 2 * BLOCK, dtype=np.uint8)
    if kind.startswith("ws_at_tile_"):
        return _tile_edge_spaces(2 * BLOCK, kind.removeprefix("ws_at_tile_"))
    return _straddle_block()


@pytest.mark.parametrize("kind", ["random", "straddle", "ws_at_tile_first", "ws_at_tile_last"])
def test_hash_scan_reference_matches_pallas(kind):
    data = _scan_input(kind)
    want = [np.asarray(x) for x in hash_scan_pallas(jnp.asarray(data), interpret=True)]
    got = hash_scan_reference(torch.from_numpy(data))
    assert np.array_equal(got[0].numpy().view(np.uint32), want[0])
    assert np.array_equal(got[1].numpy().view(np.uint32), want[1])
    assert np.array_equal(got[2].numpy(), want[2])


def test_byte_classes_match_tables():
    ws, wc = byte_class_tables()
    is_ws, is_wc = byte_classes(torch.arange(256, dtype=torch.uint8))
    assert np.array_equal(is_ws.numpy(), ws.astype(bool))
    assert np.array_equal(is_wc.numpy(), wc.astype(bool))


def test_hashing_copy_matches_reference():
    from mapreduce_rust_tpu.core import hashing as ref

    for name in ("H1_INIT", "H1_MULT", "H2_INIT", "H2_MULT", "SENTINEL",
                 "WHITESPACE_BYTES"):
        assert getattr(port_hashing, name) == getattr(ref, name)
    words = [b"", b"a", b"caf\xc3\xa9", b"x" * 70, b"under_score9"]
    assert np.array_equal(port_hashing.hash_words(words), ref.hash_words(words))


def test_int32_wraps_like_uint32():
    rng = np.random.default_rng(5)
    a, b, c = (rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
               for _ in range(3))
    want = a * b + c  # numpy uint32 wraps
    ta, tb, tc = (torch.from_numpy(x.view(np.int32)) for x in (a, b, c))
    got = (ta * tb + tc).numpy().view(np.uint32)
    assert np.array_equal(got, want)


def _assert_tokenize_equal(data: np.ndarray, last_is_boundary: bool = True):
    want = jax_tokenize(jnp.asarray(data), last_is_boundary=last_is_boundary)
    got = tokenize_and_hash(torch.from_numpy(data.copy()), last_is_boundary).to_numpy()
    for name, w, g in zip(("k1", "k2", "value", "valid"), want, got):
        assert np.array_equal(np.asarray(w), g), name


_STRINGS = [
    b"hello world hello",
    b"Don't stop-me now! don't",
    b"  leading and trailing  ",
    b"one",
    b"",
    b"!!! --- ...",
    b"a! b? a. b, a;",
    b"tab\tsep\nnewline\r\ncrlf",
    b"under_score 123 mix3d _lead trail_",
    "café naïve résumé café".encode("utf-8"),
]


def _padded(text: bytes, n: int = 64) -> np.ndarray:
    arr = np.frombuffer(text, dtype=np.uint8)
    return np.concatenate([arr, np.full(n - len(arr), 0x20, np.uint8)])


@pytest.mark.parametrize("text", _STRINGS)
def test_tokenize_matches_jax_on_strings(text):
    _assert_tokenize_equal(_padded(text))


@pytest.mark.parametrize("text", [b"hello wor", b"edge", b"a b c  ", b"x!"])
def test_tokenize_matches_jax_when_last_byte_is_not_boundary(text):
    # The text ends at the chunk edge: a token touching it must not emit.
    data = np.frombuffer(text.rjust(64, b" "), dtype=np.uint8).copy()
    _assert_tokenize_equal(data, last_is_boundary=False)


def _random_text(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vocab = [b"alpha", b"Beta", b"gamma_3", b"don't", b"x", "Ωmega".encode(),
             b"caf\xc3\xa9", b"--", b"a.b"]
    seps = [b" ", b"\t", b"\r\n", b"\n", b"  "]
    parts = []
    size = 0
    while size < n:
        w = vocab[rng.integers(len(vocab))] + seps[rng.integers(len(seps))]
        parts.append(w)
        size += len(w)
    return np.frombuffer(b"".join(parts)[:n], dtype=np.uint8).copy()


# ~64 KiB, deliberately not a multiple of the TPU kernel's 16 KiB block:
# the reference then takes its associative_scan path, and one shape keeps
# the JAX compiles to one.
_N = (1 << 16) - 5


def test_tokenize_matches_jax_on_random_text():
    _assert_tokenize_equal(_random_text(_N, seed=11))


def test_tokenize_matches_jax_on_whitespace_free_run():
    # One 20 KiB token (longer than a 16 KiB TPU block) amid random text.
    data = _random_text(_N, seed=7)
    data[1000: 1000 + 20480] = np.frombuffer(b"ab_c", np.uint8)[np.arange(20480) % 4]
    _assert_tokenize_equal(data)


@pytest.mark.parametrize("where", ["first", "last"])
def test_tokenize_matches_jax_with_whitespace_only_at_tile_edges(where):
    # At this size the JAX function is compiled for last_is_boundary=True
    # only, and the file adds no compile: False differs from True only in
    # that byte N-1, which is not whitespace here, ends no token.
    data = _tile_edge_spaces(_N, where)
    assert data[-1] != ord(" ")
    _assert_tokenize_equal(data, last_is_boundary=True)
    want = [np.asarray(x) for x in jax_tokenize(jnp.asarray(data), last_is_boundary=True)]
    got = tokenize_hash_reference(torch.from_numpy(data), last_is_boundary=False)
    got = [g.numpy().view(np.uint32) if i < 2 else g.numpy() for i, g in enumerate(got)]
    assert want[3][-1]  # the trailing token ends the chunk when it is a boundary...
    for name, w, g, last in zip(("k1", "k2", "value", "valid"), want, got,
                                (np.uint32(port_hashing.SENTINEL), np.uint32(port_hashing.SENTINEL),
                                 0, False)):
        assert np.array_equal(w[:-1], g[:-1]), name
        assert g[-1] == last, name  # ...and ends none when it is not


def test_hash_scan_on_cpu_uses_plain_version_and_counts_nothing():
    data = torch.from_numpy(_random_text(4096, seed=1))
    before = hash_scan.launches, tokenize_hash.launches
    got = hash_scan(data)
    want = hash_scan_reference(data)
    fused = tokenize_hash(data, False)
    fused_want = tokenize_hash_reference(data, False)
    assert (hash_scan.launches, tokenize_hash.launches) == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(fused, fused_want))


@pytest.mark.parametrize("bad", ["dtype", "shape", "meta",
                                 "fused-dtype", "fused-shape", "fused-meta"])
def test_hash_scan_rejects_what_the_kernel_does_not_take(bad):
    entry = tokenize_hash if bad.startswith("fused-") else hash_scan
    x = {
        "dtype": torch.zeros(16, dtype=torch.int32),
        "shape": torch.zeros((4, 4), dtype=torch.uint8),
        "meta": torch.zeros(16, dtype=torch.uint8, device="meta"),
    }[bad.removeprefix("fused-")]
    with pytest.raises(ValueError):
        entry(x)
