"""The CUDA kernel against its plain version, on the card.

Needs a CUDA device and nvcc; skips without a card. This file imports
neither jax nor the JAX package, so on the card's machine (which has no
jax) it runs on its own, without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mapreduce_rust_tpu_torch.ops.tokenize_cuda import (
    hash_scan,
    hash_scan_reference,
    tokenize_hash,
    tokenize_hash_reference,
)


def _inputs(n: int):
    rng = np.random.default_rng(n)
    text = np.where(rng.random(n) < 0.15, 32, rng.integers(97, 123, n)).astype(np.uint8)
    yield "text", text
    yield "bytes", rng.integers(0, 256, n, dtype=np.uint8)
    # A whitespace-free run over many 4 KiB tiles.
    run = text.copy()
    run[n // 4: n // 4 + min(n // 2, 50_000)] = ord("a")
    yield "ws_free_run", run
    # No whitespace at all: at 4 MiB, the longest look-back chain.
    no_space = rng.integers(0, 256, n, dtype=np.uint8)
    no_space[np.isin(no_space, np.frombuffer(b" \t\n\r\x0b\x0c", np.uint8))] = ord("_")
    yield "no_space", no_space


_SIZES = [1, 17, 4095, 4097, (16 << 10) + 7, 4 << 20]


@pytest.mark.cuda
@pytest.mark.parametrize("n", _SIZES)
def test_cuda_kernel_matches_plain_version(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, data in _inputs(n):
        x = torch.from_numpy(data).cuda()
        before = hash_scan.launches
        got = hash_scan(x)
        want = hash_scan_reference(x)
        torch.cuda.synchronize()
        assert hash_scan.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), (n, name)


@pytest.mark.cuda
@pytest.mark.parametrize("last_is_boundary", [True, False])
@pytest.mark.parametrize("n", _SIZES)
def test_fused_kernel_matches_plain_version(n, last_is_boundary):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, data in _inputs(n):
        x = torch.from_numpy(data).cuda()
        before = tokenize_hash.launches
        got = tokenize_hash(x, last_is_boundary)
        want = tokenize_hash_reference(x, last_is_boundary)
        torch.cuda.synchronize()
        assert tokenize_hash.launches == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (n, name)
