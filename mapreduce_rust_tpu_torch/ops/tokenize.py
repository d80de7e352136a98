"""On-device tokenize→hash: bytes to token-hash records.

The port of ``mapreduce_rust_tpu/ops/tokenize.py::tokenize_and_hash``. The
work is ops/tokenize_cuda.tokenize_hash: on a CUDA chunk one launch of the
hand-written kernel, which scans the token hashes and derives the token
ends in the same pass; on a CPU chunk its plain PyTorch version. The
kernel takes any length, so there is no block-multiple eligibility test
and no second scan path. Token ends are those of the reference: a
non-whitespace byte followed by whitespace (or the chunk's end, when
``last_is_boundary``) with at least one word char.
"""

from __future__ import annotations

import torch

from mapreduce_rust_tpu_torch.core.kv import KVBatch
from mapreduce_rust_tpu_torch.ops.tokenize_cuda import tokenize_hash


def tokenize_and_hash(chunk: torch.Tensor, last_is_boundary: bool = True) -> KVBatch:
    """Tokenize+hash one uint8 byte chunk.

    Args:
      chunk: uint8[N] byte tensor. The host chunker pads with spaces, so
        padding never produces tokens.
      last_is_boundary: whether byte N-1 ends the stream.

    Returns a KVBatch[N]: valid entries sit at token-end byte positions
    with value 1 (one occurrence); every other slot is SENTINEL padding.
    """
    return KVBatch(*tokenize_hash(chunk, last_is_boundary))
