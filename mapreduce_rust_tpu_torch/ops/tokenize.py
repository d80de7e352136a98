"""On-device tokenize→hash: bytes to token-hash records.

The port of ``mapreduce_rust_tpu/ops/tokenize.py::tokenize_and_hash`` and
``tokenize_and_hash_with_len``. The
work is ops/tokenize_cuda.tokenize_hash: on a CUDA chunk one launch of the
hand-written kernel, which scans the token hashes and derives the token
ends in the same pass; on a CPU chunk its plain PyTorch version. The
kernel takes any length, so there is no block-multiple eligibility test
and no second scan path. Token ends are those of the reference: a
non-whitespace byte followed by whitespace (or the chunk's end, when
``last_is_boundary``) with at least one word char.

The with-length form adds the token-byte-length lane the halo path reads
(parallel/halo.py). The reference scans it as a seventh lane of its
associative scan and never through its Pallas kernel; here the hashes come
from the same kernel launch as :func:`tokenize_and_hash` and the length is
one cummax over the whitespace positions (:func:`token_len`), equal at
every position to the scanned lane (:func:`token_len_reference`).
"""

from __future__ import annotations

import torch

from mapreduce_rust_tpu_torch.core.kv import KVBatch
from mapreduce_rust_tpu_torch.ops.tokenize_cuda import byte_classes, tokenize_hash


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


def token_len(chunk: torch.Tensor) -> torch.Tensor:
    """int32[N]: at each byte, the bytes since the last whitespace byte
    (inclusive of this one; 0 on whitespace, position + 1 before the first
    whitespace) — at a token's end byte, the whole token's byte count,
    deleted punctuation included: ``pos - cummax(where(is_ws, pos, -1))``."""
    is_ws, _ = byte_classes(chunk)
    pos = torch.arange(chunk.numel(), dtype=torch.int32, device=chunk.device)
    last_ws = torch.cummax(torch.where(is_ws, pos, -1), dim=0).values
    return pos - last_ws


def token_len_reference(chunk: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`token_len`: the reference's length lane as an
    inclusive scan under its reset monoid (``_scan_combine_len``: a
    whitespace byte resets to 0, every other byte adds 1), Hillis–Steele
    in torch ops."""
    is_ws, _ = byte_classes(chunk)
    f = is_ws
    length = (~is_ws).to(torch.int32)
    d, n = 1, chunk.numel()
    while d < n:
        fy = f[d:]
        length = torch.cat([length[:d], torch.where(fy, length[d:], length[:-d] + length[d:])])
        f = torch.cat([f[:d], f[:-d] | fy])
        d *= 2
    return length


def tokenize_and_hash_with_len(chunk: torch.Tensor, last_is_boundary: bool = True):
    """(KVBatch[N], token_byte_len int32[N]): :func:`tokenize_and_hash` plus
    :func:`token_len`, which the halo path compares against the window
    position to detect tokens longer than the halo."""
    return tokenize_and_hash(chunk, last_is_boundary), token_len(chunk)
