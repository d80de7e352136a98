"""Halo exchange: tokenize a byte stream sharded across the mesh, cut
ANYWHERE.

The port of ``mapreduce_rust_tpu/parallel/halo.py``. The chunker aligns
chunk cuts to whitespace on the host; a stream laid across the mesh as one
contiguous byte shard per shard, cut at arbitrary offsets (mid-word, even
mid-UTF-8 sequence), must still count every word exactly once. Each shard
scans a window

    window_i = [ tail_H(shard_{i-1}) | shard_i | head_1(shard_{i+1}) ]

- ownership: shard i emits exactly the tokens whose END byte lies in its
  own shard; a straddling word ends in exactly one shard, so it counts
  once, its hash completed from the left halo;
- the 1-byte right probe decides whether a token ending at the shard's
  last byte really ends there (next byte whitespace) or continues into the
  right neighbour (which then owns it);
- shards 0 and D-1 see whitespace beyond the stream's ends;
- a token longer than the halo H (= Config.max_word_len) that began before
  the window would hash truncated: it is detected through the token-length
  lane (ops/tokenize.tokenize_and_hash_with_len) and counted, like every
  other capacity fault here.

The reference moves the halo and probe with a ``ppermute`` pair; here they
are slices of the neighbours' tensors copied to the shard's device (no copy
at all when the shards share a card). The window's hashes are one launch
of the scan kernel per shard.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mapreduce_rust_tpu_torch.core.kv import SENTINEL_I32, KVBatch
from mapreduce_rust_tpu_torch.ops.tokenize import tokenize_and_hash_with_len
from mapreduce_rust_tpu_torch.parallel.shuffle import Mesh

_SPACE = 0x20


def _tokenize_shard(window: torch.Tensor, halo: int, n: int):
    """(masked KVBatch[halo + n + 1], trunc int32) of one shard's window."""
    kv, tlen = tokenize_and_hash_with_len(window, last_is_boundary=True)
    pos = torch.arange(halo + n + 1, dtype=torch.int32, device=window.device)
    own = (pos >= halo) & (pos < halo + n)
    valid = kv.valid & own
    # A token ending at pos with byte length tlen started at pos - tlen + 1.
    # The scan sees only the window, so tlen == pos + 1 means the token
    # reaches the window's start and may have begun before it: a possibly
    # truncated hash. No false positive while tokens are <= halo bytes (such
    # a token ending in the shard cannot reach window position 0).
    trunc = (valid & (tlen >= pos + 1)).sum(dtype=torch.int32)
    return KVBatch(
        k1=torch.where(valid, kv.k1, SENTINEL_I32),
        k2=torch.where(valid, kv.k2, SENTINEL_I32),
        value=torch.where(valid, kv.value, 0),
        valid=valid,
    ), trunc


def make_sharded_tokenizer(mesh: Mesh, halo: int):
    """fn(shards) → (one KVBatch[halo + N + 1] per shard, trunc int32[D] on
    the first shard's device), for ``shards`` one uint8[N] tensor per shard
    on its device, N >= halo.

    Shard i's batch holds the tokens that END in its shard (valid-masked,
    window-relative positions); trunc counts the tokens whose start may
    precede the window — nonzero means the halo is too small."""
    d = mesh.size

    def sharded_tokenize(shards: Sequence[torch.Tensor]):
        n = shards[0].numel()
        if n < halo:
            raise ValueError(f"shards of {n} bytes are narrower than the {halo}-byte halo")
        kvs, truncs = [], []
        for i, (me, dev) in enumerate(zip(shards, mesh.devices)):
            # Shard i-1's tail is my left halo, shard i+1's head byte my
            # right probe; the stream's ends are whitespace.
            left = (shards[i - 1][-halo:].to(dev) if i > 0
                    else torch.full((halo,), _SPACE, dtype=torch.uint8, device=dev))
            right = (shards[i + 1][:1].to(dev) if i < d - 1
                     else torch.full((1,), _SPACE, dtype=torch.uint8, device=dev))
            kv, trunc = _tokenize_shard(torch.cat([left, me, right]), halo, n)
            kvs.append(kv)
            truncs.append(trunc.to(mesh.devices[0]))
        return kvs, torch.stack(truncs)

    return sharded_tokenize


def shard_stream(data: bytes, mesh: Mesh, pad: "int | None" = None) -> np.ndarray:
    """Host helper: the ``[D, N]`` layout the sharded tokenizer wants — a
    byte stream cut at equal arbitrary offsets, padded with spaces."""
    d = mesh.size
    n = pad or -(-len(data) // d)  # ceil
    buf = np.full(d * n, _SPACE, dtype=np.uint8)
    buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf.reshape(d, n)
