"""Grep: which documents contain each query word (the port of
``mapreduce_rust_tpu/apps/grep.py``) — a filtered inverted index.

- the query words are normalized and hashed ONCE on the host with the
  corpus pipeline's own rules (core/normalize, runtime/dictionary
  .extract_words, core/hashing), so a query like "don't" matches the
  corpus token "dont";
- device_map compares every record's hash pair against the small query
  set on the card — an [N, Q] broadcast compare — turns every other record
  into SENTINEL-keyed padding, then stamps doc_id as the value like
  inverted_index;
- combine_op "distinct" builds the posting sets; only query keys ever
  occupy device state.

The host-map engine applies the same filter through App.host_mask (the
numpy twin of the compare) before it packs updates.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mapreduce_rust_tpu_torch.apps.inverted_index import InvertedIndex
from mapreduce_rust_tpu_torch.core.kv import SENTINEL_I32, KVBatch


@functools.lru_cache(maxsize=64)
def _query_keys(query: tuple[str, ...]) -> np.ndarray:
    """uint32 [Q, 2] hash pairs of the normalized query words (reference
    ``grep.py:39-66``). Each query term must normalize to exactly one
    token: a term that vanishes (all punctuation) or splits (contains
    whitespace) is a usage error that fails loudly."""
    from mapreduce_rust_tpu_torch.core.hashing import hash_words
    from mapreduce_rust_tpu_torch.core.normalize import normalize_unicode
    from mapreduce_rust_tpu_torch.runtime.dictionary import extract_words

    if not query:
        raise ValueError("grep needs at least one --query word")
    words = []
    for term in query:
        raw = term.encode() if isinstance(term, str) else bytes(term)
        toks = extract_words(normalize_unicode(raw))
        if len(toks) != 1:
            raise ValueError(
                f"grep query {term!r} normalizes to {len(toks)} tokens "
                f"({toks!r}); each query must be exactly one word"
            )
        words.append(toks[0])
    arr = hash_words(words)
    # Shared by every caller: frozen, so a mutating caller fails loudly.
    arr.flags.writeable = False
    return arr


@functools.lru_cache(maxsize=64)
def _query_tensors(query: tuple[str, ...], device: torch.device):
    """(k1 [1, Q], k2 [1, Q]) int32 bit patterns of the query keys on
    ``device``: built once per (query, device), not once per chunk."""
    qk = np.ascontiguousarray(_query_keys(query)).view(np.int32)
    t = torch.from_numpy(qk.copy()).to(device)
    return t[:, 0][None, :], t[:, 1][None, :]


@dataclasses.dataclass(frozen=True)
class Grep(InvertedIndex):
    """A filtered inverted index: posting values, doc-id stamping
    (host_values) and the egress format are inherited; grep adds the
    query-key filter on both engines."""

    name: str = "grep"
    query: tuple[str, ...] = ()

    def device_map(self, kv: KVBatch, doc_id) -> KVBatch:
        q1, q2 = _query_tensors(tuple(self.query), kv.k1.device)
        match = ((kv.k1[:, None] == q1) & (kv.k2[:, None] == q2)).any(dim=1)
        valid = kv.valid & match
        # Filtered rows become SENTINEL-keyed padding with value 0, not
        # real-keyed invalid rows: padding melts into one dead segment,
        # where a real-keyed invalid row would hold a state slot per
        # corpus word.
        return KVBatch(
            k1=torch.where(valid, kv.k1, SENTINEL_I32),
            k2=torch.where(valid, kv.k2, SENTINEL_I32),
            value=valid.to(torch.int32) * doc_id,
            valid=valid,
        )

    def host_mask(self, keys: np.ndarray) -> np.ndarray:
        qk = _query_keys(tuple(self.query))
        return (
            (keys[:, 0][:, None] == qk[:, 0][None, :])
            & (keys[:, 1][:, None] == qk[:, 1][None, :])
        ).any(axis=1)
