"""Inverted index: term → sorted list of doc_ids containing it (the port of
``mapreduce_rust_tpu/apps/inverted_index.py``).

- device_map stamps the chunk's doc_id as every valid record's value, so
  the stream becomes (term-hash, doc_id) pairs;
- combine_op "distinct" makes the value part of the sort key
  (ops/groupby.py): duplicates of (term, doc) collapse on the device and
  the posting set builds associatively across chunks, with no
  variable-length list in device memory;
- egress groups the surviving (term, doc) pairs by term on the host and
  emits 'word d0,d1,...' with doc_ids ascending.
"""

from __future__ import annotations

import dataclasses

import torch

from mapreduce_rust_tpu_torch.apps.base import App
from mapreduce_rust_tpu_torch.core.kv import KVBatch


@dataclasses.dataclass(frozen=True)
class InvertedIndex(App):
    name: str = "inverted_index"
    combine_op: str = "distinct"

    def device_map(self, kv: KVBatch, doc_id) -> KVBatch:
        # valid * doc_id stays int32 whether doc_id is an int or a 0-d int32
        # tensor on the device (a captured step's static doc id).
        return KVBatch(k1=kv.k1, k2=kv.k2,
                       value=kv.valid.to(torch.int32) * doc_id, valid=kv.valid)

    def host_values(self, counts, doc_id: int):
        """Every unique term of the window posts this window's doc_id — the
        host-engine mirror of device_map's doc_id stamp."""
        import numpy as np

        return np.full(len(counts), doc_id, dtype=np.uint32)

    def format_line(self, word: bytes, value) -> bytes:
        return b"%s %s" % (word, ",".join(str(d) for d in value).encode())
