"""Two-input equi-join on the token (the port of
``mapreduce_rust_tpu/apps/join.py``): for every word present in BOTH
corpora, one line per (left doc, right doc) pair containing it.

- doc_ids are global over the concatenated listing of the corpora
  (runtime/chunker.resolve_corpora), so the doc_id stamp inherited from
  InvertedIndex already encodes the side: ``doc_id < corpus_bounds[0]``
  is the left corpus;
- combine_op "distinct" builds each word's posting set; the same word
  hashes identically from either corpus, so both sides of a key land in
  one partition;
- ``emit_lines`` splits the posting set at the bound corpus boundary and
  emits the cross product with corpus-relative doc ids ("word aDoc
  bDoc"), and [] for a key found on one side only.

``requires_corpora = 2`` makes prepare_app reject any other corpus count
before anything streams.
"""

from __future__ import annotations

import bisect
import dataclasses

from mapreduce_rust_tpu_torch.apps.inverted_index import InvertedIndex


@dataclasses.dataclass(frozen=True)
class Join(InvertedIndex):
    """An inverted index whose egress is the inner-join cross product."""

    name: str = "join"
    requires_corpora = 2

    def corpus_of(self, doc_id: int) -> int:
        """Which corpus a global doc_id came from (bisect over the bound
        cumulative boundaries)."""
        return bisect.bisect_right(self.corpus_bounds, doc_id)

    def emit_lines(self, word: bytes, value) -> list[bytes]:
        bound = self.corpus_bounds[0]
        left = [d for d in value if d < bound]
        right = [d - bound for d in value if d >= bound]
        if not left or not right:
            return []  # one-sided key: the inner join drops it
        return [
            b"%s %d %d" % (word, a, b)
            for a in left for b in right
        ]

    def format_line(self, word: bytes, value) -> bytes:  # pragma: no cover
        raise NotImplementedError(
            "join emits via emit_lines (cross-product pairs), never a "
            "single posting line"
        )
