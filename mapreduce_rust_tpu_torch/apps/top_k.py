"""Top-k most frequent words (the port of ``mapreduce_rust_tpu/apps/top_k.py``).

Counting is word count; selection happens at egress. The map/combine path
is WordCount's (sum combiner), so the device does the counting and
finalize keeps only the k most frequent words. Output goes to partition 0:
a global top-k is one list, not reduce_n hash partitions. Ties break
bytewise on the word, so the output is deterministic at any reduce_n.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable

from mapreduce_rust_tpu_torch.apps.base import App


@dataclasses.dataclass(frozen=True)
class TopK(App):
    name: str = "top_k"
    combine_op: str = "sum"
    k: int = 20

    @property
    def device_select_k(self) -> int:
        """A mesh run may pull only per-device top-k candidates."""
        return self.k

    def finalize(
        self, items: Iterable[tuple[bytes, int, tuple[int, int]]], reduce_n: int
    ) -> dict[int, list[bytes]]:
        top = heapq.nsmallest(self.k, items, key=lambda it: (-it[1], it[0]))
        parts: dict[int, list[bytes]] = {r: [] for r in range(reduce_n)}
        parts[0] = [self.format_line(w, v) for w, v, _ in top]
        return parts

    def finalize_partition(self, items: Iterable, partition: int) -> list[bytes]:
        """Per-partition top-k *candidates*: partitions hold disjoint key
        sets, so the global top-k is a subset of the union of the
        per-partition top-k's."""
        top = heapq.nsmallest(self.k, items, key=lambda it: (-it[1], it[0]))
        return [self.format_line(w, v) for w, v, _ in top]

    def merge_lines(self, lines: Iterable[bytes]) -> list[bytes]:
        """Global selection over the candidates."""
        parsed = []
        for line in lines:
            word, val = line.rsplit(b" ", 1)
            parsed.append((word, int(val)))
        top = heapq.nsmallest(self.k, parsed, key=lambda it: (-it[1], it[0]))
        return [self.format_line(w, v) for w, v in top]
