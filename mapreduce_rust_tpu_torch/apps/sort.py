"""Global sort — the range-partitioned MapReduce workload (the port of
``mapreduce_rust_tpu/apps/sort.py``).

- map/combine is word count (sum of occurrences per token);
- egress routes by RANGE, not hash: partition = searchsorted of the word's
  packed 8-byte prefix over the R-1 splitters that the sampled-splitter
  subsystem (runtime/splitter.py) derived and ``prepare_app`` bound onto
  this frozen instance before the stream started;
- ``emit_lines`` emits the word once per occurrence, so the concatenation
  of ``mr-{r}.txt`` in partition order is exactly ``sorted()`` of the
  corpus token multiset: range routing orders the partitions, the egress
  sort orders within each, and the prefix pack is order-preserving with
  equal-prefix words always sharing a partition.

Egress materializes one line per occurrence in RAM; a sort larger than
RAM waits for the streaming egress of the spill tiers.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from mapreduce_rust_tpu_torch.apps.base import App
from mapreduce_rust_tpu_torch.ops.partition import pack_word_prefix, range_partition


@functools.lru_cache(maxsize=8)
def _splitter_array(splitters: tuple) -> np.ndarray:
    """The bound splitter tuple as a frozen uint64 array, cached so the
    per-block route does not rebuild it."""
    arr = np.asarray(splitters, dtype=np.uint64)
    arr.flags.writeable = False
    return arr


@dataclasses.dataclass(frozen=True)
class Sort(App):
    name: str = "sort"
    combine_op: str = "sum"
    partition_mode = "range"

    def route(self, word: "bytes | None", k1: int, reduce_n: int) -> int:
        if word is None:
            return 0  # unknown-key guard: counted upstream, never crashes
        return int(range_partition(
            pack_word_prefix([word]), _splitter_array(self.splitters)
        )[0])

    def route_block(self, words, k1s, reduce_n: int):
        return range_partition(
            pack_word_prefix(words), _splitter_array(self.splitters)
        ).tolist()

    def emit_lines(self, word: bytes, value) -> list[bytes]:
        """One line per OCCURRENCE: the sorted output is the input token
        multiset."""
        return [word] * int(value)
