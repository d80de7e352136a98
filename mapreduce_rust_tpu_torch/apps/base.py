"""The app plugin seam.

The port of ``mapreduce_rust_tpu/apps/base.py``: an app is an object the
driver is parameterized by, split along the device/host seam —

- **device_map** — a per-chunk transform applied on the device to the
  tokenized torch KVBatch (e.g. stamp doc_id as the value); must be
  shape-preserving and must not copy to the host.
- **combine_op** — the associative reduce op (ops/groupby.REDUCE_OPS),
  which lets per-chunk partials merge on the device and spilled tails sum
  on the host.
- **host_mask** / **host_values** — the host-map engine's twins of
  device_map: which of a window's unique keys to keep, and their values
  given their occurrence counts.
- **finalize** and the other host methods — egress: turn the final
  (word, value) table into ``mr-{r}.txt`` lines, partitioned by
  ``k1 % reduce_n`` like the reference's split (hash mode) or by sampled
  splitters (range mode, sort). They are copied from the reference
  package unchanged, so the two write the same bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from mapreduce_rust_tpu_torch.core.kv import KVBatch

#: finalize receives, per key: int value for scalar ops ("sum"/"max"/"min"),
#: or a sorted list[int] of distinct values for "distinct".
FinalValue = "int | list[int]"


@dataclasses.dataclass(frozen=True)
class App:
    """Base app: identity device_map, sum combiner, 'word value' egress."""

    name: str = "app"
    combine_op: str = "sum"
    #: Range apps (sort): R-1 packed-uint64 splitters, bound by the
    #: sampled-splitter subsystem (runtime/splitter.prepare_app) before the
    #: job streams. () = unbound.
    splitters: tuple = ()
    #: Multi-corpus apps (join): cumulative doc counts of corpora[:-1] in
    #: the flat doc_id space, bound by prepare_app. A record's corpus is
    #: bisect(corpus_bounds, doc_id). () = single corpus.
    corpus_bounds: tuple = ()

    #: "hash" routes egress by k1 % reduce_n; "range" routes by
    #: searchsorted over the bound splitters, so partition order is key
    #: order (ops/partition.py). A class attribute, not a field: the mode is
    #: the app's shape, not per-job state.
    partition_mode = "hash"
    #: Non-zero: prepare_app requires exactly this many input corpora (join:
    #: 2) at bind time, before anything streams. A class attribute too.
    requires_corpora = 0

    def device_map(self, kv: KVBatch, doc_id) -> KVBatch:
        """On-device per-chunk transform; doc_id is the chunk's index in the
        job's flat input listing (every corpus's files, concatenated): an
        int, or a 0-d int32 tensor on the device in a captured step
        (runtime/step_graph.py), so it is never read back to the host."""
        return kv

    @property
    def device_select_k(self) -> "int | None":
        """Non-None: the mesh driver may finish the job from per-shard top-k
        candidates (parallel/topk.py)."""
        return None

    def host_mask(self, keys) -> "object | None":
        """Host-map-engine twin of a FILTERING device_map: given the
        window's unique keys (uint32 [n, 2]), return a bool[n] keep-mask,
        or None (default) for keep-everything. Applied by the host engine
        BEFORE host_values, whose inputs are already filtered."""
        return None

    def host_values(self, counts, doc_id: int):
        """Host-map-engine counterpart of device_map: values for one
        window's unique keys, given their occurrence counts (uint32[n]).
        Must agree with device_map ∘ combine_op — the two engines are
        interchangeable and tested equal. The default is only correct for
        sum apps (occurrence counts); any other combine_op must override
        rather than inherit a silently wrong value stream."""
        if self.combine_op != "sum":
            raise NotImplementedError(
                f"app {self.name!r} (combine_op={self.combine_op!r}) must "
                "override host_values to run under map_engine='host'"
            )
        return counts

    def route(self, word: "bytes | None", k1: int, reduce_n: int) -> int:
        """Output partition of one key: k1 % reduce_n on the UNSIGNED k1,
        the reference's partitioner. The word is ignored in hash mode."""
        return k1 % reduce_n

    def route_block(self, words, k1s, reduce_n: int):
        """Vectorized ``route`` for a block of (word, k1) pairs; k1s are
        unsigned (uint32 or int64 holding uint32 values)."""
        import numpy as np

        return (np.asarray(k1s, dtype=np.int64) % reduce_n).tolist()

    def emit_lines(self, word: bytes, value: "FinalValue") -> list[bytes]:
        """Output lines for ONE final key. Default: one 'word value' line."""
        return [self.format_line(word, value)]

    def finalize(
        self, items: Iterable[tuple[bytes, "FinalValue", tuple[int, int]]], reduce_n: int
    ) -> dict[int, list[bytes]]:
        """items: (word, value, key_pair) for every distinct key, unordered.

        Returns partition → output lines (no trailing newline): routed via
        ``self.route``, emitted via ``self.emit_lines``, sorted bytewise
        within each partition like the reference's sort-then-emit reduce.
        """
        parts: dict[int, list[bytes]] = {r: [] for r in range(reduce_n)}
        for word, value, (k1, _k2) in items:
            parts[self.route(word, k1, reduce_n)].extend(
                self.emit_lines(word, value)
            )
        for lines in parts.values():
            lines.sort()
        return parts

    def finalize_partition(self, items: Iterable, partition: int) -> list[bytes]:
        """Egress for ONE reduce partition (items already routed)."""
        lines: list[bytes] = []
        for w, v, _ in items:
            lines.extend(self.emit_lines(w, v))
        lines.sort()
        return lines

    def merge_lines(self, lines: Iterable[bytes]) -> list[bytes]:
        """Global merge of all partitions' lines — the reference's
        `cat mr-* | sort > final.txt`."""
        return sorted(lines)

    def format_line(self, word: bytes, value: "FinalValue") -> bytes:
        return b"%s %d" % (word, value)
