"""Job metrics & phase timing — per phase, never per record.

The port of ``mapreduce_rust_tpu/runtime/metrics.py::JobStats`` for the
counters the single-device engines (device and host-map), the spill
tiers and egress fill, under the reference's names, so a port run and a
reference run compare field by field. The live metrics registry and
tracing come with a later slice.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from contextlib import contextmanager

log = logging.getLogger("mapreduce_rust_tpu_torch")


@dataclasses.dataclass
class JobStats:
    bytes_in: int = 0
    chunks: int = 0
    forced_cuts: int = 0          # tokens longer than chunk_bytes, split
    distinct_keys: int = 0        # final distinct key count
    spill_events: int = 0         # merges whose evicted tail was non-empty
    spilled_keys: int = 0         # records moved device → host accumulator
    partial_overflow_replays: int = 0  # chunks re-run on the full-width path
    accum_spill_runs: int = 0     # accrun-* disk runs the accumulator's
                                  # budget tier wrote (counted at job end,
                                  # before the run files are deleted)
    dict_spill_runs: int = 0      # dictrun-* disk runs, same contract
    dictionary_words: int = 0     # distinct words over both tiers
    hash_collisions: int = 0
    unknown_keys: int = 0         # final keys missing from the dictionary
    wall_seconds: float = 0.0
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    # Who is the bottleneck: time the consumer loop sat waiting for host
    # ingest (read→normalize→chunk) vs blocked on device results.
    ingest_wait_s: float = 0.0
    device_wait_s: float = 0.0
    # Host-map engine (map_engine="host"): the scan pool, the router's own
    # work, the fold shards and the dispatch plane, each in seconds.
    host_map_workers: int = 0
    fold_shards: int = 0
    host_map_s: float = 0.0       # scan seconds summed over the workers
    host_glue_s: float = 0.0      # router work per window, stalls excluded
    scan_wait_s: float = 0.0      # router blocked on the oldest scan
    dispatch_s: float = 0.0       # dispatch-thread scatter/pack/copy/merge
    dispatch_stall_s: float = 0.0  # router blocked on the dispatch plane
    dispatch_mode: str = ""       # "sync"|"async" [+coalesce]
    merge_dispatches: int = 0     # packed device merges
    merge_fill_frac: float = 0.0  # records shipped / (dispatches × cap)
    fold_s: float = 0.0           # dictionary fold seconds (device engine:
                                  # its consumer; host engine: summed over shards)
    fold_stall_s: float = 0.0     # router blocked on full shard queues
    # Spill tiers (runtime/spill.py), summed over every writer thread.
    spill_s: float = 0.0          # writer seconds sorting/packing/writing runs
    spill_stall_s: float = 0.0    # owner seconds blocked on a full writer queue
    spill_bytes: int = 0          # bytes written to runs (both tiers)
    merge_fanin: int = 0          # sources the egress k-way merge saw
                                  # (0 = in-RAM egress)
    host_arena_bytes: int = 0     # live native scan arenas at stream end
    # Egress and the workload plane.
    partition_bytes: list = dataclasses.field(default_factory=list)
    # bytes of formatted output per reduce partition (index = r): the
    # reduce-side skew signal
    partition_mode: str = "hash"  # "hash" (k1 % reduce_n) or "range"
    # (searchsorted over sampled splitters — sort)
    splitter_samples: int = 0     # tokens the splitter pre-pass drew
    # across all inputs (range apps only; 0 = no pre-pass ran)
    splitter_s: float = 0.0       # wall seconds of the sample+derive pre-pass
    # Named distributions: "spill.write_s" (seconds per run, every writer).
    hists: dict = dataclasses.field(default_factory=dict)

    @property
    def gb_per_s(self) -> float:
        return self.bytes_in / self.wall_seconds / 1e9 if self.wall_seconds else 0.0

    @property
    def bottleneck(self) -> str:
        # With several scan workers the summed host_map_s is no wall time;
        # the router's wait on the oldest scan is. Off-router planes (fold
        # shards, async dispatch) name themselves by the router's stall.
        scan = self.host_map_s if self.host_map_workers <= 1 else self.scan_wait_s
        parts = {"host-ingest": self.ingest_wait_s, "device": self.device_wait_s,
                 "host-map": scan, "host-glue": self.host_glue_s}
        if self.fold_shards > 1:
            parts["host-fold"] = self.fold_stall_s
        if self.spill_s > 0 or self.spill_stall_s > 0:
            # Runs are written off the hot threads: "the disk is the
            # ceiling" reads as the owners' writer backpressure.
            parts["spill"] = self.spill_stall_s
        if self.dispatch_mode.startswith("async"):
            parts["merge-dispatch"] = self.dispatch_stall_s
        name, val = max(parts.items(), key=lambda kv: kv[1])
        return name if val > 0 else "balanced"

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + dt
            log.info("phase %-10s %8.3fs", name, dt)

    def summary(self) -> str:
        phases = " ".join(f"{k}={v:.2f}s" for k, v in self.phase_seconds.items())
        return (
            f"{self.bytes_in / 1e6:.2f} MB in {self.wall_seconds:.3f}s "
            f"({self.gb_per_s:.3f} GB/s) chunks={self.chunks} "
            f"distinct={self.distinct_keys} dict={self.dictionary_words} "
            f"spills={self.spill_events}({self.spilled_keys} keys) "
            f"replays={self.partial_overflow_replays} "
            f"collisions={self.hash_collisions} unknown={self.unknown_keys} "
            f"waits[ingest={self.ingest_wait_s:.2f}s device={self.device_wait_s:.2f}s "
            f"→ {self.bottleneck}] [{phases}]"
            + (f" host[workers={self.host_map_workers} shards={self.fold_shards} "
               f"scan={self.host_map_s:.2f}s glue={self.host_glue_s:.2f}s "
               f"fold={self.fold_s:.2f}s dispatch={self.dispatch_s:.2f}s "
               f"merges={self.merge_dispatches} fill={self.merge_fill_frac:.3f} "
               f"{self.dispatch_mode}]" if self.dispatch_mode else "")
            + (f" spill[runs acc={self.accum_spill_runs} dict={self.dict_spill_runs} "
               f"write={self.spill_s:.2f}s stall={self.spill_stall_s:.2f}s "
               f"bytes={self.spill_bytes} fanin={self.merge_fanin}]"
               if self.accum_spill_runs or self.dict_spill_runs else "")
        )
