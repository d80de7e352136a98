"""Single config object for the PyTorch/CUDA port.

The port of ``mapreduce_rust_tpu/config.py`` for the fields the
single-device engines read (device engine and host-map engine, every app),
with the reference's names and defaults — except ``device``, which
defaults to ``"cuda"``: the port's entry points run on the card and raise
without one, unless the caller asks for the CPU with ``device="cpu"``.

Fields of engines this package does not have yet keep their reference
names and defaults so that a reference Config's settings read the same
here; setting one to anything else raises ``NotImplementedError`` instead
of being ignored.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def sync_dispatch_forced() -> bool:
    """``MR_DISPATCH_SYNC`` — process-tree opt-out of the async dispatch
    plane. Both the driver (plane construction) and the fold-shard auto
    heuristic below read it, so the two never disagree on what counts as
    async."""
    return os.environ.get("MR_DISPATCH_SYNC", "").strip().lower() in (
        "1", "true", "on", "yes"
    )


def _usable_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # non-Linux
        return os.cpu_count() or 1

#: Reference fields whose engines are not ported: field → the only value
#: accepted (the reference default, which leaves the engine off).
NOT_PORTED = {
    "mesh_shape": None,                # multi-device mesh
    "sharded_stream": False,           # halo-exchange ingestion
    "checkpoint_every_groups": 0,      # mesh checkpoint
    "resume": False,
    "trace_path": None,                # Chrome trace
    "manifest_path": None,             # run manifest
    "profile_dir": None,               # device profiler trace
    "profile": False,                  # sampling profiler
    "lineage": False,                  # provenance ledger
}

DEVICES = ("auto", "cuda", "cpu")


@dataclasses.dataclass
class Config:
    reduce_n: int = 4       # number of reduce partitions (mr-{r}.txt)

    # ---- Data plane ----
    chunk_bytes: int = 1 << 22      # bytes per map chunk fed to the device
    merge_capacity: int = 1 << 21   # running distinct-key capacity on device
    partial_capacity: Optional[int] = None  # per-chunk distinct-key cap
                                    # (None → max(chunk_bytes // 8, 1024);
                                    # overflow replays the chunk full-width)
    device: str = "cuda"            # "cuda" | "auto" (= "cuda") | "cpu"
    ingest_threads: int = 4         # host threads for dictionary scans
    prefetch_chunks: int = 8        # chunker read-ahead depth (host queue)
    pipeline_depth: int = 64        # in-flight device steps before the host
                                    # reads back their counters in one copy

    # ---- Host-map engine (map_engine="host") ----
    map_engine: str = "device"      # "device": tokenize/combine on the card;
                                    # "host": the fused native scan maps on
                                    # the host, the card merges the updates
    host_window_bytes: int = 16 << 20  # map window of the host engine
    host_map_workers: Optional[int] = None  # scan threads; None = usable
                                    # cores minus one (the router's), min 1
    fold_shards: Optional[int] = None  # egress-fold shards; None = 1 below
                                    # 4 usable cores, else min(4, cores // 2)
    host_update_cap: int = 1 << 16  # records per packed device merge
    dispatch_async: bool = True     # merges dispatch from their own thread
                                    # (False or MR_DISPATCH_SYNC=1: inline
                                    # on the router; outputs identical)
    dispatch_coalesce: bool = True  # sum apps: successive windows' updates
                                    # pre-sum in a staging buffer before
                                    # they ship (outputs identical)
    dispatch_fill_frac: float = 0.5  # staging fill (of the stage cap) that
                                    # triggers a coalesced dispatch
    dispatch_stage_cap: Optional[int] = None  # staging records; None =
                                    # 64 × host_update_cap

    # ---- Spill tiers (runtime/spill.py) ----
    host_accum_budget_mb: Optional[int] = None  # set: the host
                                    # accumulator spills sorted runs
                                    # (accrun-*.npy) to work_dir whenever its
                                    # pending rows pass this many MiB, and
                                    # the job ends through the streaming
                                    # merge-join egress (outputs identical)
    dictionary_budget_words: Optional[int] = None  # set: the egress
                                    # dictionary spills sorted word runs
                                    # (dictrun-*.bin) at this many words in
                                    # RAM (split across fold shards)
    spill_async: bool = True        # budget flushes freeze a snapshot that a
                                    # background writer per tier (each
                                    # dictionary shard, the accumulator)
                                    # sorts, packs and writes while the
                                    # owner keeps going; False (or
                                    # MR_SPILL_SYNC=1) writes inline.
                                    # Outputs are identical either way

    # ---- Workload plane ----
    split_samples: int = 512        # range apps (sort): tokens the seeded
                                    # splitter pre-pass samples per input
                                    # file (runtime/splitter.py)

    # ---- Not ported (see NOT_PORTED) ----
    mesh_shape: Optional[int] = None
    sharded_stream: bool = False
    checkpoint_every_groups: int = 0
    resume: bool = False
    trace_path: Optional[str] = None
    manifest_path: Optional[str] = None
    profile_dir: Optional[str] = None
    profile: bool = False
    lineage: bool = False

    # ---- Paths ----
    input_dir: str = "data"
    input_pattern: str = "*.txt"
    input_dirs: "Optional[tuple]" = None  # multi-corpus input: ordered
                                    # ((name, dir), ...) pairs, the CLI's
                                    # --input a=DIR b=DIR, sorted by name.
                                    # When set it supersedes input_dir and
                                    # doc ids run over the concatenated
                                    # listings (chunker.resolve_corpora)
    work_dir: str = "mr-work"        # intermediates
    output_dir: str = "mr-out"       # final per-partition outputs

    def __post_init__(self) -> None:
        for name, accepted in NOT_PORTED.items():
            if getattr(self, name) != accepted:
                raise NotImplementedError(
                    f"Config.{name}={getattr(self, name)!r}: not ported to the "
                    f"PyTorch/CUDA package yet (only {accepted!r})"
                )
        if self.reduce_n <= 0 or self.chunk_bytes <= 0:
            raise ValueError("reduce_n and chunk_bytes must be positive")
        if self.device not in DEVICES:
            raise ValueError(f"unknown device {self.device!r}; have {DEVICES}")
        if self.merge_capacity < 1:
            raise ValueError("merge_capacity must be >= 1")
        if self.partial_capacity is not None and self.partial_capacity < 1:
            raise ValueError("partial_capacity must be >= 1 (or None)")
        if self.map_engine not in ("device", "host"):
            raise ValueError(f"unknown map_engine {self.map_engine!r}")
        if self.host_map_workers is not None and self.host_map_workers < 1:
            raise ValueError("host_map_workers must be >= 1 (or None for auto)")
        if self.fold_shards is not None and self.fold_shards < 1:
            raise ValueError("fold_shards must be >= 1 (or None for auto)")
        if not 0.0 < self.dispatch_fill_frac <= 1.0:
            raise ValueError("dispatch_fill_frac must be in (0, 1]")
        if self.dispatch_stage_cap is not None and self.dispatch_stage_cap < 1:
            raise ValueError("dispatch_stage_cap must be >= 1 (or None)")
        if self.host_window_bytes < 1 or self.host_update_cap < 1:
            raise ValueError("host_window_bytes and host_update_cap must be >= 1")
        if self.split_samples < 1:
            raise ValueError("split_samples must be >= 1")
        if self.input_dirs is not None:
            # Canonical, validated form (reference config.py:526-542): a
            # non-empty tuple of (name, dir) string pairs with unique
            # non-empty names.
            dirs = tuple(tuple(p) for p in self.input_dirs)
            if not dirs or not all(
                len(p) == 2 and all(isinstance(x, str) and x for x in p)
                for p in dirs
            ):
                raise ValueError(
                    "input_dirs must be ((name, dir), ...) string pairs"
                )
            names = [n for n, _ in dirs]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate corpus names in {names}")
            self.input_dirs = dirs

    def corpora(self) -> "tuple[tuple[str, str], ...]":
        """The job's ordered (name, dir) corpus list, multi-corpus or
        classic — the one accessor inputs resolve through."""
        if self.input_dirs is not None:
            return tuple(self.input_dirs)
        return (("corpus", self.input_dir),)

    def effective_partial_capacity(self) -> int:
        """The per-chunk distinct-key capacity of the map step."""
        return self.partial_capacity or max(self.chunk_bytes // 8, 1024)

    def effective_host_map_workers(self) -> int:
        """Resolved host-map scan worker count: the explicit knob, or the
        usable cores (cpuset/affinity-aware) minus one reserved for the
        router thread, which folds and dispatches full time."""
        if self.host_map_workers:
            return max(int(self.host_map_workers), 1)
        return max(_usable_cores() - 1, 1)

    def effective_fold_shards(self) -> int:
        """Resolved egress-fold shard count of the host-map engine: the
        explicit knob, or min(4, cores // 2) at >= 4 usable cores. Below 4
        cores: 2 when the dispatch plane is async and a dictionary budget
        declares a high-cardinality job (the off-router fold pays there),
        else 1 (the inline fold on the router)."""
        if self.fold_shards:
            return max(int(self.fold_shards), 1)
        n = _usable_cores()
        if n < 4:
            if (self.dispatch_async and not sync_dispatch_forced()
                    and self.dictionary_budget_words is not None):
                return 2
            return 1
        return min(4, n // 2)

    def effective_dispatch_stage_cap(self) -> int:
        """Resolved staging-combine capacity of the dispatch plane: the
        explicit knob (clamped up to one update cap), or 64 × the update
        cap — staging must span many windows' distinct keys for
        cross-window duplicates to cancel. The buffers are np.empty, so
        resident memory follows the fill actually reached."""
        if self.dispatch_stage_cap is not None:
            return max(int(self.dispatch_stage_cap), self.host_update_cap)
        return 64 * self.host_update_cap
