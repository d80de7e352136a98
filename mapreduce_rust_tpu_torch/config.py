"""Single config object for the PyTorch/CUDA port.

The port of ``mapreduce_rust_tpu/config.py`` for the fields the
single-device engines (device engine and host-map engine, every app), the
mesh (chunked and sequence-parallel, with its checkpoint; one process or
several), the coordinator/worker task path, the multi-tenant job service, tracing,
the run manifest, the live metrics, the sampling profiler, the device
trace and the provenance ledger read, with the reference's names, defaults
and validation — except ``device``, which defaults to ``"cuda"``: the
port's entry points run on the card and raise without one, unless the
caller asks for the CPU with ``device="cpu"``.

One reference field has no counterpart: ``compilation_cache_dir`` (XLA's
persistent compile cache; nothing here compiles through XLA).
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


def profile_forced() -> bool:
    """``MR_PROFILE`` — process-tree opt-in to the sampling profiler: a
    chaos child or SIGKILL-test subprocess inherits profiling without a
    flag in its argv."""
    return os.environ.get("MR_PROFILE", "").strip().lower() in (
        "1", "true", "on", "yes"
    )


def _usable_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # non-Linux
        return os.cpu_count() or 1


DEVICES = ("auto", "cuda", "cpu")


@dataclasses.dataclass
class Config:
    map_n: int = 6          # number of map tasks (one per input file)
    reduce_n: int = 4       # number of reduce partitions (mr-{r}.txt)
    worker_n: int = 1       # the coordinator's registration barrier size

    # ---- Data plane ----
    chunk_bytes: int = 1 << 22      # bytes per map chunk fed to the device
    max_word_len: int = 64          # halo of the sequence-parallel mesh
                                    # tokenizer: a longer token that straddles
                                    # a shard edge is counted in
                                    # halo_truncations
    merge_capacity: int = 1 << 21   # running distinct-key capacity on device
    partial_capacity: Optional[int] = None  # per-chunk distinct-key cap
                                    # (None → max(chunk_bytes // 8, 1024);
                                    # overflow replays the chunk full-width)
    bucket_capacity_factor: float = 2.0  # mesh all_to_all per-bucket
                                    # slack over an even split; a bucket that
                                    # overflows replays its group (exact)
    device: str = "cuda"            # "cuda" | "auto" (= "cuda") | "cpu"
    mesh_shape: Optional[int] = None  # shards of the 1-D mesh; > 1 runs the
                                    # mesh driver, shard i on cuda:(i % the
                                    # card count), or all on the CPU with
                                    # device="cpu"
    sharded_stream: bool = False    # mesh only: each window rides the mesh
                                    # as ONE byte stream cut at arbitrary
                                    # offsets; a halo exchange
                                    # (parallel/halo.py) counts straddling
                                    # tokens exactly once
    multihost_barrier_timeout_s: float = 120.0  # how long a multi-process
                                    # run waits at the dictionary-exchange
                                    # barrier for every peer's shard before
                                    # failing the job (a dead peer's hash
                                    # classes died with it: fail loudly,
                                    # rerun the job)
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

    # ---- Observability ----
    trace_path: Optional[str] = None  # write a Chrome trace-event JSON of
                                    # the run's spans (runtime/trace.py);
                                    # workers and the coordinator suffix it
                                    # per process
    manifest_path: Optional[str] = None  # write the machine-readable run
                                    # manifest (runtime/telemetry.py), also
                                    # when the run fails
    flight_record_period_s: float = 5.0  # traced processes rewrite an
                                    # atomic {trace}.partial.json at most
                                    # this often, so a SIGKILLed worker's
                                    # timeline survives
    metrics_enabled: bool = True    # live metrics registry + time-series
                                    # ring (runtime/metrics.py), sampled
                                    # from the consumer/poll/renewal loops
    metrics_sample_period_s: float = 1.0  # wall-clock bucket of one point
    metrics_ring_points: int = 512  # ring capacity (oldest evicted)
    metrics_port: int = 0           # coordinator only: Prometheus text
                                    # exposition on this port; 0 = off
    sanitize: bool = False          # opt-in thread-ownership sanitizer
                                    # (analysis/sanitize.py); MR_SANITIZE=1
                                    # turns it on for a process tree
    profile_dir: Optional[str] = None  # write a torch.profiler Chrome
                                    # trace of the stream phase here, with
                                    # CUDA activity on a card (raises if
                                    # the profiler cannot record it)
    profile: bool = False           # in-process sampling profiler
                                    # (runtime/prof.py): one thread walks
                                    # sys._current_frames() at profile_hz,
                                    # collapsed stacks keyed by the mr/
                                    # plane-thread names, embedded in the
                                    # manifest as stats.profile and in
                                    # flight-recorder partials. Off by
                                    # default (--profile / MR_PROFILE=1)
    profile_hz: float = 97.0        # sampler rate; prime, so it never
                                    # phase-locks with 1/10/100 Hz work
    lineage: bool = False           # chunk-level data lineage
                                    # (runtime/lineage.py): per-chunk
                                    # blake2b content digests + partition
                                    # routing recorded to
                                    # {work_dir}/lineage.jsonl and
                                    # summarized as stats.lineage; the
                                    # `lineage` CLI answers forward/
                                    # backward/blast-radius queries.
                                    # Observational only: outputs stay
                                    # byte-identical on and off
                                    # (--lineage / MR_LINEAGE=1)

    # ---- Control plane (the Rust reference's timings) ----
    host: str = "127.0.0.1"
    port: int = 1040
    lease_timeout_s: float = 5.0
    lease_check_period_s: float = 5.0
    lease_renew_period_s: float = 1.0
    poll_retry_s: float = 1.0       # worker sleep on -2/-3, backing off
    rpc_timeout_s: float = 15.0     # per-call deadline on worker →
                                    # coordinator RPCs; a timeout raises
                                    # RpcTimeout, never ConnectionError
    sched: str = "fifo"             # "fifo": a strict map barrier;
                                    # "pipeline": reduce task r is granted
                                    # once every map task reported bytes
                                    # for partition r (outputs identical)
    speculate: bool = False         # re-issue the slowest in-flight task
                                    # near phase end; first finish wins
    speculate_after_frac: float = 0.75  # phase fraction done before it arms
    speculate_slow_factor: float = 1.5  # ...and only attempts this many
                                    # task p50s slow (once >= 3 samples)
    speculate_max_attempts: int = 2  # concurrent attempts per task
    chaos: Optional[str] = None     # deterministic fault-injection spec
                                    # (analysis/chaos.py grammar, e.g.
                                    # "kill:map:*"); MR_CHAOS overrides
    rpc_backoff_base_s: float = 0.05  # first retry delay
    rpc_backoff_cap_s: float = 2.0  # delay envelope cap
    rpc_backoff_budget_s: float = 60.0  # total retry budget per operation
    poll_retry_cap_s: Optional[float] = None  # sentinel-poll backoff cap;
                                    # None = 4 × poll_retry_s

    # ---- Multi-tenant job service (service/server.py) ----
    service_max_jobs: int = 3       # concurrent RUNNING jobs the service
                                    # admits; further submissions queue
                                    # (FIFO within priority)
    service_inflight_budget_mb: float = 256.0  # admission budget: total
                                    # input MiB across RUNNING jobs; a job
                                    # that would pass it stays QUEUED
                                    # (the doctor's `service-saturated`),
                                    # unless nothing is running
    service_cache_entries: int = 64  # result-cache capacity (LRU, keyed on
                                    # app, corpus digest, config digest); a
                                    # repeated submission is served from it
                                    # with zero new task grants; 0 = off

    # ---- Data-plane checkpoint (the chunked mesh driver) ----
    checkpoint_every_groups: int = 0  # > 0: after every N mesh groups,
                                    # drain the pipeline and write an atomic
                                    # work_dir/driver.ckpt.npz (per-shard
                                    # state, host accumulator, progress) with
                                    # the dictionary beside it
    resume: bool = False            # start from work_dir/driver.ckpt.* when
                                    # it matches this job's fingerprint

    # ---- Paths ----
    input_dir: str = "data"
    input_pattern: str = "*.txt"
    input_dirs: "Optional[tuple]" = None  # multi-corpus input: ordered
                                    # ((name, dir), ...) pairs, the CLI's
                                    # --input a=DIR b=DIR, sorted by name.
                                    # When set it supersedes input_dir and
                                    # doc ids run over the concatenated
                                    # listings (chunker.resolve_corpora)
    work_dir: str = "mr-work"        # intermediates / checkpoints
    output_dir: str = "mr-out"       # final per-partition outputs

    def __post_init__(self) -> None:
        if self.map_n <= 0 or self.reduce_n <= 0 or self.worker_n <= 0:
            raise ValueError("map_n, reduce_n, worker_n must be positive")
        if self.chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")
        if self.chunk_bytes <= 2 * self.max_word_len:
            raise ValueError("chunk_bytes too small for max_word_len halo")
        if self.device not in DEVICES:
            raise ValueError(f"unknown device {self.device!r}; have {DEVICES}")
        if self.merge_capacity < 1:
            raise ValueError("merge_capacity must be >= 1")
        if self.multihost_barrier_timeout_s <= 0:
            raise ValueError("multihost_barrier_timeout_s must be positive")
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
        if self.rpc_timeout_s <= 0:
            raise ValueError("rpc_timeout_s must be positive")
        if self.flight_record_period_s <= 0:
            raise ValueError("flight_record_period_s must be positive")
        if not 0.0 < self.speculate_after_frac <= 1.0:
            raise ValueError("speculate_after_frac must be in (0, 1]")
        if self.speculate_slow_factor < 1.0:
            raise ValueError("speculate_slow_factor must be >= 1.0")
        if self.speculate_max_attempts < 2:
            raise ValueError(
                "speculate_max_attempts must be >= 2 (the original plus at "
                "least one speculative copy)"
            )
        if self.rpc_backoff_base_s <= 0 or self.rpc_backoff_cap_s <= 0 \
                or self.rpc_backoff_budget_s <= 0:
            raise ValueError("rpc_backoff_* must be positive")
        if self.metrics_sample_period_s <= 0:
            raise ValueError("metrics_sample_period_s must be positive")
        if self.metrics_ring_points < 8:
            raise ValueError("metrics_ring_points must be >= 8")
        if self.metrics_port < 0:
            raise ValueError("metrics_port must be >= 0 (0 = off)")
        if self.poll_retry_cap_s is not None and self.poll_retry_cap_s <= 0:
            raise ValueError("poll_retry_cap_s must be positive (or None)")
        if self.sched not in ("fifo", "pipeline"):
            raise ValueError(f"unknown sched {self.sched!r} "
                             "(expected 'fifo' or 'pipeline')")
        if self.service_max_jobs < 1:
            raise ValueError("service_max_jobs must be >= 1")
        if self.service_inflight_budget_mb <= 0:
            raise ValueError("service_inflight_budget_mb must be positive")
        if self.service_cache_entries < 0:
            raise ValueError("service_cache_entries must be >= 0 (0 = off)")
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
        if self.chaos:
            # Fail at config time, not mid-task inside a worker: a typo'd
            # fault spec is a loud error before any lease is granted.
            from mapreduce_rust_tpu_torch.analysis.chaos import ChaosPlan

            ChaosPlan.parse(self.chaos)

    def corpora(self) -> "tuple[tuple[str, str], ...]":
        """The job's ordered (name, dir) corpus list, multi-corpus or
        classic — the one accessor inputs resolve through."""
        if self.input_dirs is not None:
            return tuple(self.input_dirs)
        return (("corpus", self.input_dir),)

    @property
    def sched_pipeline(self) -> bool:
        """True when the coordinator releases reduce tasks per partition."""
        return self.sched == "pipeline"

    def effective_poll_retry_cap_s(self) -> float:
        return self.poll_retry_cap_s or 4.0 * self.poll_retry_s

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
