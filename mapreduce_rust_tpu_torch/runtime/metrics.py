"""Job metrics & phase timing — per phase, never per record.

The port of ``mapreduce_rust_tpu/runtime/metrics.py``. Two layers share
this module, as there:

- :class:`JobStats` — the one-shot per-run dataclass every engine fills
  and the manifest serializes, under the reference's field names, so a
  port run and a reference run compare field by field. Fields of engines
  the port does not have yet (the mesh, the XLA compile listener) stay at
  their zero defaults, so the manifest keeps the reference's keys.
- :class:`MetricsRegistry` — the live layer: named counters / gauges /
  histograms sampled by ``maybe_sample()`` from the existing consumer,
  poll and renewal loops into a bounded time-series ring (manifest
  ``stats.timeseries``, the renewal-RPC envelope, the coordinator's
  Prometheus endpoint). Never per record.

No torch import and no device probe anywhere in this module: the
registry must be constructible in the coordinator, a process that never
touches a device.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import re
import threading
import time
from contextlib import contextmanager

from mapreduce_rust_tpu_torch.runtime.histogram import EDGES, Histogram
from mapreduce_rust_tpu_torch.runtime.trace import trace_span

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
    # Device engine on a card (runtime/step_graph.py): chunks whose step ran
    # as a replay of the captured graph, and the graphs this job captured
    # (0 when an idle one of the process served it).
    step_graph_replays: int = 0
    step_graph_captures: int = 0
    # Mesh engine counters (not ported yet: they stay 0 on one device).
    bucket_skew_replays: int = 0
    halo_truncations: int = 0
    mesh_rounds: int = 0
    shuffle_wire_bytes: int = 0
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
    fold_shard_s: list = dataclasses.field(default_factory=list)
    fold_shard_idle_s: list = dataclasses.field(default_factory=list)
    # Spill tiers (runtime/spill.py), summed over every writer thread.
    spill_s: float = 0.0          # writer seconds sorting/packing/writing runs
    spill_stall_s: float = 0.0    # owner seconds blocked on a full writer queue
    spill_bytes: int = 0          # bytes written to runs (both tiers)
    merge_fanin: int = 0          # sources the egress k-way merge saw
                                  # (0 = in-RAM egress)
    host_arena_bytes: int = 0     # live native scan arenas at stream end
    all_to_all_s: float = 0.0     # mesh all_to_all seconds (0 on one device)
    # Kernel builds: one per library this process loaded for the first time
    # (ops/cuda_build.BUILD_LOG: nvcc and g++ builds are misses, loads of a
    # library already built hits), as runtime/driver._fold_builds assigns
    # them to jobs.
    compile_count: int = 0
    compile_s: float = 0.0
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0
    device_mem_high_bytes: int = 0  # high-water torch.cuda.memory_allocated
    # (max_memory_allocated), sampled from the drain loops only where CUDA
    # is already initialized (0 on the CPU)
    # Egress and the workload plane.
    partition_bytes: list = dataclasses.field(default_factory=list)
    # bytes of formatted output per reduce partition (index = r): the
    # reduce-side skew signal
    partition_mode: str = "hash"  # "hash" (k1 % reduce_n) or "range"
    # (searchsorted over sampled splitters — sort)
    splitter_samples: int = 0     # tokens the splitter pre-pass drew
    # across all inputs (range apps only; 0 = no pre-pass ran)
    splitter_s: float = 0.0       # wall seconds of the sample+derive pre-pass
    mesh_shard_rows: list = dataclasses.field(default_factory=list)
    # Named distributions: "spill.write_s" (seconds per run, every writer),
    # "host_map.scan_s", "device.drain_s", "worker.task_s". Serialized into
    # the manifest as "histograms" by telemetry.stats_to_dict.
    hists: dict = dataclasses.field(default_factory=dict)

    def record_hist(self, name: str, value: float) -> None:
        """Fold one sample into the named latency/size histogram. Same
        ownership contract as every other stats write (the sanitizer's
        registered-writer gate covers it)."""
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        h.add(value)

    def register_writer(self) -> None:
        """Sanitizer hook: announce the calling thread as a legitimate
        concurrent writer. No-op here; the sanitized subclass
        (analysis/sanitize.SanitizedJobStats) records the thread and
        rejects writes from any thread that never registered."""

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
            # Phases double as top-level timeline spans ("phase.stream",
            # "phase.finalize", "phase.egress") when tracing is on.
            with trace_span(f"phase.{name}"):
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


# ---------------------------------------------------------------------------
# Live metrics registry
# ---------------------------------------------------------------------------

TIMESERIES_SCHEMA = 1

#: Prometheus metric-name charset; anything else becomes "_".
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _series_key(name: str, labels: tuple) -> str:
    """Flat series identity: ``name`` or ``name{k=v,k2=v2}`` — the key the
    ring, the manifest and the scrape endpoint all agree on."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _prom_name(name: str, prefix: str = "mr_") -> str:
    return prefix + _NAME_RE.sub("_", name)


def _prom_labels(labels: tuple) -> str:
    if not labels:
        return ""
    body = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\").replace('"', r"\""))
        for k, v in labels
    )
    return "{" + body + "}"


def _prom_num(v) -> str:
    if isinstance(v, float):
        return format(v, ".10g")
    return str(v)


class _Instrument:
    """One named metric; label-sets map to independent values. Mutations
    take the registry lock — cheap at the allowed per-window/per-poll
    rate, and the doctrine (module docstring) forbids per-record calls."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str = "") -> None:
        self._registry = registry
        self.name = name
        self.help = help
        self._values: dict = {}

    @staticmethod
    def _labelkey(labels: dict) -> tuple:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def remove_labels(self, **labels) -> int:
        """Drop every label-set whose labels INCLUDE the given pairs
        (``remove_labels(job="j3")`` drops all of j3's series whatever
        the other labels say). The long-lived-server hygiene hook
       : a multi-tenant registry that only ever adds
        label-sets grows without bound and keeps exporting a finished
        tenant's stale last values. Returns the number dropped; already-
        recorded ring points keep their history (the ring is bounded)."""
        want = {(k, str(v)) for k, v in labels.items()}
        with self._registry._lock:
            victims = [
                key for key in self._values if want <= set(key)
            ]
            for key in victims:
                del self._values[key]
        return len(victims)


class Counter(_Instrument):
    """Monotonic count. ``inc`` for push-style sites; ``set_total`` for
    pull-style mirrors of an externally-accumulated total (e.g. the
    coordinator re-publishing JobReport RPC counts each serve tick)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._labelkey(labels)
        with self._registry._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def set_total(self, value: float, **labels) -> None:
        key = self._labelkey(labels)
        with self._registry._lock:
            # Monotonicity kept even against a sloppy publisher: a counter
            # that goes backwards reads as a process restart to scrapers.
            if value >= self._values.get(key, 0):
                self._values[key] = value


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._labelkey(labels)
        with self._registry._lock:
            self._values[key] = value

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._labelkey(labels)
        with self._registry._lock:
            self._values[key] = self._values.get(key, 0) + amount


class HistogramMetric(_Instrument):
    """Label-set → runtime.histogram.Histogram (the same mergeable
    log-bucket primitive the manifests carry). ``observe`` folds one
    sample; ``set_hist`` adopts a copy of an externally-maintained
    histogram (pull-style, e.g. JobReport's per-RPC latency hists)."""

    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        key = self._labelkey(labels)
        with self._registry._lock:
            h = self._values.get(key)
            if h is None:
                h = self._values[key] = Histogram()
            h.add(value)

    def set_hist(self, hist: Histogram, **labels) -> None:
        key = self._labelkey(labels)
        snap = Histogram().merge(hist)  # copy: the source keeps mutating
        with self._registry._lock:
            self._values[key] = snap


class MetricsRegistry:
    """Named instruments + a bounded time-series ring of their sampled
    values.

    - Registration is idempotent by name; re-registering under a
      different kind raises (two subsystems fighting over one name is a
      bug, not a merge).
    - ``add_collector(fn)`` attaches a pull source: ``fn() -> {name:
      number}``, called only when a sample is actually taken (never the
      hot path); its values land in the ring and the scrape text as
      gauges. This is how JobStats rides along without double-
      instrumenting every engine (see :func:`jobstats_collector`).
    - ``maybe_sample()`` is the piggyback tick: wall-clock-bucketed (one
      point per ``period_s`` bucket however many loops tick), bounded by
      ``capacity`` points (oldest evicted, eviction counted).
    """

    def __init__(self, period_s: float = 1.0, capacity: int = 512) -> None:
        if period_s <= 0:
            raise ValueError("metrics period_s must be positive")
        if capacity < 8:
            raise ValueError("metrics ring capacity must be >= 8")
        self.period_s = float(period_s)
        self.capacity = int(capacity)
        self._instruments: dict[str, _Instrument] = {}
        self._collectors: list = []
        self._points: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._last_bucket: "int | None" = None
        self.dropped_points = 0
        self.collector_errors = 0

    # ---- registration ----

    def _register(self, cls, name: str, help: str):
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"not {cls.kind}"
                )
            return inst
        inst = self._instruments[name] = cls(self, name, help)
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> HistogramMetric:
        return self._register(HistogramMetric, name, help)

    def add_collector(self, fn) -> None:
        self._collectors.append(fn)

    # ---- sampling ----

    def current_values(self) -> dict:
        """Flat {series_key: number} of every instrument + collector right
        now. Histograms contribute ``<series>.count`` and ``<series>.sum``
        (rates and means are derivable; percentiles stay in the full
        histogram blocks the manifest already carries)."""
        out: dict = {}
        for fn in self._collectors:
            try:
                vals = fn() or {}
            except Exception:
                # A telemetry pull must never fail the loop that ticked it.
                self.collector_errors += 1
                continue
            for k, v in vals.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                out[str(k)] = v
        with self._lock:
            for name, inst in self._instruments.items():
                for key, v in inst._values.items():
                    sk = _series_key(name, key)
                    if isinstance(v, Histogram):
                        out[f"{sk}.count"] = v.count
                        out[f"{sk}.sum"] = round(v.total, 9)
                    else:
                        out[sk] = v
        return out

    def due(self) -> bool:
        """Would ``maybe_sample()`` take a point right now? The cheap
        pre-check for callers whose PREPARATION for a sample is itself
        expensive (the coordinator republishes its control plane and
        renders the scrape text — work worth skipping on the serve-loop
        passes between buckets)."""
        last = self._last_bucket
        return last is None or int(time.time() / self.period_s) > last

    def maybe_sample(self, force: bool = False) -> bool:
        """The piggyback tick. Wall-clock-bucketed: however many loops
        call this, at most one point lands per ``period_s`` bucket. The
        not-due path is two reads and a compare (plus one uncontended
        lock round when the bucket rolls over). The bucket is CLAIMED
        under the lock before the (lock-taking) collector walk runs, so
        two threads ticking the same registry at the rollover cannot
        both sample it."""
        now = time.time()
        # Integer bucket index: `now - now % period` floats differently
        # across two calls inside the SAME bucket (mod rounding), which
        # would let two threads claim "different" buckets that stamp the
        # same point.
        bucket = int(now / self.period_s)
        last = self._last_bucket
        if not force and last is not None and bucket <= last:
            return False
        with self._lock:
            last = self._last_bucket
            if not force and last is not None and bucket <= last:
                return False  # another thread claimed this bucket — and a
                # stalled claimer must never move the high-water mark BACK
                # (that would re-open the newer bucket for a duplicate)
            self._last_bucket = max(bucket, last or 0)
        point = {"t": round(bucket * self.period_s if not force else now, 3),
                 "v": self.current_values()}
        with self._lock:
            if len(self._points) == self.capacity:
                self.dropped_points += 1
            self._points.append(point)
        return True

    def points(self) -> list:
        # Sorted on read: a claimer that stalled between claiming its
        # bucket and appending its point can land behind a newer one.
        with self._lock:
            return sorted(self._points, key=lambda p: p["t"])

    def latest(self) -> "dict | None":
        with self._lock:
            return self._points[-1] if self._points else None

    def ship_sample(self) -> dict:
        """The renewal-envelope payload: one fresh point (not ring-gated —
        the renewal period already paces it). Small flat dict by
        construction."""
        return {"t": round(time.time(), 3), "v": self.current_values()}

    # ---- serialization ----

    def series_catalog(self) -> dict:
        """series_key → {kind} for every series seen so far (collector
        series appear once a point holds them, as gauges)."""
        catalog: dict = {}
        with self._lock:
            for name, inst in self._instruments.items():
                for key in inst._values:
                    sk = _series_key(name, key)
                    if inst.kind == "histogram":
                        catalog[f"{sk}.count"] = {"kind": "histogram"}
                        catalog[f"{sk}.sum"] = {"kind": "histogram"}
                    else:
                        catalog[sk] = {"kind": inst.kind}
            known = set(catalog)
            for p in self._points:
                for sk in p["v"]:
                    if sk not in known:
                        catalog[sk] = {"kind": "gauge"}
                        known.add(sk)
        return catalog

    def timeseries_dict(self) -> dict:
        """The manifest block (``stats.timeseries``) and flight-recorder
        payload: the series catalog + every ring point, JSON-safe."""
        return {
            "schema": TIMESERIES_SCHEMA,
            "period_s": self.period_s,
            "capacity": self.capacity,
            "dropped_points": self.dropped_points,
            "series": self.series_catalog(),
            "points": self.points(),
        }

    # ---- Prometheus text exposition ----

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def prometheus_text(self, prefix: str = "mr_") -> str:
        """Render instruments + the freshest collector values in the
        Prometheus text exposition format (counters/gauges as single
        samples; histograms as cumulative ``_bucket{le=...}`` series over
        the log-bucket edges, plus ``_sum``/``_count``)."""
        lines: list[str] = []
        collected: dict = {}
        for fn in self._collectors:
            try:
                collected.update(fn() or {})
            except Exception:
                self.collector_errors += 1
        with self._lock:
            instruments = {
                name: (inst.kind, inst.help, dict(inst._values))
                for name, inst in sorted(self._instruments.items())
            }
        for name, (kind, help_, values) in instruments.items():
            pname = _prom_name(name, prefix)
            if help_:
                lines.append(f"# HELP {pname} {help_}")
            lines.append(f"# TYPE {pname} {kind}")
            for key, v in sorted(values.items()):
                lab = _prom_labels(key)
                if kind != "histogram":
                    lines.append(f"{pname}{lab} {_prom_num(v)}")
                    continue
                cum = 0
                for idx in sorted(v.buckets):
                    cum += v.buckets[idx]
                    le = ("+Inf" if idx >= len(EDGES)
                          else format(EDGES[min(idx, len(EDGES) - 1)], ".6g"))
                    blab = _prom_labels(key + (("le", le),))
                    lines.append(f"{pname}_bucket{blab} {cum}")
                inf_lab = _prom_labels(key + (("le", "+Inf"),))
                if f"{pname}_bucket{inf_lab} {v.count}" != (
                    lines[-1] if lines else ""
                ):
                    lines.append(f"{pname}_bucket{inf_lab} {v.count}")
                lines.append(f"{pname}_sum{lab} {_prom_num(round(v.total, 9))}")
                lines.append(f"{pname}_count{lab} {v.count}")
        for k, v in sorted(collected.items()):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            pname = _prom_name(str(k), prefix)
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_prom_num(v)}")
        return "\n".join(lines) + "\n"


def jobstats_collector(stats: JobStats):
    """Pull source bridging the one-shot JobStats into the live ring: the
    sampler reads these aggregate fields when a point is due — no engine
    grows a second instrumentation site, and the read is benign (plain
    int/float attribute loads, no iteration over mutating containers)."""

    def collect() -> dict:
        return {
            "job.bytes_in": stats.bytes_in,
            "job.chunks": stats.chunks,
            "job.spill_events": stats.spill_events,
            "job.spilled_keys": stats.spilled_keys,
            "job.ingest_wait_s": round(stats.ingest_wait_s, 6),
            "job.device_wait_s": round(stats.device_wait_s, 6),
            "job.host_map_s": round(stats.host_map_s, 6),
            "job.host_glue_s": round(stats.host_glue_s, 6),
            "job.fold_s": round(stats.fold_s, 6),
            "job.fold_stall_s": round(stats.fold_stall_s, 6),
            "job.spill_s": round(stats.spill_s, 6),
            "job.spill_stall_s": round(stats.spill_stall_s, 6),
            "job.spill_bytes": stats.spill_bytes,
            "job.dispatch_s": round(stats.dispatch_s, 6),
            "job.dispatch_stall_s": round(stats.dispatch_stall_s, 6),
            "job.merge_dispatches": stats.merge_dispatches,
            "job.merge_fill_frac": round(stats.merge_fill_frac, 6),
            "job.scan_wait_s": round(stats.scan_wait_s, 6),
            "job.all_to_all_s": round(stats.all_to_all_s, 6),
            "job.mesh_rounds": stats.mesh_rounds,
            "job.shuffle_wire_bytes": stats.shuffle_wire_bytes,
            "job.compile_s": round(stats.compile_s, 6),
            "job.device_mem_high_bytes": stats.device_mem_high_bytes,
        }

    return collect


# ---------------------------------------------------------------------------
# Process-global registry lifecycle — the trace.py pattern: one registry
# per run, installed by the run owner (run_job / Worker.run / Coordinator
# CLI), ticked by module-level maybe_sample() from the existing loops.
# ---------------------------------------------------------------------------

_registry: "MetricsRegistry | None" = None


def start_metrics(period_s: float = 1.0,
                  capacity: int = 512) -> MetricsRegistry:
    global _registry
    _registry = MetricsRegistry(period_s=period_s, capacity=capacity)
    return _registry


def stop_metrics(expected: "MetricsRegistry | None" = None) \
        -> "MetricsRegistry | None":
    """Clear the global slot. With ``expected``, compare-and-clear: an
    in-process co-hosted run (tests drive several Workers in one
    interpreter) may have REPLACED the slot since this owner started —
    tearing down someone else's live registry would silence their
    renewal samples and manifest ring."""
    global _registry
    if expected is not None and _registry is not expected:
        return None
    r, _registry = _registry, None
    return r


def active_registry() -> "MetricsRegistry | None":
    return _registry


def metrics_tick() -> None:
    """Sampler tick on the active registry — no-op (one global read) when
    metrics are off. Call from consumer/poll/renewal loops, beside the
    flight recorder's ``maybe_snapshot()`` — never per record."""
    r = _registry
    if r is not None:
        r.maybe_sample()


# ---------------------------------------------------------------------------
# Prometheus scrape endpoint (coordinator --metrics-port)
# ---------------------------------------------------------------------------

class MetricsHTTPServer:
    """Text-exposition endpoint (``GET /metrics``) on its own thread —
    stdlib ``http.server``, zero new deps, so standard scrapers work
    against a long-lived coordinator.

    Publish/serve split: the OWNER thread (the coordinator's event loop,
    serialized with every RPC handler) renders the text and calls
    ``publish``; the HTTP thread only ever serves the last published
    bytes. The scrape path therefore never iterates a dict an RPC handler
    is mutating — the same discipline as the report snapshot at teardown.
    Port 0 binds an ephemeral port (tests); ``.port`` is the bound one.
    """

    def __init__(self, port: int, host: str = "127.0.0.1") -> None:
        import http.server

        outer = self
        self._body = b"# metrics: no samples published yet\n"
        self._pub_lock = threading.Lock()

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path not in ("/", "/metrics"):
                    self.send_error(404, "try /metrics")
                    return
                with outer._pub_lock:
                    body = outer._body
                self.send_response(200)
                self.send_header("Content-Type", MetricsRegistry.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass  # scrapes poll; stderr chatter is not telemetry

        self._srv = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self.host = host
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="mr/metrics-http", daemon=True
        )
        self._thread.start()

    def publish(self, text: str) -> None:
        body = text.encode()
        with self._pub_lock:
            self._body = body

    def close(self) -> None:
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except OSError:
            pass
        self._thread.join(timeout=5)
