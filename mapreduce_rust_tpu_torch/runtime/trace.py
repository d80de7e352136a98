"""In-process timeline tracer — Chrome trace-event JSON, buffered in RAM.

The port of ``mapreduce_rust_tpu/runtime/trace.py``: the same events,
files and merge, with NVTX ranges where the reference enters
``jax.profiler.TraceAnnotation``.

The observability doctrine (runtime/metrics.py) forbids per-record work on
the hot path; this tracer keeps that contract at the SPAN level: a span is
two ``perf_counter`` reads plus one list append (lists append GIL-atomically,
so producer/scan/consumer threads share one buffer lock-free), and the whole
buffer is serialized exactly once, at job end. Per-chunk and per-round spans
are fine; per-record spans are not.

Output is the Chrome trace-event format — ``{"traceEvents": [...]}`` of
"X" (complete) events with microsecond ``ts``/``dur`` — loadable directly
in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``. Spans on one
thread nest by call structure, so the viewer reconstructs the flame graph
with no explicit parent links.

When CUDA is already initialized in the process, every span also pushes
an NVTX range (``torch.cuda.nvtx``): an Nsight Systems or torch.profiler
trace of the same run then shows these host spans on its timeline, lined
up with the kernels they launched. The check is ``torch`` in
``sys.modules`` AND ``torch.cuda.is_initialized()`` — a span never
initializes CUDA, so control-plane processes (coordinator) trace without
touching a device.

Tracing is OFF by default: ``trace_span`` with no active tracer is a
single global read. ``run_job`` activates a tracer when
``Config.trace_path`` is set and writes the file in its ``finally``.

Cross-process stitching (distributed-timeline tentpole): every tracer
records a wall-clock anchor next to its ``perf_counter`` epoch, every
written file carries ``metadata`` ({pid, tag, anchors, clock_sync}), and
``merge_traces`` rebases a fleet's files onto one clock — the
coordinator's when NTP-style RPC offsets are available (ClockSync in
coordinator/server.py), the shared wall clock otherwise. Flow events
(``ph: s/t/f``, id = ``phase:tid:attempt``) link a task's grant span in
the coordinator to the worker's task span and the finish-report RPC, so a
re-executed task forks into two visible attempt chains. The flight
recorder makes all of this survive a SIGKILL: an atomic ``*.partial.json``
snapshot is rewritten from the existing consumer/poll loops (never the
span hot path), and ``merge_traces`` accepts partials.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

_UNSET = object()  # undecided; None = permanently unavailable; else the class
_ANN = _UNSET

_tracer: "Tracer | None" = None

_COUNTER = object()  # t1 slot marker: the event is a "C" counter sample


class _Flow:
    """t1 slot marker: a Chrome flow event (ph s/t/f) with its bound id."""

    __slots__ = ("ph", "id")

    def __init__(self, ph: str, flow_id: str) -> None:
        self.ph = ph
        self.id = flow_id


def _annotation_cls():
    """The NVTX range pair (push, pop) iff CUDA is ALREADY initialized in
    this process, else None.

    Three cache states: undecided (_UNSET — re-check per span, so a CUDA
    init later in the run is picked up), permanently unavailable (None —
    the NVTX import FAILED once; never re-attempt it on the span hot
    path), or the pair. A process without torch, or with torch but no
    CUDA context yet, stays undecided, cheaply: a span must never be what
    initializes CUDA (the coordinator process never touches a device).
    """
    global _ANN
    if _ANN is _UNSET:
        import sys

        torch = sys.modules.get("torch")
        if torch is None:
            return None
        try:
            if not torch.cuda.is_initialized():
                return None  # undecided: never initialize CUDA from a span
            from torch.cuda import nvtx

            _ANN = (nvtx.range_push, nvtx.range_pop)
        except Exception:  # NVTX absent from this build — spans still record
            _ANN = None
    return _ANN


class Tracer:
    """Bounded-overhead span buffer for one run.

    Events are (name, t0, t1, thread_id, args) tuples; timestamps are raw
    ``perf_counter`` seconds, rebased to the tracer's epoch only at
    ``write`` time so the hot path does no arithmetic beyond the clock
    reads themselves.
    """

    def __init__(self, tag: "str | None" = None) -> None:
        # The two anchors are read back-to-back so the wall clock names the
        # same instant as the perf_counter epoch: stitching rebases event
        # timestamps across processes through either one.
        self._anchor_unix = time.time()
        self._epoch = time.perf_counter()
        self._pid = os.getpid()
        self._events: list[tuple] = []  # append is GIL-atomic
        self.tag = tag                  # process role for track naming
        self.clock_sync = None          # ClockSync (or dict) to the coordinator
        self.metrics_registry = None    # live MetricsRegistry:
        # when set, flight-recorder partials embed the time-series ring, so
        # a SIGKILLed run keeps its sampled series alongside its events
        self.profiler = None            # live SamplingProfiler:
        # same contract — partials embed the live profile snapshot, so a
        # SIGKILLed run keeps its flamegraph alongside its events
        self.lineage = None             # live LineageLedger:
        # same contract — partials embed the provenance tail, so a
        # SIGKILLed run's backward queries still resolve
        # Flight recorder state (see enable_flight_recorder).
        self._snap_path: "str | None" = None
        self._snap_period = 5.0
        self._snap_min_events = 512
        self._snap_last_t = 0.0
        self._snap_last_n = 0
        self._snap_lock = threading.Lock()

    def add_span(self, name: str, t0: float, t1: float, args=None,
                 tid: "int | None" = None) -> None:
        """``tid`` defaults to the calling thread. Pass an explicit pseudo
        tid for spans whose interval was measured by SOMEONE ELSE'S clock
        (e.g. a compile listener re-emitting durations it measured):
        on a synthetic track they can never partially overlap this
        thread's own call-structured spans, which the validator rejects."""
        self._events.append(
            (name, t0, t1, threading.get_ident() if tid is None else tid, args)
        )

    def instant(self, name: str, **args) -> None:
        t = time.perf_counter()
        self._events.append((name, t, None, threading.get_ident(), args or None))

    def flow(self, name: str, ph: str, flow_id: str, **args) -> None:
        """A Chrome flow event — ``ph`` "s" starts a chain, "t" steps it,
        "f" finishes it; events with one ``flow_id`` draw as arrows across
        processes once traces are merged. Same one-append hot path as a
        span; emit INSIDE the span the arrow should attach to."""
        if ph not in ("s", "t", "f"):
            raise ValueError(f"flow ph must be s/t/f, got {ph!r}")
        t = time.perf_counter()
        self._events.append(
            (name, t, _Flow(ph, flow_id), threading.get_ident(), args or None)
        )

    def counter(self, name: str, **values) -> None:
        """A Chrome "C" counter sample (numeric values only) — Perfetto
        renders these as a gauge track (e.g. the host-map engine's
        in-flight scan depth over time). Same one-append hot path as a
        span."""
        t = time.perf_counter()
        self._events.append((name, t, _COUNTER, threading.get_ident(), values))

    def __len__(self) -> int:
        return len(self._events)

    def summarize(self, name: str) -> "dict | None":
        """Aggregate of the named complete spans — {count, total_s,
        mean_ms, p50/p95/p99_ms, max_ms} — or None when the buffer holds
        none. Used at manifest-flush time (one pass over the buffer, off
        the hot path) to surface e.g. per-round mesh.all_to_all durations
        without shipping every event into the manifest. Percentiles are
        exact (sorted sample), not bucketed — the buffer already holds
        every duration."""
        durs = sorted(
            t1 - t0
            for n, t0, t1, _tid, _args in self._events
            if n == name and isinstance(t1, float)
        )
        if not durs:
            return None
        total = sum(durs)
        n = len(durs)

        def pct(q: float) -> float:
            return durs[min(int(q * (n - 1) + 0.5), n - 1)]

        return {
            "count": n,
            "total_s": round(total, 6),
            "mean_ms": round(total / n * 1e3, 3),
            "p50_ms": round(pct(0.50) * 1e3, 3),
            "p95_ms": round(pct(0.95) * 1e3, 3),
            "p99_ms": round(pct(0.99) * 1e3, 3),
            "max_ms": round(durs[-1] * 1e3, 3),
        }

    def events(self, limit: "int | None" = None) -> list[dict]:
        """The buffer as Chrome trace-event dicts (µs since the epoch).
        ``limit`` serializes only the first N events — the flight recorder
        snapshots a len() observed under the GIL, so a concurrent append
        can never tear a snapshot."""
        out = []
        buf = self._events if limit is None else self._events[:limit]
        for name, t0, t1, tid, args in buf:
            if t1 is _COUNTER:
                ph = "C"
            elif isinstance(t1, _Flow):
                ph = t1.ph
            elif t1 is not None:
                ph = "X"
            else:
                ph = "i"
            ev = {
                "name": name,
                "ph": ph,
                "ts": (t0 - self._epoch) * 1e6,
                "pid": self._pid,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = (t1 - t0) * 1e6
            elif ph == "i":
                ev["s"] = "t"  # instant event scope: thread
            elif ph in ("s", "t", "f"):
                ev["id"] = t1.id
                if ph == "f":
                    ev["bp"] = "e"  # bind the arrow head to the enclosing slice
            if args:
                ev["args"] = {k: v for k, v in args.items()}
            out.append(ev)
        return out

    def metadata(self, partial: bool = False) -> dict:
        """Stitching identity of this trace file: who wrote it and how its
        timestamps map onto other clocks. ``anchor_perf_s`` is the raw
        perf_counter epoch (the clock RPC offsets are measured against);
        ``anchor_unix_s`` the wall clock at the same instant (the shared
        fallback when no RPC sync exists)."""
        md: dict = {
            "pid": self._pid,
            "tag": self.tag,
            "anchor_unix_s": self._anchor_unix,
            "anchor_perf_s": self._epoch,
        }
        cs = self.clock_sync
        if cs is not None:
            best = cs.best() if hasattr(cs, "best") else dict(cs)
            if best:
                md["clock_sync"] = best
        if partial:
            md["partial"] = True
        return md

    # ---- flight recorder ----

    def enable_flight_recorder(self, partial_path_: str,
                               period_s: "float | None" = None,
                               min_new_events: int = 512) -> None:
        """Arm crash-safe incremental snapshots: ``maybe_snapshot()`` (from
        the existing consumer/poll loops — never the span hot path) rewrites
        ``partial_path_`` atomically every ``period_s`` seconds or
        ``min_new_events`` new events, whichever first. A SIGKILLed process
        leaves its last snapshot; a clean ``write`` removes it. The
        MR_FLIGHT_RECORD_S env var overrides the period (test hook)."""
        env = os.environ.get("MR_FLIGHT_RECORD_S")
        if env:
            try:
                period_s = float(env)
            except ValueError:
                pass
        self._snap_path = partial_path_
        if period_s is not None and period_s > 0:
            self._snap_period = period_s
        self._snap_min_events = max(int(min_new_events), 1)
        # First snapshot one period after arming, not instantly.
        self._snap_last_t = time.monotonic()

    def maybe_snapshot(self, force: bool = False) -> "str | None":
        """Snapshot if armed and due. The not-due path is two reads and a
        compare — cheap enough for a per-chunk/per-poll call site."""
        path = self._snap_path
        if path is None:
            return None
        n = len(self._events)
        if not force:
            if n == self._snap_last_n:
                return None
            if (
                time.monotonic() - self._snap_last_t < self._snap_period
                and n - self._snap_last_n < self._snap_min_events
            ):
                return None
        # Non-blocking: a concurrent snapshot (atexit vs signal vs loop) is
        # already writing this same buffer — skipping loses nothing.
        if not self._snap_lock.acquire(blocking=False):
            return None
        try:
            body = {
                "traceEvents": self.events(limit=n),
                "displayTimeUnit": "ms",
                "metadata": self.metadata(partial=True),
            }
            reg = self.metrics_registry
            if reg is not None:
                try:
                    # The series ride the partial: a SIGKILLed run's ring
                    # would otherwise die with the process before any
                    # manifest flush could serialize it.
                    body["metrics"] = reg.timeseries_dict()
                except Exception:
                    pass  # the recorder must never fail the run
            sprof = self.profiler
            if sprof is not None:
                try:
                    # The flamegraph rides the partial too: a
                    # SIGKILLed run's sample aggregate would otherwise die
                    # with the process before any manifest flush.
                    body["profile"] = sprof.profile_dict()
                except Exception:
                    pass  # the recorder must never fail the run
            ledger = self.lineage
            if ledger is not None:
                try:
                    # Provenance rides the partial: the jsonl
                    # on disk survives a SIGKILL by itself, but the
                    # embedded tail lets the lineage CLI answer queries
                    # from the partial alone.
                    body["lineage"] = ledger.tail_dict()
                except Exception:
                    pass  # the recorder must never fail the run
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.{self._pid}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                json.dump(body, f, separators=(",", ":"))
            os.replace(tmp, path)
            self._snap_last_t = time.monotonic()
            self._snap_last_n = n
            return path
        except OSError:
            return None  # best-effort: the recorder must never fail the run
        finally:
            self._snap_lock.release()

    def write(self, path: str) -> str:
        """Serialize once, atomically (tmp + rename). Returns ``path``.

        Under the sanitizer (MR_SANITIZE=1 / Config.sanitize) the buffer is
        validated first — an unbalanced or ill-typed event stream fails at
        the writer, naming the broken span, instead of shipping a trace
        Perfetto renders as garbage. (Every producer — driver, worker,
        coordinator — writes through here, so they all get the check.)
        """
        from mapreduce_rust_tpu_torch.analysis.sanitize import sanitize_enabled

        if sanitize_enabled():
            validate_events(self.events())
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.{self._pid}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "traceEvents": self.events(),
                    "displayTimeUnit": "ms",
                    "metadata": self.metadata(),
                },
                f,
                separators=(",", ":"),
            )
        os.replace(tmp, path)
        # The run completed and the full trace exists: the crash snapshot
        # is now stale — a later merge must not double-ingest it.
        if self._snap_path:
            try:
                os.remove(self._snap_path)
            except OSError:
                pass
        return path


def start_tracing(tag: "str | None" = None) -> Tracer:
    """Install a fresh process-global tracer (one tracer per run: run_job
    owns the lifecycle; concurrent run_jobs in one process would interleave
    buffers, which the driver does not do)."""
    global _tracer
    _tracer = Tracer(tag=tag)
    return _tracer


def stop_tracing() -> "Tracer | None":
    """Deactivate and return the current tracer (caller writes it)."""
    global _tracer
    t, _tracer = _tracer, None
    return t


def active_tracer() -> "Tracer | None":
    return _tracer


@contextmanager
def trace_span(name: str, **args):
    """Span context: no-op (one global read) when tracing is off.

    With a tracer active and CUDA initialized, also pushes an NVTX range
    so a device profile of the same interval shows this span on its
    timeline.
    """
    tr = _tracer
    if tr is None:
        yield
        return
    ann = _annotation_cls()
    if ann is not None:
        ann[0](name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        if ann is not None:
            ann[1]()
        tr.add_span(name, t0, t1, args or None)


def trace_counter(name: str, **values) -> None:
    """Record a counter sample on the active tracer — no-op (one global
    read) when tracing is off. Values must be numeric (Chrome "C" event
    semantics)."""
    tr = _tracer
    if tr is not None:
        tr.counter(name, **values)


def trace_instant(name: str, **args) -> None:
    """Record an instant event on the active tracer — no-op when off. The
    flight recorder's unit of progress: a task-begin mark survives in the
    partial snapshot even though the enclosing span (recorded at exit)
    dies with the process."""
    tr = _tracer
    if tr is not None:
        tr.instant(name, **args)


def trace_flow(name: str, ph: str, flow_id: str, **args) -> None:
    """Record a flow event (ph s/t/f, bound ``flow_id``) on the active
    tracer — no-op when off."""
    tr = _tracer
    if tr is not None:
        tr.flow(name, ph, flow_id, **args)


def maybe_snapshot() -> None:
    """Flight-recorder tick on the active tracer — no-op when tracing is
    off or the recorder is not armed. Call from consumer/poll loops (per
    chunk, per renewal, per serve tick), never per record."""
    tr = _tracer
    if tr is not None:
        tr.maybe_snapshot()


_crash_dump_installed = False


def install_crash_dump() -> None:
    """atexit + SIGTERM dump of the active tracer's flight-recorder
    snapshot: a process dying on an unhandled exception or a polite kill
    leaves its timeline even if no loop ticked again. (SIGKILL cannot be
    caught — that is what the periodic snapshots are for.) CLI entry
    points install this; in-process library use (tests, embedding) must
    not have its signal handlers stolen, so it is opt-in."""
    global _crash_dump_installed
    if _crash_dump_installed:
        return
    _crash_dump_installed = True
    import atexit
    import signal

    def _dump() -> None:
        tr = _tracer
        if tr is not None:
            try:
                tr.maybe_snapshot(force=True)
            except Exception:
                pass  # a dying process must die on ITS error, not ours

    atexit.register(_dump)

    def _on_term(signum, frame):
        _dump()
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)  # re-raise: exit status stays honest

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass  # not the main thread — atexit still covers clean exits


def per_process_path(path: str, tag: str) -> str:
    """Derive a per-process artifact path (`x.json` → `x-w123.json`):
    several workers (or a coordinator) on one host may share a Config, and
    their trace/manifest files must never clobber each other."""
    root, ext = os.path.splitext(path)
    return f"{root}-{tag}{ext or '.json'}"


def partial_path(path: str) -> str:
    """The flight-recorder snapshot path beside a final trace path
    (`x.json` → `x.partial.json`)."""
    root, ext = os.path.splitext(path)
    return f"{root}.partial{ext or '.json'}"


_FLOW_ORDER = {"s": 0, "t": 1, "f": 2}  # tie-break at equal timestamps


def validate_events(events: list[dict]) -> None:
    """Structural validator for a Chrome trace-event list (the test,
    ``stats`` and ``lint --check-trace`` consumers share it): required
    fields; per-(pid, tid) "X" spans either nest or are disjoint — never
    partially overlap, which is what makes the Perfetto flame graph
    well-formed; "B"/"E" duration pairs balance per thread (every E
    matches the most recent open B of the same name, nothing left open);
    "C" counter samples carry only numeric values — Perfetto plots a
    non-numeric gauge as silent garbage, so it is rejected here instead;
    "s"/"t"/"f" flow events carry a bound id and each id's chain is
    well-formed (started at most once, steps never precede the start,
    nothing after the finish — but a start with no finish is legal: that
    is exactly what a crashed attempt looks like, and a fragment file
    holding only "t" steps merges later); "M" metadata events carry args.
    """
    per_thread: dict = {}
    be_events: dict = {}  # (pid, tid) → [(ts, seq, ph, name)]
    flows: dict = {}      # flow id → [(ts, order, seq, ph)]
    for seq, ev in enumerate(events):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event missing {field!r}: {ev}")
        if ev["ph"] in ("s", "t", "f"):
            fid = ev.get("id")
            if fid is None or (isinstance(fid, str) and not fid):
                raise ValueError(f"flow event needs a bound id: {ev}")
            flows.setdefault(fid, []).append(
                (ev["ts"], _FLOW_ORDER[ev["ph"]], seq, ev["ph"])
            )
        elif ev["ph"] == "M":
            args = ev.get("args")
            if not args or not isinstance(args, dict):
                raise ValueError(f"M metadata event needs non-empty args: {ev}")
        elif ev["ph"] == "X":
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(f"X event needs dur >= 0: {ev}")
            per_thread.setdefault((ev["pid"], ev["tid"]), []).append(
                (ev["ts"], ev["ts"] + ev["dur"], ev["name"])
            )
        elif ev["ph"] in ("B", "E"):
            be_events.setdefault((ev["pid"], ev["tid"]), []).append(
                (ev["ts"], seq, ev["ph"], ev["name"])
            )
        elif ev["ph"] == "C":
            args = ev.get("args")
            if not args or not isinstance(args, dict):
                raise ValueError(f"C event needs non-empty args: {ev}")
            for k, v in args.items():
                # bool is an int subclass but not a gauge sample.
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ValueError(
                        f"C event value {k}={v!r} is not numeric: {ev}"
                    )
    for fid, fevs in flows.items():
        # Stable order: ts, then s<t<f at equal timestamps (a grant and its
        # task step can land on the same microsecond after merging), then
        # emission order.
        fevs.sort()
        phs = [ph for _ts, _o, _seq, ph in fevs]
        starts = [i for i, ph in enumerate(phs) if ph == "s"]
        if len(starts) > 1:
            raise ValueError(f"flow id {fid!r} started twice")
        if starts and starts[0] != 0:
            raise ValueError(f"flow id {fid!r} has steps before its start")
        if "f" in phs and phs.index("f") != len(phs) - 1:
            raise ValueError(f"flow id {fid!r} continues after its finish")
    for key, evs in be_events.items():
        # Emission order breaks ties at equal timestamps (stable sort), so
        # a zero-duration B-then-E pair stays balanced.
        evs.sort(key=lambda e: (e[0], e[1]))
        open_spans: list[str] = []
        for ts, _seq, ph, name in evs:
            if ph == "B":
                open_spans.append(name)
            elif not open_spans:
                raise ValueError(
                    f"E event {name!r} at ts={ts} on thread {key} has no "
                    "matching open B"
                )
            elif open_spans[-1] != name:
                raise ValueError(
                    f"E event {name!r} at ts={ts} on thread {key} closes "
                    f"{open_spans[-1]!r} — B/E pairs must nest by name"
                )
            else:
                open_spans.pop()
        if open_spans:
            raise ValueError(
                f"unbalanced B/E spans on thread {key}: "
                f"{open_spans!r} never closed"
            )
    for key, spans in per_thread.items():
        # Sort by start asc, end desc: a containing span precedes its
        # children, so a stack check catches partial overlap.
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list[tuple] = []
        for s0, s1, name in spans:
            while stack and stack[-1][1] <= s0:
                stack.pop()
            if stack and s1 > stack[-1][1]:
                raise ValueError(
                    f"span {name!r} [{s0}, {s1}] partially overlaps "
                    f"{stack[-1][2]!r} [{stack[-1][0]}, {stack[-1][1]}] "
                    f"on thread {key}"
                )
            stack.append((s0, s1, name))


# ---------------------------------------------------------------------------
# Cross-process stitching
# ---------------------------------------------------------------------------

def load_trace(path: str) -> tuple[list[dict], dict]:
    """(events, metadata) of one trace file — final or ``*.partial.json``
    (the flight recorder writes the same schema). Pre-metadata files (a
    bare event list, or no ``metadata`` key) load with empty metadata."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        md = doc.get("metadata") or {}
    else:
        events, md = doc, {}
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    return events, md


def _rebase_delta(md: dict, ref_md: dict) -> tuple[float, str]:
    """Seconds to add to this trace's timestamps to land on the reference
    trace's timeline, and which clock relation justified it. Preference
    order: the NTP-style RPC offset (valid only against the coordinator's
    perf_counter clock), then the shared wall clock, then nothing."""
    cs = md.get("clock_sync")
    if (
        cs
        and ref_md.get("tag") == "coord"
        and md.get("anchor_perf_s") is not None
        and ref_md.get("anchor_perf_s") is not None
    ):
        return (
            md["anchor_perf_s"] + cs["offset_s"] - ref_md["anchor_perf_s"],
            "rpc",
        )
    if md.get("anchor_unix_s") is not None and ref_md.get("anchor_unix_s") is not None:
        return md["anchor_unix_s"] - ref_md["anchor_unix_s"], "wall"
    return 0.0, "none"


def _repair_flow_causality(merged: "list[dict]") -> None:
    """Clamp sub-tolerance flow inversions introduced by the rebase.

    The protocol guarantees grant (s) → task step (t) → finish (f), but
    cross-process timestamps are only accurate to the rebase's residual
    error (±RTT/2 for RPC offsets, worse for wall fallback): a worker's
    step can land a few hundred µs before its grant and the merged file
    would then fail its own flow validation — losing the whole artifact
    over known clock noise. Inversions BETWEEN files within the combined
    tolerance are lifted to the causal bound; same-file inversions and
    anything beyond tolerance are left for validate_events to reject
    (those are writer bugs or broken clocks, not noise)."""
    by_id: dict = {}
    for ev in merged:
        if ev.get("ph") in ("s", "t", "f"):
            by_id.setdefault(ev["id"], []).append(ev)
    for evs in by_id.values():
        starts = [e for e in evs if e["ph"] == "s"]
        finishes = [e for e in evs if e["ph"] == "f"]
        if len(starts) == 1:
            s = starts[0]
            for e in evs:
                if (
                    e["ph"] != "s"
                    and e["_src"] != s["_src"]
                    and e["ts"] < s["ts"]
                    and (s["ts"] - e["ts"]) <= (e["_tol"] + s["_tol"]) * 1e6
                ):
                    e["ts"] = s["ts"]  # equal ts: s<t<f tie-break keeps order
        if len(finishes) == 1:
            f = finishes[0]
            for e in evs:
                if (
                    e["ph"] != "f"
                    and e["_src"] != f["_src"]
                    and e["ts"] > f["ts"]
                    and (e["ts"] - f["ts"]) <= (e["_tol"] + f["_tol"]) * 1e6
                ):
                    e["ts"] = f["ts"]


def merge_traces(out_path: str, paths: "list[str]",
                 out_format: str = "json") -> dict:
    """Stitch per-process trace files (partials included) onto ONE
    timeline and write a Perfetto-loadable file to ``out_path``.

    The reference clock is the coordinator's (tag "coord") when present —
    workers carry an RPC-measured offset to it — else the earliest
    wall-clock anchor. Each input keeps its own pid track (colliding pids,
    e.g. two hosts, are remapped) and gets a ``process_name`` metadata
    event from its tag, so the merged view reads "coord / w1234 / ...".
    The merged stream is validated before writing: a stitched file that
    fails ``validate_events`` is a bug here, not a viewer surprise.
    Returns a summary dict (events, processes, per-file clock domains).
    """
    if not paths:
        raise ValueError("trace merge needs at least one input trace")
    traces = []
    for p in paths:
        events, md = load_trace(p)
        traces.append({"path": p, "events": events, "md": md})
    ref = next((t for t in traces if t["md"].get("tag") == "coord"), None)
    if ref is None:
        anchored = [t for t in traces if t["md"].get("anchor_unix_s") is not None]
        ref = min(anchored, key=lambda t: t["md"]["anchor_unix_s"]) if anchored \
            else traces[0]

    merged: list[dict] = []
    processes: list[dict] = []
    used_pids: set = set()
    used_labels: set = set()
    for t in traces:
        md = t["md"]
        delta_s, domain = (0.0, "reference") if t is ref \
            else _rebase_delta(md, ref["md"])
        # One pid per input file keeps tracks distinct even when metadata
        # is absent; collisions (same pid from two hosts, or a final trace
        # merged next to its own stale partial) are remapped.
        pids = {ev["pid"] for ev in t["events"]}
        if md.get("pid") is not None:
            pids.add(md["pid"])
        remap = {}
        for pid in sorted(pids, key=str):
            new = pid
            while new in used_pids:
                new = (new if isinstance(new, int) else 0) + 100000
            remap[pid] = new
            used_pids.add(new)
        tag = md.get("tag") or os.path.splitext(os.path.basename(t["path"]))[0]
        # Duplicate (pid, tag) metadata across input files (pid reuse on
        # another host mints the same "w<pid>" tag; or one file fed in
        # twice): the pids above were remapped apart, but two tracks with
        # ONE name silently read as one process — remap the tag too, like
        # the pid, so every track stays attributable. The partial flag is
        # part of the identity: a final trace beside its own stale partial
        # is the legitimate same-tag pair and keeps its bare name.
        key = (tag, bool(md.get("partial")))
        if key in used_labels:
            n = 2
            while (f"{tag}#{n}", key[1]) in used_labels:
                n += 1
            tag = f"{tag}#{n}"
            key = (tag, key[1])
        used_labels.add(key)
        label = f"{tag}{' [partial]' if md.get('partial') else ''}"
        for pid in sorted(remap.values(), key=str):
            merged.append({
                "name": "process_name", "ph": "M", "ts": 0,
                "pid": pid, "tid": 0, "args": {"name": label},
            })
            processes.append({
                "pid": pid, "tag": tag, "path": t["path"],
                "clock_domain": domain,
                "partial": bool(md.get("partial")),
            })
        for ev in t["events"]:
            ev = dict(ev)
            ev["pid"] = remap[ev["pid"]]
            if ev.get("ph") != "M":
                ev["ts"] = ev["ts"] + delta_s * 1e6
            ev["_src"] = t["path"]
            ev["_tol"] = 0.0 if t is ref else (
                # Residual clock error after the rebase: ±RTT/2 for the
                # RPC-measured offset, a generous bound for wall-clock
                # fallback (NTP-class skew), zero for the reference.
                md["clock_sync"]["rtt_s"] if domain == "rpc" else 0.05
            )
            merged.append(ev)

    _repair_flow_causality(merged)
    for ev in merged:
        ev.pop("_src", None)  # the process_name "M" rows never carried them
        ev.pop("_tol", None)

    # Normalize so the earliest real event sits at ts 0 (wall-anchored
    # deltas are epoch-sized; Perfetto handles them, humans do not).
    real_ts = [ev["ts"] for ev in merged if ev.get("ph") != "M"]
    t_min = min(real_ts) if real_ts else 0.0
    for ev in merged:
        if ev.get("ph") != "M":
            ev["ts"] -= t_min
    merged.sort(key=lambda ev: (0 if ev.get("ph") == "M" else 1, ev["ts"]))

    validate_events(merged)
    if out_format == "perfetto":
        # Binary track_event protobuf: same merged-and-validated stream, serialized for the
        # timelines the JSON loader chokes on. JSON stays the default.
        from mapreduce_rust_tpu_torch.runtime.perfetto import write_pftrace

        write_pftrace(merged, out_path)
    elif out_format == "json":
        d = os.path.dirname(os.path.abspath(out_path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{out_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "traceEvents": merged,
                    "displayTimeUnit": "ms",
                    "metadata": {
                        "merged_from": [t["path"] for t in traces],
                        "reference": {
                            "path": ref["path"],
                            "tag": ref["md"].get("tag"),
                        },
                    },
                },
                f,
                separators=(",", ":"),
            )
        os.replace(tmp, out_path)
    else:
        raise ValueError(f"unknown trace merge format {out_format!r}")
    span_s = (max(real_ts) - t_min) / 1e6 if real_ts else 0.0
    return {
        "out": out_path,
        "events": sum(1 for ev in merged if ev.get("ph") != "M"),
        "processes": processes,
        "reference": ref["path"],
        "span_s": round(span_s, 6),
    }
