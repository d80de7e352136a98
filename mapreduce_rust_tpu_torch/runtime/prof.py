"""mrprof: in-process sampling profiler for the data plane.

A copy of ``mapreduce_rust_tpu/runtime/prof.py`` (stdlib only).

One sampler thread walks ``sys._current_frames()`` at ~97 Hz (a prime
rate, so the sampler never phase-locks with 1 ms/10 ms periodic work)
and aggregates collapsed stacks keyed by the stable plane-thread names
(``mr/scan-*``, ``mr/fold-*``, ``mr/spill-*``, ``mr/dispatch``,
``mr/ingest``, the router/consumer on ``MainThread``). Everything is
observational — the sampler takes no lock any plane thread holds and
mutates nothing the data plane reads, so outputs are byte-identical
with the profile on and off. It sees Python frames only: time inside a
native call (the scan library, a CUDA launch) lands on the frame that
made the call.

Memory is bounded by a capped frame table (distinct code locations) and
a capped stack table (distinct collapsed stacks); past either cap new
entries fold into a reserved overflow bucket instead of growing, so a
pathological workload cannot balloon the profile.

Lifecycle mirrors the metrics plane (metrics.py): a process-global slot
installed by the run owner beside ``start_metrics``, compare-and-clear
teardown, ``active_profiler()`` for the manifest embed. The live
profiler also rides the flight recorder (``tracer.profiler``) so a
SIGKILLed run keeps its flamegraph in the ``*.partial.json``, and it
feeds per-plane self-time counter tracks into the tracer for the
``trace merge`` Perfetto path.

No torch import: the ``prof`` CLI and the manifest reader import it
from any process.
"""

from __future__ import annotations

import os
import sys
import threading
import time

DEFAULT_HZ = 97.0          # prime — avoids aliasing with 10/100 Hz work
MAX_FRAMES = 8192          # distinct (file, firstlineno, func) entries
MAX_STACKS = 8192          # distinct collapsed stacks
MAX_DEPTH = 64             # frames kept per stack (deepest dropped first)
TOP_N = 20                 # frames reported in the manifest block
COUNTER_PERIOD_S = 1.0     # per-plane tracer counter cadence

# Thread-name prefix -> plane. Order matters (longest prefix first).
# MainThread is the router/consumer: the host-map engine folds window
# results and drives dispatch handoff from the calling thread.
_PLANE_PREFIXES = (
    ("mr/scan", "scan"),
    ("mr/fold", "fold"),
    ("mr/spill", "spill"),
    ("mr/dispatch", "dispatch"),
    ("mr/ingest", "ingest"),
    ("mr/metrics", "metrics"),
    ("mr/prof", "prof"),
)


def plane_of(thread_name: str) -> str:
    """Map a plane-thread name (satellite 1's ``mr/`` scheme) to its
    plane. Unknown threads land in ``other`` rather than vanishing —
    a rename regression shows up as an ``other`` bulge, not silence."""
    for prefix, plane in _PLANE_PREFIXES:
        if thread_name.startswith(prefix):
            return plane
    if thread_name == "MainThread":
        return "router"
    return "other"


class SamplingProfiler:
    """The sampler + aggregate. ``start()``/``stop()`` own the thread;
    every read path (``profile_dict``, ``folded_lines``) snapshots under
    the same small lock the sampler aggregates under, so a manifest
    flush or flight-recorder partial can read a LIVE profile."""

    def __init__(self, hz: float = DEFAULT_HZ, max_frames: int = MAX_FRAMES,
                 max_stacks: int = MAX_STACKS, max_depth: int = MAX_DEPTH):
        self.hz = float(hz)
        self.period_s = 1.0 / self.hz
        self.max_frames = int(max_frames)
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self._lock = threading.Lock()
        # Frame table: (filename, firstlineno, name) -> small int id.
        # Rendered lazily; id 0 is the reserved overflow frame.
        self._frame_ids: dict = {None: 0}
        self._frame_strs: list = ["<frame-table-full>"]
        self._frames_dropped = 0
        # (plane, thread_name, frame-id tuple root..leaf) -> sample count
        self._stacks: dict = {}
        self._stacks_dropped = 0
        self._plane_samples: dict = {}   # plane -> leaf samples
        self._leaf_samples: dict = {}    # frame id -> leaf samples
        self._ticks = 0
        self._samples = 0
        self._t0 = time.perf_counter()
        self._t1: "float | None" = None
        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None
        # Optional live tracer: the sampler publishes per-plane self-time
        # counter tracks through it (Chrome "C" events -> trace merge).
        self.tracer = None
        self._last_counter_t = 0.0

    # -- sampling -----------------------------------------------------

    def start(self) -> "SamplingProfiler":
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(
            target=self._loop, name="mr/prof-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        if self._t1 is None:
            self._t1 = time.perf_counter()

    def _loop(self) -> None:
        my_ident = threading.get_ident()
        while not self._stop_evt.wait(self.period_s):
            try:
                self._sample_once(my_ident)
            except Exception:
                # The profiler must never fail the run. A torn frame walk
                # (thread died mid-iteration) just skips the tick.
                pass
        self._t1 = time.perf_counter()

    def _sample_once(self, my_ident: int) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        now = time.perf_counter()
        with self._lock:
            self._ticks += 1
            for ident, frame in frames.items():
                if ident == my_ident:
                    continue
                name = names.get(ident)
                if name is None:
                    continue  # thread died between enumerate and walk
                self._record(name, frame)
        self._maybe_publish_counters(now)

    def _record(self, thread_name: str, frame) -> None:
        # Walk leaf -> root, then reverse: collapsed stacks read
        # root-left, leaf-right.
        ids = []
        f = frame
        while f is not None and len(ids) < self.max_depth:
            code = f.f_code
            key = (code.co_filename, code.co_firstlineno, code.co_name)
            fid = self._frame_ids.get(key)
            if fid is None:
                if len(self._frame_strs) >= self.max_frames:
                    fid = 0  # capped: fold into the overflow frame
                    self._frames_dropped += 1
                else:
                    fid = len(self._frame_strs)
                    self._frame_ids[key] = fid
                    base = os.path.basename(code.co_filename)
                    self._frame_strs.append(
                        _clean(f"{base}:{code.co_name}:{code.co_firstlineno}")
                    )
            ids.append(fid)
            f = f.f_back
        if not ids:
            return
        leaf = ids[0]
        ids.reverse()
        plane = plane_of(thread_name)
        skey = (plane, thread_name, tuple(ids))
        n = self._stacks.get(skey)
        if n is None and len(self._stacks) >= self.max_stacks:
            skey = (plane, thread_name, (0,))  # overflow stack
            n = self._stacks.get(skey)
            self._stacks_dropped += 1
        self._stacks[skey] = (n or 0) + 1
        self._plane_samples[plane] = self._plane_samples.get(plane, 0) + 1
        self._leaf_samples[leaf] = self._leaf_samples.get(leaf, 0) + 1
        self._samples += 1

    def _maybe_publish_counters(self, now: float) -> None:
        tr = self.tracer
        if tr is None or now - self._last_counter_t < COUNTER_PERIOD_S:
            return
        self._last_counter_t = now
        try:
            with self._lock:
                split = self._self_seconds_locked()
            for plane, s in sorted(split.items()):
                tr.counter(f"prof.self_s.{plane}", seconds=round(s, 4))
        except Exception:
            pass  # observational: never fail the run

    # -- aggregate views ----------------------------------------------

    def wall_s(self) -> float:
        end = self._t1 if self._t1 is not None else time.perf_counter()
        return max(end - self._t0, 0.0)

    def _self_seconds_locked(self) -> dict:
        # Self-time per plane in THREAD-seconds: each tick distributes
        # (wall / ticks) to every sampled thread's leaf plane, so a
        # single-busy-thread run's plane split sums to ~wall and an
        # N-thread run sums to ~N*wall (CPU-time semantics). Scaling by
        # measured wall/ticks (not the nominal period) keeps the sum
        # honest even when sampling runs slow under load.
        ticks = self._ticks
        if ticks == 0:
            return {}
        tick_s = self.wall_s() / ticks
        return {p: n * tick_s for p, n in self._plane_samples.items()}

    def profile_dict(self) -> dict:
        """The manifest block (``stats.profile``): per-plane self-time
        split, top-N hottest frames, the collapsed stacks (top by count,
        enough for ``prof --folded`` to reconstruct a flamegraph), and
        the sampler's own accounting."""
        with self._lock:
            split = self._self_seconds_locked()
            ticks = self._ticks
            tick_s = (self.wall_s() / ticks) if ticks else 0.0
            total = self._samples
            top = sorted(self._leaf_samples.items(),
                         key=lambda kv: (-kv[1], kv[0]))[:TOP_N]
            top_frames = [
                {"frame": self._frame_strs[fid], "samples": n,
                 "self_s": round(n * tick_s, 4),
                 "pct": round(100.0 * n / total, 2) if total else 0.0}
                for fid, n in top
            ]
            folded = self._folded_lines_locked()
            return {
                "hz": self.hz,
                "wall_s": round(self.wall_s(), 4),
                "ticks": ticks,
                "samples": total,
                "planes": {
                    p: {"samples": self._plane_samples.get(p, 0),
                        "self_s": round(s, 4)}
                    for p, s in sorted(split.items())
                },
                "top_frames": top_frames,
                "stacks": folded,
                "frame_table": {
                    "entries": len(self._frame_strs),
                    "cap": self.max_frames,
                    "dropped": self._frames_dropped,
                },
                "stack_table": {
                    "entries": len(self._stacks),
                    "cap": self.max_stacks,
                    "dropped": self._stacks_dropped,
                },
            }

    def _folded_lines_locked(self, limit: int = 512) -> list:
        rows = sorted(self._stacks.items(),
                      key=lambda kv: (-kv[1], kv[0][1]))[:limit]
        out = []
        for (plane, tname, ids), n in rows:
            stack = ";".join([_clean(tname)] +
                             [self._frame_strs[i] for i in ids])
            out.append(f"{stack} {n}")
        return out

    def folded_lines(self, limit: int = 512) -> list:
        """Collapsed-stack lines (``frame;frame;... count``), thread
        name as the root frame — flamegraph.pl / speedscope load these
        directly."""
        with self._lock:
            return self._folded_lines_locked(limit)

    def write_folded(self, path: str) -> str:
        lines = self.folded_lines()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        os.replace(tmp, path)
        return path


def _clean(frame: str) -> str:
    """Folded-format frames must not contain the two separators (';'
    between frames, ' ' before the count)."""
    return frame.replace(";", "_").replace(" ", "_")


# ---------------------------------------------------------------------------
# Process-global lifecycle — the metrics.py pattern: one profiler per
# run, installed by the run owner beside start_metrics, compare-and-clear
# teardown so co-hosted in-process runs can't tear down each other's.
# ---------------------------------------------------------------------------

_profiler: "SamplingProfiler | None" = None


def start_profiler(hz: float = DEFAULT_HZ) -> SamplingProfiler:
    global _profiler
    _profiler = SamplingProfiler(hz=hz).start()
    return _profiler


def stop_profiler(expected: "SamplingProfiler | None" = None) \
        -> "SamplingProfiler | None":
    """Stop sampling and clear the global slot. With ``expected``,
    compare-and-clear (see ``metrics.stop_metrics``). The stopped
    profiler stays readable — callers flush the manifest first and
    stop after, same order as the metrics registry."""
    global _profiler
    if expected is not None and _profiler is not expected:
        expected.stop()
        return None
    p, _profiler = _profiler, None
    if p is not None:
        p.stop()
    return p


def active_profiler() -> "SamplingProfiler | None":
    return _profiler
