"""Reading the window's device trace (the card's kernels, copies and
memsets as the harness's ``torch.profiler`` recorded them) and the
program's own span traces (``Config.trace_path``, one file per job).

Around each ``run_job`` the harness runs a marker kernel (``spin_kernel``,
``Card.mark``) and reads ``time.perf_counter`` once it has ended, so the
markers tie the two clocks and bound the window on the device's clock:
from the first job's start to the last job's end. The device is busy where
a kernel, copy or memset runs; the rest of the window is idle, and each
idle stretch is named after the innermost program span open on the job's
own thread at the time (``run_job`` inside a job but outside its spans,
``between_jobs`` outside every job); the program's traces carry their
``perf_counter`` epoch.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import statistics

MARKER = "spin_kernel"
TOP = 10
NAME_CHARS = 120  # a device op's name in the breakdown is cut to this


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: dict            # device op name -> [count, seconds]
    idle_by_span: dict   # host span name -> idle seconds
    span_s: dict        # program span name -> seconds, on the jobs' threads


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def _gaps(busy: list, w0: float, w1: float) -> list:
    out, cur = [], w0
    for a, b in busy:
        if a > cur:
            out.append((cur, min(a, w1)))
        cur = max(cur, b)
    if cur < w1:
        out.append((cur, w1))
    return [(a, b) for a, b in out if b > a]


def innermost(spans: list, t0: float, t1: float, outside: str) -> list:
    """Properly nested (start, end, name) spans of one thread inside
    [t0, t1] → non-overlapping (start, end, name) segments, each named
    after the innermost span open there (``outside`` where none is)."""
    segs: list = []
    stack: list = []
    cur = t0

    def emit(a, b, name):
        if b > a:
            segs.append((a, b, name))

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            emit(cur, end, nm)
            cur = max(cur, end)
        emit(cur, s, stack[-1][1] if stack else outside)
        cur = max(cur, s)
        stack.append((e, name))
    while stack:
        end, nm = stack.pop()
        emit(cur, end, nm)
        cur = max(cur, end)
    emit(cur, t1, outside)
    return segs


def attribute(gaps: list, segments: list) -> dict:
    """Seconds of each segment name that fall in the gaps (both lists
    sorted and non-overlapping, in microseconds)."""
    out: dict = collections.defaultdict(float)
    i = j = 0
    while i < len(gaps) and j < len(segments):
        a, b = gaps[i]
        s, e, name = segments[j]
        lo, hi = max(a, s), min(b, e)
        if hi > lo:
            out[name] += (hi - lo) / 1e6
        if b < e:
            i += 1
        else:
            j += 1
    return dict(out)


def program_spans(path: str) -> list:
    """Spans of the thread that ran the job's phases, as (start, end, name)
    in perf_counter seconds; none for a trace without phases."""
    with open(path) as f:
        doc = json.load(f)
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    tids = {e["tid"] for e in events if e["name"].startswith("phase.")}
    if len(tids) != 1:
        return []
    tid = tids.pop()
    epoch = float(doc["metadata"]["anchor_perf_s"])
    return [(epoch + e["ts"] / 1e6, epoch + (e["ts"] + e["dur"]) / 1e6, e["name"])
            for e in events if e["tid"] == tid]


def device_events(prof) -> list:
    """(start µs, end µs, name) of every device activity (kernel, copy,
    memset) a stopped ``torch.profiler.profile`` recorded, read in memory:
    an exported trace of a window runs to hundreds of MB."""
    from torch.autograd import DeviceType

    return [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def read(dev: list, jobs: list) -> "DeviceTrace | None":
    """``dev``: the window's device activity (``device_events``); ``jobs``:
    (perf_counter start, perf_counter end, program trace path or None) of
    each job, in order, the start and end read right after a marker. None
    unless the trace holds the two markers of every job."""
    marks = sorted(b for a, b, name in dev if MARKER in name)
    if not jobs or len(marks) != 2 * len(jobs):
        return None
    hosts = [t for t0, t1, _p in jobs for t in (t0, t1)]
    offset = statistics.median(t - m / 1e6 for t, m in zip(hosts, marks))
    w0, w1 = marks[0], marks[-1]
    ops: dict = {}
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a or MARKER in name:
            continue
        clipped.append((a, b))
        row = ops.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (b - a) / 1e6
    busy = _union(clipped)
    busy_s = sum(b - a for a, b in busy) / 1e6

    segments: list = []
    span_s: dict = collections.defaultdict(float)
    cur = w0
    for k, (_t0, _t1, path) in enumerate(jobs):
        m0, m1 = marks[2 * k], marks[2 * k + 1]
        if m0 > cur:
            segments.append((cur, m0, "between_jobs"))
        spans = program_spans(path) if path else []
        for s, e, n in spans:
            span_s[n] += e - s
        host = [((s - offset) * 1e6, (e - offset) * 1e6, n) for s, e, n in spans]
        segments.extend(innermost(host, m0, m1, "run_job"))
        cur = m1
    idle = attribute(_gaps(busy, w0, w1), segments)
    return DeviceTrace(window_s=(w1 - w0) / 1e6, busy_s=busy_s, ops=ops,
                       idle_by_span=idle, span_s=dict(span_s))


def breakdown(trace: DeviceTrace) -> dict:
    ops = sorted(trace.ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    idle = sorted(trace.idle_by_span.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[name[:NAME_CHARS], sec] for name, (_n, sec) in ops],
            "idle_gaps": [[name, sec] for name, sec in idle]}
