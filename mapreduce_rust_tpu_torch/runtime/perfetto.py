"""Perfetto ``track_event`` protobuf export — ``trace merge --format
perfetto``.

A copy of ``mapreduce_rust_tpu/runtime/perfetto.py`` (stdlib only).

Why: the JSON trace-event format is ideal for small timelines, but a
multi-job coordinator's merged timeline crosses 100 MB and the Perfetto
UI's JSON ingestion path (parse the whole document, then convert) falls
over long before its native protobuf path does. The ``.pftrace`` binary
stream loads incrementally and is ~3-5x smaller.

Why hand-rolled: the container ships no protobuf library and the bake-in
rule forbids adding one. Proto wire format is three primitives — varints,
length-delimited blobs, fixed64 — so the writer below encodes exactly the
message subset Perfetto's TrackEvent model needs, with the field numbers
pinned from perfetto's ``trace_packet.proto``/``track_event.proto``:

- ``Trace.packet = 1``
- ``TracePacket``: ``timestamp = 8`` (ns, varint),
  ``trusted_packet_sequence_id = 10``, ``track_event = 11``,
  ``track_descriptor = 60``
- ``TrackDescriptor``: ``uuid = 1``, ``name = 2``, ``process = 3``,
  ``thread = 4``, ``parent_uuid = 5``, ``counter = 8``
- ``ProcessDescriptor``: ``pid = 1``, ``process_name = 6``
- ``ThreadDescriptor``: ``pid = 1``, ``tid = 2``, ``thread_name = 5``
- ``TrackEvent``: ``type = 9`` (SLICE_BEGIN=1, SLICE_END=2, INSTANT=3,
  COUNTER=4), ``track_uuid = 11``, ``name = 23``, ``counter_value = 30``,
  ``double_counter_value = 44``, ``flow_ids = 47`` /
  ``terminating_flow_ids = 48`` (fixed64)

Input is the MERGED Chrome event list ``trace.merge_traces`` builds (and
validates) — "X" spans become BEGIN/END pairs emitted in correct nesting
order per track, instants and flows become INSTANT events carrying flow
ids, "C" counters become per-key counter tracks, and the "M"
``process_name`` rows become ProcessDescriptors. A minimal wire-format
reader (``iter_packets``) rides along so tests (and humans) can re-parse
the emitted stream without a protobuf dependency.

Pure stdlib, no jax — same rule as every trace/analysis tool.
"""

from __future__ import annotations

import hashlib
import os
import struct

#: One synthetic writer sequence: we emit absolute timestamps (no
#: interning, no incremental state), so a single sequence id is valid.
_SEQ_ID = 1

TYPE_SLICE_BEGIN = 1
TYPE_SLICE_END = 2
TYPE_INSTANT = 3
TYPE_COUNTER = 4


# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # proto uint64 wraparound for negative ints
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _f_varint(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(int(n))


def _f_bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _f_str(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode("utf-8", "replace"))


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", float(v))


def _f_fixed64(field: int, n: int) -> bytes:
    return _key(field, 1) + struct.pack("<Q", n & ((1 << 64) - 1))


def _flow_id64(fid) -> int:
    """Stable 64-bit id for a Chrome flow id string (Perfetto flow ids
    are integers; ours are ``phase:tid:attempt`` strings)."""
    h = hashlib.sha1(str(fid).encode()).digest()
    return int.from_bytes(h[:8], "little") or 1


def _packet(ts_ns: "int | None" = None, track_event: "bytes | None" = None,
            track_descriptor: "bytes | None" = None) -> bytes:
    parts = []
    if ts_ns is not None:
        parts.append(_f_varint(8, max(int(ts_ns), 0)))
    parts.append(_f_varint(10, _SEQ_ID))
    if track_event is not None:
        parts.append(_f_bytes(11, track_event))
    if track_descriptor is not None:
        parts.append(_f_bytes(60, track_descriptor))
    return _f_bytes(1, b"".join(parts))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _track_event(type_: int, track_uuid: int, name: "str | None" = None,
                 counter_value=None, flow_id: "int | None" = None,
                 terminating: bool = False) -> bytes:
    parts = [_f_varint(9, type_), _f_varint(11, track_uuid)]
    if name:
        parts.append(_f_str(23, name))
    if counter_value is not None:
        if isinstance(counter_value, float) and not counter_value.is_integer():
            parts.append(_f_double(44, counter_value))
        else:
            parts.append(_f_varint(30, int(counter_value)))
    if flow_id is not None:
        parts.append(_f_fixed64(48 if terminating else 47, flow_id))
    return b"".join(parts)


class _Tracks:
    """uuid mint + descriptor packets for process / thread / counter
    tracks, emitted once each, lazily."""

    def __init__(self, out: list) -> None:
        self._out = out
        self._next = 1
        self._proc: dict = {}     # pid → uuid
        self._thread: dict = {}   # (pid, tid) → uuid
        self._counter: dict = {}  # (pid, series) → uuid
        self._proc_names: dict = {}

    def set_process_name(self, pid, name: str) -> None:
        self._proc_names[pid] = name

    def _mint(self) -> int:
        u, self._next = self._next, self._next + 1
        return u

    def _pid_num(self, pid) -> int:
        # Perfetto pids are int32; merged pids are ints by construction
        # but stay defensive for hand-built traces.
        try:
            return int(pid) & 0x7FFFFFFF
        except (TypeError, ValueError):
            return _flow_id64(pid) & 0x7FFFFFFF

    def process(self, pid) -> int:
        u = self._proc.get(pid)
        if u is None:
            u = self._proc[pid] = self._mint()
            name = str(self._proc_names.get(pid, f"pid {pid}"))
            proc = _f_varint(1, self._pid_num(pid)) + _f_str(6, name)
            desc = _f_varint(1, u) + _f_str(2, name) + _f_bytes(3, proc)
            self._out.append(_packet(track_descriptor=desc))
        return u

    def thread(self, pid, tid) -> int:
        u = self._thread.get((pid, tid))
        if u is None:
            self.process(pid)  # parent descriptor first
            u = self._thread[(pid, tid)] = self._mint()
            try:
                tid_num = int(tid) & 0x7FFFFFFF
            except (TypeError, ValueError):
                tid_num = _flow_id64(tid) & 0x7FFFFFFF
            thr = (
                _f_varint(1, self._pid_num(pid)) + _f_varint(2, tid_num)
                + _f_str(5, f"tid {tid}")
            )
            desc = _f_varint(1, u) + _f_bytes(4, thr)
            self._out.append(_packet(track_descriptor=desc))
        return u

    def counter(self, pid, series: str) -> int:
        u = self._counter.get((pid, series))
        if u is None:
            parent = self.process(pid)
            u = self._counter[(pid, series)] = self._mint()
            desc = (
                _f_varint(1, u) + _f_str(2, series) + _f_varint(5, parent)
                + _f_bytes(8, b"")  # empty CounterDescriptor marks the kind
            )
            self._out.append(_packet(track_descriptor=desc))
        return u


def _nested_slice_stream(spans: list) -> list:
    """(ts_us, is_end, name) stream with correct per-track nesting order:
    sort by (start asc, end desc) — parents before children — and emit
    ENDs for every span that closes at-or-before the next start, so equal
    timestamps never interleave a parent's END under its child's."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: list = []
    stack: list = []
    for s0, s1, name in spans:
        while stack and stack[-1][0] <= s0:
            e, n = stack.pop()
            out.append((e, True, n))
        out.append((s0, False, name))
        stack.append((s1, name))
    while stack:
        e, n = stack.pop()
        out.append((e, True, n))
    return out


def write_pftrace(events: list, out_path: str) -> dict:
    """Serialize a (merged, validated) Chrome event list as a Perfetto
    ``.pftrace`` track_event stream. Returns {packets, bytes}."""
    packets: list = []
    tracks = _Tracks(packets)
    # Pass 1: process names from the merge's "M" rows, so descriptors
    # carry "coord"/"w1234" instead of bare pids.
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            name = (ev.get("args") or {}).get("name")
            if name:
                tracks.set_process_name(ev.get("pid"), str(name))

    spans_by_track: dict = {}
    timed: list = []  # (ts_us, gen_seq, packet_bytes)
    seq = 0
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            continue
        pid, tid, ts = ev.get("pid"), ev.get("tid"), float(ev.get("ts", 0))
        name = str(ev.get("name", ""))
        if ph == "X":
            spans_by_track.setdefault((pid, tid), []).append(
                (ts, ts + float(ev.get("dur", 0)), name)
            )
        elif ph == "i":
            te = _track_event(TYPE_INSTANT, tracks.thread(pid, tid), name)
            timed.append((ts, seq, _packet(int(ts * 1e3), te)))
            seq += 1
        elif ph in ("s", "t", "f"):
            te = _track_event(
                TYPE_INSTANT, tracks.thread(pid, tid), name,
                flow_id=_flow_id64(ev.get("id")), terminating=(ph == "f"),
            )
            timed.append((ts, seq, _packet(int(ts * 1e3), te)))
            seq += 1
        elif ph == "C":
            for k, v in (ev.get("args") or {}).items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                u = tracks.counter(pid, f"{name}.{k}" if k else name)
                te = _track_event(TYPE_COUNTER, u, counter_value=v)
                timed.append((ts, seq, _packet(int(ts * 1e3), te)))
                seq += 1
        elif ph in ("B", "E"):
            # Tracer itself emits only "X", but validate_events (the gate
            # merge runs) accepts balanced B/E pairs from foreign files —
            # the validator's balance+nesting guarantee means they map
            # 1:1 onto BEGIN/END in stream order.
            te = _track_event(
                TYPE_SLICE_END if ph == "E" else TYPE_SLICE_BEGIN,
                tracks.thread(pid, tid),
                None if ph == "E" else name,
            )
            timed.append((ts, seq, _packet(int(ts * 1e3), te)))
            seq += 1
    for (pid, tid), spans in spans_by_track.items():
        u = tracks.thread(pid, tid)
        for ts, is_end, name in _nested_slice_stream(spans):
            te = _track_event(
                TYPE_SLICE_END if is_end else TYPE_SLICE_BEGIN, u,
                None if is_end else name,
            )
            timed.append((ts, seq, _packet(int(ts * 1e3), te)))
            seq += 1
    # Stable by (ts, generation order): per-track nesting order survives
    # ties, and the trace processor gets a near-sorted stream.
    timed.sort(key=lambda t: (t[0], t[1]))
    body = b"".join(packets) + b"".join(p for _ts, _s, p in timed)
    d = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(body)
    os.replace(tmp, out_path)
    return {"packets": len(packets) + len(timed), "bytes": len(body)}


# ---------------------------------------------------------------------------
# Minimal reader — enough to re-parse what the writer emits (tests, and
# humans spot-checking a .pftrace without a protobuf dependency).
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> tuple:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7
        if shift > 63:
            raise ValueError("varint overruns 64 bits")


def _fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        if i > len(buf):
            raise ValueError("field overruns buffer")
        yield field, wt, v


def _parse_track_event(buf: bytes) -> dict:
    out: dict = {"flow_ids": [], "terminating_flow_ids": []}
    for field, _wt, v in _fields(buf):
        if field == 9:
            out["type"] = v
        elif field == 11:
            out["track_uuid"] = v
        elif field == 23:
            out["name"] = v.decode("utf-8", "replace")
        elif field == 30:
            out["counter_value"] = v
        elif field == 44:
            out["double_counter_value"] = struct.unpack("<d", v)[0]
        elif field == 47:
            out["flow_ids"].append(struct.unpack("<Q", v)[0])
        elif field == 48:
            out["terminating_flow_ids"].append(struct.unpack("<Q", v)[0])
    return out


def _parse_track_descriptor(buf: bytes) -> dict:
    out: dict = {}
    for field, _wt, v in _fields(buf):
        if field == 1:
            out["uuid"] = v
        elif field == 2:
            out["name"] = v.decode("utf-8", "replace")
        elif field == 3:
            proc: dict = {}
            for f2, _w2, v2 in _fields(v):
                if f2 == 1:
                    proc["pid"] = v2
                elif f2 == 6:
                    proc["process_name"] = v2.decode("utf-8", "replace")
            out["process"] = proc
        elif field == 4:
            thr: dict = {}
            for f2, _w2, v2 in _fields(v):
                if f2 == 1:
                    thr["pid"] = v2
                elif f2 == 2:
                    thr["tid"] = v2
                elif f2 == 5:
                    thr["thread_name"] = v2.decode("utf-8", "replace")
            out["thread"] = thr
        elif field == 5:
            out["parent_uuid"] = v
        elif field == 8:
            out["counter"] = True
    return out


def iter_packets(path: str):
    """Yield parsed TracePacket dicts ({timestamp?, sequence_id,
    track_event?|track_descriptor?}) from a ``.pftrace`` file written by
    :func:`write_pftrace` (or any track_event-subset stream)."""
    with open(path, "rb") as f:
        buf = f.read()
    for field, wt, payload in _fields(buf):
        if field != 1 or wt != 2:
            raise ValueError(
                f"top level must be Trace.packet (field 1), got field "
                f"{field} wire type {wt}"
            )
        pkt: dict = {}
        for f2, _w2, v2 in _fields(payload):
            if f2 == 8:
                pkt["timestamp"] = v2
            elif f2 == 10:
                pkt["sequence_id"] = v2
            elif f2 == 11:
                pkt["track_event"] = _parse_track_event(v2)
            elif f2 == 60:
                pkt["track_descriptor"] = _parse_track_descriptor(v2)
        yield pkt
