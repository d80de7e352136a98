"""The token count behind the scan's roofline, the device-trace reader,
and every metric reader on recorded job statistics."""

from __future__ import annotations

import json

import numpy as np
import pytest

from mrbench import counting, devtrace, harness
from mrbench.harness import Job, Readings

WS = b" \t\n\r\x0b\x0c"
WORDISH = set(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")


def _plain_tokens(data: bytes) -> int:
    """Whitespace-separated runs that hold a word byte, one byte at a time."""
    n, word = 0, False
    for b in data + b" ":
        if b in WS:
            n += word
            word = False
        elif b in WORDISH or b >= 0x80:
            word = True
    return n


@pytest.mark.parametrize("block", [1, 3, 7, 1 << 22])
def test_token_count_equals_a_plain_recount(block):
    rng = np.random.default_rng(11)
    alphabet = np.frombuffer(b"ab_9.,!-  \t\n\xc3\xa9", dtype=np.uint8)
    chunk = alphabet[rng.integers(0, len(alphabet), 5000)]
    assert counting.count_tokens(chunk, block) == _plain_tokens(chunk.tobytes())
    for text in (b"", b"   ", b"a", b"...", b"a.b c", b"!! x !!", b" ab\n"):
        arr = np.frombuffer(text, dtype=np.uint8)
        assert counting.count_tokens(arr, block) == _plain_tokens(text)


def test_scan_bytes_counts_a_read_and_a_key_per_token():
    assert counting.scan_bytes(1000, 10) == 1000 + 8 * 10


def _job(i, nbytes, wall, phases, path="", **stats):
    s = {"bytes_in": nbytes, "chunks": 2, "wall_seconds": wall, "phase_seconds": phases,
         "fold_s": 0.0, "ingest_wait_s": 0.0, "device_wait_s": 0.0,
         "unknown_keys": 0, "hash_collisions": 0}
    s.update(stats)
    return Job(index=i, file=0, path=path, nbytes=nbytes, t0=10.0 * i,
               t1=10.0 * i + wall + 0.5, output_dir="", trace_path=None, stats=s,
               error=None)


PHASES = {"stream": 1.0, "finalize": 0.5, "egress": 0.25}


def _readings(trace=None, kind="cpu"):
    jobs = [_job(0, 500_000_000, 2.0, dict(PHASES), fold_s=1.0, ingest_wait_s=0.2,
                 device_wait_s=0.1),
            _job(1, 1_500_000_000, 3.0, dict(PHASES), fold_s=3.0, ingest_wait_s=0.6,
                 device_wait_s=0.3)]
    # The traced window's job: what the untraced window's readers must not read.
    traced = [_job(2, 1_000_000_000, 9.0, {"stream": 1.0}, fold_s=50.0,
                   ingest_wait_s=50.0, device_wait_s=50.0)]
    return Readings(jobs=jobs, window_s=8.0, setup_s=12.5, trace=trace, kind=kind,
                    traced_jobs=traced)


def test_readers_on_recorded_stats():
    r = _readings()
    read = lambda name: harness.read_metric(name, r)  # noqa: E731
    assert read("gb_per_s") == pytest.approx(2.0 / 8.0)
    assert read("setup_s") == 12.5
    assert read("job_overhead_s") == pytest.approx(((2.0 - 1.75) + (3.0 - 1.75)) / 2)
    assert read("fold_s_per_gb") == pytest.approx(4.0 / 2.0)
    assert read("ingest_wait_s_per_gb") == pytest.approx(0.8 / 2.0)
    assert read("device_wait_s_per_gb") == pytest.approx(0.4 / 2.0)
    assert read("finalize_s_per_gb") == pytest.approx(1.5 / 2.0)
    # Nothing on the device to read without a trace or a known card.
    assert read("tokenize_hash_roofline") is None
    assert read("device_idle_frac") is None


def test_dispatch_seconds_from_program_spans():
    r = _readings()
    assert harness.read_metric("dispatch_s_per_gb", r) is None
    r.trace = devtrace.DeviceTrace(window_s=1.0, busy_s=0.1, ops={}, idle_by_span={},
                                   span_s={"chunk.dispatch": 3.0})
    assert harness.read_metric("dispatch_s_per_gb", r) == pytest.approx(3.0)  # traced GB


def test_roofline_and_idle_from_a_trace(tmp_path):
    path = tmp_path / "in.txt"
    path.write_bytes(b"ab cd ef\n" * 1000)  # 9000 bytes, 3000 tokens
    r = _readings(kind="NVIDIA H100 80GB HBM3")
    r.traced_jobs = r.jobs
    r.jobs = [_job(9, 10, 1.0, {})]  # the untraced window's: not read here
    for j in r.traced_jobs:
        j.path, j.nbytes, j.stats["bytes_in"], j.stats["chunks"] = str(path), 9000, 9000, 2
    need = (9000 + 8 * 3000) / 3.35e12           # seconds per job's scan
    per_launch = need * 2 / 4                      # 2 jobs over 4 chunks
    trace = devtrace.DeviceTrace(
        window_s=2.0, busy_s=0.5, idle_by_span={}, span_s={},
        ops={"void scan_kernel<true>(unsigned char const*, long)": [4, 4 * per_launch * 2],
             "void scan_kernel<false>(x)": [1, 1.0], "Memset (Device)": [4, 0.1]})
    r.trace = trace
    assert harness.read_metric("tokenize_hash_roofline", r) == pytest.approx(50.0)
    assert harness.read_metric("device_idle_frac", r) == pytest.approx(0.75)
    r.kind = "some other card"
    assert harness.read_metric("tokenize_hash_roofline", r) is None


def _x(name, ts, dur, cat, tid=1):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "cat": cat, "pid": 1, "tid": tid}


def test_device_trace_busy_idle_and_host_spans(tmp_path):
    # Device clock in µs; markers end at 1000 / 5000 (job 0) and 6000 /
    # 8000 (job 1); the host read its clock there, 100 s ahead.
    dev = [(999, 1000, "spin_kernel(long)"), (4999, 5000, "spin_kernel(long)"),
           (5999, 6000, "spin_kernel(long)"), (7999, 8000, "spin_kernel(long)"),
           (1500, 2500, "k1"), (2000, 3000, "k1"),  # busy 1500-3000
           (6500, 7000, "Memcpy HtoD"),
           (0, 500, "k0")]  # before the window: left out
    # Job 0's program trace: perf clock = device clock / 1e6 + 100 s.
    spans = {"traceEvents": [
        _x("phase.stream", 1000, 3000, "", tid=7), _x("ingest.wait", 1200, 300, "", tid=7),
        _x("phase.finalize", 4000, 800, "", tid=7), _x("other thread", 0, 9000, "", tid=8)],
        "metadata": {"anchor_perf_s": 100.0}}
    spath = tmp_path / "job0.json"
    spath.write_text(json.dumps(spans))
    jobs = [(100.001, 100.005, str(spath)), (100.006, 100.008, None)]
    t = devtrace.read(dev, jobs)
    assert t.window_s == pytest.approx(0.007)
    assert t.busy_s == pytest.approx(0.002)
    assert t.ops["k1"] == [2, pytest.approx(0.002)]
    assert "k0" not in t.ops
    assert not any("spin_kernel" in name for name in t.ops)
    idle = t.idle_by_span
    assert idle["ingest.wait"] == pytest.approx(0.0003)        # 1200-1500
    assert idle["phase.stream"] == pytest.approx(0.0002 + 0.001)  # 1000-1200, 3000-4000
    assert idle["phase.finalize"] == pytest.approx(0.0008)
    assert idle["run_job"] == pytest.approx(0.0002 + 0.0015)   # 4800-5000, job 1's rest
    assert idle["between_jobs"] == pytest.approx(0.001)
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.span_s["phase.stream"] == pytest.approx(0.003)
    assert "other thread" not in t.span_s
    b = devtrace.breakdown(t)
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) <= devtrace.TOP
    # A trace without every job's two markers is not read.
    assert devtrace.read(dev, jobs[:1]) is None


def test_device_events_keep_only_the_device(monkeypatch):
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, name, dev, t, d):
            self._v = (name, dev, t, d)

        def name(self):
            return self._v[0]

        def device_type(self):
            return self._v[1]

        def start_ns(self):
            return self._v[2]

        def duration_ns(self):
            return self._v[3]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [Ev("k", DeviceType.CUDA, 2000, 500),
                            Ev("cudaLaunchKernel", DeviceType.CPU, 1000, 10)]

    assert devtrace.device_events(Prof) == [(2.0, 2.5, "k")]
