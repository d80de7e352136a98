"""The port's observability core and the worker's persistence against the
JAX package's: tracer, metrics registry, manifest fields, backoff, chaos,
doctor, and the dictionary shards' save/load/merge — same inputs, same
outputs, on the CPU.
"""

import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from mapreduce_rust_tpu.analysis import doctor as jax_doctor
from mapreduce_rust_tpu.analysis.chaos import ChaosPlan as JaxChaosPlan
from mapreduce_rust_tpu.runtime import metrics as jax_metrics
from mapreduce_rust_tpu.runtime import telemetry as jax_telemetry
from mapreduce_rust_tpu.runtime.backoff import Backoff as JaxBackoff
from mapreduce_rust_tpu.runtime.dictionary import Dictionary as JaxDictionary
from mapreduce_rust_tpu.runtime.trace import validate_events as jax_validate_events
from mapreduce_rust_tpu_torch.analysis import doctor
from mapreduce_rust_tpu_torch.analysis.chaos import ChaosPlan
from mapreduce_rust_tpu_torch.core.hashing import hash_words
from mapreduce_rust_tpu_torch.runtime import metrics, telemetry, trace
from mapreduce_rust_tpu_torch.runtime.backoff import Backoff
from mapreduce_rust_tpu_torch.runtime.dictionary import Dictionary

REPO = pathlib.Path(__file__).resolve().parents[1]


def _words(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    base = [b"w%d" % i for i in range(n)] + ["café".encode(), "Ωmega".encode()]
    return [base[i] for i in rng.permutation(len(base)).tolist()]


def _unstamped(path) -> bytes:
    """Save bytes with the 8-byte per-instance run token zeroed."""
    b = bytearray(open(path, "rb").read())
    b[8:16] = bytes(8)
    return bytes(b)


# ---- dictionary shards: save / load / merge ----

@pytest.mark.parametrize("budget", [None, 64])
def test_dictionary_save_matches_reference(tmp_path, budget):
    words = _words(1, 300)
    kw = dict(budget_words=budget, spill_dir=str(tmp_path), async_spill=False)
    port, ref = Dictionary(**kw), JaxDictionary(**kw)
    for lo in range(0, len(words), 50):
        port.add_scanned(words[lo:lo + 50], hash_words(words[lo:lo + 50]))
        ref.add_words(words[lo:lo + 50])
    for d in (port, ref):
        d.collisions.append((b"kept", "rejé".encode()))
    assert port.spilled == ref.spilled == (budget is not None)
    port.save(tmp_path / "port.bin")
    ref.save(tmp_path / "ref.bin")
    assert _unstamped(tmp_path / "port.bin") == _unstamped(tmp_path / "ref.bin")
    for cls in (Dictionary, JaxDictionary):
        got = cls.load(tmp_path / "port.bin")
        assert list(got.iter_sorted()) == list(ref.iter_sorted())
        assert got.collisions == ref.collisions and len(got) == len(ref)
    port.remove_runs()
    ref.remove_runs()


def test_dictionary_load_text_and_merge_match_reference(tmp_path):
    a, b = _words(2, 40), _words(3, 60)
    keys = hash_words(a)
    lines = [b"%d %d %s" % (k1, k2, w) for w, (k1, k2) in zip(a, keys.tolist())]
    (tmp_path / "legacy.txt").write_bytes(b"\n".join(lines + [b"! x y"]) + b"\n")
    port, ref = Dictionary.load(tmp_path / "legacy.txt"), JaxDictionary.load(tmp_path / "legacy.txt")
    assert sorted(port.items()) == sorted(ref.items()) and port.collisions == ref.collisions
    other_p, other_r = Dictionary(), JaxDictionary()
    other_p.add_scanned(b, hash_words(b))
    other_r.add_words(b)
    port.merge(other_p)
    ref.merge(other_r)
    assert sorted(port.items()) == sorted(ref.items())
    assert len(port) == len(ref) and port.collisions == ref.collisions


# ---- tracer ----

def test_trace_span_never_initializes_cuda(tmp_path):
    """A span with a tracer active pushes no NVTX range and creates no
    CUDA context unless CUDA is already initialized."""
    code = (
        "import torch\n"
        "from mapreduce_rust_tpu_torch.runtime import trace, telemetry\n"
        "tr = trace.start_tracing(tag='coord')\n"
        "with trace.trace_span('rpc.get_map_task', tid=0):\n"
        "    trace.trace_instant('x', a=1)\n"
        "trace.stop_tracing()\n"
        "p = telemetry.platform_info()\n"
        "assert 'device_name' not in p and p['torch'] == torch.__version__, p\n"
        "assert trace._ANN is trace._UNSET\n"
        "print('INIT', torch.cuda.is_initialized())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO,
                       env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "INIT False" in r.stdout


def test_trace_span_pushes_nvtx_once_cuda_is_up(monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "_ANN", trace._UNSET)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda n: calls.append(("push", n)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: calls.append(("pop",)))
    tr = trace.start_tracing(tag="driver")
    try:
        with trace.trace_span("chunk.dispatch"):
            with trace.trace_span("device.drain", steps=2):
                pass
    finally:
        trace.stop_tracing()
    assert calls == [("push", "chunk.dispatch"), ("push", "device.drain"),
                     ("pop",), ("pop",)]
    jax_validate_events(tr.events())


def test_tracer_events_match_reference(tmp_path):
    """The same span/instant/counter/flow sequence through both tracers
    writes the same event stream (timestamps aside), and the reference
    validator accepts the port's file."""
    from mapreduce_rust_tpu.runtime import trace as jax_trace

    streams = []
    for mod in (trace, jax_trace):
        tr = mod.start_tracing(tag="w1")
        with mod.trace_span("worker.map_task", tid=3, attempt=1):
            mod.trace_flow("task", "t", "map:3:1", phase="map", tid=3)
            mod.trace_instant("worker.task_begin", phase="map", tid=3)
            mod.trace_counter("device.mem.d0", bytes_in_use=7)
        mod.stop_tracing()
        path = tmp_path / f"{mod.__name__}.json"
        tr.write(str(path))
        events, meta = jax_trace.load_trace(str(path))
        jax_validate_events(events)
        streams.append([{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
                        for e in events])
        assert meta["tag"] == "w1"
    assert streams[0] == streams[1]


def test_concurrent_writers_to_one_path_never_tear_it(tmp_path):
    """Two in-process workers may share a pid-tagged trace and manifest
    path. Eight threads, each with its own Tracer, write one trace path 20
    times, and eight more write eight manifests to one path 20 times: every
    write returns, each file left is one whole document, and no temporary
    file stays behind."""
    import json
    import threading

    trace_path = tmp_path / "t-w1.json"
    manifest_path = tmp_path / "m-w1.json"
    tracers, traces, manifests = [], [], []
    for i in range(8):
        tr = trace.Tracer(tag=f"w{i}")
        for j in range(400):
            tr.add_span("chunk.step", j, j + 0.5, args={"chunk": j, "writer": i})
        tracers.append(tr)
        traces.append({"traceEvents": tr.events(), "displayTimeUnit": "ms",
                       "metadata": tr.metadata()})
        manifests.append({"writer": i, "rows": [[i, j] for j in range(2000)]})

    barrier = threading.Barrier(16)
    errors = []

    def run(write):
        try:
            barrier.wait()
            for _ in range(20):
                write()
        except Exception as e:  # reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(
        lambda tr=tr: tr.write(str(trace_path)),)) for tr in tracers]
    threads += [threading.Thread(target=run, args=(
        lambda m=m: telemetry.write_manifest(str(manifest_path), m),))
        for m in manifests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert json.loads(trace_path.read_text()) in traces
    assert json.loads(manifest_path.read_text()) in manifests
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m-w1.json", "t-w1.json"]


# ---- metrics registry, JobStats and the manifest ----

def test_registry_matches_reference():
    out = []
    for mod in (metrics, jax_metrics):
        reg = mod.MetricsRegistry(period_s=1.0, capacity=16)
        c = reg.counter("rpc.calls", "calls")
        g = reg.gauge("fleet.util")
        h = reg.histogram("task.duration_s")
        for i in range(5):
            c.inc(method="get_map_task")
            g.set(0.25 * i, wid=i % 2)
            h.observe(0.01 * (i + 1), phase="map")
        reg.add_collector(lambda: {"worker.bytes_in": 123})
        reg.maybe_sample(force=True)
        pts = reg.timeseries_dict()
        out.append((reg.prometheus_text(), reg.current_values(), pts["series"],
                    [{k: v for k, v in p.items() if k != "t"} for p in pts["points"]]))
    assert out[0] == out[1]


def test_jobstats_manifest_fields_match_reference():
    port, ref = metrics.JobStats(), jax_metrics.JobStats()
    for s in (port, ref):
        s.bytes_in, s.chunks, s.wall_seconds = 1 << 20, 4, 2.0
        s.host_map_workers, s.host_map_s, s.merge_dispatches = 2, 1.5, 3
        s.phase_seconds["stream"] = 1.8
        s.record_hist("device.drain_s", 0.003)
        s.register_writer()
    # The port's stats are the reference's plus the captured step's two
    # counters (runtime/step_graph.py), which XLA has no counterpart of,
    # and the dispatch plane's coalesce and device-merge seconds.
    own = {"step_graph_replays": 0, "step_graph_captures": 0,
           "coalesce_s": 0.0, "merge_device_s": 0.0}
    d = telemetry.stats_to_dict(port)
    assert {k: d.pop(k) for k in own} == own
    assert d == jax_telemetry.stats_to_dict(ref)
    assert port.bottleneck == ref.bottleneck
    m = telemetry.build_manifest(None, stats=port, app_name="word_count")
    jm = jax_telemetry.build_manifest(None, stats=ref, app_name="word_count")
    assert {k: m["stats"].pop(k) for k in own} == own
    assert m["stats"] == jm["stats"]
    # Only the platform stamp differs (torch/CUDA in place of jax).
    diff = jax_telemetry.diff_manifests(jm, m)
    assert diff and all(line.startswith("  platform.") for line in diff), diff


def test_doctor_matches_reference():
    """The copied diagnosis gives the reference's verdict on the same
    manifest and on the same live coordinator stats."""
    stats = metrics.JobStats(bytes_in=1 << 24, chunks=8, wall_seconds=4.0,
                             ingest_wait_s=0.2, device_wait_s=2.5,
                             partition_bytes=[100, 900, 120])
    stats.phase_seconds.update(stream=3.0, finalize=0.5, egress=0.5)
    m = telemetry.build_manifest(None, stats=stats, app_name="word_count")
    assert doctor.diagnose(m) == jax_doctor.diagnose(m)
    rep = telemetry.JobReport(now=lambda: 5.0)
    for tid in range(3):
        rep.record_grant("map", tid, wid=tid % 2)
        rep.record_finish("map", tid, wid=tid % 2, attempt=1)
    live = {"report": rep.to_dict()}
    assert doctor.diagnose_live(live, lease_timeout_s=5.0) == \
        jax_doctor.diagnose_live(live, lease_timeout_s=5.0)


# ---- backoff and chaos ----

def test_backoff_and_chaos_match_reference():
    a = Backoff(0.05, 2.0, budget_s=5.0, rng=random.Random(7))
    b = JaxBackoff(0.05, 2.0, budget_s=5.0, rng=random.Random(7))
    assert [a.next_delay() for _ in range(8)] == [b.next_delay() for _ in range(8)]
    spec = "seed=7;pause:map:0:2.0;kill:reduce:1;slow_disk:0.01:p=0.5;kill:map:*"
    port, ref = ChaosPlan.parse(spec), JaxChaosPlan.parse(spec)
    for site, phase in [("pause", "map"), ("kill", "reduce"), ("kill", "map"),
                        ("slow_disk", None), ("drop_finish", "map")]:
        for tid in range(4):
            got, want = port.pick(site, phase=phase, tid=tid), ref.pick(site, phase=phase, tid=tid)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.site, got.seconds) == (want.site, want.seconds)
    assert port.fired() == ref.fired() and port.fired()
    with pytest.raises(ValueError):
        ChaosPlan.parse("kill:mapp:0")


@pytest.mark.parametrize("site", ["slow_disk", "slow_dispatch"])
def test_chaos_sites_fire_like_reference(tmp_path, monkeypatch, site):
    """The engine-side sites fire at the same indices in both packages:
    slow_disk per spill-run write, slow_dispatch per merge dispatch."""
    from mapreduce_rust_tpu.runtime import driver as jax_driver
    from mapreduce_rust_tpu.runtime import spill as jax_spill
    from mapreduce_rust_tpu_torch.runtime import driver, spill

    spec = f"seed=3;{site}:0.001:p=0.5"
    monkeypatch.setenv("MR_CHAOS", spec)
    fired = []
    for sp, dr in ((spill, driver), (jax_spill, jax_driver)):
        for i in range(8):
            if site == "slow_disk":
                sp.write_npy_run(str(tmp_path / f"r{i}.npy"), np.zeros((1, 3), np.int64), i)
            else:
                dr._chaos_slow_dispatch(i)
        fired.append(sp.chaos_fired(spec) if site == "slow_disk"
                     else dr.dispatch_chaos_fired(spec))
    assert fired[0] == fired[1] and 0 < len(fired[0]) < 8


@pytest.mark.parametrize("engine", ["device", "host"])
def test_sanitized_run_matches_plain(tmp_path, monkeypatch, engine):
    """Under MR_SANITIZE=1 every engine thread that writes stats or owns a
    dictionary shard registers, the fold shards check their routes and
    the native arenas their owner; outputs equal the plain run's."""
    from mapreduce_rust_tpu_torch.analysis.sanitize import SanitizedJobStats
    from mapreduce_rust_tpu_torch.config import Config
    from mapreduce_rust_tpu_torch.native import host
    from mapreduce_rust_tpu_torch.runtime.driver import run_job

    (tmp_path / "in").mkdir()
    for i in range(3):
        (tmp_path / "in" / f"{i}.txt").write_bytes(b" ".join(_words(i, 3000)))
    kw = dict(device="cpu", input_dir=str(tmp_path / "in"), work_dir=str(tmp_path / "w"),
              map_engine=engine, fold_shards=3, host_map_workers=2, chunk_bytes=1 << 14,
              dictionary_budget_words=700)
    plain = run_job(Config(output_dir=str(tmp_path / "plain"), **kw))
    monkeypatch.setenv("MR_SANITIZE", "1")
    monkeypatch.setattr(host, "_sanitize_cached", None)
    san = run_job(Config(output_dir=str(tmp_path / "san"), **kw))
    assert isinstance(san.stats, SanitizedJobStats) and san.stats.dict_spill_runs > 0
    for a, b in zip(plain.output_files, san.output_files):
        assert open(a, "rb").read() == open(b, "rb").read()
