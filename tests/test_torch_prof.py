"""The port's sampling profiler, ``profile_dir`` and roofline against the
JAX package.

The profiler and the roofline module are copies of the reference's; these
tests hold the copies to the reference on the same inputs (plane names,
the manifest's ``stats.profile`` block, ``roofline_report``, the ``prof``
CLI's text and JSON), show that port jobs write byte-identical outputs
with the profiler on and off (``Config.profile`` and ``MR_PROFILE=1``),
that every port thread lands in a plane, and that ``profile_dir`` writes
a CPU-only trace on the CPU and refuses one on a card.
"""

import json
import pathlib
import time

import numpy as np
import pytest
import torch

from mapreduce_rust_tpu.__main__ import main as jax_cli_main
from mapreduce_rust_tpu.analysis import roofline as jax_roofline
from mapreduce_rust_tpu.runtime import prof as jax_prof
from mapreduce_rust_tpu_torch.__main__ import main as cli_main
from mapreduce_rust_tpu_torch.analysis import roofline
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.runtime import driver, prof
from mapreduce_rust_tpu_torch.runtime.driver import run_job


def _corpus(seed: int, n_words: int, vocab_size: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"w%d" % i for i in range(vocab_size)] + ["café".encode(), b"it's"]
    ws = rng.integers(0, len(vocab), n_words)
    return b" ".join(vocab[w] for w in ws.tolist()) + b"\n"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    (d / "a.txt").write_bytes(_corpus(11, 30_000, 4000))
    (d / "b.txt").write_bytes(_corpus(12, 12_000, 300))
    return d


def port_cfg(corpus, out: pathlib.Path, **kw) -> Config:
    return Config(device="cpu", chunk_bytes=1 << 16, merge_capacity=1 << 14, reduce_n=3,
                  input_dir=str(corpus), output_dir=str(out / "out"),
                  work_dir=str(out / "work"), **kw)


def outputs(res) -> list:
    return [pathlib.Path(p).read_bytes() for p in res.output_files]


@pytest.fixture(scope="module")
def manifests(corpus, tmp_path_factory):
    """Profiled port runs on both engines: engine → (manifest path, outputs),
    plus their unprofiled outputs."""
    root = tmp_path_factory.mktemp("prof-runs")
    runs = {}
    for engine in ("device", "host"):
        kw = dict(map_engine=engine, host_map_workers=2, fold_shards=2)
        off = run_job(port_cfg(corpus, root / f"{engine}-off", **kw))
        m = root / f"{engine}-on" / "m.json"
        on = run_job(port_cfg(corpus, root / f"{engine}-on", profile=True, profile_hz=997.0,
                              manifest_path=str(m), **kw))
        runs[engine] = (m, outputs(on), outputs(off))
    return runs


def test_plane_of_matches_reference():
    names = ["MainThread", "mr/ingest", "mr/ingest-io_0", "mr/scan_3", "mr/fold-1",
             "mr/spill-acc-0a1b", "mr/spill-dict-0a1b", "mr/dispatch", "mr/metrics-http",
             "mr/prof-sampler", "Thread-7", "asyncio_0", "", "mr/other"]
    assert [prof.plane_of(n) for n in names] == [jax_prof.plane_of(n) for n in names]
    assert prof.DEFAULT_HZ == jax_prof.DEFAULT_HZ == Config().profile_hz


def test_profile_dict_keys_match_reference():
    def keys(p):
        d = p.profile_dict()
        return (sorted(d), sorted(d["frame_table"]), sorted(d["stack_table"]),
                [sorted(v) for v in d["planes"].values()][:1],
                [sorted(f) for f in d["top_frames"]][:1])

    docs = []
    for mod in (prof, jax_prof):
        p = mod.SamplingProfiler(hz=997.0).start()
        t_end = time.perf_counter() + 0.1
        while time.perf_counter() < t_end:
            sum(range(1000))
        p.stop()
        docs.append(keys(p))
    assert docs[0] == docs[1]
    assert docs[0][3] == [["samples", "self_s"]]


@pytest.mark.parametrize("engine", ["device", "host"])
def test_outputs_identical_with_profiler(corpus, manifests, tmp_path, monkeypatch, engine):
    m, on, off = manifests[engine]
    assert on == off
    monkeypatch.setenv("MR_PROFILE", "1")
    forced = run_job(port_cfg(corpus, tmp_path, map_engine=engine, host_map_workers=2,
                              fold_shards=2, manifest_path=str(tmp_path / "f.json")))
    assert outputs(forced) == off
    for path in (m, tmp_path / "f.json"):
        block = json.loads(path.read_text())["stats"]["profile"]
        assert block["samples"] > 0 and "router" in block["planes"]
        folded = path.with_suffix(".folded").read_text().splitlines()
        assert folded and all(line.rsplit(" ", 1)[1].isdigit() for line in folded)
    assert prof.active_profiler() is None  # compare-and-clear at job end


def test_port_threads_land_in_a_plane(corpus, manifests, tmp_path):
    """Every thread a port job starts carries an mr/ plane name: the
    stacks of a profiled run on each engine, with both spill tiers
    writing, hold no port thread in the ``other`` plane."""
    run_job(port_cfg(corpus, tmp_path, map_engine="host", host_map_workers=2, fold_shards=2,
                     host_accum_budget_mb=0, dictionary_budget_words=64, profile=True,
                     profile_hz=997.0, manifest_path=str(tmp_path / "m.json")))
    seen = {}
    for path in (tmp_path / "m.json", manifests["device"][0], manifests["host"][0]):
        for line in json.loads(path.read_text())["stats"]["profile"]["stacks"]:
            name = line.split(";", 1)[0]
            seen[name] = prof.plane_of(name)
    ours = {n: p for n, p in seen.items() if n == "MainThread" or n.startswith("mr/")}
    assert ours and all(p != "other" for p in ours.values()), ours
    assert {"router", "ingest", "scan", "fold"} <= set(ours.values()), ours


def test_profile_dir_on_cpu_writes_a_cpu_trace(corpus, tmp_path, monkeypatch):
    asked = []
    real = torch.profiler.profile

    def recording(*args, **kw):
        asked.append(list(kw["activities"]))
        return real(*args, **kw)

    monkeypatch.setattr(torch.profiler, "profile", recording)
    off = run_job(port_cfg(corpus, tmp_path / "off"))
    res = run_job(port_cfg(corpus, tmp_path / "on", profile_dir=str(tmp_path / "tp")))
    assert outputs(res) == outputs(off)
    assert asked == [[torch.profiler.ProfilerActivity.CPU]]
    (trace,) = (tmp_path / "tp").glob("stream-p*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert driver.count_device_events(str(trace)) == 0


def test_profile_dir_on_a_card_refuses_a_cpu_only_trace(tmp_path, monkeypatch):
    """A torch without CUPTI raises before the block runs; a trace that
    comes back without device activity raises after it."""
    card = torch.device("cuda", 0)
    cpu_only = {torch.profiler.ProfilerActivity.CPU}
    monkeypatch.setattr(torch.profiler, "supported_activities", lambda: cpu_only)
    ran = []
    with pytest.raises(RuntimeError, match="cannot record CUDA activity"):
        with driver._device_trace(str(tmp_path / "a"), card):
            ran.append(1)
    assert not ran and not (tmp_path / "a").exists()

    both = cpu_only | {torch.profiler.ProfilerActivity.CUDA}
    monkeypatch.setattr(torch.profiler, "supported_activities", lambda: both)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(RuntimeError, match="holds no CUDA activity"):
        with driver._device_trace(str(tmp_path / "b"), card):
            torch.ones(4).sum()
    assert len(list((tmp_path / "b").glob("*.pt.trace.json"))) == 1


# ---------------------------------------------------------------------------
# Roofline and the prof CLI
# ---------------------------------------------------------------------------

MACHINE = {"schema": 1, "created": "2026-01-01T00:00:00Z", "host_memcpy_gbs": 9.5,
           "probe_mb": 64, "devices": [{"id": 0, "kind": "NVIDIA H100 80GB HBM3",
                                        "platform": "gpu", "hbm_gbs": 3350.0,
                                        "tflops": 989.0}]}


@pytest.fixture(scope="module")
def machine(tmp_path_factory):
    path = tmp_path_factory.mktemp("machine") / "machine.json"
    path.write_text(json.dumps(MACHINE))
    return path


def synthetic_manifest(host_manifest: pathlib.Path, tmp: pathlib.Path) -> pathlib.Path:
    """The host manifest plus blocks its run did not write (an
    interconnect split and a spill split) and a merge cost of round
    numbers, so every row of the report is exercised."""
    m = json.loads(host_manifest.read_text())
    m["merge_cost"] = {"flops": 2.5e6, "bytes_accessed": 3.0e6}
    m["stats"]["ici_split"] = {"wire_bytes": 5 << 20, "all_to_all_s": 0.01, "rounds": 3}
    m["stats"]["spill_split"] = {"bytes": 7 << 20, "write_s": 0.02}
    path = tmp / "synthetic.json"
    path.write_text(json.dumps(m))
    return path


def test_roofline_report_matches_reference(manifests, tmp_path):
    paths = [manifests["device"][0], manifests["host"][0],
             synthetic_manifest(manifests["host"][0], tmp_path)]
    for machine_doc in (MACHINE, {**MACHINE, "devices": []}):
        for path in paths:
            m = json.loads(path.read_text())
            got = roofline.roofline_report(m, machine_doc)
            assert got == jax_roofline.roofline_report(m, machine_doc)
    rows = roofline.roofline_report(json.loads(paths[2].read_text()), MACHINE)["stages"]
    assert {r["stage"] for r in rows} == {"host-map-scan", "spill-write", "dispatch",
                                          "device-merge", "a2a-shuffle"}


@pytest.mark.parametrize("form", ["text", "json", "folded"])
def test_prof_cli_matches_reference(manifests, machine, tmp_path, capsys, form):
    for engine in ("device", "host"):
        m = str(manifests[engine][0])
        args = ["prof", m, "--roofline", "--machine", str(machine)]
        if form == "json":
            args += ["--format", "json"]
        outs = []
        for main, tag in ((cli_main, "port"), (jax_cli_main, "ref")):
            extra = ["--folded", str(tmp_path / f"{engine}-{tag}.folded")] \
                if form == "folded" else []
            assert main(args + extra) == 0
            outs.append(capsys.readouterr().out.replace(f"{engine}-{tag}.folded", "F"))
        assert outs[0] == outs[1] and outs[0].strip()
        if form == "folded":
            assert (tmp_path / f"{engine}-port.folded").read_bytes() == \
                (tmp_path / f"{engine}-ref.folded").read_bytes()
    assert cli_main(["prof", str(machine)]) == 0  # a file with no profile
    assert "profile: none in manifest" in capsys.readouterr().out


def test_probe_device_peaks_never_initializes_cuda(tmp_path, monkeypatch):
    assert roofline.probe_device_peaks() == []
    m = roofline.calibrate(str(tmp_path / "machine.json"), force=True, size_mb=4)
    assert m["devices"] == [] and m["host_memcpy_gbs"] > 0
    assert roofline.load_machine(str(tmp_path / "machine.json")) == m
    assert not torch.cuda.is_initialized()
    # Where CUDA is already up, each card is named and priced.
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    assert roofline.probe_device_peaks() == [
        {"id": 0, "kind": "NVIDIA H100 80GB HBM3", "platform": "gpu", "hbm_gbs": 3350.0,
         "tflops": 989.0}]
