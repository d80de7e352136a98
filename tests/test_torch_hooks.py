"""The device hooks the port's bench reads: kernel-build records folded into
a job's stats and manifest (the counterpart of the JAX package's compile
listener) and the packed merge's per-dispatch cost (the counterpart of its
XLA cost analysis), which the roofline's device-merge row needs."""

import json
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from mapreduce_rust_tpu_torch.__main__ import main as cli_main
from mapreduce_rust_tpu_torch.analysis import roofline
from mapreduce_rust_tpu_torch.apps import get_app
from mapreduce_rust_tpu_torch.config import Config
from mapreduce_rust_tpu_torch.native import host as native_host
from mapreduce_rust_tpu_torch.ops import cuda_build, tokenize_cuda
from mapreduce_rust_tpu_torch.runtime import driver
from mapreduce_rust_tpu_torch.runtime.driver import run_job


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("hooks-corpus")
    rng = np.random.default_rng(5)
    for name, n in (("a.txt", 20_000), ("b.txt", 8_000)):
        words = rng.integers(0, 3000, n)
        (d / name).write_bytes(b" ".join(b"w%d" % w for w in words.tolist()) + b"\n")
    return d


def cfg(corpus, out: pathlib.Path, **kw) -> Config:
    return Config(device="cpu", chunk_bytes=1 << 16, reduce_n=3, input_dir=str(corpus),
                  output_dir=str(out / "out"), work_dir=str(out / "work"), **kw)


@pytest.fixture
def build_log(monkeypatch):
    """A fresh, empty build log for the test, with the native library
    already loaded (its first load is not the test's record)."""
    native_host.get_lib()
    log: list = []
    monkeypatch.setattr(cuda_build, "BUILD_LOG", log)
    monkeypatch.setattr(driver, "BUILD_LOG", log)
    return log


def test_jobs_fold_build_records(corpus, tmp_path, build_log, monkeypatch):
    """Each job counts the builds made during it and no others: the
    warm-up's count, seconds and split are its own, the next job's compile
    block holds only its build, as a span on the build track, and a job
    with no build writes no compile block."""
    select = driver.select_device
    builds: list = []

    def select_and_build(kind):
        for tool, cache, seconds in builds:
            t1 = driver.time.perf_counter()
            cuda_build.record_build(tool, "x", cache, t1 - seconds, t1)
        return select(kind)

    monkeypatch.setattr(driver, "select_device", select_and_build)
    builds[:] = [("nvcc", "miss", 1.5), ("g++", "hit", 0.25)]
    warm = run_job(cfg(corpus, tmp_path / "warm"))
    assert (warm.stats.compile_count, warm.stats.compile_cache_hits,
            warm.stats.compile_cache_misses) == (2, 1, 1)
    assert warm.stats.compile_s == pytest.approx(1.75)

    builds[:] = [("nvcc", "hit", 0.125)]
    trace, manifest = tmp_path / "t.json", tmp_path / "m.json"
    run_job(cfg(corpus, tmp_path / "measured", trace_path=str(trace),
                manifest_path=str(manifest)))
    m = json.loads(manifest.read_text())
    comp = m["stats"]["compile"]
    assert (comp["count"], comp["cache_hits"], comp["cache_misses"]) == (1, 1, 0)
    assert comp["total_s"] == pytest.approx(0.125)
    assert m["stats"]["histograms"]["kernel.build_s"]["count"] == 1
    events = json.loads(trace.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = [e for e in events if e.get("name") == "kernel.build"]
    assert len(spans) == 1 and spans[0]["tid"] == driver._BUILD_TRACK_TID
    assert spans[0]["args"]["cache"] == "hit"

    builds[:] = []
    later = tmp_path / "later.json"
    run_job(cfg(corpus, tmp_path / "later", manifest_path=str(later)))
    assert "compile" not in json.loads(later.read_text())["stats"]


def test_load_library_records_a_hit_once(tmp_path, build_log, monkeypatch):
    """A library already in the build directory loads as a hit, with the
    seconds of its load; the kernel's loader loads it once per process, so
    a second use adds no record."""
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tokenize_cuda, "SOURCE", "stub.cu")
    (tmp_path / "csrc").mkdir()
    # The scan library's C interface, stubbed: the loader checks the tile.
    (tmp_path / "csrc" / "stub.cu").write_text(
        'extern "C" {\n'
        "int mr_hash_scan() { return 0; }\nint mr_tokenize_hash() { return 0; }\n"
        "long long mr_hash_scan_scratch_bytes(long long) { return 0; }\n"
        f"long long mr_hash_scan_tile_bytes() {{ return {tokenize_cuda.TILE_BYTES}; }}\n"
        "}\n")
    lib_path = cuda_build.library_path("stub.cu")
    lib_path.parent.mkdir()
    subprocess.run([shutil.which("g++"), "-shared", "-fPIC", "-x", "c++", "-o",
                    str(lib_path), str(tmp_path / "csrc" / "stub.cu")], check=True)
    tokenize_cuda._load_lib.cache_clear()
    try:
        lib = tokenize_cuda._lib()
        assert lib.mr_hash_scan_tile_bytes() == tokenize_cuda.TILE_BYTES
        assert len(build_log) == 1
        rec = build_log[0]
        assert (rec["tool"], rec["source"], rec["cache"]) == ("nvcc", "stub.cu", "hit")
        assert rec["dur_s"] == rec["t1"] - rec["t0"] >= 0
        assert tokenize_cuda._lib() is lib and len(build_log) == 1
    finally:
        tokenize_cuda._load_lib.cache_clear()


@pytest.fixture(scope="module")
def host_manifests(corpus, tmp_path_factory):
    """Two host-engine jobs whose merges dispatch to the (CPU) device, each
    writing a manifest; the merge-cost cache is emptied before each."""
    root = tmp_path_factory.mktemp("merge-cost")
    paths = []
    for i in range(2):
        driver._merge_costs.clear()
        path = root / f"m{i}.json"
        res = run_job(cfg(corpus, root / f"run{i}", map_engine="host",
                          merge_capacity=1 << 12, host_update_cap=1 << 10,
                          dispatch_coalesce=False, manifest_path=str(path)))
        assert res.stats.merge_dispatches > 0
        paths.append(path)
    return paths


def test_host_manifest_carries_merge_cost(host_manifests):
    costs = [json.loads(p.read_text())["merge_cost"] for p in host_manifests]
    assert costs[0] == costs[1]
    mc = costs[0]
    assert set(mc) == {"flops", "bytes_accessed"} and mc["flops"] > 0
    n, cap = 1 << 12, 1 << 10
    # At least the merge's own traffic: the state in (3 int32 lanes and
    # the bool lane), the flat update in, and the state out.
    assert mc["bytes_accessed"] >= n * 13 + (1 + 3 * cap) * 4 + n * 13


@pytest.mark.parametrize("op", ["word_count", "inverted_index"])
def test_merge_cost_is_the_same_on_meta_and_cpu(op):
    app = get_app(op)
    assert driver._count_merge_ops(app, 64, 256, "meta") == \
        driver._count_merge_ops(app, 64, 256, "cpu")


def test_roofline_prints_device_merge_row(host_manifests, tmp_path, capsys):
    machine = tmp_path / "machine.json"
    roofline.calibrate(str(machine), force=True, size_mb=4)
    assert cli_main(["prof", str(host_manifests[0]), "--roofline", "--machine",
                     str(machine), "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    rows = {r["stage"]: r for r in doc["roofline"]["stages"]}
    assert rows["device-merge"]["flops"] > 0
    assert cli_main(["prof", str(host_manifests[0]), "--roofline", "--machine",
                     str(machine)]) == 0
    assert "device-merge" in capsys.readouterr().out
