"""The port's bench, ``bench_torch.py``: its one JSON line, its corpora and
its refusal to run without a card.

The harness runs for real on the CPU at tiny sizes (``BENCH_DEVICE=cpu``,
which only tests set): corpus build, the CPU baseline pool, the device,
micro, Zipf and metrics-overhead legs each in its subprocess, the JSON
line; the profile and lineage overhead legs run in the test's process.
It runs the host engine there (``BENCH_MAP_ENGINE=host``): the legs
build the same Config either way, and the device engine's plain scan on
the CPU would quadruple the test's CPU time. A ``jax`` package that
records its import and raises stands first on the subprocesses' path, so
a stray import fails the test in whichever leg makes it. The corpora must be the
reference bench's byte for byte, and without a card the line carries no
number and names why; the other modes without a card start no process.
``tests/test_torch_bench_modes.py`` holds the other modes themselves."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import bench
import bench_torch

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

#: The smallest sizes of every leg: a 2 MB target (the synthetic seed makes
#: one 13.7 MB pass of it), 1 MB of baseline, overhead and Zipf corpus, one
#: device run and one overhead run per side.
TINY = {"BENCH_TARGET_MB": "2", "BENCH_BASELINE_MB": "1", "BENCH_ZIPF_MB": "1",
        "BENCH_METRICS_OVERHEAD_MB": "1", "BENCH_DEVICE_RUNS": "1",
        "BENCH_OVERHEAD_RUNS": "1", "BENCH_PROBE_TIMEOUT_S": "120",
        "BENCH_DEVICE_TIMEOUT_S": "240"}


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    """One BENCH_DIR for the module, so both runs share the corpus build."""
    return tmp_path_factory.mktemp("bench-torch")


@pytest.fixture(scope="module")
def poisoned_path(tmp_path_factory):
    """(PYTHONPATH entry holding a jax package that raises on import, the
    file that package writes when something imports it)."""
    root = tmp_path_factory.mktemp("poison")
    marker = root / "jax-was-imported"
    (root / "jax").mkdir()
    (root / "jax" / "__init__.py").write_text(
        f"open({str(marker)!r}, 'a').write(__name__ + '\\n')\n"
        "raise ImportError('the port and its bench must not import jax')\n")
    return root, marker


def run_bench(bench_dir, poisoned_path, **env):
    root, _marker = poisoned_path
    child_env = {k: v for k, v in os.environ.items()
                 if not k.startswith("BENCH_") and k != "PYTHONPATH"}
    child_env.update(TINY, BENCH_DIR=str(bench_dir), PYTHONPATH=str(root), **env)
    r = subprocess.run([sys.executable, str(REPO_ROOT / "bench_torch.py")],
                       capture_output=True, text=True, timeout=600, env=child_env,
                       cwd=str(REPO_ROOT))
    lines = [line for line in r.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, f"expected one stdout line, got {lines}\n{r.stderr[-2000:]}"
    return r, json.loads(lines[0])


def test_bench_prints_contract_line_on_cpu(bench_dir, poisoned_path):
    # The profile and lineage overhead legs run in this process below.
    r, line = run_bench(bench_dir, poisoned_path, BENCH_DEVICE="cpu",
                        BENCH_MAP_ENGINE="host", BENCH_PROFILE_OVERHEAD="0",
                        BENCH_LINEAGE_OVERHEAD="0")
    assert r.returncode == 0, r.stderr[-3000:]
    assert set(line) >= {"metric", "value", "unit", "vs_baseline", "platform", "probes"}
    assert line["unit"] == "GB/s" and line["value"] > 0 and line["vs_baseline"] > 0
    assert line["platform"] == "cpu" and line["map_engine"] == "host"
    assert "error" not in line, line.get("error")
    assert [p["leg"] for p in line["probes"]] == [
        "device", "micro", "zipf", "metrics-overhead"]
    assert all(p["ok"] for p in line["probes"])
    zipf = line["zipf"]
    assert zipf["exact"] and zipf["lines"] == zipf["expected_distinct"] > 0
    assert line["metrics_overhead"]["outputs_identical"]
    assert line["metrics_overhead"]["platform"] == "cpu"
    assert line["device_micro"]["map_step_ms_per_mb"] > 0
    assert line["doctor"]["bottleneck"]
    assert not poisoned_path[1].exists(), poisoned_path[1].read_text()
    # The measured leg's run manifest: the whole run_job path on the CPU.
    # The warm-up loaded the native library, so that load is the leg's
    # kernel build and the measured run, which built nothing, has none.
    run = json.loads((bench_dir / "leg-run-manifest.json").read_text())
    assert run["kind"] == "run_manifest" and run["config"]["device"] == "cpu"
    assert "compile" not in run["stats"]
    assert line["kernel_builds"]["count"] >= 1
    manifest = json.loads((bench_dir / "manifest.json").read_text())
    assert manifest["kind"] == "bench_manifest"
    # The port's linter over the repo: clean, with the reference's 24 rules.
    assert manifest["lint"]["ok"] is True and manifest["lint"]["findings"] == 0
    assert manifest["lint"]["exit_code"] == 0 and manifest["lint"]["rules"] == 24
    assert manifest["result"] == line
    history = (bench_dir / "history.jsonl").read_text().splitlines()
    assert json.loads(history[-1])["value"] == line["value"]


@pytest.mark.parametrize("leg", ["profile_overhead", "lineage_overhead"])
def test_overhead_leg_on_cpu(leg, bench_dir, monkeypatch, capsys):
    """The profile and lineage overhead legs in this process, on the CPU,
    with ``import jax`` made to fail: outputs identical on and off, and a
    1% growth of the corpus leaves most of lineage's bytes memo hits."""
    monkeypatch.setitem(sys.modules, "jax", None)  # import jax now raises
    monkeypatch.setattr(bench_torch, "BENCH_DIR", bench_dir)
    monkeypatch.setattr(bench_torch, "DEVICE", "cpu")
    monkeypatch.setattr(bench_torch, "OVERHEAD_RUNS", 1)
    monkeypatch.setenv("BENCH_MAP_ENGINE", "host")
    getattr(bench_torch, f"{leg}_leg")(str(bench_torch.build_corpus(1)))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[leg]
    assert out["outputs_identical"] and out["platform"] == "cpu"
    assert out["runs_per_side"] == 1 and out["on_s"] > 0 and out["off_s"] > 0
    if leg == "lineage_overhead":
        assert out["blast_radius"]["memo_hit_frac"] > 0.9


def test_bench_without_a_card_prints_no_number(bench_dir, poisoned_path):
    r, line = run_bench(bench_dir, poisoned_path, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 1
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["unit"] == "GB/s" and line["platform"] == "none"
    assert "no CUDA device" in line["error"]
    # Every leg was tried on the card and none ran anywhere else.
    assert line["probes"] and not any(p["ok"] for p in line["probes"])
    assert all("no CUDA device" in p["error"] for p in line["probes"])
    for leg in ("device_micro", "zipf", "metrics_overhead", "profile_overhead",
                "lineage_overhead"):
        assert leg not in line
    assert not poisoned_path[1].exists()


def test_corpora_match_the_reference_bench(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "BENCH_DIR", tmp_path / "ref")
    monkeypatch.setattr(bench, "REF_DATA", tmp_path / "absent")
    monkeypatch.setattr(bench_torch, "BENCH_DIR", tmp_path / "port")
    assert bench_torch.build_corpus(1).read_bytes() == bench.build_corpus(1).read_bytes()
    ref = bench.build_zipf_corpus(1)
    port = bench_torch.build_zipf_corpus(1)
    assert port[0].name == ref[0].name
    assert port[0].read_bytes() == ref[0].read_bytes()
    assert np.array_equal(np.load(port[1]), np.load(ref[1]))


def test_device_engine_is_the_default(monkeypatch):
    monkeypatch.delenv("BENCH_MAP_ENGINE", raising=False)
    assert bench_torch._map_engine() == "device"
    assert bench_torch._zipf_cfg("w", "o", 8).map_engine == "device"
    assert bench_torch.DEVICE == os.environ.get("BENCH_DEVICE", "cuda")


@pytest.mark.parametrize("args,keys", [
    (["--chaos"], {"ok": False, "scenarios": None}),
    (["--service-leg"], {"ok": False, "value": None}),
    (["--dispatch-ab"], {"value": None}),
    (["--sweep-spill-budget", "131072,262144"], {"value": None, "sweep": None}),
])
def test_modes_without_a_card_start_nothing(args, keys, tmp_path, poisoned_path):
    """A mode that needs the card checks for it before it starts a
    process: one line with no number and an error naming the card, exit
    1, and nothing built or run on the CPU."""
    root, marker = poisoned_path
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "MR_")) and k != "PYTHONPATH"}
    env.update(BENCH_DIR=str(tmp_path), PYTHONPATH=str(root), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(REPO_ROOT / "bench_torch.py"), *args],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=str(REPO_ROOT))
    lines = [line for line in r.stdout.splitlines() if line.strip()]
    assert r.returncode == 1 and len(lines) == 1, (r.stdout, r.stderr[-2000:])
    line = json.loads(lines[0])
    assert {k: line.get(k) for k in keys} == keys
    assert "no CUDA device" in line["error"]
    assert not any(tmp_path.iterdir()), list(tmp_path.iterdir())
    assert not marker.exists()


def test_unknown_arguments_are_refused():
    r = subprocess.run([sys.executable, str(REPO_ROOT / "bench_torch.py"), "--chaos",
                        "--no-such-flag"], capture_output=True, text=True, timeout=60,
                       cwd=str(REPO_ROOT))
    assert r.returncode != 0 and not r.stdout
    assert "unknown arguments ['--no-such-flag']" in r.stderr
