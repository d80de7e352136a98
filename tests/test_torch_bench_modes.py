"""``bench_torch.py``'s other modes against ``bench.py``'s, on the CPU.

The model leg and the sweep harness are held against the reference bench
at the same settings (the sweeps' legs stubbed in both). The legs of the
host-only knobs and the dispatch A/B are read from the stubbed legs'
environments: they run the host engine, and the spill sweep keeps the
caller's. The chaos cluster, the two slow pairs and the service run for
real at tiny sizes with ``BENCH_DEVICE=cpu``, each process behind an
import hook that records and fails any import of jax or of the JAX
package; their outputs are
held against ``reference_word_counts`` (not against the reference's
host-engine cluster, whose packer aliasing makes it unsteady on a
multi-core CPU) and their journals against ``run_check``."""

import collections
import json
import os
import pathlib
import subprocess
import sys

import pytest

import bench
import bench_torch
from mapreduce_rust_tpu_torch.analysis import mrcheck
from mapreduce_rust_tpu_torch.core.normalize import reference_word_counts

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _poison(root: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path]:
    """(PYTHONPATH entry whose sitecustomize makes every import of jax or
    of the JAX package raise in each process started with it, the file it
    writes when something tries)."""
    marker = root / "forbidden-import"
    (root / "sitecustomize.py").write_text(
        "import sys\n\n\n"
        "class _Forbid:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'mapreduce_rust_tpu'):\n"
        f"            open({str(marker)!r}, 'a').write(name + '\\n')\n"
        "            raise ImportError(f'the port and its bench must not import {name}')\n"
        "        return None\n\n\n"
        "sys.meta_path.insert(0, _Forbid())\n")
    return root, marker


@pytest.fixture(scope="module")
def poisoned_path(tmp_path_factory):
    return _poison(tmp_path_factory.mktemp("poison"))


@pytest.mark.parametrize("module", ["jax", "mapreduce_rust_tpu.config"])
def test_poison_catches_the_reference(module, tmp_path):
    root, marker = _poison(tmp_path)
    r = subprocess.run([sys.executable, "-c", f"import {module}"], cwd=str(REPO_ROOT),
                       capture_output=True, text=True, timeout=60,
                       env=_child_env((root, marker), tmp_path))
    assert r.returncode != 0 and "must not import" in r.stderr
    assert marker.read_text().split() == [module.split(".")[0]]


def _child_env(poisoned_path, bench_dir, **env) -> dict:
    child = {k: v for k, v in os.environ.items()
             if not k.startswith(("BENCH_", "MR_")) and k != "PYTHONPATH"}
    child.update(PYTHONPATH=str(poisoned_path[0]), BENCH_DIR=str(bench_dir),
                 BENCH_DEVICE="cpu", **env)
    return child


def _read_outputs(out_dir) -> dict:
    table = {}
    for p in sorted(pathlib.Path(out_dir).glob("mr-*.txt")):
        for line in p.read_bytes().splitlines():
            w, v = line.rsplit(b" ", 1)
            table[w] = int(v)
    return table


def test_model_leg_matches_reference(tmp_path, poisoned_path, monkeypatch, capsys):
    r = subprocess.run(
        [sys.executable, str(REPO_ROOT / "bench_torch.py"), "--model-leg"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO_ROOT),
        env=_child_env(poisoned_path, tmp_path / "port", BENCH_MODEL_BUDGET="200",
                       BENCH_MODEL_DEPTH="8"))
    assert r.returncode == 0, r.stderr[-2000:]
    port = json.loads(r.stdout.strip().splitlines()[-1])
    monkeypatch.setattr(bench, "BENCH_DIR", tmp_path / "ref")
    monkeypatch.setenv("BENCH_MODEL_BUDGET", "200")
    monkeypatch.setenv("BENCH_MODEL_DEPTH", "8")
    bench.model_leg()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port["model_schedules_per_s"] > 0
    for key in ("metric", "unit", "value", "platform", "model_explored", "model_pruned",
                "model_steps", "model_ok", "model_counterexamples"):
        assert port[key] == ref[key], key
    assert port["model_ok"] and port["model_explored"] > 0
    history = json.loads((tmp_path / "port" / "history.jsonl").read_text().splitlines()[-1])
    assert history["model_explored"] == port["model_explored"]
    assert not poisoned_path[1].exists()


@pytest.mark.parametrize("spec,typ", [
    ("0,2", int), (" , ", int), ("-1", int), ("1,x", int), ("", int),
    ("0", float), ("1.5", float), ("0.5,-0.1", float), (",", float),
    ("1, 2,4", int), ("0.25,1", float),
])
def test_parse_sweep_counts_like_reference(spec, typ):
    def outcome(mod):
        try:
            return mod._parse_sweep_counts(spec, "--sweep", typ=typ)
        except (SystemExit, ValueError) as e:
            return type(e).__name__, str(e)

    assert outcome(bench_torch) == outcome(bench)


_SWEEPS = [
    # (function, spec, env var, engine its legs run)
    ("sweep_host_workers", "1,2,4", "BENCH_HOST_WORKERS", "host"),
    ("sweep_fold_shards", "1,2,4", "BENCH_FOLD_SHARDS", "host"),
    ("sweep_spill_budget", "131072,262144", "BENCH_SPILL_BUDGET_WORDS", "device"),
    ("sweep_dispatch_fill", "0.25,0.5,0.9", "BENCH_DISPATCH_FILL", "host"),
]

#: Every field the four sweeps' point_stats read, so each point is full.
_LEG_STATS = {
    "bottleneck": "host-map", "host_map_s": 1.0, "scan_wait_s": 0.1,
    "host_glue_s": 0.5, "fold_stall_s": 0.01, "wall_seconds": 2.0,
    "host_map_split": {"scan_parallelism": 3.5},
    "fold_split": {"fold_parallelism": 2.0, "balance": 0.9},
    "spill_split": {"write_s": 0.3, "stall_s": 0.0, "dict_runs": 4, "merge_fanin": 5},
    "dispatch_split": {"dispatch_s": 0.2, "stall_s": 0.05, "dispatches": 7,
                       "fill_frac": 0.6},
}


@pytest.mark.parametrize("fail_first", [False, True])
@pytest.mark.parametrize("name,spec,env_var,engine", _SWEEPS)
def test_run_sweep_matches_reference(name, spec, env_var, engine, fail_first, tmp_path,
                                     monkeypatch, capsys):
    """The same stubbed legs give the same curve and anchoring (every
    speedup null when the first point failed) in both benches; the port's
    legs run the engine the knob exists on, and its line names it."""
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"a b c\n" * 100)
    monkeypatch.delenv("BENCH_MANIFEST", raising=False)
    monkeypatch.delenv("BENCH_MAP_ENGINE", raising=False)
    monkeypatch.setattr(bench_torch, "DEVICE", "cpu")

    def run(mod):
        seen = []

        def fake_leg(c, timeout_s, env, init_timeout_s=None, mode="--device-leg"):
            seen.append(env)
            n = float(env[env_var])
            if fail_first and len(seen) == 1:
                return None, "leg failed"
            gbs = 0.1 * n if n >= 1 else n
            if mode == "--zipf":
                return {"zipf": {"gbs": gbs, "platform": "cpu"}, "stats": _LEG_STATS}, None
            return {"gbs": gbs, "info": {"platform": "cpu"}, "stats": _LEG_STATS}, None

        monkeypatch.setattr(mod, "BENCH_DIR", tmp_path / "bench")
        monkeypatch.setattr(mod, "build_corpus", lambda mb: corpus)
        monkeypatch.setattr(mod, "_run_device_leg", fake_leg)
        getattr(mod, name)(spec)
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), seen

    port, seen = run(bench_torch)
    ref, _ = run(bench)
    assert port["sweep"] == ref["sweep"]
    assert port["speedup_vs_first"] == ref["speedup_vs_first"]
    assert len(port["sweep"]) == len(spec.split(","))
    assert all(s is None for s in port["speedup_vs_first"]) == fail_first
    assert [env["BENCH_MAP_ENGINE"] for env in seen] == [engine] * len(seen)
    assert port["map_engine"] == engine and engine in port["metric"]
    assert port["platform"] == "cpu"


def test_dispatch_ab_interleaves_sides_on_the_host_engine(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DISPATCH_AB_REPEATS", "2")
    monkeypatch.delenv("BENCH_MAP_ENGINE", raising=False)
    for var in ("MR_DISPATCH_SYNC", "BENCH_DISPATCH_COALESCE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(bench_torch, "DEVICE", "cpu")

    def run(mod):
        seen = []

        def fake_leg(c, timeout_s, env, init_timeout_s=None, mode="--device-leg"):
            assert mode == "--zipf"
            sync = env.get("MR_DISPATCH_SYNC") == "1"
            seen.append(env)
            wall = (3.0 if sync else 2.0) + 0.1 * len(seen)
            return {"zipf": {"wall_s": wall, "gbs": 1 / wall, "platform": "cpu",
                             "dispatch_mode": "sync" if sync else "async"}}, None

        monkeypatch.setattr(mod, "BENCH_DIR", tmp_path / mod.__name__)
        monkeypatch.setattr(mod, "_run_device_leg", fake_leg)
        mod.dispatch_ab_pair()
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), seen

    port, seen = run(bench_torch)
    ref, _ = run(bench)
    # plane, pr10, plane, pr10: the pr10 side alone runs sync, uncoalesced.
    assert [(e.get("MR_DISPATCH_SYNC"), e.get("BENCH_DISPATCH_COALESCE")) for e in seen] \
        == [(None, None), ("1", "0")] * 2
    assert all(e["BENCH_MAP_ENGINE"] == "host" for e in seen)
    assert port["value"] == ref["value"] == round(3.2 / 2.1, 3)
    assert port["plane"] == ref["plane"] and port["pr10"] == ref["pr10"]
    assert port["map_engine"] == "host" and port["platform"] == "cpu"


@pytest.fixture(scope="module")
def chaos_runs(tmp_path_factory, poisoned_path):
    """The fault-free leg on the default (device) engine and the seeded
    kill leg on the host engine named by BENCH_MAP_ENGINE, both real
    coordinator + 2 worker processes on the CPU."""
    root = tmp_path_factory.mktemp("chaos")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_torch, "DEVICE", "cpu")
        mp.setenv("PYTHONPATH", str(poisoned_path[0]))
        mp.delenv("MR_CHAOS", raising=False)
        mp.delenv("BENCH_MAP_ENGINE", raising=False)
        base = bench_torch._chaos_cluster("baseline", root, None, False)
        mp.setenv("BENCH_MAP_ENGINE", "host")
        kill = bench_torch._chaos_cluster("kill", root, "seed=2;kill:map:1", False)
    return {"baseline": base, "kill": kill}


@pytest.mark.parametrize("leg,engine", [("baseline", "device"), ("kill", "host")])
def test_chaos_cluster_recovers_exactly(leg, engine, chaos_runs, poisoned_path):
    r = chaos_runs[leg]
    assert r["recovered"], r
    oracle = collections.Counter()
    for t in bench_torch._CHAOS_TEXTS:
        oracle.update(reference_word_counts(t))
    assert _read_outputs(pathlib.Path(r["dir"]) / "out") == {
        w.encode(): c for w, c in oracle.items()}
    assert r["outputs"] == chaos_runs["baseline"]["outputs"]
    assert bench_torch._CHAOS_TEXTS == bench._CHAOS_TEXTS
    doc = mrcheck.run_check(str(pathlib.Path(r["dir"]) / "work"))
    assert doc["ok"], doc["violations"]
    assert r["map_engine"] == engine
    assert r["workers"] and all(w["engine"] == engine for w in r["workers"])
    assert all(w["kernel_builds"]["cache_misses"] == 0 for w in r["workers"])
    report = json.loads((pathlib.Path(r["dir"]) / "work" / "job_report.json")
                        .read_text())["report"]["totals"]
    grants = sum(w["map_grants"] for w in r["workers"])
    if leg == "kill":
        # The victim SIGKILLed itself on map task 1: it wrote no manifest,
        # and the survivor re-ran that task after the expiry.
        assert len(r["workers"]) == 1
        assert report["map"]["expiries"] >= 1 and report["map"]["re_executions"] >= 1
        assert 1 <= grants <= len(bench_torch._CHAOS_TEXTS) + report["map"]["re_executions"]
    else:
        assert len(r["workers"]) == 2 and grants == len(bench_torch._CHAOS_TEXTS)
        assert report["map"]["expiries"] == report["map"]["re_executions"] == 0
    assert not poisoned_path[1].exists()


@pytest.mark.parametrize("fault", ["none", "diverged", "violation", "hidden"])
def test_chaos_legs_fail_the_matrix(fault, tmp_path, monkeypatch, capsys):
    """chaos_legs with the clusters and the pairs stubbed: a diverged
    output, a run_check violation or a pair that hid nothing fails the
    matrix (exit 1); otherwise it passes."""
    monkeypatch.setattr(bench_torch, "DEVICE", "cpu")
    monkeypatch.setattr(bench_torch, "BENCH_DIR", tmp_path)
    monkeypatch.setattr(bench_torch, "_build_libraries", lambda: None)
    monkeypatch.setattr(bench_torch, "build_corpus", lambda mb: tmp_path / "c.txt")

    def fake_cluster(name, work_root, spec, speculate, sched="fifo"):
        out = {"mr-0.txt": b"a 1\n"}
        if fault == "diverged" and name == "kill":
            out = {"mr-0.txt": b"a 2\n"}
        return {"scenario": name, "speculate": speculate, "sched": sched,
                "wall_s": 5.0 if name == "slow_scan-nospec" else 2.0,
                "recovered": True, "outputs": out, "dir": str(tmp_path / name)}

    def fake_check(target, trace=None):
        bad = fault == "violation" and target.endswith(os.path.join("pause", "work"))
        return {"ok": not bad,
                "violations": [{"code": "double-grant", "message": "x"}] if bad else []}

    def fake_leg(c, timeout_s, env, init_timeout_s=None, mode="--device-leg"):
        name = mode[2:-4].replace("-", "_")
        hidden = 0.0 if fault == "hidden" and name == "slow_dispatch" else 0.4
        return {name: {"platform": "cpu", "fired": 3, "hidden_s": hidden,
                       "outputs_identical": True}}, None

    monkeypatch.setattr(bench_torch, "_chaos_cluster", fake_cluster)
    monkeypatch.setattr(mrcheck, "run_check", fake_check)
    monkeypatch.setattr(bench_torch, "_run_device_leg", fake_leg)
    if fault == "none":
        bench_torch.chaos_legs()
    else:
        with pytest.raises(SystemExit) as e:
            bench_torch.chaos_legs()
        assert e.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ok"] == (fault == "none")
    assert line["speculation_speedup"] == 2.5
    assert [r["scenario"] for r in line["scenarios"]][:2] == ["baseline", "pause"]
    assert line["slow_dispatch_pair"]["hidden_s"] == (0.0 if fault == "hidden" else 0.4)
    assert line["platform"] == "cpu" and line["map_engine"] == "device"


@pytest.mark.parametrize("mode,name", [("--slow-disk-leg", "slow_disk"),
                                       ("--slow-dispatch-leg", "slow_dispatch")])
def test_slow_pair_leg_on_cpu(mode, name, tmp_path, poisoned_path):
    """Each pair in its subprocess at ~1-2 MB: the fault fired and the
    outputs are identical. Whether the async side hides the delay is the
    card's to show (PERF.md), not this CPU's."""
    corpus = tmp_path / "c.txt"
    # ~1.6 MB of 100,000 distinct words (the slow-dispatch leg builds its
    # own 1 MB Zipf corpus instead).
    corpus.write_bytes(b"".join(b"w%d x%d " % (i, i % 97) for i in range(100_000)))
    r = subprocess.run(
        [sys.executable, str(REPO_ROOT / "bench_torch.py"), mode, str(corpus)],
        capture_output=True, text=True, timeout=180, cwd=str(REPO_ROOT),
        env=_child_env(poisoned_path, tmp_path / "bench", BENCH_SLOW_DISPATCH_MB="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    det = json.loads(r.stdout.strip().splitlines()[-1])[name]
    assert det["outputs_identical"] and det["fired"] > 0
    assert det["platform"] == "cpu" and det["map_engine"] == "host"
    # Interleaved runs per side; each side reports its fastest.
    assert det["runs_per_side"] == 2
    for side in ("async", "sync"):
        assert len(det["walls_s"][side]) == 2
        assert det[side]["wall_s"] == min(det["walls_s"][side]) > 0
    assert not poisoned_path[1].exists()


def test_service_run_serves_repeats_from_the_cache(tmp_path, poisoned_path, monkeypatch):
    monkeypatch.setattr(bench_torch, "DEVICE", "cpu")
    monkeypatch.setenv("PYTHONPATH", str(poisoned_path[0]))
    monkeypatch.delenv("BENCH_MAP_ENGINE", raising=False)
    r = bench_torch._service_run(4, "fifo", tmp_path / "service")
    assert r["ok"], r
    assert r["completed"] == 4 and r["cache_hits"] == 1
    assert r["mrcheck"]["ok"] and r["mrcheck"]["jobs"] == 3
    assert r["value"] > 0 and r["queue_wait_p95_s"] is not None
    # Three computed jobs of three documents each; the repeat granted none.
    assert len(r["workers"]) == 2 and all(w["engine"] == "device" for w in r["workers"])
    assert sum(w["map_grants"] for w in r["workers"]) == 9
    assert r["platform"] == "cpu" and r["map_engine"] == "device"
    assert not poisoned_path[1].exists()
