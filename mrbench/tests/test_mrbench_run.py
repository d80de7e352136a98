"""The harness end to end on the CPU: the contract line, the refusals
(no card, JAX loaded, no program beside it), the faults a run must catch,
and the controls; one test for the card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from mrbench import harness
from mrbench.tests.conftest import ROOT, HostCard, bench, tiny

SEED = 3_000_000_017  # over 2**31: a seed may need more than 32 signed bits
CELLS = [w["name"] for w in bench()["workloads"]]

#: Runs ``python -m mrbench.run`` in a fresh interpreter with the card
#: replaced by the CPU stand-in; argv[1] is the extra code to run first.
_STUB = """
import runpy, sys
sys.path.insert(0, {code_root!r})
from mrbench import chip
from mrbench.tests.conftest import HostCard
chip.open_card = lambda n: HostCard(n)
exec(sys.argv[1])
sys.argv = ["mrbench.run"] + sys.argv[2:]
try:
    runpy.run_module("mrbench.run", run_name="__main__", alter_sys=True)
finally:
    tops = sorted({{m.split(".")[0] for m in sys.modules}})
    print("MODULES " + " ".join(tops), file=sys.stderr)
"""


def _run_cli(cwd, workload, seconds=2, trace=0, pre="", code_root=ROOT, env=None):
    cmd = [sys.executable, "-c", _STUB.format(code_root=str(code_root)), pre,
           "--workload", workload, "--seed", str(SEED), "--seconds", str(seconds),
           "--trace", str(trace)]
    e = dict(os.environ, **(env or {}))
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300, env=e)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_run_prints_one_contract_line(tiny_root, trace):
    p = _run_cli(tiny_root, "wordcount-zipf.64m", trace=trace)
    assert p.returncode == 0, p.stderr[-3000:]
    line = _last_json(p.stdout)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    b = bench()
    names = {m["name"] for m in (b["per_layer"] if trace else b["end_to_end"])}
    units = {m["name"]: m["unit"] for m in b["per_layer"] + b["end_to_end"]}
    assert set(line["metrics"]) <= names
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        # The CPU has no device trace: the device metrics are left out.
        assert "job_overhead_s" in line["metrics"] and "device_idle_frac" not in line["metrics"]
        assert "breakdown" not in line and "busy_s" not in line["device"]
        # A second, traced window follows the untraced one; both are checked.
        walls = [x.split(" walls s ")[1].split() for x in p.stderr.splitlines()
                 if "job walls s " in x]
        assert len(walls) == 2 and all(walls)
        assert line["attempted"] == sum(map(len, walls)) == line["checks"]["jobs_checked"]["value"]
    else:
        assert set(line["metrics"]) == {"gb_per_s", "setup_s"}
    stderr_checks = [x for x in p.stderr.splitlines() if x.startswith("check ")]
    assert [x.split()[1] for x in stderr_checks] == list(line["checks"])


def test_run_loads_no_jax(tiny_root):
    p = _run_cli(tiny_root, "wordcount-hibench.256m")
    assert p.returncode == 0, p.stderr[-3000:]
    tops = next(x for x in p.stderr.splitlines() if x.startswith("MODULES ")).split()[1:]
    assert "mapreduce_rust_tpu_torch" in tops and "torch" in tops
    assert not set(tops) & {"jax", "jaxlib", "flax", "mapreduce_rust_tpu"}


def test_run_refuses_when_jax_was_loaded(tiny_root):
    pre = "import types; sys.modules['jax'] = types.ModuleType('jax')"
    p = _run_cli(tiny_root, CELLS[0], pre=pre)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "jax" in p.stderr


def test_run_refuses_without_a_card():
    cmd = [sys.executable, "-m", "mrbench.run", "--workload", CELLS[0], "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and not p.stdout.strip()
    assert "cuda" in p.stderr.lower()


def test_run_fails_without_the_program(tmp_path):
    # A checkout that holds only BENCHMARK.json and the benchmark's files.
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "mrbench", tmp_path / "mrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_cli(tmp_path, CELLS[0], code_root=tmp_path,
                 env={"PYTHONPATH": str(tmp_path)})
    assert p.returncode != 0 and not p.stdout.strip()
    assert "mapreduce_rust_tpu_torch" in p.stderr


def test_traffic_keys_nothing_reads_are_refused(tiny_root):
    path = tiny_root / "mrbench" / "traffic" / "64m.json"
    mix = json.loads(path.read_text())
    harness.load_cell(str(tiny_root), "wordcount-zipf.64m")
    path.write_text(json.dumps(dict(mix, clients=4)))
    with pytest.raises(harness.Refused, match="clients"):
        harness.load_cell(str(tiny_root), "wordcount-zipf.64m")


def test_every_job_is_checked(tmp_path):
    from mrbench import pool as pool_mod
    from mrbench.reference import word_count

    cell = _tiny_cell(CELLS[0])
    p = pool_mod.build(cell.config, cell.traffic, SEED, "cpu", 4)
    try:
        ids, counts = p.truth[0]
        want = word_count.expected(p.words, p.parts, ids, counts, 4)
        good, bad = tmp_path / "good", tmp_path / "bad"
        for d, lines in ((good, want), (bad, [want[0][1:] + [want[0][0] + b"9"]] + want[1:])):
            d.mkdir()
            for r, part in enumerate(lines):
                (d / f"mr-{r}.txt").write_bytes(b"".join(x + b"\n" for x in sorted(part)))
        stats = {"unknown_keys": 0, "hash_collisions": 0}
        jobs = [harness.Job(index=k, file=0, path=p.files[0], nbytes=0, t0=0.0, t1=1.0,
                            output_dir=str(good), trace_path=None, stats=dict(stats),
                            error=None) for k in range(150)]
        jobs[97].output_dir = str(bad)
        jobs[131].stats["unknown_keys"] = 1
        jobs[149].stats, jobs[149].error = None, "RuntimeError()"
        checks, failed = harness.check_answers(cell, p, jobs)
    finally:
        p.close()
    assert checks["jobs_checked"]["value"] == 149
    assert checks["mismatched_lines"]["value"] == 2 and checks["unknown_keys"]["value"] == 1
    assert checks["jobs_raised"]["value"] == 1 and failed == 3
    assert not harness.passed(checks)


def _tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(str(ROOT), name)
    cell.config, cell.traffic = tiny(cell.config, [w for w in bench()["workloads"]
                                                   if w["name"] == name][0]["traffic"])
    return cell


def _break_state(monkeypatch):
    from mapreduce_rust_tpu_torch.runtime import driver

    orig = driver.make_step_fns

    def make_step_fns(app, u_cap):
        map_combine, merge = orig(app, u_cap)

        def merge_unchanged(state, update):
            _new, evicted, ev_count = merge(state, update)
            return state, evicted, ev_count * 0
        return map_combine, merge_unchanged
    monkeypatch.setattr(driver, "make_step_fns", make_step_fns)


def _half_batch(monkeypatch):
    import torch

    from mapreduce_rust_tpu_torch.core.kv import KVBatch
    from mapreduce_rust_tpu_torch.runtime import driver

    orig = driver.tokenize_and_hash

    def first_half(chunk, last_is_boundary=True):
        kv = orig(chunk, last_is_boundary)
        keep = torch.arange(kv.valid.numel(), device=kv.valid.device) < kv.valid.numel() // 2
        return KVBatch(kv.k1, kv.k2, kv.value * keep, kv.valid & keep)
    monkeypatch.setattr(driver, "tokenize_and_hash", first_half)


def _alter_token(monkeypatch):
    import torch

    from mapreduce_rust_tpu_torch.core.kv import KVBatch
    from mapreduce_rust_tpu_torch.runtime import driver

    orig = driver.tokenize_and_hash

    def altered(chunk, last_is_boundary=True):
        kv = orig(chunk, last_is_boundary)
        first = torch.argmax(kv.valid.to(torch.int32))
        k1 = kv.k1.clone()
        k1[first] ^= 1
        return KVBatch(k1, kv.k2, kv.value, kv.valid)
    monkeypatch.setattr(driver, "tokenize_and_hash", altered)


FAULTS = {"state_unchanged": _break_state, "half_batch": _half_batch,
          "token_altered": _alter_token}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_faults_come_out_not_correct(monkeypatch, cell, fault):
    if fault is not None:
        FAULTS[fault](monkeypatch)
    res = harness.run_cell(_tiny_cell(cell), SEED, 1.0, False, time.perf_counter(),
                           HostCard())
    assert res["correct"] is (fault is None), res["checks"]
    if fault is not None:
        assert res["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell):
    from mrbench import control, pool

    c = harness.load_cell(str(ROOT), cell)
    if c.config["control"] == "int16_counts":
        # The most frequent word passes 32,767 in an 8 MiB Zipf job.
        traffic = {"job_bytes": {"law": "fixed", "bytes": 8 << 20}, "pool_files": 2,
                   "warmup_bytes": 8}
    else:
        traffic = {"job_bytes": {"law": "fixed", "bytes": 3 << 20}, "pool_files": 2,
                   "warmup_bytes": 1 << 10}
        c.config["program"]["chunk_bytes"] = 256 << 10
    p = pool.build(c.config, traffic, SEED, "cpu", int(c.config["program"]["reduce_n"]))
    try:
        checks, failed = control.control_checks(c, p, 2)
    finally:
        p.close()
    assert checks["mismatched_lines"]["value"] > 0 and failed == 2
    assert not harness.passed(checks)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable, "-m", "mrbench.run", "--workload", cell, "--seed", str(SEED),
           "--seconds", "3", "--trace", "1"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = _last_json(p.stdout)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert 0 < line["metrics"]["tokenize_hash_roofline"]["value"] <= 100
