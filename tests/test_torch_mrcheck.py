"""The port's ``check`` (analysis/mrcheck.py) against the JAX package's.

The reference's own recorded run (its Coordinator, driven as
tests/test_mrcheck.py drives it, tracing on) is corrupted by the
reference's seeded-violation harness, one mutation class at a time; the
port's checker must give the reference's findings on each, as equal JSON
and equal CLI output and exit codes. The port's checker must also accept a
port cluster's artifacts (exit 0, the reference's verdict) and a service
work root, and its CLI must never load torch.
"""

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from mapreduce_rust_tpu.analysis import mrcheck as jax_mrcheck
from mapreduce_rust_tpu.config import Config as JaxConfig
from mapreduce_rust_tpu.coordinator.server import Coordinator as JaxCoordinator
from mapreduce_rust_tpu.runtime.telemetry import write_job_report
from mapreduce_rust_tpu.runtime.trace import start_tracing, stop_tracing
from mapreduce_rust_tpu_torch.analysis import mrcheck
from test_torch_cluster import cluster_kw, corpus, port_cluster  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
TEXTS = [
    "the quick brown fox jumps over the lazy dog " * 20,
    "pack my box with five dozen liquor jugs " * 20,
]


@pytest.fixture(scope="module")
def recorded_run(tmp_path_factory):
    """The reference Coordinator through a clean 2-worker, 2-phase run
    with tracing on; journal, job report and trace persisted."""
    root = tmp_path_factory.mktemp("mrcheck-run")
    docs = root / "in"
    docs.mkdir()
    for i, t in enumerate(TEXTS):
        (docs / f"doc-{i}.txt").write_bytes(t.encode())
    cfg = JaxConfig(map_n=2, reduce_n=2, worker_n=2, chunk_bytes=4096,
                    input_dir=str(docs), work_dir=str(root / "work"),
                    output_dir=str(root / "out"))
    tracer = start_tracing(tag="coord")
    try:
        c = JaxCoordinator(cfg)
        assert (c.get_worker_id(), c.get_worker_id()) == (0, 1)
        t0, t1 = c.get_map_task(0), c.get_map_task(1)
        assert c.renew_map_lease(t0, 0) is True
        assert c.report_map_task_finish(t1, attempt=1, wid=1) is False
        assert c.report_map_task_finish(t0, attempt=1, wid=0) is True
        r0, r1 = c.get_reduce_task(0), c.get_reduce_task(1)
        c.report_reduce_task_finish(r0, attempt=1, wid=0)
        c.report_reduce_task_finish(r1, attempt=1, wid=1)
        assert c.deregister_worker(0) and c.deregister_worker(1)
        write_job_report(os.path.join(cfg.work_dir, "job_report.json"), c.report)
    finally:
        tracer = stop_tracing()
    trace = str(root / "trace.json")
    tracer.write(trace)
    return {"work": root / "work", "trace": trace}


def _cli(module, target, trace=None, fmt="text"):
    args = argparse.Namespace(target=target, trace=trace, journal=None,
                              job_report=None, format=fmt, verbose=False)
    return module.run_cli(args)


def _same_verdict(target, capsys, trace=None) -> dict:
    """Both packages' check over one target: equal documents, equal CLI
    output and exit codes in both formats. Returns the port's document."""
    got = mrcheck.run_check(target, trace=trace)
    want = jax_mrcheck.run_check(target, trace=trace)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    for fmt in ("text", "json"):
        capsys.readouterr()
        rc = _cli(mrcheck, target, trace, fmt)
        out = capsys.readouterr()
        assert rc == _cli(jax_mrcheck, target, trace, fmt), fmt
        assert out == capsys.readouterr(), fmt
    return got


def test_catalog_is_the_reference_catalog():
    assert sorted(mrcheck.INVARIANTS) == sorted(jax_mrcheck.INVARIANTS)
    assert sorted(mrcheck.MUTATIONS) == sorted(jax_mrcheck.MUTATIONS)
    assert set(mrcheck.MUTATIONS) == set(mrcheck.INVARIANTS)


@pytest.mark.parametrize("name", ["none"] + sorted(jax_mrcheck.MUTATIONS))
def test_findings_match_reference(recorded_run, tmp_path, capsys, name):
    work = tmp_path / "work"
    work.mkdir()
    for f in ("coordinator.journal", "job_report.json"):
        shutil.copy(recorded_run["work"] / f, work / f)
    trace = str(tmp_path / "trace.json")
    shutil.copy(recorded_run["trace"], trace)
    needs_trace = True
    if name != "none":
        needs_trace, mutate = jax_mrcheck.MUTATIONS[name]
        assert (mutate(str(work), trace) if needs_trace else mutate(str(work))) == name
    doc = _same_verdict(str(work), capsys, trace=trace if needs_trace else None)
    if name == "none":
        assert doc["ok"] and doc["checked"]["journal_lines"] == 4
    else:
        assert {v["code"] for v in doc["violations"]} == {name}


@pytest.mark.parametrize("name", sorted(jax_mrcheck.MUTATIONS))
def test_port_mutations_write_the_reference_corruption(recorded_run, tmp_path, name):
    """The port's seeded-violation harness corrupts a copy exactly as the
    reference's does."""
    copies = []
    for pkg in (mrcheck, jax_mrcheck):
        d = tmp_path / pkg.__name__.split(".")[0]
        shutil.copytree(recorded_run["work"], d / "work")
        shutil.copy(recorded_run["trace"], d / "trace.json")
        needs_trace, mutate = pkg.MUTATIONS[name]
        args = (str(d / "work"), str(d / "trace.json")) if needs_trace else (str(d / "work"),)
        assert mutate(*args) == name
        copies.append({p.relative_to(d).as_posix(): p.read_bytes()
                       for p in sorted(d.rglob("*")) if p.is_file()})
    assert copies[0] == copies[1]


def test_port_cluster_artifacts_are_conformant(corpus, tmp_path, capsys):  # noqa: F811
    fields = cluster_kw(corpus, tmp_path, "word_count", chunk_bytes=1 << 14,
                        trace_path=str(tmp_path / "t.json"))
    port_cluster(fields, "word_count", "host")
    trace = str(next(tmp_path.glob("t-c*.json")))
    doc = _same_verdict(str(tmp_path / "work"), capsys, trace=trace)
    assert doc["ok"] and doc["checked"]["authoritative"]
    assert doc["checked"]["journal_lines"] == 4 + 3
    assert _cli(mrcheck, str(tmp_path / "work"), trace) == 0


def _service_root(recorded_run, root: pathlib.Path) -> pathlib.Path:
    """A service work root: an admission journal and one job's dir."""
    shutil.copytree(recorded_run["work"], root / "job-j1")
    rows = [{"op": "submit", "job": "j1", "t": 0.1},
            {"op": "start", "job": "j1", "t": 0.2},
            {"op": "done", "job": "j1", "t": 1.0, "state": "done"}]
    (root / "service.journal").write_text("".join(json.dumps(r) + "\n" for r in rows))
    return root


def test_service_root_matches_reference(recorded_run, tmp_path, capsys):
    root = _service_root(recorded_run, tmp_path / "svc")
    doc = _same_verdict(str(root), capsys)
    assert doc["checked"]["service_journal_lines"] == 3


def test_check_cli_never_loads_torch(recorded_run, tmp_path):
    root = _service_root(recorded_run, tmp_path / "svc")
    code = (
        "import sys; from mapreduce_rust_tpu_torch.__main__ import main; "
        f"rcs = [main(['check', {str(recorded_run['work'])!r}, '--trace', "
        f"{recorded_run['trace']!r}]), main(['check', {str(root)!r}])]; "
        "bad = [m for m in ('torch', 'jax', 'mapreduce_rust_tpu') if m in sys.modules]; "
        "print('RCS', rcs, 'LOADED', bad); sys.exit(3 if bad else max(rcs))"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO,
                       env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "RCS [0, 0] LOADED []" in r.stdout
