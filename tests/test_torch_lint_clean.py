"""Tier-1 gate: the port's tree lints clean with an EMPTY baseline.

``python -m mapreduce_rust_tpu_torch lint`` checks the port package,
``tests/``, ``bench_torch.py`` and ``__graft_entry_torch__.py`` with the
JAX package's 24 rules (six of them widened with torch twins) and must
exit 0 with no finding, in the JSON and in the text format. The command
is torch-free: the process that runs both loads none of torch, jax or the
JAX package. ``--check-trace``
accepts a trace the port's Tracer wrote and rejects an unbalanced one.
"""

import json
import pathlib
import subprocess
import sys

import pytest

from mapreduce_rust_tpu.analysis.rules import ALL_RULES as REF_RULES
from mapreduce_rust_tpu.analysis.rules import PROGRAM_RULES as REF_PROGRAM_RULES
from mapreduce_rust_tpu_torch.__main__ import main
from mapreduce_rust_tpu_torch.runtime.trace import (
    start_tracing,
    stop_tracing,
    trace_counter,
    trace_flow,
    trace_span,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}


def _py_files(root: pathlib.Path) -> int:
    return sum(1 for p in root.rglob("*.py") if "__pycache__" not in p.parts)


#: ``python -m mapreduce_rust_tpu_torch lint --format json`` through runpy,
#: as ``-m`` runs it, then ``main(['lint'])`` in the text format with its
#: report on stderr, then the backends the two loaded, on stderr.
_LINT = """
import contextlib, runpy, sys
sys.argv = ["mapreduce_rust_tpu_torch", "lint", "--format", "json"]
try:
    runpy.run_module("mapreduce_rust_tpu_torch", run_name="__main__", alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
from mapreduce_rust_tpu_torch.__main__ import main
with contextlib.redirect_stdout(sys.stderr):
    text_rc = main(["lint"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("torch", "jax", "mapreduce_rust_tpu"))
print("TEXT_RC", text_rc, file=sys.stderr)
print("LOADED", bad, file=sys.stderr)
sys.exit(rc or text_rc or (3 if bad else 0))
"""


@pytest.fixture(scope="module")
def lint_run():
    """The whole-tree lint in both formats, once for the module: the exit
    code, the JSON report and the modules the runs loaded."""
    return subprocess.run([sys.executable, "-c", _LINT], capture_output=True,
                          text=True, timeout=180, cwd=REPO, env=ENV)


def test_lint_exits_zero_on_the_port(lint_run):
    r = lint_run
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-1000:])
    doc = json.loads(r.stdout)
    assert doc["ok"] is True and doc["findings"] == []
    assert doc["tool"] == "mrlint" and doc["suppressed_baseline"] == 0
    # The port package, tests/, bench_torch.py and __graft_entry_torch__.py.
    assert doc["files_checked"] == (
        _py_files(REPO / "mapreduce_rust_tpu_torch") + _py_files(REPO / "tests") + 2)
    assert doc["rules"] == sorted(r.name for r in [*REF_RULES, *REF_PROGRAM_RULES])
    assert len(doc["rules"]) == 24


def test_lint_cli_loads_no_torch_or_jax(lint_run):
    r = lint_run
    assert r.returncode == 0, (r.returncode, r.stdout[-2000:], r.stderr[-500:])
    assert "TEXT_RC 0" in r.stderr
    assert "LOADED []" in r.stderr


def test_check_trace_accepts_a_port_trace(tmp_path, capsys):
    tracer = start_tracing(tag="w1")
    try:
        with trace_span("rpc.get_map_task", tid=0):
            trace_flow("task", "s", "map:0:1")
            trace_counter("device.mem.d0", bytes_in_use=4096)
    finally:
        stop_tracing()
    good = tracer.write(str(tmp_path / "trace.json"))
    assert main(["lint", "--check-trace", good]) == 0
    assert "valid trace" in capsys.readouterr().out

    # The same trace with a span opened and never closed.
    bad = tmp_path / "bad.json"
    events = json.loads(pathlib.Path(good).read_text())["traceEvents"]
    span = next(e for e in events if e["ph"] == "X")
    opened = {k: v for k, v in span.items() if k != "dur"} | {"ph": "B"}
    bad.write_text(json.dumps({"traceEvents": [*events, opened]}))
    assert main(["lint", "--check-trace", str(bad)]) == 1
    assert "INVALID trace" in capsys.readouterr().err
