"""The port's ``model`` (analysis/mrmodel.py) against the JAX package's.

mrmodel drives a package's own Coordinator and JobService under a virtual
clock, so equal documents from the two packages — explored schedules,
prunes, steps, verdict, shrunk counterexample, offending events and chaos
spec — mean the port's control plane makes the reference's decisions on
every explored schedule. Held at each focus on the unmutated tree, and for
every seeded mutation class, at the reference tests' depths and seeds. The
CLI must never load torch, at every focus.
"""

import json
import pathlib
import subprocess
import sys

import pytest

from mapreduce_rust_tpu.analysis import mrmodel as jax_mrmodel
from mapreduce_rust_tpu.analysis.mrcheck import MUTATIONS as JAX_MUTATIONS
from mapreduce_rust_tpu_torch.analysis import mrmodel
from mapreduce_rust_tpu_torch.analysis.chaos import ChaosPlan

REPO = pathlib.Path(__file__).resolve().parents[1]
#: Wall-clock fields: the only ones that may differ between two runs.
TIMING = ("elapsed_s", "schedules_per_s")


def _both(tmp_path, **kw) -> dict:
    docs = []
    for i, module in enumerate((mrmodel, jax_mrmodel)):
        d = tmp_path / str(i)
        d.mkdir()
        doc = module.run_model(workdir=str(d), **kw)
        docs.append(json.dumps({k: v for k, v in doc.items() if k not in TIMING},
                               sort_keys=True, default=str))
    assert docs[0] == docs[1]
    return json.loads(docs[0])


@pytest.mark.parametrize("focus,budget,depth", [
    ("lease", 400, 12), ("pipeline", 300, 12), ("service", 60, 8)])
def test_clean_exploration_matches_reference(tmp_path, focus, budget, depth):
    doc = _both(tmp_path, focus=focus, budget=budget, depth=depth, seed=0)
    assert doc["ok"] and doc["explored"] > 0
    assert doc["model_invariants"] == [
        "no-grant-starvation", "readiness-monotone-per-attempt", "replay-convergence"]


@pytest.mark.parametrize("name", sorted(JAX_MUTATIONS))
def test_mutation_counterexample_matches_reference(tmp_path, name):
    assert sorted(mrmodel.MODEL_MUTATORS) == sorted(jax_mrmodel.MODEL_MUTATORS)
    focus = mrmodel.MUTATION_FOCUS.get(name, "lease")
    assert focus == jax_mrmodel.MUTATION_FOCUS.get(name, "lease")
    doc = _both(tmp_path, focus=focus, budget=5000, depth=12, seed=0, mutate=name)
    assert not doc["ok"]
    ce = doc["counterexamples"][0]
    assert ce["code"] == name and 1 <= ce["length"] <= 8
    plan = ChaosPlan.parse(ce["chaos_spec"])
    assert plan.seed == 0 and plan.faults


def test_other_seed_matches_reference(tmp_path):
    doc = _both(tmp_path, focus="lease", budget=2000, depth=12, seed=3,
                mutate="report-after-revoke")
    assert doc["counterexamples"][0]["code"] == "report-after-revoke"


def test_model_cli_never_loads_torch():
    code = (
        "import sys; from mapreduce_rust_tpu_torch.__main__ import main; "
        "rcs = [main(['model', '--budget', '60', '--depth', '8']), "
        "main(['model', '--focus', 'service', '--budget', '20', '--depth', '6']), "
        "main(['model', '--mutate', 'double-win', '--format', 'json'])]; "
        "bad = [m for m in ('torch', 'jax', 'mapreduce_rust_tpu') if m in sys.modules]; "
        "print('RCS', rcs, 'LOADED', bad); sys.exit(3 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO,
                       env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "mrmodel: ok" in r.stdout
    assert "RCS [0, 0, 1] LOADED []" in r.stdout
