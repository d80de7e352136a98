"""The port's mrlint (analysis/lint.py, rules.py, dataflow.py) against the
JAX package's.

Parity: every snippet that tests/test_lint.py hands one of its fixture
helpers as a string is found by walking that file's AST, written where the
helper writes it (under ``mapreduce_rust_tpu/`` for the package-scoped
rules), and linted by both packages' ``lint_paths``: the sorted
``(rule, line, col)`` lists and the suppression counts must be equal. The
five ``_program`` sources of its dataflow units go through both packages'
``Program``, ``guarded_reach`` and ``origins`` and must describe the same
CFGs, definitions, call edges, guards and origins.

The six rules keyed on JAX names carry torch twins: each fires on a BAD
snippet (the PyTorch form of its hazard) with PyTorch wording, and stays
silent on a GOOD one modelled on the port's own code. The framework's
suppression, baseline and JSON mechanics are held on the port's CLI.
"""

import ast
import json
import pathlib
import textwrap

import pytest

from mapreduce_rust_tpu.analysis import dataflow as ref_dataflow
from mapreduce_rust_tpu.analysis import lint as ref_lint
from mapreduce_rust_tpu.analysis.rules import ALL_RULES as REF_RULES
from mapreduce_rust_tpu.analysis.rules import PROGRAM_RULES as REF_PROGRAM_RULES
from mapreduce_rust_tpu_torch.__main__ import main
from mapreduce_rust_tpu_torch.analysis import dataflow
from mapreduce_rust_tpu_torch.analysis import lint
from mapreduce_rust_tpu_torch.analysis.lint import lint_file, lint_paths, load_baseline

LINT_TESTS = pathlib.Path(__file__).with_name("test_lint.py")

#: test_lint.py's fixture helpers: (directory they write under, default
#: file name — None where the caller always passes the path).
_HELPERS = {
    "run_lint": ("", "snippet.py"),
    "rules_fired": ("", "snippet.py"),
    "program_rules_fired": ("", "snippet.py"),
    "run_lint_in_package": ("mapreduce_rust_tpu", "worker.py"),
    "run_lint_in_pkg_path": ("mapreduce_rust_tpu", None),
}


def _calls(fn: ast.AST, name: str) -> list[ast.Call]:
    return sorted(
        (n for n in ast.walk(fn) if isinstance(n, ast.Call)
         and isinstance(n.func, ast.Name) and n.func.id == name),
        key=lambda n: (n.lineno, n.col_offset))


def _fixture_snippets() -> list:
    """pytest params (relative path, source) of every string snippet
    test_lint.py passes to a fixture helper, in file order."""
    tree = ast.parse(LINT_TESTS.read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        calls = sorted(
            (c for h in _HELPERS for c in _calls(fn, h)),
            key=lambda n: (n.lineno, n.col_offset))
        for k, call in enumerate(calls):
            if len(call.args) < 2 or not isinstance(call.args[1], ast.Constant) \
                    or not isinstance(call.args[1].value, str):
                continue
            sub, default = _HELPERS[call.func.id]
            named = call.args[2] if len(call.args) > 2 else next(
                (kw.value for kw in call.keywords), None)
            name = named.value if named is not None else default
            rel = f"{sub}/{name}" if sub else name
            out.append(pytest.param(rel, call.args[1].value, id=f"{fn.name}-{k}"))
    return out


def _dataflow_sources() -> list:
    tree = ast.parse(LINT_TESTS.read_text())
    return [pytest.param(c.args[0].value, id=f"program-{i}")
            for i, c in enumerate(_calls(tree, "_program"))]


_SNIPPETS = _fixture_snippets()


def _key(report) -> list:
    return sorted((f.rule, f.line, f.col)
                  for f in report.findings + report.parse_errors)


def test_every_fixture_snippet_is_collected():
    # 104 string snippets and five dataflow sources in test_lint.py.
    assert len(_SNIPPETS) >= 104
    assert len(_dataflow_sources()) >= 5


@pytest.mark.parametrize("rel,src", _SNIPPETS)
def test_fixture_snippet_parity(tmp_path, rel, src):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    ref = ref_lint.lint_paths([str(p)])
    port = lint_paths([str(p)])
    assert _key(port) == _key(ref)
    assert (port.suppressed, port.files_checked) == (ref.suppressed, ref.files_checked)


def _describe(dataflow_mod, lint_mod, src: str) -> list[dict]:
    """Everything the dataflow layer derives from ``src``, in plain data."""
    tree = ast.parse(textwrap.dedent(src))
    lint_mod.attach_parents(tree)
    prog = dataflow_mod.Program([("snippet.py", tree)])
    out = []
    for fu in prog.functions:
        cfg = fu.cfg
        defs, reach = fu.rd
        callees = prog.callees(fu)
        loads = [n for n in ast.walk(fu.node)
                 if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)]
        out.append({
            "unit": (fu.name, fu.qualname, fu.path, fu.is_async),
            "succ": {i: sorted(v) for i, v in cfg.succ.items()},
            "defs": [(d.name, d.node, ast.dump(d.value) if d.value else None)
                     for d in defs],
            "reach": {i: sorted(v) for i, v in reach.items()},
            "callees": [(c.lineno, c.col_offset, t.qualname if t else None)
                        for c, t in callees],
            "guarded": [dataflow_mod.guarded_reach(cfg, c, "_backends")
                        for c, _t in callees],
            "origins": [[ast.dump(o) if o is not None else None
                         for o in dataflow_mod.origins(cfg, defs, reach, n)]
                        for n in loads],
            "reachable": [(t.qualname, [(f.qualname, c.lineno) for f, c in chain])
                          for t, chain in prog.reachable(fu)],
        })
    return out


@pytest.mark.parametrize("src", _dataflow_sources())
def test_dataflow_parity(src):
    port = _describe(dataflow, lint, src)
    assert port and port == _describe(ref_dataflow, ref_lint, src)


# ---------------------------------------------------------------------------
# The torch twins: (BAD snippet, the findings it raises as (line, the name
# the message quotes), GOOD snippet modelled on the port), and the words
# every torch finding of the rule carries.
# ---------------------------------------------------------------------------

TORCH_WORDING = {
    "donation-safety": "CUDA event",
    "a2a-purity": "waits for the card",
    "jit-in-loop": "on the card",
    "psum-replicated-flag": "world size",
    "backend-init-in-probe": "torch.cuda.is_initialized()",
    "device-dispatch-in-consumer": "host-to-device",
}

TWINS = {
    "donation-safety": ("""
        import torch

        class Stager:
            def __init__(self, device):
                self.device = device
                self.host = torch.empty(16, pin_memory=True)
                self.dev = torch.empty(16, device=device)

            def to_device(self):
                return self.host.to(self.device, non_blocking=True)

            def refill(self):
                self.dev.copy_(self.host, non_blocking=True)
                return self.dev
    """, [(11, "'self.host'"), (14, "'self.host'")], """
        import torch

        class PackStager:
            def __init__(self, cap, device):
                self.device = device
                self.needs_barrier = device.type != "cpu"
                self.host = torch.full((1 + 3 * cap,), -1, dtype=torch.int32,
                                       pin_memory=self.needs_barrier)
                self._copied = torch.cuda.Event() if self.needs_barrier else None
                self._pending = False

            def to_device(self):
                if not self.needs_barrier:
                    return self.host.clone()
                flat_dev = self.host.to(self.device, non_blocking=True)
                self._copied.record()
                self._pending = True
                return flat_dev

            def snapshot(self):
                return self.host.to(self.device)


        def to_device(data, device):
            host = torch.from_numpy(data)
            if device.type == "cpu":
                return host, host
            host = host.pin_memory()
            return host, host.to(device, non_blocking=True)
    """),
    "a2a-purity": ("""
        import torch

        def replay(stats, host, wide, acc):
            with _a2a_span(stats, round=stats.mesh_rounds, tier="replay"):
                kvs = wide(host)
                n = int(kvs.valid.sum().item())
                torch.cuda.synchronize()
                acc.extend(kvs.keys.cpu().tolist())
            return n
    """, [(7, "'.item'"), (8, "'torch.cuda.synchronize'"), (9, "'.tolist'"),
          (9, "'kvs.keys.cpu'")], """
        def replay(stats, host, mesh, wide, wide_merge, state, acc, doc_id, d):
            with _a2a_span(stats, round=stats.mesh_rounds, tier="replay",
                           wire_bytes=0):
                kvs, _trunc = tokenize(_ship(host, mesh))
                local, _p, _b = wide(kvs, [doc_id] * d)
                state, evicted, ev_counts = wide_merge(state, local)
            _replay_readback(stats, acc, evicted, ev_counts)
            return int(ev_counts.sum().item())
    """),
    "jit-in-loop": ("""
        import torch
        from torch import compile

        def per_window(windows, step):
            for w in windows:
                fast = torch.compile(step)
                fast(w)

        def per_chunk(chunks, step):
            while chunks:
                @torch.compile
                def body(c):
                    return step(c)
                body(chunks.pop())

        def per_round(rounds, step):
            for r in rounds:
                compile(step)(r)
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    step(r)
    """, [(7, "torch.compile"), (13, "torch.compile"), (19, "torch.compile"),
          (20, "torch.cuda.CUDAGraph"), (21, "torch.cuda.graph")], """
        import re

        import torch

        def make_step(step):
            return torch.compile(step)

        def scan(lines, step):
            fast = make_step(step)
            out = []
            for line in lines:
                pat = re.compile(r"\\w+")
                code = compile(line, "<line>", "exec")
                out.append((pat.findall(line), code, fast(line)))
            return out
    """),
    "psum-replicated-flag": ("""
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol

        def round_flags(vec):
            dist.all_reduce(vec)
            replay = vec[1] + vec[2]
            dist.all_reduce(vec)
            return replay

        def totals(x, group):
            total = funcol.all_reduce(x, "sum", group)
            return funcol.all_reduce(total, "sum", group)
    """, [(8, "'vec'"), (13, "'total'")], """
        import functools

        import torch
        import torch.distributed as dist

        @functools.lru_cache(maxsize=8)
        def make_round_fn(mesh):
            def round_sum(vec):
                dist.all_reduce(vec)
                return vec

            return round_sum

        def map_shuffle(have, p_ovf, b_ovf, mesh):
            round_sum = make_round_fn(mesh)
            flag = torch.tensor(have, dtype=torch.int32).to(mesh.home, non_blocking=True)
            totals = round_sum(torch.stack([flag, p_ovf.sum(dtype=torch.int32),
                                            b_ovf.sum(dtype=torch.int32)]))
            return (totals[1] + totals[2]) == 0

        def two_rounds(vec, fresh):
            dist.all_reduce(vec)
            vec = fresh()
            dist.all_reduce(vec)
            return vec
    """),
    "backend-init-in-probe": ("""
        import torch
        import torch.distributed as dist

        def device_gauge(stats):
            stats.device_name = torch.cuda.get_device_name(0)

        def sample_memory(stats):
            if not dist.is_initialized():
                return
            stats.high = torch.cuda.max_memory_allocated()

        def probe_card(stats):
            _read(stats)

        def _read(stats):
            free, total = torch.cuda.mem_get_info()
            stats.free = free
    """, [(6, "'torch.cuda.get_device_name'"),
          (11, "'torch.cuda.max_memory_allocated'"),
          (17, "'torch.cuda.mem_get_info'")], """
        import sys

        import torch

        def platform_info():
            info = {}
            torch = sys.modules.get("torch")
            if torch is not None:
                try:
                    if not torch.cuda.is_initialized():
                        return info
                    dev = torch.cuda.current_device()
                    info["device_name"] = torch.cuda.get_device_name(dev)
                    info["device_memory_bytes"] = int(
                        torch.cuda.get_device_properties(dev).total_memory)
                    dist = torch.distributed
                    info["process_count"] = (
                        dist.get_world_size()
                        if dist.is_available() and dist.is_initialized() else 1)
                except Exception:
                    info["backend"] = "unavailable"
            return info

        def _sample_device_memory(stats):
            try:
                if not torch.cuda.is_initialized():
                    return
                n = torch.cuda.device_count()
                high = max(int(torch.cuda.max_memory_allocated(i)) for i in range(n))
                stats.device_mem_high_bytes = max(high, stats.device_mem_high_bytes)
            except Exception:
                pass

        class Worker:
            def _sample_memory(self):
                torch = sys.modules.get("torch")
                if torch is None or not torch.cuda.is_initialized():
                    return
                _sample_device_memory(self.stats)

        def probe_device_peaks():
            torch = sys.modules.get("torch")
            if torch is None:
                return []
            try:
                if not torch.cuda.is_initialized():
                    return []
                return [torch.cuda.get_device_name(i)
                        for i in range(torch.cuda.device_count())]
            except Exception:
                return []
    """),
    "device-dispatch-in-consumer": ("""
        import torch

        class Router:
            def consume(self, window):
                keys = torch.from_numpy(window.keys).to(self.device, non_blocking=True)
                self.merge(keys)

            def route_raw(self, raw):
                return raw.cuda()

        def _fold_one(shard, rows, dev):
            return _stage(rows, dev)

        def _stage(rows, dev):
            return torch.as_tensor(rows, device=dev)
    """, [(6, "'.to(device)'"), (10, "'.cuda()'"),
          (16, "'torch.as_tensor(device=...)'")], """
        import torch

        class DispatchPlane:
            def submit(self, window):
                return window.keys.to(self.device, non_blocking=True)

        class Router:
            def consume(self, window):
                counts = window.counts.to(torch.int64)
                self.plane.submit(window)
                return counts

        def upload(rows, dev):
            return torch.tensor(rows, device=dev)
    """),
}


def _lint_snippet(tmp_path, src):
    p = tmp_path / "snippet.py"
    p.write_text(textwrap.dedent(src))
    report = lint_paths([str(p)])
    assert not report.parse_errors, report.parse_errors
    return report


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_fires_on_bad(tmp_path, rule):
    bad, expected, _good = TWINS[rule]
    report = _lint_snippet(tmp_path, bad)
    got = sorted((f.line, f.message) for f in report.findings)
    assert {f.rule for f in report.findings} == {rule}, got
    assert [line for line, _m in got] == [line for line, _w in expected], got
    for (line, message), (_line, name) in zip(got, sorted(expected)):
        assert name in message, (line, message)
        assert TORCH_WORDING[rule] in message, (line, message)
    # The JAX package's rule does not see the PyTorch form.
    assert ref_lint.lint_paths([str(tmp_path / "snippet.py")]).findings == []


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twin_silent_on_good(tmp_path, rule):
    _bad, _expected, good = TWINS[rule]
    assert _lint_snippet(tmp_path, good).findings == []


@pytest.mark.parametrize("package", ["mapreduce_rust_tpu_torch", "mapreduce_rust_tpu"])
def test_package_scoped_rules_cover_both_names(tmp_path, package):
    pool = tmp_path / package / "ops" / "build.py"
    pool.parent.mkdir(parents=True)
    pool.write_text(textwrap.dedent("""
        from concurrent.futures import ThreadPoolExecutor

        def build_all(sources, build):
            with ThreadPoolExecutor(max_workers=len(sources)) as pool:
                return list(pool.map(build, sources))
    """))
    digest = """
        import hashlib

        def identity(chunk_bytes):
            return hashlib.sha256(chunk_bytes).hexdigest()[:16]
    """
    for rel in ("runtime/cache.py", "runtime/lineage.py"):
        p = tmp_path / package / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(digest))
    report = lint_paths([str(tmp_path / package)])
    assert sorted((f.rule, f.path.rsplit("/", 1)[-1]) for f in report.findings) == [
        ("ad-hoc-corpus-digest", "cache.py"), ("unnamed-plane-thread", "build.py")]


# ---------------------------------------------------------------------------
# The framework: suppressions, baseline, JSON, exit codes.
# ---------------------------------------------------------------------------

BAD_SNIPPET = """
    def shard(dictionary):
        return list(dictionary.items())
"""


def test_inline_ignore_with_reason_suppresses(tmp_path):
    p = tmp_path / "snippet.py"
    p.write_text(textwrap.dedent("""
        def shard(dictionary):
            # mrlint: ignore[spilled-dict-api] -- provably RAM-only here
            return list(dictionary.items())
    """))
    findings, errors, suppressed = lint_file(str(p))
    assert findings == [] and errors == [] and suppressed == 1


def test_inline_ignore_without_reason_is_reported(tmp_path):
    p = tmp_path / "snippet.py"
    p.write_text(textwrap.dedent("""
        MARKER = "# mrlint: ignore[spilled-dict-api] -- not a comment"

        def shard(dictionary):
            # mrlint: ignore[spilled-dict-api]
            return list(dictionary.items())
    """))
    findings, errors, suppressed = lint_file(str(p))
    assert [f.rule for f in findings] == ["spilled-dict-api"] and suppressed == 0
    assert [e.rule for e in errors] == ["bad-suppression"]


def test_baseline_suppresses_and_tracks_unused(tmp_path):
    p = tmp_path / "legacy.py"
    p.write_text(textwrap.dedent(BAD_SNIPPET))
    baseline = [
        {"rule": "spilled-dict-api", "path": "*legacy.py",
         "reason": "grandfathered until the shard rewrite"},
        {"rule": "jit-in-loop", "path": "*never.py", "reason": "unused"},
    ]
    report = lint_paths([str(p)], baseline)
    assert report.ok and report.baselined == 1
    assert [e["path"] for e in report.unused_baseline] == ["*never.py"]


@pytest.mark.parametrize("doc", [
    {"suppressions": [{"rule": "jit-in-loop", "path": "*"}]},
    [{"rule": "x"}],
])
def test_bad_baseline_is_a_config_error(tmp_path, capsys, doc):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="reason|suppressions"):
        load_baseline(str(bad))
    (tmp_path / "clean.py").write_text("X = 1\n")
    assert main(["lint", str(tmp_path / "clean.py"), "--baseline", str(bad)]) == 2
    assert "bad baseline" in capsys.readouterr().err


def test_baseline_file_is_loaded_from_the_cwd(tmp_path, monkeypatch, capsys):
    (tmp_path / "legacy.py").write_text(textwrap.dedent(BAD_SNIPPET))
    assert main(["lint", str(tmp_path / "legacy.py")]) == 1
    (tmp_path / ".mrlint.json").write_text(json.dumps({"suppressions": [
        {"rule": "spilled-dict-api", "path": "*legacy.py", "reason": "RAM-only"}]}))
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    assert main(["lint", "legacy.py"]) == 0
    assert "1 baselined" in capsys.readouterr().out


def test_strict_baseline_promotes_unused_entries(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("X = 1\n")
    baseline = tmp_path / ".mrlint.json"
    baseline.write_text(json.dumps({"suppressions": [
        {"rule": "jit-in-loop", "path": "*gone.py",
         "reason": "stale suppression nothing matches"},
    ]}))
    assert main(["lint", str(clean), "--baseline", str(baseline)]) == 0
    capsys.readouterr()
    assert main(["lint", str(clean), "--baseline", str(baseline),
                 "--strict-baseline", "--format", "json"]) == 1
    out = capsys.readouterr()
    assert json.loads(out.out)["ok"] is False
    assert "unused baseline" in out.err


def test_json_report_schema(tmp_path, capsys):
    p = tmp_path / "legacy.py"
    p.write_text(textwrap.dedent(BAD_SNIPPET))
    assert main(["lint", str(p), "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    ref = ref_lint.lint_paths([str(p)]).to_dict()
    assert set(doc) == set(ref)
    assert doc["tool"] == "mrlint" and doc["schema"] == 1
    assert doc["ok"] is False and doc["files_checked"] == 1
    assert doc["rules"] == sorted(r.name for r in [*REF_RULES, *REF_PROGRAM_RULES])
    assert len(doc["rules"]) == 24
    (f,) = doc["findings"]
    assert set(f) == {"rule", "path", "line", "col", "message"}
    assert (f["rule"], f["line"], f["col"]) == (
        ref["findings"][0]["rule"], ref["findings"][0]["line"], ref["findings"][0]["col"])


def test_cli_exits_2_when_explicit_paths_match_nothing(tmp_path, capsys):
    assert main(["lint", str(tmp_path / "nonexistent")]) == 2
    assert "nothing checked" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main(["lint", str(empty)]) == 2


def test_parse_error_is_a_finding_not_a_crash(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def broken(:\n")
    report = lint_paths([str(p)])
    assert not report.ok
    assert [e.rule for e in report.parse_errors] == ["parse-error"]
