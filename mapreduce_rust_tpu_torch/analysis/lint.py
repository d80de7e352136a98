"""mrlint framework: file discovery, rule driver, suppressions, output.

The port of ``mapreduce_rust_tpu/analysis/lint.py``, copied: the same
finding format, suppressions, baseline and JSON document (``"tool":
"mrlint"``, ``"schema": 1``). What changes is what it lints by default
(the port package and its repo-root siblings) and the trace validator
behind ``--check-trace`` (the port's ``runtime/trace``).

Design constraints:

- **Backend-free and fast.** Pure ``ast`` + stdlib, no torch; each file
  is parsed once and every rule's walk reuses the parsed tree, so linting
  the whole repo takes seconds and can gate tier-1
  (tests/test_torch_lint_clean.py).
- **Zero findings is the contract.** The shipped tree lints clean with an
  EMPTY baseline; anything that must stay gets an inline
  ``# mrlint: ignore[rule] -- reason`` (the reason is mandatory — a bare
  ignore is itself a finding) or a ``.mrlint.json`` baseline entry with a
  ``reason`` field. Suppression without a recorded why is how a fixed
  class of bug gets re-shipped; the format forbids it.
- **Machine-readable.** ``--format json`` emits one stable document
  (findings + suppression accounting) so CI can diff runs; the baseline
  file is itself JSON with the same vocabulary.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
import fnmatch
import json
import os
import re
import sys
import tokenize
from typing import Iterable, Iterator, Sequence


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str           # repo-relative posix path
    line: int           # 1-based
    col: int            # 0-based (ast convention)
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintReport:
    findings: list[Finding]
    suppressed: int = 0              # inline-ignored findings
    baselined: int = 0               # baseline-suppressed findings
    files_checked: int = 0
    unused_baseline: list[dict] = dataclasses.field(default_factory=list)
    parse_errors: list[Finding] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings and not self.parse_errors

    def to_dict(self) -> dict:
        from mapreduce_rust_tpu_torch.analysis.rules import ALL_RULES, PROGRAM_RULES

        return {
            "tool": "mrlint",
            "schema": 1,
            "ok": self.ok,
            "files_checked": self.files_checked,
            "rules": sorted(r.name for r in [*ALL_RULES, *PROGRAM_RULES]),
            "findings": [f.to_dict() for f in self.findings + self.parse_errors],
            "suppressed_inline": self.suppressed,
            "suppressed_baseline": self.baselined,
            "unused_baseline_entries": self.unused_baseline,
        }


# ---------------------------------------------------------------------------
# AST helpers shared by the rules
# ---------------------------------------------------------------------------

def attach_parents(tree: ast.AST) -> None:
    """Annotate every node with ``.mr_parent`` so rules can walk upward
    (enclosing with/try/loop/function) without re-deriving the spine, and
    with ``.mr_children`` so they walk downward without re-deriving each
    node's fields on every one of their passes (:func:`walk`)."""
    for node in ast.walk(tree):
        kids = list(ast.iter_child_nodes(node))
        node.mr_children = kids  # type: ignore[attr-defined]
        for child in kids:
            child.mr_parent = node  # type: ignore[attr-defined]


def children(node: ast.AST) -> list:
    """``ast.iter_child_nodes`` of a node, from the list attach_parents
    cached where there is one."""
    kids = getattr(node, "mr_children", None)
    return kids if kids is not None else list(ast.iter_child_nodes(node))


def walk(node: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` — the same nodes in the same order — over the cached
    child lists. The rules walk every file some forty times, and deriving
    the children anew was most of that cost; a whole module's walk is
    kept on the module after the first."""
    if isinstance(node, ast.Module):
        order = getattr(node, "mr_walk", None)
        if order is None:
            order = node.mr_walk = list(_walk(node))  # type: ignore[attr-defined]
        return iter(order)
    return _walk(node)


def _walk(node: ast.AST) -> Iterator[ast.AST]:
    todo = collections.deque([node])
    while todo:
        node = todo.popleft()
        todo.extend(children(node))
        yield node


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = getattr(node, "mr_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "mr_parent", None)


def qualname(node: ast.AST) -> str:
    """Dotted source name of a Name/Attribute chain ('' for anything else):
    ``jax.jit`` → "jax.jit", ``self.pool.submit`` → "self.pool.submit"."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def last_segment(name: str) -> str:
    """Last dotted segment of a qualname (``"a.b.c"`` → ``"c"``) — the
    ONE suffix-matching helper rules and the dataflow call graph share,
    so their notion of "same callable name" can never drift."""
    return name.rsplit(".", 1)[-1]


def enclosing_function(node: ast.AST) -> "ast.FunctionDef | ast.AsyncFunctionDef | None":
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def enclosing_class(node: ast.AST) -> "ast.ClassDef | None":
    for anc in ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc
    return None


# ---------------------------------------------------------------------------
# Inline suppressions
# ---------------------------------------------------------------------------

# `# mrlint: ignore[rule-a, rule-b] -- reason` (the `--` is optional but the
# reason text is not: an unreasoned ignore does not suppress and is reported).
_IGNORE_RE = re.compile(
    r"#\s*mrlint:\s*ignore\[([A-Za-z0-9_\-, ]+)\]\s*(?:--\s*)?(.*)"
)


def _inline_ignores(src: str, path: str) -> tuple[dict[int, set[str]], list[Finding]]:
    """line → suppressed rule names, plus findings for unreasoned ignores.

    Comments are read with ``tokenize`` (not a line regex) so string
    literals containing the marker don't suppress anything.
    """
    ignores: dict[int, set[str]] = {}
    bad: list[Finding] = []
    try:
        tokens = tokenize.generate_tokens(iter(src.splitlines(True)).__next__)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _IGNORE_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = m.group(2).strip()
            if not reason:
                bad.append(Finding(
                    "bad-suppression", path, tok.start[0], tok.start[1],
                    "inline ignore without a reason — write "
                    "'# mrlint: ignore[rule] -- why it is safe'",
                ))
                continue
            ignores.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenError:
        pass  # the parse error is reported by the main loop
    return ignores, bad


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def load_baseline(path: str) -> list[dict]:
    """``.mrlint.json``: {"suppressions": [{"rule", "path", "reason"}]}.
    Every entry needs all three fields — a reasonless or pathless entry is
    a config error, raised loudly (CI must not silently suppress)."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(
            f"{path}: baseline must be an object with a 'suppressions' list"
        )
    entries = data.get("suppressions", [])
    if not isinstance(entries, list):
        raise ValueError(f"{path}: 'suppressions' must be a list")
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or not all(
            isinstance(e.get(k), str) and e.get(k) for k in ("rule", "path", "reason")
        ):
            raise ValueError(
                f"{path}: suppression #{i} needs non-empty string fields "
                f"'rule', 'path' and 'reason' (got {e!r})"
            )
    return entries


def _baseline_match(entry: dict, finding: Finding) -> bool:
    return (
        (entry["rule"] == "*" or entry["rule"] == finding.rule)
        and fnmatch.fnmatch(finding.path, entry["path"])
    )


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", ".jax_cache", ".bench", "node_modules"}


def discover_files(paths: Sequence[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                out.extend(
                    os.path.join(root, f) for f in sorted(files) if f.endswith(".py")
                )
        elif p.endswith(".py") and os.path.exists(p):
            out.append(p)
    # De-dup while keeping order (a file reachable via two roots).
    seen: set[str] = set()
    uniq = []
    for p in out:
        rp = os.path.realpath(p)
        if rp not in seen:
            seen.add(rp)
            uniq.append(p)
    return uniq


def default_roots() -> list[str]:
    """What ``lint`` checks with no path arguments: the package itself plus
    the repo-root siblings that ship with it (tests, bench, graft entry) —
    derived from the package location, not the CWD, so the gate test checks
    the same tree no matter where pytest runs."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo = os.path.dirname(pkg)
    roots = [pkg]
    for sib in ("tests", "bench_torch.py", "__graft_entry_torch__.py"):
        p = os.path.join(repo, sib)
        if os.path.exists(p):
            roots.append(p)
    return roots


def _rel(path: str) -> str:
    """Repo-relative posix path (stable across machines for baselines)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo = os.path.dirname(pkg)
    try:
        rel = os.path.relpath(os.path.abspath(path), repo)
    except ValueError:  # different drive (windows) — keep as-is
        rel = path
    if rel.startswith(".."):
        rel = path
    return rel.replace(os.sep, "/")


@dataclasses.dataclass
class ParsedFile:
    """One linted file, parsed exactly once: the per-file rules, the
    program rules (via dataflow.Program) and the suppression pass all
    consume this instead of re-reading the source."""

    path: str
    rel: str
    tree: ast.Module
    src: str
    ignores: dict[int, set[str]]


def parse_file(path: str) -> tuple["ParsedFile | None", list[Finding]]:
    """(parsed file, parse/suppression errors). None on a parse failure —
    the error Finding is the record of it."""
    rel = _rel(path)
    try:
        with open(path, "rb") as f:
            src = f.read().decode("utf-8", errors="replace")
        tree = ast.parse(src, filename=path)
    except (OSError, SyntaxError) as e:
        return None, [Finding("parse-error", rel, getattr(e, "lineno", 1) or 1,
                              0, f"cannot lint: {e}")]
    attach_parents(tree)
    ignores, bad_ignores = _inline_ignores(src, rel)
    return ParsedFile(path, rel, tree, src, ignores), bad_ignores


def _suppress(findings: Iterable[Finding],
              ignores: dict[int, set[str]]) -> tuple[list[Finding], int]:
    kept: list[Finding] = []
    suppressed = 0
    for f in sorted(findings, key=lambda f: (f.line, f.col, f.rule)):
        # An ignore suppresses on its own line or the line directly below
        # (comment-above style) — never file-wide.
        cov = ignores.get(f.line, set()) | ignores.get(f.line - 1, set())
        if f.rule in cov or "*" in cov:
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed


def lint_file(path: str, rules: Iterable | None = None) -> tuple[list[Finding], list[Finding], int]:
    """(findings, parse/suppression errors, inline-suppressed count).

    Per-file rules only: the interprocedural program rules need the whole
    file set and run from :func:`lint_paths`."""
    from mapreduce_rust_tpu_torch.analysis.rules import ALL_RULES

    rules = list(rules) if rules is not None else ALL_RULES
    pf, errors = parse_file(path)
    if pf is None:
        return [], errors, 0
    findings: list[Finding] = []
    for rule in rules:
        findings.extend(rule.check(pf.tree, pf.src, pf.rel))
    kept, suppressed = _suppress(findings, pf.ignores)
    return kept, errors, suppressed


def lint_paths(paths: Sequence[str] | None = None,
               baseline: list[dict] | None = None) -> LintReport:
    from mapreduce_rust_tpu_torch.analysis.rules import ALL_RULES, PROGRAM_RULES

    files = discover_files(list(paths) if paths else default_roots())
    report = LintReport(findings=[], files_checked=len(files))
    parsed: list[ParsedFile] = []
    raw: dict[str, list[Finding]] = {}
    for path in files:
        pf, errors = parse_file(path)
        report.parse_errors.extend(errors)
        if pf is None:
            continue
        parsed.append(pf)
        fs = raw.setdefault(pf.rel, [])
        for rule in ALL_RULES:
            fs.extend(rule.check(pf.tree, pf.src, pf.rel))
    if PROGRAM_RULES and parsed:
        # The interprocedural pass: one Program over every parsed file, so
        # the call graph sees helper frames in other modules. Program
        # findings land on their file and obey the SAME inline ignores and
        # baseline as per-file findings.
        from mapreduce_rust_tpu_torch.analysis.dataflow import Program

        program = Program([(pf.rel, pf.tree) for pf in parsed])
        for rule in PROGRAM_RULES:
            for f in rule.run_program(program):
                raw.setdefault(f.path, []).append(f)
    ignores_by_rel = {pf.rel: pf.ignores for pf in parsed}
    used = [0] * len(baseline or [])
    for rel in sorted(raw):
        kept, suppressed = _suppress(raw[rel], ignores_by_rel.get(rel, {}))
        report.suppressed += suppressed
        for f in kept:
            hit = None
            for i, entry in enumerate(baseline or []):
                if _baseline_match(entry, f):
                    hit = i
                    break
            if hit is None:
                report.findings.append(f)
            else:
                used[hit] += 1
                report.baselined += 1
    report.unused_baseline = [
        e for i, e in enumerate(baseline or []) if not used[i]
    ]
    return report


# ---------------------------------------------------------------------------
# CLI (dispatched from mapreduce_rust_tpu_torch.__main__)
# ---------------------------------------------------------------------------

def run_cli(args) -> int:
    """The ``lint`` subcommand body. Exit 0 = clean (suppressions counted,
    not failing); 1 = findings; 2 = config error (bad baseline)."""
    if getattr(args, "check_trace", None):
        return _check_trace(args.check_trace)

    baseline_path = getattr(args, "baseline", None)
    if baseline_path is None and os.path.exists(".mrlint.json"):
        baseline_path = ".mrlint.json"
    try:
        baseline = load_baseline(baseline_path) if baseline_path else None
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"mrlint: bad baseline: {e}", file=sys.stderr)
        return 2

    paths = getattr(args, "paths", None) or None
    if paths and not discover_files(list(paths)):
        # Explicit targets resolving to nothing is a config error, not a
        # clean tree — a mistyped CI path must not pass as "0 findings".
        print(
            f"mrlint: no .py files under {list(paths)!r} — nothing checked",
            file=sys.stderr,
        )
        return 2

    report = lint_paths(paths, baseline)
    # Resolved BEFORE the document prints: under --strict-baseline a
    # stale entry IS the failure, and the JSON "ok" field must agree with
    # the exit code (a CI pipeline gating on the archived document would
    # otherwise record a pass for a failed invocation).
    strict_stale = bool(
        getattr(args, "strict_baseline", False) and report.unused_baseline
    )

    if getattr(args, "format", "text") == "json":
        doc = report.to_dict()
        if strict_stale:
            doc["ok"] = False
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        for f in report.findings + report.parse_errors:
            print(f.format())
        for e in report.unused_baseline:
            print(
                f"mrlint: warning: unused baseline entry "
                f"{e['rule']} @ {e['path']} ({e['reason']})",
                file=sys.stderr,
            )
        n = len(report.findings) + len(report.parse_errors)
        print(
            f"mrlint: {report.files_checked} files, {n} finding(s), "
            f"{report.suppressed} inline-suppressed, "
            f"{report.baselined} baselined"
        )
    if strict_stale:
        # Stale suppressions are debt with interest: an entry nothing
        # matches today will happily swallow a REAL finding at that path
        # tomorrow. --strict-baseline turns the warning into the failure
        # it deserves so CI prunes them at the source.
        print(
            f"mrlint: --strict-baseline: {len(report.unused_baseline)} "
            "unused baseline entr(y/ies) — remove them from the baseline "
            "file",
            file=sys.stderr,
        )
        return 1
    return 0 if report.ok else 1


def _check_trace(path: str) -> int:
    """--check-trace: run the trace validator on a written trace file, so
    trace artifacts are checkable the same way source is
    (validate_events rejects unbalanced B/E pairs and non-numeric
    counter samples)."""
    from mapreduce_rust_tpu_torch.runtime.trace import validate_events

    try:
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        validate_events(events)
    except (OSError, KeyError, ValueError, json.JSONDecodeError) as e:
        print(f"mrlint: {path}: INVALID trace — {e}", file=sys.stderr)
        return 1
    print(f"mrlint: {path}: valid trace ({len(events)} events)")
    return 0
