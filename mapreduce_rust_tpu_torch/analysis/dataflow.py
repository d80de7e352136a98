"""Shared intraprocedural dataflow/CFG layer + package call graph for
mrlint — the port of ``mapreduce_rust_tpu/analysis/dataflow.py``, copied.

The per-rule AST matchers (rules.py) prove *shape*: a call sits inside a
with-block, a kwarg is present. What they cannot prove is *flow* — that a
value assigned three statements ago reaches this loop, that every path
from the function entry to a device probe passes a guard, that a blocking
call is reachable from an ``async def`` through two helper frames. This
module gives rules those three primitives:

- :class:`CFG` — a statement-level control-flow graph per function
  (if/while/for/try/with/return/raise/break/continue modeled; every
  try-body statement also edges to its handlers, which is what makes
  guard-inside-try analysis sound for the shipped probe pattern).
- :func:`reaching_defs` — the classic worklist analysis over that CFG:
  which assignments reach each statement. :func:`origins` follows copy
  chains (``y = x``) through it, so a rule can ask "what expression did
  this name originally come from?".
- :func:`guarded_reach` — branch-sensitive guard analysis: is a target
  statement reachable only on paths where a test mentioning ``ident``
  held true? (The ``xla_bridge._backends`` early-return idiom.)
- :class:`Program` / :class:`CallGraph` — all linted files parsed once,
  functions indexed, call edges resolved conservatively by name (same
  class first, then module, then package-unique), with callables that are
  only *passed* to an executor (``run_in_executor``/``submit``/
  ``Thread(target=...)``) excluded from an async caller's edges — handing
  work to a pool thread is exactly how blocking code legally coexists
  with an event loop.

Pure ``ast`` + stdlib, like the rest of the analyzer.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator

from mapreduce_rust_tpu_torch.analysis.lint import children, qualname, walk
from mapreduce_rust_tpu_torch.analysis.lint import last_segment as _last_segment


# ---------------------------------------------------------------------------
# Control-flow graph
# ---------------------------------------------------------------------------

class CFG:
    """Statement-level CFG of one function body.

    Nodes are ast statements (indexed); ``succ[i]`` holds (j, label)
    edges where label is "true"/"false" for an If's branch edges and ""
    otherwise. ``EXIT`` (-1) is the single sink (returns, raises, falling
    off the end)."""

    EXIT = -1

    def __init__(self, fn: "ast.FunctionDef | ast.AsyncFunctionDef") -> None:
        self.fn = fn
        self.nodes: list[ast.stmt] = []
        self.succ: dict[int, list[tuple[int, str]]] = {}
        self.index: dict[int, int] = {}  # id(stmt) -> node index
        self._loop_stack: list[tuple[list[int], list[int]]] = []
        frontier = self._build(fn.body, ["entry"])
        self._connect(frontier, self.EXIT)

    # frontier: list of (node, label) pairs awaiting their successor; the
    # sentinel "entry" stands for the function entry.

    def _add(self, stmt: ast.stmt) -> int:
        i = len(self.nodes)
        self.nodes.append(stmt)
        self.index[id(stmt)] = i
        self.succ[i] = []
        return i

    def _connect(self, frontier, target: int) -> None:
        for item in frontier:
            if item == "entry":
                continue  # entry's successor is implicit (first node)
            src, label = item
            self.succ[src].append((target, label))

    def _build(self, stmts: list[ast.stmt], frontier: list) -> list:
        for stmt in stmts:
            # Statements after a terminator (return/raise/...) leave an
            # empty frontier: they are still recorded so defs inside them
            # exist, but nothing flows in.
            i = self._add(stmt)
            self._connect(frontier, i)
            frontier = self._stmt(stmt, i)
        return frontier

    def _stmt(self, stmt: ast.stmt, i: int) -> list:
        if isinstance(stmt, (ast.Return, ast.Raise)):
            self.succ[i].append((self.EXIT, ""))
            return []
        if isinstance(stmt, ast.Break):
            if self._loop_stack:
                self._loop_stack[-1][0].append(i)
            return []
        if isinstance(stmt, ast.Continue):
            if self._loop_stack:
                self._loop_stack[-1][1].append(i)
            return []
        if isinstance(stmt, ast.If):
            body_exit = self._build(stmt.body, [(i, "true")])
            if stmt.orelse:
                else_exit = self._build(stmt.orelse, [(i, "false")])
            else:
                else_exit = [(i, "false")]
            return body_exit + else_exit
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            self._loop_stack.append(([], []))
            label = "true" if isinstance(stmt, ast.While) else ""
            body_exit = self._build(stmt.body, [(i, label)])
            breaks, continues = self._loop_stack.pop()
            # Back edges: body exit + continues loop to the header.
            self._connect(body_exit, i)
            for c in continues:
                self.succ[c].append((i, ""))
            out = [(i, "false" if isinstance(stmt, ast.While) else "")]
            out += [(b, "") for b in breaks]
            if stmt.orelse:
                out = self._build(stmt.orelse, out)
            return out
        if isinstance(stmt, ast.Try):
            body_exit = self._build(stmt.body, [(i, "")])
            body_nodes = [
                j for j in range(i + 1, len(self.nodes))
                if any(self.nodes[j] is s or self._contains(s, self.nodes[j])
                       for s in stmt.body)
            ]
            out = []
            for handler in stmt.handlers:
                h_entry: list = [(i, "")]
                # An exception can surface at ANY statement of the try
                # body: every body node edges into every handler head.
                h_frontier = h_entry + [(j, "") for j in body_nodes]
                out += self._build(handler.body, h_frontier)
            if stmt.orelse:
                body_exit = self._build(stmt.orelse, body_exit)
            out += body_exit
            if stmt.finalbody:
                out = self._build(stmt.finalbody, out)
            return out
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._build(stmt.body, [(i, "")])
        # Plain statement (incl. nested function/class defs: opaque).
        return [(i, "")]

    @staticmethod
    def _contains(root: ast.stmt, node: ast.stmt) -> bool:
        return any(n is node for n in walk(root))

    def node_of(self, sub: ast.AST) -> "int | None":
        """CFG node whose statement contains ``sub`` (None for nodes in
        nested function scopes, which get their own CFG)."""
        cur = sub
        while cur is not None:
            i = self.index.get(id(cur))
            if i is not None:
                return i
            cur = getattr(cur, "mr_parent", None)
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and cur is not self.fn:
                return None
        return None

    def preds(self) -> dict[int, list[tuple[int, str]]]:
        p: dict[int, list[tuple[int, str]]] = {i: [] for i in self.succ}
        p[self.EXIT] = []
        for i, outs in self.succ.items():
            for j, label in outs:
                p.setdefault(j, []).append((i, label))
        return p


# ---------------------------------------------------------------------------
# Reaching definitions
# ---------------------------------------------------------------------------

def _def_targets(stmt: ast.stmt) -> Iterator[tuple[str, "ast.expr | None"]]:
    """(name, value-expr) pairs a statement defines. Value None = opaque
    (for-loop targets, with-as, aug-assign reads its own prior value)."""
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            for name in _target_names(t):
                yield name, stmt.value
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        for name in _target_names(stmt.target):
            yield name, stmt.value
    elif isinstance(stmt, ast.AugAssign):
        for name in _target_names(stmt.target):
            yield name, None
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        for name in _target_names(stmt.target):
            yield name, None
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            if item.optional_vars is not None:
                for name in _target_names(item.optional_vars):
                    yield name, None


def _target_names(t: ast.expr) -> Iterator[str]:
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for el in t.elts:
            yield from _target_names(el)
    elif isinstance(t, ast.Starred):
        yield from _target_names(t.value)


@dataclasses.dataclass
class Def:
    name: str
    node: int                  # CFG node of the defining statement
    value: "ast.expr | None"   # RHS when it is a simple binding


def reaching_defs(cfg: CFG) -> tuple[list[Def], dict[int, set[int]]]:
    """(all defs, node -> def-ids reaching its ENTRY) — the textbook
    worklist, at statement granularity. Parameters are def -1 (opaque)."""
    defs: list[Def] = []
    gen: dict[int, set[int]] = {}
    kill_names: dict[int, set[str]] = {}
    for i, stmt in enumerate(cfg.nodes):
        g: set[int] = set()
        names: set[str] = set()
        for name, value in _def_targets(stmt):
            d = len(defs)
            defs.append(Def(name, i, value))
            g.add(d)
            names.add(name)
        gen[i] = g
        kill_names[i] = names
    by_name: dict[str, set[int]] = {}
    for d_id, d in enumerate(defs):
        by_name.setdefault(d.name, set()).add(d_id)
    preds = cfg.preds()
    IN: dict[int, set[int]] = {i: set() for i in range(len(cfg.nodes))}
    OUT: dict[int, set[int]] = {}
    for i in range(len(cfg.nodes)):
        OUT[i] = set(gen[i])
    changed = True
    while changed:
        changed = False
        for i in range(len(cfg.nodes)):
            new_in: set[int] = set()
            for p, _label in preds.get(i, []):
                if p >= 0:
                    new_in |= OUT[p]
            if new_in != IN[i]:
                IN[i] = new_in
            survivors = {
                d for d in new_in if defs[d].name not in kill_names[i]
                # A def of the same name in the same statement kills it —
                # except the statement's own gen, added back below.
            }
            new_out = survivors | gen[i]
            if new_out != OUT[i]:
                OUT[i] = new_out
                changed = True
    return defs, IN


def origins(cfg: CFG, defs: list[Def], reach_in: dict[int, set[int]],
            name_node: ast.Name, max_hops: int = 8) -> list["ast.expr | None"]:
    """Origin expressions of a Name load: its reaching definitions'
    values, with copy chains (``y = x``) followed through further
    reaching definitions. ``None`` entries mean an opaque origin (loop
    target, parameter, augmented assignment)."""
    node = cfg.node_of(name_node)
    if node is None:
        return [None]
    out: list["ast.expr | None"] = []
    seen: set[tuple[int, str]] = set()

    def walk(at: int, name: str, hops: int) -> None:
        if (at, name) in seen or hops > max_hops:
            return
        seen.add((at, name))
        hit = False
        for d_id in reach_in.get(at, ()):
            d = defs[d_id]
            if d.name != name:
                continue
            hit = True
            if isinstance(d.value, ast.Name):
                walk(d.node, d.value.id, hops + 1)
            else:
                out.append(d.value)
        if not hit:
            out.append(None)  # parameter / nonlocal / global: opaque

    walk(node, name_node.id, 0)
    return out


# ---------------------------------------------------------------------------
# Branch-sensitive guard analysis
# ---------------------------------------------------------------------------

def _guard_polarity(test: ast.expr, ident: str,
                    call_guard=None) -> "str | None":
    """"true-means-present" / "true-means-absent" when the test is a
    simple (possibly negated) mention of ``ident`` — or a (possibly
    negated) call that ``call_guard(call)`` accepts; None when the test is
    too complex to trust (conservative: no guard credit)."""
    neg = False
    while isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        neg = not neg
        test = test.operand
    if call_guard is not None and isinstance(test, ast.Call) \
            and call_guard(test):
        return "true-means-absent" if neg else "true-means-present"
    # Only a BARE mention carries trustworthy polarity: a comparison or
    # call form (`len(x._backends) == 0`) mentions the ident but its
    # truth value means the opposite of the bare idiom — guessing would
    # block the wrong branch edge and flag correctly guarded code.
    if not isinstance(test, (ast.Name, ast.Attribute)):
        return None
    if ident not in (getattr(test, "attr", "") or "") \
            and ident not in (getattr(test, "id", "") or ""):
        return None
    return "true-means-absent" if neg else "true-means-present"


def guarded_reach(cfg: CFG, target: ast.AST, ident: str,
                  call_guard=None) -> bool:
    """True iff every entry path to ``target``'s statement passes a
    branch where a simple test on ``ident`` held TRUE (e.g. the
    ``if not xla_bridge._backends: return`` early exit, or nesting under
    ``if xla_bridge._backends:``). Reachability with the guarded edges
    removed decides it: still reachable -> unguarded. ``call_guard``, a
    predicate on a Call, lets a guarding call count as well (the port's
    ``if not torch.cuda.is_initialized(): return``)."""
    t = cfg.node_of(target)
    if t is None:
        return False
    # Remove every guard-HOLDING edge (the branch taken when the test
    # proves the guard); if the target is then unreachable, every real
    # path needed one of those edges — i.e. the guard dominates it.
    blocked: set[tuple[int, int]] = set()
    for i, stmt in enumerate(cfg.nodes):
        if not isinstance(stmt, (ast.If, ast.While)):
            continue
        pol = _guard_polarity(stmt.test, ident, call_guard)
        if pol is None:
            continue
        ok_label = "true" if pol == "true-means-present" else "false"
        for j, label in cfg.succ[i]:
            if label == ok_label:
                blocked.add((i, j))
    if not cfg.nodes:
        return False
    seen = {0}
    stack = [0]
    while stack:
        i = stack.pop()
        if i == t:
            return False  # reachable without the guard holding
        for j, _label in cfg.succ.get(i, []):
            if j >= 0 and (i, j) not in blocked and j not in seen:
                seen.add(j)
                stack.append(j)
    return True  # unreachable without the guard holding -> guarded


# ---------------------------------------------------------------------------
# Package-level program + call graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FunctionUnit:
    """One function/method in the linted program."""

    node: "ast.FunctionDef | ast.AsyncFunctionDef"
    name: str
    qualname: str        # "Class.method" or bare function name
    path: str            # repo-relative path
    is_async: bool
    _cfg: "CFG | None" = None
    _rd: "tuple | None" = None

    @property
    def cfg(self) -> CFG:
        if self._cfg is None:
            self._cfg = CFG(self.node)
        return self._cfg

    @property
    def rd(self) -> tuple:
        if self._rd is None:
            self._rd = reaching_defs(self.cfg)
        return self._rd


#: Callables whose function-valued ARGUMENTS are dispatched elsewhere
#: (another thread / a pool), not called in the enclosing context.
EXECUTOR_SINKS = frozenset({
    "run_in_executor", "submit", "map", "Thread", "Timer", "start_new_thread",
    "call_soon_threadsafe", "to_thread", "Process",
})


class Program:
    """Every linted file parsed once, functions indexed, call edges
    resolvable — the shared substrate the interprocedural rules run on."""

    def __init__(self, files: list[tuple[str, ast.Module]]) -> None:
        self.files = files
        self.functions: list[FunctionUnit] = []
        self.by_name: dict[str, list[FunctionUnit]] = {}
        self.by_qualname: dict[str, list[FunctionUnit]] = {}
        self._callees_cache: dict[int, list] = {}
        for path, tree in files:
            for node in walk(tree):
                if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                cls = None
                cur = getattr(node, "mr_parent", None)
                while cur is not None and cls is None:
                    if isinstance(cur, ast.ClassDef):
                        cls = cur.name
                    cur = getattr(cur, "mr_parent", None)
                qn = f"{cls}.{node.name}" if cls else node.name
                fu = FunctionUnit(
                    node=node, name=node.name, qualname=qn, path=path,
                    is_async=isinstance(node, ast.AsyncFunctionDef),
                )
                self.functions.append(fu)
                self.by_name.setdefault(node.name, []).append(fu)
                self.by_qualname.setdefault(qn, []).append(fu)

    def _executor_arg_ids(self, fn: ast.AST) -> set[int]:
        """ids of nodes whose EVALUATION happens on another thread
        because they were handed to an executor sink: the callable
        reference itself, and the whole body of a lambda argument
        (``run_in_executor(None, lambda: heavy())`` defers ``heavy`` to
        the pool). Eagerly-evaluated argument calls stay in —
        ``submit(build_payload())`` runs ``build_payload`` on the
        CALLER's thread before the handoff ever happens, so it is a real
        callee of an async caller."""
        out: set[int] = set()
        for n in walk(fn):
            if not isinstance(n, ast.Call):
                continue
            if _last_segment(qualname(n.func)) not in EXECUTOR_SINKS:
                continue
            for a in list(n.args) + [kw.value for kw in n.keywords]:
                if isinstance(a, ast.Lambda):
                    out.update(id(x) for x in walk(a))
                elif not isinstance(a, ast.Call):
                    out.add(id(a))
        return out

    def callees(self, fu: FunctionUnit) -> list[tuple[ast.Call, "FunctionUnit | None"]]:
        """(call site, resolved target or None) for every call in ``fu``,
        excluding calls handed to executor sinks and calls inside nested
        function definitions (their bodies are separate units). Cached —
        every program rule traverses the same edges."""
        cached = self._callees_cache.get(id(fu.node))
        if cached is not None:
            return cached
        skip = self._executor_arg_ids(fu.node)
        out = []
        for n in self._own_walk(fu.node):
            if not isinstance(n, ast.Call) or id(n) in skip:
                continue
            if id(n.func) in skip:
                continue
            out.append((n, self.resolve(qualname(n.func), fu)))
        self._callees_cache[id(fu.node)] = out
        return out

    @staticmethod
    def _own_walk(fn: ast.AST) -> Iterator[ast.AST]:
        stack = list(children(fn))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield n
            stack.extend(children(n))

    def resolve(self, call_qualname: str,
                caller: FunctionUnit) -> "FunctionUnit | None":
        """Conservative name resolution: ``self.m``/``cls.m`` binds to the
        caller's class first; a bare/attr name binds when the last segment
        is unique in the caller's file, else unique across the program.
        Ambiguity resolves to None (no edge) — precision over recall."""
        if not call_qualname:
            return None
        last = _last_segment(call_qualname)
        cands = self.by_name.get(last) or []
        if not cands:
            return None
        if call_qualname.startswith(("self.", "cls.")) \
                and "." not in call_qualname[5:]:
            own_cls = caller.qualname.split(".")[0] \
                if "." in caller.qualname else None
            if own_cls:
                same = [c for c in cands
                        if c.qualname == f"{own_cls}.{last}"
                        and c.path == caller.path]
                if len(same) == 1:
                    return same[0]
        same_file = [c for c in cands if c.path == caller.path]
        if len(same_file) == 1:
            return same_file[0]
        if not same_file and len(cands) == 1:
            return cands[0]
        return None

    def reachable(self, root: FunctionUnit,
                  max_depth: int = 6) -> list[tuple[FunctionUnit, list]]:
        """(unit, call path) for every function reachable from ``root``
        through resolved SYNC call edges (an awaited async callee is its
        own analysis root). The path is the chain of call sites — what a
        finding prints so the reader can follow the frames."""
        out: list[tuple[FunctionUnit, list]] = []
        seen = {id(root.node)}
        frontier: list[tuple[FunctionUnit, list]] = [(root, [])]
        for _ in range(max_depth):
            nxt: list[tuple[FunctionUnit, list]] = []
            for fu, path in frontier:
                for call, target in self.callees(fu):
                    if target is None or id(target.node) in seen:
                        continue
                    if target.is_async:
                        continue
                    seen.add(id(target.node))
                    entry = (target, path + [(fu, call)])
                    out.append(entry)
                    nxt.append(entry)
            frontier = nxt
            if not frontier:
                break
        return out
