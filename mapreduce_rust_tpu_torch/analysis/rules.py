"""The mrlint rule set — one rule per bug class this repo actually shipped.

The port of ``mapreduce_rust_tpu/analysis/rules.py``: the same 24 rules
under the same names. Each rule's docstring names the incident it
encodes; the rule exists so the NEXT regression of that class is caught
by ``python -m mapreduce_rust_tpu_torch lint`` in CI instead of by a
human reading a heisenbug out of a crashed run.

Six rules match JAX names (``donate_argnums``, ``device_get``,
``jax.jit``, ``psum``, ``xla_bridge._backends``, ``device_put``). Each
keeps its JAX matcher, since ``tests/`` still holds JAX code, and widens
it with the same hazard in PyTorch form (see each rule's "Torch twin"
paragraph); a finding raised by a PyTorch name speaks PyTorch in its
message. The two package-scoped rules accept a path segment of either
package's name.

Rules are deliberately framework-specific: they know this repo's names
(JobStats, ``_a2a_span``, ``Dictionary``, ``SHARD_MAP_NATIVE``) because
the invariants are this framework's, not Python's. Precision beats recall:
a rule that cries wolf gets baselined into silence, so every rule here is
tuned to fire on the shipped bug pattern and stay quiet on the shipped
fix pattern.
"""

from __future__ import annotations

import ast
from typing import Iterator

from mapreduce_rust_tpu_torch.analysis.dataflow import guarded_reach
from mapreduce_rust_tpu_torch.analysis.lint import (
    Finding,
    ancestors,
    children,
    enclosing_class,
    enclosing_function,
    last_segment as _last_segment,
    qualname,
    walk,
)


#: The package path segments the package-scoped rules cover: the port's
#: own, and the JAX package's name, which rule fixtures write under.
_PACKAGES = frozenset({"mapreduce_rust_tpu_torch", "mapreduce_rust_tpu"})


class Rule:
    """Base: subclasses set ``name``/``summary`` and implement ``run``."""

    name = "rule"
    summary = ""

    def check(self, tree: ast.Module, src: str, path: str) -> list[Finding]:
        return list(self.run(tree, src, path))

    def run(self, tree: ast.Module, src: str, path: str) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, path: str, node: ast.AST, message: str) -> Finding:
        return Finding(self.name, path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


def _mentions(node: ast.AST, ident: str, substring: bool = False) -> bool:
    """Does the subtree reference ``ident`` as a Name or Attribute?"""
    for n in walk(node):
        cand = None
        if isinstance(n, ast.Name):
            cand = n.id
        elif isinstance(n, ast.Attribute):
            cand = n.attr
        if cand is not None and (ident in cand if substring else cand == ident):
            return True
    return False


def _kw(call: ast.Call, name: str) -> "ast.expr | None":
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node: "ast.expr | None") -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _is_false(node: "ast.expr | None") -> bool:
    return isinstance(node, ast.Constant) and node.value is False


def _import_map(tree: ast.AST) -> dict[str, str]:
    """Local name → dotted name it was imported as (``import torch as t``
    → {"t": "torch"}; ``from torch import compile`` → {"compile":
    "torch.compile"})."""
    out: dict[str, str] = {}
    for n in walk(tree):
        if isinstance(n, ast.Import):
            for alias in n.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    head = alias.name.split(".", 1)[0]
                    out[head] = head
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            for alias in n.names:
                out[alias.asname or alias.name] = f"{n.module}.{alias.name}"
    return out


def _resolved(node: ast.AST, imports: dict[str, str]) -> str:
    """qualname() with its first segment read through the file's imports
    (a name the file never imports stays as written)."""
    q = qualname(node)
    if not q:
        return ""
    head, _, rest = q.partition(".")
    full = imports.get(head, head)
    return f"{full}.{rest}" if rest else full


# ---------------------------------------------------------------------------


class StatsOwnershipRule(Rule):
    """Functions submitted to a thread pool must not mutate JobStats.

    Incident: the host-map engine's first cut had scan workers doing
    ``stats.host_map_s += dt`` from pool threads; an orphaned scan
    surviving an exception teardown then raced the unwound stream's stats
    (and the += itself was a lost-update race). The fix made scan workers
    pure and moved every stats write to the single consumer thread — this
    rule keeps it that way.
    """

    name = "stats-ownership"
    summary = "pool-submitted functions must not mutate JobStats/self.stats"

    def run(self, tree, src, path):
        submitted: dict[str, ast.Call] = {}
        for node in walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = qualname(node.func)
            arg = None
            if _last_segment(fn) == "submit" and node.args:
                arg = node.args[0]
            elif _last_segment(fn) == "run_in_executor" and len(node.args) >= 2:
                arg = node.args[1]
            if arg is None:
                continue
            name = qualname(arg)
            if name:
                submitted.setdefault(_last_segment(name), node)
            elif isinstance(arg, ast.Lambda):
                yield from self._scan_body(arg, path, "<lambda>")
        if not submitted:
            return
        for node in walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in submitted:
                yield from self._scan_body(node, path, node.name)

    def _scan_body(self, fn, path, label):
        for node in walk(fn):
            targets = []
            if isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            for t in targets:
                q = qualname(t)
                # stats.x / self.stats.x / outer.stats.x — any write through
                # a segment named 'stats' is a consumer-thread privilege.
                parts = q.split(".")
                if len(parts) >= 2 and "stats" in parts[:-1]:
                    yield self.finding(
                        path, node,
                        f"{label!r} is submitted to an executor but writes "
                        f"{q!r} — JobStats is owned by the consumer thread; "
                        "return the value and fold it there (an orphaned "
                        "task must not race the unwound stream)",
                    )


class ExecutorTeardownRule(Rule):
    """Every ThreadPoolExecutor must reach shutdown(wait=True,
    cancel_futures=True) through a finally block or a with statement.

    Incident: the host-map engine's pool was torn down with the default
    ``shutdown(wait=False)`` on the exception path, abandoning an in-flight
    scan that kept its memmap window alive past the stream's unwind (fixed
    later); the ingest pool predates even that, leaking executors past
    stream teardown.
    """

    name = "executor-teardown"
    summary = "executors need shutdown(wait=True, cancel_futures=True) in a finally/with"

    _GOOD = "shutdown(wait=True, cancel_futures=True)"

    def run(self, tree, src, path):
        for node in walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if _last_segment(qualname(node.func)) not in (
                "ThreadPoolExecutor", "ProcessPoolExecutor"
            ):
                continue
            if any(isinstance(a, ast.withitem) for a in ancestors(node)):
                continue  # context manager owns the lifecycle
            target = self._assign_target(node)
            if target is None:
                yield self.finding(
                    path, node,
                    "executor is neither stored nor used as a context manager "
                    f"— it can never reach {self._GOOD}",
                )
                continue
            q = qualname(target)
            if isinstance(target, ast.Name):
                ok, why = self._name_shutdown_in_finally(node, q)
            else:
                ok, why = self._attr_shutdown_anywhere(node, q)
            if not ok:
                yield self.finding(path, node, why)

    def _assign_target(self, call):
        parent = getattr(call, "mr_parent", None)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
                and isinstance(parent.targets[0], (ast.Name, ast.Attribute)):
            return parent.targets[0]
        if isinstance(parent, ast.AnnAssign) \
                and isinstance(parent.target, (ast.Name, ast.Attribute)):
            return parent.target
        return None

    def _shutdown_calls(self, scope, q):
        for n in walk(scope):
            if isinstance(n, ast.Call) and qualname(n.func) == f"{q}.shutdown":
                yield n

    def _good_kwargs(self, call) -> "str | None":
        if _is_false(_kw(call, "wait")):
            return "shutdown(wait=False) abandons running futures"
        if not _is_true(_kw(call, "cancel_futures")):
            return ("shutdown without cancel_futures=True leaves queued work "
                    "to run against torn-down state")
        return None

    def _name_shutdown_in_finally(self, call, q):
        scope = enclosing_function(call)
        if scope is None:
            scope = next(
                (a for a in ancestors(call) if isinstance(a, ast.Module)), call
            )
        in_finally = []
        anywhere = []
        for n in walk(scope):
            if isinstance(n, ast.Try):
                for stmt in n.finalbody:
                    in_finally.extend(self._shutdown_calls(stmt, q))
        anywhere.extend(self._shutdown_calls(scope, q))
        if in_finally:
            bad = [self._good_kwargs(c) for c in in_finally]
            good = [b for b in bad if b is None]
            if good:
                return True, ""
            return False, f"executor {q!r}: {bad[0]} — need {self._GOOD}"
        if anywhere:
            return False, (
                f"executor {q!r} is shut down outside any finally block — an "
                f"exception before the call leaks the pool; move "
                f"{self._GOOD} into a finally (or use a with statement)"
            )
        return False, (
            f"executor {q!r} never reaches shutdown — add a finally with "
            f"{self._GOOD} (or use a with statement)"
        )

    def _attr_shutdown_anywhere(self, call, q):
        # self.pool-style executors have a lifecycle method (close/teardown)
        # elsewhere in the class; require the well-formed shutdown to exist
        # anywhere in the owning class body.
        scope = enclosing_class(call)
        if scope is None:
            scope = next(
                (a for a in ancestors(call) if isinstance(a, ast.Module)), call
            )
        calls = list(self._shutdown_calls(scope, q))
        if not calls:
            return False, (
                f"executor {q!r} never reaches shutdown anywhere in its "
                f"owning class — add a teardown path calling {self._GOOD}"
            )
        if any(self._good_kwargs(c) is None for c in calls):
            return True, ""
        return False, (
            f"executor {q!r}: {self._good_kwargs(calls[0])} — need {self._GOOD}"
        )


class TmpdirCleanupRule(Rule):
    """mkdtemp must be paired with a try/finally rmtree in the same function.

    Incident: the streaming egress once leaked ``egress-*`` part files into
    the output dir when a partition sort failed mid-way; the fix
    wrapped the whole egress phase in one try/finally rmtree. Spill-run
    files got the same treatment via ``remove_run_files`` in run_job's
    finally.
    """

    name = "tmpdir-cleanup"
    summary = "mkdtemp needs a try/finally rmtree/remove_run_files in the same function"

    _CLEANERS = ("rmtree", "remove_run_files", "cleanup")

    def run(self, tree, src, path):
        for node in walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if _last_segment(qualname(node.func)) != "mkdtemp":
                continue
            scope = enclosing_function(node) or tree
            cleaned = False
            for n in walk(scope):
                if not isinstance(n, ast.Try):
                    continue
                for stmt in n.finalbody:
                    for c in walk(stmt):
                        if isinstance(c, ast.Call) and _last_segment(
                            qualname(c.func)
                        ) in self._CLEANERS:
                            cleaned = True
            if not cleaned:
                yield self.finding(
                    path, node,
                    "mkdtemp without a try/finally rmtree (or "
                    "remove_run_files) in the same function — a failure "
                    "between creation and cleanup leaks the directory into "
                    "a shared output/work dir",
                )


class DonationSafetyRule(Rule):
    """donate_argnums on a shard_map computation must sit behind the
    native-shard_map guard.

    Incident: donating state buffers into the pre-0.6 experimental
    ``shard_map`` corrupts the jaxlib 0.4.x CPU client heap (observed as a
    glibc "corrupted double-linked list" under the spill-heavy mesh merge,
    fixed by gating donation on ``_SHARD_MAP_NATIVE``). Donation is
    a memory optimization, never a correctness requirement — unguarded it
    is a latent heap corruption on every jax<0.6 image.

    Torch twin: PyTorch has no donation; its buffer-lifetime hazard is the
    asynchronous host→device copy of a buffer that outlives the call. The
    reference's ``_PackStager`` reused a host buffer that the device
    transfer could still be reading, and its next pack overwrote rows in
    flight. So a ``.to(..., non_blocking=True)`` of, or a
    ``.copy_(src, non_blocking=True)`` from, a ``self.`` attribute fires
    unless the same function records a CUDA event (``<event>.record()``)
    after the copy — the barrier the next writer waits on (the port's
    ``_PackStager.to_device``). A copy of a local the caller keeps alive
    is not this rule's business.
    """

    name = "donation-safety"
    summary = "donate_argnums near shard_map must be gated on SHARD_MAP_NATIVE"

    def run(self, tree, src, path):
        yield from self._run_jax(tree, path)
        yield from self._run_torch(tree, path)

    @staticmethod
    def _reads_self_attr(expr) -> bool:
        return any(
            isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id == "self"
            for n in walk(expr)
        )

    def _run_torch(self, tree, path):
        for node in walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and _is_true(_kw(node, "non_blocking"))):
                continue
            if node.func.attr == "to":
                read = node.func.value
            elif node.func.attr == "copy_" and node.args:
                read = node.args[0]
            else:
                continue
            if not self._reads_self_attr(read):
                continue
            fn = enclosing_function(node)
            scope = fn if fn is not None else tree
            at = (node.lineno, node.col_offset)
            if any(
                isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "record"
                and (n.lineno, n.col_offset) > at
                for n in walk(scope)
            ):
                continue
            yield self.finding(
                path, node,
                f"non_blocking .{node.func.attr}() reads "
                f"{qualname(read) or 'a self. buffer'!r}, which outlives "
                "this call, and no CUDA event is recorded after the copy "
                "— the next write into the buffer can land while the "
                "transfer still reads it; record an event after the copy "
                "and synchronize on it before reusing the buffer (see "
                "runtime/driver.py's _PackStager)",
            )

    def _run_jax(self, tree, path):
        # decorator Call → the FunctionDef it decorates
        deco_owner: dict[int, ast.AST] = {}
        for node in walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for deco in node.decorator_list:
                    for sub in walk(deco):
                        deco_owner[id(sub)] = node
        for node in walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if _kw(node, "donate_argnums") is None and _kw(node, "donate_argnames") is None:
                continue
            if self._guarded(node):
                continue
            owner = deco_owner.get(id(node))
            near_shard_map = False
            if owner is not None and any(
                _mentions(d, "shard_map") for d in owner.decorator_list
            ):
                near_shard_map = True
            else:
                stmt = self._nearest_statement(node)
                if stmt is not None and _mentions(stmt, "shard_map"):
                    near_shard_map = True
            if near_shard_map:
                yield self.finding(
                    path, node,
                    "donate_argnums applied to a shard_map computation "
                    "without the native-shard_map guard — donating into "
                    "jax.experimental.shard_map corrupts the jaxlib 0.4.x "
                    "heap; gate it on SHARD_MAP_NATIVE (see "
                    "parallel/shuffle.py) or drop the donation",
                )

    def _guarded(self, node) -> bool:
        for anc in ancestors(node):
            test = None
            if isinstance(anc, (ast.If, ast.IfExp)):
                test = anc.test
            if test is not None and _mentions(test, "SHARD_MAP_NATIVE", substring=True):
                return True
        return False

    def _nearest_statement(self, node):
        for anc in ancestors(node):
            if isinstance(anc, ast.stmt):
                return anc
        return None


class A2APurityRule(Rule):
    """No blocking readbacks inside ``_a2a_span`` blocks.

    Incident: the mesh replay paths once fetched spill counts
    (``device_get`` → host block) INSIDE the ``mesh.all_to_all`` span, so
    ``stats.all_to_all_s`` — the ICI numerator of the interconnect-vs-
    compute split — was inflated with device-wait time and the multi-chip
    attribution lied. The fix moved every blocking fetch after the span;
    this rule pins it.

    Torch twin: the PyTorch readbacks block the same way — ``.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()`` wait for the card, and
    ``torch.cuda.synchronize()`` (or an event's ``.synchronize()``) waits
    for everything queued.
    """

    name = "a2a-purity"
    summary = "no device_get/block_until_ready/asarray inside _a2a_span blocks"

    _TORCH_BLOCKING = ("item", "cpu", "tolist", "numpy", "synchronize")
    _BLOCKING = (
        "device_get", "block_until_ready", "asarray",
        "local_rows", "local_batch", "to_host",
    ) + _TORCH_BLOCKING

    def run(self, tree, src, path):
        for node in walk(tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(
                isinstance(item.context_expr, ast.Call)
                and _last_segment(qualname(item.context_expr.func)).lstrip("_")
                == "a2a_span"
                for item in node.items
            ):
                continue
            for stmt in node.body:
                for sub in walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    last = _last_segment(qualname(sub.func))
                    # qualname() is '' for a call-rooted receiver
                    # (x.sum().item()); the attribute still names a torch
                    # readback.
                    if not last and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr in self._TORCH_BLOCKING:
                        last = sub.func.attr
                    if last not in self._BLOCKING:
                        continue
                    name = qualname(sub.func) or f".{last}"
                    if last in self._TORCH_BLOCKING:
                        yield self.finding(
                            path, sub,
                            f"{name!r} inside an _a2a_span block — a "
                            "blocking readback (.item()/.cpu()/.tolist()/"
                            ".numpy(), torch.cuda.synchronize()) waits for "
                            "the card and inflates stats.all_to_all_s (the "
                            "interconnect numerator) with device-wait "
                            "time; read back after the span and account it "
                            "in device_wait_s",
                        )
                        continue
                    yield self.finding(
                        path, sub,
                        f"{qualname(sub.func)!r} inside an _a2a_span "
                        "block — blocking readbacks inflate "
                        "stats.all_to_all_s (the ICI numerator) with "
                        "device-wait time; fetch after the span and "
                        "account it in device_wait_s",
                    )


class SpanBalanceRule(Rule):
    """Tracer spans are entered only via ``with``.

    A span entered by hand (``span = trace_span(...); span.__enter__()``)
    that unwinds on an exception never closes, leaving the Chrome trace
    with partially-overlapping spans that ``validate_events`` rejects and
    Perfetto renders as garbage. The contextmanager protocol is the only
    supported entry.
    """

    name = "span-balance"
    summary = "trace_span/_a2a_span only as a with-statement context"

    _SPANS = ("trace_span", "a2a_span")

    def run(self, tree, src, path):
        if path.endswith("runtime/trace.py"):
            return  # the definition site manipulates spans by construction
        for node in walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if _last_segment(qualname(node.func)).lstrip("_") not in self._SPANS:
                continue
            parent = getattr(node, "mr_parent", None)
            if isinstance(parent, ast.withitem):
                continue
            yield self.finding(
                path, node,
                f"{qualname(node.func)!r} outside a with statement — a "
                "manually entered span that unwinds on exception leaves the "
                "trace unbalanced (validate_events rejects it); use "
                "'with ...:'",
            )


class SpilledDictApiRule(Rule):
    """No ``in``/``.items()`` on a possibly-spilled Dictionary outside
    runtime/dictionary.py.

    Incident: after the bounded-memory dictionary tier landed, RAM-tier
    point probes (``key in d``, ``d.items()``) silently answered from a
    PARTIAL store once a budget flush had moved words to disk runs — the fix
    made both raise on spilled instances, and egress consumes
    ``iter_sorted()``. This rule catches new probe sites before they trip
    the runtime guard in a spill-heavy run nobody tests locally.

    Precision: a name is Dictionary-typed if it is assigned from a
    ``Dictionary(...)``-like constructor in the same scope (budget kwargs
    present ⇒ spillable), or follows the repo convention of being named
    exactly ``dictionary`` (provenance unknown ⇒ treated as spillable).
    A budget-free local ``Dictionary()`` is provably RAM-only and exempt.
    """

    name = "spilled-dict-api"
    summary = "no in/.items() on possibly-spilled Dictionary outside runtime/dictionary.py"

    def run(self, tree, src, path):
        if path.endswith("runtime/dictionary.py"):
            return
        scopes = [tree] + [
            n for n in walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            yield from self._scan_scope(scope, path)

    def _own_nodes(self, scope):
        """Walk a scope without descending into nested function scopes."""
        body = scope.body if isinstance(
            scope, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef)
        ) else [scope]
        stack = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested scope boundary — it gets its own pass
            yield n
            stack.extend(children(n))

    def _scan_scope(self, scope, path):
        spillable: dict[str, bool] = {}  # name → may be spilled
        for n in self._own_nodes(scope):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                    and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
                ctor = qualname(n.value.func)
                if _last_segment(ctor).endswith("Dictionary"):
                    spillable[n.targets[0].id] = bool(
                        n.value.args or n.value.keywords
                    )
        def is_risky(expr) -> "str | None":
            q = qualname(expr)
            if not q:
                return None
            if isinstance(expr, ast.Name):
                if expr.id in spillable:
                    return q if spillable[expr.id] else None
                return q if expr.id == "dictionary" else None
            # self.dictionary / worker.dictionary — unknown provenance
            return q if _last_segment(q) == "dictionary" else None

        for n in self._own_nodes(scope):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "items":
                name = is_risky(n.func.value)
                if name:
                    yield self._probe_finding(path, n, f"{name}.items()")
            if isinstance(n, ast.Compare) and len(n.ops) == 1 \
                    and isinstance(n.ops[0], (ast.In, ast.NotIn)):
                name = is_risky(n.comparators[0])
                if name:
                    yield self._probe_finding(path, n, f"'in {name}'")

    def _probe_finding(self, path, node, probe):
        return self.finding(
            path, node,
            f"{probe} on a possibly-spilled Dictionary answers from the RAM "
            "tier only (flushed words live in disk runs) — consume "
            "iter_sorted() / lookup(), or prove it RAM-only "
            "(runtime/dictionary.py owns the spilled API)",
        )


class JitInLoopRule(Rule):
    """No jax.jit/pjit construction inside per-chunk / per-window loops.

    Incident: an early bench measured warm == cold because fresh jitted
    closures were built per call — every chunk paid the trace. The fix
    cached step fns at module level keyed by value (make_step_fns /
    make_packed_merge_fn); constructing a jit inside a data loop recreates
    exactly that bug, with a ~40 s XLA compile per iteration on TPU.

    Torch twin: ``torch.compile`` (a call or a decorator, matched through
    the file's imports so ``re.compile`` stays silent) recompiles per
    construction, and a CUDA graph (``torch.cuda.CUDAGraph()``,
    ``torch.cuda.graph(...)``) re-captures per construction — inside a
    loop both pay their whole build on every iteration.
    """

    name = "jit-in-loop"
    summary = "no jax.jit/pjit construction inside data loops"

    _JITS = ("jit", "pjit")
    _TORCH_COMPILERS = ("torch.compile", "torch.cuda.CUDAGraph",
                       "torch.cuda.graph")

    def _torch_compiler(self, node, imports) -> "str | None":
        """The torch.compile / CUDA-graph name a call or decorator
        constructs through, or None."""
        target = node.func if isinstance(node, ast.Call) else node
        name = _resolved(target, imports)
        return name if name in self._TORCH_COMPILERS else None

    def _is_jit_expr(self, node) -> bool:
        if _last_segment(qualname(node)) in self._JITS:
            return True
        if isinstance(node, ast.Call):
            fn = _last_segment(qualname(node.func))
            if fn in self._JITS:
                return True
            if fn == "partial" and node.args \
                    and _last_segment(qualname(node.args[0])) in self._JITS:
                return True
        return False

    def _in_loop(self, node) -> bool:
        return any(
            isinstance(a, (ast.For, ast.AsyncFor, ast.While))
            for a in ancestors(node)
        )

    def run(self, tree, src, path):
        imports = _import_map(tree)
        for node in walk(tree):
            hit = built = None
            if isinstance(node, ast.Call):
                if self._is_jit_expr(node):
                    hit = node
                else:
                    built = self._torch_compiler(node, imports)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(self._is_jit_expr(d) for d in node.decorator_list):
                    hit = node
                else:
                    built = next(filter(None, (
                        self._torch_compiler(d, imports)
                        for d in node.decorator_list)), None)
            if built is not None and self._in_loop(node):
                what = ("recompiles" if built == "torch.compile"
                        else "re-captures the graph")
                yield self.finding(
                    path, node,
                    f"{built} constructed inside a loop — every iteration "
                    f"{what} (seconds per build on the card); build it "
                    "once outside the loop, or use a cached factory like "
                    "make_step_fns",
                )
            if hit is not None and self._in_loop(hit):
                yield self.finding(
                    path, hit,
                    "jax.jit/pjit constructed inside a loop — every "
                    "iteration re-traces (and on TPU re-compiles, ~40 s); "
                    "build the jitted fn once outside, or use a cached "
                    "factory like make_step_fns",
                )


class PsumReplicatedFlagRule(Rule):
    """No ``psum`` of a value that is already psum-replicated.

    The multi-process drivers depend on replicated decision flags: the
    shuffle step fns psum their overflow counters exactly once
    (``_chip_shuffle_tail``), after which every chip holds the identical
    global total and any process reads ONE local shard
    (``make_mh_shuffle_step_fns`` contract, parallel/shuffle.py). Psumming
    such a value again multiplies it by the axis size — a replay flag that
    should read 1 reads D, and on a flag compared ``== 0`` the bug is
    silent until a skewed input makes every process disagree about a
    replay. Encodes the "psum-replicated-flag misuse in multi-process
    drivers" review note as a rule.

    Precision: fires only on (a) a ``psum`` call whose argument subtree
    contains another ``psum`` call, and (b) ``psum(x, ...)`` where ``x``
    was assigned from a ``psum`` call in the same function scope. A single
    psum of per-chip values — the shipped pattern — never matches.

    Torch twin: ``torch.distributed.all_reduce`` (sum) is the psum of a
    process group, and joins ``psum`` in both shapes. It also reduces IN
    PLACE, so (c) ``all_reduce(x)`` fires where an earlier in-place
    ``all_reduce(x)`` of the same scope already replicated ``x`` and
    nothing rebound ``x`` in between. One reduction per round of a fresh
    vector — the port's ``round_sum`` — never matches.
    """

    name = "psum-replicated-flag"
    summary = "no psum of an already-psum-replicated value (multiplies by D)"

    _REDUCERS = ("psum", "all_reduce")

    def _is_psum(self, node) -> bool:
        return isinstance(node, ast.Call) and \
            _last_segment(qualname(node.func)) in self._REDUCERS

    @staticmethod
    def _word(call) -> str:
        return _last_segment(qualname(call.func))

    def run(self, tree, src, path):
        scopes = [tree] + [
            n for n in walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            yield from self._scan_scope(scope, path)

    def _own_nodes(self, scope):
        body = scope.body if isinstance(
            scope, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef)
        ) else [scope]
        stack = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested scope gets its own pass
            yield n
            stack.extend(children(n))

    def _scan_scope(self, scope, path):
        nodes = list(self._own_nodes(scope))
        # name → line numbers where it was ASSIGNED from a psum call. The
        # match below requires a strictly earlier definition line, so the
        # common rebinding idiom `x = psum(x, AXIS)` — a single psum whose
        # argument is the pre-assignment (per-chip) value — never fires.
        def_lines: dict[str, list[int]] = {}
        for n in nodes:
            if isinstance(n, ast.Assign) and self._is_psum(n.value):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        def_lines.setdefault(t.id, []).append(n.lineno)
            elif isinstance(n, ast.AnnAssign) and n.value is not None \
                    and self._is_psum(n.value) and isinstance(n.target, ast.Name):
                def_lines.setdefault(n.target.id, []).append(n.lineno)
        # name → lines of an in-place all_reduce(name) statement, and
        # name → lines that rebind it (the in-place shape's kill set).
        reduced_at: dict[str, list[int]] = {}
        bound_at: dict[str, list[int]] = {}
        for n in nodes:
            if isinstance(n, ast.Expr) and self._is_psum(n.value) \
                    and self._word(n.value) == "all_reduce" \
                    and n.value.args and isinstance(n.value.args[0], ast.Name):
                reduced_at.setdefault(n.value.args[0].id, []).append(n.lineno)
            targets = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign, ast.For,
                                ast.AsyncFor)):
                targets = [n.target]
            for t in targets:
                for s in walk(t):
                    if isinstance(s, ast.Name):
                        bound_at.setdefault(s.id, []).append(n.lineno)
        for n in nodes:
            if not self._is_psum(n):
                continue
            word = self._word(n)
            inner = next(
                (s for a in n.args for s in walk(a) if self._is_psum(s)),
                None,
            )
            if inner is not None:
                if word == "all_reduce" or self._word(inner) == "all_reduce":
                    yield self.finding(
                        path, n,
                        "all_reduce of an all_reduce result multiplies the "
                        "total by the world size — the inner reduction "
                        "already replicated it to every rank; reduce the "
                        "per-rank value once",
                    )
                    continue
                yield self.finding(
                    path, n,
                    "psum of a psum result multiplies the total by the axis "
                    "size — the inner psum already replicated it to every "
                    "chip; read one shard instead",
                )
                continue
            arg0 = n.args[0] if n.args else None
            if word == "all_reduce" and isinstance(arg0, ast.Name) and any(
                line < n.lineno and not any(
                    line < b < n.lineno for b in bound_at.get(arg0.id, ()))
                for line in reduced_at.get(arg0.id, ())
            ):
                yield self.finding(
                    path, n,
                    f"{arg0.id!r} was already all_reduce'd in place — "
                    "reducing it again multiplies it by the world size (a "
                    "replay flag compared == 0 then lies); all_reduce each "
                    "per-rank value exactly once",
                )
                continue
            for a in n.args:
                for s in walk(a):
                    if isinstance(s, ast.Name) and any(
                        line < n.lineno for line in def_lines.get(s.id, ())
                    ):
                        if word == "all_reduce":
                            yield self.finding(
                                path, n,
                                f"{s.id!r} is already an all_reduce'd value "
                                "— reducing it again multiplies it by the "
                                "world size; all_reduce each per-rank value "
                                "exactly once",
                            )
                            break
                        yield self.finding(
                            path, n,
                            f"{s.id!r} is already a psum-replicated value — "
                            "psumming it again multiplies the flag by the "
                            "axis size (a replay flag compared == 0 then "
                            "lies); psum the per-chip value exactly once "
                            "and read one shard (make_mh_shuffle_step_fns "
                            "contract)",
                        )
                        break
                else:
                    continue
                break


class UnboundedRetryRule(Rule):
    """Retry/poll loops must back off, bound their attempts, or carry a
    stop condition.

    Incident: the RPC plane's retry loops once slept a fixed
    constant forever: the worker's connect retry hammered a coming-up
    coordinator at a fixed rate (thundering herd on restart), and a
    constant-sleep failure loop can busy-hammer a struggling peer while
    never surfacing the real error. The fix is runtime/backoff.Backoff
    (jittered exponential, cap, budget); this rule keeps constant-sleep
    retry loops from coming back.

    Precision: fires only on ``while True`` loops (a real loop condition
    IS a stop condition) that sleep a non-growing delay — a literal, or a
    name/attribute never reassigned inside the loop; a delay produced by
    any call (``backoff.next_delay()``, ``min(...)``) is assumed to grow
    and stays silent. Two shapes fire: (a) the constant sleep sits on an
    except-handler retry path with no raise/break/return bounding it
    anywhere in the loop; (b) the loop has no exit statement at all.
    Bounded ``for attempt in range(n)`` retries never match (not a While).
    """

    name = "unbounded-retry"
    summary = "no constant-sleep retry/poll loops without backoff, cap, or stop condition"

    def run(self, tree, src, path):
        for node in walk(tree):
            if not isinstance(node, ast.While):
                continue
            if not (isinstance(node.test, ast.Constant)
                    and node.test.value is True):
                continue  # the loop test is a stop condition
            yield from self._check_loop(node, path)

    def _check_loop(self, loop, path):
        body_nodes = [n for stmt in loop.body for n in walk(stmt)]
        sleeps = [
            n for n in body_nodes
            if isinstance(n, ast.Call)
            and _last_segment(qualname(n.func)) == "sleep"
        ]
        if not sleeps:
            return
        assigned: set[str] = set()
        for n in body_nodes:
            targets = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            elif isinstance(n, (ast.For, ast.AsyncFor)):
                targets = [n.target]
            for t in targets:
                q = qualname(t)
                if q:
                    assigned.add(q)

        def is_constant_delay(call: ast.Call) -> bool:
            if not call.args:
                return False
            arg = call.args[0]
            if isinstance(arg, ast.Constant):
                return True
            if isinstance(arg, (ast.Name, ast.Attribute)):
                # Never reassigned in the loop → the delay cannot grow.
                return qualname(arg) not in assigned
            return False  # computed (a call, arithmetic): assume it grows

        const_sleeps = [c for c in sleeps if is_constant_delay(c)]
        if not const_sleeps:
            return
        has_raise = any(isinstance(n, ast.Raise) for n in body_nodes)
        for h in (n for n in body_nodes if isinstance(n, ast.ExceptHandler)):
            h_nodes = list(walk(h))
            h_sleeps = [c for c in const_sleeps if any(c is n for n in h_nodes)]
            if not h_sleeps:
                continue
            if has_raise or any(
                isinstance(n, (ast.Break, ast.Return)) for n in h_nodes
            ):
                continue  # bounded: attempts surface an error or exit
            yield self.finding(
                path, h_sleeps[0],
                "constant-sleep retry in a `while True` loop — failures "
                "retry forever at a fixed rate (thundering herd, and the "
                "real error never surfaces); use runtime/backoff.Backoff "
                "(jittered exponential with cap and budget) or bound the "
                "attempts",
            )
            return
        if not any(
            isinstance(n, (ast.Break, ast.Return, ast.Raise))
            for n in body_nodes
        ):
            yield self.finding(
                path, const_sleeps[0],
                "`while True` poll loop sleeping a constant with no exit "
                "(no break/return/raise) and no backoff — give it a stop "
                "condition, or draw delays from runtime/backoff.Backoff",
            )


class MetricInHotLoopRule(Rule):
    """No metric mutations or wall-clock sampling inside the known
    per-record hot loops.

    The observability doctrine (runtime/metrics.py) allows per-window and
    per-round telemetry but forbids per-record work — the reference's one
    log line *per emitted KV pair* is the founding counter-example, and
    the live registry makes the mistake easy to re-introduce: a
    registry ``inc`` is a lock acquire + dict update, ``record_hist`` is
    a bisect, and ``time.time()`` is a syscall-class read; any of them
    inside the scan fold or the a2a pack loop multiplies by the record
    rate. The sampler exists precisely so these loops never need their
    own instruments — they tick ``metrics_tick()`` once per window and
    the registry pulls aggregates.

    Precision: fires only inside ``for``/``while`` loops of the named
    hot-loop scopes (the scan-fold and pack functions:
    ``fold_scan_into_dictionary``, ``_pack_update``, ``_fold``,
    ``add_scanned_raw``, ``_insert_hashed``). Three shapes match: (a)
    wall-clock sampling (``time.time``/``perf_counter``/``monotonic``);
    (b) mutations of a registry instrument — a call chained off
    ``counter()``/``gauge()``/``histogram()``, a name assigned from one
    in the same scope, or a mutator on a receiver whose qualname mentions
    ``metric``/``registry``; (c) ``record_hist``/``metrics_tick``/
    ``maybe_sample``/``ship_sample`` calls. The same calls OUTSIDE the
    loops (per-window accounting after the fold) never match.
    """

    name = "metric-in-hot-loop"
    summary = "no metric mutations / time sampling in per-record hot loops"

    HOT_SCOPES = (
        "fold_scan_into_dictionary",  # scan fold: native scan → dictionary
        "_pack_update",               # a2a/merge pack: rows → padded update
        "_fold",                      # HostAccumulator spill fold
        "add_scanned_raw",            # dictionary per-token insert pass
        "_insert_hashed",             # dictionary hashed-word insert loop
    )
    _CLOCKS = ("time", "perf_counter", "monotonic")
    _MUTATORS = ("inc", "observe", "set", "set_total", "set_hist")
    _FACTORIES = ("counter", "gauge", "histogram")
    _TICKS = ("record_hist", "metrics_tick", "maybe_sample", "ship_sample")

    def run(self, tree, src, path):
        for scope in walk(tree):
            if not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if scope.name not in self.HOT_SCOPES:
                continue
            yield from self._scan_scope(scope, path)

    def _own_nodes(self, scope):
        stack = list(scope.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested scope: not this hot loop's body
            yield n
            stack.extend(children(n))

    def _instrument_names(self, scope) -> set[str]:
        """Names assigned from a registry factory call in this scope —
        ``h = registry.histogram("x")`` makes ``h.observe`` a mutation."""
        out: set[str] = set()
        for n in self._own_nodes(scope):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                    and _last_segment(qualname(n.value.func)) in self._FACTORIES:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
        return out

    def _is_metric_mutation(self, call: ast.Call, instruments: set) -> bool:
        if not isinstance(call.func, ast.Attribute):
            return False
        if call.func.attr not in self._MUTATORS:
            return False
        recv = call.func.value
        # Chained off a factory: registry.counter("x").inc(...)
        if isinstance(recv, ast.Call) and \
                _last_segment(qualname(recv.func)) in self._FACTORIES:
            return True
        # A name bound from a factory in this scope.
        if isinstance(recv, ast.Name) and recv.id in instruments:
            return True
        # Receiver path names the registry (self.metrics.…, registry.…) —
        # conservative textual hint, scoped to the mutator verbs above.
        q = qualname(recv).lower()
        return "metric" in q or "registry" in q

    def _is_clock(self, call: ast.Call) -> bool:
        q = qualname(call.func)
        if q == "time.time" or q.endswith(".time.time"):
            return True
        # perf_counter/monotonic are unambiguous in any spelling (bare
        # from-import or module-qualified); a bare `time()` is not — it
        # could be anything, so only the module-qualified form fires.
        return _last_segment(q) in ("perf_counter", "monotonic")

    def _scan_scope(self, scope, path):
        instruments = self._instrument_names(scope)
        seen: set[int] = set()
        for loop in self._own_nodes(scope):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for n in walk(loop):
                if not isinstance(n, ast.Call) or id(n) in seen:
                    continue
                seen.add(id(n))
                last = _last_segment(qualname(n.func))
                if self._is_clock(n):
                    yield self.finding(
                        path, n,
                        f"wall-clock sampling ({qualname(n.func)}) inside "
                        f"the {scope.name!r} hot loop runs per record — "
                        "time once per window outside the loop, or let the "
                        "registry sampler (metrics_tick at the window "
                        "sites) carry the series",
                    )
                elif last in self._TICKS:
                    yield self.finding(
                        path, n,
                        f"{last!r} inside the {scope.name!r} hot loop runs "
                        "per record (a histogram add is a bisect, a "
                        "sampler tick is a clock read + compare) — move it "
                        "after the loop; the per-window sites already tick "
                        "the sampler",
                    )
                elif self._is_metric_mutation(n, instruments):
                    yield self.finding(
                        path, n,
                        f"registry instrument mutation inside the "
                        f"{scope.name!r} hot loop — a lock acquire + dict "
                        "update per record is the reference's per-KV log "
                        "line all over again; accumulate locally and "
                        "record once after the loop (the sampler pulls "
                        "aggregates)",
                    )


# ---------------------------------------------------------------------------
# Interprocedural program rules (the dataflow layer)
class NakedClockInControlPlaneRule(Rule):
    """No direct ``time.monotonic()`` / ``time.time()`` calls inside the
    control-plane state machines.

    Incident: mrmodel explores the real Coordinator/JobService
    under a virtual clock — the whole point is that no model rewrite can
    drift from the shipped logic. That only holds while every wall-clock
    read in those classes routes through the injectable ``self._now``
    seam: one naked ``time.monotonic()`` and model time and real time
    disagree mid-schedule, so lease expiry explores a state the cluster
    can never reach (or misses one it can). The seam ASSIGNMENT
    (``self._now = now if now is not None else time.monotonic``) is a
    function reference, not a call, and stays legal; ``time.perf_counter``
    latency stamps are measurement, not scheduling, and are out of scope.
    """

    name = "naked-clock-in-control-plane"
    summary = ("control-plane classes read the clock via the _now seam, "
               "never time.monotonic()/time.time() directly")

    #: The classes mrmodel drives under a virtual clock — plus any class
    #: that publishes an RPC ``_METHODS`` table (a control-plane surface
    #: by construction, whatever it is named).
    _CONTROL_CLASSES = frozenset({
        "Coordinator", "JobService", "_Phase", "JobReport",
        "Worker", "ServiceWorker",
    })
    _CLOCKS = frozenset({"monotonic", "time"})

    def _from_imports(self, tree) -> dict[str, str]:
        out: dict[str, str] = {}
        for n in walk(tree):
            if isinstance(n, ast.ImportFrom) and n.module:
                for alias in n.names:
                    out[alias.asname or alias.name] = n.module
        return out

    @staticmethod
    def _defines_methods_table(cls: ast.ClassDef) -> bool:
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "_METHODS"
                    for t in stmt.targets):
                return True
        return False

    def _is_naked_clock(self, call: ast.Call, from_imports) -> "str | None":
        q = qualname(call.func)
        if not q:
            return None
        last = _last_segment(q)
        if last not in self._CLOCKS:
            return None
        if q == f"time.{last}" or q.endswith(f".time.{last}"):
            return f"time.{last}"
        if q == last and from_imports.get(last) == "time":
            return f"time.{last}"
        return None

    def run(self, tree, src, path):
        from_imports = self._from_imports(tree)
        for cls in walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            if cls.name not in self._CONTROL_CLASSES \
                    and not self._defines_methods_table(cls):
                continue
            for call in walk(cls):
                if not isinstance(call, ast.Call):
                    continue
                clock = self._is_naked_clock(call, from_imports)
                if clock is None:
                    continue
                yield self.finding(
                    path, call,
                    f"{clock}() called directly inside control-plane "
                    f"class {cls.name} — route the read through the "
                    "injectable clock seam (self._now()) so mrmodel's "
                    "virtual-clock exploration drives the same code the "
                    "cluster runs; keep a bare time.monotonic only as "
                    "the seam's default REFERENCE, never a call",
                )


# ---------------------------------------------------------------------------


class ProgramRule(Rule):
    """A rule that runs once over the whole linted file set with the
    dataflow layer (analysis/dataflow.py): CFG + reaching definitions per
    function, and a package call graph so a value or a hazard can be
    followed across frames. Findings land on their file and obey the same
    inline ignores and baseline as per-file findings."""

    def run_program(self, program) -> Iterator[Finding]:
        raise NotImplementedError

    def check(self, tree, src, path):  # pragma: no cover - program-only
        return []


def _call_chain(path_frames) -> str:
    """Render a call path as ``a -> b -> c`` for finding messages."""
    return " -> ".join(fu.qualname for fu, _call in path_frames)


class BlockingInAsyncRule(ProgramRule):
    """No blocking calls reachable inside ``async def`` — directly or
    through sync helper frames.

    Incident: the renewal/backoff loops live on the event loop; a single
    ``time.sleep`` (or a subprocess wait) anywhere in their call closure
    starves EVERY coroutine in the process — renewals stop, leases expire
    under live tasks, and the failure reads as a distributed timing bug
    instead of the local blocking call it is. The chaos sites dodge this
    only because task bodies run in the executor (``run_in_executor``),
    which is exactly the boundary this rule understands: callables merely
    PASSED to an executor sink are not async-context callees.
    """

    name = "blocking-in-async"
    summary = "no time.sleep/subprocess/socket waits reachable from async def"

    #: qualname -> why it blocks. Bare last-segment matches are accepted
    #: only for names that unambiguously come from these modules
    #: (from-import detection below).
    _BLOCKING_ROOTS = {
        "time": {"sleep"},
        "subprocess": {"run", "call", "check_call", "check_output", "Popen"},
        "os": {"system", "wait", "waitpid"},
        "socket": {"create_connection"},
        "urllib.request": {"urlopen"},
    }

    def _from_imports(self, tree) -> dict[str, str]:
        """bare name -> source module, for ``from time import sleep``."""
        out: dict[str, str] = {}
        for n in walk(tree):
            if isinstance(n, ast.ImportFrom) and n.module:
                for alias in n.names:
                    out[alias.asname or alias.name] = n.module
        return out

    def _is_blocking(self, call, from_imports) -> "str | None":
        q = qualname(call.func)
        if not q:
            return None
        last = _last_segment(q)
        for root, names in self._BLOCKING_ROOTS.items():
            if last not in names:
                continue
            if q == f"{root}.{last}" or q.endswith(f".{root}.{last}"):
                return f"{root}.{last}"
            if q == last and from_imports.get(last) == root:
                return f"{root}.{last}"
        return None

    def run_program(self, program):
        from_imports_by_path: dict[str, dict] = {}
        for path, tree in program.files:
            from_imports_by_path[path] = self._from_imports(tree)
        seen: set[tuple[str, int]] = set()
        for root in program.functions:
            if not root.is_async:
                continue
            frames = [(root, [])] + program.reachable(root)
            for fu, chain in frames:
                imports = from_imports_by_path.get(fu.path, {})
                for call, _target in program.callees(fu):
                    blocked = self._is_blocking(call, imports)
                    if blocked is None:
                        continue
                    key = (fu.path, getattr(call, "lineno", 0))
                    if key in seen:
                        continue  # one finding per site, however many
                    seen.add(key)  # async roots reach it
                    via = (
                        f" via {_call_chain(chain)} -> {fu.qualname}"
                        if chain else ""
                    )
                    yield self.finding(
                        fu.path, call,
                        f"{blocked!r} reached inside async def "
                        f"{root.qualname}{via} — a blocking call on the "
                        "event loop starves every coroutine (renewals "
                        "stop, leases expire under live tasks); await "
                        "asyncio.sleep, or move the work to "
                        "run_in_executor",
                    )


class BackendInitInProbeRule(ProgramRule):
    """Telemetry probes must not initialize a jax backend.

    Incident: the worker's first device-memory gauge called
    ``jax.local_devices()`` from the task loop; on a process whose
    backend was NOT yet initialized that call *triggers* backend init — a
    ~minutes-long metadata probe against an absent accelerator that
    wedged the worker. The fix gates the gauge on
    ``jax._src.xla_bridge._backends`` (already-initialized check). This
    rule walks every probe-named function (``sample``/``probe``/
    ``gauge``/``platform_info`` — the repo's telemetry naming convention)
    and its sync call closure: any path to ``jax.devices()`` /
    ``jax.local_devices()`` / ``memory_stats()`` must be dominated by a
    ``_backends`` guard, at the device call or at the call site leading
    to it (branch-sensitive: the ``if not _backends: return`` early exit
    counts, including inside try/except).

    Torch twin: a ``torch.cuda`` query (``current_device``,
    ``get_device_name``, ``get_device_properties``, the memory counters,
    ``mem_get_info``, ``synchronize``) in a process without a CUDA context
    CREATES one — hundreds of MiB of device memory and seconds of driver
    start-up in a coordinator or a host-engine worker that never meant to
    touch the card. A test of ``is_initialized()`` on a ``cuda`` receiver
    (``if not torch.cuda.is_initialized(): return``) is the guard, beside
    ``_backends``; ``dist.is_initialized()`` is not.
    """

    name = "backend-init-in-probe"
    summary = "telemetry probes gate device access on xla_bridge._backends"

    _PROBE = ("sample", "probe", "gauge", "platform_info")
    _TORCH_DEVICE = (
        "current_device", "get_device_name", "get_device_properties",
        "memory_allocated", "max_memory_allocated", "memory_reserved",
        "mem_get_info", "synchronize",
    )
    _DEVICE = ("local_devices", "devices", "memory_stats") + _TORCH_DEVICE

    def _is_probe(self, fu) -> bool:
        low = fu.name.lower()
        return any(p in low for p in self._PROBE)

    @staticmethod
    def _cuda_guard(call) -> bool:
        """``<...>.cuda.is_initialized()``: the CUDA-context check."""
        parts = qualname(call.func).split(".")
        return parts[-1] == "is_initialized" and "cuda" in parts[:-1]

    def _is_torch_call(self, call) -> bool:
        parts = qualname(call.func).split(".")
        return parts[-1] in self._TORCH_DEVICE or "cuda" in parts[:-1]

    def _guarded(self, cfg, node) -> bool:
        return guarded_reach(cfg, node, "_backends", self._cuda_guard)

    def _device_calls(self, program, fu):
        for call, _t in program.callees(fu):
            if _last_segment(qualname(call.func)) in self._DEVICE:
                yield call

    def run_program(self, program):
        seen: set[tuple[str, int]] = set()
        for root in program.functions:
            if not self._is_probe(root):
                continue
            frames = [(root, [])] + program.reachable(root)
            for fu, chain in frames:
                for call in self._device_calls(program, fu):
                    if self._guarded(fu.cfg, call):
                        continue
                    # A hop guarded at its CALL SITE covers the callee:
                    # the probe checked before descending.
                    if any(self._guarded(src.cfg, site) for src, site in chain):
                        continue
                    key = (fu.path, getattr(call, "lineno", 0))
                    if key in seen:
                        continue
                    seen.add(key)
                    via = (
                        f" (reached from probe {root.qualname} via "
                        f"{_call_chain(chain)})" if chain else ""
                    )
                    if self._is_torch_call(call):
                        yield self.finding(
                            fu.path, call,
                            f"{qualname(call.func)!r} in "
                            f"telemetry probe {root.qualname}{via} without "
                            "the torch.cuda.is_initialized() guard — in a "
                            "process without a CUDA context this CALL "
                            "creates one (device memory and seconds of "
                            "driver start-up in a process that never meant "
                            "to touch the card); check `if not "
                            "torch.cuda.is_initialized(): return` first",
                        )
                        continue
                    yield self.finding(
                        fu.path, call,
                        f"{qualname(call.func)!r} in telemetry probe "
                        f"{root.qualname}{via} without the "
                        "xla_bridge._backends guard — on an uninitialized "
                        "process this CALL initializes the backend (a "
                        "~minutes metadata probe against an absent "
                        "accelerator wedged a worker); check "
                        "`if not xla_bridge._backends: return` first",
                    )


class NondeterministicPartitionRule(ProgramRule):
    """No unordered-set iteration flowing into partition/shard indexing.

    The framework's headline invariant is BIT-IDENTICAL outputs — for any
    worker count, any recovery path, any speculation race. Iterating a
    ``set`` (hash-randomized for str keys) while computing a partition or
    shard index makes the spill ROW ORDER depend on interpreter hash
    state: two attempts of one task then write permuted rows, and the
    "outputs identical" oracle fails only on the rerun nobody can
    reproduce. The shipped pattern sorts first (``for d in sorted(v)``,
    worker/runtime.py); this rule follows values through reaching
    definitions (``pending = seen; for d in pending: ...``) so an alias
    can't hide the set. Dict iteration is insertion-ordered on every
    supported interpreter and deliberately does not fire.
    """

    name = "nondeterministic-partition-input"
    summary = "sort set-typed values before they feed partition/shard indexing"

    _PART_HINT = ("reduce_n", "partition", "shard", "n_part", "nparts",
                  "parts", "buckets")

    def _is_set_expr(self, expr) -> bool:
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return True
        if isinstance(expr, ast.Call) and \
                _last_segment(qualname(expr.func)) in ("set", "frozenset"):
            return True
        return False

    def _partitionish(self, node) -> bool:
        """Does a subtree compute a partition/shard index? ``x % NAME``
        with a partition-hinted NAME, or a subscript into one."""
        for n in walk(node):
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod):
                names = " ".join(
                    q for q in (qualname(n.right), qualname(n.left)) if q
                ).lower()
                if any(h in names for h in self._PART_HINT):
                    return True
            if isinstance(n, ast.Subscript):
                if any(h in qualname(n.value).lower()
                       for h in self._PART_HINT):
                    return True
        return False

    def run_program(self, program):
        from mapreduce_rust_tpu_torch.analysis.dataflow import origins

        for fu in program.functions:
            defs = reach = None
            for n in program._own_walk(fu.node):
                if not isinstance(n, (ast.For, ast.AsyncFor)):
                    continue
                it = n.iter
                set_like = self._is_set_expr(it)
                if not set_like and isinstance(it, ast.Name):
                    if defs is None:
                        defs, reach = fu.rd
                    set_like = any(
                        o is not None and self._is_set_expr(o)
                        for o in origins(fu.cfg, defs, reach, it)
                    )
                if not set_like:
                    continue
                if not (self._partitionish(n) or self._partitionish(it)):
                    continue
                yield self.finding(
                    fu.path, n,
                    "iterating an unordered set into a partition/shard "
                    "index — row order then depends on interpreter hash "
                    "state and two attempts of one task write permuted "
                    "spills, breaking the bit-identical-outputs "
                    "invariant; iterate sorted(...) instead",
                )


class CrossShardFoldRule(ProgramRule):
    """No fold mutations into a DIFFERENT shard's dictionary.

    The sharded egress fold holds exactly one invariant the
    sanitizer can only check at runtime: a function that was handed shard
    index ``i`` folds into shard ``i``'s dictionary and no other — a
    ``shards[j]`` mutation with a foreign index splits one key's dedup and
    collision state across two dictionaries, and the corruption is silent
    until an egress diff. This rule checks it statically: inside any
    function with a shard-index parameter (``shard``/``shard_idx``/
    ``shard_index``/``shard_i``/``s`` — the fold plane's naming), a
    dictionary mutator (``add_scanned_raw``/``add_scanned``/``add_words``/
    ``add_text``/``merge``) whose receiver is — or aliases, via reaching
    definitions (the dataflow layer) — a subscript into a
    shard container (any name mentioning ``shard``) must index it with an
    expression that MENTIONS the shard parameter. The same applies to a
    ``shards[j]`` handed straight to a ``fold``-named helper (the
    one-call-hop shape ``fold_into(self.shards[j], ...)``). Precision over
    recall: ``shards[s]``, aliases of it, and receivers that arrive as
    plain parameters stay silent.
    """

    name = "cross-shard-fold"
    summary = "a shard-indexed function folds only into its own shard"

    _MUTATORS = ("add_scanned_raw", "add_scanned", "add_words", "add_text",
                 "merge")
    _IDX_PARAMS = ("shard", "shard_idx", "shard_index", "shard_i", "s")

    def _shard_param(self, fu) -> "str | None":
        a = fu.node.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            if arg.arg in self._IDX_PARAMS:
                return arg.arg
        return None

    @staticmethod
    def _shard_subscript(expr) -> "ast.Subscript | None":
        if isinstance(expr, ast.Subscript) \
                and "shard" in qualname(expr.value).lower():
            return expr
        return None

    @staticmethod
    def _mentions_param(expr, param: str) -> bool:
        return any(
            isinstance(n, ast.Name) and n.id == param for n in walk(expr)
        )

    def run_program(self, program):
        from mapreduce_rust_tpu_torch.analysis.dataflow import origins

        for fu in program.functions:
            param = self._shard_param(fu)
            if param is None:
                continue
            defs = reach = None
            for n in program._own_walk(fu.node):
                if not isinstance(n, ast.Call):
                    continue
                if isinstance(n.func, ast.Attribute) \
                        and n.func.attr in self._MUTATORS:
                    recv = n.func.value
                    subs = []
                    direct = self._shard_subscript(recv)
                    if direct is not None:
                        subs.append(direct)
                    elif isinstance(recv, ast.Name):
                        if defs is None:
                            defs, reach = fu.rd
                        for o in origins(fu.cfg, defs, reach, recv):
                            so = (
                                self._shard_subscript(o)
                                if o is not None else None
                            )
                            if so is not None:
                                subs.append(so)
                    for sub in subs:
                        if not self._mentions_param(sub.slice, param):
                            yield self.finding(
                                fu.path, n,
                                f"{fu.qualname} received shard index "
                                f"{param!r} but mutates a shard dictionary "
                                "selected by a different index — one key's "
                                "dedup/collision state would silently "
                                "split across two shard dictionaries; fold "
                                f"only into the shard {param!r} names "
                                "(cross-shard work goes back through the "
                                "router)",
                            )
                            break
                    continue
                # One-call-hop shape: shards[j] handed to a fold helper.
                if "fold" not in _last_segment(qualname(n.func)).lower():
                    continue
                for arg in n.args:
                    sub = self._shard_subscript(arg)
                    if sub is not None \
                            and not self._mentions_param(sub.slice, param):
                        yield self.finding(
                            fu.path, n,
                            f"{fu.qualname} received shard index {param!r} "
                            "but hands a DIFFERENT shard's dictionary to a "
                            "fold helper — the callee will mutate a shard "
                            "this thread does not own (cross-shard-fold)",
                        )
                        break


class BlockingIoInFoldRule(ProgramRule):
    """No file I/O reachable from the fold/consumer hot scopes.

    The binary async spill plane exists because
    ``Dictionary._flush_words`` used to sort and WRITE the run file
    inline on the fold/consumer thread — a 15x throughput collapse on the
    spill-engaged Zipf leg that three PRs of telemetry had to find. The
    invariant this rule pins: the fold-side hot scopes (the fold-plane
    thread body, the host-map consumer, the dictionary/accumulator fold
    mutators) hand frozen snapshots to the async writer
    (``AsyncSpillWriter.submit`` — an executor sink, so the handed task
    is invisible to the call graph by design) and never ``open``/
    ``.write``/``.flush``/``np.save`` a file themselves, directly or
    through sync helper frames. Throttled telemetry ticks
    (``maybe_snapshot``/``metrics_tick`` — the flight recorder and the
    metrics sampler own their budgets) are the sanctioned exceptions.
    """

    name = "blocking-io-in-fold"
    summary = "fold/consumer hot scopes do file I/O only via the async writer"

    #: The fold/consumer hot scopes, by the runtime's naming: the fold
    #: plane's per-shard body, the host-map consumer, and every
    #: dictionary/accumulator fold mutator the stream loops call per
    #: window. A rename there must update this list (the fixtures gate it).
    _HOT = (
        "_fold_one", "consume", "fold_scan_into_dictionary",
        "add_scanned_raw", "add_scanned", "add_words", "_insert_hashed",
        "_maybe_flush", "_flush_words", "add_batch", "_flush_run",
    )
    #: Direct file-I/O producers (builtin/module function calls).
    _IO_FUNCS = {
        "open": ("", "io", "os", "gzip", "bz2", "lzma"),
        "save": ("np", "numpy"),
        "savez": ("np", "numpy"),
        "replace": ("os",),
        "rename": ("os",),
        "copyfileobj": ("shutil",),
    }
    #: Methods that write a file handle (receiver must ORIGINATE from an
    #: open() call — reaching defs — or the method stays silent: .write on
    #: buffers/sockets/tracers is not this rule's business).
    _FILE_METHODS = ("write", "flush", "writelines")
    #: Frames whose presence in the chain sanctions the I/O below them:
    #: the flight recorder / metrics sampler ticks are throttled by
    #: contract (their own modules own that budget), and a plane ``submit``
    #: handoff (AsyncSpillWriter / _DispatchPlane) makes everything below
    #: it the plane's business — its sync mode runs the same frames inline
    #: as an explicit opt-in debug/measurement path, not a fold-thread
    #: regression (device-dispatch-in-consumer's doctrine, shared).
    _EXEMPT_FRAMES = ("maybe_snapshot", "metrics_tick", "submit")

    def _io_call(self, call) -> "str | None":
        q = qualname(call.func)
        if not q:
            return None
        last = _last_segment(q)
        roots = self._IO_FUNCS.get(last)
        if roots is None:
            return None
        for root in roots:
            if root == "" and q == last:
                return last
            if root and (q == f"{root}.{last}" or q.endswith(f".{root}.{last}")):
                return f"{root}.{last}"
        return None

    @staticmethod
    def _origin_is_open(o) -> bool:
        return (
            isinstance(o, ast.Call)
            and _last_segment(qualname(o.func)) == "open"
        )

    def run_program(self, program):
        from mapreduce_rust_tpu_torch.analysis.dataflow import origins

        seen: set[tuple[str, int]] = set()
        for root in program.functions:
            if root.name not in self._HOT:
                continue
            frames = [(root, [])] + program.reachable(root)
            for fu, chain in frames:
                if fu.name in self._EXEMPT_FRAMES or any(
                    src.name in self._EXEMPT_FRAMES for src, _call in chain
                ):
                    continue
                defs = reach = None
                for call, _target in program.callees(fu):
                    hit = self._io_call(call)
                    if hit is None and isinstance(call.func, ast.Attribute) \
                            and call.func.attr in self._FILE_METHODS:
                        recv = call.func.value
                        if self._origin_is_open(recv):
                            hit = f"file.{call.func.attr}"
                        elif isinstance(recv, ast.Name):
                            if defs is None:
                                defs, reach = fu.rd
                            if any(
                                self._origin_is_open(o)
                                for o in origins(fu.cfg, defs, reach, recv)
                            ):
                                hit = f"file.{call.func.attr}"
                    if hit is None:
                        continue
                    key = (fu.path, getattr(call, "lineno", 0))
                    if key in seen:
                        continue
                    seen.add(key)
                    via = (
                        f" via {_call_chain(chain)} -> {fu.qualname}"
                        if chain else ""
                    )
                    yield self.finding(
                        fu.path, call,
                        f"{hit!r} reached from fold/consumer hot scope "
                        f"{root.qualname}{via} without going through the "
                        "async spill-writer handoff — inline file I/O on "
                        "the fold thread was the spill-engaged Zipf leg's "
                        "15x collapse; freeze a snapshot and "
                        "AsyncSpillWriter.submit it instead",
                    )


class DeviceDispatchInConsumerRule(ProgramRule):
    """No device dispatch reachable from the consume/fold hot scopes.

    The dispatch plane exists because the host-map consumer
    used to scatter, pack, ``jax.device_put`` and invoke the compiled
    packed merge INLINE per window — ~13 s of the 24 s Zipf leg booked as
    host-glue once everything else had moved off the router. The
    invariant this rule pins (mirroring blocking-io-in-fold's spill
    contract): the
    router-side hot scopes (the host-map consumer, the fold-plane thread
    body, the dictionary fold mutators) hand windows to the dispatch
    plane (``_DispatchPlane.submit`` — the sanctioned sink frame) and
    never reach ``jax.device_put`` or a merge function produced by
    ``make_packed_merge_fn`` themselves, directly or through sync helper
    frames. Chains that pass the plane's ``submit`` are the plane's own
    sync mode — sanctioned by design (that IS the A/B debug path);
    throttled telemetry ticks stay exempt like blocking-io-in-fold.

    Torch twin: the PyTorch host→device hops are ``.to(...)`` with a device
    argument (``device=``, a ``cuda``/``cpu`` string, a name ending in
    ``dev``/``device``, ``torch.device(...)``) or ``non_blocking=``,
    ``.cuda()``, and ``torch.tensor``/``torch.as_tensor`` with
    ``device=``; the hot scopes and exempt frames are the same.
    """

    name = "device-dispatch-in-consumer"
    summary = "consume/fold hot scopes dispatch device work only via the plane"

    #: Router-side hot scopes, by the runtime's naming (a rename there
    #: must update this list — the fixtures gate the semantics).
    _HOT = (
        "consume", "_fold_one", "fold_scan_into_dictionary",
        "add_scanned_raw", "add_scanned", "add_words", "_insert_hashed",
        "route_raw", "route_list",
    )
    #: Device-hop producers: the transfer call by qualname, and any call
    #: through a name that ORIGINATES from make_packed_merge_fn (reaching
    #: defs — `merge_packed = make_packed_merge_fn(...); merge_packed(...)`).
    _DEVICE_FUNCS = ("device_put",)
    _MERGE_FACTORY = "make_packed_merge_fn"
    #: Frames whose presence sanctions the dispatch below them: the
    #: dispatch plane's submit handoff (its sync mode runs the same code
    #: inline — that is the measurement plane, not a violation), plus the
    #: throttled telemetry ticks blocking-io-in-fold also exempts.
    _EXEMPT_FRAMES = ("submit", "maybe_snapshot", "metrics_tick")

    @staticmethod
    def _names_device(arg) -> bool:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value.split(":", 1)[0] in ("cuda", "cpu")
        if isinstance(arg, ast.Call):
            return _last_segment(qualname(arg.func)) == "device"
        last = _last_segment(qualname(arg)).lower()
        return last.endswith(("dev", "device"))

    def _torch_hop(self, call) -> "str | None":
        """The PyTorch host→device hop a call makes, or None."""
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr == "to" and (
                _kw(call, "device") is not None
                or _kw(call, "non_blocking") is not None
                or (call.args and self._names_device(call.args[0]))
            ):
                return ".to(device)"
            if func.attr == "cuda":
                return ".cuda()"
        q = qualname(func)
        if q in ("torch.tensor", "torch.as_tensor") \
                and _kw(call, "device") is not None:
            return f"{q}(device=...)"
        return None

    def _device_call(self, call, fu, defs_reach) -> "str | None":
        q = qualname(call.func)
        if q and _last_segment(q) in self._DEVICE_FUNCS:
            return q
        hop = self._torch_hop(call)
        if hop is not None:
            return hop
        # A call THROUGH a packed-merge closure: receiver name originates
        # from a make_packed_merge_fn(...) call via reaching definitions.
        if isinstance(call.func, ast.Name):
            from mapreduce_rust_tpu_torch.analysis.dataflow import origins

            defs, reach = defs_reach()
            for o in origins(fu.cfg, defs, reach, call.func):
                if (
                    isinstance(o, ast.Call)
                    and _last_segment(qualname(o.func)) == self._MERGE_FACTORY
                ):
                    return f"{self._MERGE_FACTORY}(...) result"
        return None

    def run_program(self, program):
        seen: set[tuple[str, int]] = set()
        for root in program.functions:
            if root.name not in self._HOT:
                continue
            frames = [(root, [])] + program.reachable(root)
            for fu, chain in frames:
                if fu.name in self._EXEMPT_FRAMES or any(
                    src.name in self._EXEMPT_FRAMES for src, _call in chain
                ):
                    continue
                cache: list = []

                def defs_reach(fu=fu, cache=cache):
                    if not cache:
                        cache.append(fu.rd)
                    return cache[0]

                for call, _target in program.callees(fu):
                    hit = self._device_call(call, fu, defs_reach)
                    if hit is None:
                        continue
                    key = (fu.path, getattr(call, "lineno", 0))
                    if key in seen:
                        continue
                    seen.add(key)
                    via = (
                        f" via {_call_chain(chain)} -> {fu.qualname}"
                        if chain else ""
                    )
                    if hit.startswith((".", "torch.")):
                        yield self.finding(
                            fu.path, call,
                            f"{hit!r} reached from consume/fold hot scope "
                            f"{root.qualname}{via} without going through "
                            "the dispatch-plane submit handoff — an inline "
                            "host-to-device copy on the router thread "
                            "stalls every window behind the transfer; hand "
                            "the window to _DispatchPlane.submit instead",
                        )
                        continue
                    yield self.finding(
                        fu.path, call,
                        f"{hit!r} reached from consume/fold hot scope "
                        f"{root.qualname}{via} without going through the "
                        "dispatch-plane submit handoff — an inline device "
                        "hop on the router thread was the ~13s host-glue "
                        "wall of the Zipf leg; hand the window "
                        "to _DispatchPlane.submit instead",
                    )


class UnsampledRangePartitionRule(ProgramRule):
    """Range-partition calls must consume SAMPLER-derived splitters.

    The workload plane's global-sort contract has two legs:
    partition order is key order, and every re-execution derives the SAME
    splitters. Both die the moment a call site hands
    ``range_partition``/``bucket_scatter(mode="range")`` an ad-hoc
    splitter array: a literal (or a name assigned from one) is divorced
    from the corpus distribution — partitions silently skew — and any
    non-shared derivation can disagree between a task and its recovery
    attempt, routing one key to two partitions (the mrcheck-invisible
    corruption: both attempts "succeed"). Legitimate splitters flow from
    exactly two places: the shared sampler (runtime/splitter.py —
    ``derive_splitters``/``corpus_splitters``/``splitters_for_job``) or
    an app's bound ``.splitters`` attribute, which only
    ``splitter.prepare_app`` writes. This rule follows the splitters
    argument through reaching definitions and flags literal-container
    provenance; values it cannot resolve (parameters, foreign calls)
    stay silent — precision over recall, per the module doctrine.
    """

    name = "unsampled-range-partition"
    summary = "range-partition splitters must come from the shared sampler"

    #: The sampler's producing functions (runtime/splitter.py) — the OK
    #: provenance, alongside a ``.splitters`` attribute read (bound-app).
    _SAMPLER_FUNCS = ("derive_splitters", "corpus_splitters",
                      "splitters_for_job")
    _RANGE_FUNCS = ("range_partition",)

    def _splitter_arg(self, call: ast.Call) -> "ast.expr | None":
        """The splitters expression of a range-partition call site."""
        seg = _last_segment(qualname(call.func))
        if seg in self._RANGE_FUNCS:
            kw = _kw(call, "splitters")
            if kw is not None:
                return kw
            return call.args[1] if len(call.args) > 1 else None
        if seg == "bucket_scatter":
            mode = _kw(call, "mode")
            if not (isinstance(mode, ast.Constant) and mode.value == "range"):
                return None  # hash mode: no splitters to audit
            return _kw(call, "splitters") or (
                call.args[4] if len(call.args) > 4 else None
            )
        return None

    def _provenance(self, expr) -> "str | None":
        """"ok" (sampler/bound-app mention), "literal" (container built
        in place), or None (unresolvable here)."""
        verdict = None
        for n in walk(expr):
            if isinstance(n, ast.Call) and \
                    _last_segment(qualname(n.func)) in self._SAMPLER_FUNCS:
                return "ok"
            if isinstance(n, ast.Attribute) and n.attr == "splitters":
                return "ok"  # the bound-app seam: prepare_app-written
            if isinstance(n, (ast.List, ast.Tuple, ast.Set, ast.ListComp)):
                verdict = "literal"
        return verdict

    def run_program(self, program):
        from mapreduce_rust_tpu_torch.analysis.dataflow import origins

        for fu in program.functions:
            defs = reach = None
            for call, _target in program.callees(fu):
                arg = self._splitter_arg(call)
                if arg is None:
                    continue
                prov = self._provenance(arg)
                if prov is None and isinstance(arg, ast.Name):
                    if defs is None:
                        defs, reach = fu.rd
                    for o in origins(fu.cfg, defs, reach, arg):
                        p = self._provenance(o) if o is not None else None
                        if p == "ok":
                            prov = "ok"
                            break
                        if p == "literal":
                            prov = "literal"
                if prov != "literal":
                    continue
                yield self.finding(
                    fu.path, call,
                    "range partition fed ad-hoc literal splitters — "
                    "partitions then ignore the corpus distribution and "
                    "a re-executed task may derive DIFFERENT routing "
                    "than its first attempt; derive them with the shared "
                    "sampler (runtime/splitter.derive_splitters / "
                    "splitters_for_job, or the app's prepare_app-bound "
                    ".splitters)",
                )


class UnreapedJobLabelsRule(ProgramRule):
    """Per-job labeled metric series must have a reachable reap.

    The multi-tenant service publishes ``job=<id>``-labeled gauges
    (phase progress, tenant attribution) — one labeled child per live
    job. Labels are an unbounded cardinality dimension: without a
    matching ``remove_labels(job=...)`` on the job's teardown path,
    every job that ever ran stays a live series forever, the Prometheus
    scrape body grows without bound, and the registry lock is held
    longer on every tick (the slow leak the fleet plane would
    itself be built on). The contract: any CLASS whose methods write a
    mutator (``set``/``inc``/``observe``/``set_total``/``set_hist``)
    with a ``job=`` kwarg must also, somewhere in its method set or
    their sync call closure, call ``remove_labels``. Module-level
    functions stay silent — a free function has no teardown seam to
    anchor the reap to, and the repo's labeled writers are all
    class-owned ticks.
    """

    name = "unreaped-job-labels"
    summary = "job=-labeled metric writes need a reachable remove_labels reap"

    _MUTATORS = ("set", "inc", "observe", "set_total", "set_hist")

    def _job_label_sites(self, fu):
        """Mutator calls carrying a ``job=`` kwarg, by direct AST walk —
        qualname() cannot render call-containing receiver chains like
        ``self.registry.gauge(...).set(...)``, so the verb + kwarg shape
        is the detector."""
        for n in walk(fu.node):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in self._MUTATORS
                and any(kw.arg == "job" for kw in n.keywords)
            ):
                yield n

    @staticmethod
    def _has_reap(fu) -> bool:
        return any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "remove_labels"
            for n in walk(fu.node)
        )

    def run_program(self, program):
        by_class: dict[tuple, list] = {}
        for fu in program.functions:
            if "." not in fu.qualname:
                continue  # free function: no teardown seam to demand
            cls = fu.qualname.rsplit(".", 1)[0]
            by_class.setdefault((fu.path, cls), []).append(fu)
        for (path, cls), methods in sorted(by_class.items()):
            sites = [
                (fu, call) for fu in methods
                for call in self._job_label_sites(fu)
            ]
            if not sites:
                continue
            sanctioned = any(self._has_reap(fu) for fu in methods)
            if not sanctioned:
                for fu in methods:
                    if any(
                        self._has_reap(reached)
                        for reached, _chain in program.reachable(fu)
                    ):
                        sanctioned = True
                        break
            if sanctioned:
                continue
            fu, call = sites[0]
            yield self.finding(
                path, call,
                f"{cls} registers job=-labeled series "
                f"({len(sites)} write site(s)) but no method reaches "
                "remove_labels — every job that ever ran stays a live "
                "labeled child and the scrape body grows without bound; "
                "reap with registry.<instrument>.remove_labels(job=...) "
                "on the job's teardown path",
            )


class FifoPollInSchedulerRule(ProgramRule):
    """Scheduler grant loops must consult the scoring seam.

    The pipeline scheduler replaced the service's admission-order job
    polling with a
    scored candidate order (``_sched_order``: priority class, phase
    criticality, worker recent-job affinity). The shipped-bug shape is
    the old ``JobService.get_task``: a ``for job in <running …>:`` loop
    inside a scheduler-named scope that calls the per-phase grant RPCs
    directly — admission order silently decides fleet placement again,
    reintroducing the barrier bubbles the pipeline scheduler exists to
    fill, and the regression is invisible (every output stays correct,
    only ``fleet_bubble_frac`` drifts up). Sanctioned shape: the scope
    consults the seam — mentions ``_sched_order``/``sched_pipeline`` or
    a score — anywhere in its body; FIFO-as-oracle then lives INSIDE the
    seam, not beside it.
    """

    name = "fifo-poll-in-scheduler"
    summary = ("scheduler grant loops must consult the scoring seam, "
               "not admission order")

    _GRANTS = ("get_map_task", "get_reduce_task")
    _SEAMS = ("_sched_order", "sched_order", "sched_pipeline")

    @staticmethod
    def _scheduler_scope(fu) -> bool:
        q = fu.qualname.lower()
        return "sched" in q or q.rsplit(".", 1)[-1] == "get_task"

    def run_program(self, program):
        for fu in program.functions:
            if not self._scheduler_scope(fu):
                continue
            if any(_mentions(fu.node, s) for s in self._SEAMS) \
                    or _mentions(fu.node, "score", substring=True):
                continue
            for n in walk(fu.node):
                if not isinstance(n, (ast.For, ast.AsyncFor)):
                    continue
                if not _mentions(n.iter, "running", substring=True):
                    continue
                if not any(
                    isinstance(c, ast.Call)
                    and isinstance(c.func, ast.Attribute)
                    and c.func.attr in self._GRANTS
                    for c in walk(n)
                ):
                    continue
                yield self.finding(
                    fu.path, n,
                    f"{fu.qualname} grants tasks in admission order — a "
                    "`for … in running` poll loop that never consults "
                    "the scoring seam; iterate _sched_order(wid) "
                    "(priority, phase criticality, worker affinity) so "
                    "one job's map windows can fill another's barrier "
                    "bubbles, with FIFO kept as a mode inside the seam",
                )
                break  # one finding per scope names the class of bug


class RpcArgCompatRule(ProgramRule):
    """Every parameter of an RPC handler beyond its first operand must be
    trailing-with-default.

    Incident class: the coordinator/service wire protocol is positional
    JSON-RPC frames from workers of MIXED vintages — a rolling fleet
    restart always has old workers calling new servers. The shipped
    handlers grew ``wid=-1``, ``sample=None``, ``job=None`` one at a time
    precisely so an old caller's shorter frame still binds; ONE required
    parameter added mid-signature and every pre-upgrade worker's
    ``renew_map_lease(tid, wid)`` dies server-side as a TypeError that
    telemetry records as a stale renewal storm. The RPC surface is
    whatever the class's own ``_METHODS`` table exports — the rule reads
    that table, so a new handler is covered the moment it is wired.
    """

    name = "rpc-arg-compat"
    summary = ("RPC handler params beyond the first must be "
               "trailing-with-default (mixed-vintage wire compat)")

    @staticmethod
    def _methods_literal(cls: ast.ClassDef) -> "set[str] | None":
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "_METHODS"
                    for t in stmt.targets):
                names = {
                    n.value for n in walk(stmt.value)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)
                }
                return names or None
        return None

    def run_program(self, program):
        for path, tree in program.files:
            for cls in walk(tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                methods = self._methods_literal(cls)
                if not methods:
                    continue
                for fn in cls.body:
                    if not isinstance(fn, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                        continue
                    if fn.name not in methods:
                        continue
                    yield from self._check_signature(path, cls, fn)

    def _check_signature(self, path, cls, fn):
        a = fn.args
        pos = list(a.posonlyargs) + list(a.args)
        if pos and pos[0].arg in ("self", "cls"):
            pos = pos[1:]
        required = len(pos) - len(a.defaults)
        for i, arg in enumerate(pos):
            if 1 <= i < required:
                yield self.finding(
                    path, arg,
                    f"RPC handler {cls.name}.{fn.name} parameter "
                    f"{arg.arg!r} is required — a positional wire frame "
                    "from a pre-upgrade worker omits it and the call "
                    "dies as a server-side TypeError; new RPC params "
                    "must be trailing-with-default",
                )
        for arg, default in zip(a.kwonlyargs, a.kw_defaults):
            if default is None:
                yield self.finding(
                    path, arg,
                    f"RPC handler {cls.name}.{fn.name} keyword-only "
                    f"parameter {arg.arg!r} has no default — positional "
                    "wire frames can never supply it, so every caller "
                    "of any vintage fails; give it a default",
                )


class UnnamedPlaneThreadRule(Rule):
    """Plane threads must be named at creation (``name=`` /
    ``thread_name_prefix=``).

    Incident: the sampling profiler attributes collapsed stacks
    by thread name, and the sanitizer's ownership messages print thread
    names — but the ingest producer and the ingest scan pool rendered as
    ``Thread-N``/``ThreadPoolExecutor-0_1``, so their samples landed in
    the unattributable ``other`` plane and ownership reports named
    nobody. Satellite 1 put every plane thread on the stable ``mr/``
    scheme; this rule keeps the next thread on it. Scoped to the
    installed package: test harness threads don't feed profiles.
    """

    name = "unnamed-plane-thread"
    summary = "threading.Thread/ThreadPoolExecutor in the package needs " \
              "name=/thread_name_prefix="

    def run(self, tree, src, path):
        parts = path.replace("\\", "/").split("/")
        if not _PACKAGES.intersection(parts):
            return
        for node in walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = _last_segment(qualname(node.func))
            if fn == "Thread" and _kw(node, "name") is None:
                yield self.finding(
                    path, node,
                    "threading.Thread without name= — the profiler "
                    "attributes samples by thread name and the sanitizer "
                    "names owners; use the mr/ plane scheme "
                    "(mr/scan-0, mr/fold-2, mr/spill-acc, mr/dispatch)",
                )
            elif (fn == "ThreadPoolExecutor"
                    and _kw(node, "thread_name_prefix") is None):
                yield self.finding(
                    path, node,
                    "ThreadPoolExecutor without thread_name_prefix= — "
                    "its workers render as ThreadPoolExecutor-N_M and "
                    "profile into the unattributable 'other' plane; "
                    "use the mr/ plane scheme",
                )


class AdHocCorpusDigestRule(Rule):
    """Corpus/chunk bytes get hashed through the lineage seam, not
    ad-hoc hashlib calls.

    Incident: the provenance plane keys everything — forward and
    backward queries, the blast-radius diff, the service result-cache
    cross-check — on ONE pair of digest definitions
    (``runtime.lineage.chunk_digest`` over raw chunk bytes,
    ``corpus_fingerprint`` over name:size:mtime metadata). A second
    ad-hoc digest of the same bytes elsewhere drifts independently
    (different algorithm, different truncation, pre- vs post-
    normalization bytes) and the planes silently stop agreeing: a cache
    hit keyed one way can't be cross-checked against a ledger keyed the
    other. Scoped to the installed package; the lineage module itself
    and the service's ``scan_corpus`` seam (which IS the metadata
    fingerprint) are the two legitimate homes.
    """

    name = "ad-hoc-corpus-digest"
    summary = "hashlib over corpus/chunk bytes outside the " \
              "runtime.lineage digest seam"

    CTORS = {"blake2b", "sha256", "sha1", "md5", "sha512", "sha3_256"}
    HOT = ("chunk", "window", "payload", "corpus")
    EXEMPT_FUNCS = {"scan_corpus", "scan_corpus_spec"}

    def _hot_arg(self, node) -> "str | None":
        """First plain Name in the subtree whose id smells like corpus
        bytes. Names only — attribute mentions like cfg.chunk_bytes are
        shape knobs feeding config fingerprints, not the bytes
        themselves."""
        for n in walk(node):
            if isinstance(n, ast.Name):
                low = n.id.lower()
                if any(w in low for w in self.HOT):
                    return n.id
        return None

    def run(self, tree, src, path):
        parts = path.replace("\\", "/").split("/")
        if not _PACKAGES.intersection(parts):
            return
        if "/".join(parts[-2:]) == "runtime/lineage.py":
            return
        exempt: set[int] = set()
        hashed: set[str] = set()
        for node in walk(tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in self.EXEMPT_FUNCS):
                exempt.update(id(n) for n in walk(node))
            elif (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and _last_segment(
                        qualname(node.value.func)) in self.CTORS):
                hashed.update(t.id for t in node.targets
                              if isinstance(t, ast.Name))
        for node in walk(tree):
            if not isinstance(node, ast.Call) or id(node) in exempt:
                continue
            fn = _last_segment(qualname(node.func))
            is_ctor = fn in self.CTORS
            is_update = (
                fn == "update" and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in hashed
            )
            if not (is_ctor or is_update) or not node.args:
                continue
            hot = self._hot_arg(node.args[0])
            if hot is None:
                continue
            yield self.finding(
                path, node,
                f"ad-hoc {fn}(...{hot}...) digest of corpus/chunk bytes "
                "— every plane keys on the lineage seam; use "
                "runtime.lineage.chunk_digest for content or "
                "corpus_fingerprint for file metadata so digests stay "
                "comparable across the ledger, the result cache, and "
                "the coordinator journal",
            )


ALL_RULES: list[Rule] = [
    StatsOwnershipRule(),
    ExecutorTeardownRule(),
    TmpdirCleanupRule(),
    DonationSafetyRule(),
    A2APurityRule(),
    SpanBalanceRule(),
    SpilledDictApiRule(),
    JitInLoopRule(),
    PsumReplicatedFlagRule(),
    UnboundedRetryRule(),
    MetricInHotLoopRule(),
    NakedClockInControlPlaneRule(),
    UnnamedPlaneThreadRule(),
    AdHocCorpusDigestRule(),
]

#: Interprocedural rules: run once per lint over the whole file set, on
#: the shared dataflow layer. Kept separate so ``lint_file`` (single-file
#: consumers, fixture tests) stays cheap and self-contained.
PROGRAM_RULES: list[ProgramRule] = [
    BlockingInAsyncRule(),
    BackendInitInProbeRule(),
    NondeterministicPartitionRule(),
    CrossShardFoldRule(),
    BlockingIoInFoldRule(),
    DeviceDispatchInConsumerRule(),
    UnsampledRangePartitionRule(),
    UnreapedJobLabelsRule(),
    FifoPollInSchedulerRule(),
    RpcArgCompatRule(),
]
