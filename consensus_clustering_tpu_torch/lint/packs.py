# Copied from consensus_clustering_tpu/lint/packs.py.
"""Serve-concurrency, import-hygiene and test-budget rule packs
(JL011-JL015, JL018).

These rules encode invariants of THIS repo's serving stack rather than
universal JAX hazards (those live in lint/rules.py).  Each is a
discipline-only rule that at least one review pass has re-found by
hand — see docs/LINT.md for the bite history per rule.  The registry's
prime directive applies doubly here, because concurrency analysis is
easy to over-trigger: every rule prefers missing a finding over
inventing one, and skips entirely when its structural anchors
(a ``threading.Thread(target=self._x)`` root, a PEP-562 ``__getattr__``,
a declared stdlib-only path) are absent.

Cross-FILE contract rules (JL016/JL017) live in lint/contracts.py;
this module is per-file analysis only.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from consensus_clustering_tpu_torch.lint.findings import Finding
from consensus_clustering_tpu_torch.lint.registry import (
    ModuleContext,
    Rule,
    path_components,
    register,
)

# -- shared helpers ---------------------------------------------------------


def _in_serve(path: str) -> bool:
    return "serve" in path_components(path)


def _self_attr(node: ast.AST, names: Iterable[str]) -> bool:
    """True for ``self.<name>`` where name is in ``names``."""
    return (
        isinstance(node, ast.Attribute)
        and node.attr in names
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    )


def _attr_chain(node: ast.AST) -> List[str]:
    """``self.leases.claim_orphan`` -> ["self", "leases", "claim_orphan"];
    [] when the chain is not rooted in a plain Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def _walk_skip_functions(node: ast.AST):
    """Descendants of ``node``, not descending into nested function
    definitions (separate scopes analysed on their own)."""
    func_types = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
    for child in ast.iter_child_nodes(node):
        yield child
        if isinstance(child, func_types):
            continue
        yield from _walk_skip_functions(child)


# -- JL011: unfenced-store-write --------------------------------------------

#: Jobstore calls that mutate durable job state.  Read-side calls
#: (load_job, get_result, iter_jobs, ...) and lease-file bookkeeping
#: (gc_stale_leases, claim_profile) are deliberately absent.
STORE_MUTATORS = frozenset({
    "save_job",
    "delete_job",
    "save_payload",
    "delete_payload",
    "set_payload_attempts",
    "clear_checkpoints",
    "put_result",
})

#: A call to either of these earlier in the same function counts as a
#: dominating fence: ``self._fence(job_id, op)`` raises LeaseLost when
#: a peer superseded the lease, and ``claim_orphan`` only returns truthy
#: after WINNING a fencing token — ownership is the fence.
FENCE_CALLS = frozenset({"_fence", "claim_orphan"})


@register
class ServeUnfencedStoreWrite(Rule):
    """JL011 — a state-mutating jobstore call on a worker-thread-reachable
    path with no dominating fence in the same function.

    Roots are the methods a serve-module class hands to
    ``threading.Thread(target=self._x)``; reachability follows
    ``self._y()`` calls inside the class.  A write is fenced if a
    ``self._fence(...)`` or ``...claim_orphan(...)`` call appears
    earlier (lexically) in the same function.  Classes that start no
    threads produce no findings, and writes in API-side methods that
    workers never reach are out of scope — prefer a miss.
    """

    id = "JL011"
    name = "unfenced-store-write"
    summary = (
        "worker-reachable jobstore write without a dominating "
        "self._fence(...) / claim_orphan ownership win"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if not _in_serve(ctx.path):
            return []
        findings: List[Finding] = []
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                findings.extend(self._check_class(ctx, cls))
        return findings

    def _check_class(
        self, ctx: ModuleContext, cls: ast.ClassDef
    ) -> List[Finding]:
        methods: Dict[str, ast.AST] = {
            stmt.name: stmt
            for stmt in cls.body
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        roots = self._thread_target_methods(ctx, cls, methods)
        if not roots:
            return []
        reachable = self._reachable(methods, roots)
        findings: List[Finding] = []
        for name in sorted(reachable):
            findings.extend(
                self._check_method(ctx, name, methods[name])
            )
        return findings

    def _thread_target_methods(
        self,
        ctx: ModuleContext,
        cls: ast.ClassDef,
        methods: Dict[str, ast.AST],
    ) -> Set[str]:
        roots: Set[str] = set()
        for node in ast.walk(cls):
            if not isinstance(node, ast.Call):
                continue
            qual = ctx.resolve_call(node)
            if qual not in ("threading.Thread", "Thread"):
                continue
            for kw in node.keywords:
                if kw.arg == "target" and _self_attr(
                    kw.value, methods
                ):
                    roots.add(kw.value.attr)
        return roots

    def _reachable(
        self, methods: Dict[str, ast.AST], roots: Set[str]
    ) -> Set[str]:
        seen: Set[str] = set()
        frontier = sorted(roots)
        while frontier:
            name = frontier.pop()
            if name in seen:
                continue
            seen.add(name)
            for node in ast.walk(methods[name]):
                if (
                    isinstance(node, ast.Call)
                    and _self_attr(node.func, methods)
                    and node.func.attr not in seen
                ):
                    frontier.append(node.func.attr)
        return seen

    def _check_method(
        self, ctx: ModuleContext, name: str, method: ast.AST
    ) -> List[Finding]:
        fence_lines: List[int] = []
        writes: List[Tuple[ast.Call, str]] = []
        for node in ast.walk(method):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if not chain:
                continue
            if chain[-1] in FENCE_CALLS:
                fence_lines.append(node.lineno)
            elif (
                chain[-1] in STORE_MUTATORS
                and len(chain) >= 3
                and chain[0] == "self"
                and chain[-2] in ("store", "_store")
            ):
                writes.append((node, chain[-1]))
        if not writes:
            return []
        first_fence = min(fence_lines) if fence_lines else None
        out: List[Finding] = []
        for call, mutator in writes:
            if first_fence is not None and first_fence <= call.lineno:
                continue
            out.append(ctx.finding(
                self.id, call,
                f"jobstore write .{mutator}(...) in worker-reachable "
                f"{name}() with no dominating self._fence(...) or "
                "claim_orphan ownership win — a superseded lease could "
                "still land this write (docs/SERVING.md multi-worker "
                "runbook)",
            ))
        return out


# -- JL012: lock-order-inversion --------------------------------------------

#: Scheduler-side lock attribute; the fair queue's condition is
#: ``_cond`` (serve/sched/fairshare.py) and queue access goes through
#: ``self._queue`` / ``self.queue``.
_SCHED_LOCKS = ("_lock", "lock")
_QUEUE_ATTRS = ("_queue", "queue")
_COND_ATTRS = ("_cond", "cond")


@register
class ServeLockOrderInversion(Rule):
    """JL012 — touching the queue/condition while holding ``self._lock``.

    The documented order (see the comment above the queue reads
    in ``Scheduler.metrics``) is queue-cond BEFORE the scheduler lock,
    or neither nested: the fair queue's ``take_matching`` holds its
    condition while the scheduler separately holds ``_lock``, so
    nesting the other way deadlocks under contention.  Flags any call
    on ``self._queue``/``self.queue``, and any ``with self._cond``-like
    acquisition, lexically inside a ``with self._lock:`` body.
    """

    id = "JL012"
    name = "lock-order-inversion"
    summary = (
        "queue/condition acquired while self._lock is held "
        "(documented order: queue-cond before _lock)"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if not _in_serve(ctx.path):
            return []
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(
                _self_attr(item.context_expr, _SCHED_LOCKS)
                for item in node.items
            ):
                continue
            for stmt in node.body:
                for inner in [stmt, *_walk_skip_functions(stmt)]:
                    found = self._inversion(ctx, inner)
                    if found is not None:
                        findings.append(found)
        return findings

    def _inversion(
        self, ctx: ModuleContext, node: ast.AST
    ) -> Optional[Finding]:
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if (
                len(chain) >= 3
                and chain[0] == "self"
                and any(a in _QUEUE_ATTRS for a in chain[1:-1])
            ):
                return ctx.finding(
                    self.id, node,
                    f"queue call .{chain[-1]}(...) while holding "
                    "self._lock — the queue condition must be taken "
                    "BEFORE the scheduler lock, never inside it",
                )
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                chain = _attr_chain(item.context_expr)
                if chain and chain[0] == "self" and any(
                    a in _COND_ATTRS or a in _QUEUE_ATTRS
                    for a in chain[1:]
                ):
                    return ctx.finding(
                        self.id, item.context_expr,
                        "condition acquired while holding self._lock — "
                        "documented order is queue-cond before _lock",
                    )
        return None


# -- JL013: unsupervised-thread ---------------------------------------------


@register
class ServeUnsupervisedThread(Rule):
    """JL013 — a ``threading.Thread(...)`` in a serve module with no
    ``daemon=`` decision.

    A non-daemon worker thread turns every crash into a hang: the
    process survives its own failure, holding its lease until expiry
    and blocking interpreter exit.  Every thread in serve/ must make
    its supervision story explicit — ``daemon=True`` plus the watchdog/
    lease machinery, or a visible ``t.daemon = ...`` assignment in the
    same scope.
    """

    id = "JL013"
    name = "unsupervised-thread"
    summary = "threading.Thread(...) without an explicit daemon= decision"

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if not _in_serve(ctx.path):
            return []
        findings: List[Finding] = []
        scopes: List[ast.AST] = [ctx.tree] + [
            f.node for f in ctx.functions
        ]
        for scope in scopes:
            findings.extend(self._check_scope(ctx, scope))
        return findings

    def _check_scope(
        self, ctx: ModuleContext, scope: ast.AST
    ) -> List[Finding]:
        body = getattr(scope, "body", None)
        if body is None:
            return []
        nodes = [
            n
            for stmt in (body if isinstance(body, list) else [body])
            for n in [stmt, *_walk_skip_functions(stmt)]
        ]
        bare: List[Tuple[ast.Call, Optional[str]]] = []
        daemon_set: Set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if (
                        isinstance(target, ast.Attribute)
                        and target.attr == "daemon"
                        and isinstance(target.value, ast.Name)
                    ):
                        daemon_set.add(target.value.id)
            if isinstance(node, ast.Call):
                qual = ctx.resolve_call(node)
                if qual not in ("threading.Thread", "Thread"):
                    continue
                if any(kw.arg == "daemon" for kw in node.keywords):
                    continue
                bare.append((node, None))
        if not bare:
            return []
        # Map thread calls assigned to a name whose .daemon is set in
        # this scope: `t = Thread(...); t.daemon = True` is supervised.
        assigned: Dict[int, str] = {}
        for node in nodes:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        assigned[id(node.value)] = target.id
        out: List[Finding] = []
        for call, _ in bare:
            if assigned.get(id(call)) in daemon_set:
                continue
            out.append(ctx.finding(
                self.id, call,
                "threading.Thread(...) without daemon= — an "
                "unsupervised thread outlives crashes and blocks "
                "shutdown; pass daemon=True (workers are supervised "
                "by the lease/watchdog layer)",
            ))
        return out


# -- JL014: stdlib-pin-violation --------------------------------------------

#: Modules pinned stdlib-only so forensics work on a wedged host with
#: no accelerator stack (runtime-enforced today by `-X importtime`
#: subprocess tests in tests/test_hostile.py; this rule catches the
#: drift at lint time).  Files match by path suffix, directories by
#: consecutive path components, so fixture trees exercise the rule.
STDLIB_ONLY_FILE_SUFFIXES = (
    "estimator/bounds.py",
    "serve/leases.py",
    "serve/admin.py",
    "serve/events.py",
)
STDLIB_ONLY_DIR_COMPONENTS = (
    ("obs",),
    ("serve", "sched"),
    ("lint",),
)

HEAVY_IMPORT_ROOTS = frozenset({
    "numpy", "jax", "scipy", "sklearn", "pandas",
})


def _in_stdlib_only_set(path: str) -> bool:
    normalized = path.replace("\\", "/")
    if any(normalized.endswith(s) for s in STDLIB_ONLY_FILE_SUFFIXES):
        return True
    comps = path_components(path)
    for want in STDLIB_ONLY_DIR_COMPONENTS:
        n = len(want)
        for i in range(len(comps) - n):
            # Directory components only: the file name itself never
            # counts (tests/test_lint.py is not in a `lint/` dir).
            if tuple(comps[i:i + n]) == want:
                return True
    return False


def _is_type_checking(ctx: ModuleContext, test: ast.AST) -> bool:
    qual = ctx.resolve(test)
    return qual in ("TYPE_CHECKING", "typing.TYPE_CHECKING")


def _module_level_imports(ctx: ModuleContext) -> List[ast.stmt]:
    """Import statements executed at module import time: module body,
    descending through If (minus TYPE_CHECKING arms), Try, With and
    class bodies, but never into functions."""
    out: List[ast.stmt] = []

    def visit(stmts: List[ast.stmt]) -> None:
        for s in stmts:
            if isinstance(s, (ast.Import, ast.ImportFrom)):
                out.append(s)
            elif isinstance(s, ast.If):
                if not _is_type_checking(ctx, s.test):
                    visit(s.body)
                visit(s.orelse)
            elif isinstance(s, ast.Try):
                visit(s.body)
                visit(s.orelse)
                visit(s.finalbody)
                for h in s.handlers:
                    visit(h.body)
            elif isinstance(s, (ast.With, ast.AsyncWith)):
                visit(s.body)
            elif isinstance(s, ast.ClassDef):
                visit(s.body)

    visit(ctx.tree.body)
    return out


def _heavy_roots_of(stmt: ast.stmt) -> List[str]:
    roots: List[str] = []
    if isinstance(stmt, ast.Import):
        for a in stmt.names:
            root = a.name.split(".")[0]
            if root in HEAVY_IMPORT_ROOTS:
                roots.append(root)
    elif isinstance(stmt, ast.ImportFrom) and stmt.level == 0:
        root = (stmt.module or "").split(".")[0]
        if root in HEAVY_IMPORT_ROOTS:
            roots.append(root)
    return roots


@register
class StdlibPinViolation(Rule):
    """JL014 — a module-level numpy/jax-family import in a module
    declared stdlib-only.

    The forensic layer (obs/*), the lease files, the fair-share queue
    and jaxlint itself are the tools you reach for when the accelerator
    stack is the PROBLEM — they must import in milliseconds on a host
    where ``import jax`` hangs or OOMs.  ``-X importtime`` subprocess
    tests enforce this at runtime; this rule moves the failure to lint
    time and names the import.  ``if TYPE_CHECKING:`` imports are fine.
    """

    id = "JL014"
    name = "stdlib-pin-violation"
    summary = (
        "module-level heavy import (numpy/jax/...) in a declared "
        "stdlib-only module"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if not _in_stdlib_only_set(ctx.path):
            return []
        findings: List[Finding] = []
        for stmt in _module_level_imports(ctx):
            for root in _heavy_roots_of(stmt):
                findings.append(ctx.finding(
                    self.id, stmt,
                    f"module-level import of {root} in a stdlib-only "
                    "module — this file must import on a wedged host "
                    "with no accelerator stack (tests/test_hostile.py "
                    "importtime pins); defer the import into the "
                    "function that needs it",
                ))
        return findings


# -- JL015: eager-subpackage-import -----------------------------------------


@register
class EagerSubpackageImport(Rule):
    """JL015 — an eager heavy import in a PEP-562 lazy ``__init__.py``.

    A package that declares ``__getattr__``/``_EXPORTS`` promises that
    ``import pkg`` is cheap and submodules load on first attribute use.
    A module-level import of numpy/jax — or of a module listed in
    ``_EXPORTS`` itself — silently breaks that promise for every
    importer (the serve-admin CLI's startup budget rides on it).
    Non-lazy ``__init__`` files (no module-level ``__getattr__``) are
    out of scope.
    """

    id = "JL015"
    name = "eager-subpackage-import"
    summary = (
        "eager heavy or lazily-exported import in a PEP-562 lazy "
        "package __init__"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        comps = path_components(ctx.path)
        if not comps or comps[-1] != "__init__.py":
            return []
        has_getattr = any(
            isinstance(s, ast.FunctionDef) and s.name == "__getattr__"
            for s in ctx.tree.body
        )
        if not has_getattr:
            return []
        lazy_targets = self._export_targets(ctx)
        findings: List[Finding] = []
        for stmt in _module_level_imports(ctx):
            for root in _heavy_roots_of(stmt):
                findings.append(ctx.finding(
                    self.id, stmt,
                    f"eager module-level import of {root} in a PEP-562 "
                    "lazy __init__ — every importer of this package "
                    "pays it; move it behind __getattr__",
                ))
            for mod in self._imported_modules(stmt):
                if mod in lazy_targets:
                    findings.append(ctx.finding(
                        self.id, stmt,
                        f"eager import of {mod}, which _EXPORTS "
                        "declares lazy — the import defeats the "
                        "package's own deferral",
                    ))
        return findings

    @staticmethod
    def _export_targets(ctx: ModuleContext) -> Set[str]:
        targets: Set[str] = set()
        for stmt in ctx.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == "_EXPORTS"
                for t in stmt.targets
            ):
                continue
            if isinstance(stmt.value, ast.Dict):
                for v in stmt.value.values:
                    if isinstance(v, ast.Constant) and isinstance(
                        v.value, str
                    ):
                        targets.add(v.value)
        return targets

    @staticmethod
    def _imported_modules(stmt: ast.stmt) -> List[str]:
        if isinstance(stmt, ast.Import):
            return [a.name for a in stmt.names]
        if isinstance(stmt, ast.ImportFrom) and stmt.module:
            return [stmt.module]
        return []


# -- JL018: unmarked-compile-bearing-test -----------------------------------

#: Free-function sweep entry points (matched on the LAST dotted
#: component after alias resolution): calling one of these IS running
#: a compiled sweep.
SWEEP_ENTRY_TAILS = frozenset({
    "run_sweep",
    "run_streaming_sweep",
    "build_sweep",
    "run_pair_estimate",
})

#: Engine/executor classes whose CONSTRUCTION is cheap and host-only
#: (fingerprint shaping, admission math) — only *executing* one
#: compiles.  A test triggers when it calls one of ``_RUN_METHODS`` on
#: an instance it visibly constructed; construction alone never fires
#: (tests/test_progressive.py shapes results through a real
#: SweepExecutor without ever compiling).
ENGINE_CONSTRUCTOR_TAILS = frozenset({
    "SweepExecutor",
    "StreamingSweep",
    "PairConsensusEngine",
    "ConsensusClustering",
})

_RUN_METHODS = frozenset({"run", "fit"})

#: Evidence a test runs against stubs, not real engines: any of these
#: substrings (case-insensitive) in the test's own source or in a
#: module-local helper it calls.  Stub-based tests construct
#: API-shaped objects without compiling anything.
_STUB_EVIDENCE_RE = re.compile(r"stub|fake|mock|dummy", re.IGNORECASE)

_SLOW_MARK_ATTRS = ("slow", "skip")


def _has_slow_mark(decorators: List[ast.expr]) -> bool:
    for dec in decorators:
        for node in ast.walk(dec):
            if (
                isinstance(node, ast.Attribute)
                and node.attr in _SLOW_MARK_ATTRS
            ):
                return True
    return False


@register
class UnmarkedCompileBearingTest(Rule):
    """JL018 — a test function that builds a real compiled sweep without
    ``@pytest.mark.slow``.

    The tier-1 fast lane runs ~715 tests in ~825 s of an 870 s budget
    (ROADMAP.md re-anchor note): ONE unmarked engine-scale compile can
    push it over the timeout for every future PR.  Triggers when the
    test (or a module-local helper it calls) either calls a sweep entry
    function (``SWEEP_ENTRY_TAILS``) or runs an engine it visibly
    constructed (``ENGINE_CONSTRUCTOR_TAILS`` + ``.run``/``.fit``);
    skips tests with stub evidence (stub/fake/mock/dummy in the code
    they run) and anything already slow- or skip-marked at function,
    class or module level.  The fast lane's rebalance deliberately keeps
    a set of small-N compile tests fast — those are grandfathered in
    the committed baseline, so the zero-NEW-findings gate enforces the
    ROADMAP policy ("slow-mark every new compile-bearing test") only
    on tests written from here on.
    """

    id = "JL018"
    name = "unmarked-compile-bearing-test"
    summary = (
        "test runs a real compiled sweep but is not "
        "@pytest.mark.slow (tier-1 870 s budget)"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        comps = path_components(ctx.path)
        base = comps[-1] if comps else ""
        if not (base.startswith("test_") and base.endswith(".py")):
            return []
        if self._module_slow(ctx):
            return []
        helpers = {
            s.name: s for s in ctx.tree.body
            if isinstance(s, ast.FunctionDef)
            and not s.name.startswith("test_")
        }
        findings: List[Finding] = []
        for func, class_slow in self._test_functions(ctx):
            if class_slow or _has_slow_mark(func.decorator_list):
                continue
            trigger = self._trigger(ctx, func, helpers)
            if trigger is None:
                continue
            findings.append(ctx.finding(
                self.id, func,
                f"test calls {trigger} (engine-scale compile) without "
                "@pytest.mark.slow — the tier-1 fast lane runs within "
                "~45 s of its 870 s cap (ROADMAP.md); mark it slow or "
                "drive it with a stub executor",
            ))
        return findings

    @staticmethod
    def _module_slow(ctx: ModuleContext) -> bool:
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "pytestmark"
                for t in stmt.targets
            ):
                for node in ast.walk(stmt.value):
                    if (
                        isinstance(node, ast.Attribute)
                        and node.attr in _SLOW_MARK_ATTRS
                    ):
                        return True
        return False

    @staticmethod
    def _test_functions(
        ctx: ModuleContext,
    ) -> List[Tuple[ast.FunctionDef, bool]]:
        out: List[Tuple[ast.FunctionDef, bool]] = []
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.FunctionDef) and stmt.name.startswith(
                "test_"
            ):
                out.append((stmt, False))
            elif isinstance(stmt, ast.ClassDef):
                class_slow = _has_slow_mark(stmt.decorator_list)
                for sub in stmt.body:
                    if isinstance(
                        sub, ast.FunctionDef
                    ) and sub.name.startswith("test_"):
                        out.append((sub, class_slow))
        return out

    def _trigger(
        self,
        ctx: ModuleContext,
        func: ast.FunctionDef,
        helpers: Dict[str, ast.FunctionDef],
    ) -> Optional[str]:
        """The trigger call's display name, or None if the test is not
        compile-bearing (or shows stub evidence)."""
        bodies = [func]
        for node in ast.walk(func):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Name
            ):
                helper = helpers.get(node.func.id)
                if helper is not None and helper is not func:
                    bodies.append(helper)
        for body in bodies:
            if _STUB_EVIDENCE_RE.search(self._segment(ctx, body)):
                return None
        for body in bodies:
            trigger = self._body_trigger(ctx, body)
            if trigger is not None:
                return trigger
        return None

    def _body_trigger(
        self, ctx: ModuleContext, body: ast.FunctionDef
    ) -> Optional[str]:
        engine_vars: Dict[str, str] = {}
        for node in ast.walk(body):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                tail = self._tail(ctx, node.value)
                if tail in ENGINE_CONSTRUCTOR_TAILS:
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            engine_vars[target.id] = tail
        for node in ast.walk(body):
            if not isinstance(node, ast.Call):
                continue
            tail = self._tail(ctx, node)
            if tail in SWEEP_ENTRY_TAILS:
                return tail
            # engine.run(...) / ConsensusClustering(...).fit(...)
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _RUN_METHODS
            ):
                recv = node.func.value
                if (
                    isinstance(recv, ast.Name)
                    and recv.id in engine_vars
                ):
                    return (
                        f"{engine_vars[recv.id]}()"
                        f".{node.func.attr}"
                    )
                if isinstance(recv, ast.Call):
                    ctor = self._tail(ctx, recv)
                    if ctor in ENGINE_CONSTRUCTOR_TAILS:
                        return f"{ctor}().{node.func.attr}"
        return None

    @staticmethod
    def _tail(ctx: ModuleContext, call: ast.Call) -> Optional[str]:
        qual = ctx.resolve_call(call)
        return qual.rsplit(".", 1)[-1] if qual else None

    @staticmethod
    def _segment(ctx: ModuleContext, node: ast.AST) -> str:
        start = getattr(node, "lineno", 1) - 1
        end = getattr(node, "end_lineno", start + 1)
        return "\n".join(ctx.lines[start:end])
