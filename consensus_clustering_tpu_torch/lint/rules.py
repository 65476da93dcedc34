# Copied from consensus_clustering_tpu/lint/rules.py.
"""The JL001-JL008 rule set: the JAX hazards this repo has been bitten by.

Each rule is a :class:`~consensus_clustering_tpu_torch.lint.registry.Rule`
subclass registered by ID; docs/LINT.md carries the user-facing
catalogue with the "why this bites on TPU" story per rule.  Keep rules
conservative: a finding either fails CI or forces a human to write a
suppression comment, so prefer a miss over a false alarm.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from consensus_clustering_tpu_torch.lint.findings import Finding
from consensus_clustering_tpu_torch.lint.registry import (
    COLLECTIVE_CALLS,
    JIT_CALLS,
    MESH_CALLS,
    PARTIAL_CALLS,
    PSPEC_CALLS,
    SHARD_MAP_CALLS,
    FunctionInfo,
    ModuleContext,
    Rule,
    assigned_names,
    function_params,
    in_pack_scope,
    path_components,
    register,
    tainted_names,
    walk_in_order,
)

# Names that smell like PRNG keys: used only to seed tracking for values
# the assignment tracker cannot see (parameters, closures).
_KEYISH = re.compile(r"key|rng|prng", re.IGNORECASE)

# jax.random.* functions that do NOT consume the key passed to them:
# creation, stream derivation (fold_in makes an independent stream per
# distinct datum, so repeated fold_in on one key is the *correct* idiom)
# and raw-data plumbing.
_NONCONSUMING = frozenset({
    "PRNGKey", "key", "fold_in", "clone", "key_data", "wrap_key_data",
    "key_impl",
})

_KEY_PRODUCERS = frozenset({
    "jax.random.PRNGKey", "jax.random.key", "jax.random.split",
    "jax.random.fold_in", "jax.random.clone",
})


@register
class PRNGKeyReuse(Rule):
    id = "JL001"
    name = "prng-key-reuse"
    summary = (
        "PRNG key consumed twice without jax.random.split: correlated "
        "draws / duplicated randomness"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        # Module-level code is a scope too (scripts draw keys at top
        # level); nested defs are skipped there and analysed below.
        module_keys: Set[str] = set()
        module_consumed: Dict[str, Tuple[int, int]] = {}
        self._exec_block(
            ctx, ctx.tree.body, module_keys, module_consumed, findings
        )
        for info in ctx.functions:
            findings.extend(self._check_function(ctx, info))
        return findings

    def _check_function(
        self, ctx: ModuleContext, info: FunctionInfo
    ) -> List[Finding]:
        body = getattr(info.node, "body", None)
        if not isinstance(body, list):
            return []
        findings: List[Finding] = []
        keys: Set[str] = {
            p for p in function_params(info.node) if _KEYISH.search(p)
        }
        # name -> (line, col) of the first consuming call
        consumed: Dict[str, Tuple[int, int]] = {}
        self._exec_block(ctx, body, keys, consumed, findings)
        return findings

    def _exec_block(
        self,
        ctx: ModuleContext,
        stmts: Sequence[ast.stmt],
        keys: Set[str],
        consumed: Dict[str, Tuple[int, int]],
        findings: List[Finding],
    ) -> None:
        """Abstractly execute a statement list tracking key consumption.

        Branch-aware where it matters: ``if``/``else`` arms are
        exclusive per execution (each starts from the pre-branch state,
        so a key drawn from in both arms is NOT reuse; consumption from
        either arm carries forward), and loop bodies are executed twice
        so a key consumed on every iteration without a per-iteration
        ``split`` rebind IS caught as reuse.
        """
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                self._scan_linear(ctx, stmt.test, keys, consumed, findings)
                k1, c1 = set(keys), dict(consumed)
                self._exec_block(ctx, stmt.body, k1, c1, findings)
                k2, c2 = set(keys), dict(consumed)
                self._exec_block(ctx, stmt.orelse, k2, c2, findings)
                keys.clear()
                keys |= k1 | k2
                consumed.clear()
                consumed.update(c2)
                consumed.update(c1)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                header = (
                    stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor))
                    else stmt.test
                )
                self._scan_linear(ctx, header, keys, consumed, findings)
                for _ in range(2):
                    if isinstance(stmt, (ast.For, ast.AsyncFor)):
                        # The loop target is a fresh bind on EVERY
                        # iteration — re-apply it per simulated pass or
                        # `for key in split(master, n): use(key)` (each
                        # key distinct, the correct idiom) would read as
                        # reuse on the second pass.
                        self._scan_linear(
                            ctx, stmt.target, keys, consumed, findings
                        )
                    n_before = len(findings)
                    self._exec_block(
                        ctx, stmt.body, keys, consumed, findings
                    )
                    # The second pass only exists to expose state
                    # carried across iterations; once it reports, stop
                    # — another pass would duplicate the findings.
                    if len(findings) > n_before:
                        break
                self._exec_block(ctx, stmt.orelse, keys, consumed, findings)
            elif isinstance(stmt, (ast.Try, ast.With, ast.AsyncWith)):
                for item in getattr(stmt, "items", []):
                    self._scan_linear(ctx, item, keys, consumed, findings)
                self._exec_block(ctx, stmt.body, keys, consumed, findings)
                for handler in getattr(stmt, "handlers", []):
                    self._exec_block(
                        ctx, handler.body, keys, consumed, findings
                    )
                for field in ("orelse", "finalbody"):
                    self._exec_block(
                        ctx, getattr(stmt, field, []), keys, consumed,
                        findings,
                    )
            elif isinstance(
                stmt,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                # Separate scopes: nested defs are analysed as their own
                # functions; class bodies' methods likewise.
                continue
            else:
                self._scan_linear(ctx, stmt, keys, consumed, findings)

    def _scan_linear(
        self,
        ctx: ModuleContext,
        node: Optional[ast.AST],
        keys: Set[str],
        consumed: Dict[str, Tuple[int, int]],
        findings: List[Finding],
    ) -> None:
        """Process one branchless statement/expression in source order."""
        if node is None:
            return
        pending_bind: Dict[int, bool] = {}
        for n in [node, *walk_in_order(node)]:
            if isinstance(n, (ast.Assign, ast.AnnAssign)):
                is_key = self._is_key_rhs(ctx, n.value)
                targets = (
                    n.targets if isinstance(n, ast.Assign) else [n.target]
                )
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name) and isinstance(
                            sub.ctx, ast.Store
                        ):
                            pending_bind[id(sub)] = is_key
            elif isinstance(n, ast.Call):
                qual = ctx.resolve_call(n) or ""
                if not qual.startswith("jax.random."):
                    continue
                fn = qual.rsplit(".", 1)[1]
                if fn in _NONCONSUMING or not n.args:
                    continue
                arg0 = n.args[0]
                if not isinstance(arg0, ast.Name):
                    continue
                name = arg0.id
                if name not in keys and not _KEYISH.search(name):
                    continue
                if name in consumed:
                    # The loop second pass re-visits the SAME call node
                    # (line and column equal); two different calls on
                    # one source line share only the line.
                    where = (
                        "on every loop iteration"
                        if consumed[name] == (n.lineno, n.col_offset)
                        else f"on line {consumed[name][0]}"
                    )
                    findings.append(ctx.finding(
                        self.id, n,
                        f"PRNG key {name!r} already consumed by "
                        f"jax.random {where}; reusing it repeats the "
                        "same random bits — jax.random.split (or "
                        "fold_in with distinct data) first",
                    ))
                else:
                    consumed[name] = (n.lineno, n.col_offset)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                # A rebind makes the name a fresh value: reset both the
                # consumed state and the key-ness.
                consumed.pop(n.id, None)
                if pending_bind.pop(id(n), False):
                    keys.add(n.id)
                else:
                    keys.discard(n.id)

    @staticmethod
    def _is_key_rhs(ctx: ModuleContext, value: Optional[ast.AST]) -> bool:
        if value is None:
            return False
        if isinstance(value, ast.Call):
            return (ctx.resolve_call(value) or "") in _KEY_PRODUCERS
        if isinstance(value, ast.Name):
            # Aliasing an existing key keeps key-ness (`k2 = key`).
            return bool(_KEYISH.search(value.id))
        if isinstance(value, (ast.Subscript, ast.Starred)):
            return PRNGKeyReuse._is_key_rhs(
                ctx, getattr(value, "value", None)
            )
        return False


_TIME_READS = frozenset({
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.thread_time",
})
_TIME_SIDE_EFFECTS = _TIME_READS | frozenset({"time.sleep"})


@register
class SideEffectInJit(Rule):
    id = "JL002"
    name = "side-effect-in-jit"
    summary = (
        "Python side effect (print/open/time/stdlib random) inside "
        "jitted code: runs at trace time only, silent no-op afterwards"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for info in ctx.traced_functions():
            for node in walk_in_order(info.node):
                if not isinstance(node, ast.Call):
                    continue
                qual = ctx.resolve_call(node) or ""
                what = None
                if qual == "print":
                    what = "print() (use jax.debug.print)"
                elif qual in ("open", "input"):
                    what = f"{qual}()"
                elif qual in _TIME_SIDE_EFFECTS:
                    what = f"{qual}() (traced once, never re-runs)"
                elif qual.startswith("random."):
                    what = (
                        f"stdlib {qual}() (host RNG, fires at trace time "
                        "only — use jax.random)"
                    )
                elif qual.startswith("numpy.random."):
                    what = (
                        f"{qual}() (host RNG, fires at trace time only — "
                        "use jax.random)"
                    )
                if what is not None:
                    findings.append(ctx.finding(
                        self.id, node,
                        f"{what} inside jit-traced code executes during "
                        "tracing, not on the device: it runs once per "
                        "compilation and never again",
                    ))
        return findings


_NUMPY_SYNCS = frozenset({"numpy.asarray", "numpy.array"})


@register
class HostSyncInJit(Rule):
    id = "JL003"
    name = "host-sync-in-jit"
    summary = (
        "implicit host sync (.item()/float()/np.asarray/device_get) on "
        "a traced value inside jitted code"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for info in ctx.traced_functions():
            tainted = tainted_names(ctx, info)

            def is_tainted(node: ast.AST) -> bool:
                return any(
                    isinstance(n, ast.Name) and n.id in tainted
                    for n in ast.walk(node)
                )

            for node in walk_in_order(info.node):
                if not isinstance(node, ast.Call):
                    continue
                qual = ctx.resolve_call(node) or ""
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("item", "tolist")
                    and not node.args
                    and is_tainted(node.func.value)
                ):
                    findings.append(ctx.finding(
                        self.id, node,
                        f".{node.func.attr}() on a traced value inside "
                        "jitted code: a ConcretizationTypeError at trace "
                        "time, or a device->host sync if it escapes the "
                        "trace",
                    ))
                elif (
                    qual in ("float", "int", "bool")
                    and node.args
                    and is_tainted(node.args[0])
                ):
                    findings.append(ctx.finding(
                        self.id, node,
                        f"{qual}() on a traced value inside jitted code "
                        "forces concretization: ConcretizationTypeError "
                        "at trace time",
                    ))
                elif (
                    qual in _NUMPY_SYNCS
                    and node.args
                    and is_tainted(node.args[0])
                ):
                    findings.append(ctx.finding(
                        self.id, node,
                        f"{qual}() on a traced value inside jitted code "
                        "pulls the array to the host mid-trace — keep it "
                        "jnp until the program boundary",
                    ))
                elif qual == "jax.device_get":
                    findings.append(ctx.finding(
                        self.id, node,
                        "jax.device_get inside jitted code is a host "
                        "round trip staged into the program",
                    ))
        return findings


@register
class JitRetracePerCall(Rule):
    id = "JL004"
    name = "jit-retrace-per-call"
    summary = (
        "jax.jit in a loop body / on a fresh lambda / immediately "
        "invoked: recompiles on every call"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []

        def visit(node: ast.AST, in_loop: bool, in_func: bool) -> None:
            for child in ast.iter_child_nodes(node):
                child_loop = in_loop
                child_func = in_func
                if isinstance(child, (ast.For, ast.AsyncFor, ast.While)):
                    child_loop = True
                elif isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    # A jit at function scope runs once per *call* of the
                    # enclosing function, not once per enclosing loop
                    # iteration: reset the loop flag, remember the scope.
                    child_loop = False
                    child_func = True
                if isinstance(child, ast.Call):
                    qual = ctx.resolve_call(child) or ""
                    if qual in JIT_CALLS:
                        # A module-scope jit(lambda ...) is evaluated
                        # once and keeps its cache — only a lambda
                        # rebuilt per call (function scope) or per
                        # iteration (loop) retraces.
                        if any(
                            isinstance(a, ast.Lambda) for a in child.args
                        ) and (child_loop or child_func):
                            findings.append(ctx.finding(
                                self.id, child,
                                "jit of a fresh lambda: every evaluation "
                                "builds a new callable with a new cache, "
                                "so XLA recompiles per call — name the "
                                "function and jit it once",
                            ))
                        elif child_loop:
                            findings.append(ctx.finding(
                                self.id, child,
                                "jax.jit inside a loop body creates a "
                                "fresh compiled callable (and a fresh "
                                "trace cache) per iteration — hoist the "
                                "jit out of the loop",
                            ))
                    # jax.jit(f)(x): the compiled callable is discarded
                    # after one call, so every execution re-traces.
                    inner = (
                        child.func if isinstance(child.func, ast.Call)
                        else None
                    )
                    if (
                        inner is not None
                        and (ctx.resolve_call(inner) or "") in JIT_CALLS
                        and child_func
                    ):
                        findings.append(ctx.finding(
                            self.id, child,
                            "jax.jit(...)(...) immediately invoked "
                            "inside a function: the compiled callable "
                            "is dropped after the call, so every call "
                            "of the enclosing function re-traces — "
                            "bind the jitted function once",
                        ))
                visit(child, child_loop, child_func)

        visit(ctx.tree, False, False)
        return findings


@register
class TracedPythonBranch(Rule):
    id = "JL005"
    name = "traced-python-branch"
    summary = (
        "Python if/while on a traced value inside jitted code: "
        "TracerBoolConversionError (use lax.cond/lax.while_loop/where)"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for info in ctx.traced_functions():
            tainted = tainted_names(ctx, info)
            for node in walk_in_order(info.node):
                if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    test = node.test
                    if self._static_test(test):
                        continue
                    names = {
                        n.id for n in ast.walk(test)
                        if isinstance(n, ast.Name)
                        and isinstance(n.ctx, ast.Load)
                    }
                    hit = sorted(names & tainted)
                    if hit:
                        kind = {
                            ast.If: "if", ast.While: "while",
                            ast.IfExp: "conditional expression",
                        }[type(node)]
                        findings.append(ctx.finding(
                            self.id, node,
                            f"Python {kind} branches on traced value(s) "
                            f"{', '.join(hit)}: inside jit this raises "
                            "TracerBoolConversionError — use jnp.where, "
                            "lax.cond or lax.while_loop",
                        ))
        return findings

    @staticmethod
    def _static_test(test: ast.AST) -> bool:
        """Tests that are fine on tracers / are really static checks.

        ``x is None`` (optional-argument plumbing: an identity check,
        never concretizes) and ``isinstance(...)`` (type-level, resolved
        at trace time) are common legitimate patterns.
        """
        if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        ):
            return True
        if isinstance(test, ast.Call) and isinstance(
            test.func, ast.Name
        ) and test.func.id in ("isinstance", "hasattr", "callable"):
            return True
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return TracedPythonBranch._static_test(test.operand)
        if isinstance(test, ast.BoolOp):
            return all(
                TracedPythonBranch._static_test(v) for v in test.values
            )
        return False


_ARRAY_MAKERS = frozenset({
    "numpy.array", "numpy.asarray", "jax.numpy.array", "jax.numpy.asarray",
    "jax.numpy.zeros", "jax.numpy.ones", "jax.numpy.arange",
})


@register
class BadStaticArgs(Rule):
    id = "JL006"
    name = "bad-static-args"
    summary = (
        "non-hashable or array-valued static_argnums/static_argnames: "
        "TypeError at call time, or a recompile per distinct array"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            qual = ctx.resolve_call(node) or ""
            is_jit = qual in JIT_CALLS
            if not is_jit and qual in PARTIAL_CALLS and node.args:
                is_jit = (ctx.resolve(node.args[0]) or "") in JIT_CALLS
            if not is_jit:
                continue
            for kw in node.keywords:
                if kw.arg == "static_argnums":
                    findings.extend(
                        self._check_argnums(ctx, kw.value)
                    )
                elif kw.arg == "static_argnames":
                    findings.extend(
                        self._check_argnames(ctx, kw.value)
                    )
        return findings

    def _check_argnums(
        self, ctx: ModuleContext, value: ast.AST
    ) -> List[Finding]:
        if isinstance(value, ast.Call):
            if (ctx.resolve_call(value) or "") in _ARRAY_MAKERS:
                return [ctx.finding(
                    self.id, value,
                    "array-valued static_argnums: static argnums must "
                    "be Python ints (argument *positions*), not arrays",
                )]
            return []
        if isinstance(value, (ast.Dict, ast.Set)):
            return [ctx.finding(
                self.id, value,
                "static_argnums must be an int or a tuple of ints, not "
                f"a {type(value).__name__.lower()} literal",
            )]
        elts = (
            value.elts if isinstance(value, (ast.Tuple, ast.List))
            else [value]
        )
        out = []
        for e in elts:
            if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
                e = e.operand
            if isinstance(e, ast.Constant) and not isinstance(
                e.value, int
            ):
                out.append(ctx.finding(
                    self.id, e,
                    f"static_argnums entry {e.value!r} is not an int: "
                    "argnums are argument positions; did you mean "
                    "static_argnames?",
                ))
            elif isinstance(e, ast.Call) and (
                ctx.resolve_call(e) or ""
            ) in _ARRAY_MAKERS:
                out.append(ctx.finding(
                    self.id, e,
                    "array-valued static_argnums entry: arrays are "
                    "unhashable and cannot be static",
                ))
        return out

    def _check_argnames(
        self, ctx: ModuleContext, value: ast.AST
    ) -> List[Finding]:
        if isinstance(value, ast.Call):
            if (ctx.resolve_call(value) or "") in _ARRAY_MAKERS:
                return [ctx.finding(
                    self.id, value,
                    "array-valued static_argnames: names must be strings",
                )]
            return []
        if isinstance(value, (ast.Dict, ast.Set)):
            return [ctx.finding(
                self.id, value,
                "static_argnames must be a string or tuple of strings, "
                f"not a {type(value).__name__.lower()} literal",
            )]
        elts = (
            value.elts if isinstance(value, (ast.Tuple, ast.List))
            else [value]
        )
        return [
            ctx.finding(
                self.id, e,
                f"static_argnames entry {e.value!r} is not a string: "
                "names select arguments by keyword; did you mean "
                "static_argnums?",
            )
            for e in elts
            if isinstance(e, ast.Constant)
            and not isinstance(e.value, str)
        ]


# Calls whose region-presence marks real device work between two timer
# reads.  Deliberately narrow — metadata constructors (ShapeDtypeStruct,
# sharding objects, config reads) must not count.
_DEVICE_PREFIXES = (
    "jax.numpy.", "jax.random.", "jax.lax.", "jax.scipy.", "jax.nn.",
    "jax.image.",
)
_DEVICE_EXACT = frozenset({"jax.device_put"})

_SYNC_MARKERS = frozenset({
    "jax.block_until_ready", "block_until_ready", "jax.device_get",
    "jax.effects_barrier", "numpy.asarray", "numpy.array",
})


@register
class TimingWithoutSync(Rule):
    id = "JL007"
    name = "timing-without-sync"
    summary = (
        "timing delta around device computation without "
        "block_until_ready: measures async dispatch, not execution"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        findings: List[Finding] = []
        for info in ctx.functions:
            if isinstance(info.node, ast.Lambda):
                continue
            reads = [
                node for node in walk_in_order(
                    info.node, skip_nested_functions=False
                )
                if isinstance(node, ast.Call)
                and (ctx.resolve_call(node) or "") in _TIME_READS
            ]
            if len(reads) < 2:
                continue
            reads.sort(key=lambda n: (n.lineno, n.col_offset))
            region_nodes = list(
                walk_in_order(info.node, skip_nested_functions=False)
            )
            for start, end in zip(reads, reads[1:]):
                lo, hi = start.lineno, end.lineno
                in_region = [
                    n for n in region_nodes
                    if lo < getattr(n, "lineno", 0) <= hi
                ]
                device = any(
                    isinstance(n, ast.Call) and self._is_device_call(
                        ctx.resolve_call(n) or ""
                    )
                    for n in in_region
                )
                if not device:
                    continue
                synced = any(
                    self._is_sync_marker(ctx, n) for n in in_region
                )
                if not synced:
                    findings.append(ctx.finding(
                        self.id, end,
                        "timing delta (lines "
                        f"{lo}-{hi}) spans device computation with no "
                        "completion barrier: JAX dispatch is async, so "
                        "this measures launch latency — call "
                        "jax.block_until_ready (or copy to host) before "
                        "the closing timer read",
                    ))
        return findings

    @staticmethod
    def _is_device_call(qual: str) -> bool:
        return qual.startswith(_DEVICE_PREFIXES) or qual in _DEVICE_EXACT

    @staticmethod
    def _is_sync_marker(ctx: ModuleContext, node: ast.AST) -> bool:
        # Both calls AND bare references count: np.asarray passed as the
        # mapped function of jax.tree.map is a completion barrier too.
        if isinstance(node, (ast.Name, ast.Attribute)):
            qual = ctx.resolve(node) or ""
            if qual in _SYNC_MARKERS:
                return True
            if isinstance(node, ast.Attribute) and node.attr in (
                "block_until_ready", "effects_barrier",
            ):
                return True
        return False


@register
class ShardMapAxisMismatch(Rule):
    id = "JL008"
    name = "shard-map-axis-mismatch"
    summary = (
        "shard_map axis names absent from the mesh, or mesh axes "
        "declared but unused (the PR-1 GSPMD miscompile trigger)"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        consts = self._collect_str_consts(ctx)
        mesh_axes = self._collect_mesh_vars(ctx, consts)
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if not ctx.call_matches(node, SHARD_MAP_CALLS):
                continue
            axes = self._mesh_axes_for_call(ctx, node, mesh_axes, consts)
            if axes is None:
                continue  # mesh not statically known: nothing to verify
            used: List[Tuple[str, ast.AST]] = []
            for kw in node.keywords:
                if kw.arg in ("in_specs", "out_specs"):
                    used.extend(
                        (s, kw.value)
                        for s in self._spec_strings(kw.value, consts)
                    )
            for arg in node.args[2:4]:   # positional in_specs/out_specs
                used.extend(
                    (s, arg) for s in self._spec_strings(arg, consts)
                )
            body = node.args[0] if node.args else None
            if isinstance(body, ast.Name):
                for f in ctx.functions:
                    if f.name == body.id:
                        used.extend(
                            self._body_axis_uses(ctx, f.node, consts)
                        )
            elif isinstance(body, ast.Lambda):
                used.extend(self._body_axis_uses(ctx, body, consts))
            axis_set = set(axes)
            for name, where in used:
                if name not in axis_set:
                    findings.append(ctx.finding(
                        self.id, where,
                        f"axis {name!r} is not an axis of the mesh "
                        f"{tuple(axes)!r} this shard_map runs over",
                    ))
            used_names = {name for name, _ in used}
            for axis in axes:
                if axis not in used_names:
                    findings.append(ctx.finding(
                        self.id, node,
                        f"mesh axis {axis!r} is declared but unused by "
                        "this shard_map's specs and body: values "
                        "replicated over an unmentioned axis have "
                        "triggered GSPMD miscompiles (jit-computed RNG "
                        "indices arrived doubled on JAX 0.4.x) — drop "
                        "the axis or mention it in a spec",
                    ))
        return findings

    @staticmethod
    def _collect_str_consts(ctx: ModuleContext) -> Dict[str, str]:
        """Names bound (once) to a string literal, module-wide.

        Axis names are conventionally module constants
        (``KSHARD_AXIS = "k"``) rather than literals at the use site —
        the actual miscompile site spells every axis that way, so
        without this resolution the rule would skip the one file it
        exists for.  Names bound to different strings in different
        places are ambiguous and dropped.
        """
        consts: Dict[str, str] = {}
        ambiguous: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not (
                isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                continue
            for t in node.targets:
                for name in assigned_names(t):
                    if name in consts and consts[name] != node.value.value:
                        ambiguous.add(name)
                    consts[name] = node.value.value
        for name in ambiguous:
            consts.pop(name, None)
        return consts

    @staticmethod
    def _resolve_str(
        node: ast.AST, consts: Dict[str, str]
    ) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return consts.get(node.id)
        return None

    def _axes_from_mesh_call(
        self, call: ast.Call, consts: Dict[str, str]
    ) -> Optional[Sequence[str]]:
        cand: Optional[ast.AST] = None
        if len(call.args) >= 2:
            cand = call.args[1]
        for kw in call.keywords:
            if kw.arg == "axis_names":
                cand = kw.value
        if cand is None:
            return None
        single = self._resolve_str(cand, consts)
        if single is not None:
            return [single]
        if isinstance(cand, (ast.Tuple, ast.List)):
            out = []
            for e in cand.elts:
                s = self._resolve_str(e, consts)
                if s is None:
                    return None
                out.append(s)
            return out
        return None

    def _collect_mesh_vars(
        self, ctx: ModuleContext, consts: Dict[str, str]
    ) -> Dict[str, Sequence[str]]:
        """Variable name -> mesh axis names, where unambiguous.

        Name resolution here is module-flat, so a name bound to
        DIFFERENT meshes in different scopes (two functions each
        building their own ``mesh``) is ambiguous: verifying a
        shard_map against the wrong binding would both invent and
        miss findings, so such names are dropped (rule skips).
        """
        out: Dict[str, Sequence[str]] = {}
        ambiguous: Set[str] = set()
        for node in ast.walk(ctx.tree):
            value = None
            names: Set[str] = set()
            if isinstance(node, ast.Assign):
                value, names = node.value, set()
                for t in node.targets:
                    names |= assigned_names(t)
            elif isinstance(node, ast.withitem):
                value = node.context_expr
                if node.optional_vars is not None:
                    names = assigned_names(node.optional_vars)
            if not isinstance(value, ast.Call) or not names:
                continue
            if not ctx.call_matches(value, MESH_CALLS):
                continue
            axes = self._axes_from_mesh_call(value, consts)
            for n in names:
                if axes is None or (
                    n in out and tuple(out[n]) != tuple(axes)
                ):
                    ambiguous.add(n)
                if axes is not None:
                    out[n] = axes
        for n in ambiguous:
            out.pop(n, None)
        return out

    def _mesh_axes_for_call(
        self,
        ctx: ModuleContext,
        call: ast.Call,
        mesh_vars: Dict[str, Sequence[str]],
        consts: Dict[str, str],
    ) -> Optional[Sequence[str]]:
        mesh_expr: Optional[ast.AST] = None
        for kw in call.keywords:
            if kw.arg == "mesh":
                mesh_expr = kw.value
        if mesh_expr is None and len(call.args) >= 2:
            mesh_expr = call.args[1]
        if isinstance(mesh_expr, ast.Call) and ctx.call_matches(
            mesh_expr, MESH_CALLS
        ):
            return self._axes_from_mesh_call(mesh_expr, consts)
        if isinstance(mesh_expr, ast.Name):
            return mesh_vars.get(mesh_expr.id)
        return None

    def _spec_strings(
        self, spec: ast.AST, consts: Dict[str, str]
    ) -> List[str]:
        out = []
        for n in ast.walk(spec):
            s = self._resolve_str(n, consts)
            if s is not None:
                out.append(s)
        return out

    def _body_axis_uses(
        self, ctx: ModuleContext, body: ast.AST, consts: Dict[str, str]
    ) -> List[Tuple[str, ast.AST]]:
        out: List[Tuple[str, ast.AST]] = []
        for node in ast.walk(body):
            if not isinstance(node, ast.Call):
                continue
            qual = ctx.resolve_call(node) or ""
            if qual in COLLECTIVE_CALLS:
                for a in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    for s in self._spec_strings(a, consts):
                        out.append((s, node))
            elif qual in PSPEC_CALLS:
                for s in self._spec_strings(node, consts):
                    out.append((s, node))
        return out


# ---------------------------------------------------------------------------
# The `estimator` rule pack (registry.RULE_PACKS): subsystem-invariant
# rules scoped to consensus_clustering_tpu/estimator/.

# Array allocators whose shape argument JL009 inspects.
_ALLOCATOR_CALLS = frozenset({
    "jax.numpy.zeros", "jax.numpy.ones", "jax.numpy.empty",
    "jax.numpy.full", "jax.numpy.zeros_like",
    "numpy.zeros", "numpy.ones", "numpy.empty", "numpy.full",
})

# Dense-matrix builders from the exact engines: any call to one of
# these inside estimator/ materialises (a row block of) an N x N
# object, which is exactly what the subsystem exists to never do.
_DENSE_BUILDERS = frozenset({
    "consensus_clustering_tpu.ops.coassoc.coassociation_counts",
    "consensus_clustering_tpu.ops.resample.cosample_counts",
    "consensus_clustering_tpu.ops.resample.indicator_matrix",
    "consensus_clustering_tpu.ops.analysis.consensus_matrix",
    "coassociation_counts", "cosample_counts", "indicator_matrix",
    "consensus_matrix",
})


@register
class EstimatorDenseAlloc(Rule):
    id = "JL009"
    name = "estimator-dense-alloc"
    summary = (
        "dense N x N allocation (or dense-builder call) inside "
        "estimator/: silently re-erects the O(N^2) memory wall the "
        "sampled-pair subsystem exists to remove"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if not in_pack_scope(ctx.path, "estimator"):
            return []
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            qual = ctx.resolve_call(node)
            if qual is None:
                continue
            if qual in _DENSE_BUILDERS:
                findings.append(ctx.finding(
                    self.id, node,
                    f"{qual.rsplit('.', 1)[-1]}() builds (a row block "
                    "of) a dense N x N matrix — estimator/ code must "
                    "stay O(M); gather per-pair values instead "
                    "(docs/LINT.md JL009)",
                ))
                continue
            if qual in _ALLOCATOR_CALLS and self._square_shape(node):
                findings.append(ctx.finding(
                    self.id, node,
                    "allocation with a repeated symbolic dimension "
                    "(shape like (n, n)) inside estimator/ — the "
                    "subsystem's contract is O(M) state, never "
                    "O(N^2); if the repeated dimension is not N, "
                    "rename one of them or suppress with a reason "
                    "(docs/LINT.md JL009)",
                ))
        return findings

    @staticmethod
    def _square_shape(call: ast.Call) -> bool:
        """Whether the allocator's shape argument repeats the SAME
        non-constant expression in two dimensions — the (n, n) /
        (n_pad, n_pad) smell.  Constant repeats like (20, 20) are
        fine (bins-sized temporaries), and unequal symbolic dims like
        (h_block, n) are the subsystem's bread and butter."""
        shape = None
        if call.args:
            shape = call.args[0]
        for kw in call.keywords:
            if kw.arg == "shape":
                shape = kw.value
        if not isinstance(shape, (ast.Tuple, ast.List)):
            return False
        rendered = [
            ast.dump(e) for e in shape.elts
            if not isinstance(e, ast.Constant)
        ]
        return len(rendered) != len(set(rendered))


# The `packed` rule pack: the bit-plane accumulation path
# (ops/bitpack.py, ops/pallas_coassoc.py — the modules
# PACKED_PATH_MODULES names, plus any future packed/ subdirectory).
# Its reason to exist is that per-resample co-membership stays 1 BIT
# wide end to end; unpacking the masks back into a dense (N, N) object
# — or calling one of the dense exact-engine builders — inside that
# path would silently re-pay the 32x the representation removed, and
# no small-N unit test would notice.

#: File stems that ARE the packed accumulation path today.  The pack
#: scope is directory-based like every pack (a future ops/packed/
#: lands inside automatically); these two modules live flat in ops/,
#: so the rule matches them by name as well.
PACKED_PATH_MODULES = frozenset({"bitpack.py", "pallas_coassoc.py"})


@register
class PackedDenseMaterialize(Rule):
    id = "JL010"
    name = "packed-dense-materialize"
    summary = (
        "dense (N, N) unpack/materialisation (or dense exact-engine "
        "builder call) inside the packed accumulation path: silently "
        "re-pays the 32x HBM bytes the bit-plane representation "
        "removes"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        import re as _re

        parts = _re.split(r"[\\/]+", ctx.path)
        if not (
            in_pack_scope(ctx.path, "packed")
            or (parts and parts[-1] in PACKED_PATH_MODULES)
        ):
            return []
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            qual = ctx.resolve_call(node)
            if qual is None:
                continue
            if qual in _DENSE_BUILDERS:
                findings.append(ctx.finding(
                    self.id, node,
                    f"{qual.rsplit('.', 1)[-1]}() builds (a row block "
                    "of) a dense N x N matrix — the packed "
                    "accumulation path must stay bit-planes + "
                    "popcount tiles; materialise int32 counts only at "
                    "the engines' evaluate/finalize boundaries "
                    "(docs/LINT.md JL010)",
                ))
                continue
            if qual in _ALLOCATOR_CALLS and EstimatorDenseAlloc\
                    ._square_shape(node):
                findings.append(ctx.finding(
                    self.id, node,
                    "allocation with a repeated symbolic dimension "
                    "(shape like (n, n)) inside the packed "
                    "accumulation path — packed state is O(H*k*N/32) "
                    "words and tiles are (tile_r, n), never square in "
                    "N; if the repeated dimension is not N, rename "
                    "one of them or suppress with a reason "
                    "(docs/LINT.md JL010)",
                ))
        return findings


#: File stems that ARE the fused assign+pack path today (a future
#: ops/fused/ subdirectory lands inside the pack scope automatically).
FUSED_PATH_MODULES = frozenset({"pallas_fused_block.py"})

#: The round-trip packer the fused kernel exists to bypass: calling it
#: from the fused path means a dense per-lane labels array was
#: materialised first — the exact regression JL019 guards against.
_LABEL_PACKERS = frozenset({
    "consensus_clustering_tpu.ops.bitpack.pack_label_planes",
    "pack_label_planes",
})


@register
class FusedLabelMaterialize(Rule):
    id = "JL019"
    name = "fused-label-materialize"
    summary = (
        "dense label materialisation inside the fused assign+pack "
        "path: an (h_block, n)-class int32 allocation or a "
        "pack_label_planes() call silently re-erects the label "
        "round-trip the fused kernel removes"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        parts = path_components(ctx.path)
        if not (
            in_pack_scope(ctx.path, "fused")
            or (parts and parts[-1] in FUSED_PATH_MODULES)
        ):
            return []
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            qual = ctx.resolve_call(node)
            if qual is None:
                continue
            if qual in _LABEL_PACKERS:
                findings.append(ctx.finding(
                    self.id, node,
                    "pack_label_planes() consumes a dense per-lane "
                    "labels array — the fused path's contract is that "
                    "labels exist only as per-lane VMEM vectors; keep "
                    "the round-trip packer in the UNFUSED engine "
                    "branch (docs/LINT.md JL019)",
                ))
                continue
            if qual in _ALLOCATOR_CALLS and self._dense_int32(node):
                findings.append(ctx.finding(
                    self.id, node,
                    "int32 allocation with two or more symbolic "
                    "dimensions ((h_block, n)-class) inside the fused "
                    "assign+pack path — that is the dense label "
                    "buffer the fused kernel exists to eliminate; "
                    "emit uint32 bit-planes instead, or suppress "
                    "with a reason if the buffer is not labels "
                    "(docs/LINT.md JL019)",
                ))
        return findings

    @staticmethod
    def _dense_int32(call: ast.Call) -> bool:
        """An allocator call whose dtype names int32 AND whose shape
        carries >= 2 non-constant dimensions — the label-buffer
        class.  f32 lane/tile buffers and uint32 planes (the packed
        representation itself) stay clean."""
        shape = call.args[0] if call.args else None
        dtype = call.args[1] if len(call.args) > 1 else None
        for kw in call.keywords:
            if kw.arg == "shape":
                shape = kw.value
            elif kw.arg == "dtype":
                dtype = kw.value
        if dtype is None:
            return False
        if isinstance(dtype, ast.Attribute):
            named = dtype.attr
        elif isinstance(dtype, ast.Name):
            named = dtype.id
        elif isinstance(dtype, ast.Constant) and isinstance(
            dtype.value, str
        ):
            named = dtype.value
        else:
            return False
        if named not in ("int32", "i32"):
            return False
        if not isinstance(shape, (ast.Tuple, ast.List)):
            return False
        symbolic = [
            e for e in shape.elts if not isinstance(e, ast.Constant)
        ]
        return len(symbolic) >= 2
