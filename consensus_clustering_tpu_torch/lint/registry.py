# Copied from consensus_clustering_tpu/lint/registry.py.
"""Rule registry and shared AST infrastructure for jaxlint.

Everything rules need more than once lives here so a new rule is ~30
lines: import-alias resolution (``jnp.dot`` -> ``jax.numpy.dot``),
traced-function discovery (decorated with / wrapped in ``jax.jit``,
passed to ``shard_map``/``lax.scan``/... — minus host-callback
functions), a linear in-source-order walker, and a conservative taint
pass marking values that are tracers inside a traced function.

The analysis is intentionally intra-module and heuristic: jaxlint is a
pre-TPU tripwire for the hazard idioms this repo has actually been
bitten by (see docs/LINT.md), not a type checker.  Rules must prefer
missing a finding over inventing one — every emitted finding either
fails CI or forces a human to write a suppression comment.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple, Type

from consensus_clustering_tpu_torch.lint.findings import Finding

# -- canonical names --------------------------------------------------------

# Callables whose function-valued arguments are traced by JAX.  Bare
# last-component aliases are included because shard_map in particular is
# commonly re-exported or wrapped locally for 0.4.x/0.5.x compatibility.
TRACING_CALLS = frozenset({
    "jax.jit", "jax.pjit", "jax.experimental.pjit.pjit",
    "jax.vmap", "jax.pmap", "jax.grad", "jax.value_and_grad",
    "jax.shard_map", "jax.experimental.shard_map.shard_map", "shard_map",
    "jax.lax.scan", "jax.lax.map", "jax.lax.while_loop",
    "jax.lax.fori_loop", "jax.lax.cond", "jax.lax.switch",
    "jax.checkpoint", "jax.remat",
})

JIT_CALLS = frozenset({
    "jax.jit", "jax.pjit", "jax.experimental.pjit.pjit",
})

SHARD_MAP_CALLS = frozenset({
    "jax.shard_map", "jax.experimental.shard_map.shard_map", "shard_map",
})

# Function-valued arguments to these run on the HOST (outside the trace),
# so hazards inside them are not hazards at all.
HOST_CALLBACK_CALLS = frozenset({
    "jax.debug.callback", "jax.pure_callback",
    "jax.experimental.io_callback", "io_callback",
})

PARTIAL_CALLS = frozenset({"functools.partial", "partial"})

MESH_CALLS = frozenset({
    "jax.sharding.Mesh", "jax.experimental.mesh_utils.Mesh", "Mesh",
    "jax.make_mesh",
})

# Collectives that name a mesh axis via a positional string / axis_name kw.
COLLECTIVE_CALLS = frozenset({
    "jax.lax.psum", "jax.lax.pmean", "jax.lax.pmax", "jax.lax.pmin",
    "jax.lax.all_gather", "jax.lax.axis_index", "jax.lax.axis_size",
    "jax.lax.ppermute", "jax.lax.pshuffle", "jax.lax.psum_scatter",
    "jax.lax.all_to_all",
})

PSPEC_CALLS = frozenset({
    "jax.sharding.PartitionSpec", "PartitionSpec", "P",
})


# -- module context ---------------------------------------------------------

@dataclass
class FunctionInfo:
    node: ast.AST                       # FunctionDef / AsyncFunctionDef / Lambda
    name: str                           # "<lambda>" for lambdas
    parent: Optional["FunctionInfo"]    # lexically enclosing function
    traced: bool = False
    host: bool = False
    # Parameters marked static via jit's static_argnums/static_argnames:
    # NOT tracers inside the trace, so taint-based rules must skip them.
    static_params: Set[str] = field(default_factory=set)


class ModuleContext:
    """Parsed module plus everything the rules share.

    Built once per file; rules receive it and emit :class:`Finding`s
    with paths/lines relative to it.
    """

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.aliases = _collect_aliases(self.tree)
        self.functions: List[FunctionInfo] = []
        self._func_by_node: Dict[int, FunctionInfo] = {}
        self._collect_functions()
        self._mark_traced()

    # -- name resolution ----------------------------------------------------

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted canonical name for a Name/Attribute chain, or None.

        ``jnp.asarray`` -> ``jax.numpy.asarray`` given ``import
        jax.numpy as jnp``; unknown bases resolve to themselves so
        suffix/bare matching still works.
        """
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(self.aliases.get(node.id, node.id))
            return ".".join(reversed(parts))
        return None

    def resolve_call(self, call: ast.Call) -> Optional[str]:
        return self.resolve(call.func)

    def call_matches(self, call: ast.Call, names: frozenset) -> bool:
        qual = self.resolve_call(call)
        return qual is not None and qual in names

    # -- source helpers -----------------------------------------------------

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=rule,
            path=self.path,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            text=self.line_text(line),
        )

    # -- traced-function discovery ------------------------------------------

    def _collect_functions(self) -> None:
        def visit(node: ast.AST, parent: Optional[FunctionInfo]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    name = getattr(child, "name", "<lambda>")
                    info = FunctionInfo(child, name, parent)
                    self.functions.append(info)
                    self._func_by_node[id(child)] = info
                    visit(child, info)
                else:
                    visit(child, parent)

        visit(self.tree, None)

    def _defs_named(self, name: str) -> List[FunctionInfo]:
        return [f for f in self.functions if f.name == name]

    def _jit_decorated(self, info: FunctionInfo) -> bool:
        for dec in getattr(info.node, "decorator_list", []):
            qual = self.resolve(dec)
            if qual in JIT_CALLS:
                return True
            if isinstance(dec, ast.Call):
                qual = self.resolve_call(dec)
                is_jit = qual in JIT_CALLS
                # @partial(jax.jit, static_argnums=...)
                if not is_jit and qual in PARTIAL_CALLS and dec.args:
                    is_jit = self.resolve(dec.args[0]) in JIT_CALLS
                if is_jit:
                    info.static_params |= _static_param_names(
                        dec, info.node
                    )
                    return True
        return False

    def _mark_traced(self) -> None:
        roots: Set[int] = set()
        hosts: Set[int] = set()
        for info in self.functions:
            if self._jit_decorated(info):
                roots.add(id(info.node))
        for call in ast.walk(self.tree):
            if not isinstance(call, ast.Call):
                continue
            qual = self.resolve_call(call)
            if qual is None:
                continue
            target = roots if qual in TRACING_CALLS else (
                hosts if qual in HOST_CALLBACK_CALLS else None
            )
            if target is None:
                continue
            for arg in list(call.args) + [kw.value for kw in call.keywords]:
                if isinstance(arg, ast.Lambda):
                    target.add(id(arg))
                elif isinstance(arg, ast.Name):
                    for f in self._defs_named(arg.id):
                        target.add(id(f.node))
                        if qual in JIT_CALLS:
                            # jax.jit(f, static_argnums=...) call-site
                            # wrapping marks statics the same way the
                            # decorator form does.
                            f.static_params |= _static_param_names(
                                call, f.node
                            )
        # Propagate: nested functions inherit traced-ness unless they (or
        # an ancestor between them and the traced root) are host callbacks.
        for info in self.functions:
            cursor: Optional[FunctionInfo] = info
            while cursor is not None:
                if id(cursor.node) in hosts:
                    info.host = True
                    break
                if id(cursor.node) in roots:
                    info.traced = True
                    break
                cursor = cursor.parent
        for info in self.functions:
            if info.host:
                info.traced = False

    def traced_functions(self) -> List[FunctionInfo]:
        return [f for f in self.functions if f.traced]


def _static_param_names(call: ast.Call, func_node: ast.AST) -> Set[str]:
    """Parameter names a jit call marks static, from literal
    static_argnums/static_argnames keywords (unknowable values resolve
    to nothing — taint then over-approximates, the safe direction)."""
    names: Set[str] = set()
    args = getattr(func_node, "args", None)
    positional = (
        [a.arg for a in args.posonlyargs + args.args]
        if args is not None else []
    )

    def literal_elts(value: ast.AST):
        if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
            return value.elts
        return [value]

    for kw in call.keywords:
        if kw.arg == "static_argnames":
            for e in literal_elts(kw.value):
                if isinstance(e, ast.Constant) and isinstance(
                    e.value, str
                ):
                    names.add(e.value)
        elif kw.arg == "static_argnums":
            for e in literal_elts(kw.value):
                if isinstance(e, ast.Constant) and isinstance(
                    e.value, int
                ) and 0 <= e.value < len(positional):
                    names.add(positional[e.value])
    return names


def _collect_aliases(tree: ast.AST) -> Dict[str, str]:
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                aliases[local] = a.name if a.asname else local
        elif isinstance(node, ast.ImportFrom):
            # Relative imports keep a leading dot-free best-effort base;
            # jax/numpy/time are always absolute, which is all that
            # resolution needs to be exact for.
            base = node.module or ""
            for a in node.names:
                local = a.asname or a.name
                aliases[local] = f"{base}.{a.name}" if base else a.name
    return aliases


# -- traversal helpers ------------------------------------------------------

def walk_in_order(
    node: ast.AST, *, skip_nested_functions: bool = True
) -> Iterator[ast.AST]:
    """Yield descendants depth-first in source order.

    For ``Assign``-family nodes the VALUE is yielded before the targets
    so a rule observing "use then rebind" (the PRNG tracker) sees events
    in evaluation order.  Nested function bodies are skipped by default —
    they are separate scopes with their own analysis.
    """
    func_types = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

    def children(n: ast.AST) -> Iterator[ast.AST]:
        if isinstance(n, ast.Assign):
            yield n.value
            for t in n.targets:
                yield t
        elif isinstance(n, (ast.AnnAssign, ast.AugAssign)):
            if n.value is not None:
                yield n.value
            yield n.target
        else:
            yield from ast.iter_child_nodes(n)

    for child in children(node):
        yield child
        if skip_nested_functions and isinstance(child, func_types):
            continue
        yield from walk_in_order(
            child, skip_nested_functions=skip_nested_functions
        )


def function_params(node: ast.AST) -> Set[str]:
    args = getattr(node, "args", None)
    if args is None:
        return set()
    names = set()
    for group in (args.posonlyargs, args.args, args.kwonlyargs):
        names.update(a.arg for a in group)
    for a in (args.vararg, args.kwarg):
        if a is not None:
            names.add(a.arg)
    return names


def assigned_names(target: ast.AST) -> Set[str]:
    """All plain Names bound by an assignment target (tuples unpacked)."""
    out: Set[str] = set()
    for node in ast.walk(target):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def tainted_names(ctx: ModuleContext, func: FunctionInfo) -> Set[str]:
    """Names that (conservatively) hold tracers inside a traced function.

    Seeds: the function's parameters (inside a jit/shard_map trace every
    array argument is a tracer) minus any marked static via
    static_argnums/static_argnames.  Propagates through simple
    assignments whose RHS mentions a tainted name or calls into
    ``jax.*`` / ``jax.numpy.*``.  No control-flow sensitivity — a name
    once tainted stays tainted, which errs toward reporting; rules built
    on this must pair it with a strong syntactic trigger to stay
    low-noise.
    """
    tainted = set(function_params(func.node)) - func.static_params
    body = getattr(func.node, "body", func.node)
    nodes = (
        [n for stmt in body for n in [stmt, *walk_in_order(stmt)]]
        if isinstance(body, list) else [body, *walk_in_order(body)]
    )
    for node in nodes:
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = node.value
            if value is None:
                continue
            rhs_tainted = any(
                isinstance(n, ast.Name) and n.id in tainted
                for n in ast.walk(value)
            )
            if not rhs_tainted:
                for n in ast.walk(value):
                    if isinstance(n, ast.Call):
                        qual = ctx.resolve_call(n) or ""
                        if qual.startswith(("jax.", "jax_")):
                            rhs_tainted = True
                            break
            if rhs_tainted:
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    tainted |= assigned_names(t)
    return tainted


# -- rule packs -------------------------------------------------------------

#: Directory-scoped rule packs: rules that guard an INVARIANT OF ONE
#: SUBSYSTEM rather than a universal JAX hazard.  A pack's rules check
#: :func:`in_pack_scope` themselves (the runner lints whole trees, so
#: scoping lives in the rule) and this table is the one place the
#: pack -> rules mapping is registered — docs/LINT.md renders it, and
#: tests/test_lint.py asserts every packed rule id exists.
#:
#: ``estimator``: the sampled-pair estimator's whole reason to exist
#: is O(M) state — a dense N×N allocation inside
#: ``consensus_clustering_tpu/estimator/`` silently re-erects the
#: memory wall the subsystem removes, which no unit test at small N
#: would ever notice.
#: ``packed``: the bit-plane accumulation path (``ops/bitpack.py``,
#: ``ops/pallas_coassoc.py``, any future ``packed/`` directory) exists
#: to keep per-resample co-membership ONE BIT wide — a dense (N, N)
#: unpack/materialisation inside it re-erects the 32× HBM cost the
#: representation removes.  Scope: the ``packed`` directory rule plus
#: the two flat ops modules (``rules.PACKED_PATH_MODULES``).
#: ``serve-concurrency``: the scheduler's multi-worker story rests on
#: three discipline-only invariants that review passes keep re-finding
#: by hand — every worker-path jobstore write goes through the
#: ``self._fence(...)`` lease gate (or ``claim_orphan``'s token win),
#: the lock order is queue-cond BEFORE ``_lock`` (never nested the
#: other way), and every thread is a supervised daemon.
#: ``import-hygiene``: the forensic/scheduling layer (obs/*, leases,
#: fair-share, lint itself) is pinned stdlib-only so it works on a
#: wedged host with no accelerator stack; PEP-562 lazy ``__init__``s
#: must not eagerly import what they promise to defer.
#: ``contract-sync``: prose/test catalogues that must track code —
#: the events docstring catalogue, the metrics key pin, and the
#: slow-mark rule protecting the tier-1 time budget.
RULE_PACKS: Dict[str, Tuple[str, ...]] = {
    "estimator": ("JL009",),
    "packed": ("JL010", "JL019"),
    "serve-concurrency": ("JL011", "JL012", "JL013"),
    "import-hygiene": ("JL014", "JL015"),
    "contract-sync": ("JL016", "JL017", "JL018"),
}


def in_pack_scope(path: str, pack: str) -> bool:
    """Whether a file path lies inside a pack's subsystem directory
    (any path component equal to the pack name — matching works for
    repo-relative and absolute spellings alike)."""
    import re as _re

    return pack in _re.split(r"[\\/]+", path)


def path_components(path: str) -> List[str]:
    """Forward/back-slash agnostic path split, for rule self-scoping."""
    import re as _re

    return [c for c in _re.split(r"[\\/]+", path) if c]


def select_rules(packs: Optional[List[str]]) -> List["Rule"]:
    """Resolve ``--pack`` selections to rule instances.

    ``None``/empty and ``all`` both mean every registered rule (the
    historical default).  ``core`` means the rules not claimed by any
    pack (the universal JAX-hazard set plus JL000).  Unknown pack names
    raise ``KeyError``.
    """
    rules = all_rules()
    if not packs or "all" in packs:
        return rules
    packed_ids = {rid for ids in RULE_PACKS.values() for rid in ids}
    wanted: Set[str] = set()
    for pack in packs:
        if pack == "core":
            wanted |= {r.id for r in rules if r.id not in packed_ids}
        elif pack in RULE_PACKS:
            wanted |= set(RULE_PACKS[pack])
        else:
            raise KeyError(pack)
    return [r for r in rules if r.id in wanted]


def pack_of(rule_id: str) -> Optional[str]:
    for pack, ids in RULE_PACKS.items():
        if rule_id in ids:
            return pack
    return None


# -- rule registry ----------------------------------------------------------

class Rule:
    """Base class: subclass, set ``id``/``name``/``summary``, implement
    :meth:`check`, decorate with :func:`register`."""

    id: str = ""
    name: str = ""
    summary: str = ""
    #: Project rules see every linted module at once (cross-file
    #: contracts); the runner calls :meth:`check_project` after the
    #: per-file pass instead of :meth:`check`.
    project: bool = False

    def check(self, ctx: ModuleContext) -> List[Finding]:
        raise NotImplementedError

    def check_project(
        self, contexts: List[ModuleContext]
    ) -> List[Finding]:
        return []


class ProjectRule(Rule):
    """A rule over the whole linted file set at once.

    Cross-file contracts (an emit site in one module vs a catalogue in
    another) cannot be checked per-file.  Subclasses implement
    :meth:`check_project`; :meth:`check` is a no-op so project rules
    are harmless if handed to the per-file path.  A project rule MUST
    return ``[]`` when its contract anchors are absent from the file
    set (someone linting a single file is not asserting the repo has no
    catalogue) — prefer missing a finding over inventing one.
    """

    project = True

    def check(self, ctx: ModuleContext) -> List[Finding]:
        return []


_REGISTRY: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id}")
    _REGISTRY[cls.id] = cls
    return cls


@register
class StaleSuppression(Rule):
    """JL000 — synthesized by the runner, not by :meth:`check`.

    A ``jaxlint: disable=JL0xx`` comment whose rule no longer fires on
    that line is dead armor: it documents a hazard that is not there
    and will silently swallow a FUTURE real finding of that rule on
    that line.  The runner (``lint_paths``) emits JL000 for every
    explicitly-named rule ID that was run but produced nothing to
    suppress on that line; registered here so it appears in
    ``--list-rules``, participates in the baseline, and can itself be
    silenced by adding ``JL000`` to the line's ID list.  ``disable=all``
    is exempt (a blanket gesture carries no per-rule claim to go
    stale).
    """

    id = "JL000"
    name = "stale-suppression"
    summary = (
        "a per-line suppression names a rule that no longer fires there"
    )

    def check(self, ctx: ModuleContext) -> List[Finding]:
        return []


def all_rules() -> List[Rule]:
    """Instantiate every registered rule, sorted by ID."""
    # Importing the rule modules is what populates the registry; done
    # lazily here so `from lint.registry import Rule` never cycles.
    from consensus_clustering_tpu_torch.lint import (  # noqa: F401
        rules as _rules,
    )
    from consensus_clustering_tpu_torch.lint import (  # noqa: F401
        packs as _packs,
    )
    from consensus_clustering_tpu_torch.lint import (  # noqa: F401
        contracts as _contracts,
    )

    return [_REGISTRY[rid]() for rid in sorted(_REGISTRY)]
