# Copied from consensus_clustering_tpu/lint/contracts.py.
"""Contract-sync project rules (JL016, JL017): prose/test catalogues
that must track code, checked across the whole linted file set.

Unlike per-file rules these need BOTH sides of a contract at once — an
emit site in serve/scheduler.py against the catalogue docstring in
serve/events.py, or the metrics dict against the key pin in
tests/test_serve.py.  They subclass :class:`ProjectRule` and return
``[]`` whenever a contract anchor is missing from the linted set:
linting one file must never assert repo-wide drift (prefer a miss).

JL016 absorbs the recursive AST scan that used to live ad hoc in
tests/test_obs.py::test_event_catalogue_matches_emissions — the test is
now a thin wrapper asserting a clean JL016 run, so one implementation
owns the contract.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from consensus_clustering_tpu_torch.lint.findings import Finding
from consensus_clustering_tpu_torch.lint.registry import (
    ModuleContext,
    ProjectRule,
    path_components,
    register,
)

#: Catalogue entry format in serve/events.py's module docstring:
#: a ``- ``event_name`` — description`` bullet per event.
CATALOGUE_ENTRY_RE = re.compile(r"^- ``([a-z_]+)``", re.MULTILINE)


def _basename(path: str) -> str:
    comps = path_components(path)
    return comps[-1] if comps else ""


def _find_context(
    contexts: List[ModuleContext], component: str, base: str
) -> Optional[ModuleContext]:
    for ctx in contexts:
        comps = path_components(ctx.path)
        if comps and comps[-1] == base and component in comps[:-1]:
            return ctx
    return None


@register
class EventCatalogueDrift(ProjectRule):
    """JL016 — serve event emissions vs the serve/events.py catalogue,
    both directions.

    Every ``*.emit("name", ...)`` in a serve module must appear as a
    ``- ``name`` —`` bullet in the events.py module docstring (the
    operator-facing event reference), and every catalogued name must
    still be emitted somewhere.  The emitted set is collected from all
    linted serve-component modules; the never-emitted direction only
    runs when the linted set includes serve modules beyond events.py
    itself, so linting the catalogue alone cannot declare every event
    dead.
    """

    id = "JL016"
    name = "event-catalogue-drift"
    summary = (
        "emitted serve event names out of sync with the "
        "serve/events.py docstring catalogue"
    )

    def check_project(
        self, contexts: List[ModuleContext]
    ) -> List[Finding]:
        events_ctx = _find_context(contexts, "serve", "events.py")
        if events_ctx is None:
            return []
        catalogued = self._catalogued(events_ctx)
        if catalogued is None:
            return []
        emitters = [
            ctx for ctx in contexts
            if "serve" in path_components(ctx.path)[:-1]
        ]
        emitted: Dict[str, List[Tuple[ModuleContext, ast.Call]]] = {}
        for ctx in emitters:
            for name, call in self._emit_calls(ctx):
                emitted.setdefault(name, []).append((ctx, call))

        findings: List[Finding] = []
        for name in sorted(emitted):
            if name in catalogued:
                continue
            for ctx, call in emitted[name]:
                findings.append(ctx.finding(
                    self.id, call,
                    f"event '{name}' is emitted but missing from the "
                    "serve/events.py docstring catalogue — operators "
                    "grep that catalogue during incidents; add a "
                    f"``- ``{name}`` — ...`` bullet",
                ))
        # Reverse direction needs the emitting modules in the linted
        # set; events.py alone proves nothing about dead entries.
        if any(ctx is not events_ctx for ctx in emitters):
            for name in sorted(set(catalogued) - set(emitted)):
                findings.append(Finding(
                    rule=self.id,
                    path=events_ctx.path,
                    line=catalogued[name],
                    col=0,
                    message=(
                        f"event '{name}' is catalogued but never "
                        "emitted by any serve module — stale "
                        "documentation misdirects incident response; "
                        "remove the bullet or restore the emission"
                    ),
                    text=events_ctx.line_text(catalogued[name]),
                ))
        return findings

    @staticmethod
    def _catalogued(ctx: ModuleContext) -> Optional[Dict[str, int]]:
        """Catalogue entry name -> 1-based docstring line, or None when
        events.py has no docstring catalogue at all (anchor missing)."""
        doc = ast.get_docstring(ctx.tree, clean=False)
        if not doc:
            return None
        out: Dict[str, int] = {}
        for i, line in enumerate(ctx.lines, start=1):
            m = CATALOGUE_ENTRY_RE.match(line.strip())
            if m:
                out.setdefault(m.group(1), i)
        # Only entries actually inside the docstring count; the line
        # scan above is for anchoring, the docstring scan for truth.
        names = set(CATALOGUE_ENTRY_RE.findall(doc))
        return {n: ln for n, ln in out.items() if n in names} if (
            names or out
        ) else None

    @staticmethod
    def _emit_calls(
        ctx: ModuleContext,
    ) -> List[Tuple[str, ast.Call]]:
        out: List[Tuple[str, ast.Call]] = []
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "emit"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                out.append((node.args[0].value, node))
        return out


@register
class MetricsKeyDrift(ProjectRule):
    """JL017 — keys written by ``Scheduler.metrics()`` vs the
    ``EXPECTED_METRICS_KEYS`` pin in tests/test_serve.py.

    The pin is an exhaustive-equality contract: a key added to
    ``metrics()`` without updating the pin (or vice versa) fails a
    tier-1 test at runtime; this rule fails it at lint time with the
    drifted key named at its source line.  Extraction follows the one
    structure the scheduler actually uses — a returned dict literal of
    constant keys plus ``**``-spreads resolvable through a local dict
    comprehension over a module-level dict literal.  ANY unresolvable
    piece (computed key, opaque spread) disables the rule for the run
    rather than guessing.
    """

    id = "JL017"
    name = "metrics-key-drift"
    summary = (
        "Scheduler.metrics() keys out of sync with "
        "EXPECTED_METRICS_KEYS in tests/test_serve.py"
    )

    def check_project(
        self, contexts: List[ModuleContext]
    ) -> List[Finding]:
        sched_ctx = _find_context(contexts, "serve", "scheduler.py")
        tests_ctx = next(
            (
                c for c in contexts
                if _basename(c.path) == "test_serve.py"
            ),
            None,
        )
        if sched_ctx is None or tests_ctx is None:
            return []
        written = self._metrics_keys(sched_ctx)
        pinned = self._pinned_keys(tests_ctx)
        if written is None or pinned is None:
            return []
        pinned_names, pin_node = pinned
        findings: List[Finding] = []
        for key in sorted(set(written) - set(pinned_names)):
            findings.append(sched_ctx.finding(
                self.id, written[key],
                f"metrics() writes key '{key}' missing from "
                "EXPECTED_METRICS_KEYS in tests/test_serve.py — the "
                "exhaustive-equality pin exists so dashboards never "
                "meet an undocumented key; add it there",
            ))
        for key in sorted(set(pinned_names) - set(written)):
            findings.append(tests_ctx.finding(
                self.id, pin_node,
                f"EXPECTED_METRICS_KEYS pins '{key}' but "
                "Scheduler.metrics() no longer writes it — remove the "
                "stale pin or restore the key",
            ))
        return findings

    def _metrics_keys(
        self, ctx: ModuleContext
    ) -> Optional[Dict[str, ast.AST]]:
        """Key -> AST node for each metrics() dict key, or None when
        the structure is not fully resolvable."""
        metrics = self._method(ctx, "Scheduler", "metrics")
        if metrics is None:
            return None
        returned = [
            n.value for n in ast.walk(metrics)
            if isinstance(n, ast.Return)
            and isinstance(n.value, ast.Dict)
        ]
        if len(returned) != 1:
            return None
        out: Dict[str, ast.AST] = {}
        for k, v in zip(returned[0].keys, returned[0].values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                out[k.value] = k
            elif k is None:
                spread = self._resolve_spread(ctx, metrics, v)
                if spread is None:
                    return None
                for name in spread:
                    out[name] = v
            else:
                return None
        return out

    @staticmethod
    def _method(
        ctx: ModuleContext, cls_name: str, meth_name: str
    ) -> Optional[ast.FunctionDef]:
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == cls_name:
                for sub in node.body:
                    if (
                        isinstance(sub, ast.FunctionDef)
                        and sub.name == meth_name
                    ):
                        return sub
        return None

    def _resolve_spread(
        self,
        ctx: ModuleContext,
        metrics: ast.FunctionDef,
        value: ast.AST,
    ) -> Optional[Set[str]]:
        """Resolve ``**executor_counters`` -> its key set, through
        `x = {k: ... for k, _ in TABLE.items()}` with TABLE a
        module-level dict literal of constant keys."""
        if not isinstance(value, ast.Name):
            return None
        comp = None
        for node in ast.walk(metrics):
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == value.id
                for t in node.targets
            ):
                comp = node.value
        if not isinstance(comp, ast.DictComp):
            return None
        if len(comp.generators) != 1:
            return None
        it = comp.generators[0].iter
        if not (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Attribute)
            and it.func.attr == "items"
            and isinstance(it.func.value, ast.Name)
        ):
            return None
        table = self._module_dict(ctx, it.func.value.id)
        if table is None:
            return None
        # The comprehension key must be the table key verbatim
        # (`{key: ... for key, attr in TABLE.items()}`).
        target = comp.generators[0].target
        if not (
            isinstance(target, ast.Tuple)
            and target.elts
            and isinstance(target.elts[0], ast.Name)
            and isinstance(comp.key, ast.Name)
            and comp.key.id == target.elts[0].id
        ):
            return None
        return table

    @staticmethod
    def _module_dict(
        ctx: ModuleContext, name: str
    ) -> Optional[Set[str]]:
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets
            ):
                if isinstance(node.value, ast.Dict):
                    keys: Set[str] = set()
                    for k in node.value.keys:
                        if isinstance(k, ast.Constant) and isinstance(
                            k.value, str
                        ):
                            keys.add(k.value)
                        else:
                            return None
                    return keys
        return None

    @staticmethod
    def _pinned_keys(
        ctx: ModuleContext,
    ) -> Optional[Tuple[Set[str], ast.AST]]:
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name)
                and t.id == "EXPECTED_METRICS_KEYS"
                for t in node.targets
            ):
                value = node.value
                if (
                    isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Name)
                    and value.func.id == "frozenset"
                    and len(value.args) == 1
                    and isinstance(value.args[0], (ast.Set, ast.List,
                                                   ast.Tuple))
                ):
                    keys: Set[str] = set()
                    for e in value.args[0].elts:
                        if isinstance(e, ast.Constant) and isinstance(
                            e.value, str
                        ):
                            keys.add(e.value)
                        else:
                            return None
                    return keys, node
        return None
