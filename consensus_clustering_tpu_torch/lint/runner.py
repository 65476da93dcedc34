# Copied from consensus_clustering_tpu/lint/runner.py.
"""jaxlint entry point: walk files, run rules, apply suppressions and
baseline, report, exit.

Invoked as ``python -m consensus_clustering_tpu_torch lint [paths ...]``
(the CLI subcommand) or ``python -m consensus_clustering_tpu_torch.lint``.
Stdlib only, no jax import; the parent package's ``__init__`` imports
torch, which the command pays for before it starts.  The default paths
are the reference package's tree, as the CI gate lints it.

Exit codes: 0 clean (no new findings), 1 new findings (or unparseable
files), 2 usage errors.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from consensus_clustering_tpu_torch.lint.findings import (
    Baseline,
    Finding,
    is_suppressed,
    suppressions_for_source,
)
from consensus_clustering_tpu_torch.lint.registry import (
    RULE_PACKS,
    ModuleContext,
    all_rules,
    pack_of,
    select_rules,
)
from consensus_clustering_tpu_torch.lint.reporters import (
    report_json,
    report_text,
)

DEFAULT_BASELINE = ".jaxlint-baseline.json"

# Walking a directory skips these wherever they appear: caches, VCS
# internals, and anything hidden.
_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", ".eggs"}


def _normalize(path: str) -> str:
    """Canonical reported path, independent of invocation spelling.

    ``./mod.py``, ``mod.py`` and ``/abs/cwd/mod.py`` must all
    fingerprint identically or a committed baseline green in CI goes
    red for anyone spelling the path differently: paths under the cwd
    become cwd-relative with forward slashes; paths outside stay
    normpath'd absolute/relative as given.
    """
    rel = os.path.relpath(os.path.abspath(path), os.getcwd())
    out = rel if not rel.startswith("..") else os.path.normpath(path)
    return out.replace(os.sep, "/")


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    for path in paths:
        if os.path.isfile(path):
            yield _normalize(path)
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in _SKIP_DIRS and not d.startswith(".")
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield _normalize(os.path.join(root, name))
        else:
            raise FileNotFoundError(path)


def _analyze_file(path: str, rules):
    """Per-file pass: returns (active, suppressed, error, ctx,
    suppressions).  ``ctx``/``suppressions`` are None for unparseable
    files."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        ctx = ModuleContext(path, source)
    except SyntaxError as e:
        return (
            [], [], f"{path}:{e.lineno}: syntax error: {e.msg}",
            None, None,
        )
    suppressions = suppressions_for_source(source)
    active: List[Finding] = []
    suppressed: List[Finding] = []
    seen = set()
    for rule in rules:
        for finding in rule.check(ctx):
            # Nested scopes can re-derive the same finding (e.g. a
            # timing pair visible from both an outer function and a
            # closure): report each location once.
            key = (finding.rule, finding.line, finding.col,
                   finding.message)
            if key in seen:
                continue
            seen.add(key)
            if is_suppressed(finding, suppressions):
                suppressed.append(finding)
            else:
                active.append(finding)
    return active, suppressed, None, ctx, suppressions


def lint_file(
    path: str, rules=None
) -> Tuple[List[Finding], List[Finding], Optional[str]]:
    """Lint one file with the per-file rules: returns (active,
    suppressed, error).

    ``error`` is a human-readable parse failure; an unparseable file
    yields no findings but must still fail the run (a syntax error in a
    scanned tree is never 'clean').  Project rules (cross-file
    contracts) and stale-suppression synthesis need the whole file set
    and run in :func:`lint_paths` only.
    """
    if rules is None:
        rules = all_rules()
    active, suppressed, err, _, _ = _analyze_file(path, rules)
    return active, suppressed, err


def _stale_suppressions(
    contexts: Dict[str, ModuleContext],
    supp_by_path: Dict[str, Dict[int, set]],
    suppressed: List[Finding],
    ran_rule_ids: set,
) -> List[Finding]:
    """Synthesize JL000 findings for explicitly-named rule IDs that
    were RUN this invocation but suppressed nothing on their line.

    ``disable=all`` is exempt (no per-rule claim to go stale), rules
    excluded by ``--pack`` are exempt (we cannot know), and a line that
    also names JL000 opts out of staleness reporting entirely.
    """
    consumed: Dict[Tuple[str, int], set] = {}
    for f in suppressed:
        consumed.setdefault((f.path, f.line), set()).add(f.rule)
    out: List[Finding] = []
    for path in sorted(supp_by_path):
        ctx = contexts[path]
        for line in sorted(supp_by_path[path]):
            ids = supp_by_path[path][line]
            if "JL000" in ids:
                continue
            used = consumed.get((path, line), set())
            for rid in sorted(ids):
                if rid == "ALL" or rid in used:
                    continue
                if rid not in ran_rule_ids:
                    continue
                out.append(Finding(
                    rule="JL000",
                    path=path,
                    line=line,
                    col=0,
                    message=(
                        f"stale suppression: {rid} no longer fires on "
                        "this line — dead armor swallows the next real "
                        f"{rid} finding here; remove the comment (or "
                        "add JL000 to the list if the line is "
                        "intentionally pre-armed)"
                    ),
                    text=ctx.line_text(line),
                ))
    return out


def lint_paths(
    paths: Iterable[str], rules=None
) -> Tuple[List[Finding], List[Finding], List[str], int]:
    """Lint every .py under ``paths``.

    Returns (active, suppressed, errors, n_files); ``active`` has not
    yet been partitioned against a baseline.  This is the full
    pipeline: per-file rules, then project rules over the collected
    module set, then stale-suppression synthesis (JL000) over every
    suppression comment the run observed.
    """
    if rules is None:
        rules = all_rules()
    per_file = [r for r in rules if not getattr(r, "project", False)]
    project = [r for r in rules if getattr(r, "project", False)]
    active: List[Finding] = []
    suppressed: List[Finding] = []
    errors: List[str] = []
    contexts: Dict[str, ModuleContext] = {}
    supp_by_path: Dict[str, Dict[int, set]] = {}
    n_files = 0
    for path in iter_python_files(paths):
        n_files += 1
        a, s, err, ctx, supp = _analyze_file(path, per_file)
        active.extend(a)
        suppressed.extend(s)
        if err is not None:
            errors.append(err)
        if ctx is not None:
            contexts[path] = ctx
            supp_by_path[path] = supp
    ctx_list = [contexts[p] for p in sorted(contexts)]
    seen = set()
    for rule in project:
        for finding in rule.check_project(ctx_list):
            key = (finding.rule, finding.path, finding.line,
                   finding.col, finding.message)
            if key in seen:
                continue
            seen.add(key)
            if is_suppressed(
                finding, supp_by_path.get(finding.path, {})
            ):
                suppressed.append(finding)
            else:
                active.append(finding)
    ran_rule_ids = {r.id for r in rules}
    active.extend(_stale_suppressions(
        contexts, supp_by_path, suppressed, ran_rule_ids
    ))
    return active, suppressed, errors, n_files


def add_arguments(parser: argparse.ArgumentParser) -> None:
    """Shared flag definitions for the CLI subcommand and the console
    script (one source of truth, cli.py reuses it)."""
    parser.add_argument(
        "paths", nargs="*", default=None,
        help="files or directories to lint (default: "
        "consensus_clustering_tpu tests bench.py benchmarks examples "
        "scripts, whichever exist)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the machine-readable JSON report instead of text",
    )
    parser.add_argument(
        "--json-out", metavar="FILE", default=None,
        help="also write the JSON report to FILE (CI artifact; the "
        "text/stdout report is unaffected)",
    )
    parser.add_argument(
        "--pack", action="append", default=None, metavar="PACK",
        help="run only this rule pack (repeatable); 'all' = every "
        "rule (the default), 'core' = the universal JAX-hazard rules "
        f"outside any pack; packs: {', '.join(sorted(RULE_PACKS))}",
    )
    parser.add_argument(
        "--baseline", default=DEFAULT_BASELINE,
        help=f"baseline file of grandfathered findings (default: "
        f"{DEFAULT_BASELINE}; a missing file is an empty baseline)",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline to grandfather every current "
        "unsuppressed finding, then exit 0",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: every unsuppressed finding is new",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue and exit",
    )


def run(args: argparse.Namespace) -> int:
    try:
        rules = select_rules(getattr(args, "pack", None))
    except KeyError as e:
        print(
            f"jaxlint: unknown pack: {e.args[0]} (known: "
            f"{', '.join(sorted(RULE_PACKS))}, plus 'all' and 'core')",
            file=sys.stderr,
        )
        return 2
    if args.list_rules:
        for rule in rules:
            pack = pack_of(rule.id)
            suffix = f"  [pack: {pack}]" if pack else ""
            print(f"{rule.id} {rule.name}: {rule.summary}{suffix}")
        return 0

    paths = args.paths
    if not paths:
        # Everything the repo gates: the suppression comments under
        # benchmarks/ (and any future hazard there) must be exercised
        # by the default run, not only by an explicit path list.
        paths = [
            p for p in (
                "consensus_clustering_tpu", "tests", "bench.py",
                "benchmarks", "examples", "scripts",
            )
            if os.path.exists(p)
        ] or ["."]
    try:
        active, suppressed, errors, n_files = lint_paths(paths, rules)
    except FileNotFoundError as e:
        print(f"jaxlint: no such path: {e.args[0]}", file=sys.stderr)
        return 2

    if args.write_baseline:
        fresh = Baseline.from_findings(active)
        try:
            fresh.adopt_whys(Baseline.load(args.baseline))
        except (ValueError, KeyError, TypeError):
            pass  # unreadable old baseline: write without whys
        fresh.save(args.baseline)
        print(
            f"jaxlint: wrote {len(active)} finding(s) to {args.baseline}",
            file=sys.stderr,
        )
        return 0

    if args.no_baseline:
        new, grandfathered = active, []
    else:
        try:
            baseline = Baseline.load(args.baseline)
        except (ValueError, KeyError, TypeError) as e:
            print(f"jaxlint: bad baseline: {e}", file=sys.stderr)
            return 2
        new, grandfathered = baseline.partition(active)

    json_out = getattr(args, "json_out", None)
    if json_out:
        with open(json_out, "w") as f:
            report_json(
                new, grandfathered, suppressed, errors, n_files, f
            )
    reporter = report_json if args.json else report_text
    reporter(new, grandfathered, suppressed, errors, n_files, sys.stdout)
    return 1 if new or errors else 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="jaxlint",
        description=(
            "JAX-aware static analysis: tracer, PRNG and recompile "
            "hazards, before they hit the TPU (docs/LINT.md)"
        ),
    )
    add_arguments(parser)
    return run(parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
