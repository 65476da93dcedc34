# Copied from consensus_clustering_tpu/lint/__init__.py.
"""jaxlint: JAX-aware static analysis for this repo's hazard idioms.

Zero-dependency (stdlib ``ast`` only — importing this package never
imports jax; its parent package imports torch to pin full-f32 GEMMs,
so ``import consensus_clustering_tpu_torch.lint`` pays for torch's
import), rule-registry based, with per-line suppressions and a
committed baseline.  See docs/LINT.md for the rule catalogue and
workflow; ``python -m consensus_clustering_tpu_torch lint`` to run.
The rules, their messages, the default paths and the baseline are the
reference package's, so both packages write equal reports.

Public surface:

- :func:`lint_paths` / :func:`lint_file` — programmatic linting
- :func:`main` — the CLI (also the ``jaxlint`` console script)
- :class:`Finding`, :class:`Baseline` — the data model
- :class:`Rule`, :class:`ProjectRule`, :func:`register`,
  :func:`all_rules`, :func:`select_rules` — extension API (per-file
  rules live in lint/rules.py and lint/packs.py; cross-file contract
  rules in lint/contracts.py)
"""

from consensus_clustering_tpu_torch.lint.findings import (
    Baseline,
    Finding,
)
from consensus_clustering_tpu_torch.lint.registry import (
    RULE_PACKS,
    ModuleContext,
    ProjectRule,
    Rule,
    all_rules,
    register,
    select_rules,
)
from consensus_clustering_tpu_torch.lint.runner import (
    lint_file,
    lint_paths,
    main,
)

__all__ = [
    "Baseline",
    "Finding",
    "ModuleContext",
    "ProjectRule",
    "RULE_PACKS",
    "Rule",
    "all_rules",
    "register",
    "select_rules",
    "lint_file",
    "lint_paths",
    "main",
]
