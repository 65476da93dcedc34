# Copied from consensus_clustering_tpu/lint/findings.py.
"""Finding, suppression and baseline model for jaxlint.

A :class:`Finding` is one rule violation at one source location.  Two
mechanisms keep the linter adoptable on a tree that already has
violations:

- **per-line suppression** — a ``# jaxlint: disable=JL00x`` comment on
  the finding's line silences that rule (comma-separate several IDs,
  or ``disable=all``).  Suppressions are for *intentional* hazards and
  should carry a trailing justification, e.g.::

      t1 = time.perf_counter()  # jaxlint: disable=JL007 -- times compile()

- **committed baseline** — a JSON file of grandfathered findings.
  Findings matching the baseline are reported but do not fail the run;
  only *new* findings (not suppressed, not baselined) exit nonzero.
  The goal state is an empty baseline: fix or suppress instead.

Baseline entries are fingerprinted by ``(rule, path, stripped source
line text)`` rather than line numbers, so unrelated edits above a
grandfathered finding do not invalidate the whole file's baseline.
Duplicate fingerprints are matched as a multiset: a baseline with one
entry for a pattern grandfathers exactly one occurrence of it.
"""

from __future__ import annotations

import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

BASELINE_VERSION = 1

# A ``jaxlint: disable=JL001`` comment / ``disable=JL001,JL007`` /
# ``disable=all``; anything after the ID list (e.g. a ``-- why``
# justification) is ignored.  Matched against COMMENT tokens only (see
# :func:`suppressions_for_source`), so the pattern may safely appear in
# docstrings, string fixtures and prose without registering.
_SUPPRESS_RE = re.compile(
    r"#\s*jaxlint:\s*disable=([A-Za-z0-9_,\s]+)"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str          # "JL001"
    path: str          # path as reported (normalised by the runner)
    line: int          # 1-based
    col: int           # 0-based, as in the ast module
    message: str
    text: str = ""     # the stripped source line, for fingerprinting

    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.path.replace(os.sep, "/"), self.text)

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path.replace(os.sep, "/"),
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "text": self.text,
        }


def _parse_ids(raw: str) -> set:
    ids = {tok.strip().upper() for tok in raw.split(",") if tok.strip()}
    # A trailing justification without a comma separator may glue to
    # the last ID ("JL007 -- why" splits fine; "JL007 why" would
    # not) — keep only tokens that look like rule IDs or 'all'.
    ids = {t.split()[0] for t in ids if t}
    return {t for t in ids if t == "ALL" or re.fullmatch(r"JL\d{3}", t)}


def suppressions_for_source(source: str) -> Dict[int, set]:
    """Map 1-based line number -> set of suppressed rule IDs on that line.

    ``all`` suppresses every rule.  Only the finding's own line is
    consulted — a suppression comment must sit on the physical line the
    finding is reported at (for a multi-line statement, the statement's
    first line, which is where the ast anchors it).

    Only genuine COMMENT tokens register: the pattern inside a docstring
    or a string literal (this repo's own lint tests are full of those)
    is prose, not a suppression — critical now that an unconsumed
    suppression is itself a finding (JL000 stale-suppression).  If the
    source does not tokenize (the runner only calls this after a
    successful ``ast.parse``, but API callers may not), fall back to the
    historical line-based scan rather than silently dropping
    suppressions and inventing findings.
    """
    out: Dict[int, set] = {}
    try:
        tokens = list(
            tokenize.generate_tokens(io.StringIO(source).readline)
        )
    except (tokenize.TokenError, IndentationError, SyntaxError):
        for i, line in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                ids = _parse_ids(m.group(1))
                if ids:
                    out[i] = ids
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        ids = _parse_ids(m.group(1))
        if ids:
            out.setdefault(tok.start[0], set()).update(ids)
    return out


def is_suppressed(finding: Finding, suppressions: Dict[int, set]) -> bool:
    ids = suppressions.get(finding.line)
    if not ids:
        return False
    return "ALL" in ids or finding.rule.upper() in ids


@dataclass
class Baseline:
    """Multiset of grandfathered finding fingerprints.

    Each entry may carry an optional ``why`` — a one-line human
    justification for why the finding is deliberate.  ``why`` is
    documentation only: it never participates in matching, and
    ``--write-baseline`` preserves the ``why`` of entries that survive
    the rewrite (see :meth:`adopt_whys`).
    """

    entries: List[Tuple[str, str, str]] = field(default_factory=list)
    whys: List[str] = field(default_factory=list)  # parallel; "" = none

    def __post_init__(self) -> None:
        if len(self.whys) < len(self.entries):
            self.whys.extend(
                [""] * (len(self.entries) - len(self.whys))
            )

    @classmethod
    def load(cls, path: str) -> "Baseline":
        """Read a baseline file; a missing file is an empty baseline."""
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict) or "findings" not in payload:
            raise ValueError(
                f"{path}: not a jaxlint baseline (expected an object "
                "with a 'findings' list)"
            )
        entries = []
        whys = []
        for e in payload["findings"]:
            entries.append(
                (str(e["rule"]), str(e["path"]), str(e.get("text", "")))
            )
            whys.append(str(e.get("why", "")))
        return cls(entries, whys)

    @classmethod
    def from_findings(cls, findings: Iterable[Finding]) -> "Baseline":
        return cls([f.fingerprint() for f in findings])

    def adopt_whys(self, other: "Baseline") -> None:
        """Carry justifications over from ``other`` for matching
        fingerprints (multiset: each of other's whys is used once)."""
        pool: Dict[Tuple[str, str, str], List[str]] = {}
        for e, w in zip(other.entries, other.whys):
            if w:
                pool.setdefault(e, []).append(w)
        for i, e in enumerate(self.entries):
            if not self.whys[i] and pool.get(e):
                self.whys[i] = pool[e].pop(0)

    def save(self, path: str) -> None:
        records = []
        for (r, p, t), w in sorted(
            zip(self.entries, self.whys), key=lambda it: it[0]
        ):
            rec: Dict[str, str] = {"rule": r, "path": p, "text": t}
            if w:
                rec["why"] = w
            records.append(rec)
        payload = {
            "version": BASELINE_VERSION,
            "note": (
                "jaxlint grandfathered findings; matched by (rule, path, "
                "source line text), not line numbers.  Goal state: empty "
                "— fix the code or add a justified per-line suppression "
                "instead of baselining new findings.  'why' is the "
                "one-line justification for keeping an entry."
            ),
            "findings": records,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=False)
            f.write("\n")
        os.replace(tmp, path)

    def partition(
        self, findings: Iterable[Finding]
    ) -> Tuple[List[Finding], List[Finding]]:
        """Split findings into (new, grandfathered) against this baseline.

        Multiset semantics: each baseline entry absorbs at most one
        matching finding, so a second occurrence of a grandfathered
        pattern is NEW and fails the run.
        """
        budget: Dict[Tuple[str, str, str], int] = {}
        for e in self.entries:
            budget[e] = budget.get(e, 0) + 1
        new: List[Finding] = []
        old: List[Finding] = []
        for f in findings:
            fp = f.fingerprint()
            if budget.get(fp, 0) > 0:
                budget[fp] -= 1
                old.append(f)
            else:
                new.append(f)
        return new, old
