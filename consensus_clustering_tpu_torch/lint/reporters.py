# Copied from consensus_clustering_tpu/lint/reporters.py.
"""Output formatting for jaxlint: human text and machine JSON.

The JSON schema (version 1) is a stability contract covered by
tests/test_lint.py::test_json_reporter_schema — extend it by adding
keys, never by renaming or repurposing existing ones:

    {
      "version": 1,
      "findings": [
        {"rule": "JL007", "path": "a.py", "line": 3, "col": 0,
         "message": "...", "text": "t1 = ...", "status": "new"}
      ],
      "summary": {"new": 1, "baseline": 0, "suppressed": 0,
                  "files": 12, "errors": 0}
    }

``status`` is one of ``new`` (fails the run), ``baseline``
(grandfathered) or ``suppressed`` (silenced by a per-line comment).
"""

from __future__ import annotations

import json
from typing import Dict, List, TextIO

from consensus_clustering_tpu_torch.lint.findings import Finding

JSON_SCHEMA_VERSION = 1


def _ordered(findings: List[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def report_text(
    new: List[Finding],
    baseline: List[Finding],
    suppressed: List[Finding],
    errors: List[str],
    n_files: int,
    out: TextIO,
) -> None:
    for err in errors:
        print(f"error: {err}", file=out)
    for f in _ordered(new):
        print(f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}",
              file=out)
    parts = [f"{len(new)} new finding{'s' if len(new) != 1 else ''}"]
    if baseline:
        parts.append(f"{len(baseline)} baselined")
    if suppressed:
        parts.append(f"{len(suppressed)} suppressed")
    if errors:
        parts.append(f"{len(errors)} file error(s)")
    print(
        f"jaxlint: {', '.join(parts)} across {n_files} file"
        f"{'s' if n_files != 1 else ''}",
        file=out,
    )


def report_json(
    new: List[Finding],
    baseline: List[Finding],
    suppressed: List[Finding],
    errors: List[str],
    n_files: int,
    out: TextIO,
) -> None:
    findings: List[Dict[str, object]] = []
    for status, group in (
        ("new", new), ("baseline", baseline), ("suppressed", suppressed),
    ):
        for f in _ordered(group):
            entry = f.to_json()
            entry["status"] = status
            findings.append(entry)
    payload = {
        "version": JSON_SCHEMA_VERSION,
        "findings": findings,
        "summary": {
            "new": len(new),
            "baseline": len(baseline),
            "suppressed": len(suppressed),
            "files": n_files,
            "errors": len(errors),
        },
        "errors": errors,
    }
    json.dump(payload, out, indent=1)
    out.write("\n")
