"""Input admission: reject data the sweep cannot count correctly."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def check_input_matrix(
    x, max_report: int = 20
) -> Optional[Dict[str, Any]]:
    """Why a data matrix is numerically inadmissible, or None if fine.

    ``reason="non_finite"``: NaN/Inf cells, with the first ``max_report``
    offending ``rows``/``cols`` (NaN is absorbing under the accumulation
    GEMMs: one bad cell poisons whole count rows).  ``reason=
    "zero_variance"``: every row identical, so no K >= 2 partition exists.
    The payload carries ``error``, ``code="invalid_data"`` and ``hint``.
    """
    x = np.asarray(x)
    finite = np.isfinite(x)
    if not finite.all():
        bad_rows, bad_cols = np.nonzero(~finite)
        return {
            "error": (
                f"'data' contains {int((~finite).sum())} non-finite "
                f"value(s) (NaN/Inf); first at row {int(bad_rows[0])}, "
                f"col {int(bad_cols[0])}"
            ),
            "code": "invalid_data",
            "reason": "non_finite",
            "rows": [int(v) for v in np.unique(bad_rows)[:max_report]],
            "cols": [int(v) for v in np.unique(bad_cols)[:max_report]],
            "hint": (
                "NaN is absorbing under the co-clustering accumulation: "
                "one bad cell silently poisons whole count rows. Clean "
                "or impute the listed rows/cols and resubmit"
            ),
        }
    if x.shape[0] > 1 and bool(np.all(x == x[0])):
        return {
            "error": (
                "'data' has zero variance (every row identical): no "
                "clustering into K >= 2 groups is defined"
            ),
            "code": "invalid_data",
            "reason": "zero_variance",
            "rows": [],
            "cols": [],
            "hint": (
                "check the upstream feature pipeline — identical rows "
                "usually mean a join or scaling step emitted a "
                "constant matrix"
            ),
        }
    return None
