# Ported from consensus_clustering_tpu/autotune/policy.py.
"""Knob resolution with explicit provenance: user pin > calibrated > default.

The one place ``api.py`` and ``serve/executor.py`` turn an
*unset* performance knob into a concrete value.  Three tiers, strictly
ordered:

- ``user-pinned`` — the caller set the knob (constructor kwarg, job
  config field, operator flag).  A pin is NEVER overridden; calibration
  is advice for the undecided, not policy for the decided.
- ``calibrated`` — the :class:`~.store.CalibrationStore` holds a
  parity-gated record for this (environment, knob, shape bucket).
- ``default`` — the static fallback the codebase always had.  For
  ``stream_h_block`` that fallback IS the pre-existing
  :func:`consensus_clustering_tpu_torch.config.autotune_stream_block`
  heuristic (H/8 clamped to [16, 128]), demoted from "the" serving rule
  to the bottom tier of this layer.

Every resolution reports its tier, and every surface that consumes one
discloses it (ROADMAP's never-silent rule): ``metrics_["autotune"]`` on
the api, the ``autotune`` section of a serve result plus the
``autotune_provenance_total`` counters in ``/metrics``, and the
``autotune`` block beside ``vs_baseline`` in a bench record.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, NamedTuple, Optional

from consensus_clustering_tpu_torch.autotune.store import (
    CalibrationError,
    CalibrationStore,
)
from consensus_clustering_tpu_torch.config import autotune_stream_block

logger = logging.getLogger(__name__)

PROVENANCE_USER = "user-pinned"
PROVENANCE_CALIBRATED = "calibrated"
PROVENANCE_DEFAULT = "default"


def default_calibration_dir() -> Optional[str]:
    """``CCTPU_CALIBRATION_DIR`` when set, else None: the port has no
    committed store of its own (the JAX package's seeds were measured on
    another stack), so an unset variable means no records and a job
    resolves to the user-pinned or the default tier."""
    return os.environ.get("CCTPU_CALIBRATION_DIR") or None


class Resolution(NamedTuple):
    """One resolved knob: the value, which tier decided it, and — for
    the calibrated tier — the record that did (its parity section is the
    disclosure payload)."""

    knob: str
    value: Any
    provenance: str
    record: Optional[Dict[str, Any]] = None

    def disclosure(self) -> Dict[str, Any]:
        """The JSON-able form every consumer embeds next to its rate."""
        out: Dict[str, Any] = {
            "value": self.value,
            "provenance": self.provenance,
        }
        if self.record is not None:
            out["parity"] = self.record.get("parity")
            out["calibrated_rate"] = self.record.get("rate")
            out["calibrated_speedup"] = self.record.get("speedup")
        return out


class AutotunePolicy:
    """Resolver over one calibration store (which may be absent)."""

    def __init__(self, store: Optional[CalibrationStore] = None):
        self.store = store

    def _lookup(self, knob: str, bucket: Optional[str]):
        if self.store is None or bucket is None:
            return None
        try:
            return self.store.get(knob, bucket)
        except CalibrationError as e:
            # A broken/foreign/future-schema record must not crash a
            # fit or a serving job — it just cannot steer one.  The
            # refusal is logged, the default tier answers.
            logger.warning(
                "ignoring calibration record for %s@%s: %s",
                knob, bucket, e,
            )
            return None

    def resolve(
        self,
        knob: str,
        bucket: Optional[str],
        *,
        pinned: Any = None,
        default: Any = None,
    ) -> Resolution:
        """Resolve one knob.  ``pinned is not None`` means the caller
        set it (the api spells "unset" as None for every knob this
        layer fills — ``cluster_batch``/``stream_h_block``/
        ``adaptive_tol`` natively, ``split_init`` via its Optional
        default)."""
        if pinned is not None:
            return Resolution(knob, pinned, PROVENANCE_USER)
        record = self._lookup(knob, bucket)
        if record is not None:
            return Resolution(
                knob, record["value"], PROVENANCE_CALIBRATED, record
            )
        return Resolution(knob, default, PROVENANCE_DEFAULT)

    def resolve_stream_block(
        self,
        bucket: Optional[str],
        *,
        job_pin: Optional[int] = None,
        operator_pin: Optional[int] = None,
        n_iterations: int,
    ) -> Resolution:
        """The serving block-size rule, now tiered.

        Job pin and operator pin are both ``user-pinned`` (the operator
        chose a flag; same authority), then a calibrated record for the
        bucket, then the ORIGINAL heuristic —
        :func:`~consensus_clustering_tpu_torch.config.autotune_stream_block`
        (H/8 clamped to [16, 128]) — as the ``default`` tier.
        """
        if job_pin is not None:
            return Resolution("stream_h_block", int(job_pin), PROVENANCE_USER)
        if operator_pin is not None:
            return Resolution(
                "stream_h_block", int(operator_pin), PROVENANCE_USER
            )
        record = self._lookup("stream_h_block", bucket)
        if record is not None:
            return Resolution(
                "stream_h_block", int(record["value"]),
                PROVENANCE_CALIBRATED, record,
            )
        return Resolution(
            "stream_h_block",
            autotune_stream_block(n_iterations),
            PROVENANCE_DEFAULT,
        )
