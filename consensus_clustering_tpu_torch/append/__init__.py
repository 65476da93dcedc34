"""Incremental consensus for growing datasets.

The port of the reference package's ``append/``: a completed packed run's
bit-planes become a digest-verified **plane store**, and a row append
(``N -> N + dN``) runs only the new resample lanes on the device, reusing
the old lanes' counts exactly.

- :mod:`.store`     — the persistent plane store (a copy of the
  reference's, manifests naming their backend);
- :mod:`.mixing`    — numpy exact mixing: widening, merging generations,
  and the host oracle of the curves (a copy of the reference's);
- :mod:`.staleness` — the DKW-backed ``refresh_recommended`` verdict, its
  CDFs counted on the device;
- :mod:`.engine`    — ``bootstrap_generation`` and ``run_append``.

Lazy (PEP 562): importing the package imports none of its modules.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "PlaneStore": "store",
    "PlaneStoreError": "store",
    "STORE_SCHEMA": "store",
    "merge_generations": "mixing",
    "pair_counts": "mixing",
    "widen_planes": "mixing",
    "staleness_report": "staleness",
    "run_append": "engine",
    "bootstrap_generation": "engine",
    "generation_seed": "engine",
    "check_compat": "engine",
    "curves_for_planes": "engine",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
