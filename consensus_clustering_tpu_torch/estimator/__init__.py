"""Sampled-pair consensus estimator: O(M) state instead of O(N²).

The port of the reference package's ``estimator/`` for one device:

- :mod:`.sampler`  — seeded uniform upper-triangle pair draws on the
  device, the reference's bit for bit;
- :mod:`.bounds`   — the DKW/Massart error bands, the ``n_pairs`` default
  and the disclosure every estimator result carries (stdlib only);
- :mod:`.engine`   — the O(M) pair-count streaming engine
  (:class:`~.engine.PairConsensusEngine`), whose sampled-pair counts
  equal the dense engines' matrix entries bit for bit;
- :mod:`.tiled`    — exact curves for one chosen K, a row tile at a time
  on the device (the ``exact_best_k`` refinement);
- :mod:`.validate` — the exact-vs-estimator bound gate
  (``python -m consensus_clustering_tpu_torch.estimator.validate``).

Lazy (PEP 562): importing the package imports none of its modules.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "PairConsensusEngine": "engine",
    "run_pair_estimate": "engine",
    "verify_pair_state_frame": "engine",
    "sample_pairs": "sampler",
    "pair_key": "sampler",
    "default_n_pairs": "bounds",
    "pac_error_bound": "bounds",
    "cdf_error_bound": "bounds",
    "bound_disclosure": "bounds",
    "exact_curves_for_k": "tiled",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
