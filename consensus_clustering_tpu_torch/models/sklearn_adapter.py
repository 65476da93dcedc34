"""Host adapter for sklearn-compatible estimators.

The original library accepts any estimator with ``fit_predict`` and an
``n_clusters`` or ``n_components`` attribute, configured through
``set_params``.  This adapter keeps that plugin surface: the estimator
runs on the host, while the plan, the counts and the analysis stay on the
device (:mod:`..parallel.host`).  Each call clones the estimator, so calls
from several threads share nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class SklearnClusterer:
    """Wrap an sklearn estimator as a :class:`.protocol.HostClusterer`.

    The cluster count goes to ``n_clusters`` (KMeans, agglomerative,
    spectral) or ``n_components`` (GaussianMixture); an estimator with
    neither raises AttributeError.
    """

    def __init__(self, estimator: Any,
                 options: Optional[Dict[str, Any]] = None):
        if not hasattr(estimator, "fit_predict"):
            raise AttributeError(
                f"{type(estimator).__name__} has no fit_predict method"
            )
        if not (
            hasattr(estimator, "n_clusters")
            or hasattr(estimator, "n_components")
        ):
            raise AttributeError(
                "clusterer has neither n_clusters nor n_components attribute"
            )
        self.estimator = estimator
        self.options = dict(options or {})

    def _configure(self, seed: int, k: int):
        from sklearn.base import clone

        est = clone(self.estimator)
        if hasattr(est, "n_clusters"):
            est.n_clusters = k
        else:
            est.n_components = k
        params = dict(self.options)
        if "random_state" in est.get_params():
            params["random_state"] = seed
        if params:
            est.set_params(**params)
        return est

    def fit_predict_host(
        self, seed: int, x: np.ndarray, k: int
    ) -> np.ndarray:
        est = self._configure(seed, k)
        return np.asarray(est.fit_predict(x), dtype=np.int32)
