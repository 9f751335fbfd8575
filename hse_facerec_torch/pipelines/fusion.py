"""Dempster-Shafer gender fusion over a face cluster.

The port's own copy of ``hse_facerec_tf_tpu/pipelines/fusion.py`` (numpy
only): the reference's evidence-combination scheme
(``process_photos.py:159-217``). Per-face male probability → proximity to the
two-class decision template dt = [[0.875, 0.125], [0.353, 0.647]] → log belief
degrees → summed over the cluster → argmax class (0 = male, 1 = female).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

DECISION_TEMPLATE = np.array([[0.875, 0.125], [0.353, 0.647]])


def _proximities(pred: np.ndarray, dt: np.ndarray = DECISION_TEMPLATE) -> np.ndarray:
    """prox_i = (1 + ||dt_i - pred||)^-1, normalized (reference :160-169)."""
    norms = np.linalg.norm(dt - pred[None, :], axis=1)
    prox = 1.0 / (1.0 + norms)
    return prox / prox.sum()


def _log_beliefs(prox: np.ndarray) -> np.ndarray:
    """Log belief degrees (reference ``compute_b`` :184-195)."""
    n = len(prox)
    out = np.empty(n)
    for j in range(n):
        others = np.prod([1.0 - prox[k] for k in range(n) if k != j])
        num = np.log(prox[j]) + np.sum([np.log(1.0 - prox[k]) for k in range(n) if k != j])
        denom = np.log(1.0 - prox[j] * (1.0 - others))
        out[j] = num - denom
    return out


def dempster_shafer_gender(male_probs: Sequence[float]) -> int:
    """Fuse per-face gender evidence for one cluster.

    Returns 0 (male) or 1 (female), matching reference
    ``dempster_shafer_gender`` (:208-217) where the per-face prediction vector
    is [p_male, 1 - p_male]."""
    beliefs = []
    for p in np.atleast_1d(np.asarray(male_probs, dtype=np.float64)):
        pred = np.array([p, 1.0 - p])
        prox = _proximities(pred)
        beliefs.append(_log_beliefs(prox))
    total = np.sum(beliefs, axis=0)
    return int(np.argmax(total))
