"""Clustering quality metrics: ARI/AMI/V-measure + extended B-Cubed.

The port's own copy of ``hse_facerec_tf_tpu/eval/clustering_metrics.py``;
``sklearn`` is imported inside the functions that need it.

Reproduces the reference's metric suite
(``facial_clustering_test.py:322-359,416-423``). The B-Cubed implementation is
vectorized (the reference's is O(N²) Python loops) but numerically identical
for single-label elements.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def bcubed(y_true: np.ndarray, y_pred: np.ndarray, beta: float = 1.0
           ) -> Tuple[float, float, float]:
    """Extended B-Cubed precision/recall/F for single-label elements.

    With singleton label sets the reference's formulas reduce to:
      precision = mean_i mean_{j: true_j == true_i} [pred_i == pred_j]
      recall    = mean_i mean_{j: pred_j == pred_i} [true_i == true_j]
    (argument order follows the reference's ``BCubed_stat(y_true, y_pred)``
    call, :353-359).
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    same_true = y_true[:, None] == y_true[None, :]
    same_pred = y_pred[:, None] == y_pred[None, :]
    p = np.mean([same_pred[i, same_true[i]].mean() for i in range(len(y_true))])
    r = np.mean([same_true[i, same_pred[i]].mean() for i in range(len(y_true))])
    f = (1.0 + beta ** 2) * p * r / (beta ** 2 * p + r) if (p + r) else 0.0
    return float(p), float(r), float(f)


def clustering_statistics(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    """The full metric dict the reference prints per run (:416-423)."""
    from sklearn import metrics

    hom, comp, v = metrics.homogeneity_completeness_v_measure(y_true, y_pred)
    bp, br, bf = bcubed(y_true, y_pred)
    return {
        "num_classes": int(len(np.unique(y_true))),
        "num_clusters": int(len(np.unique(y_pred))),
        "ari": float(metrics.adjusted_rand_score(y_true, y_pred)),
        "ami": float(metrics.adjusted_mutual_info_score(y_true, y_pred,
                                                        average_method="arithmetic")),
        "homogeneity": float(hom),
        "completeness": float(comp),
        "v_measure": float(v),
        "bcubed_precision": bp,
        "bcubed_recall": br,
        "bcubed_f": bf,
    }
