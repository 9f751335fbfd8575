"""Clustering-threshold model selection with early stopping.

The port's own copy of ``hse_facerec_tf_tpu/eval/threshold_search.py``;
``sklearn`` is imported inside the functions that need it.

Reproduces the reference's grid search
(``facial_clustering_test.py:447-499``): sweep the distance threshold over
validation datasets, score each setting (B-Cubed precision by default, as the
reference uses for the scipy path; V-measure for rank-order), stop early when
the score drops or exceeds a target, return the best threshold + scores.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..pipelines.clustering import clusters_to_labels, get_facial_clusters
from .clustering_metrics import bcubed


def clustering_score(dist_matrix: np.ndarray, y_true: np.ndarray,
                     threshold, method: str = "scipy",
                     statistic: str = "bcubed_precision") -> float:
    """``threshold``: a float for scipy/dbscan; for rank-order pass a
    (norm_threshold, rank_t) tuple — the reference's grid-search convention
    (facial_clustering_test.py:452-459)."""
    clusters = get_facial_clusters(dist_matrix, threshold, method=method)
    y_pred = clusters_to_labels(clusters, len(y_true))
    if statistic == "bcubed_precision":
        return bcubed(y_true, y_pred)[0]
    if statistic == "bcubed_f":
        return bcubed(y_true, y_pred)[2]
    if statistic == "v_measure":
        from sklearn import metrics

        return metrics.homogeneity_completeness_v_measure(y_true, y_pred)[2]
    raise ValueError(statistic)


def search_distance_threshold(datasets: Sequence[Tuple[np.ndarray, np.ndarray]],
                              method: str = "scipy",
                              thresholds: Optional[np.ndarray] = None,
                              statistic: str = "bcubed_precision",
                              early_stop_drop: float = 0.01,
                              early_stop_target: float = 0.85
                              ) -> Dict[str, object]:
    """datasets: [(dist_matrix, y_true)] validation sets.

    Returns {"best_threshold", "best_score", "trace": [(thr, score)]}.
    Early-stop rules follow the reference (:491-495): stop when the running
    score falls more than ``early_stop_drop`` below the previous step, or
    exceeds ``early_stop_target``.
    """
    if thresholds is None:
        thresholds = np.linspace(0.6, 1.3, 71)  # reference :476
    best_thr, best_score, prev = None, -np.inf, -np.inf
    trace: List[Tuple[float, float]] = []
    for thr in thresholds:
        score = float(np.mean([
            clustering_score(d, y, float(thr), method, statistic)
            for d, y in datasets]))
        trace.append((float(thr), score))
        if score > best_score:
            best_score, best_thr = score, float(thr)
        if score < prev - early_stop_drop:
            break
        if score > early_stop_target:
            break
        prev = score
    return {"best_threshold": best_thr, "best_score": best_score, "trace": trace}


def search_rankorder_thresholds(datasets: Sequence[Tuple[np.ndarray, np.ndarray]],
                                distance_thresholds: Optional[np.ndarray] = None,
                                rank_thresholds: Sequence[int] = range(12, 22, 2),
                                statistic: str = "v_measure"
                                ) -> Dict[str, object]:
    """The reference's 2-D rank-order grid search
    (``facial_clustering_test.py:451-472``): sweep (distanceThreshold ×
    rankThreshold), scoring V-measure; break the inner loop when the score
    stops improving, the outer loop when a distance row improved nothing.

    Returns {"best_threshold": (dist, rank), "best_score", "trace"}.
    """
    if distance_thresholds is None:
        distance_thresholds = np.linspace(1.02, 1.1, 9)   # reference :452
    best_score, prev = 0.0, 0.0
    best_thr: Tuple[float, int] = (0.0, 0)
    trace: List[Tuple[float, int, float]] = []
    for dist_thr in distance_thresholds:
        prev = 0.0
        best_changed = False
        for rank_t in rank_thresholds:
            score = float(np.mean([
                clustering_score(d, y, (float(dist_thr), int(rank_t)),
                                 "rankorder", statistic)
                for d, y in datasets]))
            trace.append((float(dist_thr), int(rank_t), score))
            if score > best_score:
                best_score, best_thr = score, (float(dist_thr), int(rank_t))
                best_changed = True
            if score <= prev:                              # reference :469
                break
            prev = score
        if not best_changed:                               # reference :471
            break
    return {"best_threshold": best_thr, "best_score": best_score,
            "trace": trace}
