"""Face clustering: hierarchical (with same-photo constraint), rank-order, DBSCAN.

The port's own copy of ``hse_facerec_tf_tpu/pipelines/clustering.py``, the
reference's clustering layer (``age_gender_identity/facial_clustering.py``)
with the same public contract: ``get_facial_clusters(dist_matrix,
distance_threshold, all_indices, no_images_in_cluster)`` -> list of index
lists, sorted by size (docstring :214-224, sort :284). The O(N²) distance
matrix is computed on the device (``ops/distance.py``, one matmul); the
agglomeration itself is a host-side graph algorithm in float64 (scipy HAC /
union-find): the sequential merge logic does not vectorize.

Methods:
  - 'scipy': single-linkage HAC + fcluster at the distance threshold, then —
    when photo indices are provided — each cluster is re-clustered with a +100
    penalty between same-photo faces under complete linkage, preventing two
    faces from one photo landing in one identity cluster (:240-259).
  - 'rankorder': Zhu et al. rank-order clustering, iterative cluster-graph
    merging with Union-Find connected components (:24-204; t=14,
    norm threshold 0.9, top-20 neighbour lists, K=12 normalization).
  - 'dbscan': sklearn DBSCAN over the precomputed matrix (:261-266).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _hac_clusters(dist_matrix: np.ndarray, threshold: float,
                  all_indices: Optional[Sequence[int]]) -> List[List[int]]:
    import scipy.cluster.hierarchy as hac
    from scipy.spatial.distance import squareform

    condensed = squareform(dist_matrix, checks=False)
    z = hac.linkage(condensed, method="single")
    labels = hac.fcluster(z, threshold, "distance")
    clusters: List[List[int]] = []
    if all_indices is None:
        return [[i for i, l in enumerate(labels) if l == lbl] for lbl in set(labels)]
    inf_dist = 100.0
    all_indices = np.asarray(all_indices)
    for lbl in set(labels):
        cluster = [i for i, l in enumerate(labels) if l == lbl]
        if len(cluster) > 1:
            sub = dist_matrix[np.ix_(cluster, cluster)].astype(np.float64).copy()
            same_photo = all_indices[cluster][:, None] == all_indices[cluster][None, :]
            penalty = inf_dist * (same_photo & ~np.eye(len(cluster), dtype=bool))
            sub += penalty
            z2 = hac.linkage(squareform(sub, checks=False), method="complete")
            labels2 = hac.fcluster(z2, inf_dist / 2, "distance")
            for l2 in set(labels2):
                clusters.append([cluster[i] for i, l in enumerate(labels2) if l == l2])
        else:
            clusters.append(cluster)
    return clusters


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, a: int) -> int:
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _rank_order_clusters(dist_matrix: np.ndarray, n_neighbours: int = 20,
                         k_norm: int = 12, t: float = 14.0,
                         norm_threshold: float = 0.9) -> List[List[int]]:
    """Iterative rank-order cluster merging (reference :134-204).

    Per-face top-N absolute neighbour lists stay fixed; clusters carry top-N
    nearest-cluster lists (min-linkage). Each round adds an edge between
    neighbouring clusters whose normalized min-distance < norm_threshold and
    whose cluster-level rank-order distance < t, then merges connected
    components; repeats until no merge happens.
    """
    n = dist_matrix.shape[0]
    order = np.argsort(dist_matrix, axis=1, kind="stable")
    face_nbrs = order[:, :n_neighbours]                     # includes self at rank 0
    face_nbr_dists = np.take_along_axis(dist_matrix, face_nbrs, axis=1)
    face_topk_sum = face_nbr_dists[:, :k_norm].sum(axis=1)
    # the reference divides by min(len(neighbour_list), K)
    # (facial_clustering.py:85-86) — the neighbour list holds min(n, 20)
    # entries, so with fewer than K faces the divisor is n, not K
    k_eff = min(face_nbrs.shape[1], k_norm)

    clusters: List[List[int]] = [[i] for i in range(n)]

    def cluster_min_dist(c1: List[int], c2: List[int]) -> float:
        return float(dist_matrix[np.ix_(c1, c2)].min())

    def cluster_neighbours(cls: List[List[int]]):
        m = len(cls)
        cmat = np.empty((m, m))
        for i, c1 in enumerate(cls):
            for j in range(i, m):
                d = cluster_min_dist(c1, cls[j])
                cmat[i, j] = cmat[j, i] = d
        nbr_idx = np.argsort(cmat, axis=1, kind="stable")[:, :n_neighbours]
        return cmat, nbr_idx

    def rank_order_between(nbrs_i: np.ndarray, nbrs_j: np.ndarray, i: int, j: int) -> float:
        def asym(a_list, b_list, b):
            pos_in_b = {e: r for r, e in enumerate(b_list)}
            penalty = 0.0
            last = len(a_list) - 1
            for rank, e in enumerate(a_list):
                r_b = pos_in_b.get(e)
                if r_b == 0:
                    return penalty, rank + 1
                if r_b is not None:
                    penalty += r_b
            return penalty, last + 1

        d_ij, n_i = asym(list(nbrs_i), list(nbrs_j), j)
        d_ji, n_j = asym(list(nbrs_j), list(nbrs_i), i)
        return (d_ij + d_ji) / min(n_i, n_j)

    merged = True
    first = True
    while first or merged:
        first = False
        m = len(clusters)
        cmat, nbr_idx = cluster_neighbours(clusters)
        uf = _UnionFind(m)
        merged = False
        for i in range(m):
            for j in nbr_idx[i]:
                j = int(j)
                if i == j:
                    continue
                faces = clusters[i] + clusters[j]
                norm_sum = face_topk_sum[faces].sum()
                denom = (norm_sum / k_eff) / len(faces)
                normalized = cmat[i, j] / max(denom, 1e-12)
                if normalized >= norm_threshold:
                    continue
                if rank_order_between(nbr_idx[i], nbr_idx[j], i, j) >= t:
                    continue
                uf.union(i, j)
                merged = True
        groups = {}
        for i in range(m):
            groups.setdefault(uf.find(i), []).append(i)
        clusters = [[f for ci in g for f in clusters[ci]] for g in groups.values()]
        if len(clusters) == m:
            merged = False
    return [c for c in clusters if len(c) > 1]


def get_facial_clusters(dist_matrix: np.ndarray, distance_threshold: float = 1.0,
                        all_indices: Optional[Sequence[int]] = None,
                        no_images_in_cluster: int = 1,
                        method: str = "scipy") -> List[List[int]]:
    """Cluster faces by pairwise distance. Same contract as the reference's
    ``get_facial_clusters`` (``facial_clustering.py:214-285``); ``method``
    replaces its compile-time ``use_clustering`` switch (:17-20)."""
    dist_matrix = np.asarray(dist_matrix)
    if dist_matrix.shape[0] < 2:
        return []
    if method == "scipy":
        clusters = _hac_clusters(dist_matrix, distance_threshold, all_indices)
    elif method in ("rankorder", "rankorder_py"):
        # rank-order parameters: the reference's main entry hardcodes
        # (norm_threshold=0.9, t=14) (facial_clustering.py:137-138); its
        # grid-search variant threads them as a (distance, rank) tuple
        # (facial_clustering_test.py:136,235) — accept both conventions.
        if isinstance(distance_threshold, (tuple, list)):
            norm_threshold, t = float(distance_threshold[0]), float(distance_threshold[1])
        else:
            norm_threshold, t = 0.9, 14.0
        if method == "rankorder":
            # native C++ core when the toolchain is available (same semantics,
            # interpreted-Python-free inner loops); see native/rankorder.cc
            from ..native import rankorder as native_ro

            if native_ro.available():
                clusters = native_ro.rank_order_cluster_native(
                    dist_matrix, norm_threshold=norm_threshold, t=t)
            else:
                clusters = _rank_order_clusters(dist_matrix, t=t,
                                                norm_threshold=norm_threshold)
        else:
            clusters = _rank_order_clusters(dist_matrix, t=t,
                                            norm_threshold=norm_threshold)
    elif method == "dbscan":
        from sklearn.cluster import DBSCAN

        db = DBSCAN(eps=distance_threshold, min_samples=no_images_in_cluster,
                    metric="precomputed").fit(dist_matrix)
        clusters = [[i for i, l in enumerate(db.labels_) if l == lbl]
                    for lbl in set(db.labels_) if lbl != -1]
    else:
        raise ValueError(method)
    clusters.sort(key=len, reverse=True)
    return clusters


def clusters_to_labels(clusters: List[List[int]], n: int) -> np.ndarray:
    """Index lists -> label vector; unclustered elements get fresh singleton
    labels (reference ``facial_clustering_test.py:402-409``)."""
    y = -np.ones(n, dtype=np.int64)
    for ind, cluster in enumerate(clusters):
        y[cluster] = ind
    nxt = len(clusters)
    for i in range(n):
        if y[i] == -1:
            nxt += 1
            y[i] = nxt
    return y
