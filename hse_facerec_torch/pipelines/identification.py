"""Face identification: 1-NN / k-NN on the device and the reference's
protocols.

Counterpart of ``hse_facerec_tf_tpu/pipelines/identification.py``
(reference ``facerec_test.py:177-288,401-432``): features are
L2-normalized, the gallery x probe distances are one matmul, and
prediction is argmin / top-k + majority vote. ``quantized=True`` keeps the
gallery int8 and ranks through the int8 1-NN kernel (K2b) on CUDA. With a
``mesh``, k=1 euclidean prediction runs the gallery-sharded sweep
(``parallel/knn.py``).

Protocols: 50 % StratifiedShuffleSplit, seed 0 (``classifier_tester``
:200-207); singleton-class removal (:408-414); one gallery image per class
(``get_single_image_per_class_cv`` :177-198, seed 0, 10 splits).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..numerics import precision_scope
from ..ops.distance import l2_normalize, nearest_neighbor, top_k_neighbors
from ..ops.kernels.knn import nearest_neighbor_auto, quantize_embeddings
from ..parallel.knn import nearest_neighbor_sharded
from .detector import resolve_device


class KNNIdentifier:
    """k-NN classifier over L2-normalized embeddings, on ``device``.

    k=1 euclidean prediction goes through ``nearest_neighbor_auto``:
    matmul + argmin (the reference's ``nearest_neighbor``), or on CUDA the
    matrix-free kernel K2a on f32 operands once the (M, N) f32 matrix
    would pass 4 GiB; either way the ranking is exact f32.
    ``quantized``: store the gallery int8 (one symmetric global scale,
    4x less device memory per enrolled identity) and rank through the int8
    kernel K2b on CUDA, its exact twin on the CPU; distances are exact
    squared L2 between the dequantized embeddings.
    ``mesh`` (``parallel.sharding.Mesh``): k=1 euclidean prediction splits
    the gallery over its ``data`` axis (``nearest_neighbor_sharded``, f32
    or quantized inside the sweep, as the reference's mesh path); the
    rows live on the mesh's first device in between, which replaces
    ``device``."""

    def __init__(self, k: int = 1, metric: str = "euclidean", normalize: bool = True,
                 quantized: bool = False, device="cuda", mesh=None):
        if quantized and (k != 1 or metric != "euclidean"):
            raise ValueError("quantized gallery supports k=1 euclidean only")
        self.k = k
        self.metric = metric
        self.normalize = normalize
        self.quantized = quantized
        self.mesh = mesh
        self.device = (mesh.devices.flat[0] if mesh is not None
                       else resolve_device(device))
        self._gallery = None
        self._labels = None        # host numpy: labels are gathered on the host

    def _rows(self, x) -> torch.Tensor:
        """numpy rows or a tensor on any device -> f32 rows on ``device``."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return l2_normalize(x) if self.normalize else x

    def fit(self, features: np.ndarray, labels: np.ndarray) -> "KNNIdentifier":
        g = self._rows(features)
        # the reference quantizes the gallery eagerly: an exact division;
        # the mesh path quantizes inside the sharded sweep
        self._gallery = (quantize_embeddings(g) if self.quantized and self.mesh is None
                         else g)
        self._labels = np.asarray(labels)
        return self

    def predict(self, probes: np.ndarray) -> np.ndarray:
        p = self._rows(probes)
        if self.k == 1:
            if self.mesh is not None and self.metric == "euclidean":
                _, idx = nearest_neighbor_sharded(p, self._gallery, self.mesh,
                                                  int8=self.quantized)
            elif self.quantized or self.metric == "euclidean":
                # matmul + argmin, or a 1-NN kernel where the reference's
                # routing rule picks one (int8 always, f32 past the limit)
                _, idx = nearest_neighbor_auto(p, self._gallery,
                                               int8=self.quantized)
            else:
                n = self._gallery.shape[0]
                idx, _ = nearest_neighbor(self._gallery,
                                          torch.arange(n, device=self.device),
                                          p, self.metric)
            return self._labels[idx.cpu().numpy()]
        idx, _ = top_k_neighbors(self._gallery, p, self.k, self.metric)
        votes = self._labels[idx.cpu().numpy()]   # (M, k)
        out = np.empty(len(votes), dtype=votes.dtype)
        for i, row in enumerate(votes):
            vals, counts = np.unique(row, return_counts=True)
            out[i] = vals[np.argmax(counts)]
        return out

    def score(self, probes: np.ndarray, labels: np.ndarray) -> float:
        return float(np.mean(self.predict(probes) == np.asarray(labels)))


def pca_project(train: np.ndarray, test: np.ndarray, n_components: int,
                device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """PCA fit on train, project both, via an SVD on the device (the
    reference's 1-NN+PCA pipeline, ``facerec_test.py:418-424``). Singular
    vectors are defined up to sign, so a column may come out negated
    against another implementation; distances do not change."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(train, np.float32), device=dev)
    mean = torch.mean(x, dim=0, keepdim=True)
    _, _, vt = torch.linalg.svd(x - mean, full_matrices=False)
    comps = vt[:n_components].T

    def proj(a):
        a = torch.as_tensor(np.asarray(a, np.float32), device=dev)
        with precision_scope("highest"):
            return ((a - mean) @ comps).cpu().numpy()

    return proj(train), proj(test)


def drop_singleton_classes(features: np.ndarray, labels: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Remove classes with a single sample and re-encode labels 0..C-1
    (reference ``facerec_test.py:408-414``)."""
    labels = np.asarray(labels)
    vals, counts = np.unique(labels, return_counts=True)
    keep_classes = set(vals[counts > 1].tolist())
    mask = np.array([l in keep_classes for l in labels])
    kept = labels[mask]
    remap = {v: i for i, v in enumerate(np.unique(kept))}
    return features[mask], np.array([remap[l] for l in kept])


def stratified_split_eval(features: np.ndarray, labels: np.ndarray,
                          classifier: Optional[KNNIdentifier] = None,
                          test_size: float = 0.5, seed: int = 0,
                          n_splits: int = 1, device="cuda") -> Tuple[float, float]:
    """The reference's ``classifier_tester`` protocol: StratifiedShuffleSplit
    (sklearn, same seed -> same split), accuracy mean/std."""
    from sklearn.model_selection import StratifiedShuffleSplit

    classifier = classifier or KNNIdentifier(k=1, device=device)
    sss = StratifiedShuffleSplit(n_splits=n_splits, test_size=test_size,
                                 random_state=seed)
    accs = []
    for tr, te in sss.split(features, labels):
        classifier.fit(features[tr], labels[tr])
        accs.append(classifier.score(features[te], labels[te]))
    return float(np.mean(accs)), float(np.std(accs))


def single_image_per_class_splits(labels: np.ndarray, n_splits: int = 10,
                                  seed: int = 0):
    """Gallery = 1 random image per class, probe = the rest (reference
    ``get_single_image_per_class_cv`` :177-198). Seeds and consumes the
    GLOBAL numpy RNG in one loop, as the reference does, so the shuffles
    are the reference's; every split is built before it is returned."""
    labels = np.asarray(labels)
    inds = np.arange(len(labels))
    np.random.seed(seed)
    splits = []
    for _ in range(n_splits):
        tr, te = [], []
        for lbl in np.unique(labels):
            tmp = inds[labels == lbl].copy()
            np.random.shuffle(tmp)
            tr.extend(tmp[:1])
            te.extend(tmp[1:])
        splits.append((np.asarray(tr), np.asarray(te)))
    return splits


def single_image_eval(features: np.ndarray, labels: np.ndarray,
                      n_splits: int = 10, seed: int = 0,
                      device="cuda") -> Tuple[float, float]:
    accs = []
    knn = KNNIdentifier(k=1, device=device)
    for tr, te in single_image_per_class_splits(labels, n_splits, seed):
        knn.fit(features[tr], labels[tr])
        accs.append(knn.score(features[te], labels[te]))
    return float(np.mean(accs)), float(np.std(accs))


def gallery_probe_eval(gallery_features, gallery_labels, probe_features,
                       probe_labels, k: int = 1, quantized: bool = False,
                       device="cuda") -> float:
    """Separate Gallery/Probe directory protocol (``tf_train_test_recognition``
    :220-288). ``quantized`` enrolls the gallery int8 (k=1 only)."""
    knn = KNNIdentifier(k=k, quantized=quantized, device=device).fit(
        gallery_features, gallery_labels)
    return knn.score(probe_features, probe_labels)


def gallery_probe_suite(gallery_features, gallery_labels, probe_features,
                        probe_labels, pca_components: int = 16,
                        rf_seed: Optional[int] = None, device="cuda") -> dict:
    """The reference's gallery/probe classifier comparison
    (``facerec_test.py:270-288``): 1-NN / 3-NN +- PCA(16), Random Forest
    (100 trees, depth 10), SVC, LinearSVC +- PCA(16), each fit on the RAW
    gallery features and scored on the probe set. The k-NN rows run on the
    device; the sklearn estimators on the host, as the reference's do.
    ``rf_seed`` pins the forest's RNG (the reference leaves it unseeded)."""
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.svm import SVC, LinearSVC

    Xg = np.asarray(gallery_features, np.float32)
    Xp = np.asarray(probe_features, np.float32)
    yg = np.asarray(gallery_labels)
    yp = np.asarray(probe_labels)

    results = {}
    Xg_pca, Xp_pca = pca_project(Xg, Xp, pca_components, device)
    for k in (1, 3):
        knn = KNNIdentifier(k=k, normalize=False, device=device).fit(Xg, yg)
        results[f"{k}-NN"] = knn.score(Xp, yp)
        knn_p = KNNIdentifier(k=k, normalize=False, device=device).fit(Xg_pca, yg)
        results[f"{k}-NN+PCA"] = knn_p.score(Xp_pca, yp)

    def sk_score(clf, xg, xp):
        clf.fit(xg, yg)
        return float(np.mean(clf.predict(xp) == yp))

    results["rf"] = sk_score(
        RandomForestClassifier(n_estimators=100, max_depth=10,
                               random_state=rf_seed), Xg, Xp)
    results["svm"] = sk_score(SVC(), Xg, Xp)
    results["linear svm"] = sk_score(LinearSVC(), Xg, Xp)
    results["linear svm+PCA"] = sk_score(LinearSVC(), Xg_pca, Xp_pca)
    return results
