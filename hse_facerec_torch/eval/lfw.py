"""LFW / LFW∩YTF / gallery-probe identification benchmarks.

Counterpart of ``hse_facerec_tf_tpu/eval/lfw.py`` (the reference's
``facerec_test.py __main__`` protocol, :290-442): directory-per-identity
dataset -> batched feature extraction (cached to .npz) -> L2 normalize ->
singleton-class removal -> 1-NN (and friends) under seeded splits.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..pipelines import identification as ident
from ..pipelines.embedder import EmbeddingExtractor
from ..utils.image_io import get_files


def load_class_filter(classes_file: str) -> set:
    """LFW∩YTF class list (reference :379-380, ``lfw_ytf_classes.txt``):
    one class name a line, blank lines skipped."""
    with open(classes_file) as f:
        return {line.strip() for line in f if line.strip()}


def extract_dataset_features(dataset_dir: str, extractor: EmbeddingExtractor,
                             cache_file: Optional[str] = None,
                             class_filter: Optional[set] = None,
                             class_to_label: Optional[Dict[str, int]] = None
                             ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Features + integer labels + class names for a directory-per-class set,
    cached like the reference does (:296-308,399). ``class_to_label`` shares
    a label encoding across datasets (a probe tree must use the gallery's
    ids, :232-238)."""
    if cache_file and os.path.exists(cache_file):
        d = np.load(cache_file, allow_pickle=True)
        return d["x"], d["y"], list(d["class_names"])

    pairs = get_files(dataset_dir)
    if class_filter is not None:
        pairs = [(d, f) for d, f in pairs if d in class_filter]
    dirs = [d for d, _ in pairs]
    class_names = sorted(set(dirs))
    if class_to_label is None:
        name_to_id = {n: i for i, n in enumerate(class_names)}
    else:
        name_to_id = class_to_label
        unknown = set(dirs) - set(name_to_id)
        if unknown:
            raise ValueError(
                f"classes not in the shared label encoding: {sorted(unknown)[:5]}")
    labels = np.array([name_to_id[d] for d in dirs])
    paths = [os.path.join(dataset_dir, f) for _, f in pairs]
    feats = extractor.extract_files(paths)
    if cache_file:
        np.savez(cache_file, x=feats, y=labels, class_names=class_names)
    return feats, labels, class_names


def identification_benchmark(features: np.ndarray, labels: np.ndarray,
                             protocol: str = "split50",
                             device="cuda") -> Dict[str, float]:
    """protocol: 'split50' (LFW >1-photo rows) or 'single' (LFW∩YTF rows)."""
    feats, labs = ident.drop_singleton_classes(features, labels)
    if protocol == "split50":
        mean, std = ident.stratified_split_eval(feats, labs, device=device)
    elif protocol == "single":
        mean, std = ident.single_image_eval(feats, labs, device=device)
    else:
        raise ValueError(protocol)
    return {"accuracy": mean, "std": std,
            "n_images": int(len(labs)), "n_classes": int(len(np.unique(labs)))}


def classifier_suite(features: np.ndarray, labels: np.ndarray,
                     pca_components: int = 128, device="cuda") -> Dict[str, float]:
    """The reference's LFW-path classifier comparison (:416-432): 1-NN / 3-NN
    with and without PCA (128 components), on L2-normalized features under
    the seeded 50 % split."""
    from sklearn.model_selection import StratifiedShuffleSplit

    feats, labs = ident.drop_singleton_classes(features, labels)
    feats = np.asarray(feats, np.float32)
    feats = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
    sss = StratifiedShuffleSplit(n_splits=1, test_size=0.5, random_state=0)
    (tr, te), = sss.split(feats, labs)
    results: Dict[str, float] = {}
    tr_p, te_p = ident.pca_project(feats[tr], feats[te], pca_components, device)
    for k in (1, 3):
        knn = ident.KNNIdentifier(k=k, normalize=False, device=device).fit(
            feats[tr], labs[tr])
        results[f"{k}nn"] = knn.score(feats[te], labs[te])
        knn_p = ident.KNNIdentifier(k=k, normalize=False, device=device).fit(
            tr_p, labs[tr])
        results[f"{k}nn_pca{pca_components}"] = knn_p.score(te_p, labs[te])
    return results
