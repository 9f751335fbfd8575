"""The clustering layer of the PyTorch port against the JAX package.

``get_facial_clusters`` with every method (scipy HAC with and without the
same-photo constraint, the native rank-order core, its Python core and
DBSCAN), ``clusters_to_labels``, the B-Cubed and sklearn metrics, both
threshold searches and the Dempster-Shafer gender fusion, each fed the same
numpy inputs on both sides. Both sides run the same host algorithms in
float64 on identical matrices, so clusters, labels and decisions must be
identical and the metrics equal; the port's native rank-order core must
equal its Python core.
"""

import numpy as np
import pytest

from hse_facerec_tf_tpu.eval import clustering_metrics as jcm
from hse_facerec_tf_tpu.eval import threshold_search as jts
from hse_facerec_tf_tpu.pipelines import clustering as jcl
from hse_facerec_tf_tpu.pipelines import fusion as jfu
from hse_facerec_torch.eval import clustering_metrics as tcm
from hse_facerec_torch.eval import threshold_search as tts
from hse_facerec_torch.native import rankorder as tro
from hse_facerec_torch.pipelines import clustering as tcl
from hse_facerec_torch.pipelines import fusion as tfu

METHODS = ["scipy", "rankorder", "rankorder_py", "dbscan"]


def _blobs(seed, n_classes, per_class, dim, spread, scale):
    """Unit-normalized features around ``n_classes`` centres, their float64
    L2 distance matrix, labels and photo indices (two faces a photo)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_classes, dim) * scale
    feats = np.concatenate([c + spread * rng.randn(per_class, dim) for c in centers])
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    dist = np.sqrt(np.maximum(((feats[:, None] - feats[None]) ** 2).sum(-1), 0.0))
    np.fill_diagonal(dist, 0.0)
    labels = np.repeat(np.arange(n_classes), per_class)
    photos = rng.permutation(len(labels)) // 2
    return dist, labels, photos


# "separable": tight blobs; "mixed": blobs that overlap at the thresholds
DATASETS = {"separable": _blobs(3, 5, 8, 16, 0.05, 3.0),
            "mixed": _blobs(4, 6, 7, 32, 0.9, 1.0)}


@pytest.mark.parametrize("name", sorted(DATASETS))
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("with_photos", [False, True])
def test_get_facial_clusters_matches_jax(name, method, with_photos):
    dist, labels, photos = DATASETS[name]
    idx = photos if with_photos else None
    thr = (0.9, 14.0) if method.startswith("rankorder") else 0.8
    want = jcl.get_facial_clusters(dist, thr, idx, 2, method=method)
    got = tcl.get_facial_clusters(dist, thr, idx, 2, method=method)
    assert got == want
    n = len(labels)
    np.testing.assert_array_equal(tcl.clusters_to_labels(got, n),
                                  jcl.clusters_to_labels(want, n))
    if method == "scipy" and with_photos:
        for c in got:        # the same-photo constraint holds
            assert len(set(photos[c])) == len(c)


@pytest.mark.parametrize("name", sorted(DATASETS))
@pytest.mark.parametrize("threshold", [(0.9, 14.0), (1.05, 12.0), (1.1, 20.0)])
def test_native_rankorder_equals_python_core(name, threshold):
    dist = DATASETS[name][0]
    assert tro.available()
    assert tro.library_path().parent.parent.name == "_build"
    native = tro.rank_order_cluster_native(dist, norm_threshold=threshold[0],
                                           t=threshold[1])
    py = tcl._rank_order_clusters(dist, norm_threshold=threshold[0], t=threshold[1])
    assert sorted(map(sorted, native)) == sorted(map(sorted, py))


def test_rankorder_falls_back_to_python_without_a_compiler(monkeypatch):
    dist = DATASETS["mixed"][0]
    want = tcl.get_facial_clusters(dist, (0.9, 14.0), method="rankorder_py")
    monkeypatch.setattr(tro, "_load", lambda: None)
    assert not tro.available()
    assert tcl.get_facial_clusters(dist, (0.9, 14.0), method="rankorder") == want
    with pytest.raises(RuntimeError, match="unavailable"):
        tro.rank_order_cluster_native(dist)


def test_rankorder_native_rejects_a_non_square_matrix():
    with pytest.raises(ValueError, match="square"):
        tro.rank_order_cluster_native(np.zeros((3, 4)))


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_metrics_match_jax(name):
    dist, labels, _ = DATASETS[name]
    y_pred = tcl.clusters_to_labels(tcl.get_facial_clusters(dist, 0.8), len(labels))
    assert tcm.bcubed(labels, y_pred) == jcm.bcubed(labels, y_pred)
    assert tcm.clustering_statistics(labels, y_pred) == \
        jcm.clustering_statistics(labels, y_pred)
    for stat in ("bcubed_precision", "bcubed_f", "v_measure"):
        assert tts.clustering_score(dist, labels, 0.8, "scipy", stat) == \
            jts.clustering_score(dist, labels, 0.8, "scipy", stat)
    with pytest.raises(ValueError):
        tts.clustering_score(dist, labels, 0.8, "scipy", "nope")


@pytest.mark.parametrize("method", ["scipy", "dbscan"])
def test_search_distance_threshold_matches_jax(method):
    val = [DATASETS[n][:2] for n in sorted(DATASETS)]
    thresholds = np.linspace(0.3, 1.3, 11)
    got = tts.search_distance_threshold(val, method=method, thresholds=thresholds)
    want = jts.search_distance_threshold(val, method=method, thresholds=thresholds)
    assert got == want and len(got["trace"]) > 1


def test_search_rankorder_thresholds_matches_jax():
    val = [DATASETS[n][:2] for n in sorted(DATASETS)]
    grid = np.linspace(0.8, 1.1, 4)
    got = tts.search_rankorder_thresholds(val, distance_thresholds=grid)
    want = jts.search_rankorder_thresholds(val, distance_thresholds=grid)
    assert got == want and len(got["trace"]) > 1


def test_dempster_shafer_gender_matches_jax():
    rng = np.random.RandomState(11)
    decisions = []
    for n in (1, 2, 3, 5, 9, 20):
        for _ in range(8):
            probs = rng.beta(0.7, 0.7, n)
            got = tfu.dempster_shafer_gender(probs)
            assert got == jfu.dempster_shafer_gender(probs)
            decisions.append(got)
    assert set(decisions) == {0, 1}
    prox = tfu._proximities(np.array([0.3, 0.7]))
    np.testing.assert_array_equal(prox, jfu._proximities(np.array([0.3, 0.7])))
    np.testing.assert_array_equal(tfu._log_beliefs(prox), jfu._log_beliefs(prox))
