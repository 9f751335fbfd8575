"""Distance / similarity ops for identification and clustering.

Counterpart of ``hse_facerec_tf_tpu/ops/distance.py``: the gallery x probe
distance matrix is one matmul and 1-NN is matmul + argmin. The JAX package
runs these outside any Pallas kernel, so they stay plain PyTorch here; the
matrix-free 1-NN kernels are in ``ops/kernels/knn.py``.

Ties: ``torch.argmin`` returns the first occurrence, as ``jnp.argmin``
does; ``top_k_neighbors`` goes through ``numerics.top_k`` (a stable sort),
because ``lax.top_k`` breaks ties by the lowest index. The matmul forms
take the reference's ``precision`` tier (``numerics``), "highest" by
default, as there.
"""

from __future__ import annotations

import torch

from ..numerics import precision_scope, top_k


def l2_normalize(x, axis: int = -1, eps: float = 1e-10):
    """Row-normalize feature vectors along ``axis`` (reference
    ``facerec_test.py:401-405``, sklearn ``preprocessing.normalize``
    semantics)."""
    n = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp(n, min=eps)


def pairwise_sqeuclidean(a, b, precision="highest"):
    """(N, D) x (M, D) -> (N, M) squared-L2 distances via one matmul."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    with precision_scope(precision):
        ab = a @ b.T
    return torch.clamp(a2 + b2.T - 2.0 * ab, min=0.0)


def pairwise_euclidean(a, b, precision="highest"):
    return torch.sqrt(pairwise_sqeuclidean(a, b, precision=precision))


def pairwise_cosine(a, b, precision="highest"):
    """Cosine *distance* (1 - similarity)."""
    with precision_scope(precision):
        sim = l2_normalize(a) @ l2_normalize(b).T
    return 1.0 - sim


def chi2_dist(x, y):
    """chi^2 distance sum (x-y)^2/(x+y) over histograms; 0 where x+y == 0
    (reference ``facerec_test.py:157-160``). Broadcasts over leading dims."""
    s = x + y
    num = (x - y) ** 2
    return torch.sum(torch.where(s > 0, num / torch.where(s > 0, s, 1.0), 0.0),
                     dim=-1)


def pairwise_chi2(a, b):
    return chi2_dist(a[:, None, :], b[None, :, :])


def kl_dist(x, y, eps: float = 0.001):
    """Smoothed KL divergence sum (x+eps) log((x+eps)/(y+eps)) (reference
    ``facerec_test.py:162-164``)."""
    xs = x + eps
    ys = y + eps
    return torch.sum(xs * torch.log(xs / ys), dim=-1)


def pairwise_kl(a, b):
    return kl_dist(a[:, None, :], b[None, :, :])


def emd_1d(x, y):
    """Earth-mover's distance with the reference's unit ground metric
    (cost 1 - I, ``facerec_test.py:166-175``): half the L1 distance."""
    return 0.5 * torch.sum(torch.abs(x - y), dim=-1)


def pairwise_emd_unit(a, b):
    return emd_1d(a[:, None, :], b[None, :, :])


_PAIRWISE = {"euclidean": pairwise_sqeuclidean, "cosine": pairwise_cosine,
             "chi2": pairwise_chi2, "kl": pairwise_kl}


def _pairwise(metric: str, a, b, precision):
    if metric in ("euclidean", "cosine"):
        return _PAIRWISE[metric](a, b, precision=precision)
    return _PAIRWISE[metric](a, b)


def nearest_neighbor(gallery, gallery_labels, probes, metric: str = "euclidean",
                     precision="highest"):
    """1-NN classification: distance matrix + argmin + gather. Returns
    (predicted labels (M,), nn distances (M,)); euclidean distances are
    plain L2 (reference ``facerec_test.py:269-281,416-432``)."""
    if metric not in _PAIRWISE:
        raise ValueError(metric)
    d = _pairwise(metric, probes, gallery, precision)
    idx = torch.argmin(d, dim=-1)
    dmin = torch.gather(d, -1, idx[:, None])[:, 0]
    if metric == "euclidean":
        dmin = torch.sqrt(dmin)
    return gallery_labels[idx], dmin


def top_k_neighbors(gallery, probes, k: int, metric: str = "euclidean",
                    precision="highest"):
    """k nearest gallery indices + distances per probe (ascending)."""
    if metric not in ("euclidean", "cosine"):
        raise ValueError(metric)
    d = _pairwise(metric, probes, gallery, precision)
    neg_d, idx = top_k(-d, k)
    d_k = -neg_d
    if metric == "euclidean":
        d_k = torch.sqrt(torch.clamp(d_k, min=0.0))
    return idx, d_k
