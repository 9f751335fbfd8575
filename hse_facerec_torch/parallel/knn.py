"""Gallery-sharded 1-NN over a device mesh.

Counterpart of ``hse_facerec_tf_tpu/parallel/knn.py``. The gallery is split
over the mesh's ``data`` axis (the axis that grows with the enrolled
identities) and the probes are replicated. Each shard sweeps its slice with
the single-device 1-NN (K2b for int8, the routed f32 path otherwise:
matmul + argmin, or K2a where ``use_kernel_path`` picks it), adds its row
offset and masks rows past the gallery to +inf. The (shards, M) minima and
indices are gathered on the first shard's device and the argmin over shards
picks the answer: ties go to the lowest shard, hence to the lowest global
index, as in the single-device sweep.

``place_gallery`` does the padding, the int8 quantization and the
placement once; a long-lived caller (``EnrollmentGallery``) keeps its
result and passes it to ``nearest_neighbor_sharded`` per query.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..ops.kernels.knn import (nearest_neighbor_auto, nearest_neighbor_int8q,
                               quantize_embeddings)
from .sharding import Mesh

# f32 pad rows must lose every shard's argmin (a zero row would win for
# small-norm probes): 1e4-magnitude rows give ~1e8 squared distances, far
# above any embedding pair, and stay exact in f32
F32_PAD = 1e4


class ShardedGallery(NamedTuple):
    """A gallery laid out over a mesh axis: ``shards[s]`` (rows
    ``s·shard .. (s+1)·shard`` of the padded gallery) on ``devices[s]``;
    ``n`` real rows; int8 galleries carry the global ``scales`` (one copy
    per shard)."""
    shards: List[torch.Tensor]
    devices: List[torch.device]
    n: int
    shard: int
    scales: Optional[List[torch.Tensor]]


def place_gallery(gallery, mesh: Mesh, axis: str = "data", int8: bool = False,
                  n_valid: Optional[int] = None) -> ShardedGallery:
    """Pad ``gallery`` to the ``axis`` size and place one slice per shard.

    f32: pad rows are ``F32_PAD``-filled. ``int8``: an f32 gallery is
    quantized once with one global scale (every shard ranks in the same
    scaled domain) and zero-padded; a ``(q int8, scale)`` pair must already
    be padded to the axis, with ``n_valid`` its real rows. int8 pad rows are
    masked by each shard's ``valid_n``, not by value."""
    devices = mesh.shard_devices(axis)
    n_dev = len(devices)
    scale = None
    if isinstance(gallery, tuple):
        if not int8:
            raise ValueError("a (q, scale) gallery requires int8=True")
        gallery, scale = gallery
        if gallery.shape[0] % n_dev:
            raise ValueError(f"pre-quantized gallery rows {gallery.shape[0]} not "
                             f"a multiple of the {n_dev}-device {axis!r} axis")
        n = gallery.shape[0] if n_valid is None else int(n_valid)
    else:
        if n_valid is not None:
            raise ValueError("n_valid requires a pre-quantized (q, scale) gallery")
        n = gallery.shape[0]
        pad = -(-n // n_dev) * n_dev - n
        if int8:
            gallery, scale = quantize_embeddings(gallery)
            fill = 0
        else:
            gallery = gallery.to(torch.float32)
            fill = F32_PAD
        if pad:
            gallery = torch.cat([gallery, torch.full((pad, gallery.shape[1]), fill,
                                                     dtype=gallery.dtype,
                                                     device=gallery.device)])
    shard = gallery.shape[0] // n_dev
    # each slice its own buffer, also where two shards share a device
    shards = [gallery[s * shard:(s + 1) * shard].to(d, copy=True)
              for s, d in enumerate(devices)]
    scales = (None if scale is None else
              [torch.as_tensor(scale, dtype=torch.float32).to(d, copy=True)
               for d in devices])
    return ShardedGallery(shards, devices, int(n), shard, scales)


def nearest_neighbor_sharded(probes, gallery, mesh: Mesh, axis: str = "data",
                             force_kernel: bool = False, int8: bool = False,
                             n_valid: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, D) probes x (N, D) gallery -> (min squared L2 (M,), argmin (M,))
    on the first shard's device; global indices refer to the unpadded
    gallery. ``gallery``: f32 rows, a ``(q, scale)`` pair (``int8``, padded
    to the axis, ``n_valid`` real rows) or a ``place_gallery`` result.
    ``force_kernel``: K2a for the f32 shards wherever CUDA is."""
    if not isinstance(gallery, ShardedGallery):
        gallery = place_gallery(gallery, mesh, axis, int8, n_valid)
    elif n_valid is not None:
        raise ValueError("a placed gallery carries its own row count")
    n, shard = gallery.n, gallery.shard
    mins, idxs = [], []
    for s, dev in enumerate(gallery.devices):
        p = probes.to(dev)
        offset = s * shard
        if gallery.scales is not None:
            valid = min(max(n - offset, 0), shard)
            dmin, idx = nearest_neighbor_int8q(p, gallery.shards[s], gallery.scales[s],
                                               valid_n=valid)
        else:
            dmin, idx = nearest_neighbor_auto(p, gallery.shards[s],
                                              force_kernel=force_kernel)
        gidx = idx + offset
        mins.append(torch.where(gidx < n, dmin, torch.full_like(dmin, float("inf"))))
        idxs.append(gidx)
    home = gallery.devices[0]
    all_min = torch.stack([m.to(home) for m in mins])         # (shards, M)
    all_idx = torch.stack([i.to(home) for i in idxs])
    best = torch.argmin(all_min, dim=0)[None, :]               # ties: lowest shard
    return (torch.gather(all_min, 0, best)[0], torch.gather(all_idx, 0, best)[0])
