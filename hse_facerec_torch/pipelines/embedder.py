"""Batched face-embedding extraction.

Counterpart of ``hse_facerec_tf_tpu/pipelines/embedder.py``: a uint8 batch
goes to the device, is resized (matmuls), normalized and run through the
backbone, in batches instead of the reference's one ``sess.run`` per image
(``facerec_test.py:114-122``). With a ``mesh`` the params are replicated on
its devices and each batch is split over them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.preprocess import NORMALIZERS
from ..ops.resize import resize, resize_host
from ..params import to_torch
from ..parallel.sharding import gather, pad_batch, split_batch
from .detector import resolve_device


class EmbeddingExtractor:
    """Turns a backbone into a batched feature extractor on one device or
    over a mesh.

    Args:
      model_fn: ``f(params, images_f32_nhwc) -> (N, D)`` on torch tensors.
      params: the model's parameters in the reference's numpy layouts;
        moved to ``device`` once (``params.to_torch``; a quantized
        pytree takes the int8 layouts).
      input_size: (H, W) the model expects.
      normalization: key into ``ops.preprocess.NORMALIZERS``.
      resize_method: 'cv2_linear' | 'cv2_area' | 'pil_bilinear' | ...
      batch_size: device batch.
      flip_tta: sum the features of the image and its horizontal mirror;
      l2_normalize_output: normalize rows (the reference's InsightFace
        extractor, ``insightface_face_embedding.py:47-62``).
      host_resize: 'never' resizes on the device; 'always' resizes every
        non-native size on the host (same weight matrices,
        ``ops.resize.resize_host``). The reference's 'auto' bounds its
        compiled programs; eager PyTorch compiles none, so it is not here.
      convert: ``f(params, device)`` -> the tensors ``model_fn`` takes
        (default ``params.to_torch``, for pytrees of layer dicts).
      mesh: a ``parallel.sharding.Mesh``: ``convert`` places one copy of
        the params per distinct device, every forward splits its rows over
        all the mesh's shards (padded by repeating the last row), and the
        features come back in input order. The mesh's first device
        replaces ``device``.
      compute_dtype: stored as ``self.compute_dtype``, as the reference
        stores it; the forward's own dtype and tier are ``model_fn``'s
        (``zoo.build_extractor(precision=...)``). The device resize runs
        at "highest", as there.
    """

    def __init__(self, model_fn: Callable, params, input_size: Tuple[int, int],
                 normalization: str = "caffe", resize_method: str = "pil_bilinear",
                 batch_size: int = 64, device="cuda", flip_tta: bool = False,
                 l2_normalize_output: bool = False, host_resize: str = "never",
                 convert: Callable = to_torch, mesh=None,
                 compute_dtype=torch.float32):
        if host_resize not in ("always", "never"):
            raise ValueError(f"host_resize must be always|never, "
                             f"got {host_resize!r}")
        self.model_fn = model_fn
        self.compute_dtype = compute_dtype
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self.params = convert(params, self.device)
        else:
            self.device = mesh.devices.flat[0]
            self._replicas = mesh.replicate(params, convert)
            self.params = self._replicas[self.device]
        self.input_size = tuple(input_size)
        self.normalization = normalization
        self.resize_method = resize_method
        self.batch_size = batch_size
        self.flip_tta = flip_tta
        self.l2_normalize_output = l2_normalize_output
        self.host_resize = host_resize

    def _maybe_host_resize(self, batch: np.ndarray) -> np.ndarray:
        """Resize on the host when ``host_resize='always'``."""
        if (self.host_resize == "always"
                and (batch.shape[1], batch.shape[2]) != self.input_size):
            return resize_host(batch, self.input_size, self.resize_method)
        return batch

    @torch.no_grad()
    def _forward(self, images: np.ndarray) -> torch.Tensor:
        if self.mesh is None:
            return self._forward_on(self.params, torch.from_numpy(
                np.ascontiguousarray(images)).to(self.device))
        # each shard's rows on its device, the features gathered in order
        shards = self.mesh.shard_devices()
        padded, n = pad_batch(np.asarray(images), len(shards))
        feats = [self._forward_on(self._replicas[d], x)
                 for d, x in zip(shards, split_batch(padded, shards))]
        return gather(feats, self.device)[:n]

    def _forward_on(self, params, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if (x.shape[1], x.shape[2]) != self.input_size:
            x = resize(x, self.input_size, self.resize_method)
        x = NORMALIZERS[self.normalization](x)
        feats = self.model_fn(params, x)
        if self.flip_tta:
            feats = feats + self.model_fn(params, torch.flip(x, dims=(2,)))
        if self.l2_normalize_output:
            feats = feats / torch.clamp(
                torch.linalg.vector_norm(feats, dim=-1, keepdim=True), min=1e-12)
        return feats

    def extract_batch(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8/float RGB (uniform size) -> (N, D) float32.

        A tail chunk pads to the next power of two (floor 8, at most
        ``batch_size``), so a run sees a handful of batch shapes, as in the
        reference; each chunk is queued on the device before any result is
        copied back. Under a mesh the tail bucket holds at least one row a
        shard."""
        images = self._maybe_host_resize(np.asarray(images))
        outs, takes = [], []
        for i in range(0, len(images), self.batch_size):
            chunk = images[i:i + self.batch_size]
            take = len(chunk)
            if take < self.batch_size:
                bucket = max(8, 1 << max(0, (take - 1).bit_length()))
                if self.mesh is not None:
                    bucket = max(bucket, self.mesh.size)
                chunk = pad_batch(chunk, min(bucket, self.batch_size))[0]
            outs.append(self._forward(chunk))
            takes.append(take)
        return np.concatenate([o[:t].cpu().numpy() for o, t in zip(outs, takes)])

    def extract_files(self, paths: Sequence[str], loader=None,
                      decode_workers: int = 4) -> np.ndarray:
        """Streamed file extraction, order preserved: threaded decode
        (``utils/prefetch.bounded_thread_map``) feeds per-source-size
        buckets; a full bucket is queued on the device at once, so decoding
        the next batch overlaps the device's work on this one.
        ``decode_workers=0`` decodes inline. ``loader`` maps a path to an
        RGB array (default: decode the image file)."""
        from ..utils.image_io import imread_rgb
        from ..utils.prefetch import bounded_thread_map

        loader = loader or imread_rgb
        feats: List[Optional[np.ndarray]] = [None] * len(paths)
        buckets: Dict[Tuple[int, int], List[Tuple[int, np.ndarray]]] = {}
        in_flight: List[Tuple[List[int], torch.Tensor]] = []

        def dispatch(bucket):
            idxs = [i for i, _ in bucket]
            batch = self._maybe_host_resize(np.stack([im for _, im in bucket]))
            padded = pad_batch(batch, self.batch_size)[0]
            for s in range(0, len(padded), self.batch_size):
                in_flight.append((idxs[s:s + self.batch_size],
                                  self._forward(padded[s:s + self.batch_size])))

        def drain():
            for idxs, dev in in_flight:
                emb = dev[:len(idxs)].cpu().numpy()
                for j, i in enumerate(idxs):
                    feats[i] = emb[j]
            in_flight.clear()

        for i, img in enumerate(bounded_thread_map(loader, paths,
                                                   workers=decode_workers,
                                                   depth=2 * self.batch_size)):
            bucket = buckets.setdefault(img.shape[:2], [])
            bucket.append((i, img))
            if len(bucket) == self.batch_size:
                dispatch(bucket)
                buckets[img.shape[:2]] = []
            if len(in_flight) >= 2:   # bound device-side queueing + host copies
                drain()
        for bucket in buckets.values():
            if bucket:
                dispatch(bucket)
        drain()
        return np.stack(feats)
