"""Persistent face-enrollment gallery for serving.

Counterpart of ``hse_facerec_tf_tpu/pipelines/gallery.py``. The store
keeps the f32 gallery on the host and an int8 ranking state on the device
(one global scale, the rows padded and their norms computed by
``pack_quantized_gallery``), rebuilt lazily after enrollments, and answers
1-NN queries through ``nearest_neighbor_int8p``: the int8 kernel K2c on
CUDA, its twin on the CPU, with exact squared L2 between the dequantized
vectors (the reference's ``nearest_neighbor_auto(int8=True)`` answers).
With a ``mesh`` the ranking state is split over the mesh's devices
instead (``parallel/knn.py``: K2b per shard for int8).

Thread-safe. Persistence is one ``.npz`` written atomically (tmp +
``os.replace``) after every change; the file is the reference's format, so
either package loads what the other wrote, with the ``ranking`` preference.

Decision rule: a probe matches its nearest enrollment iff the plain L2
distance between the normalized vectors is below the threshold, in the
units of the album pipeline's ``DistanceThreshold=0.82``
(``process_photos.py:26``).
"""

from __future__ import annotations

import os
import threading
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.knn import (nearest_neighbor_auto, nearest_neighbor_int8p,
                               pack_quantized_gallery)
from ..parallel.knn import nearest_neighbor_sharded, place_gallery
from .detector import resolve_device


def _l2_normalize_host(x: np.ndarray) -> np.ndarray:
    """Host L2 normalization (sklearn semantics), as the reference's
    ``pipelines/gallery.py::_l2_normalize_host``: probes and enrollments
    are a handful of rows."""
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-10)


def _quantize_host(x: np.ndarray):
    """Host int8 quantization with one global symmetric scale, in f32
    arithmetic with round-half-even, as the reference's
    ``pipelines/gallery.py::_quantize_host``: a gallery ``.npz`` written by
    either package loads in the other."""
    x = np.asarray(x, np.float32)
    scale = np.maximum(np.max(np.abs(x)) / np.float32(127.0),
                       np.float32(1e-30))        # f32 arithmetic throughout
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, np.float32(scale)


class EnrollmentGallery:
    """Labeled-embedding store with a lazy int8 ranking state on ``device``.

    ``path``: optional ``.npz`` file, loaded at construction if present and
    rewritten atomically after each ``enroll``/``remove``.
    ``quantized``: rank through the int8 path (default); ``False`` ranks in
    exact f32. The preference persists in the file; an explicit bool
    overrides the stored one, ``None`` follows the file.
    ``mesh`` (``parallel.sharding.Mesh``): the ranking state is padded to
    the ``mesh_axis`` size and placed as one slice per shard once per
    gallery version (int8: quantized on the host, ranked on K2b per shard
    with its valid rows; f32: ``1e4`` pad rows), so the gallery's capacity
    grows with the devices; probes go to the mesh's first device, which
    replaces ``device``. ``placements`` counts the placements."""

    def __init__(self, path: Optional[str] = None,
                 quantized: Optional[bool] = None, device="cuda",
                 mesh=None, mesh_axis: str = "data"):
        self.path = path
        self.quantized = True if quantized is None else quantized
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.placements = 0
        self.device = (mesh.devices.flat[0] if mesh is not None
                       else resolve_device(device))
        self._lock = threading.RLock()
        self._labels: List[str] = []
        self._feats: List[np.ndarray] = []
        self._rank_state = None            # (rank_fn, dim, labels snapshot)
        if path and os.path.exists(path):
            data = np.load(path, allow_pickle=False)
            feats = np.asarray(data["features"], np.float32)
            labels = [str(s) for s in data["labels"]]
            if len(labels) != len(feats):
                raise ValueError(f"corrupt gallery file {path}: "
                                 f"{len(labels)} labels vs {len(feats)} rows")
            self._feats = list(feats)
            self._labels = labels
            if quantized is None and "ranking" in data:
                self.quantized = str(data["ranking"]) == "int8"

    def __len__(self) -> int:
        with self._lock:
            return len(self._labels)

    def stats(self) -> dict:
        with self._lock:
            return {
                "n_enrolled": len(self._labels),
                "n_labels": len(set(self._labels)),
                "dim": int(self._feats[0].shape[0]) if self._feats else None,
                "quantized": self.quantized,
                "path": self.path,
            }

    def enroll(self, label: str, embedding: np.ndarray) -> int:
        """Add one embedding under ``label`` (L2-normalized here); returns
        the new gallery size. Several enrollments per label are allowed."""
        return self.enroll_many(
            [label], np.asarray(embedding, np.float32).reshape(1, -1))

    def enroll_many(self, labels: List[str], embeddings: np.ndarray,
                    replace_labels: Iterable[str] = ()) -> int:
        """Bulk ``enroll`` under one lock with one save. ``replace_labels``:
        existing enrollments dropped in the SAME atomic update. Everything
        is validated before anything changes. Returns the new size."""
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim != 2 or len(labels) != len(embeddings):
            raise ValueError(f"expected (N, D) embeddings matching "
                             f"{len(labels)} labels, got {embeddings.shape}")
        if any(not l for l in labels):
            raise ValueError("labels must be non-empty")
        embs = (_l2_normalize_host(embeddings) if len(embeddings)
                else embeddings)
        drop = {str(l) for l in replace_labels}
        with self._lock:
            keep = [i for i, l in enumerate(self._labels) if l not in drop]
            if len(embs) and keep and embs.shape[1] != self._feats[keep[0]].shape[0]:
                raise ValueError(
                    f"embedding dim {embs.shape[1]} != gallery dim "
                    f"{self._feats[keep[0]].shape[0]} (different --model?)")
            if not len(embs) and len(keep) == len(self._labels):
                return len(self._labels)      # nothing to add or drop
            if len(keep) != len(self._labels):
                self._feats = [self._feats[i] for i in keep]
                self._labels = [self._labels[i] for i in keep]
            self._feats.extend(embs)
            self._labels.extend(str(l) for l in labels)
            self._rank_state = None
            self._save_locked()
            return len(self._labels)

    def remove(self, label: str) -> int:
        """Drop every embedding enrolled under ``label``; returns how many
        were removed."""
        with self._lock:
            keep = [i for i, l in enumerate(self._labels) if l != label]
            removed = len(self._labels) - len(keep)
            if removed:
                self._feats = [self._feats[i] for i in keep]
                self._labels = [self._labels[i] for i in keep]
                self._rank_state = None
                self._save_locked()
            return removed

    def identify(self, embedding: np.ndarray, threshold: float = 0.82,
                 ) -> Tuple[Optional[str], Optional[float], Optional[str]]:
        """1-NN over the gallery: ``(label_or_None, l2_distance,
        nearest_label)``; ``label`` is None when the gallery is empty or the
        nearest enrollment is farther than ``threshold``."""
        return self.identify_many(
            np.asarray(embedding, np.float32).reshape(1, -1), threshold)[0]

    def identify_many(self, embeddings: np.ndarray, threshold: float = 0.82,
                      ) -> List[Tuple[Optional[str], Optional[float],
                                      Optional[str]]]:
        """Batched ``identify``: one device call and one copy back for all
        probes (per-face labelling of a multi-face photo)."""
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim != 2:
            raise ValueError(f"expected (N, D) probes, got "
                             f"{embeddings.shape}")
        rank_fn, dim, labels = self._ranking_state()
        if rank_fn is None:
            return [(None, None, None)] * len(embeddings)
        if embeddings.shape[1] != dim:
            raise ValueError(f"probe dim {embeddings.shape[1]} != gallery "
                             f"dim {dim} (gallery enrolled in a different "
                             f"mode or with a different --model?)")
        if not len(embeddings):
            return []
        probes = torch.from_numpy(_l2_normalize_host(embeddings)).to(self.device)
        dsq, idx = (t.cpu().numpy() for t in rank_fn(probes))
        out = []
        for d, i in zip(dsq, idx):
            dist = float(np.sqrt(max(float(d), 0.0)))
            nearest = labels[int(i)]
            out.append(((nearest if dist <= threshold else None), dist,
                        nearest))
        return out

    # -- internals --------------------------------------------------------

    def _ranking_state(self):
        """``(rank_fn, dim, labels snapshot)``, rebuilt only after changes:
        quantized (on the host, the reference's numpy mirror) and uploaded
        once per gallery version, not per query."""
        with self._lock:
            if not self._feats:
                return None, None, None
            if self._rank_state is None:
                g = np.stack(self._feats)
                if self.mesh is not None:
                    rank_fn = self._mesh_rank_fn(g)
                elif self.quantized:
                    packed = pack_quantized_gallery(
                        *(torch.as_tensor(a, device=self.device)
                          for a in _quantize_host(g)))
                    rank_fn = lambda probes: nearest_neighbor_int8p(probes, *packed)
                else:
                    gallery = torch.from_numpy(g).to(self.device)
                    rank_fn = lambda probes: nearest_neighbor_auto(probes, gallery)
                self._rank_state = (rank_fn, g.shape[1], list(self._labels))
            return self._rank_state

    def _mesh_rank_fn(self, g: np.ndarray):
        """The gallery padded to the mesh axis and placed as shards, once;
        each query runs the per-shard sweep and the cross-shard argmin."""
        n, dim = g.shape
        pad = (-n) % self.mesh.shape[self.mesh_axis]
        if self.quantized:
            # on the host: the reference's numpy mirror, an exact division
            q, scale = _quantize_host(g)
            q = np.concatenate([q, np.zeros((pad, dim), np.int8)])
            placed = place_gallery((torch.from_numpy(q), torch.tensor(scale)),
                                   self.mesh, self.mesh_axis, int8=True, n_valid=n)
        else:
            placed = place_gallery(torch.from_numpy(g), self.mesh, self.mesh_axis)
        self.placements += 1
        return lambda probes: nearest_neighbor_sharded(probes, placed, self.mesh,
                                                       self.mesh_axis)

    def _save_locked(self):
        if not self.path:
            return
        tmp = self.path + ".tmp"
        feats = (np.stack(self._feats) if self._feats
                 else np.zeros((0, 0), np.float32))
        with open(tmp, "wb") as f:   # file handle: savez can't munge the name
            np.savez(f, features=feats,
                     labels=np.asarray(self._labels, dtype=np.str_),
                     ranking=np.str_("int8" if self.quantized else "f32"))
        os.replace(tmp, self.path)
