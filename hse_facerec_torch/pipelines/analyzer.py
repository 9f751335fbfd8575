"""FacialAnalyzer: detect → crop → age/gender/identity.

Counterpart of ``hse_facerec_tf_tpu/pipelines/analyzer.py`` (``analyze``
and ``analyze_with_rotations``). Per-face semantics follow the reference's
``process_image`` (``facial_analysis.py:233-294``): boxes dilated by 10 px,
clipped to the image, cropped to 224² bilinear (border-replicate), BGR +
ImageNet means; age = 1 + expectation over the renormalized top-2 age bins;
gender probability thresholded at 0.6.

Under a ``mesh`` (``parallel.sharding.Mesh``) ``analyze_batch`` splits the
lanes over the mesh's shards, each running the compacted batch program on
its device with a replica of the detector and the heads (the JAX package's
``shard_map`` of ``_build_batch_compact_fn``).

Numerics: each forward holds its own precision tier (``numerics``), so no
global setting changes an answer. The detector's tier comes in
``detector_kwargs`` (``precision=``), the heads' in their constructor
(``MultiheadHeads(params, device, precision=...)``, or ``head_kwargs`` of
``from_two_model_pbs``); both default to "highest", IEEE fp32, the tier of
the reference's answers.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.mtcnn import import_mtcnn_params
from ..models.multihead import import_multihead_params
from ..ops import boxes as B
from ..ops.kernels.crop import crop_resize
from ..parallel.sharding import split_batch
from .detector import MTCNNDetector, resolve_device, to_host
from .heads import Int8MultiheadHeads, MultiheadHeads, TwoModelHeads


# the oversampled crops: the box and four ±10 px diagonal shifts,
# [dy, dx, dy, dx] on the [y1, x1, y2, x2] crop rect
OVERSAMPLE_SHIFTS = torch.tensor(
    [[0, 0], [-10, -10], [10, -10], [-10, 10], [10, 10]],
    dtype=torch.float32).repeat(1, 2)[:, None, :]


@dataclasses.dataclass
class FaceResult:
    bbox: Tuple[int, int, int, int]       # dilated+clipped [x1, y1, x2, y2]
    raw_bbox: Tuple[float, float, float, float]
    score: float
    age: float
    gender_prob: float                    # P(male)
    identity: np.ndarray                  # (1024,) embedding; (0,) two-model
    landmarks: np.ndarray                 # (10,) [x0..x4, y0..y4]

    def is_male(self, threshold: float = 0.6) -> bool:
        return self.gender_prob >= threshold


def _home(device, mesh) -> torch.device:
    """Where an analyzer lives: the mesh's first device, else ``device``."""
    return mesh.devices.flat[0] if mesh is not None else resolve_device(device)


class FacialAnalyzer:
    """Detection + per-face heads on one device, or a batch over a mesh.

    ``mtcnn_params`` and ``multihead_params`` are the reference's numpy
    pytrees; they move to ``device`` once. ``heads`` replaces the default
    ``MultiheadHeads(multihead_params)``: any object on the same device with
    ``apply(crops) -> (ages, gender_prob, identity)``, e.g.
    ``Int8MultiheadHeads``. ``head_batch`` bounds the crops and head
    forwards per image: the first ``head_batch`` valid boxes are analyzed,
    and ``analyze`` re-runs at the detector's full width when an image has
    more valid faces than that. ``oversample`` turns on the reference's
    5-crop oversampling (``facial_analysis.py:248-253``: the box and four
    ±10 px diagonal shifts, ages and P(male) averaged over the five crops,
    identity from the box's own crop). ``batch_head_total`` is the number
    of head slots ``analyze_batch`` shares across a batch (default
    ``max(16, 2·lanes)``). ``mesh`` (``parallel.sharding.Mesh``): the
    analyzer lives on the mesh's first device, which replaces ``device``,
    and ``analyze_batch`` shards its lanes over every device of the mesh:
    zero lanes pad the batch to a multiple of the shards, each shard runs
    ``analyze_batch_core`` on its lanes with a per-shard budget of
    ``batch_head_total or max(16, 2·lanes a shard)`` head slots (lane by
    lane with ``oversample``), and the host stitches the shards together.
    ``analyze`` (one image) is not sharded; the padded retry and rotation
    forms refuse a mesh."""

    def __init__(self, mtcnn_params, multihead_params=None, device="cuda",
                 minsize: int = 40, face_size: int = 224,
                 bbox_dilation: int = 10, head_batch: int = 16, heads=None,
                 oversample: bool = False, batch_head_total=None, mesh=None,
                 **detector_kwargs):
        self.mesh = mesh
        self.device = _home(device, mesh)
        if heads is None:
            if multihead_params is None:
                raise ValueError("pass multihead_params or heads")
            heads = MultiheadHeads(multihead_params, self.device)
        self.detector = MTCNNDetector(mtcnn_params, device=self.device,
                                      minsize=minsize, **detector_kwargs)
        self.heads = heads
        self.face_size = face_size
        self.bbox_dilation = bbox_dilation
        self.head_batch = head_batch
        self.oversample = oversample
        self.batch_head_total = batch_head_total

    @classmethod
    def from_reference_models(cls, mtcnn_pb: str, agegender_pb: str,
                              int8_heads: bool = False, **kwargs):
        """``int8_heads=True`` runs the per-face multi-head net on the
        full-int8 serving path (``models/int8_infer.py``)."""
        mh = import_multihead_params(agegender_pb)
        if int8_heads:
            device = _home(kwargs.pop("device", "cuda"), kwargs.get("mesh"))
            return cls(import_mtcnn_params(mtcnn_pb), device=device,
                       heads=Int8MultiheadHeads(mh, device), **kwargs)
        return cls(import_mtcnn_params(mtcnn_pb), mh, **kwargs)

    @classmethod
    def from_two_model_pbs(cls, mtcnn_pb: str, age_pb: str, gender_pb: str,
                           sota: bool = False, head_kwargs: Optional[Dict] = None,
                           **kwargs):
        """Two-graph configuration (reference ``age_gender_one_model=False``,
        ``facial_analysis.py:47-54,67-71``): separate frozen age and gender
        models, each with its own input size and tensor taps
        (``TwoModelHeads``). Faces carry no identity features: each
        ``FaceResult.identity`` has shape (0,)."""
        device = _home(kwargs.pop("device", "cuda"), kwargs.get("mesh"))
        heads = TwoModelHeads(age_pb, gender_pb, device, sota=sota,
                              **(head_kwargs or {}))
        return cls(import_mtcnn_params(mtcnn_pb), device=device, heads=heads,
                   **kwargs)

    def _dilated_geometry(self, boxes, h: int, w: int):
        """Dilate by ``bbox_dilation`` (reference :240-244): the [y1, x1,
        y2, x2] crop rects (pre-clip) and the clipped [x1, y1, x2, y2]
        dilated boxes. ``boxes`` is (..., n, 4)."""
        dil = float(self.bbox_dilation)
        x1 = torch.floor(boxes[..., 0]) - dil
        y1 = torch.floor(boxes[..., 1]) - dil
        x2 = torch.floor(boxes[..., 2]) + dil
        y2 = torch.floor(boxes[..., 3]) + dil
        rect = torch.stack([y1, x1, y2, x2], dim=-1)
        dilated = torch.stack([torch.clamp(x1, 0, w), torch.clamp(y1, 0, h),
                               torch.clamp(x2, 0, w), torch.clamp(y2, 0, h)],
                              dim=-1)
        return rect, dilated

    @torch.no_grad()
    def analyze_core(self, img, head_batch: Optional[int] = None,
                     tier: int = 0):
        """One image tensor (H, W, 3) on the device, or a batch (L, H, W, 3)
        analyzed lane by lane (the JAX package's vmapped per-lane program,
        which ``analyze_batch`` runs with ``oversample``) -> (boxes, dilated,
        scores, points, valid, ages, gender_prob, identity_k, sel,
        truncated, head_truncated): per-slot arrays at the detector's width,
        ``identity_k`` compact with scatter indices ``sel``, each with a
        leading L for a batch."""
        k = head_batch or self.head_batch
        h, w = img.shape[-3], img.shape[-2]
        img_f = img.to(torch.float32).contiguous()
        boxes, scores, points, valid, truncated = self.detector.detect_core(img_f, tier)
        rect_all, dilated = self._dilated_geometry(boxes, h, w)
        # compact to the first k valid boxes, in slot order: most of a
        # full-width head pass would be padding
        sel = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)[..., :k]
        rect = B.take_rows(rect_all, sel)                     # (..., k, 4)
        if self.oversample:
            # the box and 4 diagonal ±10 shifts (reference :248-253), each
            # clipped on its own (:255-263)
            rect = rect[..., None, :, :] + OVERSAMPLE_SHIFTS.to(rect.device)
        else:
            rect = rect[..., None, :, :]                      # (..., v, k, 4)
        v, k = rect.shape[-3], rect.shape[-2]
        hw = torch.tensor([h, w, h, w], dtype=torch.float32, device=self.device)
        rect = torch.minimum(torch.clamp(rect, min=0.0), hw)
        crops = crop_resize(img_f, rect.reshape(*rect.shape[:-3], v * k, 4),
                            self.face_size, 1, "clamp")
        ages_v, gender_v, identity_v = self.heads.apply(
            crops.reshape(-1, *crops.shape[-3:]))
        lead = valid.shape[:-1]
        # average over the crop variants; identity from the box's own crop
        # (the reference keeps the last processed, and its boxes[::-1]
        # order ends on the box itself)
        ages_k = ages_v.reshape(*lead, v, k).mean(dim=-2)
        gender_k = gender_v.reshape(*lead, v, k).mean(dim=-2)
        # the width is explicit: the two-model heads' identity is (n, 0)
        identity_k = identity_v.reshape(*lead, v, k, identity_v.shape[-1])[..., 0, :, :]
        ages = torch.zeros(valid.shape, device=self.device).scatter_(-1, sel, ages_k)
        gender_prob = torch.zeros(valid.shape, device=self.device).scatter_(
            -1, sel, gender_k)
        head_truncated = torch.sum(valid, dim=-1) > k
        return (boxes, dilated, scores, points, valid, ages, gender_prob,
                identity_k, sel, truncated, head_truncated)

    @torch.no_grad()
    def analyze_batch_core(self, imgs, total: int):
        """A batch (L, H, W, 3) on the device with cross-lane head compaction
        (the JAX package's ``_build_batch_compact_fn``): the batched
        cascade, then the first ``total`` valid boxes of all lanes, in
        lane-major order, cropped in one K1 launch with a lane index and
        run through one head forward. Returns the ``analyze_core`` outputs
        with a leading L, except ``identity_k`` (total, D) and ``sel``
        (total,), flat indices into the (L·n) slots, and
        ``head_truncated`` (L,): a lane one of whose valid faces ranked
        past ``total``."""
        h, w = imgs.shape[-3], imgs.shape[-2]
        imgs_f = imgs.to(torch.float32).contiguous()
        boxes, scores, points, valid, truncated = self.detector.detect_batch_core(imgs_f)
        lanes, n = valid.shape
        rect_all, dilated = self._dilated_geometry(boxes, h, w)
        flat_valid = valid.reshape(-1)
        sel = torch.argsort((~flat_valid).to(torch.uint8), stable=True)[:total]
        hw = torch.tensor([h, w, h, w], dtype=torch.float32, device=self.device)
        rect = torch.minimum(torch.clamp(rect_all.reshape(-1, 4)[sel], min=0.0), hw)
        crops = crop_resize(imgs_f, rect, self.face_size, 1, "clamp",
                            lanes=(sel // n).to(torch.int32))
        ages_k, gender_k, identity_k = self.heads.apply(crops)
        ages = torch.zeros(lanes * n, device=self.device)
        ages[sel] = ages_k
        gender = torch.zeros(lanes * n, device=self.device)
        gender[sel] = gender_k
        # the rank of a valid face: the cumulative valid count, lane-major
        rank = torch.cumsum(flat_valid.to(torch.int32), 0).reshape(lanes, n)
        head_truncated = torch.any(valid & (rank > total), dim=1)
        return (boxes, dilated, scores, points, valid, ages.reshape(lanes, n),
                gender.reshape(lanes, n), identity_k, sel, truncated,
                head_truncated)

    @staticmethod
    def _scatter_identity(identity_k: np.ndarray, sel: np.ndarray,
                          n: int) -> np.ndarray:
        """The compact identity rows back at full width, on the host."""
        out = np.zeros((n, identity_k.shape[-1]), identity_k.dtype)
        out[sel] = identity_k
        return out

    @staticmethod
    def _assemble_results(out_np, identity: np.ndarray) -> List[FaceResult]:
        """One image's host arrays -> FaceResult list."""
        boxes, dilated, scores, points, valid, ages, genders = out_np[:7]
        results = []
        for i in np.where(valid)[0]:
            x1, y1, x2, y2 = boxes[i, :4]
            if not (x2 > x1 and y2 > y1):
                continue  # reference skips zero-area boxes (:237)
            results.append(FaceResult(
                bbox=tuple(int(v) for v in dilated[i]),
                raw_bbox=tuple(float(v) for v in boxes[i, :4]),
                score=float(scores[i]),
                age=float(ages[i]),
                gender_prob=float(genders[i]),
                identity=identity[i],
                landmarks=points[i],
            ))
        return results

    def _run(self, img, head_batch=None, tier: int = 0):
        return to_host(self.analyze_core(img, head_batch, tier))

    def analyze(self, img: np.ndarray) -> List[FaceResult]:
        """RGB uint8/float (H, W, 3) -> per-face results.

        When the detector's box caps saturate, re-runs at doubled-cap tiers
        (up to ``max_escalations``); when only the head budget saturates,
        re-runs at the detector's full width."""
        h, w = img.shape[:2]
        det = self.detector
        dev = det.upload(img)
        tier = 0
        out_np = self._run(dev)
        while (bool(out_np[9]) and tier < det.max_escalations
               and det.caps_for(h, w, tier + 1) != det.caps_for(h, w, tier)):
            tier += 1
            out_np = self._run(dev, tier=tier)
        width = det.caps_for(h, w, tier)[2]  # stage-3 width
        if bool(out_np[10]) and self.head_batch < width:
            out_np = self._run(dev, width, tier)
        det._warn_truncated(bool(out_np[9]), det.caps_for(h, w, tier))
        identity = self._scatter_identity(out_np[7], out_np[8], len(out_np[4]))
        return self._assemble_results(out_np, identity)

    def _batch_head_budget(self) -> int:
        """Per-lane head budget of the lane-by-lane batch form (oversample),
        never above the detector's full width."""
        return min(max(8, self.head_batch // 2), self.detector.max_stage3)

    def _batch_total(self, lanes: int) -> int:
        return self.batch_head_total or max(16, 2 * lanes)

    def _pad(self, images: np.ndarray, lanes: int) -> np.ndarray:
        """Zero images up to ``lanes``: blank lanes detect nothing, so they
        take no head slots."""
        images = np.asarray(images)
        if len(images) >= lanes:
            return images
        return np.concatenate([images, np.zeros((lanes - len(images),)
                                                + images.shape[1:], images.dtype)])

    def analyze_batch(self, images: np.ndarray,
                      n_valid: Optional[int] = None) -> List[List[FaceResult]]:
        """Same-size RGB batch (N, H, W, 3) -> per-image FaceResult lists.

        One upload and one pass over the batch: the cross-lane compacted
        program (``analyze_batch_core``), or with ``oversample`` the
        lane-by-lane one at ``_batch_head_budget`` faces a lane. Lanes whose
        faces overflow the head slots, or whose detector caps truncated
        (when ``max_escalations`` > 0), re-run through ``analyze``.
        ``n_valid``: with a padded batch, the number of real leading lanes;
        only those are returned. Pad with zero images (not repeats): blank
        lanes detect nothing, so they take no head slots. Under a mesh the
        lanes are sharded (``_analyze_sharded``)."""
        images = np.asarray(images)
        if self.mesh is not None:
            return self._analyze_sharded(images, n_valid)
        return self._analyze_uploaded(self.detector.upload(images), images, n_valid)

    def _analyze_sharded(self, images: np.ndarray,
                         n_valid: Optional[int] = None) -> List[List[FaceResult]]:
        """``analyze_batch`` over the mesh (the JAX package's
        ``_batch_compact_sharded_fn``): every stage is lane-local, so each
        shard compacts its own lanes' faces into its own head slots and no
        shard waits for another. Each shard's ``sel`` indexes its local
        (lanes · n) slots; the host adds the shard offsets."""
        n, h, w = images.shape[:3]
        n_valid = n if n_valid is None else min(n_valid, n)
        shards = self.mesh.shard_devices()
        images = self._pad(images, -(-n // len(shards)) * len(shards))
        lanes = len(images) // len(shards)
        replicas = self.mesh.replicate(self)
        parts = split_batch(images, shards)
        caps = self.detector.caps_for(h, w)
        if self.oversample:
            budget = self._batch_head_budget()
            cores = [replicas[d].analyze_core(x, budget) for d, x in zip(shards, parts)]
            can_fallback = budget < caps[2]
        else:
            total = self._batch_total(lanes)
            cores = [replicas[d].analyze_batch_core(x, total)
                     for d, x in zip(shards, parts)]
            can_fallback = total < lanes * caps[2]
        outs = [to_host(c) for c in cores]     # after every shard was launched
        out = [np.concatenate(a) for a in zip(*outs)]
        if not self.oversample:
            width = outs[0][4].shape[1]
            out[8] = np.concatenate([o[8] + s * lanes * width
                                     for s, o in enumerate(outs)])
        det_esc = self.detector.max_escalations > 0
        self.detector._warn_truncated(bool(out[9][:n_valid].any()) and not det_esc, caps)
        return self._finish_compact(out, lambda i: images[i], n_valid, can_fallback)

    def _analyze_uploaded(self, dev, images: np.ndarray,
                          n_valid: Optional[int] = None) -> List[List[FaceResult]]:
        """``analyze_batch`` of ``images``, already on the device as ``dev``."""
        n, h, w = images.shape[:3]
        n_valid = n if n_valid is None else min(n_valid, n)
        if self.oversample:
            out = self._run(dev, self._batch_head_budget())
            can_fallback = (self._batch_head_budget()
                            < self.detector.caps_for(h, w)[2])
        else:
            total = self._batch_total(n)
            out = to_host(self.analyze_batch_core(dev, total))
            can_fallback = total < n * self.detector.caps_for(h, w)[2]
        det_esc = self.detector.max_escalations > 0
        self.detector._warn_truncated(bool(out[9][:n_valid].any()) and not det_esc,
                                      self.detector.caps_for(h, w))
        return self._finish_compact(out, lambda i: images[i], n_valid, can_fallback)

    def _finish_compact(self, out, fallback_img, n_valid: int,
                        can_fallback: bool, only=None) -> List[List[FaceResult]]:
        """Host assembly of one batch's outputs: scatter the compact
        identity rows, build the per-lane FaceResult lists, and re-run the
        truncated lanes through ``analyze``. ``fallback_img``: lane index
        -> the image that re-run sees (a rotation pass hands the host-rotated
        photo). ``only``: the lanes to assemble; the others return [] with
        no re-run."""
        det_esc = self.detector.max_escalations > 0
        identity_k, sel = out[7], out[8]
        lanes, width = out[4].shape
        if identity_k.ndim == 3:        # lane by lane: (L, k, D), sel (L, k)
            identity = np.stack([self._scatter_identity(identity_k[i], sel[i], width)
                                 for i in range(lanes)])
        else:                           # compact: (K, D) over the L·n slots
            identity = self._scatter_identity(
                identity_k, sel, lanes * width).reshape(lanes, width, identity_k.shape[-1])
        results = []
        for i in range(n_valid):
            if only is not None and i not in only:
                results.append([])
            elif (bool(out[10][i]) and can_fallback) or (bool(out[9][i]) and det_esc):
                results.append(self.analyze(fallback_img(i)))
            else:
                results.append(self._assemble_results([a[i] for a in out[:7]],
                                                      identity[i]))
        return results

    def analyze_batch_padded(self, images: np.ndarray,
                             lanes: int) -> List[List[FaceResult]]:
        """``analyze_batch`` over a fixed lane count: zero-pads the batch up
        to ``lanes`` and returns the results of the real images only."""
        return self.analyze_batch(self._pad(images, lanes), n_valid=len(images))

    def _rotations(self, dev, n: int, lanes: int, images: np.ndarray, only=None):
        """The 90° and 270° passes over uploaded upright images ``dev``,
        rotated on the device (``torch.rot90`` is ``np.rot90``'s exact
        reindexing), in one host copy: (faces_90, faces_270) per image, the
        270° pass assembled only for images without a face at 90°."""
        h, w = images.shape[1:3]
        total = self._batch_total(lanes)
        # device k values mirror the host convention: np.rot90(img, 3) turns
        # the photo 90° clockwise
        outs = [self.analyze_batch_core(torch.rot90(dev, k, dims=(1, 2)), total)
                for k in (3, 1)]
        host = to_host(list(outs[0]) + list(outs[1]))
        can_fallback = total < lanes * self.detector.caps_for(w, h)[2]
        pending = set(range(n)) if only is None else only
        res90 = self._finish_compact(
            host[:11], lambda i: np.ascontiguousarray(np.rot90(images[i], 3)),
            n, can_fallback, only=pending)
        res270 = self._finish_compact(
            host[11:], lambda i: np.ascontiguousarray(np.rot90(images[i], 1)),
            n, can_fallback, only={i for i in pending if not res90[i]})
        return res90, res270

    def analyze_batch_rotations_padded(
            self, images: np.ndarray,
            lanes: int) -> List[Tuple[List[FaceResult], List[FaceResult]]]:
        """The 90° and 270° analyses of upright images from one upload:
        (faces_90, faces_270) per real image, in the rotated images'
        coordinates (those of ``np.rot90(img, 3)`` and ``np.rot90(img,
        1)``); faces_270 only for images with no face at 90°. The caller
        applies the reference's 90-first policy. Single-device only."""
        if self.mesh is not None:
            raise ValueError("analyze_batch_rotations_padded runs on one device, "
                             "not over a mesh")
        n = len(images)
        images = self._pad(images, lanes)
        res90, res270 = self._rotations(self.detector.upload(images), n, lanes,
                                        images)
        return list(zip(res90, res270))

    def analyze_batch_retry_padded(
            self, images: np.ndarray,
            lanes: int) -> List[Tuple[List[FaceResult], int]]:
        """``analyze_batch_padded`` with the reference's 90°/270° retry
        (``process_photos.py:241-247``) from one upload: the upright pass
        first, and only when some image finds no face, the rotation pair on
        the same device tensor. Returns (faces, rotation) per real image,
        rotation in {0, 90, 270}; a rotated result's boxes lie in the
        rotated image, as with ``analyze_with_rotations``."""
        if self.mesh is not None or self.oversample:
            raise ValueError("analyze_batch_retry_padded runs the single-device "
                             "compacted batch path only, not a mesh or oversample")
        n = len(images)
        images = self._pad(images, lanes)
        dev = self.detector.upload(images)                  # the one upload
        res_up = self._analyze_uploaded(dev, images, n)
        pending = {i for i in range(n) if not res_up[i]}
        if not pending:
            return [(r, 0) for r in res_up]
        res90, res270 = self._rotations(dev, n, lanes, images, only=pending)
        return [(res_up[i], 0) if res_up[i] else (res90[i], 90) if res90[i]
                else (res270[i], 270) for i in range(n)]

    def with_minsize(self, minsize: int) -> "FacialAnalyzer":
        """Shallow clone detecting at another minimum face size: the heads
        and the detector's weights are shared (no copy, no upload), the
        detector is fresh and keeps every other setting."""
        clone = copy.copy(self)
        clone.detector = copy.copy(self.detector)
        clone.detector.minsize = minsize
        clone.detector.last_truncated = False
        return clone

    def analyze_with_rotations(self, img: np.ndarray) -> Tuple[List[FaceResult], int]:
        """Retry at 90°/270° when no face is found (reference
        ``process_photos.py:241-247``). Returns (faces, rotation_applied)."""
        faces = self.analyze(img)
        if faces:
            return faces, 0
        for rot in (90, 270):
            k = 3 if rot == 90 else 1  # np.rot90 is counter-clockwise
            faces = self.analyze(np.ascontiguousarray(np.rot90(img, k)))
            if faces:
                return faces, rot
        return [], 0
