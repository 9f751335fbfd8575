"""FacialAnalyzer: detect → crop → age/gender/identity.

Counterpart of ``hse_facerec_tf_tpu/pipelines/analyzer.py`` (``analyze``
and ``analyze_with_rotations``). Per-face semantics follow the reference's
``process_image`` (``facial_analysis.py:233-294``): boxes dilated by 10 px,
clipped to the image, cropped to 224² bilinear (border-replicate), BGR +
ImageNet means; age = 1 + expectation over the renormalized top-2 age bins;
gender probability thresholded at 0.6.

Numerics: parity with the reference needs fp32 without TF32. Call
``hse_facerec_torch.set_parity_numerics()`` once before analyzing on a
CUDA device, as the CLI and ``chip_smoke.py`` do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.mtcnn import import_mtcnn_params
from ..models.multihead import import_multihead_params
from ..ops.kernels.crop import crop_resize
from .detector import MTCNNDetector, resolve_device
from .heads import Int8MultiheadHeads, MultiheadHeads


@dataclasses.dataclass
class FaceResult:
    bbox: Tuple[int, int, int, int]       # dilated+clipped [x1, y1, x2, y2]
    raw_bbox: Tuple[float, float, float, float]
    score: float
    age: float
    gender_prob: float                    # P(male)
    identity: np.ndarray                  # (1024,) embedding
    landmarks: np.ndarray                 # (10,) [x0..x4, y0..y4]

    def is_male(self, threshold: float = 0.6) -> bool:
        return self.gender_prob >= threshold


class FacialAnalyzer:
    """Detection + per-face heads on one device.

    ``mtcnn_params`` and ``multihead_params`` are the reference's numpy
    pytrees; they move to ``device`` once. ``heads`` replaces the default
    ``MultiheadHeads(multihead_params)``: any object on the same device with
    ``apply(crops) -> (ages, gender_prob, identity)``, e.g.
    ``Int8MultiheadHeads``. ``head_batch`` bounds the crops and head
    forwards per image: the first ``head_batch`` valid boxes are analyzed,
    and ``analyze`` re-runs at the detector's full width when an image has
    more valid faces than that."""

    def __init__(self, mtcnn_params, multihead_params=None, device="cuda",
                 minsize: int = 40, face_size: int = 224,
                 bbox_dilation: int = 10, head_batch: int = 16, heads=None,
                 **detector_kwargs):
        self.device = resolve_device(device)
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

    @classmethod
    def from_reference_models(cls, mtcnn_pb: str, agegender_pb: str,
                              int8_heads: bool = False, **kwargs):
        """``int8_heads=True`` runs the per-face multi-head net on the
        full-int8 serving path (``models/int8_infer.py``)."""
        mh = import_multihead_params(agegender_pb)
        if int8_heads:
            device = resolve_device(kwargs.pop("device", "cuda"))
            return cls(import_mtcnn_params(mtcnn_pb), device=device,
                       heads=Int8MultiheadHeads(mh, device), **kwargs)
        return cls(import_mtcnn_params(mtcnn_pb), mh, **kwargs)

    def _dilated_geometry(self, boxes, h: int, w: int):
        """Dilate by ``bbox_dilation`` (reference :240-244): the [y1, x1,
        y2, x2] crop rects (pre-clip) and the clipped [x1, y1, x2, y2]
        dilated boxes."""
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
        """One image tensor on the device -> (boxes, dilated, scores, points,
        valid, ages, gender_prob, identity_k, sel, truncated,
        head_truncated), the JAX program's outputs: per-slot arrays at the
        detector's width, ``identity_k`` compact with scatter indices
        ``sel``."""
        k = head_batch or self.head_batch
        h, w = img.shape[0], img.shape[1]
        boxes, scores, points, valid, truncated = self.detector.detect_core(img, tier)
        n = boxes.shape[0]
        img_f = img.to(torch.float32).contiguous()
        rect_all, dilated = self._dilated_geometry(boxes, h, w)
        # compact to the first k valid boxes, in slot order: most of a
        # full-width head pass would be padding
        sel = torch.argsort((~valid).to(torch.uint8), stable=True)[:k]
        hw = torch.tensor([h, w, h, w], dtype=torch.float32, device=self.device)
        rect = torch.minimum(torch.clamp(rect_all[sel], min=0.0), hw).contiguous()
        crops = crop_resize(img_f, rect, self.face_size, 1, "clamp")
        ages_k, gender_k, identity_k = self.heads.apply(crops)
        ages = torch.zeros(n, device=self.device)
        ages[sel] = ages_k
        gender_prob = torch.zeros(n, device=self.device)
        gender_prob[sel] = gender_k
        head_truncated = torch.sum(valid) > k
        return (boxes, dilated, scores, points, valid, ages, gender_prob,
                identity_k, sel, truncated, head_truncated)

    @staticmethod
    def _assemble_results(out_np) -> List[FaceResult]:
        """One image's host arrays -> FaceResult list."""
        boxes, dilated, scores, points, valid, ages, genders = out_np[:7]
        identity_k, sel = out_np[7], out_np[8]
        identity = np.zeros((len(valid), identity_k.shape[-1]), identity_k.dtype)
        identity[sel] = identity_k
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
        return [t.cpu().numpy() for t in self.analyze_core(img, head_batch, tier)]

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
        return self._assemble_results(out_np)

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
