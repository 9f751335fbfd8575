"""Cascade fallback detector (the reference's non-MTCNN path).

Counterpart of ``hse_facerec_tf_tpu/pipelines/cascade_fallback.py``. The
reference keeps an LBP-cascade detector beside MTCNN
(``facial_analysis.py:63,210-223``: ``cv2.CascadeClassifier`` over
``lbpcascade_frontalface.xml``); here ``pipelines/lbp_cascade.py`` reads
the same XML and runs its stages on ``device``. The output contract is
``MTCNNDetector.detect``'s: (boxes (n, 5), landmarks (10, n)), the
landmarks zeros, as the reference's cascade branch has none."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .lbp_cascade import LBPCascade


class CascadeFallbackDetector:
    def __init__(self, cascade_path: Optional[str] = None,
                 scale_factor: float = 1.1, min_neighbors: int = 3,
                 min_size: int = 40, device="cuda"):
        self._cascade = LBPCascade(cascade_path, device=device)
        self.scale_factor = scale_factor
        self.min_neighbors = min_neighbors
        self.min_size = min_size

    def detect(self, img_rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        boxes = self._cascade.detect(img_rgb, scale_factor=self.scale_factor,
                                     min_neighbors=self.min_neighbors,
                                     min_size=self.min_size)
        return boxes, np.zeros((10, len(boxes)))
