"""Host-side image decode and dataset walking.

The port's own copy of ``get_files`` and ``imread_rgb`` from
``hse_facerec_tf_tpu/utils/image_io.py``. ``cv2`` is imported inside the
functions: a machine without it still imports the port.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def imread_rgb(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 (H, W, 3)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot decode image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def get_files(db_dir: str, extensions=(".jpg", ".jpeg", ".png", ".bmp")) -> List[Tuple[str, str]]:
    """[(class_dir, relative_path)] for a directory-per-class dataset
    (reference ``facerec_test.py:38-39``)."""
    out = []
    for d in sorted(os.listdir(db_dir)):
        full = os.path.join(db_dir, d)
        if not os.path.isdir(full):
            continue
        for f in sorted(os.listdir(full)):
            if f.lower().endswith(extensions):
                out.append((d, os.path.join(d, f)))
    return out
