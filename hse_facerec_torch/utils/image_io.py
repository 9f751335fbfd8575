"""Host-side image/video IO: decode, EXIF/rotation probing, dataset walking.

The port's own copy of ``hse_facerec_tf_tpu/utils/image_io.py``. ``cv2`` and
``PIL`` are imported inside the functions that decode: a machine without
them still imports the port, and ``video_rotation``, ``apply_orientation``
and ``rotate_image`` are pure Python and numpy.
"""

from __future__ import annotations

import os
import struct
from typing import List, Tuple

import numpy as np


def imread_rgb(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 (H, W, 3)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot decode image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def bgr_to_rgb(frame: np.ndarray) -> np.ndarray:
    """A decoded BGR frame -> RGB: the same bytes as ``cv2.cvtColor(frame,
    cv2.COLOR_BGR2RGB)``, without cv2."""
    return np.ascontiguousarray(frame[:, :, ::-1])


def imread_rgb_bounded(path: str, max_w: int, max_h: int) -> np.ndarray:
    """Decode for DOWNSCALED analysis: when the source is a JPEG at least 2×
    larger than the (max_w, max_h) fit box, decode at the largest 1/2^k
    JPEG DCT scale that still covers the target (libjpeg skips the unneeded
    IDCT work — a 48 MP photo analyzed at 640×480 decodes ~8× faster), and
    leave the exact final fit-resize to the caller, same as ``imread_rgb``.

    The reduction factor is chosen orientation-invariantly (EXIF rotation
    swaps w/h, and cv2 applies it during decode while the header probe sees
    the pre-rotation size), so the decoded image always covers the target
    box whichever way it ends up rotated. NOT for parity-sensitive paths
    (eval protocols decode at full resolution like the reference); the DCT
    intermediate differs sub-perceptibly from full-decode-then-resize.
    """
    import cv2

    try:
        from PIL import Image

        with Image.open(path) as im:    # header-only probe, no pixel decode
            if (im.format or "").upper() != "JPEG":
                raise ValueError
            w, h = im.size
    except Exception:
        return imread_rgb(path)
    # the larger of the two orientations' fit scales — the reduced image
    # must cover the target even if EXIF rotation swaps the axes
    s = max(min(max_w / w, max_h / h), min(max_w / h, max_h / w))
    reduction = 1
    while reduction < 8 and (reduction * 2) * s <= 1.0:
        reduction *= 2
    if reduction == 1:
        return imread_rgb(path)
    flag = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
            8: cv2.IMREAD_REDUCED_COLOR_8}[reduction]
    img = cv2.imread(path, flag)
    if img is None:
        return imread_rgb(path)
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


def exif_orientation(path: str) -> int:
    """EXIF orientation tag (1 = upright). Pure-Python probe via PIL."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            exif = im.getexif()
            return int(exif.get(0x0112, 1))
    except Exception:
        return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Apply an EXIF orientation to a decoded RGB array."""
    if orientation == 3:
        return np.rot90(img, 2).copy()
    if orientation == 6:
        return np.rot90(img, 3).copy()
    if orientation == 8:
        return np.rot90(img, 1).copy()
    return img


def video_rotation(path: str) -> int:
    """Rotation metadata (degrees cw) for MP4/MOV files.

    Pure-Python replacement for the reference's ``exiftool`` subprocess
    (``facial_analysis.py:619-635``): walks the MP4 box structure and decodes
    the track ``tkhd`` rotation matrix. Returns 0 / 90 / 180 / 270.

    Scope: MP4/MOV (ISO-BMFF) containers only — the reference's exiftool
    shell-out handled any container, but rotation metadata effectively only
    exists in phone-recorded MP4/MOV; AVI/MKV carry no standard rotation
    tag, and for those this probe returns 0 (frames used as stored)."""
    try:
        with open(path, "rb") as f:
            data = f.read(4 * 1024 * 1024)
        idx = data.find(b"tkhd")
        if idx < 0:
            return 0
        # tkhd: 4cc + version/flags(4) + times/id/duration (v0: 20 B, v1: 32 B)
        # + reserved(8) + layer(2) + alt_group(2) + volume(2) + reserved(2)
        # + matrix(36)
        version = data[idx + 4]
        base = idx + 4 + 4 + (32 if version == 1 else 20) + 8 + 2 + 2 + 2 + 2
        matrix = struct.unpack(">9i", data[base : base + 36])
        a, b = matrix[0] / 65536.0, matrix[1] / 65536.0
        if abs(a - 1) < 0.01 and abs(b) < 0.01:
            return 0
        if abs(a) < 0.01 and abs(b - 1) < 0.01:
            return 90
        if abs(a + 1) < 0.01 and abs(b) < 0.01:
            return 180
        if abs(a) < 0.01 and abs(b + 1) < 0.01:
            return 270
        return 0
    except Exception:
        return 0


def rotate_image(img: np.ndarray, degrees_cw: int) -> np.ndarray:
    """Rotate a frame by the video rotation metadata
    (reference ``show_video`` :643-651)."""
    k = (degrees_cw // 90) % 4
    return np.rot90(img, -k).copy() if k else img
