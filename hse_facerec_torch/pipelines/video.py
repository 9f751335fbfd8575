"""Live / file video demos: frame loop → analyze → annotate.

The reference's L6 demo surface (``facial_analysis.py:607-691``):
``show_webcam`` (:607-617), ``show_video`` with frame-skip 5, ≤640×480
downscale and rotation fix (:637-669), and ``process_all_images`` (:671-691).
Here as composable generators over the analyzer's batch path;
display/write-out is the caller's choice (the CLI wires cv2.imshow /
VideoWriter).

The port's own copy of ``hse_facerec_tf_tpu/pipelines/video.py``. Opening a
video or camera, decoding image files and drawing need cv2, imported inside
the functions; the downscale is ``ops/resize.py``'s cv2 INTER_LINEAR in
cv2's uint8 fixed point (the same bytes as ``cv2.resize``) and frames turn BGR to RGB by reversing the channel axis (the same
bytes as ``cv2.cvtColor``)."""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from ..ops.resize import resize_linear_u8
from ..utils.draw import draw_faces
from ..utils.image_io import bgr_to_rgb, imread_rgb, rotate_image, video_rotation
from .analyzer import FacialAnalyzer

# Optional per-face person-name source for the overlays: called with a FLAT
# list of FaceResult (possibly spanning several frames of one batch) and
# returns one Optional[str] per face — one enrollment-gallery ranking call
# per analyze batch, not per frame.
Labeler = Callable[[list], List[Optional[str]]]


def _labels_for(labeler: Optional[Labeler], faces: list) -> Optional[list]:
    return labeler(faces) if labeler is not None and faces else None


def _annotate_group(analyzer: FacialAnalyzer, frames: list, lanes: int,
                    labeler: Optional[Labeler]) -> list:
    """One batch-path analyze over a same-shape frame group (the
    ``analyze_batch_padded`` lane contract) + one labeler call over the
    flat face list; returns [(annotated, faces)] per frame."""
    all_faces = analyzer.analyze_batch_padded(np.stack(frames), lanes)
    flat = [f for fc in all_faces for f in fc]
    labels = _labels_for(labeler, flat)
    out, pos = [], 0
    for fr, fc in zip(frames, all_faces):
        lab = labels[pos:pos + len(fc)] if labels is not None else None
        out.append((draw_faces(fr, fc, labels=lab), fc))
        pos += len(fc)
    return out


def _downscale(frame: np.ndarray, max_w: int = 640, max_h: int = 480) -> np.ndarray:
    """The reference's distorting fit (``facial_analysis.py:653-655``): each
    axis past its bound is resized to the bound."""
    h, w = frame.shape[:2]
    if w <= max_w and h <= max_h:
        return frame
    return resize_linear_u8(frame, (min(h, max_h), min(w, max_w)))


def annotated_video_frames(analyzer: FacialAnalyzer, video_path: str,
                           frame_skip: int = 5,
                           max_size: Tuple[int, int] = (640, 480),
                           batch: int = 8,
                           labeler: Optional[Labeler] = None
                           ) -> Iterator[Tuple[np.ndarray, list]]:
    """Yields (annotated RGB frame, faces) every ``frame_skip`` frames with the
    reference's downscale + rotation semantics.

    ``batch`` > 1 runs the analyzer's batch path over groups of selected
    frames (same frames, same order — the skip is fixed, so batching changes
    no semantics): one cascade and ONE host copy per group instead of per
    frame. The tail group zero-pads to the same lane count."""
    import cv2

    rotation = video_rotation(video_path)
    video = cv2.VideoCapture(video_path)
    counter = 0
    buf: list = []

    def flush():
        out = _annotate_group(analyzer, buf, batch, labeler)
        buf.clear()
        return out

    try:
        while video.isOpened():
            if not video.grab():
                break
            counter += 1
            if counter % frame_skip != 0:
                continue
            _, frame = video.retrieve()
            frame = bgr_to_rgb(frame)
            # reference order (facial_analysis.py:654-661): bound to
            # <=640x480 FIRST, rotate the small frame after — rotating the
            # full-res frame first changes the non-aspect-preserving
            # resize's geometry (and pays the resize at full resolution)
            frame = _downscale(frame, *max_size)
            frame = rotate_image(frame, rotation)
            if batch <= 1:
                faces = analyzer.analyze(frame)
                yield draw_faces(frame, faces,
                                 labels=_labels_for(labeler, faces)), faces
                continue
            if buf and buf[0].shape != frame.shape:
                yield from flush()   # mid-stream resolution change
            buf.append(frame)
            if len(buf) == batch:
                yield from flush()
        if buf:
            yield from flush()
    finally:
        video.release()


def annotated_camera_frames(analyzer: FacialAnalyzer, camera_index: int = 0,
                            max_size: Tuple[int, int] = (640, 480),
                            labeler: Optional[Labeler] = None
                            ) -> Iterator[Tuple[np.ndarray, list]]:
    """Webcam loop (reference ``show_webcam`` :607-617)."""
    import cv2

    cam = cv2.VideoCapture(camera_index)
    try:
        while True:
            ok, frame = cam.read()
            if not ok:
                break
            frame = _downscale(bgr_to_rgb(frame), *max_size)
            faces = analyzer.analyze(frame)
            yield draw_faces(frame, faces,
                             labels=_labels_for(labeler, faces)), faces
    finally:
        cam.release()


def process_image_dir(analyzer: FacialAnalyzer, image_dir: str,
                      max_size: Tuple[int, int] = (640, 480),
                      labeler: Optional[Labeler] = None,
                      batch: int = 8
                      ) -> Iterator[Tuple[str, np.ndarray, list]]:
    """Annotate every image in a directory (reference ``process_all_images``,
    ``facial_analysis.py:671-691`` — a serial per-image loop there).

    Decode runs on prefetch threads overlapped with device compute, and
    CONSECUTIVE same-shape images (the common camera-dir case after the
    ≤640×480 downscale) group into one batch via the shared
    ``analyze_batch_padded`` lane contract — same results, same order, one
    host copy per group."""
    from ..utils.prefetch import bounded_thread_map
    from .album import is_image

    names = [f for f in sorted(os.listdir(image_dir)) if is_image(f)]
    decoded = bounded_thread_map(
        lambda f: (f, _downscale(imread_rgb(os.path.join(image_dir, f)),
                                 *max_size)),
        names, workers=4, depth=2 * max(1, batch))
    if batch <= 1:
        for name, img in decoded:
            faces = analyzer.analyze(img)
            yield name, draw_faces(img, faces,
                                   labels=_labels_for(labeler, faces)), faces
        return
    buf: list = []

    def flush():
        out = _annotate_group(analyzer, [im for _, im in buf], batch, labeler)
        pairs = [(n, a, fc) for (n, _), (a, fc) in zip(buf, out)]
        buf.clear()
        return pairs

    for name, img in decoded:
        if buf and buf[0][1].shape != img.shape:
            yield from flush()   # shape change ends the group
        buf.append((name, img))
        if len(buf) == batch:
            yield from flush()
    if buf:
        yield from flush()
