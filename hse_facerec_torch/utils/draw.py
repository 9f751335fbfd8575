"""Detection-result overlays (the reference's demo rendering).

The port's own copy of ``hse_facerec_tf_tpu/utils/draw.py``.

Mirrors ``show_detection_results`` (``facial_analysis.py:296-317``): blue box
for male (gender ≥ 0.6), red for female, green age text at the top-left
corner; optional 5-point landmarks."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# The reference draws male=blue / female=red on screen
# (facial_analysis.py:304-308, BGR (255,0,0)/(0,0,255)); we draw on RGB arrays.
MALE_COLOR = (0, 0, 255)
FEMALE_COLOR = (255, 0, 0)
AGE_COLOR = (0, 255, 0)
LANDMARK_COLORS = [(0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255), (255, 255, 0)]


def draw_faces(img_rgb: np.ndarray, faces: Sequence, male_threshold: float = 0.6,
               draw_landmarks: bool = False,
               labels: Optional[Sequence[Optional[str]]] = None) -> np.ndarray:
    """faces: FaceResult list (pipelines/analyzer.py). Returns annotated copy.

    ``labels``: optional per-face person names (from an enrollment-gallery
    match; no reference analog — the reference overlays only age/gender,
    ``facial_analysis.py:304-312``). A non-None label is drawn above its
    box; None faces get no name line."""
    import cv2

    out = img_rgb.copy()
    for k, f in enumerate(faces):
        x1, y1, x2, y2 = [int(v) for v in f.bbox]
        color = MALE_COLOR if f.gender_prob >= male_threshold else FEMALE_COLOR
        cv2.rectangle(out, (x1, y1), (x2, y2), color)
        cv2.putText(out, f"{f.age:.0f}", (x1, y1 + 10),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, AGE_COLOR)
        if labels is not None and labels[k]:
            cv2.putText(out, str(labels[k]), (x1, max(10, y1 - 4)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color)
        if draw_landmarks:
            p = f.landmarks
            for i in range(5):
                cv2.circle(out, (int(p[i]), int(p[i + 5])), 1, LANDMARK_COLORS[i], 2)
    return out
