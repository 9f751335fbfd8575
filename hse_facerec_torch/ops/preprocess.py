"""Input normalizations used on the analyze path."""

from __future__ import annotations

import torch

# Mean pixel values (BGR order, matching the Caffe-lineage models).
IMAGENET_MEANS_BGR = (103.939, 116.779, 123.68)     # facerec_test.py:97-100


def normalize_mtcnn(x):
    """(x - 127.5) * 0.0078125 — reference ``facial_analysis.py:506,550,580``."""
    return (x.to(torch.float32) - 127.5) * 0.0078125
