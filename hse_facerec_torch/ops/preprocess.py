"""Input normalizations: channel order + mean subtraction / scaling, and
the fused resize + normalize of a batch.

Counterpart of ``hse_facerec_tf_tpu/ops/preprocess.py`` (the reference's
schemes, ``facerec_test.py:95-111``, ``facial_analysis.py:103-107,506``).
Inputs are RGB (..., H, W, 3); a scheme that needs BGR flips the channels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..numerics import div_const, fma
from .resize import resize

# Mean pixel values (BGR order, matching the Caffe-lineage models).
IMAGENET_MEANS_BGR = (103.939, 116.779, 123.68)     # facerec_test.py:97-100
VGGFACE2_MEANS_BGR = (91.4953, 103.8827, 131.0912)  # facerec_test.py:102-105
# keras_vggface.utils.preprocess_input version=1 (facerec_test.py:344-349)
VGGFACE1_MEANS_BGR = (93.5940, 104.7624, 129.1863)


def to_bgr(x):
    return torch.flip(x, dims=(-1,))


def normalize_caffe(x, means_bgr=IMAGENET_MEANS_BGR):
    """RGB float input -> BGR, per-channel mean subtraction. Each mean is
    filled in on ``x``'s device by a kernel that takes it as an argument: a
    copy from the host (``torch.tensor(..., device=...)``, or an item
    assigned) would make the host wait for the card's queued work."""
    means = torch.empty(len(means_bgr), dtype=torch.float32, device=x.device)
    for c, m in enumerate(means_bgr):
        means[c].fill_(m)
    return to_bgr(x.to(torch.float32)) - means


def normalize_vggface2(x):
    return normalize_caffe(x, VGGFACE2_MEANS_BGR)


def normalize_vggface1(x):
    return normalize_caffe(x, VGGFACE1_MEANS_BGR)


def normalize_mtcnn(x):
    """(x - 127.5) * 0.0078125 — reference ``facial_analysis.py:506,550,580``."""
    return (x.to(torch.float32) - 127.5) * 0.0078125


def normalize_tf(x):
    """x / 127.5 - 1 — reference ``facerec_test.py:109-111``. Inside
    ``jax.jit`` this is one FMA with the f32 reciprocal of 127.5."""
    x = x.to(torch.float32)
    recip = div_const(torch.ones((), device=x.device), 127.5)
    return fma(x, recip.expand_as(x), torch.full_like(x, -1.0))


NORMALIZERS = {
    "caffe": normalize_caffe,
    "vggface2": normalize_vggface2,
    "vggface1": normalize_vggface1,
    "mtcnn": normalize_mtcnn,
    "tf": normalize_tf,
    "none": lambda x: x.to(torch.float32),
}


def preprocess_batch(images, out_hw: Tuple[int, int], normalization: str = "vggface2",
                     resize_method: str = "cv2_linear"):
    """Resize + normalize a batch of same-size RGB images on their device:
    (N, H, W, 3) uint8 or float -> (N, out_h, out_w, 3) float32. Upload
    uint8 and the cast to float happens here, on the device (a byte a
    channel crosses the bus, not four)."""
    x = resize(images.to(torch.float32), out_hw, method=resize_method)
    return NORMALIZERS[normalization](x)
