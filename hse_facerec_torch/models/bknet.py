"""BKNet-style multi-task CNN (smile / gender / age) on 48² grayscale.

Counterpart of ``hse_facerec_tf_tpu/models/bknet.py``. The reference
benchmarks the external BKNetStyle2 model on UTKFace (``utkface_test.py:
153-184``): 48×48×1 input normalized (x − 128)/255, three heads — smile(2) /
gender(2) / age(101) — decoded as argmax. Three double-conv blocks (32/64/128
channels, 3×3 SAME, max-pool 2) and a shared 256-wide FC trunk.

Params are numpy pytrees in the reference's layouts (``init_bknet_params``,
``bknet_params_from_npz``); the forward takes them as tensors
(``params.tree_to_torch``). Input and output keep the reference's NHWC.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..numerics import precision_scope
from ..ops.resize import resize_linear_u8
from ..params import normal
from .layers import conv2d, dense

BKNET_BLOCKS = (32, 64, 128)
INPUT_SIZE = 48

# cv2's fixed-point RGB -> gray (15-bit weights)
_GRAY_SHIFT = 15
_R2Y, _G2Y, _B2Y = 9798, 19235, 3735


def bknet_apply(params: Dict, x, *, precision="highest"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 48, 48, 1) normalized grayscale → (smile (N, 2), gender (N, 2),
    age (N, 101)) logits, at ``precision``'s tier."""
    with precision_scope(precision):
        h = x.to(torch.float32).permute(0, 3, 1, 2)
        for bi, _ in enumerate(BKNET_BLOCKS, start=1):
            for ci in (1, 2):
                p = params[f"conv{bi}_{ci}"]
                h = torch.relu(conv2d(h, p["kernel"], p["bias"]))
            h = torch.nn.functional.max_pool2d(h, 2, 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten
        fc = params["fc"]
        h = torch.relu(dense(h, fc["kernel"], fc["bias"]))
        return tuple(dense(h, params[name]["kernel"], params[name]["bias"])
                     for name in ("smile", "gender", "age"))


def _rgb_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of a uint8 image: cv2's
    15-bit fixed-point weights with round-half-up (bit-exact against
    opencv-python 5.0 over every RGB triple, ``tests/test_torch_utkface.py``)."""
    x = img.astype(np.int32)
    y = x[..., 0] * _R2Y + x[..., 1] * _G2Y + x[..., 2] * _B2Y
    return ((y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)


def preprocess_bknet(images_rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 batch → (N, 48, 48, 1) normalized, reference :171-176
    (cv2 grayscale, resize 48², (x − 128)/255), in cv2's fixed-point
    arithmetic without cv2 (the card's machine has none)."""
    out = []
    for img in np.asarray(images_rgb):
        gray = resize_linear_u8(_rgb_to_gray_u8(img), (INPUT_SIZE, INPUT_SIZE))
        out.append((gray.astype(np.float32) - 128.0) / 255.0)
    return np.asarray(out)[..., None]


def init_bknet_params(generator: torch.Generator, input_size: int = INPUT_SIZE) -> Dict:
    """He-normal convs, N(0, 0.01) dense layers, zero biases: numpy params
    in the reference's layouts, normals drawn from ``generator``."""
    def conv(cin, cout):
        return {"kernel": normal(generator, (3, 3, cin, cout), np.sqrt(2.0 / (9 * cin))),
                "bias": np.zeros(cout, np.float32)}

    def dense_p(din, dout):
        return {"kernel": normal(generator, (din, dout), 0.01),
                "bias": np.zeros(dout, np.float32)}

    p: Dict = {}
    in_ch = 1
    for bi, ch in enumerate(BKNET_BLOCKS, start=1):
        p[f"conv{bi}_1"] = conv(in_ch, ch)
        p[f"conv{bi}_2"] = conv(ch, ch)
        in_ch = ch
    spatial = input_size // 8          # three 2× pools
    p["fc"] = dense_p(spatial * spatial * in_ch, 256)
    p["smile"] = dense_p(256, 2)
    p["gender"] = dense_p(256, 2)
    p["age"] = dense_p(256, 101)
    return p


def bknet_params_from_npz(path: str) -> Dict:
    """Load a BKNet checkpoint dumped as an .npz with this module's pytree
    key layout (``conv1_1/kernel`` … ``age/bias``)."""
    p: Dict = {}
    with np.load(path) as z:
        for k in z.files:
            layer, leaf = k.rsplit("/", 1)
            p.setdefault(layer, {})[leaf] = np.asarray(z[k], np.float32)
    return p
