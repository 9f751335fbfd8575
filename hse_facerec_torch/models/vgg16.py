"""VGGFace VGG16 embedder (keras_vggface architecture).

Counterpart of ``hse_facerec_tf_tpu/models/vgg16.py``. The reference uses
``keras_vggface.VGGFace(model='vgg16')`` tapped at ``fc7/relu`` as an
alternative face embedder (``facerec_test.py:344-349``,
``facial_clustering_test.py:295-300``): five 3×3 conv blocks (64/128/256/
512/512 channels, 2/2/3/3/3 layers) each followed by a 2×2 max-pool, then
fc6(4096)+relu and fc7(4096)+relu; the fc8 head is not used.

Params are numpy pytrees in the reference's layouts (138 M floats, 553 MB:
seed or load them once); the forward takes them as tensors
(``params.to_torch``). Input keeps the reference's NHWC.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import precision_scope
from ..params import normal
from .layers import conv2d, dense

# (block, n_convs, channels)
VGG16_BLOCKS = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))


def vgg16_embed(params: Dict, x, *, precision="highest") -> torch.Tensor:
    """(N, 224, 224, 3) preprocessed (BGR, mean-subtracted) -> (N, 4096)
    fc7/relu activations (the reference's embedding tap), at
    ``precision``'s tier."""
    with precision_scope(precision):
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        for block, n_convs, _ in VGG16_BLOCKS:
            for i in range(1, n_convs + 1):
                layer = params[f"conv{block}_{i}"]
                x = torch.relu(conv2d(x, layer["kernel"], layer["bias"]))
            x = F.max_pool2d(x, 2, 2)
        # Keras Flatten on NHWC: (7, 7, 512) in (h, w, c) order, the
        # published fc6 kernel's
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(dense(x, params["fc6"]["kernel"], params["fc6"]["bias"]))
        return torch.relu(dense(x, params["fc7"]["kernel"], params["fc7"]["bias"]))


def init_vgg16_params(generator: torch.Generator) -> Dict:
    """He-normal random init (tests, the random-init fallback): numpy
    params, normals drawn from ``generator``."""
    params: Dict = {}
    cin = 3
    for block, n_convs, cout in VGG16_BLOCKS:
        for i in range(1, n_convs + 1):
            params[f"conv{block}_{i}"] = {
                "kernel": normal(generator, (3, 3, cin, cout), np.sqrt(2.0 / (9 * cin))),
                "bias": np.zeros(cout, np.float32)}
            cin = cout
    flat = 7 * 7 * 512
    for name, (fi, fo) in (("fc6", (flat, 4096)), ("fc7", (4096, 4096))):
        params[name] = {"kernel": normal(generator, (fi, fo), np.sqrt(2.0 / fi)),
                        "bias": np.zeros(fo, np.float32)}
    return params


def vgg16_params_from_h5(path: str) -> Dict:
    """Map a keras_vggface VGG16 h5 (standard Keras layer groups; kernel =
    4-D/2-D array, bias = 1-D) onto the param pytree. fc8 is ignored."""
    from ..core.h5_import import load_keras_h5

    by_layer: Dict[str, Dict[str, np.ndarray]] = {}
    for name, arr in load_keras_h5(path).items():
        slot = "kernel" if arr.ndim > 1 else "bias"
        by_layer.setdefault(name.split("/")[0], {})[slot] = np.asarray(arr, np.float32)

    params: Dict = {}
    for block, n_convs, cout in VGG16_BLOCKS:
        for i in range(1, n_convs + 1):
            layer = f"conv{block}_{i}"
            if layer not in by_layer:
                raise KeyError(f"{path}: missing VGG16 layer {layer!r}")
            k = by_layer[layer]["kernel"]
            if k.shape[-1] != cout:
                raise ValueError(f"{layer}: kernel shape {k.shape}, want "
                                 f"(3, 3, ?, {cout})")
            params[layer] = {"kernel": k, "bias": by_layer[layer]["bias"]}
    for name in ("fc6", "fc7"):
        if name not in by_layer:
            raise KeyError(f"{path}: missing VGG16 layer {name!r}")
        params[name] = {"kernel": by_layer[name]["kernel"], "bias": by_layer[name]["bias"]}
    return params
