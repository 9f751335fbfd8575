"""ArcFace IResNet backbones (r34/r50/r100) + InsightFace gender-age decode.

Counterpart of ``hse_facerec_tf_tpu/models/arcface.py``, for the
reference's two MXNet InsightFace adapters:

- ``insightface_face_embedding.py:20-63``: the 112×112 ArcFace embedder
  (``model-r100-ii``), tapping ``fc1_output``; here the IResNet family
  ("improved residual", BN-first units with PReLU) those checkpoints use;
- ``age_gender_identity/insightface.py:110-132``: the gender-age model, the
  same backbone with a 202-wide ``fc1``, decoded by ``decode_gender_age``.

Numerics of the MXNet graphs: BN eps 2e-5 written ``(x − mean)·(γ·rsqrt(var
+ eps)) + β``, PReLU as ``where(x ≥ 0, x, α·x)``, 3×3 convs padded 1 on every
side even at stride 2 (not TF SAME), input scaled ``(x − 127.5) / 127.5``
with the float32 reciprocal, as the jitted reference computes it. The
forward takes the reference's ``precision`` tier and ``compute_dtype``:
each conv casts its input and weight to ``compute_dtype`` and its output
back to float32; BN, PReLU and ``pre_fc1`` stay float32.

On a card the trunk runs each unit's BNs, PReLU and residual add as two
launches of the fused kernel K6 (``ops/kernels/bn_act.py``), which rounds
every step as the eager passes do; CPU tensors take the eager passes. K6
has no backward, so on a card the trunk refuses a forward that autograd
would record.

``iresnet_params_from_npz`` reads the flat MXNet param naming
(``stage{s}_unit{u}_bn1_gamma``, ``conv0_weight``, ``pre_fc1_weight``, …)
from an ``.npz``; unit counts come from the names. Params are numpy
pytrees in the reference's layouts (HWIO, NHWC-flatten ``pre_fc1``); the
forward takes them as tensors (``params.tree_to_torch``). Input is RGB
0–255 NHWC at 112².
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import div_const, precision_scope
from ..ops.kernels.bn_act import bn_act, bn_plain
from ..params import normal

# stage unit counts per depth (insightface fresnet configs)
IRESNET_UNITS = {
    34: (3, 4, 6, 3),
    50: (3, 4, 14, 3),
    100: (3, 13, 30, 3),
}
IRESNET_FILTERS = (64, 64, 128, 256, 512)
# IResNet's inference BN (mxnet's default eps, as insightface uses it),
# defined once beside K6, whose passes must give its bits
_bn = bn_plain


def _prelu(x, alpha):
    return torch.where(x >= 0, x, x * alpha.reshape(1, -1, 1, 1))


def _conv(x, w, stride: int = 1, dt=torch.float32):
    # mxnet pads 3×3 convs symmetrically (pad=1) even at stride 2
    return F.conv2d(x.to(dt), w.to(dt), stride=stride,
                    padding=1 if w.shape[-1] == 3 else 0).to(torch.float32)


def _unit(x, p, stride: int, dt):
    """IResNet unit_v3: bn1 → conv1(3×3 s1) → bn2 → prelu → conv2(3×3 s) →
    bn3, plus shortcut (identity, or conv1sc+sc BN when the shape changes)."""
    h = _bn(x, p["bn1"])
    h = _conv(h, p["conv1"], 1, dt)
    h = _prelu(_bn(h, p["bn2"]), p["relu1_alpha"])
    h = _bn(_conv(h, p["conv2"], stride, dt), p["bn3"])
    sc = _bn(_conv(x, p["conv1sc"], stride, dt), p["sc"]) if "conv1sc" in p else x
    return h + sc


def _trunk(params: Dict, x, dt):
    """conv0 → bn0 → PReLU → the units → bn1, in eager passes."""
    h = _conv(x, params["conv0"], 1, dt)
    h = _prelu(_bn(h, params["bn0"]), params["relu0_alpha"])
    for s, n_units in enumerate(iresnet_units(params), start=1):
        for u in range(1, n_units + 1):
            h = _unit(h, params[f"stage{s}_unit{u}"], 2 if u == 1 else 1, dt)
    return _bn(h, params["bn1"])


def _trunk_fused(params: Dict, x, dt):
    """``_trunk`` on K6, the same bits: the stem's BN and PReLU with unit
    1's ``bn1`` as a second output, then per unit bn2 → PReLU, and bn3 plus
    the shortcut (its own BN in a downsampling unit) with the next unit's
    ``bn1`` (the last unit's: the trunk's ``bn1``) as a second output. One
    launch for the stem and two a unit."""
    units = [(params[f"stage{s}_unit{u}"], 2 if u == 1 else 1)
             for s, n_units in enumerate(iresnet_units(params), start=1)
             for u in range(1, n_units + 1)]
    nexts = [p["bn1"] for p, _ in units] + [params["bn1"]]
    h, b = bn_act(_conv(x, params["conv0"], 1, dt), params["bn0"],
                  alpha=params["relu0_alpha"], next_bn=nexts[0])
    for (p, stride), nxt in zip(units, nexts[1:]):
        r = bn_act(_conv(b, p["conv1"], 1, dt), p["bn2"], alpha=p["relu1_alpha"])
        r = _conv(r, p["conv2"], stride, dt)
        if "conv1sc" in p:
            h, b = bn_act(r, p["bn3"], residual=_conv(h, p["conv1sc"], stride, dt),
                          residual_bn=p["sc"], next_bn=nxt)
        else:
            h, b = bn_act(r, p["bn3"], residual=h, next_bn=nxt)
    return b


def iresnet_units(params: Dict) -> Tuple[int, ...]:
    """Per-stage unit counts recovered from the param dict's keys."""
    counts = []
    for s in range(1, 5):
        u = 0
        while f"stage{s}_unit{u + 1}" in params:
            u += 1
        counts.append(u)
    return tuple(counts)


def iresnet_embed(params: Dict, x, *, precision="highest",
                  compute_dtype=torch.float32) -> torch.Tensor:
    """(N, 112, 112, 3) RGB 0-255 → (N, emb_dim) fc1 output (pre-normalize):
    the reference tap ``fc1_output`` (insightface_face_embedding.py:33),
    with the final fc1 BatchNorm1d."""
    dt = compute_dtype
    with precision_scope(precision):
        x = div_const(x.to(torch.float32) - 127.5, 127.5).permute(0, 3, 1, 2)
        h = (_trunk_fused if x.device.type == "cuda" else _trunk)(params, x, dt)
        # NHWC flatten; pre_fc1's kernel is stored in the matching order
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = F.linear(h, params["pre_fc1"]["kernel"], params["pre_fc1"]["bias"])
    return _bn(h, params["fc1"])


def decode_gender_age(out) -> Tuple[torch.Tensor, torch.Tensor]:
    """InsightFace gender-age head decode (reference
    ``age_gender_identity/insightface.py:110-132``): for (N, 202) fc1
    output, gender = argmax over out[:, 0:2]; age = Σ over the 100 two-way
    argmaxes of out[:, 2:202] reshaped (N, 100, 2)."""
    gender = torch.argmax(out[:, 0:2], dim=1)
    pairs = out[:, 2:202].reshape(out.shape[0], 100, 2)
    return gender, torch.sum(torch.argmax(pairs, dim=2), dim=1)


def letterbox_112(img: np.ndarray, size: int = 112) -> np.ndarray:
    """Square letterbox with black border on the LEFT (w<h) or TOP (w>=h),
    then cv2-INTER_CUBIC resize — the reference's ``resize_image``
    (``age_gender_identity/insightface.py:77-90``), on the host."""
    from ..ops.resize import resize_host

    h, w = img.shape[:2]
    pad = ((0, 0), (h - w, 0), (0, 0)) if w < h else ((w - h, 0), (0, 0), (0, 0))
    return resize_host(np.pad(np.asarray(img), pad), (size, size), "cv2_cubic")


def init_iresnet_params(generator: torch.Generator, depth: int = 100,
                        emb_dim: int = 512, input_size: int = 112) -> Dict:
    """He-init IResNet params (shapes identical to an imported checkpoint):
    numpy, normals drawn from ``generator``."""
    f = IRESNET_FILTERS

    def conv(shape):
        return normal(generator, shape, np.sqrt(2.0 / (shape[0] * shape[1] * shape[2])))

    def bn(ch):
        return {"gamma": np.ones(ch, np.float32), "beta": np.zeros(ch, np.float32),
                "mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)}

    params: Dict = {"conv0": conv((3, 3, 3, f[0])), "bn0": bn(f[0]),
                    "relu0_alpha": np.full((f[0],), 0.25, np.float32)}
    in_ch = f[0]
    for s, n_units in enumerate(IRESNET_UNITS[depth], start=1):
        out_ch = f[s]
        for u in range(1, n_units + 1):
            p = {"bn1": bn(in_ch), "conv1": conv((3, 3, in_ch, out_ch)),
                 "bn2": bn(out_ch), "relu1_alpha": np.full((out_ch,), 0.25, np.float32),
                 "conv2": conv((3, 3, out_ch, out_ch)), "bn3": bn(out_ch)}
            if u == 1:
                p["conv1sc"] = conv((1, 1, in_ch, out_ch))
                p["sc"] = bn(out_ch)
            params[f"stage{s}_unit{u}"] = p
            in_ch = out_ch
    params["bn1"] = bn(in_ch)
    flat = (input_size // 16) ** 2 * in_ch   # stride 2 per stage
    params["pre_fc1"] = {"kernel": normal(generator, (flat, emb_dim), np.sqrt(1.0 / flat)),
                         "bias": np.zeros(emb_dim, np.float32)}
    params["fc1"] = bn(emb_dim)
    return params


def _npz_bn(w: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"gamma": w[f"{prefix}_gamma"], "beta": w[f"{prefix}_beta"],
            "mean": w[f"{prefix}_moving_mean"], "var": w[f"{prefix}_moving_var"]}


def _npz_conv(w: Dict[str, np.ndarray], name: str) -> np.ndarray:
    # mxnet OIHW -> HWIO
    return np.ascontiguousarray(np.transpose(w[name], (2, 3, 1, 0)))


def iresnet_params_from_npz(path: str, depth: Optional[int] = None,
                            input_size: int = 112) -> Dict:
    """Import an ArcFace/gender-age checkpoint from an .npz of flat MXNet
    param names. The per-stage unit counts come from the names (stage 4
    alone cannot tell r34/r50/r100 apart); ``depth``, when given, must
    agree. ``pre_fc1`` moves from MXNet's NCHW flatten to the NHWC one."""
    with np.load(path) as z:
        w = {k: np.asarray(z[k], np.float32) for k in z.files}
    units = []
    for s in range(1, 5):
        u = 0
        while f"stage{s}_unit{u + 1}_bn1_gamma" in w:
            u += 1
        units.append(u)
    units = tuple(units)
    if depth is not None and IRESNET_UNITS[depth] != units:
        raise ValueError(f"checkpoint has units {units}, not IResNet-{depth} "
                         f"{IRESNET_UNITS[depth]}")
    if any(u == 0 for u in units):
        raise ValueError(f"incomplete checkpoint: stage unit counts {units}")
    params: Dict = {"conv0": _npz_conv(w, "conv0_weight"), "bn0": _npz_bn(w, "bn0"),
                    "relu0_alpha": w["relu0_gamma"]}
    for s, n_units in enumerate(units, start=1):
        for u in range(1, n_units + 1):
            pre = f"stage{s}_unit{u}"
            p = {"bn1": _npz_bn(w, f"{pre}_bn1"),
                 "conv1": _npz_conv(w, f"{pre}_conv1_weight"),
                 "bn2": _npz_bn(w, f"{pre}_bn2"),
                 "relu1_alpha": w[f"{pre}_relu1_gamma"],
                 "conv2": _npz_conv(w, f"{pre}_conv2_weight"),
                 "bn3": _npz_bn(w, f"{pre}_bn3")}
            if f"{pre}_conv1sc_weight" in w:
                p["conv1sc"] = _npz_conv(w, f"{pre}_conv1sc_weight")
                p["sc"] = _npz_bn(w, f"{pre}_sc")
            params[pre] = p
    params["bn1"] = _npz_bn(w, "bn1")
    emb, flat = w["pre_fc1_weight"].shape
    ch = IRESNET_FILTERS[-1]
    spatial = input_size // 16
    if flat != ch * spatial * spatial:
        raise ValueError(f"pre_fc1 takes {flat} inputs, not {ch}x{spatial}x{spatial}")
    k = w["pre_fc1_weight"].reshape(emb, ch, spatial, spatial)
    k = np.transpose(k, (2, 3, 1, 0)).reshape(spatial * spatial * ch, emb)
    params["pre_fc1"] = {"kernel": np.ascontiguousarray(k),
                         "bias": w.get("pre_fc1_bias", np.zeros(emb, np.float32))}
    params["fc1"] = _npz_bn(w, "fc1")
    return params
