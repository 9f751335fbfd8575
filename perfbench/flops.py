"""The card's peaks and the work the models and kernels need, counted from
shapes. Copied from the port's twin (``hse_facerec_torch/bench.py``:
``PEAK_OPS``, ``HBM_BYTES_PER_S``, ``bound``, ``_mobilenet_flops``) and
extended; kept here so that no change to the program moves the yardstick.

FLOPs are 2 x the multiply-adds of every conv and dense layer; elementwise
work (BN, PReLU, ReLU6, softmax) is not counted. Bytes count each input
byte read once and each output byte written once."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores,
# bf16 and int8 on them; HBM3
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float, kind: str) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take for work that moves ``nbytes`` and does ``ops`` operations of
    ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def iresnet_flops(cfg: Dict) -> float:
    """FLOPs of one IResNet forward at ``cfg``'s input size: conv0 3x3;
    per unit conv1 3x3 at the unit's input size, conv2 3x3 at its stride,
    and on a stage's first unit the 1x1 shortcut; then ``pre_fc1`` on the
    NHWC-flattened last map."""
    size = cfg["input_size"]
    widths = cfg["widths"]
    macs = size * size * 9 * 3 * widths[0]
    in_ch = widths[0]
    for stage, n_units in enumerate(cfg["units"]):
        out_ch = widths[stage + 1]
        for u in range(n_units):
            stride = 2 if u == 0 else 1
            out = size // stride
            macs += size * size * 9 * in_ch * out_ch          # conv1, stride 1
            macs += out * out * 9 * out_ch * out_ch           # conv2
            if u == 0:
                macs += out * out * in_ch * out_ch            # 1x1 shortcut
            size, in_ch = out, out_ch
    macs += size * size * in_ch * cfg["embedding_dim"]        # pre_fc1
    return 2.0 * macs


def iresnet_params(cfg: Dict) -> int:
    """Parameters of the convs, PReLUs, BNs and ``pre_fc1``."""
    widths = cfg["widths"]
    n = 9 * 3 * widths[0] + 4 * widths[0] + widths[0]
    in_ch = widths[0]
    for stage, n_units in enumerate(cfg["units"]):
        out_ch = widths[stage + 1]
        for u in range(n_units):
            n += 4 * in_ch + 9 * in_ch * out_ch + 4 * out_ch + out_ch
            n += 9 * out_ch * out_ch + 4 * out_ch
            if u == 0:
                n += in_ch * out_ch + 4 * out_ch
            in_ch = out_ch
    spatial = cfg["input_size"] // 2 ** len(cfg["units"])
    n += 4 * in_ch + spatial * spatial * in_ch * cfg["embedding_dim"]
    n += cfg["embedding_dim"] + 4 * cfg["embedding_dim"]
    return n


def same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def mobilenet_multihead_flops(cfg: Dict) -> float:
    """FLOPs of one multi-head forward at ``cfg``'s input size (SAME
    padding): conv1 3x3 s2, each block's depthwise 3x3 and pointwise 1x1,
    then the ``feats``, ``age`` and ``gender`` dense heads."""
    size = same_out(cfg["input_size"], 2)
    ch = cfg["stem_width"]
    macs = size * size * 9 * 3 * ch
    for stride, out_ch in cfg["blocks"]:
        size = same_out(size, stride)
        macs += size * size * (9 * ch + ch * out_ch)
        ch = out_ch
    feats = cfg["feats_dim"]
    macs += ch * feats + feats * cfg["age_bins"] + feats * 1
    return 2.0 * macs


def model_flops(cfg: Dict) -> float:
    """FLOPs of one face through the configuration's embedding model."""
    if cfg["model"] == "iresnet":
        return iresnet_flops(cfg)
    if cfg["model"] == "mobilenet_multihead":
        return mobilenet_multihead_flops(cfg)
    raise ValueError(f"no FLOP count for model {cfg['model']!r}")


def knn_int8_work(m: int, n: int, d: int) -> Tuple[float, float]:
    """(operations, bytes) of an int8 1-NN of ``m`` probes over ``n`` rows
    of ``d`` (rows padded to 16-byte words): the int8 gallery and its f32
    norms read once, the int8 probes read once, a distance and an index
    written per probe."""
    dp = 16 * math.ceil(d / 16)
    return 2.0 * m * n * d, float(n * dp + 4 * n + m * dp + 8 * m)


def crop_work(boxes: Sequence[Tuple[float, float, float, float]], height: int,
              width: int, channels: int, out_size: int, supersample: int,
              clamp: bool) -> Tuple[float, float]:
    """(operations, bytes) of bilinear crops of f32 images: per box, the
    source pixels its taps touch (the box's rows and columns inside the
    image, one more each way for the last tap, at most two taps a sample)
    read once, and ``out_size``² x ``channels`` f32 written. Operations:
    per output value ``supersample``² samples of 4 taps, a multiply-add
    each. ``boxes`` are [y1, x1, y2, x2] as the crop takes them."""
    nbytes = 0.0
    per_axis = 2 * supersample * out_size
    for y1, x1, y2, x2 in boxes:
        if clamp:
            y1, x1 = max(y1, 0.0), max(x1, 0.0)
            y2, x2 = min(y2, float(height)), min(x2, float(width))
        rows = max(0, min(math.ceil(y2) + 1, height) - max(math.floor(y1), 0))
        cols = max(0, min(math.ceil(x2) + 1, width) - max(math.floor(x1), 0))
        nbytes += 4.0 * channels * (min(rows, per_axis) * min(cols, per_axis)
                                    + out_size * out_size) + 16.0
    ops = 2.0 * 4 * supersample ** 2 * out_size ** 2 * channels * len(boxes)
    return ops, nbytes


def pnet_flops(hs: int, ws: int) -> float:
    """P-Net on one pyramid level of hs x ws: conv1 3x3 (3->10), 2x2 max
    pool, conv2 3x3 (10->16), conv3 3x3 (16->32), the 1x1 heads (32->2+4);
    VALID convs."""
    h1, w1 = hs - 2, ws - 2
    ph, pw = same_out(h1, 2), same_out(w1, 2)
    macs = h1 * w1 * 27 * 10 + (ph - 2) * (pw - 2) * 90 * 16
    macs += (ph - 4) * (pw - 4) * (144 * 32 + 32 * 6)
    return 2.0 * max(macs, 0)


# R-Net on a 24x24 crop and O-Net on a 48x48 crop, from their layer shapes
RNET_FLOPS = 2.0 * (22 * 22 * 27 * 28 + 9 * 9 * 252 * 48 + 3 * 3 * 192 * 64
                    + 576 * 128 + 128 * 6)
ONET_FLOPS = 2.0 * (46 * 46 * 27 * 32 + 21 * 21 * 288 * 64 + 8 * 8 * 576 * 64
                    + 3 * 3 * 256 * 128 + 1152 * 256 + 256 * 16)


def analysis_flops(counts: Dict, cfg: Dict) -> float:
    """FLOPs one photo's analysis needs, from the plain reference's counts:
    P-Net over every pyramid level, R-Net over the candidates entering
    stage 2, O-Net over those entering stage 3, the multi-head net over
    the faces."""
    return (sum(pnet_flops(h, w) for h, w in counts["levels"])
            + counts["stage2"] * RNET_FLOPS + counts["stage3"] * ONET_FLOPS
            + counts["faces"] * mobilenet_multihead_flops(cfg))
