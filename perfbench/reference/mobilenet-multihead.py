"""Plain reference of the multi-output MobileNet-V1 (Savchenko, PeerJ CS
5:e197, 2019; the ``age_gender_identity`` model), in float32 PyTorch.

Input: RGB face crops (N, 224, 224, 3), uint8 or float. Caffe
preprocessing: channels flipped to BGR, the ImageNet means subtracted.
Backbone (alpha 1.0, folded BN): conv1 3x3 stride 2, then 13 blocks of a
depthwise 3x3 and a pointwise 1x1, each conv + bias -> ReLU6, TensorFlow
SAME padding (the odd pixel at the bottom and right). The identity is the
global average of the last map (1024-d). Heads: ``feats`` Dense-256 ReLU,
``age`` Dense-100 softmax, ``gender`` Dense-1 sigmoid; the age is 1 + the
expectation over the two most probable bins, renormalised (ties: the
lower bin first). Weights come as the benchmark made them: HWIO convs,
(H, W, C, 1) depthwise, (in, out) dense. Nothing here imports the
program."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.common import fp32_mode, tf32

IMAGENET_MEANS_BGR = (103.939, 116.779, 123.68)


def _t(a, device):
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _same(x, k: int, stride: int):
    """TensorFlow SAME padding of an NCHW map for a k x k window."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv(x, layer, stride: int, depthwise: bool, device):
    k = _t(layer["kernel"], device)
    if depthwise:                                   # (H, W, C, 1) -> (C, 1, H, W)
        w = k.permute(2, 3, 0, 1).contiguous()
        groups = x.shape[1]
    else:                                           # HWIO -> OIHW
        w = k.permute(3, 2, 0, 1).contiguous()
        groups = 1
    y = F.conv2d(tf32(_same(x, w.shape[-1], stride)), tf32(w), stride=stride, groups=groups)
    return torch.clamp(y + _t(layer["bias"], device).reshape(1, -1, 1, 1), 0.0, 6.0)


def _dense(x, layer, device):
    return tf32(x) @ tf32(_t(layer["kernel"], device)) + _t(layer["bias"], device)


def on_device(params: Dict, device) -> Dict:
    """The weights as tensors on ``device``, in their own layouts."""
    return {k: on_device(v, device) if isinstance(v, dict) else _t(v, device)
            for k, v in params.items()}


def _backbone_identity(params: Dict, crops, strides, device):
    x = torch.as_tensor(crops, device=device).to(torch.float32)
    x = torch.flip(x, dims=(-1,)) - torch.tensor(IMAGENET_MEANS_BGR, device=device)
    h = _conv(x.permute(0, 3, 1, 2), params["backbone"]["conv1"], 2, False, device)
    for i, stride in enumerate(strides, start=1):
        h = _conv(h, params["backbone"][f"dw{i}"], stride, True, device)
        h = _conv(h, params["backbone"][f"pw{i}"], 1, False, device)
    return h.mean(dim=(2, 3))


def _strides(cfg: Dict):
    return [s for s, _ in cfg["blocks"]]


@torch.no_grad()
def embed(params: Dict, crops, device, cfg: Dict, fp32: str = "ieee",
          block: int = 256) -> torch.Tensor:
    """(N, 224, 224, 3) -> (N, 1024) identity embeddings on ``device``."""
    tp = on_device(params, device)
    with fp32_mode(fp32):
        return torch.cat([_backbone_identity(tp, crops[i:i + block], _strides(cfg), device)
                          for i in range(0, len(crops), block)])


@torch.no_grad()
def heads(params: Dict, crops, device, cfg: Dict, fp32: str = "ieee",
          block: int = 256) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 224, 224, 3) -> (age, P(male), identity) on ``device``."""
    tp = on_device(params, device)
    ages, males, idents = [], [], []
    with fp32_mode(fp32):
        for i in range(0, len(crops), block):
            ident = _backbone_identity(tp, crops[i:i + block], _strides(cfg), device)
            f = torch.relu(_dense(ident, tp["feats"], device))
            probs = torch.softmax(_dense(f, tp["age"], device), dim=-1)
            top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
            top, idx = top[:, :cfg["age_top_k"]], idx[:, :cfg["age_top_k"]]
            ages.append(1.0 + (top * idx.to(torch.float32)).sum(-1) / top.sum(-1))
            males.append(torch.sigmoid(_dense(f, tp["gender"], device))[:, 0])
            idents.append(ident)
    return torch.cat(ages), torch.cat(males), torch.cat(idents)


# -- the MTCNN cascade in front (Zhang et al., arXiv:1604.02878), as the
# reference package's detector defines it: the transposed feed (the first
# spatial axis of a net's input is the image's x), 1-indexed boxes with +1
# widths, np.fix truncation, the cv2 INTER_AREA scale pyramid rounded to
# integers, candidates in the order (score descending, index ascending),
# greedy NMS. Unbounded: every candidate that passes is kept. Divisions by
# a constant are multiplications by its float32 reciprocal and the box
# regressions one rounding of a multiply-add, as the reference package's
# jitted code computes them.


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _recip(d: float) -> float:
    return float(np.float32(1.0) / np.float32(d))


def pyramid_scales(h: int, w: int, minsize: int, factor: float):
    m = 12.0 / minsize
    minl, scales, k = min(h, w) * m, [], 0
    while minl >= 12:
        scales.append(m * factor ** k)
        minl *= factor
        k += 1
    return scales


def area_weights(src: int, dst: int) -> np.ndarray:
    """cv2 INTER_AREA as a (dst, src) float32 matrix: each output cell
    averages the source pixels over its interval [i·s, (i+1)·s), s =
    src/dst, by overlap."""
    w = np.zeros((dst, src), np.float32)
    s = src / dst
    for i in range(dst):
        lo, hi = i * s, (i + 1) * s
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), src)):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                w[i, j] = overlap / s
    return w


def crop(img, rects, out_size: int, supersample: int, clamp: bool):
    """Bilinear crops (N, out, out, C) of an (H, W, C) image by [y1, x1, y2,
    x2] rects: an (s·out)² grid of samples at half-pixel centres
    (``(i + 0.5)/(s·out)`` of the rect, less 0.5), each from its 2x2 taps,
    averaged s x s; outside the image a tap reads 0, or with ``clamp`` the
    sample is pulled to the border."""
    H, W, C = img.shape
    n_s = supersample * out_size
    idx = (torch.arange(n_s, dtype=torch.float32, device=img.device) + 0.5) * _recip(n_s)

    def weights(lo, hi, size):
        coord = _fma(idx[None, :], (hi - lo)[:, None], lo[:, None]) - 0.5
        if clamp:
            coord = torch.clamp(coord, 0.0, size - 1.0)
        j = torch.arange(size, dtype=torch.float32, device=img.device)
        hat = torch.clamp(1.0 - torch.abs(j[None, None, :] - coord[..., None]), min=0.0)
        return hat.reshape(len(lo), out_size, supersample, size).mean(dim=2)

    rects = rects.to(torch.float32)
    R = weights(rects[:, 0], rects[:, 2], H)
    Cw = weights(rects[:, 1], rects[:, 3], W)
    rows = torch.einsum("nih,hwc->niwc", tf32(R), tf32(img))
    return torch.einsum("niwc,njw->nijc", tf32(rows), tf32(Cw))


def _prelu_nc(x, alpha):
    a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, a * x)


def _cv(x, p, pad_same=False):
    w = p["kernel"].permute(3, 2, 0, 1).contiguous()
    if pad_same:
        x = _same(x, w.shape[-1], 1)
    return F.conv2d(tf32(x), tf32(w)) + p["bias"].reshape(1, -1, 1, 1)


def _pool(x, k: int, stride: int, same: bool):
    if same:
        pads = []
        for size in (x.shape[3], x.shape[2]):
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def _fc(x, p):
    return tf32(x) @ tf32(p["kernel"]) + p["bias"]


def _flat(x):
    return x.permute(0, 2, 3, 1).flatten(1)


def pnet(p, x):
    """x (N, H, W, 3) -> (reg (N, h, w, 4), P(face) (N, h, w))."""
    x = x.permute(0, 3, 1, 2)
    x = _prelu_nc(_cv(x, p["conv1"]), p["prelu1"]["alpha"])
    x = _pool(x, 2, 2, True)
    x = _prelu_nc(_cv(x, p["conv2"]), p["prelu2"]["alpha"])
    x = _prelu_nc(_cv(x, p["conv3"]), p["prelu3"]["alpha"])
    prob = torch.softmax(_cv(x, p["cls"]), dim=1)[:, 1]
    return _cv(x, p["reg"]).permute(0, 2, 3, 1), prob


def rnet(p, x):
    x = x.permute(0, 3, 1, 2)
    x = _prelu_nc(_cv(x, p["conv1"]), p["prelu1"]["alpha"])
    x = _pool(x, 3, 2, True)
    x = _prelu_nc(_cv(x, p["conv2"]), p["prelu2"]["alpha"])
    x = _pool(x, 3, 2, False)
    x = _prelu_nc(_cv(x, p["conv3"]), p["prelu3"]["alpha"])
    x = _prelu_nc(_fc(_flat(x), p["fc"]), p["prelu4"]["alpha"])
    return _fc(x, p["reg"]), torch.softmax(_fc(x, p["cls"]), dim=-1)[:, 1]


def onet(p, x):
    x = x.permute(0, 3, 1, 2)
    x = _prelu_nc(_cv(x, p["conv1"]), p["prelu1"]["alpha"])
    x = _pool(x, 3, 2, True)
    x = _prelu_nc(_cv(x, p["conv2"]), p["prelu2"]["alpha"])
    x = _pool(x, 3, 2, False)
    x = _prelu_nc(_cv(x, p["conv3"]), p["prelu3"]["alpha"])
    x = _pool(x, 2, 2, True)
    x = _prelu_nc(_cv(x, p["conv4"]), p["prelu4"]["alpha"])
    x = _prelu_nc(_fc(_flat(x), p["fc"]), p["prelu5"]["alpha"])
    return _fc(x, p["reg"]), _fc(x, p["lmk"]), torch.softmax(_fc(x, p["cls"]), dim=-1)[:, 1]


def nms(boxes, threshold: float, method: str):
    """Greedy NMS over boxes (N, 4) already in rank order: a box is kept
    unless an earlier kept box overlaps it by more than ``threshold``
    (intersection over union, or over the smaller area with "min").
    Returns the kept positions."""
    if len(boxes) == 0:
        return torch.zeros(0, dtype=torch.long, device=boxes.device)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    w = torch.clamp(torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])
                    + 1.0, min=0.0)
    h = torch.clamp(torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])
                    + 1.0, min=0.0)
    inter = w * h
    denom = (torch.minimum(area[:, None], area[None]) if method == "min"
             else area[:, None] + area[None] - inter)
    over = (inter / torch.clamp(denom, min=1e-10) > threshold).cpu().numpy()
    keep = []
    alive = np.ones(len(boxes), bool)
    for i in range(len(boxes)):
        if alive[i]:
            keep.append(i)
            alive &= ~over[i]
    return torch.as_tensor(keep, dtype=torch.long, device=boxes.device)


def _rank(scores):
    """Positions in (score descending, position ascending) order."""
    return torch.sort(-scores, stable=True).indices


def _bbreg(boxes, reg, plus_one: float):
    w = boxes[:, 2] - boxes[:, 0] + plus_one
    h = boxes[:, 3] - boxes[:, 1] + plus_one
    return torch.stack([_fma(reg[:, 0], w, boxes[:, 0]), _fma(reg[:, 1], h, boxes[:, 1]),
                        _fma(reg[:, 2], w, boxes[:, 2]), _fma(reg[:, 3], h, boxes[:, 3])], 1)


def _rerec(boxes):
    h = boxes[:, 3] - boxes[:, 1]
    w = boxes[:, 2] - boxes[:, 0]
    side = torch.maximum(w, h)
    x1 = boxes[:, 0] + w * 0.5 - side * 0.5
    y1 = boxes[:, 1] + h * 0.5 - side * 0.5
    return torch.trunc(torch.stack([x1, y1, x1 + side, y1 + side], 1))


def _rect(boxes):
    """1-indexed [x1, y1, x2, y2] -> the crop's 0-indexed half-open [y1,
    x1, y2, x2]."""
    return torch.stack([boxes[:, 1] - 1.0, boxes[:, 0] - 1.0, boxes[:, 3], boxes[:, 2]], 1)


def net_input(img, rects, size: int, supersample: int):
    """A net's input: the zero-padded crops of [y1, x1, y2, x2] rects,
    normalised, transposed."""
    x = crop(img, rects, size, supersample, clamp=False)
    return ((x - 127.5) * 0.0078125).permute(0, 2, 1, 3)


def pnet_maps(mt: Dict, img, det: Dict):
    """(scale, level size, reg (gx, gy, 4), P(face) (gx, gy)) for each
    pyramid level of an (H, W, 3) float32 image: the level cv2-area
    resized, rounded to integers, normalised, fed transposed."""
    h, w = img.shape[:2]
    for scale in pyramid_scales(h, w, det["minsize"], det["factor"]):
        hs, ws = int(np.ceil(h * scale)), int(np.ceil(w * scale))
        wr = torch.from_numpy(area_weights(h, hs)).to(img.device)
        wc = torch.from_numpy(area_weights(w, ws)).to(img.device)
        level = torch.einsum("oh,hwc->owc", tf32(wr), tf32(img))
        level = torch.einsum("pw,owc->opc", tf32(wc), tf32(level))
        level = (torch.clamp(torch.round(level), 0.0, 255.0) - 127.5) * 0.0078125
        reg, prob = pnet(mt["pnet"], level.transpose(0, 1)[None])
        yield scale, (hs, ws), reg[0], prob[0]


def detect(mt: Dict, img, det: Dict):
    """The cascade on one image (H, W, 3) float32 on its device: (boxes (n,
    4) [x1, y1, x2, y2], scores (n,), landmarks (n, 10)) of the final
    faces in rank order, and the counts the benchmark's work figures read:
    the pyramid levels' sizes and the candidates entering stages 2 and 3."""
    th1, th2, th3 = det["thresholds"]
    dev = img.device
    counts = {"levels": [], "stage2": 0, "stage3": 0,
              "stage2_rects": np.zeros((0, 4), np.float32),
              "stage3_rects": np.zeros((0, 4), np.float32)}
    cand_b, cand_s, cand_r = [], [], []
    for scale, size, reg, prob in pnet_maps(mt, img, det):
        counts["levels"].append(size)
        gy = prob.shape[1]
        flat = prob.reshape(-1)
        above = torch.nonzero(flat >= th1)[:, 0]
        if len(above) == 0:
            continue
        if len(above) == 1:                               # the reference's flipud quirk
            reg = torch.flip(reg, dims=(0,))
        order = above[_rank(flat[above])]
        ii, jj = (order // gy).to(torch.float32), (order % gy).to(torch.float32)
        r = _recip(scale)
        boxes = torch.trunc(torch.stack([(2.0 * ii + 1.0) * r, (2.0 * jj + 1.0) * r,
                                         (2.0 * ii + 12.0) * r, (2.0 * jj + 12.0) * r], 1))
        keep = nms(boxes, 0.5, "union")
        cand_b.append(boxes[keep])
        cand_s.append(flat[order][keep])
        cand_r.append(reg.reshape(-1, 4)[order][keep])
    empty = (torch.zeros((0, 4), device=dev), torch.zeros(0, device=dev),
             torch.zeros((0, 10), device=dev))
    if not cand_b:
        return (*empty, counts)
    boxes, scores, regs = torch.cat(cand_b), torch.cat(cand_s), torch.cat(cand_r)
    order = _rank(scores)
    boxes, scores, regs = boxes[order], scores[order], regs[order]
    keep = nms(boxes, 0.7, "union")
    boxes = _rerec(_bbreg(boxes[keep], regs[keep], 0.0))
    counts["stage2"] = len(boxes)
    counts["stage2_rects"] = _rect(boxes).cpu().numpy()
    reg, prob = rnet(mt["rnet"], net_input(img, _rect(boxes), 24, det["supersample"]))
    ok = prob > th2
    boxes, scores, reg = boxes[ok], prob[ok], reg[ok]
    order = _rank(scores)
    boxes, scores, reg = boxes[order], scores[order], reg[order]
    keep = nms(boxes, 0.7, "union")
    boxes = _rerec(_bbreg(boxes[keep], reg[keep], 1.0))
    counts["stage3"] = len(boxes)
    counts["stage3_rects"] = _rect(boxes).cpu().numpy()
    if len(boxes) == 0:
        return (*empty, counts)
    reg, lmk, prob = onet(mt["onet"], net_input(img, _rect(boxes), 48, det["supersample"]))
    ok = prob > th3
    boxes, scores, reg, lmk = boxes[ok], prob[ok], reg[ok], lmk[ok]
    bw = boxes[:, 2] - boxes[:, 0] + 1.0
    bh = boxes[:, 3] - boxes[:, 1] + 1.0
    points = torch.cat([_fma(bw[:, None], lmk[:, 0:5], boxes[:, 0:1]) - 1.0,
                        _fma(bh[:, None], lmk[:, 5:10], boxes[:, 1:2]) - 1.0], 1)
    boxes = _bbreg(boxes, reg, 1.0)
    order = _rank(scores)
    keep = order[nms(boxes[order], 0.7, "min")]
    keep = torch.sort(keep).values                        # back in stage-3 slot order
    return boxes[keep], scores[keep], points[keep], counts


@torch.no_grad()
def analyze(mtcnn_params: Dict, params: Dict, photo: np.ndarray, device, cfg: Dict,
            fp32: str = "ieee") -> Dict:
    """One RGB photo (H, W, 3) uint8 -> the faces: {"boxes" (n, 4) raw,
    "scores", "landmarks", "dilated" (n, 4) ints, "ages", "male",
    "identity" (n, 1024)} as host arrays, and the cascade's counts. Boxes
    of zero area are left out; each face is dilated by ``bbox_dilation``
    (floor of the raw box), clipped to the photo, cropped at ``face_size``
    with one bilinear sample a pixel (border replicated) and run through
    the heads."""
    det = cfg["detector"]
    tm = on_device(mtcnn_params, device)
    with fp32_mode(fp32):
        img = torch.as_tensor(photo, device=device).to(torch.float32)
        h, w = img.shape[:2]
        boxes, scores, points, counts = detect(tm, img, det)
        area = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, scores, points = boxes[area], scores[area], points[area]
        d = float(det["bbox_dilation"])
        x1, y1 = torch.floor(boxes[:, 0]) - d, torch.floor(boxes[:, 1]) - d
        x2, y2 = torch.floor(boxes[:, 2]) + d, torch.floor(boxes[:, 3]) + d
        lim = torch.tensor([h, w, h, w], dtype=torch.float32, device=device)
        rects = torch.minimum(torch.clamp(torch.stack([y1, x1, y2, x2], 1), min=0.0), lim)
        dilated = torch.stack([torch.clamp(x1, 0, w), torch.clamp(y1, 0, h),
                               torch.clamp(x2, 0, w), torch.clamp(y2, 0, h)], 1)
    if len(boxes):
        crops = crop(img, rects, det["face_size"], 1, clamp=True)
        ages, male, ident = heads(params, crops, device, cfg, fp32)
    else:
        ages = male = torch.zeros(0, device=device)
        ident = torch.zeros((0, cfg["identity_dim"]), device=device)
    counts["faces"] = len(boxes)
    host = lambda t: t.detach().cpu().numpy()
    return {"boxes": host(boxes), "scores": host(scores), "landmarks": host(points),
            "dilated": host(dilated).astype(np.int64), "ages": host(ages),
            "male": host(male), "identity": host(ident), "counts": counts}
