"""Resize ops: the generic separable resize with cv2/PIL semantics (the
embedder's input path), the cv2 INTER_AREA scale pyramid and the per-box
bilinear crop+resize.

Counterpart of ``hse_facerec_tf_tpu/ops/resize.py``. Each 1-D resampling is
a small weight matrix, built in numpy (copied from the reference, whose
module imports jax), applied as a matmul.
``crop_resize_bilinear`` and its batch forms ``crop_resize_bilinear_batch``
(one image per lane) and ``crop_resize_bilinear_lanes`` (a lane index per
box) are the plain PyTorch version of the CUDA crop kernel
(``ops/kernels/crop.py``): the CPU path and the kernel's oracle.
Every matmul form takes the reference's ``precision`` tier (``numerics``),
"highest" by default, as there.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..numerics import div_const, fma, precision_scope


@functools.lru_cache(maxsize=256)
def _linear_weights_cv2(src: int, dst: int) -> np.ndarray:
    """cv2.INTER_LINEAR 1-D weights: half-pixel centers, edge clamp."""
    w = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for i in range(dst):
        f = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(f))
        a = f - i0
        i0c = min(max(i0, 0), src - 1)
        i1c = min(max(i0 + 1, 0), src - 1)
        w[i, i0c] += 1.0 - a
        w[i, i1c] += a
    return w


@functools.lru_cache(maxsize=256)
def _area_weights_cv2(src: int, dst: int) -> np.ndarray:
    """cv2.INTER_AREA 1-D weights: pixel-area overlap averaging.

    Each target cell i covers source interval [i*s, (i+1)*s), s = src/dst;
    source pixels contribute proportionally to their overlap. For upscale
    (s < 1) this degenerates to nearest — same as cv2's area path."""
    w = np.zeros((dst, src), dtype=np.float32)
    s = src / dst
    for i in range(dst):
        lo = i * s
        hi = (i + 1) * s
        j0 = int(np.floor(lo))
        j1 = min(int(np.ceil(hi)), src)
        for j in range(j0, j1):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                w[i, j] = overlap / s
    return w


@functools.lru_cache(maxsize=256)
def _triangle_weights_pil(src: int, dst: int) -> np.ndarray:
    """PIL (Pillow >= 2.7) BILINEAR 1-D weights: triangle filter with support
    scaled by the downscale factor, weights normalized. Matches
    ``scipy.misc.imresize(interp='bilinear')`` which wraps PIL."""
    w = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    for i in range(dst):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src)
        xs = np.arange(xmin, xmax)
        dist = (xs + 0.5 - center) / filterscale
        k = np.clip(1.0 - np.abs(dist), 0.0, None)
        tot = k.sum()
        if tot > 0:
            w[i, xmin:xmax] = k / tot
    return w


@functools.lru_cache(maxsize=256)
def _cubic_weights_cv2(src: int, dst: int) -> np.ndarray:
    """cv2.INTER_CUBIC 1-D weights: 4-tap cubic convolution (a = -0.75),
    half-pixel centers, edge clamp (reference InsightFace letterbox,
    ``age_gender_identity/insightface.py:89``)."""
    a = -0.75

    def k(x):
        x = abs(x)
        if x <= 1.0:
            return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
        if x < 2.0:
            return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
        return 0.0

    w = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for i in range(dst):
        f = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(f))
        for j in range(i0 - 1, i0 + 3):
            jc = min(max(j, 0), src - 1)
            w[i, jc] += k(f - j)
    return w


@functools.lru_cache(maxsize=256)
def _nearest_weights_pil(src: int, dst: int) -> np.ndarray:
    """PIL NEAREST 1-D selection matrix: source index = floor((i+0.5)*scale)
    (Keras ``image.load_img`` default, ``facerec_test.py:141-144``)."""
    w = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for i in range(dst):
        j = min(int((i + 0.5) * scale), src - 1)
        w[i, j] = 1.0
    return w


_WEIGHT_FNS = {
    "cv2_linear": _linear_weights_cv2,
    "cv2_area": _area_weights_cv2,
    "pil_bilinear": _triangle_weights_pil,
    "pil_nearest": _nearest_weights_pil,
    "cv2_cubic": _cubic_weights_cv2,
}


def resize(img, out_hw: Tuple[int, int], method: str = "cv2_linear",
           precision="highest"):
    """Resize (..., H, W, C) to (..., out_h, out_w, C) with the given
    semantics ('cv2_linear' | 'cv2_area' | 'pil_bilinear' | 'pil_nearest' |
    'cv2_cubic'): rows, then columns, each one matmul."""
    h, w = img.shape[-3], img.shape[-2]
    oh, ow = out_hw
    wfn = _WEIGHT_FNS[method]
    mh = torch.from_numpy(wfn(h, oh)).to(img.device)
    mw = torch.from_numpy(wfn(w, ow)).to(img.device)
    with precision_scope(precision):
        x = torch.einsum("oh,...hwc->...owc", mh, img.to(torch.float32))
        return torch.einsum("pw,...owc->...opc", mw, x)


@functools.lru_cache(maxsize=256)
def _taps(method: str, src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """The nonzero entries of a 1-D weight matrix, row by row in source
    order: (dst, T) source indices and (dst, T) weights, padded with
    weight 0 at index 0."""
    w = _WEIGHT_FNS[method](src, dst)
    n = np.count_nonzero(w, axis=1)
    idx = np.zeros((dst, max(1, int(n.max()))), np.intp)
    val = np.zeros(idx.shape, np.float32)
    for i in range(dst):
        cols = np.nonzero(w[i])[0]
        idx[i, :len(cols)] = cols
        val[i, :len(cols)] = w[i, cols]
    return idx, val


def resize_host(img: np.ndarray, out_hw: Tuple[int, int],
                method: str = "cv2_linear") -> np.ndarray:
    """Host-side (numpy) resize with the same 1-D weight matrices as
    ``resize``, for collapsing mixed-size datasets onto one input size and
    for the album's 224² output crops and downscales.
    Accepts (..., H, W, C); returns float32 (..., out_h, out_w, C).
    Each pass sums only the nonzero taps of its weight matrix, in source
    order, so the result equals the dense ``einsum`` of the JAX package's
    ``resize_host`` bit for bit (the zeros it adds are exact) at a cost that
    grows with the output, not with output x input."""
    h, w = img.shape[-3], img.shape[-2]
    oh, ow = out_hw
    x = np.asarray(img, np.float32)
    idx, val = _taps(method, h, oh)
    acc = val[:, 0, None, None] * x[..., idx[:, 0], :, :]
    for t in range(1, idx.shape[1]):
        acc += val[:, t, None, None] * x[..., idx[:, t], :, :]
    idx, val = _taps(method, w, ow)
    out = val[:, 0, None] * acc[..., idx[:, 0], :]
    for t in range(1, idx.shape[1]):
        out += val[:, t, None] * acc[..., idx[:, t], :]
    return np.ascontiguousarray(out, dtype=np.float32)


# cv2's INTER_LINEAR on uint8 works in fixed point: INTER_RESIZE_COEF_BITS 11
_COEF_SCALE = 1 << 11


def _linear_taps_u8(src: int, dst: int):
    """cv2 INTER_LINEAR taps for uint8: per output index the source index
    and the two short weights (a float32 fraction times 2048, rounded half
    to even), with cv2's edge rules (a tap left of 0 or at the last pixel
    takes all the weight)."""
    scale = src / dst
    fx = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    low = sx < 0
    fx[low], sx[low] = 0.0, 0
    high = sx >= src - 1
    fx[high], sx[high] = 0.0, src - 1
    a1 = np.rint(fx * np.float32(_COEF_SCALE)).astype(np.int64)
    a0 = np.rint((np.float32(1.0) - fx) * np.float32(_COEF_SCALE)).astype(np.int64)
    return sx, a0, a1


def resize_linear_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h))`` (INTER_LINEAR) of an (H, W) or
    (H, W, C) uint8 image, bit for bit, in cv2's fixed-point arithmetic
    without cv2: rows of int sums of source x weight, then the vertical
    pass ``((b0·(S0 >> 4)) >> 16) + ((b1·(S1 >> 4)) >> 16) + 2) >> 2``,
    the form its scalar and vector paths share. At an exact 2x downscale
    cv2 switches to its area path, ``(a + b + c + d + 2) >> 2`` over each
    2x2 block; with all four weights at 1024 this form computes the same."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img.copy()
    x = img.astype(np.int64)
    chan = (None,) * (x.ndim - 2)           # the weights broadcast over channels
    sx, a0, a1 = _linear_taps_u8(w, ow)
    rows = (x[:, sx] * a0[(slice(None), *chan)]
            + x[:, np.minimum(sx + 1, w - 1)] * a1[(slice(None), *chan)])  # (h, ow, ...)
    scale = h / oh
    fy = ((np.arange(oh) + 0.5) * scale - 0.5).astype(np.float32)
    sy = np.floor(fy).astype(np.int64)
    fy = fy - sy.astype(np.float32)
    b0 = np.rint((np.float32(1.0) - fy) * np.float32(_COEF_SCALE)).astype(np.int64)
    b1 = np.rint(fy * np.float32(_COEF_SCALE)).astype(np.int64)
    s0 = rows[np.clip(sy, 0, h - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, h - 1)] >> 4
    col = (slice(None), None, *chan)
    out = (((b0[col] * s0) >> 16) + ((b1[col] * s1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_pyramid(img, out_hws: Sequence[Tuple[int, int]],
                   method: str = "cv2_area", precision="highest") -> List[torch.Tensor]:
    """``[resize(img, hw, method) for hw in out_hws]`` of (..., H, W, C)
    images (cv2 INTER_AREA by default, the MTCNN scale pyramid): the row
    passes of all levels stack into one (Σoh, H) matmul, the column passes
    run per level."""
    h, w, c = img.shape[-3:]
    lead = img.shape[:-3]
    dev = img.device
    wfn = _WEIGHT_FNS[method]
    stacked = torch.from_numpy(
        np.concatenate([wfn(h, oh) for oh, _ in out_hws])).to(dev)
    x = img.to(torch.float32)
    outs = []
    with precision_scope(precision):
        rows = (stacked @ x.reshape(*lead, h, w * c)).reshape(*lead, -1, w, c)
        off = 0
        for oh, ow in out_hws:
            mw = torch.from_numpy(wfn(w, ow)).to(dev)
            outs.append(torch.einsum("pw,...owc->...opc", mw,
                                     rows[..., off:off + oh, :, :]))
            off += oh
    return outs


def _hat_weights(coord, size: int, clamp: bool):
    """w[n, i, j] = max(0, 1 - |j - coord[n, i]|): the two bilinear taps per
    sample. ``clamp`` pulls coords into [0, size-1] first (border
    replicate); without it out-of-range samples weigh zero everywhere (the
    reference's black crop buffers)."""
    if clamp:
        coord = torch.clamp(coord, 0.0, size - 1.0)
    j = torch.arange(size, dtype=torch.float32, device=coord.device)
    return torch.clamp(1.0 - torch.abs(j[None, None, :] - coord[..., None]),
                       min=0.0)


def _crop_weights(boxes, H: int, W: int, out_size: int, supersample: int,
                  outside: str):
    """Per-box row/column hat-weight matrices ((N, out, H), (N, out, W))."""
    s = supersample * out_size
    boxes = boxes.to(torch.float32)
    y1, x1, y2, x2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    idx = div_const(torch.arange(s, dtype=torch.float32, device=boxes.device)
                    + 0.5, s)
    ys = fma(idx[None, :], (y2 - y1)[:, None], y1[:, None]) - 0.5  # (N, s)
    xs = fma(idx[None, :], (x2 - x1)[:, None], x1[:, None]) - 0.5
    clamp = outside == "clamp"
    R = _hat_weights(ys, H, clamp)                                # (N, s, H)
    C = _hat_weights(xs, W, clamp)                                # (N, s, W)
    if supersample > 1:
        # fold the s×s box filter into the weight matrices
        R = R.reshape(R.shape[0], out_size, supersample, H).mean(dim=2)
        C = C.reshape(C.shape[0], out_size, supersample, W).mean(dim=2)
    return R, C


def crop_resize_bilinear(img, boxes, out_size: int, supersample: int = 2,
                         outside: str = "clamp", precision="highest"):
    """Batched crop + resize with supersampled bilinear sampling.

    img: (H, W, C) float32; boxes: (N, 4) [y1, x1, y2, x2] pixel coords.
    Returns (N, out_size, out_size, C). The (s·out)² bilinear sample grid
    (cv2 half-pixel convention) is averaged s×s, approximating INTER_AREA.
    ``outside``: 'clamp' replicates border pixels; 'zero' reads
    out-of-image pixels as black."""
    img = img.to(torch.float32)
    H, W, C = img.shape
    R, Cw = _crop_weights(boxes, H, W, out_size, supersample, outside)
    with precision_scope(precision):
        rows = (R @ img.reshape(H, W * C)).reshape(R.shape[0], out_size, W, C)
        return torch.einsum("niwc,njw->nijc", rows, Cw)


def crop_resize_bilinear_batch(images, boxes, out_size: int,
                               supersample: int = 2, outside: str = "zero"):
    """``crop_resize_bilinear`` for each lane of a batch, the vmapped form:
    images (L, H, W, C), boxes (L, K, 4) [y1, x1, y2, x2], lane l's boxes
    cropping from image l -> (L, K, out_size, out_size, C)."""
    images = images.to(torch.float32)
    L, H, W, C = images.shape
    K = boxes.shape[1]
    R, Cw = _crop_weights(boxes.reshape(L * K, 4), H, W, out_size, supersample,
                          outside)
    with precision_scope("highest"):
        rows = torch.matmul(R.reshape(L, K * out_size, H), images.reshape(L, H, W * C))
        rows = rows.reshape(L * K, out_size, W, C)
        out = torch.einsum("niwc,njw->nijc", rows, Cw)
    return out.reshape(L, K, out_size, out_size, C)


def crop_resize_bilinear_lanes(images, lanes, boxes, out_size: int,
                               supersample: int = 1, outside: str = "clamp",
                               precision="highest"):
    """``crop_resize_bilinear`` where each box crops from its own image of a
    batch: images (L, H, W, C), lanes (N,) integer image index per box,
    boxes (N, 4) [y1, x1, y2, x2] -> (N, out_size, out_size, C). What lets
    the batch analyzer compact boxes across lanes before the head crops."""
    images = images.to(torch.float32)
    R, Cw = _crop_weights(boxes, images.shape[1], images.shape[2], out_size,
                          supersample, outside)
    per_box = images[lanes.long()]                                # (N, H, W, C)
    with precision_scope(precision):
        rows = torch.einsum("nih,nhwc->niwc", R, per_box)
        return torch.einsum("niwc,njw->nijc", rows, Cw)
