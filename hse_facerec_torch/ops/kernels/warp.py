"""Wrapper of the CUDA warp kernel K3 (``csrc/warp.cu``) and its plain
PyTorch version.

Counterpart of ``hse_facerec_tf_tpu/ops/pallas/warp.py::warp_batch_pallas``:
a batched inverse-affine bilinear warp in the two-pass (Catmull-Smith)
factorization of ``train/augment.py::_warp_one``, with the Pallas kernel's
numerics. Per image, with the flip factored out (``warp_scalars``):

- pass A, vertical, per column ``x``: ``b = m10/m00``, ``a = m11 - b·m01``,
  ``g = m12 - b·m02``; ``base = floor(a·o + g) + floor(b·x)``,
  ``t = clip(a·o + g + b·x, 0, H-1) - base``,
  ``IA(o, x) = Σ_j hat(t - j)·bf16(img(base + j, x))``, j = 0, 1, 2;
- pass B, horizontal, per row ``y``, at ``xe = W-1-x`` for a flipped image:
  ``base2 = floor(m00·xe + m02) + floor(m01·y)``,
  ``t2 = clip(m00·xe + m02 + m01·y, 0, W-1) - base2``,
  ``out = Σ_j hat(t2 - j)·bf16(IA(y, base2 + j))``;
- ``fill`` where the sample point ``(m00·xe + m02 + m01·y,
  m10·xe + m11·y + m12)`` lies outside the image.

A tap with nonzero weight always lies inside the image (``|clip(r) -
(base + j)| < 1``), so taps outside read nothing and weigh 0; where ``t``
falls outside (-1, 3) every weight is 0 and ``IA`` is 0 (the fill covers
those pixels). Inside the jitted interpret-mode kernel XLA fuses
``m11 - b·m01``, ``m12 - b·m02``, ``a·o + g``, ``m00·xe + m02``,
``m10·xe + (m11·y)``, ``w0·s0 + (w1·s1)`` and ``acc + w2·s2`` into FMAs,
and nothing else; they are FMAs here (``numerics.fma``) and in the kernel
(``__fmaf_rn``), so the plain version equals interpret-mode
``warp_batch_pallas`` bit for bit.

``warp_batch`` routes by the device of its tensors: CPU tensors take
``warp_batch_plain``; CUDA tensors launch the kernel or raise. The kernel
takes the raw mats and computes ``warp_scalars`` itself, so a call on the
card is one launch and nothing else. ``warp_batch.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...numerics import fma
from . import build

MAX_CHANNELS = 4        # the kernel keeps one pixel's channels in registers


def warp_scalars(mats, w: int, fill: float):
    """(N, 2, 3) f32 inverse-affine mats -> (N, 11) f32 per-image scalars
    (the kernel computes the same from the raw mats), in this order: the
    flip-factored matrix ``M⁺`` (m00, m01, m02, m10, m11, m12; where
    ``m00 < 0``, M = M⁺ ∘ mirror_x, as the Pallas wrapper factors it), the
    flip flag (-1 or 1), the fill value, and pass A's ``b, a, g``."""
    mats = mats.to(torch.float32)
    neg = mats[:, 0, 0] < 0
    col0 = mats[:, :, 0]
    adj = torch.where(neg[:, None], -col0, col0)
    col2 = mats[:, :, 2] + torch.where(neg[:, None], col0 * float(w - 1),
                                       torch.zeros_like(col0))
    m00, m10 = adj[:, 0], adj[:, 1]
    m01, m11 = mats[:, 0, 1], mats[:, 1, 1]
    m02, m12 = col2[:, 0], col2[:, 1]
    b = m10 / m00
    a = fma(-b, m01, m11)
    g = fma(-b, m02, m12)
    flip = torch.where(neg, -1.0, 1.0).to(torch.float32)
    return torch.stack([m00, m01, m02, m10, m11, m12, flip,
                        torch.full_like(m00, float(fill)), b, a, g], dim=1)


def _hat(t):
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _resample(base, t, axis_len, gather):
    """``Σ_j hat(t - j)·bf16(tap_j)`` over the taps at ``base + j``, j = 0,
    1, 2, as XLA fuses the sum: ``fma(w0, s0, w1·s1)``, then
    ``fma(w2, s2, ·)``. ``gather(idx)`` reads the source at the clamped
    index; taps outside [0, axis_len) weigh 0 and read as 0."""
    terms = []
    for j in range(3):
        idx = base + j
        inside = (idx >= 0) & (idx < axis_len)
        tap = _bf16(gather(idx.clamp(0, axis_len - 1)))
        tap = torch.where(inside[..., None], tap, torch.zeros((), dtype=tap.dtype))
        terms.append((_hat(t - float(j))[..., None].expand_as(tap), tap))
    (w0, s0), (w1, s1), (w2, s2) = terms
    return fma(w2, s2, fma(w0, s0, w1 * s1))


def _scalars(scal):
    """(N, 11) -> the 11 per-image scalars, each (N, 1, 1)."""
    return scal[:, :, None, None].unbind(1)


def vertical_pass(images, scal):
    """Pass A: ``IA(o, x) = Σ_j hat(t - j)·bf16(img(base + j, x))`` for
    every output row o and input column x, (N, H, W, C) f32 (before pass
    B rounds it to bf16). 0 where ``t`` lies outside (-1, 3)."""
    n, h, w, _ = images.shape
    _, _, _, _, _, _, _, _, b, a, g = _scalars(scal)
    dev = images.device
    rows = torch.arange(h, device=dev, dtype=torch.float32)[:, None]   # (H, 1)
    cols = torch.arange(w, device=dev, dtype=torch.float32)[None, :]   # (1, W)
    r0 = fma(a, rows, g)                                               # (N, H, 1)
    bx = b * cols                                                      # (N, 1, W)
    base = torch.floor(r0).to(torch.int64) + torch.floor(bx).to(torch.int64)
    t = torch.clamp(r0 + bx, 0.0, h - 1.0) - base.to(torch.float32)
    nidx = torch.arange(n, device=dev)[:, None, None]
    xi = torch.arange(w, device=dev)[None, None, :]
    return _resample(base, t, h, lambda i: images[nidx, i, xi])


def warp_batch_plain(images, mats, fill: float = 0.0):
    """K3's function in plain PyTorch, on any device: (N, H, W, C) f32
    images, (N, 2, 3) mats -> (N, H, W, C) f32, with gathers."""
    n, h, w, _ = images.shape
    scal = warp_scalars(mats, w, fill)
    ia = vertical_pass(images, scal)
    m00, m01, m02, m10, m11, m12, flip, fillv, _, _, _ = _scalars(scal)
    dev = images.device
    rows = torch.arange(h, device=dev, dtype=torch.float32)[:, None]   # (H, 1)
    cols = torch.arange(w, device=dev, dtype=torch.float32)[None, :]   # (1, W)
    # pass B (horizontal), at mirrored columns for a flipped image
    xe = torch.where(flip < 0, (w - 1.0) - cols, cols)                 # (N, 1, W)
    c0 = fma(m00, xe, m02)
    ky = m01 * rows                                                    # (N, H, 1)
    base2 = torch.floor(c0).to(torch.int64) + torch.floor(ky).to(torch.int64)
    sx = c0 + ky
    t2 = torch.clamp(sx, 0.0, w - 1.0) - base2.to(torch.float32)
    nidx = torch.arange(n, device=dev)[:, None, None]
    yi = torch.arange(h, device=dev)[None, :, None]
    out = _resample(base2, t2, w, lambda i: ia[nidx, yi, i])

    sy = fma(m10, xe, m11 * rows) + m12
    valid = (sx >= 0) & (sx <= w - 1.0) & (sy >= 0) & (sy <= h - 1.0)
    return torch.where(valid[..., None], out, fillv[..., None])


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load_library()
    fn = lib.warp_batch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(images, mats):
    if images.device != mats.device:
        raise ValueError(f"warp_batch: images on {images.device}, mats on "
                         f"{mats.device}; both must be on one CUDA device or the CPU")
    if images.device.type != "cuda":
        raise ValueError(f"warp_batch runs on CUDA or CPU tensors, not {images.device}")
    if images.dtype != torch.float32 or mats.dtype != torch.float32:
        raise TypeError(f"warp_batch takes float32 images and mats, got "
                        f"{images.dtype} / {mats.dtype}")
    if images.dim() != 4 or mats.shape != (images.shape[0], 2, 3):
        raise ValueError(f"expected (N, H, W, C) images and (N, 2, 3) mats, got "
                         f"{tuple(images.shape)} and {tuple(mats.shape)}")
    if not (images.is_contiguous() and mats.is_contiguous()):
        raise ValueError("warp_batch takes contiguous NHWC images and mats")
    if images.numel() >= 2 ** 31 or not 1 <= images.shape[3] <= MAX_CHANNELS:
        raise ValueError(f"unsupported shape {tuple(images.shape)} (C must be "
                         f"1-{MAX_CHANNELS})")


def warp_batch(images, mats, fill: float = 0.0):
    """(N, H, W, C) f32 images + (N, 2, 3) inverse-affine mats (output ->
    input, as ``train/augment.py::sample_affine`` makes them) -> the warped
    (N, H, W, C) batch. Any H, W and C <= 4 whose row fits a block's shared
    memory (W·C up to about 57,000 floats; ``csrc/warp.cu`` refuses a wider
    one). CPU tensors take ``warp_batch_plain``."""
    if images.device.type == "cpu" and mats.device.type == "cpu":
        return warp_batch_plain(images, mats, fill)
    _check(images, mats)
    n, h, w, c = images.shape
    out = torch.empty_like(images)
    if out.numel() == 0:
        return out
    lib, fn = _kernel()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        code = fn(images.data_ptr(), mats.data_ptr(), float(fill), n, h, w, c,
                  out.data_ptr(), stream)
    build.check(lib, code, f"warp_batch launch at {tuple(images.shape)} (a block "
                "keeps a row of W·C floats and a staging row in shared memory, "
                "227 KB at most)")
    build.count_launch(warp_batch)
    return out


warp_batch.launches = 0
