"""Wrapper of the fused BN/PReLU/residual kernel K6 (``csrc/bn_act.cu``)
and its plain PyTorch version.

K6 has no TPU counterpart: it came with IResNet's trunk on the card
(``models/arcface.py``). One launch takes a conv output ``x`` (N, C, H, W)
float32 through an inference BatchNorm, then either a PReLU or a residual
add (the residual as it is or through a BN of its own), and writes the
result and, on request, a second BN of it: the next unit's ``bn1``. Each
step rounds as the eager composition does, so the outputs are the eager
passes' bits. ``bn_scale`` and ``bn_plain`` are the one definition of the
BN's arithmetic: ``arcface._bn`` is ``bn_plain``, and K6 takes
``bn_scale``'s channel vectors.

``bn_act`` runs CUDA tensors only and raises on anything else, and where
autograd would record it: the eager passes stay the CPU's path. ``bn_act_plain`` computes the same function
with torch's own passes, on any device. ``bn_act.launches`` counts kernel
launches.

K7, in the same source, came with MobileNet-V1's folded layers on a card
(``models/mobilenet.py``) and has no TPU counterpart either: XLA fuses the
bias and the clip into the convs. ``bias_relu6`` takes a folded conv's
bias-free output through its bias and ReLU6 in one pass, and writes it, on
request, into the next conv's zero edge: the buffer ``F.pad`` would make
for a 3x3 stride-2 conv on an even size. ``bias_relu6_plain`` is torch's
own add, clamp and ``F.pad``, the eager layer's bits; ``bias_relu6`` takes
what ``bn_act`` takes and raises where it does, and counts its launches in
``bias_relu6.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import build

BN_EPS = 2e-5  # mxnet's BatchNorm eps, IResNet's (``models/arcface.py``)


def bn_scale(p: Dict):
    """A BN's per-channel ``gamma · rsqrt(var + eps)``."""
    return p["gamma"] * torch.rsqrt(p["var"] + BN_EPS)


def bn_plain(x, p: Dict):
    """An inference BatchNorm over axis 1 in torch's own passes: ``(x -
    mean) · scale + beta``, IResNet's eager ``_bn``."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - p["mean"].reshape(shape)) * bn_scale(p).reshape(shape)
            + p["beta"].reshape(shape))


def bn_act_plain(x, bn: Dict, *, alpha=None, residual=None,
                 residual_bn: Optional[Dict] = None, next_bn: Optional[Dict] = None):
    """K6's function in torch's own passes: ``y = bn(x)``, then
    ``where(y >= 0, y, y·alpha)`` if ``alpha`` is given, then ``y +
    residual_bn(residual)`` (or ``y + residual``) if ``residual`` is given.
    Returns ``y``, or ``(y, next_bn(y))`` when ``next_bn`` is given."""
    y = bn_plain(x, bn)
    if alpha is not None:
        y = torch.where(y >= 0, y, y * alpha.reshape(1, -1, 1, 1))
    if residual is not None:
        y = y + (residual if residual_bn is None else bn_plain(residual, residual_bn))
    return y if next_bn is None else (y, bn_plain(y, next_bn))


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load_library()
    fn = lib.k6_bn_act
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _layout(x) -> bool:
    """True for channels-last, False for contiguous NCHW; raises on any
    other tensor K6 does not take."""
    if x.dtype != torch.float32:
        raise TypeError(f"bn_act takes float32 tensors, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"bn_act takes (N, C, H, W) tensors, got {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("bn_act takes tensors on a 16-byte boundary")
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    if x.is_contiguous():
        return False
    raise ValueError(f"bn_act takes contiguous or channels-last tensors, got strides "
                     f"{x.stride()}")


def _vec(v, x, what: str, kernel: str = "bn_act"):
    if v.dtype != torch.float32 or v.shape != (x.shape[1],) or v.device != x.device:
        raise ValueError(f"{kernel}: {what} must be ({x.shape[1]},) float32 on {x.device}, "
                         f"got {tuple(v.shape)} {v.dtype} on {v.device}")
    return v.contiguous()


def _bn_args(p: Optional[Dict], x, what: str):
    if p is None:
        return [None, None, None]
    return [_vec(p["mean"], x, f"{what} mean"), _vec(bn_scale(p), x, f"{what} scale"),
            _vec(p["beta"], x, f"{what} beta")]


def bn_act(x, bn: Dict, *, alpha=None, residual=None,
           residual_bn: Optional[Dict] = None, next_bn: Optional[Dict] = None):
    """``bn_act_plain``'s function in one K6 launch, for the passes of
    IResNet's trunk: ``alpha`` with or without ``next_bn``, or
    ``residual`` (with or without ``residual_bn``) with ``next_bn``. ``x``
    (N, C, H, W) float32 on a card, contiguous or channels-last on a
    16-byte boundary, ``residual`` with the same shape and strides; each BN
    a dict of ``gamma``, ``beta``, ``mean`` and ``var`` (C,). The outputs
    take ``x``'s layout. Returns ``y``, or ``(y, next_bn(y))``. K6 has no
    backward: it raises where autograd would record the call."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, alpha, residual, *(v for p in (bn, residual_bn, next_bn)
                                            if p is not None for v in p.values()))):
        raise RuntimeError("bn_act (K6) has no backward: call it, and IResNet's forward on "
                           "a card, under torch.no_grad() or with tensors that need no grad")
    channels_last = _layout(x)
    if residual is not None:
        _layout(residual)
        if residual.shape != x.shape or residual.stride() != x.stride():
            raise ValueError(f"bn_act: residual {tuple(residual.shape)} strides "
                             f"{residual.stride()} differs from x {tuple(x.shape)} "
                             f"strides {x.stride()}")
    if (alpha is None) == (residual is None) or (residual is not None and next_bn is None) \
            or (residual_bn is not None and residual is None):
        raise ValueError("bn_act takes IResNet's passes: alpha, or a residual (with or "
                         "without residual_bn) and next_bn")
    if x.device.type != "cuda" or (residual is not None and residual.device != x.device):
        raise ValueError(f"bn_act runs on CUDA tensors, not {x.device}")
    vecs = (_bn_args(bn, x, "bn")
            + [None if alpha is None else _vec(alpha, x, "alpha")]
            + _bn_args(residual_bn, x, "residual_bn")
            + _bn_args(next_bn, x, "next_bn"))
    out = torch.empty_like(x)
    out2 = None if next_bn is None else torch.empty_like(x)
    if x.numel():
        def ptr(t):
            return None if t is None else t.data_ptr()

        lib, fn = _kernel()
        n, c = x.numel(), x.shape[1]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = fn(ptr(x), *map(ptr, vecs[:4]), ptr(residual), *map(ptr, vecs[4:]),
                      ptr(out), ptr(out2), n, c, x.shape[2] * x.shape[3],
                      int(channels_last), stream)
        build.check(lib, code, f"bn_act launch at {tuple(x.shape)}")
        build.count_launch(bn_act)
    return out if next_bn is None else (out, out2)


bn_act.launches = 0


def bias_relu6_plain(y, bias, *, pad_next: bool = False):
    """K7's function in torch's own passes: ``clamp(y + bias, 0, 6)``, the
    eager folded layer's bias add (cuDNN's conv adds none) and ReLU6, then,
    with ``pad_next``, ``F.pad`` of one zero row at the bottom and one
    zero column at the right."""
    out = torch.clamp(y + bias.reshape(1, -1, 1, 1), 0.0, 6.0)
    return F.pad(out, (0, 1, 0, 1)) if pad_next else out


@functools.lru_cache(maxsize=None)
def _kernel7():
    lib = build.load_library()
    fn = lib.k7_bias_relu6
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def bias_relu6(y, bias, *, pad_next: bool = False):
    """``bias_relu6_plain``'s function in one K7 launch. ``y`` (N, C, H, W)
    float32 on a card, channels-last on a 16-byte boundary, C a multiple of
    4; ``bias`` (C,) float32 on the same card. Returns a new channels-last
    tensor: (N, C, H, W), or with ``pad_next`` (N, C, H+1, W+1) with its
    last row and column zero, the strides ``F.pad`` gives. K7 has no
    backward: it raises where autograd would record the call."""
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        raise RuntimeError("bias_relu6 (K7) has no backward: call it, and MobileNet's folded "
                           "forward on a card, under torch.no_grad() or with tensors that "
                           "need no grad")
    if y.dtype != torch.float32:
        raise TypeError(f"bias_relu6 takes float32 tensors, got {y.dtype}")
    if y.dim() != 4 or y.shape[1] % 4:
        raise ValueError(f"bias_relu6 takes (N, C, H, W) tensors with C a multiple of 4, "
                         f"got {tuple(y.shape)}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"bias_relu6 takes channels-last tensors, got strides {y.stride()}")
    if y.data_ptr() % 16:
        raise ValueError("bias_relu6 takes tensors on a 16-byte boundary")
    bias = _vec(bias, y, "bias", "bias_relu6")
    if y.device.type != "cuda":
        raise ValueError(f"bias_relu6 runs on CUDA tensors, not {y.device}")
    n, c, h, w = y.shape
    edge = int(bool(pad_next))
    out = torch.empty((n, c, h + edge, w + edge), dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last)
    if y.numel():
        lib, fn = _kernel7()
        with torch.cuda.device(y.device):
            stream = torch.cuda.current_stream(y.device).cuda_stream
            code = fn(y.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c, h, w, edge, stream)
        build.check(lib, code, f"bias_relu6 launch at {tuple(y.shape)}")
        build.count_launch(bias_relu6)
    return out


bias_relu6.launches = 0
