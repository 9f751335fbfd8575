"""Wrapper of the CUDA int8 pointwise-conv kernel K4 (``csrc/pw_conv.cu``)
and its plain PyTorch version.

Counterpart of ``hse_facerec_tf_tpu/ops/pallas/pw_conv.py``: a 1x1 conv on
an int8 channels-last activation is a (M, K) int8 x (K, N) int8 product
with exact int32 accumulation, then ``clip(fma(acc, scale, bias), 0, 6)``
(ReLU6), then either the requant to int8 at the fixed activation scale
6/127 or an f32 store (the last block). The weight lies (N, K): one row of
input-channel weights per output channel, so both operands are K-minor.

``pw_conv_int8`` routes by the device its tensors lie on: CPU tensors take
``pw_conv_int8_plain``; CUDA tensors launch the kernel or raise. The
kernel runs every shape on the int8 tensor cores; ``tile_config`` picks its
block tile and ``load_width`` its copy width, here, where the CPU tests
reach them.
``pw_conv_int8.launches`` counts kernel launches, under a lock
(``build.count_launch``): the server's threads embed at once. The plain
version equals the jitted reference (``_pw_conv_int8`` + ``_requant`` of
``models/int8_infer.py``) and the interpret-mode Pallas kernel bit for bit;
the kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...numerics import fma
from . import build

# the f32 constant the jitted reference multiplies by: 1 / ACT_SCALE, and
# 127 / 6, round to the same float32
INV_ACT_SCALE = float(np.float32(127.0 / 6.0))


# block tiles of csrc/pw_conv.cu, (rows, output channels), largest first
TILES = ((128, 128), (64, 64))


def tile_config(m: int, n: int, sms: int):
    """The block tile (BM, BN) of an (m, K) x (K, n) product on a card of
    ``sms`` streaming multiprocessors: the largest no wider than n (a wider
    one computes columns past n) that still makes a tile for each SM (a
    grid of fewer leaves some idle), else the smallest."""
    for bm, bn in TILES:
        if bn <= n and -(-m // bm) * -(-n // bn) >= sms:
            return bm, bn
    return TILES[-1]


def load_width(k: int, *ptrs: int) -> int:
    """The kernel's copy width in bytes for K = ``k`` and operands at
    addresses ``ptrs``: 16 (``cp.async`` of whole 16-byte chunks) when K
    and the addresses are multiples of 16, 4 when they are multiples of 4,
    else 1 (byte loads)."""
    for width in (16, 4):
        if k % width == 0 and all(p % width == 0 for p in ptrs):
            return width
    return 1


def requant_int8(y):
    """f32 post-ReLU6 activation -> int8 in [0, 127] at the fixed scale
    6/127: ``round(y * f32(127/6))``, halves to even, as ``jnp.round``."""
    return torch.round(y * INV_ACT_SCALE).to(torch.int8)


def int8_dot_exact(a, w):
    """(M, K) x (N, K) int8 -> (M, N) float64, exact: every product and
    partial sum is an integer below 2^53."""
    return a.to(torch.float64) @ w.to(torch.float64).T


def pw_conv_int8_plain(a, w, scale, bias, requant: bool = True):
    """K4's function in plain PyTorch, on any device: the exact dot rounded
    once to f32 (as the kernel's int32 to float), one fused multiply-add,
    ReLU6, then ``requant_int8`` or the f32 values."""
    acc = int8_dot_exact(a, w).to(torch.float32)
    y = torch.clamp(fma(acc, scale, bias), 0.0, 6.0)
    return requant_int8(y) if requant else y


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load_library()
    fn = lib.pw_conv_int8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(a, w, scale, bias):
    dev = a.device
    for t in (w, scale, bias):
        if t.device != dev:
            raise ValueError(f"pw_conv_int8: tensors on {a.device}, {w.device}, "
                             f"{scale.device}, {bias.device}; all must be on one "
                             "CUDA device or all on the CPU")
    if dev.type != "cuda":
        raise ValueError(f"pw_conv_int8 runs on CUDA or CPU tensors, not {dev}")
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"pw_conv_int8 takes int8 operands, got {a.dtype} / {w.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"scale and bias must be float32, got {scale.dtype} / {bias.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"expected (M, K) and (N, K), got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    n = w.shape[0]
    if scale.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"scale and bias must be ({n},), got {tuple(scale.shape)} "
                         f"and {tuple(bias.shape)}")
    if not all(t.is_contiguous() for t in (a, w, scale, bias)):
        raise ValueError("pw_conv_int8 takes contiguous tensors")
    if a.shape[0] >= 2 ** 31 - 64 or w.shape[1] < 1 or n < 1:
        raise ValueError(f"unsupported shape {tuple(a.shape)} x {tuple(w.shape)}")
    return dev


def pw_conv_int8(a, w, scale, bias, requant: bool = True):
    """(M, K) int8 activations x (N, K) int8 weights, per-channel f32
    ``scale``/``bias`` (N,) -> (M, N) int8 (``requant``) or f32.

    On CUDA every tensor must be contiguous on one device; any M, K and N.
    CPU tensors take ``pw_conv_int8_plain``."""
    if all(t.device.type == "cpu" for t in (a, w, scale, bias)):
        return pw_conv_int8_plain(a, w, scale, bias, requant)
    dev = _check(a, w, scale, bias)
    m, k = a.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=torch.int8 if requant else torch.float32,
                      device=dev)
    if m == 0:
        return out
    load = load_width(k, a.data_ptr(), w.data_ptr())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bm, _ = tile_config(m, n, sms)
    lib, fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(a.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  m, n, k, int(requant), load, bm, out.data_ptr(), stream)
    build.check(lib, code, "pw_conv_int8 launch")
    build.count_launch(pw_conv_int8)
    return out


pw_conv_int8.launches = 0
