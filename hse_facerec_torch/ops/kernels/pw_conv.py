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
kernel runs every shape on the int8 tensor cores, ``wgmma`` fed by TMA:
persistent blocks of 128 or 256 rows x 64 or 128 channels
(``tile_config``), K 16 and 32 layers packed into 64-byte rows
(``pack_rows``). TMA copies rows of whole 16-byte words from 16-byte
aligned bases: every MobileNet layer has them, and for other shapes the
launch zero-pads K (zero columns add exact zeros) and copies a base off 16
bytes. ``plan`` computes the launch here, where the CPU tests reach it,
once per shape. The weight's tensor map is cached by address and shape
(``_weight_map``); the activation's is encoded per call, in the launch.
``pw_conv_int8.launches`` counts kernel launches, under a lock
(``build.count_launch``): the server's threads embed at once. The plain
version equals the jitted reference (``_pw_conv_int8`` + ``_requant`` of
``models/int8_infer.py``) and the interpret-mode Pallas kernel bit for bit;
the kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ...numerics import fma
from . import build

# the f32 constant the jitted reference multiplies by: 1 / ACT_SCALE, and
# 127 / 6, round to the same float32
INV_ACT_SCALE = float(np.float32(127.0 / 6.0))


ROW_WORD = 16   # TMA copies rows of whole 16-byte words from 16-byte aligned bases
# the tiles (BM rows: two consumer warpgroups of one or two m64 atoms; BN
# channels) and their time an output relative to 256 x 128's, each over
# whole waves, as an H100 timed them on pw7 at batch 1024 (chip_smoke.py's
# tiles_ms: the larger tiles copy fewer bytes an output into shared memory
# and keep more of them in flight)
TILES = {(256, 128): 1.0, (128, 128): 1.22, (128, 64): 2.4}


class Plan(NamedTuple):
    bm: int         # block tile rows
    bn: int         # block tile output channels
    grid: int       # persistent blocks launched: one an SM, at most one a tile
    pack: int = 1   # pixels a 64-byte row (pack_rows)


def tile_config(m: int, n: int, sms: int):
    """The block tile (BM, BN) of an (m, K) x (K, n) product on a card of
    ``sms`` SMs: of the tiles no wider than n (64 channels always
    allowed), the one whose whole waves over ``sms`` persistent blocks cost
    least, a wave costing a tile's outputs times its relative time an
    output (``TILES``); ties go to the larger tile."""
    best = None
    for (bm, bn), rel in TILES.items():
        if bn > n and bn != 64:
            continue
        waves = -(-(-(-m // bm) * -(-n // bn)) // sms)
        key = (waves * bm * bn * rel, -bm * bn)
        if best is None or key < best[0]:
            best = (key, (bm, bn))
    return best[1]


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, sms: int) -> Plan:
    """K4's launch for an (m, k) x (k, n) product, k a multiple of
    ``ROW_WORD``, on a card of ``sms`` SMs: the block tile, the grid (one
    persistent block an SM, at most one a tile) and how many pixels a
    64-byte row packs: 64 / k where k divides 64 and m, so that TMA copies
    whole 64-byte rows (pw1's 32-byte rows held its copies to half their
    bytes a row; the tile is then chosen for the packed product). Cached:
    a forward asks for the same few shapes every call."""
    pack = 64 // k if k < 64 and 64 % k == 0 and m % (64 // k) == 0 else 1
    m, n = m // pack, n * pack
    bm, bn = tile_config(m, n, sms)
    return Plan(bm, bn, min(-(-m // bm) * -(-n // bn), sms), pack)


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
def _kernels():
    lib = build.load_library()
    fn = lib.pw_conv_int8_wgmma
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pw_conv_weight_map.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.pw_conv_weight_map.restype = ctypes.c_int
    return lib, fn


# block-diagonal weights of packed layers, by id of the weight tensor while
# it lives (a tensor's == is elementwise, so it cannot key a weak dict)
_PACKED = {}


def pack_rows(w, scale, bias, pack: int):
    """The layer as a product of ``pack`` pixels a row, as the TPU kernel
    packs it: a contiguous (M, K) activation is the (M / pack, pack K)
    matrix of its pixels side by side, and its (M, N) output the (M / pack,
    pack N) one, so the block-diagonal weight (pack N, pack K) with w on
    its diagonal and scale and bias tiled pack times give the same outputs
    bit for bit (the zero blocks add exact zeros). Cached per weight tensor
    and checked against the versions of all three, so an in-place update
    packs again."""
    key = (w, pack, w._version, scale, scale._version, bias, bias._version)
    hit = _PACKED.get(id(w))
    if hit is not None and all(x is y if isinstance(x, torch.Tensor) else x == y
                               for x, y in zip((hit[0](),) + hit[1], key)):
        return hit[2]
    n, k = w.shape
    wp = torch.zeros((pack * n, pack * k), dtype=torch.int8, device=w.device)
    for i in range(pack):
        wp[i * n:(i + 1) * n, i * k:(i + 1) * k] = w
    packed = (wp, scale.repeat(pack), bias.repeat(pack))
    if id(w) not in _PACKED:
        weakref.finalize(w, _PACKED.pop, id(w), None)
    _PACKED[id(w)] = (weakref.ref(w), key[1:], packed)
    return packed


@functools.lru_cache(maxsize=1024)
def _weight_map(ptr: int, n: int, k: int, bn: int):
    """The TMA map of a weight (n, k) int8 at ``ptr`` in boxes of bn rows
    (128 bytes, encoded once). A map holds the address and the shape, no
    data, so it stays right for whatever weight lies there with that
    shape."""
    lib = _kernels()[0]
    buf = ctypes.create_string_buffer(128)
    build.check(lib, lib.pw_conv_weight_map(ptr, n, k, bn, buf), "pw_conv_weight_map")
    return buf


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


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def tma_operands(a, w):
    """``a`` (M, K) and ``w`` (N, K) as TMA can copy them: K zero-padded to
    whole 16-byte words (zero columns add exact zeros to every dot), and an
    operand whose base is off 16 bytes copied. Every MobileNet layer's
    operands come back as they are."""
    k = a.shape[1]
    if k % ROW_WORD:
        a, w = (torch.nn.functional.pad(x, (0, -k % ROW_WORD)) for x in (a, w))
    return tuple(t if t.data_ptr() % ROW_WORD == 0 else t.clone() for t in (a, w))


def pw_conv_int8(a, w, scale, bias, requant: bool = True):
    """(M, K) int8 activations x (N, K) int8 weights, per-channel f32
    ``scale``/``bias`` (N,) -> (M, N) int8 (``requant``) or f32.

    On CUDA every tensor must be contiguous on one device; any M, K and N.
    CPU tensors take ``pw_conv_int8_plain``."""
    if all(t.device.type == "cpu" for t in (a, w, scale, bias)):
        return pw_conv_int8_plain(a, w, scale, bias, requant)
    out = launch(a, w, scale, bias, requant)
    if out.shape[0]:
        build.count_launch(pw_conv_int8)
    return out


def launch(a, w, scale, bias, requant: bool = True, tile=None):
    """One K4 launch on CUDA tensors, on ``plan``'s tile or on ``tile``
    (BM, BN) where it is given (to time one tile against another), on
    ``tma_operands``. Counts nothing: ``pw_conv_int8`` does."""
    dev = _check(a, w, scale, bias)
    m, n = a.shape[0], w.shape[0]
    out = torch.empty((m, n), dtype=torch.int8 if requant else torch.float32,
                      device=dev)
    if m == 0:
        return out
    a, w = tma_operands(a, w)
    k = a.shape[1]
    sms = _sms(dev.index)
    p = plan(m, n, k, sms)
    if p.pack > 1:   # the same memory as (m / pack, pack k) -> (m / pack, pack n)
        w, scale, bias = pack_rows(w, scale, bias, p.pack)
        m, n, k = m // p.pack, n * p.pack, k * p.pack
    if tile is not None:
        bm, bn = tile
        p = p._replace(bm=bm, bn=bn, grid=min(sms, -(-m // bm) * -(-n // bn)))
    lib, fn = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(a.data_ptr(), _weight_map(w.data_ptr(), n, k, p.bn), scale.data_ptr(),
                  bias.data_ptr(), m, n, k, int(requant), p.bm, p.bn, p.grid,
                  out.data_ptr(), stream)
    build.check(lib, code, "pw_conv_int8 launch")
    return out


pw_conv_int8.launches = 0
