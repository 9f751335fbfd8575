"""Wrappers of the CUDA attention kernels K5 and K8 (``csrc/attention.cu``)
and their plain PyTorch versions.

K5 has no TPU counterpart: it came with the ViT face embedder
(``models/vit.py``). It takes the qkv GEMM's output as it lies, (B, T, 3·H·D)
float32 (a token's q, k and v, each H heads of D), and returns each head's
``softmax(q·kᵀ · D^-½)·v`` as (B, T, H·D): heads side by side in a token's
row, the layout the output projection reads. Products and sums are IEEE
float32 at every tier (no TF32, no tensor cores), and the softmax subtracts
each row's max, as ``attention_plain`` computes it.

``attention`` routes by the tensor's device: CPU tensors take
``attention_plain``; CUDA tensors launch the kernel or raise.
``attention.launches`` counts kernel launches.

K8 came with the Swin-T face embedder (``models/swin.py``):
``window_attention`` takes the qkv GEMM's output on the token map as it
lies, (B, R, R, 3·H·32) float32, and returns (B, R, R, H·32) in the map's
own token order: per 7 x 7 window of the map rolled by ``-shift`` and per
head, ``softmax((q · D^-½)·kᵀ + bias (+ mask))·v``, with the (H, 49, 49)
relative-position bias and, where ``shift > 0``, -100 between tokens of
different regions of the rolled map. ``window_attention_plain`` computes it
in the source's order (roll, partition, bias, mask, softmax, reverse, roll
back) and is what CPU tensors take. ``window_attention.launches`` counts
launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

HEAD_DIM = 96      # the kernel's one instantiation, ViT-L's
MAX_TOKENS = 144   # four lanes a row pair, 288 threads a block


def default_scale(head_dim: int) -> float:
    """``head_dim ** -0.5`` rounded to float32, as a float32 tensor times
    the Python float takes it."""
    return float(np.float32(head_dim ** -0.5))


def attention_plain(qkv, num_heads: int):
    """K5's function in plain PyTorch, on any device: q, k and v of each
    head from the (B, T, 3, H, D) view, ``softmax((q @ kᵀ) · D^-½) @ v``
    over the keys, the heads concatenated per token -> (B, T, H·D)."""
    b, t, width = qkv.shape
    d = width // (3 * num_heads)
    q, k, v = qkv.reshape(b, t, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    s = torch.matmul(q, k.transpose(-2, -1)) * default_scale(d)
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    return o.transpose(1, 2).reshape(b, t, num_heads * d)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load_library()
    fn = lib.k5_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(qkv, num_heads: int) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"attention runs on CUDA or CPU tensors, not {qkv.device}")
    if qkv.dtype != torch.float32:
        raise TypeError(f"attention takes float32 qkv, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] != 3 * num_heads * HEAD_DIM:
        raise ValueError(f"attention takes (B, T, 3·H·{HEAD_DIM}) qkv with H = "
                         f"{num_heads}, got {tuple(qkv.shape)}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("attention takes contiguous qkv on a 16-byte boundary")
    if not 1 <= qkv.shape[1] <= MAX_TOKENS:
        raise ValueError(f"attention takes 1-{MAX_TOKENS} tokens, got {qkv.shape[1]}")


def attention(qkv, num_heads: int):
    """(B, T, 3·H·D) float32 qkv -> (B, T, H·D): one K5 launch for every
    image and head of the batch, at D = 96 and up to 144 tokens. CPU
    tensors take ``attention_plain`` (any D and T)."""
    if qkv.device.type == "cpu":
        return attention_plain(qkv, num_heads)
    _check(qkv, num_heads)
    b, t, d = qkv.shape[0], qkv.shape[1], HEAD_DIM
    out = torch.empty((b, t, num_heads * d), dtype=torch.float32, device=qkv.device)
    if out.numel() == 0:
        return out
    lib, fn = _kernel()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = fn(qkv.data_ptr(), b, t, num_heads, d, default_scale(d), out.data_ptr(),
                  stream)
    build.check(lib, code, f"attention launch at {tuple(qkv.shape)}, {num_heads} heads")
    build.count_launch(attention)
    return out


attention.launches = 0


WINDOW = 7              # K8's one window side, Swin's
WINDOW_HEAD_DIM = 32    # K8's one head size, Swin's
MASK_VALUE = -100.0     # the source's mask between regions


def relative_position_index(window: int) -> torch.Tensor:
    """(window², window²) index into the (2·window−1)² bias table, as the
    source builds it: ``(Δy + window−1)·(2·window−1) + (Δx + window−1)``
    with Δ = query's coordinate minus key's, tokens row-major."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :]
    return (rel[0] + window - 1) * (2 * window - 1) + (rel[1] + window - 1)


def region_labels(size: int, window: int, shift: int) -> torch.Tensor:
    """(number of windows, window²) region label of every token of the
    rolled (size, size) map, window by window: the source's three slices a
    side, [0, size−window), [size−window, size−shift), [size−shift, size),
    numbered row-major (3 x row slice + column slice)."""
    t = torch.arange(size)
    side = (t >= size - window).long() + (t >= size - shift).long()
    labels = side[:, None] * 3 + side[None, :]
    n = size // window
    return labels.reshape(n, window, n, window).permute(0, 2, 1, 3).reshape(n * n, -1)


def window_attention_plain(qkv, num_heads: int, window: int, shift: int, bias):
    """K8's function in plain PyTorch, on any device, in the source's order:
    the map rolled by ``-shift``, cut into windows, per head
    ``softmax((q · D^-½) @ kᵀ + bias + mask) @ v`` (the mask where
    ``shift > 0``), the windows put back and rolled by ``+shift`` ->
    (B, R, R, H·D)."""
    b, r, _, width = qkv.shape
    d, n, t = width // (3 * num_heads), r // window, window * window
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = x.reshape(b, n, window, n, window, width).permute(0, 1, 3, 2, 4, 5)
    q, k, v = x.reshape(b * n * n, t, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    s = torch.matmul(q * default_scale(d), k.transpose(-2, -1)) + bias
    if shift:
        labels = region_labels(r, window, shift).to(qkv.device)
        mask = torch.zeros(labels.shape + (t,), dtype=s.dtype, device=s.device)
        mask.masked_fill_(labels[:, :, None] != labels[:, None, :], MASK_VALUE)
        s = (s.view(b, n * n, num_heads, t, t) + mask[:, None]).view(-1, num_heads, t, t)
    o = torch.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2)
    o = o.reshape(b, n, n, window, window, num_heads * d).permute(0, 1, 3, 2, 4, 5)
    o = o.reshape(b, r, r, num_heads * d)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


@functools.lru_cache(maxsize=None)
def _window_kernel():
    lib = build.load_library()
    fn = lib.k8_window_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_window(qkv, num_heads: int, window: int, shift: int, bias) -> None:
    if qkv.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"window_attention takes float32 qkv and bias, got {qkv.dtype} "
                        f"and {bias.dtype}")
    if window != WINDOW:
        raise ValueError(f"window_attention takes {WINDOW} x {WINDOW} windows, got {window}")
    if qkv.dim() != 4 or qkv.shape[1] != qkv.shape[2] \
            or qkv.shape[3] != 3 * num_heads * WINDOW_HEAD_DIM:
        raise ValueError(f"window_attention takes (B, R, R, 3·H·{WINDOW_HEAD_DIM}) qkv "
                         f"with H = {num_heads}, got {tuple(qkv.shape)}")
    if qkv.shape[1] % window:
        raise ValueError(f"window_attention takes a map of whole {window} x {window} "
                         f"windows, got {qkv.shape[1]} x {qkv.shape[2]}")
    if not 0 <= shift < window:
        raise ValueError(f"window_attention takes a shift in [0, {window}), got {shift}")
    if tuple(bias.shape) != (num_heads, window * window, window * window):
        raise ValueError(f"window_attention takes an (H, {window * window}, "
                         f"{window * window}) bias, got {tuple(bias.shape)}")
    if qkv.device.type != "cuda" or bias.device != qkv.device:
        raise ValueError(f"window_attention runs on CUDA or CPU tensors, not {qkv.device} "
                         f"(bias on {bias.device})")
    if not (qkv.is_contiguous() and bias.is_contiguous()) or qkv.data_ptr() % 16:
        raise ValueError("window_attention takes contiguous qkv on a 16-byte boundary "
                         "and a contiguous bias")


def window_attention(qkv, num_heads: int, window: int, shift: int, bias):
    """(B, R, R, 3·H·D) float32 qkv and the gathered (H, 49, 49) bias ->
    (B, R, R, H·D): one K8 launch for every image, window and head of the
    batch, at D = 32 and 7 x 7 windows. CPU tensors take
    ``window_attention_plain`` (any D and window)."""
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, num_heads, window, shift, bias)
    _check_window(qkv, num_heads, window, shift, bias)
    b, r = qkv.shape[0], qkv.shape[1]
    out = torch.empty((b, r, r, num_heads * WINDOW_HEAD_DIM), dtype=torch.float32,
                      device=qkv.device)
    if out.numel() == 0:
        return out
    lib, fn = _window_kernel()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = fn(qkv.data_ptr(), bias.data_ptr(), b, r, num_heads, WINDOW_HEAD_DIM,
                  window, shift, default_scale(WINDOW_HEAD_DIM), out.data_ptr(), stream)
    build.check(lib, code, f"window_attention launch at {tuple(qkv.shape)}, "
                           f"{num_heads} heads, shift {shift}")
    build.count_launch(window_attention)
    return out


window_attention.launches = 0
