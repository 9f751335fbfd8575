"""Wrapper of the CUDA attention kernel K5 (``csrc/attention.cu``) and its
plain PyTorch version.

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
