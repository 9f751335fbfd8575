"""Wrapper of the CUDA crop+resize kernel K1 (``csrc/crop_resize.cu``).

``crop_resize`` routes by the device its tensors lie on: CPU tensors take
the plain PyTorch version (``ops/resize.py::crop_resize_bilinear``); CUDA
tensors launch the kernel or raise. ``crop_resize.launches`` counts kernel
launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..resize import crop_resize_bilinear
from . import build


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load_library()
    fn = lib.crop_resize_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def crop_resize(img, boxes, out_size: int, supersample: int = 2,
                outside: str = "zero"):
    """(H, W, C) f32 image + (K, 4) f32 boxes [y1, x1, y2, x2] ->
    (K, out_size, out_size, C) crops; ``outside`` is 'zero' (the detector's
    stage-2/3 crops) or 'clamp' (the analyzer's head crops). Semantics of
    ``crop_resize_bilinear``; on CUDA both tensors must be contiguous f32
    on one device, with C <= 4."""
    if outside not in ("zero", "clamp"):
        raise ValueError(f"outside must be 'zero' or 'clamp', not {outside!r}")
    if img.device.type == "cpu" and boxes.device.type == "cpu":
        return crop_resize_bilinear(img, boxes, out_size, supersample, outside)
    if img.device.type != "cuda" or boxes.device != img.device:
        raise ValueError(f"crop_resize: image on {img.device}, boxes on "
                         f"{boxes.device}; both must be on one CUDA device or "
                         "both on the CPU")
    if img.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError(f"crop_resize takes float32, got {img.dtype} / {boxes.dtype}")
    if img.dim() != 3 or not 1 <= img.shape[2] <= 4:
        raise ValueError(f"image must be (H, W, C<=4), got {tuple(img.shape)}")
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be (K, 4), got {tuple(boxes.shape)}")
    if not (img.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("crop_resize takes contiguous tensors")
    if out_size < 1 or supersample < 1:
        raise ValueError(f"out_size {out_size} and supersample {supersample} must be >= 1")
    H, W, C = img.shape
    K = boxes.shape[0]
    out = torch.empty((K, out_size, out_size, C), dtype=torch.float32,
                      device=img.device)
    if K == 0:
        return out
    lib, fn = _kernel()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        code = fn(img.data_ptr(), H, W, C, boxes.data_ptr(), K, out_size,
                  supersample, int(outside == "clamp"), out.data_ptr(), stream)
    build.check(lib, code, "crop_resize_f32 launch")
    crop_resize.launches += 1
    return out


crop_resize.launches = 0
