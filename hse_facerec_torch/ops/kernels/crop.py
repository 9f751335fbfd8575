"""Wrapper of the CUDA crop+resize kernel K1 (``csrc/crop_resize.cu``).

``crop_resize`` routes by the device its tensors lie on: CPU tensors take
the plain PyTorch version (``ops/resize.py``: ``crop_resize_bilinear`` and
its batch forms); CUDA tensors launch the kernel or raise. It takes three
forms, each one launch:

- one image (H, W, C) and boxes (K, 4);
- a batch (L, H, W, C) and boxes (L, K, 4), lane l's boxes cropping from
  image l (the detector's stage-2/3 crops);
- a batch (L, H, W, C), boxes (N, 4) and ``lanes`` (N,) int32, the image
  of each box (the analyzer's head crops, compacted across lanes).

On the card a lane outside [0, L) writes NaN over its box (no sync to
check it); on the CPU it raises. ``crop_resize.launches`` counts kernel
launches, so a run can show that it went through the kernel; it counts
under a lock (``build.count_launch``), because the album's two flush
threads launch K1 at once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..resize import (crop_resize_bilinear, crop_resize_bilinear_batch,
                      crop_resize_bilinear_lanes)
from . import build

MAX_SAMPLES = 1024      # supersample * out_size: the kernel's tap tables


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load_library()
    fn = lib.crop_resize_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _form(img, boxes, lanes):
    """(L, N boxes, boxes per lane or 0 with lanes, output shape prefix) of
    a call; raises on shapes that fit none of the three forms."""
    if lanes is not None:
        if img.dim() != 4 or boxes.dim() != 2 or lanes.shape != boxes.shape[:1]:
            raise ValueError(f"with lanes: images (L, H, W, C), boxes (N, 4) and "
                             f"lanes (N,), got {tuple(img.shape)}, "
                             f"{tuple(boxes.shape)}, {tuple(lanes.shape)}")
        return img.shape[0], boxes.shape[0], 0, boxes.shape[:1]
    if img.dim() == 3 and boxes.dim() == 2:
        return 1, boxes.shape[0], boxes.shape[0], boxes.shape[:1]
    if img.dim() == 4 and boxes.dim() == 3 and boxes.shape[0] == img.shape[0]:
        return img.shape[0], boxes.shape[0] * boxes.shape[1], boxes.shape[1], boxes.shape[:2]
    raise ValueError(f"images {tuple(img.shape)} and boxes {tuple(boxes.shape)}: "
                     "want (H, W, C) and (K, 4), or (L, H, W, C) and (L, K, 4)")


def crop_resize(img, boxes, out_size: int, supersample: int = 2,
                outside: str = "zero", lanes=None):
    """Crops of ``out_size`` x ``out_size`` from f32 images by [y1, x1, y2,
    x2] boxes, in one of the three forms above -> (K | (L, K) | N, out_size,
    out_size, C); ``outside`` is 'zero' (the detector's stage-2/3 crops) or
    'clamp' (the analyzer's head crops). Semantics of
    ``crop_resize_bilinear``; on CUDA every tensor must be contiguous on
    one device, f32 (lanes int32), with C <= 4."""
    if outside not in ("zero", "clamp"):
        raise ValueError(f"outside must be 'zero' or 'clamp', not {outside!r}")
    if boxes.shape[-1:] != (4,):
        raise ValueError(f"boxes must end in 4 coordinates, got {tuple(boxes.shape)}")
    if lanes is not None and lanes.dtype != torch.int32:
        raise TypeError(f"lanes must be int32, got {lanes.dtype}")
    L, N, per_lane, prefix = _form(img, boxes, lanes)
    on_cpu = img.device.type == "cpu" and boxes.device.type == "cpu"
    if on_cpu and (lanes is None or lanes.device.type == "cpu"):
        if lanes is not None:
            if N and not (0 <= int(lanes.min()) and int(lanes.max()) < L):
                raise ValueError(f"lanes must lie in [0, {L}), got "
                                 f"[{int(lanes.min())}, {int(lanes.max())}]")
            return crop_resize_bilinear_lanes(img, lanes, boxes, out_size,
                                              supersample, outside)
        if img.dim() == 4:
            return crop_resize_bilinear_batch(img, boxes, out_size, supersample,
                                              outside)
        return crop_resize_bilinear(img, boxes, out_size, supersample, outside)
    dev = img.device
    if dev.type != "cuda" or boxes.device != dev or (
            lanes is not None and lanes.device != dev):
        raise ValueError(f"crop_resize: images on {dev}, boxes on {boxes.device}"
                         + (f", lanes on {lanes.device}" if lanes is not None else "")
                         + "; all must be on one CUDA device or all on the CPU")
    if img.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError(f"crop_resize takes float32, got {img.dtype} / {boxes.dtype}")
    if not 1 <= img.shape[-1] <= 4:
        raise ValueError(f"images must have 1-4 channels, got {tuple(img.shape)}")
    if not (img.is_contiguous() and boxes.is_contiguous()
            and (lanes is None or lanes.is_contiguous())):
        raise ValueError("crop_resize takes contiguous tensors")
    if out_size < 1 or not 1 <= supersample <= 4 or supersample * out_size > MAX_SAMPLES:
        raise ValueError(f"out_size {out_size} and supersample {supersample}: want "
                         f"out_size >= 1, supersample 1-4 and out_size * supersample "
                         f"<= {MAX_SAMPLES}")
    H, W, C = img.shape[-3:]
    out = torch.empty((*prefix, out_size, out_size, C), dtype=torch.float32,
                      device=dev)
    if N == 0:
        return out
    lib, fn = _kernel()
    # the raw handle of the current stream: torch.cuda.current_stream builds
    # a Stream object on every call, several µs of a call this short
    args = (img.data_ptr(), L, H, W, C, boxes.data_ptr(),
            None if lanes is None else lanes.data_ptr(), N, per_lane, out_size,
            supersample, int(outside == "clamp"), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        code = fn(*args)
    else:
        with torch.cuda.device(dev):
            code = fn(*args)
    build.check(lib, code, "crop_resize_f32 launch")
    build.count_launch(crop_resize)
    return out


crop_resize.launches = 0
