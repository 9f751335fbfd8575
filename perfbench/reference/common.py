"""What the plain references share: float32 arithmetic at a stated
precision. The reference turns TF32 off itself (torch's ``fp32_precision``
settings, which the program also uses, restored on the way out); the
control's TF32 is the operands of every conv and matmul rounded to TF32's
10-bit mantissa, then multiplied and summed in IEEE float32, which is what
the tensor cores do with TF32 and runs alike on any device."""

from __future__ import annotations

import contextlib
import threading

import torch

_local = threading.local()


@contextlib.contextmanager
def fp32_mode(mode: str = "ieee"):
    """float32 convs and matmuls in IEEE fp32 ("ieee"), or on operands
    rounded to TF32 ("tf32", the control's lower precision, see ``tf32``)."""
    if mode not in ("ieee", "tf32"):
        raise ValueError(f"fp32 mode {mode!r}")
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = (matmul.fp32_precision, conv.fp32_precision, getattr(_local, "mode", "ieee"))
    matmul.fp32_precision = conv.fp32_precision = "ieee"
    _local.mode = mode
    try:
        yield
    finally:
        matmul.fp32_precision, conv.fp32_precision, _local.mode = saved


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a conv or matmul operand: unchanged in "ieee" mode; in
    "tf32" mode rounded to the nearest value with a 10-bit mantissa (ties
    away from zero), as TF32 keeps it."""
    if getattr(_local, "mode", "ieee") != "tf32":
        return x
    bits = x.contiguous().to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
