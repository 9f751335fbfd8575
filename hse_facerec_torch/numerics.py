"""Numerics of the port: the precision tiers and the exact-rounding helpers.

A forward's ``precision`` is one of three tiers, the reference's
``jax.lax.Precision`` by name (``Precision.X`` -> ``X.name.lower()``):

- ``"highest"``: IEEE fp32 in cuBLAS matmuls and cuDNN convolutions. The
  default of every forward of the port, and the tier whose answers the JAX
  package's are held against.
- ``"high"`` and ``"default"``: TF32 in both (``torch.set_float32_matmul_
  precision("high")`` is torch's own name for it). TF32 keeps about three
  decimal digits, which flips the detector's .5 pixel roundings and its
  threshold decisions, so these tiers are opt-in.

bf16 is the separate ``compute_dtype`` axis, as in the reference; the
fp32 flags do not touch a bf16 op.

torch reads the flags globally, when an op is dispatched, and not per
thread. A forward therefore dispatches its ops inside ``precision_scope``:
a gate keyed by the flags' setting, which forwards at one setting share and
a forward at the other enters only when they have all left. While the gate
is held the flags are its setting; when the last holder leaves they return
to what they were before the first came. All of it goes through torch's
``fp32_precision`` properties, never the legacy ``allow_tf32`` flags (torch
refuses to read the legacy flags once the two were mixed).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

PRECISIONS = ("highest", "high", "default")
_FP32 = {"highest": "ieee", "high": "tf32", "default": "tf32"}


def fp32_precision(precision: str) -> str:
    """The ``fp32_precision`` setting ('ieee' or 'tf32') of a tier."""
    try:
        return _FP32[precision]
    except KeyError:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}") from None


def _read_flags():
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.cudnn.conv.fp32_precision)


def _write_flags(matmul: str, conv: str) -> None:
    torch.backends.cuda.matmul.fp32_precision = matmul
    torch.backends.cudnn.conv.fp32_precision = conv


class _Gate:
    """Holders at one flag setting share the gate; a thread that wants the
    other setting waits until the holders count drops to zero."""

    def __init__(self):
        self._cond = threading.Condition()
        self._mode: Optional[str] = None
        self._holders = 0
        self._saved = None

    def acquire(self, mode: Optional[str]) -> str:
        """Take the gate at ``mode``; None joins the setting that holds it,
        or takes 'ieee' when it is free. Returns the setting taken."""
        with self._cond:
            if mode is None:
                mode = self._mode if self._holders else "ieee"
            while self._holders and self._mode != mode:
                self._cond.wait()
            if not self._holders:
                self._saved = _read_flags()
                _write_flags(mode, mode)
                self._mode = mode
            self._holders += 1
            return mode

    def release(self) -> None:
        with self._cond:
            self._holders -= 1
            if not self._holders:
                _write_flags(*self._saved)
                self._mode = None
                self._cond.notify_all()


_GATE = _Gate()
_local = threading.local()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class precision_scope(contextlib.ContextDecorator):
    """Dispatch the block's ops at ``precision``'s flag setting. ``None``
    keeps the enclosing scope's setting in this thread; in a thread with
    none it joins the setting that holds the gate, without waiting (the
    autograd engine's worker thread, recomputing a checkpointed block
    while its caller holds the gate), or takes "highest" when the gate is
    free. Scopes nest; an inner scope at the other setting gives the gate
    up and takes it again on the way out, so a thread never waits while it
    holds the gate. Also a decorator."""

    def __init__(self, precision: Optional[str] = None):
        self._mode = None if precision is None else fp32_precision(precision)

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        mode = self._mode or top
        if mode is None or mode != top:
            if top is not None:
                _GATE.release()
            mode = _GATE.acquire(mode)
        stack.append(mode)

    def __exit__(self, *exc):
        stack = _stack()
        mode = stack.pop()
        top = stack[-1] if stack else None
        if mode != top:
            _GATE.release()
            if top is not None:
                _GATE.acquire(top)
        return False


def set_parity_numerics() -> None:
    """fp32 everywhere, outside any forward too: no TF32 in cuBLAS matmuls
    or cuDNN convolutions. A forward's answer does not depend on it (each
    dispatches under its own ``precision_scope``); it sets what code
    outside the port's forwards sees."""
    _write_flags("ieee", "ieee")


def div_const(x, d: float):
    """``x / d`` for a host constant ``d``, computed as the reference
    computes it: inside ``jax.jit`` XLA rewrites a division by a constant
    into a multiply by the float32 reciprocal of float32(d). A true division
    differs in the last bit, which flips ``fix`` truncations of box corners
    and moves crop sample positions. The explicit multiply also gives the
    same bits on the CPU and on CUDA."""
    return x * float(np.float32(1.0) / np.float32(d))


def fma(a, b, c):
    """``a * b + c`` rounded once to float32, as XLA computes the multiply-
    adds it fuses inside ``jax.jit`` (box regression, landmarks, crop
    sample positions). The float32 product is exact in float64, so the one
    float64 add leaves a single rounding to float32, apart from a double
    rounding that needs a tie at float64 precision."""
    return (a.double() * b.double() + c.double()).float()


def top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, ties by
    lowest index first, as ``lax.top_k`` breaks them: a stable descending
    sort, since ``torch.topk`` promises no tie order on CUDA."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]
