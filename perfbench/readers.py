"""What the per-layer metrics' readers share. A reader that finds nothing
to read returns None, and the metric is left out of the result line; no
share of a peak or a roofline is ever reported as 0 for want of data."""

from __future__ import annotations

from typing import Callable, Optional

from . import flops
from .stats import percentile, share_of_peak


def mfu(ctx) -> Optional[float]:
    """Percent of the measured window that the model work the window's
    completed units needed would fill at the card's peaks
    (``work_at_peak_s``, from the benchmark's own FLOP counts)."""
    return share_of_peak(ctx.entry.get("work_at_peak_s", 0.0), ctx.window.seconds)


def device_idle(ctx) -> Optional[float]:
    """Percent of the traced window with no kernel running. Copies and sets
    do not count as busy: the SMs wait through them."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.kernel_busy_s / ctx.trace.window_s)


def roofline(ctx, timed: Callable[[str], bool], counted: Callable[[str], bool],
             work) -> Optional[float]:
    """Percent of a kernel's device time in the trace that its roofline
    bound allows. ``timed`` picks the kernels whose time is the kernel's
    (a sweep and its reduction), ``counted`` the one launch a call;
    ``work(calls)`` -> [(bytes, ops, kind)], the work of the traced calls
    as the benchmark counts it from the shapes the work needs. The sum of
    their ``flops.bound_s`` over the summed device time."""
    if ctx.trace is None:
        return None
    seconds, _ = ctx.trace.kernel_time_s(timed)
    _, calls = ctx.trace.kernel_time_s(counted)
    if not calls or seconds <= 0:
        return None
    bound = sum(flops.bound_s(b, o, k)[0] for b, o, k in work(calls))
    return 100.0 * bound / seconds if bound > 0 else None


def span_percentile_ms(ctx, name: str, q: float) -> Optional[float]:
    """The ``q``-th percentile of a host span's durations, in ms."""
    values = ctx.spans.durations_ms(name)
    return percentile(values, q) if values else None
