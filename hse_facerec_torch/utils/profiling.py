"""Named stage timers and a device-kernel profile.

The port's own copy of ``StageTimer`` from
``hse_facerec_tf_tpu/utils/profiling.py``: wall-clock samples per named
stage with aggregate stats (count, total, mean, p50, p95). A stage that
times device work must end in a host sync (``torch.cuda.synchronize`` or a
copy to the host) inside its block, or it times the enqueue only; the
album's stages end in the analyzer's one copy of its results.

``fusion_profile`` is the counterpart of the reference's per-fusion table,
on ``torch.profiler``: device time per kernel, with no byte counts (the
profiler gives none).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Iterator, Optional

import numpy as np


class StageTimer:
    """Accumulates wall-clock samples per named stage. Thread-safe: samples
    may arrive from concurrent threads (the album's flush workers) while
    another thread snapshots stats(). Per-stage history is a bounded deque
    (``max_samples``, default last 10k) so a long-lived process doesn't
    grow its sample lists without bound."""

    def __init__(self, enabled: bool = True, max_samples: int = 10_000):
        self.enabled = enabled
        self.samples: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=max_samples))
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Time a stage."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.samples[name].append(dt)

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            snapshot = {name: list(xs) for name, xs in self.samples.items()}
        out = {}
        for name, xs in snapshot.items():
            if not xs:
                continue
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "total_s": float(a.sum()),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':30s} {'count':>6s} {'mean':>9s} {'p50':>9s} {'p95':>9s}"]
        for name, s in sorted(self.stats().items()):
            lines.append(f"{name:30s} {s['count']:6d} {s['mean_ms']:8.2f}m "
                         f"{s['p50_ms']:8.2f}m {s['p95_ms']:8.2f}m")
        return "\n".join(lines)

    def reset(self):
        with self._lock:
            self.samples.clear()


def fusion_profile(run, top: int = 8) -> Optional[Dict]:
    """Device time per kernel from a ``torch.profiler`` trace of one call to
    ``run()`` (a zero-arg callable; the trace waits for the card after it).
    The counterpart of the reference's per-fusion table behind serve's
    ``/profile``, on kernels instead of XLA fusions.

    Returns ``{busy_ms, top: [{name, ms, calls, pct_busy}, ...]}`` over the
    device kernels, the ``top`` longest first, or None when the trace holds
    no device kernel (no card, or a session that lost its records). The
    reference's byte and GB/s columns are left out: the profiler counts no
    bytes. Concurrent work on the card lands in the same trace window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run()                      # the caller's failure propagates
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = us if us is not None else e.self_cuda_time_total
        rows.append({"name": e.key, "ms": us / 1e3, "calls": int(e.count)})
    busy_ms = sum(r["ms"] for r in rows)
    if not busy_ms:
        return None
    rows = sorted(rows, key=lambda r: -r["ms"])[:top]
    for r in rows:
        r["pct_busy"] = round(100 * r["ms"] / busy_ms, 1)
        r["ms"] = round(r["ms"], 4)
    return {"busy_ms": round(busy_ms, 4), "top": rows}
