"""Named stage timers, spans and counters, and a device-kernel profile.

The port's own copy of ``StageTimer`` from
``hse_facerec_tf_tpu/utils/profiling.py``: wall-clock samples per named
stage with aggregate stats (count, total, mean, p50, p95). A stage that
times device work must end in a host sync (``torch.cuda.synchronize`` or a
copy to the host) inside its block, or it times the enqueue only; the
album's stages end in the analyzer's one copy of its results.

Every stage is also kept as a span, ``(name, start_ns, end_ns, span_id,
parent_id)``, on the clock of ``torch.profiler``'s device events
(``now_ns``), so that a trace of the card can say what the host was doing
in each gap; beside them, named counters.

``fusion_profile`` is the counterpart of the reference's per-fusion table,
on ``torch.profiler``: device time per kernel, with no byte counts (the
profiler gives none).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional

import numpy as np


def now_ns() -> int:
    """The spans' clock: Unix time in ns, ``time.time_ns()``, the clock
    that ``torch.profiler``'s Kineto events carry, so a span and the
    device operations it launched or waited on line up in one trace."""
    return time.time_ns()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]


class StageTimer:
    """Accumulates wall-clock samples per named stage, spans and counts.
    Thread-safe: samples may arrive from concurrent threads (the album's
    flush workers, serve's pool of batched calls) while another thread
    snapshots stats(). Per-stage history is a bounded deque
    (``max_samples``, default last 10k), and so are the spans
    (``max_spans``), so a long-lived process doesn't grow them without
    bound. ``enabled=False`` records nothing."""

    def __init__(self, enabled: bool = True, max_samples: int = 10_000,
                 max_spans: int = 100_000):
        self.enabled = enabled
        self.samples: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=max_samples))
        self._spans: Deque[Span] = deque(maxlen=max_spans)
        self._counts: Dict[str, int] = defaultdict(int)
        self._ids = itertools.count(1)
        self._open = threading.local()       # this thread's open span ids
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, parent: Optional[int] = None) -> Iterator[Optional[int]]:
        """Time a stage and keep it as a span; yields the span's id (None
        when disabled). ``parent`` names the span that caused this one;
        by default it is the innermost stage open on this thread."""
        if not self.enabled:
            yield None
            return
        stack = self._open.__dict__.setdefault("ids", [])
        if parent is None and stack:
            parent = stack[-1]
        with self._lock:
            span_id = next(self._ids)
        stack.append(span_id)
        t0 = now_ns()
        try:
            yield span_id
        finally:
            t1 = now_ns()
            stack.pop()
            with self._lock:
                self.samples[name].append((t1 - t0) / 1e9)
                self._spans.append(Span(name, t0, t1, span_id, parent))

    def add(self, name: str, seconds: float) -> None:
        """A duration sample taken elsewhere."""
        if self.enabled:
            with self._lock:
                self.samples[name].append(seconds)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        if self.enabled:
            with self._lock:
                self._counts[name] += n

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

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

    def reset(self):
        with self._lock:
            self.samples.clear()
            self._spans.clear()
            self._counts.clear()


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
