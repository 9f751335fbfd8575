"""The card: its presence, name and power limit, its peak memory, and the
reduction of a ``torch.profiler`` trace of the window to device busy
time, kernel times and idle gaps labelled by the harness's host spans.

Kernel and host times share one clock: the profiler's events carry Unix
nanoseconds, and host spans are taken with ``time.time_ns``. The parsing
follows the port's ``utils/profiling.py::fusion_profile`` (device events by
``device_type``), on the raw event list, which is cheaper for a trace of
some hundred thousand kernels."""

from __future__ import annotations

import subprocess
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Span = Tuple[str, int, int]          # (name, start ns, end ns), Unix time


def require_cards(n: int) -> None:
    """Raise unless ``n`` CUDA cards are visible: no number is ever taken
    from the CPU under a device metric's name."""
    if not torch.cuda.is_available():
        raise SystemExit("perfbench: torch.cuda.is_available() is false; "
                         "this benchmark runs on a CUDA card only")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"perfbench: the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} visible")


def card_name_and_power_limit() -> str:
    """``name, power.limit`` as ``nvidia-smi`` prints them, or what the
    failure says."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class Spans:
    """Named host spans from any thread, kept in memory."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Span] = []
        self.sizes: Dict[str, List[float]] = defaultdict(list)

    def add(self, name: str, start_ns: int, end_ns: int, size: Optional[float] = None):
        with self._lock:
            self.items.append((name, start_ns, end_ns))
            if size is not None:
                self.sizes[name].append(size)

    def clear(self) -> None:
        with self._lock:
            self.items.clear()
            self.sizes.clear()

    def durations_ms(self, name: str) -> List[float]:
        with self._lock:
            return [(e - s) / 1e6 for n, s, e in self.items if n == name]


class Tracer:
    """Traces the whole window with ``torch.profiler``, CUDA activity only
    (on the CPU, in the tests, the CPU's ops): started before the window's
    first unit and stopped after its last, so that neither the profiler's
    start nor its stop lands inside the window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t0_ns = self.t1_ns = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        act = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
        return profile(activities=[act])

    def prepare(self) -> None:
        """Start and stop the profiler once in set-up: its one-time
        initialisation is set-up work."""
        if self.enabled:
            prof = self._profile()
            prof.start()
            prof.stop()

    def start(self) -> None:
        if self.enabled:
            self.prof = self._profile()
            self.prof.start()
            self.t0_ns = time.time_ns()

    def stop(self) -> None:
        if self.prof is not None and self.t1_ns is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t1_ns = time.time_ns()
            self.prof.stop()

    def summary(self) -> Optional["TraceSummary"]:
        """The traced window, or None when nothing was traced or no device
        activity was recorded."""
        if self.prof is None or self.t1_ns is None:
            return None
        kernels = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns()
            kernels.append((e.name(), start, start + e.duration_ns()))
        summary = TraceSummary(kernels, self.t0_ns, self.t1_ns)
        return summary if summary.kernels else None


def is_kernel(name: str) -> bool:
    """A device event that runs on the SMs: not a copy or a set, which the
    profiler names ``Memcpy ...`` and ``Memset ...``."""
    return not name.startswith(("Memcpy", "Memset"))


class TraceSummary:
    """Device activity (kernels, copies, sets) between ``t0_ns`` and
    ``t1_ns``. ``busy_s`` is the union of every operation's intervals
    inside it; ``kernel_busy_s`` that of the kernels alone, and the idle
    gaps are the time in which no kernel ran, a copy or not."""

    def __init__(self, kernels: List[Span], t0_ns: int, t1_ns: int):
        self.kernels = [k for k in kernels if k[2] > t0_ns and k[1] < t1_ns]
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.window_s = (t1_ns - t0_ns) / 1e9

        def union(events):
            return _union([(max(s, t0_ns), min(e, t1_ns)) for _, s, e in events])

        self.busy_s = sum(e - s for s, e in union(self.kernels)) / 1e9
        self.intervals = union([k for k in self.kernels if is_kernel(k[0])])
        self.kernel_busy_s = sum(e - s for s, e in self.intervals) / 1e9

    def kernel_time_s(self, match) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name ``match``
        accepts."""
        total, n = 0, 0
        for name, s, e in self.kernels:
            if match(name):
                total += e - s
                n += 1
        return total / 1e9, n

    def device_ops(self, top: int = 10) -> List[List]:
        by_name: Dict[str, int] = defaultdict(int)
        for name, s, e in self.kernels:
            by_name[name[:120]] += e - s
        rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in rows]

    def idle_gaps(self, spans: Sequence[Span], priority: Sequence[str],
                  top: int = 10) -> List[List]:
        """Time with no kernel running, summed by the host span open at each
        gap's midpoint (the first of ``priority`` open then, else "no
        span")."""
        gaps, prev = [], self.t0_ns
        for s, e in self.intervals:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1_ns > prev:
            gaps.append((prev, self.t1_ns))
        # one sweep over the span boundaries, in time order with the gaps'
        # midpoints: ``active`` counts the open spans of each name
        events = sorted([(s, 1, n) for n, s, e in spans if n in priority]
                        + [(e, -1, n) for n, s, e in spans if n in priority])
        active: Dict[str, int] = defaultdict(int)
        by_label: Dict[str, int] = defaultdict(int)
        i = 0
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            while i < len(events) and events[i][0] <= mid:
                active[events[i][2]] += events[i][1]
                i += 1
            label = next((n for n in priority if active[n] > 0), "no span")
            by_label[label] += g1 - g0
        rows = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return [[label, ns / 1e9] for label, ns in rows]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out
