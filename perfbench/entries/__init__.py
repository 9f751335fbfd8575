"""The entry points of the program that a traffic mix drives, one module
each, found by the mix's ``entry``. Each module defines ``Entry``:

- ``setup()`` builds the system under test from the seed and warms up the
  shapes the mix uses;
- ``window(seconds)`` drives it for the window and returns a ``Window``;
- ``release()`` frees the program's state before the reference runs;
- ``checks(control)`` compares what the window produced with the plain
  reference (``control=True``: the reference at the precision below the
  configuration's, put in the program's place) and returns the numbers
  compared;
- ``context()``: what the per-layer readers read."""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Callable, Dict


@dataclasses.dataclass
class Window:
    seconds: float                  # all the time of the window
    attempted: int                  # units due in it
    failed: int                     # units that failed or never came
    end_to_end: Dict[str, float]    # this entry's end-to-end metrics
    units: int = 0                  # units completed


def load(entry: str):
    return importlib.import_module(f"perfbench.entries.{entry}").Entry


def now_ns() -> int:
    return time.time_ns()


def closed_loop(call: Callable[[int], int], seconds: float, spans,
                span: str) -> Window:
    """Calls ``call(k)`` back to back, each after the last returned, until
    ``seconds`` have passed; ``call`` returns the units it completed. The
    window ends when the last call started in it returns: every unit
    counted, over all the time it took."""
    units = calls = 0
    t0 = now_ns()
    t_end = t0
    while True:
        t = now_ns()
        elapsed = (t - t0) / 1e9
        if elapsed >= seconds:
            break
        done = call(calls)
        t_end = now_ns()
        spans.add(span, t, t_end, size=done)
        units += done
        calls += 1
    return Window(seconds=(t_end - t0) / 1e9, attempted=units, failed=0,
                  end_to_end={}, units=units)
