"""The program's own spans and counters inside ``EmbeddingExtractor``, in
a traced run of an enrolment cell: what the ``idle_*.enroll*`` and
``upload_gbps.enroll.multihead`` readers read.

Handed a ``StageTimer``, the port's extractor records ``embed.upload``
(host rows to the card), ``embed.forward`` (the launches of a chunk's
forward) and ``embed.fetch`` (the wait for the card and the copies back)
on the profiler's clock, and counts ``embed.upload_bytes``, ``embed.rows``
and ``embed.padded_rows``. The entry ``extract_batch`` builds its extractor
without a timer, so ``timed(Entry)`` hands it one after set-up, files the
trace's idle gaps under the program's spans before the entry's own, and
returns the window's counts in ``context()``:

    python -m perfbench.embed_spans --workload <cell> --seed <n> --seconds <s> --trace 1

runs a cell as ``python -m perfbench.run`` does, with the readers below
added to the cell's per-layer metrics; the result line is ``run``'s."""

from __future__ import annotations

import time

T0_NS = time.time_ns()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

PROGRAM_SPANS = ["embed.upload", "embed.forward", "embed.fetch"]

# the per-layer metrics these spans and counters feed, in BENCHMARK.json's form
METRICS: List[Dict] = [
    {"name": f"{name}.{tag}", "unit": "%", "better": "lower", "source": "program_span",
     "layer": layer, "moves": moves, "workloads": [cell]}
    for name, layer in (("idle_upload", "upload"), ("idle_launch", "model step"),
                        ("idle_fetch", "model step"))
    for cell, tag, moves in (("arcface-enroll", "enroll", "faces_per_s"),
                             ("multihead-enroll", "enroll.multihead", "faces_per_s.multihead"))
] + [{"name": "upload_gbps.enroll.multihead", "unit": "GB/s", "better": "higher",
      "source": "program_counter", "layer": "upload", "moves": "faces_per_s.multihead",
      "workloads": ["multihead-enroll"]}]


def idle_share(ctx, span: str) -> Optional[float]:
    """Percent of the traced window with no kernel running whose gap's
    midpoint falls in a ``span`` of the program (the trace's
    ``idle_gaps`` over the program's spans). The program's three shares
    and the gaps outside them (the caller's loop) add up to
    ``device_idle``. None without a trace or without the program's
    spans."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    spans = ctx.spans.items
    if not any(name in PROGRAM_SPANS for name, _, _ in spans):
        return None
    gaps = dict(ctx.trace.idle_gaps(spans, PROGRAM_SPANS, top=len(PROGRAM_SPANS) + 1))
    return 100.0 * gaps.get(span, 0.0) / ctx.trace.window_s


def upload_gbps(ctx) -> Optional[float]:
    """The window's ``embed.upload_bytes`` over the device time of the
    trace's host-to-device copies, in GB/s. None without a trace, bytes or
    copies."""
    if ctx.trace is None:
        return None
    moved = ctx.entry.get("counts", {}).get("embed.upload_bytes", 0)
    seconds, _ = ctx.trace.kernel_time_s(lambda name: name.startswith("Memcpy HtoD"))
    if not moved or seconds <= 0:
        return None
    return moved / seconds / 1e9


def timed(entry_cls):
    """``entry_cls`` (an entry whose ``extractor`` is an
    ``EmbeddingExtractor``) with a ``StageTimer`` handed to its extractor
    after set-up, its spans of the window added to the run's, and the
    window's counts under ``counts`` in ``context()``."""

    class Timed(entry_cls):
        span_priority = PROGRAM_SPANS + list(entry_cls.span_priority)

        def setup(self) -> None:
            from hse_facerec_torch.utils.profiling import StageTimer

            super().setup()
            self.timer = StageTimer(max_spans=1 << 21)
            self.extractor.timer = self.timer

        def window(self, seconds: float):
            self.timer.reset()
            w = super().window(seconds)
            for s in self.timer.spans():
                if s.name in PROGRAM_SPANS:
                    self.run.spans.add(s.name, s.start_ns, s.end_ns)
            self.counts = self.timer.counts()
            return w

        def context(self) -> Dict:
            return {**super().context(), "counts": self.counts}

    Timed.__name__ = f"Timed{entry_cls.__name__}"
    return Timed


def execute_timed(bench, workload: Dict, seed: int, seconds: float, traced: bool,
                  device: str = "cuda", t0_ns: Optional[int] = None):
    """``run.execute`` of ``workload`` with the timed entry and the metrics
    above added to ``bench``'s (a copy): (result, compared)."""
    from . import entries, run

    known = {m["name"] for m in bench.data["per_layer"]}
    bench = copy.copy(bench)
    bench.data = {**bench.data, "per_layer": bench.data["per_layer"]
                  + [m for m in METRICS if m["name"] not in known]}
    load = entries.load
    entries.load = lambda name: timed(load(name))
    try:
        return run.execute(bench, workload, seed, seconds, traced, device=device,
                           t0_ns=time.time_ns() if t0_ns is None else t0_ns)
    finally:
        entries.load = load


def main(argv: Optional[List[str]] = None) -> int:
    from . import run
    from .spec import Benchmark
    from .trace import require_cards

    ap = argparse.ArgumentParser(prog="python -m perfbench.embed_spans",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    root = Path.cwd()
    run.cache_dirs(root)
    bench = Benchmark(root)
    workload = bench.workload(args.workload)
    try:
        require_cards(workload["chips"])
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    result, _ = execute_timed(bench, workload, args.seed, args.seconds, bool(args.trace),
                              t0_ns=T0_NS)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
