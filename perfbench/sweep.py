"""The highest rate an open-loop cell sustains, found once by a sweep on
the card: the cell's system is set up once, then driven for ``--seconds``
at each rate in turn. For each rate one JSON line: requests due, finished,
failed, the latency percentiles from the due time, and the median latency
of the window's last quarter of requests against its first (a backlog that
grows all through the window reads well above 1).

    python -m perfbench.sweep --workload <cell> --seed <n> --seconds <s> \\
        --rates 100,200,...

The cell's rate is then fixed in its file, at about four fifths of the
highest rate sustained."""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m perfbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    from .run import Run, cache_dirs

    cache_dirs(root)
    from . import entries
    from .spec import Benchmark
    from .stats import percentile
    from .trace import require_cards

    bench = Benchmark(root)
    workload = bench.workload(args.workload)
    require_cards(workload["chips"])
    run = Run(bench, workload, args.seed, "cuda")
    entry = entries.load(run.traffic["entry"])(run)
    entry.setup()
    for rate in (float(r) for r in args.rates.split(",")):
        entry.traffic["rate_per_s"] = rate
        entry.results.clear()
        entry.latency_ms.clear()
        entry.timer.reset()
        run.spans.clear()
        t = time.time()
        w = entry.window(args.seconds)
        lat = [entry.latency_ms.get(i, math.inf) for i in range(w.attempted)]
        q = max(1, len(lat) // 4)
        first, last = percentile(lat[:q], 50), percentile(lat[-q:], 50)
        sizes = run.spans.sizes.get("extract_batch", [])
        print(json.dumps({
            "rate": rate, "due": w.attempted, "failed": w.failed,
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "p99_ms": percentile(lat, 99), "last_over_first_p50": last / first,
            "batch_mean": sum(sizes) / len(sizes) if sizes else None,
            "rank_p50_ms": percentile(run.spans.durations_ms("identify"), 50),
            "lag_p99_ms": percentile(entry.lag_ms, 99),
            "wall_s": time.time() - t}), flush=True)
    entry.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
