"""Readings for the limits of a cell's comparison, on the card: the
program's numbers over many seeds (the lower readings) and the control's
(the plain reference at the precision below the configuration's, put in
the program's place) over a few, and the program's with a fault of
``perfbench/faults.py`` planted, each seed a full run of the cell at its
own size, in one process.

    python -m perfbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--faults bn_dropped,... --fault-seeds 4,5,6] \\
        --seconds <s>

Prints one JSON line per run: the seed, whether it was the control, the
fault planted, and the numbers compared."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    from .run import cache_dirs, execute, forbidden_modules

    cache_dirs(root)
    import torch

    from .faults import planted
    from .spec import Benchmark
    from .trace import require_cards

    bench = Benchmark(root)
    workload = bench.workload(args.workload)
    require_cards(workload["chips"])

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    runs = [(s, False, None) for s in seeds(args.seeds)] + \
           [(s, True, None) for s in seeds(args.control_seeds)] + \
           [(s, False, f) for f in args.faults.split(",") if f for s in seeds(args.fault_seeds)]
    for seed, control, fault in runs:
        t0 = time.time_ns()
        with planted(fault) if fault else contextlib.nullcontext():
            result, compared = execute(bench, workload, seed, args.seconds, False,
                                       t0_ns=t0, control=control)
        print(json.dumps({"seed": seed, "control": control, "fault": fault,
                          "numbers": {k: v for k, (v, _) in compared.items()},
                          "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                          "wall_s": (time.time_ns() - t0) / 1e9}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if forbidden_modules():
        print(f"forbidden modules: {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
