"""Run one cell of ``BENCHMARK.json`` on the card this process sees.

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernels' build on a
checkout's first run, seeded weights and inputs, warm-up of the cell's own
shapes) runs from process start to the window; the window drives the
cell's entry for ``--seconds``; then the peak memory is read, the
program's state freed, and the plain reference judges what the window
produced. The last line of standard output is the result, a JSON object;
the numbers compared and their limits end standard error. With
``--trace 1`` the window is traced and the cell's per-layer metrics are
reported instead of its end-to-end ones.

Exit codes: 0 with a result; 2 without a CUDA card or with too few; 3 when
JAX or the JAX package was loaded into this process."""

from __future__ import annotations

import time

T0_NS = time.time_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

# top-level module names that may not be loaded in this process
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "hse_facerec_tf_tpu"}


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds. The port's own nvcc build already
    lives there (``hse_facerec_torch/_build``)."""
    base = root / ".perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, whole, is forbidden."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def quantity(metric: str) -> str:
    """The quantity an end-to-end metric reports: its name up to the first
    dot. ``faces_per_s.multihead`` is the entry's ``faces_per_s`` in the
    cells it lists, held to a bound of its own."""
    return metric.split(".")[0]


class Run:
    """What one run knows: the cell's parts, the seed, the device, the
    host spans and the set-up phases."""

    def __init__(self, bench, workload: Dict, seed: int, device: str):
        from .trace import Spans

        self.workload = workload
        self.name = workload["name"]
        self.seed = int(seed)
        self.device = device
        self.cfg = bench.config(workload["config"])
        self.cell = bench.cell(workload["name"])
        self.traffic = {**bench.traffic(workload["traffic"]),
                        **self.cell.get("traffic_params", {})}
        self.reference = bench.reference(workload["config"])
        self.spans = Spans()
        self.phases: Dict[str, float] = {}


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, run: Run, window, trace, entry: Dict):
        self.cell, self.cfg, self.traffic = run.name, run.cfg, run.traffic
        self.spans = run.spans
        self.window = window
        self.trace = trace
        self.entry = entry


def execute(bench, workload: Dict, seed: int, seconds: float, traced: bool,
            device: str = "cuda", t0_ns: int = T0_NS,
            control: bool = False) -> Tuple[Dict, Dict]:
    """One run of ``workload``: (result, {name: (value, limit)}). With
    ``control`` the numbers compared are the control's."""
    import torch

    from . import entries
    from .trace import Tracer, card_name_and_power_limit

    run = Run(bench, workload, seed, device)
    run.traced = traced
    entry = entries.load(run.traffic["entry"])(run)
    entry.setup()
    tracer = Tracer(traced)
    tracer.prepare()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = (time.time_ns() - t0_ns) / 1e9
    tracer.start()
    window = entry.window(seconds)
    tracer.stop()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = tracer.summary()
    entry_ctx = entry.context()
    entry.release()
    checks = entry.checks(control=control)
    limits = run.cell["limits"]
    compared = {k: (checks[k], limits[k]) for k in limits}
    correct = set(checks) == set(limits) and all(v <= lim for v, lim in compared.values())

    metrics: Dict[str, Dict] = {}
    if traced:
        ctx = Context(run, window, summary, entry_ctx)
        for m in bench.per_layer(run.name):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(window.end_to_end, setup_s=setup_s)
        for m in bench.end_to_end(run.name):
            metrics[m["name"]] = {"value": values[quantity(m["name"])], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name() if on_card else device,
           "count": workload["chips"], "memory_peak_bytes": int(peak)}
    result: Dict = {"correct": bool(correct), "attempted": window.attempted,
                    "failed": window.failed, "metrics": metrics, "device": dev}
    if traced and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": summary.device_ops(),
            "idle_gaps": summary.idle_gaps(run.spans.items, entry.span_priority)}
    result["card"] = card_name_and_power_limit() if on_card else "none"
    result["setup_parts_s"] = run.phases
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result, compared


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m perfbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_dirs(root)
    from .spec import Benchmark
    from .trace import require_cards

    bench = Benchmark(root)
    workload = bench.workload(args.workload)
    try:
        require_cards(workload["chips"])
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    result, compared = execute(bench, workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, (value, limit) in compared.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
