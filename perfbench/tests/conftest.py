"""A tiny copy of the benchmark: the same files, with the configurations'
depth and the traffic's sizes cut so that a cell runs on the CPU in
seconds. Widths the port fixes (the MTCNN, MobileNet's 13 blocks, the
inputs' sizes) stay."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# the cells built and held back (PERF.md, Open questions), read from their
# own files: cell -> (configuration, traffic, the end-to-end quantity its
# entry reports, its unit); their per-layer metrics are the readers in
# ``metrics/`` whose names end in the cell's tag
HELD = {
    "multihead-album": ("mobilenet-multihead", "closed-album-32", "photos_per_s", "photos/s"),
    "arcface-identify": ("iresnet100-arcface", "open-identify-poisson", "query_p95_ms", "ms"),
}


def held_tag(cell: str) -> str:
    return cell.split("-")[-1]


def held_entries(pkg: Path) -> dict:
    """BENCHMARK.json entries for the held cells, made from their files."""
    out = {"workloads": [], "end_to_end": [], "per_layer": []}
    for cell, (config, traffic, quantity, unit) in HELD.items():
        out["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                 "chips": 1, "why": "held back"})
        out["end_to_end"].append({"name": quantity, "unit": unit, "better": "lower",
                                  "bound": 0.25, "source": "host_clock", "workloads": [cell]})
        for reader in sorted((pkg / "metrics").glob(f"*.{held_tag(cell)}.py")):
            out["per_layer"].append({"name": reader.stem, "unit": "%", "better": "higher",
                                     "source": "host_clock", "layer": "held", "moves": quantity,
                                     "workloads": [cell]})
    return out


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    for key, value in changes.items():
        if isinstance(value, dict) and isinstance(data.get(key), dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data))


def make_tiny(dst: Path) -> Path:
    pkg = dst / "perfbench"
    shutil.copytree(REPO / "perfbench", pkg, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    # the admitted cells and the ones held back
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for key, entries in held_entries(pkg).items():
        bench[key] += entries
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    _edit(pkg / "configs/iresnet100-arcface.json", units=[1, 1, 1, 1],
          widths=[8, 8, 16, 16, 32], embedding_dim=16)
    cfg = json.loads((pkg / "configs/mobilenet-multihead.json").read_text())
    _edit(pkg / "configs/mobilenet-multihead.json", stem_width=8, identity_dim=32, feats_dim=8,
          blocks=[[s, 8 * (1 + i // 4)] for i, (s, _) in enumerate(cfg["blocks"])])
    _edit(pkg / "traffic/closed-embed-1024.json", batch=16, batch_size=8, pool=32,
          check_per_call=2, check_sample=8, warmup_calls=1)
    _edit(pkg / "traffic/open-identify-poisson.json", gallery_rows=3000, enrolled=64,
          probe_pool=32, check_sample=16, clients=64, max_batch=8)
    _edit(pkg / "cells/arcface-identify.json", traffic_params={"rate_per_s": 40})
    _edit(pkg / "traffic/closed-album-32.json", photo_hw=[120, 160], pool=8, batch=4,
          check_sample=8)
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(root, Benchmark) of a tiny copy, shared by the session's tests."""
    from perfbench.spec import Benchmark

    root = make_tiny(tmp_path_factory.mktemp("tiny"))
    return root, Benchmark(root, pkg=root / "perfbench")


def run_tiny(bench, cell: str, seed: int = 2 ** 31 + 12345, seconds: float = 1.5,
             traced: bool = False, control: bool = False):
    import time

    from perfbench import run

    return run.execute(bench, bench.workload(cell), seed, seconds, traced, device="cpu",
                       t0_ns=time.time_ns(), control=control)
