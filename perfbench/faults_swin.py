"""Faults planted in the program's Swin forward
(``hse_facerec_torch.models.swin``), each of a kind that a fused windowed
attention or a patch merge could bring: the comparison of a Swin cell has
to come out not correct under every one. The CPU tests plant them at a
tiny size;

    python -m perfbench.faults_swin --workload swin-enroll --seeds 1,2 \\
        [--faults bias_zeroed,...] --seconds <s>

reads them on the card at the cell's own size (one process, one JSON line a
run: the seed, the fault and the numbers compared). The first four reach
the card through the arguments K8 is handed or the merge around it;
``mask_dropped`` empties the region labels that only the plain path reads,
so it is planted on the CPU alone."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path
from unittest import mock

import torch


def _transposed(window: int) -> torch.Tensor:
    """Token i = (y, x) of a window -> the token (x, y)."""
    i = torch.arange(window * window)
    return (i % window) * window + i // window


def _attention(edit):
    """The program's windowed attention with its arguments edited."""
    def attend(qkv, heads, window, shift, bias):
        from hse_facerec_torch.ops.kernels.attention import window_attention

        return window_attention(qkv, heads, window, *edit(window, shift, bias))
    return attend


def _bias_zeroed(window, shift, bias):
    return shift, torch.zeros_like(bias)


def _index_transposed(window, shift, bias):
    """The bias as if the relative index swapped Δy and Δx: the table read
    at (Δx + 6)·13 + (Δy + 6), which is the gathered bias with the tokens of
    both axes transposed."""
    t = _transposed(window).to(bias.device)
    return shift, bias[:, t][:, :, t].contiguous()


def _shift_dropped(window, shift, bias):
    return 0, bias


def _merge_quadrants_swapped(x, p, dt):
    from hse_facerec_torch.models import swin

    x = torch.cat([x[:, 0::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 0::2], x[:, 1::2, 1::2]],
                  dim=-1)
    return swin._linear(swin._layer_norm(x, p["norm"]), p["reduction"], dt)


def _no_regions(size, window, shift):
    n = size // window
    return torch.zeros((n * n, window * window), dtype=torch.long)


# name -> (the module, its function replaced, the replacement)
FAULTS = {
    "bias_zeroed": ("swin", "window_attention", _attention(_bias_zeroed)),
    "index_transposed": ("swin", "window_attention", _attention(_index_transposed)),
    "shift_dropped": ("swin", "window_attention", _attention(_shift_dropped)),
    "merge_quadrants_swapped": ("swin", "_merge", _merge_quadrants_swapped),
    "mask_dropped": ("attention", "region_labels", _no_regions),
}
CARD_FAULTS = ["bias_zeroed", "index_transposed", "shift_dropped", "merge_quadrants_swapped"]


@contextlib.contextmanager
def planted(name: str):
    """The program runs with fault ``name`` inside the block."""
    from hse_facerec_torch.models import swin
    from hse_facerec_torch.ops.kernels import attention

    module, attr, fn = FAULTS[name]
    with mock.patch.object({"swin": swin, "attention": attention}[module], attr, fn):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m perfbench.faults_swin")
    ap.add_argument("--workload", default="swin-enroll")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default=",".join(CARD_FAULTS))
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from .run import cache_dirs, execute, forbidden_modules

    cache_dirs(Path.cwd())
    from .spec import Benchmark
    from .trace import require_cards

    bench = Benchmark(Path.cwd())
    workload = bench.workload(args.workload)
    require_cards(workload["chips"])
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in [int(s) for s in args.seeds.split(",") if s]:
            t0 = time.time_ns()
            with planted(fault):
                result, compared = execute(bench, workload, seed, args.seconds, False, t0_ns=t0)
            print(json.dumps({"seed": seed, "fault": fault, "correct": result["correct"],
                              "numbers": {k: v for k, (v, _) in compared.items()},
                              "limits": {k: lim for k, (_, lim) in compared.items()},
                              "wall_s": (time.time_ns() - t0) / 1e9}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    if forbidden_modules():
        print(f"forbidden modules: {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
