"""Faults planted in the program's ViT forward
(``hse_facerec_torch.models.vit``), each of a kind that a fused attention
or a folded LayerNorm could bring: the comparison of a ViT cell has to come
out not correct under every one. The CPU tests plant them at a tiny size;

    python -m perfbench.faults_vit --workload vit-enroll --seeds 1,2 \\
        [--faults scale_dropped,...] --seconds <s>

reads them on the card at the cell's own size (one process, one JSON line a
run: the seed, the fault and the numbers compared)."""

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
import torch.nn.functional as F


def _attention(scale_on: bool = True, softmax_dim: int = -1, interleave: bool = False):
    """Softmax attention over (B, T, 3·H·D) qkv in plain torch, with the
    scale left out, the softmax over the queries, or the heads' channels
    interleaved in the output on request."""
    def attend(qkv, heads):
        b, t, width = qkv.shape
        d = width // (3 * heads)
        q, k, v = qkv.reshape(b, t, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        s = q @ k.transpose(-2, -1)
        if scale_on:
            s = s * d ** -0.5
        o = torch.softmax(s, dim=softmax_dim) @ v                # (B, H, T, D)
        o = o.permute(0, 2, 3, 1) if interleave else o.transpose(1, 2)
        return o.reshape(b, t, heads * d)
    return attend


def _tokens_without_positions(params, x, dt):
    x = x.to(torch.float32).div(255.0).sub(0.5).div(0.5).permute(0, 3, 1, 2)
    w = params["patch_embed"]["kernel"]
    t = F.conv2d(x.to(dt), w.to(dt), stride=w.shape[-1]).to(torch.float32)
    return (t + params["patch_embed"]["bias"].reshape(1, -1, 1, 1)).flatten(2).transpose(1, 2)


def _head_without_final_mean(params, x, dt):
    from hse_facerec_torch.models import vit

    p = params["norm"]
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    x = (x * torch.rsqrt(var + vit.LN_EPS) * p["gamma"] + p["beta"]).reshape(x.shape[0], -1)
    x = vit._bn(vit._linear(x, params["fc1"], dt), params["bn1"])
    return vit._bn(vit._linear(x, params["fc2"], dt), params["bn2"])


# name -> (the vit module's function replaced, its replacement)
FAULTS = {
    "scale_dropped": ("attention", _attention(scale_on=False)),
    "softmax_over_queries": ("attention", _attention(softmax_dim=-2)),
    "heads_interleaved": ("attention", _attention(interleave=True)),
    "pos_embed_dropped": ("_tokens", _tokens_without_positions),
    "final_ln_mean_dropped": ("_head", _head_without_final_mean),
}


@contextlib.contextmanager
def planted(name: str):
    """The program runs with fault ``name`` inside the block."""
    from hse_facerec_torch.models import vit

    attr, fn = FAULTS[name]
    with mock.patch.object(vit, attr, fn):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m perfbench.faults_vit")
    ap.add_argument("--workload", default="vit-enroll")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
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
