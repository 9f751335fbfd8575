#!/usr/bin/env python3
"""Time the int8 tensor-core kernels, K4 (``pw_conv_int8``) and K2b/K2c
(``nearest_neighbor_int8q`` / ``nearest_neighbor_int8p``), through the
public wrappers of the ``hse_facerec_torch`` package under ``--root``, so
that two checkouts can be timed in turns on one card in one run:

    python3 hse_facerec_torch/int8_ab.py --root <checkout> --label <name> \\
        [--out chiprun_out/int8_ab.jsonl]

It needs a CUDA device and builds the root's kernels at first use. Every
number is measured in the run and appended to ``--out`` as one JSON line:

- ``k4_b16``: the 13 pointwise layers of MobileNet-V1 at a 16-face head
  batch, 224² (pw13 with f32 out), as a forward of 13 wrapper calls on
  operands made beforehand, in ``ROUNDS`` rounds: the host µs a forward
  (the host clock over back-to-back forwards, no sync), the ms a forward by
  CUDA events, the device ms a forward (``torch.profiler``, the K4 kernels
  alone) and the host ms, events minus device;
- ``k4_b1024`` and ``k4_b64_192``: the device-bound forwards at the int8
  embedder's batch (1024, 224²) and at ``vgg2_mobilenet_int8``'s (64,
  192²), ms a forward by CUDA events and each layer's ms;
- ``knn``: K2c and K2b (two-pass epilogue) at 16 and 8192 probes against
  2^20 gallery rows of 512 and 4096 int8 values, ms a call by CUDA events;
- ``checksums``: a digest of every answer, so that two checkouts are held
  bit-equal on the same seeded operands.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

PW_LAYERS = [("pw1", 12544, 32, 64), ("pw2", 3136, 64, 128),
             ("pw3", 3136, 128, 128), ("pw4", 784, 128, 256),
             ("pw5", 784, 256, 256), ("pw6", 196, 256, 512)] + [
    (f"pw{i}", 196, 512, 512) for i in range(7, 12)] + [
    ("pw12", 49, 512, 1024), ("pw13", 49, 1024, 1024)]
KNN_SHAPES = [(16, 1 << 20, 512), (8192, 1 << 20, 512), (16, 1 << 20, 4096),
              (8192, 1 << 20, 4096)]
ROUNDS = 3
SEED = 0


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def layer_operands(torch, gen, batch: int, size: int):
    """Seeded operands of the 13 layers: activations in [0, 127], weights in
    [-127, 127], scales that spread the outputs over [0, 6]."""
    ops = []
    for name, pixels, k, n in PW_LAYERS:
        m = (int(pixels ** 0.5) * size // 224) ** 2 * batch

        def ints(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                                 dtype=torch.int16).to(torch.int8)

        scale = (torch.rand(n, generator=gen, device="cuda") + 0.5) * (3.0 / (2700.0 * k ** 0.5))
        bias = torch.rand(n, generator=gen, device="cuda") * 4.0 - 1.0
        ops.append((name, (ints(0, 128, (m, k)), ints(-127, 128, (n, k)), scale, bias),
                    name != PW_LAYERS[-1][0]))
    return ops


def events_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, calls: int, mark: str, kernels: int) -> float:
    """Device ms a call of the kernels whose name holds ``mark`` by
    ``torch.profiler``; a session that kept fewer than ``kernels`` records
    a call runs again, three sessions at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen, us = 0, 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and mark in e.key:
                seen += e.count
                t = getattr(e, "self_device_time_total", None)
                us += t if t is not None else e.self_cuda_time_total
        if seen >= calls * kernels:
            return us / 1e3 / calls
    raise RuntimeError(f"the profiler kept {seen} of {calls * kernels} {mark} records")


def digest(h, *tensors) -> None:
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())


def forward_of(pw_conv, ops):
    """The 13 layers' wrapper calls in order, on ready operands."""
    def forward():
        for _, args, requant in ops:
            pw_conv.pw_conv_int8(*args, requant=requant)
    return forward


def k4_numbers(torch, pw_conv, h):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    ops = layer_operands(torch, gen, 16, 224)
    forward = forward_of(pw_conv, ops)
    for _, args, requant in ops:
        digest(h, pw_conv.pw_conv_int8(*args, requant=requant))
    rounds = []
    for _ in range(ROUNDS):
        forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            forward()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        ev = events_ms(torch, forward, 200)
        dev = device_ms(torch, forward, 20, "pw_conv_int8", len(PW_LAYERS))
        rounds.append({"host_us": host_us, "events_ms": ev, "device_ms": dev,
                       "host_ms": ev - dev})
    out["k4_b16"] = rounds
    del ops
    for key, batch, size in (("k4_b1024", 1024, 224), ("k4_b64_192", 64, 192)):
        ops = layer_operands(torch, gen, batch, size)
        for _, args, requant in ops:
            digest(h, pw_conv.pw_conv_int8(*args, requant=requant))
        layers = {name: events_ms(torch, lambda: pw_conv.pw_conv_int8(*args, requant=rq), 20)
                  for name, args, rq in ops}
        out[key] = {"forward_ms": [events_ms(torch, forward_of(pw_conv, ops), 10)
                                   for _ in range(ROUNDS)], "layers_ms": layers}
        del ops
        torch.cuda.empty_cache()
    return out


def knn_numbers(torch, knn, h):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {}
    for m, n, d in KNN_SHAPES:
        q = torch.randint(-127, 128, (n, d), generator=gen, device="cuda",
                          dtype=torch.int16).to(torch.int8)
        sb = torch.tensor(1.0 / 127.0, device="cuda")
        p = torch.randn((m, d), generator=gen, device="cuda")
        packed = knn.pack_quantized_gallery(q, sb)
        digest(h, *knn.nearest_neighbor_int8p(p, *packed), *knn.nearest_neighbor_int8q(p, q, sb))
        iters = 20 if m <= 16 else 3
        out[f"{m}x{n}x{d}"] = {
            "knn_int8p_ms": [events_ms(torch, lambda: knn.nearest_neighbor_int8p(p, *packed),
                                       iters, 1) for _ in range(ROUNDS)],
            "knn_int8q_ms": [events_ms(torch, lambda: knn.nearest_neighbor_int8q(p, q, sb),
                                       iters, 1) for _ in range(ROUNDS)]}
        del q, p, packed
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose hse_facerec_torch is timed")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path[0] = os.path.abspath(args.root)   # the root's package, not this file's
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("int8_ab needs a CUDA device")
    torch.backends.cuda.matmul.fp32_precision = "ieee"      # IEEE fp32 matmuls
    from hse_facerec_torch.ops.kernels import knn, pw_conv

    h = hashlib.sha256()
    t0 = time.perf_counter()
    line = {"label": args.label, "root": args.root, "card": card(),
            **k4_numbers(torch, pw_conv, h), "knn": knn_numbers(torch, knn, h)}
    line["checksums"] = h.hexdigest()
    line["seconds"] = time.perf_counter() - t0
    print(json.dumps(line))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
