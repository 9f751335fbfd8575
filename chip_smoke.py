#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hse_facerec_torch``) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA Hopper GPU (the
kernels are built for sm_90a). It:

1. prints the card's name and power limit and sets parity numerics
   (fp32, no TF32);
2. builds the CUDA kernels from ``hse_facerec_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version at the shapes the
   analyze path gives it, and times both with CUDA events;
4. drives ``FacialAnalyzer.analyze_with_rotations`` on the card at full
   width (shipped weights when present, seeded random ones otherwise),
   shows through the launch counters that the path ran the kernels, and
   checks the card's results against the same analyzer on the CPU.

Any failure raises (non-zero exit). The last two lines are a JSON summary
of the kernels and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from hse_facerec_torch import set_parity_numerics
from hse_facerec_torch.models import zoo
from hse_facerec_torch.models.mtcnn import import_mtcnn_params
from hse_facerec_torch.models.multihead import import_multihead_params
from hse_facerec_torch.ops.kernels import build
from hse_facerec_torch.ops.kernels.crop import crop_resize
from hse_facerec_torch.ops.resize import crop_resize_bilinear
from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
from hse_facerec_torch.testing import random_mtcnn_params, random_multihead_params

H, W = 480, 640
N_IMAGES = 3
SEED = 0
KERNEL_ATOL = 1e-3      # 0-255 pixel units; only the summation order differs
# (name, K boxes, out size, supersample, outside): the analyze path's calls
CROP_SHAPES = [("stage2", 128, 24, 2, "zero"),
               ("stage3", 64, 48, 2, "zero"),
               ("head", 16, 224, 1, "clamp")]


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def crop_boxes(rng, k: int):
    """Seeded [y1, x1, y2, x2] boxes, some partly and two fully off the image."""
    y1 = rng.uniform(-60, H - 10, k)
    x1 = rng.uniform(-60, W - 10, k)
    size = rng.uniform(6, 300, k)
    boxes = np.stack([y1, x1, y1 + size, x1 + size], 1).astype(np.float32)
    boxes[0] = [-80, -80, -20, -20]
    boxes[1] = [H + 10, W + 10, H + 60, W + 60]
    return boxes


def check_crop_kernel(rng):
    img = torch.from_numpy((rng.rand(H, W, 3) * 255).astype(np.float32)).cuda()
    results = []
    for name, k, out, s, outside in CROP_SHAPES:
        boxes = torch.from_numpy(crop_boxes(rng, k)).cuda()
        got = crop_resize(img, boxes, out, s, outside)
        want = crop_resize_bilinear(img, boxes, out, s, outside)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: crop_resize(img, boxes, out, s, outside), 200)
        plain_ms = cuda_ms(lambda: crop_resize_bilinear(img, boxes, out, s, outside), 50)
        print(f"crop_resize {name}: K={k} out={out} s={s} outside={outside} "
              f"max_abs_err={err:.3g} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"crop_resize {name}: max abs err {err} > {KERNEL_ATOL}")
        results.append((err, ms, plain_ms))
    return results


def smooth_images(rng, n: int):
    """Seeded synthetic photos: low-frequency colour fields plus noise."""
    low = torch.from_numpy(rng.rand(n, 3, 12, 16).astype(np.float32) * 255)
    img = F.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    img = img + torch.from_numpy(rng.randn(n, 3, H, W).astype(np.float32) * 12)
    img = img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return [np.ascontiguousarray(a) for a in img.numpy()]


def load_images(rng):
    """The reference fixture (downscaled to fit 640x480, as the reference
    demos do) when it and cv2 are present, then seeded synthetic photos."""
    fixture = os.path.join(os.path.dirname(zoo.MTCNN_PB), "test_image.jpg")
    images = []
    if os.path.exists(fixture) and importlib.util.find_spec("cv2") is not None:
        import cv2

        img = cv2.cvtColor(cv2.imread(fixture), cv2.COLOR_BGR2RGB)
        scale = min(W / img.shape[1], H / img.shape[0], 1.0)
        images.append(cv2.resize(img, (int(img.shape[1] * scale),
                                       int(img.shape[0] * scale))))
        print(f"image 0: fixture {fixture} at {images[0].shape[1]}x{images[0].shape[0]}")
    else:
        print("fixture photo or cv2 not available: synthetic images only")
    return images + smooth_images(rng, N_IMAGES - len(images))


def load_params():
    if os.path.exists(zoo.MTCNN_PB) and os.path.exists(zoo.AGEGENDER_PB):
        print(f"weights: shipped ({zoo.MTCNN_PB}, {zoo.AGEGENDER_PB})")
        return (import_mtcnn_params(zoo.MTCNN_PB),
                import_multihead_params(zoo.AGEGENDER_PB))
    print("!!! WEIGHTS: shipped pbs not found at "
          f"{os.path.dirname(zoo.MTCNN_PB)} — using SEEDED RANDOM weights "
          f"(seed {SEED}); faces and ages are meaningless, parity is not !!!")
    return (random_mtcnn_params(np.random.RandomState(SEED + 2)),
            random_multihead_params(np.random.RandomState(SEED + 100)))


def compare_analyzers(gpu, cpu, img):
    """The card's results against the CPU's on one image."""
    g = gpu.analyze_core(gpu.detector.upload(img))
    c = cpu.analyze_core(cpu.detector.upload(img))
    g_valid, c_valid = g[4].cpu().numpy(), c[4].cpu().numpy()
    if not np.array_equal(g_valid, c_valid):
        raise AssertionError(f"valid masks differ: cuda {g_valid} cpu {c_valid}")
    faces_g, faces_c = gpu.analyze(img), cpu.analyze(img)
    if len(faces_g) != len(faces_c):
        raise AssertionError(f"face count: cuda {len(faces_g)} cpu {len(faces_c)}")
    worst = {"box_px": 0.0, "age": 0.0, "gender": 0.0, "min_cos": 1.0}
    for a, b in zip(faces_g, faces_c):
        worst["box_px"] = max(worst["box_px"],
                              float(np.abs(np.subtract(a.raw_bbox, b.raw_bbox)).max()))
        worst["age"] = max(worst["age"], abs(a.age - b.age))
        worst["gender"] = max(worst["gender"], abs(a.gender_prob - b.gender_prob))
        cos = float(np.dot(a.identity, b.identity)
                    / (np.linalg.norm(a.identity) * np.linalg.norm(b.identity)))
        worst["min_cos"] = min(worst["min_cos"], cos)
    print(f"cuda vs cpu on image 0: {len(faces_g)} faces, valid masks equal, "
          f"worst {json.dumps(worst)}")
    if not (worst["box_px"] <= 1.0 and worst["age"] <= 1e-2
            and worst["gender"] <= 1e-3 and worst["min_cos"] > 0.999):
        raise AssertionError(f"cuda vs cpu disagree: {worst}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")

    print(gpu_name_and_power_limit())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    set_parity_numerics()

    # --- build ---
    print(f"nvcc: {build.find_nvcc()}; triton importable: "
          f"{importlib.util.find_spec('triton') is not None}")
    t0 = time.perf_counter()
    build.load_library()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"({build.library_path()})")
    log = build.library_path().parent / "build.log"
    if log.exists():
        print(log.read_text().strip())

    # --- kernel vs plain ---
    rng = np.random.RandomState(SEED)
    crop_results = check_crop_kernel(rng)

    # --- main path ---
    mtcnn_params, mh_params = load_params()
    gpu = FacialAnalyzer(mtcnn_params, mh_params, device="cuda")
    images = load_images(rng)
    gpu.analyze_with_rotations(images[0])      # warm-up: cuDNN and allocator
    torch.cuda.synchronize()
    crop_resize.launches = 0
    t0 = time.perf_counter()
    outputs = [gpu.analyze_with_rotations(img) for img in images]
    torch.cuda.synchronize()
    ms_per_image = (time.perf_counter() - t0) * 1e3 / len(images)
    launches = crop_resize.launches
    for i, (faces, rot) in enumerate(outputs):
        print(f"image {i}: {len(faces)} faces, rotation {rot}: " + json.dumps(
            [{"bbox": list(f.bbox), "age": round(f.age, 2),
              "gender_prob": round(f.gender_prob, 4)} for f in faces[:8]]))
        for f in faces:
            if not (np.all(np.isfinite(f.identity)) and f.identity.shape == (1024,)
                    and np.isfinite(f.age) and 0.0 <= f.gender_prob <= 1.0):
                raise AssertionError(f"image {i}: malformed face {f}")
    print(f"analyze_with_rotations: {ms_per_image:.3f} ms/image over "
          f"{len(images)} images; crop_resize launches {launches}")
    if launches <= 0:
        raise AssertionError("the analyze path launched no crop_resize kernel")

    cpu = FacialAnalyzer(mtcnn_params, mh_params, device="cpu")
    compare_analyzers(gpu, cpu, images[0])

    # ms / plain_ms: the sum over the three call-site shapes, i.e. one
    # image's crop passes at the default caps
    errs, ms, plain = zip(*crop_results)
    print(json.dumps({"kernels": [{
        "name": "crop_resize", "route": "cuda",
        "source": "hse_facerec_torch/csrc/crop_resize.cu",
        "replaces": "hse_facerec_tf_tpu/ops/pallas/crop.py:103",
        "launches": launches, "max_abs_err": max(errs),
        "ms": sum(ms), "plain_ms": sum(plain)}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
