#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hse_facerec_torch``) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA Hopper GPU (the
kernels are built for sm_90a). It:

1. prints the card's name and power limit and sets parity numerics
   (fp32, no TF32);
2. builds the CUDA kernels from ``hse_facerec_torch/csrc`` with nvcc;
3. holds K1 (crop) against its plain PyTorch version at the analyze
   path's three call sites, and times both with CUDA events;
4. drives the analyze path: ``FacialAnalyzer.analyze_with_rotations``
   (K1), timed, then checked against the same analyzer on the CPU;
5. holds K2a/K2b/K2c (1-NN) against their plain twins on ragged shapes
   with ties, at serving shapes (1 and 16 probes against 1,048,576
   gallery rows) and, for the int8 kernels, at the design point (8192 x
   1,048,576 x 512), timed with CUDA events;
6. drives the identify paths at full width:
   - identify: the ``agegender_identity`` extractor embeds a seeded
     gallery/probe tree through ``extract_files``, then
     ``KNNIdentifier(quantized=True)`` (K2b) and an int8
     ``EnrollmentGallery`` (K2c) rank the probes; answers equal the same
     objects on the CPU;
   - identify at scale: 2048 probes against 1,048,576 enrolled 1024-d
     embeddings through an exact ``KNNIdentifier`` (K2a on f32 operands:
     the f32 matrix would be 8 GiB), checked against the chunked f32
     twin, and ``gallery_probe_eval`` quantized (K2b), then 16-probe
     serving queries against the packed gallery (K2c), checked against
     the int8 twin;
   - analyze --gallery: ``analyze_with_rotations`` then
     ``EnrollmentGallery.identify_many`` per photo (K1 + K2c).
Each path runs with the launch counters set to 0 just before it and read
just after, and fails if it did not launch its kernels.
Weights are the shipped ones when present, seeded random ones otherwise.

Any failure raises (non-zero exit). The last two lines are a JSON summary
of the kernels and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from hse_facerec_torch import set_parity_numerics
from hse_facerec_torch.models import zoo
from hse_facerec_torch.models.mtcnn import import_mtcnn_params
from hse_facerec_torch.models.multihead import import_multihead_params
from hse_facerec_torch.ops.kernels import build
from hse_facerec_torch.ops.kernels import knn
from hse_facerec_torch.ops.distance import l2_normalize
from hse_facerec_torch.ops.kernels.crop import crop_resize
from hse_facerec_torch.ops.resize import crop_resize_bilinear
from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
from hse_facerec_torch.pipelines.gallery import EnrollmentGallery
from hse_facerec_torch.pipelines.identification import (KNNIdentifier,
                                                        gallery_probe_eval)
from hse_facerec_torch.testing import random_mtcnn_params, random_multihead_params

H, W = 480, 640
N_IMAGES = 3
# the path is host-bound: one pass over 3 photos spread 26-42 ms/image
# between runs of the same code on one card, so the median of several
ANALYZE_REPEATS = 7
SEED = 0
KERNEL_ATOL = 1e-3      # 0-255 pixel units; only the summation order differs
# (name, K boxes, out size, supersample, outside): the analyze path's calls
CROP_SHAPES = [("stage2", 128, 24, 2, "zero"),
               ("stage3", 64, 48, 2, "zero"),
               ("head", 16, 224, 1, "clamp")]
# 1-NN checks, (name, M probes, N gallery rows, D): ragged with ties, then
# serving (identify_many asks 1-16 probes of the whole gallery)
KNN_SHAPES = [("ragged", 37, 1000, 30), ("serve1", 1, 1 << 20, 512),
              ("serve16", 16, 1 << 20, 512)]
KNN_REPORT = "serve16"          # the shape whose times go in the JSON line
KNN_DESIGN = (8192, 1 << 20, 512)
DESIGN_CHECK_STRIDE = 32        # the design point's twin checks every 32nd probe
# K2a sums in another order than its twin (rtol/atol of the reference test)
KNN_F32_RTOL, KNN_F32_ATOL = 1e-4, 1e-3
N_PEOPLE, N_GALLERY, N_PROBE = 6, 3, 2          # identify path photo tree
SCALE_N, SCALE_M, SCALE_D = 1 << 20, 2048, 1024  # identify at scale
SERVE_BATCH, SERVE_QUERIES = 16, 8


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after warm-up."""
    for _ in range(warmup):
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

def unit_rows(gen, n: int, d: int):
    x = torch.randn((n, d), generator=gen, device="cuda")
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def same(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def check_knn_shape(gen, name, m, n, d, results):
    """K2b/K2c bit-equal to the int8 twin in both epilogues; K2a (f32 and
    bf16) within tolerance, and index-equal where the twin's top two
    candidates are further apart than the tolerance."""
    g = unit_rows(gen, n, d)
    g[n // 2:n // 2 + 3] = g[1:4]            # exact ties with lower rows
    p = unit_rows(gen, m, d)
    qb, sb = knn.quantize_embeddings(g)
    packed = knn.pack_quantized_gallery(qb, sb)
    for pack in (False, True):
        want = knn.nearest_neighbor_int8_plain(p, qb, sb, pack_idx=pack)
        for kname, got in (
                ("knn_int8q", knn.nearest_neighbor_int8q(p, qb, sb, pack_idx=pack)),
                ("knn_int8p", knn.nearest_neighbor_int8p(p, *packed, pack_idx=pack))):
            torch.cuda.synchronize()
            if not same(got, want):
                bad = int((got[1] != want[1]).sum())
                raise AssertionError(f"{kname} {name} pack_idx={pack}: {bad} "
                                     "indices differ or distances not bit-equal")
            results[kname]["max_abs_err"] = max(
                results[kname]["max_abs_err"],
                float((got[0] - want[0]).abs().max()))
    times = {
        "knn_int8q": cuda_ms(lambda: knn.nearest_neighbor_int8q(p, qb, sb), 20),
        "knn_int8q_plain": cuda_ms(lambda: knn.nearest_neighbor_int8_plain(
            p, qb, sb), 5),
        "knn_int8p": cuda_ms(lambda: knn.nearest_neighbor_int8p(p, *packed), 20),
    }
    times["knn_int8p_plain"] = times["knn_int8q_plain"]
    for bf16 in (False, True):
        gd, gi = knn.nearest_neighbor_f32(p, g, bf16=bf16)
        wd, wi = knn.nearest_neighbor_plain(p, g, bf16=bf16)
        torch.cuda.synchronize()
        err = float((gd - wd).abs().max())
        if not torch.allclose(gd, wd, rtol=KNN_F32_RTOL, atol=KNN_F32_ATOL):
            raise AssertionError(f"knn_f32 {name} bf16={bf16}: max abs err {err}")
        a = p.to(torch.bfloat16).float() if bf16 else p
        b = g.to(torch.bfloat16).float() if bf16 else g
        d2 = (p * p).sum(1)[:, None] + (g * g).sum(1)[None, :] - 2.0 * (a @ b.T)
        top2 = torch.topk(d2, 2, dim=1, largest=False).values
        clear = (top2[:, 1] - top2[:, 0]) > KNN_F32_ATOL + KNN_F32_RTOL * top2[:, 0].abs()
        if not torch.equal(gi[clear], wi[clear]):
            raise AssertionError(f"knn_f32 {name} bf16={bf16}: index differs "
                                 "where the top two are clearly apart")
        results["knn_f32"]["max_abs_err"] = max(results["knn_f32"]["max_abs_err"], err)
        tag = "knn_f32" if bf16 else "knn_f32_exact"
        times[tag] = cuda_ms(lambda: knn.nearest_neighbor_f32(p, g, bf16=bf16), 20)
        times[tag + "_plain"] = cuda_ms(
            lambda: knn.nearest_neighbor_plain(p, g, bf16=bf16), 5)
    print(f"knn {name}: M={m} N={n} D={d}: int8 bit-equal (both epilogues), "
          f"f32 within tolerance; ms " + json.dumps(
              {k: round(v, 4) for k, v in times.items()}))
    if name == KNN_REPORT:
        for kname in ("knn_f32", "knn_int8q", "knn_int8p"):
            results[kname].update(ms=times[kname], plain_ms=times[kname + "_plain"],
                                  shape=f"M={m} N={n} D={d}")


def check_knn_design_point(gen, results):
    """K2b/K2c at 8192 x 1,048,576 x 512: the kernels on every probe, the
    twin on every 32nd probe with the same operands (the probe scale comes
    from all probes), bit-equal; the twin timed once over all probes."""
    m, n, d = KNN_DESIGN
    g = unit_rows(gen, n, d)
    p = unit_rows(gen, m, d)
    qb, sb = knn.quantize_embeddings(g)
    packed = knn.pack_quantized_gallery(qb, sb)
    sub = torch.arange(0, m, DESIGN_CHECK_STRIDE, device="cuda")
    for pack in (False, True):
        ops = knn._int8_operands(p, knn._sumsq(qb), sb, None, pack)
        part = ops._replace(qa=ops.qa[sub], a2raw=ops.a2raw[sub])
        emin, idx = knn._rank_int8_plain(part.qa, qb, part.b2v, pack)
        want = (knn._int8_distances(part, emin, pack), idx)
        for kname, got in (
                ("knn_int8q", knn.nearest_neighbor_int8q(p, qb, sb, pack_idx=pack)),
                ("knn_int8p", knn.nearest_neighbor_int8p(p, *packed, pack_idx=pack))):
            if not same((got[0][sub], got[1][sub]), want):
                raise AssertionError(f"{kname} design point pack_idx={pack}: "
                                     "not bit-equal to the twin")
    q_ms = cuda_ms(lambda: knn.nearest_neighbor_int8q(p, qb, sb), 3, 1)
    p_ms = cuda_ms(lambda: knn.nearest_neighbor_int8p(p, *packed), 3, 1)
    plain_ms = cuda_ms(lambda: knn.nearest_neighbor_int8_plain(p, qb, sb), 1, 0)
    print(f"knn design point M={m} N={n} D={d}: int8 bit-equal on {len(sub)} "
          f"probes (1 in {DESIGN_CHECK_STRIDE}), both epilogues; "
          f"knn_int8q {q_ms:.3f} ms, knn_int8p {p_ms:.3f} ms, "
          f"plain twin (chunked, all probes) {plain_ms:.3f} ms")
    results["design_point"] = {"M": m, "N": n, "D": d, "knn_int8q_ms": q_ms,
                               "knn_int8p_ms": p_ms, "plain_ms": plain_ms}


def check_knn_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {k: {"max_abs_err": 0.0} for k in ("knn_f32", "knn_int8q", "knn_int8p")}
    for name, m, n, d in KNN_SHAPES:
        check_knn_shape(gen, name, m, n, d, results)
    check_knn_design_point(gen, results)
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

def knn_launches():
    return {"knn_f32": knn.nearest_neighbor_f32.launches,
            "knn_int8q": knn.nearest_neighbor_int8q.launches,
            "knn_int8p": knn.nearest_neighbor_int8p.launches,
            "crop_resize": crop_resize.launches}


def reset_launches():
    crop_resize.launches = 0
    knn.nearest_neighbor_f32.launches = 0
    knn.nearest_neighbor_int8q.launches = 0
    knn.nearest_neighbor_int8p.launches = 0


def people_tree(rng, root: str):
    """Seeded per-person .npy "photos" (a base image plus noise) under
    root/{gallery,probe}/<person>/, as extract_files reads them."""
    paths = {"gallery": [], "probe": []}
    labels = {"gallery": [], "probe": []}
    for person in range(N_PEOPLE):
        base = rng.rand(112, 112, 3) * 255
        for i in range(N_GALLERY + N_PROBE):
            split = "gallery" if i < N_GALLERY else "probe"
            d = os.path.join(root, split, f"person{person}")
            os.makedirs(d, exist_ok=True)
            paths[split].append(os.path.join(d, f"{i}.npy"))
            labels[split].append(f"person{person}")
            np.save(paths[split][-1], np.clip(base + rng.randn(112, 112, 3) * 20,
                                              0, 255).astype(np.uint8))
    return paths, {k: np.asarray(v) for k, v in labels.items()}


def identify_path(rng, mh_params, tmp: str):
    """The identify path at full width (224², 1024-d) on the card, then
    the same ranking objects on the CPU with the card's features."""
    paths, labels = people_tree(rng, tmp)
    gpu_ex = zoo.build_extractor("agegender_identity", batch_size=8,
                                 device="cuda", params=mh_params)
    gpu_ex.extract_files(paths["gallery"][:2], loader=np.load)   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    feats = {s: gpu_ex.extract_files(paths[s], loader=np.load) for s in paths}
    preds, idents, accs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        knn_q = KNNIdentifier(quantized=True, device=dev).fit(
            feats["gallery"], labels["gallery"])
        preds[dev] = knn_q.predict(feats["probe"])
        accs[dev] = gallery_probe_eval(feats["gallery"], labels["gallery"],
                                       feats["probe"], labels["probe"],
                                       device=dev)
        gallery = EnrollmentGallery(os.path.join(tmp, f"gallery_{dev}.npz"),
                                    device=dev)
        gallery.enroll_many(list(labels["gallery"]), feats["gallery"])
        idents[dev] = gallery.identify_many(feats["probe"])
        if dev == "cuda":
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = knn_launches()
    n = sum(len(v) for v in paths.values())
    print(f"identify path: {n} photos at 224x224 -> {feats['probe'].shape[1]}-d, "
          f"{wall * 1e3:.1f} ms on the card (extract + rank); launches "
          f"{json.dumps(launches)}; int8 accuracy "
          f"{float(np.mean(preds['cuda'] == labels['probe']))}, f32 {accs['cuda']}")
    for k in ("knn_int8q", "knn_int8p"):
        if launches[k] <= 0:
            raise AssertionError(f"the identify path launched no {k} kernel")
    if not np.all(np.isfinite(feats["gallery"])) or feats["gallery"].shape != (
            N_PEOPLE * N_GALLERY, 1024):
        raise AssertionError(f"malformed features {feats['gallery'].shape}")
    # the same objects on the CPU, from the same features
    if not np.array_equal(preds["cuda"], preds["cpu"]) or accs["cuda"] != accs["cpu"]:
        raise AssertionError(f"identify cuda {preds['cuda']} vs cpu {preds['cpu']}")
    g_lab = [(a, c) for a, _, c in idents["cuda"]]
    if g_lab != [(a, c) for a, _, c in idents["cpu"]] or not np.allclose(
            [b for _, b, _ in idents["cuda"]], [b for _, b, _ in idents["cpu"]],
            rtol=1e-6):
        raise AssertionError(f"gallery cuda {idents['cuda']} vs cpu {idents['cpu']}")
    cpu_ex = zoo.build_extractor("agegender_identity", batch_size=8,
                                 device="cpu", params=mh_params)
    cpu_feats = cpu_ex.extract_files(paths["probe"], loader=np.load)
    cos = np.sum(cpu_feats * feats["probe"], 1) / (
        np.linalg.norm(cpu_feats, axis=1) * np.linalg.norm(feats["probe"], axis=1))
    print(f"identify cuda vs cpu: predictions and gallery answers equal; "
          f"extractor min cosine {cos.min():.7f}, max abs "
          f"{np.abs(cpu_feats - feats['probe']).max():.3g}")
    if not cos.min() > 0.999:
        raise AssertionError(f"extractor cuda vs cpu cosine {cos.min()}")
    return launches


def identify_at_scale():
    """Identification at a 1,048,576-row enrollment (1024-d, four
    embeddings per identity): an exact ``KNNIdentifier`` runs K2a on f32
    operands (the f32 matrix would be 8 GiB), ``gallery_probe_eval``
    quantized runs K2b; then 16-probe serving queries against the packed
    gallery (K2c). Checked against the plain twins on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    g = unit_rows(gen, SCALE_N, SCALE_D)
    labels = np.arange(SCALE_N) // 4
    pick = torch.randint(0, SCALE_N, (SCALE_M,), generator=gen, device="cuda")
    probes = g[pick] + 0.02 * torch.randn((SCALE_M, SCALE_D), generator=gen,
                                          device="cuda")
    truth = labels[pick.cpu().numpy()]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pred_exact = KNNIdentifier(device="cuda").fit(g, labels).predict(probes)
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    acc_exact = float(np.mean(pred_exact == truth))
    acc_q = gallery_probe_eval(g, labels, probes, truth, quantized=True,
                               device="cuda")
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0 - t_exact
    gn = l2_normalize(g)                 # what the identifiers rank
    qb, sb = knn.quantize_embeddings(gn)
    packed = knn.pack_quantized_gallery(qb, sb)
    served = [knn.nearest_neighbor_int8p(probes[i:i + SERVE_BATCH], *packed)
              for i in range(0, SERVE_BATCH * SERVE_QUERIES, SERVE_BATCH)]
    torch.cuda.synchronize()
    launches = knn_launches()
    print(f"identify at scale: M={SCALE_M} N={SCALE_N} D={SCALE_D}: accuracy "
          f"exact {acc_exact} ({t_exact * 1e3:.1f} ms), int8 {acc_q} "
          f"({t_q * 1e3:.1f} ms); {SERVE_QUERIES} serving queries of "
          f"{SERVE_BATCH}; launches {json.dumps(launches)}")
    for k in ("knn_f32", "knn_int8q", "knn_int8p"):
        if launches[k] <= 0:
            raise AssertionError(f"identify at scale launched no {k} kernel")
    if not (acc_exact > 0.99 and acc_q > 0.99):
        raise AssertionError(f"identify at scale: accuracy {acc_exact} / {acc_q}")
    # the K2c answers equal the int8 twin's on the same probes
    n_served = SERVE_BATCH * SERVE_QUERIES
    for i, got in enumerate(served):
        want = knn.nearest_neighbor_int8_plain(
            probes[i * SERVE_BATCH:(i + 1) * SERVE_BATCH], qb, sb)
        if not same(got, want):
            raise AssertionError(f"serving query {i}: K2c differs from the twin")
    # the exact identifier answered what K2a on f32 operands answers, and
    # K2a agrees with the chunked f32 twin: where the two pick different
    # rows, the kernel's row ties the twin's minimum within the tolerance
    pn = l2_normalize(probes)
    gd, gi = knn.nearest_neighbor_f32(pn, gn, bf16=False)
    wd, wi = knn.nearest_neighbor_chunked(pn, gn, chunk=256, bf16=False)
    if not np.array_equal(pred_exact, labels[gi.cpu().numpy()]):
        raise AssertionError("identify at scale: the exact identifier's "
                             "answers are not K2a's")
    if not torch.allclose(gd, wd, rtol=KNN_F32_RTOL, atol=KNN_F32_ATOL):
        raise AssertionError("identify at scale: K2a distances off the twin")
    diff = gi != wi
    alt = ((pn[diff] - gn[gi[diff]]) ** 2).sum(1)
    if not torch.allclose(alt, wd[diff], rtol=KNN_F32_RTOL, atol=KNN_F32_ATOL):
        raise AssertionError("identify at scale: K2a picked a row that does "
                             "not tie the twin's minimum")
    agree = 1.0 - float(diff.float().mean())
    print(f"identify at scale: K2c bit-equal to the twin on {n_served} served "
          f"probes; exact identifier = K2a (f32); K2a vs chunked f32 twin "
          f"index agreement {agree}, max abs err "
          f"{float((gd - wd).abs().max()):.3g}")
    if agree < 0.99:
        raise AssertionError(f"K2a index agreement {agree}")
    return launches


def analyze_gallery_path(gpu, images, tmp: str):
    """``analyze --gallery`` (cmd_analyze): each photo is analyzed and its
    faces named with one ``identify_many``, against a gallery holding the
    faces of the first photo that has any. The answers must equal those of
    the same gallery on the CPU."""
    enrolled = next(faces for faces, _ in map(gpu.analyze_with_rotations, images)
                    if faces)                 # also the warm-up
    names = [f"face{i}" for i in range(len(enrolled))]
    feats = np.stack([f.identity for f in enrolled])
    galleries = {dev: EnrollmentGallery(os.path.join(tmp, f"people_{dev}.npz"),
                                        device=dev) for dev in ("cuda", "cpu")}
    for gallery in galleries.values():
        gallery.enroll_many(names, feats)
    torch.cuda.synchronize()
    reset_launches()
    answers = []
    for img in images:
        faces, _ = gpu.analyze_with_rotations(img)
        if faces:
            probes = np.stack([np.asarray(f.identity, np.float32) for f in faces])
            answers.append((probes, galleries["cuda"].identify_many(probes)))
    torch.cuda.synchronize()
    launches = knn_launches()
    print(f"analyze --gallery: {len(images)} photos, {len(enrolled)} faces "
          f"enrolled; first answers {answers[0][1] if answers else None}; "
          f"launches {json.dumps(launches)}")
    if launches["crop_resize"] <= 0 or launches["knn_int8p"] <= 0:
        raise AssertionError("analyze --gallery did not launch K1 and K2c")
    self_matches = 0
    for probes, got in answers:
        want = galleries["cpu"].identify_many(probes)
        if [(a, c) for a, _, c in got] != [(a, c) for a, _, c in want] or not \
                np.allclose([b for _, b, _ in got], [b for _, b, _ in want],
                            rtol=1e-6):
            raise AssertionError(f"analyze --gallery cuda {got} vs cpu {want}")
        self_matches += sum(b < 0.05 for _, b, _ in got)
    print(f"analyze --gallery: cuda answers equal the cpu gallery's; "
          f"{self_matches} faces within 0.05 of an enrollment")
    return launches


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

    # --- main paths: counts set to 0 just before each, read just after ---
    mtcnn_params, mh_params = load_params()
    gpu = FacialAnalyzer(mtcnn_params, mh_params, device="cuda")
    images = load_images(rng)
    gpu.analyze_with_rotations(images[0])      # warm-up: cuDNN and allocator
    torch.cuda.synchronize()
    reset_launches()
    repeats = []
    for _ in range(ANALYZE_REPEATS):
        t0 = time.perf_counter()
        outputs = [gpu.analyze_with_rotations(img) for img in images]
        torch.cuda.synchronize()
        repeats.append((time.perf_counter() - t0) * 1e3 / len(images))
    path_launches = [knn_launches()]
    for i, (faces, rot) in enumerate(outputs):
        print(f"image {i}: {len(faces)} faces, rotation {rot}: " + json.dumps(
            [{"bbox": list(f.bbox), "age": round(f.age, 2),
              "gender_prob": round(f.gender_prob, 4)} for f in faces[:8]]))
        for f in faces:
            if not (np.all(np.isfinite(f.identity)) and f.identity.shape == (1024,)
                    and np.isfinite(f.age) and 0.0 <= f.gender_prob <= 1.0):
                raise AssertionError(f"image {i}: malformed face {f}")
    print(f"analyze_with_rotations: median {float(np.median(repeats)):.3f} "
          f"ms/image over {ANALYZE_REPEATS} repeats of {len(images)} images "
          f"(each {[round(r, 3) for r in repeats]}); launches "
          f"{json.dumps(path_launches[0])}")
    if path_launches[0]["crop_resize"] <= 0:
        raise AssertionError("the analyze path launched no crop_resize kernel")

    cpu = FacialAnalyzer(mtcnn_params, mh_params, device="cpu")
    compare_analyzers(gpu, cpu, images[0])

    # the 1-NN kernel checks allocate tens of GB: after the analyze timing
    knn_results = check_knn_kernels()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        path_launches.append(identify_path(rng, mh_params, tmp))
        path_launches.append(identify_at_scale())
        torch.cuda.empty_cache()
        path_launches.append(analyze_gallery_path(gpu, images, tmp))
    launches = {k: sum(p[k] for p in path_launches) for k in path_launches[0]}

    # crop ms / plain_ms: the sum over the three call-site shapes, i.e. one
    # image's crop passes at the default caps; knn: the serve16 shape
    errs, ms, plain = zip(*crop_results)
    kernels = [{
        "name": "crop_resize", "route": "cuda",
        "source": "hse_facerec_torch/csrc/crop_resize.cu",
        "replaces": "hse_facerec_tf_tpu/ops/pallas/crop.py:103",
        "launches": launches["crop_resize"], "max_abs_err": max(errs),
        "ms": sum(ms), "plain_ms": sum(plain)}]
    for name, line in (("knn_f32", 159), ("knn_int8q", 313), ("knn_int8p", 439)):
        r = knn_results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "hse_facerec_torch/csrc/knn.cu",
            "replaces": f"hse_facerec_tf_tpu/ops/pallas/knn.py:{line}",
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "equal": name != "knn_f32", "ms": r["ms"], "plain_ms": r["plain_ms"],
            "shape": r["shape"]})
    print("knn design point: " + json.dumps(knn_results["design_point"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
