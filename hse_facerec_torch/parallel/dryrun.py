"""The multi-device dry run: every sharded path against its single-device run.

Counterpart of the JAX package's ``dryrun_multichip`` (``__graft_entry__
.py:33-240``), on seeded weights and synthetic photos instead of the
shipped pbs and the fixture photo. Each section runs on an ``n_devices``
mesh and again on one device, from the same seeds, and asserts that the
values agree:

1. the dp x tp face-ID step (f32): loss within 1e-4 relative, accuracy equal;
2. the alternating age/gender pair over both axes: losses within 1e-4
   relative (f32 for the first step; the second step, after an update, in
   float64 compute: see ``_pair``);
3. the batch-parallel embed: within 1e-5;
4. the sharded ``detect_batch_core``: every lane finds a face, outputs
   within 1e-4;
5. mesh ``analyze_batch``: boxes equal, ages and identity within 1e-3;
6. the sharded 1-NN, f32 and int8, against a float64 host argmin;
7. the mesh gallery: 13 enrollments over the data axis (padded shards).

With fewer cards than ``n_devices`` the cards repeat (virtual shards), and
the run says so.

    python -m hse_facerec_torch.parallel.dryrun [n_devices] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, List

import numpy as np
import torch

from ..models.mobilenet import init_mobilenet_params, mobilenet_embed
from ..params import to_numpy
from ..pipelines.detector import resolve_device
from ..testing import random_mtcnn_params, random_multihead_params, synthetic_photo
from .knn import nearest_neighbor_sharded
from .sharding import Mesh, make_mesh, split_batch, to_device
from .train_step import run_one_sharded_age_gender_pair, run_one_sharded_step

# the seeded analyze setting of the parity tests: 96x128 photos, minsize
# 20, reduced caps, 64² face crops
PHOTO_HW = (96, 128)
ANALYZER_KW = dict(minsize=20, face_size=64, head_batch=4, max_level_boxes=64,
                   max_stage2=16, max_stage3=8, max_escalations=0)


def mesh_devices(n_devices: int, device="cuda") -> List[torch.device]:
    """``n_devices`` shard devices: the cards in turn on CUDA (repeated when
    there are fewer), ``device`` repeated otherwise."""
    device = resolve_device(device)
    if device.type == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(min(torch.cuda.device_count(), n_devices))]
    else:
        cards = [device]
    return [cards[i % len(cards)] for i in range(n_devices)]


def detect_batch_sharded(detector, mesh: Mesh, images: np.ndarray, tier: int = 0):
    """``detect_batch_core`` with the lanes split over every shard of
    ``mesh`` (a detector replica per device), gathered on the host."""
    shards = mesh.shard_devices()
    replicas = mesh.replicate(detector, to_device)
    outs = [replicas[d].detect_batch_core(x, tier)
            for d, x in zip(shards, split_batch(images, shards))]
    return [np.concatenate([o[i].cpu().numpy() for o in outs]) for i in range(5)]


def _close(got: float, want: float, rtol: float, what: str, atol: float = 0.0) -> None:
    if not abs(got - want) <= atol + rtol * abs(want):
        raise AssertionError(f"{what}: sharded {got} vs single-device {want}")


def _pair(mesh: Mesh, single: Mesh, batch: int) -> Dict[str, float]:
    """The sharded age/gender pair against the single-device one. The age
    step's loss is a forward of the initial weights, held in f32. The
    gender step runs after one Adam update, which turns the f32 rounding of
    gradients near zero into sign flips of ``lr·g/(|g| + eps)``; so it is
    held in float64 compute, where none lie that close."""
    got = run_one_sharded_age_gender_pair(mesh, batch=batch, compute_dtype=torch.float32)
    want = run_one_sharded_age_gender_pair(single, batch=batch,
                                           compute_dtype=torch.float32)
    _close(got["age_loss"], want["age_loss"], 1e-4, "age/gender pair: age loss")
    got64 = run_one_sharded_age_gender_pair(mesh, batch=batch, compute_dtype=torch.float64)
    want64 = run_one_sharded_age_gender_pair(single, batch=batch,
                                             compute_dtype=torch.float64)
    for k in ("age_loss", "gender_loss"):
        _close(got64[k], want64[k], 1e-4, f"age/gender pair (float64): {k}")
    assert all(math.isfinite(v) for v in got.values()), got
    return got


def dryrun_multichip(n_devices: int = 8, device="cuda") -> Dict:
    """Run every sharded path over an ``n_devices`` mesh against its
    single-device run; raises on a disagreement. Returns what it measured."""
    from ..ops.kernels.crop import crop_resize
    from ..pipelines.analyzer import FacialAnalyzer
    from ..pipelines.embedder import EmbeddingExtractor
    from ..pipelines.gallery import EnrollmentGallery

    devices = mesh_devices(n_devices, device)
    distinct = list(dict.fromkeys(devices))
    note = ("" if len(distinct) == n_devices else
            f" ({n_devices} virtual shards on {len(distinct)} device(s): "
            f"{', '.join(map(str, distinct))} repeated)")
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // tp
    mesh = make_mesh((dp, tp), ("data", "model"), devices)
    single = make_mesh((1, 1), ("data", "model"), devices[:1])
    flat = make_mesh((n_devices,), ("data",), devices)
    home = devices[0]
    batch0 = 2 * dp * tp
    out: Dict = {"mesh": [dp, tp], "devices": [str(d) for d in devices]}

    # 1. the dp x tp face-ID step, f32
    metrics = run_one_sharded_step(mesh, n_classes=64, batch=batch0, image_size=32,
                                   compute_dtype=torch.float32)
    want = run_one_sharded_step(single, n_classes=64, batch=batch0, image_size=32,
                                compute_dtype=torch.float32)
    assert math.isfinite(metrics["loss"]), metrics
    _close(metrics["loss"], want["loss"], 1e-4, "face-ID loss", atol=1e-5)
    _close(metrics["acc"], want["acc"], 0.0, "face-ID accuracy", atol=1e-6)
    out["face_id"] = metrics

    # 2. the alternating age/gender pair, data parallel over both axes
    out["age_gender"] = _pair(mesh, single, batch0)

    # 3. the batch-parallel embed over every shard
    params = to_numpy(init_mobilenet_params(torch.Generator().manual_seed(0),
                                            n_classes=8, device="cpu"))
    images = np.random.RandomState(0).rand(batch0, 32, 32, 3).astype(np.float32)
    emb = EmbeddingExtractor(mobilenet_embed, params, (32, 32), normalization="none",
                             batch_size=batch0, mesh=mesh).extract_batch(images)
    want_emb = EmbeddingExtractor(mobilenet_embed, params, (32, 32),
                                  normalization="none", batch_size=batch0,
                                  device=home).extract_batch(images)
    assert emb.shape[0] == batch0 and np.isfinite(emb).all()
    np.testing.assert_allclose(emb, want_emb, rtol=1e-5, atol=1e-5)
    out["embed_shape"] = list(emb.shape)

    # 4. the sharded detection cascade, one photo a lane with shifted levels
    mtcnn_np = random_mtcnn_params(np.random.RandomState(2))
    mh_np = random_multihead_params(np.random.RandomState(100))
    base = synthetic_photo(2, *PHOTO_HW).astype(np.int16)
    lanes = np.stack([np.clip(base + 3 * i, 0, 255) for i in range(n_devices)]
                     ).astype(np.uint8)
    plain = FacialAnalyzer(mtcnn_np, mh_np, device=home, **ANALYZER_KW)
    dout = detect_batch_sharded(plain.detector, flat, lanes)
    want_d = [t.cpu().numpy() for t in plain.detector.detect_batch_core(
        plain.detector.upload(lanes))]
    per_lane = dout[3].sum(axis=1)
    if not (per_lane >= 1).all():
        raise AssertionError(f"sharded cascade missed faces in some lanes: {per_lane}")
    for g, w in zip(dout, want_d):
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   rtol=1e-4, atol=1e-4)
    out["detect_boxes_shape"] = list(dout[0].shape)

    # 5. mesh analyze_batch: the compacted program per shard
    sharded = FacialAnalyzer(mtcnn_np, mh_np, mesh=flat, **ANALYZER_KW)
    batch = np.concatenate([lanes, lanes])
    before = crop_resize.launches
    got_faces = sharded.analyze_batch(batch)
    k1 = crop_resize.launches - before
    if home.type == "cuda" and k1 != 3 * n_devices:
        raise AssertionError(f"mesh analyze_batch launched K1 {k1} times, "
                             f"want 3 x {n_devices} shards")
    want_faces = plain.analyze_batch(batch)
    if not all(got_faces):
        raise AssertionError(f"lanes without faces: {[len(f) for f in got_faces]}")
    assert [len(f) for f in got_faces] == [len(f) for f in want_faces]
    for gf_lane, wf_lane in zip(got_faces, want_faces):
        for gf, wf in zip(gf_lane, wf_lane):
            assert gf.bbox == wf.bbox, (gf.bbox, wf.bbox)
            np.testing.assert_allclose(gf.age, wf.age, atol=1e-3)
            np.testing.assert_allclose(gf.identity, wf.identity, atol=1e-3)
    out["analyze_batch"] = {"lanes": len(batch), "faces": sum(map(len, got_faces)),
                            "k1_launches": k1}

    # 6. the gallery-sharded 1-NN, f32 and int8, against a float64 argmin
    gen = torch.Generator().manual_seed(2)
    probes = torch.randn((12, 16), generator=gen)
    gallery = torch.randn((100, 16), generator=gen)
    host_d = ((probes.double()[:, None, :] - gallery.double()[None]) ** 2).sum(-1).numpy()
    host_idx = host_d.argmin(axis=1)
    dev_p, dev_g = probes.to(home), gallery.to(home)
    kd, ki = nearest_neighbor_sharded(dev_p, dev_g, flat)
    np.testing.assert_array_equal(ki.cpu().numpy(), host_idx)
    np.testing.assert_allclose(kd.cpu().numpy(), host_d.min(axis=1), rtol=1e-4, atol=1e-5)
    kd8, ki8 = nearest_neighbor_sharded(dev_p, dev_g, flat, int8=True)
    np.testing.assert_array_equal(ki8.cpu().numpy(), host_idx)
    np.testing.assert_allclose(kd8.cpu().numpy(), host_d.min(axis=1), rtol=0.05, atol=0.05)

    # 7. the serving gallery over the mesh: 13 rows, so shards are padded
    store = EnrollmentGallery(mesh=flat)
    store.enroll_many([f"id{i}" for i in range(13)], gallery[:13].numpy())
    hits = store.identify_many(gallery[:3].numpy() * 2.0, threshold=0.5)
    assert [h[0] for h in hits] == ["id0", "id1", "id2"], hits

    print(f"dryrun_multichip ok: mesh=({dp}x{tp}){note} face_id={out['face_id']} "
          f"age_gender={out['age_gender']} embed_shape={out['embed_shape']} "
          f"detect_boxes_shape={out['detect_boxes_shape']} "
          f"analyze_batch={out['analyze_batch']}")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
