"""The plain references against the port at tiny sizes on the CPU: the
same seeded weights and inputs through both."""

from __future__ import annotations

import json

import numpy as np
import torch

from perfbench import inputs, weights
from perfbench.spec import load_module

from .conftest import REPO

IRESNET = {"units": [1, 2, 1, 1], "widths": [8, 8, 16, 16, 32], "input_size": 112,
           "embedding_dim": 16, "model": "iresnet", "name": "iresnet100-arcface"}


def _ref(name):
    return load_module(REPO / "perfbench" / "reference" / f"{name}.py")


def _multihead_cfg():
    cfg = json.loads((REPO / "perfbench/configs/mobilenet-multihead.json").read_text())
    cfg.update(stem_width=8, feats_dim=8, identity_dim=32,
               blocks=[[s, 8 * (1 + i // 4)] for i, (s, _) in enumerate(cfg["blocks"])])
    return cfg


def test_iresnet_reference_matches_the_port():
    from hse_facerec_torch.models.zoo import build_extractor

    params = weights.iresnet(IRESNET, 5, "cpu")
    crops = inputs.images(6, 112, 112, 5, "t", "cpu")
    port = build_extractor("insightface_arcface", batch_size=8, device="cpu", params=params)
    got = port.extract_batch(crops)
    ref = _ref("iresnet100-arcface").embed(params, crops, "cpu", IRESNET).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert np.allclose(np.linalg.norm(ref, axis=1), 1.0, atol=1e-6)


def test_multihead_reference_matches_the_port():
    from hse_facerec_torch.models.multihead import expected_age_top_k, multihead_apply
    from hse_facerec_torch.params import to_torch

    cfg = _multihead_cfg()
    params = weights.mobilenet_multihead(cfg, 9, "cpu")
    crops = inputs.images(4, 224, 224, 9, "t", "cpu").astype(np.float32)
    x = torch.flip(torch.from_numpy(crops), dims=(-1,)) - torch.tensor((103.939, 116.779, 123.68))
    out = multihead_apply(to_torch(params, "cpu"), x)
    ages, male, ident = _ref("mobilenet-multihead").heads(params, crops, "cpu", cfg)
    np.testing.assert_allclose(ident, out.identity, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(male, out.gender_prob, atol=1e-6)
    np.testing.assert_allclose(ages, 1.0 + expected_age_top_k(out.age_probs), atol=1e-4)


def test_mtcnn_cascade_reference_matches_the_port_face_for_face():
    from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer

    cfg = _multihead_cfg()
    mt = weights.mtcnn(3, "cpu")
    params = weights.mobilenet_multihead(cfg, 3, "cpu")
    photos = inputs.images(4, 120, 160, 3, "photos", "cpu")
    port = FacialAnalyzer(mt, params, device="cpu").analyze_batch(photos)
    ref = _ref("mobilenet-multihead")
    faces = 0
    for photo, got in zip(photos, port):
        r = ref.analyze(mt, params, photo, "cpu", cfg)
        assert len(r["boxes"]) == len(got)
        for i, f in enumerate(got):
            np.testing.assert_allclose(f.raw_bbox, r["boxes"][i], atol=1e-3)
            assert f.bbox == tuple(r["dilated"][i])
            np.testing.assert_allclose(f.landmarks, r["landmarks"][i], atol=1e-3)
            np.testing.assert_allclose([f.score, f.age, f.gender_prob],
                                       [r["scores"][i], r["ages"][i], r["male"][i]], atol=1e-4)
            np.testing.assert_allclose(f.identity, r["identity"][i], rtol=1e-4, atol=1e-4)
        faces += len(got)
        assert r["counts"]["stage2"] >= r["counts"]["stage3"] >= len(got)
    assert faces > 0


def test_int8_gallery_reference_matches_the_ports_ranking():
    from hse_facerec_torch.pipelines.gallery import EnrollmentGallery

    from perfbench.reference import knn_int8

    rows = inputs.unit_rows(500, 64, 4, "g", "cpu")
    probes = rows[:20] + 0.05 * inputs.unit_rows(20, 64, 4, "p", "cpu")
    gal = EnrollmentGallery(device="cpu")
    gal.enroll_many([f"r{i}" for i in range(500)], rows)
    ref = knn_int8.Gallery(torch.from_numpy(rows))
    for p in probes:
        label, dist, nearest = gal.identify(p, 0.82)
        idx, d = ref.nearest(torch.from_numpy(p))
        assert nearest == f"r{idx}"
        assert abs(dist - d) < 1e-5
    q, scale = knn_int8.quantize(torch.tensor([[0.5, -1.0, 0.25]]))
    assert scale == np.float32(1.0) / np.float32(127.0) and q.tolist() == [[64.0, -127.0, 32.0]]
