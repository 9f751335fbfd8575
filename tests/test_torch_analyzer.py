"""The whole analyze slice of the PyTorch port against the JAX package.

``MTCNNDetector`` and ``FacialAnalyzer`` of both packages get the same
seeded random parameters (``hse_facerec_torch.testing``) and the same photo-
like image, at a small size: 96x128, minsize 20, reduced caps, 64² face
crops. The JAX side runs jitted at Precision.HIGHEST on the CPU; the port
runs on the CPU with the plain twins of its kernels. Required: identical
valid masks and face counts slot for slot, boxes within 1 px, ages within
1e-3, P(male) within 1e-4, identity cosine above 0.9999 (fp32 sums in
another order through 13 MobileNet blocks).
"""

import jax
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.pipelines.analyzer import FacialAnalyzer as JaxAnalyzer
from hse_facerec_tf_tpu.pipelines.detector import MTCNNDetector as JaxDetector
from hse_facerec_tf_tpu.pipelines.heads import MultiheadHeads as JaxHeads
from hse_facerec_torch.ops.kernels.crop import crop_resize
from hse_facerec_torch.pipelines import detector as detector_mod
from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
from hse_facerec_torch.pipelines.detector import MTCNNDetector
from hse_facerec_torch.testing import random_mtcnn_params, random_multihead_params

HIGHEST = jax.lax.Precision.HIGHEST
H, W = 96, 128

# name -> (mtcnn seed, image seed, detector caps/escalations, head_batch).
# "fits": the caps hold every candidate and the head budget every face.
# "crowded": the caps truncate, so the cascade escalates a tier, and the
# faces overflow the head budget, so the analyzer re-runs the heads at the
# detector's full width.
CASES = {
    "fits": (2, 2, dict(max_level_boxes=64, max_stage2=16, max_stage3=8,
                        max_escalations=0), 4),
    "crowded": (9, 1, dict(max_level_boxes=32, max_stage2=8, max_stage3=4,
                           max_escalations=1), 2),
}


def _photo(seed):
    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.rand(1, 3, 8, 10).astype(np.float32) * 255)
    img = torch.nn.functional.interpolate(low, size=(H, W), mode="bilinear")
    img = img[0].permute(1, 2, 0).numpy() + rng.randn(H, W, 3) * 8
    return np.clip(img, 0, 255).round().astype(np.uint8)


@pytest.fixture(scope="module")
def multihead_np():
    return random_multihead_params(np.random.RandomState(100))


def _analyzers(case, multihead_np):
    seed, _, det_kw, head_batch = CASES[case]
    mtcnn_np = random_mtcnn_params(np.random.RandomState(seed))
    kw = dict(minsize=20, face_size=64, head_batch=head_batch, **det_kw)
    jax_an = JaxAnalyzer(mtcnn_np, heads=JaxHeads(multihead_np, precision=HIGHEST),
                         precision=HIGHEST, **kw)
    return jax_an, FacialAnalyzer(mtcnn_np, multihead_np, device="cpu", **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_detector_matches_jax(case):
    seed, img_seed, det_kw, _ = CASES[case]
    mtcnn_np = random_mtcnn_params(np.random.RandomState(seed))
    jax_det = JaxDetector(mtcnn_np, minsize=20, precision=HIGHEST, **det_kw)
    det = MTCNNDetector(mtcnn_np, device="cpu", minsize=20, **det_kw)
    img = _photo(img_seed)
    for tier in range(det_kw["max_escalations"] + 1):
        want = jax.device_get(jax_det.detect_fn(H, W, tier)(img))
        got = [t.numpy() for t in det.detect_core(det.upload(img), tier)]
        boxes, scores, points, valid, truncated = got
        np.testing.assert_array_equal(valid, want[3])
        assert bool(truncated) == bool(want[4])
        assert valid.sum() > 0
        np.testing.assert_allclose(boxes[valid], want[0][valid], atol=1.0)
        np.testing.assert_allclose(scores[valid], want[1][valid], atol=1e-4)
        np.testing.assert_allclose(points[valid], want[2][valid], atol=1.0)
    jb, jp = jax_det.detect(img)
    tb, tp = det.detect(img)
    assert tb.shape == jb.shape and tp.shape == jp.shape
    np.testing.assert_allclose(tb[:, :4], jb[:, :4], atol=1.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_analyzer_matches_jax(case, multihead_np, monkeypatch):
    jax_an, an = _analyzers(case, multihead_np)
    img = _photo(CASES[case][1])
    calls = []
    run = an._run
    monkeypatch.setattr(an, "_run", lambda *a, **k: calls.append(a[1:]) or run(*a, **k))
    want = jax_an.analyze(img)
    got = an.analyze(img)
    assert len(got) == len(want) > 0
    if case == "crowded":
        # escalated one tier, then re-ran the heads at the stage-3 width
        assert an.detector.last_truncated == jax_an.detector.last_truncated
        assert len(calls) == 3 and calls[-1][0] > an.head_batch
    else:
        assert calls == [()]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.raw_bbox, w.raw_bbox, atol=1.0)
        assert np.abs(np.subtract(g.bbox, w.bbox)).max() <= 1
        assert g.age == pytest.approx(w.age, abs=1e-3)
        assert g.gender_prob == pytest.approx(w.gender_prob, abs=1e-4)
        cos = np.dot(g.identity, w.identity) / (
            np.linalg.norm(g.identity) * np.linalg.norm(w.identity))
        assert cos > 0.9999
        np.testing.assert_allclose(g.landmarks, w.landmarks, atol=1.0)


def test_analyze_with_rotations_blank(multihead_np):
    """No face anywhere: tries 0°, 90° and 270°, returns ([], 0), and on the
    CPU never launches the CUDA kernel."""
    _, an = _analyzers("fits", multihead_np)
    seen = []
    analyze = an.analyze
    an.analyze = lambda img: seen.append(img.shape) or analyze(img)
    crop_resize.launches = 0
    assert an.analyze_with_rotations(np.zeros((H, W, 3), np.uint8)) == ([], 0)
    assert seen == [(H, W, 3), (W, H, 3), (W, H, 3)]
    assert crop_resize.launches == 0


def test_cuda_requested_without_cuda_raises(monkeypatch, multihead_np):
    monkeypatch.setattr(detector_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FacialAnalyzer(random_mtcnn_params(np.random.RandomState(0)),
                       multihead_np, device="cuda")


def test_cli_analyze(tmp_path, capsys, multihead_np):
    """``python -m hse_facerec_torch.cli analyze`` end to end on the CPU, from
    frozen graphs written with the shipped graphs' tensor names."""
    import json

    import cv2

    from hse_facerec_torch import cli

    from .test_torch_models import write_mtcnn_pb, write_multihead_pb

    mtcnn_np = random_mtcnn_params(np.random.RandomState(2))
    write_mtcnn_pb(mtcnn_np, tmp_path / "mtcnn.pb")
    write_multihead_pb(multihead_np, tmp_path / "ag.pb", np.random.RandomState(9))
    img = tmp_path / "photo.png"
    cv2.imwrite(str(img), _photo(2)[:, :, ::-1])
    cli.main(["analyze", str(img), "--device", "cpu", "--minsize", "20",
              "--mtcnn-pb", str(tmp_path / "mtcnn.pb"),
              "--agegender-pb", str(tmp_path / "ag.pb"),
              "--out", str(tmp_path / "out.png")])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows and all(set(r) == {"bbox", "score", "age", "gender_prob", "is_male"}
                        for r in rows)
    assert (tmp_path / "out.png").exists()
    with pytest.raises(SystemExit):
        cli.main(["analyze", str(img), "--device", "cpu",
                  "--mtcnn-pb", str(tmp_path / "missing.pb")])
