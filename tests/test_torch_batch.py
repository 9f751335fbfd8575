"""The batch analysis slice of the PyTorch port against the JAX package.

K1's batch forms (``crop_resize_bilinear_batch``, one image per lane, and
``crop_resize_bilinear_lanes``, a lane index per box) against the jitted JAX
ops; the lane-batched box and NMS ops bit-equal to the port's own per-lane
calls; ``detect_batch_core``/``detect_batch`` against the JAX package's
vmapped ``detect_batch_fn`` slot for slot; and every ``analyze_batch*``
form, ``oversample`` and ``with_minsize`` against the JAX analyzer. Same
setting as ``test_torch_analyzer.py``: seeded random weights, photo-like
96x128 images, minsize 20, reduced caps, 64² face crops, the JAX side jitted
at Precision.HIGHEST on the CPU and the port on the CPU with the plain
twins of its kernels. Required: identical valid masks and face counts,
boxes within 1 px, ages within 1e-3, P(male) within 1e-4, identity cosine
above 0.9999; crops within 1e-3 in 0-255 pixel units (only the order of
the sums differs).
"""

import jax
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.ops import resize as jr
from hse_facerec_tf_tpu.pipelines.analyzer import FacialAnalyzer as JaxAnalyzer
from hse_facerec_tf_tpu.pipelines.heads import MultiheadHeads as JaxHeads
from hse_facerec_torch.ops import boxes as B
from hse_facerec_torch.ops import resize as tr
from hse_facerec_torch.ops.kernels.crop import crop_resize
from hse_facerec_torch.ops.nms import nms_mask
from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
from hse_facerec_torch.pipelines.detector import MTCNNDetector
from hse_facerec_torch.testing import random_mtcnn_params, random_multihead_params

from .test_torch_analyzer import CASES, H, W, _photo
from .test_torch_kernels import _crop_boxes

HIGHEST = jax.lax.Precision.HIGHEST
CROP_ATOL = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def rng():
    return np.random.RandomState(7)


# ---------- K1's batch forms ----------

def _lane_batch(rng, lanes):
    """Images (4, 40, 50, 3), boxes partly and wholly off the image, and
    the lane of each box."""
    imgs = (rng.rand(4, 40, 50, 3) * 255).astype(np.float32)
    boxes = _crop_boxes(rng, len(lanes), 40, 50)
    return imgs, boxes, np.asarray(lanes, np.int32)


# ragged: lane 1 and 3 empty; all in one lane; a single box
LANE_CASES = {"ragged": [0, 0, 2, 2, 2, 0, 2], "one_lane": [3] * 6, "single": [1]}


@pytest.mark.parametrize("lanes", sorted(LANE_CASES))
@pytest.mark.parametrize("out_size,supersample,outside", [
    (12, 2, "zero"), (12, 1, "zero"), (16, 1, "clamp"), (9, 2, "clamp")])
def test_crop_lanes_matches_jax(rng, lanes, out_size, supersample, outside):
    imgs, boxes, lane = _lane_batch(rng, LANE_CASES[lanes])
    want = np.asarray(jax.jit(lambda i, l, b: jr.crop_resize_bilinear_lanes(
        i, l, b, out_size, supersample=supersample, outside=outside,
        precision=HIGHEST))(imgs, lane, boxes))
    got = tr.crop_resize_bilinear_lanes(_t(imgs), _t(lane), _t(boxes), out_size,
                                        supersample, outside).numpy()
    np.testing.assert_allclose(got, want, atol=CROP_ATOL, rtol=0)
    wrapped = crop_resize(_t(imgs), _t(boxes), out_size, supersample, outside,
                          lanes=_t(lane)).numpy()
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("out_size,supersample,outside", [
    (12, 2, "zero"), (16, 1, "clamp")])
def test_crop_batch_matches_jax_vmap(rng, out_size, supersample, outside):
    """(L, K, 4) boxes, lane l's boxes cropping image l: the vmapped
    single-image crop of the JAX detector's batch program."""
    imgs = (rng.rand(3, 40, 50, 3) * 255).astype(np.float32)
    boxes = np.stack([_crop_boxes(rng, 5, 40, 50) for _ in range(3)])
    want = np.asarray(jax.jit(jax.vmap(lambda i, b: jr.crop_resize_bilinear(
        i, b, out_size, supersample=supersample, outside=outside,
        precision=HIGHEST)))(imgs, boxes))
    got = crop_resize(_t(imgs), _t(boxes), out_size, supersample, outside).numpy()
    assert got.shape == (3, 5, out_size, out_size, 3)
    np.testing.assert_allclose(got, want, atol=CROP_ATOL, rtol=0)


def test_crop_wrapper_batch_forms_take_plain_path_on_cpu(rng):
    imgs, boxes, lane = _lane_batch(rng, LANE_CASES["ragged"])
    crop_resize.launches = 0
    got = crop_resize(_t(imgs), _t(boxes), 12, 2, "zero", lanes=_t(lane))
    want = tr.crop_resize_bilinear_lanes(_t(imgs), _t(lane), _t(boxes), 12, 2, "zero")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    per_lane = _t(np.stack([boxes[:3]] * 4))
    got = crop_resize(_t(imgs), per_lane, 12, 2, "zero")
    for i in range(4):
        np.testing.assert_allclose(
            got[i].numpy(), tr.crop_resize_bilinear(_t(imgs[i]), per_lane[i], 12, 2,
                                                    "zero").numpy(), atol=CROP_ATOL)
    empty = crop_resize(_t(imgs), _t(boxes[:0]), 12, 2, "zero", lanes=_t(lane[:0]))
    assert empty.shape == (0, 12, 12, 3)
    assert crop_resize.launches == 0


@pytest.mark.parametrize("bad", [-1, 4])
def test_crop_wrapper_raises_on_a_lane_out_of_range(rng, bad):
    imgs, boxes, lane = _lane_batch(rng, LANE_CASES["ragged"])
    lane[2] = bad
    with pytest.raises(ValueError, match="lanes must lie in"):
        crop_resize(_t(imgs), _t(boxes), 12, 2, "zero", lanes=_t(lane))


def test_crop_wrapper_rejects_bad_batch_forms(rng):
    imgs, boxes, lane = _lane_batch(rng, LANE_CASES["ragged"])
    with pytest.raises(TypeError, match="int32"):
        crop_resize(_t(imgs), _t(boxes), 12, 2, "zero", lanes=_t(lane).long())
    with pytest.raises(ValueError):      # (L, K, 4) boxes for another L
        crop_resize(_t(imgs), _t(np.stack([boxes] * 3)), 12, 2, "zero")
    with pytest.raises(ValueError):      # lanes with one image
        crop_resize(_t(imgs[0]), _t(boxes), 12, 2, "zero", lanes=_t(lane))
    with pytest.raises(ValueError):      # one lane too few
        crop_resize(_t(imgs), _t(boxes), 12, 2, "zero", lanes=_t(lane[1:]))


# ---------- lane-batched box and NMS ops ----------

def _per_lane(fn, *args):
    """``fn`` on each lane of ``args`` on its own, stacked back."""
    outs = [fn(*(a[i] for a in args)) for i in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _assert_equal(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("method,threshold", [("union", 0.5), ("union", 0.7),
                                              ("min", 0.7)])
def test_nms_mask_batched_equals_per_lane(rng, method, threshold):
    centers = rng.uniform(10, 90, (5, 40, 2))
    size = rng.uniform(5, 40, (5, 40, 1))
    boxes = _t(np.concatenate([centers - size / 2, centers + size / 2], -1)
               .astype(np.float32))
    scores = _t(rng.choice([0.5, 0.7, 0.9], (5, 40)).astype(np.float32))  # ties
    valid = _t(rng.rand(5, 40) < 0.8)
    valid[3] = False                                                     # an empty lane
    got = nms_mask(boxes, scores, valid, threshold, method)
    want = _per_lane(lambda b, s, v: nms_mask(b, s, v, threshold, method),
                     boxes, scores, valid)
    _assert_equal(got, want)
    assert got.any() and not got[3].any()


@pytest.mark.parametrize("max_boxes", [10, 200])
def test_generate_boxes_batched_equals_per_lane(rng, max_boxes):
    """Lane 1 has exactly one cell above the threshold, so only its reg map
    takes the reference's flip; the others have many or none."""
    prob = rng.rand(3, 9, 11).astype(np.float32) * 0.5
    prob[0, rng.rand(9, 11) < 0.4] = 0.8
    prob[1, 2, 7] = 0.95
    reg = rng.randn(3, 9, 11, 4).astype(np.float32)
    got = B.generate_boxes(_t(prob), _t(reg), 0.3, 0.6, max_boxes)
    want = _per_lane(lambda p, r: B.generate_boxes(p, r, 0.3, 0.6, max_boxes),
                     _t(prob), _t(reg))
    _assert_equal(got, want)
    assert int(got[3][1].sum()) == 1
    flipped = B.generate_boxes(_t(prob[1]), _t(reg[1]), 0.3, 0.6, max_boxes)[2]
    assert torch.equal(flipped[0], _t(reg[1, 6, 7]))   # the quirk: row 8 - 2


def test_select_top_and_box_math_batched_equal_per_lane(rng):
    boxes = _t(rng.uniform(0, 100, (4, 30, 4)).astype(np.float32))
    scores = _t(rng.choice([0.1, 0.5, 0.9], (4, 30)).astype(np.float32))
    valid = _t(rng.rand(4, 30) < 0.6)
    extra = _t(rng.randn(4, 30, 4).astype(np.float32))
    got = B.select_top(boxes, scores, valid, extra, 12)
    _assert_equal(got, _per_lane(lambda b, s, v, e: B.select_top(b, s, v, e, 12),
                                 boxes, scores, valid, extra))
    for fn in (B.bbreg, B.bbreg_stage1):
        _assert_equal(fn(boxes, extra), _per_lane(fn, boxes, extra))
    _assert_equal(B.rerec(boxes), _per_lane(B.rerec, boxes))


# ---------- detection and analysis against the JAX package ----------

@pytest.fixture(scope="module")
def multihead_np():
    return random_multihead_params(np.random.RandomState(100))


def _batch(case):
    """The case's photo, a zero lane and another photo."""
    img_seed = CASES[case][1]
    return np.stack([_photo(img_seed), np.zeros((H, W, 3), np.uint8),
                     _photo(img_seed + 2)])


def _pair(case, multihead_np, **kw):
    seed, _, det_kw, head_batch = CASES[case]
    mtcnn_np = random_mtcnn_params(np.random.RandomState(seed))
    kw = dict(minsize=20, face_size=64, head_batch=head_batch, **det_kw, **kw)
    jax_an = JaxAnalyzer(mtcnn_np, heads=JaxHeads(multihead_np, precision=HIGHEST),
                         precision=HIGHEST, **kw)
    return jax_an, FacialAnalyzer(mtcnn_np, multihead_np, device="cpu", **kw)


@pytest.fixture(scope="module")
def analyzers(multihead_np):
    """One (JAX, port) analyzer pair per case, shared so that each JAX
    program compiles once."""
    return {case: _pair(case, multihead_np) for case in CASES}


def _assert_same_faces(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.raw_bbox, w.raw_bbox, atol=1.0)
        assert np.abs(np.subtract(g.bbox, w.bbox)).max() <= 1
        assert g.age == pytest.approx(w.age, abs=1e-3)
        assert g.gender_prob == pytest.approx(w.gender_prob, abs=1e-4)
        cos = np.dot(g.identity, w.identity) / (
            np.linalg.norm(g.identity) * np.linalg.norm(w.identity))
        assert cos > 0.9999
        np.testing.assert_allclose(g.landmarks, w.landmarks, atol=1.0)


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_faces(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_detect_batch_matches_jax(case, analyzers):
    jax_an, an = analyzers[case]
    imgs = _batch(case)
    det = an.detector
    for tier in range(det.max_escalations + 1):
        want = jax.device_get(jax_an.detector.detect_batch_fn(H, W, tier)(imgs))
        got = [t.numpy() for t in det.detect_batch_core(det.upload(imgs), tier)]
        boxes, scores, points, valid, truncated = got
        assert truncated.shape == (3,)
        np.testing.assert_array_equal(valid, want[3])
        np.testing.assert_array_equal(truncated, want[4])
        assert valid[0].sum() > 0 and valid[1].sum() == 0
        np.testing.assert_allclose(boxes[valid], want[0][valid], atol=1.0)
        np.testing.assert_allclose(scores[valid], want[1][valid], atol=1e-4)
        np.testing.assert_allclose(points[valid], want[2][valid], atol=1.0)
    want = jax_an.detector.detect_batch(imgs)
    got = det.detect_batch(imgs)
    assert det.last_truncated == jax_an.detector.last_truncated
    for (gb, gp), (wb, wp) in zip(got, want):
        assert gb.shape == wb.shape and gp.shape == wp.shape
        np.testing.assert_allclose(gb[:, :4], wb[:, :4], atol=1.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_analyze_batch_matches_jax(case, analyzers, monkeypatch):
    """"fits": every face inside the shared head slots; "crowded": the
    detector truncates (max_escalations 1) and the faces overflow the
    slots, so lanes re-run through ``analyze``, as in the JAX package."""
    jax_an, an = analyzers[case]
    imgs = _batch(case)
    fallbacks = []
    analyze = FacialAnalyzer.analyze
    monkeypatch.setattr(FacialAnalyzer, "analyze",
                        lambda self, img: fallbacks.append(1) or analyze(self, img))
    crop_resize.launches = 0
    got = an.analyze_batch(imgs)
    _assert_same_batches(got, jax_an.analyze_batch(imgs))
    assert sum(map(len, got)) > 0 and got[1] == []
    assert crop_resize.launches == 0
    assert (len(fallbacks) > 0) == (case == "crowded")


def test_analyze_batch_head_fallback_and_n_valid(multihead_np):
    """Two head slots for the whole batch: the lanes past them re-run
    through ``analyze``; ``n_valid`` returns the first lanes only."""
    jax_an, an = _pair("fits", multihead_np, batch_head_total=2)
    imgs = _batch("fits")[[0, 2, 1]]
    seen = []
    analyze = an.analyze
    an.analyze = lambda img: seen.append(img.shape) or analyze(img)
    got = an.analyze_batch(imgs, n_valid=2)
    _assert_same_batches(got, jax_an.analyze_batch(imgs, n_valid=2))
    assert len(got) == 2 and seen
    assert sum(map(len, got)) > 2


def test_analyze_batch_padded_matches_jax(analyzers):
    jax_an, an = analyzers["fits"]
    imgs = _batch("fits")[[0, 2]]
    got = an.analyze_batch_padded(imgs, 3)
    assert len(got) == 2
    _assert_same_batches(got, jax_an.analyze_batch_padded(imgs, 3))
    _assert_same_batches(got, an.analyze_batch(imgs))


def test_analyze_batch_rotations_padded_matches_jax(analyzers):
    """Both rotations from one upload, rotated on the device; equal to the
    JAX package and to the port's own batch over host-rotated copies."""
    jax_an, an = analyzers["fits"]
    imgs = _batch("fits")
    got = an.analyze_batch_rotations_padded(imgs[:2], 3)
    want = jax_an.analyze_batch_rotations_padded(imgs[:2], 3)
    assert len(got) == 2
    for (g90, g270), (w90, w270) in zip(got, want):
        _assert_same_faces(g90, w90)
        _assert_same_faces(g270, w270)
    host90 = an.analyze_batch_padded(np.rot90(imgs[:2], 3, axes=(1, 2)), 3)
    _assert_same_batches([g for g, _ in got], host90)
    assert sum(len(g) for g, _ in got) > 0


def test_analyze_batch_retry_padded_matches_jax(analyzers, monkeypatch):
    """A lane with no face upright (a zero image) runs the rotation pair on
    the uploaded batch; lanes with faces keep their upright results."""
    jax_an, an = analyzers["fits"]
    imgs = _batch("fits")
    uploads, cores = [], []
    upload, core = MTCNNDetector.upload, FacialAnalyzer.analyze_batch_core
    monkeypatch.setattr(MTCNNDetector, "upload",
                        lambda self, x: uploads.append(x.shape) or upload(self, x))
    monkeypatch.setattr(FacialAnalyzer, "analyze_batch_core",
                        lambda self, x, t: cores.append(tuple(x.shape)) or core(self, x, t))
    got = an.analyze_batch_retry_padded(imgs, 4)
    want = jax_an.analyze_batch_retry_padded(imgs, 4)
    assert [r for _, r in got] == [r for _, r in want]
    for (g, _), (w, _) in zip(got, want):
        _assert_same_faces(g, w)
    assert got[1] == ([], 270) and got[0][1] == 0 and got[0][0]
    assert uploads == [(4, H, W, 3)]
    assert cores == [(4, H, W, 3), (4, W, H, 3), (4, W, H, 3)]
    # no face-less lane: the upright pass alone
    cores.clear()
    got = an.analyze_batch_retry_padded(imgs[[0, 2]], 2)
    assert [r for _, r in got] == [0, 0] and len(cores) == 1


def test_with_minsize_matches_jax(analyzers):
    jax_an, an = analyzers["fits"]
    clone, jax_clone = an.with_minsize(30), jax_an.with_minsize(30)
    assert clone.detector.minsize == 30 and an.detector.minsize == 20
    assert clone.heads is an.heads and clone.detector.params is an.detector.params
    assert clone.detector.max_stage3 == an.detector.max_stage3
    imgs = _batch("fits")
    _assert_same_batches(clone.analyze_batch(imgs), jax_clone.analyze_batch(imgs))
    _assert_same_faces(clone.analyze(imgs[0]), jax_clone.analyze(imgs[0]))


def test_oversample_matches_jax(multihead_np):
    """Five crops a face (the box and four ±10 px diagonal shifts), single
    image and batch, the batch lane by lane at the per-lane budget."""
    jax_an, an = _pair("fits", multihead_np, oversample=True)
    imgs = _batch("fits")
    single = an.analyze(imgs[0])
    _assert_same_faces(single, jax_an.analyze(imgs[0]))
    crop_resize.launches = 0
    batch = an.analyze_batch(imgs)
    _assert_same_batches(batch, jax_an.analyze_batch(imgs))
    _assert_same_faces(batch[0], single)
    plain = _pair("fits", multihead_np)[1].analyze(imgs[0])
    assert [f.raw_bbox for f in plain] == [f.raw_bbox for f in single]
    assert any(abs(p.age - o.age) > 1e-6 for p, o in zip(plain, single))
    with pytest.raises(ValueError, match="oversample"):
        an.analyze_batch_retry_padded(imgs, 3)


def test_mesh_is_not_ported(multihead_np):
    """A mesh analyzer shards ``analyze_batch`` (``test_torch_parallel.py``
    holds it against the JAX package); the single-device retry and rotation
    forms refuse a mesh, as the JAX package's retry form does."""
    from hse_facerec_torch.parallel.sharding import make_mesh

    mtcnn_np = random_mtcnn_params(np.random.RandomState(CASES["fits"][0]))
    kw = dict(minsize=20, face_size=64, head_batch=4, **CASES["fits"][2])
    an = FacialAnalyzer(mtcnn_np, multihead_np, mesh=make_mesh(devices=["cpu"] * 2), **kw)
    imgs = _batch("fits")
    _assert_same_batches(an.analyze_batch(imgs),
                         FacialAnalyzer(mtcnn_np, multihead_np, device="cpu",
                                        **kw).analyze_batch(imgs))
    for form in (an.analyze_batch_retry_padded, an.analyze_batch_rotations_padded):
        with pytest.raises(ValueError, match="mesh"):
            form(imgs, 4)
