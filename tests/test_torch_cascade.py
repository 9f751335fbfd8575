"""The port's LBP cascade (``pipelines/lbp_cascade.py``) and the cascade
fallback detector against the JAX package's, on the CPU.

OpenCV's ``lbpcascade_frontalface.xml`` is not in the repository, so the
cascade is ``hse_facerec_torch.testing.write_lbp_cascade``'s: seeded
features in the published file's format, a 24x24 window and 20 stages,
thresholds set on three seeded photos so that about 1% of their windows
pass every stage. Required: the boxes equal the JAX module's exactly (the
port evaluates the stages in torch float64, forming every sum in the JAX
module's order), on those photos, on fresh ones, on a blank and on noise;
``_area_downscale`` and ``_group_rectangles`` equal too.
"""

import os

import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.pipelines import cascade_fallback as jcf
from hse_facerec_tf_tpu.pipelines import lbp_cascade as jlbp
from hse_facerec_torch.pipelines import cascade_fallback as tcf
from hse_facerec_torch.pipelines import lbp_cascade as tlbp
from hse_facerec_torch.testing import LBP_STAGES, write_lbp_cascade

SHAPE = (120, 160)


def _photo(seed, shape=SHAPE):
    """A seeded photo-like image: a low-frequency colour field plus noise."""
    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.rand(1, 3, 6, 8).astype(np.float32) * 255)
    img = torch.nn.functional.interpolate(low, size=shape, mode="bilinear")
    img = img[0].permute(1, 2, 0).numpy() + rng.randn(*shape, 3) * 12
    return np.clip(img, 0, 255).round().astype(np.uint8)


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cascade") / "lbpcascade_synthetic.xml")
    return write_lbp_cascade(path, [_photo(s) for s in range(3)], seed=0, survivors=1e-2)


IMAGES = {"calibration0": lambda: _photo(0), "calibration2": lambda: _photo(2),
          "fresh": lambda: _photo(10), "portrait": lambda: _photo(11, (160, 120)),
          "small": lambda: _photo(12, (50, 64)),
          "blank": lambda: np.full(SHAPE + (3,), 128, np.uint8),
          "noise": lambda: (np.random.RandomState(13).rand(*SHAPE, 3) * 255).astype(np.uint8)}


def test_parse_matches_jax(xml):
    got, want = tlbp.LBPCascade(xml, device="cpu"), jlbp.LBPCascade(xml)
    assert (got.win_w, got.win_h) == (want.win_w, want.win_h) == (24, 24)
    np.testing.assert_array_equal(got.rects, want.rects)
    assert len(got.stages) == len(want.stages) == LBP_STAGES
    for g, w in zip(got.stages, want.stages):
        assert g.threshold == w.threshold
        for field in ("feat_idx", "subsets", "leaves"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_boxes_equal_jax(xml, name):
    img = IMAGES[name]()
    got = tlbp.LBPCascade(xml, device="cpu").detect(img)
    want = jlbp.LBPCascade(xml).detect(img)
    assert got.shape[1] == 5
    np.testing.assert_array_equal(got, want)
    if name.startswith("calibration"):
        assert len(got) >= 1 and got[:, 4].min() > 3       # groups past min_neighbors
    if name == "blank":
        assert len(got) == 0


@pytest.mark.parametrize("kw", [dict(scale_factor=1.25, min_neighbors=1, min_size=30, step=1),
                                dict(scale_factor=1.1, min_neighbors=0, min_size=24, step=3)])
def test_boxes_equal_jax_off_defaults(xml, kw):
    img = _photo(0)
    got = tlbp.LBPCascade(xml, device="cpu").detect(img, **kw)
    want = jlbp.LBPCascade(xml).detect(img, **kw)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((120, 160), (72, 96)), ((97, 131), (40, 53)),
                                     ((50, 64), (50, 64)), ((480, 640), (290, 387))])
def test_area_downscale_equals_jax(src, dst):
    gray = np.random.RandomState(sum(src)).rand(*src) * 255
    np.testing.assert_array_equal(tlbp._area_downscale(gray, *dst),
                                  jlbp._area_downscale(gray, *dst))


@pytest.mark.parametrize("min_neighbors", [0, 2, 3])
def test_group_rectangles_equals_jax(min_neighbors):
    """Clusters of jittered boxes at a few sizes, and lone boxes."""
    rng = np.random.RandomState(min_neighbors)
    rects = []
    for _ in range(12):
        x, y, s = rng.randint(0, 300), rng.randint(0, 200), rng.randint(30, 90)
        for _ in range(rng.randint(1, 9)):
            j = rng.randint(-4, 5, 4)
            rects.append((x + j[0], y + j[1], x + s + j[2], y + s + j[3]))
    order = rng.permutation(len(rects))
    rects = [rects[i] for i in order]
    got = tlbp._group_rectangles(rects, min_neighbors)
    want = jlbp._group_rectangles(rects, min_neighbors)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
    assert tlbp._group_rectangles([], min_neighbors).shape == (0, 5)


def test_fallback_detector_contract(xml):
    """``CascadeFallbackDetector.detect`` returns ``MTCNNDetector.detect``'s
    contract, (boxes (n, 5), landmarks (10, n)) with zero landmarks, equal
    to the JAX detector's."""
    for img in (_photo(0), IMAGES["blank"]()):
        boxes, points = tcf.CascadeFallbackDetector(xml, device="cpu").detect(img)
        want_boxes, want_points = jcf.CascadeFallbackDetector(xml).detect(img)
        assert boxes.shape == (len(boxes), 5) and points.shape == (10, len(boxes))
        assert not points.any()
        np.testing.assert_array_equal(boxes, want_boxes)
        np.testing.assert_array_equal(points, want_points)


def test_missing_cascade_raises(tmp_path):
    missing = str(tmp_path / "absent.xml")
    with pytest.raises(FileNotFoundError):
        tlbp.LBPCascade(missing, device="cpu")
    with pytest.raises(FileNotFoundError):
        jlbp.LBPCascade(missing)
    assert tlbp.REFERENCE_CASCADE == jlbp.REFERENCE_CASCADE
    if not os.path.exists(tlbp.REFERENCE_CASCADE):
        with pytest.raises(FileNotFoundError):
            tcf.CascadeFallbackDetector(device="cpu")


def test_fallback_detector_defaults_to_the_card(xml):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcf.CascadeFallbackDetector(xml)
