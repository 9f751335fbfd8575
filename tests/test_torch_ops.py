"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Every case feeds the same seeded numpy inputs to the JAX function (jitted,
as the JAX pipelines run it, at Precision.HIGHEST) and to its counterpart in
``hse_facerec_torch`` (plain PyTorch on the CPU). Tolerances:

- box math, top-k selection and NMS masks: exact (the port computes the
  multiply-adds that XLA fuses as single-rounding FMAs, ``numerics.fma``);
- layers: 1e-4 absolute on O(1) activations (fp32 sums in another order);
- the pyramid after rounding to integer pixels: exact;
- crops: 1e-3 in 0-255 pixel units, on photo-like images. The matmul sums
  run in another order, and XLA fuses the sample position's multiply-add
  into an FMA, which moves a position by up to one ulp (about 1e-5 px); on
  a photo's gradients that is far below 1e-3. The kernel and its plain twin
  compute bit-identical positions and are compared on noise.

The kernel wrapper and the CUDA kernel itself are tested in
``test_torch_kernels.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.models import layers as jl
from hse_facerec_tf_tpu.ops import boxes as jb
from hse_facerec_tf_tpu.ops import nms as jn
from hse_facerec_tf_tpu.ops import resize as jr
from hse_facerec_tf_tpu.ops.pallas.crop import crop_resize_zero_pallas
from hse_facerec_tf_tpu.pipelines.detector import pyramid_scales
from hse_facerec_torch import params as P
from hse_facerec_torch.models import layers as tl
from hse_facerec_torch.ops import boxes as tb
from hse_facerec_torch.ops import nms as tn
from hse_facerec_torch.ops import resize as tr

from .test_torch_kernels import _crop_boxes

HIGHEST = jax.lax.Precision.HIGHEST


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture
def rng():
    return np.random.RandomState(2024)


# ---------------- layers ----------------

@pytest.mark.parametrize("size,k,stride,padding", [
    ((13, 17), 3, 1, "SAME"), ((13, 17), 3, 1, "VALID"),
    ((224, 224), 3, 2, "SAME"), ((15, 10), 3, 2, "SAME"),
    ((12, 12), 2, 1, "VALID"), ((9, 9), 1, 1, "SAME")])
def test_conv2d(rng, size, k, stride, padding):
    x = rng.randn(2, *size, 3).astype(np.float32)
    kernel = rng.randn(k, k, 3, 5).astype(np.float32) * 0.3
    bias = rng.randn(5).astype(np.float32)
    want = jax.jit(lambda x: jl.conv2d(x, kernel, stride=stride, padding=padding,
                                       precision=HIGHEST) + bias)(x)
    got = tl.conv2d(_nchw(x), _t(P.conv_weight(kernel)), _t(bias),
                    stride=stride, padding=padding)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("size,stride", [((112, 112), 2), ((14, 14), 2),
                                         ((13, 9), 1), ((7, 7), 1)])
def test_depthwise_conv2d(rng, size, stride):
    c = 8
    x = rng.randn(2, *size, c).astype(np.float32)
    kernel = rng.randn(3, 3, c, 1).astype(np.float32)
    want = jax.jit(lambda x: jl.depthwise_conv2d(x, kernel, stride=stride,
                                                 precision=HIGHEST))(x)
    got = tl.depthwise_conv2d(_nchw(x), _t(P.depthwise_weight(kernel)),
                              stride=stride)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-4)


def test_dense_prelu_relu6(rng):
    x = rng.randn(6, 40).astype(np.float32) * 3
    kernel = rng.randn(40, 12).astype(np.float32) * 0.3
    bias = rng.randn(12).astype(np.float32)
    alpha = rng.uniform(0.1, 0.3, 12).astype(np.float32)
    want = jax.jit(lambda x: jl.relu6(jl.prelu(
        jl.dense(x, kernel, bias, precision=HIGHEST), alpha)))(x)
    got = tl.relu6(tl.prelu(tl.dense(_t(x), _t(P.dense_weight(kernel)), _t(bias)),
                            _t(alpha)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_prelu_per_channel_nchw(rng):
    x = rng.randn(2, 5, 6, 4).astype(np.float32)
    alpha = rng.uniform(0.1, 0.3, 4).astype(np.float32)
    want = jax.jit(lambda x: jl.prelu(x, alpha))(x)
    got = tl.prelu(_nchw(x), _t(alpha))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("size,k,stride,padding", [
    ((22, 22), 3, 2, "SAME"), ((46, 46), 3, 2, "SAME"), ((9, 9), 3, 2, "VALID"),
    ((8, 8), 2, 2, "SAME"), ((7, 11), 2, 2, "SAME"), ((21, 21), 3, 2, "VALID")])
def test_max_pool(rng, size, k, stride, padding):
    # all-negative inputs: zero padding instead of -inf would show
    x = -np.abs(rng.randn(2, *size, 3)).astype(np.float32) - 0.5
    want = jax.jit(lambda x: jl.max_pool(x, k, stride, padding))(x)
    got = tl.max_pool(_nchw(x), k, stride, padding)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_global_avg_pool(rng):
    x = rng.rand(3, 7, 7, 16).astype(np.float32) * 6
    want = jax.jit(jl.global_avg_pool)(x)
    got = tl.global_avg_pool(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------- boxes ----------------

def _rand_boxes(rng, n, extent=200.0):
    x1 = rng.uniform(0, extent, n)
    y1 = rng.uniform(0, extent, n)
    w = rng.uniform(4, 60, n)
    h = rng.uniform(4, 60, n)
    return np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)


@pytest.mark.parametrize("fn", ["bbreg", "bbreg_stage1"])
def test_box_regression(rng, fn):
    boxes = _rand_boxes(rng, 50)
    reg = (rng.randn(50, 4) * 0.1).astype(np.float32)
    want = jax.jit(getattr(jb, fn))(boxes, reg)
    got = getattr(tb, fn)(_t(boxes), _t(reg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rerec_fix(rng):
    boxes = _rand_boxes(rng, 50)
    want = jax.jit(lambda b: jb.fix(jb.rerec(b)))(boxes)
    got = tb.fix(tb.rerec(_t(boxes)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["many", "one_above", "padded", "ties"])
def test_generate_boxes(rng, case):
    gx, gy, threshold, max_boxes = 23, 31, 0.6, 64
    prob = rng.rand(gx, gy).astype(np.float32)
    if case == "one_above":           # the reference's flipud quirk
        prob *= 0.5
        prob[7, 11] = 0.9
    if case == "padded":              # fewer cells than max_boxes
        prob = prob[:5, :7]
    if case == "ties":                # equal scores: lowest index first
        prob = np.round(prob * 4) / 4
    reg = (rng.randn(*prob.shape, 4) * 0.1).astype(np.float32)
    for scale in (0.6, 0.6 * 0.709, 0.6 * 0.709 ** 4):
        want = jax.jit(lambda p, r: jb.generate_boxes(p, r, scale, threshold,
                                                      max_boxes))(prob, reg)
        got = tb.generate_boxes(_t(prob), _t(reg), scale, threshold, max_boxes)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_select_top(rng):
    boxes = _rand_boxes(rng, 40)
    scores = np.round(rng.rand(40) * 8).astype(np.float32) / 8   # with ties
    valid = rng.rand(40) > 0.4
    regs = rng.randn(40, 4).astype(np.float32)
    want = jax.jit(lambda b, s, v, r: jb.select_top(b, s, v, r, 16))(
        boxes, scores, valid, regs)
    got = tb.select_top(_t(boxes), _t(scores), _t(valid), _t(regs), 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------- NMS ----------------

def _clustered_boxes(rng, n):
    centers = rng.uniform(20, 180, (6, 2))
    c = centers[rng.randint(0, 6, n)] + rng.randn(n, 2) * 6
    s = rng.uniform(15, 40, n)
    return np.stack([c[:, 0], c[:, 1], c[:, 0] + s, c[:, 1] + s], 1).astype(np.float32)


@pytest.mark.parametrize("method,threshold", [("union", 0.5), ("union", 0.7),
                                              ("min", 0.7)])
def test_nms_mask_matches_greedy_numpy(rng, method, threshold):
    boxes = _clustered_boxes(rng, 60)
    scores = rng.rand(60).astype(np.float32)
    keep = tn.nms_mask(_t(boxes), _t(scores), torch.ones(60, dtype=torch.bool),
                       threshold, method).numpy()
    picks = jn.nms_numpy(boxes, scores, threshold, method)
    assert set(np.where(keep)[0]) == set(picks.tolist())


@pytest.mark.parametrize("method", ["union", "min"])
def test_nms_mask_matches_jax(rng, method):
    boxes = _clustered_boxes(rng, 48)
    scores = np.round(rng.rand(48) * 16).astype(np.float32) / 16  # with ties
    valid = rng.rand(48) > 0.25
    want = jax.jit(lambda b, s, v: jn.nms_mask(b, s, v, 0.5, method))(
        boxes, scores, valid)
    got = tn.nms_mask(_t(boxes), _t(scores), _t(valid), 0.5, method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    overlap = jn.pairwise_overlap(jnp.asarray(boxes), method)
    np.testing.assert_allclose(tn.pairwise_overlap(_t(boxes), method).numpy(),
                               np.asarray(overlap), atol=1e-6)


# ---------------- resize ----------------

@pytest.mark.parametrize("hw,minsize", [((96, 128), 20), ((120, 90), 24)])
def test_resize_pyramid_rounded(rng, hw, minsize):
    h, w = hw
    img = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    sizes = [(int(np.ceil(h * s)), int(np.ceil(w * s)))
             for s in pyramid_scales(h, w, minsize)]
    want = jax.jit(lambda x: [jnp.clip(jnp.round(l), 0, 255)
                              for l in jr.resize_pyramid(x, sizes, "cv2_area")])(img)
    got = [torch.clamp(torch.round(l), 0, 255)
           for l in tr.resize_pyramid(_t(img), sizes)]
    assert len(got) == len(want) > 1
    for g, wl in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wl))


def _photo(rng, H, W):
    """Smooth colour field plus mild noise: photo-like local gradients."""
    low = torch.from_numpy(rng.rand(1, 3, H // 10, W // 10).astype(np.float32))
    img = torch.nn.functional.interpolate(low * 255, size=(H, W), mode="bilinear")
    img = img[0].permute(1, 2, 0).numpy() + rng.randn(H, W, 3) * 3
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.mark.parametrize("out_size,supersample,outside", [
    (24, 2, "zero"), (48, 2, "zero"), (24, 2, "clamp"), (64, 1, "clamp"),
    (24, 1, "zero")])
def test_crop_twin_matches_jax(rng, out_size, supersample, outside):
    H, W = 120, 160
    img = _photo(rng, H, W)
    boxes = _crop_boxes(rng, 16, H, W)
    want = jax.jit(lambda i, b: jr.crop_resize_bilinear(
        i, b, out_size, supersample=supersample, outside=outside,
        precision=HIGHEST))(img, boxes)
    got = tr.crop_resize_bilinear(_t(img), _t(boxes), out_size, supersample,
                                  outside)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("out_size", [24, 48])
def test_crop_twin_matches_pallas_kernel(rng, out_size):
    """The TPU kernel K1 in interpret mode, as tests/test_pallas_crop.py runs
    it. Its dots run at default precision, so it differs from its own oracle,
    the JAX einsum form, by up to ~2e-3 on these inputs; the twin must be no
    further from the kernel than that oracle is, within 1e-3."""
    H, W = 120, 160
    img = _photo(rng, H, W)
    boxes = _crop_boxes(rng, 16, H, W)
    kernel = np.asarray(crop_resize_zero_pallas(
        jnp.asarray(img), jnp.asarray(boxes), out_size, 2, interpret=True))
    oracle = np.asarray(jax.jit(lambda i, b: jr.crop_resize_bilinear(
        i, b, out_size, supersample=2, outside="zero", precision=HIGHEST))(
        img, boxes))
    got = tr.crop_resize_bilinear(_t(img), _t(boxes), out_size, 2, "zero").numpy()
    assert np.abs(got - kernel).max() <= np.abs(oracle - kernel).max() + 1e-3
    assert np.all(got[0] == 0.0)
