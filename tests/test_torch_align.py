"""The port's face alignment (``ops/align.py``) against the JAX package's,
and against the cv2 goldens of ``tests/test_align_models.py``, on the CPU.

Both sides compute in float32, op by op (the JAX module is not jitted);
they differ where JAX's 2×2 SVD and small matmuls round otherwise than
the port's closed form and explicit sums. Tolerances:
- the similarity estimate within 1e-5 relative (its entries are O(1) and
  O(100));
- ``warp_affine`` on one affine, pixels (0-255 scale) within 2e-2
  absolute (2.3e-3 seen): a sample coordinate a few ulps apart (about 1e-5
  px at 100 px) moves a bilinear blend by at most that times the image's
  steepest step (255 a pixel, in two directions), and a floor that flips
  at an integer moves it by nothing more, since the blend is continuous
  there;
- ``align_faces``, pixels within 5e-2 (1.4e-2 seen): the estimates differ
  by up to 1e-6 relative, which moves sample coordinates by up to 1e-4 px.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.ops import align as ja
from hse_facerec_torch.ops import align as ta

M_REL, PIXEL_ATOL, ALIGN_ATOL = 1e-5, 2e-2, 5e-2


def _landmarks(rng, n, out_size=112):
    """Template points under seeded similarities (scale 0.6-2, ±40°, any
    shift inside a 200x200 image) plus 1.5 px of noise: detector-like."""
    t = ja.arcface_template(out_size)
    out = []
    for _ in range(n):
        th, s = rng.uniform(-0.7, 0.7), rng.uniform(0.6, 2.0)
        r = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        c = rng.uniform(40, 160, 2)
        out.append((t - t.mean(0)) @ r.T * s + c + rng.randn(5, 2) * 1.5)
    return np.asarray(out, np.float32)


def test_template_and_layout_match_jax():
    for width in (112, 96):
        np.testing.assert_array_equal(ta.arcface_template(width), ja.arcface_template(width))
    pts = np.random.RandomState(1).rand(4, 10).astype(np.float32) * 100
    np.testing.assert_array_equal(ta.landmarks_from_detector(pts),
                                  ja.landmarks_from_detector(pts))


def test_landmark_layout():
    pts = np.arange(20).reshape(2, 10).astype(np.float32)
    lmk = ta.landmarks_from_detector(pts)
    assert lmk.shape == (2, 5, 2)
    np.testing.assert_array_equal(lmk[0, :, 0], pts[0, 0:5])
    np.testing.assert_array_equal(lmk[0, :, 1], pts[0, 5:10])


@pytest.mark.parametrize("out_size", [112, 96])
def test_estimate_similarity_matches_jax(out_size):
    """Batched over faces on the port's side, one face at a time on JAX's,
    reflections included (a mirrored face's points)."""
    rng = np.random.RandomState(out_size)
    src = _landmarks(rng, 12, out_size)
    src[::4, :, 0] = 200 - src[::4, :, 0]                # mirrored: det(cov) < 0
    dst = ja.arcface_template(out_size)
    got = ta.estimate_similarity(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    want = np.stack([np.asarray(ja.estimate_similarity(jnp.asarray(s), jnp.asarray(dst)))
                     for s in src])
    assert got.shape == (12, 2, 3)
    np.testing.assert_allclose(got, want, rtol=M_REL, atol=M_REL * np.abs(want).max())


def test_estimate_similarity_degenerate_points_match_jax():
    """All five points equal: the variance clamp gives scale 0 and the
    template's mean as the shift; the warp of such a map is NaN in both."""
    src = np.full((1, 5, 2), 37.5, np.float32)
    dst = ja.arcface_template(112)
    got = ta.estimate_similarity(torch.from_numpy(src), torch.from_numpy(dst)).numpy()[0]
    want = np.asarray(ja.estimate_similarity(jnp.asarray(src[0]), jnp.asarray(dst)))
    np.testing.assert_allclose(got, want, rtol=M_REL)
    np.testing.assert_array_equal(got[:, :2], 0.0)
    img = np.random.RandomState(2).rand(40, 40, 3).astype(np.float32) * 255
    out = ta.warp_affine(torch.from_numpy(img), torch.from_numpy(got[None]), (8, 8))
    ref = np.asarray(ja.warp_affine(jnp.asarray(img), jnp.asarray(want), (8, 8)))
    assert np.isnan(out.numpy()).all() and np.isnan(ref).all()


def test_estimate_similarity_exact_recovery():
    """Recover a known similarity transform from noiseless points."""
    rng = np.random.RandomState(3)
    theta, scale, tx, ty = 0.3, 1.7, 12.0, -5.0
    r = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    src = rng.rand(5, 2) * 50
    dst = (scale * src @ r.T) + np.array([tx, ty])
    m = ta.estimate_similarity(torch.tensor(src[None], dtype=torch.float32),
                               torch.tensor(dst, dtype=torch.float32)).numpy()[0]
    np.testing.assert_allclose(m[:, :2], scale * r, atol=1e-3)
    np.testing.assert_allclose(m[:, 2], [tx, ty], atol=1e-2)


def test_estimate_similarity_vs_cv2():
    """cv2.estimateAffinePartial2D (a robust LMEDS fit) as the golden, in
    point space."""
    rng = np.random.RandomState(4)
    dst = ta.arcface_template(112)
    theta, scale = 0.2, 1.3
    r = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]], np.float32)
    src = (dst - 56.0) @ r.T / scale + 56.0 + rng.randn(5, 2).astype(np.float32) * 0.5
    want, _ = cv2.estimateAffinePartial2D(src.reshape(-1, 1, 2), dst.reshape(-1, 1, 2),
                                          method=cv2.LMEDS)
    got = ta.estimate_similarity(torch.from_numpy(src[None]), torch.from_numpy(dst)).numpy()[0]
    ones = np.concatenate([src, np.ones((5, 1), np.float32)], axis=1)
    np.testing.assert_allclose(ones @ got.T, ones @ want.T, atol=1.0)


def _mats(rng, n):
    """Affines near the identity and far from it, some mapping most of the
    output outside the image."""
    m = []
    for i in range(n):
        th, s = rng.uniform(-0.5, 0.5), rng.uniform(0.5, 2.0)
        shift = rng.uniform(-60, 60, 2) * (3 if i % 3 == 0 else 1)
        m.append([[s * np.cos(th), -s * np.sin(th), shift[0]],
                  [s * np.sin(th), s * np.cos(th), shift[1]]])
    return np.asarray(m, np.float32)


def test_warp_affine_matches_jax():
    rng = np.random.RandomState(5)
    img = (rng.rand(80, 100, 3) * 255).astype(np.float32)
    mats = _mats(rng, 9)
    got = ta.warp_affine(torch.from_numpy(img), torch.from_numpy(mats), (48, 64)).numpy()
    want = np.stack([np.asarray(ja.warp_affine(jnp.asarray(img), jnp.asarray(m), (48, 64)))
                     for m in mats])
    assert got.shape == (9, 48, 64, 3)
    zero = want == 0
    assert zero.mean() > 0.1 and np.array_equal(got[zero], want[zero])
    assert np.abs(got - want).max() <= PIXEL_ATOL


def test_warp_affine_vs_cv2():
    rng = np.random.RandomState(6)
    img = (rng.rand(80, 100, 3) * 255).astype(np.float32)
    m = np.array([[0.9, 0.1, 5.0], [-0.1, 0.9, 3.0]], dtype=np.float32)
    want = cv2.warpAffine(img, m, (64, 48))
    got = ta.warp_affine(torch.from_numpy(img), torch.from_numpy(m[None]), (48, 64)).numpy()[0]
    # interior agreement (borders differ by partial-pixel conventions)
    assert np.abs(got[2:-2, 2:-2] - want[2:-2, 2:-2]).max() < 1.5


@pytest.mark.parametrize("out_size", [112, 96])
def test_align_faces_matches_jax(out_size):
    rng = np.random.RandomState(7 + out_size)
    img = (rng.rand(200, 200, 3) * 255).astype(np.uint8)
    lmk = _landmarks(rng, 6, out_size)
    got = ta.align_faces(img, lmk, out_size, device="cpu")
    want = np.asarray(ja.align_faces(jnp.asarray(img), jnp.asarray(lmk), out_size))
    assert got.dtype == torch.float32 and got.shape == (6, out_size, out_size, 3)
    assert np.abs(got.numpy() - want).max() <= ALIGN_ATOL


def test_align_faces_roundtrip():
    """Landmarks that already match the template, shifted: the alignment is
    a pure translation, the crop at that shift."""
    img = (np.random.RandomState(8).rand(200, 200, 3) * 255).astype(np.float32)
    template = ta.arcface_template(112) + np.array([40.0, 50.0], np.float32)
    aligned = ta.align_faces(img, template[None], device="cpu").numpy()
    assert aligned.shape == (1, 112, 112, 3)
    assert np.abs(aligned[0] - img[50:50 + 112, 40:40 + 112]).max() < 1e-2


def test_align_faces_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ta.align_faces(np.zeros((8, 8, 3), np.uint8), np.zeros((1, 5, 2), np.float32))
