"""The host-side choices of the Hopper kernels K3 (warp) and K4 (int8
pointwise conv), on the CPU, where the CUDA kernels cannot run:

- K4's block tile (``tile_config``): at every pointwise layer of the int8
  MobileNet, at a head batch of 16 faces and at the embedder's batch of
  1024, a tile that makes at least one tile for each of the H100's 132
  SMs, the largest such no wider than the layer, or else the smallest;
- K4's copy width (``load_width``): 16-byte copies where K and the operand
  addresses allow them, 4-byte, else bytes;
- K3's prologue: the kernel computes the per-image scalars from the raw
  mats itself, in the order below; a numpy float32 mirror of that order
  equals ``warp_scalars`` (the plain version's) bit for bit, with and
  without flips.
"""

import numpy as np
import pytest
import torch

from hse_facerec_torch.ops.kernels import pw_conv
from hse_facerec_torch.ops.kernels import warp
from hse_facerec_torch.train.augment import AugmentConfig, sample_affine

# the 13 pointwise layers of MobileNet-V1 alpha 1.0 at 224²: (name, pixels
# per face, K, N)
PW_LAYERS = [("pw1", 12544, 32, 64), ("pw2", 3136, 64, 128),
             ("pw3", 3136, 128, 128), ("pw4", 784, 128, 256),
             ("pw5", 784, 256, 256), ("pw6", 196, 256, 512)] + [
    (f"pw{i}", 196, 512, 512) for i in range(7, 12)] + [
    ("pw12", 49, 512, 1024), ("pw13", 49, 1024, 1024)]
SMS = 132   # the streaming multiprocessors of an H100 SXM


def _blocks(m, n, tile):
    return -(-m // tile[0]) * -(-n // tile[1])


@pytest.mark.parametrize("batch", [16, 1024])
@pytest.mark.parametrize("name,pixels,k,n", PW_LAYERS)
def test_tile_config_fills_the_card(name, pixels, k, n, batch):
    m = pixels * batch
    tile = pw_conv.tile_config(m, n, SMS)
    assert tile in pw_conv.TILES
    filling = [t for t in pw_conv.TILES
               if _blocks(m, n, t) >= SMS and t[1] <= n]
    if filling:
        assert tile == filling[0]             # the largest tile that fills
        assert _blocks(m, n, tile) >= SMS
    else:
        assert tile == pw_conv.TILES[-1]      # nothing fills: the smallest


def test_tile_config_at_the_embedder_batch():
    """At batch 1024 every layer but pw1 fills the card with 128 x 128
    tiles (pw13: 392 x 8 of them); pw1 (N = 64) takes 64 x 64, no wider
    than its output; at batch 16 pw2 (392 tiles) still takes 128 x 128 and
    pw13 (13 x 16 tiles of 64 x 64) falls to the smallest."""
    tiles = {name: pw_conv.tile_config(p * 1024, n, SMS) for name, p, _, n in PW_LAYERS}
    assert tiles.pop("pw1") == (64, 64)
    assert set(tiles.values()) == {(128, 128)}
    assert pw_conv.tile_config(3136 * 16, 128, SMS) == (128, 128)
    assert pw_conv.tile_config(49 * 16, 1024, SMS) == (64, 64)
    assert pw_conv.tile_config(1, 1, SMS) == (64, 64)


@pytest.mark.parametrize("k,want", [(1024, 16), (52, 4), (30, 1)])
def test_load_width_by_k(k, want):
    assert pw_conv.load_width(k, 0, 512) == want


def test_load_width_by_address():
    assert pw_conv.load_width(1024, 0, 8) == 4          # 4-byte aligned only
    assert pw_conv.load_width(1024, 2, 512) == 1        # off a word
    assert pw_conv.load_width(64) == 16


def _fma32(a, b, c):
    """a·b + c rounded once to float32 (the float32 product is exact in
    float64), as ``__fmaf_rn``."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
            ).astype(np.float32)


def _kernel_prologue(mats, w):
    """The order ``csrc/warp.cu::image_scalars`` computes the scalars in,
    in numpy float32: flip = m00 < 0; m00, m10 negated under a flip; m02 and
    m12 plus the rounded product col0·(W-1) under a flip (a rounded sum,
    no FMA); b = m10 / m00, IEEE; a = fma(-b, m01, m11), g = fma(-b, m02,
    m12)."""
    m = np.asarray(mats, np.float32)
    M00, M01, M02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    M10, M11, M12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    neg = M00 < 0
    wm1 = np.float32(w - 1)
    zero = np.float32(0.0)
    m00 = np.where(neg, -M00, M00)
    m10 = np.where(neg, -M10, M10)
    m02 = M02 + np.where(neg, M00 * wm1, zero)
    m12 = M12 + np.where(neg, M10 * wm1, zero)
    b = m10 / m00
    a = _fma32(-b, M01, M11)
    g = _fma32(-b, m02, m12)
    flip = np.where(neg, np.float32(-1.0), np.float32(1.0))
    return np.stack([m00, M01, m02, m10, M11, m12, flip,
                     np.full_like(m00, 0.25), b, a, g], axis=1)


@pytest.mark.parametrize("cfg,flips", [
    (AugmentConfig(), "some"),
    (AugmentConfig(shift=0.5, rotation_deg=30), "some"),
    (AugmentConfig(horizontal_flip=False, zoom=0.0), "none")])
def test_kernel_prologue_equals_warp_scalars_bitwise(cfg, flips):
    n, h, w = 64, 224, 224
    mats = sample_affine(torch.Generator().manual_seed(11), cfg, n, h, w)
    neg = (mats[:, 0, 0] < 0).numpy()
    assert neg.any() == (flips == "some") and not neg.all()
    want = warp.warp_scalars(mats, w, 0.25).numpy()
    got = _kernel_prologue(mats.numpy(), w)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))

