"""The host-side choices of the Hopper kernels K2 (1-NN), K3 (warp) and K4
(int8 pointwise conv), on the CPU, where the CUDA kernels cannot run:

- K2's gallery splits (``knn.sweep_config``) at the serving, design and
  routed shapes, with the block tiles an H100 gives: the splits cover every
  gallery tile, none is empty, at least two blocks an SM are launched (the
  int8 tile itself, from the kernel's shared memory, is held on the card);
- K2b's in-sweep norms: a numpy mirror of what the kernel forms (an int32
  sum of squares per row, one f32 multiply by c, +inf from valid_n on)
  equals the host's b2v bit for bit;

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

from hse_facerec_torch.ops.kernels import knn
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



# (M probes, N gallery rows, D, sweep: True int8, False f32, "bf16"):
# serving queries, the int8 design point, K2a's routed shape and the int8
# identify at scale, K2a at serving; the int8 sweep at vggface_vgg16's
# 4096-d (the streamed probe tile); K2a's bf16 sweep at the benchmark's
# shape and at a serving query
KNN_SWEEPS = [(1, 1 << 20, 512, True), (16, 1 << 20, 512, True),
              (8192, 1 << 20, 512, True), (2048, 1 << 20, 1024, True),
              (2048, 1 << 20, 1024, False), (16, 1 << 20, 512, False),
              (8192, 1 << 20, 4096, True), (8192, 1 << 20, 512, "bf16"),
              (16, 1 << 20, 512, "bf16")]


def _h100_tile(m, d, int8):
    """(probes a block, blocks an SM) on an H100: ``knn.int8_tile``'s answer
    for the int8 sweep (held on the card by ``test_knn_int8_tile_on_card``:
    at D = 1024 the 128 KB resident probe tile leaves room for one block an
    SM; past D = 1536 the probe tile streams, 128 probes and two blocks an
    SM at any width), the bf16 sweep's streamed tile and the f32 sweep's
    fixed one."""
    if int8 == "bf16":
        return knn.bf16_tile(m), knn.BF16_PER_SM
    if not int8:
        return knn.F32_TM, 2
    if m <= 16:
        return 16, 2
    return 128, 1 if 768 < d <= 1536 else 2


@pytest.mark.parametrize("m,n,d,int8", KNN_SWEEPS)
def test_knn_sweep_config_fills_the_card(m, n, d, int8):
    tm, per_sm = _h100_tile(m, d, int8)
    cfg = knn.sweep_config(m, n, SMS, tm, per_sm)
    n_tiles = -(-n // knn.TILE_N)
    assert cfg.tm == tm
    assert cfg.splits * cfg.tiles_per_split >= n_tiles          # every tile
    assert (cfg.splits - 1) * cfg.tiles_per_split < n_tiles     # none empty
    assert cfg.splits <= knn.MAX_SPLITS
    blocks = -(-m // cfg.tm) * cfg.splits
    assert blocks >= 2 * SMS


def test_knn_sweep_config_in_whole_waves():
    """At the design point the 2,112 blocks of 128 probes make 8 whole waves
    of 2 blocks an SM; at D = 1024, one block an SM, 528 blocks make 4
    waves; a serving query takes 16 probes a block and 512 splits of 16
    tiles."""
    design = knn.sweep_config(8192, 1 << 20, SMS, 128, 2)
    assert (design.tm, design.splits, design.tiles_per_split) == (128, 33, 249)
    routed = knn.sweep_config(2048, 1 << 20, SMS, 128, 1)
    assert 16 * routed.splits == 528
    serve = knn.sweep_config(16, 1 << 20, SMS, 16, 2)
    assert (serve.tm, serve.splits, serve.tiles_per_split) == (16, 512, 16)
    assert knn.sweep_config(1, 5, SMS, 16, 2) == (16, 1, 1)


def _in_sweep_b2v(q, c, valid_n):
    """What the int8 sweep forms per gallery row: the exact int32 sum of
    squares, converted to f32 and multiplied by c once (float32 x float32
    rounds once in numpy), +inf from valid_n on."""
    sumsq = np.sum(q.astype(np.int32) ** 2, axis=1, dtype=np.int32)
    b2 = sumsq.astype(np.float32) * np.float32(c)
    n = q.shape[0]
    lim = n if valid_n is None else max(0, min(valid_n, n))
    return np.where(np.arange(n) < lim, b2, np.float32(np.inf)).astype(np.float32)


@pytest.mark.parametrize("valid_n", [None, 0, 1, 127, 128, 299, 10_000])
@pytest.mark.parametrize("d", [30, 512, 1024, 4096])
def test_in_sweep_norms_equal_host_b2v_bitwise(d, valid_n):
    rng = np.random.RandomState(d)
    n = 300
    g = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    p = torch.from_numpy(rng.randn(7, d).astype(np.float32))
    qb, sb = knn.quantize_embeddings(g)
    q = knn._pad_dim(qb)
    ops = knn._int8_operands(p, knn._sumsq(q), sb, valid_n, False)
    got = _in_sweep_b2v(q.numpy(), ops.c.numpy(), valid_n)
    want = ops.b2v.numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isinf(got).sum() == n - knn._valid_rows(n, valid_n)
