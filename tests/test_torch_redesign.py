"""The host-side choices of the Hopper kernels K2 (1-NN), K3 (warp) and K4
(int8 pointwise conv), on the CPU, where the CUDA kernels cannot run:

- K2's gallery splits (``knn.sweep_config``) at the serving, design and
  routed shapes, with the block tiles an H100 gives: the splits cover every
  gallery tile, none is empty, at least two blocks an SM are launched (the
  int8 tile itself, from the kernel's shared memory, is held on the card);
- K2b's in-sweep norms: a numpy mirror of what the kernel forms (an int32
  sum of squares per row, one f32 multiply by c, +inf from valid_n on)
  equals the host's b2v bit for bit;

- K2's int8 sweep: rows padded to whole 16-byte words (``_pad_dim``),
  the one ``wgmma`` route; the batch rows' splits fill the card in whole
  waves;
- K4's tile and launch (``tile_config``, ``plan``): every pointwise layer
  of the int8 MobileNet at batch 16, 64 (192²) and 1024 in persistent
  blocks of the tile whose whole waves over the H100's 132 SMs cost least,
  at most one block an SM; at batch 1024 each layer makes a tile an SM;
- K4's operands (``tma_operands``): a ragged K zero-padded to whole
  16-byte words and a base off 16 bytes copied, with the same outputs;
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
    """The tile of each layer (on pw1's product packed two pixels a row):
    one of ``TILES``, no wider than the layer (64 channels always
    allowed), the one whose whole waves of tiles over the 132 SMs cost
    least, a wave costing its outputs times the tile's relative time an
    output, ties to the larger; at batch 1024 it makes at least a tile an
    SM and fills 98% of the waves it takes."""
    m, n = pixels * batch // (2 if k == 32 else 1), n * (2 if k == 32 else 1)
    tile = pw_conv.tile_config(m, n, SMS)
    assert tile in pw_conv.TILES
    allowed = [t for t in pw_conv.TILES if t[1] <= n or t[1] == 64]
    cost = {t: -(-_blocks(m, n, t) // SMS) * t[0] * t[1] * pw_conv.TILES[t]
            for t in allowed}
    assert tile in allowed and cost[tile] == min(cost.values())
    assert all(t[0] * t[1] <= tile[0] * tile[1] for t in allowed if cost[t] == cost[tile])
    if batch == 1024:
        blocks = _blocks(m, n, tile)
        assert blocks >= SMS and blocks / (-(-blocks // SMS) * SMS) >= 0.98


def test_tile_config_at_the_embedder_batch():
    """At batch 1024 every layer takes 256 x 128 tiles (pw1 on its packed
    product, 128 channels); at batch 16 pw2 (on 392 tiles of 128 x 128)
    and pw13 (128 x 64: 7 x 16 tiles, one wave) take smaller ones; one
    output takes the narrowest tile."""
    tiles = {name: pw_conv.tile_config(p * 1024 // (2 if k == 32 else 1),
                                       n * (2 if k == 32 else 1), SMS)
             for name, p, k, n in PW_LAYERS}
    assert set(tiles.values()) == {(256, 128)}
    assert pw_conv.tile_config(3136 * 16, 128, SMS) == (128, 128)
    assert pw_conv.tile_config(49 * 16, 1024, SMS) == (128, 64)
    assert pw_conv.tile_config(1, 1, SMS) == (128, 64)


# the tile per layer: (batch, size) -> (BM, BN) of pw1..pw13
_T64, _T128, _W128, _W64 = (128, 64), (128, 128), (256, 128), (256, 64)
WGMMA_TILE_BY_BATCH = {
    (16, 224): [_W128, _T128, _T128, _W128, _W128] + [_T128] * 6 + [_T64, _T64],
    (64, 192): [_W128] * 5 + [_T128] * 6 + [_W128, _W128],
    (1024, 224): [_W128] * 13}


def _layer_m(pixels, batch, size):
    return (int(np.sqrt(pixels)) * size // 224) ** 2 * batch


@pytest.mark.parametrize("batch,size", sorted(WGMMA_TILE_BY_BATCH))
def test_plan_puts_every_layer_on_wgmma(batch, size):
    """Every MobileNet layer runs on wgmma as it is (K a multiple of 16):
    the tile (BM 128 or 256, BN 64 or 128, no wider than the layer) whose
    whole waves of tiles over the 132 SMs cost least,
    a wave costing its outputs times the tile's relative time an output
    (ties to the larger), for pw1 (K 32) on its packed product of two
    pixels a 64-byte row; persistent blocks, one an SM or one a tile where
    there are fewer tiles. At batch 1024 every layer makes at least a tile
    an SM, and its tiles fill 98% of the waves they take (at batch 16 and
    64 some layers make fewer tiles than SMs: one wave of large tiles
    costs less than more waves of small ones)."""
    tiles_taken = []
    for name, pixels, k, n in PW_LAYERS:
        m = _layer_m(pixels, batch, size)
        p = pw_conv.plan(m, n, k, SMS)
        # pw1's 32-byte rows go two pixels a 64-byte row
        assert p.pack == (2 if k == 32 else 1)
        m, n = m // p.pack, n * p.pack
        tiles = -(-m // p.bm) * -(-n // p.bn)
        assert k % pw_conv.ROW_WORD == 0
        assert p.grid == min(tiles, SMS)
        allowed = [t for t in pw_conv.TILES if t[1] <= n or t[1] == 64]
        cost = {t: -(-(-(-m // t[0]) * -(-n // t[1])) // SMS) * t[0] * t[1]
                * pw_conv.TILES[t] for t in allowed}
        assert cost[(p.bm, p.bn)] == min(cost.values())
        if batch == 1024:
            assert tiles >= SMS and tiles / (-(-tiles // SMS) * SMS) >= 0.98
        tiles_taken.append((p.bm, p.bn))
    assert tiles_taken == WGMMA_TILE_BY_BATCH[(batch, size)]


@pytest.mark.parametrize("k,offsets,kp", [(1024, (0, 0), 1024), (32, (0, 0), 32),
                                         (16, (16, 32), 16), (36, (0, 0), 48),
                                         (30, (0, 0), 32), (1024, (8, 0), 1024),
                                         (1024, (0, 4), 1024), (8, (0, 0), 16),
                                         (52, (4, 8), 64), (1, (0, 0), 16),
                                         (48, (8, 8), 48)])
def test_tma_operands_pad_ragged_k_and_align_bases(k, offsets, kp):
    """What TMA copies: K zero-padded to whole 16-byte words, an operand
    off 16 bytes copied, every MobileNet-like operand passed as it is; the
    plain version on the result equals it on the operands given, bit for
    bit, int8 and f32 out, and the plan takes the padded K."""
    m, n = 1000, 50
    rng = np.random.RandomState(k + sum(offsets))

    def at(offset, rows, x):
        t = torch.empty(rows * k + offset, dtype=torch.int8)[offset:].view(rows, k)
        return t.copy_(torch.from_numpy(x))

    a = at(offsets[0], m, rng.randint(0, 128, (m, k)).astype(np.int8))
    w = at(offsets[1], n, rng.randint(-127, 128, (n, k)).astype(np.int8))
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, n) * 3.0 / (2700.0 * np.sqrt(k)))
                             .astype(np.float32))
    bias = torch.from_numpy((rng.rand(n) * 4.0 - 1.0).astype(np.float32))
    ta, tw = pw_conv.tma_operands(a, w)
    assert ta.shape == (m, kp) and tw.shape == (n, kp)
    assert ta.data_ptr() % 16 == 0 and tw.data_ptr() % 16 == 0
    if kp == k and offsets == (0, 0) and a.data_ptr() % 16 == 0:
        assert ta is a and tw is w
    for requant in (True, False):
        assert torch.equal(pw_conv.pw_conv_int8_plain(ta, tw, scale, bias, requant),
                           pw_conv.pw_conv_int8_plain(a, w, scale, bias, requant))
    assert pw_conv.plan(m, n, kp, SMS).grid <= SMS


def test_plan_is_computed_once_per_shape():
    """A forward asks for the same 13 shapes every call: the plan is cached
    on (m, n, k, sms), so a repeated call costs one lookup and returns the
    same plan."""
    m, n, k = 12544 * 16, 64, 32
    first = pw_conv.plan(m, n, k, SMS)
    hits = pw_conv.plan.cache_info().hits
    assert pw_conv.plan(m, n, k, SMS) is first
    assert pw_conv.plan.cache_info().hits == hits + 1
    assert pw_conv.plan(m, n, k, SMS - 1) is not first


@pytest.mark.parametrize("m,k,pack", [(12544, 32, 2), (5000, 16, 4), (777, 32, 1),
                                      (1000, 64, 1), (1000, 48, 1)])
def test_pack_rows_gives_the_same_outputs(m, k, pack):
    """The wgmma route packs 64 / K pixels a 64-byte row where K divides 64
    and M: the plan says so, and the plain version on the packed operands
    (the activation's memory as (M / pack, 64), the block-diagonal weight,
    scale and bias tiled) equals it on the layer as given, bit for bit,
    int8 and f32 out. The packed weight is cached per weight tensor and
    made again after an in-place update."""
    n = 24
    assert pw_conv.plan(m, n, k, SMS).pack == pack
    if pack == 1:
        return
    rng = np.random.RandomState(m + k)
    a = torch.from_numpy(rng.randint(0, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, n) * 3.0 / (2700.0 * np.sqrt(k)))
                             .astype(np.float32))
    bias = torch.from_numpy((rng.rand(n) * 4.0 - 1.0).astype(np.float32))
    packed = pw_conv.pack_rows(w, scale, bias, pack)
    assert packed[0].shape == (pack * n, 64)
    for requant in (True, False):
        want = pw_conv.pw_conv_int8_plain(a, w, scale, bias, requant)
        got = pw_conv.pw_conv_int8_plain(a.view(m // pack, 64), *packed, requant)
        assert torch.equal(got.view(m, n), want)
    assert pw_conv.pack_rows(w, scale, bias, pack)[0] is packed[0]
    w.add_(1)
    again = pw_conv.pack_rows(w, scale, bias, pack)[0]
    assert again is not packed[0] and torch.equal(again[:n, :k], w)


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
    on wgmma, serving queries too, the resident 128-probe tile, two blocks
    an SM at D = 512, one at D = 1024 (128 KB); past D = 1408 the probe
    tile streams, two blocks an SM at any width), the bf16 sweep's
    streamed tile and the f32 sweep's fixed one."""
    if int8 == "bf16":
        return knn.bf16_tile(m), knn.BF16_PER_SM
    if not int8:
        return knn.F32_TM, 2
    assert d % knn.ROW_WORD == 0
    return 128, 1 if 768 < d <= 1408 else 2


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


# the int8 rows of KNN_SWEEPS
KNN_INT8_SHAPES = [(m, n, d) for m, n, d, int8 in KNN_SWEEPS if int8 is True]


@pytest.mark.parametrize("m,n,d", KNN_INT8_SHAPES)
def test_knn_int8_route_and_whole_waves(m, n, d):
    """Each int8 row runs on the one route, wgmma fed by TMA, the serving
    queries (16 probes or fewer) too: its rows are whole 16-byte words as
    they are, and a row 4 bytes longer is zero-padded to them; a batch
    row's blocks fill the 132 SMs' slots in whole waves, a serving query's
    make two blocks an SM at least (one probe tile, 512 splits)."""
    q = torch.ones((3, d), dtype=torch.int8)
    assert knn._pad_dim(q).shape == (3, d) and knn._pad_dim(q).data_ptr() == q.data_ptr()
    padded = knn._pad_dim(torch.ones((3, d + 4), dtype=torch.int8))
    assert padded.shape == (3, d + 16) and int(padded[:, d + 4:].abs().sum()) == 0
    tm, per_sm = _h100_tile(m, d, True)
    cfg = knn.sweep_config(m, n, SMS, tm, per_sm)
    blocks = -(-m // tm) * cfg.splits
    assert tm == 128
    if m > 16:
        assert blocks % (SMS * per_sm) == 0
    else:
        assert blocks >= SMS * per_sm


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
