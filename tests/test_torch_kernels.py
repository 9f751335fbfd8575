"""The kernels K1 (crop), K2a/K2b/K2c (1-NN), K3 (warp) and K4 (int8
pointwise conv): their wrappers' routing, their build, and each kernel on
the card against its plain twin.

This file imports no JAX (neither does the package), so the card tests run
on a machine without it, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tests marked ``cuda`` skip where ``torch.cuda.is_available()`` is False. On
the card K1 must match ``crop_resize_bilinear`` (and its batch forms, one
launch each) within 1e-3 (0-255 pixel units) on noise images: sample
positions and hat weights are bit-identical, only the order of the sums
differs; a lane out of range writes NaN. K2b/K2c must equal
``nearest_neighbor_int8_plain`` bit for bit in index and distance (an
exact int32 dot, one f32 rounding per key). K2a sums in another order than
its twin: distances within rtol 1e-4 / atol 1e-3, and the same index
wherever the twin's two best candidates differ by more than that. K4 must
equal ``pw_conv_int8_plain`` bit for bit, int8 and f32 out (an exact int32
dot, one fused multiply-add, the same clip and round). K3 must match
``warp_batch_plain`` within 1e-6 on unit-range images: coordinates, taps and
bf16 roundings are the same; the plain version's FMAs round through float64,
which can differ from the card's single rounding by one ulp of a blended
value in rare double-rounding cases.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hse_facerec_torch.ops import resize as tr
from hse_facerec_torch.ops.kernels import build
from hse_facerec_torch.ops.kernels import knn
from hse_facerec_torch.ops.kernels import pw_conv
from hse_facerec_torch.ops.kernels import warp
from hse_facerec_torch.ops.kernels.crop import crop_resize
from hse_facerec_torch.train.augment import AugmentConfig, sample_affine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def rng():
    return np.random.RandomState(2025)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _crop_boxes(rng, k, H, W):
    """Seeded boxes, partly off the image; the first fully outside."""
    y1 = rng.uniform(-30, H - 10, k)
    x1 = rng.uniform(-30, W - 10, k)
    s = rng.uniform(6, 150, k)
    boxes = np.stack([y1, x1, y1 + s, x1 + s], -1).astype(np.float32)
    boxes[0] = [-40.0, -40.0, -8.0, -8.0]
    return boxes


def test_crop_wrapper_cpu_takes_plain_path(rng):
    img = _t((rng.rand(40, 50, 3) * 255).astype(np.float32))
    boxes = _t(_crop_boxes(rng, 8, 40, 50))
    crop_resize.launches = 0
    for outside in ("zero", "clamp"):
        got = crop_resize(img, boxes, 24, 2, outside)
        want = tr.crop_resize_bilinear(img, boxes, 24, 2, outside)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert crop_resize.launches == 0


def test_crop_wrapper_rejects_other_devices(rng):
    img = torch.zeros((40, 50, 3), device="meta")
    boxes = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        crop_resize(img, boxes, 24, 2, "zero")
    with pytest.raises(ValueError):
        crop_resize(torch.zeros(40, 50, 3), torch.zeros(8, 4), 24, 2, "edge")


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(tmp_path / "lib.so")


def test_build_key_tracks_sources(tmp_path, monkeypatch):
    assert [p.name for p in build.sources()] == ["attention.cu", "bn_act.cu",
                                                 "crop_resize.cu", "knn.cu", "pw_conv.cu",
                                                 "warp.cu"]
    assert [p.name for p in build.headers()] == ["mma_s8.cuh"]
    key = build.source_hash()
    assert key == build.source_hash() and len(key) == 16
    assert build.library_path().parent.name == key
    # an edit to a header (not compiled on its own) changes the key too
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.sources() + build.headers():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    assert build.source_hash() == key
    with open(csrc / "mma_s8.cuh", "a") as f:
        f.write("// edited\n")
    assert build.source_hash() != key


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, loads without jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hse_facerec_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.cuda
@pytest.mark.parametrize("k,out_size,supersample,outside", [
    (128, 24, 2, "zero"), (64, 48, 2, "zero"), (16, 224, 1, "clamp")])
def test_crop_kernel_matches_plain_on_card(cuda, rng, k, out_size, supersample,
                                           outside):
    H, W = 480, 640
    img = _t((rng.rand(H, W, 3) * 255).astype(np.float32)).to(cuda)
    boxes = _t(_crop_boxes(rng, k, H, W)).to(cuda)
    before = crop_resize.launches
    got = crop_resize(img, boxes, out_size, supersample, outside)
    want = tr.crop_resize_bilinear(img, boxes, out_size, supersample, outside)
    torch.cuda.synchronize()
    assert crop_resize.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-3


# K1's batch forms: (L, K, 4) boxes, or a lane per box (ragged, all in one
# lane, lanes left empty), at the analyze path's sizes and odd ones
CROP_LANES = {"ragged": [0, 0, 2, 2, 2, 0, 2, 1] * 4, "one_lane": [1] * 16,
              "empty_lanes": [0, 3] * 5}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["batch"] + sorted(CROP_LANES))
@pytest.mark.parametrize("out_size,supersample,outside,c", [
    (24, 2, "zero", 3), (48, 2, "zero", 3), (224, 1, "clamp", 3),
    (17, 3, "zero", 1), (30, 2, "clamp", 4)])
def test_crop_kernel_batch_forms_match_plain_on_card(cuda, rng, form, out_size,
                                                     supersample, outside, c):
    L, H, W = 4, 120, 160
    imgs = _t((rng.rand(L, H, W, c) * 255).astype(np.float32)).to(cuda)
    before = crop_resize.launches
    if form == "batch":
        boxes = _t(np.stack([_crop_boxes(rng, 9, H, W) for _ in range(L)])).to(cuda)
        got = crop_resize(imgs, boxes, out_size, supersample, outside)
        want = tr.crop_resize_bilinear_batch(imgs, boxes, out_size, supersample,
                                             outside)
    else:
        lanes = _t(np.asarray(CROP_LANES[form], np.int32)).to(cuda)
        boxes = _t(_crop_boxes(rng, len(lanes), H, W)).to(cuda)
        got = crop_resize(imgs, boxes, out_size, supersample, outside, lanes=lanes)
        want = tr.crop_resize_bilinear_lanes(imgs, lanes, boxes, out_size,
                                             supersample, outside)
    torch.cuda.synchronize()
    assert crop_resize.launches == before + 1
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_crop_kernel_writes_nan_for_a_lane_out_of_range(cuda, rng):
    imgs = _t((rng.rand(2, 40, 50, 3) * 255).astype(np.float32)).to(cuda)
    boxes = _t(_crop_boxes(rng, 4, 40, 50)).to(cuda)
    lanes = torch.tensor([0, 2, -1, 1], dtype=torch.int32, device=cuda)
    got = crop_resize(imgs, boxes, 24, 2, "zero", lanes=lanes)
    torch.cuda.synchronize()
    assert bool(got[1].isnan().all()) and bool(got[2].isnan().all())
    want = tr.crop_resize_bilinear_lanes(imgs, lanes[[0, 3]], boxes[[0, 3]], 24, 2,
                                         "zero")
    assert float((got[[0, 3]] - want).abs().max()) <= 1e-3


def _unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _knn_launches():
    return (knn.nearest_neighbor_f32.launches, knn.nearest_neighbor_int8q.launches,
            knn.nearest_neighbor_int8p.launches)


def test_knn_wrappers_cpu_take_plain_path(rng):
    p, g = _t(_unit_rows(rng, 5, 20)), _t(_unit_rows(rng, 40, 20))
    qb, sb = knn.quantize_embeddings(g)
    before = _knn_launches()
    for pack in (False, True):
        got = knn.nearest_neighbor_int8q(p, qb, sb, pack_idx=pack)
        want = knn.nearest_neighbor_int8_plain(p, qb, sb, pack_idx=pack)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        got = knn.nearest_neighbor_int8p(p, *knn.pack_quantized_gallery(qb, sb),
                                         pack_idx=pack)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    got = knn.nearest_neighbor_f32(p, g)
    want = knn.nearest_neighbor_plain(p, g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert _knn_launches() == before


def test_knn_wrappers_reject_other_devices():
    p = torch.zeros((4, 8), device="meta")
    g = torch.zeros((16, 8), device="meta")
    with pytest.raises(ValueError):
        knn.nearest_neighbor_f32(p, g)
    with pytest.raises(ValueError):
        knn.nearest_neighbor_f32(torch.zeros(4, 8), g)
    with pytest.raises(TypeError):
        knn.nearest_neighbor_int8q(torch.zeros(4, 8), torch.zeros(16, 8), 1.0)
    with pytest.raises(ValueError):
        knn.nearest_neighbor_int8q(torch.zeros(0, 8),
                                   torch.zeros(16, 8, dtype=torch.int8), 1.0)


# (M, N, D): ragged and tiny, tile edges, the serving shapes; then D off
# whole 32- and 64-byte K steps (30, 100, 1000: rows zero-padded to whole
# 16-byte words) and M at the edges of 16 probes (the serving size) and of
# the 128-probe tile; then widths past the resident probe tile, where it
# streams (1700, padded; 4096: vggface_vgg16's), and a serving query at 4096
KNN_CARD_SHAPES = [(1, 5, 30), (7, 129, 64), (37, 1000, 30), (1, 100_000, 512),
                   (16, 100_000, 512), (300, 20_000, 512), (1, 300, 1000),
                   (16, 777, 100), (17, 5000, 100), (128, 3000, 1000),
                   (129, 2000, 30), (129, 1000, 1700), (300, 3000, 4096),
                   (16, 5000, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("pack_idx", [False, True])
@pytest.mark.parametrize("m,n,d", KNN_CARD_SHAPES)
def test_knn_int8_kernels_equal_plain_on_card(cuda, m, n, d, pack_idx):
    rng = np.random.RandomState(m + n + d)
    g = _unit_rows(rng, n, d)
    g[n // 2:n // 2 + 3] = g[1:4]              # exact ties with lower rows
    p = _t(_unit_rows(rng, m, d)).to(cuda)
    qb, sb = knn.quantize_embeddings(_t(g).to(cuda))
    want = knn.nearest_neighbor_int8_plain(p, qb, sb, pack_idx=pack_idx)
    before = _knn_launches()
    got_q = knn.nearest_neighbor_int8q(p, qb, sb, pack_idx=pack_idx)
    got_p = knn.nearest_neighbor_int8p(p, *knn.pack_quantized_gallery(qb, sb),
                                       pack_idx=pack_idx)
    torch.cuda.synchronize()
    assert _knn_launches() == (before[0], before[1] + 1, before[2] + 1)
    for got in (got_q, got_p):
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("pack_idx", [False, True])
def test_knn_int8_kernel_ties_and_valid_n_on_card(cuda, pack_idx):
    rng = np.random.RandomState(4)
    base = _unit_rows(rng, 50, 64)
    g = _t(np.concatenate([base] * 5)).to(cuda)   # every row five times
    p = _t(base[::7] + 0.01 * rng.randn(8, 64).astype(np.float32)).to(cuda)
    qb, sb = knn.quantize_embeddings(g)
    for valid_n in (None, 120, 3):
        got = knn.nearest_neighbor_int8q(p, qb, sb, valid_n=valid_n,
                                         pack_idx=pack_idx)
        want = knn.nearest_neighbor_int8_plain(p, qb, sb, valid_n=valid_n,
                                               pack_idx=pack_idx)
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    np.testing.assert_array_equal(
        knn.nearest_neighbor_int8q(p, qb, sb, pack_idx=pack_idx)[1].cpu().numpy(),
        np.arange(0, 50, 7))


@pytest.mark.cuda
def test_knn_int8_tile_on_card(cuda):
    """The int8 block tile from the kernel's shared memory: 128 probes (two
    wgmma warpgroups) at every M, resident and two blocks an SM at D = 512
    (a 5-stage ring), resident and one at D = 1024 and 1408, streamed past
    it (two blocks an SM at D = 4096); either tile on request where it
    fits; rows of part 16-byte words refused (the wrapper pads them)."""
    idx = torch.cuda.current_device()
    assert knn.int8_tile(1, 64, idx) == (128, 2, False)
    assert knn.int8_tile(16, 512, idx) == (128, 2, False)
    assert knn.int8_tile(8192, 512, idx) == (128, 2, False)
    assert knn.int8_tile(8192, 512, idx, 1) == (128, 2, True)
    assert knn.int8_tile(2048, 1024, idx) == (128, 1, False)
    assert knn.int8_tile(2048, 1408, idx) == (128, 1, False)
    assert knn.int8_tile(2048, 1424, idx) == (128, 2, True)
    assert knn.int8_tile(8192, 4096, idx) == (128, 2, True)
    with pytest.raises(ValueError):
        knn.int8_tile(8192, 4096, idx, 0)      # 512 KB: no resident tile
    with pytest.raises(ValueError):
        knn.int8_tile(8192, 1000, idx)         # part 16-byte words


@pytest.mark.cuda
def test_knn_sweep_config_falls_back_to_the_small_tile(cuda):
    """The small tile is a fallback no more, nor a tile at all: serving
    queries take the 128-probe tile too, and past D = 1408 the resident
    probe tile no longer fits and streams, 128 probes and two blocks an SM
    at every width. No width is too wide; only a row of part 16-byte words
    is refused."""
    idx = torch.cuda.current_device()
    assert knn.int8_tile(4096, 2048, idx) == (128, 2, True)
    assert knn.int8_tile(4096, 16384, idx) == (128, 2, True)
    assert knn.int8_tile(4096, 1008, idx) == (128, 1, False)
    assert knn.int8_tile(16, 4096, idx) == (128, 2, True)
    assert knn.int8_tile(16, 16384, idx) == (128, 2, True)
    sms = knn._sms(cuda)
    assert knn.sweep_config(16, 1 << 20, sms, 128, 2).splits >= 2 * sms
    with pytest.raises(ValueError):
        knn.int8_tile(4096, 6, idx)


# (M, D) of the int8 sweep: past the 16-probe serving size, ragged against
# the 128-probe tile; narrow, the design point's width (resident probe
# tile) and vggface_vgg16's (streamed); then serving queries of 1 and 16
# probes
KNN_WGMMA_SHAPES = [(m, d) for m in (17, 300, 1000) for d in (64, 512, 4096)] + [
    (1, 512), (16, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("pack_idx", [False, True])
@pytest.mark.parametrize("m,d", KNN_WGMMA_SHAPES)
def test_knn_int8_wgmma_route_equals_plain_on_card(cuda, m, d, pack_idx):
    """K2b/K2c on wgmma fed by TMA, bit-equal to the twin: ties, valid_n
    inside and at the 128-row tile edges, both epilogues; the resident and
    the streamed probe tile where both fit; a gallery whose base is off 16
    bytes (the wrapper copies it) and one of rows 4 bytes short of whole
    16-byte words (the wrapper pads them)."""
    rng = np.random.RandomState(m * 7 + d)
    n = 3001
    g = _unit_rows(rng, n, d)
    g[n // 2:n // 2 + 3] = g[1:4]              # exact ties with lower rows
    p = _t(_unit_rows(rng, m, d)).to(cuda)
    qb, sb = knn.quantize_embeddings(_t(g).to(cuda))
    packed = knn.pack_quantized_gallery(qb, sb)
    assert packed.q.shape[1] == d and packed.q.data_ptr() % 16 == 0
    for valid_n in (None, 2000, 129, 128):
        want = knn.nearest_neighbor_int8_plain(p, qb, sb, valid_n=valid_n, pack_idx=pack_idx)
        got = knn.nearest_neighbor_int8q(p, qb, sb, valid_n=valid_n, pack_idx=pack_idx)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    want = knn.nearest_neighbor_int8_plain(p, qb, sb, pack_idx=pack_idx)
    ops = knn._int8_operands(p, packed.b2i, sb, None, pack_idx)
    tiles = [-1] + ([0, 1] if d <= 1408 else [])
    for stream in tiles:
        emin, idx = knn._rank_int8_cuda(ops.qa, packed.q, ops.b2v, pack_idx,
                                        stream=stream)
        got = knn._int8_distances(ops, emin, pack_idx)
        np.testing.assert_array_equal(idx.cpu().numpy(), want[1].cpu().numpy())
        np.testing.assert_array_equal(got.cpu().numpy(), want[0].cpu().numpy())
    off = torch.empty(n * d + 4, dtype=torch.int8, device=cuda)[4:].view(n, d)
    off.copy_(qb)
    got = knn.nearest_neighbor_int8q(p, off, sb, pack_idx=pack_idx)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    short = d - 4
    want = knn.nearest_neighbor_int8_plain(p[:, :short], qb[:, :short].contiguous(), sb,
                                           pack_idx=pack_idx)
    got = knn.nearest_neighbor_int8q(p[:, :short], qb[:, :short].contiguous(), sb,
                                     pack_idx=pack_idx)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(5, 5000, 100), (129, 3001, 1000),
                                   (129, 3001, 2000)])
def test_knn_int8q_norms_in_sweep_under_valid_n_on_card(cuda, m, n, d):
    """K2b's two-pass sweep forms b2v from the rows' squares itself (rows
    padded to whole 16-byte words at D 100 and 1000, the probe tile
    streamed at 2000): one launch, bit-equal to the twin with valid_n
    inside, at and past the 128-row tile edges."""
    rng = np.random.RandomState(n + d)
    g = _t(_unit_rows(rng, n, d)).to(cuda)
    p = _t(_unit_rows(rng, m, d)).to(cuda)
    qb, sb = knn.quantize_embeddings(g)
    for valid_n in (None, n - 1, 129, 128, 127, 1, 0):
        before = _knn_launches()
        got = knn.nearest_neighbor_int8q(p, qb, sb, valid_n=valid_n)
        want = knn.nearest_neighbor_int8_plain(p, qb, sb, valid_n=valid_n)
        torch.cuda.synchronize()
        assert _knn_launches() == (before[0], before[1] + 1, before[2])
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
        if valid_n:
            assert int(got[1].max()) < valid_n


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n,d", KNN_CARD_SHAPES + [(1100, 100_000, 512)])
def test_knn_f32_kernel_matches_plain_on_card(cuda, m, n, d, bf16):
    rng = np.random.RandomState(m * n + d)
    p = _t(rng.randn(m, d).astype(np.float32)).to(cuda)
    g = _t(rng.randn(n, d).astype(np.float32)).to(cuda)
    before = knn.nearest_neighbor_f32.launches
    gd, gi = knn.nearest_neighbor_f32(p, g, bf16=bf16)
    wd, wi = knn.nearest_neighbor_plain(p, g, bf16=bf16)
    torch.cuda.synchronize()
    assert knn.nearest_neighbor_f32.launches == before + 1
    np.testing.assert_allclose(gd.cpu().numpy(), wd.cpu().numpy(), rtol=1e-4,
                               atol=1e-3)
    # the index may differ only where the twin's top two are within tolerance
    a = p.float().to(torch.bfloat16).float() if bf16 else p
    b = g.float().to(torch.bfloat16).float() if bf16 else g
    d2 = (p * p).sum(1)[:, None] + (g * g).sum(1)[None, :] - 2.0 * (a @ b.T)
    top2 = torch.topk(d2, min(2, n), dim=1, largest=False).values
    clear = (top2[:, -1] - top2[:, 0]) > 1e-3 + 1e-4 * top2[:, 0].abs()
    if n == 1:
        clear[:] = True
    mask = clear.cpu().numpy()
    np.testing.assert_array_equal(gi.cpu().numpy()[mask], wi.cpu().numpy()[mask])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [30, 512])
@pytest.mark.parametrize("m", [1, 37, 300])
def test_knn_bf16_kernel_matches_twin_on_card(cuda, m, d):
    """K2a's bf16 sweep (the tensor-core mainloop on bf16 rows) against its
    twin at ragged shapes: one launch, distances within rtol 1e-4 and atol
    1e-3 (the bf16 products are exact in f32, only the sum's order
    differs), the index equal wherever the twin's top two are further
    apart than that."""
    rng = np.random.RandomState(m + d)
    n = 4999
    p = _t(_unit_rows(rng, m, d)).to(cuda)
    g = _t(_unit_rows(rng, n, d)).to(cuda)
    g[n // 2:n // 2 + 3] = g[1:4]                 # exact ties with lower rows
    before = knn.nearest_neighbor_f32.launches
    gd, gi = knn.nearest_neighbor_f32(p, g, bf16=True)
    wd, wi = knn.nearest_neighbor_plain(p, g, bf16=True)
    torch.cuda.synchronize()
    assert knn.nearest_neighbor_f32.launches == before + 1
    np.testing.assert_allclose(gd.cpu().numpy(), wd.cpu().numpy(), rtol=1e-4, atol=1e-3)
    a, b = p.to(torch.bfloat16).float(), g.to(torch.bfloat16).float()
    d2 = (p * p).sum(1)[:, None] + (g * g).sum(1)[None, :] - 2.0 * (a @ b.T)
    top2 = torch.topk(d2, 2, dim=1, largest=False).values
    clear = ((top2[:, 1] - top2[:, 0]) > 1e-3 + 1e-4 * top2[:, 0].abs()).cpu().numpy()
    np.testing.assert_array_equal(gi.cpu().numpy()[clear], wi.cpu().numpy()[clear])


def _pw_operands(rng, m, k, n, device="cpu"):
    a = rng.randint(0, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (n, k)).astype(np.int8)
    # |acc| spreads about 2700·sqrt(k): outputs cover [0, 6] and clip at both ends
    scale = (rng.uniform(0.5, 1.5, n) * 3.0 / (2700.0 * np.sqrt(k))).astype(np.float32)
    bias = (rng.rand(n) * 4.0 - 1.0).astype(np.float32)
    return [_t(x).to(device) for x in (a, w, scale, bias)]


def test_pw_conv_wrapper_cpu_takes_plain_path(rng):
    ops = _pw_operands(rng, 70, 36, 20)
    before = pw_conv.pw_conv_int8.launches
    for requant in (True, False):
        got = pw_conv.pw_conv_int8(*ops, requant=requant)
        want = pw_conv.pw_conv_int8_plain(*ops, requant=requant)
        assert got.dtype == (torch.int8 if requant else torch.float32)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert pw_conv.pw_conv_int8.launches == before


def test_pw_conv_wrapper_rejects_other_devices(rng):
    a, w, scale, bias = _pw_operands(rng, 8, 16, 4)
    with pytest.raises(ValueError):
        pw_conv.pw_conv_int8(a.to("meta"), w.to("meta"), scale.to("meta"),
                             bias.to("meta"))
    with pytest.raises(ValueError):
        pw_conv.pw_conv_int8(a, w.to("meta"), scale, bias)


# (M, K, N): pw1 at one 112² image; pw13 at a 7² image ragged against the
# 128-row tile, f32 out; K and N off whole words; then M from one row to
# many tiles a block, K off whole 16-byte words (30, 52: zero-padded to 32
# and 64) and on them (1024), and N off and on whole 16-byte stores
PW_CARD_SHAPES = [(12544, 32, 64), (49, 1024, 1024), (1000, 30, 50)] + [
    (m, k, n) for m in (1, 17, 784, 200704) for k in (30, 52, 1024)
    for n in (50, 64, 1024)]
# the 13 pointwise layers of MobileNet-V1 at 224², (M at a head batch of
# 16 faces, K, N); then ragged M and N (K % 16 == 0):
# one row, M off the 128-row tile, N off the 64-channel tile and off whole
# 16-byte stores, N above 256 off every tile width; K 16 and 32 packed 4
# and 2 pixels a row, and K 32 at an odd M (not packed)
PW_LAYER_SHAPES = [(12544 * 16, 32, 64), (3136 * 16, 64, 128), (3136 * 16, 128, 128),
                   (784 * 16, 128, 256), (784 * 16, 256, 256), (196 * 16, 256, 512),
                   (196 * 16, 512, 512), (49 * 16, 512, 1024), (49 * 16, 1024, 1024)]
PW_WGMMA_RAGGED = [(1, 64, 64), (1000, 64, 50), (129, 512, 1000), (777, 96, 200),
                   (300, 1024, 72), (5000, 16, 8), (777, 32, 64), (1002, 32, 50)]


@pytest.mark.cuda
@pytest.mark.parametrize("requant", [True, False])
@pytest.mark.parametrize("m,k,n", PW_CARD_SHAPES)
def test_pw_conv_kernel_equals_plain_on_card(cuda, m, k, n, requant):
    ops = _pw_operands(np.random.RandomState(m + k + n), m, k, n, cuda)
    before = pw_conv.pw_conv_int8.launches
    got = pw_conv.pw_conv_int8(*ops, requant=requant)
    want = pw_conv.pw_conv_int8_plain(*ops, requant=requant)
    torch.cuda.synchronize()
    assert pw_conv.pw_conv_int8.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if requant:
        assert 0 < int(got.to(torch.int32).sum()) and int(got.max()) <= 127


@pytest.mark.cuda
@pytest.mark.parametrize("requant", [True, False])
@pytest.mark.parametrize("m,k,n", PW_LAYER_SHAPES + PW_WGMMA_RAGGED)
def test_pw_conv_wgmma_route_equals_plain_on_card(cuda, m, k, n, requant):
    """K4 on wgmma fed by TMA (persistent blocks, every tile the plan gives
    these shapes), bit-equal to the plain version, int8 and f32 out. An
    activation or a weight off 16 bytes is copied first and equal too."""
    ops = _pw_operands(np.random.RandomState(m + 3 * k + n), m, k, n, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pw_conv.plan(m, n, k, sms).grid <= sms
    before = pw_conv.pw_conv_int8.launches
    got = pw_conv.pw_conv_int8(*ops, requant=requant)
    want = pw_conv.pw_conv_int8_plain(*ops, requant=requant)
    torch.cuda.synchronize()
    assert pw_conv.pw_conv_int8.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if m > 1:
        # the same product from an activation 8 bytes off 16, then a weight 4 off
        a_off = torch.empty(m * k + 8, dtype=torch.int8, device=cuda)[8:].view(m, k)
        a_off.copy_(ops[0])
        got = pw_conv.pw_conv_int8(a_off, *ops[1:], requant=requant)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        w_off = torch.empty(n * k + 4, dtype=torch.int8, device=cuda)[4:].view(n, k)
        w_off.copy_(ops[1])
        got = pw_conv.pw_conv_int8(ops[0], w_off, *ops[2:], requant=requant)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("requant", [True, False])
@pytest.mark.parametrize("tile", sorted(pw_conv.TILES))
@pytest.mark.parametrize("m,k,n", [(777, 96, 200), (3000, 1024, 300)])
def test_pw_conv_wgmma_every_tile_on_card(cuda, m, k, n, tile, requant):
    """Each tile K4 has (128 x 64, 128 x 128, 256 x 128), forced,
    bit-equal to the plain version at ragged M and N, int8 and f32 out: the
    persistent blocks walk several tiles each."""
    ops = _pw_operands(np.random.RandomState(m + k + n + tile[1]), m, k, n, cuda)
    got = pw_conv.launch(*ops, requant=requant, tile=tile)
    want = pw_conv.pw_conv_int8_plain(*ops, requant=requant)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_pw_conv_kernel_rejects_bad_operands_on_card(cuda, rng):
    a, w, scale, bias = _pw_operands(rng, 64, 32, 16, cuda)
    with pytest.raises(TypeError):
        pw_conv.pw_conv_int8(a.float(), w, scale, bias)
    with pytest.raises(ValueError):
        pw_conv.pw_conv_int8(a[:, ::2], w[:, :16], scale, bias)
    with pytest.raises(ValueError):
        pw_conv.pw_conv_int8(a, w, scale, bias.cpu())


def test_warp_wrapper_cpu_takes_plain_path(rng):
    imgs = _t(rng.rand(3, 20, 24, 3).astype(np.float32))
    mats = sample_affine(torch.Generator().manual_seed(0), AugmentConfig(), 3, 20, 24)
    before = warp.warp_batch.launches
    got = warp.warp_batch(imgs, mats, 0.5)
    np.testing.assert_array_equal(got.numpy(), warp.warp_batch_plain(imgs, mats, 0.5).numpy())
    assert warp.warp_batch.launches == before


def test_warp_wrapper_rejects_other_devices(rng):
    imgs = torch.zeros((2, 8, 8, 3))
    mats = torch.zeros((2, 2, 3))
    with pytest.raises(ValueError):
        warp.warp_batch(imgs.to("meta"), mats.to("meta"))
    with pytest.raises(ValueError):
        warp.warp_batch(imgs, mats.to("meta"))


# (N, H, W, C, config): the training shape at batch 16, and a ragged one
# with large shifts (the zero-IA region); W·C off whole 16-byte words, C = 1
# and 4, H = 1, and a row of 4000 pixels (48 KB of pass-A values in shared
# memory)
WARP_CARD_SHAPES = [(16, 224, 224, 3, AugmentConfig()),
                    (5, 50, 62, 3, AugmentConfig(shift=0.5, rotation_deg=30)),
                    (5, 50, 61, 3, AugmentConfig(shift=0.5, rotation_deg=30)),
                    (4, 40, 48, 1, AugmentConfig()), (4, 40, 48, 4, AugmentConfig()),
                    (3, 1, 64, 3, AugmentConfig()), (1, 8, 4000, 3, AugmentConfig())]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,cfg", WARP_CARD_SHAPES)
def test_warp_kernel_matches_plain_on_card(cuda, n, h, w, c, cfg):
    gen = torch.Generator(device=cuda).manual_seed(n + h + w)
    imgs = torch.rand((n, h, w, c), generator=gen, device=cuda)
    mats = sample_affine(gen, cfg, n, h, w)
    before = warp.warp_batch.launches
    got = warp.warp_batch(imgs, mats, 0.25)
    want = warp.warp_batch_plain(imgs, mats, 0.25)
    torch.cuda.synchronize()
    assert warp.warp_batch.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-6
    assert bool(((got == 0.25).all(-1)).any())         # the fill appears
