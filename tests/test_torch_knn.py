"""Parity of the port's 1-NN (``hse_facerec_torch/ops/kernels/knn.py``) with
the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX functions (the Pallas
kernels in interpret mode, as ``tests/test_pallas_knn.py`` runs them) and
through the port's wrappers, which take their plain twins on CPU tensors.

Tolerances:
- int8 (K2b/K2c) against the interpret-mode kernels: index and distance
  bit-equal, both epilogues. The port computes the host-side scales, norms
  and packed offset as the jitted reference does (reciprocal of 127, the
  FMAs XLA fuses), so every key is the same f32.
- int8 against ``nearest_neighbor_int8_xla``: index equal, distance
  ``rtol=1e-6`` (that program fuses ``b2`` into the ranking expression, one
  rounding fewer than the kernel).
- f32 (K2a) against ``nearest_neighbor_tpu(bf16=False)``: index equal,
  distance ``rtol=1e-4, atol=1e-3``, the reference test's own tolerance
  (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.ops.pallas import knn as jk
from hse_facerec_tf_tpu.pipelines.gallery import _quantize_host
from hse_facerec_torch.ops.kernels import knn as tk

_TILES = dict(tile_m=8, tile_n=128, splits=1)   # small interpret-mode grid


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_bit_equal(got, want):
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("path", ["jit", "eager", "numpy"])
def test_quantize_embeddings_three_call_paths(path):
    """q and scale bit for bit against each way the reference quantizes:
    inside jit (probes; XLA multiplies by the reciprocal of 127), eagerly
    (``KNNIdentifier.fit``) and in numpy (``gallery._quantize_host``). The
    seeds cover cases where the two roundings of max/127 differ."""
    rng = np.random.RandomState(7)
    n_diff = 0
    for _ in range(60):
        x = rng.randn(64, 32).astype(np.float32) * rng.uniform(0.01, 10)
        m = np.max(np.abs(x))
        n_diff += (m * (np.float32(1) / np.float32(127))) != (m / np.float32(127))
        if path == "jit":
            q, s = jax.jit(jk.quantize_embeddings)(x)
        elif path == "eager":
            q, s = jk.quantize_embeddings(jnp.asarray(x))
        else:
            q, s = _quantize_host(x)
        tq, ts = tk.quantize_embeddings(_t(x), reciprocal=path == "jit")
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        assert tq.dtype == torch.int8
        assert np.float32(ts.item()) == np.float32(s)
    assert n_diff > 0     # the sample does tell the two roundings apart


@pytest.mark.parametrize("pack_idx", [False, True])
@pytest.mark.parametrize("m,n,d", [(1, 5, 16), (13, 300, 30), (37, 700, 64),
                                   (9, 300, 4096), (23, 400, 100)])
def test_int8q_twin_matches_interpret_kernel(m, n, d, pack_idx):
    rng = np.random.RandomState(m * 1000 + n)
    p, g = _unit_rows(rng, m, d), _unit_rows(rng, n, d)
    qb, sb = jk.quantize_embeddings(jnp.asarray(g))
    want = jk.nearest_neighbor_tpu_int8q(jnp.asarray(p), qb, sb, interpret=True,
                                         pack_idx=pack_idx, **_TILES)
    got = tk.nearest_neighbor_int8q(_t(p), _t(qb), _t(sb), pack_idx=pack_idx)
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("pack_idx", [False, True])
@pytest.mark.parametrize("m,n,d", [(21, 333, 30), (9, 300, 4096), (21, 333, 100)])
def test_int8p_twin_matches_interpret_kernel(pack_idx, m, n, d):
    rng = np.random.RandomState(11)
    p, g = _unit_rows(rng, m, d), _unit_rows(rng, n, d)
    qb, sb = jk.quantize_embeddings(jnp.asarray(g))
    packed = jk.pack_quantized_gallery(qb, sb, tile_n=128)
    want = jk.nearest_neighbor_tpu_int8p(jnp.asarray(p), *packed, interpret=True,
                                         pack_idx=pack_idx, **_TILES)
    mine = tk.pack_quantized_gallery(_t(qb), _t(sb))
    assert mine.q.shape == (n, -(-d // 16) * 16) and mine.b2i.shape == (n,)
    got = tk.nearest_neighbor_int8p(_t(p), *mine, pack_idx=pack_idx)
    _assert_bit_equal(got, want)
    # K2c and K2b agree on the same gallery
    _assert_bit_equal(got, tk.nearest_neighbor_int8q(_t(p), _t(qb), _t(sb),
                                                     pack_idx=pack_idx))


@pytest.mark.parametrize("pack_idx", [False, True])
@pytest.mark.parametrize("valid_n", [1, 150, 299, 400])
def test_int8q_valid_n(valid_n, pack_idx):
    rng = np.random.RandomState(valid_n)
    p, g = _unit_rows(rng, 9, 32), _unit_rows(rng, 300, 32)
    qb, sb = jk.quantize_embeddings(jnp.asarray(g))
    want = jk.nearest_neighbor_tpu_int8q(jnp.asarray(p), qb, sb, interpret=True,
                                         pack_idx=pack_idx, valid_n=valid_n,
                                         **_TILES)
    got = tk.nearest_neighbor_int8q(_t(p), _t(qb), _t(sb), pack_idx=pack_idx,
                                    valid_n=valid_n)
    _assert_bit_equal(got, want)
    assert int(got[1].max()) < min(valid_n, 300)


@pytest.mark.parametrize("valid_n", [None, 40])
def test_int8_plain_matches_xla_twin(valid_n):
    rng = np.random.RandomState(5)
    p, g = _unit_rows(rng, 50, 64), _unit_rows(rng, 120, 64)
    qb, sb = jk.quantize_embeddings(jnp.asarray(g))
    wd, wi = jk.nearest_neighbor_int8_xla(jnp.asarray(p), qb, sb, valid_n=valid_n)
    gd, gi = tk.nearest_neighbor_int8_plain(_t(p), _t(qb), _t(sb), valid_n=valid_n)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)


@pytest.mark.parametrize("pack_idx", [False, True])
def test_int8_ties_resolve_to_lowest_index(pack_idx):
    """Duplicated gallery rows tie exactly; the first copy wins, across
    the reference's tile boundary (tile_n=16) too."""
    rng = np.random.RandomState(3)
    base = _unit_rows(rng, 10, 32)
    g = np.concatenate([base, base, base[::-1]])     # 30 rows, 3 copies each
    p = base[[2, 7, 0]] + 0.01 * rng.randn(3, 32).astype(np.float32)
    qb, sb = jk.quantize_embeddings(jnp.asarray(g))
    want = jk.nearest_neighbor_tpu_int8q(jnp.asarray(p), qb, sb, interpret=True,
                                         pack_idx=pack_idx, tile_m=8,
                                         tile_n=16, splits=2)
    got = tk.nearest_neighbor_int8q(_t(p), _t(qb), _t(sb), pack_idx=pack_idx)
    _assert_bit_equal(got, want)
    np.testing.assert_array_equal(got[1].numpy(), [2, 7, 0])


@pytest.mark.parametrize("m,n,d", [(70, 1500, 128), (300, 1025, 64)])
def test_f32_twin_matches_interpret_kernel(m, n, d):
    rng = np.random.RandomState(n)
    p = rng.randn(m, d).astype(np.float32)
    g = rng.randn(n, d).astype(np.float32)
    wd, wi = jk.nearest_neighbor_tpu(jnp.asarray(p), jnp.asarray(g), bf16=False,
                                     interpret=True, tile_m=64, tile_n=256)
    gd, gi = tk.nearest_neighbor_f32(_t(p), _t(g), bf16=False)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("d", [30, 64, 512])
def test_f32_bf16_twin_rounds_operands_only(d):
    """bf16 twin = f32 math on bf16-rounded operands with f32 norms and an
    f32 sum, as the reference's bf16 kernel (interpret) computes it; at
    widths off the bf16 sweep's 8-value words (30), on them (64) and at
    the benchmark's (512)."""
    rng = np.random.RandomState(8)
    p = rng.randn(40, d).astype(np.float32)
    g = rng.randn(500, d).astype(np.float32)
    wd, wi = jk.nearest_neighbor_tpu(jnp.asarray(p), jnp.asarray(g), bf16=True,
                                     interpret=True, tile_m=64, tile_n=256)
    gd, gi = tk.nearest_neighbor_f32(_t(p), _t(g))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-4, atol=1e-3)


def test_k2a_bf16_route_matches_jax():
    rng = np.random.RandomState(4)
    p = rng.randn(64, 32).astype(np.float32)
    g = rng.randn(1000, 32).astype(np.float32)
    _, want = jk.nearest_neighbor_tpu(jnp.asarray(p), jnp.asarray(g), bf16=True,
                                      interpret=True)
    _, got = tk.nearest_neighbor_f32(torch.from_numpy(p), torch.from_numpy(g), bf16=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the chunked twin on bf16 operands ranks as the bf16 kernel does (JAX's
    # chunked XLA form keeps f32 operands off the TPU, so it is no oracle here)
    _, got_c = tk.nearest_neighbor_chunked(torch.from_numpy(p), torch.from_numpy(g),
                                           16, bf16=True)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want))


def test_chunked_matches_xla_chunked():
    rng = np.random.RandomState(9)
    p = rng.randn(700, 64).astype(np.float32)
    g = rng.randn(2000, 64).astype(np.float32)
    wd, wi = jk.nearest_neighbor_chunked_xla(jnp.asarray(p), jnp.asarray(g),
                                             chunk=512, bf16=False)
    gd, gi = tk.nearest_neighbor_chunked(_t(p), _t(g), chunk=512, bf16=False)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("int8", [False, True])
def test_auto_on_cpu_matches_reference_auto(int8):
    """``nearest_neighbor_auto`` on CPU tensors: the reference's off-TPU
    answers (matmul + argmin for f32, the exact two-pass int8 twin), with
    an f32 gallery or a pre-quantized pair, and no kernel launch."""
    rng = np.random.RandomState(12)
    p, g = _unit_rows(rng, 10, 32), _unit_rows(rng, 50, 32)
    before = (tk.nearest_neighbor_f32.launches, tk.nearest_neighbor_int8q.launches)
    wd, wi = jk.nearest_neighbor_auto(jnp.asarray(p), jnp.asarray(g), int8=int8)
    gd, gi = tk.nearest_neighbor_auto(_t(p), _t(g), int8=int8)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-6)
    if int8:
        qb, sb = tk.quantize_embeddings(_t(g))
        hd, hi = tk.nearest_neighbor_auto(_t(p), (qb, sb), int8=True)
        _assert_bit_equal((hd, hi), (gd, gi))
    else:
        with pytest.raises(ValueError):
            tk.nearest_neighbor_auto(_t(p), _t(g), valid_n=3)
    assert (tk.nearest_neighbor_f32.launches,
            tk.nearest_neighbor_int8q.launches) == before


def test_auto_kernel_route_ranks_exact_f32(monkeypatch):
    """Where the routing rule picks K2a, it runs on f32 operands: the
    answer is the matmul route's, so an exact identifier keeps its
    precision whatever the gallery's size."""
    rng = np.random.RandomState(13)
    p = rng.randn(20, 64).astype(np.float32)
    g = rng.randn(400, 64).astype(np.float32)
    wd, wi = tk.nearest_neighbor_auto(_t(p), _t(g))          # matmul + argmin
    calls, f32 = [], tk.nearest_neighbor_f32

    def recording(probes, gallery, bf16=True):
        calls.append(bf16)
        return f32(probes, gallery, bf16)

    monkeypatch.setattr(tk, "use_kernel_path", lambda *a, **kw: True)
    monkeypatch.setattr(tk, "nearest_neighbor_f32", recording)
    gd, gi = tk.nearest_neighbor_auto(_t(p), _t(g))
    assert calls == [False]
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    np.testing.assert_allclose(gd.numpy(), wd.numpy(), rtol=1e-5, atol=1e-4)


def test_int8_wrappers_and_twin_share_the_default_epilogue():
    """K2b, K2c and their twin default to the two-pass epilogue, so a call
    at the defaults compares like with like."""
    rng = np.random.RandomState(14)
    p, g = _unit_rows(rng, 11, 30), _unit_rows(rng, 90, 30)
    qb, sb = tk.quantize_embeddings(_t(g))
    want = tk.nearest_neighbor_int8_plain(_t(p), qb, sb)
    _assert_bit_equal(want, tk.nearest_neighbor_int8_plain(_t(p), qb, sb,
                                                           pack_idx=False))
    _assert_bit_equal(tk.nearest_neighbor_int8q(_t(p), qb, sb), want)
    _assert_bit_equal(tk.nearest_neighbor_int8p(
        _t(p), *tk.pack_quantized_gallery(qb, sb)), want)


def test_use_kernel_path_routing_rule():
    assert not tk.use_kernel_path(10, 10, "cpu", force=True)
    assert not tk.use_kernel_path(8192, 1 << 20, "cpu")
    assert tk.use_kernel_path(10, 10, "cuda", force=True)
    assert not tk.use_kernel_path(1024, 204800, "cuda")          # 0.8 GB
    assert tk.use_kernel_path(8192, 1 << 20, "cuda")             # 32 GB
    assert tk.use_kernel_path(100, 100, "cuda", hbm_limit_bytes=1000)
