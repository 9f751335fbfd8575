"""The warp kernel K3's plain version and the port's augmentation against
the JAX package, on the CPU.

- ``warp_batch_plain`` against the Pallas kernel ``warp_batch_pallas`` in
  interpret mode (jitted, so XLA fuses its multiply-adds as it does on the
  TPU): bit-equal, with both flip branches, the fill and, at large shifts,
  the region where pass A's every weight is 0;
- the plain version against the einsum two-pass ``_warp_one`` within 0.02,
  the JAX package's own bound between the two (``test_train.py``);
- the port's affine closed form, fed the uniforms the reference draws from
  its keys, against ``_sample_affine``: the linear part within 1e-6, the
  translation within 1e-6 of the size of its terms (``c - a·(cx + tx) -
  b·(cy + ty)`` cancels terms of up to about 60 here, so the one-ulp
  difference of the two packages' sin and cos shows as a few 1e-6);
- an identity config warps to the bf16-rounded input, exactly: K3 reads
  the image through bf16, as the TPU kernel does;
- ``augment_batch`` on a CPU batch runs the plain version, seeded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.ops.pallas.warp import warp_batch_pallas
from hse_facerec_tf_tpu.train import augment as ja
from hse_facerec_torch.ops.kernels import warp
from hse_facerec_torch.train import augment as ta

# (N, H, W, config, seed): the JAX test's shift 0.2 (both flips, fill), and
# shift 0.5 with rotation 30° (pass A's zero region)
CASES = [(8, 64, 64, ja.AugmentConfig(shift=0.2), 0),
         (4, 48, 56, ja.AugmentConfig(shift=0.5, rotation_deg=30), 1),
         (8, 64, 64, ja.AugmentConfig(shift=0.5, rotation_deg=30), 5)]


def _jax_mats(cfg, n, h, w, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np.asarray(jax.vmap(lambda k: ja._sample_affine(k, cfg, h, w))(keys))


def _images(seed, n, h, w):
    # in (0.01, 1.01]: no pixel is 0, so a 0 of pass A is its zero region
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32) + 0.01


@pytest.mark.parametrize("n,h,w,cfg,seed", CASES)
def test_plain_warp_equals_interpret_pallas(n, h, w, cfg, seed):
    imgs, mats = _images(seed, n, h, w), _jax_mats(cfg, n, h, w, seed)
    flips = mats[:, 0, 0] < 0
    assert flips.any() and (~flips).any()       # both branches exercised
    want = np.asarray(warp_batch_pallas(jnp.asarray(imgs), jnp.asarray(mats),
                                        cfg.fill_value, interpret=True))
    got = warp.warp_batch_plain(torch.from_numpy(imgs), torch.from_numpy(mats.copy()),
                                cfg.fill_value).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == cfg.fill_value).all(-1).any()     # the fill appears
    if cfg.shift == 0.5:
        scal = warp.warp_scalars(torch.from_numpy(mats.copy()), w, cfg.fill_value)
        ia = warp.vertical_pass(torch.from_numpy(imgs), scal)
        assert bool((ia == 0).all(-1).any())          # every weight 0, not the edge


@pytest.mark.parametrize("n,h,w,cfg,seed", CASES)
def test_plain_warp_near_einsum_two_pass(n, h, w, cfg, seed):
    imgs, mats = _images(seed, n, h, w), _jax_mats(cfg, n, h, w, seed)
    want = np.asarray(jax.vmap(lambda im, m: ja._warp_one(im, m, cfg.fill_value))(
        jnp.asarray(imgs), jnp.asarray(mats)))
    got = warp.warp_batch_plain(torch.from_numpy(imgs), torch.from_numpy(mats.copy()),
                                cfg.fill_value).numpy()
    assert np.abs(got - want).max() < 0.02


@pytest.mark.parametrize("cfg", [ja.AugmentConfig(), ja.AugmentConfig(shift=0.5, rotation_deg=30),
                                 ja.AugmentConfig(horizontal_flip=False, zoom=0.0)])
def test_affine_closed_form_matches_sample_affine(cfg):
    n, h, w = 16, 48, 56
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    u = np.stack([[float(jax.random.uniform(k7, ())) for k7 in jax.random.split(k, 7)]
                  for k in keys]).astype(np.float32)
    want = _jax_mats(cfg, n, h, w, 7)
    tcfg = ta.AugmentConfig(**{f: getattr(cfg, f) for f in
                               ("rotation_deg", "shear", "zoom", "shift",
                                "horizontal_flip", "fill_value")})
    got = ta.affine_from_uniforms(torch.from_numpy(u), tcfg, h, w).numpy()
    assert got.dtype == np.float32 and got.shape == (n, 2, 3)
    np.testing.assert_allclose(got[:, :, :2], want[:, :, :2], rtol=1e-6, atol=1e-6)
    # translation: c - a·(cx + tx) - b·(cy + ty), against its terms' size
    tx = (u[:, 4] * 2 - 1) * cfg.shift * w
    ty = (u[:, 5] * 2 - 1) * cfg.shift * h
    centre = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    terms = (np.abs(want[:, :, 0]) * np.abs(centre[0] + tx)[:, None]
             + np.abs(want[:, :, 1]) * np.abs(centre[1] + ty)[:, None] + centre)
    assert (np.abs(got[:, :, 2] - want[:, :, 2]) <= 1e-6 * terms).all()
    assert (np.sign(got[:, 0, 0]) == np.sign(want[:, 0, 0])).all()


def test_identity_config_is_the_bf16_identity():
    imgs = torch.from_numpy(_images(3, 4, 32, 40))
    ident = ta.AugmentConfig(rotation_deg=0, shear=0, zoom=0, shift=0,
                             horizontal_flip=False)
    out = ta.augment_batch(torch.Generator().manual_seed(0), imgs, ident)
    np.testing.assert_array_equal(out.numpy(),
                                  imgs.to(torch.bfloat16).to(torch.float32).numpy())


def test_augment_batch_on_cpu_runs_the_plain_version_seeded():
    imgs = torch.from_numpy(_images(4, 4, 32, 32))
    before = warp.warp_batch.launches
    outs = [ta.augment_batch(torch.Generator().manual_seed(s), imgs) for s in (0, 0, 1)]
    assert warp.warp_batch.launches == before
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    assert not np.allclose(outs[0].numpy(), outs[2].numpy())
    assert not np.allclose(outs[0].numpy(), imgs.numpy())
    mats = ta.sample_affine(torch.Generator().manual_seed(0), ta.AugmentConfig(), 4, 32, 32)
    np.testing.assert_array_equal(outs[0].numpy(),
                                  warp.warp_batch_plain(imgs, mats).numpy())
