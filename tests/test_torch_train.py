"""The port's face-ID training slice against the JAX package, on the CPU:
the MobileNet-V1 training forward (batch-statistics BN), the loss and its
gradients, Adam, the BN running statistics, whole jitted train steps,
remat, checkpoints across the two packages, and the CLI ``train``.

The same numpy weights (the JAX package's ``init_mobilenet_params`` at
width 0.25, 5 classes, bridged with ``params.to_torch``) and the same
seeded inputs (48x48, batch 6) go through both packages, augmentation off.
Tolerances and their reasons:
- float32 forward: the two packages' convolutions round differently (2e-7
  relative after conv1) and each BN layer spreads that a little (about
  1.2x per layer; 4e-5 relative after 27 layers here), so logits and batch
  moments are held to 2e-4 relative L2 and the loss to 1e-5 relative;
- gradients and train steps in float64 (``jax.enable_x64`` for the JAX
  side): in float32 those 1e-5-scale differences flip the ReLU6 gradient
  mask of activations that lie within about 1e-5 of 0 or 6 (one such flip
  at pw8 here moves every gradient below it by about 1.5%), a difference of
  the data, not of the algorithm. In float64 no element lies that close, so
  gradients are held to 1e-6 relative L2 per tensor (the float32 head
  after the GAP bounds them). Adam divides each gradient element by its
  own RMS, so an element's relative error (large where its sum cancels)
  becomes an absolute error of its step, and later steps start from params
  that differ so: after 1 and 3 steps the params, Adam moments and BN
  statistics are held to 1e-4 relative L2 (up to 3e-5 seen after 3 steps).
  Params are compared where |g| is above 1e-4 of the tensor's largest
  gradient: below it a rounding of g may flip the sign of the first step,
  about ``lr·g/(|g| + 1e-8)``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hse_facerec_tf_tpu.config import TrainConfig as JaxTrainConfig
from hse_facerec_tf_tpu.models import mobilenet as jm
from hse_facerec_tf_tpu.train import checkpoints as jck
from hse_facerec_tf_tpu.train import face_id as jf
from hse_facerec_torch import cli
from hse_facerec_torch import params as P
from hse_facerec_torch.config import TrainConfig
from hse_facerec_torch.models import mobilenet as tm
from hse_facerec_torch.train import checkpoints as tck
from hse_facerec_torch.train import face_id as tf
from hse_facerec_torch.ops.kernels import warp

N_CLASSES, WIDTH, SIZE, BATCH = 5, 0.25, 48, 6
F32_REL, LOSS_REL, GRAD_REL, STEP_REL = 2e-4, 1e-5, 1e-6, 1e-4
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module")
def jax_params():
    p = jm.init_mobilenet_params(jax.random.PRNGKey(0), n_classes=N_CLASSES,
                                 width=WIDTH)
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32) * 2 - 1
    return x, rng.randint(0, N_CLASSES, BATCH)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port(params):
    """Port params from numpy, trainable tensors marked for autograd."""
    tp = P.to_torch(params, "cpu")
    for _, t in tf.trainable(tp):
        t.requires_grad_(True)
    return tp


def _trainer(n_classes, **kwargs):
    """A CPU ``FaceIdTrainer`` on width-0.25 params (the trainer makes
    width-1.0 ones)."""
    trainer = tf.FaceIdTrainer(n_classes=n_classes, device="cpu", **kwargs)
    trainer.params = tm.init_mobilenet_params(torch.Generator().manual_seed(1),
                                              n_classes=n_classes, width=WIDTH,
                                              device="cpu")
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    return trainer


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_to_numpy_inverts_to_torch(jax_params):
    back = _flat(P.to_numpy(P.to_torch(jax_params, "cpu")))
    want = _flat(jax_params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_bn_train_forward_matches_jax(jax_params, batch):
    x, _ = batch
    logits, stats = jax.jit(lambda p, x: jf.forward_train(
        p, x, compute_dtype=jnp.float32))(jax_params, x)
    with torch.no_grad():
        t_logits, t_stats = tf.forward_train(P.to_torch(jax_params, "cpu"),
                                             torch.from_numpy(x),
                                             compute_dtype=torch.float32)
    assert _rel(t_logits.numpy(), logits) < F32_REL
    assert t_stats.keys() == stats.keys() and len(stats) == 27
    for layer, s in stats.items():
        for key in ("mean", "var"):
            assert _rel(t_stats[layer][key].numpy(), s[key]) < F32_REL, (layer, key)
    # the variance is the biased one (over N, H, W), as jnp.var's
    var = np.asarray(stats["conv1"]["var"])
    assert np.all(var > 0)


def test_loss_matches_jax_float32(jax_params, batch):
    x, y = batch
    (loss, (_, acc)) = jax.jit(lambda p: jf.loss_fn(
        p, x, y, 4e-5, compute_dtype=jnp.float32))(jax_params)
    t_loss, (_, t_acc) = tf.loss_fn(P.to_torch(jax_params, "cpu"), torch.from_numpy(x),
                                    torch.from_numpy(y), 4e-5,
                                    compute_dtype=torch.float32)
    assert abs(float(t_loss) - float(loss)) <= LOSS_REL * abs(float(loss))
    assert float(t_acc) == float(acc)


@pytest.fixture(scope="module")
def jax_grads(jax_params, batch):
    """The JAX loss and gradients in float64 compute."""
    x, y = batch
    with jax.enable_x64(True):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jf.loss_fn(p, x, y, 4e-5, compute_dtype=jnp.float64),
            has_aux=True))(jax_params)
        return float(loss), jax.tree.map(np.asarray, grads)


def test_loss_gradients_match_jax(jax_params, batch, jax_grads):
    x, y = batch
    loss, grads = jax_grads
    tp = _port(jax_params)
    t_loss, _ = tf.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y), 4e-5,
                           compute_dtype=torch.float64)
    leaves = tf.trainable(tp)
    t_grads = torch.autograd.grad(t_loss, [t for _, t in leaves])
    assert abs(float(t_loss) - loss) <= LOSS_REL * abs(loss)
    got = _flat(P.to_numpy(tf._tree([p for p, _ in leaves], t_grads)))
    want = _flat(grads)
    assert set(got) == {k for k in want if not k.endswith(("/mean", "/var"))}
    assert len(got) == 29 + 2 * 27          # kernels, classifier bias, gamma/beta
    for k, g in got.items():
        assert g.dtype == np.float32
        assert _rel(g, want[k]) < GRAD_REL, (k, _rel(g, want[k]))


@pytest.fixture(scope="module")
def step_batches(batch):
    rng = np.random.RandomState(1)
    return [batch] + [(rng.rand(*batch[0].shape).astype(np.float32) * 2 - 1,
                       rng.randint(0, N_CLASSES, BATCH)) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_steps(jax_params, step_batches):
    """Three steps of the jitted JAX step in float64 compute: the params,
    the Adam state and the losses after the first and after the third."""
    cfg = JaxTrainConfig(learning_rate=3e-3, lr_decay=0.1)
    with jax.enable_x64(True):
        opt = jf.make_optimizer(cfg)
        step = jax.jit(jf.make_train_step(cfg, opt, augment=None,
                                          compute_dtype=jnp.float64))
        p, state, losses, after = jax_params, opt.init(jax_params), [], {}
        for n, (x, y) in enumerate(step_batches, start=1):
            p, state, m = step(p, state, jax.random.PRNGKey(0), x, y)
            losses.append(float(m["loss"]))
            after[n] = jax.tree.map(np.asarray, (p, state)) + (list(losses),)
        return after


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jitted_jax(jax_params, step_batches, jax_steps, jax_grads,
                                      n_steps):
    batches = step_batches[:n_steps]
    jp, jstate, jlosses = jax_steps[n_steps]
    _, grads = jax_grads

    cfg = TrainConfig(learning_rate=3e-3, lr_decay=0.1)
    opt = tf.make_optimizer(cfg)
    tp = P.to_torch(jax_params, "cpu")
    state = opt.init(tp)
    step = tf.make_train_step(cfg, opt, augment=None, compute_dtype=torch.float64)
    losses = [float(step(tp, state, None, torch.from_numpy(bx), torch.from_numpy(by))[2]["loss"])
              for bx, by in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_REL)
    assert state["count"] == n_steps == int(jstate[0].count)

    got, want, g = _flat(P.to_numpy(tp)), _flat(jp), _flat(grads)
    init = _flat(jax_params)
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith(("/mean", "/var")):           # BN running statistics
            assert _rel(got[k], want[k]) < STEP_REL, k
            continue
        big = np.abs(g[k]) > 1e-4 * np.abs(g[k]).max()
        assert big.mean() > 0.5, k
        assert _rel(got[k][big], want[k][big]) < STEP_REL, k
        assert np.abs(got[k] - init[k]).max() > 0, k
    for name, tree in (("mu", jstate[0].mu), ("nu", jstate[0].nu)):
        t_m, j_m = _flat(P.to_numpy(state[name])), _flat(tree)
        for k, v in t_m.items():
            assert _rel(v, j_m[k]) < STEP_REL, (name, k)


def test_adam_matches_optax():
    rng = np.random.RandomState(3)
    shapes = {"a": {"kernel": (4, 3)}, "b": {"kernel": (7,), "bias": (2,)}}
    params = {n: {k: rng.randn(*s).astype(np.float32) for k, s in p.items()}
              for n, p in shapes.items()}
    cfg = TrainConfig(learning_rate=1e-2, lr_decay=0.05)
    opt = optax.adam(lambda t: cfg.learning_rate / (1.0 + cfg.lr_decay * t))
    jp, jstate = params, opt.init(params)
    tp = {n: {k: torch.from_numpy(v.copy()) for k, v in p.items()} for n, p in params.items()}
    adam = tf.make_optimizer(cfg)
    state = adam.init(tp)
    paths = [p for p, _ in tf.trainable(tp)]
    for _ in range(5):
        g = {n: {k: rng.randn(*s).astype(np.float32) for k, s in p.items()}
             for n, p in shapes.items()}
        upd, jstate = opt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        adam.update(tp, [torch.from_numpy(g[p[0]][p[1]]) for p in paths], state)
    for n, p in jp.items():
        for k, v in p.items():
            np.testing.assert_allclose(tp[n][k].detach().numpy(), v, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(state["nu"][n][k].numpy(), jstate[0].nu[n][k],
                                       rtol=1e-6)


def test_update_bn_stats_matches_jax(jax_params, batch):
    x, _ = batch
    stats = jax.jit(lambda p, x: jf.forward_train(
        p, x, compute_dtype=jnp.float32)[1])(jax_params, x)
    want = _flat(jax.tree.map(np.asarray, jm.update_bn_stats(jax_params, stats, 0.7)))
    tp = P.to_torch(jax_params, "cpu")
    t_stats = {k: {kk: torch.from_numpy(np.asarray(vv)) for kk, vv in s.items()}
               for k, s in stats.items()}
    got = _flat(P.to_numpy(tm.update_bn_stats(tp, t_stats, 0.7)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_remat_train_step_matches(jax_params, batch):
    """Per-block recomputation gives the same loss and the same updated
    params as the plain step, bit for bit on the CPU."""
    x, y = batch
    outs = []
    for remat in (False, True):
        cfg = TrainConfig()
        opt = tf.make_optimizer(cfg)
        tp = P.to_torch(jax_params, "cpu")
        state = opt.init(tp)
        step = tf.make_train_step(cfg, opt, augment=None, remat=remat,
                                  compute_dtype=torch.float32)
        _, _, m = step(tp, state, None, torch.from_numpy(x), torch.from_numpy(y))
        outs.append((float(m["loss"]), _flat(P.to_numpy(tp))))
    assert outs[0][0] == outs[1][0]
    for k, v in outs[0][1].items():
        np.testing.assert_array_equal(outs[1][1][k], v, err_msg=k)


def _toy_face_data(rng, n_classes=4, per_class=8, size=64):
    """Distinguishable per-class patterns (the JAX package's toy recipe)."""
    images, labels = [], []
    for c in range(n_classes):
        base = rng.rand(size, size, 3).astype(np.float32)
        for _ in range(per_class):
            img = base + 0.05 * rng.randn(size, size, 3).astype(np.float32)
            images.append(np.clip(img, 0, 1) * 2 - 1)
            labels.append(c)
    return np.stack(images), np.asarray(labels)


def test_face_id_training_learns():
    rng = np.random.RandomState(12345)
    images, labels = _toy_face_data(rng)
    trainer = _trainer(4, cfg=TrainConfig(batch_size=8, learning_rate=3e-3),
                       augment=None, bn_momentum=0.7)
    first_loss = None
    for _ in range(15):
        perm = rng.permutation(len(images))
        for i in range(0, len(images), 8):
            m = trainer.train_batch(images[perm[i:i + 8]], labels[perm[i:i + 8]])
            first_loss = m["loss"] if first_loss is None else first_loss
    assert m["loss"] < first_loss
    assert trainer.eval_accuracy(images, labels) > 0.8
    assert trainer.embed(images[:2]).shape == (2, 256)


def test_trainer_defaults_to_the_card():
    """No entry point runs on the CPU unless asked: the default device is
    CUDA, and without a card the trainer refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.FaceIdTrainer(n_classes=3)


def test_augmented_step_runs_the_warp_and_is_seeded(batch):
    """With augmentation the step warps its batch (K3's plain version on
    the CPU: no kernel launch) and the generator's seed fixes the result."""
    x, y = batch
    losses = []
    for seed in (0, 0, 1):
        trainer = _trainer(N_CLASSES, seed=seed, compute_dtype=torch.float32)
        before = warp.warp_batch.launches
        losses.append(trainer.train_batch(x, y)["loss"])
        assert warp.warp_batch.launches == before
    assert losses[0] == losses[1] and losses[0] != losses[2]


def test_checkpoints_cross_packages(jax_params, batch, tmp_path):
    """A port checkpoint loads into the JAX package and embeds as the port
    does; a JAX checkpoint loads into the port and embeds as JAX does."""
    x, y = batch
    trainer = _trainer(N_CLASSES, augment=None, compute_dtype=torch.float32)
    trainer.train_batch(x, y)
    ck = tck.BestCheckpoint(str(tmp_path / "port"), name="faceid")
    assert ck.update(0.5, trainer.params, epoch=0)
    loaded = jck.load_pytree(ck.best_path)
    assert loaded["classifier"]["kernel"].shape == (256, N_CLASSES)
    assert loaded["dw1"]["kernel"].shape == (3, 3, 8, 1)
    want = np.asarray(jm.mobilenet_embed(loaded, x, precision=HIGHEST))
    assert _rel(trainer.embed(x), want) < F32_REL

    path = str(tmp_path / "jax.npz")
    jck.save_pytree(jax_params, path)
    back = P.to_torch(tck.load_pytree(path), "cpu")
    with torch.no_grad():
        got = tm.mobilenet_embed(back, torch.from_numpy(x)).numpy()
    assert _rel(got, np.asarray(jm.mobilenet_embed(jax_params, x, precision=HIGHEST))) \
        < F32_REL


def test_cli_train_writes_a_loadable_checkpoint(tmp_path, capsys):
    import cv2

    rng = np.random.RandomState(5)
    for c in ("alice", "bob", "carol"):
        (tmp_path / "train" / c).mkdir(parents=True)
        base = rng.rand(40, 40, 3) * 255
        for j in range(4):
            img = np.clip(base + rng.randn(40, 40, 3) * 10, 0, 255).astype(np.uint8)
            cv2.imwrite(str(tmp_path / "train" / c / f"{j}.jpg"), img)
    out = tmp_path / "ckpt"
    cli.main(["train", str(tmp_path / "train"), "--out-dir", str(out), "--epochs", "2",
              "--batch-size", "4", "--image-size", "32", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "epoch 0" in text and "epoch 1" in text and "best:" in text
    saved = sorted(os.listdir(out))
    assert saved and all(f.startswith("faceid-") for f in saved)
    params = jck.load_pytree(str(out / saved[-1]))
    assert params["classifier"]["kernel"].shape == (1024, 3)
    emb = jm.mobilenet_embed(params, rng.rand(2, 32, 32, 3).astype(np.float32))
    assert np.all(np.isfinite(np.asarray(emb)))
