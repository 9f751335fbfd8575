"""The port's sharded trainers and its multi-device dry run, on the CPU.

The JAX package's sharded trainers run once each, in module fixtures, on
its 8 virtual XLA CPU devices (a (2, 2) mesh) at tiny shapes: 32², batch
8, no augmentation; the face-ID trainer at its only width (1.0) with 16
classes, in f32 and again in float64 compute, the age and the gender step
at width 0.25 in f32, each from the initial params, with the dropout masks
their keys draw handed to the port. The port runs on a mesh that repeats the CPU.
Required:
- sharded f32 losses within 1e-4 relative of the JAX package's and of the
  port's own single-device step, accuracies equal;
- params after one step within 1e-4 relative L2 per tensor in float64
  compute: against the port's single-device step everywhere, and against
  the JAX package's sharded step (under ``jax.enable_x64``) where |g| is
  above 1e-4 of the tensor's largest gradient, as ``test_torch_train.py``
  holds the single-device step (the float32 head after the GAP leaves
  gradients 1e-7-scale apart, and below that mask such a rounding may flip
  the sign of the first Adam step, ``lr·g/(|g| + 1e-8)``);
- replicas bit-identical after a step; the classifier's columns, its bias
  and their Adam moments split over ``model``;
- the dry-run twin passes on an 8-shard CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec

from hse_facerec_tf_tpu.models import mobilenet as jm
from hse_facerec_tf_tpu.parallel import train_step as jts
from hse_facerec_torch import params as P
from hse_facerec_torch.config import TrainConfig
from hse_facerec_torch.parallel import dryrun
from hse_facerec_torch.parallel import sharding as ps
from hse_facerec_torch.parallel import train_step as ts
from hse_facerec_torch.train import age_gender as tag
from hse_facerec_torch.train import face_id as tf

N_CLASSES, SIZE, BATCH, SEED = 16, 32, 8, 7


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the sharded steps run thousands of small ops a
    shard and a layer at a time, which a thread team on cores that other
    test workers share slows down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
LOSS_REL, STEP_REL = 1e-4, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _mesh(shape):
    return ps.make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def _batch(n=BATCH, seed=SEED, classes=N_CLASSES):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, SIZE, SIZE, 3).astype(np.float32) * 2 - 1
    return x, rng.randint(0, classes, n)


# ---------- face-ID, dp x tp ----------

@pytest.fixture(scope="module")
def jax_face_id():
    """The JAX package's dp x tp trainer on a (2, 2) mesh: its initial
    params, one f32 step's metrics, and the params after one step in
    float64 compute (``jax.enable_x64``: in float32 a rounding of a
    noise-level gradient flips the sign of its first Adam step, ``lr·g/(|g|
    + 1e-8)``, as ``test_torch_train.py`` explains)."""
    mesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    x, y = _batch()
    params, opt_state, step = jts.make_sharded_face_id_trainer(
        mesh, N_CLASSES, seed=SEED, compute_dtype=jnp.float32)
    init = jax.tree.map(np.array, params)
    _, _, metrics = step(params, opt_state, jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(y))
    with jax.enable_x64(True):
        params, opt_state, step = jts.make_sharded_face_id_trainer(
            mesh, N_CLASSES, seed=SEED, compute_dtype=jnp.float64)
        # under x64 the trainer's He scale is a float64 numpy scalar, so its
        # own init differs from the f32 one in the last bits: start from
        # the f32 init, placed as the trainer places its params
        params = jax.device_put(init, jax.tree.map(lambda a: a.sharding, params))
        params, _, _ = step(params, opt_state, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(y))
        after = jax.tree.map(np.asarray, params)
    return init, {k: float(v) for k, v in metrics.items()}, after


def _single_step(init, dtype, x, y, cfg=None):
    cfg = cfg or TrainConfig()
    opt = tf.make_optimizer(cfg)
    tp = P.to_torch(init, "cpu")
    state = opt.init(tp)
    step = tf.make_train_step(cfg, opt, augment=None, compute_dtype=dtype)
    _, _, m = step(tp, state, None, torch.from_numpy(x), torch.from_numpy(y))
    return tp, state, {k: float(v) for k, v in m.items()}


def _sharded_step(init, shape, dtype, x, y, **kw):
    placed, state, step = ts.make_sharded_face_id_trainer(
        _mesh(shape), N_CLASSES, params=init, compute_dtype=dtype, **kw)
    _, _, m = step(placed, state, None, x, y)
    return placed, state, {k: float(v) for k, v in m.items()}


def _float64_grads(init, x, y):
    """The single-device float64 gradient of every trainable tensor."""
    tp = P.to_torch(init, "cpu")
    owned = tf.trainable(tp)
    for _, t in owned:
        t.requires_grad_(True)
    loss, _ = tf.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y),
                         TrainConfig().weight_decay, compute_dtype=torch.float64)
    grads = torch.autograd.grad(loss, [t for _, t in owned])
    tree = {}
    for (path, _), g in zip(owned, grads):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return _flat(P.to_numpy(tree))


def test_sharded_face_id_matches_jax(jax_face_id):
    init, want_m, want_p = jax_face_id
    x, y = _batch()
    _, _, m = _sharded_step(init, (2, 2), torch.float32, x, y)
    assert m["loss"] == pytest.approx(want_m["loss"], rel=LOSS_REL)
    assert m["acc"] == want_m["acc"]
    _, _, single = _single_step(init, torch.float32, x, y)
    assert m["loss"] == pytest.approx(single["loss"], rel=LOSS_REL)
    placed, _, _ = _sharded_step(init, (2, 2), torch.float64, x, y)
    got, want = _flat(P.to_numpy(ts.gather_params(placed))), _flat(want_p)
    g = _float64_grads(init, x, y)
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith(("/mean", "/var")):            # BN running statistics
            assert _rel(got[k], want[k]) < STEP_REL, k
            continue
        # at 32² the last depthwise layers see a 2x2 or 1x1 map: taps that
        # only meet the padding get no gradient and no step, in both
        big = np.abs(g[k]) > 1e-4 * np.abs(g[k]).max()
        assert big.sum() > 0.5 * (g[k] != 0).sum(), k
        held = big | (g[k] == 0)
        assert _rel(got[k][held], want[k][held]) < STEP_REL, k


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_sharded_face_id_matches_single_device_float64(jax_face_id, shape):
    init, _, _ = jax_face_id
    x, y = _batch()
    tp, state1, single = _single_step(init, torch.float64, x, y)
    placed, state, m = _sharded_step(init, shape, torch.float64, x, y)
    assert m["loss"] == pytest.approx(single["loss"], rel=1e-6)
    assert m["acc"] == single["acc"]
    got, want = _flat(P.to_numpy(ts.gather_params(placed))), _flat(P.to_numpy(tp))
    for k in want:
        assert _rel(got[k], want[k]) < STEP_REL, k
    # the classifier, its bias and their moments split over 'model'
    tp_cols = shape[1]
    pieces = placed.tree["classifier"]
    assert sorted(pieces) == [str(t) for t in range(tp_cols)]
    assert [p["kernel"].shape[0] for p in pieces.values()] == [N_CLASSES // tp_cols] * tp_cols
    for name in ("mu", "nu"):
        assert sorted(state[name]["classifier"]) == sorted(pieces)
        joined = torch.cat([state[name]["classifier"][t]["kernel"] for t in sorted(pieces)])
        assert _rel(joined.numpy(), state1[name]["classifier"]["kernel"].numpy()) < STEP_REL
    # every replica of every tensor equals its master, bit for bit
    for path in placed.groups:
        copies = placed.replicas(path)
        for c in copies[1:]:
            for a, b in zip(ts._tensors(c), ts._tensors(copies[0])):
                assert torch.equal(a, b)


def test_sharded_face_id_uneven_classes_and_remat():
    """15 classes over two column pieces (8 + 7), and ``remat``: the
    single-device step's loss and params (float64 compute)."""
    init = jax.tree.map(np.asarray, jm.init_mobilenet_params(
        jax.random.PRNGKey(1), n_classes=15, width=0.25))
    x, y = _batch(classes=15)
    tp, _, single = _single_step(init, torch.float64, x, y)
    for remat in (False, True):
        placed, state, step = ts.make_sharded_face_id_trainer(
            _mesh((2, 2)), 15, params=init, compute_dtype=torch.float64, remat=remat)
        assert [p["kernel"].shape[0] for p in placed.tree["classifier"].values()] == [8, 7]
        _, _, m = step(placed, state, None, x, y)
        assert float(m["loss"]) == pytest.approx(single["loss"], rel=1e-6)
        got, want = _flat(P.to_numpy(ts.gather_params(placed))), _flat(P.to_numpy(tp))
        assert max(_rel(got[k], want[k]) for k in want) < STEP_REL


def test_run_one_sharded_step_on_a_4x2_mesh():
    metrics = ts.run_one_sharded_step(_mesh((4, 2)), n_classes=32, image_size=32)
    assert np.isfinite(metrics["loss"]) and 0.0 <= metrics["acc"] <= 1.0


def test_face_id_trainer_mesh_equals_single_device(monkeypatch):
    """``FaceIdTrainer(mesh=...)``: the whole batch's augmentation drawn
    from the trainer's generator, warped once per data shard (K3 on the
    card), two steps equal to the single-device trainer's (float64
    compute)."""
    warps = []
    warp = ts.warp_batch
    monkeypatch.setattr(ts, "warp_batch", lambda x, *a: warps.append(x.shape[0]) or warp(x, *a))
    kw = dict(n_classes=N_CLASSES, seed=3, compute_dtype=torch.float64)
    single = tf.FaceIdTrainer(device="cpu", **kw)
    sharded = tf.FaceIdTrainer(mesh=ps.make_mesh((4, 2), ("data", "model"), ["cpu"] * 8), **kw)
    x, y = _batch()
    for _ in range(2):
        want, got = single.train_batch(x, y), sharded.train_batch(x, y)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
        assert got["acc"] == want["acc"]
    assert warps == [2] * 8                   # 4 data shards, two steps
    got, want = _flat(P.to_numpy(sharded.params)), _flat(P.to_numpy(single.params))
    for k in want:
        assert _rel(got[k], want[k]) < STEP_REL, k
    assert sharded.embed(x[:2]).shape == (2, 1024)


# ---------- age/gender over both axes ----------

AG_WIDTH = 0.25


@pytest.fixture(scope="module")
def jax_age_gender():
    """The JAX package's sharded age and gender steps on a (2, 2) mesh,
    without augmentation, each from the initial params (after an age step
    float32 rounding of noise-level gradients flips the sign of some first
    Adam steps, ``lr·g/(|g| + eps)``, so a chained gender loss is held in
    float64 against the port's own single-device pair below): the initial
    params, the keys' dropout masks and the two steps' metrics."""
    mesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    params, age_os, gender_os, age_step, gender_step, _ = \
        jts.make_sharded_age_gender_trainer(mesh, width=AG_WIDTH, seed=SEED,
                                            compute_dtype=jnp.float32, augment=None)
    init = jax.tree.map(np.array, params)
    x, ages = _batch(classes=100)
    genders = np.random.RandomState(SEED + 1).randint(0, 2, BATCH)
    keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
    masks = []
    for key in keys:
        k1, k2 = jax.random.split(key)
        masks.append((np.asarray(jax.random.bernoulli(k1, 0.5, (BATCH, 256))),
                      np.asarray(jax.random.bernoulli(k2, 0.5, (BATCH, 256)))))
    _, _, m1 = age_step(params, age_os, keys[0], jnp.asarray(x), jnp.asarray(ages))
    fresh = jax.device_put(init, NamedSharding(mesh, PartitionSpec()))
    _, _, m2 = gender_step(fresh, gender_os, keys[1], jnp.asarray(x), jnp.asarray(genders))
    metrics = {k: float(v) for k, v in {**m1, **m2}.items()}
    return init, masks, (x, ages, genders), metrics


def _port_masks(masks):
    return tuple(torch.from_numpy(np.array(m)) for m in masks)


TASK_DATA = (("age", 1, 0), ("gender", 2, 1))     # (task, labels in data, masks)


def _single_pair(init, masks, data, dtype, frozen=False, augment=None, seed=0,
                 tasks=("age", "gender")):
    """The single-device steps of ``tasks``, in order, on one param tree."""
    x = data[0]
    opts = {t: tag.make_optimizer(1e-3, frozen, task=t) for t in tag.TASKS}
    tp = P.to_torch(init, "cpu")
    states = {t: opts[t].init(tp) for t in tag.TASKS}
    steps = dict(zip(tag.TASKS, tag.make_steps(opts["age"], opts["gender"],
                                               freeze_backbone=frozen,
                                               compute_dtype=dtype, augment=augment)))
    gen = torch.Generator().manual_seed(seed)
    m = {}
    for task, at, mi in TASK_DATA:
        if task in tasks:
            y = torch.from_numpy(data[at]).to(torch.float32 if task == "gender"
                                                else torch.int64)
            m.update(steps[task](tp, states[task], gen, torch.from_numpy(x), y,
                                 masks=masks[mi] and _port_masks(masks[mi]))[2])
    return tp, {k: float(v) for k, v in m.items()}


def _sharded_pair(init, masks, data, dtype, shape=(2, 2), frozen=False, augment=None,
                  seed=0, tasks=("age", "gender")):
    """The sharded steps of ``tasks``, in order, on one placed tree."""
    x = data[0]
    placed, age_os, gender_os, age_step, gender_step, devices = \
        ts.make_sharded_age_gender_trainer(_mesh(shape), freeze_backbone=frozen,
                                           compute_dtype=dtype, params=init,
                                           augment=augment)
    assert len(devices) == int(np.prod(shape))
    gen = torch.Generator().manual_seed(seed)
    steps = {"age": (age_step, age_os), "gender": (gender_step, gender_os)}
    m = {}
    for task, at, mi in TASK_DATA:
        if task in tasks:
            fn, state = steps[task]
            m.update(fn(placed, state, gen, x, data[at],
                        masks=masks[mi] and _port_masks(masks[mi]))[2])
    return placed, {k: float(v) for k, v in m.items()}


def test_sharded_age_gender_matches_jax(jax_age_gender):
    init, masks, data, want = jax_age_gender
    got, single = {}, {}
    for task in ("age", "gender"):          # each from the initial params
        got.update(_sharded_pair(init, masks, data, torch.float32, tasks=(task,))[1])
        single.update(_single_pair(init, masks, data, torch.float32, tasks=(task,))[1])
    for k in ("age_loss", "gender_loss"):
        assert got[k] == pytest.approx(want[k], rel=LOSS_REL), k
        assert got[k] == pytest.approx(single[k], rel=LOSS_REL), k
    for k in ("age_acc", "gender_acc"):
        assert got[k] == want[k] == single[k], k


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_sharded_age_gender_matches_single_device_float64(jax_age_gender, frozen, shape):
    """With the augmentation on (the warp per shard) and the dropout masks
    drawn from the generator: the pair's losses and params equal the
    single-device pair's; a frozen trunk stays bit-identical."""
    init, _, data, _ = jax_age_gender
    aug = tag.AugmentConfig()
    tp, single = _single_pair(init, (None, None), data, torch.float64, frozen, aug)
    placed, got = _sharded_pair(init, (None, None), data, torch.float64, shape, frozen, aug)
    for k in single:
        assert got[k] == pytest.approx(single[k], rel=1e-6), k
    g, w, start = _flat(P.to_numpy(placed.tree)), _flat(P.to_numpy(tp)), _flat(init)
    for k in w:
        assert _rel(g[k], w[k]) < STEP_REL, k
        if frozen and k.startswith("backbone/"):
            np.testing.assert_array_equal(g[k], start[k])


def test_run_one_sharded_age_gender_pair_on_a_4x2_mesh():
    metrics = ts.run_one_sharded_age_gender_pair(_mesh((4, 2)))
    assert np.isfinite(metrics["age_loss"]) and np.isfinite(metrics["gender_loss"])
    assert 0.0 <= metrics["age_acc"] <= 1.0


# ---------- the dry run ----------

def test_dryrun_multichip_on_cpu_shards(capsys):
    out = dryrun.dryrun_multichip(8, device="cpu")
    assert out["mesh"] == [4, 2] and out["embed_shape"] == [16, 1024]
    assert out["analyze_batch"]["faces"] > 0
    assert "8 virtual shards on 1 device(s)" in capsys.readouterr().out


def test_dryrun_needs_the_card_it_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(4)
