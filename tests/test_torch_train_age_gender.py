"""The port's age/gender trainer against the JAX package, on the CPU.

The same numpy weights (the JAX package's ``init_mobilenet_params`` at
width 0.25 and ``init_head_params``, bridged with ``params.to_torch``), the
same seeded inputs (48x48, batch 6, ages in [0, 100), genders in {0, 1})
and the same dropout masks (``jax.random.bernoulli`` on the step's key,
handed to the port) go through both packages, augmentation off. Jitted
JAX on one side, the port on the other. Tolerances, as in
``test_torch_train.py`` and for its reasons:
- float32 forward: logits within 2e-4 relative L2 (the packages'
  convolutions round differently, and each BN layer spreads it a little);
  the bf16 inference logits of ``evaluate`` within 1e-4 absolute;
- gradients and steps in float64 compute (``jax.enable_x64``): gradients
  within 1e-6 relative L2 per tensor (the float32 heads after the pool
  bound them); losses within 1e-5 relative; after 1 and 3 chained steps
  the params, Adam moments and BN statistics within 1e-4 relative L2,
  params compared where the step's |g| is above 1e-4 of the tensor's
  largest (below it a rounding may flip the sign of Adam's first step).
What a task's optimizer does not own (the other head; the backbone while
frozen) is held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hse_facerec_tf_tpu.models import mobilenet as jm
from hse_facerec_tf_tpu.train import age_gender as jag
from hse_facerec_torch import params as P
from hse_facerec_torch.config import TrainConfig
from hse_facerec_torch.ops.kernels import warp
from hse_facerec_torch.train import age_gender as tag
from hse_facerec_torch.train import face_id as tf

from .test_torch_train import _flat, _rel

WIDTH, SIZE, BATCH = 0.25, 48, 6
LRS = {"frozen": 1e-3, "unfrozen": 1e-4}   # TrainConfig's two phases
F32_REL, LOSS_REL, GRAD_REL, STEP_REL = 2e-4, 1e-5, 1e-6, 1e-4
BF16_ATOL = 1e-4        # bf16 inference logits (2.4e-8 apart on this CPU)
PHASES = {"frozen": True, "unfrozen": False}


@pytest.fixture(scope="module")
def jax_params():
    kb, kh = jax.random.split(jax.random.PRNGKey(0))
    backbone = jm.init_mobilenet_params(kb, width=WIDTH)
    tree = {"backbone": backbone, **jag.init_head_params(kh, backbone_dim=256)}
    return jax.tree.map(np.asarray, tree)


def _batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32) * 2 - 1
    return x, rng.randint(0, 100, BATCH), rng.randint(0, 2, BATCH)


@pytest.fixture(scope="module")
def batches():
    return [_batch(s) for s in range(3)]


def _labels(batch, task):
    return batch[1] if task == "age" else batch[2].astype(np.float32)


def _jax_masks(key):
    """The keep masks the JAX step draws from its dropout ``key`` (in the
    float64 mode the steps run in: bernoulli's uniforms follow it)."""
    with jax.enable_x64(True):
        k1, k2 = jax.random.split(key)
        keep = 1.0 - 0.5
        return (np.asarray(jax.random.bernoulli(k1, keep, (BATCH, 256))),
                np.asarray(jax.random.bernoulli(k2, keep, (BATCH, 256))))


def _port_masks(masks):
    return tuple(torch.from_numpy(np.array(m)) for m in masks)


def _jax_loss(p, x, y, key, task, backbone_train, dtype):
    age, gender, _ = jag.forward(p, x, train=True, dropout_key=key,
                                 backbone_train=backbone_train, compute_dtype=dtype)
    if task == "age":
        loss = optax.softmax_cross_entropy_with_integer_labels(age, y).mean()
    else:
        loss = optax.sigmoid_binary_cross_entropy(gender, y.astype(jnp.float32)).mean()
    return loss + jag._l2_penalty(p, ("feats", task))


def _port_step_fns(phase, dtype=torch.float64):
    frozen = PHASES[phase]
    opts = {t: tag.make_optimizer(LRS[phase], frozen, task=t) for t in tag.TASKS}
    steps = dict(zip(tag.TASKS, tag.make_steps(opts["age"], opts["gender"],
                                               freeze_backbone=frozen,
                                               compute_dtype=dtype)))
    return opts, steps


def _adam_moments(state):
    """mu, nu of a JAX per-task optimizer state, flattened, without the
    masked entries."""
    adam = state.inner_states["train"].inner_state[0]
    return {name: {k: v for k, v in _flat(jax.tree.map(
        np.asarray, getattr(adam, name),
        is_leaf=lambda n: isinstance(n, optax.MaskedNode))).items() if v.size}
        for name in ("mu", "nu")}


def test_param_round_trip():
    """``to_numpy(to_torch(tree)) == tree`` on the age/gender tree at full
    width: dense kernels (in, out) -> (out, in) and back, the backbone's
    BN layers and depthwise kernels nested under ``backbone``."""
    kb, kh = jax.random.split(jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, {"backbone": jm.init_mobilenet_params(kb),
                                     **jag.init_head_params(kh)})
    tp = P.to_torch(tree, "cpu")
    assert tuple(tp["feats"]["kernel"].shape) == (tag.FEATS_DIM, 1024)
    assert tuple(tp["backbone"]["dw1"]["kernel"].shape) == (32, 1, 3, 3)
    back, want = _flat(P.to_numpy(tp)), _flat(tree)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_init_head_params_shapes_and_seed():
    a = tag.init_head_params(torch.Generator().manual_seed(4), device="cpu")
    b = tag.init_head_params(torch.Generator().manual_seed(4), device="cpu")
    assert {k: tuple(v["kernel"].shape) for k, v in a.items()} == {
        "feats": (256, 1024), "age": (100, 256), "gender": (1, 256)}
    limit = np.sqrt(6.0 / (1024 + 256))
    assert float(a["feats"]["kernel"].abs().max()) <= limit
    for k in a:
        assert torch.equal(a[k]["kernel"], b[k]["kernel"]) and not a[k]["bias"].any()


@pytest.mark.parametrize("backbone_train", [False, True])
def test_forward_matches_jax(jax_params, batches, backbone_train):
    x = batches[0][0]
    key = jax.random.PRNGKey(5)
    age, gender, stats = jax.jit(lambda p, x: jag.forward(
        p, x, train=True, dropout_key=key, backbone_train=backbone_train,
        compute_dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST))(jax_params, x)
    with jax.enable_x64(False):
        k1, k2 = jax.random.split(key)
        masks = (np.asarray(jax.random.bernoulli(k1, 0.5, (BATCH, 256))),
                 np.asarray(jax.random.bernoulli(k2, 0.5, (BATCH, 256))))
    with torch.no_grad():
        t_age, t_gender, t_stats = tag.forward(
            P.to_torch(jax_params, "cpu"), torch.from_numpy(x), masks=_port_masks(masks),
            backbone_train=backbone_train, compute_dtype=torch.float32)
    assert _rel(t_age.numpy(), age) < F32_REL
    assert _rel(t_gender.numpy(), gender) < F32_REL
    assert t_stats.keys() == stats.keys() and len(stats) == (27 if backbone_train else 0)
    for layer, s in stats.items():
        assert _rel(t_stats[layer]["mean"].numpy(), s["mean"]) < F32_REL, layer


# (task, batch, key) of each step: age, gender, age, as train_alternating
ORDER = [("age", 0, 10), ("gender", 1, 11), ("age", 2, 12)]
FIRST = {"age": 0, "gender": 1}         # each task's first step in ORDER


@pytest.fixture(scope="module")
def jax_steps(jax_params, batches):
    """The jitted JAX steps in float64 compute, per phase, one record per
    step of ``ORDER``: the params before it, the loss and gradients of its
    task at those params, then the params, the loss and both tasks' Adam
    moments after it."""
    out = {}
    with jax.enable_x64(True):
        for phase, frozen in PHASES.items():
            opts = {t: jag.make_optimizer(LRS[phase], frozen, task=t) for t in tag.TASKS}
            fns = dict(zip(tag.TASKS, jag.make_steps(
                opts["age"], opts["gender"], freeze_backbone=frozen, jit=False,
                compute_dtype=jnp.float64)))
            fns = {t: jax.jit(f) for t, f in fns.items()}
            p = jax_params
            states = {t: opts[t].init(jax_params) for t in tag.TASKS}
            records = []
            for task, b, k in ORDER:
                x, y, key = batches[b][0], _labels(batches[b], task), jax.random.PRNGKey(k)
                loss, grads = jax.jit(jax.value_and_grad(lambda q: _jax_loss(
                    q, x, y, key, task, not frozen, jnp.float64)))(p)
                before = _flat(jax.tree.map(np.asarray, p))
                p, states[task], m = fns[task](p, states[task], key, x, y)
                records.append({"before": before, "loss": float(loss),
                                "grads": _flat(jax.tree.map(np.asarray, grads)),
                                "after": _flat(jax.tree.map(np.asarray, p)),
                                "step_loss": float(m[f"{task}_loss"]),
                                "moments": {t: _adam_moments(s) for t, s in states.items()}})
            out[phase] = records
    return out


@pytest.mark.parametrize("phase", list(PHASES))
@pytest.mark.parametrize("task", tag.TASKS)
def test_loss_gradients_match_jax(batches, jax_steps, task, phase):
    """A step's loss and its gradients over what the task's optimizer
    owns (``feats`` and the task's head, and the backbone once unfrozen),
    at the params the task's first step starts from."""
    record = jax_steps[phase][FIRST[task]]
    _, b, k = ORDER[FIRST[task]]
    opts, _ = _port_step_fns(phase)
    tp = _load(record["before"])
    owned = opts[task].owned(tp)
    for _, t in owned:
        t.requires_grad_(True)
    age, gender, _ = tag.forward(tp, torch.from_numpy(batches[b][0]),
                                 masks=_port_masks(_jax_masks(jax.random.PRNGKey(k))),
                                 backbone_train=not PHASES[phase], compute_dtype=torch.float64)
    t_loss, _ = tag._task_loss(task, age, gender, torch.from_numpy(_labels(batches[b], task)))
    t_loss = t_loss + tag._l2_penalty(tp, ("feats", task))
    t_grads = torch.autograd.grad(t_loss, [t for _, t in owned])
    assert abs(float(t_loss.detach()) - record["loss"]) <= LOSS_REL * abs(record["loss"])
    other = "gender" if task == "age" else "age"
    names = {"/".join(p) for p, _ in owned}
    assert not any(n.startswith(other + "/") for n in names)
    assert any(n.startswith("backbone/") for n in names) == (phase == "unfrozen")
    assert len(names) == 4 + (27 + 2 * 27 if phase == "unfrozen" else 0)
    got = _flat(P.to_numpy(tf._tree([p for p, _ in owned], t_grads)))
    assert got.keys() == names
    for k, g in got.items():
        want = record["grads"][k]
        assert _rel(g, want) < GRAD_REL, (k, _rel(g, want))


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = v
    return tree


def _load(flat):
    """The reference-layout params ``flat`` as port params."""
    return P.to_torch(_unflatten(flat), "cpu")


def _snapshot(tp):
    return {k: v.copy() for k, v in _flat(P.to_numpy(tp)).items()}


def _run_port_steps(jax_params, batches, phase, n_steps):
    """The port's steps of ``ORDER[:n_steps]`` in float64 with JAX's masks,
    the params and each task's optimizer state carried through."""
    opts, steps = _port_step_fns(phase)
    tp = P.to_torch(jax_params, "cpu")
    states = {t: opts[t].init(tp) for t in tag.TASKS}
    losses, snaps = [], []
    for task, b, k in ORDER[:n_steps]:
        x, y = batches[b][0], _labels(batches[b], task)
        snaps.append((task, _snapshot(tp)))
        m = steps[task](tp, states[task], None, torch.from_numpy(x), torch.from_numpy(y),
                        masks=_port_masks(_jax_masks(jax.random.PRNGKey(k))))[2]
        losses.append(float(m[f"{task}_loss"]))
    snaps.append((None, _snapshot(tp)))
    return states, losses, snaps


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("phase", list(PHASES))
def test_steps_match_jitted_jax(jax_params, batches, jax_steps, phase, n_steps):
    """One age step, and three alternating steps (age, gender, age) chained
    on each side, against the jitted JAX steps: after each step the loss,
    the params, both tasks' Adam moments (their counts carried by the port
    across the interleaving) and the BN statistics. What a step leaves is
    held bit for bit against the port's own params before it."""
    records = jax_steps[phase][:n_steps]
    states, losses, snaps = _run_port_steps(jax_params, batches, phase, n_steps)
    np.testing.assert_allclose(losses, [r["step_loss"] for r in records], rtol=LOSS_REL)
    assert states["age"]["count"] == (n_steps + 1) // 2
    assert states["gender"]["count"] == n_steps // 2
    moved = set()
    for (task, own_before), (_, got), r in zip(snaps, snaps[1:], records):
        want, before = r["after"], r["before"]
        assert got.keys() == want.keys()
        for k in want:
            if k.endswith(("/mean", "/var")) or np.array_equal(want[k], before[k]):
                if k.endswith(("/mean", "/var")) and not PHASES[phase]:
                    assert _rel(got[k], want[k]) < STEP_REL, k
                else:                       # frozen statistics, or not the step's
                    np.testing.assert_array_equal(got[k], own_before[k], err_msg=k)
                continue
            moved.add(k)
            g = r["grads"][k]
            big = np.abs(g) > 1e-4 * np.abs(g).max()
            assert big.mean() > 0.5, k
            assert _rel(got[k][big], want[k][big]) < STEP_REL, (task, k)
    for t in tag.TASKS:
        if states[t]["count"] == 0:
            continue
        for name in ("mu", "nu"):
            # JAX's moments also cover the BN statistics, at zero gradient
            j_m = records[-1]["moments"][t][name]
            assert not any(j_m[k].any() for k in j_m if k.endswith(("/mean", "/var")))
            j_m = {k: v for k, v in j_m.items() if not k.endswith(("/mean", "/var"))}
            t_m = _flat(P.to_numpy(states[t][name]))
            assert t_m.keys() == j_m.keys(), (t, name)
            for k, v in t_m.items():
                assert _rel(v, j_m[k]) < STEP_REL, (t, name, k)
    assert len(moved) == (4 if n_steps == 1 else 6) + (0 if PHASES[phase] else 27 + 2 * 27)


@pytest.mark.parametrize("phase", list(PHASES))
def test_each_step_leaves_what_it_does_not_own(jax_params, batches, phase):
    """An age step leaves the gender head bit-identical and the other way
    round; the frozen phase leaves the whole backbone, kernels and BN
    entries, bit-identical (ports of the JAX package's isolation and
    frozen-backbone tests)."""
    _, _, snaps = _run_port_steps(jax_params, batches, phase, 3)
    for (task, before), (_, after) in zip(snaps, snaps[1:]):
        other = "gender" if task == "age" else "age"
        changed = {k for k in before if not np.array_equal(before[k], after[k])}
        assert not any(k.startswith(other + "/") for k in changed), (task, changed)
        assert any(k.startswith(task + "/") for k in changed)
        touched_backbone = any(k.startswith("backbone/") for k in changed)
        assert touched_backbone == (phase == "unfrozen")


def test_frozen_backbone_builds_no_gradient(jax_params, batches):
    """A frozen (inference-mode) backbone runs without autograd: even with
    its tensors marked, no gradient reaches them."""
    tp = P.to_torch(jax_params, "cpu")
    kernel = tp["backbone"]["conv1"]["kernel"].requires_grad_(True)
    tp["feats"]["kernel"].requires_grad_(True)
    age, _, stats = tag.forward(tp, torch.from_numpy(batches[0][0]), backbone_train=False,
                                compute_dtype=torch.float32)
    assert stats == {}
    g_kernel, g_feats = torch.autograd.grad(age.sum(), [kernel, tp["feats"]["kernel"]],
                                            allow_unused=True)
    assert g_kernel is None and g_feats is not None


def _trainer(jax_params, **kwargs):
    """A CPU trainer on the width-0.25 JAX params (heads included)."""
    trainer = tag.AgeGenderTrainer(jax_params["backbone"], device="cpu", **kwargs)
    heads = P.to_torch({k: jax_params[k] for k in ("feats", "age", "gender")}, "cpu")
    trainer.params.update(heads)
    trainer._configure(trainer.cfg.learning_rate, freeze_backbone=True)
    return trainer


def test_unfreeze_starts_fresh_optimizer_states(jax_params, batches):
    trainer = _trainer(jax_params, augment=None)
    x, ages, genders = batches[0]
    trainer.train_alternating(iter([(x, ages)] * 2), iter([(x, genders)]), steps=3)
    assert trainer.age_opt_state["count"] == 2 and trainer.gender_opt_state["count"] == 1
    assert set(trainer.age_opt_state["mu"]) == {"feats", "age"}
    trainer.unfreeze()
    assert trainer.age_optimizer.learning_rate == TrainConfig().finetune_learning_rate
    for state, task in ((trainer.age_opt_state, "age"), (trainer.gender_opt_state, "gender")):
        assert state["count"] == 0
        assert set(state["mu"]) == {"backbone", "feats", task}
        assert all(not t.any() for t in _flat(P.to_numpy(state["mu"])).values())
    conv1 = trainer.params["backbone"]["conv1"]["kernel"].clone()
    m = trainer.train_alternating(iter([(x, ages)]), iter([(x, genders)]), steps=2)
    assert set(m) == {"age_loss", "age_acc", "gender_loss", "gender_acc"}
    assert all(np.isfinite(v) for v in m.values())
    assert not torch.equal(trainer.params["backbone"]["conv1"]["kernel"], conv1)


def test_augmented_step_runs_the_warp_and_is_seeded(jax_params, batches):
    """With augmentation a step warps its batch (K3's plain version on the
    CPU: no kernel launch); the generator's seed fixes the warp and the
    masks, and the loss differs from the un-augmented step's."""
    x, ages, _ = batches[0]
    losses = []
    for seed, augment in ((0, tag.AugmentConfig()), (0, tag.AugmentConfig()),
                          (1, tag.AugmentConfig()), (0, None)):
        trainer = _trainer(jax_params, seed=seed, augment=augment,
                           compute_dtype=torch.float32)
        before = warp.warp_batch.launches
        losses.append(float(trainer.age_step(x, ages)["age_loss"]))
        assert warp.warp_batch.launches == before
    assert losses[0] == losses[1] and len(set(losses[1:])) == 3


def test_evaluate_matches_jax(jax_params, batches):
    """``evaluate`` against the JAX trainer's, both at the default bf16
    compute, on labels set so that each accuracy is neither 0 nor 1: half
    the labels are the JAX model's own predictions. The bf16 logits agree
    within ``BF16_ATOL`` and no prediction lies that close to a tie, so the
    accuracies must be equal."""
    x = np.concatenate([b[0] for b in batches])
    jt = jag.AgeGenderTrainer(seed=0)
    jt.params = jax.tree.map(jnp.asarray, jax_params)
    age, gender = (np.asarray(v) for v in jt._eval_fwd(jt.params, x))
    trainer = _trainer(jax_params)
    with torch.no_grad():
        t_age, t_gender, _ = tag.forward(trainer.params, torch.from_numpy(x))
    assert np.abs(t_age.numpy() - age).max() < BF16_ATOL
    assert np.abs(t_gender.numpy() - gender).max() < BF16_ATOL
    top2 = np.sort(age, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > BF16_ATOL and np.abs(gender).min() > BF16_ATOL
    ages = np.where(np.arange(len(x)) % 2 == 0, np.argmax(age, -1), 0)
    genders = np.where(np.arange(len(x)) % 2 == 0, gender > 0, gender <= 0).astype(np.float32)
    want = jt.evaluate(x, ages, genders, batch_size=4)
    got = trainer.evaluate(x, ages, genders, batch_size=4)
    assert got == want
    assert 0 < got["age_acc"] < 1 and 0 < got["gender_acc"] < 1


def test_default_trainer_runs_on_the_card_only():
    """No entry point runs on the CPU unless asked: the default device is
    CUDA, and without a card the trainer refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tag.AgeGenderTrainer()
