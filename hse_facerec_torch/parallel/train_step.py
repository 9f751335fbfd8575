"""Sharded training steps (data parallel x tensor parallel).

Counterpart of ``hse_facerec_tf_tpu/parallel/train_step.py``. The models
are small, so the design is batch data parallelism; the one tensor worth
splitting is the identity classifier (9131 identities over a 1024-d
embedding, ``facerec_keras_train.py:46-57``), whose columns split over a
``model`` axis. What GSPMD derives from the JAX package's sharding
annotations is written out here, so that a sharded step computes what the
single-device step computes:

- the batch splits over ``data``; each data shard runs the backbone on its
  device, and every BN layer normalizes with the moments of the whole
  batch, combined from per-shard partial sums (``backbone_sharded``);
- the classifier's column pieces sit on the ``model`` devices of each data
  row; the cross-entropy takes a log-sum-exp over the pieces' own, and the
  weight decay sums over the pieces;
- the loss is the mean over the whole batch; every parameter's gradient is
  the sum of its replicas' gradients, on the device of its master copy;
  one update per master copy, then the masters are copied into the
  replicas (``ShardedParams.broadcast_``), so replicas stay bit-identical;
- the augmentation affines (K3, one launch per shard) and the dropout masks
  are drawn for the whole batch from the trainer's generator, then split:
  the draws do not depend on the shard count.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..models.layers import batch_norm, conv2d, dense, depthwise_conv2d, relu6_train
from ..models.mobilenet import (BN_EPS, MOBILENET_V1_BLOCKS, _conv_bn_relu6,
                                init_mobilenet_params, update_bn_stats)
from ..numerics import precision_scope
from ..ops.kernels.warp import warp_batch
from ..params import cast_tree, to_torch
from ..train.augment import AugmentConfig, sample_affine
from ..train.face_id import Adam, make_optimizer
from .sharding import Mesh, shard_sum, split_batch, to_device

Path = Tuple[str, ...]


def _get(tree: Dict, path: Path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: Dict, path: Path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a (sub)tree, in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for k in sorted(tree) for t in _tensors(tree[k])]


class ShardedParams:
    """A param tree placed over a mesh. ``tree`` holds the master copy of
    every tensor, the copy the optimizer updates; ``groups`` maps a subtree
    path to the devices that compute with it, the first of which holds the
    master. The other devices hold replicas, made once; a device that
    appears twice holds one copy, so no shard's in-place update reaches
    another's buffer twice. ``on(device)`` is the tree a shard on that
    device computes with."""

    def __init__(self, tree: Dict, groups: Dict[Path, Sequence[torch.device]]):
        self.tree = tree
        self.groups = {tuple(p): list(dict.fromkeys(devs)) for p, devs in groups.items()}
        self._replicas: Dict[Tuple[Path, torch.device], Dict] = {}
        with torch.no_grad():
            for path, devs in self.groups.items():
                master = to_device(_get(tree, path), devs[0])
                _set(tree, path, master)
                for dev in devs:
                    self._replicas[(path, dev)] = (master if dev == devs[0]
                                                   else to_device(master, dev))
        self._views: Dict[torch.device, Dict] = {}

    def on(self, device) -> Dict:
        if device not in self._views:
            view: Dict = {}
            for path, devs in self.groups.items():
                if device in devs:
                    _set(view, path, self._replicas[(path, device)])
            self._views[device] = view
        return self._views[device]

    def replicas(self, path: Path) -> List[torch.Tensor]:
        """Every copy of the tensor at ``path``, the master first."""
        group = next(g for g in self.groups if path[:len(g)] == g)
        return [_get(self._replicas[(group, dev)], path[len(group):])
                for dev in self.groups[group]]

    def gradients(self, loss, optimizer: Adam) -> List[torch.Tensor]:
        """d loss / d master for every tensor ``optimizer`` owns, in its
        ``owned`` order: the sum of the replicas' gradients on the master's
        device, the master's own first, the others in mesh order."""
        paths = [p for p, _ in optimizer.owned(self.tree)]
        copies = [self.replicas(p) for p in paths]
        flat = [t for c in copies for t in c]
        for t in flat:
            t.requires_grad_(True)
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        out = []
        for c in copies:
            parts = [g if g is not None else torch.zeros_like(t)
                     for g, t in zip([next(grads) for _ in c], c)]
            out.append(shard_sum(parts, c[0].device))
        return out

    @torch.no_grad()
    def broadcast_(self) -> None:
        """Copy every master tensor into its replicas."""
        for (path, _), rep in self._replicas.items():
            master = _get(self.tree, path)
            if rep is not master:
                for r, m in zip(_tensors(rep), _tensors(master)):
                    r.copy_(m)


# -- the backbone over shards --------------------------------------------------


def _conv_bn_relu6_sharded(xs, ps, conv, stride: int, train: bool, home):
    """``mobilenet._conv_bn_relu6`` over shards: with ``train`` every shard
    normalizes with the mean and biased variance of the whole batch (two
    passes of per-shard sums, differentiable across devices). Returns the
    activations and the moments (on ``home``, detached) or None."""
    if not (train and "bn" in ps[0]):
        return [_conv_bn_relu6(x, p, conv, stride, False)[0]
                for x, p in zip(xs, ps)], None
    ys = [conv(x, p["kernel"], stride=stride) for x, p in zip(xs, ps)]
    acc = torch.promote_types(ys[0].dtype, torch.float32)
    count = sum(y.shape[0] * y.shape[2] * y.shape[3] for y in ys)
    dims = (0, 2, 3)
    mean = shard_sum([torch.sum(y, dim=dims, dtype=acc) for y in ys], home) / count
    means = [mean.to(y.device).reshape(1, -1, 1, 1) for y in ys]
    var = shard_sum([torch.sum(torch.square(y.to(acc) - m), dim=dims)
                     for y, m in zip(ys, means)], home) / count
    mean, var = mean.to(ys[0].dtype), var.to(ys[0].dtype)
    out = [relu6_train(batch_norm(y, p["bn"]["gamma"], p["bn"]["beta"],
                                  mean.to(y.device), var.to(y.device), eps=BN_EPS))
           for y, p in zip(ys, ps)]
    return out, (mean.detach(), var.detach())


def backbone_sharded(trees: Sequence[Dict], xs: Sequence[torch.Tensor], *,
                     compute_dtype=torch.float32, train: bool = False,
                     stats_out: Optional[Dict] = None, remat: bool = False,
                     home=None) -> List[torch.Tensor]:
    """``mobilenet_v1_backbone`` over shards: ``xs[s]`` (N_s, H, W, 3) on
    the device of ``trees[s]``, every shard a layer at a time so that BN in
    training mode sees the whole batch. Moments go to ``stats_out`` on
    ``home`` (default the first shard's device). ``remat`` recomputes each
    block of every shard in the backward pass."""
    home = home or xs[0].device
    dt = compute_dtype
    xs = [x.permute(0, 3, 1, 2).to(dt) for x in xs]
    stats: Dict[str, Tuple] = {}
    xs, stats["conv1"] = _conv_bn_relu6_sharded(
        xs, [cast_tree(t["conv1"], dt) for t in trees], conv2d, 2, train, home)
    for i, (stride, _) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        pdw = [cast_tree(t[f"dw{i}"], dt) for t in trees]
        ppw = [cast_tree(t[f"pw{i}"], dt) for t in trees]

        def block(*xs, pdw=pdw, ppw=ppw, stride=stride):
            ys, s_dw = _conv_bn_relu6_sharded(xs, pdw, depthwise_conv2d, stride,
                                              train, home)
            ys, s_pw = _conv_bn_relu6_sharded(ys, ppw, conv2d, 1, train, home)
            return ys, s_dw, s_pw

        if remat:
            xs, s_dw, s_pw = torch.utils.checkpoint.checkpoint(block, *xs,
                                                               use_reentrant=False)
        else:
            xs, s_dw, s_pw = block(*xs)
        stats[f"dw{i}"], stats[f"pw{i}"] = s_dw, s_pw
    if stats_out is not None:
        stats_out.update({k: {"mean": s[0], "var": s[1]}
                          for k, s in stats.items() if s is not None})
    return [x.permute(0, 2, 3, 1) for x in xs]


def _augment_split(generator, images, cfg: AugmentConfig, devices):
    """The global batch's augmentation affines drawn from ``generator``,
    then each shard's images warped on its device (K3 on CUDA)."""
    n, h, w = images.shape[0], images.shape[1], images.shape[2]
    affines = split_batch(sample_affine(generator, cfg, n, h, w), devices)
    return [warp_batch(x, a, cfg.fill_value)
            for x, a in zip(split_batch(images, devices), affines)]


def _as_float_batch(images) -> torch.Tensor:
    return torch.as_tensor(images, dtype=torch.float32)


# -- face-ID: data parallel x classifier columns over 'model' ------------------


def _grid(mesh: Mesh, split_classifier: bool) -> List[List[torch.device]]:
    """grid[d][t]: the device of data shard d, classifier piece t."""
    data = mesh.shard_devices("data")
    if not (split_classifier and "model" in mesh.axis_names):
        return [[d] for d in data]
    names = list(mesh.axis_names)
    order = [names.index("data"), names.index("model")]
    rest = tuple(0 for a in names if a not in ("data", "model"))
    grid = np.transpose(mesh.devices, order + [i for i in range(len(names))
                                               if i not in order])
    grid = grid[(slice(None), slice(None)) + rest]
    return [list(row) for row in grid]


def face_id_param_shardings(mesh: Mesh, params: Dict,
                            split_classifier: bool = True) -> Dict:
    """Which devices compute with which part of a face-ID tree, as
    ``ShardedParams`` groups (the JAX package's shardings: the classifier's
    kernel columns and bias over ``model``, everything else replicated):
    the backbone on each data shard's device, classifier piece t (of a tree
    split by ``split_classifier_columns``) on the ``model`` index t of every
    data shard."""
    grid = _grid(mesh, split_classifier)
    rows = [row[0] for row in grid]
    groups = {(k,): rows for k in params if k != "classifier"}
    if len(grid[0]) == 1:
        groups[("classifier",)] = rows
    else:
        for t in range(len(grid[0])):
            groups[("classifier", str(t))] = [row[t] for row in grid]
    return groups


def split_classifier_columns(params: Dict, pieces: int) -> Dict:
    """The tree with its classifier's columns (the rows of the (C, D)
    kernel in the port's layout, and the bias) split into ``pieces``
    contiguous pieces ``{"0": {kernel, bias}, ...}``, sizes as
    ``torch.tensor_split`` gives them: C need not divide."""
    cls = params["classifier"]
    ks = torch.tensor_split(cls["kernel"].detach(), pieces, dim=0)
    bs = torch.tensor_split(cls["bias"].detach(), pieces, dim=0)
    return {**params, "classifier": {str(t): {"kernel": k.clone(), "bias": b.clone()}
                                     for t, (k, b) in enumerate(zip(ks, bs))}}


def gather_params(params: ShardedParams) -> Dict:
    """The master tree with a split classifier joined back: the
    single-device layout (``params.to_numpy`` reads it)."""
    tree = dict(params.tree)
    cls = tree.get("classifier")
    if cls is not None and "kernel" not in cls:
        pieces = [cls[str(t)] for t in range(len(cls))]
        home = pieces[0]["kernel"].device
        tree["classifier"] = {k: torch.cat([p[k].detach().to(home) for p in pieces])
                              for k in ("kernel", "bias")}
    return tree


def _classifier_pieces(tree: Dict, pieces: int) -> List[Dict]:
    cls = tree["classifier"]
    return [cls] if pieces == 1 else [cls[str(t)] for t in range(pieces)]


def face_id_loss(params: ShardedParams, grid, xs, ys, weight_decay: float,
                 remat: bool = False, compute_dtype=torch.bfloat16):
    """``train.face_id.loss_fn`` over shards: (loss, (BN moments,
    accuracy)) on the first shard's device. Each data shard's logits are
    computed per classifier piece on that piece's device; the softmax
    normalizer is the log-sum-exp of the pieces' log-sum-exps, the label's
    logit comes from the piece that holds its column, and the prediction is
    the first maximum over the pieces (the lowest global column)."""
    rows = [row[0] for row in grid]
    home = rows[0]
    stats: Dict = {}
    hs = backbone_sharded([params.on(d) for d in rows], xs, compute_dtype=compute_dtype,
                          train=True, stats_out=stats, remat=remat, home=home)
    n_total = sum(x.shape[0] for x in xs)
    ce_sums, correct = [], []
    for row, h, y in zip(grid, hs, ys):
        here = row[0]
        emb = torch.mean(h, dim=(1, 2)).to(torch.float32)
        lses, picked, best_v, best_i = [], [], [], []
        offset = 0
        for t, dev in enumerate(row):
            piece = _classifier_pieces(params.on(dev), len(row))[t]
            logits = dense(emb.to(dev), piece["kernel"], piece["bias"])
            c = logits.shape[1]
            local = y.to(dev) - offset
            inside = (local >= 0) & (local < c)
            pick = torch.gather(logits, 1, local.clamp(0, c - 1)[:, None])[:, 0]
            lses.append(torch.logsumexp(logits, dim=1).to(here))
            picked.append(torch.where(inside, pick, torch.zeros_like(pick)).to(here))
            v, i = torch.max(logits.detach(), dim=1)
            best_v.append(v.to(here))
            best_i.append((i + offset).to(here))
            offset += c
        lse = torch.logsumexp(torch.stack(lses), dim=0)
        ce_sums.append(torch.sum(lse - shard_sum(picked, here)))
        first = torch.argmax(torch.stack(best_v), dim=0)[None, :]
        pred = torch.gather(torch.stack(best_i), 0, first)[0]
        correct.append(torch.sum((pred == y).to(torch.float32)))
    ce = shard_sum(ce_sums, home) / n_total
    l2 = weight_decay * shard_sum(
        [torch.sum(torch.square(p["kernel"]))
         for p in _classifier_pieces(params.tree, len(grid[0]))], home)
    acc = shard_sum(correct, home) / n_total
    return ce + l2, (stats, acc)


def make_sharded_face_id_step(mesh: Mesh, cfg: TrainConfig, optimizer: Adam,
                              augment: Optional[AugmentConfig] = None,
                              bn_momentum: float = 0.99, remat: bool = False,
                              compute_dtype=torch.bfloat16,
                              split_classifier: bool = True):
    """``train.face_id.make_train_step`` over ``mesh``: ``step(params
    (ShardedParams), opt_state, generator, images, labels) -> (params,
    opt_state, metrics)``, updated in place; the batch splits over
    ``data`` and, with ``split_classifier``, the classifier over
    ``model``."""
    grid = _grid(mesh, split_classifier)
    rows = [row[0] for row in grid]

    @precision_scope("highest")                   # the forward and the backward
    def step(params, opt_state, generator, images, labels):
        images = _as_float_batch(images)
        xs = (_augment_split(generator, images, augment, rows) if augment is not None
              else split_batch(images, rows))
        ys = split_batch(torch.as_tensor(labels).to(torch.int64), rows)
        loss, (stats, acc) = face_id_loss(params, grid, xs, ys, cfg.weight_decay,
                                          remat=remat, compute_dtype=compute_dtype)
        optimizer.update(params.tree, params.gradients(loss, optimizer), opt_state)
        update_bn_stats(params.tree, stats, momentum=bn_momentum)
        params.broadcast_()
        return params, opt_state, {"loss": loss.detach(), "acc": acc}

    return step


def place_face_id_params(mesh: Mesh, params: Dict,
                         split_classifier: bool = True) -> ShardedParams:
    """A face-ID tree (on any device) placed for ``make_sharded_face_id_step``."""
    grid = _grid(mesh, split_classifier)
    if len(grid[0]) > 1:
        params = split_classifier_columns(params, len(grid[0]))
    return ShardedParams(params, face_id_param_shardings(mesh, params, split_classifier))


def make_sharded_face_id_trainer(mesh: Mesh, n_classes: int,
                                 cfg: Optional[TrainConfig] = None, seed: int = 0,
                                 remat: bool = False, compute_dtype=None,
                                 params: Optional[Dict] = None):
    """Returns (params, opt_state, step_fn) laid out dp x tp over ``mesh``
    (axes ``data`` and, optionally, ``model``): the batch over ``data``,
    the classifier's columns, its bias and their Adam moments over
    ``model``, everything else replicated. ``step_fn(params, opt_state,
    generator, images, labels)``; no augmentation, as in the JAX package.
    ``params``: a reference-layout numpy tree (the JAX package's own
    weights, through ``params.to_torch``) instead of He-normal weights from
    ``seed + 1``. ``compute_dtype`` is the backbone's activation type
    (default bf16)."""
    cfg = cfg or TrainConfig()
    home = mesh.devices.flat[0]
    tree = (init_mobilenet_params(torch.Generator().manual_seed(seed + 1),
                                  n_classes=n_classes, device=home)
            if params is None else to_torch(params, home))
    placed = place_face_id_params(mesh, tree)
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(placed.tree)
    step = make_sharded_face_id_step(mesh, cfg, optimizer, augment=None, remat=remat,
                                     compute_dtype=compute_dtype or torch.bfloat16)
    return placed, opt_state, step


def _seeded_batch(n: int, image_size: int, seed: int):
    rng = np.random.RandomState(seed)
    return rng, rng.rand(n, image_size, image_size, 3).astype(np.float32) * 2 - 1


def run_one_sharded_step(mesh: Mesh, n_classes: int = 64, batch: Optional[int] = None,
                         image_size: int = 32, seed: int = 0, compute_dtype=None,
                         params: Optional[Dict] = None) -> Dict[str, float]:
    """One sharded face-ID step on tiny shapes, from the same numpy images
    and labels as the JAX package's ``run_one_sharded_step``."""
    dp = mesh.shape["data"]
    batch = batch or 2 * dp
    placed, opt_state, step = make_sharded_face_id_trainer(
        mesh, n_classes, compute_dtype=compute_dtype, params=params)
    rng, images = _seeded_batch(batch, image_size, seed)
    labels = rng.randint(0, n_classes, batch)
    _, _, metrics = step(placed, opt_state, None, images, labels)
    loss, acc = torch.stack([metrics["loss"], metrics["acc"]]).tolist()
    return {"loss": loss, "acc": acc}


# -- age/gender: data parallel over every axis --------------------------------


def make_sharded_age_gender_steps(mesh: Mesh, age_optimizer: Adam,
                                  gender_optimizer: Adam, bn_momentum: float = 0.99,
                                  freeze_backbone: bool = False,
                                  compute_dtype=torch.bfloat16,
                                  augment: Optional[AugmentConfig] = None):
    """``train.age_gender.make_steps`` over every shard of ``mesh`` (both
    axes flattened): ``step(params (ShardedParams), own_opt_state,
    generator, images, labels, masks=None) -> (params, opt_state,
    metrics)``. The warp's uniforms, then the dropout masks, are drawn for
    the whole batch from ``generator``, as the single-device step draws
    them."""
    from ..train.age_gender import _l2_penalty, _task_loss, dropout_masks, heads

    devices = mesh.shard_devices()
    home = devices[0]
    optimizers = {"age": age_optimizer, "gender": gender_optimizer}

    def make(task: str):
        optimizer = optimizers[task]

        @precision_scope("highest")               # the forward and the backward
        def step(params, opt_state, generator, images, labels, masks=None):
            images = _as_float_batch(images)
            n = images.shape[0]
            xs = (_augment_split(generator, images, augment, devices)
                  if augment is not None else split_batch(images, devices))
            if masks is None:
                masks = dropout_masks(generator, n, params.tree)
            shard_masks = list(zip(*(split_batch(m, devices) for m in masks)))
            ys = split_batch(torch.as_tensor(labels), devices)
            trees = [params.on(d) for d in devices]
            stats: Dict = {}
            with torch.set_grad_enabled(not freeze_backbone):
                hs = backbone_sharded([t["backbone"] for t in trees], xs,
                                      compute_dtype=compute_dtype,
                                      train=not freeze_backbone, stats_out=stats,
                                      home=home)
            losses, accs = [], []
            for tree, h, m, y in zip(trees, hs, shard_masks, ys):
                emb = torch.mean(h, dim=(1, 2)).to(torch.float32)
                age_logits, gender_logit = heads(tree, emb, m)
                if task == "gender":
                    y = y.to(torch.float32)
                loss_s, acc_s = _task_loss(task, age_logits, gender_logit, y)
                losses.append(loss_s * y.shape[0])
                accs.append(acc_s * y.shape[0])
            loss = (shard_sum(losses, home) / n
                    + _l2_penalty(params.tree, ("feats", task)))
            acc = shard_sum(accs, home) / n
            optimizer.update(params.tree, params.gradients(loss, optimizer), opt_state)
            if not freeze_backbone:
                update_bn_stats(params.tree["backbone"], stats, momentum=bn_momentum)
            params.broadcast_()
            return params, opt_state, {f"{task}_loss": loss.detach(), f"{task}_acc": acc}

        return step

    return make("age"), make("gender")


def make_sharded_age_gender_trainer(mesh: Mesh, lr: float = 1e-3,
                                    freeze_backbone: bool = False, seed: int = 0,
                                    width: float = 1.0, compute_dtype=None,
                                    augment="default", params: Optional[Dict] = None):
    """The alternating age/gender steps over ``mesh``: pure data
    parallelism over both axes, params replicated, one Adam per task.
    ``augment`` defaults to the reference's generator policy; None keeps
    the raw batch. ``params``: a reference-layout numpy tree
    ``{"backbone", "feats", "age", "gender"}`` instead of He-normal and
    glorot weights from ``seed + 1`` and ``seed + 2``. Returns (params,
    age_opt_state, gender_opt_state, age_step, gender_step, shard
    devices)."""
    from ..train.age_gender import init_head_params, make_optimizer as ag_optimizer

    if augment == "default":
        augment = AugmentConfig()
    devices = mesh.shard_devices()
    home = devices[0]
    if params is None:
        backbone = init_mobilenet_params(torch.Generator().manual_seed(seed + 1),
                                         width=width, device=home)
        tree = {"backbone": backbone,
                **init_head_params(torch.Generator().manual_seed(seed + 2),
                                   backbone_dim=backbone["pw13"]["kernel"].shape[0],
                                   device=home)}
    else:
        tree = to_torch(params, home)
    placed = ShardedParams(tree, {(k,): devices for k in tree})
    age_opt = ag_optimizer(lr, freeze_backbone, task="age")
    gender_opt = ag_optimizer(lr, freeze_backbone, task="gender")
    age_state, gender_state = age_opt.init(placed.tree), gender_opt.init(placed.tree)
    age_step, gender_step = make_sharded_age_gender_steps(
        mesh, age_opt, gender_opt, freeze_backbone=freeze_backbone,
        compute_dtype=compute_dtype or torch.bfloat16, augment=augment)
    return placed, age_state, gender_state, age_step, gender_step, devices


def run_one_sharded_age_gender_pair(mesh: Mesh, batch: Optional[int] = None,
                                    image_size: int = 32, seed: int = 0,
                                    compute_dtype=None, params: Optional[Dict] = None,
                                    augment="default") -> Dict[str, float]:
    """One alternating (age, gender) sharded step pair on tiny shapes
    (width 0.25), from the JAX package's numpy images and labels; the
    augmentation and dropout draw from a generator seeded with ``seed``."""
    batch = batch or 2 * mesh.size
    placed, age_state, gender_state, age_step, gender_step, devices = \
        make_sharded_age_gender_trainer(mesh, width=0.25, seed=seed,
                                        compute_dtype=compute_dtype, params=params,
                                        augment=augment)
    rng, images = _seeded_batch(batch, image_size, seed)
    ages = rng.randint(0, 100, batch)
    genders = rng.randint(0, 2, batch)
    generator = torch.Generator(device=devices[0]).manual_seed(seed)
    _, _, m1 = age_step(placed, age_state, generator, images, ages)
    _, _, m2 = gender_step(placed, gender_state, generator, images, genders)
    metrics = {**m1, **m2}
    return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
