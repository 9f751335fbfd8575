"""Face-identification backbone training (softmax over identities).

Counterpart of ``hse_facerec_tf_tpu/train/face_id.py``, with the
reference's recipe (``facerec_keras_train.py``): MobileNet + GAP + softmax
Dense with L2 4e-5 on its kernel (:46-57), Adam 1e-3 with 1e-5 decay
(:192), augmentation per ``ImageDataGenerator`` (:164-168, here
``train/augment.py`` on the warp kernel K3), checkpoint on best val
accuracy + early stopping patience 2 (:205-208).

One train step: augmentation (K3), forward with batch-statistics BN, loss,
autograd, an Adam update and the BN running-statistics update, all on the
device. Params, Adam moments and BN statistics are updated in place (the
reference donates their buffers to the jitted step). ``FaceIdTrainer(mesh=
...)`` splits each batch over the mesh's ``data`` axis
(``parallel/train_step.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TrainConfig
from ..models.layers import dense
from ..models.mobilenet import (init_mobilenet_params, mobilenet_classify,
                                mobilenet_embed, mobilenet_v1_backbone,
                                update_bn_stats)
from ..numerics import precision_scope
from ..pipelines.detector import resolve_device
from .augment import AugmentConfig, augment_batch

Path = Tuple[str, ...]


def trainable(params: Dict, select: Optional[Callable[[Path], bool]] = None
              ) -> List[Tuple[Path, torch.Tensor]]:
    """The tensors an optimizer moves, with their paths, in tree order:
    every kernel and bias, and each BN layer's gamma and beta (its running
    mean and variance get no gradient: the training forward normalizes
    with the batch's moments). Layers may nest (the age/gender tree keeps
    the backbone's layers under ``"backbone"``); ``select``, a predicate on
    the path, keeps the tensors one optimizer owns."""
    out: List[Tuple[Path, torch.Tensor]] = []

    def walk(node: Dict, path: Path) -> None:
        for key, value in node.items():
            if key == "bn":
                out.extend((path + (key, k), value[k]) for k in ("gamma", "beta"))
            elif isinstance(value, dict):
                walk(value, path + (key,))
            else:
                out.append((path + (key,), value))

    walk(params, ())
    return out if select is None else [(p, t) for p, t in out if select(p)]


def _tree(paths: List[Path], tensors) -> Dict:
    root: Dict = {}
    for path, t in zip(paths, tensors):
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t
    return root


def _leaves(tree: Dict, paths: List[Path]) -> List[torch.Tensor]:
    out = []
    for path in paths:
        node = tree
        for p in path:
            node = node[p]
        out.append(node)
    return out


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam`` with Keras-style decay: the learning rate of update t
    (counted from 0) is ``learning_rate / (1 + lr_decay·t)``; b1 0.9, b2
    0.999, eps 1e-8, eps_root 0 (optax's defaults, which the reference
    uses). Updates params and moments in place. ``select`` (a predicate on
    a ``trainable`` path) restricts it to the tensors it owns, as an
    ``optax.multi_transform`` that sends the rest to ``set_to_zero`` does:
    they keep no moments and never move."""
    learning_rate: float
    lr_decay: float = 0.0
    select: Optional[Callable[[Path], bool]] = None
    b1 = 0.9
    b2 = 0.999
    eps = 1e-8

    def owned(self, params: Dict) -> List[Tuple[Path, torch.Tensor]]:
        return trainable(params, self.select)

    def init(self, params: Dict) -> Dict:
        """Zero moments, in the params' tree shape; marks the owned
        tensors as requiring grad."""
        leaves = self.owned(params)
        paths = [p for p, _ in leaves]
        for _, t in leaves:
            t.requires_grad_(True)
        zeros = [torch.zeros_like(t, requires_grad=False) for _, t in leaves]
        return {"count": 0, "mu": _tree(paths, zeros),
                "nu": _tree(paths, [z.clone() for z in zeros])}

    @torch.no_grad()
    def update(self, params: Dict, grads: List[torch.Tensor], state: Dict) -> None:
        """One update of ``params`` from ``grads``, in ``owned`` order."""
        paths = [p for p, _ in self.owned(params)]
        ps = _leaves(params, paths)
        mus, nus = _leaves(state["mu"], paths), _leaves(state["nu"], paths)
        # the schedule and the bias corrections in float32, as optax computes
        # them: 1 - 0.999**t loses digits to cancellation, in the same way
        f32 = np.float32
        lr = f32(self.learning_rate) / (f32(1.0) + f32(self.lr_decay) * f32(state["count"]))
        state["count"] += 1
        t = f32(state["count"])
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(nus, float(f32(1.0) - f32(self.b2) ** t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, float(f32(1.0) - f32(self.b1) ** t))
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(ps, upd, alpha=-float(lr))


def make_optimizer(cfg: TrainConfig) -> Adam:
    """Adam with Keras-style 1/(1 + decay·t) learning-rate decay (:192)."""
    return Adam(cfg.learning_rate, cfg.lr_decay)


def forward_train(params: Dict, images, *, precision="highest",
                  remat: bool = False, compute_dtype=torch.bfloat16):
    """Training forward: logits and the BN batch moments. ``remat`` applies
    per-block recomputation in the backbone (activation-memory headroom,
    not speed); ``compute_dtype`` is the backbone's activation type, and
    every layer runs at ``precision``'s tier ("highest" by default, where
    the reference's trainers default to DEFAULT)."""
    stats: Dict = {}
    with precision_scope(precision):
        h = mobilenet_v1_backbone(params, images, precision=precision,
                                  compute_dtype=compute_dtype, train=True,
                                  stats_out=stats, remat=remat)
        emb = torch.mean(h, dim=(1, 2)).to(torch.float32)
        logits = dense(emb, params["classifier"]["kernel"], params["classifier"]["bias"])
    return logits, stats


def forward_eval(params: Dict, images, *, precision="highest",
                 compute_dtype=torch.bfloat16):
    return mobilenet_classify(params, images, precision=precision,
                              compute_dtype=compute_dtype)


def loss_fn(params: Dict, images, labels, weight_decay: float,
            precision="highest", remat: bool = False, compute_dtype=torch.bfloat16):
    """Mean softmax cross-entropy plus ``weight_decay``·Σ kernel² of the
    classifier; returns (loss, (BN moments, accuracy))."""
    logits, stats = forward_train(params, images, precision=precision, remat=remat,
                                  compute_dtype=compute_dtype)
    ce = F.cross_entropy(logits, labels)
    l2 = weight_decay * torch.sum(torch.square(params["classifier"]["kernel"]))
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
    return ce + l2, (stats, acc)


def make_train_step(cfg: TrainConfig, optimizer: Adam,
                    augment: Optional[AugmentConfig] = AugmentConfig(),
                    bn_momentum: float = 0.99, remat: bool = False,
                    compute_dtype=torch.bfloat16):
    """Returns ``step(params, opt_state, generator, images, labels) ->
    (params, opt_state, metrics)``: the same objects, updated in place;
    ``metrics`` holds the loss and accuracy as device scalars. ``images``
    are the float32 preprocessed batch, ``generator`` a ``torch.Generator``
    on their device (it draws the augmentation). The forward and the
    backward run at "highest"."""
    @precision_scope("highest")
    def step(params, opt_state, generator, images, labels):
        if augment is not None:
            images = augment_batch(generator, images, augment)
        loss, (stats, acc) = loss_fn(params, images, labels, cfg.weight_decay,
                                     remat=remat, compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, [t for _, t in optimizer.owned(params)])
        optimizer.update(params, list(grads), opt_state)
        update_bn_stats(params, stats, momentum=bn_momentum)
        return params, opt_state, {"loss": loss.detach(), "acc": acc}

    return step


class FaceIdTrainer:
    """Drives the train step over in-memory batches on ``device``.

    Weights are He-normal from ``seed + 1`` (drawn on the CPU, so a seed
    gives the same weights on every device); augmentation draws from a
    generator on the device seeded with ``seed``. ``compute_dtype`` is the
    backbone's activation type (bf16 by default, as the reference's).
    ``mesh`` (``parallel.sharding.Mesh``): pure data parallelism, the batch
    split over its ``data`` axis and the params replicated (every BN layer
    normalizes with the whole batch's moments, the augmentation is drawn
    for the whole batch and warped per shard); the trainer's own params
    live on the mesh's first device, which replaces ``device``."""

    def __init__(self, n_classes: int, cfg: Optional[TrainConfig] = None,
                 seed: int = 0, augment: Optional[AugmentConfig] = AugmentConfig(),
                 bn_momentum: float = 0.99, remat: bool = False, device="cuda",
                 compute_dtype=torch.bfloat16, mesh=None):
        self.cfg = cfg or TrainConfig()
        self.device = (mesh.devices.flat[0] if mesh is not None
                       else resolve_device(device))
        self.compute_dtype = compute_dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_mobilenet_params(torch.Generator().manual_seed(seed + 1),
                                            n_classes=n_classes, device=self.device)
        self.optimizer = make_optimizer(self.cfg)
        self.opt_state = self.optimizer.init(self.params)
        self._sharded = None
        if mesh is None:
            self._step = make_train_step(self.cfg, self.optimizer, augment,
                                         bn_momentum=bn_momentum, remat=remat,
                                         compute_dtype=compute_dtype)
        else:
            from ..parallel.train_step import (make_sharded_face_id_step,
                                               place_face_id_params)

            # the master copies are self.params' own tensors
            self._sharded = place_face_id_params(mesh, self.params,
                                                 split_classifier=False)
            self._step = make_sharded_face_id_step(
                mesh, self.cfg, self.optimizer, augment, bn_momentum=bn_momentum,
                remat=remat, compute_dtype=compute_dtype, split_classifier=False)

    def _input(self, images):
        return torch.as_tensor(images, dtype=torch.float32, device=self.device)

    def train_batch(self, images, labels) -> Dict[str, float]:
        """One step on (N, H, W, 3) float images (numpy or a tensor) and
        their integer labels."""
        y = torch.as_tensor(labels, device=self.device).to(torch.int64)
        params = self.params if self._sharded is None else self._sharded
        _, _, metrics = self._step(params, self.opt_state, self.generator,
                                   self._input(images), y)
        # one host read for the whole metrics dict, not one per scalar
        loss, acc = torch.stack([metrics["loss"], metrics["acc"]]).tolist()
        return {"loss": loss, "acc": acc}

    @torch.no_grad()
    def eval_accuracy(self, images, labels, batch_size: int = 64) -> float:
        correct = 0
        for i in range(0, len(images), batch_size):
            logits = forward_eval(self.params, self._input(images[i:i + batch_size]),
                                  compute_dtype=self.compute_dtype)
            correct += int((torch.argmax(logits, dim=-1).cpu().numpy()
                            == np.asarray(labels[i:i + batch_size])).sum())
        return correct / len(images)

    @torch.no_grad()
    def embed(self, images) -> np.ndarray:
        return mobilenet_embed(self.params, self._input(images),
                               compute_dtype=self.compute_dtype).cpu().numpy()
