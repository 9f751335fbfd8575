"""Multi-task age and gender head training over the MobileNet-V1 trunk.

Counterpart of ``hse_facerec_tf_tpu/train/age_gender.py``. The reference
trains its multi-output net in an alternating-batch loop, because the age
labels (IMDB-wiki year directories) and the gender labels live in
different directory trees (``age_gender_train.py:139-159,194-232``): each
step takes either an age batch (a 100-way softmax head) or a gender batch
(a sigmoid head), and both move the shared trunk. Two phases: the backbone
frozen (3 epochs at 1e-3), then everything fine-tuned (30 epochs at 1e-4)
(:240-269).

The param tree is ``{"backbone": {conv1, dw1, pw1, ...}, "feats", "age",
"gender"}`` in PyTorch layouts (``params.to_torch``). One step: the
augmentation warp (K3 on the card, ``train/augment.py``), the forward with
dropout on the pooled embedding and on ``feats``, the task's loss,
autograd over the tensors the task's optimizer owns, its Adam update, then
the BN running statistics; params, moments and statistics are updated in
place. Each task owns its own Adam (the reference compiles ``age_model``
and ``gender_model`` apart, :243-245), which never holds or moves the other
task's head. A frozen backbone runs inference-mode BN without autograd: no
gradient is built for it, and its kernels and statistics stay as they are.

Random draws come from one ``torch.Generator`` on the device, in the
reference's order: the warp's uniforms, then the dropout masks. They are
not ``jax.random``'s bits; the steps take the masks from the caller where
the caller has them (the tests hand over the masks JAX's keys give).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TrainConfig
from ..models.layers import dense
from ..models.mobilenet import (init_mobilenet_params, mobilenet_v1_backbone,
                                update_bn_stats)
from ..numerics import div_const, precision_scope
from ..params import to_torch
from ..pipelines.detector import resolve_device
from .augment import AugmentConfig, augment_batch
from .face_id import Adam, Path

N_AGE_BINS = 100
FEATS_DIM = 256
L2_REG = 4e-5           # kernel_regularizer=l2(4e-5) (:178-181)
ADAM_DECAY = 1e-6       # Adam(lr, decay=1e-6) (:243,262)
DROPOUT_RATE = 0.5
TASKS = ("age", "gender")


def init_head_params(generator: torch.Generator, backbone_dim: int = 1024,
                     device="cuda") -> Dict:
    """Glorot-uniform ``feats`` (backbone_dim -> 256), ``age`` (256 -> 100)
    and ``gender`` (256 -> 1) Dense layers with zero biases, on ``device``.
    The uniforms come from ``generator`` (on the CPU, so a seed gives the
    same weights on every device) in the reference's (in, out) shapes."""
    def glorot(shape):
        limit = np.float32(np.sqrt(6.0 / (shape[0] + shape[1])))
        u = torch.rand(shape, generator=generator, device=generator.device)
        return u.cpu().numpy() * (2 * limit) - limit

    heads = {name: {"kernel": glorot((n_in, n_out)), "bias": np.zeros(n_out, np.float32)}
             for name, n_in, n_out in (("feats", backbone_dim, FEATS_DIM),
                                       ("age", FEATS_DIM, N_AGE_BINS),
                                       ("gender", FEATS_DIM, 1))}
    return to_torch(heads, resolve_device(device))


def dropout_masks(generator: torch.Generator, n: int, params: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep masks (bool, True = kept with probability 1 - ``DROPOUT_RATE``)
    for the pooled embedding (n, backbone_dim) and ``feats``' output (n,
    256), drawn from ``generator`` on its device."""
    kernel = params["feats"]["kernel"]                     # (out, in)
    keep = 1.0 - DROPOUT_RATE
    return tuple(torch.rand((n, d), generator=generator, device=generator.device) < keep
                 for d in (kernel.shape[1], kernel.shape[0]))


def forward(params: Dict, images, *, masks: Optional[Sequence[torch.Tensor]] = None,
            precision="highest", backbone_train: bool = False,
            compute_dtype=torch.bfloat16):
    """Shared trunk -> (age_logits (N, 100), gender_logit (N,), BN moments).

    ``backbone_train`` runs the trunk's BN on the batch's moments and
    returns them (the fine-tuning phase); otherwise the trunk runs
    inference-mode BN on its running statistics, without autograd (the
    frozen phase and evaluation), and the moments are ``{}``. ``masks``
    (``dropout_masks``) apply dropout as the reference does:
    ``emb·mask/keep``, then ``relu(feats)``, then ``f·mask/keep``. Every
    layer runs at ``precision``'s tier ("highest" by default, where the
    reference's trainers default to DEFAULT)."""
    stats: Dict = {}
    with precision_scope(precision):
        with torch.set_grad_enabled(backbone_train and torch.is_grad_enabled()):
            h = mobilenet_v1_backbone(params["backbone"], images,
                                      precision=precision,
                                      compute_dtype=compute_dtype,
                                      train=backbone_train,
                                      stats_out=stats if backbone_train else None)
            emb = torch.mean(h, dim=(1, 2)).to(torch.float32)
        return (*heads(params, emb, masks), stats)


def heads(params: Dict, emb, masks: Optional[Sequence[torch.Tensor]] = None):
    """The pooled embedding (N, backbone_dim) -> (age_logits, gender_logit),
    with dropout where ``masks`` are given."""
    keep = 1.0 - DROPOUT_RATE
    if masks is not None:
        emb = div_const(emb * masks[0], keep)
    f = torch.relu(dense(emb, params["feats"]["kernel"], params["feats"]["bias"]))
    if masks is not None:
        f = div_const(f * masks[1], keep)
    age_logits = dense(f, params["age"]["kernel"], params["age"]["bias"])
    gender_logit = dense(f, params["gender"]["kernel"], params["gender"]["bias"])[:, 0]
    return age_logits, gender_logit


def _owner(excluded: frozenset) -> Callable[[Path], bool]:
    return lambda path: path[0] not in excluded


def make_optimizer(lr: float, freeze_backbone: bool, task: Optional[str] = None) -> Adam:
    """Per-task Adam with the reference's legacy-Keras decay
    ``lr/(1 + 1e-6·t)`` on its own count. ``task`` ('age' or 'gender'):
    the other task's head is not the optimizer's; with ``freeze_backbone``
    neither is the backbone."""
    excluded = {"age": {"gender"}, "gender": {"age"}}.get(task, set())
    if freeze_backbone:
        excluded = excluded | {"backbone"}
    return Adam(lr, ADAM_DECAY, select=_owner(frozenset(excluded)) if excluded else None)


def _l2_penalty(params: Dict, heads) -> torch.Tensor:
    """Keras ``l2(4e-5)`` adds ``4e-5·Σw²`` per regularized kernel to the
    loss; each reference task model holds ``feats`` and its own head's
    Dense (:178-181), never the other task's."""
    return L2_REG * sum(torch.sum(torch.square(params[h]["kernel"])) for h in heads)


def _task_loss(task: str, age_logits, gender_logit, labels):
    """(loss without the L2 term, accuracy): softmax cross-entropy over the
    age bins, or the sigmoid binary cross-entropy in optax's log-sigmoid
    form for gender."""
    if task == "age":
        ce = F.cross_entropy(age_logits, labels)
        acc = torch.mean((torch.argmax(age_logits, dim=-1) == labels).to(torch.float32))
        return ce, acc
    y = labels.to(torch.float32)
    bce = torch.mean(-y * F.logsigmoid(gender_logit) - (1.0 - y) * F.logsigmoid(-gender_logit))
    acc = torch.mean(((gender_logit > 0) == (labels > 0.5)).to(torch.float32))
    return bce, acc


def make_steps(age_optimizer: Adam, gender_optimizer: Optional[Adam] = None,
               bn_momentum: float = 0.99, freeze_backbone: bool = False,
               compute_dtype=torch.bfloat16, augment: Optional[AugmentConfig] = None):
    """(age_step, gender_step) over one shared param tree, each with its
    own optimizer and state: ``step(params, own_opt_state, generator,
    images, labels, masks=None) -> (params, opt_state, metrics)``, the same
    objects updated in place; ``metrics`` holds ``<task>_loss`` and
    ``<task>_acc`` as device scalars. ``generator`` (on the images' device)
    draws the warp when ``augment`` is set, then the dropout masks unless
    ``masks`` are given. With ``freeze_backbone`` the trunk runs
    inference-mode BN and its running statistics stay untouched (a frozen
    Keras base does not update BN moments). ``augment`` applies the
    reference's ImageDataGenerator policy (both its loops feed
    ``train_datagen``'s batches, ``age_gender_train.py:127-133``); None
    keeps the raw batch."""
    optimizers = {"age": age_optimizer, "gender": gender_optimizer or age_optimizer}

    def make(task: str):
        optimizer = optimizers[task]

        @precision_scope("highest")               # the forward and the backward
        def step(params, opt_state, generator, images, labels, masks=None):
            if augment is not None:
                images = augment_batch(generator, images, augment)
            if masks is None:
                masks = dropout_masks(generator, images.shape[0], params)
            age_logits, gender_logit, stats = forward(
                params, images, masks=masks, backbone_train=not freeze_backbone,
                compute_dtype=compute_dtype)
            loss, acc = _task_loss(task, age_logits, gender_logit, labels)
            loss = loss + _l2_penalty(params, ("feats", task))
            grads = torch.autograd.grad(loss, [t for _, t in optimizer.owned(params)])
            optimizer.update(params, list(grads), opt_state)
            if not freeze_backbone:
                update_bn_stats(params["backbone"], stats, momentum=bn_momentum)
            return params, opt_state, {f"{task}_loss": loss.detach(), f"{task}_acc": acc}

        return step

    return make("age"), make("gender")


class AgeGenderTrainer:
    """The reference's two-phase alternating trainer on ``device``.

    The backbone is ``backbone_params`` (a reference-layout numpy pytree,
    as a checkpoint of either package holds; its ``classifier`` is dropped)
    or He-normal from ``seed + 1``, the heads glorot-uniform from ``seed +
    2`` (both drawn on the CPU); the warp and the dropout masks draw from a
    generator on the device seeded with ``seed``. Starts frozen at
    ``cfg.learning_rate``; ``unfreeze`` starts the fine-tuning phase.
    ``compute_dtype`` is the backbone's activation type (bf16 by default,
    as the reference's)."""

    def __init__(self, backbone_params: Optional[Dict] = None, seed: int = 0,
                 cfg: Optional[TrainConfig] = None,
                 augment: Optional[AugmentConfig] = AugmentConfig(),
                 device="cuda", compute_dtype=torch.bfloat16):
        self.cfg = cfg or TrainConfig()
        self.device = resolve_device(device)
        self.augment = augment
        self.compute_dtype = compute_dtype
        if backbone_params is None:
            backbone = init_mobilenet_params(torch.Generator().manual_seed(seed + 1),
                                             device=self.device)
        else:
            backbone = to_torch({k: v for k, v in backbone_params.items()
                                 if k != "classifier"}, self.device)
        heads = init_head_params(torch.Generator().manual_seed(seed + 2),
                                 backbone_dim=backbone["pw13"]["kernel"].shape[0],
                                 device=self.device)
        self.params = {"backbone": backbone, **heads}
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._configure(self.cfg.learning_rate, freeze_backbone=True)

    def _configure(self, lr: float, freeze_backbone: bool) -> None:
        # one optimizer and state per task, fresh (count 0) in each phase
        self.age_optimizer = make_optimizer(lr, freeze_backbone, task="age")
        self.gender_optimizer = make_optimizer(lr, freeze_backbone, task="gender")
        self.age_opt_state = self.age_optimizer.init(self.params)
        self.gender_opt_state = self.gender_optimizer.init(self.params)
        self._age_step, self._gender_step = make_steps(
            self.age_optimizer, self.gender_optimizer, freeze_backbone=freeze_backbone,
            compute_dtype=self.compute_dtype, augment=self.augment)

    def unfreeze(self, lr: Optional[float] = None) -> None:
        """Phase 2: fine-tune the whole network (:249-269)."""
        self._configure(lr or self.cfg.finetune_learning_rate, freeze_backbone=False)

    def _input(self, images):
        return torch.as_tensor(images, dtype=torch.float32, device=self.device)

    def age_step(self, images, ages) -> Dict[str, torch.Tensor]:
        """One age step on (N, H, W, 3) float images and integer age bins."""
        y = torch.as_tensor(ages, device=self.device).to(torch.int64)
        return self._age_step(self.params, self.age_opt_state, self.generator,
                              self._input(images), y)[2]

    def gender_step(self, images, genders) -> Dict[str, torch.Tensor]:
        """One gender step on (N, H, W, 3) float images and 0/1 genders."""
        y = torch.as_tensor(genders, device=self.device).to(torch.float32)
        return self._gender_step(self.params, self.gender_opt_state, self.generator,
                                 self._input(images), y)[2]

    def train_alternating(self, age_batches: Iterator, gender_batches: Iterator,
                          steps: int) -> Dict[str, float]:
        """Interleave age and gender batches 1:1, age first (:194-232)."""
        metrics: Dict[str, torch.Tensor] = {}
        for s in range(steps):
            if s % 2 == 0:
                metrics.update(self.age_step(*next(age_batches)))
            else:
                metrics.update(self.gender_step(*next(gender_batches)))
        # one host read at the end, not one per step and metric
        return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))

    @torch.no_grad()
    def evaluate(self, images: np.ndarray, ages: np.ndarray, genders: np.ndarray,
                 batch_size: int = 64) -> Dict[str, float]:
        """Age-bin and gender accuracy of the inference forward."""
        age_ok = gender_ok = 0
        for i in range(0, len(images), batch_size):
            al, gl, _ = forward(self.params, self._input(images[i:i + batch_size]),
                                compute_dtype=self.compute_dtype)
            age_ok += int((torch.argmax(al, -1).cpu().numpy()
                           == np.asarray(ages[i:i + batch_size])).sum())
            gender_ok += int(((gl > 0).cpu().numpy()
                              == (np.asarray(genders[i:i + batch_size]) > 0.5)).sum())
        n = len(images)
        return {"age_acc": age_ok / n, "gender_acc": gender_ok / n}
