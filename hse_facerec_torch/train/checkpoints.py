"""Checkpointing: save-best, early stopping, pytree (de)serialization.

The reference's training loops rely on Keras ``ModelCheckpoint(save_best_only,
monitor=val_acc)`` + ``EarlyStopping(patience=2)``
(``facerec_keras_train.py:205-208``) and manual best-val saves with templated
filenames (``age_gender_train.py:225-237``). The port's own copy of
``hse_facerec_tf_tpu/train/checkpoints.py``: the same behaviors over param
trees in a plain .npz container (no pickle). Torch tensors are saved
through ``params.to_numpy``, so a checkpoint holds the reference's keys and
layouts and loads into either package."""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

from ..params import to_numpy


def flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    """A nested tree's leaves as numpy arrays under "a/b/c" keys."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def save_pytree(tree, path: str) -> None:
    np.savez(path if path.endswith(".npz") else path + ".npz",
             **flatten(to_numpy(tree)))


def load_pytree(path: str) -> Dict:
    """Rebuild the nested dict (list/tuple nodes come back as dicts with
    integer-string keys)."""
    if not path.endswith(".npz"):
        path += ".npz"
    flat = dict(np.load(path))
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


class BestCheckpoint:
    """save_best_only + early stopping, Keras-style.

    ``update(metric, params)`` returns True while training should continue."""

    def __init__(self, directory: str, name: str = "model", mode: str = "max",
                 patience: Optional[int] = None):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.name = name
        self.mode = mode
        self.patience = patience
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.best_path: Optional[str] = None

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        return metric > self.best if self.mode == "max" else metric < self.best

    def update(self, metric: float, params, epoch: int = 0) -> bool:
        if self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
            # templated filename like the reference's '%d-%.2f' saves
            self.best_path = os.path.join(
                self.directory, f"{self.name}-{epoch:02d}-{metric:.4f}.npz")
            save_pytree(params, self.best_path)
        else:
            self.bad_epochs += 1
        return self.patience is None or self.bad_epochs < self.patience

    def load_best(self) -> Dict:
        assert self.best_path is not None, "no checkpoint saved yet"
        return load_pytree(self.best_path)
