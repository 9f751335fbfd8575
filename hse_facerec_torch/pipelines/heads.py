"""Per-face analysis heads (counterpart of ``pipelines/heads.py``)."""

from __future__ import annotations

import torch

from ..models.multihead import expected_age_top_k, multihead_apply
from ..ops.preprocess import IMAGENET_MEANS_BGR
from ..params import to_torch


class MultiheadHeads:
    """One-model configuration: the shipped multi-head net.
    ``apply(crops) -> (ages, gender_prob, identity)`` over (N, S, S, 3)
    float32 RGB crops on ``device``."""

    identity_dim = 1024

    def __init__(self, params, device):
        self.device = torch.device(device)
        self.params = to_torch(params, self.device)
        self._means = torch.tensor(IMAGENET_MEANS_BGR, dtype=torch.float32,
                                   device=self.device)

    @torch.no_grad()
    def apply(self, crops):
        x = torch.flip(crops, dims=(-1,)) - self._means
        out = multihead_apply(self.params, x)
        ages = 1.0 + expected_age_top_k(out.age_probs, k=2)
        return ages, out.gender_prob, out.identity
