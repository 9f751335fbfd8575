"""Per-face analysis heads (counterpart of ``pipelines/heads.py``)."""

from __future__ import annotations

import torch

from ..models.int8_infer import (is_quantized, multihead_apply_int8,
                                 quantize_multihead_int8)
from ..models.multihead import expected_age_top_k, multihead_apply
from ..ops.preprocess import IMAGENET_MEANS_BGR
from ..params import to_torch


class MultiheadHeads:
    """One-model configuration: the shipped multi-head net.
    ``apply(crops) -> (ages, gender_prob, identity)`` over (N, S, S, 3)
    float32 RGB crops on ``device``."""

    identity_dim = 1024
    forward = staticmethod(multihead_apply)

    def __init__(self, params, device):
        self.device = torch.device(device)
        self.params = to_torch(params, self.device)
        self._means = torch.tensor(IMAGENET_MEANS_BGR, dtype=torch.float32,
                                   device=self.device)

    @torch.no_grad()
    def apply(self, crops):
        x = torch.flip(crops, dims=(-1,)) - self._means
        out = self.forward(self.params, x)
        ages = 1.0 + expected_age_top_k(out.age_probs, k=2)
        return ages, out.gender_prob, out.identity


class Int8MultiheadHeads(MultiheadHeads):
    """The one-model configuration on the full-int8 serving path
    (``models/int8_infer.py``, pointwise layers on K4). ``params`` are raw
    multi-head params, quantized here, or an already quantized pytree.
    Same per-face semantics as ``MultiheadHeads``."""

    forward = staticmethod(multihead_apply_int8)

    def __init__(self, params, device):
        super().__init__(params if is_quantized(params)
                         else quantize_multihead_int8(params), device)
