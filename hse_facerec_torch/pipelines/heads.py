"""Per-face analysis heads (counterpart of ``pipelines/heads.py``): the
one-model multi-head net, f32 or int8, and the two-model configuration of
separate frozen age and gender graphs."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.int8_infer import (is_quantized, multihead_apply_int8,
                                 quantize_multihead_int8)
from ..models.multihead import expected_age_top_k, multihead_apply
from ..numerics import fp32_precision
from ..ops.preprocess import IMAGENET_MEANS_BGR
from ..ops.resize import resize
from ..params import to_torch


class MultiheadHeads:
    """One-model configuration: the shipped multi-head net.
    ``apply(crops) -> (ages, gender_prob, identity)`` over (N, S, S, 3)
    float32 RGB crops on ``device``, the net at ``precision``'s tier
    ("highest" by default; the reference's HIGH is f32-exact only on its
    chip)."""

    identity_dim = 1024

    def __init__(self, params, device, precision="highest"):
        fp32_precision(precision)                 # refuse an unknown tier now
        self.device = torch.device(device)
        self.params = to_torch(params, self.device)
        self.precision = precision
        self._means = torch.tensor(IMAGENET_MEANS_BGR, dtype=torch.float32,
                                   device=self.device)

    def forward(self, params, x):
        return multihead_apply(params, x, precision=self.precision)

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
    Same per-face semantics as ``MultiheadHeads``. It takes no
    ``precision``: the dial does not apply to the int8 path, as in the
    reference (its float convs run "highest")."""

    def __init__(self, params, device):
        super().__init__(params if is_quantized(params)
                         else quantize_multihead_int8(params), device)

    def forward(self, params, x):
        return multihead_apply_int8(params, x)


def _placeholder_hw(graph, name: str) -> Optional[Tuple[int, int]]:
    """(H, W) from a placeholder's shape attr, or None if dynamic."""
    node = graph.by_name[name]
    shape = node.attrs.get("shape")
    if shape is None or shape.shape is None or len(shape.shape) != 4:
        return None
    h, w = shape.shape[1], shape.shape[2]
    if h is None or w is None or h <= 0 or w <= 0:
        return None
    return int(h), int(w)


class TwoModelHeads:
    """Two-model configuration: separate frozen age and gender graphs
    (reference ``load_gender``/``load_age``, ``facial_analysis.py:132-208``),
    each compiled by ``core/graph_compiler.py`` with its constants on
    ``device``. Per model: the input size read from its placeholder
    ((224, 224) when dynamic), a cv2-linear resize only when the crop size
    differs, BGR + Caffe means. Age = 1 + the renormalized top-2
    expectation of the softmax tap; gender = the sigmoid tap, or with
    ``sota`` the ``data``/``prob`` taps and the hard decision P(male) > 0.5
    as 0.0/1.0. No identity features (reference :284): identity is (n, 0).
    Both graphs run at ``precision``'s tier ("highest" by default, as in
    the reference); the crop resize stays "highest", as there.
    """

    identity_dim = 0

    def __init__(self, age_pb: str, gender_pb: str, device="cuda", *,
                 age_input: str = "input_1",
                 age_output: str = "predictions/Softmax",
                 gender_input: str = "input_1",
                 gender_output: str = "predictions/Sigmoid",
                 sota: bool = False, precision="highest"):
        from ..core.graph_compiler import compile_pb

        if sota:
            # use_sota taps (reference :144-146,173-175)
            age_input, age_output = "data", "prob"
            gender_input, gender_output = "data", "prob"
        self.sota = sota
        self.device = torch.device(device)
        self.precision = precision
        self._age = compile_pb(age_pb, [age_output], precision=precision)
        self._gender = compile_pb(gender_pb, [gender_output], precision=precision)
        self._age_in = age_input.split(":")[0]
        self._gender_in = gender_input.split(":")[0]
        self.age_hw = _placeholder_hw(self._age.graph, self._age_in) or (224, 224)
        self.gender_hw = _placeholder_hw(self._gender.graph, self._gender_in) or (224, 224)
        self.params = {"age": self._age.torch_params(self.device),
                       "gender": self._gender.torch_params(self.device)}
        self._means = torch.tensor(IMAGENET_MEANS_BGR, dtype=torch.float32,
                                   device=self.device)

    def _preprocess(self, crops, hw):
        x = crops
        if (int(x.shape[-3]), int(x.shape[-2])) != tuple(hw):
            x = resize(x, hw, "cv2_linear")
        return torch.flip(x, dims=(-1,)) - self._means   # Caffe means either way (:148-151)

    @torch.no_grad()
    def apply(self, crops):
        n = crops.shape[0]
        (age_preds,) = self._age.fn(
            self.params["age"], {self._age_in: self._preprocess(crops, self.age_hw)})
        ages = 1.0 + expected_age_top_k(age_preds.reshape(n, -1), k=2)
        (gender_preds,) = self._gender.fn(
            self.params["gender"],
            {self._gender_in: self._preprocess(crops, self.gender_hw)})
        gender_preds = gender_preds.reshape(n, -1)
        if self.sota:
            # softmax [female, male]; is_male = preds[1] > 0.5 (:78-79). The
            # HARD decision as 0.0/1.0: consumers threshold gender_prob at
            # the one-model path's 0.6, which would misread probs in [0.5, 0.6)
            gender_prob = (gender_preds[:, 1] > 0.5).to(torch.float32)
        else:
            gender_prob = gender_preds[:, 0]
        identity = torch.zeros((n, 0), dtype=torch.float32, device=crops.device)
        return ages, gender_prob, identity
