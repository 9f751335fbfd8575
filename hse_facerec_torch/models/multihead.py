"""Multi-head age/gender/identity network on the MobileNet-V1 backbone.

Counterpart of ``hse_facerec_tf_tpu/models/multihead.py``: backbone → GAP
(the 1024-d identity) → Dense-256 relu (``feats``) → ``age`` Dense-100
softmax and ``gender`` Dense-1 sigmoid.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core.graphdef import extract_constants, load_graphdef
from ..numerics import precision_scope, top_k
from .layers import dense, global_avg_pool
from .mobilenet import MOBILENET_V1_BLOCKS, mobilenet_v1_backbone


class MultiHeadOutput(NamedTuple):
    age_probs: torch.Tensor      # (N, 100) softmax over integer ages
    gender_prob: torch.Tensor    # (N,) P(male)
    identity: torch.Tensor       # (N, 1024) GAP embedding
    feats: torch.Tensor          # (N, 256) shared head representation


def multihead_apply(params: Dict, x, compute_dtype=torch.float32, *,
                    precision="highest", bf16_blocks_below: int = 0) -> MultiHeadOutput:
    """x: (N, H, W, 3) preprocessed (BGR, ImageNet means subtracted).

    The backbone runs in ``compute_dtype`` (``torch.bfloat16``: the bf16
    inference tier of the reference's ``compute_dtype``), its blocks below
    ``bf16_blocks_below`` in bf16 (``mobilenet_v1_backbone``); the pooled
    identity is cast to float32 and the heads run in float32. Every layer
    runs at ``precision``'s tier."""
    with precision_scope(precision):
        h = mobilenet_v1_backbone(params["backbone"], x, precision=precision,
                                  compute_dtype=compute_dtype,
                                  bf16_blocks_below=bf16_blocks_below)
        # == global_pooling/Mean
        identity = global_avg_pool(h.permute(0, 3, 1, 2)).to(torch.float32)
        f = torch.relu(dense(identity, params["feats"]["kernel"],
                             params["feats"]["bias"]))
        age_logits = dense(f, params["age"]["kernel"], params["age"]["bias"])
        gender_logit = dense(f, params["gender"]["kernel"], params["gender"]["bias"])
    return MultiHeadOutput(
        age_probs=torch.softmax(age_logits, dim=-1),
        gender_prob=torch.sigmoid(gender_logit)[:, 0],
        identity=identity,
        feats=f,
    )


def expected_age_top_k(age_probs, k: int = 2):
    """Expectation over the top-k softmax bins, renormalized (reference
    ``facial_analysis.py:119-124``); ties keep the lowest bin first."""
    probs, idx = top_k(age_probs, k)
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    return torch.sum(probs * idx.to(age_probs.dtype), dim=-1)


def import_multihead_params(pb_path: str) -> Dict:
    """numpy params (reference layouts) from the frozen multi-head pb, with
    the graph's BN artifacts folded: the depthwise BN ``Mul`` scale goes into
    the depthwise kernel and every ``Add`` offset becomes a bias."""
    consts = extract_constants(load_graphdef(pb_path))

    def find(name: str) -> np.ndarray:
        # weight consts appear as '<name>/read/...' or constant-folded aliases
        if name in consts:
            return consts[name]
        matches = [k for k in consts if k == name or k.startswith(name + "/")]
        if not matches:
            raise KeyError(name)
        return consts[sorted(matches, key=len)[0]]

    backbone: Dict[str, Dict] = {
        "conv1": {
            "kernel": np.asarray(find("conv1/kernel")),
            "bias": np.asarray(find("conv1_bn/batchnorm_1/sub")).reshape(-1),
        }
    }
    for i, _ in enumerate(MOBILENET_V1_BLOCKS, start=1):
        dw_kernel = np.asarray(find(f"conv_dw_{i}/depthwise_kernel"), np.float32)
        dw_scale = np.asarray(find(f"conv_dw_{i}_bn/batchnorm_1/mul"),
                              np.float32).reshape(-1)
        dw_bias = np.asarray(find(f"conv_dw_{i}_bn/batchnorm_1/sub"),
                             np.float32).reshape(-1)
        backbone[f"dw{i}"] = {
            "kernel": dw_kernel * dw_scale[None, None, :, None],
            "bias": dw_bias,
        }
        backbone[f"pw{i}"] = {
            "kernel": np.asarray(find(f"conv_pw_{i}/kernel")),
            "bias": np.asarray(find(f"conv_pw_{i}_bn/batchnorm_1/sub")).reshape(-1),
        }

    def head(name):
        return {
            "kernel": np.asarray(find(f"{name}/kernel")),
            "bias": np.asarray(find(f"{name}/bias")).reshape(-1),
        }

    return {
        "backbone": backbone,
        "feats": head("feats"),
        "age": head("age_pred"),
        "gender": head("gender_pred"),
    }


def is_male(gender_prob, threshold: float = 0.6):
    """Gender decision threshold (reference ``facial_analysis.py:76-81``)."""
    return gender_prob >= threshold
