"""Model zoo: paths of the shipped reference weights and the named embedder
configurations (counterpart of ``hse_facerec_tf_tpu/models/zoo.py``).

Each entry is a declarative spec: parameters + forward + input size +
preprocessing (normalization scheme and resize flavor per the reference's
per-model settings), resolved into an ``EmbeddingExtractor``. Only the
entries whose backbone the port has are here; the others are listed in
``ROADMAP.md``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

REFERENCE_ROOT = "/root/reference"
MTCNN_PB = os.path.join(REFERENCE_ROOT, "age_gender_identity", "mtcnn.pb")
AGEGENDER_PB = os.path.join(REFERENCE_ROOT, "age_gender_identity",
                            "age_gender_tf2_new-01-0.14-0.92_quantized.pb")


@dataclasses.dataclass
class ModelSpec:
    name: str
    input_size: Tuple[int, int]
    normalization: str       # ops.preprocess.NORMALIZERS key
    resize_method: str
    embedding_dim: int
    build_params: Callable[[], Dict]   # numpy params in the reference's layouts
    model_fn: Callable                 # f(torch params, x NHWC) -> (N, D)
    # extra EmbeddingExtractor options (flip_tta, l2_normalize_output, ...)
    extractor_kwargs: Dict = dataclasses.field(default_factory=dict)


def _multihead_identity(params, x):
    from .multihead import multihead_apply

    return multihead_apply(params, x).identity


def _multihead_identity_int8(params, x):
    from .int8_infer import multihead_apply_int8

    return multihead_apply_int8(params, x).identity


def _agegender_params():
    from .multihead import import_multihead_params

    return import_multihead_params(AGEGENDER_PB)


def _agegender_int8_params():
    from .int8_infer import quantize_multihead_int8

    return quantize_multihead_int8(_agegender_params())


MODEL_ZOO: Dict[str, ModelSpec] = {
    # multi-head identity tap: the reference's default age/gender/id model
    # (facial_analysis.py:29-33, facerec_test.py:210 commented variant)
    "agegender_identity": ModelSpec(
        "agegender_identity", (224, 224), "caffe", "cv2_linear", 1024,
        _agegender_params, _multihead_identity),
    # the same model on the full-int8 serving path (models/int8_infer.py,
    # pointwise layers on K4); same preprocessing and protocols
    "agegender_identity_int8": ModelSpec(
        "agegender_identity_int8", (224, 224), "caffe", "cv2_linear", 1024,
        _agegender_int8_params, _multihead_identity_int8),
}

_WEIGHT_FILES = {"agegender_identity": AGEGENDER_PB}


def weights_origin(name: str) -> str:
    """'imported' if the entry's trained reference weights are on this
    machine, 'missing' if not (building it would then fail). The int8
    variants share their f32 base's file."""
    if name.endswith("_int8"):
        name = name[: -len("_int8")]
    return "imported" if os.path.exists(_WEIGHT_FILES[name]) else "missing"


def build_extractor(name: str, batch_size: int = 64, device="cuda",
                    params: Optional[Dict] = None):
    """The zoo entry as an ``EmbeddingExtractor`` on ``device``. ``params``
    (numpy, the layouts ``build_params`` returns: quantized for the int8
    entries) replaces the entry's weights, e.g. with seeded random weights
    where the file is absent."""
    from ..pipelines.embedder import EmbeddingExtractor

    spec = MODEL_ZOO[name]
    return EmbeddingExtractor(spec.model_fn,
                              spec.build_params() if params is None else params,
                              spec.input_size,
                              normalization=spec.normalization,
                              resize_method=spec.resize_method,
                              batch_size=batch_size, device=device,
                              **spec.extractor_kwargs)
