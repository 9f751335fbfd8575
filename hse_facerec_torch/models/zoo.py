"""Model zoo: paths of the reference weights and the named embedder
configurations (counterpart of ``hse_facerec_tf_tpu/models/zoo.py``).

Each entry is a declarative spec: parameters + forward + input size +
preprocessing (normalization scheme and resize flavor per the reference's
per-model settings), resolved into an ``EmbeddingExtractor``. An entry
whose trained weights are absent builds from seeded random ones, with a
``RuntimeWarning``, as the reference does; ``weights_origin`` says which.
``graph_extractor`` wraps any frozen pb. Every entry of the JAX package's
zoo is here. ``ModelSpec.model_fn(precision)``, ``build_extractor`` and
``graph_extractor`` take the reference's ``precision`` tier
(``numerics``); the int8 entries ignore it, as there.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import warnings
from typing import Callable, Dict, Optional, Tuple

REFERENCE_ROOT = "/root/reference"
MTCNN_PB = os.path.join(REFERENCE_ROOT, "age_gender_identity", "mtcnn.pb")
AGEGENDER_PB = os.path.join(REFERENCE_ROOT, "age_gender_identity",
                            "age_gender_tf2_new-01-0.14-0.92_quantized.pb")
VGG2_MOBILENET_H5 = os.path.join(REFERENCE_ROOT, "models", "vgg2_mobilenet.h5")
VGG2_MOBILENET_PB = os.path.join(REFERENCE_ROOT, "models", "vgg2_mobilenet.pb")
VGG2_RESNET_PB = os.path.join(REFERENCE_ROOT, "models", "vgg2_resnet.pb")
# keras_vggface ResNet-50 weights (rcmalli_vggface_tf_resnet50.h5 — the
# 'resnet50'/avg_pool extractor variant, facial_clustering_test.py:296-300).
VGGFACE_RESNET50_H5 = os.environ.get(
    "HSE_FACEREC_VGGFACE_RESNET50_H5",
    os.path.join(REFERENCE_ROOT, "models", "rcmalli_vggface_tf_resnet50.h5"))
# ArcFace r100 checkpoint as an .npz of flat MXNet param names (the MXNet
# blob itself lives outside the repo — insightface_face_embedding.py:24).
ARCFACE_NPZ = os.environ.get(
    "HSE_FACEREC_ARCFACE_NPZ",
    os.path.join(REFERENCE_ROOT, "models", "arcface_r100.npz"))
# arcface_torch's ViT-L, trained on WebFace42M: a PyTorch checkpoint that
# the port does not import yet, so the entry always builds seeded weights.
VIT_L_CHECKPOINT = "arcface_torch's WebFace42M vit_l checkpoint (not imported)"
# A Swin-T face embedder (SwinFace's 2x2 stem on the 112² crop): no trained
# weights are in the repository, so the entry always builds seeded weights.
SWIN_T_CHECKPOINT = "a trained Swin-T face checkpoint (not in the repository)"
# keras_vggface VGG16 weights (rcmalli_vggface_tf_vgg16.h5 — external blob,
# downloaded by keras_vggface in the reference's environment).
VGGFACE_VGG16_H5 = os.environ.get(
    "HSE_FACEREC_VGGFACE16_H5",
    os.path.join(REFERENCE_ROOT, "models", "rcmalli_vggface_tf_vgg16.h5"))


@dataclasses.dataclass
class ModelSpec:
    name: str
    input_size: Tuple[int, int]
    normalization: str       # ops.preprocess.NORMALIZERS key
    resize_method: str
    embedding_dim: int
    build_params: Callable[[], Dict]   # numpy params in the reference's layouts
    model_fn_factory: Callable         # precision -> f(torch params, x NHWC) -> (N, D)
    # extra EmbeddingExtractor options (flip_tta, l2_normalize_output,
    # convert for a pytree that is not of layer dicts, ...)
    extractor_kwargs: Dict = dataclasses.field(default_factory=dict)

    def model_fn(self, precision="highest") -> Callable:
        """The entry's forward ``f(params, x)`` at ``precision``'s tier."""
        return self.model_fn_factory(precision)


def _at(forward):
    """The factory of ``forward(params, x, precision=...)`` at a tier."""
    return lambda precision="highest": functools.partial(forward, precision=precision)


def _untiered(forward):
    """A factory whose forward ignores the tier (the int8 entries: the
    dial does not apply to the int8 path)."""
    return lambda precision="highest": forward


def _multihead_identity(params, x, precision="highest"):
    from .multihead import multihead_apply

    return multihead_apply(params, x, precision=precision).identity


def _multihead_identity_int8(params, x):
    from .int8_infer import multihead_apply_int8

    return multihead_apply_int8(params, x).identity


def _agegender_params():
    from .multihead import import_multihead_params

    return import_multihead_params(AGEGENDER_PB)


def _agegender_int8_params():
    from .int8_infer import quantize_multihead_int8

    return quantize_multihead_int8(_agegender_params())


def _mobilenet_embed(params, x, precision="highest"):
    from .mobilenet import mobilenet_embed

    return mobilenet_embed(params, x, precision=precision)


def _mobilenet_embed_int8(params, x):
    from .int8_infer import mobilenet_embed_int8

    return mobilenet_embed_int8(params, x)


def _arcface_embed(params, x, precision="highest"):
    from .arcface import iresnet_embed

    return iresnet_embed(params, x, precision=precision)


def _vit_embed(params, x, precision="highest"):
    from .vit import vit_embed

    return vit_embed(params, x, precision=precision)


def _swin_embed(params, x, precision="highest"):
    from .swin import swin_embed

    return swin_embed(params, x, precision=precision)


def _vgg16_embed(params, x, precision="highest"):
    from .vgg16 import vgg16_embed

    return vgg16_embed(params, x, precision=precision)


def _resnet_embed(params, x, precision="highest"):
    from .resnet import resnet50_embed

    return resnet50_embed(params, x, precision=precision)


def _warn_random_init(name: str, missing_path: str) -> None:
    warnings.warn(
        f"model {name!r}: trained weights not found at {missing_path} "
        "(a blob the reference obtains externally) — using RANDOM "
        "initialization. Embeddings will be meaningless for recognition; "
        "provide the weight file or pick a model with shipped weights "
        "(e.g. 'agegender_identity').", RuntimeWarning, stacklevel=3)


def _seed0():
    import torch

    return torch.Generator().manual_seed(0)


def _seeded(init_fn):
    """numpy params (reference layouts) from ``init_fn`` at seed 0: random
    weights are host data, made on the CPU whatever the entry's device."""
    from ..params import to_numpy

    return to_numpy(init_fn(_seed0(), device="cpu"))


def _vgg2_mobilenet_params():
    """vgg2_mobilenet weights: the Keras ``.h5`` if present, else the frozen
    ``.pb`` via the structural importer (the reference consumes the pb form
    directly, ``facerec_test.py:212``; both blobs are missing upstream).
    Falls back to seeded random weights, with a warning."""
    if os.path.exists(VGG2_MOBILENET_H5):
        from ..core.h5_import import mobilenet_params_from_h5

        return mobilenet_params_from_h5(VGG2_MOBILENET_H5)
    if os.path.exists(VGG2_MOBILENET_PB):
        from ..core.pb_import import mobilenet_params_from_pb

        return mobilenet_params_from_pb(VGG2_MOBILENET_PB)
    from .mobilenet import init_mobilenet_params

    _warn_random_init("vgg2_mobilenet", VGG2_MOBILENET_H5)
    return _seeded(init_mobilenet_params)


def _vgg2_mobilenet_int8_params():
    from .int8_infer import quantize_backbone_int8

    return quantize_backbone_int8(_vgg2_mobilenet_params())


def _vgg2_resnet_params():
    """vgg2_resnet.pb (reference ``facerec_test.py:213``; missing upstream)
    via the structural frozen-pb importer; seeded random weights otherwise."""
    if os.path.exists(VGG2_RESNET_PB):
        from ..core.pb_import import resnet50_params_from_pb

        return resnet50_params_from_pb(VGG2_RESNET_PB)
    from .resnet import init_resnet50_params

    _warn_random_init("vgg2_resnet", VGG2_RESNET_PB)
    return _seeded(init_resnet50_params)


def _vggface_resnet50_params():
    from .resnet import init_resnet50_params, resnet50_params_from_h5

    if os.path.exists(VGGFACE_RESNET50_H5):
        return resnet50_params_from_h5(VGGFACE_RESNET50_H5)
    _warn_random_init("vggface_resnet50", VGGFACE_RESNET50_H5)
    return _seeded(init_resnet50_params)


def _arcface_params():
    from .arcface import init_iresnet_params, iresnet_params_from_npz

    if os.path.exists(ARCFACE_NPZ):
        return iresnet_params_from_npz(ARCFACE_NPZ)
    _warn_random_init("insightface_arcface", ARCFACE_NPZ)
    return init_iresnet_params(_seed0(), depth=100)   # numpy already


def _vit_l_params():
    """Seeded in the source's initialisation: no trained ViT-L weights are
    in the repository, nor an importer of the checkpoint."""
    from .vit import VIT_L, init_vit_params

    _warn_random_init("insightface_vit_l", VIT_L_CHECKPOINT)
    return init_vit_params(_seed0(), **VIT_L)


def _vit_to_torch(params, device):
    from .vit import to_torch

    return to_torch(params, device)


def _swin_t_params():
    """Seeded in the source's initialisation: no trained Swin-T face
    weights are in the repository."""
    from .swin import SWIN_T, init_swin_params

    _warn_random_init("swin_t_face", SWIN_T_CHECKPOINT)
    return init_swin_params(_seed0(), **SWIN_T)


def _swin_to_torch(params, device):
    from .swin import to_torch

    return to_torch(params, device)


def _vgg16_params():
    from .vgg16 import init_vgg16_params, vgg16_params_from_h5

    if os.path.exists(VGGFACE_VGG16_H5):
        return vgg16_params_from_h5(VGGFACE_VGG16_H5)
    _warn_random_init("vggface_vgg16", VGGFACE_VGG16_H5)
    return init_vgg16_params(_seed0())                 # numpy already


def _tree_to_torch(params, device):
    from ..params import tree_to_torch

    return tree_to_torch(params, device)


MODEL_ZOO: Dict[str, ModelSpec] = {
    # multi-head identity tap: the reference's default age/gender/id model
    # (facial_analysis.py:29-33, facerec_test.py:210 commented variant)
    "agegender_identity": ModelSpec(
        "agegender_identity", (224, 224), "caffe", "cv2_linear", 1024,
        _agegender_params, _at(_multihead_identity)),
    # MobileNet-192 VGGFace2 embedder (facerec_test.py:212: convert2BGR=True,
    # imageNetUtilsMean=True)
    "vgg2_mobilenet": ModelSpec(
        "vgg2_mobilenet", (192, 192), "caffe", "pil_bilinear", 1024,
        _vgg2_mobilenet_params, _at(_mobilenet_embed)),
    # ResNet-50 VGGFace2 embedder (facerec_test.py:213: VGGFace2 means)
    "vgg2_resnet": ModelSpec(
        "vgg2_resnet", (224, 224), "vggface2", "pil_bilinear", 2048,
        _vgg2_resnet_params, _at(_resnet_embed)),
    # InsightFace ArcFace-r100 112² embedder (insightface_face_embedding.py:
    # 20-63): raw 0-255 RGB in (the model scales internally), L2-normalized
    # output; flip-TTA off (reference self.flip=0, :23)
    "insightface_arcface": ModelSpec(
        "insightface_arcface", (112, 112), "none", "cv2_linear", 512,
        _arcface_params, _at(_arcface_embed),
        extractor_kwargs={"l2_normalize_output": True, "convert": _tree_to_torch}),
    # InsightFace arcface_torch ViT-L (backbones/vit.py, get_model("vit_l")):
    # 112² RGB 0-255 in (the model scales it), 144 tokens of 768, 24 blocks,
    # 8 heads on K5; L2-normalized 512-d output, no flip-TTA
    "insightface_vit_l": ModelSpec(
        "insightface_vit_l", (112, 112), "none", "cv2_linear", 512,
        _vit_l_params, _at(_vit_embed),
        extractor_kwargs={"l2_normalize_output": True, "convert": _vit_to_torch}),
    # Swin-T (microsoft/Swin-Transformer) with SwinFace's 2x2 stem: 112² RGB
    # 0-255 in (the model scales it), 56² tokens of 96, stages of (2, 2, 6,
    # 2) blocks, shifted-window attention on K8; L2-normalized 512-d output
    "swin_t_face": ModelSpec(
        "swin_t_face", (112, 112), "none", "cv2_linear", 512,
        _swin_t_params, _at(_swin_embed),
        extractor_kwargs={"l2_normalize_output": True, "convert": _swin_to_torch}),
    # the int8 serving variants (models/int8_infer.py, pointwise layers on
    # K4); same preprocessing and protocols as their f32 bases
    "agegender_identity_int8": ModelSpec(
        "agegender_identity_int8", (224, 224), "caffe", "cv2_linear", 1024,
        _agegender_int8_params, _untiered(_multihead_identity_int8)),
    "vgg2_mobilenet_int8": ModelSpec(
        "vgg2_mobilenet_int8", (192, 192), "caffe", "pil_bilinear", 1024,
        _vgg2_mobilenet_int8_params, _untiered(_mobilenet_embed_int8)),
    # keras_vggface VGG16, fc7/relu tap (facerec_test.py:344-349,
    # facial_clustering_test.py:295-300): Keras load_img resizes with PIL
    # NEAREST (its default interpolation), preprocess_input v1 means
    "vggface_vgg16": ModelSpec(
        "vggface_vgg16", (224, 224), "vggface1", "pil_nearest", 4096,
        _vgg16_params, _at(_vgg16_embed)),
    # keras_vggface ResNet-50, avg_pool tap (facial_clustering_test.py:
    # 296-300: layers={'resnet50': 'avg_pool'}): Keras load_img resizes with
    # PIL NEAREST (its default interpolation), preprocess_input with its
    # default version=1 means (the reference passes no version arg)
    "vggface_resnet50": ModelSpec(
        "vggface_resnet50", (224, 224), "vggface1", "pil_nearest", 2048,
        _vggface_resnet50_params, _at(_resnet_embed)),
}


# the shipped weights, without which an entry does not build
_WEIGHT_FILES = {"agegender_identity": AGEGENDER_PB}


def weights_origin(name: str) -> str:
    """Where an entry's weights come from on this machine: 'imported' when
    the trained reference file is here; for the shipped multi-head pb
    'missing' when absent (building it then fails), for the entries whose
    blobs the reference obtains externally 'random' (building falls back
    to seeded random weights). The int8 variants share their f32 base's
    file."""
    if name.endswith("_int8"):
        name = name[: -len("_int8")]
    if name in _WEIGHT_FILES:
        return "imported" if os.path.exists(_WEIGHT_FILES[name]) else "missing"
    files = {"vgg2_mobilenet": (VGG2_MOBILENET_H5, VGG2_MOBILENET_PB),
             "vgg2_resnet": (VGG2_RESNET_PB,),
             "vggface_resnet50": (VGGFACE_RESNET50_H5,),
             "insightface_arcface": (ARCFACE_NPZ,),
             "vggface_vgg16": (VGGFACE_VGG16_H5,),
             "insightface_vit_l": (),
             "swin_t_face": ()}[name]
    return "imported" if any(os.path.exists(f) for f in files) else "random"


def build_extractor(name: str, batch_size: int = 64, device="cuda",
                    params: Optional[Dict] = None, mesh=None, precision="highest",
                    timer=None):
    """The zoo entry as an ``EmbeddingExtractor`` on ``device``, or over
    ``mesh`` (params replicated, batches split), its forward at
    ``precision``'s tier. ``params``
    (numpy, the layouts ``build_params`` returns: quantized for the int8
    entries) replaces the entry's weights, e.g. with seeded random weights
    where the file is absent. ``timer``: a ``StageTimer`` that takes the
    extractor's spans and counters (None records nothing)."""
    from ..pipelines.embedder import EmbeddingExtractor

    spec = MODEL_ZOO[name]
    return EmbeddingExtractor(spec.model_fn(precision),
                              spec.build_params() if params is None else params,
                              spec.input_size,
                              normalization=spec.normalization,
                              resize_method=spec.resize_method,
                              batch_size=batch_size, device=device, mesh=mesh,
                              timer=timer, **spec.extractor_kwargs)


def graph_extractor(pb_path: str, input_tensor: str, output_tensor: str,
                    input_size, normalization: str = "caffe",
                    resize_method: str = "pil_bilinear", batch_size: int = 64,
                    device="cuda", extra_feeds: Optional[Dict[str, object]] = None,
                    mesh=None, precision="highest"):
    """Generic frozen-pb embedder: ANY TF frozen graph as an
    ``EmbeddingExtractor`` on ``device`` (or over ``mesh``), the general form of the
    reference's ``TensorFlowInference`` model rows (``facerec_test.py:
    209-218``: FaceNet, InsightFace, custom pbs, each selected by a (pb,
    input, output, preprocessing) tuple). The graph runs through
    ``core/graph_compiler.py`` at ``precision``'s tier; its constants move
    to the device once.

    extra_feeds: {tensor: value} pinned when the graph is compiled — the
    reference's ``learning_phase_tensor``/``additional_input_value``
    convention (``facerec_test.py:215-216``: FaceNet feeds
    ``phase_train:0 = False``, insightface.pb feeds ``dropout_rate:0 =
    0.9``)."""
    from ..core.graph_compiler import compile_pb
    from ..pipelines.embedder import EmbeddingExtractor

    cg = compile_pb(pb_path, [output_tensor], precision=precision,
                    const_feeds=extra_feeds)
    in_name = input_tensor.split(":")[0]

    def model_fn(graph_params, x):
        (out,) = cg.fn(graph_params, {in_name: x})
        return out.reshape(out.shape[0], -1)

    # the graph's constants, not a layer tree, are the params it places
    return EmbeddingExtractor(model_fn, cg, input_size,
                              normalization=normalization,
                              resize_method=resize_method,
                              batch_size=batch_size, device=device,
                              convert=lambda g, dev: g.torch_params(dev), mesh=mesh)
