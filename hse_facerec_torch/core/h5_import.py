"""Keras .h5 weight import/export → numpy param pytrees.

Counterpart of ``hse_facerec_tf_tpu/core/h5_import.py``. Replaces the
reference's Keras ``load_weights``/``save`` plumbing
(``facerec_keras_train.py:95-142`` conversion utilities; the absent
``models/vgg2_mobilenet.h5``) without TensorFlow/Keras: the HDF5 weight
layout is read directly (group per layer, ``weight_names`` attrs) and the
standard Keras MobileNet / multi-head layer names map onto the param
pytrees, in the reference's numpy layouts (``params.to_torch`` takes them
to a device). The exporter writes the same layout back.

``h5py`` is imported inside the functions: the card's machine has none.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..models.mobilenet import MOBILENET_V1_BLOCKS


def _f32(a) -> np.ndarray:
    """A weight as the reference holds it: float32 (JAX runs without 64-bit
    types)."""
    return np.asarray(a, np.float32)


def load_keras_h5(path: str) -> Dict[str, np.ndarray]:
    """Flat {'<layer>/<weight>': array} dict from a Keras-layout h5 file."""
    import h5py

    out: Dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name.split(":")[0]] = np.asarray(obj)

        root.visititems(visit)
    # keys look like '<layer>/<layer>/<weight>' (keras nests the layer name
    # twice) or '<layer>/<weight>'; layer names may themselves contain '/'
    # (keras_vggface: 'conv1/7x7_s2/bn'), so try every split point where the
    # doubled prefix matches and drop the longest one
    normalized = {}
    for k, v in out.items():
        parts = [p for p in k.split("/") if p]
        for n in range((len(parts) - 1) // 2, 0, -1):
            if parts[:n] == parts[n:2 * n]:
                parts = parts[n:]
                break
        normalized["/".join(parts)] = v
    return normalized


def _bn(weights: Dict[str, np.ndarray], layer: str) -> Dict[str, np.ndarray]:
    return {
        "gamma": _f32(weights[f"{layer}/gamma"]),
        "beta": _f32(weights[f"{layer}/beta"]),
        "mean": _f32(weights[f"{layer}/moving_mean"]),
        "var": _f32(weights[f"{layer}/moving_variance"]),
    }


def mobilenet_params_from_h5(path: str, n_classes: Optional[int] = None,
                             classifier_layer: str = "preds") -> Dict:
    """Keras MobileNet-V1 (alpha=1.0) h5 → mobilenet param pytree (BN form).

    Matches the architecture the reference trains in
    ``facerec_keras_train.py:46-57`` (MobileNet base + GAP + softmax Dense)."""
    w = load_keras_h5(path)
    params: Dict = {
        "conv1": {"kernel": _f32(w["conv1/kernel"]), "bn": _bn(w, "conv1_bn")},
    }
    for i, _ in enumerate(MOBILENET_V1_BLOCKS, start=1):
        params[f"dw{i}"] = {
            "kernel": _f32(w[f"conv_dw_{i}/depthwise_kernel"]),
            "bn": _bn(w, f"conv_dw_{i}_bn"),
        }
        params[f"pw{i}"] = {
            "kernel": _f32(w[f"conv_pw_{i}/kernel"]),
            "bn": _bn(w, f"conv_pw_{i}_bn"),
        }
    if n_classes is not None and f"{classifier_layer}/kernel" in w:
        params["classifier"] = {
            "kernel": _f32(w[f"{classifier_layer}/kernel"]),
            "bias": _f32(w[f"{classifier_layer}/bias"]),
        }
    return params


def multihead_params_from_h5(path: str) -> Dict:
    """Keras multi-head age/gender h5 (``age_gender_train.py:170-185`` arch:
    MobileNet base + feats/age_pred/gender_pred Dense heads) → multihead pytree."""
    w = load_keras_h5(path)
    backbone = mobilenet_params_from_h5(path)
    backbone.pop("classifier", None)

    def head(name):
        return {"kernel": _f32(w[f"{name}/kernel"]),
                "bias": _f32(w[f"{name}/bias"])}

    return {
        "backbone": backbone,
        "feats": head("feats"),
        "age": head("age_pred"),
        "gender": head("gender_pred"),
    }


def save_mobilenet_h5(params: Dict, path: str,
                      classifier_layer: str = "preds") -> None:
    """Export a mobilenet pytree (BN form, numpy layouts) back to Keras h5
    layout — the counterpart of the reference's hdf5→h5 conversion
    (``facerec_keras_train.py:101-122``)."""
    import h5py

    def put(g, layer, weights):
        lg = g.require_group(layer).require_group(layer)
        names = []
        for wname, arr in weights.items():
            arr = np.asarray(arr)
            lg.create_dataset(wname, data=arr)
            names.append(f"{layer}/{layer}/{wname}".encode())
        g[layer].attrs["weight_names"] = names

    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        bn_names = lambda p: {"gamma": p["gamma"], "beta": p["beta"],
                              "moving_mean": p["mean"], "moving_variance": p["var"]}
        put(root, "conv1", {"kernel": params["conv1"]["kernel"]})
        put(root, "conv1_bn", bn_names(params["conv1"]["bn"]))
        for i, _ in enumerate(MOBILENET_V1_BLOCKS, start=1):
            put(root, f"conv_dw_{i}", {"depthwise_kernel": params[f"dw{i}"]["kernel"]})
            put(root, f"conv_dw_{i}_bn", bn_names(params[f"dw{i}"]["bn"]))
            put(root, f"conv_pw_{i}", {"kernel": params[f"pw{i}"]["kernel"]})
            put(root, f"conv_pw_{i}_bn", bn_names(params[f"pw{i}"]["bn"]))
        if "classifier" in params:
            put(root, classifier_layer, {"kernel": params["classifier"]["kernel"],
                                         "bias": params["classifier"]["bias"]})
