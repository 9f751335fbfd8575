"""Weight quantization for serving (8-bit min/max, TF graph_transforms style).

Counterpart of ``hse_facerec_tf_tpu/ops/quantize.py``, numpy only. The
reference serves its multi-head model quantized (weights stored as
``(quint8, min, max)`` triples with MIN_FIRST dequantize); this module
quantizes a param pytree the same way (3.9x smaller checkpoints) and
dequantizes on load with the semantics of ``core/graphdef.py``'s importer.
The ``.npz`` files are the JAX package's, byte for byte, on the same params.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core.graphdef import dequantize_min_first

_MIN_ELEMS = 1024  # graph_transforms default: leave small tensors in float


def quantize_array(w: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """float32 -> (quint8, min, max), TF MIN_FIRST convention."""
    w = np.asarray(w, dtype=np.float32)
    mn = float(w.min())
    mx = float(w.max())
    if mx == mn:
        mx = mn + 1e-6
    scale = (mx - mn) / 255.0
    offset = np.round(mn / scale)
    q = np.clip(np.round(w / scale - offset), 0, 255).astype(np.uint8)
    return q, mn, mx


def quantize_pytree(params, min_elements: int = _MIN_ELEMS) -> Dict:
    """Pytree of float arrays -> {'quantized': {path: (q, mn, mx)},
    'float': {path: arr}} keyed by '/'-joined paths."""
    out = {"quantized": {}, "float": {}}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
            return
        arr = np.asarray(tree)
        key = prefix.rstrip("/")
        if arr.dtype.kind == "f" and arr.size >= min_elements:
            out["quantized"][key] = quantize_array(arr)
        else:
            out["float"][key] = arr

    walk(params)
    return out


def dequantize_pytree(store: Dict) -> Dict:
    """Inverse of quantize_pytree: nested dict of float32 arrays."""
    root: Dict = {}

    def put(key, val):
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    for key, (q, mn, mx) in store["quantized"].items():
        put(key, dequantize_min_first(q, mn, mx))
    for key, arr in store["float"].items():
        put(key, arr)
    return root


def save_quantized(params, path: str, min_elements: int = _MIN_ELEMS) -> None:
    store = quantize_pytree(params, min_elements)
    flat = {}
    for k, (q, mn, mx) in store["quantized"].items():
        flat[f"q:{k}"] = q
        flat[f"r:{k}"] = np.array([mn, mx], dtype=np.float32)
    for k, arr in store["float"].items():
        flat[f"f:{k}"] = arr
    np.savez_compressed(path if path.endswith(".npz") else path + ".npz", **flat)


def load_quantized(path: str) -> Dict:
    if not path.endswith(".npz"):
        path += ".npz"
    data = np.load(path)
    store: Dict = {"quantized": {}, "float": {}}
    for k in data.files:
        tag, name = k.split(":", 1)
        if tag == "q":
            mn, mx = data[f"r:{name}"]
            store["quantized"][name] = (data[k], float(mn), float(mx))
        elif tag == "f":
            store["float"][name] = data[k]
    return dequantize_pytree(store)
