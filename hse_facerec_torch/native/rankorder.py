"""ctypes bindings for the native rank-order clustering core.

The port's own copy of ``hse_facerec_tf_tpu/native/rankorder.py`` with the
same ctypes contract. ``librankorder.so`` is built with g++ at first use
into ``hse_facerec_torch/_build/rankorder-<hash>/`` (git-ignored), keyed by
a hash of the source and the flags, and appears there atomically, so
processes that build at once never load a half-written file. Without a
compiler ``available()`` is False and callers use the Python core
(``pipelines/clustering.py::_rank_order_clusters``), as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().with_name("rankorder.cc")
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD_ROOT / f"rankorder-{h.hexdigest()[:16]}" / "librankorder.so"


def _build(lib_path: Path) -> bool:
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
            out = Path(tmp) / lib_path.name
            subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(out)],
                           check=True, capture_output=True, timeout=120)
            os.replace(out, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        lib_path = library_path()
        if not lib_path.exists() and not _build(lib_path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(lib_path))
        lib.rank_order_cluster.restype = ctypes.c_int
        lib.rank_order_cluster.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def rank_order_cluster_native(dist_matrix: np.ndarray, n_neighbours: int = 20,
                              k_norm: int = 12, t: float = 14.0,
                              norm_threshold: float = 0.9) -> List[List[int]]:
    """Native rank-order clustering; same result contract as the Python
    implementation (clusters with >1 member, unsorted)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native rankorder library unavailable (no g++?)")
    d = np.ascontiguousarray(dist_matrix, dtype=np.float32)
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"expected a square distance matrix, got {d.shape}")
    n = d.shape[0]
    labels = np.zeros(n, dtype=np.int32)
    lib.rank_order_cluster(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, n_neighbours,
        k_norm, t, norm_threshold,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    clusters: dict = {}
    for i, l in enumerate(labels):
        clusters.setdefault(int(l), []).append(i)
    return [c for c in clusters.values() if len(c) > 1]
