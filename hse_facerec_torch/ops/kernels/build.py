"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

All of ``hse_facerec_torch/csrc/*.cu`` compile into one shared library with
a plain C interface, for Hopper (``sm_90a``), at first use: one ``nvcc``
per source (``-I csrc`` for the shared ``*.cuh`` headers), all started
together, then one link. The library goes to
``hse_facerec_torch/_build/<hash>/``, keyed by a hash of the sources, the
headers and the flags, so an edited source or header rebuilds and an
unchanged tree loads at once.
Nothing here falls back: a missing ``nvcc`` or a failed build raises.
The build runs once per process even when several threads (the server's
workers) use a kernel for the first time at once, and ``count_launch``
counts each wrapper's launches under one lock for the same reason.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_ROOT / "csrc"
BUILD_ROOT = PACKAGE_ROOT / "_build"
LIB_NAME = "libfacerec_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (default
    /usr/local/cuda). Raises when neither has it."""
    cuda_bin = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")
    search = os.pathsep.join([os.environ.get("PATH", ""), cuda_bin])
    nvcc = shutil.which("nvcc", path=search)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels "
            "of hse_facerec_torch cannot be built")
    return nvcc


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def _run(cmds: List[List[str]], logs: List[Path]) -> str:
    """Run the commands at once, each writing to its log; raise if any
    fails. Returns the logs, in order."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT))
    codes = [proc.wait() for proc in procs]
    text = "".join(log.read_text() for log in logs)
    for cmd, code in zip(cmds, codes):
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{text}")
    return text


def build(lib_path: Path) -> str:
    """Compile every source into ``lib_path``; returns nvcc's output (the
    ``-Xptxas -v`` register and spill report). The library appears
    atomically, so a concurrent build never loads a half-written file."""
    nvcc = find_nvcc()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        tmp = Path(tmp)
        objs = [tmp / (src.stem + ".o") for src in sources()]
        log = _run([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources(), objs)],
                   [obj.with_suffix(".log") for obj in objs])
        lib = tmp / LIB_NAME
        log += _run([[nvcc, "-shared", "-o", str(lib), *map(str, objs)]],
                    [tmp / "link.log"])
        os.replace(lib, lib_path)
    (lib_path.parent / "build.log").write_text(log)
    return log


_load_lock = threading.Lock()
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib_path = library_path()
    if not lib_path.exists():
        build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.facerec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.facerec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if this source hash has no
    build yet. The lock makes a second thread wait for the first one's
    build instead of running nvcc beside it."""
    with _load_lock:
        return _load()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``: a read-modify-write, so under a
    lock, since the server's threads launch the same kernel at once."""
    with _count_lock:
        wrapper.launches += 1


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if code:
        msg = lib.facerec_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
