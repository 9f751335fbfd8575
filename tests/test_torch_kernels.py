"""The crop kernel K1: its wrapper's routing, its build, and the kernel on
the card against its plain twin.

This file imports no JAX (neither does the package), so the card tests run
on a machine without it, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tests marked ``cuda`` skip where ``torch.cuda.is_available()`` is False. On
the card the kernel must match ``crop_resize_bilinear`` within 1e-3 (0-255
pixel units) on noise images: sample positions and hat weights are
bit-identical, only the order of the sums differs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hse_facerec_torch.ops import resize as tr
from hse_facerec_torch.ops.kernels import build
from hse_facerec_torch.ops.kernels.crop import crop_resize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def rng():
    return np.random.RandomState(2025)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _crop_boxes(rng, k, H, W):
    """Seeded boxes, partly off the image; the first fully outside."""
    y1 = rng.uniform(-30, H - 10, k)
    x1 = rng.uniform(-30, W - 10, k)
    s = rng.uniform(6, 150, k)
    boxes = np.stack([y1, x1, y1 + s, x1 + s], -1).astype(np.float32)
    boxes[0] = [-40.0, -40.0, -8.0, -8.0]
    return boxes


def test_crop_wrapper_cpu_takes_plain_path(rng):
    img = _t((rng.rand(40, 50, 3) * 255).astype(np.float32))
    boxes = _t(_crop_boxes(rng, 8, 40, 50))
    crop_resize.launches = 0
    for outside in ("zero", "clamp"):
        got = crop_resize(img, boxes, 24, 2, outside)
        want = tr.crop_resize_bilinear(img, boxes, 24, 2, outside)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert crop_resize.launches == 0


def test_crop_wrapper_rejects_other_devices(rng):
    img = torch.zeros((40, 50, 3), device="meta")
    boxes = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        crop_resize(img, boxes, 24, 2, "zero")
    with pytest.raises(ValueError):
        crop_resize(torch.zeros(40, 50, 3), torch.zeros(8, 4), 24, 2, "edge")


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(tmp_path / "lib.so")


def test_build_key_tracks_sources():
    assert [p.name for p in build.sources()] == ["crop_resize.cu"]
    key = build.source_hash()
    assert key == build.source_hash() and len(key) == 16
    assert build.library_path().parent.name == key


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, loads without jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hse_facerec_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.cuda
@pytest.mark.parametrize("k,out_size,supersample,outside", [
    (128, 24, 2, "zero"), (64, 48, 2, "zero"), (16, 224, 1, "clamp")])
def test_crop_kernel_matches_plain_on_card(cuda, rng, k, out_size, supersample,
                                           outside):
    H, W = 480, 640
    img = _t((rng.rand(H, W, 3) * 255).astype(np.float32)).to(cuda)
    boxes = _t(_crop_boxes(rng, k, H, W)).to(cuda)
    before = crop_resize.launches
    got = crop_resize(img, boxes, out_size, supersample, outside)
    want = tr.crop_resize_bilinear(img, boxes, out_size, supersample, outside)
    torch.cuda.synchronize()
    assert crop_resize.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-3
