"""The port stands alone: no module of ``hse_facerec_torch``, and not
``chip_smoke.py``, imports JAX, optax or the JAX package, not even inside a
function or a numpy-only module of it. The host libraries the card's
machine lacks (cv2, PIL, matplotlib, sklearn, h5py) are imported only
inside the functions that need them.

The ast check reads every ``import`` and ``from`` in the sources, the
function-local ones too; the subprocess checks import every module of the
port in a fresh interpreter and look at what was loaded.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "hse_facerec_tf_tpu")
HOST_ONLY_INSIDE = ("cv2", "PIL", "matplotlib", "sklearn", "h5py")
SOURCES = sorted((REPO / "hse_facerec_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_the_check_catches_a_function_local_import():
    tree = ast.parse("def f():\n    from hse_facerec_tf_tpu.utils import draw\n"
                     "    import jax.numpy as jnp\n")
    assert [n for n in _imported(tree) if _forbidden(n)] == [
        "hse_facerec_tf_tpu.utils", "jax.numpy"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    bad = [n for n in _imported(ast.parse(path.read_text(), str(path))) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _import_all(forbidden):
    return (
        "import importlib, pkgutil, sys\n"
        "import hse_facerec_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) >= 30


def test_importing_the_port_loads_nothing_of_jax():
    _run(_import_all(FORBIDDEN))


def test_importing_the_port_loads_no_host_only_library():
    _run(_import_all(HOST_ONLY_INSIDE))
