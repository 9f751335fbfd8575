"""Nothing the benchmark runs imports JAX or the JAX package, and nothing
of the references imports the program: each import's top-level name, the
part before the first dot, compared whole (the port's name begins with
the JAX package's)."""

from __future__ import annotations

import ast
import sys

import pytest

from perfbench.spec import load_module

from .conftest import REPO

PKG = REPO / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "hse_facerec_tf_tpu"}
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_whole_name_rule():
    assert "hse_facerec_torch".split(".")[0] not in FORBIDDEN
    assert "hse_facerec_tf_tpu.models".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_forbidden_import(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "bench" not in names
    if "reference" in path.parts:
        assert "hse_facerec_torch" not in names


def test_importing_every_module_loads_none_of_them():
    import importlib

    before = set(sys.modules)
    for path in SOURCES:
        rel = path.relative_to(REPO).with_suffix("")
        if all(part.isidentifier() for part in rel.parts):
            importlib.import_module(".".join(p for p in rel.parts if p != "__init__"))
        else:                             # metrics and references, found by name
            load_module(path)
    loaded = {m.split(".")[0] for m in set(sys.modules) - before}
    assert not loaded & FORBIDDEN
