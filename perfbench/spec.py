"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root, then ``configs/``, ``traffic/``, ``cells/``, ``metrics/`` and
``reference/`` beside this file. A later cell, configuration, traffic mix
or metric is a new file and a new entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_name(name: str, what: str) -> str:
    """``name`` if it is a valid name (letters a-z A-Z, digits, ``_``,
    ``.``, ``-``; at most 64; not starting with ``.`` or ``-``)."""
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """``BENCHMARK.json`` and the files it names, below ``root``."""

    def __init__(self, root: Path, pkg: Path = HERE):
        self.root = Path(root)
        self.pkg = Path(pkg)
        self.data = load_json(self.root / "BENCHMARK.json")
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def workload(self, name: str) -> Dict:
        try:
            return self.workloads[check_name(name, "workload")]
        except KeyError:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None

    def _applies(self, metric: Dict, cell: str, e2e_names: List[str]) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return metric.get("moves", metric["name"]) in e2e_names

    def end_to_end(self, cell: str) -> List[Dict]:
        """The cell's end-to-end metrics: those that list it, or list no
        cells."""
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[Dict]:
        """The cell's per-layer metrics: those that list it, or that list
        no cells and move an end-to-end metric the cell reports."""
        e2e = [m["name"] for m in self.end_to_end(cell)]
        return [m for m in self.data["per_layer"] if self._applies(m, cell, e2e)]

    def config(self, name: str) -> Dict:
        """The configuration file as it is run, with its BENCHMARK.json
        entry under ``entry``."""
        cfg = load_json(self.pkg / "configs" / f"{check_name(name, 'config')}.json")
        cfg["entry"] = self.configs.get(name, {})
        return cfg

    def traffic(self, name: str) -> Dict:
        return load_json(self.pkg / "traffic" / f"{check_name(name, 'traffic')}.json")

    def cell(self, name: str) -> Dict:
        return load_json(self.pkg / "cells" / f"{check_name(name, 'cell')}.json")

    def reference(self, config: str) -> ModuleType:
        return load_module(self.pkg / "reference" / f"{check_name(config, 'config')}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.pkg / "metrics" / f"{check_name(metric, 'metric')}.py")


def load_module(path: Path) -> ModuleType:
    """A module from its file, whatever its name (metric names hold dots,
    configuration names dashes)."""
    name = "perfbench._by_name." + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
