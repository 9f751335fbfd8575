"""BENCHMARK.json against the benchmark's contract, and every part of
every cell found by name."""

from __future__ import annotations

import json
import re

import pytest

from perfbench.spec import HERE, NAME_RE, UNIT_RE, Benchmark

from .conftest import HELD, REPO, held_tag

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE_RE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and BENCH["command"][:3] == ["python3", "-m", "perfbench.run"]
    assert all(LINE_RE.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    # a full check of 24 cells fits its time: 2 + 14 runs a cell, each
    # run_seconds + 60, 2 x 90 s of compiling a cell, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entry_keys_and_names(section, keys):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - keys
        assert keys <= set(e) and extra <= ({"workloads"} if section in ("end_to_end", "per_layer")
                                            else set()), (section, e)
        assert NAME_RE.match(e["name"]), e["name"]
        if "why" in e:
            assert LINE_RE.match(e["why"])
        if "unit" in e:
            assert UNIT_RE.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if section == "workloads":
            assert NAME_RE.match(e["config"]) and NAME_RE.match(e["traffic"])
            assert e["chips"] in (1, 4) and LINE_RE.match(e["why"])


def test_metrics_sources_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE_RE.match(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_part_is_found_by_name():
    bench = Benchmark(REPO)
    for c in BENCH["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = bench.config(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert (HERE / "reference" / f"{c['name']}.py").exists()
    for w in BENCH["workloads"]:
        assert w["config"] in bench.configs
        bench.traffic(w["traffic"])
        assert "limits" in bench.cell(w["name"])
        bench.reference(w["config"])
    for m in BENCH["per_layer"]:
        assert callable(bench.reader(m["name"]).read)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(bench.configs)


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = Benchmark(REPO)
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in bench.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.per_layer(w["name"])


def test_a_per_layer_metric_moves_what_its_cells_report():
    bench = Benchmark(REPO)
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m["workloads"]:
            assert m["moves"] in [e["name"] for e in bench.end_to_end(cell)], (m["name"], cell)


def test_a_roofline_metric_comes_with_a_whole_step_share_moving_the_same_metric():
    for m in BENCH["per_layer"]:
        if "_roofline" in m["name"]:
            assert any("mfu" in n["name"] and n["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(n["workloads"])
                       for n in BENCH["per_layer"]), m["name"]


def test_the_held_back_cells_are_complete():
    """Each held cell's configuration, traffic, limits and readers exist
    as files, so that a later benchmark PR admits it by adding its
    BENCHMARK.json entries alone."""
    bench = Benchmark(REPO)
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for cell, (config, traffic, quantity, _) in HELD.items():
        assert config in bench.configs and cell not in bench.workloads
        bench.traffic(traffic)
        assert "limits" in bench.cell(cell)
        assert quantity not in names
        readers = sorted((HERE / "metrics").glob(f"*.{held_tag(cell)}.py"))
        assert readers
        for reader in readers:
            assert reader.stem not in names and callable(bench.reader(reader.stem).read)


def test_no_cell_takes_four_chips():
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_layer_names_agree_with_perf_md():
    perf = (REPO / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert layer in perf, layer
