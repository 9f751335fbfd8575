"""Whole runs of every cell at a tiny size on the CPU, past the look for
a card: sound runs come out correct; the control (the reference at the
precision below the configuration's in the program's place) and a program
whose answers are altered where they are produced come out not correct;
a program with a fault planted in its BN or PReLU passes comes out not
correct; an added cell is found and run from its files alone."""

from __future__ import annotations

import json

import numpy as np
import pytest

from perfbench.faults import FAULTS, planted
from perfbench.spec import Benchmark

from .conftest import make_tiny, run_tiny

CELLS = ["arcface-enroll", "multihead-enroll", "arcface-identify", "multihead-album"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(tiny, cell):
    _, bench = tiny
    result, compared = run_tiny(bench, cell)
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in bench.end_to_end(cell)}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(bench.cell(cell)["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_comparison(tiny, cell):
    _, bench = tiny
    result, compared = run_tiny(bench, cell, control=True)
    assert not result["correct"], compared


def _alter_embedding(monkeypatch):
    from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor

    real = EmbeddingExtractor.extract_batch

    def altered(self, images):
        out = real(self, images).copy()
        out[:, 0] += 0.01                # every embedding moved off its crop's
        return out

    monkeypatch.setattr(EmbeddingExtractor, "extract_batch", altered)


def _alter_ranking(monkeypatch):
    from hse_facerec_torch.pipelines.gallery import EnrollmentGallery

    real = EnrollmentGallery.identify

    def altered(self, embedding, threshold=0.82):
        label, dist, nearest = real(self, embedding, threshold)
        return label, dist * 1.05, nearest

    monkeypatch.setattr(EnrollmentGallery, "identify", altered)


def _alter_faces(monkeypatch):
    from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer

    real = FacialAnalyzer.analyze_batch

    def altered(self, images, n_valid=None):
        out = real(self, images, n_valid)
        for faces in out:
            for f in faces:
                f.gender_prob = 1.0 - f.gender_prob
        return out

    monkeypatch.setattr(FacialAnalyzer, "analyze_batch", altered)


@pytest.mark.parametrize("cell,fault", [
    ("arcface-enroll", _alter_embedding), ("multihead-enroll", _alter_embedding),
    ("arcface-identify", _alter_embedding), ("arcface-identify", _alter_ranking),
    ("multihead-album", _alter_faces)])
def test_an_answer_altered_where_it_is_produced_is_not_correct(tiny, monkeypatch, cell, fault):
    _, bench = tiny
    fault(monkeypatch)
    result, compared = run_tiny(bench, cell, seconds=1.0)
    assert not result["correct"], compared


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_bn_or_prelu_fault_in_the_backbone_is_not_correct(tiny, fault):
    """A dropped or mis-folded BN, or slopes on the wrong channels, in the
    program's IResNet: the seeded BN moments and slopes make each show."""
    _, bench = tiny
    with planted(fault):
        result, compared = run_tiny(bench, "arcface-enroll", seconds=1.0)
    assert not result["correct"], compared


@pytest.mark.parametrize("cell", ["arcface-enroll", "arcface-identify", "multihead-album"])
def test_a_traced_run_reports_per_layer_metrics_instead(tiny, cell):
    _, bench = tiny
    result, _ = run_tiny(bench, cell, traced=True)
    names = {m["name"] for m in bench.per_layer(cell)}
    assert set(result["metrics"]) <= names and result["metrics"]
    # no card here: the device's numbers are left out, never read as 0
    assert not any("idle" in n or "roofline" in n for n in result["metrics"])


def test_an_added_cell_runs_from_new_files_alone(tmp_path):
    root = make_tiny(tmp_path)
    pkg = root / "perfbench"
    (pkg / "cells" / "arcface-enroll-small.json").write_text(
        (pkg / "cells" / "arcface-enroll.json").read_text())
    traffic = json.loads((pkg / "traffic" / "closed-embed-1024.json").read_text())
    traffic.update(batch=8, pool=16)
    (pkg / "traffic" / "closed-embed-small.json").write_text(json.dumps(traffic))
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    bench_json["workloads"].append({"name": "arcface-enroll-small", "config": "iresnet100-arcface",
                                    "traffic": "closed-embed-small", "chips": 1, "why": "test"})
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        if "arcface-enroll" in m.get("workloads", []):
            m["workloads"].append("arcface-enroll-small")
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    bench = Benchmark(root, pkg=pkg)
    result, compared = run_tiny(bench, "arcface-enroll-small")
    assert result["correct"], compared
    assert result["attempted"] % 8 == 0


def test_main_refuses_without_a_card(tmp_path, monkeypatch, capsys):
    import torch

    from perfbench import run

    root = make_tiny(tmp_path)
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "arcface-enroll", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_main_refuses_without_the_program(tmp_path):
    """From a directory holding only BENCHMARK.json and the benchmark's
    files, a run exits with an error and prints no result."""
    import shutil
    import subprocess
    import sys

    from .conftest import REPO

    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "arcface-enroll",
                           "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    """On a card: a short run of the smallest cell from the repository's
    own files is correct. Skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    from perfbench import run

    from .conftest import REPO

    bench = Benchmark(REPO)
    result, compared = run.execute(bench, bench.workload("multihead-enroll"), 2 ** 31 + 5, 2.0,
                                   False, t0_ns=time.time_ns())
    assert result["correct"], compared
    assert result["device"]["platform"] == "gpu"


def test_seeds_past_32_bits_give_the_same_inputs():
    from perfbench import inputs

    a = inputs.images(2, 16, 16, 2 ** 33 + 1, "x", "cpu")
    b = inputs.images(2, 16, 16, 2 ** 33 + 1, "x", "cpu")
    c = inputs.images(2, 16, 16, 2 ** 33 + 2, "x", "cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
