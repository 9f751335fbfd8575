"""Whole runs of the ``swin-enroll`` cell at a tiny size on the CPU: a
sound run comes out correct and reports its end-to-end metrics; the
control (the reference at TF32 in the program's place) comes out not
correct. The configuration is cut to 14 x 14 tokens of 16 channels
(112² crops, as the zoo entry takes them, through an 8 x 8 stem), stages
of (2, 2) blocks with (1, 2) heads: stage 1 has shifted, masked windows and
stage 2 is one whole window."""

from __future__ import annotations

import json

import pytest

from perfbench.spec import Benchmark

from .conftest import make_tiny, run_tiny

TINY = {"input_size": 112, "patch_size": 8, "embed_dim": 16, "depths": [2, 2],
        "num_heads": [1, 2], "embedding_dim": 16}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = make_tiny(tmp_path_factory.mktemp("tiny_swin"))
    path = root / "perfbench" / "configs" / "swin-t-face.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY}))
    return Benchmark(root, pkg=root / "perfbench")


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_a_tiny_swin_enroll_run(bench, control):
    result, compared = run_tiny(bench, "swin-enroll", control=control)
    assert result["correct"] is not control, compared
    if not control:
        assert set(result["metrics"]) == {"faces_per_s", "setup_s"}
        assert result["attempted"] > 0 and result["failed"] == 0
        assert set(result["checks"]) == {"emb_rel_err"}
