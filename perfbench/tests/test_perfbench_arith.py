"""The benchmark's arithmetic against hand counts: percentiles over all
requests, rates, shares of a peak and of a roofline, the models' FLOPs
from their shapes, the kernels' work, the open-loop schedule."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from perfbench import flops, readers, stats
from perfbench.entries.identify import schedule
from perfbench.trace import TraceSummary

from .conftest import REPO


def _cfg(name):
    return json.loads((REPO / "perfbench" / "configs" / f"{name}.json").read_text())


def test_percentile_counts_failures_beyond_every_value():
    lat = [float(i) for i in range(1, 101)]
    assert stats.percentile(lat, 95) == 95.0
    assert stats.percentile(lat, 50) == 50.0
    # five failed requests of 100: the 95th percentile is the last finite one
    assert stats.percentile(lat[:95] + [math.inf] * 5, 95) == 95.0
    assert stats.percentile(lat[:94] + [math.inf] * 6, 95) == math.inf
    assert stats.percentile([3.0], 99) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate_spread_and_share_of_peak():
    assert stats.rate(1024 * 3, 2.0) == 1536.0
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)
    assert stats.share_of_peak(0.5, 2.0) == 25.0
    assert stats.share_of_peak(0.0, 2.0) is None


def test_iresnet100_flops_and_parameters_by_hand():
    cfg = _cfg("iresnet100-arcface")
    macs = 112 * 112 * 27 * 64                              # conv0
    size, cin = 112, 64
    for units, cout in zip((3, 13, 30, 3), (64, 128, 256, 512)):
        out = size // 2
        macs += size * size * 9 * cin * cout + out * out * 9 * cout * cout + out * out * cin * cout
        macs += (units - 1) * 2 * out * out * 9 * cout * cout
        size, cin = out, cout
    macs += 7 * 7 * 512 * 512                               # pre_fc1
    assert flops.iresnet_flops(cfg) == 2.0 * macs
    assert flops.iresnet_flops(cfg) == pytest.approx(24.2e9, rel=0.01)
    assert flops.iresnet_params(cfg) == pytest.approx(65.2e6, rel=0.01)


def test_mobilenet_multihead_flops_match_the_ports_count():
    from hse_facerec_torch.bench import _dense_flops, _mobilenet_flops
    from hse_facerec_torch.testing import random_multihead_params

    cfg = _cfg("mobilenet-multihead")
    params = random_multihead_params(np.random.RandomState(0))
    theirs = _mobilenet_flops(params["backbone"], (224, 224)) + _dense_flops(
        params, ("feats", "age", "gender"))
    assert flops.mobilenet_multihead_flops(cfg) == theirs
    assert flops.mobilenet_multihead_flops(cfg) == pytest.approx(1.14e9, rel=0.01)


def test_mtcnn_flops_by_hand():
    # P-Net on a 12x12 window: one output cell
    assert flops.pnet_flops(12, 12) == 2.0 * (10 * 10 * 270 + 3 * 3 * 1440 + 1 * 1 * (4608 + 192))
    assert flops.RNET_FLOPS == 2.0 * (484 * 756 + 81 * 12096 + 9 * 12288 + 73728 + 768)
    counts = {"levels": [(12, 12)], "stage2": 2, "stage3": 1, "faces": 1}
    cfg = _cfg("mobilenet-multihead")
    assert flops.analysis_flops(counts, cfg) == (flops.pnet_flops(12, 12) + 2 * flops.RNET_FLOPS
                                                 + flops.ONET_FLOPS
                                                 + flops.mobilenet_multihead_flops(cfg))


def test_knn_and_crop_work_by_hand():
    ops, nbytes = flops.knn_int8_work(1, 1_000_000, 512)
    assert ops == 2 * 512e6
    assert nbytes == 1_000_000 * 512 + 4_000_000 + 512 + 8
    t, kind = flops.bound_s(nbytes, ops, "int8")
    assert kind == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    # a 10x20 box inside a 100x100 image at 24x24, one sample a pixel:
    # 11 rows x 21 columns of taps, 3 channels in and out, f32
    ops, nbytes = flops.crop_work([(5.0, 5.0, 15.0, 25.0)], 100, 100, 3, 24, 1, clamp=True)
    assert nbytes == 4.0 * 3 * (11 * 21 + 24 * 24) + 16
    assert ops == 2.0 * 4 * 24 * 24 * 3
    # a box hanging off the image: only the pixels inside are read
    _, inside = flops.crop_work([(-50.0, -50.0, 10.0, 10.0)], 100, 100, 3, 24, 1, clamp=False)
    assert inside == 4.0 * 3 * (11 * 11 + 24 * 24) + 16


class _Ctx:
    def __init__(self, trace, entry, seconds):
        self.trace, self.entry = trace, entry
        self.window = type("W", (), {"seconds": seconds})()


def test_busy_idle_roofline_and_mfu_from_a_trace():
    s = 1_000_000_000
    kernels = [("k2", s, s + 200_000_000), ("k2", s + 100_000_000, s + 300_000_000),
               ("reduce", s + 500_000_000, s + 600_000_000),
               ("Memcpy HtoD (Pageable -> Device)", s + 700_000_000, s + 800_000_000)]
    trace = TraceSummary(kernels, s, s + 1_000_000_000)
    assert trace.busy_s == pytest.approx(0.5)          # overlapping kernels count once
    assert trace.kernel_busy_s == pytest.approx(0.4)   # the copy leaves the SMs idle
    ctx = _Ctx(trace, {"work_at_peak_s": 0.25}, 2.0)
    assert readers.device_idle(ctx) == pytest.approx(60.0)
    assert readers.mfu(ctx) == pytest.approx(12.5)
    # two calls of 0.335 GB at 3.35 TB/s = 0.2 ms of bound over 0.5 s of kernels
    share = readers.roofline(ctx, lambda k: k in ("k2", "reduce"), lambda k: k == "k2",
                             lambda n: [(0.335e9, 0.0, "int8")] * n)
    assert share == pytest.approx(100.0 * 2 * 1e-4 / 0.5)
    assert readers.roofline(_Ctx(None, {}, 1.0), bool, bool, lambda n: []) is None
    gaps = dict(trace.idle_gaps([("a", s, s + 400_000_000), ("b", s + 350_000_000, s + 2 * s)],
                                ["a", "b"]))
    assert gaps == {"b": pytest.approx(0.6)}


def test_open_loop_schedule_same_gaps_for_every_seed():
    a, b = schedule(500.0, 10.0, 1), schedule(500.0, 10.0, 2 ** 31 + 7)
    assert len(a) == len(b) == 5000
    gaps_a, gaps_b = np.diff(a, prepend=0.0), np.diff(b, prepend=0.0)
    assert np.all(gaps_a > 0)
    assert sorted(gaps_a) == pytest.approx(sorted(gaps_b), rel=1e-9, abs=1e-12)
    assert not np.allclose(a, b)
    assert gaps_a.mean() == pytest.approx(1 / 500.0, rel=1e-9)
    assert a[-1] == pytest.approx(10.0)
    # exponential gaps: the share of gaps longer than the mean is 1/e
    assert np.mean(gaps_a > 1 / 500.0) == pytest.approx(np.exp(-1), abs=0.01)
    assert np.array_equal(schedule(500.0, 10.0, 1), a)
