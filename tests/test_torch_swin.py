"""The Swin-T face embedder (``models/swin.py``, zoo entry ``swin_t_face``)
and its windowed-attention kernel K8 (``ops/kernels/attention.py::
window_attention``): the forward against the benchmark's plain reference
(``perfbench/reference/swin-t-face.py``) on its seeded weights,
``window_attention_plain`` against the reference's roll, partition and
reverse, the bias gather and the region labels against indices built by
hand, the FLOP and parameter counts, the zoo entry, the wrapper's refusals,
the planted faults at a tiny size of the ``swin-enroll`` cell on the CPU,
the roofline reader, and on a card K8 against ``window_attention_plain``
and the whole forward against the reference.

The tiny size: 14 x 14 tokens (28² crops and a 2 x 2 stem for the forward;
112² and an 8 x 8 stem in the cell, whose zoo entry takes 112² crops), 16
channels, stages of (2, 2) blocks with (1, 2) heads and 7 x 7 windows, so
that stage 1 has shifted, masked windows and stage 2 is one whole window.
The card's tests take the published widths. No JAX here: the card's tests
run with ``--noconftest``."""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

from hse_facerec_torch.models import swin, zoo
from hse_facerec_torch.ops.kernels import attention as k8

SHAPE = {"embed_dim": 16, "depths": [2, 2], "num_heads": [1, 2], "embedding_dim": 16}
TINY = {**SHAPE, "input_size": 28, "patch_size": 2}
TINY_CELL = {**SHAPE, "input_size": 112, "patch_size": 8}
SEED = 2 ** 33 + 2501
# bf16 GEMM operands keep 8 bits of mantissa through the 12 GEMM layers
# and two merges of the tiny Swin, whose seeded attention is peaked: a
# row's cosine to the float32 reference read 0.9989 (the dial's 0.999 for
# the convolutional zoo models is not met at 16 channels)
BF16_COS = 0.99


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A tiny copy of the benchmark with the Swin configuration cut to
    ``TINY_CELL`` (``make_tiny`` cuts the two configurations it knows)."""
    from perfbench.spec import Benchmark
    from perfbench.tests.conftest import make_tiny

    root = make_tiny(tmp_path_factory.mktemp("tiny_swin"))
    path = root / "perfbench" / "configs" / "swin-t-face.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY_CELL}))
    return Benchmark(root, pkg=root / "perfbench")


@pytest.fixture(scope="module")
def tiny(bench):
    """(configuration at 28², seeded weights, the reference, 6 seeded crops)."""
    from perfbench import inputs
    from perfbench import swin as pswin

    cfg = {**bench.config("swin-t-face"), **TINY}
    return (cfg, pswin.weights(cfg, SEED, "cpu"), bench.reference("swin-t-face"),
            inputs.images(6, 28, 28, SEED, "test.crops", "cpu"))


def _rel_err(got, want):
    return float((torch.linalg.vector_norm(got - want, dim=1)
                  / torch.linalg.vector_norm(want, dim=1)).max())


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_swin_embed_matches_the_plain_reference(tiny, dtype):
    """At "highest" the port's forward is the reference's to 1e-5 relative:
    the same float32 operations, only the order of sums differs (the GEMMs
    over the map against the reference's over windows, F.layer_norm
    against its mean and variance; 1.6e-6 seen); with bf16 GEMM operands
    every row's cosine is at least ``BF16_COS``."""
    cfg, params, ref, crops = tiny
    want = ref.embed(params, crops, "cpu", cfg)
    got = _unit(swin.swin_embed(swin.to_torch(params, "cpu"), torch.from_numpy(crops),
                                compute_dtype=dtype))
    if dtype == torch.float32:
        assert _rel_err(got, want) <= 1e-5
    else:
        assert float((got * want).sum(dim=1).min()) >= BF16_COS
        assert _rel_err(got, want) > 1e-5          # the GEMMs did take bf16


def _reference_attention(ref, qkv, heads, window, shift, table):
    """Windowed attention composed from the reference's own parts: its
    roll, ``window_partition``, index, mask and ``window_reverse``."""
    b, r, _, width = qkv.shape
    d, t = width // (3 * heads), window * window
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    q, k, v = ref._partition(x, window).view(-1, t, 3, heads, d).permute(2, 0, 3, 1, 4)
    bias = table[ref.relative_position_index(window).view(-1)].view(t, t, -1).permute(2, 0, 1)
    a = (q * d ** -0.5) @ k.transpose(-2, -1) + bias.unsqueeze(0)
    if shift:
        mask = ref.attn_mask(r, window, shift, "cpu")
        a = (a.view(-1, mask.shape[0], heads, t, t) + mask.unsqueeze(1).unsqueeze(0))
        a = a.view(-1, heads, t, t)
    o = (torch.softmax(a, dim=-1) @ v).transpose(1, 2).reshape(-1, window, window, heads * d)
    o = ref._reverse(o, window, r)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


@pytest.mark.parametrize("shape", [(2, 14, 1, 16, 3), (2, 14, 2, 8, 0), (1, 7, 2, 16, 0),
                                   (2, 21, 3, 32, 3)], ids=str)
def test_window_attention_plain_is_the_references_composition(bench, shape):
    b, r, h, d, shift = shape
    gen = torch.Generator().manual_seed(7)
    qkv = torch.randn(b, r, r, 3 * h * d, generator=gen) * 2.0
    table = torch.randn(169, h, generator=gen)
    ref = bench.reference("swin-t-face")
    want = _reference_attention(ref, qkv, h, 7, shift, table)
    bias = swin.to_torch({"rel_bias_table": table.numpy()}, "cpu")["attn_bias"]
    before = k8.window_attention.launches
    torch.testing.assert_close(k8.window_attention_plain(qkv, h, 7, shift, bias), want,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(k8.window_attention(qkv, h, 7, shift, bias), want,
                               rtol=1e-6, atol=1e-6)
    assert k8.window_attention.launches == before


def test_the_bias_gather_and_the_region_labels_by_hand(bench):
    ref = bench.reference("swin-t-face")
    index = k8.relative_position_index(7)
    by_hand = torch.tensor([[(yi - yj + 6) * 13 + (xi - xj + 6)
                             for yj in range(7) for xj in range(7)]
                            for yi in range(7) for xi in range(7)])
    assert torch.equal(index, by_hand) and torch.equal(ref.relative_position_index(7), by_hand)
    assert index[2 * 7 + 5, 6 * 7 + 0] == (2 - 6 + 6) * 13 + (5 - 0 + 6)
    table = np.arange(169 * 3, dtype=np.float32).reshape(169, 3)
    bias = swin.to_torch({"rel_bias_table": table}, "cpu")["attn_bias"]
    assert bias.shape == (3, 49, 49)
    assert bias[2, 10, 40] == table[by_hand[10, 40], 2]
    # a 14 x 14 map rolled by 3: window 0 lies in region 0; the last window
    # (rows and columns 7-13) splits at 11 = 14 - 3 on both axes
    labels = k8.region_labels(14, 7, 3)
    assert labels.shape == (4, 49) and not labels[0].any()
    side = [1] * 4 + [2] * 3
    assert labels[3].tolist() == [3 * sy + sx for sy in side for sx in side]
    assert labels[1].tolist() == [sx for _ in range(7) for sx in side]          # (0, 1)
    assert labels[2].tolist() == [3 * sy for sy in side for _ in range(7)]      # (1, 0)
    mask = torch.where(labels[:, :, None] != labels[:, None, :], -100.0, 0.0)
    assert torch.equal(mask, ref.attn_mask(14, 7, 3, "cpu"))


def test_flops_equal_torchs_count_of_the_reference(tiny):
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench import swin as pswin

    cfg, params, ref, crops = tiny
    with FlopCounterMode(display=False) as counter:
        ref.embed(params, crops[:2], "cpu", cfg)
    assert counter.get_total_flops() == 2 * pswin.flops(cfg)


def test_params_count_the_learned_leaves(tiny):
    from perfbench import swin as pswin

    cfg, params, _, _ = tiny

    def count(tree, name=""):
        return sum(count(v, k) if isinstance(v, dict) else
                   (0 if name.startswith("bn") and k in ("mean", "var") else np.size(v))
                   for k, v in tree.items())

    assert count(params) == pswin.params(cfg)


def test_swin_t_counts():
    """The published configuration: 28.50 M parameters, 8.96 GFLOPs a
    face, 3.1% of them in q.kᵀ and A.v; K8 12 launches a chunk, 912
    (window, head) pairs and 22.9 MB a face, its bound 6.8 us a face."""
    from perfbench import flops
    from perfbench import swin as pswin
    from perfbench.spec import Benchmark
    from perfbench.tests.conftest import REPO

    cfg = Benchmark(REPO).config("swin-t-face")
    assert pswin.params(cfg) == 28_501_498
    assert round(pswin.flops(cfg) / 1e9, 2) == 8.96
    work = pswin.window_attention_work(cfg, 1)
    assert len(work) == 12
    ops, nbytes = sum(o for o, _ in work), sum(b for _, b in work)
    assert round(nbytes / 1e6, 1) == 22.9 and round(ops / pswin.flops(cfg), 3) == 0.031
    assert round(sum(flops.bound_s(b, o, "f32")[0] for o, b in work) * 1e6, 1) == 6.8
    windows = sum(depth * (r // 7) ** 2 * heads for depth, r, _, heads, _ in pswin.stages(cfg))
    assert windows == 912
    assert {k: (list(v) if isinstance(v, tuple) else v) for k, v in swin.SWIN_T.items()} == \
        {k: cfg[k] for k in swin.SWIN_T}


def test_the_zoo_entry_embeds_through_the_extractor(bench):
    """The cell's path at 112² (an 8 x 8 stem at the tiny widths)."""
    from perfbench import inputs
    from perfbench import swin as pswin

    cfg = bench.config("swin-t-face")
    params = pswin.weights(cfg, SEED, "cpu")
    crops = inputs.images(5, 112, 112, SEED, "test.crops", "cpu")
    ex = zoo.build_extractor("swin_t_face", batch_size=4, device="cpu", params=params)
    got = ex.extract_batch(crops)
    assert got.shape == (5, 16)
    want = bench.reference("swin-t-face").embed(params, crops, "cpu", cfg)
    assert _rel_err(torch.from_numpy(got), want) <= 1e-5


def test_the_zoo_entry_without_weights_seeds_and_warns(monkeypatch):
    monkeypatch.setattr(swin, "SWIN_T", {**swin.SWIN_T, **TINY})
    assert zoo.weights_origin("swin_t_face") == "random"
    with pytest.warns(RuntimeWarning, match="swin_t_face"):
        a = zoo.MODEL_ZOO["swin_t_face"].build_params()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = zoo.MODEL_ZOO["swin_t_face"].build_params()
    assert a["stage1"]["block1"]["qkv"]["kernel"].shape == (32, 3, 2, 16)
    assert a["stage0"]["block0"]["rel_bias_table"].shape == (169, 1)
    assert np.array_equal(a["fc1"]["kernel"], b["fc1"]["kernel"])
    spec = zoo.MODEL_ZOO["swin_t_face"]
    assert (spec.input_size, spec.normalization, spec.resize_method, spec.embedding_dim) == \
        ((112, 112), "none", "cv2_linear", 512)
    assert spec.extractor_kwargs["l2_normalize_output"]
    assert spec.extractor_kwargs["convert"](a, "cpu")["stage0"]["block1"]["attn_bias"].shape \
        == (1, 49, 49)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "float32"),
    ("head_dim", ValueError, "3·H·32"),
    ("window", ValueError, "7 x 7 windows"),
    ("ragged map", ValueError, "whole 7 x 7 windows"),
    ("shift", ValueError, "shift"),
    ("bias", ValueError, "bias"),
    ("device", ValueError, "CUDA or CPU"),
])
def test_the_wrapper_refuses_what_k8_does_not_take(case, error, match):
    """Off the CPU the wrapper launches K8 or raises: float32 only, D 32,
    7 x 7 windows, a map of whole windows, 0 <= shift < 7, an (H, 49, 49)
    bias; the meta device is neither CPU nor CUDA."""
    qkv, heads, window, shift, bias = _meta((2, 14, 14, 3 * 2 * 32)), 2, 7, 3, \
        _meta((2, 49, 49))
    if case == "dtype":
        qkv = _meta(qkv.shape, torch.bfloat16)
    elif case == "head_dim":
        qkv = _meta((2, 14, 14, 3 * 2 * 16))
    elif case == "window":
        window = 8
    elif case == "ragged map":
        qkv = _meta((2, 16, 16, 3 * 2 * 32))
    elif case == "shift":
        shift = 7
    elif case == "bias":
        bias = _meta((2, 49, 48))
    with pytest.raises(error, match=match):
        k8.window_attention(qkv, heads, window, shift, bias)


@pytest.mark.parametrize("fault", ["bias_zeroed", "index_transposed", "shift_dropped",
                                   "merge_quadrants_swapped", "mask_dropped"])
def test_a_fault_planted_in_the_forward_is_not_correct(bench, fault):
    from perfbench.faults_swin import FAULTS, planted
    from perfbench.tests.conftest import run_tiny

    assert fault in FAULTS
    with planted(fault):
        result, compared = run_tiny(bench, "swin-enroll", seed=SEED, seconds=0.5)
    assert not result["correct"], compared


def test_the_seeded_attention_is_peaked(tiny):
    """Far from uniform (1/49), so that a dropped shift or mask shows."""
    cfg, params, ref, crops = tiny
    peak = ref.attention_peak(params, crops, "cpu", cfg)
    assert 0.15 < peak < 0.9


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_time_s(self, match):
        hits = [e - s for n, s, e in self.kernels if match(n)]
        return sum(hits) / 1e9, len(hits)


@pytest.mark.parametrize("case", ["no trace", "no launches", "mismatch", "part of a chunk",
                                  "read"])
def test_the_window_attention_roofline_reads_only_k8(bench, case):
    from types import SimpleNamespace

    from perfbench import flops
    from perfbench import swin as pswin

    cfg = bench.config("swin-t-face")
    work = pswin.window_attention_work(cfg, 8)
    kernels = [("void (anonymous namespace)::k8_window_attention_kernel(...)", 0, 10_000)] * 24
    kernels += [("void (anonymous namespace)::k5_attention_kernel<96>(...)", 0, 9_000_000),
                ("ampere_sgemm_128x64_tn", 0, 9_000_000)]
    entry = {"winattn_launches": 24, "winattn_work": work}
    trace = _Trace(kernels)
    if case == "no trace":
        trace = None
    elif case == "no launches":
        entry["winattn_launches"] = 0
    elif case == "mismatch":
        entry["winattn_launches"] = 36
    elif case == "part of a chunk":
        trace = _Trace(kernels[:18] + kernels[24:])
        entry["winattn_launches"] = 18
    ctx = SimpleNamespace(trace=trace, entry=entry)
    value = bench.reader("winattn_roofline.enroll.swin").read(ctx)
    if case == "read":
        chunks = 24 // len(work)                    # 4 blocks, 4 launches a chunk
        bound = chunks * sum(flops.bound_s(b, o, "f32")[0] for o, b in work)
        assert value == pytest.approx(100.0 * bound / (24 * 10e-6))
    else:
        assert value is None


# ---------- on a card ----------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 56, 3, 0), (2, 56, 3, 3), (3, 28, 6, 3),
                                   (2, 14, 12, 0), (3, 14, 12, 3), (5, 7, 24, 0),
                                   (1, 7, 24, 0), (256, 56, 3, 3)], ids=str)
def test_k8_equals_window_attention_plain_on_the_card(card, shape):
    """One launch a call; within 1e-5 of the plain version in float64,
    relative to the output or 1 (the softmax runs online in float32, so
    the order of its sums differs). The shapes
    are Swin-T's four stages, shifted and not, with windows not a multiple
    of a block's four (5 x 1 and 1 x 1) and the cell's 256-face stage 1."""
    b, r, h, shift = shape
    gen = torch.Generator(device=card).manual_seed(11)
    qkv = torch.randn(b, r, r, 3 * h * 32, generator=gen, device=card) * 1.5
    bias = torch.randn(h, 49, 49, generator=gen, device=card)
    before = k8.window_attention.launches
    got = k8.window_attention(qkv, h, 7, shift, bias)
    assert k8.window_attention.launches == before + 1
    want = k8.window_attention_plain(qkv.double(), h, 7, shift, bias.double()).float()
    torch.cuda.synchronize()
    err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    assert err < 1e-5, err


@pytest.mark.cuda
def test_swin_embed_at_published_widths_matches_the_reference_on_the_card(card, monkeypatch):
    """Swin-T at its published widths and depth through the zoo's extractor
    on the card: one 1,024-crop call launches K8 exactly 48 times (12 a
    256-face chunk, one a block) and calls no ``torch.roll``; its rows
    agree with the plain reference under the cell's ``emb_rel_err``
    limit."""
    from perfbench import inputs
    from perfbench import swin as pswin
    from perfbench.spec import Benchmark
    from perfbench.tests.conftest import REPO

    bench = Benchmark(REPO)
    cfg = bench.config("swin-t-face")
    params = pswin.weights(cfg, SEED, "cuda")
    crops = inputs.images(1024, 112, 112, SEED, "test.crops", "cuda")
    ex = zoo.build_extractor("swin_t_face", batch_size=256, device="cuda", params=params)
    rolls = []
    real_roll = torch.roll

    def counted_roll(*args, **kwargs):
        rolls.append(args[1:])
        return real_roll(*args, **kwargs)

    monkeypatch.setattr(torch, "roll", counted_roll)
    blocks = sum(depth for depth, *_ in pswin.stages(cfg))
    before = k8.window_attention.launches
    got = ex.extract_batch(crops)
    assert k8.window_attention.launches - before == blocks * 4 == 48
    assert rolls == []
    monkeypatch.undo()
    want = bench.reference("swin-t-face").embed(params, crops[:64], "cuda", cfg)
    err = _rel_err(torch.from_numpy(got[:64]).cuda(), want)
    limit = bench.cell("swin-enroll")["limits"]["emb_rel_err"]
    print(f"swin_t_face on the card against the reference: emb_rel_err {err:.3e}")
    assert err <= limit
