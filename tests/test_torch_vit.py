"""The ViT face embedder (``models/vit.py``, zoo entry ``insightface_vit_l``)
and its attention kernel K5 (``ops/kernels/attention.py``): the forward
against the benchmark's plain reference (``perfbench/reference/
vit-l-arcface.py``) on its seeded weights, ``attention_plain`` against
matmul-softmax-matmul, K5 against ``attention_plain`` on a card, and tiny
runs of the ``vit-enroll`` cell on the CPU: sound runs correct, the TF32
control and five planted faults not, the FLOP count equal to torch's own
count of the reference, and the attention roofline's reader silent where
it has nothing of K5's to read.

The tiny size: 144 tokens of 112² crops at 32 channels, 2 blocks of 4
heads, an MLP of 128 and a 16-d embedding; the card's tests take the
published widths (768, 8 heads of 96). No JAX here: the card's tests run
with ``--noconftest``."""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

from hse_facerec_torch.models import vit, zoo
from hse_facerec_torch.ops.kernels import attention as k5

TINY = {"embed_dim": 32, "depth": 2, "num_heads": 4, "embedding_dim": 16}
SEED = 2 ** 33 + 2101
BF16_COS = 0.999          # the precision dial's tolerance for bf16 operands


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A tiny copy of the benchmark with the ViT configuration cut to
    ``TINY`` (``make_tiny`` cuts the two configurations it knows)."""
    from perfbench.spec import Benchmark
    from perfbench.tests.conftest import make_tiny

    root = make_tiny(tmp_path_factory.mktemp("tiny_vit"))
    path = root / "perfbench" / "configs" / "vit-l-arcface.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY}))
    return Benchmark(root, pkg=root / "perfbench")


@pytest.fixture(scope="module")
def tiny(bench):
    """(configuration, seeded weights, the reference, 6 seeded crops)."""
    from perfbench import inputs
    from perfbench import vit as pvit

    cfg = bench.config("vit-l-arcface")
    return (cfg, pvit.weights(cfg, SEED, "cpu"), bench.reference("vit-l-arcface"),
            inputs.images(6, 112, 112, SEED, "test.crops", "cpu"))


def _rel_err(got, want):
    return float((torch.linalg.vector_norm(got - want, dim=1)
                  / torch.linalg.vector_norm(want, dim=1)).max())


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_vit_embed_matches_the_plain_reference(tiny, dtype):
    """At "highest" the port's forward is the reference's to 1e-5 relative
    (only the order of sums differs); with bf16 GEMM operands every row's
    cosine is at least the dial's 0.999."""
    cfg, params, ref, crops = tiny
    want = ref.embed(params, crops, "cpu", cfg)
    got = _unit(vit.vit_embed(vit.to_torch(params, "cpu"), torch.from_numpy(crops),
                              compute_dtype=dtype))
    if dtype == torch.float32:
        assert _rel_err(got, want) <= 1e-5
    else:
        assert float((got * want).sum(dim=1).min()) >= BF16_COS
        assert _rel_err(got, want) > 1e-5          # the GEMMs did take bf16


def test_the_zoo_entry_embeds_through_the_extractor(tiny):
    cfg, params, ref, crops = tiny
    ex = zoo.build_extractor("insightface_vit_l", batch_size=4, device="cpu", params=params)
    got = ex.extract_batch(crops)
    assert got.shape == (6, 16)
    assert _rel_err(torch.from_numpy(got), ref.embed(params, crops, "cpu", cfg)) <= 1e-5


def test_the_zoo_entry_without_weights_seeds_and_warns(monkeypatch):
    monkeypatch.setattr(vit, "VIT_L", {**vit.VIT_L, **TINY})
    assert zoo.weights_origin("insightface_vit_l") == "random"
    with pytest.warns(RuntimeWarning, match="insightface_vit_l"):
        a = zoo.MODEL_ZOO["insightface_vit_l"].build_params()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = zoo.MODEL_ZOO["insightface_vit_l"].build_params()
    assert a["block1"]["qkv"]["kernel"].shape == (32, 3, 4, 8)
    assert np.array_equal(a["fc1"]["kernel"], b["fc1"]["kernel"])
    spec = zoo.MODEL_ZOO["insightface_vit_l"]
    assert spec.input_size == (112, 112) and spec.embedding_dim == 512
    assert spec.extractor_kwargs["l2_normalize_output"]


def _per_head(qkv, heads, scale):
    """Attention written out one image and one head at a time."""
    b, t, width = qkv.shape
    d = width // (3 * heads)
    out = torch.empty(b, t, heads * d, dtype=qkv.dtype)
    for i in range(b):
        for h in range(heads):
            q, k, v = (qkv[i, :, j * heads * d + h * d: j * heads * d + (h + 1) * d]
                       for j in range(3))
            a = torch.softmax((q @ k.T) * scale, dim=-1)
            out[i, :, h * d:(h + 1) * d] = a @ v
    return out


@pytest.mark.parametrize("shape", [(2, 144, 4, 8), (3, 17, 2, 32)])
def test_attention_plain_is_matmul_softmax_matmul(shape):
    b, t, h, d = shape
    gen = torch.Generator().manual_seed(5)
    qkv = torch.randn(b, t, 3 * h * d, generator=gen) * 2.0
    scale = k5.default_scale(d)
    want = _per_head(qkv, h, scale)
    before = k5.attention.launches
    torch.testing.assert_close(k5.attention_plain(qkv, h), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(k5.attention(qkv, h), want, rtol=1e-6, atol=1e-6)
    assert k5.attention.launches == before       # the CPU path launches nothing
    assert scale == float(np.float32(d ** -0.5))


def test_attention_refuses_a_device_it_does_not_run_on():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k5.attention(torch.empty(2, 144, 3 * 8 * 96, device="meta"), 8)


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_a_tiny_vit_enroll_run(bench, control):
    """The cell's comparison: a sound run correct, the reference at TF32 in
    the program's place not."""
    from perfbench.tests.conftest import run_tiny

    result, compared = run_tiny(bench, "vit-enroll", seed=SEED, control=control)
    assert result["correct"] is not control, compared
    if not control:
        assert set(result["metrics"]) == {"faces_per_s", "setup_s"}
        assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("fault", ["scale_dropped", "softmax_over_queries", "heads_interleaved",
                                   "pos_embed_dropped", "final_ln_mean_dropped"])
def test_a_fault_planted_in_the_forward_is_not_correct(bench, fault):
    from perfbench.faults_vit import FAULTS, planted
    from perfbench.tests.conftest import run_tiny

    assert fault in FAULTS
    with planted(fault):
        result, compared = run_tiny(bench, "vit-enroll", seed=SEED, seconds=1.0)
    assert not result["correct"], compared


def test_the_seeded_attention_is_peaked(tiny):
    """Far from uniform (1/144), so that a dropped scale or a softmax over
    the wrong axis shows."""
    cfg, params, ref, crops = tiny
    peak = ref.attention_peak(params, crops, "cpu", cfg)
    assert 0.15 < peak < 0.9


def test_flops_equal_torchs_count_of_the_reference(tiny):
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench import vit as pvit

    cfg, params, ref, crops = tiny
    with FlopCounterMode(display=False) as counter:
        ref.embed(params, crops[:2], "cpu", cfg)
    assert counter.get_total_flops() == 2 * pvit.flops(cfg)


def test_params_count_the_learned_leaves(tiny):
    from perfbench import vit as pvit

    cfg, params, _, _ = tiny

    def count(tree, name=""):
        return sum(count(v, k) if isinstance(v, dict) else
                   (0 if name.startswith("bn") and k in ("mean", "var") else np.size(v))
                   for k, v in tree.items())

    assert count(params) == pvit.params(cfg)


def test_vit_l_counts():
    """The published configuration: 255.68 M parameters, 50.68 GFLOPs a
    face, 3.0% of them in attention, K5's 63.7 MFLOP and 1.77 MB a face."""
    from perfbench import vit as pvit
    from perfbench.spec import Benchmark
    from perfbench.tests.conftest import REPO

    cfg = Benchmark(REPO).config("vit-l-arcface")
    assert pvit.params(cfg) == 255_683_584
    assert round(pvit.flops(cfg) / 1e9, 2) == 50.68
    ops, nbytes = pvit.attention_work(cfg, 1)
    assert round(ops / 1e6, 1) == 63.7 and round(nbytes / 1e6, 2) == 1.77
    assert round(24 * ops / pvit.flops(cfg), 3) == 0.030


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_time_s(self, match):
        hits = [e - s for n, s, e in self.kernels if match(n)]
        return sum(hits) / 1e9, len(hits)


@pytest.mark.parametrize("case", ["no trace", "no launches", "mismatch", "read"])
def test_the_attention_roofline_reads_only_k5(bench, case):
    from types import SimpleNamespace

    from perfbench import vit as pvit

    cfg = bench.config("vit-l-arcface")
    work = pvit.attention_work(cfg, 8)
    kernels = [("void (anonymous namespace)::k5_attention_kernel<32>(...)", 0, 2_000_000)] * 3
    kernels += [("ampere_sgemm_128x64_tn", 0, 9_000_000), ("flash_attention_fwd", 0, 1_000)]
    entry = {"attn_launches": 3, "attn_work": work}
    trace = _Trace(kernels)
    if case == "no trace":
        trace = None
    elif case == "no launches":
        entry["attn_launches"] = 0
    elif case == "mismatch":
        entry["attn_launches"] = 4
    ctx = SimpleNamespace(trace=trace, entry=entry)
    value = bench.reader("attn_roofline.enroll.vit").read(ctx)
    if case == "read":
        assert value == pytest.approx(100.0 * (work[0] / 67e12) / 2e-3)
    else:
        assert value is None


# ---------- on a card ----------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 144, 8, 96), (256, 144, 8, 96), (3, 144, 3, 96),
                                   (2, 50, 4, 96), (3, 33, 5, 96), (2, 7, 1, 96)])
def test_k5_equals_attention_plain_on_the_card(card, shape):
    """One launch a call; within 1e-5 of the plain version in float64,
    relative to the output or 1 (the softmax runs online in float32, so
    the order of its sums differs: 2.8e-6 seen at 144 tokens)."""
    b, t, h, d = shape
    gen = torch.Generator(device=card).manual_seed(11)
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device=card) * 1.5
    before = k5.attention.launches
    got = k5.attention(qkv, h)
    assert k5.attention.launches == before + 1
    want = k5.attention_plain(qkv.double(), h).float()
    torch.cuda.synchronize()
    err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    assert err < 1e-5, err


@pytest.mark.cuda
def test_vit_embed_at_published_widths_matches_the_reference_on_the_card(card):
    """Two blocks at ViT-L's widths through the zoo's extractor on the card
    (K5 in every block), against the plain reference."""
    from perfbench import inputs
    from perfbench import vit as pvit
    from perfbench.spec import Benchmark
    from perfbench.tests.conftest import REPO

    bench = Benchmark(REPO)
    cfg = {**bench.config("vit-l-arcface"), "depth": 2}
    params = pvit.weights(cfg, SEED, "cuda")
    crops = inputs.images(40, 112, 112, SEED, "test.crops", "cuda")
    before = k5.attention.launches
    got = zoo.build_extractor("insightface_vit_l", batch_size=16, device="cuda",
                              params=params).extract_batch(crops)
    assert k5.attention.launches - before == 2 * 3
    want = bench.reference("vit-l-arcface").embed(params, crops, "cuda", cfg)
    assert _rel_err(torch.from_numpy(got).cuda(), want) <= 1e-5
