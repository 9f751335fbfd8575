"""The fused BN/PReLU/residual kernel K6 (``ops/kernels/bn_act.py``) and
IResNet's trunk on it (``models/arcface.py::_trunk_fused``).

On the CPU: the eager passes stay the CPU's path, gradients included, the
wrapper refuses what K6 does not take and any call that autograd would
record (K6 has no backward), ``bn_act_plain`` is the eager composition bit for bit,
and the fused trunk's grouping (with ``bn_act_plain`` in K6's place) gives
the eager trunk's bits. On a card (``-m cuda``): each of the four passes
the trunk launches is the eager composition's bits at every IResNet-100
activation shape, in both memory formats, at batch 1, 9 and 256; a
256-crop forward matches the eager forward; a forward that autograd
would record raises; one 256-face chunk launches
K6 ``1 + 2·49`` times; and five planted faults of the BN and PReLU
parameters each read over the ``arcface-enroll`` cell's limit. No JAX here:
the card's tests run with ``--noconftest``."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from hse_facerec_torch.models import arcface, zoo
from hse_facerec_torch.ops.kernels import bn_act as k6
from hse_facerec_torch.ops.kernels import kernel_launches
from hse_facerec_torch.params import tree_to_torch

SEED = 2 ** 33 + 2201
# (C, H, W) of every activation IResNet-100's trunk hands to a BN at 112²
SHAPES = [(64, 112, 112), (64, 56, 56), (128, 56, 56), (128, 28, 28),
          (256, 28, 28), (256, 14, 14), (512, 14, 14), (512, 7, 7)]
EMB_LIMIT = 2e-4         # the arcface-enroll cell's emb_rel_err limit


def _bn(c, gen):
    dev = gen.device
    return {"gamma": torch.rand(c, generator=gen, device=dev) + 0.5,
            "beta": torch.randn(c, generator=gen, device=dev) * 0.1,
            "mean": torch.randn(c, generator=gen, device=dev) * 0.3,
            "var": torch.rand(c, generator=gen, device=dev) + 0.5}


def _pass_args(kind, c, gen):
    """One of the trunk's four K6 passes: its keyword arguments beside x
    (the residual, where it takes one, filled in by the caller)."""
    kw = {"bn": _bn(c, gen)}
    if kind in ("bn_prelu", "stem"):
        kw["alpha"] = torch.rand(c, generator=gen, device=gen.device)
    if kind in ("tail", "tail_sc"):
        kw["residual"] = None
    if kind == "tail_sc":
        kw["residual_bn"] = _bn(c, gen)
    if kind != "bn_prelu":
        kw["next_bn"] = _bn(c, gen)
    return kw


def _eager(x, bn, alpha=None, residual=None, residual_bn=None, next_bn=None):
    """The passes K6 replaces, as ``models/arcface.py`` composes them."""
    y = arcface._bn(x, bn)
    if alpha is not None:
        y = arcface._prelu(y, alpha)
    if residual is not None:
        y = y + (residual if residual_bn is None else arcface._bn(residual, residual_bn))
    return y if next_bn is None else (y, arcface._bn(y, next_bn))


def _activation(shape, channels_last, gen):
    """Normals times 2, the first elements 0, -0, NaN, ±inf and ±1e-30."""
    x = torch.randn(shape, generator=gen, device=gen.device) * 2.0
    x.view(-1)[:7] = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"),
                                   1e-30, -1e-30])
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def _tiny_params(units=(1, 2, 1, 1)):
    """IResNet params at the published widths, cut to ``units`` a stage,
    with BN and PReLU leaves drawn (not left at identity)."""
    full = arcface.init_iresnet_params(torch.Generator().manual_seed(5), depth=34)
    rng = np.random.RandomState(7)
    params = {k: v for k, v in full.items() if not k.startswith("stage")}
    for s, n in enumerate(units, start=1):
        for u in range(1, n + 1):
            params[f"stage{s}_unit{u}"] = full[f"stage{s}_unit{u}"]

    def draw(tree):
        for key, v in tree.items():
            if isinstance(v, dict) and "gamma" in v:
                c = v["gamma"].shape[0]
                tree[key] = {"gamma": rng.uniform(0.5, 1.5, c), "beta": rng.normal(0, 0.1, c),
                             "mean": rng.normal(0, 0.3, c), "var": rng.uniform(0.5, 1.5, c)}
            elif isinstance(v, dict):
                draw(v)
            elif "alpha" in key:
                tree[key] = rng.uniform(0.1, 0.3, v.shape)
    draw(params)
    return params


# ---------- on the CPU ----------

def test_cpu_forward_takes_the_eager_passes(monkeypatch):
    """On CPU tensors ``iresnet_embed`` runs the eager trunk: K6's trunk is
    never called and every BN goes through ``_bn``."""
    params = tree_to_torch(_tiny_params(), "cpu")
    calls = []
    eager_bn = arcface._bn

    def counted(x, p):
        calls.append(tuple(x.shape))
        return eager_bn(x, p)

    def refused(*args, **kwargs):
        raise AssertionError("the CPU took K6's trunk")

    monkeypatch.setattr(arcface, "_bn", counted)
    monkeypatch.setattr(arcface, "_trunk_fused", refused)
    before = k6.bn_act.launches
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 112, 112, 3).astype(np.float32) * 255)
    with torch.no_grad():
        out = arcface.iresnet_embed(params, x)
    assert out.shape == (2, 512) and bool(torch.isfinite(out).all())
    # bn0, three a unit, one more for each of the 4 shortcuts, bn1, fc1
    assert len(calls) == 1 + 3 * 5 + 4 + 1 + 1
    assert k6.bn_act.launches == before


def test_cpu_forward_keeps_autograd():
    """The eager trunk is the CPU's path with gradients too: a forward with
    a parameter that requires grad records and back-propagates to it."""
    params = tree_to_torch(_tiny_params(), "cpu")
    gamma = params["stage2_unit2"]["bn2"]["gamma"].requires_grad_()
    x = torch.from_numpy(np.random.RandomState(4).rand(1, 112, 112, 3).astype(np.float32) * 255)
    arcface.iresnet_embed(params, x).square().sum().backward()
    assert gamma.grad is not None and bool(torch.isfinite(gamma.grad).all())
    assert float(gamma.grad.abs().sum()) > 0


@pytest.mark.parametrize("needs", ["x", "alpha", "bn", "residual", "residual_bn", "next_bn",
                                   "no_grad"])
def test_wrapper_refuses_what_autograd_would_record(needs):
    """K6 has no backward: the wrapper raises where any tensor it takes
    requires grad and grad is enabled; under ``no_grad`` it goes on (to
    the CPU's refusal, here)."""
    gen = torch.Generator().manual_seed(19)
    x = torch.randn(2, 8, 4, 4, generator=gen)
    if needs in ("x", "alpha", "bn", "no_grad"):
        kw = {"bn": _bn(8, gen), "alpha": torch.rand(8, generator=gen)}
    else:
        kw = {"bn": _bn(8, gen), "residual": torch.randn(2, 8, 4, 4, generator=gen),
              "residual_bn": _bn(8, gen), "next_bn": _bn(8, gen)}
    {"x": lambda: x.requires_grad_(), "alpha": lambda: kw["alpha"].requires_grad_(),
     "bn": lambda: kw["bn"]["gamma"].requires_grad_(),
     "residual": lambda: kw["residual"].requires_grad_(),
     "residual_bn": lambda: kw["residual_bn"]["var"].requires_grad_(),
     "next_bn": lambda: kw["next_bn"]["mean"].requires_grad_(),
     "no_grad": lambda: x.requires_grad_()}[needs]()
    if needs == "no_grad":
        with torch.no_grad(), pytest.raises(ValueError, match="runs on CUDA"):
            k6.bn_act(x, **kw)
    else:
        with pytest.raises(RuntimeError, match="no backward"):
            k6.bn_act(x, **kw)


@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
def test_fused_trunk_grouping_gives_the_eager_bits(monkeypatch, channels_last):
    """``_trunk_fused`` with ``bn_act_plain`` in K6's place: the eager
    trunk's bits, in the input's memory format, 1 + 2 launches a unit."""
    params = tree_to_torch(_tiny_params(), "cpu")
    calls = []

    def plain(*args, **kwargs):
        calls.append(1)
        return k6.bn_act_plain(*args, **kwargs)

    monkeypatch.setattr(arcface, "bn_act", plain)
    x = torch.randn(2, 112, 112, 3, generator=torch.Generator().manual_seed(9)).permute(0, 3, 1, 2)
    x = x if channels_last else x.contiguous()
    with torch.no_grad():
        want = arcface._trunk(params, x, torch.float32)
        got = arcface._trunk_fused(params, x, torch.float32)
    assert len(calls) == 1 + 2 * 5
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last) == channels_last


@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("kind", ["bn_prelu", "stem", "tail", "tail_sc"])
def test_plain_is_the_eager_composition(kind, channels_last):
    gen = torch.Generator().manual_seed(13)
    x = _activation((3, 8, 5, 7), channels_last, gen)
    kw = _pass_args(kind, 8, gen)
    if "residual" in kw:
        kw["residual"] = _activation((3, 8, 5, 7), channels_last, gen)
    got, want = k6.bn_act_plain(x, **kw), _eager(x, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
        assert torch.equal(torch.signbit(g), torch.signbit(w))


@pytest.mark.parametrize("case", ["cpu", "float64", "misaligned", "strided", "residual_strides",
                                  "bn_alone", "prelu_and_residual", "residual_alone"])
def test_wrapper_refuses_what_k6_does_not_take(case):
    gen = torch.Generator().manual_seed(17)
    bn = _bn(8, gen)
    x = torch.randn(2, 8, 4, 4, generator=gen)
    kw = {"alpha": torch.rand(8, generator=gen)}
    if case == "cpu":
        err, match = ValueError, "runs on CUDA"
    elif case == "float64":
        x, err, match = x.double(), TypeError, "float32"
    elif case == "misaligned":
        x = torch.randn(2 * 8 * 4 * 4 + 1, generator=gen)[1:].view(2, 8, 4, 4)
        err, match = ValueError, "16-byte"
    elif case == "strided":
        x, err, match = x[:, :, ::2], ValueError, "contiguous or channels-last"
    elif case == "residual_strides":
        kw = {"residual": torch.randn(2, 8, 4, 4, generator=gen).contiguous(
            memory_format=torch.channels_last), "next_bn": bn}
        err, match = ValueError, "differs from x"
    else:
        kw = {"bn_alone": {}, "prelu_and_residual": {**kw, "residual": x, "next_bn": bn},
              "residual_alone": {"residual": x}}[case]
        err, match = ValueError, "IResNet's passes"
    with pytest.raises(err, match=match):
        k6.bn_act(x, bn, **kw)


def test_kernel_launches_lists_k6():
    assert "bn_act" in kernel_launches()
    assert kernel_launches()["bn_act"] == k6.bn_act.launches


# ---------- on a card ----------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 9, 256])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k6_is_the_eager_passes_bit_for_bit(card, shape, channels_last, batch):
    """Each of the trunk's four passes, one launch each, equal to the eager
    composition (NaN where it has NaN, -0.0 where it has -0.0)."""
    gen = torch.Generator(device=card).manual_seed(SEED + batch + shape[0] + shape[1])
    full = (batch,) + shape
    x = _activation(full, channels_last, gen)
    for kind in ("bn_prelu", "stem", "tail", "tail_sc"):
        kw = _pass_args(kind, shape[0], gen)
        if "residual" in kw:
            kw["residual"] = _activation(full, channels_last, gen)
        before = k6.bn_act.launches
        got = k6.bn_act(x, **kw)
        assert k6.bn_act.launches == before + 1
        want = _eager(x, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.stride() == x.stride(), kind
            assert torch.equal(g.isnan(), w.isnan()), kind
            assert torch.equal(g.nan_to_num(), w.nan_to_num()), kind
            assert torch.equal(torch.signbit(g), torch.signbit(w)), kind
        del got, want, kw
    del x
    torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def r100():
    """The ``arcface-enroll`` cell's seeded IResNet-100 weights (numpy),
    its configuration, its plain reference and 256 seeded crops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench import inputs, weights
    from perfbench.spec import Benchmark
    from perfbench.tests.conftest import REPO

    bench = Benchmark(REPO)
    cfg = bench.config("iresnet100-arcface")
    params = weights.for_config(cfg, SEED, "cuda")
    crops = inputs.images(256, 112, 112, SEED, "test.crops", "cuda")
    return params, cfg, bench.reference("iresnet100-arcface"), crops


def _embed(params, crops, device="cuda"):
    """L2-normalised embeddings of uint8 crops through ``iresnet_embed``."""
    with torch.no_grad():
        out = arcface.iresnet_embed(tree_to_torch(params, device),
                                    torch.from_numpy(crops).to(device))
    return out / torch.linalg.vector_norm(out, dim=1, keepdim=True)


def _rel_err(got, want):
    return float((torch.linalg.vector_norm(got - want.to(got.device), dim=1)
                  / torch.linalg.vector_norm(want, dim=1).to(got.device)).max())


@pytest.mark.cuda
def test_fused_forward_matches_the_eager_forward_on_the_card(card, r100, monkeypatch):
    """256 crops through K6's trunk and through the eager trunk on the same
    card: relative L2 at most 1e-6 (each pass is bit-equal; the convs see
    the same strides)."""
    params, _, _, crops = r100
    before = k6.bn_act.launches
    got = _embed(params, crops)
    assert k6.bn_act.launches - before == 1 + 2 * 49
    monkeypatch.setattr(arcface, "_trunk_fused", arcface._trunk)
    want = _embed(params, crops)
    assert _rel_err(got, want) <= 1e-6


@pytest.mark.cuda
def test_card_forward_refuses_a_recorded_forward(card, r100):
    """On a card the trunk is K6's, which has no backward: a forward that
    autograd would record raises rather than leave the kernel; the same
    parameters under ``no_grad`` run on K6."""
    params, _, _, crops = r100
    tp = tree_to_torch(params, "cuda")
    tp["stage3_unit7"]["bn2"]["gamma"].requires_grad_()
    x = torch.from_numpy(crops[:2]).to("cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        arcface.iresnet_embed(tp, x)
    before = k6.bn_act.launches
    with torch.no_grad():
        out = arcface.iresnet_embed(tp, x)
    assert k6.bn_act.launches - before == 1 + 2 * 49
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_one_chunk_counts_the_documented_k6_launches(card, r100):
    """One 256-crop ``extract_batch`` through the zoo's extractor: one K6
    launch for the stem and two for each of the 49 units, no other
    kernel of the library."""
    params, _, _, crops = r100
    ex = zoo.build_extractor("insightface_arcface", batch_size=256, device="cuda",
                             params=params)
    ex.extract_batch(crops)
    torch.cuda.synchronize()
    before = kernel_launches()
    ex.extract_batch(crops)
    after = kernel_launches()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert delta == {"bn_act": 99}


def _fault(params, name):
    """``perfbench/faults.py``'s faults as edits of the parameters, so that
    they reach the eager passes and K6 alike."""
    p = copy.deepcopy(params)

    def bns(tree):
        for key, v in tree.items():
            if isinstance(v, dict) and "gamma" in v:
                yield v
            elif isinstance(v, dict):
                yield from bns(v)

    eps = np.float32(k6.BN_EPS)
    for bn in bns(p):
        if name == "bn_dropped":
            bn.update(gamma=np.ones_like(bn["gamma"]), beta=np.zeros_like(bn["beta"]),
                      mean=np.zeros_like(bn["mean"]), var=np.ones_like(bn["var"]) - eps)
        elif name == "bn_mean_dropped":
            bn["mean"] = np.zeros_like(bn["mean"])
        elif name == "bn_beta_dropped":
            bn["beta"] = np.zeros_like(bn["beta"])
        elif name == "bn_var_unrooted":     # rsqrt(var' + eps) = 1 / (var + eps)
            bn["var"] = (np.float32(bn["var"]) + eps) ** 2 - eps
    if name == "prelu_slopes_flipped":
        for key, v in list(p.items()):
            if key == "relu0_alpha":
                p[key] = v[::-1].copy()
            elif isinstance(v, dict) and "relu1_alpha" in v:
                v["relu1_alpha"] = v["relu1_alpha"][::-1].copy()
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["bn_dropped", "bn_var_unrooted", "bn_mean_dropped",
                                   "bn_beta_dropped", "prelu_slopes_flipped"])
def test_planted_faults_read_over_the_cell_limit(card, r100, fault, monkeypatch):
    """Each fault, planted in the parameters, moves K6's embeddings of 32
    crops further than ``EMB_LIMIT`` from the plain reference on the sound
    weights, and the eager trunk on the same faulted parameters gives K6's
    answer."""
    params, cfg, ref, crops = r100
    crops = crops[:32]
    want = ref.embed(params, crops, "cuda", cfg)
    assert _rel_err(_embed(params, crops), want) <= EMB_LIMIT
    bad = _fault(params, fault)
    got = _embed(bad, crops)
    assert _rel_err(got, want) > EMB_LIMIT
    monkeypatch.setattr(arcface, "_trunk_fused", arcface._trunk)
    assert _rel_err(got, _embed(bad, crops)) <= 1e-6
