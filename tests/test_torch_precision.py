"""The precision dial of the PyTorch port against the JAX package, on the CPU.

Every forward of the port takes the reference's ``precision`` as a tier
("highest", "high", "default": ``jax.lax.Precision.X`` is ``X.name.lower()``)
and holds it itself (``numerics.precision_scope``), where the reference fixes
it into its jitted program. Checked here:

- each forward at each tier against the JAX function at the same
  ``Precision``, on the same seeded numpy inputs, at small widths, within
  that module's f32 tolerance in the other ``test_torch_*`` files (named
  at each check). On the CPU the tiers compute the same float32 sums on
  both sides, so this holds the dial's threading, not TF32's rounding,
  which only the card shows (``chip_smoke.py``, phase ``tiers``);
- the four zoo models with ``compute_dtype=bfloat16`` and ``multihead_apply``
  at ``bf16_blocks_below`` 0, 4 and 14 against JAX's bf16: identity cosine
  >= 0.999 (BF16_COS; the lowest seen here is in each check's comment);
- every default resolves to "highest";
- inside each entry point's forward the flags read at op time (through a
  wrapped ``F.conv2d`` / ``F.linear``) equal the object's tier, with the
  global flags set the other way first; two threads at different tiers
  each see only their own tier at every op; two at one tier share the gate;
- a parameter-name check of the JAX package's public functions against the
  port's, with the TPU-only names and the renamed ones allow-listed.
"""

import ast
import importlib
import inspect
import pathlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hse_facerec_tf_tpu.core import graph_compiler as jgc
from hse_facerec_tf_tpu.models import arcface as jarc
from hse_facerec_tf_tpu.models import bknet as jbk
from hse_facerec_tf_tpu.models import inception_resnet as jir
from hse_facerec_tf_tpu.models import mobilenet as jmb
from hse_facerec_tf_tpu.models import mobilenet_v2 as jmn2
from hse_facerec_tf_tpu.models import mtcnn as jm
from hse_facerec_tf_tpu.models import multihead as jmh
from hse_facerec_tf_tpu.models import resnet as jrn
from hse_facerec_tf_tpu.models import ssrnet as jssr
from hse_facerec_tf_tpu.models import vgg16 as jvgg
from hse_facerec_tf_tpu.models import wide_resnet as jwrn
from hse_facerec_tf_tpu.models import zoo as jzoo
from hse_facerec_tf_tpu.ops import distance as jd
from hse_facerec_tf_tpu.ops import resize as jrs
from hse_facerec_tf_tpu.pipelines.analyzer import FacialAnalyzer as JaxAnalyzer
from hse_facerec_tf_tpu.pipelines.detector import MTCNNDetector as JaxDetector
from hse_facerec_tf_tpu.pipelines.embedder import EmbeddingExtractor as JaxExtractor
from hse_facerec_tf_tpu.pipelines.heads import MultiheadHeads as JaxHeads
from hse_facerec_tf_tpu.pipelines.heads import TwoModelHeads as JaxTwoModelHeads
from hse_facerec_tf_tpu.train import age_gender as jag
from hse_facerec_tf_tpu.train import face_id as jf
from hse_facerec_torch import numerics
from hse_facerec_torch import params as P
from hse_facerec_torch.core import graph_compiler as tgc
from hse_facerec_torch.core import graphdef_export as texp
from hse_facerec_torch.models import arcface as tarc
from hse_facerec_torch.models import bknet as tbk
from hse_facerec_torch.models import inception_resnet as tir
from hse_facerec_torch.models import mobilenet as tmb
from hse_facerec_torch.models import mobilenet_v2 as tmn2
from hse_facerec_torch.models import mtcnn as tm
from hse_facerec_torch.models import multihead as tmh
from hse_facerec_torch.models import resnet as trn
from hse_facerec_torch.models import ssrnet as tssr
from hse_facerec_torch.models import vgg16 as tvgg
from hse_facerec_torch.models import wide_resnet as twrn
from hse_facerec_torch.models import zoo as tzoo
from hse_facerec_torch.ops import distance as td
from hse_facerec_torch.ops import resize as trs
from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
from hse_facerec_torch.pipelines.detector import MTCNNDetector
from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor
from hse_facerec_torch.pipelines.heads import (Int8MultiheadHeads, MultiheadHeads,
                                               TwoModelHeads)
from hse_facerec_torch.testing import (random_mobilenet_params, random_mtcnn_params,
                                       random_multihead_params, random_resnet50_params)
from hse_facerec_torch.train import age_gender as tag
from hse_facerec_torch.train import face_id as tf

from .test_torch_analyzer import CASES, H, W, _photo

TIERS = {"highest": jax.lax.Precision.HIGHEST, "high": jax.lax.Precision.HIGH,
         "default": jax.lax.Precision.DEFAULT}
MODE = {"highest": "ieee", "high": "tf32", "default": "tf32"}
OTHER = {"ieee": "tf32", "tf32": "ieee"}
BF16_COS = 0.999
FACE = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, atol=1e-4, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _close_scaled(got, want):
    """test_torch_backbones.py's tolerance: rtol and atol 1e-4, the atol
    scaled to the output's magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cos_min(a, b):
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    num = np.sum(a * b, 1)
    return float(np.min(num / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))))


def _flags():
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.cudnn.conv.fp32_precision)


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = _flags()
    yield
    torch.backends.cuda.matmul.fp32_precision = saved[0]
    torch.backends.cudnn.conv.fp32_precision = saved[1]


def _set_global(mode):
    torch.backends.cuda.matmul.fp32_precision = mode
    torch.backends.cudnn.conv.fp32_precision = mode


@pytest.fixture(scope="module")
def mtcnn_np():
    return random_mtcnn_params(np.random.RandomState(CASES["fits"][0]))


@pytest.fixture(scope="module")
def multihead_np():
    return random_multihead_params(np.random.RandomState(100))


@pytest.fixture(scope="module")
def face_pbs(tmp_path_factory, multihead_np):
    """The seeded multi-head model's age half at 48² and gender half at
    the crop size, as test_torch_agegender.py writes them."""
    d = tmp_path_factory.mktemp("halves")
    age, gender = str(d / "age_net.pb"), str(d / "gender_net.pb")
    texp.export_age_pb(multihead_np, age, input_size=48)
    texp.export_gender_pb(multihead_np, gender, input_size=FACE)
    return age, gender


@pytest.fixture(scope="module")
def multihead_pb(tmp_path_factory, multihead_np):
    path = str(tmp_path_factory.mktemp("mh") / "multihead.pb")
    texp.export_multihead_pb(multihead_np, path, input_size=FACE)
    return path


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def mobilenet_bn():
    """The training-form (BN) MobileNet at width 0.25 with a 5-class
    classifier, numpy in the reference's layouts (the port's seeded init)."""
    return P.to_numpy(tmb.init_mobilenet_params(_gen(0), n_classes=5, width=0.25,
                                                device="cpu"))


@pytest.fixture(scope="module")
def age_gender_np():
    """A width-0.25 trunk and the age/gender heads on its 256-d embedding."""
    backbone = P.to_numpy(tmb.init_mobilenet_params(_gen(1), width=0.25, device="cpu"))
    heads = P.to_numpy(tag.init_head_params(_gen(2), backbone_dim=256, device="cpu"))
    return {"backbone": backbone, **heads}


# ---------------------------------------------------------------- the gate

def test_scope_sets_and_restores_the_flags():
    _set_global("tf32")
    with numerics.precision_scope("highest"):
        assert _flags() == ("ieee", "ieee")
        with numerics.precision_scope("default"):
            assert _flags() == ("tf32", "tf32")
            with numerics.precision_scope():          # inherits
                assert _flags() == ("tf32", "tf32")
        assert _flags() == ("ieee", "ieee")
    assert _flags() == ("tf32", "tf32")
    with numerics.precision_scope():                  # outside any: highest
        assert _flags() == ("ieee", "ieee")
    assert _flags() == ("tf32", "tf32")


@pytest.mark.parametrize("bad", ["HIGHEST", "tf32", "bf16", ""])
def test_unknown_tier_is_refused(bad, mtcnn_np):
    with pytest.raises(ValueError, match="precision must be one of"):
        with numerics.precision_scope(bad):
            pass
    with pytest.raises(ValueError, match="precision must be one of"):
        MTCNNDetector(mtcnn_np, device="cpu", precision=bad)


def test_one_tier_shares_the_gate():
    """Two threads at one tier are inside their scopes at the same time:
    each waits, inside its scope, for the other to enter."""
    inside = [threading.Event(), threading.Event()]
    ok = [False, False]

    def run(i):
        with numerics.precision_scope("high"):
            inside[i].set()
            ok[i] = inside[1 - i].wait(timeout=10)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert ok == [True, True]


def test_a_thread_without_a_tier_joins_the_holder():
    """``precision_scope()`` in a thread with no scope of its own (the
    autograd engine's worker recomputing a checkpointed block while its
    caller holds the gate) joins the holder's setting without waiting; with
    the gate free it takes "highest"."""
    seen = {}

    def worker():
        with numerics.precision_scope():
            seen["flags"] = _flags()

    with numerics.precision_scope("high"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen["flags"] == ("tf32", "tf32")
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert seen["flags"] == ("ieee", "ieee")


def test_another_tier_waits_for_the_holders():
    """A thread at another tier enters only after the holder left, and sees
    its own flags there."""
    entered, release = threading.Event(), threading.Event()
    seen = {}

    def holder():
        with numerics.precision_scope("highest"):
            entered.set()
            release.wait(timeout=10)
            seen["holder_left"] = time.perf_counter()

    def other():
        entered.wait(timeout=10)
        with numerics.precision_scope("default"):
            seen["other_in"] = time.perf_counter()
            seen["other_flags"] = _flags()

    threads = [threading.Thread(target=holder), threading.Thread(target=other)]
    for t in threads:
        t.start()
    entered.wait(timeout=10)
    time.sleep(0.2)
    assert "other_in" not in seen
    release.set()
    for t in threads:
        t.join(timeout=20)
    assert seen["other_in"] >= seen["holder_left"]
    assert seen["other_flags"] == ("tf32", "tf32")


# ---------------------------------------------------------------- each forward at each tier

@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("net,shape", [("pnet", (1, 37, 29, 3)), ("rnet", (7, 24, 24, 3)),
                                       ("onet", (5, 48, 48, 3))])
def test_mtcnn_nets_at_tier(mtcnn_np, net, shape, tier):
    """test_torch_models.py's tolerance: 1e-4 absolute."""
    x = np.random.RandomState(0).uniform(-1, 1, shape).astype(np.float32)
    want = jax.jit(lambda v: getattr(jm, net)(mtcnn_np[net], v,
                                              precision=TIERS[tier]))(x)
    got = getattr(tm, net)(P.to_torch(mtcnn_np, "cpu")[net], _t(x), precision=tier)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_detector_at_tier(mtcnn_np, tier):
    """test_torch_analyzer.py's tolerances: valid masks equal, boxes within
    1 px, scores within 1e-4."""
    _, img_seed, det_kw, _ = CASES["fits"]
    jdet = JaxDetector(mtcnn_np, minsize=20, precision=TIERS[tier], **det_kw)
    det = MTCNNDetector(mtcnn_np, device="cpu", minsize=20, precision=tier, **det_kw)
    assert det.precision == tier
    img = _photo(img_seed)
    want = jax.device_get(jdet.detect_fn(H, W)(img))
    boxes, scores, points, valid, truncated = [t.numpy() for t in
                                               det.detect_core(det.upload(img))]
    np.testing.assert_array_equal(valid, want[3])
    assert valid.sum() > 0
    _close(boxes[valid], want[0][valid], atol=1.0)
    _close(scores[valid], want[1][valid], atol=1e-4)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_multihead_heads_at_tier(multihead_np, tier):
    """test_torch_analyzer.py's tolerances: ages within 1e-3, P(male)
    within 1e-4, identity cosine above 0.9999."""
    crops = (np.random.RandomState(3).rand(3, FACE, FACE, 3) * 255).astype(np.float32)
    jh = JaxHeads(multihead_np, precision=TIERS[tier])
    want = jax.device_get(jax.jit(jh.apply)(jh.params, jnp.asarray(crops)))
    th = MultiheadHeads(multihead_np, "cpu", precision=tier)
    assert th.precision == tier
    got = [t.numpy() for t in th.apply(_t(crops))]
    _close(got[0], want[0], atol=1e-3)
    _close(got[1], want[1], atol=1e-4)
    assert _cos_min(got[2], want[2]) > 0.9999


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_two_model_heads_at_tier(face_pbs, tier):
    """test_torch_agegender.py's tolerances: ages 1e-4, P(male) 1e-5."""
    crops = (np.random.RandomState(4).rand(3, FACE, FACE, 3) * 255).astype(np.float32)
    jh = JaxTwoModelHeads(*face_pbs, precision=TIERS[tier])
    want = jax.device_get(jax.jit(jh.apply)(jh.params, jnp.asarray(crops)))
    th = TwoModelHeads(*face_pbs, "cpu", precision=tier)
    assert th._age.precision == th._gender.precision == tier
    got = [t.numpy() for t in th.apply(_t(crops))]
    _close(got[0], want[0], atol=1e-4)
    _close(got[1], want[1], atol=1e-5)


def _assert_same_faces(got, want):
    """test_torch_analyzer.py's tolerances."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _close(g.raw_bbox, w.raw_bbox, atol=1.0)
        assert g.age == pytest.approx(w.age, abs=1e-3)
        assert g.gender_prob == pytest.approx(w.gender_prob, abs=1e-4)
        if w.identity.size:
            assert _cos_min(g.identity[None], np.asarray(w.identity)[None]) > 0.9999


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_analyzer_at_tier(mtcnn_np, multihead_np, tier):
    """``detector_kwargs`` carry the detector's tier and ``with_minsize``
    copies it; ``analyze`` against the JAX analyzer at the same
    ``Precision`` (``analyze_batch``'s tier: the op-time flags test)."""
    _, img_seed, det_kw, head_batch = CASES["fits"]
    kw = dict(minsize=20, face_size=FACE, head_batch=head_batch, **det_kw)
    jan = JaxAnalyzer(mtcnn_np, heads=JaxHeads(multihead_np, precision=TIERS[tier]),
                      precision=TIERS[tier], **kw)
    an = FacialAnalyzer(mtcnn_np, device="cpu", precision=tier,
                        heads=MultiheadHeads(multihead_np, "cpu", precision=tier), **kw)
    img = _photo(img_seed)
    _assert_same_faces(an.analyze(img), jan.analyze(img))
    clone, jclone = an.with_minsize(24), jan.with_minsize(24)
    assert clone.detector.precision == tier
    assert jclone.detector.precision == TIERS[tier]


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_two_model_analyzer_head_kwargs_carry_the_tier(mtcnn_np, face_pbs, tier,
                                                       monkeypatch):
    """``from_two_model_pbs(head_kwargs={"precision": ...})`` gives both
    graphs the tier and ``detector_kwargs`` the detector (the heads and the
    detector at each tier against JAX: the tests above)."""
    from hse_facerec_torch.pipelines import analyzer as analyzer_mod

    monkeypatch.setattr(analyzer_mod, "import_mtcnn_params", lambda path: mtcnn_np)
    _, img_seed, det_kw, head_batch = CASES["fits"]
    kw = dict(minsize=20, face_size=FACE, head_batch=head_batch, **det_kw)
    an = FacialAnalyzer.from_two_model_pbs("mtcnn.pb", *face_pbs, device="cpu",
                                           head_kwargs={"precision": tier},
                                           precision=tier, **kw)
    assert an.heads.precision == an.detector.precision == tier
    assert an.heads._age.precision == an.heads._gender.precision == tier
    faces = an.analyze(_photo(img_seed))
    assert faces and all(f.identity.shape == (0,) for f in faces)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_mobilenet_forwards_at_tier(mobilenet_bn, tier):
    """The training-form (BN) MobileNet at width 0.25 in float32, at
    test_torch_train.py's float32 tolerance (2e-4 relative L2): backbone,
    embedding and classifier."""
    jp = mobilenet_bn
    tp = P.to_torch(jp, "cpu")
    x = np.random.RandomState(5).randn(3, 48, 48, 3).astype(np.float32)
    prec = TIERS[tier]
    for jfn, tfn in ((jmb.mobilenet_v1_backbone, tmb.mobilenet_v1_backbone),
                     (jmb.mobilenet_embed, tmb.mobilenet_embed),
                     (jmb.mobilenet_classify, tmb.mobilenet_classify)):
        want = jax.jit(lambda v: jfn(jp, v, precision=prec))(x)
        with torch.no_grad():
            got = tfn(tp, _t(x), precision=tier)
        assert _rel(got.numpy(), want) < 2e-4, jfn.__name__


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_multihead_apply_at_tier(multihead_np, tier):
    """test_torch_models.py's tolerance: 1e-4 absolute."""
    x = (np.random.RandomState(6).rand(2, FACE, FACE, 3) * 255 - 120).astype(np.float32)
    want = jax.jit(lambda v: jmh.multihead_apply(multihead_np, v,
                                                 precision=TIERS[tier]))(x)
    got = tmh.multihead_apply(P.to_torch(multihead_np, "cpu"), _t(x), precision=tier)
    for name in ("age_probs", "gender_prob", "identity", "feats"):
        _close(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_graph_compiler_at_tier(multihead_pb, tier):
    """test_torch_graph.py's tolerance: 1e-4 absolute; ``compile_pb``,
    ``compile_graph`` and ``CompiledGraph`` all take the tier."""
    from hse_facerec_torch.core.graphdef import load_graphdef

    out = ["global_pooling/Mean:0"]
    x = (np.random.RandomState(7).rand(2, FACE, FACE, 3) * 255 - 120).astype(np.float32)
    jcg = jgc.compile_pb(multihead_pb, out, precision=TIERS[tier])
    (want,) = jcg.jit()(jcg.params, {"input_1": x})
    for tcg in (tgc.compile_pb(multihead_pb, out, precision=tier),
                tgc.compile_graph(load_graphdef(multihead_pb), out, precision=tier)):
        assert tcg.precision == tier
        (got,) = tcg.fn(tcg.torch_params("cpu"), {"input_1": _t(x)})
        _close(got, want)


def _narrow_vgg16(rng):
    """VGG16's 13 convs and two FC layers at 4 channels: the forward reads
    every width from the params (a 32² input pools to 1x1x4)."""
    params = {}
    cin = 3
    for block, n_convs, _ in tvgg.VGG16_BLOCKS:
        for i in range(1, n_convs + 1):
            params[f"conv{block}_{i}"] = {
                "kernel": (rng.randn(3, 3, cin, 4) * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
                "bias": (rng.randn(4) * 0.1).astype(np.float32)}
            cin = 4
    for name, fi in (("fc6", 4), ("fc7", 8)):
        params[name] = {"kernel": (rng.randn(fi, 8) * 0.5).astype(np.float32),
                        "bias": (rng.randn(8) * 0.1).astype(np.float32)}
    return params


def _zoo_case(name, bf16=False):
    """(params, input, JAX forward f(params, x, precision, **kw), port forward)
    of a zoo model at a small size; Inception-ResNet and MobileNetV2 with
    their heads (which run the backbone at the tier), or with ``bf16`` the
    backbones, which take ``compute_dtype``."""
    rng = np.random.RandomState(8)
    if name == "resnet50":
        return (random_resnet50_params(np.random.RandomState(15)),
                (rng.rand(2, 64, 64, 3) * 255 - 120).astype(np.float32),
                jrn.resnet50_embed, trn.resnet50_embed)
    if name == "vgg16":
        return (_narrow_vgg16(rng), (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32),
                jvgg.vgg16_embed, tvgg.vgg16_embed)
    if name == "ssrnet":
        return (tssr.init_ssrnet_params(_gen(3)), (rng.rand(2, 64, 64, 3) * 255).astype(np.float32),
                jssr.ssrnet_apply, tssr.ssrnet_apply)
    if name == "bknet":
        return (tbk.init_bknet_params(_gen(1)), (rng.rand(2, 48, 48, 1) - 0.5).astype(np.float32),
                jbk.bknet_apply, tbk.bknet_apply)
    if name == "arcface":
        return (tarc.init_iresnet_params(_gen(11), depth=34, emb_dim=64),
                (rng.rand(2, 112, 112, 3) * 255).astype(np.float32),
                jarc.iresnet_embed, tarc.iresnet_embed)
    if name == "inception_resnet":
        return (tir.init_inception_resnet_v1_params(_gen(9), with_heads=True),
                ((rng.rand(1, 96, 96, 3) - 0.5) * 2).astype(np.float32),
                *((jir.inception_resnet_v1, tir.inception_resnet_v1) if bf16 else
                  (jir.inception_resnet_v1_age_gender, tir.inception_resnet_v1_age_gender)))
    if name == "wide_resnet":
        return (twrn.init_wide_resnet_params(_gen(5), k=2),    # unsaturated heads
                (rng.rand(2, 64, 64, 3) - 0.5).astype(np.float32),
                jwrn.wide_resnet_16_8, twrn.wide_resnet_16_8)
    if name == "mobilenet_v2":
        if bf16:
            return (tmn2.init_mobilenet_v2_params(_gen(7)),
                    (rng.rand(2, 96, 96, 3) * 2 - 1).astype(np.float32),
                    jmn2.mobilenet_v2_backbone, tmn2.mobilenet_v2_backbone)
        return (tmn2.init_mobilenet_v2_params(_gen(7)),
                (rng.rand(2, 96, 96, 3) * 255).astype(np.float32),
                jmn2.agendernet_apply, tmn2.agendernet_apply)
    raise KeyError(name)


def _port(fn, params, x, **kw):
    with torch.no_grad():
        out = fn(P.tree_to_torch(params, "cpu"), _t(x), **kw)
    return [o.float().numpy() for o in out] if isinstance(out, tuple) else out.float().numpy()


def _jax(fn, params, x, **kw):
    out = jax.jit(lambda p, v: fn(p, v, **kw))(_jnp(params), x)
    return ([np.asarray(o, np.float32) for o in out] if isinstance(out, tuple)
            else np.asarray(out, np.float32))


ZOO = ["resnet50", "vgg16", "ssrnet", "bknet", "arcface", "inception_resnet",
       "wide_resnet", "mobilenet_v2"]
BF16_ZOO = ["arcface", "inception_resnet", "wide_resnet", "mobilenet_v2"]


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", ZOO)
def test_zoo_models_at_tier(name, tier):
    """Each zoo model's forward (Inception-ResNet's age/gender logits and
    AgenderNet's probabilities, which run their backbones at the tier) at
    test_torch_graph.py's 1e-4 absolute for ResNet-50, test_torch_backbones.py's
    scaled 1e-4 for the others."""
    params, x, jfn, tfn = _zoo_case(name)
    want = _jax(jfn, params, x, precision=TIERS[tier])
    got = _port(tfn, params, x, precision=tier)
    for g, w in zip(*((got, want) if isinstance(got, list) else ([got], [want]))):
        if name == "resnet50":
            _close(g, w)
        else:
            _close_scaled(g, w)


@pytest.mark.parametrize("name", BF16_ZOO)
def test_zoo_models_bf16(name, monkeypatch):
    """``compute_dtype=bfloat16`` against JAX's bf16 at the same tier:
    cosine >= BF16_COS per row (lowest seen: arcface 0.99994,
    inception_resnet 0.99997, wide_resnet 0.9996 on the age probabilities,
    mobilenet_v2 0.999999), every conv of the port on bf16 operands."""
    params, x, jfn, tfn = _zoo_case(name, bf16=True)
    want = _jax(jfn, params, x, precision=TIERS["default"], compute_dtype=jnp.bfloat16)
    dtypes = []
    conv = F.conv2d

    def rec(v, w, *a, **k):
        dtypes.append((v.dtype, w.dtype))
        return conv(v, w, *a, **k)

    monkeypatch.setattr(F, "conv2d", rec)
    got = _port(tfn, params, x, precision="default", compute_dtype=torch.bfloat16)
    assert dtypes and set(dtypes) == {(torch.bfloat16, torch.bfloat16)}
    if not isinstance(got, list):
        got, want = [got], [want]
    for g, w in zip(got, want):
        assert np.all(np.isfinite(g))
        assert _cos_min(g, w) >= BF16_COS


@pytest.mark.parametrize("below", [0, 4, 14])
def test_multihead_bf16_blocks_below(multihead_np, below):
    """``multihead_apply(bf16_blocks_below=k)``: blocks below k (conv1 = 0)
    in bf16 against JAX's same dial, identity cosine >= BF16_COS (lowest
    seen 0.99999 at 4, 0.99997 at 14), probabilities within 2e-3 (3.2e-4
    seen); at 0 the f32 answer at test_torch_models.py's 1e-4."""
    x = (np.random.RandomState(10).rand(2, FACE, FACE, 3) * 255 - 120).astype(np.float32)
    want = jax.jit(lambda v: jmh.multihead_apply(
        multihead_np, v, precision=jax.lax.Precision.HIGHEST,
        bf16_blocks_below=below))(x)
    got = tmh.multihead_apply(P.to_torch(multihead_np, "cpu"), _t(x),
                              bf16_blocks_below=below)
    assert got.identity.dtype == torch.float32
    assert _cos_min(got.identity.numpy(), want.identity) >= BF16_COS
    _close(got.gender_prob, want.gender_prob, atol=2e-3)
    _close(got.age_probs, want.age_probs, atol=2e-3)
    if below == 0:
        _close(got.identity, want.identity)
    else:
        f32 = tmh.multihead_apply(P.to_torch(multihead_np, "cpu"), _t(x))
        assert not torch.equal(got.identity, f32.identity)


def test_mobilenet_bf16_blocks_run_in_bf16(multihead_np, monkeypatch):
    """The blocks below ``bf16_blocks_below`` (conv1 = 0) get bf16 inputs,
    the rest float32: 1 + 2·3 convs in bf16 at 4."""
    dtypes = []
    conv = F.conv2d

    def rec(x, w, *a, **k):
        dtypes.append(x.dtype)
        return conv(x, w, *a, **k)

    monkeypatch.setattr(F, "conv2d", rec)
    x = torch.zeros(1, 32, 32, 3)
    tmb.mobilenet_v1_backbone(P.to_torch(multihead_np, "cpu")["backbone"], x,
                              bf16_blocks_below=4)
    assert dtypes == [torch.bfloat16] * 7 + [torch.float32] * 20


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", ["agegender_identity", "vgg2_mobilenet", "vgg2_resnet"])
def test_zoo_extractors_at_tier(name, tier):
    """``ModelSpec.model_fn(precision)`` and ``build_extractor(precision=)``
    against the JAX entry's ``model_fn(precision)`` in its extractor, on
    seeded params (test_torch_graph.py's 1e-4 absolute)."""
    params = (random_resnet50_params if "resnet" in name else
              random_multihead_params if name == "agegender_identity" else
              random_mobilenet_params)(np.random.RandomState(18))
    spec = jzoo.MODEL_ZOO[name]
    imgs = (np.random.RandomState(11).rand(2, 70, 60, 3) * 255).astype(np.uint8)
    kw = dict(normalization=spec.normalization, resize_method=spec.resize_method,
              batch_size=8)
    want = JaxExtractor(spec.model_fn(TIERS[tier]), params, (64, 64), **kw).extract_batch(imgs)
    got = EmbeddingExtractor(tzoo.MODEL_ZOO[name].model_fn(tier), params, (64, 64),
                             device="cpu", **kw).extract_batch(imgs)
    _close(got, want)
    ex = tzoo.build_extractor(name, batch_size=8, device="cpu", params=params,
                              precision=tier)
    np.testing.assert_array_equal(ex.model_fn.keywords["precision"], tier)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_graph_extractor_at_tier(multihead_pb, tier):
    imgs = (np.random.RandomState(12).rand(2, FACE, FACE, 3) * 255).astype(np.uint8)
    args = (multihead_pb, "input_1:0", "global_pooling/Mean:0", (FACE, FACE))
    want = jzoo.graph_extractor(*args, batch_size=8,
                                precision=TIERS[tier]).extract_batch(imgs)
    got = tzoo.graph_extractor(*args, batch_size=8, device="cpu",
                               precision=tier).extract_batch(imgs)
    _close(got, want)


def test_embedder_stores_compute_dtype(multihead_np):
    """The reference stores ``compute_dtype`` and reads it nowhere; so does
    the port."""
    fn = tzoo.MODEL_ZOO["agegender_identity"].model_fn()
    ex = EmbeddingExtractor(fn, multihead_np, (FACE, FACE), device="cpu",
                            compute_dtype=torch.bfloat16)
    jex = JaxExtractor(jzoo.MODEL_ZOO["agegender_identity"].model_fn(), multihead_np,
                       (FACE, FACE), compute_dtype=jnp.bfloat16)
    assert ex.compute_dtype == torch.bfloat16 and jex.compute_dtype == jnp.bfloat16
    assert EmbeddingExtractor(fn, multihead_np, (FACE, FACE),
                              device="cpu").compute_dtype == torch.float32


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_distance_ops_at_tier(tier):
    """test_torch_identification.py's 1e-5 relative on the distances; the
    1-NN and top-k indices equal."""
    rng = np.random.RandomState(13)
    g, p = rng.randn(20, 16).astype(np.float32), rng.randn(7, 16).astype(np.float32)
    labels = np.arange(20)
    prec = TIERS[tier]
    for name in ("pairwise_sqeuclidean", "pairwise_euclidean", "pairwise_cosine"):
        want = getattr(jd, name)(jnp.asarray(p), jnp.asarray(g), precision=prec)
        got = getattr(td, name)(_t(p), _t(g), precision=tier)
        _close(got, want, atol=1e-5, rtol=1e-5)
    for metric in ("euclidean", "cosine"):
        wl, wd = jd.nearest_neighbor(jnp.asarray(g), jnp.asarray(labels),
                                     jnp.asarray(p), metric, precision=prec)
        gl, gd = td.nearest_neighbor(_t(g), _t(labels), _t(p), metric, precision=tier)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        _close(gd, wd, atol=1e-5, rtol=1e-5)
        wi, wk = jd.top_k_neighbors(jnp.asarray(g), jnp.asarray(p), 3, metric,
                                    precision=prec)
        gi, gk = td.top_k_neighbors(_t(g), _t(p), 3, metric, precision=tier)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        _close(gk, wk, atol=1e-5, rtol=1e-5)
    x = rng.randn(4, 5, 6).astype(np.float32)
    for axis in (0, 1, -1):
        _close(td.l2_normalize(_t(x), axis=axis), jd.l2_normalize(jnp.asarray(x), axis=axis),
               atol=1e-6)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_resize_ops_at_tier(tier):
    """test_torch_ops.py's tolerances: 1e-3 absolute on 0-255 pixels."""
    rng = np.random.RandomState(14)
    img = (rng.rand(2, 30, 40, 3) * 255).astype(np.float32)
    prec = TIERS[tier]
    for method in ("cv2_linear", "cv2_area", "pil_bilinear"):
        _close(trs.resize(_t(img), (17, 23), method, precision=tier),
               jrs.resize(jnp.asarray(img), (17, 23), method, precision=prec), atol=1e-3)
        sizes = [(20, 26), (11, 15)]
        for g, w in zip(trs.resize_pyramid(_t(img[0]), sizes, method, precision=tier),
                        jrs.resize_pyramid(jnp.asarray(img[0]), sizes, method,
                                           precision=prec)):
            _close(g, w, atol=1e-3)
    boxes = np.array([[2.5, 3.0, 20.0, 30.5], [-4.0, -2.0, 12.0, 9.0]], np.float32)
    _close(trs.crop_resize_bilinear(_t(img[0]), _t(boxes), 8, 2, "zero", precision=tier),
           jrs.crop_resize_bilinear(jnp.asarray(img[0]), jnp.asarray(boxes), 8, 2, "zero",
                                    precision=prec), atol=1e-3)
    lanes = np.array([1, 0], np.int32)
    _close(trs.crop_resize_bilinear_lanes(_t(img), _t(lanes), _t(boxes), 8,
                                          precision=tier),
           jrs.crop_resize_bilinear_lanes(jnp.asarray(img), jnp.asarray(lanes),
                                          jnp.asarray(boxes), 8, precision=prec), atol=1e-3)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_face_id_forwards_at_tier(mobilenet_bn, tier):
    """``forward_train``, ``forward_eval`` and ``loss_fn`` in float32 at
    test_torch_train.py's tolerances (2e-4 relative L2 on logits, 1e-5
    relative on the loss)."""
    jp = mobilenet_bn
    tp = P.to_torch(jp, "cpu")
    rng = np.random.RandomState(15)
    x = rng.randn(6, 48, 48, 3).astype(np.float32)
    y = rng.randint(0, 5, 6).astype(np.int32)
    prec = TIERS[tier]
    logits, _ = jax.jit(lambda v: jf.forward_train(jp, v, precision=prec,
                                                   compute_dtype=jnp.float32))(x)
    with torch.no_grad():
        t_logits, _ = tf.forward_train(tp, _t(x), precision=tier,
                                       compute_dtype=torch.float32)
        t_eval = tf.forward_eval(tp, _t(x), precision=tier, compute_dtype=torch.float32)
        t_loss, _ = tf.loss_fn(tp, _t(x), _t(y).long(), 4e-5, precision=tier,
                               compute_dtype=torch.float32)
    assert _rel(t_logits.numpy(), logits) < 2e-4
    # the JAX forward_eval is fixed at bf16, so the port's f32 eval is held
    # against its own f32 classifier at the same tier
    want_eval = jax.jit(lambda v: jmb.mobilenet_classify(jp, v, precision=prec))(x)
    assert _rel(t_eval.numpy(), want_eval) < 2e-4
    loss, _ = jax.jit(lambda v: jf.loss_fn(jp, v, y, 4e-5, precision=prec,
                                           compute_dtype=jnp.float32))(x)
    assert abs(float(t_loss) - float(loss)) <= 1e-5 * abs(float(loss))


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_age_gender_forward_at_tier(age_gender_np, tier):
    """``train.age_gender.forward`` in float32, inference BN, no dropout:
    2e-4 relative L2 (test_torch_train_age_gender.py's float32 forward)."""
    jp = age_gender_np
    tp = P.to_torch(jp, "cpu")
    x = np.random.RandomState(16).randn(4, 48, 48, 3).astype(np.float32)
    age, gender, _ = jax.jit(lambda v: jag.forward(
        jp, v, precision=TIERS[tier], compute_dtype=jnp.float32))(x)
    with torch.no_grad():
        t_age, t_gender, _ = tag.forward(tp, _t(x), precision=tier,
                                         compute_dtype=torch.float32)
    assert _rel(t_age.numpy(), age) < 2e-4
    assert _rel(t_gender.numpy(), gender) < 2e-4


# ---------------------------------------------------------------- defaults

# every forward of Tentpole step 2 with a ``precision`` parameter
FORWARDS = [tm.pnet, tm.rnet, tm.onet, tmb.mobilenet_v1_backbone, tmb.mobilenet_embed,
            tmb.mobilenet_classify, tmh.multihead_apply, tgc.compile_graph,
            tgc.compile_pb, tgc.CompiledGraph, trn.resnet50_backbone, trn.resnet50_embed,
            trn.resnet50_classify, tvgg.vgg16_embed, tssr.ssrnet_apply, tbk.bknet_apply,
            tarc.iresnet_embed, tir.inception_resnet_v1,
            tir.inception_resnet_v1_age_gender, twrn.wide_resnet_16_8,
            tmn2.mobilenet_v2_backbone, tmn2.agendernet_apply,
            tzoo.ModelSpec.model_fn, tzoo.build_extractor, tzoo.graph_extractor,
            td.pairwise_sqeuclidean, td.pairwise_euclidean, td.pairwise_cosine,
            td.nearest_neighbor, td.top_k_neighbors, trs.resize, trs.resize_pyramid,
            trs.crop_resize_bilinear, trs.crop_resize_bilinear_lanes, tf.forward_train, tf.forward_eval,
            tf.loss_fn, tag.forward, MTCNNDetector, MultiheadHeads, TwoModelHeads]


@pytest.mark.parametrize("fn", FORWARDS, ids=lambda f: f.__qualname__)
def test_every_default_is_highest(fn):
    assert inspect.signature(fn).parameters["precision"].default == "highest"


def test_default_objects_hold_highest(mtcnn_np, multihead_np, face_pbs):
    an = FacialAnalyzer(mtcnn_np, multihead_np, device="cpu")
    assert an.detector.precision == an.heads.precision == "highest"
    assert TwoModelHeads(*face_pbs, "cpu").precision == "highest"
    assert tzoo.MODEL_ZOO["vgg2_mobilenet"].model_fn().keywords["precision"] == "highest"
    # the building blocks inherit the forward's tier, "highest" outside any
    from hse_facerec_torch.models import layers

    for fn in (layers.conv2d, layers.depthwise_conv2d, layers.dense):
        assert inspect.signature(fn).parameters["precision"].default is None


# ---------------------------------------------------------------- flags at op time

class _OpFlags:
    """Wraps ``F.conv2d`` and ``F.linear``: each call records the calling
    thread and the (matmul, conv) flags it dispatched under."""

    def __init__(self, monkeypatch):
        self.seen = []
        self._lock = threading.Lock()
        for name in ("conv2d", "linear"):
            monkeypatch.setattr(F, name, self._wrap(getattr(F, name)))

    def _wrap(self, fn):
        def wrapped(*args, **kwargs):
            with self._lock:
                self.seen.append((threading.get_ident(), _flags()))
            return fn(*args, **kwargs)

        return wrapped

    def modes(self, thread=None):
        return {f for t, f in self.seen if thread is None or t == thread}


def _entry_points(name, tier, mtcnn_np, multihead_np, face_pbs, multihead_pb):
    """() -> the entry point's call at ``tier``."""
    img = _photo(CASES["fits"][1])
    crops = torch.from_numpy((np.random.RandomState(1).rand(2, FACE, FACE, 3) * 255)
                             .astype(np.float32))
    _, _, det_kw, head_batch = CASES["fits"]
    kw = dict(minsize=20, face_size=FACE, head_batch=head_batch, **det_kw)
    if name == "detector":
        det = MTCNNDetector(mtcnn_np, device="cpu", minsize=20, precision=tier, **det_kw)
        return lambda: det.detect(img)
    if name == "multihead_heads":
        heads = MultiheadHeads(multihead_np, "cpu", precision=tier)
        return lambda: heads.apply(crops)
    if name == "two_model_heads":
        heads = TwoModelHeads(*face_pbs, "cpu", precision=tier)
        return lambda: heads.apply(crops)
    if name in ("analyze", "analyze_batch"):
        an = FacialAnalyzer(mtcnn_np, device="cpu", precision=tier,
                            heads=MultiheadHeads(multihead_np, "cpu", precision=tier), **kw)
        return ((lambda: an.analyze(img)) if name == "analyze"
                else lambda: an.analyze_batch(np.stack([img, img])))
    if name == "build_extractor":
        ex = tzoo.build_extractor("agegender_identity", batch_size=8, device="cpu",
                                  params=multihead_np, precision=tier)
        return lambda: ex.extract_batch(np.zeros((2, FACE, FACE, 3), np.uint8))
    if name == "graph_extractor":
        ex = tzoo.graph_extractor(multihead_pb, "input_1:0", "global_pooling/Mean:0",
                                  (FACE, FACE), batch_size=8, device="cpu",
                                  precision=tier)
        return lambda: ex.extract_batch(np.zeros((2, FACE, FACE, 3), np.uint8))
    if name in ZOO:
        params, x, _, tfn = _zoo_case(name)
        return lambda: _port(tfn, params, x[:1], precision=tier)
    if name == "face_id":
        tp = tmb.init_mobilenet_params(_gen(0), n_classes=5, width=0.25, device="cpu")
        x = torch.zeros(2, 32, 32, 3)
        return lambda: (tf.forward_train(tp, x, precision=tier),
                        tf.forward_eval(tp, x, precision=tier))
    raise KeyError(name)


ENTRY_POINTS = ["detector", "multihead_heads", "two_model_heads", "analyze",
                "analyze_batch", "build_extractor", "graph_extractor", "face_id",
                "resnet50", "ssrnet", "bknet", "arcface", "wide_resnet", "mobilenet_v2"]


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_ops_dispatch_at_the_objects_tier(name, tier, monkeypatch, mtcnn_np,
                                          multihead_np, face_pbs, multihead_pb):
    """With the global flags set the other way, every conv and linear op of
    the entry point's forward dispatches at the object's tier, and the
    global flags are as they were after."""
    call = _entry_points(name, tier, mtcnn_np, multihead_np, face_pbs, multihead_pb)
    mode = MODE[tier]
    _set_global(OTHER[mode])
    ops = _OpFlags(monkeypatch)
    call()
    assert ops.seen
    assert ops.modes() == {(mode, mode)}
    assert _flags() == (OTHER[mode], OTHER[mode])


def test_int8_heads_dispatch_at_highest(monkeypatch, multihead_np):
    """The int8 path takes no tier: its float convs run at "highest"
    whatever the global flags say."""
    heads = Int8MultiheadHeads(multihead_np, "cpu")
    _set_global("tf32")
    ops = _OpFlags(monkeypatch)
    heads.apply(torch.zeros(2, FACE, FACE, 3))
    assert ops.seen and ops.modes() == {("ieee", "ieee")}


def test_train_step_backward_dispatches_at_highest():
    """The face-ID train step's forward and backward (autograd's conv and
    matmul backward ops, which the F wrappers do not see) run at
    "highest" with the global flags at TF32."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from hse_facerec_torch.config import TrainConfig

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if "convolution" in name or name.startswith("aten.mm") or "addmm" in name:
                seen.append((name, _flags()))
            return func(*args, **(kwargs or {}))

    tp = tmb.init_mobilenet_params(_gen(0), n_classes=5, width=0.25, device="cpu")
    cfg = TrainConfig()
    opt = tf.make_optimizer(cfg)
    state = opt.init(tp)
    step = tf.make_train_step(cfg, opt, augment=None, compute_dtype=torch.float32)
    _set_global("tf32")
    with Record():
        step(tp, state, torch.Generator().manual_seed(0), torch.zeros(2, 32, 32, 3),
             torch.tensor([0, 1]))
    names = {n for n, _ in seen}
    assert any("convolution_backward" in n for n in names)
    assert {f for _, f in seen} == {("ieee", "ieee")}
    assert _flags() == ("tf32", "tf32")


def test_two_threads_see_only_their_own_tier(monkeypatch, mtcnn_np, multihead_np):
    """One thread runs ``analyze`` at "highest", another a zoo embed at
    "default", each three times and at once: every op of each thread ran
    at its own tier, and the "highest" answers equal a solo run's."""
    an_call = _entry_points("analyze", "highest", mtcnn_np, multihead_np, None, None)
    embed = _entry_points("build_extractor", "default", mtcnn_np, multihead_np, None, None)
    solo = an_call()
    ops = _OpFlags(monkeypatch)
    barrier = threading.Barrier(2)
    idents, answers, errors = {}, [], []

    def run(key, call, out=None):
        idents[key] = threading.get_ident()
        try:
            for _ in range(3):
                barrier.wait(timeout=30)
                r = call()
                if out is not None:
                    out.append(r)
        except Exception as e:                      # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=("highest", an_call, answers)),
               threading.Thread(target=run, args=("default", embed))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert ops.modes(idents["highest"]) == {("ieee", "ieee")}
    assert ops.modes(idents["default"]) == {("tf32", "tf32")}
    assert len(answers) == 3
    for faces in answers:
        assert len(faces) == len(solo)
        for g, w in zip(faces, solo):
            assert g.raw_bbox == w.raw_bbox and g.age == w.age
            np.testing.assert_array_equal(g.identity, w.identity)


# ---------------------------------------------------------------- parameter names

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "hse_facerec_tf_tpu", "hse_facerec_torch"

# JAX parameters and functions the port does not have, and why. Anything
# else a JAX public function takes, the port's counterpart must take.
ALLOWED = {
    # TPU-only: XLA/Mosaic workarounds and compiled-program controls
    "models/mtcnn.py:pnet": {"im2col"},
    "models/mtcnn.py:rnet": {"im2col"},
    "models/mtcnn.py:onet": {"im2col"},
    "pipelines/detector.py:MTCNNDetector.__init__": {"crop_backend"},
    "pipelines/embedder.py:EmbeddingExtractor.__init__": {"max_compiled_shapes"},
    "models/int8_infer.py:mobilenet_backbone_int8": {"pallas_pw"},
    "models/int8_infer.py:multihead_apply_int8": {"pallas_pw"},
    "models/int8_infer.py:mobilenet_embed_int8": {"pallas_pw"},
    "parallel/knn.py:nearest_neighbor_sharded": {"force_pallas"},
    "train/age_gender.py:make_steps": {"jit"},
    "core/graph_compiler.py:CompiledGraph.jit": "*",
    # the int8 hybrid prefix works around XLA's int8 conv emitter
    "models/int8_infer.py:quantize_backbone_int8": {"bf16_blocks_below"},
    "models/int8_infer.py:quantize_multihead_int8": {"bf16_blocks_below"},
    # JAX PRNG keys: explicit torch.Generators (dropout as explicit masks)
    "models/arcface.py:init_iresnet_params": {"rng"},
    "models/bknet.py:init_bknet_params": {"rng"},
    "models/inception_resnet.py:init_inception_resnet_v1_params": {"rng"},
    "models/mobilenet.py:init_mobilenet_params": {"rng"},
    "models/mobilenet_v2.py:init_mobilenet_v2_params": {"rng"},
    "models/resnet.py:init_resnet50_params": {"rng"},
    "models/ssrnet.py:init_ssrnet_params": {"rng", "input_size"},   # unused there
    "models/vgg16.py:init_vgg16_params": {"rng"},
    "models/wide_resnet.py:init_wide_resnet_params": {"rng"},
    "train/age_gender.py:init_head_params": {"rng"},
    "train/augment.py:augment_batch": {"key"},
    "train/age_gender.py:forward": {"train", "dropout_key", "dropout_rate"},
    # jit-program builders and pure apply(params, ...) forms of the JAX
    # objects: the port's objects run eagerly on their own params
    "pipelines/detector.py:MTCNNDetector.detect_core": {"h", "w", "batched"},
    "pipelines/detector.py:MTCNNDetector.detect_fn": "*",
    "pipelines/detector.py:MTCNNDetector.detect_batch_fn": "*",
    "pipelines/heads.py:MultiheadHeads.apply": {"params"},
    "pipelines/heads.py:Int8MultiheadHeads.apply": {"params"},
    "pipelines/heads.py:TwoModelHeads.apply": {"params"},
    "parallel/sharding.py:batch_sharding": "*",
    "parallel/sharding.py:replicated": "*",
    "utils/profiling.py:StageTimer.timed": "*",
    # a text exporter nothing of the port reads; /stats, the album and
    # the benchmark read stats(), spans() and counts()
    "utils/profiling.py:StageTimer.report": "*",
    "utils/profiling.py:xla_trace": "*",
    # the port's layers take PyTorch-layout weights, not HWIO kernels, and
    # its frozen-graph importers fold scale_bias away
    "models/layers.py:conv2d": {"kernel"},
    "models/layers.py:depthwise_conv2d": {"kernel"},
    "models/layers.py:dense": {"kernel"},
    "models/layers.py:scale_bias": "*",
}
# JAX modules with no counterpart: the Pallas kernels (ported under
# ops/kernels/) and the persistent XLA compilation cache
ALLOWED_MODULES = {"ops/pallas/__init__.py", "ops/pallas/crop.py", "ops/pallas/knn.py",
                   "ops/pallas/pw_conv.py", "ops/pallas/warp.py",
                   "utils/compilation_cache.py"}


def _public_signatures(path: pathlib.Path):
    """{qualname: [parameter names]} of a module's public functions and its
    public classes' public methods (and __init__), by ast."""
    out = {}

    def names(f):
        a = f.args
        return ([x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
                + [x.arg for x in (a.vararg, a.kwarg) if x is not None])

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = names(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and (not m.name.startswith("_")
                                                       or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = names(m)
    return out


def _port_params(rel: str, qualname: str):
    """The port's parameter names for ``qualname`` (inherited methods
    included), or None when it has no such function."""
    module = importlib.import_module(f"{PORT_PKG}.{rel[:-3].replace('/', '.')}")
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return list(inspect.signature(obj).parameters)


def test_port_takes_every_jax_parameter():
    missing = []
    for path in sorted((ROOT / JAX_PKG).rglob("*.py")):
        rel = path.relative_to(ROOT / JAX_PKG).as_posix()
        if not (ROOT / PORT_PKG / rel).exists():
            if rel not in ALLOWED_MODULES:
                missing.append(f"{rel}: no module")
            continue
        for qualname, want in _public_signatures(path).items():
            allowed = ALLOWED.get(f"{rel}:{qualname}", set())
            have = _port_params(rel, qualname)
            if have is None:
                if allowed != "*":
                    missing.append(f"{rel}:{qualname}: no function")
                continue
            lacking = [p for p in want if p not in have and p not in allowed
                       and p not in ("self", "cls")]
            if lacking:
                missing.append(f"{rel}:{qualname}: {lacking}")
    assert not missing, "\n".join(missing)


def test_allow_list_names_only_real_gaps():
    """Every allow-listed name is a JAX parameter the port lacks: a gap
    that closes leaves the list."""
    stale = []
    for key, allowed in ALLOWED.items():
        rel, qualname = key.split(":")
        want = _public_signatures(ROOT / JAX_PKG / rel).get(qualname)
        have = _port_params(rel, qualname)
        if allowed == "*":
            if want is None or have is not None:
                stale.append(key)
        elif want is None or any(p not in want or p in (have or []) for p in allowed):
            stale.append(key)
    assert not stale, stale
