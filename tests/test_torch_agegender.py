"""The two-model age/gender configuration, quantize and export of the
PyTorch port against the JAX package.

- ``ops/quantize``: the npz members byte-equal to the JAX package's on the
  same params, and the round trip equal.
- ``TwoModelHeads``: small frozen graphs written as
  ``tests/test_two_model_heads.py`` writes them (age at 192², gender at
  224², the non-sota taps; then the sota ``data``/``prob`` taps, and a
  dynamic placeholder) against the jitted JAX heads: ages within 1e-4,
  P(male) within 1e-5, the sota hard decision equal, identity (n, 0).
- The two-model analyzer (seeded MTCNN, ``heads=``, and
  ``from_two_model_pbs``) against the JAX analyzer, single image, batch and
  oversample, in ``test_torch_analyzer.py``'s setting: boxes within 1 px,
  ages within 1e-3, P(male) within 1e-4, identity of shape (0,).
- The round trip of ``test_exported_two_model_matches_one_model`` on seeded
  multi-head params: ``export_age_pb``/``export_gender_pb`` then the
  two-model analyzer equal to the one-model analyzer (same boxes, ages
  within 1e-4, P(male) within 1e-5).
- The CLI: ``export`` in every format against the JAX CLI's files (both
  importers monkeypatched to return the seeded params),
  ``analyze --age-pb/--gender-pb`` against the JAX CLI's JSON, and the
  ``album`` and ``--int8-heads`` refusals with the JAX CLI's messages.
"""

import io
import json
import zipfile
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu import cli as jcli
from hse_facerec_tf_tpu.core.graphdef_export import GraphBuilder
from hse_facerec_tf_tpu.ops import quantize as jq
from hse_facerec_tf_tpu.pipelines.analyzer import FacialAnalyzer as JaxAnalyzer
from hse_facerec_tf_tpu.pipelines.heads import TwoModelHeads as JaxTwoModelHeads
from hse_facerec_torch import cli as tcli
from hse_facerec_torch.core import graphdef_export as texp
from hse_facerec_torch.ops import quantize as tq
from hse_facerec_torch.ops.kernels.crop import crop_resize
from hse_facerec_torch.pipelines import analyzer as analyzer_mod
from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
from hse_facerec_torch.pipelines.heads import TwoModelHeads, _placeholder_hw
from hse_facerec_torch.testing import random_mtcnn_params, random_multihead_params

from .test_torch_analyzer import CASES, H, W, _photo

HIGHEST = jax.lax.Precision.HIGHEST
FACE = 64          # the analyzer's crop size in these tests


@pytest.fixture
def rng():
    return np.random.RandomState(41)


@pytest.fixture(scope="module")
def multihead_np():
    return random_multihead_params(np.random.RandomState(100))


# ---------------------------------------------------------------- quantize

def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_quantized_npz_byte_equal_to_jax(multihead_np, tmp_path):
    """Same params -> the same members, byte for byte (the zip's own
    timestamps aside), and the same dequantized tree."""
    t_path, j_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tq.save_quantized(multihead_np, t_path)
    jq.save_quantized(multihead_np, j_path)
    assert _npz_members(t_path) == _npz_members(j_path)
    got, want = tq.load_quantized(t_path), jq.load_quantized(j_path)
    flat = lambda t: {"/".join(str(k.key) for k in p): np.asarray(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in g:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_quantize_array_matches_jax(rng):
    for w in (rng.randn(300, 7).astype(np.float32), np.full((4, 4), 2.5, np.float32)):
        q, mn, mx = tq.quantize_array(w)
        jq_, jmn, jmx = jq.quantize_array(w)
        assert np.array_equal(q, jq_) and (mn, mx) == (jmn, jmx)


# ---------------------------------------------------------------- TwoModelHeads

def _small_net_pb(path, rng, hw, n_out, act, in_name="input_1", out_name=None):
    """in_name (N,hw,hw,3) → Mean over H,W → MatMul(3,n_out) → act, tapped
    as ``out_name`` (default 'predictions/<act>'); hw None is dynamic."""
    b = GraphBuilder()
    x = b.placeholder(in_name, [-1, hw or -1, hw or -1, 3])
    pooled = b.mean("pool", x, [1, 2])
    w = (rng.randn(3, n_out) * 0.05).astype(np.float32)
    logits = b.matmul("predictions/MatMul", pooled, b.const("w", w))
    b.simple(act, out_name or f"predictions/{act}", [logits])
    with open(path, "wb") as f:
        f.write(b.serialize())


@pytest.fixture(scope="module")
def two_model_pbs(tmp_path_factory):
    """{"plain": (age, gender) at 192²/224², "sota": data/prob taps with a
    softmax gender, "dynamic": placeholders without a size}."""
    rng = np.random.RandomState(0)
    d = tmp_path_factory.mktemp("two_model")
    out = {}
    for kind, (age_hw, g_hw) in (("plain", (192, 224)), ("sota", (160, 224)),
                                 ("dynamic", (None, None))):
        age, gender = str(d / f"{kind}_age.pb"), str(d / f"{kind}_gender.pb")
        if kind == "sota":
            _small_net_pb(age, rng, age_hw, 100, "Softmax", "data", "prob")
            _small_net_pb(gender, rng, g_hw, 2, "Softmax", "data", "prob")
        else:
            _small_net_pb(age, rng, age_hw, 100, "Softmax")
            _small_net_pb(gender, rng, g_hw, 1, "Sigmoid")
        out[kind] = (age, gender)
    return out


def _heads_outputs(pbs, sota, crops):
    jh = JaxTwoModelHeads(*pbs, sota=sota)
    th = TwoModelHeads(*pbs, "cpu", sota=sota)
    want = jax.device_get(jax.jit(jh.apply)(jh.params, jnp.asarray(crops)))
    got = [t.numpy() for t in th.apply(torch.from_numpy(crops))]
    return jh, th, got, want


@pytest.mark.parametrize("kind", ["plain", "dynamic"])
def test_two_model_heads_match_jax(two_model_pbs, rng, kind):
    crops = (rng.rand(3, 224, 224, 3) * 255).astype(np.float32)
    jh, th, got, want = _heads_outputs(two_model_pbs[kind], False, crops)
    assert (th.age_hw, th.gender_hw) == (jh.age_hw, jh.gender_hw) == (
        ((192, 192), (224, 224)) if kind == "plain" else ((224, 224), (224, 224)))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)   # ages
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)   # P(male)
    assert got[2].shape == want[2].shape == (3, 0)


def test_two_model_heads_sota_taps_match_jax(two_model_pbs, rng):
    crops = (rng.rand(6, 224, 224, 3) * 255).astype(np.float32)
    _, th, got, want = _heads_outputs(two_model_pbs["sota"], True, crops)
    assert th.age_hw == (160, 160)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    assert set(np.unique(got[1])) <= {0.0, 1.0}
    np.testing.assert_array_equal(got[1], want[1])   # the hard decision
    assert got[2].shape == (6, 0)


def test_placeholder_hw_matches_jax(two_model_pbs):
    from hse_facerec_tf_tpu.core.graphdef import load_graphdef as jload
    from hse_facerec_tf_tpu.pipelines.heads import _placeholder_hw as jhw
    from hse_facerec_torch.core.graphdef import load_graphdef

    for kind, (age, gender) in two_model_pbs.items():
        name = "data" if kind == "sota" else "input_1"
        for pb in (age, gender):
            assert _placeholder_hw(load_graphdef(pb), name) == jhw(jload(pb), name)


# ---------------------------------------------------------------- two-model analyzer

@pytest.fixture(scope="module")
def face_pbs(tmp_path_factory, multihead_np):
    """The seeded multi-head model split into its age and gender halves:
    age at 48² (resized from the 64² crops), gender at the crop size."""
    d = tmp_path_factory.mktemp("halves")
    age, gender = str(d / "age_net.pb"), str(d / "gender_net.pb")
    texp.export_age_pb(multihead_np, age, input_size=48)
    texp.export_gender_pb(multihead_np, gender, input_size=FACE)
    return age, gender


def _two_model_pair(face_pbs, case="fits", **kw):
    seed, _, det_kw, head_batch = CASES[case]
    mtcnn_np = random_mtcnn_params(np.random.RandomState(seed))
    kw = dict(minsize=20, face_size=FACE, head_batch=head_batch, **det_kw, **kw)
    jax_an = JaxAnalyzer(mtcnn_np, heads=JaxTwoModelHeads(*face_pbs), precision=HIGHEST,
                         **kw)
    return jax_an, FacialAnalyzer(mtcnn_np, device="cpu",
                                  heads=TwoModelHeads(*face_pbs, "cpu"), **kw)


def _assert_same_faces(got, want, age_tol=1e-3, gender_tol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.raw_bbox, w.raw_bbox, atol=1.0)
        assert np.abs(np.subtract(g.bbox, w.bbox)).max() <= 1
        assert g.age == pytest.approx(w.age, abs=age_tol)
        assert g.gender_prob == pytest.approx(w.gender_prob, abs=gender_tol)
        assert g.identity.shape == w.identity.shape == (0,)


def _batch(case="fits"):
    seed = CASES[case][1]
    return np.stack([_photo(seed), np.zeros((H, W, 3), np.uint8), _photo(seed + 2)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_model_analyzer_matches_jax(face_pbs, case):
    """Single image (the crowded case escalates and re-runs the heads at
    full width) and batch (the crowded case's lanes re-run through
    ``analyze``), no CUDA launch on the CPU."""
    jax_an, an = _two_model_pair(face_pbs, case)
    imgs = _batch(case)
    crop_resize.launches = 0
    single = an.analyze(imgs[0])
    assert single
    _assert_same_faces(single, jax_an.analyze(imgs[0]))
    got = an.analyze_batch(imgs)
    want = jax_an.analyze_batch(imgs)
    assert len(got) == len(want) == 3 and got[1] == []
    for g, w in zip(got, want):
        _assert_same_faces(g, w)
    assert crop_resize.launches == 0


def test_two_model_oversample_and_padded_batch_match_jax(face_pbs):
    """The lane-by-lane batch form (oversample) and the padded batch, with
    identity width 0 through every scatter."""
    jax_an, an = _two_model_pair(face_pbs, oversample=True)
    imgs = _batch()
    for g, w in zip(an.analyze_batch(imgs), jax_an.analyze_batch(imgs)):
        _assert_same_faces(g, w)
    jax_an, an = _two_model_pair(face_pbs)
    got = an.analyze_batch_padded(imgs[[0, 2]], 4)
    want = jax_an.analyze_batch_padded(imgs[[0, 2]], 4)
    for g, w in zip(got, want):
        _assert_same_faces(g, w)


def test_from_two_model_pbs_matches_jax(face_pbs, monkeypatch, tmp_path):
    """The constructor the CLI calls, on both packages, with the seeded
    MTCNN weights in place of the shipped pb."""
    from hse_facerec_tf_tpu.models import mtcnn as jmtcnn

    mtcnn_np = random_mtcnn_params(np.random.RandomState(CASES["fits"][0]))
    monkeypatch.setattr(analyzer_mod, "import_mtcnn_params", lambda path: mtcnn_np)
    monkeypatch.setattr(jmtcnn, "import_mtcnn_params", lambda path: mtcnn_np)
    _, img_seed, det_kw, head_batch = CASES["fits"]
    kw = dict(minsize=20, face_size=FACE, head_batch=head_batch, **det_kw)
    an = FacialAnalyzer.from_two_model_pbs("mtcnn.pb", *face_pbs, device="cpu", **kw)
    jax_an = JaxAnalyzer.from_two_model_pbs("mtcnn.pb", *face_pbs, precision=HIGHEST,
                                            **kw)
    assert isinstance(an.heads, TwoModelHeads) and an.heads.identity_dim == 0
    img = _photo(img_seed)
    _assert_same_faces(an.analyze(img), jax_an.analyze(img))


def test_exported_halves_equal_the_one_model_analyzer(multihead_np, tmp_path):
    """Split seeded multi-head weights into age and gender pbs at the crop
    size (no extra resize) and run the two-model analyzer: per-face ages and
    P(male) equal the one-model analyzer's (same weights, same crops)."""
    age, gender = str(tmp_path / "age.pb"), str(tmp_path / "gender.pb")
    texp.export_age_pb(multihead_np, age, input_size=FACE)
    texp.export_gender_pb(multihead_np, gender, input_size=FACE)
    seed, img_seed, det_kw, head_batch = CASES["fits"]
    mtcnn_np = random_mtcnn_params(np.random.RandomState(seed))
    kw = dict(minsize=20, face_size=FACE, head_batch=head_batch, device="cpu", **det_kw)
    two = FacialAnalyzer(mtcnn_np, heads=TwoModelHeads(age, gender, "cpu"), **kw)
    one = FacialAnalyzer(mtcnn_np, multihead_np, **kw)
    imgs = _batch()
    for got, want in ((two.analyze(imgs[0]), one.analyze(imgs[0])),
                      *zip(two.analyze_batch(imgs), one.analyze_batch(imgs))):
        assert len(got) == len(want)
        for f2, f1 in zip(got, want):
            assert f2.bbox == f1.bbox and f2.raw_bbox == f1.raw_bbox
            assert f2.age == pytest.approx(f1.age, abs=1e-4)
            assert f2.gender_prob == pytest.approx(f1.gender_prob, abs=1e-5)
            assert f2.identity.shape == (0,) and f1.identity.shape == (1024,)


# ---------------------------------------------------------------- CLI

def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture
def multihead_pb(tmp_path, multihead_np, monkeypatch):
    """A stand-in for the shipped multi-head pb: both CLIs' importers return
    the seeded params for it."""
    from hse_facerec_tf_tpu.models import multihead as jmh
    from hse_facerec_torch.models import multihead as tmh

    path = str(tmp_path / "agegender.pb")
    open(path, "wb").close()
    for mod in (jmh, tmh):
        monkeypatch.setattr(mod, "import_multihead_params", lambda pb: multihead_np)
    return path


@pytest.mark.parametrize("fmt", ["pb", "quantized", "age_pb", "gender_pb"])
def test_cli_export_matches_jax(multihead_pb, tmp_path, fmt):
    suffix = ".npz" if fmt == "quantized" else ".pb"
    t_out, j_out = str(tmp_path / f"t{suffix}"), str(tmp_path / f"j{suffix}")
    t_said = _run(tcli.main, ["export", t_out, "--format", fmt,
                              "--agegender-pb", multihead_pb])
    j_said = _run(jcli.main, ["export", j_out, "--format", fmt,
                              "--agegender-pb", multihead_pb])
    assert t_said.replace(t_out, "OUT") == j_said.replace(j_out, "OUT")
    if fmt == "quantized":
        assert _npz_members(t_out) == _npz_members(j_out)
    else:
        assert open(t_out, "rb").read() == open(j_out, "rb").read()


def _cli_image(tmp_path):
    import cv2

    path = str(tmp_path / "photo.png")
    cv2.imwrite(path, cv2.cvtColor(_photo(CASES["fits"][1]), cv2.COLOR_RGB2BGR))
    return path


def test_cli_analyze_two_model_matches_jax(face_pbs, monkeypatch, tmp_path):
    """``analyze --age-pb --gender-pb`` prints the JAX CLI's rows (seeded
    MTCNN weights in place of the shipped pb; the 224² crops are resized
    to each half's input size)."""
    from hse_facerec_tf_tpu.models import mtcnn as jmtcnn

    mtcnn_np = random_mtcnn_params(np.random.RandomState(CASES["fits"][0]))
    monkeypatch.setattr(analyzer_mod, "import_mtcnn_params", lambda path: mtcnn_np)
    monkeypatch.setattr(jmtcnn, "import_mtcnn_params", lambda path: mtcnn_np)
    image = _cli_image(tmp_path)
    mtcnn_pb = str(tmp_path / "mtcnn.pb")
    open(mtcnn_pb, "wb").close()
    argv = ["analyze", image, "--mtcnn-pb", mtcnn_pb, "--age-pb", face_pbs[0],
            "--gender-pb", face_pbs[1], "--minsize", "20"]
    got = [json.loads(r) for r in _run(tcli.main, argv + ["--device", "cpu"]).splitlines()]
    want = [json.loads(r) for r in _run(jcli.main, argv).splitlines()]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["bbox"] == w["bbox"] and g["is_male"] == w["is_male"]
        assert g["age"] == pytest.approx(w["age"], abs=0.1)          # printed to 0.1
        assert g["gender_prob"] == pytest.approx(w["gender_prob"], abs=1e-4)


def _exit_message(main, argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value.code)


def test_cli_album_refuses_the_two_model_configuration(face_pbs, tmp_path):
    argv = ["album", str(tmp_path), "--age-pb", face_pbs[0], "--gender-pb", face_pbs[1]]
    got = _exit_message(tcli.main, argv + ["--device", "cpu"])
    assert got == _exit_message(jcli.main, argv)
    assert "no identity features" in got


def test_cli_int8_heads_refused_with_two_models(face_pbs, tmp_path):
    image = _cli_image(tmp_path)
    argv = ["analyze", image, "--age-pb", face_pbs[0], "--gender-pb", face_pbs[1],
            "--int8-heads"]
    got = _exit_message(tcli.main, argv + ["--device", "cpu"])
    assert got == _exit_message(jcli.main, argv)
    assert "--int8-heads" in got
