"""The int8 serving slice of the PyTorch port against the JAX package, on
the CPU: quantization, K4's plain version, the int8 backbone, the
multi-head and embedder forwards, ``Int8MultiheadHeads``, the int8
analyzer, the ``agegender_identity_int8`` extractor and the CLI.

The same seeded numpy weights and inputs go through both packages; the JAX
functions run jitted (eager JAX rounds the pointwise epilogue twice, the
jitted form once, as XLA fuses the multiply-add), the Pallas kernel K4 in
interpret mode. The port runs on the CPU with K4's plain version.
Tolerances and their reasons:
- quantized arrays, K4's plain version (int8 and f32 out): bit-equal.
  Both compute an exact integer dot, one fused multiply-add, the same clip
  and a round half to even by the same f32 constant;
- int8 block activations: the depthwise convs sum 9 taps in another order
  (mkldnn vs XLA's CPU conv), so an f32 result can differ in its last bit
  and its requant by one quantum; allowed in at most 1 in 1,000 values
  (none seen on the CPU);
- f32 outputs after the 13 blocks, held as tightly as the CPU shows: with
  no requant flip the two packages differ only in the order of the GAP and
  dense sums, 4e-8 relative L2 on the identity. The bounds: relative L2
  1e-5 on the identity and feats, ages 1e-4 years, P(male) 1e-5, age
  probabilities 1e-6. The int8 path sits 6.5e-2 relative L2 from the f32
  one on these weights (asserted below), so the bound tells the two apart;
  one flip cascading through the later blocks (about 1e-2 on an H100
  against the CPU) breaks it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.models import int8_infer as qi
from hse_facerec_tf_tpu.models import multihead as jmh
from hse_facerec_tf_tpu.models import zoo as jzoo
from hse_facerec_tf_tpu.pipelines.analyzer import FacialAnalyzer as JaxAnalyzer
from hse_facerec_tf_tpu.pipelines.heads import Int8MultiheadHeads as JaxInt8Heads
from hse_facerec_tf_tpu.ops.pallas.pw_conv import pack_pw_weights, pw_conv_int8_pallas
from hse_facerec_torch import params as P
from hse_facerec_torch.models import int8_infer as ti
from hse_facerec_torch.models import zoo as tzoo
from hse_facerec_torch.models.mobilenet import MOBILENET_V1_BLOCKS
from hse_facerec_torch.ops.kernels import pw_conv as tpw
from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
from hse_facerec_torch.pipelines.heads import Int8MultiheadHeads
from hse_facerec_torch.testing import random_mtcnn_params, random_multihead_params

from .test_torch_analyzer import CASES, _photo

HIGHEST = jax.lax.Precision.HIGHEST
FLIP_FRACTION = 1e-3       # int8 activations one quantum apart, at most
REL_L2 = 1e-5              # identity and feats, against the JAX package
AGE_ATOL, GENDER_ATOL, PROBS_ATOL = 1e-4, 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel_l2(a, b):
    """Largest relative L2 distance of the rows of ``a`` from ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)))


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y)


def _without_tpu_packing(tree):
    return {k: _without_tpu_packing(v) if isinstance(v, dict) else v
            for k, v in tree.items() if k not in ("wp", "scale_p", "bias_p")}


def _channels(width):
    c = [max(8, int(32 * width))]
    return c + [max(8, int(out * width)) for _, out in MOBILENET_V1_BLOCKS]


def _random_backbone(rng, form, width=0.25):
    """numpy MobileNet-V1 params in one of the three forms the quantizer
    folds: {kernel, bn}, {kernel, scale, bias} or {kernel, bias}."""
    def layer(shape, ch):
        p = {"kernel": (rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
                        ).astype(np.float32)}
        if form == "bn":
            p["bn"] = {"gamma": rng.uniform(0.5, 1.5, ch).astype(np.float32),
                       "beta": (rng.randn(ch) * 0.1).astype(np.float32),
                       "mean": (rng.randn(ch) * 0.1).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, ch).astype(np.float32)}
        elif form == "scale":
            p["scale"] = rng.uniform(0.5, 1.5, ch).astype(np.float32)
            p["bias"] = (rng.randn(ch) * 0.1).astype(np.float32)
        else:
            p["bias"] = (rng.randn(ch) * 0.1).astype(np.float32)
        return p

    ch = _channels(width)
    params = {"conv1": layer((3, 3, 3, ch[0]), ch[0])}
    for i in range(1, len(MOBILENET_V1_BLOCKS) + 1):
        params[f"dw{i}"] = layer((3, 3, ch[i - 1], 1), ch[i - 1])
        params[f"pw{i}"] = layer((1, 1, ch[i - 1], ch[i]), ch[i])
    return params


@pytest.fixture(scope="module")
def mh_np():
    return random_multihead_params(np.random.RandomState(100))


# -- quantization -------------------------------------------------------------


@pytest.mark.parametrize("form", ["bn", "scale", "folded"])
def test_quantize_backbone_matches_jax(form):
    params = _random_backbone(np.random.RandomState(3), form)
    want = qi.quantize_backbone_int8(params)
    got = ti.quantize_backbone_int8(params)
    _assert_trees_equal(got, _without_tpu_packing(want))


def test_quantize_multihead_matches_jax(mh_np):
    want = qi.quantize_multihead_int8(mh_np)
    got = ti.quantize_multihead_int8(mh_np)
    _assert_trees_equal(got, _without_tpu_packing(want))
    assert ti.is_quantized(got) and not ti.is_quantized(mh_np)


def test_int8_to_torch_layouts(mh_np):
    """``to_torch`` takes the JAX package's quantized pytree (TPU-packed
    keys and all) and the port's to the same tensors: q as (Cout, Cin)
    contiguous int8, float backbone kernels bf16-rounded, dense heads as
    for the f32 pytree."""
    jq = qi.quantize_multihead_int8(mh_np)
    assert "wp" in jq["backbone"]["pw13"]
    got = P.to_torch(jq, "cpu")
    mine = P.to_torch(ti.quantize_multihead_int8(mh_np), "cpu")
    for name in ("conv1", "dw1", "pw1", "pw13"):
        for key, t in got["backbone"][name].items():
            assert torch.equal(t, mine["backbone"][name][key])
    pw = got["backbone"]["pw2"]
    assert set(pw) == {"q", "scale", "bias"} and pw["q"].is_contiguous()
    np.testing.assert_array_equal(pw["q"].numpy(), jq["backbone"]["pw2"]["q"].T)
    k = jq["backbone"]["dw3"]["kernel"]
    want = np.asarray(jnp.asarray(k, jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(got["backbone"]["dw3"]["kernel"].numpy(),
                                  P.depthwise_weight(want))
    np.testing.assert_array_equal(got["feats"]["kernel"].numpy(),
                                  mh_np["feats"]["kernel"].T)
    with pytest.raises(ValueError):
        P.to_torch({"pw1": {"q": jq["backbone"]["pw1"]["q"], "zp": 0}}, "cpu")


def test_to_torch_rejects_float_pointwise_in_int8_backbone():
    """A quantized backbone whose later pointwise layer is float (the JAX
    package's TPU-only bf16 prefix, seen from its other end) is refused,
    not run as something else."""
    params = _random_backbone(np.random.RandomState(4), "bn")
    tree = ti.quantize_backbone_int8(params)
    tree["pw5"] = {"kernel": params["pw5"]["kernel"], "bias": params["pw5"]["bn"]["beta"]}
    with pytest.raises(ValueError, match="pw5"):
        P.to_torch(tree, "cpu")


def test_is_quantized_matches_jax_heads(mh_np):
    """``is_quantized`` takes the JAX ``Int8MultiheadHeads`` test (``q`` in
    ``pw1``): raw params are quantized, a quantized pytree is taken as is;
    so is a pytree whose first block alone is quantized."""
    q = ti.quantize_multihead_int8(mh_np)
    only_pw1 = {**mh_np, "backbone": {**mh_np["backbone"], "pw1": q["backbone"]["pw1"]}}
    for tree, want in ((mh_np, False), (q, True), (only_pw1, True)):
        assert ti.is_quantized(tree) is want
        assert (JaxInt8Heads(tree).params is tree) is want


# -- K4 -----------------------------------------------------------------------


def _random_layer(rng, c, cout):
    k = (rng.rand(c, cout).astype(np.float32) - 0.5) * 0.2
    s_w = np.maximum(np.abs(k).max(axis=0), 1e-12) / 127.0
    q = np.clip(np.round(k / s_w[None, :]), -127, 127).astype(np.int8)
    scale = (s_w * qi.ACT_SCALE).astype(np.float32)
    bias = (rng.rand(cout).astype(np.float32) - 0.5) * 0.5
    return q, scale, bias


_jax_pw = jax.jit(lambda a, q, s, b: qi._pw_conv_int8(a, q, s, b))
_jax_pw_requant = jax.jit(lambda a, q, s, b: qi._requant(qi._pw_conv_int8(a, q, s, b)))


# (M, K, N): the layer widths of the path at 2 x 14² pixels (ragged against
# the kernel's 64-row tile), and a ragged M of 37
@pytest.mark.parametrize("m,c,cout", [(392, 32, 64), (392, 64, 128),
                                      (392, 128, 128), (392, 256, 512),
                                      (98, 512, 1024), (98, 1024, 1024),
                                      (37, 128, 256)])
def test_pw_conv_plain_matches_jax_and_pallas(m, c, cout):
    rng = np.random.RandomState(m + c + cout)
    a = rng.randint(0, 128, (1, 1, m, c)).astype(np.int8)
    q, scale, bias = _random_layer(rng, c, cout)
    args = (_t(a.reshape(m, c)), _t(q.T), _t(scale), _t(bias))
    got_q = tpw.pw_conv_int8_plain(*args).numpy()
    got_f = tpw.pw_conv_int8_plain(*args, requant=False).numpy()
    np.testing.assert_array_equal(got_q, np.asarray(_jax_pw_requant(a, q, scale, bias))
                                  .reshape(m, cout))
    np.testing.assert_array_equal(got_f, np.asarray(_jax_pw(a, q, scale, bias))
                                  .reshape(m, cout))
    wp, sp, bp, p = pack_pw_weights(q, scale, bias)
    for requant, got in ((True, got_q), (False, got_f)):
        want = pw_conv_int8_pallas(jnp.asarray(a), wp, sp, bp, p,
                                   requant=requant, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want).reshape(m, cout))
    # the wrapper takes the plain version on CPU tensors and launches nothing
    before = tpw.pw_conv_int8.launches
    assert torch.equal(tpw.pw_conv_int8(*args), _t(got_q))
    assert tpw.pw_conv_int8.launches == before


# (M, K, N) at the CUDA kernel's edges, on small M: pw1 (K 32 -> N 64,
# packed two pixels a 64-byte TMA row) and pw13 (K 1024 -> N 1024, f32
# out); K 8 and K 36, off whole 16-byte words, which the launch zero-pads
# (the Pallas kernel packs 128 / K pixels a row, so M is a multiple of that)
@pytest.mark.parametrize("m,c,cout", [(16, 32, 64), (13, 1024, 1024), (32, 8, 64),
                                      (21, 36, 64)])
def test_pw_conv_plain_matches_pallas_at_route_edges(m, c, cout):
    """The plain version bit-equal to the interpret-mode Pallas kernel, int8
    and f32 out, where the kernel packs the layer; K 36 it does not pack
    (``pack_pw_weights`` gives None and the JAX package takes its jitted
    XLA form), so there the plain version meets that form."""
    rng = np.random.RandomState(7 * m + c + cout)
    a = rng.randint(0, 128, (1, 1, m, c)).astype(np.int8)
    q, scale, bias = _random_layer(rng, c, cout)
    args = (_t(a.reshape(m, c)), _t(q.T), _t(scale), _t(bias))
    packed = pack_pw_weights(q, scale, bias)
    assert (packed is None) == (c == 36)
    for requant in (True, False):
        got = tpw.pw_conv_int8_plain(*args, requant=requant).numpy()
        if packed is None:
            want = (_jax_pw_requant if requant else _jax_pw)(a, q, scale, bias)
        else:
            wp, sp, bp, p = packed
            want = pw_conv_int8_pallas(jnp.asarray(a), wp, sp, bp, p, requant=requant,
                                       interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want).reshape(m, cout))


def test_pw_conv_accumulator_is_exact():
    """The dot at the int8 extremes, K = 1024: equal to numpy's int64."""
    rng = np.random.RandomState(5)
    a = rng.choice(np.array([0, 1, 126, 127], np.int8), (64, 1024))
    w = rng.choice(np.array([-127, -126, 0, 126, 127], np.int8), (96, 1024))
    a[0] = 127
    w[0] = 127
    w[1] = -127
    want = a.astype(np.int64) @ w.astype(np.int64).T
    got = tpw.int8_dot_exact(_t(a), _t(w)).numpy()
    assert got[0, 0] == 1024 * 127 ** 2 and got[0, 1] == -1024 * 127 ** 2
    np.testing.assert_array_equal(got.astype(np.int64), want)


# -- backbone -----------------------------------------------------------------


def _jax_block(i, pallas):
    """Block i of the JAX backbone, jitted: int8 in, int8 out (f32 out for
    the last block), as ``mobilenet_backbone_int8`` runs it."""
    stride = MOBILENET_V1_BLOCKS[i - 1][0]
    last = i == len(MOBILENET_V1_BLOCKS)

    def fn(a, dw, pw):
        a = qi._requant(qi._dw_conv_int8(a, dw["kernel"], dw["bias"], stride))
        if pallas:
            p = pw["wp"].shape[0] // pw["q"].shape[0]
            return pw_conv_int8_pallas(a, pw["wp"], pw["scale_p"], pw["bias_p"],
                                       p, requant=not last, interpret=True)
        y = qi._pw_conv_int8(a, pw["q"], pw["scale"], pw["bias"])
        return y if last else qi._requant(y)

    return jax.jit(fn)


def _torch_block(tq, i, a):
    return ti.block_int8(tq, i, a.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("pallas", [False, True])
def test_backbone_matches_jax(pallas):
    """conv1, then block by block, each package from the same int8 input
    (the JAX chain's): the port's int8 activations equal JAX's but for
    one-quantum flips in at most ``FLIP_FRACTION`` of them. Then the whole
    backbone."""
    params = _random_backbone(np.random.RandomState(7), "bn")
    jq = qi.quantize_backbone_int8(params)
    tq = P.to_torch(ti.quantize_backbone_int8(params), "cpu")
    x = np.random.RandomState(8).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    c1 = jq["conv1"]
    conv1 = jax.jit(lambda x: qi._requant(qi.relu6(jax.lax.conv_general_dilated(
        x.astype(jnp.bfloat16), c1["kernel"].astype(jnp.bfloat16), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32) + c1["bias"])))
    a = np.asarray(conv1(x))
    got = ti.stem_int8(tq, _t(x)).permute(0, 2, 3, 1).numpy()
    flips, total = 0, a.size
    diff = np.abs(got.astype(np.int32) - a.astype(np.int32))
    assert got.dtype == a.dtype and diff.max() <= 1
    flips += int(np.count_nonzero(diff))
    for i in range(1, len(MOBILENET_V1_BLOCKS) + 1):
        want = np.asarray(_jax_block(i, pallas)(a, jq[f"dw{i}"], jq[f"pw{i}"]))
        got = _torch_block(tq, i, _t(a)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        if i < len(MOBILENET_V1_BLOCKS):
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, i
            flips += int(np.count_nonzero(diff))
            total += diff.size
        else:
            assert _rel_l2(got.ravel(), want.ravel()) < REL_L2
        a = want
    assert flips <= FLIP_FRACTION * total, (flips, total)
    want = jax.jit(lambda qp, x: qi.mobilenet_backbone_int8(qp, x, pallas_pw=pallas))(
        jq, x)
    got = ti.mobilenet_backbone_int8(tq, _t(x)).numpy()
    assert got.shape == (2, 2, 2, 256)
    assert _rel_l2(got.ravel(), np.asarray(want).ravel()) < REL_L2


def test_multihead_and_embed_int8_match_jax(mh_np):
    """Full-width multi-head int8 forward and the embedder tap; the JAX f32
    forward on the same input sits far outside the bound."""
    jq = qi.quantize_multihead_int8(mh_np)
    tq = P.to_torch(ti.quantize_multihead_int8(mh_np), "cpu")
    x = (np.random.RandomState(11).rand(2, 64, 64, 3).astype(np.float32) * 255
         - 120.0)
    want = jax.jit(qi.multihead_apply_int8)(jq, x)
    got = ti.multihead_apply_int8(tq, _t(x))
    assert got.identity.shape == (2, 1024) and got.age_probs.shape == (2, 100)
    assert _rel_l2(got.identity.numpy(), want.identity) < REL_L2
    np.testing.assert_allclose(got.age_probs.numpy(), want.age_probs, atol=PROBS_ATOL)
    np.testing.assert_allclose(got.gender_prob.numpy(), want.gender_prob,
                               atol=GENDER_ATOL)
    assert _rel_l2(got.feats.numpy(), want.feats) < REL_L2
    f32 = jax.jit(jmh.multihead_apply)(mh_np, x)
    assert _rel_l2(want.identity, f32.identity) > 1000 * REL_L2
    emb_want = jax.jit(qi.mobilenet_embed_int8)(jq["backbone"], x)
    emb = ti.mobilenet_embed_int8(tq["backbone"], _t(x))
    np.testing.assert_array_equal(emb.numpy(), got.identity.numpy())
    assert _rel_l2(emb.numpy(), emb_want) < REL_L2


def test_int8_heads_match_jax(mh_np):
    """``Int8MultiheadHeads`` from raw params and from a quantized pytree:
    the same BGR flip, ImageNet means and 1 + top-2 age expectation."""
    crops = np.random.RandomState(12).rand(3, 64, 64, 3).astype(np.float32) * 255
    jh = JaxInt8Heads(mh_np)
    want = jax.jit(jh.apply)(jh.params, crops)
    for params in (mh_np, ti.quantize_multihead_int8(mh_np)):
        heads = Int8MultiheadHeads(params, "cpu")
        ages, gender, identity = heads.apply(_t(crops))
        np.testing.assert_allclose(ages.numpy(), want[0], atol=AGE_ATOL)
        np.testing.assert_allclose(gender.numpy(), want[1], atol=GENDER_ATOL)
        assert _rel_l2(identity.numpy(), want[2]) < REL_L2


# -- the slice as a whole -----------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_analyzer_matches_jax(case, mh_np):
    """The analyzer with int8 heads in both packages, slot for slot on
    random weights; its boxes are the f32 analyzer's (detection is
    untouched)."""
    seed, img_seed, det_kw, head_batch = CASES[case]
    mtcnn_np = random_mtcnn_params(np.random.RandomState(seed))
    kw = dict(minsize=20, face_size=64, head_batch=head_batch, **det_kw)
    jax_an = JaxAnalyzer(mtcnn_np, heads=JaxInt8Heads(mh_np), precision=HIGHEST, **kw)
    an = FacialAnalyzer(mtcnn_np, device="cpu",
                        heads=Int8MultiheadHeads(mh_np, "cpu"), **kw)
    img = _photo(img_seed)
    want = jax_an.analyze(img)
    got = an.analyze(img)
    f32 = FacialAnalyzer(mtcnn_np, mh_np, device="cpu", **kw).analyze(img)
    assert len(got) == len(want) == len(f32) > 0
    for g, w, f in zip(got, want, f32):
        assert g.bbox == f.bbox and g.raw_bbox == f.raw_bbox
        np.testing.assert_allclose(g.raw_bbox, w.raw_bbox, atol=1.0)
        assert g.age == pytest.approx(w.age, abs=AGE_ATOL)
        assert g.gender_prob == pytest.approx(w.gender_prob, abs=GENDER_ATOL)
        assert _rel_l2(g.identity, w.identity) < REL_L2


SIZE = (64, 64)


def _patch_zoos(monkeypatch, qparams):
    """Both packages' ``agegender_identity_int8`` entries on ``qparams`` (the
    JAX package's quantized pytree) at 64²."""
    for zoo_mod in (jzoo, tzoo):
        spec = zoo_mod.MODEL_ZOO["agegender_identity_int8"]
        monkeypatch.setitem(zoo_mod.MODEL_ZOO, "agegender_identity_int8",
                            type(spec)(**dict(vars(spec), input_size=SIZE,
                                              build_params=lambda: qparams)))


def test_int8_zoo_extractor_matches_jax(mh_np, tmp_path, monkeypatch):
    from .test_torch_identification import _people_tree

    _patch_zoos(monkeypatch, qi.quantize_multihead_int8(mh_np))
    paths, _ = _people_tree(tmp_path, np.random.RandomState(19), n_people=2)
    want = jzoo.build_extractor("agegender_identity_int8", batch_size=4) \
        .extract_files(paths["gallery"], loader=np.load)
    ex = tzoo.build_extractor("agegender_identity_int8", batch_size=4, device="cpu")
    got = ex.extract_files(paths["gallery"], loader=np.load)
    assert got.shape == want.shape == (6, 1024)
    assert _rel_l2(got, want) < REL_L2
    assert tzoo.weights_origin("agegender_identity_int8") == \
        tzoo.weights_origin("agegender_identity")


def test_cli_analyze_int8_heads(tmp_path, capsys, mh_np):
    """``analyze --int8-heads --device cpu``: the same faces and boxes as
    without it."""
    import cv2

    from hse_facerec_torch import cli

    from .test_torch_models import write_mtcnn_pb, write_multihead_pb

    write_mtcnn_pb(random_mtcnn_params(np.random.RandomState(2)), tmp_path / "mtcnn.pb")
    write_multihead_pb(mh_np, tmp_path / "ag.pb", np.random.RandomState(9))
    img = tmp_path / "photo.png"
    cv2.imwrite(str(img), _photo(2)[:, :, ::-1])
    base = ["analyze", str(img), "--device", "cpu", "--minsize", "20",
            "--mtcnn-pb", str(tmp_path / "mtcnn.pb"),
            "--agegender-pb", str(tmp_path / "ag.pb")]
    cli.main(base)
    f32 = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    cli.main(base + ["--int8-heads"])
    int8 = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(int8) == len(f32) > 0
    assert [r["bbox"] for r in int8] == [r["bbox"] for r in f32]


def test_cli_identify_and_enroll_int8(mh_np, tmp_path, capsys, monkeypatch):
    from hse_facerec_torch import cli

    from .test_torch_identification import _png_tree

    _patch_zoos(monkeypatch, ti.quantize_multihead_int8(mh_np))
    _png_tree(tmp_path, np.random.RandomState(20))
    g, p = str(tmp_path / "gallery"), str(tmp_path / "probe")
    base = ["--device", "cpu", "--batch-size", "4", "--model",
            "agegender_identity_int8"]
    cli.main(["identify", g, p, *base])
    cli.main(["identify", g, p, "--quantized", *base])
    cli.main(["enroll", g, str(tmp_path / "people.npz"), "--mode", "image", *base])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert out[0]["accuracy"] == out[1]["accuracy"] == 1.0
    assert out[0]["n_gallery"] == 4 and out[2]["n_enrolled_total"] == 4
