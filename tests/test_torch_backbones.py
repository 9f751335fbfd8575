"""The age/gender and zoo backbones of the PyTorch port against the JAX
package: BKNet, SSR-Net, WideResNet-16-k, MobileNetV2/AgenderNet,
Inception-ResNet-v1, the ArcFace IResNet and VGG16.

The same seeded numpy params (drawn by the port's ``init_*`` functions from
a ``torch.Generator``) and the same numpy inputs go through the jitted JAX
forward and the port's forward on the CPU. Tolerance: ``|got - want| <=
1e-4 + 1e-4·max|want|`` (rtol and atol 1e-4, the atol scaled to the
output's magnitude; fp32 sums in another order). Every importer reads a
file the test writes in the published layout and must give params
bit-equal to the JAX importer's. The division forms the port chose are
held bit for bit against the jitted JAX expressions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.models import arcface as jarc
from hse_facerec_tf_tpu.models import bknet as jbk
from hse_facerec_tf_tpu.models import inception_resnet as jir
from hse_facerec_tf_tpu.models import mobilenet_v2 as jmn2
from hse_facerec_tf_tpu.models import ssrnet as jssr
from hse_facerec_tf_tpu.models import vgg16 as jvgg
from hse_facerec_tf_tpu.models import wide_resnet as jwrn
from hse_facerec_torch.models import arcface as tarc
from hse_facerec_torch.models import bknet as tbk
from hse_facerec_torch.models import inception_resnet as tir
from hse_facerec_torch.models import mobilenet_v2 as tmn2
from hse_facerec_torch.models import ssrnet as tssr
from hse_facerec_torch.models import vgg16 as tvgg
from hse_facerec_torch.models import wide_resnet as twrn
from hse_facerec_torch.params import tree_to_torch

RTOL = ATOL = 1e-4


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, what=""):
    """rtol and atol 1e-4, the atol scaled to the output's magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale, err_msg=what)


def _port(fn, params, *xs, **kw):
    with torch.no_grad():
        out = fn(tree_to_torch(params, "cpu"), *[torch.from_numpy(x) for x in xs], **kw)
    return [o.numpy() for o in out] if isinstance(out, tuple) else out.numpy()


def _assert_trees_equal(got, want, path=""):
    """Same keys, same dtypes, same shapes, same bits."""
    assert sorted(got) == sorted(want), path
    for k in got:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
            assert np.array_equal(g, w), f"{path}/{k}"


def _images(rng, n, hw, scale=255.0):
    return (rng.rand(n, hw, hw, 3) * scale).astype(np.float32)


def _keras_h5(path, layers):
    """Write {layer: {weight: array}} as a Keras h5 ('model_weights/<layer>/
    <layer>/<weight>:0') with the ordered ``layer_names`` attr."""
    import h5py

    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        for layer, weights in layers.items():
            g = root.create_group(layer)
            names = []
            for wname, arr in weights.items():
                g.create_dataset(f"{layer}/{wname}:0", data=np.asarray(arr, np.float32))
                names.append(f"{layer}/{wname}:0".encode())
            g.attrs["weight_names"] = names
        root.attrs["layer_names"] = [k.encode() for k in layers]


# ---------------------------------------------------------------- BKNet

def test_bknet_forward_matches_jax(rng):
    params = tbk.init_bknet_params(_gen(1))
    x = (rng.rand(3, 48, 48, 1).astype(np.float32) - 0.5)
    want = jax.jit(jbk.bknet_apply)(_jnp(params), x)
    got = _port(tbk.bknet_apply, params, x)
    for name, g, w in zip(("smile", "gender", "age"), got, want):
        _close(g, w, name)


def test_bknet_preprocess_bit_equal_to_jax(rng):
    """cv2's fixed-point gray and INTER_LINEAR without cv2: bit-equal to the
    JAX package's cv2 calls, at mixed sizes (down, up, 48² itself)."""
    for h, w in ((100, 80), (37, 61), (48, 48), (200, 31)):
        imgs = (rng.rand(2, h, w, 3) * 255).astype(np.uint8)
        np.testing.assert_array_equal(tbk.preprocess_bknet(imgs),
                                      jbk.preprocess_bknet(imgs))


def test_bknet_gray_bit_equal_to_cv2_on_every_rgb_triple():
    import cv2

    v = np.arange(256, dtype=np.uint8)
    triples = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(256, -1, 3)
    np.testing.assert_array_equal(tbk._rgb_to_gray_u8(triples),
                                  cv2.cvtColor(triples, cv2.COLOR_RGB2GRAY))


def test_bknet_npz_import_bit_equal(tmp_path):
    params = tbk.init_bknet_params(_gen(2))
    npz = tmp_path / "bknet.npz"
    np.savez(npz, **{f"{layer}/{leaf}": a for layer, leaves in params.items()
                     for leaf, a in leaves.items()})
    _assert_trees_equal(tbk.bknet_params_from_npz(str(npz)),
                        jbk.bknet_params_from_npz(str(npz)))


# ---------------------------------------------------------------- SSR-Net

@pytest.mark.parametrize("V", [101.0, 1.0])
def test_ssrnet_forward_matches_jax(rng, V):
    params = tssr.init_ssrnet_params(_gen(3))
    x = _images(rng, 3, 64)
    want = jax.jit(lambda p, a: jssr.ssrnet_apply(p, a, V=V))(_jnp(params), x)
    _close(_port(tssr.ssrnet_apply, params, x, V=V), want, f"V={V}")


def _write_ssrnet_h5(params, path):
    """The published demo's Keras layout: auto-named trunk/stage layers in
    construction order and the named delta/pred/local heads."""
    layers = {}
    ci = bi = di = 0

    def conv(p):
        nonlocal ci
        ci += 1
        layers[f"conv2d_{ci}"] = {"kernel": p["kernel"], "bias": p["bias"]}

    def bn(p):
        nonlocal bi
        bi += 1
        layers[f"batch_normalization_{bi}"] = {
            "gamma": p["gamma"], "beta": p["beta"], "moving_mean": p["mean"],
            "moving_variance": p["var"]}

    def dense(p, name=None):
        nonlocal di
        if name is None:
            di += 1
            name = f"dense_{di}"
        layers[name] = {"kernel": p["kernel"], "bias": p["bias"]}

    for prefix in ("x", "s"):
        for li in range(1, 5):
            conv(params[f"{prefix}{li}"])
            bn(params[f"{prefix}{li}"]["bn"])
    for k in range(1, 4):
        st = params[f"stage{k}"]
        conv(st["s_conv"])
        conv(st["x_conv"])
        dense(st["s_mix"])
        dense(st["x_mix"])
        dense(st["delta"], f"delta_s{k}")
        dense(st["feat"])
        dense(st["pred"], f"pred_age_stage{k}")
        dense(st["local"], f"local_delta_stage{k}")
    _keras_h5(path, layers)


def test_ssrnet_h5_import_bit_equal(tmp_path):
    params = tssr.init_ssrnet_params(_gen(4))
    path = str(tmp_path / "ssrnet_3_3_3_64_1.0_1.0.h5")
    _write_ssrnet_h5(params, path)
    got = tssr.ssrnet_params_from_h5(path)
    _assert_trees_equal(got, jssr.ssrnet_params_from_h5(path))
    _assert_trees_equal(got, params)


def test_ssrnet_h5_import_refuses_another_architecture(tmp_path):
    import h5py

    path = str(tmp_path / "bad.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("conv2d_1")
        g.create_dataset("conv2d_1/kernel:0", data=np.zeros((3, 3, 3, 48), np.float32))
        g.attrs["weight_names"] = [b"conv2d_1/kernel:0"]
    with pytest.raises(ValueError, match="expected 4\\+4 trunk convs"):
        tssr.ssrnet_params_from_h5(path)
    with pytest.raises(ValueError, match="expected 4\\+4 trunk convs"):
        jssr.ssrnet_params_from_h5(path)


def test_ssr_merge_matches_jax(rng):
    preds = [rng.rand(5, s).astype(np.float32) for s in tssr.STAGE_NUM]
    deltas = [(rng.randn(5) * 0.3).astype(np.float32) for _ in tssr.STAGE_NUM]
    locals_ = [(rng.randn(5, s) * 0.3).astype(np.float32) for s in tssr.STAGE_NUM]
    want = jax.jit(jssr.ssr_merge)(preds, deltas, locals_)
    t = lambda xs: [torch.from_numpy(a) for a in xs]
    _close(tssr.ssr_merge(t(preds), t(deltas), t(locals_)), want)


# ---------------------------------------------------------------- WRN-16-k

def test_wide_resnet_forward_matches_jax(rng):
    """WRN-16-4 at the reference's 64² input (the head's flatten is
    16·16·256)."""
    params = twrn.init_wide_resnet_params(_gen(5), k=4)
    x = _images(rng, 2, 64)
    want = jax.jit(jwrn.wide_resnet_16_8)(_jnp(params), x)
    got = _port(twrn.wide_resnet_16_8, params, x)
    for name, g, w in zip(("gender", "age"), got, want):
        _close(g, w, name)


def test_avg_pool_same_is_the_jitted_reciprocal_form(rng):
    """On sums that are exact (small integers), the jitted JAX pool equals
    a multiply by the float32 reciprocal of the unpadded count bit for bit,
    and a true division by the count does not: the port's form is the
    first."""
    import torch.nn.functional as F

    x = rng.randint(0, 50, (2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jwrn._avg_pool_same(a, 8))(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = twrn._avg_pool_same(xt, 8).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)

    def window_sums(t):   # SAME pads (3, 4) for an 8-wide window
        return F.avg_pool2d(F.pad(t, (3, 4, 3, 4)), 8, 1, divisor_override=1)

    true_div = window_sums(xt) / window_sums(torch.ones(1, 1, 16, 16))
    assert not np.array_equal(true_div.permute(0, 2, 3, 1).numpy(), want)


def _write_wrn_h5(params, path):
    """Keras auto-numbered layers in creation order: conv2d_* (stem, then
    per block conv1, conv2, proj), batch_normalization_* (bn1, bn2 per
    block, final BN last), dense_1 gender, dense_2 age."""
    convs = [params["conv1"]["kernel"]]
    bns = []
    for gi in (1, 2, 3):
        for b in range(2):
            blk = params[f"g{gi}_b{b}"]
            convs += [blk["conv1"], blk["conv2"]] + ([blk["proj"]] if "proj" in blk else [])
            bns += [blk["bn1"], blk["bn2"]]
    bns.append(params["bn_final"])
    layers = {f"conv2d_{i}": {"kernel": k} for i, k in enumerate(convs, start=1)}
    for i, bn in enumerate(bns, start=1):
        layers[f"batch_normalization_{i}"] = {
            "gamma": bn["gamma"], "beta": bn["beta"], "moving_mean": bn["mean"],
            "moving_variance": bn["var"]}
    layers["dense_1"] = {"kernel": params["gender"]["kernel"]}
    layers["dense_2"] = {"kernel": params["age"]["kernel"]}
    _keras_h5(path, layers)


def test_wide_resnet_h5_import_bit_equal(tmp_path):
    params = twrn.init_wide_resnet_params(_gen(6), k=2, input_size=32)
    path = str(tmp_path / "weights.28-3.73.hdf5")
    _write_wrn_h5(params, path)
    got = twrn.wide_resnet_params_from_h5(path)
    _assert_trees_equal(got, jwrn.wide_resnet_params_from_h5(path))
    _assert_trees_equal(got, params)


# ---------------------------------------------------------------- MobileNetV2

def test_agendernet_forward_matches_jax(rng):
    params = tmn2.init_mobilenet_v2_params(_gen(7))
    x = _images(rng, 2, 96)
    want = jax.jit(jmn2.agendernet_apply)(_jnp(params), x)
    got = _port(tmn2.agendernet_apply, params, x)
    for name, g, w in zip(("gender", "age"), got, want):
        _close(g, w, name)
    wg, wa = jmn2.decode_agendernet(*want)
    tg, ta = tmn2.decode_agendernet(*[torch.from_numpy(np.array(a)) for a in want])
    np.testing.assert_array_equal(tg.numpy(), np.asarray(wg))
    _close(ta.numpy(), wa, "decoded ages")


def test_agendernet_preprocess_is_the_jitted_fma(rng):
    """``x / 127.5 - 1`` inside ``jax.jit`` equals the port's FMA with the
    float32 reciprocal bit for bit."""
    from hse_facerec_torch.ops.preprocess import normalize_tf

    x = (rng.rand(4096) * 255).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a / 127.5 - 1.0)(x))
    np.testing.assert_array_equal(normalize_tf(torch.from_numpy(x)).numpy(), want)


def _write_mobilenet_v2_h5(params, path):
    layers = {}

    def bn(p):
        return {"gamma": p["gamma"], "beta": p["beta"], "moving_mean": p["mean"],
                "moving_variance": p["var"]}

    layers["Conv1"] = {"kernel": params["conv1"]["kernel"]}
    layers["bn_Conv1"] = bn(params["conv1"]["bn"])
    i = 0
    for t, _, n, _ in tmn2.MOBILENET_V2_BLOCKS:
        for _ in range(n):
            pre = "expanded_conv" if i == 0 else f"block_{i}"
            blk = params[f"block{i}"]
            if "expand" in blk:
                layers[f"{pre}_expand"] = {"kernel": blk["expand"]}
                layers[f"{pre}_expand_BN"] = bn(blk["expand_bn"])
            layers[f"{pre}_depthwise"] = {"depthwise_kernel": blk["dw"]}
            layers[f"{pre}_depthwise_BN"] = bn(blk["dw_bn"])
            layers[f"{pre}_project"] = {"kernel": blk["project"]}
            layers[f"{pre}_project_BN"] = bn(blk["project_bn"])
            i += 1
    layers["Conv_1"] = {"kernel": params["conv_last"]["kernel"]}
    layers["Conv_1_bn"] = bn(params["conv_last"]["bn"])
    layers["gender_prediction"] = params["gender"]
    layers["age_prediction"] = params["age"]
    _keras_h5(path, layers)


def test_mobilenet_v2_h5_import_bit_equal(tmp_path):
    params = tmn2.init_mobilenet_v2_params(_gen(8))
    path = str(tmp_path / "agendernet_mn2.h5")
    _write_mobilenet_v2_h5(params, path)
    got = tmn2.mobilenet_v2_params_from_h5(path)
    _assert_trees_equal(got, jmn2.mobilenet_v2_params_from_h5(path))
    _assert_trees_equal(got, params)


# ---------------------------------------------------------------- Inception-ResNet-v1

@pytest.fixture(scope="module")
def inception_params():
    return tir.init_inception_resnet_v1_params(_gen(9), with_heads=True)


def test_inception_resnet_forward_matches_jax(inception_params, rng):
    """At 96² (the smallest input the two reductions keep non-empty at
    every stage): the embedding and both heads."""
    x = (rng.rand(2, 96, 96, 3).astype(np.float32) - 0.5) * 2
    want = jax.jit(jir.inception_resnet_v1_age_gender)(_jnp(inception_params), x)
    got = _port(tir.inception_resnet_v1_age_gender, inception_params, x)
    for name, g, w in zip(("age", "gender"), got, want):
        _close(g, w, name)


def _slim_npz(params, path):
    """slim variable names: BN without gamma (scale=False ⇒ ones), the
    Bottleneck FC with its own BatchNorm, biased ``up`` convs."""
    R = "InceptionResnetV1"
    w = {}

    def cb(scope, p):
        w[f"{scope}/weights"] = p["kernel"]
        for k, name in (("beta", "beta"), ("mean", "moving_mean"), ("var", "moving_variance")):
            w[f"{scope}/BatchNorm/{name}"] = p["bn"][k]

    def up(scope, p):
        w[f"{scope}/weights"] = p["kernel"]
        w[f"{scope}/biases"] = p["bias"]

    for key, scope in (("conv1a", "Conv2d_1a_3x3"), ("conv2a", "Conv2d_2a_3x3"),
                       ("conv2b", "Conv2d_2b_3x3"), ("conv3b", "Conv2d_3b_1x1"),
                       ("conv4a", "Conv2d_4a_3x3"), ("conv4b", "Conv2d_4b_3x3")):
        cb(f"{R}/{scope}", params[key])
    for i in range(5):
        s, p = f"{R}/Repeat/block35_{i + 1}", params[f"block35_{i}"]
        for key, sub in (("b0", "Branch_0/Conv2d_1x1"), ("b1a", "Branch_1/Conv2d_0a_1x1"),
                         ("b1b", "Branch_1/Conv2d_0b_3x3"), ("b2a", "Branch_2/Conv2d_0a_1x1"),
                         ("b2b", "Branch_2/Conv2d_0b_3x3"), ("b2c", "Branch_2/Conv2d_0c_3x3")):
            cb(f"{s}/{sub}", p[key])
        up(f"{s}/Conv2d_1x1", p["up"])
    for key, sub in (("b0", "Branch_0/Conv2d_1a_3x3"), ("b1a", "Branch_1/Conv2d_0a_1x1"),
                     ("b1b", "Branch_1/Conv2d_0b_3x3"), ("b1c", "Branch_1/Conv2d_1a_3x3")):
        cb(f"{R}/Mixed_6a/{sub}", params["reduction_a"][key])
    for i in range(10):
        s, p = f"{R}/Repeat_1/block17_{i + 1}", params[f"block17_{i}"]
        for key, sub in (("b0", "Branch_0/Conv2d_1x1"), ("b1a", "Branch_1/Conv2d_0a_1x1"),
                         ("b1b", "Branch_1/Conv2d_0b_1x7"), ("b1c", "Branch_1/Conv2d_0c_7x1")):
            cb(f"{s}/{sub}", p[key])
        up(f"{s}/Conv2d_1x1", p["up"])
    for key, sub in (("b0a", "Branch_0/Conv2d_0a_1x1"), ("b0b", "Branch_0/Conv2d_1a_3x3"),
                     ("b1a", "Branch_1/Conv2d_0a_1x1"), ("b1b", "Branch_1/Conv2d_1a_3x3"),
                     ("b2a", "Branch_2/Conv2d_0a_1x1"), ("b2b", "Branch_2/Conv2d_0b_3x3"),
                     ("b2c", "Branch_2/Conv2d_1a_3x3")):
        cb(f"{R}/Mixed_7a/{sub}", params["reduction_b"][key])
    for i, scope in [(j, f"{R}/Repeat_2/block8_{j + 1}") for j in range(5)] + [
            ("final", f"{R}/Block8")]:
        p = params[f"block8_{i}"]
        for key, sub in (("b0", "Branch_0/Conv2d_1x1"), ("b1a", "Branch_1/Conv2d_0a_1x1"),
                         ("b1b", "Branch_1/Conv2d_0b_1x3"), ("b1c", "Branch_1/Conv2d_0c_3x1")):
            cb(f"{scope}/{sub}", p[key])
        up(f"{scope}/Conv2d_1x1", p["up"])
    rng = np.random.RandomState(10)
    c = params["bottleneck"]["kernel"].shape[1]
    w[f"{R}/Bottleneck/weights"] = params["bottleneck"]["kernel"]
    w[f"{R}/Bottleneck/BatchNorm/beta"] = rng.randn(c).astype(np.float32) * 0.1
    w[f"{R}/Bottleneck/BatchNorm/moving_mean"] = rng.randn(c).astype(np.float32) * 0.1
    w[f"{R}/Bottleneck/BatchNorm/moving_variance"] = rng.rand(c).astype(np.float32) + 0.5
    for head in ("age", "gender"):
        w[f"logits/{head}/weights"] = params[head]["kernel"]
        w[f"logits/{head}/biases"] = params[head]["bias"]
    np.savez(path, **w)


def test_inception_resnet_npz_import_bit_equal(inception_params, tmp_path):
    path = str(tmp_path / "facenet_age_gender.npz")
    _slim_npz(inception_params, path)
    _assert_trees_equal(tir.inception_resnet_v1_params_from_npz(path),
                        jir.inception_resnet_v1_params_from_npz(path))


# ---------------------------------------------------------------- ArcFace IResNet

def _mxnet_weights(units, emb, seed):
    from .test_arcface import _random_mxnet_weights

    return _random_mxnet_weights(np.random.RandomState(seed), emb=emb, units=units)[0]


@pytest.mark.parametrize("units,emb", [((1, 1, 1, 1), 202), ((2, 1, 2, 1), 64)])
def test_iresnet_import_and_forward_match_jax(tmp_path, rng, units, emb):
    """MXNet-named npz -> both importers (bit-equal, unit counts from the
    names) -> both forwards (fc1 output), then the gender-age decode."""
    path = str(tmp_path / "iresnet.npz")
    np.savez(path, **_mxnet_weights(units, emb, seed=sum(units)))
    got = tarc.iresnet_params_from_npz(path)
    want = jarc.iresnet_params_from_npz(path)
    _assert_trees_equal(got, want)
    assert tarc.iresnet_units(got) == units == jarc.iresnet_units(want)
    x = _images(rng, 2, 112)
    out_j = jax.jit(jarc.iresnet_embed)(want, x)
    out_t = _port(tarc.iresnet_embed, got, x)
    _close(out_t, out_j, "fc1")
    if emb == 202:
        g_j, a_j = jarc.decode_gender_age(out_j)
        g_t, a_t = tarc.decode_gender_age(torch.from_numpy(np.asarray(out_j)))
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))


def test_iresnet_import_refuses_a_wrong_depth(tmp_path):
    path = str(tmp_path / "r.npz")
    np.savez(path, **_mxnet_weights((1, 1, 1, 1), 8, seed=0))
    with pytest.raises(ValueError, match="not IResNet-34"):
        tarc.iresnet_params_from_npz(path, depth=34)


def test_iresnet_input_scale_is_the_jitted_reciprocal(rng):
    from hse_facerec_torch.numerics import div_const

    x = (rng.rand(4096) * 255).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: (a - 127.5) / 127.5)(x))
    np.testing.assert_array_equal(div_const(torch.from_numpy(x) - 127.5, 127.5).numpy(),
                                  want)


@pytest.mark.parametrize("hw", [(80, 100), (100, 80), (112, 112)])
def test_letterbox_matches_jax(rng, hw):
    img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    _close(tarc.letterbox_112(img), jarc.letterbox_112(img))


def test_init_iresnet_shapes_match_jax():
    got = tarc.init_iresnet_params(_gen(11), depth=34, emb_dim=64)
    want = jarc.init_iresnet_params(jax.random.PRNGKey(0), depth=34, emb_dim=64)
    shapes = lambda t: jax.tree.map(lambda a: np.shape(a), t)
    assert shapes(got) == shapes(want)


# ---------------------------------------------------------------- VGG16

@pytest.fixture(scope="module")
def vgg16_params():
    return tvgg.init_vgg16_params(_gen(12))


def test_vgg16_forward_matches_jax(vgg16_params, rng):
    x = (rng.rand(1, 224, 224, 3).astype(np.float32) * 2 - 1) * 60
    want = jax.jit(jvgg.vgg16_embed)(_jnp(vgg16_params), x)
    got = _port(tvgg.vgg16_embed, vgg16_params, x)
    assert got.shape == (1, 4096) and np.any(np.asarray(want) > 0)
    _close(got, want, "fc7")


def test_vgg16_h5_import_bit_equal(vgg16_params, tmp_path):
    """The published keras_vggface names ('<layer>/<layer>_W_1:0', '_b_1:0')."""
    import h5py

    path = str(tmp_path / "rcmalli_vggface_tf_vgg16.h5")
    with h5py.File(path, "w") as f:
        for layer, p in vgg16_params.items():
            g = f.create_group(layer)
            g.create_dataset(f"{layer}/{layer}_W_1:0", data=p["kernel"])
            g.create_dataset(f"{layer}/{layer}_b_1:0", data=p["bias"])
    got = tvgg.vgg16_params_from_h5(path)
    _assert_trees_equal(got, jvgg.vgg16_params_from_h5(path))
    _assert_trees_equal(got, vgg16_params)


# ---------------------------------------------------------------- the zoo entries

def test_zoo_insightface_arcface_matches_jax(tmp_path, rng, monkeypatch):
    """``build_extractor('insightface_arcface')`` of both packages on the
    same MXNet-named npz (the entry's path pointed at it): 112², raw 0-255
    in, L2-normalized 512-d rows within 1e-4; 'imported' in both."""
    from hse_facerec_tf_tpu.models import zoo as jzoo
    from hse_facerec_torch.models import zoo as tzoo

    path = str(tmp_path / "arcface.npz")
    np.savez(path, **_mxnet_weights((1, 2, 1, 1), 512, seed=13))
    for zoo in (jzoo, tzoo):
        monkeypatch.setattr(zoo, "ARCFACE_NPZ", path)
        assert zoo.weights_origin("insightface_arcface") == "imported"
    imgs = (rng.rand(3, 130, 120, 3) * 255).astype(np.uint8)
    want = jzoo.build_extractor("insightface_arcface", batch_size=4).extract_batch(imgs)
    got = tzoo.build_extractor("insightface_arcface", batch_size=4,
                               device="cpu").extract_batch(imgs)
    assert got.shape == (3, tzoo.MODEL_ZOO["insightface_arcface"].embedding_dim) == (3, 512)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    _close(got, want)


def test_zoo_vggface_vgg16_matches_jax(vgg16_params, rng, monkeypatch):
    """``build_extractor('vggface_vgg16')``: PIL-nearest resize to 224²,
    the keras_vggface v1 means, the fc7/relu 4096-d tap; the JAX entry
    builds from the same seeded params."""
    import dataclasses

    from hse_facerec_tf_tpu.models import zoo as jzoo
    from hse_facerec_torch.models import zoo as tzoo

    spec = jzoo.MODEL_ZOO["vggface_vgg16"]
    monkeypatch.setitem(jzoo.MODEL_ZOO, "vggface_vgg16", dataclasses.replace(
        spec, build_params=lambda: _jnp(vgg16_params)))
    imgs = (rng.rand(2, 64, 48, 3) * 255).astype(np.uint8)
    want = jzoo.build_extractor("vggface_vgg16", batch_size=2).extract_batch(imgs)
    got = tzoo.build_extractor("vggface_vgg16", batch_size=2, device="cpu",
                               params=vgg16_params).extract_batch(imgs)
    assert got.shape == (2, tzoo.MODEL_ZOO["vggface_vgg16"].embedding_dim) == (2, 4096)
    _close(got, want)


def test_zoo_new_entries_fall_back_to_seeded_weights(monkeypatch, tmp_path):
    """Without their files the entries warn and build from seeded weights
    (the same ones twice), as the JAX package's do from its own seed."""
    from hse_facerec_torch.models import zoo as tzoo

    monkeypatch.setattr(tzoo, "ARCFACE_NPZ", str(tmp_path / "absent.npz"))
    monkeypatch.setattr(tzoo, "VGGFACE_VGG16_H5", str(tmp_path / "absent.h5"))
    for name in ("insightface_arcface", "vggface_vgg16"):
        assert tzoo.weights_origin(name) == "random"
    with pytest.warns(RuntimeWarning, match="RANDOM"):
        a = tzoo.MODEL_ZOO["insightface_arcface"].build_params()
    with pytest.warns(RuntimeWarning, match="RANDOM"):
        b = tzoo.MODEL_ZOO["insightface_arcface"].build_params()
    assert tarc.iresnet_units(a) == tarc.IRESNET_UNITS[100]
    _assert_trees_equal(a, b)
