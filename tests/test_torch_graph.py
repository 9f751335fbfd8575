"""The frozen-graph slice of the PyTorch port against the JAX package.

The same seeded numpy params go through both packages: the port's
``graph_compiler`` against the jitted JAX compiler on the same pb (every op
the exporters and the frozen-Keras forms emit, plus the hazards: TF SAME
padding, the depthwise channel multiplier, the FusedBatchNorm epsilon and
training branch, StridedSlice masks, reductions with ``keep_dims``), within
``atol=1e-4``; the port's ``pb_import``/``h5_import`` bit-equal to the JAX
importers on the same files; the port's exporters byte-identical to the
JAX exporters for the same params; ``resnet50_embed`` against the JAX
forward; the zoo's new entries and ``graph_extractor``.
"""

import jax
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.core import graph_compiler as jgc
from hse_facerec_tf_tpu.core import graphdef_export as jexp
from hse_facerec_tf_tpu.core import h5_import as jh5
from hse_facerec_tf_tpu.core import pb_import as jpb
from hse_facerec_tf_tpu.models import mobilenet as jmb
from hse_facerec_tf_tpu.models import resnet as jrn
from hse_facerec_tf_tpu.models import zoo as jzoo
from hse_facerec_torch.core import graph_compiler as tgc
from hse_facerec_torch.core import graphdef_export as texp
from hse_facerec_torch.core import h5_import as th5
from hse_facerec_torch.core import pb_import as tpb
from hse_facerec_torch.core import protowire as pw
from hse_facerec_torch.core.graphdef import DT_FLOAT, DT_INT32
from hse_facerec_torch.models import resnet as trn
from hse_facerec_torch.models import zoo as tzoo
from hse_facerec_torch.params import to_numpy, to_torch
from hse_facerec_torch.testing import (random_mobilenet_params,
                                       random_multihead_params,
                                       random_resnet50_params)

ATOL = 1e-4


@pytest.fixture
def rng():
    return np.random.RandomState(31)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _assert_trees_equal(got, want, path=""):
    """Same keys, same dtypes, same bits."""
    assert sorted(got) == sorted(want), path
    for k in got:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


def _bn_params(params, rng):
    """A folded tree in BN form: each conv's bias becomes BN statistics
    around 1 (gamma, var) and 0 (beta, mean), so folding errors show and
    the activations keep the folded tree's range."""
    out = {}
    for k, v in params.items():
        if "kernel" not in v:
            out[k] = _bn_params(v, rng)
            continue
        n = v["bias"].shape[0]
        out[k] = {"kernel": v["kernel"], "bn": {
            "gamma": (rng.rand(n) * 0.4 + 0.8).astype(np.float32),
            "beta": v["bias"],
            "mean": (rng.randn(n) * 0.1).astype(np.float32),
            "var": (rng.rand(n) * 0.4 + 0.8).astype(np.float32)}}
    return out


@pytest.fixture(scope="module")
def mobilenet_bn():
    return _bn_params(random_mobilenet_params(np.random.RandomState(9)),
                      np.random.RandomState(1))


@pytest.fixture(scope="module")
def resnet_bn():
    return _bn_params(random_resnet50_params(np.random.RandomState(11)),
                      np.random.RandomState(2))


def _run_both(path, outputs, feeds, **kw):
    jcg = jgc.compile_pb(path, outputs, **kw)
    want = [np.asarray(o) for o in jcg.jit()(jcg.params, feeds)]
    tcg = tgc.compile_pb(path, outputs, **kw)
    got = tcg.fn(tcg.torch_params("cpu"),
                 {k: torch.from_numpy(v) for k, v in feeds.items()})
    return [g.numpy() for g in got], want, tcg


# ---------- the exporters: byte-identical ----------

# name -> (params, export(module, params, path)): the multi-head and
# single-head graphs, MobileNet and ResNet-50 from BN-form and folded trees
EXPORTS = {
    "multihead": ("multihead", lambda m, p, path: m.export_multihead_pb(
        p, path, input_size=64)),
    "age": ("multihead", lambda m, p, path: m.export_age_pb(p, path, input_size=64)),
    "gender": ("multihead", lambda m, p, path: m.export_gender_pb(
        p, path, input_size=64)),
    "mobilenet_folded": ("mobilenet_folded", lambda m, p, path:
                         m.export_mobilenet_embedder_pb(p, path, input_size=64)),
    "mobilenet_bn": ("mobilenet_bn", lambda m, p, path:
                     m.export_mobilenet_embedder_pb(p, path, input_size=64)),
    "resnet_bn": ("resnet_bn", lambda m, p, path:
                  m.export_resnet_embedder_pb(p, path, input_size=64)),
    "resnet_folded": ("resnet_folded", lambda m, p, path:
                      m.export_resnet_embedder_pb(p, path, input_size=64)),
}
OUTPUTS = {"multihead": ["age_pred/Softmax:0", "gender_pred/Sigmoid:0",
                         "global_pooling/Mean:0"],
           "mobilenet_bn": ["reshape_1/Reshape:0"],
           "resnet_bn": ["pool5_7x7_s1:0"],
           "resnet_folded": ["pool5_7x7_s1:0"]}


def _export(module, name, path, trees):
    kind, export = EXPORTS[name]
    params = trees[kind]
    export(module, params, path)
    return params


@pytest.fixture(scope="module")
def trees(mobilenet_bn, resnet_bn):
    return {"multihead": random_multihead_params(np.random.RandomState(3)),
            "mobilenet_folded": random_mobilenet_params(np.random.RandomState(12)),
            "mobilenet_bn": mobilenet_bn, "resnet_bn": resnet_bn,
            "resnet_folded": random_resnet50_params(np.random.RandomState(4))}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_exporters_write_the_same_bytes(name, tmp_path, trees):
    _export(jexp, name, str(tmp_path / "jax.pb"), trees)
    _export(texp, name, str(tmp_path / "port.pb"), trees)
    want = (tmp_path / "jax.pb").read_bytes()
    assert (tmp_path / "port.pb").read_bytes() == want and len(want) > 1000


# ---------- the compiler: the same pb through both packages ----------

@pytest.mark.parametrize("name", sorted(OUTPUTS))
def test_compile_pb_matches_jax(name, tmp_path, rng, trees):
    path = str(tmp_path / "g.pb")
    _export(texp, name, path, trees)
    feed = "input" if name.startswith("resnet") else "input_1"
    x = (rng.rand(2, 64, 64, 3) * 255 - 120).astype(np.float32)
    got, want, _ = _run_both(path, OUTPUTS[name], {feed: x})
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.all(np.isfinite(g))
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def _attr_list(key, ints):
    return jexp.GraphBuilder._attr_int_list(key, ints)


def _ops_graph(b, rng):
    """Every op the compiler knows that the exporters do not emit, with the
    hazards: SAME convs at stride 2 on an even size, a depthwise channel
    multiplier of 2, SAME and VALID pools, StridedSlice with begin/end/
    shrink masks and a negative stride, keep_dims reductions."""
    G = type(b)
    x = b.placeholder("x", [-1, 10, 12, 3])
    c = b.conv2d("conv", x, b.const("w", rng.randn(3, 3, 3, 4).astype(np.float32)),
                 stride=2)
    d = b.depthwise_conv2d("dw", c, b.const("dww", rng.randn(3, 3, 4, 2)
                                            .astype(np.float32)), stride=2)
    bn = b.fused_batch_norm(
        "bn", d, b.const("g", (rng.rand(8) + 0.5).astype(np.float32)),
        b.const("be", rng.randn(8).astype(np.float32)),
        b.const("m", rng.randn(8).astype(np.float32)),
        b.const("v", (rng.rand(8) + 0.5).astype(np.float32)), epsilon=0.01)
    r6 = b.simple("Relu6", "r6", [bn + ":0"])
    mp = b.max_pool("mp", c, 3, 2, "SAME")
    pool = lambda name, op, inp, k, s, pad: b._node(
        name, op, [inp], G._attr_type("T", DT_FLOAT) + G._attr_string("padding", pad)
        + _attr_list("ksize", [1, k, k, 1]) + _attr_list("strides", [1, s, s, 1]))
    ap_same = pool("ap_same", "AvgPool", c, 3, 2, "SAME")
    ap_valid = pool("ap_valid", "AvgPool", c, 2, 2, "VALID")
    # StridedSlice: x[1:, ::-2, 1, :3] over (N, 10, 12, 3)
    ss = b._node("ss", "StridedSlice", [
        x, b.const("ss/b", np.asarray([0, 0, 1, 0], np.int32)),
        b.const("ss/e", np.asarray([0, 0, 2, 3], np.int32)),
        b.const("ss/s", np.asarray([1, -2, 1, 1], np.int32))],
        G._attr_type("T", DT_FLOAT) + G._attr_type("Index", DT_INT32)
        + G._attr("begin_mask", pw.encode_varint_field(3, 0b0011))
        + G._attr("end_mask", pw.encode_varint_field(3, 0b0011))
        + G._attr("shrink_axis_mask", pw.encode_varint_field(3, 0b0100)))
    red = lambda name, op, inp, axes, keep: b._node(
        name, op, [inp, b.const(name + "/axes", np.asarray(axes, np.int32))],
        G._attr_type("T", DT_FLOAT) + G._attr_type("Tidx", DT_INT32)
        + G._attr_bool("keep_dims", keep))
    mean_k = red("mean_k", "Mean", r6, [1, 2], True)
    sum_ = red("sum", "Sum", mp, [1], False)
    max_k = red("max_k", "Max", ap_same, [-1], True)
    pad = b.pad("pad", ap_valid, [[0, 0], [1, 2], [0, 1], [0, 0]])
    sq = b._node("sq", "Squeeze", [mean_k], G._attr_type("T", DT_FLOAT)
                 + _attr_list("squeeze_dims", [1, 2]))
    cat = b._node("cat", "ConcatV2", [sq, sq, b.const("cat/axis", np.int32(1)
                                                       .reshape(()))],
                  G._attr_type("T", DT_FLOAT) + G._attr("N", pw.encode_varint_field(3, 2)))
    mm = b.matmul("mm", cat, b.const("mmw", rng.randn(16, 5).astype(np.float32)))
    sm = b.simple("Softmax", "sm", [mm])
    sig = b.simple("Sigmoid", "sig", [b.simple("Neg", "neg", [mm])])
    div = b.simple("RealDiv", "div", [sum_, b.const("three", np.float32(3.0)
                                                    .reshape(()))])
    mx = b.simple("Maximum", "mx", [b.simple("Sqrt", "sq2", [b.simple(
        "Abs", "abs", [ss])]), b.const("half", np.float32(0.5).reshape(()))])
    return ["r6", "mp", "ap_same", "ap_valid", "ss", "mean_k", "sum", "max_k",
            "pad", "sm", "sig", "div", "mx"]


def test_compiler_ops_match_jax(tmp_path, rng):
    b = texp.GraphBuilder()
    outputs = _ops_graph(b, np.random.RandomState(5))
    path = str(tmp_path / "ops.pb")
    with open(path, "wb") as f:
        f.write(b.serialize())
    x = (rng.rand(2, 10, 12, 3) * 4 - 2).astype(np.float32)
    got, want, _ = _run_both(path, [o + ":0" for o in outputs], {"x": x})
    for name, g, w in zip(outputs, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


def _keras_bn_graph(module, rng):
    """The frozen-Keras conv+BN form behind Switch/Merge learning-phase
    control flow, built by ``module``'s GraphBuilder (JAX
    ``tests/test_graph_compiler.py::_keras_bn_graphdef``): the training
    branch multiplies by 2."""
    w = rng.randn(3, 3, 3, 4).astype(np.float32) * 0.3
    gamma = rng.rand(4).astype(np.float32) + 0.5
    beta = rng.randn(4).astype(np.float32)
    mean = rng.randn(4).astype(np.float32) * 0.2
    var = rng.rand(4).astype(np.float32) + 0.3
    b = module.GraphBuilder()
    x = b.placeholder("input_1", [-1, 8, 8, 3])
    conv = b.conv2d("conv1/convolution", x, b.const("conv1/kernel", w))
    lp = b.placeholder_bool("conv1_bn/keras_learning_phase")
    sw = b.switch("conv1_bn/cond/Switch", conv, lp)
    train_y = b.simple("Mul", "conv1_bn/cond/train_branch",
                       [sw + ":1", b.const("two", np.float32(2.0).reshape(()))])
    bn = b.fused_batch_norm(
        "conv1_bn/cond/FusedBatchNorm", sw + ":0",
        b.const("conv1_bn/gamma", gamma), b.const("conv1_bn/beta", beta),
        b.const("conv1_bn/moving_mean", mean),
        b.const("conv1_bn/moving_variance", var), epsilon=1e-3)
    merged = b.merge("conv1_bn/cond/Merge", [train_y, bn + ":0"])
    b.simple("Relu", "conv1/Relu", [merged])
    return b.serialize()


@pytest.mark.parametrize("case", ["inference", "learning_phase", "feed_true",
                                  "feed_false"])
def test_frozen_keras_bn_control_flow(case, tmp_path, rng):
    """Inference branch, the training branch (``learning_phase=True``) and a
    bool const feed deciding the branch, as JAX
    ``tests/test_graph_compiler.py:105-186``; the dead branch is pruned."""
    data = _keras_bn_graph(texp, np.random.RandomState(6))
    assert data == _keras_bn_graph(jexp, np.random.RandomState(6))
    path = tmp_path / "bn.pb"
    path.write_bytes(data)
    kw = {"learning_phase": dict(learning_phase=True),
          "feed_true": dict(const_feeds={"conv1_bn/keras_learning_phase:0": np.bool_(True)}),
          "feed_false": dict(const_feeds={"conv1_bn/keras_learning_phase:0": np.bool_(False)}),
          "inference": {}}[case]
    x = (rng.rand(2, 8, 8, 3) * 2 - 1).astype(np.float32)
    (got,), (want,), tcg = _run_both(str(path), ["conv1/Relu:0"], {"input_1": x}, **kw)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    training = case in ("learning_phase", "feed_true")
    live = {n.name for n in tcg._needed}
    assert ("conv1_bn/cond/train_branch" in live) == training
    assert ("conv1_bn/cond/FusedBatchNorm" in live) != training
    assert ("two" in tcg.params) == training


def _dropout_graph(module, input_name, output_name):
    b = module.GraphBuilder()
    x = b.placeholder(input_name, [-1, 8, 8, 3])
    rate = b.placeholder("dropout_rate", [])
    pooled = b.mean("pool", x, [1, 2])
    b.simple("Mul", output_name, [pooled, rate])
    return b.serialize()


def test_const_feeds_scalar_placeholder(tmp_path, rng):
    """A scalar placeholder pinned when the graph is compiled (the
    reference's additional_input_value); unfed, it raises."""
    path = tmp_path / "feed.pb"
    path.write_bytes(_dropout_graph(texp, "input", "out"))
    x = rng.rand(2, 8, 8, 3).astype(np.float32)
    (got,), (want,), _ = _run_both(str(path), ["out:0"], {"input": x},
                                   const_feeds={"dropout_rate:0": np.float32(0.9)})
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    cg = tgc.compile_pb(str(path), ["out:0"])
    with pytest.raises(KeyError):
        cg.fn(cg.torch_params("cpu"), {"input": torch.from_numpy(x)})


def test_graph_extractor_extra_feeds(tmp_path, rng):
    """``graph_extractor`` with a pinned scalar feed (the FaceNet /
    insightface.pb zoo rows, facerec_test.py:215-216) against the JAX one."""
    path = tmp_path / "ext.pb"
    path.write_bytes(_dropout_graph(texp, "img_inputs", "embeddings"))
    kw = dict(normalization="none", resize_method="cv2_linear", batch_size=4,
              extra_feeds={"dropout_rate:0": 0.9})
    imgs = (rng.rand(2, 8, 8, 3) * 255).astype(np.uint8)
    got = tzoo.graph_extractor(str(path), "img_inputs:0", "embeddings:0", (8, 8),
                               device="cpu", **kw).extract_batch(imgs)
    want = jzoo.graph_extractor(str(path), "img_inputs:0", "embeddings:0", (8, 8),
                                **kw).extract_batch(imgs)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, imgs.astype(np.float32).mean(axis=(1, 2)) * 0.9,
                               rtol=1e-5)


def test_graph_extractor_defaults_to_cuda(tmp_path):
    path = tmp_path / "ext.pb"
    path.write_bytes(_dropout_graph(texp, "img_inputs", "embeddings"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tzoo.graph_extractor(str(path), "img_inputs:0", "embeddings:0", (8, 8))


def test_graph_extractor_matches_mobilenet_embed(tmp_path, rng):
    """The exported MobileNet pb through ``graph_extractor`` equals the
    native ``mobilenet_embed`` of the same params (what the smoke checks on
    the card)."""
    from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor

    params = random_mobilenet_params(np.random.RandomState(8))
    path = str(tmp_path / "m.pb")
    texp.export_mobilenet_embedder_pb(params, path, input_size=64)
    kw = dict(normalization="caffe", resize_method="pil_bilinear", batch_size=8)
    imgs = (rng.rand(3, 64, 64, 3) * 255).astype(np.uint8)
    got = tzoo.graph_extractor(path, "input_1:0", "reshape_1/Reshape:0", (64, 64),
                               device="cpu", **kw).extract_batch(imgs)
    want = EmbeddingExtractor(tzoo.MODEL_ZOO["vgg2_mobilenet"].model_fn(), params,
                              (64, 64), device="cpu", **kw).extract_batch(imgs)
    np.testing.assert_allclose(got, want, atol=ATOL,
                               rtol=0)


# ---------- the importers: bit-equal to the JAX package's ----------

def _keras_mobilenet_pb(module, params, path):
    """Frozen-Keras-form MobileNet pb: unfolded FusedBatchNorm per conv, the
    stem's behind Switch/Merge (JAX ``tests/test_pb_import.py::
    test_mobilenet_kerasform_pb_import``)."""
    g = module.GraphBuilder()
    x = g.placeholder("input_1", [-1, 64, 64, 3])
    lp = g.placeholder_bool("conv1_bn/keras_learning_phase")

    def conv_bn_relu6(x, key, name, stride, depthwise=False, switch=False):
        p = params[key]
        w = g.const(f"{name}/kernel", np.asarray(p["kernel"], np.float32))
        x = (g.depthwise_conv2d(f"{name}/depthwise", x, w, stride=stride)
             if depthwise else g.conv2d(f"{name}/Conv2D", x, w, stride=stride))
        consts = [g.const(f"{name}_bn/{k}", np.asarray(p["bn"][k], np.float32))
                  for k in ("gamma", "beta", "mean", "var")]
        if switch:
            sw = g.switch(f"{name}_bn/cond/Switch", x, lp)
            train_y = g.simple("Mul", f"{name}_bn/cond/train",
                               [sw + ":1", g.const(f"{name}_bn/two",
                                                   np.float32(2.0).reshape(()))])
            bn_out = g.fused_batch_norm(f"{name}_bn/FusedBatchNorm", sw + ":0",
                                        *consts, epsilon=1e-3)
            x = g.merge(f"{name}_bn/cond/Merge", [train_y, bn_out + ":0"])
        else:
            x = g.fused_batch_norm(f"{name}_bn/FusedBatchNorm", x, *consts,
                                   epsilon=1e-3)
        return g.simple("Relu6", f"{name}/Relu6", [x])

    x = conv_bn_relu6(x, "conv1", "conv1", 2, switch=True)
    for i, (stride, _) in enumerate(jmb.MOBILENET_V1_BLOCKS, start=1):
        x = conv_bn_relu6(x, f"dw{i}", f"conv_dw_{i}", stride, depthwise=True)
        x = conv_bn_relu6(x, f"pw{i}", f"conv_pw_{i}", 1)
    g.mean("global_pooling/Mean", x, [1, 2])
    with open(path, "wb") as f:
        f.write(g.serialize())


@pytest.mark.parametrize("form", ["folded", "bn", "keras"])
def test_mobilenet_pb_import_bit_equal(form, tmp_path, trees):
    path = str(tmp_path / "m.pb")
    params = trees["mobilenet_folded" if form == "folded" else "mobilenet_bn"]
    if form == "keras":
        _keras_mobilenet_pb(texp, params, path)
    else:
        texp.export_mobilenet_embedder_pb(params, path, input_size=64)
    got = tpb.mobilenet_params_from_pb(path)
    _assert_trees_equal(got, _np_tree(jpb.mobilenet_params_from_pb(path)))
    if form == "folded":      # a folded tree round-trips exactly
        _assert_trees_equal(got, params)
    assert "bn" not in got["conv1"]


@pytest.mark.parametrize("form", ["folded", "bn"])
def test_resnet50_pb_import_bit_equal(form, tmp_path, trees):
    params = trees[f"resnet_{form}"]
    path = str(tmp_path / "r.pb")
    texp.export_resnet_embedder_pb(params, path, input_size=64)
    got = tpb.resnet50_params_from_pb(path)
    _assert_trees_equal(got, _np_tree(jpb.resnet50_params_from_pb(path)))
    if form == "folded":
        _assert_trees_equal(got, params)
    assert "bn" not in got["stem"]


def test_pb_import_rejects_the_wrong_architecture(tmp_path):
    path = str(tmp_path / "not_mobilenet.pb")
    texp.export_resnet_embedder_pb(random_resnet50_params(np.random.RandomState(0)),
                                   path, input_size=64)
    for module in (tpb, jpb):
        with pytest.raises(module.GraphStructureError):
            module.mobilenet_params_from_pb(path)
    path = str(tmp_path / "not_resnet.pb")
    texp.export_mobilenet_embedder_pb(random_mobilenet_params(np.random.RandomState(0)),
                                      path, input_size=64)
    for module in (tpb, jpb):
        with pytest.raises(module.GraphStructureError):
            module.resnet50_params_from_pb(path)


def _tiny_graphs():
    """The fold_affine cases of JAX ``tests/test_pb_import.py``: Sub with
    the constant first, a post-activation Mul, a non-ReLU6 clip, and BN as
    raw constant expressions."""
    rng = np.random.RandomState(14)
    w = rng.randn(1, 1, 2, 3).astype(np.float32)
    cvec, bvec = rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32)
    gamma, beta = rng.rand(3).astype(np.float32) + 0.5, rng.randn(3).astype(np.float32)
    mean, var = rng.randn(3).astype(np.float32) * 0.2, rng.rand(3).astype(np.float32) + 0.3
    post = rng.rand(3).astype(np.float32) + 2.0

    def head(g):
        x = g.placeholder("input", [-1, 4, 4, 2])
        return g.conv2d("conv/Conv2D", x, g.const("conv/kernel", w))

    def sub_minuend(g):
        added = g.simple("BiasAdd", "conv/BiasAdd", [head(g), g.const("conv/bias", bvec)])
        sub = g.simple("Sub", "conv/Sub", [g.const("conv/c", cvec), added])
        return g.simple("Relu", "conv/Relu", [sub])

    def post_activation(g):
        relu = g.simple("Relu", "conv/Relu", [head(g)])
        return g.simple("Mul", "post/Mul", [relu, g.const("post/c", post)])

    def clip3(g):
        return g.simple("Minimum", "conv/Min",
                        [head(g), g.const("conv/three", np.float32(3.0).reshape(()))])

    def unfused_bn(g):
        conv = head(g)
        veps = g.simple("Add", "bn/add_eps", [g.const("bn/var", var), g.const(
            "bn/eps", np.float32(1e-3).reshape(()))])
        mul_const = g.simple("Mul", "bn/mul", [g.const("bn/gamma", gamma),
                                               g.simple("Rsqrt", "bn/rsqrt", [veps])])
        scaled = g.simple("Mul", "bn/mul_1", [conv, mul_const])
        shift = g.simple("Sub", "bn/sub", [g.const("bn/beta", beta), g.simple(
            "Mul", "bn/mul_2", [g.const("bn/mean", mean), mul_const])])
        return g.simple("Relu", "conv/Relu",
                        [g.simple("Add", "bn/add_1", [scaled, shift])])

    return {"sub_minuend": sub_minuend, "post_activation": post_activation,
            "clip3": clip3, "unfused_bn": unfused_bn}


@pytest.mark.parametrize("case", sorted(_tiny_graphs()))
def test_fold_affine_matches_jax(case, tmp_path):
    g = texp.GraphBuilder()
    out = _tiny_graphs()[case](g)
    path = str(tmp_path / "tiny.pb")
    with open(path, "wb") as f:
        f.write(g.serialize())
    results = []
    for module in (tpb, jpb):
        walk = module._Walk(path, [out])
        conv = next(n for n in walk.nodes if n.op == "Conv2D")
        scale, bias, act, last = walk.fold_affine(conv)
        results.append((scale, bias, act, last.name))
    (s1, b1, a1, l1), (s2, b2, a2, l2) = results
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(b1, b2)
    assert (a1, l1) == (a2, l2)
    assert {"sub_minuend": "Relu", "post_activation": "Relu", "clip3": None,
            "unfused_bn": "Relu"}[case] == a1


def test_mobilenet_h5_round_trip_bit_equal(tmp_path, mobilenet_bn, rng):
    """``save_mobilenet_h5`` writes the JAX exporter's bytes, and both
    importers read the file to the same bits (with a classifier, and the
    multi-head form)."""
    import h5py

    params = dict(mobilenet_bn, classifier={
        "kernel": rng.randn(1024, 5).astype(np.float32),
        "bias": rng.randn(5).astype(np.float32)})
    th5.save_mobilenet_h5(params, str(tmp_path / "port.h5"))
    jh5.save_mobilenet_h5(params, str(tmp_path / "jax.h5"))
    assert (tmp_path / "port.h5").read_bytes() == (tmp_path / "jax.h5").read_bytes()
    path = str(tmp_path / "port.h5")
    got = th5.mobilenet_params_from_h5(path, n_classes=5)
    _assert_trees_equal(got, _np_tree(jh5.mobilenet_params_from_h5(path, n_classes=5)))
    _assert_trees_equal(got, params)
    with h5py.File(path, "a") as f:
        root = f["model_weights"]
        for name, n_out in (("feats", 256), ("age_pred", 100), ("gender_pred", 1)):
            lg = root.require_group(name).require_group(name)
            lg.create_dataset("kernel", data=rng.randn(4, n_out).astype(np.float32))
            lg.create_dataset("bias", data=rng.randn(n_out).astype(np.float32))
    _assert_trees_equal(th5.multihead_params_from_h5(path),
                        _np_tree(jh5.multihead_params_from_h5(path)))


def _write_rcmalli_h5(path, params, stem_bias):
    """An h5 in the keras_vggface (rcmalli) ResNet-50 layout."""
    import h5py

    def put(root, layer, weights):
        g = root
        for part in (layer + "/" + layer).split("/"):
            g = g.require_group(part)
        for k, v in weights.items():
            g.create_dataset(k + ":0", data=np.asarray(v))

    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")

        def put_block(layer, p, bias=None):
            put(root, layer, {"kernel": p["kernel"],
                              **({} if bias is None else {"bias": bias})})
            bn = p["bn"]
            put(root, layer + "/bn", {"gamma": bn["gamma"], "beta": bn["beta"],
                                      "moving_mean": bn["mean"],
                                      "moving_variance": bn["var"]})

        put_block("conv1/7x7_s2", params["stem"], bias=stem_bias)
        for si, n_blocks in enumerate(trn.STAGES):
            for bi in range(n_blocks):
                p = params[f"stage{si + 1}_block{bi + 1}"]
                s, b = si + 2, bi + 1
                put_block(f"conv{s}_{b}_1x1_reduce", p["conv1"])
                put_block(f"conv{s}_{b}_3x3", p["conv2"])
                put_block(f"conv{s}_{b}_1x1_increase", p["conv3"])
                if bi == 0:
                    put_block(f"conv{s}_{b}_1x1_proj", p["proj"])


def test_resnet50_h5_import_bit_equal(tmp_path, resnet_bn, rng):
    """The rcmalli layout imports to the JAX importer's bits; the stem's
    conv bias folds into the BN running mean."""
    path = str(tmp_path / "rcmalli_vggface_tf_resnet50.h5")
    stem_bias = rng.randn(64).astype(np.float32)
    _write_rcmalli_h5(path, resnet_bn, stem_bias)
    got = trn.resnet50_params_from_h5(path)
    _assert_trees_equal(got, _np_tree(jrn.resnet50_params_from_h5(path)))
    np.testing.assert_array_equal(got["stem"]["bn"]["mean"],
                                  resnet_bn["stem"]["bn"]["mean"] - stem_bias)


def test_resnet50_h5_import_rejects_the_wrong_architecture(tmp_path):
    import h5py

    path = str(tmp_path / "bad.h5")
    with h5py.File(path, "w") as f:
        f.create_group("conv1").create_dataset("kernel:0",
                                               data=np.zeros((7, 7, 3, 64), np.float32))
    for module in (trn, jrn):
        with pytest.raises(KeyError):
            module.resnet50_params_from_h5(path)


# ---------- ResNet-50 and the zoo ----------

@pytest.mark.parametrize("form", ["bn", "folded"])
def test_resnet50_embed_matches_jax(form, rng, resnet_bn):
    params = resnet_bn if form == "bn" else random_resnet50_params(
        np.random.RandomState(15))
    x = (rng.rand(2, 64, 64, 3) * 255 - 120).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jrn.resnet50_embed(
        p, x, precision=jax.lax.Precision.HIGHEST))(params, x))
    with torch.no_grad():
        got = trn.resnet50_embed(to_torch(params, "cpu"), torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, atol=ATOL,
                               rtol=0)


def test_init_resnet50_params_layout():
    """BN-form params on the device asked for; ``to_numpy`` gives the
    reference's layouts and shapes; the default device is CUDA."""
    p = trn.init_resnet50_params(torch.Generator().manual_seed(0), n_classes=7,
                                 device="cpu")
    back = to_numpy(p)
    want = _np_tree(jrn.init_resnet50_params(jax.random.PRNGKey(0), n_classes=7))
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else np.shape(v)
                        for k, v in t.items()}
    assert shapes(back) == shapes(want)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trn.init_resnet50_params(torch.Generator().manual_seed(0))


NEW_ENTRIES = ["vgg2_mobilenet", "vgg2_mobilenet_int8", "vgg2_resnet",
               "vggface_resnet50"]


@pytest.mark.parametrize("name", NEW_ENTRIES)
def test_zoo_entries_match_jax(name):
    got, want = tzoo.MODEL_ZOO[name], jzoo.MODEL_ZOO[name]
    for key in ("name", "input_size", "normalization", "resize_method",
                "embedding_dim", "extractor_kwargs"):
        assert getattr(got, key) == getattr(want, key), key
    assert tzoo.weights_origin(name) == jzoo.weights_origin(name) == "random"


@pytest.mark.parametrize("name", ["vgg2_mobilenet", "vgg2_resnet"])
def test_zoo_random_fallback_warns(name):
    with pytest.warns(RuntimeWarning, match="RANDOM"):
        params = tzoo.MODEL_ZOO[name].build_params()
    key = "conv1" if name == "vgg2_mobilenet" else "stem"
    assert "bn" in params[key] and params[key]["kernel"].dtype == np.float32


def test_zoo_builds_from_a_dropped_in_pb(monkeypatch, tmp_path):
    """A published pb in place flips ``weights_origin`` to 'imported' and
    the entry builds from it."""
    mb = random_mobilenet_params(np.random.RandomState(16))
    rn = random_resnet50_params(np.random.RandomState(17))
    mb_pb, rn_pb = str(tmp_path / "vgg2_mobilenet.pb"), str(tmp_path / "vgg2_resnet.pb")
    texp.export_mobilenet_embedder_pb(mb, mb_pb)
    texp.export_resnet_embedder_pb(rn, rn_pb)
    monkeypatch.setattr(tzoo, "VGG2_MOBILENET_PB", mb_pb)
    monkeypatch.setattr(tzoo, "VGG2_RESNET_PB", rn_pb)
    for name in ("vgg2_mobilenet", "vgg2_mobilenet_int8", "vgg2_resnet"):
        assert tzoo.weights_origin(name) == "imported"
    _assert_trees_equal(tzoo.MODEL_ZOO["vgg2_mobilenet"].build_params(), mb)
    _assert_trees_equal(tzoo.MODEL_ZOO["vgg2_resnet"].build_params(), rn)


@pytest.mark.parametrize("name", ["vgg2_mobilenet", "vgg2_mobilenet_int8",
                                  "vgg2_resnet"])
def test_zoo_extractors_match_jax(name, rng):
    """``build_extractor(name, params=...)`` on seeded params against the
    JAX package's extractor of the same entry at its input size (the int8
    entry on K4's plain version here)."""
    from hse_facerec_tf_tpu.models.int8_infer import quantize_backbone_int8
    from hse_facerec_tf_tpu.pipelines.embedder import EmbeddingExtractor

    base = (random_resnet50_params if "resnet" in name else
            random_mobilenet_params)(np.random.RandomState(18))
    params = (quantize_backbone_int8(base) if name.endswith("_int8") else base)
    spec = jzoo.MODEL_ZOO[name]
    imgs = (rng.rand(2, 100, 90, 3) * 255).astype(np.uint8)
    want = EmbeddingExtractor(spec.model_fn(), params, spec.input_size,
                              normalization=spec.normalization,
                              resize_method=spec.resize_method,
                              batch_size=8).extract_batch(imgs)
    got = tzoo.build_extractor(name, batch_size=8, device="cpu",
                               params=params).extract_batch(imgs)
    assert got.shape == (2, spec.embedding_dim)
    if name.endswith("_int8"):
        # int8 activations: a one-quantum flip moves a feature by 6/127
        cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1)
                                       * np.linalg.norm(want, axis=1))
        assert cos.min() > 0.999
    else:
        np.testing.assert_allclose(got, want, atol=ATOL,
                                   rtol=0)
