"""Parity of the PyTorch port's networks with the JAX package, on the CPU.

The same seeded numpy parameters (``hse_facerec_torch.testing``, in the
reference's layouts) go through the JAX nets (jitted, Precision.HIGHEST) and,
via ``params.to_torch``, through the port's nets. Tolerance 1e-4 absolute:
fp32 sums in another order on O(1) activations and probabilities. R-Net's
24² and O-Net's 48² inputs run the SAME max-pools that pad with -inf and the
NHWC flatten before the FC layers. The importers are held against the JAX
importers on a synthetic frozen graph with the shipped graphs' tensor names.

The multi-head forward on preprocessed inputs: float32 within 1e-4 of each
output's largest magnitude; the bf16 tier (``compute_dtype``) against JAX's
bf16 forward, identity cosine at least 0.999 (both round every layer's
activations to bf16, each after its own f32 sums; 0.99999 measured). The
analytic MobileNet count (``bench._mobilenet_flops`` + ``_dense_flops``)
within 2% of XLA's ``cost_analysis()["flops"]``, which also counts the
bias, ReLU6 and softmax work (0.5-0.7% at these sizes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.core.graphdef_export import GraphBuilder
from hse_facerec_tf_tpu.models import mtcnn as jm
from hse_facerec_tf_tpu.models import multihead as jmh
from hse_facerec_torch import bench
from hse_facerec_torch import params as P
from hse_facerec_torch.models import mtcnn as tm
from hse_facerec_torch.models import multihead as tmh
from hse_facerec_torch.models.mobilenet import MOBILENET_V1_BLOCKS
from hse_facerec_torch.testing import random_mtcnn_params, random_multihead_params

HIGHEST = jax.lax.Precision.HIGHEST
MEANS_BGR = np.asarray((103.939, 116.779, 123.68), np.float32)


@pytest.fixture(scope="module")
def mtcnn_np():
    return random_mtcnn_params(np.random.RandomState(3))


@pytest.fixture(scope="module")
def multihead_np():
    return random_multihead_params(np.random.RandomState(4))


@pytest.fixture(scope="module")
def mh_params():
    return random_multihead_params(np.random.RandomState(100))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("hw", [(37, 29), (12, 12), (80, 61)])
def test_pnet(mtcnn_np, hw):
    x = np.random.RandomState(0).uniform(-1, 1, (1, *hw, 3)).astype(np.float32)
    want = jax.jit(lambda x: jm.pnet(mtcnn_np["pnet"], x, precision=HIGHEST))(x)
    got = tm.pnet(P.to_torch(mtcnn_np, "cpu")["pnet"], _t(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_rnet(mtcnn_np):
    x = np.random.RandomState(1).uniform(-1, 1, (7, 24, 24, 3)).astype(np.float32)
    want = jax.jit(lambda x: jm.rnet(mtcnn_np["rnet"], x, precision=HIGHEST))(x)
    got = tm.rnet(P.to_torch(mtcnn_np, "cpu")["rnet"], _t(x))
    for g, w in zip(got, want):
        _close(g, w)


def test_onet(mtcnn_np):
    x = np.random.RandomState(2).uniform(-1, 1, (5, 48, 48, 3)).astype(np.float32)
    want = jax.jit(lambda x: jm.onet(mtcnn_np["onet"], x, precision=HIGHEST))(x)
    got = tm.onet(P.to_torch(mtcnn_np, "cpu")["onet"], _t(x))
    for g, w in zip(got, want):
        _close(g, w)


def test_rnet_flatten_order_matters(mtcnn_np):
    """An NCHW flatten before the FC layer would give other outputs."""
    x = _t(np.random.RandomState(1).uniform(-1, 1, (3, 24, 24, 3)).astype(np.float32))
    p = P.to_torch(mtcnn_np, "cpu")["rnet"]
    nhwc = tm.rnet(p, x)[1]
    orig = tm._flatten_nhwc
    try:
        tm._flatten_nhwc = lambda t: t.flatten(1)
        nchw = tm.rnet(p, x)[1]
    finally:
        tm._flatten_nhwc = orig
    assert float((nhwc - nchw).abs().max()) > 1e-3


@pytest.mark.parametrize("size", [64, 96])
def test_multihead(multihead_np, size):
    rng = np.random.RandomState(5)
    x = (rng.rand(3, size, size, 3) * 255 - 120).astype(np.float32)
    want = jax.jit(lambda x: jmh.multihead_apply(multihead_np, x,
                                                 precision=HIGHEST))(x)
    got = tmh.multihead_apply(P.to_torch(multihead_np, "cpu"), _t(x))
    assert got.identity.shape == (3, 1024)
    for name in ("age_probs", "gender_prob", "identity", "feats"):
        _close(getattr(got, name), getattr(want, name))


def _preprocessed(n: int, size: int, seed: int) -> np.ndarray:
    """Seeded BGR mean-subtracted inputs, as the embed path makes them."""
    rgb = np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32) * 255
    return np.ascontiguousarray(rgb[..., ::-1]) - MEANS_BGR


def _cosines(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_multihead_apply_f32_matches_jax(mh_params):
    x = _preprocessed(3, 64, 1)
    want = jax.jit(lambda v: jmh.multihead_apply(mh_params, v, precision=HIGHEST))(x)
    got = tmh.multihead_apply(P.to_torch(mh_params, "cpu"), torch.from_numpy(x))
    for field in ("identity", "feats", "age_probs", "gender_prob"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field)
        assert g.dtype == torch.float32, field
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()), err_msg=field)


def test_multihead_apply_bf16_matches_jax_bf16(mh_params):
    """The bf16 tier: backbone in bf16, identity cast to float32 after the
    pool, heads in float32, as JAX ``compute_dtype=jnp.bfloat16``."""
    x = _preprocessed(4, 64, 2)
    want = jax.jit(lambda v: jmh.multihead_apply(mh_params, v,
                                                 compute_dtype=jnp.bfloat16))(x)
    got = tmh.multihead_apply(P.to_torch(mh_params, "cpu"), torch.from_numpy(x),
                              compute_dtype=torch.bfloat16)
    assert got.identity.dtype == torch.float32 and got.feats.dtype == torch.float32
    cos = _cosines(got.identity.numpy(), want.identity)
    print(f"bf16 identity cosine, port vs JAX: min {cos.min():.7f}")
    assert cos.min() >= 0.999
    # the tier is not the float32 forward: bf16 moved the identity
    f32 = tmh.multihead_apply(P.to_torch(mh_params, "cpu"), torch.from_numpy(x)).identity
    assert not torch.equal(f32, got.identity)


# 224² (the multi-head's input), 192² (vgg2_mobilenet's), 112², and an odd
# size on which SAME's ceiling division rounds up at every stride
@pytest.mark.parametrize("hw", [(224, 224), (192, 192), (112, 112), (97, 131)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_analytic_flops_match_xla_cost_analysis(mh_params, hw):
    x = jnp.zeros((1, *hw, 3), jnp.float32)
    compiled = jax.jit(lambda v: jmh.multihead_apply(mh_params, v, precision=HIGHEST)
                       ).lower(x).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    flops = bench._mobilenet_flops(mh_params["backbone"], hw) + bench._dense_flops(
        mh_params, ("feats", "age", "gender"))
    print(f"analytic {flops / 1e9:.4f} GFLOP an image, XLA {ca['flops'] / 1e9:.4f}")
    assert abs(flops / ca["flops"] - 1.0) < 0.02


def test_expected_age_top_k_ties():
    rng = np.random.RandomState(6)
    probs = rng.rand(6, 100).astype(np.float32)
    probs[0, [3, 40, 77]] = 2.0          # three-way tie: lowest bins win
    probs[1, [10, 11]] = 2.0
    probs /= probs.sum(1, keepdims=True)
    want = jax.jit(lambda p: jmh.expected_age_top_k(p, 2))(probs)
    got = tmh.expected_age_top_k(_t(probs), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got[0] == pytest.approx((3 + 40) / 2)


def test_is_male_threshold():
    p = torch.tensor([0.2, 0.6, 0.9])
    assert tmh.is_male(p).tolist() == [False, True, True]


def test_to_torch_layouts():
    rng = np.random.RandomState(7)
    params = {"conv1": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32),
                        "bias": rng.randn(8).astype(np.float32)},
              "dw1": {"kernel": rng.randn(3, 3, 8, 1).astype(np.float32)},
              "fc": {"kernel": rng.randn(6, 5).astype(np.float32)},
              "net": {"prelu1": {"alpha": np.ones(8, np.float32)}}}
    t = P.to_torch(params, "cpu")
    assert t["conv1"]["kernel"].shape == (8, 4, 3, 3)
    assert t["conv1"]["kernel"][5, 2, 0, 1] == params["conv1"]["kernel"][0, 1, 2, 5]
    assert t["dw1"]["kernel"].shape == (8, 1, 3, 3)
    assert t["dw1"]["kernel"][6, 0, 2, 1] == params["dw1"]["kernel"][2, 1, 6, 0]
    assert t["fc"]["kernel"].shape == (5, 6)
    assert t["net"]["prelu1"]["alpha"].dtype == torch.float32
    # a training layer's BN statistics come across as they are
    bn = P.to_torch({"pw1": {"kernel": np.ones((1, 1, 2, 2)),
                             "bn": {"gamma": np.arange(2.0)}}}, "cpu")["pw1"]["bn"]
    assert bn["gamma"].dtype == torch.float32 and bn["gamma"].tolist() == [0.0, 1.0]
    with pytest.raises(ValueError, match="unsupported"):
        P.to_torch({"pw1": {"kernel": np.ones((1, 1, 2, 2)), "scale": np.ones(2)}},
                   "cpu")


# ---------------- importers ----------------

_MTCNN_NAMES = {
    "pnet": {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
             "cls": "conv4-1", "reg": "conv4-2", "prelu1": "PReLU1",
             "prelu2": "PReLU2", "prelu3": "PReLU3"},
    "rnet": {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3", "fc": "conv4",
             "cls": "conv5-1", "reg": "conv5-2", "prelu1": "prelu1",
             "prelu2": "prelu2", "prelu3": "prelu3", "prelu4": "prelu4"},
    "onet": {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
             "conv4": "conv4", "fc": "conv5", "cls": "conv6-1",
             "reg": "conv6-2", "lmk": "conv6-3", "prelu1": "prelu1",
             "prelu2": "prelu2", "prelu3": "prelu3", "prelu4": "prelu4",
             "prelu5": "prelu5"},
}


def write_mtcnn_pb(params, path):
    """A frozen graph holding ``params`` under the shipped mtcnn.pb's
    constant names."""
    g = GraphBuilder()
    for net, layers in params.items():
        for key, p in layers.items():
            name = f"{net}/{_MTCNN_NAMES[net][key]}"
            if "alpha" in p:
                g.const(f"{name}/alpha", p["alpha"])
            else:
                g.const(f"{name}/weights", p["kernel"])
                g.const(f"{name}/biases", p["bias"])
    path.write_bytes(g.serialize())


def write_multihead_pb(params, path, rng):
    """A frozen graph with the quantized age/gender pb's constant names; the
    depthwise kernels come with a separate BN scale for the importer to fold."""
    g = GraphBuilder()
    bb = params["backbone"]
    g.const("conv1/kernel", bb["conv1"]["kernel"])
    g.const("conv1_bn/batchnorm_1/sub", bb["conv1"]["bias"])
    for i, _ in enumerate(MOBILENET_V1_BLOCKS, start=1):
        scale = rng.uniform(0.5, 1.5, bb[f"dw{i}"]["bias"].shape).astype(np.float32)
        g.const(f"conv_dw_{i}/depthwise_kernel", bb[f"dw{i}"]["kernel"])
        g.const(f"conv_dw_{i}_bn/batchnorm_1/mul", scale)
        g.const(f"conv_dw_{i}_bn/batchnorm_1/sub", bb[f"dw{i}"]["bias"])
        g.const(f"conv_pw_{i}/kernel", bb[f"pw{i}"]["kernel"])
        g.const(f"conv_pw_{i}_bn/batchnorm_1/sub", bb[f"pw{i}"]["bias"])
    for key, name in (("feats", "feats"), ("age", "age_pred"),
                      ("gender", "gender_pred")):
        g.const(f"{name}/kernel", params[key]["kernel"])
        g.const(f"{name}/bias", params[key]["bias"])
    path.write_bytes(g.serialize())


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_import_mtcnn_params_matches_jax(mtcnn_np, tmp_path):
    pb = tmp_path / "mtcnn.pb"
    write_mtcnn_pb(mtcnn_np, pb)
    got = tm.import_mtcnn_params(str(pb))
    _assert_trees_equal(got, jm.import_mtcnn_params(str(pb)))
    _assert_trees_equal(got, mtcnn_np)


def test_import_multihead_params_matches_jax(multihead_np, tmp_path):
    pb = tmp_path / "agegender.pb"
    write_multihead_pb(multihead_np, pb, np.random.RandomState(8))
    got = tmh.import_multihead_params(str(pb))
    _assert_trees_equal(got, jmh.import_multihead_params(str(pb)))
    assert not np.array_equal(got["backbone"]["dw1"]["kernel"],
                              multihead_np["backbone"]["dw1"]["kernel"])
