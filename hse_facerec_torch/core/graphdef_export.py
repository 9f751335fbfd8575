"""Frozen TensorFlow GraphDef *export* (no TF dependency).

The port's own copy of ``hse_facerec_tf_tpu/core/graphdef_export.py``
(numpy only): it writes the same bytes for the same numpy params.

The reference's L7 tooling converts trained Keras models to frozen ``.pb``
graphs (``facerec_keras_train.py:70-142`` ``freeze_session``/``convert_to_tf``;
``age_gender_train.py:82-108``) that its inference layer then loads by tensor
name. This module writes such a graph for a model of this package: a frozen
GraphDef, encoded directly at the protobuf wire level (``core/protowire.py``),
with the *same tensor names the reference consumes* (``input_1``,
``age_pred/Softmax``, ``gender_pred/Sigmoid``, ``global_pooling/Mean``,
``reshape_1/Reshape``), so reference-era TF tooling can load the exports
unchanged. Params are numpy pytrees in the reference's layouts (HWIO
kernels, ``params.to_numpy`` of a torch tree).

Exports use folded-BN inference form (conv kernel [+ scale] + bias), ReLU6 as
the native TF ``Relu6`` op.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

from . import protowire as pw
from .graphdef import DT_FLOAT, DT_INT32

_DTYPES = {np.dtype(np.float32): DT_FLOAT, np.dtype(np.int32): DT_INT32}


class GraphBuilder:
    """Accumulates NodeDefs and serializes a GraphDef."""

    def __init__(self):
        self._nodes: List[bytes] = []

    # --- low-level encoders ---

    @staticmethod
    def _attr(key: str, value_payload: bytes) -> bytes:
        entry = pw.encode_string_field(1, key) + pw.encode_bytes_field(2, value_payload)
        return pw.encode_bytes_field(5, entry)

    @staticmethod
    def _attr_type(key: str, dtype: int) -> bytes:
        return GraphBuilder._attr(key, pw.encode_varint_field(6, dtype))

    @staticmethod
    def _attr_string(key: str, s: str) -> bytes:
        return GraphBuilder._attr(key, pw.encode_bytes_field(2, s.encode()))

    @staticmethod
    def _attr_bool(key: str, b: bool) -> bytes:
        return GraphBuilder._attr(key, pw.encode_varint_field(5, int(b)))

    @staticmethod
    def _attr_int_list(key: str, ints) -> bytes:
        packed = b"".join(pw.encode_varint(i) for i in ints)
        lst = pw.encode_bytes_field(3, packed)
        return GraphBuilder._attr(key, pw.encode_bytes_field(1, lst))

    @staticmethod
    def _tensor_shape(dims) -> bytes:
        out = b""
        for d in dims:
            out += pw.encode_bytes_field(2, pw.encode_varint_field(1, int(d)))
        return out

    @staticmethod
    def _attr_shape(key: str, dims) -> bytes:
        return GraphBuilder._attr(key, pw.encode_bytes_field(
            7, GraphBuilder._tensor_shape(dims)))

    def _node(self, name: str, op: str, inputs: List[str], attrs: bytes) -> str:
        body = pw.encode_string_field(1, name) + pw.encode_string_field(2, op)
        for inp in inputs:
            body += pw.encode_string_field(3, inp)
        body += attrs
        self._nodes.append(pw.encode_bytes_field(1, body))
        return name

    # --- node constructors ---

    def const(self, name: str, value: np.ndarray) -> str:
        value = np.ascontiguousarray(value)
        dtype = _DTYPES[value.dtype]
        tensor = pw.encode_varint_field(1, dtype)
        tensor += pw.encode_bytes_field(2, self._tensor_shape(value.shape))
        tensor += pw.encode_bytes_field(4, value.tobytes())
        attrs = self._attr_type("dtype", dtype) + self._attr(
            "value", pw.encode_bytes_field(8, tensor))
        return self._node(name, "Const", [], attrs)

    def placeholder(self, name: str, shape) -> str:
        attrs = self._attr_type("dtype", DT_FLOAT) + self._attr_shape("shape", shape)
        return self._node(name, "Placeholder", [], attrs)

    def conv2d(self, name: str, x: str, w: str, stride: int = 1,
               padding: str = "SAME") -> str:
        attrs = (self._attr_type("T", DT_FLOAT)
                 + self._attr_string("padding", padding)
                 + self._attr_int_list("strides", [1, stride, stride, 1])
                 + self._attr_string("data_format", "NHWC"))
        return self._node(name, "Conv2D", [x, w], attrs)

    def depthwise_conv2d(self, name: str, x: str, w: str, stride: int = 1,
                         padding: str = "SAME") -> str:
        attrs = (self._attr_type("T", DT_FLOAT)
                 + self._attr_string("padding", padding)
                 + self._attr_int_list("strides", [1, stride, stride, 1])
                 + self._attr_string("data_format", "NHWC"))
        return self._node(name, "DepthwiseConv2dNative", [x, w], attrs)

    def simple(self, op: str, name: str, inputs: List[str]) -> str:
        return self._node(name, op, inputs, self._attr_type("T", DT_FLOAT))

    def matmul(self, name: str, a: str, b: str) -> str:
        attrs = (self._attr_type("T", DT_FLOAT)
                 + self._attr_bool("transpose_a", False)
                 + self._attr_bool("transpose_b", False))
        return self._node(name, "MatMul", [a, b], attrs)

    def placeholder_bool(self, name: str) -> str:
        """Scalar boolean placeholder — the Keras learning-phase tensor shape
        (``conv1_bn/keras_learning_phase:0``, reference facerec_test.py:64)."""
        from .graphdef import DT_BOOL

        attrs = self._attr_type("dtype", DT_BOOL) + self._attr_shape("shape", [])
        return self._node(name, "Placeholder", [], attrs)

    def bool_const(self, name: str, value: bool) -> str:
        from .graphdef import DT_BOOL

        tensor = pw.encode_varint_field(1, DT_BOOL)
        tensor += pw.encode_bytes_field(2, self._tensor_shape([]))
        tensor += pw.encode_varint_field(11, int(value))  # bool_val
        attrs = self._attr_type("dtype", DT_BOOL) + self._attr(
            "value", pw.encode_bytes_field(8, tensor))
        return self._node(name, "Const", [], attrs)

    def switch(self, name: str, data: str, pred: str) -> str:
        """TF cond Switch: data flows to output ``:int(pred)``
        (``:0`` = false/inference branch, ``:1`` = true/training branch)."""
        return self._node(name, "Switch", [data, pred],
                          self._attr_type("T", DT_FLOAT))

    def merge(self, name: str, inputs: List[str]) -> str:
        """TF cond Merge: forwards whichever branch produced a value."""
        attrs = (self._attr_type("T", DT_FLOAT)
                 + self._attr("N", pw.encode_varint_field(3, len(inputs))))
        return self._node(name, "Merge", inputs, attrs)

    def fused_batch_norm(self, name: str, x: str, scale: str, offset: str,
                         mean: str, variance: str, epsilon: float = 1e-3,
                         is_training: bool = False) -> str:
        """Unfolded Keras BatchNorm as the reference's ``freeze_session``
        leaves it (``facerec_keras_train.py:70-83`` does no BN folding)."""
        eps_payload = pw.encode_tag(4, pw.FIXED32) + struct.pack("<f", epsilon)
        attrs = (self._attr_type("T", DT_FLOAT)
                 + self._attr("epsilon", eps_payload)
                 + self._attr_bool("is_training", is_training)
                 + self._attr_string("data_format", "NHWC"))
        return self._node(name, "FusedBatchNorm",
                          [x, scale, offset, mean, variance], attrs)

    def pad(self, name: str, x: str, pads) -> str:
        """Explicit zero Pad — the frozen form of Keras ``ZeroPadding2D``
        (keras_vggface ResNet stem)."""
        pads_const = self.const(f"{name}/paddings",
                                np.asarray(pads, dtype=np.int32))
        attrs = self._attr_type("T", DT_FLOAT) + self._attr_type(
            "Tpaddings", DT_INT32)
        return self._node(name, "Pad", [x, pads_const], attrs)

    def max_pool(self, name: str, x: str, k: int, stride: int,
                 padding: str = "VALID") -> str:
        attrs = (self._attr_type("T", DT_FLOAT)
                 + self._attr_string("padding", padding)
                 + self._attr_int_list("ksize", [1, k, k, 1])
                 + self._attr_int_list("strides", [1, stride, stride, 1])
                 + self._attr_string("data_format", "NHWC"))
        return self._node(name, "MaxPool", [x], attrs)

    def mean(self, name: str, x: str, axes, keep_dims: bool = False) -> str:
        axes_const = self.const(f"{name}/reduction_indices",
                                np.asarray(axes, dtype=np.int32))
        attrs = (self._attr_type("T", DT_FLOAT)
                 + self._attr_type("Tidx", DT_INT32)
                 + self._attr_bool("keep_dims", keep_dims))
        return self._node(name, "Mean", [x, axes_const], attrs)

    def serialize(self) -> bytes:
        # versions field (4): producer 27 — enough for TF1-era loaders
        versions = pw.encode_varint_field(1, 27)
        return b"".join(self._nodes) + pw.encode_bytes_field(4, versions)


def _folded(params: Dict, key: str):
    """Folded inference form of a conv block (kernel, scale?, bias)."""
    p = params[key]
    if "bn" in p:
        bn = p["bn"]
        inv = np.asarray(bn["gamma"]) / np.sqrt(np.asarray(bn["var"]) + 1e-3)
        kernel = np.asarray(p["kernel"], np.float32)
        if kernel.ndim == 4 and key.startswith("dw"):
            kernel = kernel * inv[None, None, :, None]
        else:
            kernel = kernel * inv
        bias = np.asarray(bn["beta"]) - np.asarray(bn["mean"]) * inv
        return kernel.astype(np.float32), bias.astype(np.float32)
    kernel = np.asarray(p["kernel"], np.float32)
    if "scale" in p:
        if key.startswith("dw"):
            kernel = kernel * np.asarray(p["scale"])[None, None, :, None]
        else:
            kernel = kernel * np.asarray(p["scale"])
    return kernel, np.asarray(p.get("bias", np.zeros(kernel.shape[-1])), np.float32)


def export_multihead_pb(params: Dict, path: str, input_size: int = 224) -> None:
    """Write the multi-head age/gender/identity model as a frozen pb with the
    reference's tensor names (``facial_analysis.py:84-89``)."""
    from ..models.mobilenet import MOBILENET_V1_BLOCKS

    g = GraphBuilder()
    x = g.placeholder("input_1", [-1, input_size, input_size, 3])
    backbone = params["backbone"]

    def conv_block(x, key, name, stride, depthwise=False):
        kernel, bias = _folded(backbone, key)
        w = g.const(f"{name}/kernel", kernel)
        if depthwise:
            c = g.depthwise_conv2d(f"{name}/depthwise", x, w, stride=stride)
        else:
            c = g.conv2d(f"{name}/Conv2D", x, w, stride=stride)
        b = g.const(f"{name}/bias", bias)
        added = g.simple("BiasAdd", f"{name}/BiasAdd", [c, b])
        return g.simple("Relu6", f"{name}/Relu6", [added])

    x = conv_block(x, "conv1", "conv1", 2)
    for i, (stride, _) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        x = conv_block(x, f"dw{i}", f"conv_dw_{i}", stride, depthwise=True)
        x = conv_block(x, f"pw{i}", f"conv_pw_{i}", 1)

    pooled = g.mean("global_pooling/Mean", x, [1, 2])

    def head(name, x, pkey):
        w = g.const(f"{name}/kernel", np.asarray(params[pkey]["kernel"], np.float32))
        b = g.const(f"{name}/bias", np.asarray(params[pkey]["bias"], np.float32))
        mm = g.matmul(f"{name}/MatMul", x, w)
        return g.simple("BiasAdd", f"{name}/BiasAdd", [mm, b])

    feats = g.simple("Relu", "feats/Relu", [head("feats", pooled, "feats")])
    g.simple("Softmax", "age_pred/Softmax", [head("age_pred", feats, "age")])
    g.simple("Sigmoid", "gender_pred/Sigmoid", [head("gender_pred", feats, "gender")])

    with open(path, "wb") as f:
        f.write(g.serialize())


def export_head_pb(params: Dict, path: str, head_key: str, act: str,
                   input_size: int, input_name: str = "input_1",
                   output_name: str = "") -> None:
    """Backbone + feats + ONE head (``params[head_key]``, then ``act``) as a
    frozen graph. The default tensor names are the two-model ones the
    reference's ``load_gender``/``load_age`` consume (``facial_analysis.py:
    144-146,173-175``: ``input_1`` → ``predictions/<act>``); other taps
    (``input`` → ``prob``, ``Placeholder`` → ``logits``) give the converted
    checkpoints' graphs that ``eval/utkface.py``'s pb backends read."""
    from ..models.mobilenet import MOBILENET_V1_BLOCKS

    g = GraphBuilder()
    x = g.placeholder(input_name, [-1, input_size, input_size, 3])
    backbone = params["backbone"]

    def conv_block(x, key, name, stride, depthwise=False):
        kernel, bias = _folded(backbone, key)
        w = g.const(f"{name}/kernel", kernel)
        if depthwise:
            c = g.depthwise_conv2d(f"{name}/depthwise", x, w, stride=stride)
        else:
            c = g.conv2d(f"{name}/Conv2D", x, w, stride=stride)
        b = g.const(f"{name}/bias", bias)
        added = g.simple("BiasAdd", f"{name}/BiasAdd", [c, b])
        return g.simple("Relu6", f"{name}/Relu6", [added])

    x = conv_block(x, "conv1", "conv1", 2)
    for i, (stride, _) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        x = conv_block(x, f"dw{i}", f"conv_dw_{i}", stride, depthwise=True)
        x = conv_block(x, f"pw{i}", f"conv_pw_{i}", 1)
    pooled = g.mean("global_pooling/Mean", x, [1, 2])

    def dense_node(name, x, pkey):
        w = g.const(f"{name}/kernel", np.asarray(params[pkey]["kernel"], np.float32))
        b = g.const(f"{name}/bias", np.asarray(params[pkey]["bias"], np.float32))
        mm = g.matmul(f"{name}/MatMul", x, w)
        return g.simple("BiasAdd", f"{name}/BiasAdd", [mm, b])

    feats = g.simple("Relu", "feats/Relu", [dense_node("feats", pooled, "feats")])
    g.simple(act, output_name or f"predictions/{act}",
             [dense_node("predictions", feats, head_key)])
    with open(path, "wb") as f:
        f.write(g.serialize())


def export_age_pb(params: Dict, path: str, input_size: int = 224) -> None:
    """Standalone frozen age graph (``input_1`` → ``predictions/Softmax``)
    from multi-head params — the two-model configuration's age half."""
    export_head_pb(params, path, "age", "Softmax", input_size)


def export_gender_pb(params: Dict, path: str, input_size: int = 224) -> None:
    """Standalone frozen gender graph (``input_1`` → ``predictions/Sigmoid``)
    from multi-head params — the two-model configuration's gender half."""
    export_head_pb(params, path, "gender", "Sigmoid", input_size)


def export_resnet_embedder_pb(params: Dict, path: str,
                              input_size: int = 224) -> None:
    """Write a ResNet-50 embedder (resnet.py pytree, BN or folded form) as a
    frozen pb with the reference's vgg2_resnet tensor names
    (``facerec_test.py:213``: ``input`` → ``pool5_7x7_s1``). Emitted in the
    frozen-Keras form the reference's ``freeze_session`` produces
    (``facerec_keras_train.py:70-83``): ZeroPadding as explicit ``Pad``,
    unfolded ``FusedBatchNorm``, VALID 3×3/2 max-pool."""
    from ..models.resnet import STAGES

    g = GraphBuilder()
    x = g.placeholder("input", [-1, input_size, input_size, 3])

    def conv_affine(x, p, name, *, stride=1, padding="SAME"):
        w = g.const(f"{name}/kernel", np.asarray(p["kernel"], np.float32))
        x = g.conv2d(f"{name}/Conv2D", x, w, stride=stride, padding=padding)
        if "bn" in p:
            bn = p["bn"]
            consts = [g.const(f"{name}/bn/{k}", np.asarray(bn[k], np.float32))
                      for k in ("gamma", "beta", "mean", "var")]
            return g.fused_batch_norm(f"{name}/bn/FusedBatchNorm", x, *consts,
                                      epsilon=1e-3)
        if "scale" in p:
            s = g.const(f"{name}/scale", np.asarray(p["scale"], np.float32))
            x = g.simple("Mul", f"{name}/Mul", [x, s])
        b = g.const(f"{name}/bias",
                    np.asarray(p.get("bias",
                                     np.zeros(np.asarray(p["kernel"]).shape[-1])),
                               np.float32))
        return g.simple("BiasAdd", f"{name}/BiasAdd", [x, b])

    x = g.pad("conv1/pad", x, [[0, 0], [3, 3], [3, 3], [0, 0]])
    x = conv_affine(x, params["stem"], "conv1/7x7_s2", stride=2,
                    padding="VALID")
    x = g.simple("Relu", "conv1/relu", [x])
    x = g.max_pool("pool1", x, 3, 2, "VALID")

    for si, n_blocks in enumerate(STAGES):
        for bi in range(n_blocks):
            p = params[f"stage{si + 1}_block{bi + 1}"]
            base = f"conv{si + 2}_{bi + 1}"
            stride = 2 if (bi == 0 and si > 0) else 1
            shortcut = x
            if "proj" in p:
                shortcut = conv_affine(x, p["proj"], f"{base}_1x1_proj",
                                       stride=stride)
            y = conv_affine(x, p["conv1"], f"{base}_1x1_reduce", stride=stride)
            y = g.simple("Relu", f"{base}_1x1_reduce/relu", [y])
            y = conv_affine(y, p["conv2"], f"{base}_3x3")
            y = g.simple("Relu", f"{base}_3x3/relu", [y])
            y = conv_affine(y, p["conv3"], f"{base}_1x1_increase")
            x = g.simple("Add", f"{base}/add", [y, shortcut])
            x = g.simple("Relu", f"{base}/relu", [x])

    g.mean("pool5_7x7_s1", x, [1, 2])
    with open(path, "wb") as f:
        f.write(g.serialize())


def export_mobilenet_embedder_pb(params: Dict, path: str,
                                 input_size: int = 192) -> None:
    """Write a MobileNet embedder as a frozen pb with the reference's
    vgg2_mobilenet tensor names (``facerec_test.py:212``: ``input_1`` →
    ``reshape_1/Reshape``)."""
    from ..models.mobilenet import MOBILENET_V1_BLOCKS

    g = GraphBuilder()
    x = g.placeholder("input_1", [-1, input_size, input_size, 3])

    def conv_block(x, key, name, stride, depthwise=False):
        kernel, bias = _folded(params, key)
        w = g.const(f"{name}/kernel", kernel)
        if depthwise:
            c = g.depthwise_conv2d(f"{name}/depthwise", x, w, stride=stride)
        else:
            c = g.conv2d(f"{name}/Conv2D", x, w, stride=stride)
        b = g.const(f"{name}/bias", bias)
        added = g.simple("BiasAdd", f"{name}/BiasAdd", [c, b])
        return g.simple("Relu6", f"{name}/Relu6", [added])

    x = conv_block(x, "conv1", "conv1", 2)
    for i, (stride, _) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        x = conv_block(x, f"dw{i}", f"conv_dw_{i}", stride, depthwise=True)
        x = conv_block(x, f"pw{i}", f"conv_pw_{i}", 1)
    pooled = g.mean("global_pooling/Mean", x, [1, 2])
    shape_const = g.const("reshape_1/shape", np.asarray([-1, 1024], np.int32))
    body = (pw.encode_string_field(1, "reshape_1/Reshape")
            + pw.encode_string_field(2, "Reshape")
            + pw.encode_string_field(3, pooled)
            + pw.encode_string_field(3, shape_const)
            + GraphBuilder._attr_type("T", DT_FLOAT)
            + GraphBuilder._attr_type("Tshape", DT_INT32))
    g._nodes.append(pw.encode_bytes_field(1, body))

    with open(path, "wb") as f:
        f.write(g.serialize())
