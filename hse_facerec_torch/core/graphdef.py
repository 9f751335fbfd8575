"""Frozen TensorFlow GraphDef reader → plain Python graph + NumPy constants.

The port's own copy of ``hse_facerec_tf_tpu/core/graphdef.py`` (numpy
only; the port imports nothing of the JAX package).

Replaces the reference's graph loading layer (``facerec_test.py:41-48``
``load_graph`` and ``facial_analysis.py:319-332`` ``load_graph_def``) without a
TensorFlow dependency: we decode the GraphDef protobuf wire format ourselves
(see ``protowire.py``) and materialize every ``Const`` node as a NumPy array.

Also folds weight-quantization back to float32: the shipped
``age_gender_tf2_new-01-0.14-0.92_quantized.pb`` stores weights as
``(Const quint8, Const min, Const max) → Dequantize`` triples (produced by TF
graph_transforms, reference ``age_gender_identity/README.md:7``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from . import protowire as pw

# TF DataType enum values we support.
DT_FLOAT = 1
DT_DOUBLE = 2
DT_INT32 = 3
DT_UINT8 = 4
DT_INT16 = 5
DT_INT8 = 6
DT_STRING = 7
DT_INT64 = 9
DT_BOOL = 10
DT_QINT8 = 11
DT_QUINT8 = 12
DT_QINT32 = 13
DT_BFLOAT16 = 14
DT_HALF = 19

_DTYPE_TO_NUMPY = {
    DT_FLOAT: np.float32,
    DT_DOUBLE: np.float64,
    DT_INT32: np.int32,
    DT_UINT8: np.uint8,
    DT_INT16: np.int16,
    DT_INT8: np.int8,
    DT_INT64: np.int64,
    DT_BOOL: np.bool_,
    DT_QINT8: np.int8,
    DT_QUINT8: np.uint8,
    DT_QINT32: np.int32,
    DT_HALF: np.float16,
}


@dataclasses.dataclass
class AttrValue:
    s: Optional[bytes] = None
    i: Optional[int] = None
    f: Optional[float] = None
    b: Optional[bool] = None
    type: Optional[int] = None
    shape: Optional[List[int]] = None
    tensor: Optional[np.ndarray] = None
    list_i: Optional[List[int]] = None
    list_f: Optional[List[float]] = None
    list_s: Optional[List[bytes]] = None


@dataclasses.dataclass
class NodeDef:
    name: str
    op: str
    inputs: List[str]
    attrs: Dict[str, AttrValue]


@dataclasses.dataclass
class TFGraph:
    nodes: List[NodeDef]
    by_name: Dict[str, NodeDef]

    def node(self, name: str) -> NodeDef:
        return self.by_name[name.split(":")[0]]

    def ops_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for n in self.nodes:
            hist[n.op] = hist.get(n.op, 0) + 1
        return hist


def _parse_tensor_shape(buf: bytes) -> List[int]:
    dims: List[int] = []
    for field, wire, val in pw.iter_fields(buf):
        if field == 2 and wire == pw.LENGTH_DELIMITED:  # Dim
            size = 0
            for f2, w2, v2 in pw.iter_fields(val):
                if f2 == 1 and w2 == pw.VARINT:
                    size = pw.as_signed64(v2)
            dims.append(size)
    return dims


def _parse_tensor_proto(buf: bytes) -> np.ndarray:
    dtype = DT_FLOAT
    shape: List[int] = []
    tensor_content: Optional[bytes] = None
    float_vals: List[float] = []
    int_vals: List[int] = []
    string_vals: List[bytes] = []
    for field, wire, val in pw.iter_fields(buf):
        if field == 1 and wire == pw.VARINT:
            dtype = val
        elif field == 2 and wire == pw.LENGTH_DELIMITED:
            shape = _parse_tensor_shape(val)
        elif field == 4 and wire == pw.LENGTH_DELIMITED:
            tensor_content = val
        elif field == 5:  # float_val
            if wire == pw.LENGTH_DELIMITED:
                float_vals.extend(pw.decode_packed_floats(val))
            elif wire == pw.FIXED32:
                float_vals.append(pw.as_float32(val))
        elif field == 6:  # double_val (packed doubles)
            if wire == pw.LENGTH_DELIMITED:
                import struct as _struct

                float_vals.extend(_struct.unpack(f"<{len(val) // 8}d", val))
            elif wire == pw.FIXED64:
                import struct as _struct

                float_vals.append(_struct.unpack("<d", _struct.pack("<Q", val))[0])
        elif field == 13:  # half_val: raw float16 BIT PATTERNS as varints
            if wire == pw.LENGTH_DELIMITED:
                bits = pw.decode_packed_varints(val)
            else:
                bits = [val]
            float_vals.extend(
                float(np.frombuffer(np.uint16(b).tobytes(), np.float16)[0])
                for b in bits)
        elif field in (7, 10, 11):  # int/int64/bool vals (varint family)
            if wire == pw.LENGTH_DELIMITED:
                int_vals.extend(pw.as_signed64(v) for v in pw.decode_packed_varints(val))
            elif wire == pw.VARINT:
                int_vals.append(pw.as_signed64(val))
        elif field == 8 and wire == pw.LENGTH_DELIMITED:  # string_val
            string_vals.append(val)

    np_dtype = _DTYPE_TO_NUMPY.get(dtype)
    if dtype == DT_STRING:
        arr = np.array(string_vals, dtype=object)
        return arr.reshape(shape) if shape else arr

    if np_dtype is None:
        raise ValueError(f"unsupported TensorProto dtype {dtype}")

    n_elems = int(np.prod(shape)) if shape else 1
    if tensor_content is not None:
        arr = np.frombuffer(tensor_content, dtype=np_dtype).copy()
    elif float_vals:
        arr = np.asarray(float_vals, dtype=np_dtype)
        if arr.size == 1 and n_elems > 1:  # splat-encoded constant
            arr = np.full(n_elems, arr[0], dtype=np_dtype)
    elif int_vals:
        arr = np.asarray(int_vals).astype(np_dtype)
        if arr.size == 1 and n_elems > 1:
            arr = np.full(n_elems, arr[0], dtype=np_dtype)
    else:
        arr = np.zeros(n_elems, dtype=np_dtype)
    return arr.reshape(shape) if shape else arr.reshape(())


def _parse_attr_value(buf: bytes) -> AttrValue:
    a = AttrValue()
    for field, wire, val in pw.iter_fields(buf):
        if field == 2 and wire == pw.LENGTH_DELIMITED:
            a.s = val
        elif field == 3 and wire == pw.VARINT:
            a.i = pw.as_signed64(val)
        elif field == 4 and wire == pw.FIXED32:
            a.f = pw.as_float32(val)
        elif field == 5 and wire == pw.VARINT:
            a.b = bool(val)
        elif field == 6 and wire == pw.VARINT:
            a.type = val
        elif field == 7 and wire == pw.LENGTH_DELIMITED:
            a.shape = _parse_tensor_shape(val)
        elif field == 8 and wire == pw.LENGTH_DELIMITED:
            a.tensor = _parse_tensor_proto(val)
        elif field == 1 and wire == pw.LENGTH_DELIMITED:  # ListValue
            li: List[int] = []
            lf: List[float] = []
            ls: List[bytes] = []
            for f2, w2, v2 in pw.iter_fields(val):
                if f2 == 2 and w2 == pw.LENGTH_DELIMITED:
                    ls.append(v2)
                elif f2 == 3:
                    if w2 == pw.LENGTH_DELIMITED:
                        li.extend(pw.as_signed64(v) for v in pw.decode_packed_varints(v2))
                    else:
                        li.append(pw.as_signed64(v2))
                elif f2 == 4:
                    if w2 == pw.LENGTH_DELIMITED:
                        lf.extend(pw.decode_packed_floats(v2))
                    elif w2 == pw.FIXED32:
                        lf.append(pw.as_float32(v2))
            if li:
                a.list_i = li
            if lf:
                a.list_f = lf
            if ls:
                a.list_s = ls
    return a


def _parse_node_def(buf: bytes) -> NodeDef:
    name = ""
    op = ""
    inputs: List[str] = []
    attrs: Dict[str, AttrValue] = {}
    for field, wire, val in pw.iter_fields(buf):
        if field == 1 and wire == pw.LENGTH_DELIMITED:
            name = val.decode("utf-8")
        elif field == 2 and wire == pw.LENGTH_DELIMITED:
            op = val.decode("utf-8")
        elif field == 3 and wire == pw.LENGTH_DELIMITED:
            inputs.append(val.decode("utf-8"))
        elif field == 5 and wire == pw.LENGTH_DELIMITED:  # attr map entry
            key = None
            value = None
            for f2, w2, v2 in pw.iter_fields(val):
                if f2 == 1 and w2 == pw.LENGTH_DELIMITED:
                    key = v2.decode("utf-8")
                elif f2 == 2 and w2 == pw.LENGTH_DELIMITED:
                    value = _parse_attr_value(v2)
            if key is not None and value is not None:
                attrs[key] = value
    return NodeDef(name=name, op=op, inputs=inputs, attrs=attrs)


def parse_graphdef(data: bytes) -> TFGraph:
    """Parse a serialized GraphDef into a TFGraph."""
    nodes: List[NodeDef] = []
    for field, wire, val in pw.iter_fields(data):
        if field == 1 and wire == pw.LENGTH_DELIMITED:
            nodes.append(_parse_node_def(val))
    return TFGraph(nodes=nodes, by_name={n.name: n for n in nodes})


def load_graphdef(path: str) -> TFGraph:
    with open(path, "rb") as f:
        return parse_graphdef(f.read())


def dequantize_min_combined(q: np.ndarray, mn: float, mx: float) -> np.ndarray:
    """TF Dequantize, mode=MIN_COMBINED, quint8 input."""
    scale = (mx - mn) / 255.0
    return (q.astype(np.float32) * scale + mn).astype(np.float32)


def dequantize_min_first(q: np.ndarray, mn: float, mx: float) -> np.ndarray:
    """TF Dequantize, mode=MIN_FIRST, quint8 input.

    Matches TF's QuantizedToFloat: the range minimum is first rounded to an
    integer multiple of the scale so that 0.0 is exactly representable.
    """
    scale = (mx - mn) / 255.0
    lowest_quantized = 0.0  # quint8
    offset = np.round(mn / scale) - lowest_quantized
    return ((q.astype(np.float32) + offset) * scale).astype(np.float32)


def extract_constants(graph: TFGraph) -> Dict[str, np.ndarray]:
    """All Const nodes as NumPy arrays, with Dequantize nodes folded to f32.

    For a ``Dequantize(qconst, min, max)`` node named ``N``, the returned dict
    maps ``N`` to the reconstructed float32 array, so downstream weight lookup
    is uniform between quantized and unquantized graphs.
    """
    consts: Dict[str, np.ndarray] = {}
    for n in graph.nodes:
        if n.op == "Const" and "value" in n.attrs and n.attrs["value"].tensor is not None:
            consts[n.name] = n.attrs["value"].tensor
    for n in graph.nodes:
        if n.op == "Dequantize":
            q = consts.get(n.inputs[0].split(":")[0])
            mn = consts.get(n.inputs[1].split(":")[0])
            mx = consts.get(n.inputs[2].split(":")[0])
            if q is None or mn is None or mx is None:
                continue
            mode = (n.attrs.get("mode").s or b"MIN_COMBINED").decode() if "mode" in n.attrs else "MIN_COMBINED"
            if mode == "MIN_FIRST":
                consts[n.name] = dequantize_min_first(q, float(mn), float(mx))
            else:
                consts[n.name] = dequantize_min_combined(q, float(mn), float(mx))
    return consts
