"""Minimal protobuf wire-format decoder.

The port's own copy of ``hse_facerec_tf_tpu/core/protowire.py``.

The reference framework ships frozen TensorFlow ``GraphDef`` protobufs
(``age_gender_identity/mtcnn.pb``, ``age_gender_identity/age_gender_tf2_*.pb``,
``models/vgg2_*.pb`` — see reference ``facerec_test.py:41-48`` and
``facial_analysis.py:319-332`` for how they are consumed). This framework has no
TensorFlow dependency, so we decode the protobuf wire format directly.

This module is schema-free: it yields ``(field_number, wire_type, value)``
triples. ``graphdef.py`` layers the GraphDef/NodeDef/TensorProto schema on top.
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

# Wire types
VARINT = 0
FIXED64 = 1
LENGTH_DELIMITED = 2
START_GROUP = 3
END_GROUP = 4
FIXED32 = 5


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode a base-128 varint starting at ``pos``. Returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Iterate over top-level fields of a serialized protobuf message.

    Yields ``(field_number, wire_type, value)`` where value is:
      - int for VARINT
      - bytes for LENGTH_DELIMITED
      - int (raw little-endian) for FIXED32 / FIXED64
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field = tag >> 3
        wire = tag & 0x7
        if wire == VARINT:
            val, pos = read_varint(buf, pos)
            yield field, wire, val
        elif wire == LENGTH_DELIMITED:
            length, pos = read_varint(buf, pos)
            yield field, wire, buf[pos : pos + length]
            pos += length
        elif wire == FIXED32:
            yield field, wire, struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wire == FIXED64:
            yield field, wire, struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire} at offset {pos}")


def as_float32(fixed32_val: int) -> float:
    """Reinterpret a FIXED32 payload as an IEEE float32."""
    return struct.unpack("<f", struct.pack("<I", fixed32_val))[0]


def as_signed64(varint_val: int) -> int:
    """Interpret a varint payload as a two's-complement int64."""
    if varint_val >= 1 << 63:
        return varint_val - (1 << 64)
    return varint_val


def decode_packed_varints(buf: bytes) -> list:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = read_varint(buf, pos)
        out.append(v)
    return out


def decode_packed_floats(buf: bytes) -> list:
    return list(struct.unpack(f"<{len(buf) // 4}f", buf))


# ---------------------------------------------------------------------------
# Encoding (for frozen-graph export; see core/graphdef_export.py)
# ---------------------------------------------------------------------------

def encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_tag(field: int, wire_type: int) -> bytes:
    return encode_varint((field << 3) | wire_type)


def encode_bytes_field(field: int, payload: bytes) -> bytes:
    return encode_tag(field, LENGTH_DELIMITED) + encode_varint(len(payload)) + payload


def encode_string_field(field: int, s: str) -> bytes:
    return encode_bytes_field(field, s.encode("utf-8"))


def encode_varint_field(field: int, value: int) -> bytes:
    if value < 0:
        value += 1 << 64
    return encode_tag(field, VARINT) + encode_varint(value)
