"""A copy of ``boxmot_tpu/onnxlite/proto.py``.

ONNX's protobuf wire format, by hand: varints, fixed-width scalars and
length-delimited fields, with the onnx.proto field numbers (IR version 8,
opset 17).  Host code in both packages.
"""

from __future__ import annotations

import struct

# ---------------------------------------------------------------- encode

def write_varint(n: int) -> bytes:
    """Unsigned LEB128.  Negative ints are encoded as 64-bit two's
    complement (protobuf int64 semantics)."""
    if n < 0:
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return write_varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return tag(field, 0) + write_varint(int(value))


def f_bytes(field: int, payload: bytes) -> bytes:
    return tag(field, 2) + write_varint(len(payload)) + payload


def f_string(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode("utf-8"))


def f_float(field: int, v: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", v)


def f_packed_varints(field: int, values) -> bytes:
    body = b"".join(write_varint(int(v)) for v in values)
    return f_bytes(field, body)


# ---------------------------------------------------------------- decode

def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def to_signed64(n: int) -> int:
    return n - (1 << 64) if n >= (1 << 63) else n


def parse_message(buf: bytes) -> dict[int, list]:
    """Parse one message into {field_number: [raw values]}.

    Varint fields come back as ints, length-delimited as bytes,
    32/64-bit as raw bytes (caller unpacks).  Repeated fields keep
    order.
    """
    fields: dict[int, list] = {}
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = read_varint(buf, pos)
        elif wire == 2:
            ln, pos = read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        else:  # pragma: no cover - groups are not used by onnx
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def parse_packed_varints(raw) -> list[int]:
    """A repeated int field arrives either packed (one bytes blob) or
    as individual varints; normalize both."""
    out = []
    for item in raw:
        if isinstance(item, int):
            out.append(to_signed64(item))
        else:
            pos = 0
            while pos < len(item):
                v, pos = read_varint(item, pos)
                out.append(to_signed64(v))
    return out


# ------------------------------------------------- onnx field numbers

class MODEL:
    IR_VERSION = 1
    PRODUCER_NAME = 2
    PRODUCER_VERSION = 3
    DOMAIN = 4
    MODEL_VERSION = 5
    DOC_STRING = 6
    GRAPH = 7
    OPSET_IMPORT = 8


class OPSET:
    DOMAIN = 1
    VERSION = 2


class GRAPH:
    NODE = 1
    NAME = 2
    INITIALIZER = 5
    DOC_STRING = 10
    INPUT = 11
    OUTPUT = 12
    VALUE_INFO = 13


class NODE:
    INPUT = 1
    OUTPUT = 2
    NAME = 3
    OP_TYPE = 4
    ATTRIBUTE = 5
    DOC_STRING = 6
    DOMAIN = 7


class ATTR:
    NAME = 1
    F = 2
    I = 3
    S = 4
    T = 5
    FLOATS = 7
    INTS = 8
    STRINGS = 9
    TYPE = 20
    # AttributeProto.AttributeType values
    TYPE_FLOAT = 1
    TYPE_INT = 2
    TYPE_STRING = 3
    TYPE_TENSOR = 4
    TYPE_FLOATS = 6
    TYPE_INTS = 7
    TYPE_STRINGS = 8


class TENSOR:
    DIMS = 1
    DATA_TYPE = 2
    NAME = 8
    RAW_DATA = 9
    # TensorProto.DataType values
    FLOAT = 1
    UINT8 = 2
    INT8 = 3
    INT32 = 6
    INT64 = 7
    BOOL = 9
    FLOAT16 = 10
    DOUBLE = 11


class VALUEINFO:
    NAME = 1
    TYPE = 2


class TYPEPROTO:
    TENSOR_TYPE = 1


class TENSORTYPE:
    ELEM_TYPE = 1
    SHAPE = 2


class SHAPE:
    DIM = 1


class DIM:
    DIM_VALUE = 1
    DIM_PARAM = 2
