"""A copy of ``boxmot_tpu/onnxlite/builder.py``.

``GraphBuilder``: nodes, initializers and value infos serialized to ONNX
ModelProto bytes (the role of ``onnx.helper.make_*``, without the onnx
package).  Host code in both packages.
"""

from __future__ import annotations

import numpy as np

from boxmot_tpu_torch.onnxlite import proto as P

_NP_TO_ONNX = {
    np.dtype(np.float32): P.TENSOR.FLOAT,
    np.dtype(np.float64): P.TENSOR.DOUBLE,
    np.dtype(np.float16): P.TENSOR.FLOAT16,
    np.dtype(np.int64): P.TENSOR.INT64,
    np.dtype(np.int32): P.TENSOR.INT32,
    np.dtype(np.int8): P.TENSOR.INT8,
    np.dtype(np.uint8): P.TENSOR.UINT8,
    np.dtype(np.bool_): P.TENSOR.BOOL,
}
ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}


def np_to_onnx_dtype(dtype) -> int:
    dtype = np.dtype(dtype)
    if dtype not in _NP_TO_ONNX:
        raise ValueError(f"no ONNX data type for {dtype}")
    return _NP_TO_ONNX[dtype]


def _attr(name: str, value) -> bytes:
    body = P.f_string(P.ATTR.NAME, name)
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, int):
        body += P.f_varint(P.ATTR.I, value)
        body += P.f_varint(P.ATTR.TYPE, P.ATTR.TYPE_INT)
    elif isinstance(value, float):
        body += P.f_float(P.ATTR.F, value)
        body += P.f_varint(P.ATTR.TYPE, P.ATTR.TYPE_FLOAT)
    elif isinstance(value, str):
        body += P.f_bytes(P.ATTR.S, value.encode())
        body += P.f_varint(P.ATTR.TYPE, P.ATTR.TYPE_STRING)
    elif isinstance(value, np.ndarray):
        body += P.f_bytes(P.ATTR.T, _tensor("", value))
        body += P.f_varint(P.ATTR.TYPE, P.ATTR.TYPE_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            for v in value:
                body += P.f_float(P.ATTR.FLOATS, v)
            body += P.f_varint(P.ATTR.TYPE, P.ATTR.TYPE_FLOATS)
        elif value and isinstance(value[0], str):
            for v in value:
                body += P.f_bytes(P.ATTR.STRINGS, v.encode())
            body += P.f_varint(P.ATTR.TYPE, P.ATTR.TYPE_STRINGS)
        else:
            body += P.f_packed_varints(P.ATTR.INTS, value)
            body += P.f_varint(P.ATTR.TYPE, P.ATTR.TYPE_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return body


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    body = b""
    for d in arr.shape:
        body += P.f_varint(P.TENSOR.DIMS, d)
    body += P.f_varint(P.TENSOR.DATA_TYPE, np_to_onnx_dtype(arr.dtype))
    if name:
        body += P.f_string(P.TENSOR.NAME, name)
    body += P.f_bytes(P.TENSOR.RAW_DATA, arr.tobytes())
    return body


def _value_info(name: str, shape, elem_type: int) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += P.f_bytes(P.SHAPE.DIM, P.f_string(P.DIM.DIM_PARAM, d))
        else:
            dims += P.f_bytes(P.SHAPE.DIM, P.f_varint(P.DIM.DIM_VALUE, d))
    tensor_type = P.f_varint(P.TENSORTYPE.ELEM_TYPE, elem_type) + P.f_bytes(
        P.TENSORTYPE.SHAPE, dims
    )
    type_proto = P.f_bytes(P.TYPEPROTO.TENSOR_TYPE, tensor_type)
    return P.f_string(P.VALUEINFO.NAME, name) + P.f_bytes(
        P.VALUEINFO.TYPE, type_proto
    )


class GraphBuilder:
    def __init__(self, name: str = "boxmot_tpu"):
        self.name = name
        self._nodes: list[bytes] = []
        self._initializers: list[bytes] = []
        self._inputs: list[bytes] = []
        self._outputs: list[bytes] = []
        self._counter = 0
        self._const_cache: dict[tuple, str] = {}

    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def add_input(self, name: str, shape, dtype=np.float32):
        self._inputs.append(_value_info(name, shape, np_to_onnx_dtype(dtype)))

    def add_output(self, name: str, shape, dtype=np.float32):
        self._outputs.append(_value_info(name, shape, np_to_onnx_dtype(dtype)))

    def add_initializer(self, name: str, arr: np.ndarray):
        self._initializers.append(_tensor(name, np.asarray(arr)))

    def constant(self, arr: np.ndarray, hint: str = "const") -> str:
        """Deduplicated initializer for small constants (shapes, axes)."""
        arr = np.asarray(arr)
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        if key in self._const_cache:
            return self._const_cache[key]
        name = self.fresh(hint)
        self.add_initializer(name, arr)
        self._const_cache[key] = name
        return name

    def node(self, op_type: str, inputs, outputs=None, **attrs) -> str:
        """Add a node; returns the (single) output name if outputs is None."""
        if outputs is None:
            outputs = [self.fresh(op_type.lower())]
        body = b""
        for i in inputs:
            body += P.f_string(P.NODE.INPUT, i)
        for o in outputs:
            body += P.f_string(P.NODE.OUTPUT, o)
        body += P.f_string(P.NODE.NAME, self.fresh(f"n_{op_type}"))
        body += P.f_string(P.NODE.OP_TYPE, op_type)
        for k, v in attrs.items():
            body += P.f_bytes(P.NODE.ATTRIBUTE, _attr(k, v))
        self._nodes.append(body)
        return outputs[0]

    def serialize(self, opset: int = 17, producer: str = "boxmot_tpu") -> bytes:
        graph = b""
        for n in self._nodes:
            graph += P.f_bytes(P.GRAPH.NODE, n)
        graph += P.f_string(P.GRAPH.NAME, self.name)
        for t in self._initializers:
            graph += P.f_bytes(P.GRAPH.INITIALIZER, t)
        for i in self._inputs:
            graph += P.f_bytes(P.GRAPH.INPUT, i)
        for o in self._outputs:
            graph += P.f_bytes(P.GRAPH.OUTPUT, o)
        opset_msg = P.f_string(P.OPSET.DOMAIN, "") + P.f_varint(
            P.OPSET.VERSION, opset
        )
        model = (
            P.f_varint(P.MODEL.IR_VERSION, 8)
            + P.f_string(P.MODEL.PRODUCER_NAME, producer)
            + P.f_string(P.MODEL.PRODUCER_VERSION, "1.0")
            + P.f_bytes(P.MODEL.GRAPH, graph)
            + P.f_bytes(P.MODEL.OPSET_IMPORT, opset_msg)
        )
        return model
