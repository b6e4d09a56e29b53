"""A copy of ``boxmot_tpu/onnxlite/runtime.py``.

A minimal ONNX evaluator: decodes a ModelProto with ``proto.py`` and runs
the op subset the exporters emit, with numpy for elementwise and shape ops
and PyTorch on the CPU for convolution and pooling.  It shares no code with
the exporters, so it checks their graphs independently.  Host code in both
packages.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from boxmot_tpu_torch.onnxlite import proto as P
from boxmot_tpu_torch.onnxlite.builder import ONNX_TO_NP


# ------------------------------------------------------------- decoding

def _decode_tensor(buf: bytes):
    f = P.parse_message(buf)
    dims = P.parse_packed_varints(f.get(P.TENSOR.DIMS, []))
    dtype = ONNX_TO_NP[f[P.TENSOR.DATA_TYPE][0]]
    name = f.get(P.TENSOR.NAME, [b""])[0].decode()
    raw = f.get(P.TENSOR.RAW_DATA, [b""])[0]
    arr = np.frombuffer(raw, dtype=dtype).reshape(dims)
    return name, arr


def _decode_attr(buf: bytes):
    f = P.parse_message(buf)
    name = f[P.ATTR.NAME][0].decode()
    atype = f.get(P.ATTR.TYPE, [0])[0]
    if atype == P.ATTR.TYPE_INT:
        return name, P.to_signed64(f[P.ATTR.I][0])
    if atype == P.ATTR.TYPE_FLOAT:
        import struct

        return name, struct.unpack("<f", f[P.ATTR.F][0])[0]
    if atype == P.ATTR.TYPE_STRING:
        return name, f[P.ATTR.S][0].decode()
    if atype == P.ATTR.TYPE_INTS:
        return name, P.parse_packed_varints(f.get(P.ATTR.INTS, []))
    if atype == P.ATTR.TYPE_TENSOR:
        return name, _decode_tensor(f[P.ATTR.T][0])[1]
    raise ValueError(f"unsupported attribute type {atype}")


class _Node:
    __slots__ = ("op", "inputs", "outputs", "attrs")

    def __init__(self, buf: bytes):
        f = P.parse_message(buf)
        self.inputs = [s.decode() for s in f.get(P.NODE.INPUT, [])]
        self.outputs = [s.decode() for s in f.get(P.NODE.OUTPUT, [])]
        self.op = f[P.NODE.OP_TYPE][0].decode()
        self.attrs = dict(
            _decode_attr(a) for a in f.get(P.NODE.ATTRIBUTE, [])
        )


def decode_model(blob: bytes):
    """-> (nodes, initializers dict, input names, output names)."""
    model = P.parse_message(blob)
    graph = P.parse_message(model[P.MODEL.GRAPH][0])
    nodes = [_Node(n) for n in graph.get(P.GRAPH.NODE, [])]
    inits = dict(
        _decode_tensor(t) for t in graph.get(P.GRAPH.INITIALIZER, [])
    )
    def _names(field):
        out = []
        for vi in graph.get(field, []):
            out.append(P.parse_message(vi)[P.VALUEINFO.NAME][0].decode())
        return out
    return nodes, inits, _names(P.GRAPH.INPUT), _names(P.GRAPH.OUTPUT)


# ------------------------------------------------------------ operators

def _torch():
    import torch

    return torch


def _writable(x: np.ndarray) -> np.ndarray:
    """torch.from_numpy wants writable memory; initializer arrays come
    from frombuffer views and are read-only."""
    x = np.ascontiguousarray(x)
    return x if x.flags.writeable else x.copy()


def _conv(x, w, b, attrs):
    torch = _torch()
    pads = attrs.get("pads", [0] * (2 * (x.ndim - 2)))
    half = len(pads) // 2
    tpad = []
    for i in reversed(range(half)):  # torch pad order: last dim first
        tpad += [int(pads[i]), int(pads[i + half])]
    xt = torch.from_numpy(_writable(x))
    if any(tpad):
        xt = torch.nn.functional.pad(xt, tpad)
    y = torch.nn.functional.conv2d(
        xt,
        torch.from_numpy(_writable(w)),
        bias=None if b is None else torch.from_numpy(_writable(b)),
        stride=tuple(int(s) for s in attrs.get("strides", [1, 1])),
        dilation=tuple(int(d) for d in attrs.get("dilations", [1, 1])),
        groups=int(attrs.get("group", 1)),
    )
    return y.numpy()


def _pool(x, attrs, kind):
    torch = _torch()
    pads = attrs.get("pads", [0, 0, 0, 0])
    half = len(pads) // 2
    tpad = []
    for i in reversed(range(half)):
        tpad += [int(pads[i]), int(pads[i + half])]
    xt = torch.from_numpy(_writable(x))
    if any(tpad):
        fill = float("-inf") if kind == "max" else 0.0
        xt = torch.nn.functional.pad(xt, tpad, value=fill)
    k = tuple(int(v) for v in attrs["kernel_shape"])
    s = tuple(int(v) for v in attrs.get("strides", k))
    if kind == "max":
        y = torch.nn.functional.max_pool2d(xt, k, s)
    else:
        if not attrs.get("count_include_pad", 0) and any(tpad):
            raise NotImplementedError("AveragePool count_include_pad=0 with pads")
        y = torch.nn.functional.avg_pool2d(xt, k, s, count_include_pad=True)
    return y.numpy()


def _slice(vals):
    data, starts, ends, axes, steps = (
        vals + [None] * (5 - len(vals))
    )[:5]
    starts = starts.astype(np.int64)
    ends = ends.astype(np.int64)
    axes = (
        np.arange(len(starts)) if axes is None else axes.astype(np.int64)
    )
    steps = np.ones(len(starts), np.int64) if steps is None else steps.astype(np.int64)
    idx = [slice(None)] * data.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        st, en, ax, sp = int(st), int(en), int(ax), int(sp)
        en = None if (sp < 0 and en < -data.shape[ax]) else en
        idx[ax] = slice(st, en, sp)
    return data[tuple(idx)]


def _run_node(node: _Node, vals: list[np.ndarray]):
    op, a = node.op, node.attrs
    x = vals[0] if vals else None
    if op == "Conv":
        return _conv(vals[0], vals[1], vals[2] if len(vals) > 2 else None, a)
    if op == "MaxPool":
        return _pool(x, a, "max")
    if op == "AveragePool":
        return _pool(x, a, "avg")
    if op == "Transpose":
        return np.transpose(x, a["perm"])
    if op == "Reshape":
        return np.reshape(x, [int(d) for d in vals[1]])
    if op == "Expand":
        return np.broadcast_to(x, [int(d) for d in vals[1]]).copy()
    if op == "Identity":
        return x
    if op == "Cast":
        return x.astype(ONNX_TO_NP[a["to"]])
    if op == "Concat":
        return np.concatenate(vals, axis=a["axis"])
    if op == "Slice":
        return _slice(vals)
    if op == "Pad":
        pads = vals[1].astype(np.int64)
        half = len(pads) // 2
        width = [(int(pads[i]), int(pads[i + half])) for i in range(half)]
        cval = vals[2] if len(vals) > 2 else np.zeros((), x.dtype)
        return np.pad(x, width, constant_values=cval)
    if op == "Where":
        return np.where(vals[0], vals[1], vals[2])
    if op == "Einsum":
        return np.einsum(a["equation"], *vals)
    if op == "MatMul":
        return np.matmul(vals[0], vals[1])
    if op == "Gather":
        return np.take(vals[0], vals[1].astype(np.int64), axis=a.get("axis", 0))
    if op == "CumSum":
        axis = int(vals[1])
        y = np.cumsum(x, axis=axis)
        if a.get("reverse"):
            y = np.flip(np.cumsum(np.flip(x, axis), axis=axis), axis)
        return y
    if op == "ReduceSum":
        axes = tuple(int(v) for v in vals[1]) if len(vals) > 1 else None
        return np.sum(x, axis=axes, keepdims=bool(a.get("keepdims", 1)))
    if op in ("ReduceMax", "ReduceMin", "ReduceProd", "ReduceMean"):
        fn = {"ReduceMax": np.max, "ReduceMin": np.min,
              "ReduceProd": np.prod, "ReduceMean": np.mean}[op]
        axes = tuple(a["axes"]) if "axes" in a else None
        return fn(x, axis=axes, keepdims=bool(a.get("keepdims", 1)))
    if op in ("ArgMax", "ArgMin"):
        fn = np.argmax if op == "ArgMax" else np.argmin
        y = fn(x, axis=a.get("axis", 0))
        if a.get("keepdims", 1):
            y = np.expand_dims(y, a.get("axis", 0))
        return y.astype(np.int64)
    unary = {
        "Exp": np.exp, "Log": np.log, "Tanh": np.tanh, "Sqrt": np.sqrt,
        "Neg": np.negative, "Abs": np.abs, "Sign": np.sign,
        "Floor": np.floor, "Ceil": np.ceil, "Round": np.round,
        "Reciprocal": np.reciprocal, "Not": np.logical_not,
        "Sin": np.sin, "Cos": np.cos,
    }
    if op in unary:
        return unary[op](x)
    if op == "Sigmoid":
        return (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(x.dtype)
    if op == "Erf":
        try:
            from math import erf as _erf

            return np.vectorize(_erf, otypes=[np.float64])(x).astype(x.dtype)
        except Exception:  # pragma: no cover
            raise
    binary = {
        "Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
        "Div": np.divide, "Pow": np.power,
        "Less": np.less, "Greater": np.greater,
        "LessOrEqual": np.less_equal, "GreaterOrEqual": np.greater_equal,
        "Equal": np.equal, "And": np.logical_and, "Or": np.logical_or,
        "Xor": np.logical_xor,
    }
    if op in binary:
        return binary[op](vals[0], vals[1])
    if op in ("Max", "Min"):
        fn = np.maximum if op == "Max" else np.minimum
        out = vals[0]
        for v in vals[1:]:
            out = fn(out, v)
        return out
    raise NotImplementedError(f"onnxlite runtime: unsupported op {op}")


def run_onnx(model: bytes | str | Path, inputs: dict[str, np.ndarray] | list):
    """Execute the model; returns the list of graph outputs."""
    if not isinstance(model, (bytes, bytearray)):
        model = Path(model).read_bytes()
    nodes, env, in_names, out_names = decode_model(bytes(model))
    if not isinstance(inputs, dict):
        inputs = dict(zip(in_names, inputs))
    env = dict(env)
    for k, v in inputs.items():
        env[k] = np.asarray(v)
    for node in nodes:
        vals = [env[n] for n in node.inputs]
        out = _run_node(node, vals)
        outs = out if isinstance(out, (tuple, list)) else [out]
        for name, val in zip(node.outputs, outs):
            env[name] = np.asarray(val)
    return [env[n] for n in out_names]
