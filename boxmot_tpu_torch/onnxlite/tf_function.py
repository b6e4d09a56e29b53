"""A TensorFlow function that evaluates one of the port's ONNX graphs.

The JAX package builds its SavedModel and TFLite exports with ``jax2tf``;
the port has no such bridge and no ONNX-to-TF package, so its exporters
decode their own ONNX graph (``export.py``'s output, read by the copied
``runtime.decode_model``) and trace it into a ``tf.function`` here: one
small op table over the ops ``export.py`` emits, which the numpy evaluator
runs too.  One place reads torch graphs, and the TF artifacts compute
what the ONNX artifact computes.

TF's CPU convolutions and pools want NHWC, while the graph is NCHW after
its input ``Transpose``.  Each 4-D value therefore carries its layout: the
input's transpose to NCHW only relabels the NHWC tensor; convolutions,
pools and elementwise ops keep NHWC (constants are transposed at trace
time, lower-rank operands broadcast as NCHW would); a reduction or concat
maps its axes; any other op first restores NCHW.  So an OSNet graph holds
no transposes but the one its pooled features may need.

TF runs on the host: ``tensorflow()`` hides the GPUs from it before it
makes its context, so that a GPU build of TF does not take the card's
memory from PyTorch.
"""

from __future__ import annotations

import numpy as np

from boxmot_tpu_torch.onnxlite.runtime import decode_model

_TO_NHWC = (0, 2, 3, 1)
_TO_NCHW = (0, 3, 1, 2)
_STORED = {0: 0, 1: 3, 2: 1, 3: 2}  # a logical NCHW axis -> its axis in the NHWC tensor


def tensorflow():
    """The ``tensorflow`` module, with every GPU hidden from it."""
    import tensorflow as tf  # noqa: PLC0415

    try:
        tf.config.set_visible_devices([], "GPU")
    except RuntimeError:  # its context exists already: the setting was made before
        pass
    return tf


class _V:
    """A value: a TF tensor or a numpy constant, and whether it is a 4-D
    NCHW value stored as NHWC."""

    __slots__ = ("t", "nhwc")

    def __init__(self, t, nhwc: bool = False):
        self.t, self.nhwc = t, nhwc

    @property
    def rank(self) -> int:
        return len(self.t.shape)


def _plain(tf, v: _V):
    return tf.transpose(v.t, _TO_NCHW) if v.nhwc else v.t


def _as_nhwc(tf, v: _V):
    """``v`` broadcast against a 4-D NCHW value, in NHWC."""
    if v.nhwc:
        return v.t
    if isinstance(v.t, np.ndarray):
        a = v.t.reshape((1,) * (4 - v.t.ndim) + v.t.shape) if v.t.ndim < 4 else v.t
        return np.ascontiguousarray(np.transpose(a, _TO_NHWC))
    t = v.t
    if v.rank < 4:
        t = tf.reshape(t, [1] * (4 - v.rank) + list(t.shape))
    return tf.transpose(t, _TO_NHWC)


def _elementwise(tf, fn, vals):
    if any(v.nhwc for v in vals):
        return _V(fn(*[_as_nhwc(tf, v) for v in vals]), True)
    return _V(fn(*[v.t for v in vals]))


def _pads(attrs, rank=2):
    pads = [int(p) for p in attrs.get("pads", [0] * (2 * rank))]
    return [[0, 0]] + [[pads[i], pads[i + rank]] for i in range(rank)] + [[0, 0]]


def _conv(tf, x: _V, w: np.ndarray, b, attrs):
    x = _as_nhwc(tf, x)
    pads = _pads(attrs)
    if any(p for pair in pads for p in pair):
        x = tf.pad(x, pads)
    strides = [1, *[int(s) for s in attrs.get("strides", [1, 1])], 1]
    dil = [int(d) for d in attrs.get("dilations", [1, 1])]
    groups = int(attrs.get("group", 1))
    c_in, c_out = int(x.shape[-1]), w.shape[0]
    hwio = np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))  # (kh, kw, in / g, out)
    if groups == 1:
        y = tf.nn.conv2d(x, hwio, strides, "VALID", dilations=dil)
    elif groups == c_in and w.shape[1] == 1:  # depthwise: (kh, kw, C, multiplier)
        mult = c_out // c_in
        dw = hwio.reshape(hwio.shape[0], hwio.shape[1], c_in, mult)
        y = tf.nn.depthwise_conv2d(x, dw, strides, "VALID", dilations=dil)
    else:  # grouped: TF's CPU conv2d takes no groups
        xs = tf.split(x, groups, axis=-1)
        ws = np.split(hwio, groups, axis=-1)
        y = tf.concat([tf.nn.conv2d(xi, wi, strides, "VALID", dilations=dil)
                       for xi, wi in zip(xs, ws)], axis=-1)
    if b is not None:
        y = y + b
    return _V(y, True)


def _pool(tf, x: _V, attrs, kind):
    x = _as_nhwc(tf, x)
    pads = _pads(attrs)
    if any(p for pair in pads for p in pair):
        x = tf.pad(x, pads, constant_values=float("-inf") if kind == "max" else 0.0)
    k = [int(v) for v in attrs["kernel_shape"]]
    s = [int(v) for v in attrs.get("strides", k)]
    if kind == "avg" and not attrs.get("count_include_pad", 0) and any(
            p for pair in pads for p in pair):
        raise NotImplementedError("AveragePool count_include_pad=0 with pads")
    pool = tf.nn.max_pool2d if kind == "max" else tf.nn.avg_pool2d
    return _V(pool(x, k, s, "VALID"), True)


def _reduce(tf, fn, x: _V, axes, keep: bool):
    rank = x.rank
    axes = sorted(a + rank if a < 0 else a for a in (range(rank) if axes is None else axes))
    if not x.nhwc:
        return _V(fn(x.t, axis=axes, keepdims=keep))
    stored = sorted(_STORED[a] for a in axes)
    y = fn(x.t, axis=stored, keepdims=keep)
    if keep:
        return _V(y, True)
    inverse = {s: logical for logical, s in _STORED.items()}
    left = [inverse[s] for s in range(4) if s not in stored]  # logical axes in stored order
    order = sorted(range(len(left)), key=lambda i: left[i])
    return _V(tf.transpose(y, order) if order != list(range(len(left))) else y)


def _slice(tf, data, vals):
    starts, ends = [int(v) for v in vals[1]], [int(v) for v in vals[2]]
    axes = [int(v) for v in vals[3]] if len(vals) > 3 else list(range(len(starts)))
    steps = [int(v) for v in vals[4]] if len(vals) > 4 else [1] * len(starts)
    idx = [slice(None)] * len(data.shape)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        en = None if (sp < 0 and en < -int(data.shape[ax])) else en
        idx[ax] = slice(st, en, sp)
    return data[tuple(idx)]


_UNARY = {"Sqrt": "sqrt", "Exp": "exp", "Sigmoid": "sigmoid", "Erf": "erf"}
_BINARY = {"Add": "add", "Sub": "subtract", "Mul": "multiply", "Div": "divide", "Pow": "pow",
           "Max": "maximum", "Min": "minimum"}


def _run_node(tf, node, vals: list[_V]) -> _V:
    op, a = node.op, node.attrs
    if op == "Transpose":
        perm = tuple(int(p) for p in a["perm"])
        x = vals[0]
        if not x.nhwc and x.rank == 4 and perm == _TO_NCHW:
            return _V(x.t, True)  # NHWC data relabelled as NCHW
        if x.nhwc and perm == _TO_NHWC:
            return _V(x.t)
        return _V(tf.transpose(_plain(tf, x), perm))
    if op == "Conv":
        return _conv(tf, vals[0], vals[1].t, vals[2].t if len(vals) > 2 else None, a)
    if op in ("MaxPool", "AveragePool"):
        return _pool(tf, vals[0], a, "max" if op == "MaxPool" else "avg")
    if op in _UNARY:
        fn = getattr(tf.math, _UNARY[op])
        return _V(fn(vals[0].t), vals[0].nhwc)
    if op in _BINARY:
        return _elementwise(tf, getattr(tf.math, _BINARY[op]), vals)
    if op == "Identity":
        return vals[0]
    if op == "ReduceSum":
        axes = [int(v) for v in vals[1].t] if len(vals) > 1 else None
        return _reduce(tf, tf.reduce_sum, vals[0], axes, bool(a.get("keepdims", 1)))
    if op in ("ReduceMean", "ReduceMax"):
        fn = tf.reduce_mean if op == "ReduceMean" else tf.reduce_max
        return _reduce(tf, fn, vals[0], a.get("axes"), bool(a.get("keepdims", 1)))
    if op == "Concat":
        axis = int(a["axis"])
        if any(v.nhwc for v in vals) and all(v.rank == 4 for v in vals):
            return _V(tf.concat([_as_nhwc(tf, v) for v in vals], axis=_STORED[axis % 4]), True)
        return _V(tf.concat([_plain(tf, v) for v in vals], axis=axis))
    x = [_plain(tf, v) for v in vals]
    if op == "Reshape":
        return _V(tf.reshape(x[0], [int(d) for d in vals[1].t]))
    if op == "Expand":
        return _V(tf.broadcast_to(x[0], [int(d) for d in vals[1].t]))
    if op == "MatMul":
        return _V(tf.linalg.matmul(x[0], x[1]))
    if op == "Slice":
        return _V(_slice(tf, x[0], [v.t for v in vals]))
    if op == "Pad":
        pads = [int(p) for p in vals[1].t]
        half = len(pads) // 2
        value = vals[2].t.reshape(()) if len(vals) > 2 else 0  # the reader makes scalars (1,)
        return _V(tf.pad(x[0], [[pads[i], pads[i + half]] for i in range(half)],
                         constant_values=value))
    raise NotImplementedError(f"no TensorFlow translation for ONNX op {op}")


def tf_function(blob: bytes, input_shape):
    """A ``tf.function`` of the ONNX model ``blob`` (one input, one output)
    with the static input signature ``input_shape`` (float32)."""
    tf = tensorflow()
    nodes, inits, in_names, out_names = decode_model(bytes(blob))
    consts = {k: np.array(v) for k, v in inits.items()}

    def fwd(x):
        env = {in_names[0]: _V(x)}
        for node in nodes:
            vals = [env[n] if n in env else _V(consts[n]) for n in node.inputs]
            env[node.outputs[0]] = _run_node(tf, node, vals)
        return _plain(tf, env[out_names[0]])

    return tf.function(fwd, input_signature=[tf.TensorSpec(tuple(input_shape), tf.float32)],
                       autograph=False)
