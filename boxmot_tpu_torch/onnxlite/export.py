"""The port's backbones to ONNX (opset 17), through ``torch.export``.

Counterpart of ``boxmot_tpu/onnxlite/export.py``, which walks a jaxpr.  Here
``torch.export.export`` traces a CPU float32 copy of the module in eval
mode at the input's static shape, and each ATen node of its graph becomes
a few ONNX nodes in the copied ``GraphBuilder`` (``Builder``).
``torch.export`` rather than ``torch.fx.symbolic_trace``: its graphs hold
no Python shape arithmetic (the ViTs' and CSL-TinyViT's reshapes arrive as
static views) and no module calls to unpack, are functional, and every
node carries its output's shape and dtype.  The graph is taken as
``export`` gives it (about fifty ATen ops cover every backbone:
``conv2d``, ``linear``, ``batch_norm``, ``layer_norm``, ``softmax``,
``matmul``, ...), without ``run_decompositions()``, which would lower it to
core ATen but costs two to four times the trace.

As in the JAX translator, parameters, buffers and anything computed from
them alone are folded at export (the node is run on the CPU): they become
initializers, and the graph holds only the dataflow from the input.  Eval
batch norms fold into one ``Mul`` and one ``Add`` (scale and shift
computed in float64), since the evaluator (``onnxlite/runtime.py``) has no
``BatchNormalization``; instance norms, layer norms, softmax and GELU are
spelled with reductions and elementwise ops.  Only ops that ``runtime.py``
evaluates are emitted, so every export can be checked here.
``TRANSLATIONS`` holds the ops the backbones leave after folding; another
ATen op raises, naming it, and so does an in-place op (HACNN's spatial
transformer; the JAX translator refuses HACNN too).

The graph's input is the JAX artifacts' NHWC crop batch ``(B, H, W, 3)``
and its first node a ``Transpose`` to NCHW, so one array feeds an artifact
of either package.
"""

from __future__ import annotations

import copy
import math
import operator
from pathlib import Path

import numpy as np
import torch

from boxmot_tpu_torch.onnxlite import proto as P
from boxmot_tpu_torch.onnxlite.builder import GraphBuilder


class Builder(GraphBuilder):
    """The copied ``GraphBuilder``, serialized by one join of its parts: the
    copy appends them to one ``bytes`` in turn, which copies a large model's
    weights once an initializer (5 s of ResNet-101's export).  The bytes are
    the same."""

    def serialize(self, opset: int = 17, producer: str = "boxmot_tpu") -> bytes:
        graph = b"".join([*(P.f_bytes(P.GRAPH.NODE, n) for n in self._nodes),
                          P.f_string(P.GRAPH.NAME, self.name),
                          *(P.f_bytes(P.GRAPH.INITIALIZER, t) for t in self._initializers),
                          *(P.f_bytes(P.GRAPH.INPUT, i) for i in self._inputs),
                          *(P.f_bytes(P.GRAPH.OUTPUT, o) for o in self._outputs)])
        opset_msg = P.f_string(P.OPSET.DOMAIN, "") + P.f_varint(P.OPSET.VERSION, opset)
        return b"".join([P.f_varint(P.MODEL.IR_VERSION, 8),
                         P.f_string(P.MODEL.PRODUCER_NAME, producer),
                         P.f_string(P.MODEL.PRODUCER_VERSION, "1.0"),
                         P.f_bytes(P.MODEL.GRAPH, graph),
                         P.f_bytes(P.MODEL.OPSET_IMPORT, opset_msg)])


class _Dyn:
    """A value computed from the graph's input: its ONNX name, shape, dtype."""

    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name: str, shape, dtype):
        self.name, self.shape, self.dtype = name, [int(d) for d in shape], dtype


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


class _Ctx:
    def __init__(self, builder: GraphBuilder):
        self.b = builder

    def name(self, v, like=None) -> str:
        """The ONNX name of a value: a dynamic value's, or an initializer
        for a static tensor or a Python scalar (in ``like``'s dtype)."""
        if isinstance(v, _Dyn):
            return v.name
        if isinstance(v, torch.Tensor):
            return self.b.constant(_np(v), "c")
        dtype = like.dtype if like is not None else torch.float32
        return self.b.constant(_np(torch.tensor(v, dtype=dtype)), "c")

    def ints(self, values) -> str:
        return self.b.constant(np.asarray(values, np.int64), "i")

    def node(self, op: str, inputs, out_meta, **attrs) -> _Dyn:
        return _Dyn(self.b.node(op, inputs, **attrs), out_meta.shape, out_meta.dtype)

    def op(self, op: str, inputs, shape, dtype, **attrs) -> _Dyn:
        return _Dyn(self.b.node(op, inputs, **attrs), shape, dtype)


def _axis(a: int, rank: int) -> int:
    return a + rank if a < 0 else a


def _meta(node):
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        return val[0]
    return val


def _pool_out(size, k, s, p, d, ceil):
    span = size + 2 * p - d * (k - 1) - 1
    out = (span + (s - 1 if ceil else 0)) // s + 1
    if ceil and (out - 1) * s >= size + p:
        out -= 1
    return out


def _check_ceil(kind, x, k, s, p, d, ceil):
    if ceil and any(_pool_out(n, *a, True) != _pool_out(n, *a, False)
                    for n, a in zip(x.shape[2:], zip(k, s, p, d))):
        raise NotImplementedError(f"{kind} with ceil_mode that changes the output shape")


def _pair(v):
    v = [int(v)] if isinstance(v, int) else [int(u) for u in v]
    return v * 2 if len(v) == 1 else v


def _bn_shape(rank: int, c: int):
    return [c] + [1] * (rank - 2)


def _normalize(ctx, x: _Dyn, axes, eps, w, b):
    """(x - mean) / sqrt(var + eps) over ``axes`` (biased variance), then
    the affine ``w``, ``b`` (static, already in broadcast shape) if given."""
    f32 = x.dtype
    kept = [1 if i in axes else d for i, d in enumerate(x.shape)]
    mean = ctx.op("ReduceMean", [x.name], kept, f32, axes=list(axes), keepdims=1)
    d = ctx.op("Sub", [x.name, mean.name], x.shape, f32)
    sq = ctx.op("Mul", [d.name, d.name], x.shape, f32)
    var = ctx.op("ReduceMean", [sq.name], kept, f32, axes=list(axes), keepdims=1)
    den = ctx.op("Sqrt", [ctx.op("Add", [var.name, ctx.name(float(eps), x)], kept, f32).name],
                 kept, f32)
    y = ctx.op("Div", [d.name, den.name], x.shape, f32)
    if w is not None:
        y = ctx.op("Mul", [y.name, ctx.name(w)], x.shape, f32)
    if b is not None:
        y = ctx.op("Add", [y.name, ctx.name(b)], x.shape, f32)
    return y


def _binary(op):
    def emit(ctx, node, a, kw):
        x, y = a[0], a[1]
        alpha = kw.get("alpha", a[2] if len(a) > 2 else 1)
        like = x if isinstance(x, _Dyn) else y
        if op in ("Add", "Sub") and alpha != 1:
            y = ctx.op("Mul", [ctx.name(y, like), ctx.name(alpha, like)], _meta(node).shape,
                       like.dtype)
        if kw.get("rounding_mode") is not None:
            raise NotImplementedError(f"{node.target} with rounding_mode")
        return ctx.node(op, [ctx.name(x, like), ctx.name(y, like)], _meta(node))
    return emit


def _unary(op):
    return lambda ctx, node, a, kw: ctx.node(op, [a[0].name], _meta(node))


def _relu(ctx, node, a, kw):
    return ctx.node("Max", [a[0].name, ctx.name(0.0, a[0])], _meta(node))


def _relu6(ctx, node, a, kw):
    x = a[0]
    m = ctx.op("Max", [x.name, ctx.name(0.0, x)], x.shape, x.dtype)
    return ctx.node("Min", [m.name, ctx.name(6.0, x)], _meta(node))


def _silu(ctx, node, a, kw):
    s = ctx.op("Sigmoid", [a[0].name], a[0].shape, a[0].dtype)
    return ctx.node("Mul", [a[0].name, s.name], _meta(node))


def _gelu(ctx, node, a, kw):
    """The exact GELU, 0.5 x (1 + erf(x / sqrt(2)))."""
    x, f = a[0], a[0].dtype
    if kw.get("approximate", a[1] if len(a) > 1 else "none") != "none":
        raise NotImplementedError("the tanh GELU is not exported")
    t = ctx.op("Erf", [ctx.op("Mul", [x.name, ctx.name(math.sqrt(0.5), x)], x.shape, f).name],
               x.shape, f)
    one_plus = ctx.op("Add", [t.name, ctx.name(1.0, x)], x.shape, f)
    half_x = ctx.op("Mul", [x.name, ctx.name(0.5, x)], x.shape, f)
    return ctx.node("Mul", [half_x.name, one_plus.name], _meta(node))


def _pow(ctx, node, a, kw):
    x, e = a[0], a[1]
    if e == 2:
        return ctx.node("Mul", [x.name, x.name], _meta(node))
    if e == 0.5:
        return ctx.node("Sqrt", [x.name], _meta(node))
    return ctx.node("Pow", [x.name, ctx.name(float(e), x)], _meta(node))


def _softmax(ctx, node, a, kw):
    x, dim = a[0], _axis(a[1], len(a[0].shape))
    f = x.dtype
    keep = [d if i != dim else 1 for i, d in enumerate(x.shape)]
    m = ctx.op("ReduceMax", [x.name], keep, f, axes=[dim], keepdims=1)
    e = ctx.op("Exp", [ctx.op("Sub", [x.name, m.name], x.shape, f).name], x.shape, f)
    s = ctx.op("ReduceSum", [e.name, ctx.ints([dim])], keep, f, keepdims=1)
    return ctx.node("Div", [e.name, s.name], _meta(node))


def _matmul(ctx, node, a, kw):
    return ctx.node("MatMul", [ctx.name(a[0]), ctx.name(a[1])], _meta(node))


def _linear(ctx, node, a, kw):
    x, w = a[0], a[1]
    b = a[2] if len(a) > 2 else kw.get("bias")
    meta = _meta(node)
    wt = w.t() if isinstance(w, torch.Tensor) else ctx.op(
        "Transpose", [w.name], w.shape[::-1], w.dtype, perm=[1, 0])
    y = ctx.op("MatMul", [x.name, ctx.name(wt)], meta.shape, meta.dtype)
    return y if b is None else ctx.node("Add", [y.name, ctx.name(b)], meta)


def _conv(ctx, node, a, kw):
    x, w = a[0], a[1]
    b, stride, padding, dilation, groups = (list(a[2:]) + [None, 1, 0, 1, 1][len(a) - 2:])[:5]
    if isinstance(padding, str):
        raise NotImplementedError(f"conv2d with padding={padding!r} is not exported")
    inputs = [x.name, ctx.name(w)] + ([ctx.name(b)] if b is not None else [])
    pads = _pair(padding)
    return ctx.node("Conv", inputs, _meta(node), strides=_pair(stride), pads=pads + pads,
                    dilations=_pair(dilation), group=int(groups))


def _fold_norm(ctx, node, x, w, b, mean, var, eps):
    """An affine norm with fixed statistics as one Mul and one Add (scale and
    shift computed in float64)."""
    c = x.shape[1]
    w64 = torch.ones(c, dtype=torch.float64) if w is None else w.double()
    b64 = torch.zeros(c, dtype=torch.float64) if b is None else b.double()
    scale = w64 / torch.sqrt(var.double() + eps)
    shift = b64 - mean.double() * scale
    shape = _bn_shape(len(x.shape), c)
    y = ctx.op("Mul", [x.name, ctx.name(scale.float().reshape(shape))], x.shape, x.dtype)
    return ctx.node("Add", [y.name, ctx.name(shift.float().reshape(shape))], _meta(node))


def _batch_norm(ctx, node, a, kw):
    x, w, b, mean, var, training, _, eps = a[:8]
    if training or mean is None:
        raise NotImplementedError("batch_norm with batch statistics is not exported (eval mode)")
    return _fold_norm(ctx, node, x, w, b, mean, var, eps)


def _instance_norm(ctx, node, a, kw):
    """Per sample and channel over the spatial axes (biased variance)."""
    x, w, b, mean, var, use_input_stats, _, eps = a[:8]
    if not use_input_stats:
        return _fold_norm(ctx, node, x, w, b, mean, var, eps)
    shape = _bn_shape(len(x.shape), x.shape[1])
    return _normalize(ctx, x, list(range(2, len(x.shape))), eps,
                      None if w is None else w.reshape(shape),
                      None if b is None else b.reshape(shape))


def _layer_norm(ctx, node, a, kw):
    x, shape = a[0], a[1]
    w, b, eps = (list(a[2:]) + [None, None, 1e-5][len(a) - 2:])[:3]
    axes = list(range(len(x.shape) - len(shape), len(x.shape)))
    return _normalize(ctx, x, axes, eps, w, b)


def _max_pool(ctx, node, a, kw):
    x, k = a[0], _pair(a[1])
    s = _pair(a[2]) if len(a) > 2 and a[2] else k
    p = _pair(a[3]) if len(a) > 3 else [0, 0]
    d = _pair(a[4]) if len(a) > 4 else [1, 1]
    ceil = bool(a[5]) if len(a) > 5 else False
    if any(v != 1 for v in d):
        raise NotImplementedError("dilated max pooling is not exported")
    _check_ceil("max_pool2d", x, k, s, p, d, ceil)
    return ctx.node("MaxPool", [x.name], _meta(node), kernel_shape=k, strides=s, pads=p + p)


def _avg_pool(ctx, node, a, kw):
    x, k = a[0], _pair(a[1])
    s = _pair(a[2]) if len(a) > 2 and a[2] else k
    p = _pair(a[3]) if len(a) > 3 else [0, 0]
    ceil = bool(a[4]) if len(a) > 4 else False
    include_pad = bool(a[5]) if len(a) > 5 else True
    if (a[6] if len(a) > 6 else None) is not None:
        raise NotImplementedError("avg_pool2d with divisor_override")
    if any(p) and not include_pad:
        raise NotImplementedError("avg_pool2d with padding and count_include_pad=False")
    _check_ceil("avg_pool2d", x, k, s, p, [1, 1], ceil)
    return ctx.node("AveragePool", [x.name], _meta(node), kernel_shape=k, strides=s, pads=p + p,
                    count_include_pad=1)


def _reduce(op):
    def emit(ctx, node, a, kw):
        x = a[0]
        dims = a[1] if len(a) > 1 else kw.get("dim")
        keep = bool(a[2] if len(a) > 2 else kw.get("keepdim", False))
        axes = list(range(len(x.shape))) if dims in (None, []) else \
            [_axis(int(d), len(x.shape)) for d in (dims if isinstance(dims, (list, tuple))
                                                   else [dims])]
        return ctx.node(op, [x.name], _meta(node), axes=axes, keepdims=int(keep))
    return emit


def _permute(ctx, node, a, kw):
    perm = [_axis(int(p), len(a[0].shape)) for p in a[1]]
    return ctx.node("Transpose", [a[0].name], _meta(node), perm=perm)


def _reshape(ctx, node, a, kw):
    meta = _meta(node)
    if list(meta.shape) == a[0].shape:
        return a[0]
    return ctx.node("Reshape", [a[0].name, ctx.ints(list(meta.shape))], meta)


def _passthrough(ctx, node, a, kw):
    return a[0]


def _slice_nodes(ctx, x, starts, ends, axes, steps, shape, dtype):
    return ctx.op("Slice", [x.name, ctx.ints(starts), ctx.ints(ends), ctx.ints(axes),
                            ctx.ints(steps)], shape, dtype)


def _slice(ctx, node, a, kw):
    x = a[0]
    dim = _axis(int(a[1]) if len(a) > 1 else kw.get("dim", 0), len(x.shape))
    n = x.shape[dim]
    start = a[2] if len(a) > 2 else kw.get("start")
    end = a[3] if len(a) > 3 else kw.get("end")
    step = a[4] if len(a) > 4 else kw.get("step", 1)
    start = 0 if start is None else (start + n if start < 0 else start)
    end = n if end is None else (end + n if end < 0 else end)
    start, end = max(0, min(int(start), n)), max(0, min(int(end), n))
    meta = _meta(node)
    if (start, end, step) == (0, n, 1):
        return x
    return _slice_nodes(ctx, x, [start], [end], [dim], [int(step)], list(meta.shape), meta.dtype)


def _select(ctx, node, a, kw):
    x, dim, index = a[0], _axis(int(a[1]), len(a[0].shape)), int(a[2])
    index = index + x.shape[dim] if index < 0 else index
    shape = list(x.shape)
    shape[dim] = 1
    y = _slice_nodes(ctx, x, [index], [index + 1], [dim], [1], shape, x.dtype)
    return _reshape(ctx, node, [y], kw)


def _cat(ctx, node, a, kw):
    tensors = a[0]
    meta = _meta(node)
    dim = _axis(int(a[1]) if len(a) > 1 else kw.get("dim", 0), len(meta.shape))
    like = next(t for t in tensors if isinstance(t, _Dyn))
    names = [ctx.name(t, like) for t in tensors if not (isinstance(t, torch.Tensor)
                                                        and t.numel() == 0)]
    return ctx.node("Concat", names, meta, axis=dim)


def _pad(ctx, node, a, kw):
    x, pad = a[0], [int(p) for p in a[1]]
    mode = a[2] if len(a) > 2 else kw.get("mode", "constant")
    value = a[3] if len(a) > 3 else kw.get("value")
    if mode != "constant" or any(p < 0 for p in pad):
        raise NotImplementedError(f"pad with mode {mode!r} or negative pads is not exported")
    rank = len(x.shape)
    begin, end = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):
        begin[rank - 1 - i], end[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    return ctx.node("Pad", [x.name, ctx.ints(begin + end), ctx.name(float(value or 0.0), x)],
                    _meta(node))


def _transpose(ctx, node, a, kw):
    x = a[0]
    perm = list(range(len(x.shape)))
    d0, d1 = _axis(int(a[1]), len(perm)), _axis(int(a[2]), len(perm))
    perm[d0], perm[d1] = perm[d1], perm[d0]
    return ctx.node("Transpose", [x.name], _meta(node), perm=perm)


def _unbind(ctx, node, a, kw):
    x = a[0]
    dim = _axis(int(a[1]) if len(a) > 1 else kw.get("dim", 0), len(x.shape))
    rest = [d for i, d in enumerate(x.shape) if i != dim]
    outs = []
    for i in range(x.shape[dim]):
        shape = list(x.shape)
        shape[dim] = 1
        y = _slice_nodes(ctx, x, [i], [i + 1], [dim], [1], shape, x.dtype)
        outs.append(ctx.op("Reshape", [y.name, ctx.ints(rest)], rest, x.dtype))
    return tuple(outs)


def _stack(ctx, node, a, kw):
    tensors = a[0]
    meta = _meta(node)
    dim = _axis(int(a[1]) if len(a) > 1 else kw.get("dim", 0), len(meta.shape))
    names = []
    for t in tensors:
        shape = list(t.shape)
        shape.insert(dim, 1)
        if isinstance(t, torch.Tensor):
            names.append(ctx.name(t.reshape(shape)))
        else:
            names.append(ctx.op("Reshape", [t.name, ctx.ints(shape)], shape, t.dtype).name)
    return ctx.node("Concat", names, meta, axis=dim)


def _repeat_interleave(ctx, node, a, kw):
    """Each element ``repeats`` times along ``dim``: reshape, expand, reshape."""
    x, reps = a[0], a[1]
    dim = a[2] if len(a) > 2 else kw.get("dim")
    if not isinstance(reps, int) or dim is None:
        raise NotImplementedError("repeat_interleave other than an int count along a dim")
    dim = _axis(int(dim), len(x.shape))
    inter = list(x.shape[:dim + 1]) + [1] + list(x.shape[dim + 1:])
    wide = list(x.shape[:dim + 1]) + [reps] + list(x.shape[dim + 1:])
    y = ctx.op("Reshape", [x.name, ctx.ints(inter)], inter, x.dtype)
    y = ctx.op("Expand", [y.name, ctx.ints(wide)], wide, x.dtype)
    return ctx.node("Reshape", [y.name, ctx.ints(list(_meta(node).shape))], _meta(node))


TRANSLATIONS = {  # every op that a backbone but HACNN leaves after folding
    "aten.conv2d.default": _conv,
    "aten.linear.default": _linear,
    "aten.batch_norm.default": _batch_norm,
    "aten.instance_norm.default": _instance_norm,
    "aten.layer_norm.default": _layer_norm,
    "aten.max_pool2d.default": _max_pool,
    "aten.avg_pool2d.default": _avg_pool,
    "aten.add.Tensor": _binary("Add"),
    "aten.sub.Tensor": _binary("Sub"),
    "aten.mul.Tensor": _binary("Mul"),
    "aten.div.Tensor": _binary("Div"),
    "aten.pow.Tensor_Scalar": _pow,
    "aten.sqrt.default": _unary("Sqrt"),
    "aten.sigmoid.default": _unary("Sigmoid"),
    "aten.relu.default": _relu,
    "aten.relu6.default": _relu6,
    "aten.silu.default": _silu,
    "aten.gelu.default": _gelu,
    "aten.softmax.int": _softmax,
    "aten.matmul.default": _matmul,
    "aten.mean.dim": _reduce("ReduceMean"),
    "aten.amax.default": _reduce("ReduceMax"),
    "aten.permute.default": _permute,
    "aten.transpose.int": _transpose,
    "aten.reshape.default": _reshape,
    "aten.flatten.using_ints": _reshape,
    "aten.alias.default": _passthrough,
    "aten.slice.Tensor": _slice,
    "aten.select.int": _select,
    "aten.unbind.int": _unbind,
    "aten.cat.default": _cat,
    "aten.stack.default": _stack,
    "aten.repeat_interleave.self_int": _repeat_interleave,
    "aten.pad.default": _pad,
}
_CHECKS = ("aten._assert_tensor_metadata.default", "aten._assert_scalar.default",
           "aten.sym_constrain_range_for_size.default")


def _is_dyn(v) -> bool:
    if isinstance(v, _Dyn):
        return True
    if isinstance(v, (list, tuple)):
        return any(_is_dyn(u) for u in v)
    return False


def _lookup(env, a):
    if isinstance(a, torch.fx.Node):
        return env[a]
    if isinstance(a, (list, tuple)):
        return type(a)(_lookup(env, u) for u in a)
    if isinstance(a, dict):
        return {k: _lookup(env, v) for k, v in a.items()}
    return a


def exported_program(module: torch.nn.Module, example: torch.Tensor):
    """``module`` traced by ``torch.export`` at ``example``'s static shape, on a
    float32 CPU copy in eval mode."""
    model = copy.deepcopy(module).to(device="cpu", dtype=torch.float32).eval()
    example = example.detach().to(device="cpu", dtype=torch.float32)
    with torch.no_grad():
        return torch.export.export(model, (example,))


def export_module_to_onnx(module: torch.nn.Module, input_shape, path: Path | str | None = None, *,
                          graph_name: str = "boxmot_tpu") -> bytes:
    """Write (and return) the ONNX bytes of ``module``'s forward at the static
    NHWC ``input_shape`` ``(B, H, W, C)``: input ``"images"``, transposed to
    the module's NCHW by the graph's first node, output ``"features"``.
    Raises ``NotImplementedError`` naming an ATen op with no translation."""
    shape = [int(d) for d in input_shape]
    nchw = [shape[0], shape[3], shape[1], shape[2]]
    ep = exported_program(module, torch.zeros(nchw))
    b = Builder(graph_name)
    ctx = _Ctx(b)
    static = {**ep.state_dict, **ep.constants}
    specs = {s.arg.name: s for s in ep.graph_signature.input_specs}
    env: dict = {}
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            spec = specs[node.name]
            if spec.kind.name == "USER_INPUT":
                b.add_input("images", shape, np.float32)
                env[node] = ctx.op("Transpose", ["images"], nchw, torch.float32, perm=[0, 3, 1, 2])
            else:
                env[node] = static[spec.target].detach().cpu()
            continue
        if node.op == "output":
            (out,) = node.args[0]
            b.node("Identity", [ctx.name(env[out])], outputs=["features"])
            meta = _meta(out)
            b.add_output("features", [int(d) for d in meta.shape],
                         np.dtype(str(meta.dtype).removeprefix("torch.")))
            continue
        if node.op != "call_function":
            raise NotImplementedError(f"graph node {node.op} {node.target} is not exported")
        args, kwargs = _lookup(env, node.args), _lookup(env, node.kwargs)
        key = str(node.target)
        if node.target is operator.getitem:
            env[node] = args[0][args[1]]
            continue
        if key in _CHECKS:
            continue
        schema = getattr(node.target, "_schema", None)
        if schema is not None and schema.is_mutable:
            raise NotImplementedError(f"in-place ATen op {key!r} is not exported")
        if not _is_dyn(args) and not _is_dyn(kwargs):
            with torch.no_grad():  # constant folding: run the op at export
                env[node] = node.target(*args, **kwargs)
            continue
        if key not in TRANSLATIONS:
            raise NotImplementedError(f"no ONNX translation for ATen op {key!r}")
        env[node] = TRANSLATIONS[key](ctx, node, list(args), dict(kwargs))
    blob = b.serialize()
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_bytes(blob)
    return blob
