"""ReID, YOLOX and yololite weights: torchreid and yolox checkpoints, and
the JAX package's Flax variables.

Counterpart of the OSNet part of ``boxmot_tpu/models/convert.py``.  The
port's ``OSNet`` modules carry torchreid's attribute names, so a torchreid
checkpoint needs no key mapping, only the key rules of the JAX loader
(``load_state_dict``, convert.py:24-43; ``_finish``, :205-215): the
``module.`` and ``model.`` prefixes go, a ``state_dict`` (or a ``model``
dict) is unwrapped, ``classifier*`` and ``num_batches_tracked`` keys are
ignored, and any other key the model lacks raises.

``osnet_state_dict_from_flax`` carries the JAX package's Flax
``{"params", "batch_stats"}`` tree (as numpy arrays) into the port's state
dict: a copy of ``_Exporter`` and of ``export_osnet_state_dict`` /
``export_osnet_ain_state_dict`` (convert.py:385-502), with no JAX import.

YOLOX (counterpart of ``boxmot_tpu/models/yolox.py::convert_yolox``, :308,
and ``export_yolox``, :329): the port's ``YOLOX`` modules carry the yolox
checkpoint's key names, so ``load_yolox`` only applies the JAX loader's key
rules (a ``{"model": sd}`` wrapper and the ``model.`` prefix go,
``num_batches_tracked`` is ignored, a key outside ``yolox_key_spec`` raises)
and ``yolox_state_dict_from_flax`` is a JAX-free copy of ``export_yolox``
over the Flax variables as numpy trees.

The other ReID backbones (ResNet, MobileNetV2, LMBN, MLFN, CSPReID, HACNN,
ViT, CSL-TinyViT, CLIP) carry the Flax modules' names but for LMBN's OSNet
blocks (torchreid names).  ``flax_paths`` gives each port parameter and
batch statistic its Flax path, and ``backbone_state_dict_from_flax``
fills a model's state dict through it (``state_dict_from_flax_paths``):
HWIO kernels become OIHW, dense kernels are transposed, LayerNorm and
BatchNorm scales and biases become ``weight`` and ``bias``, batch
statistics ``running_mean`` and ``running_var``.  The trainer keys its
optimizer masks by the same paths, and ``reid/exporters.py`` writes Flax
checkpoints through them.  The yololite predictor's ``LiteNet`` has
auto-named Flax modules: ``yololite_state_dict_from_flax`` goes through the
same two functions with a ``rename`` of its module paths.  Checkpoints of
those backbones but CLIP have no converter, in either package
(``convert_checkpoint`` raises the JAX package's ``ValueError``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from boxmot_tpu_torch.models.osnet import AIN_BLOCKS, OSNET_VARIANTS, build_osnet
from boxmot_tpu_torch.models.yolox import yolox_key_spec

BLOCKS = (2, 2, 2)  # OSBlocks a stage in every torchreid OSNet


def load_state_dict(path_or_dict) -> dict:
    """A checkpoint as {key: np.ndarray} with normalized keys."""
    if isinstance(path_or_dict, dict):
        sd = path_or_dict
    else:
        ckpt = torch.load(path_or_dict, map_location="cpu", weights_only=False)
        sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
        sd = dict(sd.items())
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.").removeprefix("model.")
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def convert_checkpoint(path_or_dict, model_name: str) -> dict:
    """A torchreid checkpoint as the state dict of the port's ``model_name``
    module (float32 tensors), every key checked against the module's.  OSNet
    and CLIP checkpoints convert, as in the JAX package (convert.py:111-124;
    CLIP through ``convert_clip``, its image encoder at 256 x 128): any
    other backbone raises its ``ValueError``."""
    if model_name.startswith("clip"):
        return convert_clip(path_or_dict)["visual"]
    if model_name not in OSNET_VARIANTS:
        raise ValueError(
            f"no checkpoint converter for {model_name!r}; convert the weights "
            "offline or train with boxmot_tpu.reid.training")
    sd = {k: v for k, v in load_state_dict(path_or_dict).items()
          if not k.startswith("classifier") and "num_batches_tracked" not in k}
    expected = {k for k in build_osnet(model_name).state_dict() if "num_batches_tracked" not in k}
    unused = sorted(set(sd) - expected)
    if unused:
        raise ValueError(f"unmapped checkpoint keys: {unused[:8]}...")
    missing = sorted(expected - set(sd))
    if missing:
        raise ValueError(f"checkpoint lacks keys of {model_name}: {missing[:8]}...")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def load_weights(model: torch.nn.Module, state_dict: dict) -> None:
    """Load ``convert_checkpoint``'s state dict: every key but the batch
    norms' ``num_batches_tracked`` counters, which inference never reads."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if "num_batches_tracked" not in k]
    if missing or unexpected:
        raise ValueError(f"state dict does not fit the model: missing {missing[:8]}, "
                         f"unexpected {unexpected[:8]}")


class _Exporter:
    """Flax variables -> torchreid keys (boxmot_tpu/models/convert.py:385-431)."""

    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables["batch_stats"]
        self.sd = {}

    def conv(self, fnode, tk):
        self.sd[f"{tk}.weight"] = np.transpose(np.asarray(fnode["kernel"]), (3, 2, 0, 1))
        if "bias" in fnode:
            self.sd[f"{tk}.bias"] = np.asarray(fnode["bias"])

    def bn(self, pnode, snode, tk):
        self.sd[f"{tk}.weight"] = np.asarray(pnode["scale"])
        self.sd[f"{tk}.bias"] = np.asarray(pnode["bias"])
        self.sd[f"{tk}.running_mean"] = np.asarray(snode["mean"])
        self.sd[f"{tk}.running_var"] = np.asarray(snode["var"])

    def inorm(self, pnode, tk):
        self.sd[f"{tk}.weight"] = np.asarray(pnode["scale"])
        self.sd[f"{tk}.bias"] = np.asarray(pnode["bias"])

    def conv_bn(self, fname, tk):
        self.conv(self.params[fname]["conv"], f"{tk}.conv")
        self.bn(self.params[fname]["bn"], self.stats[fname]["bn"], f"{tk}.bn")

    def conv_in(self, fname, tk):
        self.conv(self.params[fname]["conv"], f"{tk}.conv")
        self.inorm(self.params[fname]["in"], f"{tk}.bn")

    def nested_conv_bn(self, fb, sub, tk):
        self.conv(self.params[fb][sub]["conv"], f"{tk}.conv")
        self.bn(self.params[fb][sub]["bn"], self.stats[fb][sub]["bn"], f"{tk}.bn")

    def light_conv(self, fb, sub, tk):
        node, snode = self.params[fb][sub], self.stats[fb][sub]
        self.conv(node["conv1"], f"{tk}.conv1")
        self.conv(node["conv2"], f"{tk}.conv2")
        self.bn(node["bn"], snode["bn"], f"{tk}.bn")

    def fc(self):
        self.sd["fc.0.weight"] = np.asarray(self.params["fc"]["kernel"]).T
        self.sd["fc.0.bias"] = np.asarray(self.params["fc"]["bias"])
        self.bn(self.params["fc_bn"], self.stats["fc_bn"], "fc.1")


def _export_osnet(variables, ibn: bool) -> dict:
    """export_osnet_state_dict (convert.py:433-465)."""
    e = _Exporter(variables)
    params = e.params
    if ibn:
        e.conv_in("conv1", "conv1")
    else:
        e.conv_bn("conv1", "conv1")
    stream = {1: "conv2a", 2: "conv2b", 3: "conv2c", 4: "conv2d"}
    for s in range(3):
        tstage = f"conv{s + 2}"
        for b in range(BLOCKS[s]):
            fb, tb = f"{tstage}_{b}", f"{tstage}.{b}"
            e.nested_conv_bn(fb, "conv1", f"{tb}.conv1")
            for t in range(1, 5):
                for u in range(t):
                    tk = f"{tb}.{stream[t]}" if t == 1 else f"{tb}.{stream[t]}.{u}"
                    e.light_conv(fb, f"conv2_{t}_{u}", tk)
            e.conv(params[fb]["gate"]["fc1"], f"{tb}.gate.fc1")
            e.conv(params[fb]["gate"]["fc2"], f"{tb}.gate.fc2")
            e.nested_conv_bn(fb, "conv3", f"{tb}.conv3")
            if "downsample" in params[fb]:
                e.nested_conv_bn(fb, "downsample", f"{tb}.downsample")
            if ibn and s == 0:
                e.inorm(params[fb]["ibn"], f"{tb}.IN")
        if s < 2:
            e.conv_bn(f"transition{s + 2}", f"{tstage}.{BLOCKS[s]}.0")
    e.conv_bn("conv5", "conv5")
    e.fc()
    return e.sd


def _export_osnet_ain(variables) -> dict:
    """export_osnet_ain_state_dict (convert.py:468-502)."""
    e = _Exporter(variables)
    params = e.params
    e.conv_in("conv1", "conv1")
    for s in range(3):
        tstage = f"conv{s + 2}"
        for b in range(BLOCKS[s]):
            fb, tb = f"{tstage}_{b}", f"{tstage}.{b}"
            e.nested_conv_bn(fb, "conv1", f"{tb}.conv1")
            for t in range(1, 5):
                for u in range(t):
                    e.light_conv(fb, f"conv2_{t}_{u}", f"{tb}.conv2.{t - 1}.layers.{u}")
            e.conv(params[fb]["gate"]["fc1"], f"{tb}.gate.fc1")
            e.conv(params[fb]["gate"]["fc2"], f"{tb}.gate.fc2")
            if AIN_BLOCKS[s][b] == "in":
                e.conv(params[fb]["conv3"], f"{tb}.conv3.conv")
                e.inorm(params[fb]["in3"], f"{tb}.IN")
            else:
                e.nested_conv_bn(fb, "conv3", f"{tb}.conv3")
            if "downsample" in params[fb]:
                e.nested_conv_bn(fb, "downsample", f"{tb}.downsample")
        if s < 2:
            e.conv_bn(f"transition{s + 2}", f"pool{s + 2}.0")
    e.conv_bn("conv5", "conv5")
    e.fc()
    return e.sd


def osnet_state_dict_from_flax(variables, name: str) -> dict:
    """The JAX package's Flax variables of OSNet variant ``name`` (numpy
    arrays) as the state dict of the port's module, checked key by key."""
    if name.startswith("osnet_ain"):
        sd = _export_osnet_ain(variables)
    else:
        sd = _export_osnet(variables, ibn=name.startswith("osnet_ibn"))
    return convert_checkpoint(sd, name)


def _yolox_keys(name: str) -> set:
    """Every checkpoint key ``yolox_key_spec(name)`` names (the predictions'
    convolutions carry a bias, the others none)."""
    keys = set()
    for tk, _, kind in yolox_key_spec(name):
        if kind == "bn":
            keys |= {f"{tk}.{k}" for k in ("weight", "bias", "running_mean", "running_var")}
        else:
            keys.add(f"{tk}.weight")
            if "_preds." in tk:
                keys.add(f"{tk}.bias")
    return keys


def load_yolox(path_or_dict, name: str = "yolox_x") -> dict:
    """A yolox torch checkpoint (``{"model": state_dict}``, or the state dict
    itself; a path or a dict) as the state dict of the port's
    ``build_yolox(name)`` (float32 tensors), for ``load_state_dict(strict=
    True)``.  Keys the model lacks raise, as in ``convert_yolox`` (:323-325),
    and so do keys the checkpoint lacks."""
    sd = {k: v for k, v in load_state_dict(path_or_dict).items()
          if "num_batches_tracked" not in k}
    expected = _yolox_keys(name)
    unused = sorted(set(sd) - expected)
    if unused:
        raise ValueError(f"unmapped yolox checkpoint keys: {unused[:8]}...")
    missing = sorted(expected - set(sd))
    if missing:
        raise ValueError(f"yolox checkpoint lacks keys of {name}: {missing[:8]}...")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def yolox_state_dict_from_flax(variables, name: str) -> dict:
    """The JAX package's Flax variables of YOLOX ``name`` (``{"params",
    "batch_stats"}`` of numpy arrays) as the port's state dict: a copy of
    ``export_yolox`` (Flax HWIO kernels -> OIHW) checked by ``load_yolox``."""
    params, stats = variables["params"], variables["batch_stats"]

    def get(tree, path):
        for p in path:
            tree = tree[p]
        return tree

    sd = {}
    for tk, fpath, kind in yolox_key_spec(name):
        if kind == "bn":
            node, snode = get(params, fpath), get(stats, fpath)
            sd[f"{tk}.weight"] = np.asarray(node["scale"])
            sd[f"{tk}.bias"] = np.asarray(node["bias"])
            sd[f"{tk}.running_mean"] = np.asarray(snode["mean"])
            sd[f"{tk}.running_var"] = np.asarray(snode["var"])
        else:
            node = get(params, fpath)
            sd[f"{tk}.weight"] = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))
            if "bias" in node:
                sd[f"{tk}.bias"] = np.asarray(node["bias"])
    return load_yolox(sd, name)


# ---------------------------------------------------------------------------
# The inverse: each port parameter's Flax path
# ---------------------------------------------------------------------------

_NORMS = (torch.nn.LayerNorm, torch.nn.modules.batchnorm._BatchNorm, torch.nn.GroupNorm,
          torch.nn.modules.instancenorm._InstanceNorm)
_STREAM_T = {"conv2a": 1, "conv2b": 2, "conv2c": 3, "conv2d": 4}


def _torchreid_segments(model: torch.nn.Module, segs: list[str]) -> tuple[list[str], object]:
    """The Flax module path of the port's torchreid-named module path
    ``segs`` (OSNet, and LMBN's OSNet blocks), and the module it names: the
    inverse of ``_export_osnet`` / ``_export_osnet_ain``."""
    from boxmot_tpu_torch.models.osnet import OSBlock  # noqa: PLC0415

    out, mod, i = [], model, 0
    while i < len(segs):
        s = segs[i]
        child = mod[int(s)] if s.isdigit() else getattr(mod, s)
        nxt = segs[i + 1] if i + 1 < len(segs) else None
        if isinstance(child, torch.nn.Sequential) and nxt is not None and nxt.isdigit() \
                and re.fullmatch(r"conv[2-4]", s):  # OSNet's stage: blocks, then a transition
            block = child[int(nxt)]
            if isinstance(block, OSBlock):
                out.append(f"{s}_{nxt}")
                mod, i = block, i + 2
            else:
                out.append(f"transition{s[-1]}")
                mod, i = block[0], i + 3
        elif re.fullmatch(r"pool[23]", s):  # OSNet-AIN's transition
            out.append(f"transition{s[-1]}")
            mod, i = child[0], i + 2
        elif s == "fc" and isinstance(child, torch.nn.Sequential):
            out.append({"0": "fc", "1": "fc_bn"}[nxt])
            mod, i = child[int(nxt)], i + 2
        elif s in _STREAM_T:
            t = _STREAM_T[s]
            out.append(f"conv2_{t}_{0 if t == 1 else nxt}")
            mod, i = (child, i + 1) if t == 1 else (child[int(nxt)], i + 2)
        elif s == "conv2" and isinstance(child, torch.nn.ModuleList):  # AIN streams
            u = segs[i + 3]
            out.append(f"conv2_{int(nxt) + 1}_{u}")
            mod, i = child[int(nxt)].layers[int(u)], i + 4
        elif s == "IN":
            out.append("in3" if mod.in_inside else "ibn")
            mod, i = child, i + 1
        elif s == "conv3" and getattr(child, "bn", True) is None:  # OSBlockINin's bare conv
            out.append("conv3")
            mod, i = child.conv, i + 2
        elif s == "bn" and isinstance(child, torch.nn.modules.instancenorm._InstanceNorm):
            out.append("in")
            mod, i = child, i + 1
        else:
            out.append(s)
            mod, i = child, i + 1
    return out, mod


def flax_paths(model: torch.nn.Module, name: str, rename=None) -> dict:
    """Every entry of ``model``'s state dict that has a Flax counterpart ->
    (collection, *Flax path): ``("params", "block0", "attn", "qkv",
    "kernel")``, ``("batch_stats", ..., "mean")``.  Convolution and linear
    weights are ``kernel``, norm weights ``scale``, running statistics
    ``mean`` / ``var``; other parameters keep their names.  A bias-free
    batch norm's zero bias (a buffer) and ``num_batches_tracked`` have none.
    ``name`` is the backbone's model name; OSNet's and LMBN's torchreid
    names map back through ``_torchreid_segments`` wherever they sit in
    ``model`` (a backbone alone or under a trainer's ``backbone.``).
    ``rename``, where given, maps a module's path (a list of its names'
    segments) to its Flax module path instead."""
    torchreid = name.startswith(("osnet", "lmbn"))
    out = {}
    for mname, module in model.named_modules():
        own = [n for n, _ in module.named_parameters(recurse=False)]
        stats = [n for n, _ in module.named_buffers(recurse=False)
                 if n in ("running_mean", "running_var")]
        if not own and not stats:
            continue
        segs = mname.split(".") if mname else []
        if rename is not None:
            fpath = rename(segs)
        elif torchreid and segs and segs[0] == "backbone":
            inner, _ = _torchreid_segments(model.get_submodule("backbone"), segs[1:])
            fpath = ["backbone", *inner]
        elif torchreid and segs and not hasattr(model, "backbone"):
            fpath, _ = _torchreid_segments(model, segs)
        else:
            fpath = segs
        for pname in own:
            leaf = pname
            if pname == "weight" and isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
                leaf = "kernel"
            elif pname == "weight" and isinstance(module, _NORMS):
                leaf = "scale"
            out[f"{mname}.{pname}" if mname else pname] = ("params", *fpath, leaf)
        for bname in stats:
            out[f"{mname}.{bname}"] = ("batch_stats", *fpath, bname.removeprefix("running_"))
    return out


def state_dict_from_flax_paths(model: torch.nn.Module, name: str, variables,
                               rename=None) -> dict:
    """Flax ``{"params", "batch_stats"}`` (numpy) as ``model``'s state dict
    through ``flax_paths`` (``rename`` as there): HWIO kernels to OIHW,
    dense kernels transposed; a bias-free batch norm's bias stays 0.  Every
    Flax leaf must be used."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    used = set()
    for key, (coll, *path) in flax_paths(model, name, rename).items():
        node = variables.get(coll, {})
        for p in path:
            if p not in node:
                raise ValueError(f"the Flax variables lack {coll}/{'/'.join(path)} of "
                                 f"{type(model).__name__} ({key})")
            node = node[p]
        a = np.asarray(node, np.float32)
        if path[-1] == "kernel":
            a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
        if tuple(a.shape) != tuple(sd[key].shape):
            raise ValueError(f"{key}: Flax {'/'.join(path)} has shape {a.shape}, the port "
                             f"{tuple(sd[key].shape)}")
        sd[key] = torch.from_numpy(np.array(a))
        used.add((coll, *path))
    leaves = set()

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, (*path, k))
            else:
                leaves.add((*path, k))

    for coll in ("params", "batch_stats"):
        walk({coll: variables.get(coll, {})}, ())
    unused = sorted("/".join(p) for p in leaves - used)
    if unused:
        raise ValueError(f"unmapped Flax variables: {unused[:8]}...")
    return sd


def backbone_state_dict_from_flax(variables, name: str, crop_hw=(256, 128),
                                  model: torch.nn.Module | None = None) -> dict:
    """The JAX package's Flax variables of ReID backbone ``name`` (numpy
    arrays) as the state dict of ``model`` (by default ``build_model(name,
    crop_hw)``: the ViTs' and CLIP's positional embeddings are sized from
    the crop; pass the model for another size, e.g. a narrow ``ClipReID``
    or a ``ClipTextEncoder``)."""
    from boxmot_tpu_torch.reid.core import build_model  # noqa: PLC0415

    model = build_model(name, crop_hw) if model is None else model
    return state_dict_from_flax_paths(model, name, variables)


# LiteNet's Flax module names per task (auto-named in creation order) -> the port's
_LITE_COMMON = {"ConvBNSiLU_0": "stem.0", "ConvBNSiLU_1": "stem.1", "ConvBNSiLU_2": "stem.2",
                "ConvBNSiLU_3": "stem.3", "ConvBNSiLU_4": "neck", "ConvBNSiLU_5": "box_stem",
                "Conv_0": "box", "ConvBNSiLU_6": "cls_stem", "Conv_1": "cls"}
_LITE_HEADS = {
    "detect": {},
    "obb": {"ConvBNSiLU_7": "angle_stem", "Conv_2": "angle"},
    "segment": {"ConvBNSiLU_7": "proto_stem", "Conv_2": "proto", "ConvBNSiLU_8": "coef_stem",
                "Conv_3": "coef"},
    "pose": {"ConvBNSiLU_7": "kpt_stem", "Conv_2": "kpt"},
}


def yololite_state_dict_from_flax(variables, task: str, nc: int = 3) -> dict:
    """The JAX ``LiteYOLO``'s Flax variables (``model.variables`` as numpy
    arrays) of head ``task`` with ``nc`` classes as the state dict of the
    port's ``LiteNet`` (for ``LiteYOLO(...).model.load_state_dict``)."""
    from boxmot_tpu_torch.detectors.yolo_lite import LiteNet  # noqa: PLC0415

    flax_of = {port: flax for flax, port in {**_LITE_COMMON, **_LITE_HEADS[task]}.items()}
    inner = {"conv": "Conv_0", "norm": "LayerNorm_0"}

    def rename(segs):
        head = 2 if segs[0] == "stem" else 1  # stem.<i>, or a head's own name
        return [flax_of[".".join(segs[:head])], *(inner[s] for s in segs[head:])]

    return state_dict_from_flax_paths(LiteNet(task, nc), "yololite", variables, rename)


# ---------------------------------------------------------------------------
# CLIP (ViT text and image towers): boxmot_tpu/models/convert.py:223-380
# ---------------------------------------------------------------------------


def _resample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(..., "bilinear")`` along one
    axis (``scale_and_translate``'s ``compute_weight_mat``, antialiased): a
    triangle kernel at the output's half-pixel sample points, widened by
    n_in / n_out when shrinking, each column normalized, columns whose
    sample lies outside the input zeroed.  Float32, as JAX computes it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # JAX: 1. / scale of Python floats
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize_clip_pos_embed(pos, gh: int, gw: int) -> np.ndarray:
    """A ViT positional embedding's square grid resampled to (gh, gw), the CLS
    row kept.  JAX resizes with ``jax.image.resize(..., "bilinear")``, which
    antialiases when it shrinks (14 -> 8 columns from ViT-B/16's grid to 16 x
    8), unlike ``F.interpolate(align_corners=False)``; this applies the same
    triangle-filter matrices (``_resample_matrix``), one axis at a time."""
    pos = np.asarray(pos, np.float32)
    cls_row, grid = pos[:1], pos[1:]
    gs = round(len(grid) ** 0.5)
    if gs * gs != len(grid):
        raise ValueError(f"non-square source grid: {len(grid)} positions")
    if (gs, gs) != (gh, gw):
        g = grid.reshape(gs, gs, -1).astype(np.float64)
        g = np.einsum("hwc,hH->Hwc", g, _resample_matrix(gs, gh).astype(np.float64))
        g = np.einsum("Hwc,wW->HWc", g, _resample_matrix(gs, gw).astype(np.float64))
        grid = g.astype(np.float32)
    return np.concatenate([cls_row, grid.reshape(gh * gw, -1)], axis=0)


def _set(tree: dict, path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


class _ClipMapper:
    """torch keys -> the Flax tree of ``ClipReID`` / ``ClipTextEncoder``, with
    a record of the keys used (the JAX ``_Mapper``'s CLIP half)."""

    def __init__(self, sd):
        self.sd, self.params, self.batch_stats, self.used = sd, {}, {}, set()

    def take(self, key, path, tree=None, value=None):
        self.used.add(key)
        _set(self.params if tree is None else tree, path,
             self.sd[key] if value is None else value)

    def dense(self, tk, path):
        self.take(f"{tk}.weight", (*path, "kernel"), value=self.sd[f"{tk}.weight"].T)
        if f"{tk}.bias" in self.sd:
            self.take(f"{tk}.bias", (*path, "bias"))

    def norm(self, tk, path):
        self.take(f"{tk}.weight", (*path, "scale"))
        self.take(f"{tk}.bias", (*path, "bias"))

    def blocks(self, prefix, n_layers):
        """transformer.resblocks.{i} -> resblock{i}."""
        for i in range(n_layers):
            tb, fb = f"{prefix}transformer.resblocks.{i}", (f"resblock{i}",)
            self.norm(f"{tb}.ln_1", (*fb, "ln_1"))
            self.norm(f"{tb}.ln_2", (*fb, "ln_2"))
            self.take(f"{tb}.attn.in_proj_weight", (*fb, "qkv", "kernel"),
                      value=self.sd[f"{tb}.attn.in_proj_weight"].T)
            self.take(f"{tb}.attn.in_proj_bias", (*fb, "qkv", "bias"))
            self.dense(f"{tb}.attn.out_proj", (*fb, "out_proj"))
            self.dense(f"{tb}.mlp.c_fc", (*fb, "c_fc"))
            self.dense(f"{tb}.mlp.c_proj", (*fb, "c_proj"))


def _layers(sd, prefix: str, depth: int) -> int:
    return len({k.split(".")[depth] for k in sd if k.startswith(prefix)})


def convert_clip(path_or_dict, h_grid: int = 16, w_grid: int = 8) -> dict:
    """An OpenAI CLIP checkpoint, or a CLIP-ReID fine-tune, for the port.

    Key naming: OpenAI's (``visual.*``, ``transformer.*``) or CLIP-ReID's
    (``image_encoder.*``, ``text_encoder.*``, ``bottleneck*``,
    ``prompt_learner.cls_ctx``); the tower sizes come from the state dict,
    and the image positional embedding is resampled to the ReID patch grid
    (16 x 8 for 256 x 128 crops, ``_resize_clip_pos_embed``).  Returns::

        {"visual": state dict of ClipReID (float32 tensors),
         "visual_config": {"width", "layers", "heads", "proj_dim", "crop_hw"},
         "text": state dict of ClipTextEncoder,
         "text_config": {"width", "layers", "heads", "context", "proj_dim"},
         "token_embedding": (vocab, width) float32 array,
         "logit_scale": float,
         "prompt_cls_ctx": (identities, n_ctx, width) array or None}

    The JAX ``convert_clip`` returns the same weights as Flax trees; this
    builds those trees the same way, key for key (the ``_Mapper`` ledger:
    every key of the checkpoint must be used, but ``classifier*``,
    ``num_batches_tracked``, the BNNecks' zero biases and the prompt
    learner's template buffers), and carries them into the port's modules.
    Heads are 64 wide (at least one), as in every CLIP tower.
    """
    from boxmot_tpu_torch.models.clip_reid import ClipReID, ClipTextEncoder  # noqa: PLC0415

    sd = {}
    for k, v in load_state_dict(path_or_dict).items():
        k = k.removeprefix("text_encoder.")
        if k.startswith("image_encoder."):
            k = "visual." + k.removeprefix("image_encoder.")
        sd[k] = v
    for meta in ("input_resolution", "context_length", "vocab_size"):
        sd.pop(meta, None)
    if "visual.proj" not in sd:
        raise ValueError("only ViT CLIP checkpoints are supported (no RN50)")

    m = _ClipMapper(sd)
    m.take("visual.conv1.weight", ("conv1", "kernel"),
           value=np.transpose(sd["visual.conv1.weight"], (2, 3, 1, 0)))
    m.take("visual.class_embedding", ("class_embedding",))
    m.take("visual.proj", ("proj",))
    m.take("visual.positional_embedding", ("positional_embedding",),
           value=_resize_clip_pos_embed(sd["visual.positional_embedding"], h_grid, w_grid))
    m.norm("visual.ln_pre", ("ln_pre",))
    m.norm("visual.ln_post", ("ln_post",))
    v_layers = _layers(sd, "visual.transformer.resblocks", 3)
    m.blocks("visual.", v_layers)
    width, proj_dim = sd["visual.proj"].shape
    for neck, dim in (("bottleneck", width), ("bottleneck_proj", proj_dim)):
        if f"{neck}.weight" in sd:  # a CLIP-ReID fine-tune's BNNecks
            m.take(f"{neck}.weight", (neck, "scale"))
            m.take(f"{neck}.running_mean", (neck, "mean"), m.batch_stats)
            m.take(f"{neck}.running_var", (neck, "var"), m.batch_stats)
            m.used.add(f"{neck}.bias")  # zeros; the neck is bias-free
        else:
            _set(m.params, (neck, "scale"), np.ones(dim, np.float32))
            _set(m.batch_stats, (neck, "mean"), np.zeros(dim, np.float32))
            _set(m.batch_stats, (neck, "var"), np.ones(dim, np.float32))
    visual_config = {"width": int(width), "layers": v_layers, "heads": max(1, int(width) // 64),
                     "proj_dim": int(proj_dim),
                     "crop_hw": (h_grid * sd["visual.conv1.weight"].shape[-2],
                                 w_grid * sd["visual.conv1.weight"].shape[-1])}
    visual = backbone_state_dict_from_flax(
        {"params": m.params, "batch_stats": m.batch_stats}, "clip",
        model=ClipReID(**visual_config))

    mt = _ClipMapper(sd)
    mt.used = m.used  # one ledger for both towers
    t_layers = _layers(sd, "transformer.resblocks", 2)
    mt.blocks("", t_layers)
    mt.take("positional_embedding", ("positional_embedding",))
    mt.take("text_projection", ("text_projection",))
    mt.norm("ln_final", ("ln_final",))
    t_width = sd["ln_final.weight"].shape[0]
    text_config = {"width": int(t_width), "layers": t_layers, "heads": max(1, int(t_width) // 64),
                   "context": int(sd["positional_embedding"].shape[0]),
                   "proj_dim": int(sd["text_projection"].shape[1])}
    text = backbone_state_dict_from_flax({"params": mt.params}, "clip",
                                         model=ClipTextEncoder(**text_config))
    mt.used |= {"token_embedding.weight", "logit_scale"}
    out = {"visual": visual, "visual_config": visual_config, "text": text,
           "text_config": text_config,
           "token_embedding": np.asarray(sd["token_embedding.weight"], np.float32),
           "logit_scale": float(np.asarray(sd.get("logit_scale", 0.0))),
           "prompt_cls_ctx": None}
    if "prompt_learner.cls_ctx" in sd:
        mt.used.add("prompt_learner.cls_ctx")
        out["prompt_cls_ctx"] = np.asarray(sd["prompt_learner.cls_ctx"], np.float32)
        # the template buffers are recomputed from the tokenizer
        mt.used.update(k for k in sd if k.startswith("prompt_learner.token_"))
    unused = [k for k in sd if k not in mt.used and not k.startswith("classifier")
              and "num_batches_tracked" not in k]
    if unused:
        raise ValueError(f"unmapped CLIP checkpoint keys: {unused[:8]}...")
    return out
