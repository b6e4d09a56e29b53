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

The other ReID backbones (ResNet, MobileNetV2, LMBN, MLFN, CSPReID, HACNN)
and the yololite predictor's ``LiteNet`` carry the Flax modules' names, so
``backbone_state_dict_from_flax`` (one function for every family) and
``yololite_state_dict_from_flax`` walk the Flax tree leaf by leaf
(``_flax_leaves``): HWIO kernels become OIHW, dense kernels are transposed,
LayerNorm and BatchNorm scales and biases become ``weight`` and ``bias``,
batch statistics ``running_mean`` and ``running_var``; LMBN's OSNet blocks
map to the port's torchreid names and LiteNet's auto-named modules to the
port's.  Checkpoints of those backbones have no converter, in either
package (``convert_checkpoint`` raises the JAX package's ``ValueError``).
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
    module (float32 tensors), every key checked against the module's.  Only
    OSNet checkpoints convert, as in the JAX package (convert.py:111-124):
    any other backbone raises its ``ValueError``; CLIP's converter is not
    ported yet."""
    if model_name.startswith("clip"):
        raise NotImplementedError(
            f"no PyTorch backbone for {model_name!r} yet: CLIP-ReID and its converter are ROADMAP "
            "Queue A item 16")
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


# Flax leaf name -> PyTorch parameter or buffer name
_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flax_leaves(variables, rename) -> dict:
    """Every leaf of Flax ``{"params", "batch_stats"}`` (numpy arrays) under
    the PyTorch key ``rename(module path) + "." + leaf``: HWIO kernels
    become OIHW, a dense (in, out) kernel (out, in), LayerNorm and BatchNorm
    scales ``weight``, batch statistics ``running_mean`` / ``running_var``."""
    sd = {}

    def walk(tree, path, leaves):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, (*path, k), leaves)
                continue
            a = np.asarray(v)
            if k == "kernel":
                a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
            sd[f"{rename(path)}.{leaves[k]}"] = a

    walk(variables["params"], (), _PARAM_LEAVES)
    walk(variables.get("batch_stats", {}), (), _STAT_LEAVES)
    return sd


def _state_dict_for(model: torch.nn.Module, sd: dict) -> dict:
    """``sd`` checked key by key against ``model``'s state dict, as float32
    tensors; a batch norm that Flax built without a bias
    (``use_bias=False``, a BNNeck) gets PyTorch's bias at 0."""
    for prefix, module in model.named_modules():
        if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
            sd.setdefault(f"{prefix}.bias", np.zeros(module.num_features, np.float32))
    expected = {k for k in model.state_dict() if "num_batches_tracked" not in k}
    unused = sorted(set(sd) - expected)
    if unused:
        raise ValueError(f"unmapped Flax variables: {unused[:8]}...")
    missing = sorted(expected - set(sd))
    if missing:
        raise ValueError(f"the Flax variables lack keys of {type(model).__name__}: "
                         f"{missing[:8]}...")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _dotted(path) -> str:
    return ".".join(path)


# an OSBlock's Flax names -> the port's torchreid names: the streams
# conv2_{t}_{u} (conv2a, conv2b.u, ...), OSBlockINin's bare conv3 and its in3,
# and the stem's instance norm ``in`` (``bn`` in the port's ConvLayer)
_OS_STREAMS = {"1": "conv2a", "2": "conv2b", "3": "conv2c", "4": "conv2d"}


def _osnet_path(path) -> str:
    out = []
    for i, seg in enumerate(path):
        m = re.fullmatch(r"conv2_([1-4])_(\d)", seg)
        if m:
            out.append(_OS_STREAMS[m[1]] + ("" if m[1] == "1" else f".{m[2]}"))
        elif seg == "in3":
            out.append("IN")
        elif seg == "in":
            out.append("bn")
        elif seg == "conv3" and i == len(path) - 1:
            out.append("conv3.conv")  # OSBlockINin's conv3 is a bare convolution
        else:
            out.append(seg)
    return ".".join(out)


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


def backbone_state_dict_from_flax(variables, name: str) -> dict:
    """The JAX package's Flax variables of ReID backbone ``name`` (ResNet,
    MobileNetV2, LMBN, MLFN, CSPReID or HACNN; numpy arrays) as the state
    dict of the port's module, checked key by key.  The port's modules carry
    the Flax names, but for LMBN's OSNet blocks (torchreid names)."""
    from boxmot_tpu_torch.reid.core import build_model  # noqa: PLC0415

    rename = _osnet_path if name.startswith("lmbn") else _dotted
    return _state_dict_for(build_model(name), _flax_leaves(variables, rename))


def yololite_state_dict_from_flax(variables, task: str, nc: int = 3) -> dict:
    """The JAX ``LiteYOLO``'s Flax variables (``model.variables`` as numpy
    arrays) of head ``task`` with ``nc`` classes as the state dict of the
    port's ``LiteNet`` (for ``LiteYOLO(...).model.load_state_dict``)."""
    from boxmot_tpu_torch.detectors.yolo_lite import LiteNet  # noqa: PLC0415

    names = {**_LITE_COMMON, **_LITE_HEADS[task]}
    inner = {"Conv_0": "conv", "LayerNorm_0": "norm"}

    def rename(path):
        return ".".join([names[path[0]], *(inner[p] for p in path[1:])])

    return _state_dict_for(LiteNet(task, nc), _flax_leaves(variables, rename))
