"""YOLOX (CSPDarknet + PAFPN + decoupled head) in PyTorch.

Counterpart of ``boxmot_tpu/models/yolox.py`` (the Flax ``YOLOX`` with
``BaseConv``, ``DWConv``, ``Bottleneck``, ``CSPLayer``, ``Focus`` and
``SPPBottleneck``, ``YOLOX_VARIANTS``, ``resolve_yolox_variant``,
``build_yolox`` and ``yolox_key_spec``), for all six variants, nano's
depthwise convolutions included.  Inference only: batch norms use their
running statistics (``eval()``), with the JAX package's epsilon of 1e-5
(Flax's default; public YOLOX's ``init_yolo`` sets 1e-3).

The modules carry the yolox package's attribute names, the keys of a yolox
torch checkpoint (``backbone.backbone.dark2.1.m.0.conv1.bn``,
``backbone.C3_p4``, ``head.stems.0``, ``head.cls_convs.0.1.dconv``, ...,
the ``_DARK`` map and ``yolox_key_spec``), so a checkpoint loads with
``load_state_dict(strict=True)`` (``models/convert.py::load_yolox``).

Layout: the module takes an NCHW batch; its output is the JAX model's raw
(B, N_anchors, 5 + C) head, [reg (4), obj, cls (C)] per anchor, the
stride-8 grid first and each level flattened row by row (y-major, then x),
as the Flax model's NHWC reshape lays it out and ``ops/nms.py::
yolox_decode`` reads it.  The convolutions and pools are PyTorch's (cuDNN
on the card), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (depth_mult, width_mult, depthwise), copied from boxmot_tpu/models/yolox.py:30-37
YOLOX_VARIANTS = {
    "yolox_nano": (0.33, 0.25, True),
    "yolox_tiny": (0.33, 0.375, False),
    "yolox_s": (0.33, 0.5, False),
    "yolox_m": (0.67, 0.75, False),
    "yolox_l": (1.0, 1.0, False),
    "yolox_x": (1.33, 1.25, False),
}
BN_EPS = 1e-5  # Flax nn.BatchNorm's default, which the JAX model keeps (yolox.py:58)


class BaseConv(nn.Module):
    """Convolution without bias, batch norm, SiLU."""

    def __init__(self, cin: int, cout: int, ks: int = 1, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ks, stride, (ks - 1) // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class DWConv(nn.Module):
    """Depthwise convolution then a pointwise one (``dconv``, ``pconv``)."""

    def __init__(self, cin: int, cout: int, ks: int = 3, stride: int = 1):
        super().__init__()
        self.dconv = BaseConv(cin, cin, ks, stride, groups=cin)
        self.pconv = BaseConv(cin, cout, 1)

    def forward(self, x):
        return self.pconv(self.dconv(x))


def _conv(depthwise: bool):
    return DWConv if depthwise else BaseConv


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = BaseConv(cin, hidden, 1)
        self.conv2 = _conv(depthwise)(hidden, cout, 3)
        self.use_add = shortcut and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.use_add else y


class CSPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = BaseConv(cin, hidden, 1)
        self.conv2 = BaseConv(cin, hidden, 1)
        self.conv3 = BaseConv(2 * hidden, cout, 1)
        self.m = nn.Sequential(*[Bottleneck(hidden, hidden, shortcut, 1.0, depthwise)
                                 for _ in range(n)])

    def forward(self, x):
        a = self.m(self.conv1(x))
        return self.conv3(torch.cat([a, self.conv2(x)], dim=1))


class Focus(nn.Module):
    """2 x 2 space-to-depth, channels [top-left, bottom-left, top-right,
    bottom-right] (yolox.py:118-123), then a convolution."""

    def __init__(self, cin: int, cout: int, ks: int = 3):
        super().__init__()
        self.conv = BaseConv(4 * cin, cout, ks)

    def forward(self, x):
        tl = x[..., ::2, ::2]
        bl = x[..., 1::2, ::2]
        tr = x[..., ::2, 1::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], dim=1))


class SPPBottleneck(nn.Module):
    """Max pools of 5, 9 and 13 at stride 1, padded with -inf (PyTorch's
    implicit padding of ``max_pool2d``, as Flax's ``max_pool``)."""

    def __init__(self, cin: int, cout: int, kernels=(5, 9, 13)):
        super().__init__()
        hidden = cin // 2
        self.conv1 = BaseConv(cin, hidden, 1)
        self.conv2 = BaseConv(hidden * (len(kernels) + 1), cout, 1)
        self.kernels = tuple(kernels)

    def forward(self, x):
        x = self.conv1(x)
        pools = [x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.kernels]
        return self.conv2(torch.cat(pools, dim=1))


def _up(t):
    """Nearest 2x upsampling as the JAX model's two ``repeat``s (yolox.py:171)."""
    return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class CSPDarknet(nn.Module):
    def __init__(self, w, d, depthwise: bool):
        super().__init__()
        Conv = _conv(depthwise)
        self.stem = Focus(3, w(64))
        self.dark2 = nn.Sequential(Conv(w(64), w(128), 3, 2),
                                   CSPLayer(w(128), w(128), d(3), depthwise=depthwise))
        self.dark3 = nn.Sequential(Conv(w(128), w(256), 3, 2),
                                   CSPLayer(w(256), w(256), d(9), depthwise=depthwise))
        self.dark4 = nn.Sequential(Conv(w(256), w(512), 3, 2),
                                   CSPLayer(w(512), w(512), d(9), depthwise=depthwise))
        self.dark5 = nn.Sequential(Conv(w(512), w(1024), 3, 2), SPPBottleneck(w(1024), w(1024)),
                                   CSPLayer(w(1024), w(1024), d(3), shortcut=False,
                                            depthwise=depthwise))

    def forward(self, x):
        x = self.dark2(self.stem(x))
        c3 = self.dark3(x)
        c4 = self.dark4(c3)
        return c3, c4, self.dark5(c4)


class PAFPN(nn.Module):
    def __init__(self, w, d, depthwise: bool):
        super().__init__()
        Conv = _conv(depthwise)
        self.backbone = CSPDarknet(w, d, depthwise)
        self.lateral_conv0 = BaseConv(w(1024), w(512), 1)
        self.C3_p4 = CSPLayer(2 * w(512), w(512), d(3), False, depthwise=depthwise)
        self.reduce_conv1 = BaseConv(w(512), w(256), 1)
        self.C3_p3 = CSPLayer(2 * w(256), w(256), d(3), False, depthwise=depthwise)
        self.bu_conv2 = Conv(w(256), w(256), 3, 2)
        self.C3_n3 = CSPLayer(2 * w(256), w(512), d(3), False, depthwise=depthwise)
        self.bu_conv1 = Conv(w(512), w(512), 3, 2)
        self.C3_n4 = CSPLayer(2 * w(512), w(1024), d(3), False, depthwise=depthwise)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        lat5 = self.lateral_conv0(c5)
        p4 = self.C3_p4(torch.cat([_up(lat5), c4], dim=1))
        lat4 = self.reduce_conv1(p4)
        p3 = self.C3_p3(torch.cat([_up(lat4), c3], dim=1))
        n3 = self.C3_n3(torch.cat([self.bu_conv2(p3), lat4], dim=1))
        n4 = self.C3_n4(torch.cat([self.bu_conv1(n3), lat5], dim=1))
        return p3, n3, n4


class YOLOXHead(nn.Module):
    """The decoupled head over strides (8, 16, 32)."""

    def __init__(self, w, depthwise: bool, num_classes: int):
        super().__init__()
        Conv = _conv(depthwise)
        hw = w(256)
        ins = (w(256), w(512), w(1024))
        self.num_classes = num_classes
        self.stems = nn.ModuleList(BaseConv(c, hw, 1) for c in ins)
        self.cls_convs = nn.ModuleList(nn.Sequential(Conv(hw, hw, 3), Conv(hw, hw, 3))
                                       for _ in ins)
        self.reg_convs = nn.ModuleList(nn.Sequential(Conv(hw, hw, 3), Conv(hw, hw, 3))
                                       for _ in ins)
        self.cls_preds = nn.ModuleList(nn.Conv2d(hw, num_classes, 1) for _ in ins)
        self.reg_preds = nn.ModuleList(nn.Conv2d(hw, 4, 1) for _ in ins)
        self.obj_preds = nn.ModuleList(nn.Conv2d(hw, 1, 1) for _ in ins)

    def forward(self, feats):
        outputs = []
        for lvl, feat in enumerate(feats):
            y = self.stems[lvl](feat)
            cls = self.cls_convs[lvl](y)
            reg = self.reg_convs[lvl](y)
            out = torch.cat([self.reg_preds[lvl](reg), self.obj_preds[lvl](reg),
                             self.cls_preds[lvl](cls)], dim=1)
            # NCHW -> (B, H * W, 5 + C), rows y-major then x, as the NHWC reshape
            outputs.append(out.permute(0, 2, 3, 1).reshape(out.shape[0], -1,
                                                           5 + self.num_classes))
        return torch.cat(outputs, dim=1)


class YOLOX(nn.Module):
    def __init__(self, depth: float = 1.33, width: float = 1.25, depthwise: bool = False,
                 num_classes: int = 1):
        super().__init__()
        w = lambda c: int(c * width)  # noqa: E731
        d = lambda n: max(round(n * depth), 1)  # noqa: E731
        self.num_classes = num_classes
        self.backbone = PAFPN(w, d, depthwise)
        self.head = YOLOXHead(w, depthwise, num_classes)

    def forward(self, x):
        """(B, 3, H, W) standardized RGB -> raw head (B, N_anchors, 5 + C)."""
        return self.head(self.backbone(x))


def resolve_yolox_variant(name: str) -> str:
    """Strip benchmark suffixes (yolox_x_MOT17_ablation -> yolox_x), as
    ``boxmot_tpu/models/yolox.py::resolve_yolox_variant`` (:210)."""
    base = name
    for suffix in ("_mot17", "_mot20", "_dancetrack", "_visdrone", "_ablation"):
        if suffix in base.lower():
            base = base[: base.lower().index(suffix)]
    if base == "yolox_n":
        base = "yolox_nano"
    if base not in YOLOX_VARIANTS:
        raise ValueError(f"unknown YOLOX variant {name!r}; available: {sorted(YOLOX_VARIANTS)}")
    return base


def build_yolox(name: str, num_classes: int = 1) -> YOLOX:
    depth, width, dw = YOLOX_VARIANTS[resolve_yolox_variant(name)]
    return YOLOX(depth=depth, width=width, depthwise=dw, num_classes=num_classes)


# the Flax module name -> (yolox checkpoint prefix, _), copied from
# boxmot_tpu/models/yolox.py:235-254
_DARK = {
    "stem": ("backbone.backbone.stem.conv", "conv"),
    "dark2_conv": ("backbone.backbone.dark2.0", None),
    "dark2_csp": ("backbone.backbone.dark2.1", None),
    "dark3_conv": ("backbone.backbone.dark3.0", None),
    "dark3_csp": ("backbone.backbone.dark3.1", None),
    "dark4_conv": ("backbone.backbone.dark4.0", None),
    "dark4_csp": ("backbone.backbone.dark4.1", None),
    "dark5_conv": ("backbone.backbone.dark5.0", None),
    "dark5_spp": ("backbone.backbone.dark5.1", None),
    "dark5_csp": ("backbone.backbone.dark5.2", None),
    "lateral_conv0": ("backbone.lateral_conv0", None),
    "C3_p4": ("backbone.C3_p4", None),
    "reduce_conv1": ("backbone.reduce_conv1", None),
    "C3_p3": ("backbone.C3_p3", None),
    "bu_conv2": ("backbone.bu_conv2", None),
    "C3_n3": ("backbone.C3_n3", None),
    "bu_conv1": ("backbone.bu_conv1", None),
    "C3_n4": ("backbone.C3_n4", None),
}


def yolox_key_spec(name: str):
    """(checkpoint key prefix, Flax path, kind) of every weight tensor of
    ``build_yolox(name)``, kind "conv" (weight, and a bias for the
    predictions) or "bn": a copy of ``boxmot_tpu/models/yolox.py::
    yolox_key_spec`` (:257-305)."""
    depth, _, dw = YOLOX_VARIANTS[resolve_yolox_variant(name)]
    spec = []

    def conv_bn(tk, fpath):
        spec.append((f"{tk}.conv", (*fpath, "conv"), "conv"))
        spec.append((f"{tk}.bn", (*fpath, "bn"), "bn"))

    def base_or_dw(tk, fpath, is_dw):
        if is_dw:
            conv_bn(f"{tk}.dconv", (*fpath, "dconv"))
            conv_bn(f"{tk}.pconv", (*fpath, "pconv"))
        else:
            conv_bn(tk, fpath)

    def csp(tk, fpath, n, is_dw):
        conv_bn(f"{tk}.conv1", (*fpath, "conv1"))
        conv_bn(f"{tk}.conv2", (*fpath, "conv2"))
        conv_bn(f"{tk}.conv3", (*fpath, "conv3"))
        for i in range(n):
            conv_bn(f"{tk}.m.{i}.conv1", (*fpath, f"m{i}", "conv1"))
            base_or_dw(f"{tk}.m.{i}.conv2", (*fpath, f"m{i}", "conv2"), is_dw)

    d = lambda nmul: max(round(nmul * depth), 1)  # noqa: E731
    conv_bn("backbone.backbone.stem.conv", ("stem", "conv"))
    for fb, (tk, _) in _DARK.items():
        if fb == "stem":
            continue
        if fb.endswith("_csp") or fb.startswith("C3_"):
            n = d(9) if fb in ("dark3_csp", "dark4_csp") else d(3)
            csp(tk, (fb,), n, dw)
        elif fb == "dark5_spp":
            conv_bn(f"{tk}.conv1", (fb, "conv1"))
            conv_bn(f"{tk}.conv2", (fb, "conv2"))
        else:
            base_or_dw(tk, (fb,), dw and fb.startswith(("dark", "bu")))
    for lvl in range(3):
        conv_bn(f"head.stems.{lvl}", (f"head_stem{lvl}",))
        for i in range(2):
            base_or_dw(f"head.cls_convs.{lvl}.{i}", (f"head_cls{lvl}_{i}",), dw)
            base_or_dw(f"head.reg_convs.{lvl}.{i}", (f"head_reg{lvl}_{i}",), dw)
        spec.append((f"head.cls_preds.{lvl}", (f"head_cls_pred{lvl}",), "conv"))
        spec.append((f"head.reg_preds.{lvl}", (f"head_reg_pred{lvl}",), "conv"))
        spec.append((f"head.obj_preds.{lvl}", (f"head_obj_pred{lvl}",), "conv"))
    return spec
