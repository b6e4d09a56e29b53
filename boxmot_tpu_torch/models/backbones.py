"""ResNet-50/101 and MobileNetV2 ReID backbones in PyTorch.

Counterpart of ``boxmot_tpu/models/backbones.py`` (``BottleneckBlock``,
``ResNet``, ``InvertedResidual``, ``MobileNetV2`` and their builders): the
torchreid ReID variants, ImageNet-style trunks whose global average pool
gives the backbone's natural width (2048 for ResNet, 1280 for MobileNetV2
x1.0, 1792 for x1.4).  ResNet keeps its last stage at stride 1 (the ReID
modification, a 16x downsample).  Layout NCHW; inference only (batch
norms use their running statistics).  The modules carry the Flax modules'
names (``layer3_0.downsample_conv``, ``block5.dw_bn``, ...), so the JAX
package's variables load by name (``models/convert.py``).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (stride), 1x1 x4 with batch norms; a projected shortcut
    where the width or the stride changes."""

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, filters, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters)
        self.conv3 = nn.Conv2d(filters, filters * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(filters * 4)
        self.project = cin != filters * 4 or stride != 1
        if self.project:
            self.downsample_conv = nn.Conv2d(cin, filters * 4, 1, stride, bias=False)
            self.downsample_bn = nn.BatchNorm2d(filters * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(y + identity)


class ResNet(nn.Module):
    """ResNet-50/101 trunk, last stage at stride 1, mean-pooled to 2048."""

    def __init__(self, stage_sizes=(3, 4, 6, 3)):
        super().__init__()
        self.feature_dim = 2048
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin, filters = 64, 64
        for stage, n_blocks in enumerate(self.stage_sizes):
            # ReID convention: final stage keeps stride 1
            stride = 1 if stage == 0 or stage == len(self.stage_sizes) - 1 else 2
            for b in range(n_blocks):
                setattr(self, f"layer{stage + 1}_{b}",
                        BottleneckBlock(cin, filters, stride if b == 0 else 1))
                cin = filters * 4
            filters *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
        return x.mean(dim=(2, 3))


class InvertedResidual(nn.Module):
    """Expand 1x1 (ReLU6), depthwise 3x3 (stride, ReLU6), project 1x1; the
    input added back where stride and width allow."""

    def __init__(self, cin: int, filters: int, stride: int = 1, expand: int = 6):
        super().__init__()
        hidden = cin * expand
        self.expand = expand
        if expand != 1:
            self.expand_conv = nn.Conv2d(cin, hidden, 1, bias=False)
            self.expand_bn = nn.BatchNorm2d(hidden)
        self.dw_conv = nn.Conv2d(hidden, hidden, 3, stride, 1, groups=hidden, bias=False)
        self.dw_bn = nn.BatchNorm2d(hidden)
        self.project_conv = nn.Conv2d(hidden, filters, 1, bias=False)
        self.project_bn = nn.BatchNorm2d(filters)
        self.residual = stride == 1 and cin == filters

    def forward(self, x):
        y = F.relu6(self.expand_bn(self.expand_conv(x))) if self.expand != 1 else x
        y = F.relu6(self.dw_bn(self.dw_conv(y)))
        y = self.project_bn(self.project_conv(y))
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    """MobileNetV2 at width multiplier ``width`` (reference mobilenetv2.py:
    82-101: channels int(c * width), feature_dim int(1280 * width) if width
    > 1), mean-pooled."""

    def __init__(self, width: float = 1.0):
        super().__init__()
        w = width
        self.feature_dim = int(1280 * w) if w > 1 else 1280
        cfg = [  # (expand, filters, repeats, stride)
            (1, int(16 * w), 1, 1),
            (6, int(24 * w), 2, 2),
            (6, int(32 * w), 3, 2),
            (6, int(64 * w), 4, 2),
            (6, int(96 * w), 3, 1),
            (6, int(160 * w), 3, 2),
            (6, int(320 * w), 1, 1),
        ]
        cin = int(32 * w)
        self.conv1 = nn.Conv2d(3, cin, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cin)
        blocks = []
        for expand, filters, repeats, stride in cfg:
            for r in range(repeats):
                blocks.append(InvertedResidual(cin, filters, stride if r == 0 else 1, expand))
                cin = filters
        self.n_blocks = len(blocks)
        for i, block in enumerate(blocks):
            setattr(self, f"block{i}", block)
        self.conv_last = nn.Conv2d(cin, self.feature_dim, 1, bias=False)
        self.bn_last = nn.BatchNorm2d(self.feature_dim)

    def forward(self, x):
        x = F.relu6(self.bn1(self.conv1(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.relu6(self.bn_last(self.conv_last(x)))
        return x.mean(dim=(2, 3))


def build_resnet50() -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3))


def build_resnet101() -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3))


def build_mobilenetv2(width: float = 1.0) -> MobileNetV2:
    return MobileNetV2(width=width)
