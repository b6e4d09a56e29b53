"""OSNet (Omni-Scale Network), the ReID backbone, in PyTorch.

Counterpart of ``boxmot_tpu/models/osnet.py`` (the Flax ``OSNet``, with
``ConvBNReLU``, ``Conv1x1Linear``, ``LightConv3x3``, ``ChannelGate``,
``OSBlock`` and ``build_osnet``), for all nine variants of
``OSNET_VARIANTS``: plain OSNet, OSNet-AIN (instance norm in the stem and
inside the residual branch of the ``AIN_BLOCKS`` marked "in") and OSNet-IBN
(instance norm in the stem and after the residual sum of stage 2).
Inference only: batch norms use their running statistics (``eval()``).

The modules' attribute names are torchreid's (``osnet.py`` and
``osnet_ain.py``), the keys that ``boxmot_tpu/models/convert.py::
export_osnet_state_dict`` and ``export_osnet_ain_state_dict`` write: e.g.
``conv2.0.conv2a``, ``conv2.0.conv2b.1``, the transition ``conv2.2.0`` of
OSNet and ``pool2.0`` of OSNet-AIN, the AIN streams ``conv2.0.conv2.1.
layers.0``, and the head ``fc.0`` / ``fc.1``; so a torchreid checkpoint's
weights load by name (``models/convert.py``).  Layout NCHW; the
convolutions, pools and the linear layer are PyTorch's (cuDNN and cuBLAS on
the card), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# channels a stage per variant, copied from boxmot_tpu/models/osnet.py:23-33
OSNET_VARIANTS = {
    "osnet_x1_0": ([64, 256, 384, 512], 1.0),
    "osnet_x0_75": ([48, 192, 288, 384], 0.75),
    "osnet_x0_5": ([32, 128, 192, 256], 0.5),
    "osnet_x0_25": ([16, 64, 96, 128], 0.25),
    "osnet_ibn_x1_0": ([64, 256, 384, 512], 1.0),
    "osnet_ain_x1_0": ([64, 256, 384, 512], 1.0),
    "osnet_ain_x0_75": ([48, 192, 288, 384], 0.75),
    "osnet_ain_x0_5": ([32, 128, 192, 256], 0.5),
    "osnet_ain_x0_25": ([16, 64, 96, 128], 0.25),
}

# block kinds a stage of OSNet-AIN (osnet.py:37): "in" blocks normalize conv3
# with instance norm inside the residual branch (torchreid's OSBlockINin)
AIN_BLOCKS = (("in", "in"), ("os", "in"), ("in", "os"))
FEATURE_DIM = 512  # the fc embedding of every torchreid OSNet


def _instance_norm(channels: int) -> nn.InstanceNorm2d:
    """InstanceNorm2d(affine=True): Flax's GroupNorm with one channel a group."""
    return nn.InstanceNorm2d(channels, affine=True)


class ConvLayer(nn.Module):
    """Convolution, batch or instance norm (``bn`` either way), ReLU: the stem
    (torchreid ConvLayer; ``ConvBNReLU(kernel=7, stride=2)`` in Flax)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, IN: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.bn = _instance_norm(cout) if IN else nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Conv1x1(ConvLayer):
    """1x1 convolution, batch norm, ReLU (``ConvBNReLU(kernel=1)``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)


class Conv1x1Linear(nn.Module):
    """1x1 convolution and batch norm, no activation; without ``bn`` the
    convolution alone (the conv3 of OSBlockINin)."""

    def __init__(self, cin: int, cout: int, bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = nn.BatchNorm2d(cout) if bn else None

    def forward(self, x):
        x = self.conv(x)
        return x if self.bn is None else self.bn(x)


class LightConv3x3(nn.Module):
    """1x1 convolution, depthwise 3x3, batch norm, ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False, groups=cout)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv2(self.conv1(x))))


class LightConvStream(nn.Module):
    """``depth`` stacked LightConv3x3 (osnet_ain.py's stream)."""

    def __init__(self, channels: int, depth: int):
        super().__init__()
        self.layers = nn.Sequential(*(LightConv3x3(channels, channels) for _ in range(depth)))

    def forward(self, x):
        return self.layers(x)


class ChannelGate(nn.Module):
    """The streams' shared gate: squeeze, 1x1 down, ReLU, 1x1 up, sigmoid."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class OSBlock(nn.Module):
    """Omni-scale residual block: four streams of 1-4 LightConv3x3 summed
    through one gate.

    ``ain``: torchreid's osnet_ain naming (``conv2`` a list of streams), and
    ``in_inside`` instance-normalizes conv3 inside the branch (OSBlockINin);
    ``IN``: instance norm of the residual sum before the ReLU (OSNet-IBN's
    stage 2).
    """

    def __init__(self, cin: int, cout: int, ain: bool = False, in_inside: bool = False,
                 IN: bool = False, reduction: int = 4):
        super().__init__()
        mid = cout // reduction
        self.ain = ain
        self.conv1 = Conv1x1(cin, mid)
        if ain:
            self.conv2 = nn.ModuleList(LightConvStream(mid, t) for t in range(1, 5))
        else:
            self.conv2a = LightConv3x3(mid, mid)
            self.conv2b = nn.Sequential(*(LightConv3x3(mid, mid) for _ in range(2)))
            self.conv2c = nn.Sequential(*(LightConv3x3(mid, mid) for _ in range(3)))
            self.conv2d = nn.Sequential(*(LightConv3x3(mid, mid) for _ in range(4)))
        self.gate = ChannelGate(mid)
        self.conv3 = Conv1x1Linear(mid, cout, bn=not in_inside)
        self.downsample = Conv1x1Linear(cin, cout) if cin != cout else None
        self.IN = _instance_norm(cout) if (in_inside or IN) else None
        self.in_inside = in_inside

    def forward(self, x):
        x1 = self.conv1(x)
        streams = self.conv2 if self.ain else (self.conv2a, self.conv2b, self.conv2c, self.conv2d)
        x2 = None
        for stream in streams:
            y = self.gate(stream(x1))
            x2 = y if x2 is None else x2 + y
        x3 = self.conv3(x2)
        if self.in_inside:
            x3 = self.IN(x3)
        identity = x if self.downsample is None else self.downsample(x)
        out = x3 + identity
        if self.IN is not None and not self.in_inside:
            out = self.IN(out)
        return F.relu(out)


class OSNet(nn.Module):
    """OSNet to its 512-d embedding (fc, batch norm, ReLU), unnormalized.

    ``ain``: OSNet-AIN (instance-norm stem, ``AIN_BLOCKS``, ``poolN``
    transitions); ``ibn``: OSNet-IBN (instance-norm stem and stage 2).
    """

    def __init__(self, channels, ain: bool = False, ibn: bool = False,
                 feature_dim: int = FEATURE_DIM):
        super().__init__()
        c0, c1, c2, c3 = channels
        self.feature_dim = feature_dim
        self.conv1 = ConvLayer(3, c0, 7, stride=2, IN=ain or ibn)
        widths = ((c0, c1), (c1, c2), (c2, c3))
        for s, (cin, cout) in enumerate(widths):
            blocks = [OSBlock(cin if b == 0 else cout, cout, ain=ain,
                              in_inside=ain and AIN_BLOCKS[s][b] == "in", IN=ibn and s == 0)
                      for b in range(2)]
            transition = nn.Sequential(Conv1x1(cout, cout), nn.AvgPool2d(2, stride=2))
            if s < 2 and not ain:
                blocks.append(transition)
            setattr(self, f"conv{s + 2}", nn.Sequential(*blocks))
            if s < 2 and ain:
                setattr(self, f"pool{s + 2}", transition)
        self.conv5 = Conv1x1(c3, c3)
        self.fc = nn.Sequential(nn.Linear(c3, feature_dim), nn.BatchNorm1d(feature_dim),
                                nn.ReLU())
        self.ain = ain

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, stride=2, padding=1)
        x = self.conv2(x)
        if self.ain:
            x = self.pool2(x)
        x = self.conv3(x)
        if self.ain:
            x = self.pool3(x)
        x = self.conv5(self.conv4(x))
        return self.fc(x.mean(dim=(2, 3)))


def build_osnet(name: str) -> OSNet:
    """The OSNet variant ``name`` of ``OSNET_VARIANTS``, randomly initialized."""
    try:
        channels, _ = OSNET_VARIANTS[name]
    except KeyError:
        raise ValueError(
            f"unknown OSNet variant {name!r}; available: {sorted(OSNET_VARIANTS)}") from None
    return OSNet(channels, ain=name.startswith("osnet_ain"), ibn=name.startswith("osnet_ibn"))
