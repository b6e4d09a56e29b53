"""CSPReID-n ReID backbone in PyTorch.

Counterpart of ``boxmot_tpu/models/cspreid.py`` (``ConvBNSiLU``,
``Bottleneck``, ``C3k2``, ``SPPF``, ``LightSelfAttention``, ``CSPReID``):
YOLO-style C3k2 cross-stage-partial blocks, SPPF (three chained stride-1
max pools, padded with -inf as Flax's ``max_pool`` pads), a light channel
and spatial attention, and an LMBN-style head (global and two horizontal
halves, each through a BNNeck); the embedding is the three 512-d features
stacked channel first to 1536 columns.  The modules carry the Flax
modules' names (``s3_c3k2.b1.cv2``, ``attn.sp_dw``, ``bn_part0``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from boxmot_tpu_torch.models.lmbn import BNNeck3


class ConvBNSiLU(nn.Module):
    def __init__(self, cin: int, out: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, out, kernel, stride, kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(out)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, out: int, shortcut: bool = True, expansion: float = 0.5):
        super().__init__()
        mid = int(out * expansion)
        self.cv1 = ConvBNSiLU(cin, mid, 1)
        self.cv2 = ConvBNSiLU(mid, out, 3)
        self.add = shortcut and cin == out

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k2(nn.Module):
    """CSP bottleneck: split, chain n bottlenecks, concat, fuse."""

    def __init__(self, cin: int, out: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        self.mid = int(out * expansion)
        self.n = n
        self.cv1 = ConvBNSiLU(cin, 2 * self.mid, 1)
        for i in range(n):
            setattr(self, f"b{i}", Bottleneck(self.mid, self.mid, shortcut))
        self.cv2 = ConvBNSiLU((2 + n) * self.mid, out, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.mid], y[:, self.mid:]]
        cur = parts[-1]
        for i in range(self.n):
            cur = getattr(self, f"b{i}")(cur)
            parts.append(cur)
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, out: int, k: int = 5):
        super().__init__()
        mid = cin // 2
        self.k = k
        self.cv1 = ConvBNSiLU(cin, mid, 1)
        self.cv2 = ConvBNSiLU(4 * mid, out, 1)

    def forward(self, x):
        x = self.cv1(x)
        pool = lambda t: F.max_pool2d(t, self.k, 1, self.k // 2)  # noqa: E731
        y1 = pool(x)
        y2 = pool(y1)
        y3 = pool(y2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class LightSelfAttention(nn.Module):
    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        mid = max(channels // reduction, 16)
        self.fc1 = nn.Conv2d(channels, mid, 1, bias=False)
        self.fc2 = nn.Conv2d(mid, channels, 1, bias=False)
        self.sp_dw = nn.Conv2d(channels, channels, 3, 1, 1, groups=channels, bias=False)
        self.sp_bn = nn.BatchNorm2d(channels)
        self.sp_pw = nn.Conv2d(channels, 1, 1, bias=False)

    def forward(self, x):
        ca = x.mean(dim=(2, 3), keepdim=True)
        ca = torch.sigmoid(self.fc2(F.silu(self.fc1(ca))))
        x = x * ca
        sa = F.silu(self.sp_bn(self.sp_dw(x)))
        return x * torch.sigmoid(self.sp_pw(sa))


class CSPReID(nn.Module):
    def __init__(self, feat_dim: int = 512):
        super().__init__()
        self.feature_dim = 3 * feat_dim
        self.stem0 = ConvBNSiLU(3, 32, 3, 2)
        self.stem1 = ConvBNSiLU(32, 64, 3, 2)
        self.s1_c3k2 = C3k2(64, 128, 1)
        self.s1_down = ConvBNSiLU(128, 128, 3, 2)
        self.s2_c3k2 = C3k2(128, 256, 1)
        self.s2_down = ConvBNSiLU(256, 256, 3, 2)
        self.s3_c3k2 = C3k2(256, 384, 2)
        self.s3_down = ConvBNSiLU(384, 384, 3, 2)
        self.s4_c3k2 = C3k2(384, 512, 1)
        self.sppf = SPPF(512, 512, k=3)
        self.attn = LightSelfAttention(512)
        self.bn_global = BNNeck3(512, feat_dim)
        self.bn_part0 = BNNeck3(512, feat_dim)
        self.bn_part1 = BNNeck3(512, feat_dim)

    def forward(self, x):
        for name in ("stem0", "stem1", "s1_c3k2", "s1_down", "s2_c3k2", "s2_down", "s3_c3k2",
                     "s3_down", "s4_c3k2", "sppf", "attn"):
            x = getattr(self, name)(x)
        # multi-branch head: global + horizontal halves (cspreid_n.py:169-222)
        h = x.shape[2]
        f_glo = self.bn_global(x.mean(dim=(2, 3)))
        f_p0 = self.bn_part0(x[:, :, : h // 2].mean(dim=(2, 3)))
        f_p1 = self.bn_part1(x[:, :, h // 2:].mean(dim=(2, 3)))
        return torch.stack([f_glo, f_p0, f_p1], dim=2).reshape(x.shape[0], -1)


def build_cspreid() -> CSPReID:
    return CSPReID()
