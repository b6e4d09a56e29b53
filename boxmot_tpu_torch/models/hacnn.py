"""HACNN (Harmonious Attention CNN) ReID backbone in PyTorch.

Counterpart of ``boxmot_tpu/models/hacnn.py`` (``ConvBlock``,
``InceptionA``, ``InceptionB``, ``SoftAttn``, ``HardAttn``, ``HACNN``):
Inception-A/B blocks with harmonious attention, soft (spatial x channel,
sigmoid-gated) on the global branch and hard (four learned regions sampled
by a spatial transformer) feeding a local branch whose region features
accumulate over the three blocks.  The embedding is the L2-normalized
[global, local] concatenation, 1024 columns.  The input is fixed at 160 x
64 and asserted, as in the JAX model.

The JAX model's ``_grid_sample`` is torch's ``affine_grid`` and
``grid_sample`` (bilinear, ``align_corners=False``, zero padding), and its
``_resize_ac`` a bilinear resize with ``align_corners=True``: here they are
``F.affine_grid``, ``F.grid_sample`` and ``F.interpolate`` (plain JAX
functions there, not kernels).  The modules carry the Flax modules' names
(``inc1b.s2c``, ``soft2.fuse``, ``hard0.fc``, ``local1``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# per-region scale factors: full width, quarter height (hacnn.py:268-274)
_REGION_SCALE = (1.0, 0.25)
# initial region centers (ty): vertical strips (hacnn.py:162-166)
_REGION_INIT_TY = (-0.75, -0.25, 0.25, 0.75)
_LOCAL_SIZES = ((24, 28), (12, 14), (6, 7))  # the regions' size in each block


def _grid_sample(x: torch.Tensor, theta: torch.Tensor, out_hw) -> torch.Tensor:
    """Affine grid sample: (B, C, H, W), (B, 2, 3) -> (B, C, oh, ow).  The
    grid and the sampling run in float32 whatever ``x``'s type (a bf16 grid
    would place the samples to 1/128 of the frame)."""
    grid = F.affine_grid(theta.float(), (x.shape[0], x.shape[1], *out_hw), align_corners=False)
    return F.grid_sample(x.float(), grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False).to(x.dtype)


def _resize_ac(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize with align_corners=True."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


class ConvBlock(nn.Module):
    """Convolution (with bias), batch norm, ReLU."""

    def __init__(self, cin: int, out: int, k: int = 1, s: int = 1, p: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, out, k, s, p)
        self.bn = nn.BatchNorm2d(out)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, out: int):
        super().__init__()
        mid = out // 4
        for s in ("s1", "s2", "s3"):
            setattr(self, f"{s}a", ConvBlock(cin, mid, 1))
            setattr(self, f"{s}b", ConvBlock(mid, mid, 3, p=1))
        self.s4 = ConvBlock(cin, mid, 1)

    def forward(self, x):
        s1 = self.s1b(self.s1a(x))
        s2 = self.s2b(self.s2a(x))
        s3 = self.s3b(self.s3a(x))
        s4 = self.s4(F.avg_pool2d(x, 3, 1, 1))  # the padding counted, as in Flax
        return torch.cat([s1, s2, s3, s4], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, out: int):
        super().__init__()
        mid = out // 4
        self.s1a, self.s1b = ConvBlock(cin, mid, 1), ConvBlock(mid, mid, 3, s=2, p=1)
        self.s2a, self.s2b = ConvBlock(cin, mid, 1), ConvBlock(mid, mid, 3, p=1)
        self.s2c = ConvBlock(mid, mid, 3, s=2, p=1)
        self.s3 = ConvBlock(cin, mid * 2, 1)

    def forward(self, x):
        s1 = self.s1b(self.s1a(x))
        s2 = self.s2c(self.s2b(self.s2a(x)))
        s3 = self.s3(F.max_pool2d(x, 3, 2, 1))
        return torch.cat([s1, s2, s3], dim=1)


class SoftAttn(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.sp1 = ConvBlock(1, 1, 3, s=2, p=1)
        self.sp2 = ConvBlock(1, 1, 1)
        self.ch1 = ConvBlock(channels, channels // 16, 1)
        self.ch2 = ConvBlock(channels // 16, channels, 1)
        self.fuse = ConvBlock(channels, channels, 1)

    def forward(self, x):
        # spatial: mean over channels, conv/2, upsample x2 (align corners), conv
        sp = self.sp1(x.mean(dim=1, keepdim=True))
        sp = self.sp2(_resize_ac(sp, (sp.shape[2] * 2, sp.shape[3] * 2)))
        # channel: squeeze-excite with conv blocks
        ch = self.ch2(self.ch1(x.mean(dim=(2, 3), keepdim=True)))
        return torch.sigmoid(self.fuse(sp * ch))


class HardAttn(nn.Module):
    """Predicts four region centers (tx, ty); a zero kernel and a bias at the
    vertical strips at initialization (hacnn.py:154-175)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Linear(channels, 8)
        with torch.no_grad():
            self.fc.weight.zero_()
            self.fc.bias.copy_(torch.tensor([v for ty in _REGION_INIT_TY for v in (0.0, ty)]))

    def forward(self, x):
        return torch.tanh(self.fc(x.mean(dim=(2, 3)))).reshape(-1, 4, 2)


class HACNN(nn.Module):
    def __init__(self, nchannels=(128, 256, 384), feat_dim_single: int = 512,
                 learn_region: bool = True):
        super().__init__()
        nc = nchannels
        self.learn_region = learn_region
        self.feature_dim = feat_dim_single * (2 if learn_region else 1)
        self.conv = ConvBlock(3, 32, 3, s=2, p=1)
        cin = 32
        for blk in range(3):
            setattr(self, f"inc{blk}a", InceptionA(cin, nc[blk]))
            setattr(self, f"inc{blk}b", InceptionB(nc[blk], nc[blk]))
            setattr(self, f"soft{blk}", SoftAttn(nc[blk]))
            setattr(self, f"hard{blk}", HardAttn(nc[blk]))
            if learn_region:
                # one local conv per block, shared by all four regions
                # (hacnn.py:254-257); its input is the previous block's output
                setattr(self, f"local{blk}", InceptionB(cin, nc[blk]))
            cin = nc[blk]
        self.fc_global = nn.Linear(nc[2], feat_dim_single)
        self.fc_global_bn = nn.BatchNorm1d(feat_dim_single)
        if learn_region:
            self.fc_local = nn.Linear(4 * nc[2], feat_dim_single)
            self.fc_local_bn = nn.BatchNorm1d(feat_dim_single)

    @staticmethod
    def _thetas(centers: torch.Tensor) -> list[torch.Tensor]:
        """(B, 4, 2) tanh centers -> four (B, 2, 3) affines with the fixed
        full-width / quarter-height scale (transform_theta)."""
        sw, sh = _REGION_SCALE
        base = torch.tensor([[sw, 0.0, 0.0], [0.0, sh, 0.0]], dtype=centers.dtype,
                            device=centers.device)
        thetas = []
        for r in range(4):
            t = base.expand(centers.shape[0], 2, 3).clone()
            t[:, :, 2] = centers[:, r]
            thetas.append(t)
        return thetas

    def forward(self, x):
        assert x.shape[2] == 160 and x.shape[3] == 64, (
            f"HACNN expects 160x64 input, got {x.shape[2]}x{x.shape[3]}"
        )
        x = self.conv(x)
        locals_ = None
        feats = prev_global = x
        for blk in range(3):
            y = getattr(self, f"inc{blk}b")(getattr(self, f"inc{blk}a")(feats))
            attn = getattr(self, f"soft{blk}")(y)
            centers = getattr(self, f"hard{blk}")(y)
            out = y * attn
            if self.learn_region:
                local_conv = getattr(self, f"local{blk}")
                new_locals = []
                for r, theta in enumerate(self._thetas(centers)):
                    t = _grid_sample(prev_global, theta, prev_global.shape[2:])
                    t = _resize_ac(t, _LOCAL_SIZES[blk])
                    if locals_ is not None:
                        t = t + locals_[r]
                    new_locals.append(local_conv(t))
                locals_ = new_locals
            feats = prev_global = out
        g = F.relu(self.fc_global_bn(self.fc_global(feats.mean(dim=(2, 3)))))
        if not self.learn_region:
            return g
        loc = torch.cat([t.mean(dim=(2, 3)) for t in locals_], dim=1)
        loc = F.relu(self.fc_local_bn(self.fc_local(loc)))
        g = g / torch.clamp_min(torch.linalg.vector_norm(g, dim=-1, keepdim=True), 1e-12)
        loc = loc / torch.clamp_min(torch.linalg.vector_norm(loc, dim=-1, keepdim=True), 1e-12)
        return torch.cat([g, loc], dim=1)


def build_hacnn() -> HACNN:
    return HACNN()
