"""CSL-TinyViT hybrid CNN-Transformer ReID backbones in PyTorch.

Counterpart of ``boxmot_tpu/models/csl_tinyvit.py`` (``ConvBN``,
``MBConv``, ``PatchMerging``, ``WindowAttention``, ``TinyViTBlock``,
``LayerNorm2d``, ``BNNeck3``, ``CSLTinyViT``, ``build_csl_tinyvit``): a
stride-4 conv patch embedding, an MBConv stage, three stages of windowed
self-attention with learned absolute-offset biases and a depthwise local
convolution, a conv + LayerNorm2d neck and a multi-granularity BNNeck head
(global and two stripes, 3 x 512; the ``*_lmbn`` head adds a drop-global,
a part-global and two channel halves through one shared linear layer and
one shared batch norm, applied twice, 7 x 512).

As in JAX: ``PatchMerging`` keeps stride 1 into the wide final stages (out
320, 448 or 576); ``TinyViTBlock`` pads the token grid with zeros to
window multiples before the attention's own LayerNorm and masks nothing,
so the padded tokens take part as keys; the bias table is gathered from a
numpy index table (a non-persistent buffer here); ``LayerNorm2d`` takes
epsilon 1e-6 and every ``nn.LayerNorm`` Flax's 1e-6; the features are
stacked on a new last axis and flattened, a channel-major interleave.
Layout NCHW between modules, NHWC inside a block's attention and MLP.  The
modules carry the Flax modules' names (``s1_b0.attn.qkv``, ``merge2.conv2``,
``neck_ln1``, ``bn_ch0.reduction``), so the JAX package's variables load by
name (``models/convert.py``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from boxmot_tpu_torch.models.layers import LN_EPS
from boxmot_tpu_torch.models.lmbn import BNNeck3
from boxmot_tpu_torch.models.vit import attention


class ConvBN(nn.Module):
    def __init__(self, cin: int, out: int, ks: int = 1, stride: int = 1, groups: int = 1):
        super().__init__()
        self.c = nn.Conv2d(cin, out, ks, stride, ks // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out)

    def forward(self, x):
        return self.bn(self.c(x))


class MBConv(nn.Module):
    def __init__(self, cin: int, out: int, expand: float = 4.0):
        super().__init__()
        hidden = int(cin * expand)
        self.conv1 = ConvBN(cin, hidden, 1)
        self.conv2 = ConvBN(hidden, hidden, 3, groups=hidden)
        self.conv3 = ConvBN(hidden, out, 1)

    def forward(self, x):
        y = F.gelu(self.conv2(F.gelu(self.conv1(x))))
        return F.gelu(self.conv3(y) + x)


class PatchMerging(nn.Module):
    def __init__(self, cin: int, out_dim: int):
        super().__init__()
        # no spatial downsample into the wide final stages (csl_tinyvit.py:79)
        stride = 1 if out_dim in (320, 448, 576) else 2
        self.conv1 = ConvBN(cin, out_dim, 1)
        self.conv2 = ConvBN(out_dim, out_dim, 3, stride=stride, groups=out_dim)
        self.conv3 = ConvBN(out_dim, out_dim, 1)

    def forward(self, x):
        return self.conv3(F.gelu(self.conv2(F.gelu(self.conv1(x)))))


def bias_index_table(resolution):
    """Absolute-offset attention bias indices (the JAX ``_bias_index_table``):
    an (N, N) table over the window's points and the number of offsets."""
    points = list(itertools.product(range(resolution[0]), range(resolution[1])))
    offsets, idxs = {}, []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return np.array(idxs, np.int64).reshape(n, n), len(offsets)


class WindowAttention(nn.Module):
    """Multi-head attention over a window's tokens with learned
    absolute-offset biases (attn_ratio 1)."""

    def __init__(self, dim: int, num_heads: int, resolution):
        super().__init__()
        self.num_heads = num_heads
        self.key_dim = dim // num_heads
        table, n_offsets = bias_index_table(resolution)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, n_offsets))
        self.register_buffer("idx_table", torch.from_numpy(table), persistent=False)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * num_heads * self.key_dim)
        self.proj = nn.Linear(num_heads * self.key_dim, dim)

    def forward(self, x):  # (B, N, dim)
        B, N, _ = x.shape
        h, kd = self.num_heads, self.key_dim
        qkv = self.qkv(self.norm(x)).reshape(B, N, h, 3 * kd).transpose(1, 2)
        q, k, v = qkv[..., :kd], qkv[..., kd:2 * kd], qkv[..., 2 * kd:]
        bias = self.attention_biases[:, self.idx_table]  # (h, N, N)
        out = attention(q, k, v, kd ** -0.5, bias)
        return self.proj(out.transpose(1, 2).reshape(B, N, h * kd))


class TinyViTBlock(nn.Module):
    """Windowed attention, a local depthwise conv and a pre-norm MLP (no
    shift, no mask)."""

    def __init__(self, dim: int, num_heads: int, window, mlp_ratio: float = 4.0):
        super().__init__()
        self.window = tuple(window)
        self.attn = WindowAttention(dim, num_heads, self.window)
        self.local_conv = ConvBN(dim, dim, 3, groups=dim)
        self.mlp_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def _windows(self, t):  # (B, H, W, C) -> attention over zero-padded windows
        B, H, W, C = t.shape
        wh, ww = self.window
        if H == wh and W == ww:
            return self.attn(t.reshape(B, H * W, C)).reshape(B, H, W, C)
        pad_b, pad_r = (wh - H % wh) % wh, (ww - W % ww) % ww
        y = F.pad(t, (0, 0, 0, pad_r, 0, pad_b))
        nH, nW = (H + pad_b) // wh, (W + pad_r) // ww
        y = y.reshape(B, nH, wh, nW, ww, C).transpose(2, 3).reshape(B * nH * nW, wh * ww, C)
        y = self.attn(y).reshape(B, nH, nW, wh, ww, C).transpose(2, 3)
        return y.reshape(B, nH * wh, nW * ww, C)[:, :H, :W]

    def forward(self, x):  # NCHW
        t = x.permute(0, 2, 3, 1)
        t = t + self._windows(t)
        t = self.local_conv(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        t = t + self.fc2(F.gelu(self.fc1(self.mlp_norm(t))))
        return t.permute(0, 3, 1, 2)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of NCHW features (Flax params ``weight``/``bias``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mu = x.mean(dim=1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
        x = (x - mu) / torch.sqrt(var + 1e-6)
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class CSLTinyViT(nn.Module):
    def __init__(self, embed_dims=(64, 128, 160, 320), depths=(2, 2, 6, 2),
                 num_heads=(2, 4, 5, 10), window_sizes=(7, 7, 14, 7), mlp_ratio: float = 4.0,
                 mbconv_expand: float = 4.0, feat_dim: int = 512, neck_dim: int = 512,
                 lmbn_head: bool = False):
        super().__init__()
        dims = self.embed_dims = tuple(embed_dims)
        self.depths, self.neck_dim, self.lmbn_head = tuple(depths), neck_dim, lmbn_head
        self.feature_dim = (7 if lmbn_head else 3) * feat_dim
        self.pe_conv1 = ConvBN(3, dims[0] // 2, 3, 2)
        self.pe_conv2 = ConvBN(dims[0] // 2, dims[0], 3, 2)
        for b in range(depths[0]):
            setattr(self, f"s0_b{b}", MBConv(dims[0], dims[0], mbconv_expand))
        self.merge0 = PatchMerging(dims[0], dims[1])
        for s in range(1, len(depths)):
            win = window_sizes[s]
            win = (win, win) if isinstance(win, int) else tuple(win)
            for b in range(depths[s]):
                setattr(self, f"s{s}_b{b}", TinyViTBlock(dims[s], num_heads[s], win, mlp_ratio))
            if s < len(depths) - 1:
                setattr(self, f"merge{s}", PatchMerging(dims[s], dims[s + 1]))
        self.neck_conv1 = nn.Conv2d(dims[-1], neck_dim, 1, bias=False)
        self.neck_ln1 = LayerNorm2d(neck_dim)
        self.neck_conv2 = nn.Conv2d(neck_dim, neck_dim, 3, padding=1, bias=False)
        self.neck_ln2 = LayerNorm2d(neck_dim)
        heads = ["bn_global", "bn_part0", "bn_part1"]
        if lmbn_head:
            heads += ["bn_drop_global", "bn_part_global"]
            self.channel_shared = nn.Linear(neck_dim // 2, feat_dim, bias=False)
            self.channel_shared_bn = nn.BatchNorm1d(feat_dim)
            for name in ("bn_ch0", "bn_ch1"):
                setattr(self, name, BNNeck3(feat_dim, feat_dim))
        for name in heads:
            setattr(self, name, BNNeck3(neck_dim, feat_dim))

    def forward(self, x):
        x = self.pe_conv2(F.gelu(self.pe_conv1(x)))
        for b in range(self.depths[0]):
            x = getattr(self, f"s0_b{b}")(x)
        x = self.merge0(x)
        for s in range(1, len(self.depths)):
            for b in range(self.depths[s]):
                x = getattr(self, f"s{s}_b{b}")(x)
            if s < len(self.depths) - 1:
                x = getattr(self, f"merge{s}")(x)
        x = self.neck_ln2(self.neck_conv2(self.neck_ln1(self.neck_conv1(x))))
        H = x.shape[2]
        g = x.mean(dim=(2, 3))
        p0, p1 = x[:, :, :H // 2].mean(dim=(2, 3)), x[:, :, H // 2:].mean(dim=(2, 3))
        feats = [self.bn_global(g), self.bn_part0(p0), self.bn_part1(p1)]
        if self.lmbn_head:
            # the spatial top-drop is train-only in the reference (and absent
            # in JAX): drop_global sees the undropped map
            half = self.neck_dim // 2
            c0 = F.relu(self.channel_shared_bn(self.channel_shared(g[:, :half])))
            c1 = F.relu(self.channel_shared_bn(self.channel_shared(g[:, half:])))
            feats = [feats[0], self.bn_drop_global(g), self.bn_part_global(g), feats[1],
                     feats[2], self.bn_ch0(c0), self.bn_ch1(c1)]
        # concat_bn: stack on a new last axis, then flatten (channel-major)
        return torch.stack(feats, dim=2).reshape(x.shape[0], -1)


CSL_VARIANTS = {
    "csl_tinyvit_7m": {"embed_dims": (64, 128, 160, 320), "num_heads": (2, 4, 5, 10)},
    "csl_tinyvit_11m": {"embed_dims": (64, 128, 256, 448), "num_heads": (2, 4, 8, 14)},
    "csl_tinyvit_23m": {"embed_dims": (96, 192, 384, 576), "num_heads": (3, 6, 12, 18)},
}
CSL_ALIASES = {
    "csl_tinyvit_small": "csl_tinyvit_7m",
    "csl_tinyvit_normal": "csl_tinyvit_11m",
    "csl_tinyvit_large": "csl_tinyvit_23m",
    "csl_tinyvit_lmbn": "csl_tinyvit_11m_lmbn",
}


def build_csl_tinyvit(name: str) -> CSLTinyViT:
    """The ten reference variants and aliases."""
    name = CSL_ALIASES.get(name, name)
    lmbn = name.endswith("_lmbn")
    base = name.removesuffix("_lmbn")
    if base not in CSL_VARIANTS:
        raise ValueError(f"unknown CSL-TinyViT variant {name!r}")
    return CSLTinyViT(lmbn_head=lmbn, **CSL_VARIANTS[base])
