"""ViT-Nano / ViT-Tiny ReID backbones in PyTorch.

Counterpart of ``boxmot_tpu/models/vit.py`` (``PatchEmbed``,
``AdaptiveINLN``, ``Attention``, ``Block``, ``OmniScaleAggregation``,
``ViTNano``, ``ViTTinyParts``, ``build_vit``): conv patches, a CLS token and
a learned positional embedding, pre-norm blocks (the first half with
AdaptiveINLN in the ``*_ain`` variants), a final LayerNorm, then the CLS
token, the patch mean or the omni-scale strip aggregation, an optional
projection and the BNNeck.  ``ViTTinyParts`` adds horizontal part stripes,
each through its own BNNeck, concatenated after the global feature.

The positional embedding is sized from the crop, as Flax sizes it at
``init`` from the input it is given: (N + 1, D) for the N patches of
``crop_hw`` (``img_size`` is never read, in either package), so the
builders take the crop.  Attention is a plain product and softmax, as the
JAX module's ``einsum``s are.  Every LayerNorm takes Flax's epsilon 1e-6;
AdaptiveINLN's instance norm takes the biased variance and 1e-5.  The
modules carry the Flax modules' names (``block0.attn.qkv``, ``os_agg``,
``part_bn1``), so the JAX package's variables load by name
(``models/convert.py``).  Layout: NCHW crops in, (B, feature_dim) out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from boxmot_tpu_torch.models.layers import LN_EPS, BiasFreeBatchNorm1d


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def patch_grid(crop_hw, patch: int, stride: int) -> tuple[int, int]:
    """(rows, columns) of the patches of a VALID ``patch`` x ``patch``
    convolution at ``stride`` over ``crop_hw``."""
    return (crop_hw[0] - patch) // stride + 1, (crop_hw[1] - patch) // stride + 1


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size: int = 16, stride: int | None = None):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride or patch_size)

    def forward(self, x):
        x = self.proj(x)
        _, _, h, w = x.shape
        return x.flatten(2).transpose(1, 2), (h, w)


class AdaptiveINLN(nn.Module):
    """gate * IN(x) + (1 - gate) * LN(x), gate = sigmoid(learned per-dim)."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = _layer_norm(dim)
        self.in_scale = nn.Parameter(torch.ones(dim))
        self.in_bias = nn.Parameter(torch.zeros(dim))
        self.gate = nn.Parameter(torch.zeros(dim))

    def forward(self, x):  # (B, N, D)
        ln = self.ln(x)
        mu = x.mean(dim=1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
        inx = (x - mu) / torch.sqrt(var + 1e-5) * self.in_scale + self.in_bias
        gate = torch.sigmoid(self.gate)
        return gate * inx + (1.0 - gate) * ln


def attention(q, k, v, scale: float, bias=None):
    """softmax(q k^T * scale (+ bias)) v over (B, heads, N, head_dim)
    tensors: the JAX modules' two einsums and softmax (CSL-TinyViT adds its
    (heads, N, N) offset biases before the softmax)."""
    logits = (q @ k.transpose(-2, -1)) * scale
    return torch.softmax(logits if bias is None else logits + bias, dim=-1) @ v


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, h, D // h).permute(2, 0, 3, 1, 4)
        out = attention(q, k, v, 1.0 / math.sqrt(D // h))
        return self.proj(out.transpose(1, 2).reshape(B, N, D))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, use_ain: bool = False):
        super().__init__()
        self.norm1 = AdaptiveINLN(dim) if use_ain else _layer_norm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = _layer_norm(dim)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


def strip_pool(spatial, n_strips: int):
    """(B, H, W, D) -> (B, D): the mean of ``n_strips`` horizontal strips'
    means, strip i spanning rows floor(i H / S) to ceil((i + 1) H / S), as
    torch's adaptive pooling (and the JAX ``_strip_pool``) takes them."""
    H = spatial.shape[1]
    strips = [spatial[:, (i * H) // n_strips:-(-((i + 1) * H) // n_strips)].mean(dim=(1, 2))
              for i in range(n_strips)]
    return torch.stack(strips, dim=1).mean(dim=1)


class OmniScaleAggregation(nn.Module):
    """Strip pooling at 1/2/4/8 strips, a LayerNorm a scale, fused by one
    shared channel gate."""

    def __init__(self, dim: int, reduction: int = 16, num_scales: int = 4):
        super().__init__()
        mid = max(dim // reduction, 1)
        self.num_scales = num_scales
        self.gate_fc1 = nn.Linear(dim, mid)
        self.gate_fc2 = nn.Linear(mid, dim)
        for i in range(num_scales):
            setattr(self, f"scale_norm{i}", _layer_norm(dim))

    def forward(self, spatial):  # (B, H, W, D)
        fused = 0.0
        for i in range(self.num_scales):
            pooled = getattr(self, f"scale_norm{i}")(strip_pool(spatial, 2 ** i))
            g = torch.sigmoid(self.gate_fc2(F.relu(self.gate_fc1(pooled))))
            fused = fused + g * pooled
        return fused


class ViTNano(nn.Module):
    """Lightweight ReID ViT; returns the BNNeck inference feature."""

    def __init__(self, crop_hw=(256, 128), patch_size: int = 16, embed_dim: int = 192,
                 depth: int = 6, num_heads: int = 3, mlp_ratio: float = 4.0, ain: bool = False,
                 omni_scale: bool = False, pool: str = "cls", patch_stride: int | None = None,
                 feat_dim: int | None = None):
        super().__init__()
        self.embed_dim, self.depth, self.pool, self.omni_scale = embed_dim, depth, pool, omni_scale
        self.fd = feat_dim or embed_dim
        self.feature_dim = self.fd
        self.grid = patch_grid(crop_hw, patch_size, patch_stride or patch_size)
        self.patch_embed = PatchEmbed(embed_dim, patch_size, patch_stride)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid[0] * self.grid[1] + 1, embed_dim))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        ain_depth = depth // 2 if ain else 0
        for i in range(depth):
            setattr(self, f"block{i}", Block(embed_dim, num_heads, mlp_ratio, use_ain=i < ain_depth))
        self.norm = _layer_norm(embed_dim)
        if omni_scale:
            self.os_agg = OmniScaleAggregation(embed_dim)
        if self.fd != embed_dim:
            self.proj = nn.Linear(embed_dim, self.fd, bias=False)
        self.bottleneck = BiasFreeBatchNorm1d(self.fd)

    def forward(self, x):
        return self._features(x)[0]

    def _features(self, x):
        tokens, (gh, gw) = self.patch_embed(x)
        B = tokens.shape[0]
        x = torch.cat([self.cls_token.expand(B, -1, -1), tokens], 1) + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.norm(x)
        patch_tokens = x[:, 1:]
        if self.omni_scale:
            v = self.os_agg(patch_tokens.reshape(B, gh, gw, self.embed_dim))
        elif self.pool == "gap":
            v = patch_tokens.mean(dim=1)
        else:
            v = x[:, 0]
        if self.fd != self.embed_dim:
            v = self.proj(v)
        return self.bottleneck(v), (x, gh, gw)


class ViTTinyParts(ViTNano):
    """ViT with horizontal part heads; the feature is [global BNNeck, part
    BNNecks] concatenated, the last stripe taking the rows left over."""

    def __init__(self, num_parts: int = 2, **kw):
        super().__init__(**kw)
        self.num_parts = num_parts
        self.feature_dim = (1 + num_parts) * self.fd
        self.part_dims = (self.fd,) * (1 + num_parts)
        for i in range(num_parts):
            if self.fd != self.embed_dim:
                setattr(self, f"part_proj{i}", nn.Linear(self.embed_dim, self.fd, bias=False))
            setattr(self, f"part_bn{i}", BiasFreeBatchNorm1d(self.fd))

    def forward(self, x):
        feat, (tokens, gh, gw) = self._features(x)
        B = tokens.shape[0]
        spatial = tokens[:, 1:].reshape(B, gh, gw, self.embed_dim)
        outs, strip_h = [feat], gh // self.num_parts
        for i in range(self.num_parts):
            lo = i * strip_h
            hi = lo + strip_h if i < self.num_parts - 1 else gh
            p = spatial[:, lo:hi].mean(dim=(1, 2))
            if self.fd != self.embed_dim:
                p = getattr(self, f"part_proj{i}")(p)
            outs.append(getattr(self, f"part_bn{i}")(p))
        return torch.cat(outs, dim=-1)


VIT_VARIANTS = {  # the reference builders' settings (boxmot_tpu/models/vit.py:244-265)
    "vit_nano": (ViTNano, {}),
    "vit_nano_ain": (ViTNano, {"ain": True}),
    "vit_nano_ain_os": (ViTNano, {"ain": True, "omni_scale": True}),
    "vit_tiny": (ViTNano, {"depth": 12, "patch_stride": 12, "feat_dim": 512}),
    "vit_tiny_parts": (ViTTinyParts, {"depth": 12, "patch_stride": 12, "feat_dim": 512,
                                      "num_parts": 2}),
    "vit_tiny_parts3": (ViTTinyParts, {"depth": 12, "patch_stride": 12, "feat_dim": 512,
                                       "num_parts": 3}),
}


def build_vit(name: str, crop_hw=(256, 128)) -> ViTNano:
    if name not in VIT_VARIANTS:
        raise ValueError(f"unknown ViT variant {name!r}")
    cls, kw = VIT_VARIANTS[name]
    return cls(crop_hw=crop_hw, **kw)
