"""CLIP-ReID in PyTorch: the ViT-B/16 image encoder with its BNNecks, and
the text tower and prompt learner of stage-1 training.

Counterpart of ``boxmot_tpu/models/clip_reid.py`` (``quick_gelu``,
``ResidualAttentionBlock``, ``ClipReID``, ``ClipTextEncoder``,
``PromptLearner``, ``pretrained_prompt_template``, ``clip_prompt_losses``,
``build_clip_reid``).  The image encoder: stride-16 conv patches, a class
token, a positional embedding, ``ln_pre``, pre-LN blocks with QuickGELU
MLPs, ``ln_post``; its feature is the CLS token (768) and its 512-d
projection, each through a bias-free BNNeck, concatenated (1280).  The
positional embedding is sized from the crop (16 x 8 + 1 rows at 256 x 128),
as Flax sizes it at ``init``.  The text tower runs causal (-inf above the
diagonal) blocks over embedded prompts and projects the end-of-text row.
Attention is a plain product and softmax, as in JAX; LayerNorms take
Flax's epsilon 1e-6.  The modules carry the Flax names (``resblock3.qkv``,
``ln_final``, ``text_projection``), so the JAX package's variables and
``models/convert.py::convert_clip``'s output load by name.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from boxmot_tpu_torch.models.layers import LN_EPS, BiasFreeBatchNorm1d
from boxmot_tpu_torch.models.vit import attention


def quick_gelu(x):
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.ln_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ln_2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.c_fc = nn.Linear(dim, 4 * dim)
        self.c_proj = nn.Linear(4 * dim, dim)

    def forward(self, x):  # (B, N, D)
        B, N, D = x.shape
        h = self.heads
        q, k, v = self.qkv(self.ln_1(x)).reshape(B, N, 3, h, D // h).permute(2, 0, 3, 1, 4)
        if self.causal:
            logits = (q @ k.transpose(-2, -1)) * (1.0 / math.sqrt(D // h))
            above = torch.ones(N, N, dtype=torch.bool, device=x.device).triu(1)
            y = torch.softmax(logits.masked_fill(above, float("-inf")), dim=-1) @ v
        else:
            y = attention(q, k, v, 1.0 / math.sqrt(D // h))
        x = x + self.out_proj(y.transpose(1, 2).reshape(B, N, D))
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class ClipReID(nn.Module):
    def __init__(self, crop_hw=(256, 128), width: int = 768, layers: int = 12, heads: int = 12,
                 patch_size: int = 16, proj_dim: int = 512):
        super().__init__()
        self.width, self.layers = width, layers
        self.feature_dim = width + proj_dim
        n = (crop_hw[0] // patch_size) * (crop_hw[1] // patch_size)
        scale = width ** -0.5
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(width) * scale)
        self.positional_embedding = nn.Parameter(torch.randn(n + 1, width) * scale)
        self.ln_pre = nn.LayerNorm(width, eps=LN_EPS)
        for i in range(layers):
            setattr(self, f"resblock{i}", ResidualAttentionBlock(width, heads))
        self.ln_post = nn.LayerNorm(width, eps=LN_EPS)
        self.proj = nn.Parameter(torch.randn(width, proj_dim) * scale)
        self.bottleneck = BiasFreeBatchNorm1d(width)
        self.bottleneck_proj = BiasFreeBatchNorm1d(proj_dim)

    def forward(self, x):
        x = self.conv1(x).flatten(2).transpose(1, 2)
        B = x.shape[0]
        x = torch.cat([self.class_embedding.expand(B, 1, -1), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding)
        for i in range(self.layers):
            x = getattr(self, f"resblock{i}")(x)
        feat = self.ln_post(x)[:, 0]
        return torch.cat([self.bottleneck(feat), self.bottleneck_proj(feat @ self.proj)], dim=-1)


def build_clip_reid(crop_hw=(256, 128)) -> ClipReID:
    return ClipReID(crop_hw=crop_hw)


class ClipTextEncoder(nn.Module):
    """CLIP text transformer over embedded prompts: positional embedding,
    causal blocks, ``ln_final``, the end-of-text row projected."""

    def __init__(self, width: int = 512, layers: int = 12, heads: int = 8, context: int = 16,
                 proj_dim: int = 512):
        super().__init__()
        self.layers = layers
        self.positional_embedding = nn.Parameter(torch.randn(context, width) * 0.01)
        for i in range(layers):
            setattr(self, f"resblock{i}", ResidualAttentionBlock(width, heads, causal=True))
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.randn(width, proj_dim) * width ** -0.5)

    def forward(self, prompts, eot_idx):
        """prompts (B, N, width); eot_idx an int or (B,) -> (B, proj_dim)."""
        x = prompts + self.positional_embedding[:prompts.shape[1]]
        for i in range(self.layers):
            x = getattr(self, f"resblock{i}")(x)
        x = self.ln_final(x)
        eot = torch.as_tensor(eot_idx, device=x.device).expand(x.shape[0])
        return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection


class PromptLearner(nn.Module):
    """Per-identity learned context inside a fixed prompt template: shared
    prefix and suffix embeddings around ``n_cls_ctx`` vectors per identity."""

    def __init__(self, num_classes: int, width: int = 512, n_prefix: int = 5,
                 n_cls_ctx: int = 4, n_suffix: int = 2):
        super().__init__()
        self.seq_len = n_prefix + n_cls_ctx + n_suffix
        self.eot_index = self.seq_len - 1
        self.token_prefix = nn.Parameter(torch.randn(n_prefix, width) * 0.02)
        self.token_suffix = nn.Parameter(torch.randn(n_suffix, width) * 0.02)
        self.cls_ctx = nn.Parameter(torch.randn(num_classes, n_cls_ctx, width) * 0.02)

    def forward(self, labels):  # (B,) identity labels
        B = labels.shape[0]
        return torch.cat([self.token_prefix.expand(B, -1, -1), self.cls_ctx[labels],
                          self.token_suffix.expand(B, -1, -1)], dim=1)


def pretrained_prompt_template(token_embedding, template: str = "A photo of a X X X X person.",
                               n_cls_ctx: int = 4):
    """The template embedded with pretrained token embeddings (the port's BPE
    tokenizer), split around the identity context slots as the reference
    PromptLearner splits it; rows past EOT dropped.  Returns (prefix,
    suffix, eot_index), the first two float32 numpy arrays."""
    from boxmot_tpu_torch.models.clip_tokenizer import tokenize  # noqa: PLC0415

    ids = tokenize(template)[0]
    eot = int(ids.argmax())  # EOT has the largest id in the vocabulary
    emb = np.asarray(token_embedding, np.float32)[ids[:eot + 1]]
    n_prefix = 1 + 4  # SOT + "a photo of a"
    return emb[:n_prefix], emb[n_prefix + n_cls_ctx:], eot


def clip_prompt_losses(image_feats, text_feats, labels, temperature: float = 0.07):
    """Symmetric supervised contrastive i2t + t2i objective (CLIP-ReID stage
    1): positives are all pairs that share an identity."""
    img = image_feats / torch.clamp_min(torch.linalg.vector_norm(image_feats, dim=1,
                                                                 keepdim=True), 1e-12)
    txt = text_feats / torch.clamp_min(torch.linalg.vector_norm(text_feats, dim=1,
                                                                keepdim=True), 1e-12)
    logits = img @ txt.T / temperature
    same = labels[:, None] == labels[None, :]

    def supcon(lg, pos):
        logp = F.log_softmax(lg, dim=1)
        n_pos = torch.clamp_min(pos.sum(dim=1), 1)
        return -torch.mean(torch.where(pos, logp, 0.0).sum(dim=1) / n_pos)

    return supcon(logits, same) + supcon(logits.T, same)
