"""Metric-learning losses and loss heads for ReID training, in PyTorch.

Counterpart of ``boxmot_tpu/reid/training/losses.py``: cross-entropy with
label smoothing, batch-hard triplet (hard or soft margin),
Multi-Similarity, Circle, and the ``ArcFaceHead``, ``CosFaceHead`` and
``CenterHead`` modules, which carry parameters in the Flax modules' names
and layouts (``weight`` of (feat, classes), ``centers`` of (classes,
feat)).  Batch-hard mining takes ``amax`` / ``amin``, which share a tie's
gradient as JAX's ``max`` / ``min`` do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def cross_entropy_label_smooth(logits, targets, epsilon: float = 0.1):
    """The batch mean of the smoothed one-hot cross-entropy, summed over
    classes."""
    num_classes = logits.shape[-1]
    log_probs = F.log_softmax(logits, dim=-1)
    smooth = (1 - epsilon) * F.one_hot(targets, num_classes).to(logits.dtype) + epsilon / num_classes
    return torch.sum(torch.mean(-smooth * log_probs, dim=0))


def _pairwise_dist(feats):
    sq = torch.sum(feats ** 2, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * feats @ feats.T
    return torch.sqrt(torch.clamp_min(d2, 1e-12))


def _unit(feats):
    return feats / torch.clamp_min(torch.linalg.vector_norm(feats, dim=1, keepdim=True), 1e-12)


def triplet_loss(feats, targets, margin: float = 0.3, soft_margin: bool = False):
    """Batch-hard triplet; an anchor without a positive or a negative counts
    as 0 / a margin's worth, as in JAX."""
    dist = _pairwise_dist(feats)
    same = targets[:, None] == targets[None, :]
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    dist_ap = torch.amax(torch.where(same, dist, -inf), dim=1)
    dist_an = torch.amin(torch.where(~same, dist, inf), dim=1)
    dist_ap = torch.where(torch.isfinite(dist_ap), dist_ap, 0.0)
    dist_an = torch.where(torch.isfinite(dist_an), dist_an, dist_ap + margin)
    if soft_margin:
        return torch.mean(F.softplus(dist_ap - dist_an + margin))
    return torch.mean(torch.clamp_min(dist_ap - dist_an + margin, 0.0))


def multi_similarity_loss(feats, targets, alpha: float = 2.0, beta: float = 50.0,
                          thresh: float = 0.5, mining_margin: float = 0.1):
    """Multi-Similarity loss with masked pair mining."""
    sim = _unit(feats) @ _unit(feats).T
    n = sim.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=sim.device)
    pos = (targets[:, None] == targets[None, :]) & ~eye
    neg = targets[:, None] != targets[None, :]
    inf = torch.tensor(float("inf"), dtype=sim.dtype, device=sim.device)
    max_neg = torch.amax(torch.where(neg, sim, -inf), dim=1)
    min_pos = torch.amin(torch.where(pos, sim, inf), dim=1)
    pos_m = pos & (sim < (max_neg + mining_margin)[:, None])
    neg_m = neg & (sim > (min_pos - mining_margin)[:, None])
    pos_term = torch.where(pos_m, torch.exp(-alpha * (sim - thresh)), 0.0).sum(dim=1)
    neg_term = torch.where(neg_m, torch.exp(beta * (sim - thresh)), 0.0).sum(dim=1)
    loss = torch.log1p(pos_term) / alpha + torch.log1p(neg_term) / beta
    any_pair = pos_m.any(dim=1) | neg_m.any(dim=1)
    return torch.where(any_pair, loss, 0.0).sum() / torch.clamp_min(any_pair.sum(), 1)


def circle_loss(feats, targets, margin: float = 0.25, gamma: float = 64.0):
    """Circle loss."""
    sim = _unit(feats) @ _unit(feats).T
    n = sim.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=sim.device)
    pos = (targets[:, None] == targets[None, :]) & ~eye
    neg = targets[:, None] != targets[None, :]
    ap = torch.clamp_min(1 + margin - sim, 0.0)
    an = torch.clamp_min(sim + margin, 0.0)
    logit_p = -gamma * ap * (sim - (1 - margin))
    logit_n = gamma * an * (sim - margin)
    lse_p = torch.logsumexp(torch.where(pos, logit_p, float("-inf")), dim=1)
    lse_n = torch.logsumexp(torch.where(neg, logit_n, float("-inf")), dim=1)
    valid = torch.isfinite(lse_p) & torch.isfinite(lse_n)
    loss = F.softplus(torch.where(valid, lse_p + lse_n, 0.0))
    return torch.where(valid, loss, 0.0).sum() / torch.clamp_min(valid.sum(), 1)


class ArcFaceHead(nn.Module):
    """Additive-angular-margin classifier head: the loss of its logits."""

    def __init__(self, feat_dim: int, num_classes: int, scale: float = 30.0,
                 margin: float = 0.5):
        super().__init__()
        self.num_classes, self.scale, self.margin = num_classes, scale, margin
        self.weight = nn.Parameter(nn.init.xavier_uniform_(torch.empty(feat_dim, num_classes)))

    def forward(self, feats, targets):
        wn = self.weight / torch.clamp_min(torch.linalg.vector_norm(self.weight, dim=0,
                                                                    keepdim=True), 1e-12)
        cos = torch.clamp(_unit(feats) @ wn, -1 + 1e-7, 1 - 1e-7)
        marg = torch.cos(torch.arccos(cos) + self.margin)
        one_hot = F.one_hot(targets, self.num_classes).to(cos.dtype)
        logits = self.scale * (one_hot * marg + (1 - one_hot) * cos)
        return cross_entropy_label_smooth(logits, targets, epsilon=0.0)


class CosFaceHead(nn.Module):
    """Large-margin cosine classifier head: the loss of its logits."""

    def __init__(self, feat_dim: int, num_classes: int, scale: float = 30.0,
                 margin: float = 0.35):
        super().__init__()
        self.num_classes, self.scale, self.margin = num_classes, scale, margin
        self.weight = nn.Parameter(nn.init.xavier_uniform_(torch.empty(feat_dim, num_classes)))

    def forward(self, feats, targets):
        wn = self.weight / torch.clamp_min(torch.linalg.vector_norm(self.weight, dim=0,
                                                                    keepdim=True), 1e-12)
        cos = _unit(feats) @ wn
        one_hot = F.one_hot(targets, self.num_classes).to(cos.dtype)
        return cross_entropy_label_smooth(self.scale * (cos - one_hot * self.margin), targets,
                                          epsilon=0.0)


class CenterHead(nn.Module):
    """Center loss with learned per-class centers."""

    def __init__(self, num_classes: int, feat_dim: int):
        super().__init__()
        self.centers = nn.Parameter(torch.randn(num_classes, feat_dim))

    def forward(self, feats, targets):
        return 0.5 * torch.mean(torch.sum((feats - self.centers[targets]) ** 2, dim=1))

