"""The ReID trainer's optimizer profiles, with optax's semantics, in PyTorch.

Counterpart of ``boxmot_tpu/reid/training/optim.py``.  The rules:
ViT-family models (``vit_*``, ``csl_tinyvit*``, ``clip``) train with AdamW,
global-norm clipping at 1.0, a per-layer LR scale (``layer_decay`` or
``reid_lrd``) and no weight decay on bias / norm / token parameters; CNNs
with Adam and the L2 term folded into the gradient, unclipped.  The center
head gets SGD at ``center_lr`` on gradients scaled by
``1 / center_loss_weight``.  The head-warmup and backbone-freeze windows
and the LR profile are per-parameter scales applied to the update after
the optimizer's step, so the moments keep integrating while a window holds
(the JAX package's documented divergence from the reference's
``requires_grad_(False)``).

Every mask and scale is keyed by a parameter's Flax path
(``"backbone/block3/attn/qkv/kernel"``, from ``models/convert.py::
flax_paths``), never by the port's PyTorch name: OSNet's torchreid names
(``fc.1.weight`` for Flax's ``fc_bn/scale``) would otherwise give another
no-WD set.  ``ProfileOptimizer`` is the optax chain written out on tensors:

* ``clip_by_global_norm(c)``: the updates scaled by ``c / ||g||`` only when
  ``||g|| >= c`` (the norm over the main chain's leaves; PyTorch's
  ``clip_grad_norm_`` divides by ``||g|| + 1e-6`` always);
* ``scale_by_adam``: moments, then bias correction by ``1 - b^count`` with
  the count already incremented, ``mu_hat / (sqrt(nu_hat) + 1e-8)``;
* AdamW adds ``wd * p`` after Adam; Adam adds it to the gradient before;
* ``scale_by_learning_rate(schedule)``: ``-schedule(count)`` with the count
  before this step (the first step's LR is ``base_lr / 25``).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

_VIT_PREFIXES = ("vit_", "csl_tinyvit", "clip")
_NO_WD_KEYWORDS = ("bias", "cls_token", "pos_embed", "norm", "ln", "bn", "in_norm", "gate",
                   "bottleneck", "margin_head")
_HEAD_PREFIXES = ("classifier", "margin_head", "bottleneck", "proj", "os_agg", "neck_",
                  "bn_global", "bn_part", "head", "neck", "feature_fusion")
_BLOCK_RE = re.compile(r"^block(\d+)$")       # ViTNano blocks
_STAGE_RE = re.compile(r"^(?:s|merge)(\d+)")  # CSL-TinyViT stage blocks/merges
_STEM_PREFIXES = ("patch_embed", "cls_token", "pos_embed", "pe_conv")
_REID_LRD_SCALES = (0.05, 0.10, 0.25, 0.50)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def is_vit_model(name: str) -> bool:
    return name.startswith(_VIT_PREFIXES)


def resolve_profile(optimizer: str, grad_clip: float, model: str) -> tuple[str, float]:
    """Optimizer '' and grad_clip < 0 resolve by backbone family."""
    vit = is_vit_model(model)
    opt = optimizer.lower() if optimizer else ("adamw" if vit else "adam")
    if opt not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {opt!r}; supported: adam, adamw")
    clip = grad_clip if grad_clip >= 0 else (1.0 if vit else 0.0)
    return opt, clip


def _is_head_path(parts: list[str]) -> bool:
    if parts and parts[0] != "backbone":
        return parts[0].startswith(("classifier", "margin_head"))
    if len(parts) >= 2:
        return parts[1].startswith(_HEAD_PREFIXES)
    return False


def _layer_index(module: str) -> int | None:
    m = _BLOCK_RE.match(module) or _STAGE_RE.match(module)
    return int(m.group(1)) if m else None


def lr_scales(paths, profile: str, layer_decay: float) -> dict:
    """Flax path -> LR scale: ``layer_decay`` puts the stem at ``d **
    (depth + 1)`` ... the last block at ``d`` and heads at 1; ``reid_lrd``
    0.05 / 0.10 / 0.25 / 0.50 for the stem and the first blocks; ``none``
    1 everywhere."""
    depth = 0
    for path in paths:
        parts = path.split("/")
        if len(parts) >= 2 and parts[0] == "backbone":
            idx = _layer_index(parts[1])
            if idx is not None:
                depth = max(depth, idx + 1)

    def scale_for(path) -> float:
        parts = path.split("/")
        if profile == "none" or _is_head_path(parts) or parts[0] != "backbone":
            return 1.0
        module = parts[1]
        if module.startswith(_STEM_PREFIXES):
            layer_id = 0
        else:
            idx = _layer_index(module)
            layer_id = depth + 1 if idx is None else idx + 1
        if profile == "reid_lrd":
            if layer_id == 0:
                return _REID_LRD_SCALES[0]
            if layer_id <= len(_REID_LRD_SCALES):
                return _REID_LRD_SCALES[layer_id - 1]
            return 1.0
        return layer_decay ** (depth + 1 - layer_id)

    return {p: scale_for(p) for p in paths}


def wd_mask(paths) -> dict:
    """Flax path -> whether weight decay applies."""
    return {p: not any(kw in p.lower() for kw in _NO_WD_KEYWORDS) for p in paths}


def window_scales(paths, head_warmup_lr_mult: float) -> tuple[dict, dict]:
    """(freeze, warmup) scales: heads at 1 / at the warmup multiple, the
    backbone at 0, the center head at 1 in both."""
    def per(path, head_value):
        parts = path.split("/")
        if parts[0] == "center":
            return 1.0
        return head_value if _is_head_path(parts) else 0.0

    return ({p: per(p, 1.0) for p in paths}, {p: per(p, head_warmup_lr_mult) for p in paths})


class ProfileOptimizer:
    """The JAX ``build_tx`` chain (module docstring) over ``params``, a dict
    of Flax path -> tensor; ``update(grads)`` returns the updates (to add
    to the parameters after any per-parameter scale)."""

    def __init__(self, params: dict, opt: str, grad_clip: float, schedule, weight_decay: float,
                 center_loss_weight: float = 0.0, center_lr: float = 0.5):
        self.opt, self.grad_clip, self.schedule = opt, grad_clip, schedule
        self.weight_decay, self.center_lr = weight_decay, center_lr
        self.center = {p for p in params if p.split("/")[0] == "center"} \
            if center_loss_weight > 0 else set()
        self.center_scale = 1.0 / center_loss_weight if self.center else 0.0
        self.main = [p for p in params if p not in self.center]
        self.decay = wd_mask(self.main)
        self.count = 0
        self.mu = {p: torch.zeros_like(params[p]) for p in self.main}
        self.nu = {p: torch.zeros_like(params[p]) for p in self.main}

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": {p: t.cpu() for p, t in self.mu.items()},
                "nu": {p: t.cpu() for p, t in self.nu.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for name in ("mu", "nu"):
            mine = getattr(self, name)
            for p, t in state[name].items():
                mine[p] = t.to(mine[p].device, mine[p].dtype)

    @torch.no_grad()
    def update(self, grads: dict, params: dict) -> dict:
        out = {}
        g = {p: grads[p] for p in self.main}
        if self.grad_clip > 0:  # no host read: the trigger stays on the device
            norm = torch.sqrt(sum(torch.sum(t * t) for t in g.values()))
            keep = norm < self.grad_clip
            g = {p: torch.where(keep, t, t / norm * self.grad_clip) for p, t in g.items()}
        if self.opt == "adam":  # L2 folded into the gradient
            g = {p: t + self.weight_decay * params[p] if self.decay[p] else t
                 for p, t in g.items()}
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - ADAM_B1 ** self.count
        c2 = 1.0 - ADAM_B2 ** self.count
        for p, t in g.items():
            self.mu[p] = (1 - ADAM_B1) * t + ADAM_B1 * self.mu[p]
            self.nu[p] = (1 - ADAM_B2) * t * t + ADAM_B2 * self.nu[p]
            u = (self.mu[p] / c1) / (torch.sqrt(self.nu[p] / c2) + ADAM_EPS)
            if self.opt == "adamw" and self.decay[p]:
                u = u + self.weight_decay * params[p]
            out[p] = -lr * u
        for p in self.center:
            out[p] = -self.center_lr * (self.center_scale * grads[p])
        return out


def warmup_cosine(base_lr: float, warmup_steps: int, steps: int):
    """``optax.warmup_cosine_decay_schedule(base_lr / 25, base_lr,
    warmup_steps, max(steps, warmup_steps + 1), base_lr / 1000)`` as a
    function of the step count, in float32 as optax evaluates it."""
    f32 = np.float32
    init, peak, end = base_lr / 25, base_lr, base_lr / 1000
    decay_steps = max(steps, warmup_steps + 1) - warmup_steps
    alpha = end / peak

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(init - peak) * frac + f32(peak))
        t = min(f32(count - warmup_steps), f32(decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay_steps)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule
