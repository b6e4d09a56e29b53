"""The benchmark's own detector and ReID models: seeded weights made on the
card, and the plain forward of each.

``frozen/models/{yolox,osnet}.py`` are frozen copies of the port's module
definitions (plain ``torch.nn`` layers), so that a state dict made here
loads into the port's models and into these alike.  The weights are made
from ``--seed`` by a ``torch.Generator`` on the card, in two calls (normal
and uniform draws), then the batch norms are calibrated on the cell's own
frames (the recipe of ``chip_smoke.py::yolox_checkpoint`` and
``calibrate_batch_norms``): He-scaled convolutions, the class and
objectness predictions at a gain of 16 and the box regression at 1, batch
norm scales in [0.5, 1.5], small biases, and each batch norm's statistics
set to mean 0 and variance the mean square of its input (at least 1).  A
random net with PyTorch's default initialization gives the same output for
every input.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from portbench.reference.frozen.models.osnet import build_osnet
from portbench.reference.frozen.models.yolox import build_yolox

GAINS = {"cls_preds": 16.0, "obj_preds": 16.0, "reg_preds": 1.0}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))


def seed_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Fill every convolution, linear layer and batch norm of ``model`` from
    two draws of ``gen`` on the model's device."""
    convs = [(name, m) for name, m in model.named_modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    norms = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    dev = next(model.parameters()).device
    n_normal = sum(m.weight.numel() + (m.bias.numel() if m.bias is not None else 0)
                   for _, m in convs) + sum(m.bias.numel() for m in norms)
    normal = torch.randn(n_normal, generator=gen, device=dev)
    uniform = torch.rand(sum(m.weight.numel() for m in norms), generator=gen, device=dev)
    i = j = 0

    def take(src, k, n):
        return src[k:k + n], k + n

    with torch.no_grad():
        for name, m in convs:
            fan_in = m.weight[0].numel()
            gain = GAINS.get(name.split(".")[-2], 2.0) if "." in name else 2.0
            if isinstance(m, nn.Linear):
                gain = 1.0
            w, i = take(normal, i, m.weight.numel())
            m.weight.copy_(w.view_as(m.weight) * math.sqrt(gain / fan_in))
            if m.bias is not None:
                b, i = take(normal, i, m.bias.numel())
                m.bias.copy_(b * 0.1)
        for m in norms:
            u, j = take(uniform, j, m.weight.numel())
            m.weight.copy_(u + 0.5)
            b, i = take(normal, i, m.bias.numel())
            m.bias.copy_(b * 0.1)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def calibrate_batch_norms(model: nn.Module, x: torch.Tensor, floor: float = 1.0) -> None:
    """Set each 2-d batch norm's running statistics from ``x``'s forward pass
    in eval mode, layer after layer: mean 0 and variance the mean square of
    its input, at least ``floor`` (``chip_smoke.py::calibrate_batch_norms``)."""
    def hook(mod, inputs):
        sq = inputs[0].detach().double().square().mean(dim=(0, 2, 3))
        mod.running_mean.zero_()
        mod.running_var.copy_(sq.clamp_min(floor).to(mod.running_var.dtype))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, nn.BatchNorm2d)]
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        for h in handles:
            h.remove()


def calibrate_train_statistics(model: nn.Module, x: torch.Tensor) -> None:
    """Each batch norm's running statistics become the mean and variance of
    its input over ``x`` (a forward in training mode, cumulative averages),
    the embedding head's too.  So each layer's output is normalized and a
    ReID embedding varies with its crop as a trained one does between
    identities (cosine similarities about 0.3 rather than 0.95): with the
    means left in, the features of all crops nearly coincide, an
    association's costs tie, and the auction runs to its iteration cap."""
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.momentum = None
            m.reset_running_stats()
    with torch.no_grad():
        model.train()(x)
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.momentum = 0.1
    model.eval()


def yolox(name: str, num_classes: int, device) -> nn.Module:
    with torch.device(device):
        return build_yolox(name, num_classes=num_classes).eval()


def osnet(name: str, device) -> nn.Module:
    with torch.device(device):
        return build_osnet(name).eval()


def embed(model: nn.Module, crops: torch.Tensor) -> torch.Tensor:
    """L2-normalized features of standardized crops (``reid/core.py::_embed``)."""
    with torch.no_grad():
        feats = model(crops).to(torch.float32)
    norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    return feats / torch.clamp_min(norm, 1e-12)


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 products and convolutions on for the block where ``enabled`` (the
    control), off otherwise; the flags as they were after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
