"""Model FLOPs from layer shapes: two operations (a multiply and an add) for
every multiply-accumulate of each convolution and linear layer, counted by
running the benchmark's own copy of the model on the ``meta`` device, which
computes shapes and no values.  YOLOX-X with one class counts 281.0 GFLOP
at 640 x 640 so (its paper gives 281.9 with 80 classes).  Normalization,
activation and pooling operations are left out, as model FLOPs leave them
out."""

from __future__ import annotations

import torch
from torch import nn


def conv_linear_flops(model: nn.Module, input_shape) -> int:
    """FLOPs of one forward of ``model`` (built on the ``meta`` device) on an
    input of ``input_shape``."""
    total = 0

    def conv(mod, inputs, out):
        nonlocal total
        kh, kw = mod.kernel_size
        total += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw

    def linear(mod, inputs, out):
        nonlocal total
        total += 2 * out.numel() * mod.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, nn.Conv2d) else linear)
             for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            model.eval()(torch.empty(tuple(input_shape), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return total
