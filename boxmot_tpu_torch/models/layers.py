"""Normalization layers with the JAX package's Flax semantics.

* ``LN_EPS``: Flax ``nn.LayerNorm``'s epsilon, 1e-6 (PyTorch's default is
  1e-5); every transformer backbone's LayerNorm takes it.
* ``BiasFreeBatchNorm1d``: Flax ``nn.BatchNorm(use_bias=False)``, the
  BNNecks' batch norm.  Its bias is a zero buffer, not a parameter: a
  checkpoint's ``bias`` key still loads into it, and training leaves it
  at 0, as Flax has no such parameter to train.
* ``use_flax_batch_norm``: batch norms that train as Flax's do.  In train
  mode Flax normalizes with the batch mean and the variance ``E[x^2] -
  E[x]^2`` (clipped at 0), and moves its running statistics by ``0.99 *
  running + 0.01 * batch`` with that biased variance; PyTorch moves them by
  ``0.9 * running + 0.1 * batch`` with the unbiased one.  The function
  switches every batch norm of a model to ``FlaxBatchNorm1d`` /
  ``FlaxBatchNorm2d`` in place (parameters and buffers unchanged); in eval
  mode they are PyTorch's batch norms.
"""

from __future__ import annotations

import torch
from torch import nn

LN_EPS = 1e-6
FLAX_BN_MOMENTUM = 0.99


class BiasFreeBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose bias is a zero buffer (Flax ``use_bias=False``)."""

    def __init__(self, num_features: int, **kw):
        super().__init__(num_features, **kw)
        del self.bias
        self.register_buffer("bias", torch.zeros(num_features))


class _FlaxBatchNorm:
    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = x.mean(dims)
        var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(FLAX_BN_MOMENTUM).add_(mean.detach(), alpha=1 - FLAX_BN_MOMENTUM)
            self.running_var.mul_(FLAX_BN_MOMENTUM).add_(var.detach(), alpha=1 - FLAX_BN_MOMENTUM)
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


class FlaxBatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class FlaxBatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


def use_flax_batch_norm(model: nn.Module) -> nn.Module:
    """Every ``BatchNorm1d`` / ``BatchNorm2d`` of ``model`` trains with Flax's
    statistics (module docstring); returns ``model``."""
    for m in model.modules():
        if isinstance(m, _FlaxBatchNorm):
            continue
        if isinstance(m, nn.BatchNorm2d):
            m.__class__ = FlaxBatchNorm2d
        elif isinstance(m, nn.BatchNorm1d):
            m.__class__ = FlaxBatchNorm1d
    return model
