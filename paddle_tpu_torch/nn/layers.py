"""Layers of the port that torch has no counterpart for (the port of
``paddle_tpu/nn/layers.py``'s ``RMSNorm``)."""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    """RMSNorm over the trailing ``normalized_shape`` axes, weight
    initialised to ones. Not a ``torch.nn.LayerNorm``: AMP O2's
    ``decorate`` keeps LayerNorm parameters in fp32 and casts these to
    the low dtype, as the JAX package does."""

    def __init__(self, normalized_shape, epsilon=1e-6):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self._normalized_shape))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon,
                          begin_norm_axis=-len(self._normalized_shape))

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, " \
            f"epsilon={self._epsilon}"
