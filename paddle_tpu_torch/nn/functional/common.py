"""``linear``, ``embedding`` and ``dropout`` (the port of
``paddle_tpu/nn/functional/common.py``), cast by the AMP rule.

``linear`` takes the torch layout: ``weight`` is ``[out, in]`` (the
JAX package's is ``[in, out]``; ``models/weights.py`` converts)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ...amp import amp_cast_inputs

__all__ = ["linear", "linear_layer", "embedding", "dropout"]


def linear(x, weight, bias=None):
    x, weight, bias = amp_cast_inputs("linear", (x, weight, bias))
    return F.linear(x, weight, bias)


def linear_layer(layer, x):
    """``x`` through a projection module: an ``nn.Linear`` as
    :func:`linear` of its weight and bias (cast by the AMP rule), any
    other module (a ``quantization.WeightOnlyLinear``) by its own
    forward."""
    if isinstance(layer, nn.Linear):
        return linear(x, layer.weight, layer.bias)
    return layer(x)


def embedding(x, weight):
    (weight,) = amp_cast_inputs("embedding", (weight,))
    return F.embedding(x, weight)


def dropout(x, p=0.5, training=True):
    """Inverted dropout (``upscale_in_train``). The mask comes from
    torch's generator, not the JAX key stream: the same ``p`` gives the
    same distribution, not the same bits."""
    if not training or p == 0.0:
        return x
    return F.dropout(x, p=p, training=True)
