"""``layer_norm`` (the port of ``paddle_tpu/nn/functional/norm.py``'s),
black-listed by the AMP rule, so it runs in fp32 under auto_cast. The
JAX package's opt-in Pallas norms (kernels #13-#16) are not ported; this
is torch's layer norm."""
from __future__ import annotations

import torch.nn.functional as F

from ...amp import amp_cast_inputs

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp_cast_inputs("layer_norm", (x, weight, bias))
    return F.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)
