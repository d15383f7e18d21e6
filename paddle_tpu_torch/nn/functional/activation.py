"""``gelu`` (the port of ``paddle_tpu/nn/functional/activation.py``'s),
cast by the AMP rule."""
from __future__ import annotations

import torch.nn.functional as F

from ...amp import amp_cast_inputs

__all__ = ["gelu"]


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form the GPT MLP uses."""
    (x,) = amp_cast_inputs("gelu", (x,))
    return F.gelu(x, approximate="tanh" if approximate else "none")
