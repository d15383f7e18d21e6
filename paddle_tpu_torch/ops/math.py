"""``add`` (the port of ``paddle_tpu/ops/math.py``'s), cast by the AMP
rule: the GPT path's residual and embedding sums."""
from __future__ import annotations

from ..amp import amp_cast_inputs

__all__ = ["add"]


def add(x, y):
    x, y = amp_cast_inputs("add", (x, y))
    return x + y
