"""``matmul`` (the port of ``paddle_tpu/ops/linalg.py``'s, for the GPT
path's tied LM head), cast by the AMP rule."""
from __future__ import annotations

import torch

from ..amp import amp_cast_inputs

__all__ = ["matmul"]


def matmul(x, y, transpose_x=False, transpose_y=False):
    """``x @ y`` with optional transposes of the last two dims."""
    x, y = amp_cast_inputs("matmul", (x, y))
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
