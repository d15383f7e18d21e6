"""Paddle dtype names the port's training slice reads, mapped to torch
dtypes (the port's copy of the part of ``paddle_tpu/core/dtype.py``
that it needs)."""
from __future__ import annotations

import torch

_DTYPE_TABLE = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
_ALIASES = {"bf16": "bfloat16", "fp16": "float16"}

__all__ = ["to_torch_dtype"]


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a Paddle name (``"float32"``, ``"bfloat16"``,
    ``"float16"`` and their aliases) or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = _ALIASES.get(dtype, dtype)
    if name not in _DTYPE_TABLE:
        raise ValueError(f"unsupported dtype {dtype!r}; the port knows "
                         f"{sorted(_DTYPE_TABLE)}")
    return _DTYPE_TABLE[name]
