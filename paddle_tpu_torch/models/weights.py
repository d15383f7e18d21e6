"""Load the JAX package's GPT weights into the port's modules.

``paddle_tpu`` names its parameters ``gpt.block_{i}.attn.qkv.weight``
and stores every ``Linear`` weight ``[in, out]``
(``paddle_tpu/nn/layers.py``); the port's ``nn.Linear`` is ``[out,
in]`` and its blocks live in ``gpt.blocks.{i}``. The fused qkv keeps the
JAX column order ``[3, heads, head_dim]``, so a transpose is the whole
conversion.
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["gpt_state_from_jax", "gpt_state_to_jax", "load_gpt_from_jax"]

_BLOCK = re.compile(r"^gpt\.block_(\d+)\.")
_TBLOCK = re.compile(r"^gpt\.blocks\.(\d+)\.")
# 2-D weights that are embedding tables (row = token/position), not Linear
_EMBEDDINGS = ("gpt.wte.weight", "gpt.wpe.weight")


def gpt_state_from_jax(named_numpy: dict) -> dict:
    """Map the JAX model's ``state_dict()`` (as numpy arrays) to a torch
    ``state_dict`` for :class:`~paddle_tpu_torch.models.gpt.
    GPTForCausalLM`: ``block_{i}`` -> ``blocks.{i}``, every 2-D
    ``Linear`` weight transposed, everything float32."""
    out = {}
    for key, arr in named_numpy.items():
        arr = np.asarray(arr, dtype=np.float32)
        if not (key.startswith("gpt.") or key.startswith("lm_head.")):
            raise KeyError(f"gpt_state_from_jax: unexpected key {key!r}")
        tkey = _BLOCK.sub(r"gpt.blocks.\1.", key)
        if (arr.ndim == 2 and key.endswith(".weight")
                and key not in _EMBEDDINGS):
            arr = arr.T
        out[tkey] = torch.tensor(arr)   # a copy, contiguous
    return out


def load_gpt_from_jax(model, named_numpy: dict):
    """Copy the JAX weights into ``model`` (on whatever device it lives
    on). A missing key, an extra key or a wrong shape raises before any
    parameter changes."""
    state = gpt_state_from_jax(named_numpy)
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"load_gpt_from_jax: missing keys {missing}, "
                       f"unexpected keys {extra}")
    bad = [f"{k}: got {tuple(v.shape)}, want {tuple(want[k].shape)}"
           for k, v in state.items() if v.shape != want[k].shape]
    if bad:
        raise ValueError("load_gpt_from_jax: shape mismatch: "
                         + "; ".join(bad))
    model.load_state_dict(state, strict=True)
    return model


def gpt_state_to_jax(named_tensors: dict) -> dict:
    """The inverse of :func:`gpt_state_from_jax`: torch names and layout
    (a ``state_dict()``, or ``{name: p.grad}`` over
    ``named_parameters()``) -> the JAX model's names (``block_{i}``) and
    layout (``Linear`` weights ``[in, out]``), as float32 numpy arrays."""
    out = {}
    for key, t in named_tensors.items():
        arr = t.detach().float().cpu().numpy()
        jkey = _TBLOCK.sub(r"gpt.block_\1.", key)
        if (arr.ndim == 2 and key.endswith(".weight")
                and key not in _EMBEDDINGS):
            arr = arr.T
        out[jkey] = np.ascontiguousarray(arr)
    return out
