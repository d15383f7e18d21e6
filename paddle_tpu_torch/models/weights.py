"""Load the JAX package's GPT and LLaMA weights into the port's modules.

``paddle_tpu`` names its parameters ``gpt.block_{i}.attn.qkv.weight``
and ``llama.layer_{i}.attn.q_proj.weight``, and stores every ``Linear``
weight ``[in, out]`` (``paddle_tpu/nn/layers.py``; an untied LLaMA
``lm_head`` too); the port's ``nn.Linear`` is ``[out, in]`` and its
blocks live in ``gpt.blocks.{i}`` and ``llama.layers.{i}``. The fused
qkv keeps the JAX column order ``[3, heads, head_dim]``, so a transpose
of every 2-D weight except the embedding tables is the whole conversion.
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["gpt_state_from_jax", "gpt_state_to_jax", "load_gpt_from_jax",
           "llama_state_from_jax", "llama_state_to_jax",
           "load_llama_from_jax"]

_BLOCK = re.compile(r"^gpt\.block_(\d+)\.")
_TBLOCK = re.compile(r"^gpt\.blocks\.(\d+)\.")
_LAYER = re.compile(r"^llama\.layer_(\d+)\.")
_TLAYER = re.compile(r"^llama\.layers\.(\d+)\.")
# 2-D weights that are embedding tables (row = token/position), not Linear
_EMBEDDINGS = ("gpt.wte.weight", "gpt.wpe.weight",
               "llama.embed_tokens.weight")


def _from_jax(named_numpy, root, layer, tlayer, who):
    out = {}
    for key, arr in named_numpy.items():
        arr = np.asarray(arr, dtype=np.float32)
        if not (key.startswith(root) or key.startswith("lm_head.")):
            raise KeyError(f"{who}: unexpected key {key!r}")
        tkey = layer.sub(tlayer, key)
        if (arr.ndim == 2 and key.endswith(".weight")
                and key not in _EMBEDDINGS):
            arr = arr.T
        out[tkey] = torch.tensor(arr)   # a copy, contiguous
    return out


def _to_jax(named_tensors, tlayer, layer):
    out = {}
    for key, t in named_tensors.items():
        arr = t.detach().float().cpu().numpy()
        jkey = tlayer.sub(layer, key)
        if (arr.ndim == 2 and key.endswith(".weight")
                and key not in _EMBEDDINGS):
            arr = arr.T
        out[jkey] = np.ascontiguousarray(arr)
    return out


def _load(model, state, who):
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"{who}: missing keys {missing}, "
                       f"unexpected keys {extra}")
    bad = [f"{k}: got {tuple(v.shape)}, want {tuple(want[k].shape)}"
           for k, v in state.items() if v.shape != want[k].shape]
    if bad:
        raise ValueError(f"{who}: shape mismatch: " + "; ".join(bad))
    model.load_state_dict(state, strict=True)
    return model


def gpt_state_from_jax(named_numpy: dict) -> dict:
    """Map the JAX model's ``state_dict()`` (as numpy arrays) to a torch
    ``state_dict`` for :class:`~paddle_tpu_torch.models.gpt.
    GPTForCausalLM`: ``block_{i}`` -> ``blocks.{i}``, every 2-D
    ``Linear`` weight transposed, everything float32."""
    return _from_jax(named_numpy, "gpt.", _BLOCK, r"gpt.blocks.\1.",
                     "gpt_state_from_jax")


def load_gpt_from_jax(model, named_numpy: dict):
    """Copy the JAX weights into ``model`` (on whatever device it lives
    on). A missing key, an extra key or a wrong shape raises before any
    parameter changes."""
    return _load(model, gpt_state_from_jax(named_numpy), "load_gpt_from_jax")


def gpt_state_to_jax(named_tensors: dict) -> dict:
    """The inverse of :func:`gpt_state_from_jax`: torch names and layout
    (a ``state_dict()``, or ``{name: p.grad}`` over
    ``named_parameters()``) -> the JAX model's names (``block_{i}``) and
    layout (``Linear`` weights ``[in, out]``), as float32 numpy arrays."""
    return _to_jax(named_tensors, _TBLOCK, r"gpt.block_\1.")


def llama_state_from_jax(named_numpy: dict) -> dict:
    """Map the JAX LLaMA's ``state_dict()`` (as numpy arrays) to a torch
    ``state_dict`` for :class:`~paddle_tpu_torch.models.llama.
    LlamaForCausalLM`: ``layer_{i}`` -> ``layers.{i}``, every 2-D
    ``Linear`` weight (``lm_head`` included) transposed, the embedding
    table not, everything float32."""
    return _from_jax(named_numpy, "llama.", _LAYER, r"llama.layers.\1.",
                     "llama_state_from_jax")


def load_llama_from_jax(model, named_numpy: dict):
    """Copy the JAX LLaMA weights into ``model`` (on whatever device it
    lives on). A missing key, an extra key or a wrong shape raises before
    any parameter changes."""
    return _load(model, llama_state_from_jax(named_numpy),
                 "load_llama_from_jax")


def llama_state_to_jax(named_tensors: dict) -> dict:
    """The inverse of :func:`llama_state_from_jax`: torch names and layout
    (a ``state_dict()``, or ``{name: p.grad}``) -> the JAX model's names
    (``layer_{i}``) and layout, as float32 numpy arrays."""
    return _to_jax(named_tensors, _TLAYER, r"llama.layer_\1.")
