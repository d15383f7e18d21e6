"""Attention functionals (the port of
``paddle_tpu/nn/functional/attention.py``), in paddle layout ``[batch,
seq, num_heads, head_dim]``.

``scaled_dot_product_attention`` routes as the JAX package does, with
"eligible" meaning "no mask and no dropout" rather than "on a TPU":
``backend=None`` takes the flash-attention kernel
(``ops/cuda/flash_attention.py``) when eligible, ``"xla"`` takes
:func:`_sdpa_plain` (the counterpart of ``_sdpa_xla``, used by
``GPTConfig(use_flash_attention=False)``), ``"pallas"`` requires the
kernel. Attention dropout waits for a later slice (the kernel has no
random bits yet).
"""
from __future__ import annotations

import math

import torch

from ...amp import amp_cast_inputs
from ...ops.cuda import flash_attention as _fa

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_qkvpacked"]

_DROPOUT = ("attention dropout > 0 arrives with a later slice of the port "
            "(the flash kernel draws no random bits yet); train at "
            "dropout=0.0")


def _sdpa_plain(q, k, v, mask=None, causal=False, scale=None):
    """Unfused softmax(q k^T) v, as ``_sdpa_xla``: fp32 scores, -inf
    masking, probabilities cast to the input dtype before the product
    with v; GQA by repeating kv heads."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    d = qt.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    hq, hk = qt.shape[1], kt.shape[1]
    if hk != hq:
        rep = hq // hk
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * s
    if causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        idx_q = torch.arange(q_len, device=q.device)[:, None] + (k_len - q_len)
        idx_k = torch.arange(k_len, device=q.device)[None, :]
        logits = logits.masked_fill(~(idx_q >= idx_k), float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1).to(qt.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, backend=None):
    """paddle ``scaled_dot_product_attention`` (layout ``[batch, seq,
    num_heads, head_dim]``). ``backend``: None = the flash kernel when
    eligible (no mask, no dropout), "xla" = the unfused plain path,
    "pallas" = the kernel or an error."""
    if backend not in (None, "xla", "pallas"):
        raise ValueError(
            f"backend must be None, 'xla' or 'pallas'; got {backend!r}")
    drop = float(dropout_p) if training else 0.0
    if drop > 0.0:
        raise NotImplementedError(f"scaled_dot_product_attention: {_DROPOUT}")
    query, key, value, attn_mask = amp_cast_inputs(
        "scaled_dot_product_attention", (query, key, value, attn_mask))
    eligible = attn_mask is None
    if backend == "pallas" and not eligible:
        raise ValueError("backend='pallas' requires no attn_mask and "
                         "dropout_p == 0")
    if backend == "pallas" or (backend is None and eligible):
        return _fa.flash_attention(query, key, value, causal=is_causal)
    return _sdpa_plain(query, key, value, mask=attn_mask, causal=is_causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True):
    """paddle ``flash_attention``: returns ``(out, None)``."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, training=True):
    """paddle ``flash_attn_qkvpacked``: ``qkv`` is ``[batch, seq, 3,
    num_heads, head_dim]``."""
    q, k, v = qkv.unbind(2)
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)
