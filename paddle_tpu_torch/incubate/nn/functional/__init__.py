"""``paddle.incubate.nn.functional`` of the port (the port of
``paddle_tpu/incubate/nn/functional/__init__.py``): the fused functionals
the training paths call, each cast by the AMP rule.

* :func:`fused_rotary_position_embedding` ends in the rope kernel
  (``ops/cuda/rope.py``), as the JAX function always ends in the Pallas
  rope kernel;
* :func:`swiglu` is ``silu(x) * y``, plain PyTorch, as it is jnp there;
* :func:`fused_rms_norm` and :func:`fused_layer_norm` pre-add ``bias``
  and ``residual`` and return ``(out, residual_out)``; on a card they
  take the norm kernels (``ops/cuda/norms.py``, kernels #13 and #15)
  under the JAX package's conditions (the last axis; RMS without a
  ``norm_bias``, Layer with weight and bias), as the JAX functions take
  the Pallas norms on a TPU, and otherwise the plain composition. The
  ``quant_*`` arguments are ignored, as the JAX functions ignore them.

``fused_dropout_add`` and ``fused_matmul_bias`` are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ....amp import amp_cast_inputs
from ....nn.functional import norm as _norm
from ....ops.cuda import norms as _norms
from ....ops.cuda import rope as _rope

__all__ = ["fused_rotary_position_embedding", "swiglu", "fused_rms_norm",
           "fused_layer_norm"]


def _default_angles(positions, d, interleaved):
    """Angles at ``positions`` (``[S]`` or ``[B, S]``) for base 10000,
    in fp32 as the JAX function computes them, tiled to ``[..., S, d]``:
    each frequency twice in a row (interleaved pairing) or the halves
    repeated (half pairing)."""
    inv = 1.0 / 10000.0 ** (torch.arange(0, d // 2, dtype=torch.float32,
                                         device=positions.device) * 2.0 / d)
    ang = positions[..., None].to(torch.float32) * inv
    if interleaved:
        return ang.repeat_interleave(2, dim=-1)
    return torch.cat([ang, ang], dim=-1)


def _flat_table(t, d):
    """``[S, D]`` or ``[1, S, 1, D]`` (or any shape whose leading dim, or
    third from last for 4-D, is S) -> ``[S, D]``."""
    return t.reshape(t.shape[-3] if t.dim() == 4 else t.shape[0], d)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False):
    """Rotary embedding of q (and k, v when given) in layout ``[batch,
    seq, num_heads, head_dim]`` (``[seq, batch, ...]`` with
    ``time_major``). ``sin``/``cos``: ``[seq, head_dim]`` or ``[1, seq,
    1, head_dim]``; without them the tables are computed for base 10000
    at ``position_ids`` (``[batch, seq]``) or at 0..seq-1. With tables,
    ``position_ids`` gathers per-example rows (clipped into the tables).

    Paddle's ``use_neox_rotary_style=True`` pairs adjacent elements (2i,
    2i+1) and ``False`` pairs the front and back halves: the *opposite*
    of the kernel's ``use_neox`` flag. Returns a 3-tuple: the rotated
    tensors in argument order, then ``None`` for the missing ones."""
    tensors = [q] + [t for t in (k, v) if t is not None]
    n = len(tensors)
    extra = ([position_ids] if position_ids is not None else []) + \
        ([sin, cos] if sin is not None else [])
    vals = amp_cast_inputs("fused_rotary_position_embedding",
                           tensors + extra)
    tensors, rest = vals[:n], vals[n:]
    if sin is not None:
        s_tab, c_tab = rest[-2], rest[-1]
        rest = rest[:-2]
    pid = rest[0] if position_ids is not None else None
    if time_major:
        tensors = [t.transpose(0, 1) for t in tensors]
    sq, d = tensors[0].shape[1], tensors[0].shape[-1]
    if sin is None:
        pos = (torch.arange(sq, device=tensors[0].device) if pid is None
               else pid)
        ang = _default_angles(pos, d, use_neox_rotary_style)
        c_tab, s_tab = torch.cos(ang), torch.sin(ang)
    else:
        c_tab, s_tab = _flat_table(c_tab, d), _flat_table(s_tab, d)
        if pid is not None:
            idx = pid.long().clamp(0, c_tab.shape[0] - 1)
            c_tab, s_tab = c_tab[idx], s_tab[idx]
    kernel_neox = not use_neox_rotary_style    # see the docstring
    outs = []
    for t in tensors:
        o = _rope.apply_rope(t, c_tab, s_tab, use_neox=kernel_neox)
        outs.append(o.transpose(0, 1) if time_major else o)
    return tuple(outs) + (None,) * (3 - n)


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; without y, x is split in halves along the last
    axis (``silu(first) * second``)."""
    vals = amp_cast_inputs("swiglu", [x] + ([y] if y is not None else []))
    if y is None:
        a, b = vals[0].chunk(2, dim=-1)
        return F.silu(a) * b
    return F.silu(vals[0]) * vals[1]


def _pre_add(v, bias, residual):
    """``v + bias + residual`` (the absent terms left out)."""
    if bias is not None:
        v = v + bias
    if residual is not None:
        v = v + residual
    return v


def _axis(begin_norm_axis, ndim):
    return begin_norm_axis if begin_norm_axis >= 0 else \
        ndim + begin_norm_axis


def fused_rms_norm(x, norm_weight, norm_bias, epsilon, begin_norm_axis,
                   bias=None, residual=None, quant_scale=-1,
                   quant_round_type=0, quant_max_bound=0, quant_min_bound=0):
    """RMSNorm of ``x + bias + residual`` over the axes from
    ``begin_norm_axis`` on: ``(out, residual_out)`` with
    ``residual_out`` the pre-added input. On a card, over the last axis
    and without ``norm_bias``, the kernel (``x * rstd * w`` in fp32, cast
    once); otherwise ``(x * rsqrt(ms + eps))`` cast, ``* w`` and ``+
    norm_bias``."""
    v, w, b, r, nb = amp_cast_inputs(
        "fused_rms_norm", (x, norm_weight, bias, residual, norm_bias))
    v = _pre_add(v, b, r)
    axis = _axis(begin_norm_axis, v.dim())
    if _norm.on_card(v.device) and axis == v.dim() - 1 and nb is None:
        return _norms.rms_norm(v, w, epsilon), v
    v32 = v.float()
    ms = v32.square().mean(dim=tuple(range(axis, v.dim())), keepdim=True)
    out = (v32 * torch.rsqrt(ms + epsilon)).to(v.dtype) * w
    if nb is not None:
        out = out + nb
    return out, v


def fused_layer_norm(x, norm_weight, norm_bias, epsilon, residual_alpha=1.0,
                     begin_norm_axis=1, bias=None, residual=None,
                     quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                     quant_min_bound=0):
    """LayerNorm of ``x + bias + residual_alpha * residual`` over the axes
    from ``begin_norm_axis`` on: ``(out, residual_out)``. Without weight
    and bias ``out`` is the pre-added input itself. On a card, over the
    last axis with both, the kernel; otherwise two-pass fp32 stats, the
    normalized value cast, then ``* w`` and ``+ norm_bias``."""
    v, w, nb, b, r = amp_cast_inputs(
        "fused_layer_norm", (x, norm_weight, norm_bias, bias, residual))
    v = _pre_add(v, b, None if r is None else residual_alpha * r)
    if w is None and nb is None:
        return v, v
    axis = _axis(begin_norm_axis, v.dim())
    if (_norm.on_card(v.device) and axis == v.dim() - 1
            and w is not None and nb is not None):
        return _norms.layer_norm(v, w, nb, epsilon), v
    v32 = v.float()
    dims = tuple(range(axis, v.dim()))
    mean = v32.mean(dim=dims, keepdim=True)
    var = (v32 - mean).square().mean(dim=dims, keepdim=True)
    out = ((v32 - mean) * torch.rsqrt(var + epsilon)).to(v.dtype)
    if w is not None:
        out = out * w
    if nb is not None:
        out = out + nb
    return out, v
