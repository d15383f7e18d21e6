"""``paddle.incubate.nn.functional`` of the port (the port of
``paddle_tpu/incubate/nn/functional/__init__.py``): the fused functionals
the LLaMA training path calls, each cast by the AMP rule.

* :func:`fused_rotary_position_embedding` ends in the rope kernel
  (``ops/cuda/rope.py``), as the JAX function always ends in the Pallas
  rope kernel;
* :func:`swiglu` is ``silu(x) * y``, plain PyTorch, as it is jnp there.

``fused_rms_norm``, ``fused_layer_norm``, ``fused_dropout_add`` and
``fused_matmul_bias`` are not ported: the first two reach the Pallas
norms (kernels #13-#16) only on a TPU and arrive with the norms slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ....amp import amp_cast_inputs
from ....ops.cuda import rope as _rope

__all__ = ["fused_rotary_position_embedding", "swiglu"]


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
