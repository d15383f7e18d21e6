"""Normalization functionals (the port of
``paddle_tpu/nn/functional/norm.py``'s ``layer_norm``, ``rms_norm`` and
``fused_residual_norm``).

``layer_norm`` and ``rms_norm`` are black-listed by the AMP rule, so
they run in fp32 under auto_cast; they are plain PyTorch, as the JAX
package's are jnp off a TPU (its opt-in Pallas norms, kernels #13-#16,
run only on a TPU with ``PDTPU_NORM_BACKEND=pallas`` and are not ported).
``fused_residual_norm(norm="rms")`` is the fused residual + RMSNorm
kernel (``ops/cuda/fused_residual_norm.py``, kernels #11-#12); its
LayerNorm twin (kernels #9-#10) arrives with GPT's glue-fusion slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import amp_cast_inputs
from ...ops.cuda import fused_residual_norm as _frn

__all__ = ["layer_norm", "rms_norm", "fused_residual_norm"]

_LAYER_GLUE = ("fused_residual_norm(norm='layer') is the fused residual + "
               "LayerNorm kernels #9-#10 of paddle_tpu/ops/pallas/"
               "fused_residual_norm.py, which arrive with the port's GPT "
               "glue-fusion slice")


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp_cast_inputs("layer_norm", (x, weight, bias))
    return F.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    """RMSNorm over the axes from ``begin_norm_axis`` on: fp32 mean of
    squares, ``(x * rsqrt(ms + eps))`` cast to x's dtype, then ``* weight
    + bias`` (the JAX op order)."""
    x, weight, bias = amp_cast_inputs("rms_norm", (x, weight, bias))
    axis = begin_norm_axis if begin_norm_axis >= 0 else \
        x.dim() + begin_norm_axis
    dims = tuple(range(axis, x.dim()))
    x32 = x.float()
    ms = x32.square().mean(dim=dims, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def fused_residual_norm(x, y, weight, bias=None, epsilon=None, norm="layer",
                        name=None):
    """Fused residual add + norm: ``(res, normed)`` with ``res = x + y``
    (the residual-stream value the next adder consumes) and ``normed``
    its norm, one kernel forward and one fused kernel backward. ``norm``
    is "layer" (weight + bias) or "rms" (weight only); callers gate on
    the ``train_glue_fusion`` flag."""
    if norm not in ("layer", "rms"):
        raise ValueError(f"norm must be 'layer' or 'rms', got {norm!r}")
    if norm == "layer" and bias is None:
        raise ValueError("fused_residual_norm(norm='layer') requires "
                         "bias (LayerNorm's affine pair)")
    eps = epsilon if epsilon is not None else \
        (1e-5 if norm == "layer" else 1e-6)
    if norm == "layer":
        raise NotImplementedError(_LAYER_GLUE)
    x, y, weight = amp_cast_inputs("fused_residual_norm", (x, y, weight))
    return _frn.fused_residual_rms_norm(x, y, weight, eps=eps)
