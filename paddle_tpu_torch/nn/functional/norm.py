"""Normalization functionals (the port of
``paddle_tpu/nn/functional/norm.py``'s ``layer_norm``, ``rms_norm`` and
``fused_residual_norm``).

``layer_norm`` and ``rms_norm`` are black-listed by the AMP rule, so
they run in fp32 under auto_cast. They are plain PyTorch, as the JAX
package's are jnp, unless the norm backend is on: on a card (the
counterpart of a TPU) with ``PDTPU_NORM_BACKEND=pallas``, read at each
call as the JAX package reads it, they take the norm kernels
(``ops/cuda/norms.py``, kernels #13-#16) under the JAX package's
conditions: LayerNorm over one axis with weight and bias, RMSNorm over
the last axis with a weight and no bias.

``fused_residual_norm`` is the fused residual + norm kernel pair
(``ops/cuda/fused_residual_norm.py``: "layer", kernels #9-#10; "rms",
kernels #11-#12), which the JAX package always takes.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ...amp import amp_cast_inputs
from ...ops.cuda import fused_residual_norm as _frn
from ...ops.cuda import norms as _norms

__all__ = ["layer_norm", "rms_norm", "fused_residual_norm"]

NORM_BACKEND_ENV = "PDTPU_NORM_BACKEND"


def on_card(device):
    """The counterpart of the JAX package's ``jax.default_backend() ==
    "tpu"``: the tensor lies on a CUDA card."""
    return device.type == "cuda"


def norm_backend(device):
    """The JAX package's ``_pallas_norms()`` switch: the norm kernels on a
    card with ``PDTPU_NORM_BACKEND=pallas``."""
    return on_card(device) and os.environ.get(NORM_BACKEND_ENV) == "pallas"


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp_cast_inputs("layer_norm", (x, weight, bias))
    if (norm_backend(x.device) and len(normalized_shape) == 1
            and weight is not None and bias is not None):
        return _norms.layer_norm(x, weight, bias, epsilon)
    return F.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    """RMSNorm over the axes from ``begin_norm_axis`` on: fp32 mean of
    squares, ``(x * rsqrt(ms + eps))`` cast to x's dtype, then ``* weight
    + bias`` (the JAX op order); the kernel computes ``x * rstd * w`` in
    fp32 and casts once, as the TPU kernel does."""
    x, weight, bias = amp_cast_inputs("rms_norm", (x, weight, bias))
    axis = begin_norm_axis if begin_norm_axis >= 0 else \
        x.dim() + begin_norm_axis
    if (norm_backend(x.device) and axis == x.dim() - 1
            and weight is not None and bias is None):
        return _norms.rms_norm(x, weight, epsilon)
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
    x, y, weight, bias = amp_cast_inputs("fused_residual_norm",
                                         (x, y, weight, bias))
    if norm == "layer":
        return _frn.fused_residual_layer_norm(x, y, weight, bias, eps=eps)
    return _frn.fused_residual_rms_norm(x, y, weight, eps=eps)
