"""The serving subset of ``paddle_tpu/quantization/__init__.py``:
weight-only int8 projections and the int8 KV-cache arithmetic.

* :func:`weight_quantize` / :func:`weight_dequantize` /
  :func:`weight_only_linear` keep the JAX package's layout at their
  boundary: a weight is ``[in, out]``, scales are one per output channel
  (absmax over the input axis / 127, a zero column gets scale 1, round
  half to even, then clip), so the int8 bytes and scales are bitwise the
  JAX package's;
* :class:`WeightOnlyLinear` replaces an ``nn.Linear`` (``[out, in]``)
  and stores ``qweight`` ``[out, in]`` int8, the layout the weight-only
  matmul kernel (``ops/cuda/quant_matmul.py``) streams: each output
  channel's row is contiguous along K. ``qweight`` and ``scale`` are
  buffers, so they travel with ``state_dict()`` and ``.to()``;
  :func:`weight_only_quantize` swaps every ``nn.Linear`` of a model in
  place;
* :func:`kv_quantize` / :func:`kv_dequantize` are the one home of the
  int8 KV page arithmetic: one absmax scale per (kv head, token slot),
  so a token's bytes depend on its own K/V vector alone and pages
  filled by prefill chunks or by decode hold the same bytes.

Not ported: ``weight_only_int4`` (packed nibbles), QAT/PTQ and
``fake_quant``; each raises ``NotImplementedError`` naming its slice.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.cuda.quant_matmul import weight_only_matmul

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "WeightOnlyLinear", "weight_only_quantize", "kv_quantize",
           "kv_dequantize", "KV_QUANT_QMAX", "fake_quant", "QAT", "PTQ"]

_INT4 = ("weight_only_int4 (two nibbles a byte) arrives with the port's "
         "int4 weight-only slice; use weight_only_int8")
_QAT = ("{} (quantization-aware training and post-training calibration) "
        "arrives with the port's quantized-training slice")


def _int8_algo(algo):
    if algo == "weight_only_int4":
        raise NotImplementedError(_INT4)
    if algo not in ("weight_only_int8", "abs_max"):
        raise ValueError(f"unsupported algo {algo!r}")


def weight_quantize(w, algo="weight_only_int8"):
    """``w`` ``[in, out]`` float -> ``(q [in, out] int8, scale [out]
    float32)``: per output channel absmax / 127 (a zero column gets scale
    1), ``q = clip(round(w / scale), -128, 127)`` with round half to
    even, as the JAX package computes it."""
    _int8_algo(algo)
    qmax = 127
    scale = w.abs().amax(dim=0) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax)
    return q.to(torch.int8), scale.to(torch.float32)


def weight_dequantize(qw, scale, algo="weight_only_int8",
                      out_dtype=torch.float32, in_features=None):
    """``qw`` ``[in, out]`` int8 times its per-channel ``scale`` ``[out]``,
    cast to ``out_dtype``. ``in_features`` is read by int4 only."""
    _int8_algo(algo)
    return (qw.to(torch.float32) * scale.to(torch.float32)).to(out_dtype)


def weight_only_linear(x, qweight, scale, bias=None, weight_dtype="int8"):
    """``x @ dequant(qweight, scale) + bias`` through the weight-only
    matmul (``ops/cuda/quant_matmul.py``): ``qweight`` ``[in, out]`` int8
    (a transposed view of an ``[out, in]`` buffer goes in without a
    copy), f32 accumulation, the scale applied once per output after the
    K reduction, the result cast to ``x.dtype`` before the bias add."""
    if weight_dtype in ("int4", "weight_only_int4"):
        raise NotImplementedError(_INT4)
    if weight_dtype not in ("int8", "weight_only_int8"):
        raise ValueError(f"unsupported weight_dtype {weight_dtype!r}")
    return weight_only_matmul(x, qweight, scale, bias=bias)


class WeightOnlyLinear(nn.Module):
    """Inference replica of an ``nn.Linear`` over int8 weights: forward
    is :func:`weight_only_linear`. ``qweight`` ``[out, in]`` int8 and
    ``scale`` ``[out]`` f32 are buffers on the linear's device; ``bias``
    is kept as it was."""

    def __init__(self, linear, algo="weight_only_int8"):
        super().__init__()
        _int8_algo(algo)
        with torch.no_grad():
            q, scale = weight_quantize(linear.weight.detach().t(), algo=algo)
        self.register_buffer("qweight", q.t().contiguous())
        self.register_buffer("scale", scale)
        self.bias = linear.bias
        self.weight_dtype = "int8"
        self.in_features = int(linear.in_features)
        self.out_features = int(linear.out_features)

    def forward(self, x):
        return weight_only_linear(x, self.qweight.t(), self.scale,
                                  self.bias, weight_dtype=self.weight_dtype)

    def extra_repr(self):
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}")


def weight_only_quantize(model, algo="weight_only_int8", min_features=1):
    """Swap every ``nn.Linear`` under ``model`` whose input dim is at
    least ``min_features`` for a :class:`WeightOnlyLinear`, in place;
    returns ``model``."""
    _int8_algo(algo)
    for name, child in list(model.named_children()):
        if isinstance(child, nn.Linear) \
                and child.in_features >= min_features:
            setattr(model, name, WeightOnlyLinear(child, algo=algo))
        else:
            weight_only_quantize(child, algo=algo,
                                 min_features=min_features)
    return model


# --- int8 KV-cache quantization (serving) ----------------------------------

KV_QUANT_QMAX = 127.0


def kv_quantize(x):
    """``[..., D]`` float K/V vectors -> ``(int8 [..., D], f32 scales
    [...])``: symmetric absmax per vector; an all-zero vector gets scale 1
    so the round trip stays exact."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1)
    sc = torch.where(amax > 0, amax / KV_QUANT_QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / sc[..., None]), -KV_QUANT_QMAX,
                    KV_QUANT_QMAX).to(torch.int8)
    return q, sc


def kv_dequantize(q, sc):
    """Inverse of :func:`kv_quantize` up to the int8 grid: ``int8 [...,
    D] * f32 [...]`` -> f32 ``[..., D]``."""
    return q.to(torch.float32) * sc.to(torch.float32)[..., None]


# --- not ported -------------------------------------------------------------

def fake_quant(x, scale, bits=8):
    raise NotImplementedError(_QAT.format("fake_quant"))


class QAT:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_QAT.format("QAT"))


class PTQ:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_QAT.format("PTQ"))
