"""Rotary position embedding (rope) for Hopper.

Replaces the Pallas TPU kernel ``_rope_call`` (``_rope_kernel``) of
``paddle_tpu/ops/pallas/rope.py`` with the same public entry,
:func:`apply_rope` ``(x, cos, sin, use_neox=True)`` in paddle layout
``[batch, seq, num_heads, head_dim]``, and the same arithmetic:
``x * cos + rot(x) * sin`` in fp32, cast to x's dtype; ``use_neox=True``
pairs column i with i + D/2, ``False`` pairs 2i with 2i + 1. The tables
are ``[seq, head_dim]`` or, for per-example positions, ``[batch, seq,
head_dim]``, tiled to the full head_dim and read in fp32.

The kernel (``csrc/rope.cu``; its design notes are in the source) reads
x through its strides, so a transposed or time-major view goes in
without a copy, and writes a contiguous output. CPU tensors take
:func:`rope_plain`; CUDA tensors launch the kernel (counted in
``rope.launches``) or raise.

The gradient is registered on a ``torch.library`` custom op,
``paddle_tpu_torch::rope``. Rope is a rotation, whose transpose is the
rotation by -theta: the backward launches the same kernel with the sin
table negated, as the TPU kernel's custom_vjp does. The tables get no
gradient. Being a dispatcher op is what lets
``recompute(..., policy="dots_and_kernels_saveable")`` keep its output
instead of running it again in backward.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["apply_rope", "rope", "rope_plain", "ROPE_OP", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load
        lib = load("rope")
        f = lib.pdt_rope
        f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _fn = (f, lib.pdt_cuda_error_string)
    return _fn


def _tables(x, cos, sin):
    """fp32 [B or 1, S, D] views of the tables, checked against x."""
    b, s, _, d = x.shape
    cos, sin = cos.float(), sin.float()
    if cos.shape != sin.shape:
        raise ValueError(f"rope: cos {tuple(cos.shape)} and sin "
                         f"{tuple(sin.shape)} differ")
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    if cos.dim() != 3 or tuple(cos.shape[1:]) != (s, d) or \
            cos.shape[0] not in (1, b):
        raise ValueError(f"rope: tables must be [seq, head_dim] = [{s}, {d}]"
                         f" or [batch, seq, head_dim], got "
                         f"{tuple(cos.shape)}")
    return cos, sin


def rope_plain(x, cos, sin, use_neox=True):
    """Plain PyTorch version (any device): ``x * cos + rot(x) * sin`` in
    fp32, cast to x's dtype; x ``[B, S, H, D]``, tables ``[S, D]`` or
    ``[B, S, D]``."""
    cos, sin = _tables(x, cos, sin)
    xf = x.float()
    d = x.shape[-1]
    if use_neox:
        rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    else:
        pairs = xf.unflatten(-1, (d // 2, 2))
        rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1) \
            .flatten(-2)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return (xf * c + rot * s).to(x.dtype)


def _vec_ok(x, use_neox):
    """16-byte loads: x's rows start 16-byte aligned and each load's
    columns stay inside one half (half pairing) or one row."""
    per = 16 // x.element_size()
    span = x.shape[-1] // 2 if use_neox else x.shape[-1]
    return (span % per == 0 and x.data_ptr() % 16 == 0
            and all(st % per == 0 for st in x.stride()[:3]))


def rope(x, cos, sin, use_neox=True, neg_sin=False):
    """The kernel's wrapper: x ``[B, S, H, D]`` (any strides, last dim
    contiguous) rotated by the tables (by their negation with
    ``neg_sin``), returned contiguous in x's dtype. CPU tensors run
    :func:`rope_plain`; CUDA tensors launch the kernel or raise."""
    if x.dim() != 4:
        raise ValueError(f"rope: x must be [batch, seq, heads, head_dim], "
                         f"got {tuple(x.shape)}")
    b, s, h, d = x.shape
    if d % 2:
        raise ValueError(f"rope: head_dim {d} must be even")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rope: float32 or bfloat16 input, got {x.dtype}")
    cos, sin = _tables(x, cos, sin)
    if x.device.type == "cpu":
        return rope_plain(x, cos, -sin if neg_sin else sin, use_neox)
    if x.device.type != "cuda":
        raise ValueError(f"rope: no kernel for device {x.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"rope: head_dim {d} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    if {cos.device, sin.device} != {x.device}:
        raise ValueError(f"rope: tables on {cos.device}, x on {x.device}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    out = torch.empty(b, s, h, d, dtype=x.dtype, device=x.device)
    fn, err_str = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
                cos.data_ptr(), sin.data_ptr(), b, s, h, d, x.stride(0),
                x.stride(1), x.stride(2), int(cos.shape[0] != 1),
                int(bool(use_neox)), int(bool(neg_sin)),
                int(_vec_ok(x, use_neox)), stream)
    if rc != 0:
        raise RuntimeError(f"rope kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    rope.launches += 1
    return out


rope.launches = 0


# ------------------------------------------------ autograd custom op --
@torch.library.custom_op("paddle_tpu_torch::rope", mutates_args=())
def _rope_op(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             use_neox: bool) -> torch.Tensor:
    return rope(x, cos, sin, use_neox)


@_rope_op.register_fake
def _(x, cos, sin, use_neox):
    return x.new_empty(x.shape)


def _setup_context(ctx, inputs, output):
    _, cos, sin, use_neox = inputs
    ctx.save_for_backward(cos, sin)
    ctx.use_neox = use_neox


def _backward(ctx, g):
    cos, sin = ctx.saved_tensors
    # the transpose of the rotation by theta is the rotation by -theta
    return rope(g, cos, sin, ctx.use_neox, neg_sin=True), None, None, None


_rope_op.register_autograd(_backward, setup_context=_setup_context)

ROPE_OP = torch.ops.paddle_tpu_torch.rope.default


def apply_rope(x, cos, sin, use_neox=True, interpret=None):
    """Rotary embedding in paddle layout ``[batch, seq, num_heads,
    head_dim]``, differentiable in x. cos/sin: ``[seq, head_dim]`` or
    ``[batch, seq, head_dim]``, tiled to the full head_dim (for
    ``use_neox=True``: ``cos[s, i] = cos(s * inv_freq[i % (d/2)])``; for
    interleaved: ``inv_freq[i // 2]``), read in fp32. ``interpret`` (a
    Pallas mode) is refused: CPU tensors run the plain version."""
    if interpret:
        raise ValueError("apply_rope: interpret= is a Pallas mode; the port "
                         "runs the plain PyTorch version for CPU tensors")
    return _rope_op(x, cos.float(), sin.float(), bool(use_neox))
