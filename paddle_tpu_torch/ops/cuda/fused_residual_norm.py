"""Fused residual add + norm, forward and backward, for Hopper.

Replaces the Pallas TPU kernels of
``paddle_tpu/ops/pallas/fused_residual_norm.py``, with the same entries
and arithmetic:

* :func:`fused_residual_rms_norm_fwd` ``(x, y, w, eps)`` on 2-D ``[rows,
  h]`` -> ``(res, normed, rstd)``: ``res = x + y`` in the input dtype,
  ``normed = res * rsqrt(mean(res^2) + eps) * w`` with fp32 stats, rstd
  fp32 ``[rows, 1]``;
* :func:`fused_residual_rms_norm_bwd` ``(res, w, rstd, dres, dnormed)``
  -> ``(d, dw)``: ``d`` the shared cotangent of x and y, ``dw`` summed
  over rows in fp32 and cast to w's dtype; ``dres=None`` is zero;
* :func:`fused_residual_layer_norm_fwd` ``(x, y, w, b, eps)`` -> ``(res,
  normed, mean, rstd)``: LayerNorm of ``res`` with two-pass fp32 stats;
* :func:`fused_residual_layer_norm_bwd` ``(res, w, mean, rstd, dres,
  dnormed)`` -> ``(d, dw, db)``;
* :func:`fused_residual_rms_norm` ``(x, y, weight, eps)`` and
  :func:`fused_residual_layer_norm` ``(x, y, weight, bias, eps)`` over
  the last axis, differentiable: ``torch.library`` custom ops whose
  autograd rule saves ``(res, w, rstd)`` / ``(res, w, mean, rstd)`` (not
  x and y), as the JAX custom_vjps do, and returns ``d`` for both x and
  y.

The kernels (``csrc/fused_residual_norm.cu``, the row kernels of
``csrc/row_norm.cuh``) read each row once, and w (and b) in their own
dtype. CPU tensors take the plain versions (``*_plain``); CUDA tensors
launch the kernels (counted in each wrapper's ``launches``, one per
call; each backward is one kernel, ``ln_bwd_kernel`` templated on the
norm, planned by ``norms.ln_bwd_plan``) or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import norms as _n

__all__ = ["fused_residual_rms_norm", "fused_residual_rms_norm_fwd",
           "fused_residual_rms_norm_bwd", "fused_residual_rms_norm_fwd_plain",
           "fused_residual_rms_norm_bwd_plain", "FUSED_RMS_FWD_OP",
           "fused_residual_layer_norm", "fused_residual_layer_norm_fwd",
           "fused_residual_layer_norm_bwd",
           "fused_residual_layer_norm_fwd_plain",
           "fused_residual_layer_norm_bwd_plain", "FUSED_LN_FWD_OP"]

_fns = None


def _kernels():
    global _fns
    if _fns is None:
        from ._build import load
        lib = load("fused_residual_norm")
        fwd = lib.pdt_rms_fwd
        fwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        lib.pdt_rms_max_h.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.pdt_rms_max_h.restype = ctypes.c_int
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        lfwd = lib.pdt_rln_fwd
        lfwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                         + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                 ctypes.c_void_p])
        lfwd.restype = ctypes.c_int
        _fns = (fwd, lib.pdt_rms_max_h, lib.pdt_cuda_error_string, lfwd,
                _n.ln_bwd_entries(lib))
    return _fns


# ------------------------------------------------------ plain versions --
def fused_residual_rms_norm_fwd_plain(x, y, w, eps=1e-6):
    """Plain PyTorch forward (any device): ``_rrms_fwd_block``."""
    r = x + y
    normed, rstd = _n.rms_norm_fwd_plain(r, w, eps)
    return r, normed, rstd


def fused_residual_rms_norm_bwd_plain(res, w, rstd, dres, dnormed):
    """Plain PyTorch backward (any device): ``_rrms_bwd_block`` over all
    rows at once; ``dres=None`` is zero."""
    d, dw, _ = _n.norm_bwd32(res, w, None, rstd, dnormed)
    if dres is not None:
        d = dres.float() + d
    return d.to(res.dtype), dw.to(w.dtype)


def fused_residual_layer_norm_fwd_plain(x, y, w, b, eps=1e-5):
    """Plain PyTorch forward (any device): ``_rln_fwd_block``."""
    r = x + y
    normed, mean, rstd = _n.layer_norm_fwd_plain(r, w, b, eps)
    return r, normed, mean, rstd


def fused_residual_layer_norm_bwd_plain(res, w, mean, rstd, dres,
                                        dnormed):
    """Plain PyTorch backward (any device): ``_rln_bwd_block`` over all
    rows at once; ``dres=None`` is zero."""
    d, dw, db = _n.norm_bwd32(res, w, mean, rstd, dnormed)
    if dres is not None:
        d = dres.float() + d
    return d.to(res.dtype), dw.to(w.dtype), db.to(w.dtype)


# ------------------------------------------------------------ kernels --
def _bwd_rows(res, dres, dnormed):
    return (("res", res), ("dnormed", dnormed)) + (
        () if dres is None else (("dres", dres),))


def fused_residual_rms_norm_fwd(x, y, w, eps=1e-6):
    """The forward kernel's wrapper on 2-D ``[rows, h]``: ``(res, normed,
    rstd)`` as :func:`fused_residual_rms_norm_fwd_plain` gives them."""
    name = "fused_residual_rms_norm_fwd"
    n, h = x.shape
    _n.check_rows(name, (("x", x), ("y", y)), h, x.dtype)
    _n.check_vectors(name, (("w", w),), h)
    dev = _n.device_of(name, (x, y, w))
    if dev.type == "cpu":
        return fused_residual_rms_norm_fwd_plain(x, y, w, eps)
    fwd, max_h, err_str, _, _ = _kernels()
    x, y = x.contiguous(), y.contiguous()
    vec = _n.vec_ok((x, y), h)
    _n.kernel_ready(name, x, h, vec, max_h)
    wdt, w, _ = _n.weight_vectors(w)
    res = torch.empty_like(x)
    normed = torch.empty_like(x)
    rstd = torch.empty(n, 1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fwd(_n.DTYPE_CODE[x.dtype], _n.DTYPE_CODE[wdt], x.data_ptr(),
                 y.data_ptr(), w.data_ptr(), res.data_ptr(),
                 normed.data_ptr(), rstd.data_ptr(), n, h, float(eps),
                 int(vec), stream)
    _n.raise_rc(name, rc, err_str)
    fused_residual_rms_norm_fwd.launches += 1
    return res, normed, rstd


fused_residual_rms_norm_fwd.launches = 0


def _residual_bwd(name, res, w, mean, rstd, dres, dnormed):
    """Check and launch the backward (one kernel) of the LayerNorm pair,
    or of the RMS pair with ``mean`` None: ``(d, dw, db)`` with ``db``
    None for RMS; None on CPU tensors."""
    n, h = res.shape
    _n.check_rows(name, _bwd_rows(res, dres, dnormed), h, res.dtype)
    _n.check_vectors(name, (("w", w),), h)
    stats = (("rstd", rstd),) + (() if mean is None else (("mean", mean),))
    _n.check_stats(name, stats, n)
    dev = _n.device_of(name, [res, w, dnormed] + [s for _, s in stats]
                       + ([] if dres is None else [dres]))
    if dev.type == "cpu":
        return None
    _, max_h, err_str, _, entries = _kernels()
    res, dnormed = res.contiguous(), dnormed.contiguous()
    dres = None if dres is None else dres.contiguous()
    rows_t = [res, dnormed] + ([] if dres is None else [dres])
    vec = _n.vec_ok(rows_t, h)
    _n.kernel_ready(name, res, h, vec, max_h)
    _, wk, _ = _n.weight_vectors(w)
    norm = _n._RMS if mean is None else _n._LAYER
    d, dwdb = _n.ln_bwd_launch(name, entries, err_str, norm, res, wk,
                               None if mean is None else mean.contiguous(),
                               rstd.contiguous(), dres, dnormed, vec)
    return (d, dwdb[0].to(w.dtype),
            None if mean is None else dwdb[1].to(w.dtype))


def fused_residual_rms_norm_bwd(res, w, rstd, dres, dnormed):
    """The backward kernel's wrapper: ``(d, dw)`` as
    :func:`fused_residual_rms_norm_bwd_plain` gives them; ``dres=None``
    is zero (the kernel reads no residual cotangent then)."""
    got = _residual_bwd("fused_residual_rms_norm_bwd", res, w, None, rstd,
                        dres, dnormed)
    if got is None:
        return fused_residual_rms_norm_bwd_plain(res, w, rstd, dres, dnormed)
    if res.shape[0]:          # no rows, no launch
        fused_residual_rms_norm_bwd.launches += 1
    return got[:2]


fused_residual_rms_norm_bwd.launches = 0


def fused_residual_layer_norm_fwd(x, y, w, b, eps=1e-5):
    """The forward kernel's wrapper on 2-D ``[rows, h]``: ``(res, normed,
    mean, rstd)`` as :func:`fused_residual_layer_norm_fwd_plain` gives
    them."""
    name = "fused_residual_layer_norm_fwd"
    n, h = x.shape
    _n.check_rows(name, (("x", x), ("y", y)), h, x.dtype)
    _n.check_vectors(name, (("w", w), ("b", b)), h)
    dev = _n.device_of(name, (x, y, w, b))
    if dev.type == "cpu":
        return fused_residual_layer_norm_fwd_plain(x, y, w, b, eps)
    _, max_h, err_str, fwd, _ = _kernels()
    x, y = x.contiguous(), y.contiguous()
    vec = _n.vec_ok((x, y), h)
    _n.kernel_ready(name, x, h, vec, max_h)
    wdt, w, b = _n.weight_vectors(w, b)
    res = torch.empty_like(x)
    normed = torch.empty_like(x)
    mean = torch.empty(n, 1, dtype=torch.float32, device=dev)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fwd(_n.DTYPE_CODE[x.dtype], _n.DTYPE_CODE[wdt], x.data_ptr(),
                 y.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr(),
                 normed.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, h,
                 float(eps), int(vec), stream)
    _n.raise_rc(name, rc, err_str)
    fused_residual_layer_norm_fwd.launches += 1
    return res, normed, mean, rstd


fused_residual_layer_norm_fwd.launches = 0


def fused_residual_layer_norm_bwd(res, w, mean, rstd, dres, dnormed):
    """The backward kernel's wrapper: ``(d, dw, db)`` as
    :func:`fused_residual_layer_norm_bwd_plain` gives them;
    ``dres=None`` is zero (the kernel reads no residual cotangent
    then)."""
    got = _residual_bwd("fused_residual_layer_norm_bwd", res, w, mean,
                        rstd, dres, dnormed)
    if got is None:
        return fused_residual_layer_norm_bwd_plain(res, w, mean, rstd, dres,
                                                   dnormed)
    if res.shape[0]:          # no rows, no launch
        fused_residual_layer_norm_bwd.launches += 1
    return got


fused_residual_layer_norm_bwd.launches = 0


# ----------------------------------------------- autograd custom ops --
@torch.library.custom_op("paddle_tpu_torch::fused_residual_rms_norm_fwd",
                         mutates_args=())
def _rms_fwd_op(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                eps: float) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    return fused_residual_rms_norm_fwd(x, y, w, eps)


@_rms_fwd_op.register_fake
def _(x, y, w, eps):
    return (x.new_empty(x.shape), x.new_empty(x.shape),
            x.new_empty(x.shape[0], 1, dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    _, _, w, _ = inputs
    res, _, rstd = output
    ctx.save_for_backward(res, w, rstd)
    # an unused output's cotangent arrives as None, not a zero tensor:
    # the kernel then reads no dres (LLaMA's final norm discards res)
    ctx.set_materialize_grads(False)


def _backward(ctx, dres, dnormed, _drstd):
    res, w, rstd = ctx.saved_tensors
    if dnormed is None:
        dnormed = torch.zeros_like(res)
    d, dw = fused_residual_rms_norm_bwd(res, w, rstd, dres, dnormed)
    return d, d, dw, None


_rms_fwd_op.register_autograd(_backward, setup_context=_setup_context)

FUSED_RMS_FWD_OP = torch.ops.paddle_tpu_torch.fused_residual_rms_norm_fwd \
    .default


def fused_residual_rms_norm(x, y, weight, eps=1e-6, rows=None,
                            interpret=None):
    """Fused residual + RMSNorm over the last axis: x, y ``[..., h]`` ->
    ``(res, normed)``, differentiable (the fused backward kernel).
    ``rows`` (the TPU row block) is accepted for API parity and not
    read; ``interpret`` (a Pallas mode) is refused."""
    return _residual_entry("fused_residual_rms_norm", x, y, interpret,
                           lambda a, b: _rms_fwd_op(a, b, weight,
                                                    float(eps))[:2])


def _residual_entry(name, x, y, interpret, op):
    """x, y ``[..., h]`` (promoted to one dtype) through ``op`` on their
    ``[rows, h]`` views -> ``(res, normed)`` in x's shape."""
    if interpret:
        raise ValueError(f"{name}: interpret= is a Pallas mode; the port "
                         f"runs the plain PyTorch version for CPU tensors")
    shape = x.shape
    if y.shape != shape:
        raise ValueError(f"{name}: x {tuple(shape)} and y "
                         f"{tuple(y.shape)} differ")
    dt = torch.promote_types(x.dtype, y.dtype)
    h = shape[-1]
    r, o = op(x.to(dt).reshape(-1, h), y.to(dt).reshape(-1, h))
    return r.reshape(shape), o.reshape(shape)


@torch.library.custom_op("paddle_tpu_torch::fused_residual_layer_norm_fwd",
                         mutates_args=())
def _ln_fwd_op(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor, eps: float) -> tuple[
                   torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return fused_residual_layer_norm_fwd(x, y, w, b, eps)


@_ln_fwd_op.register_fake
def _(x, y, w, b, eps):
    stat = x.new_empty(x.shape[0], 1, dtype=torch.float32)
    return (x.new_empty(x.shape), x.new_empty(x.shape), stat,
            stat.new_empty(stat.shape))


def _ln_setup_context(ctx, inputs, output):
    _, _, w, _, _ = inputs
    res, _, mean, rstd = output
    ctx.save_for_backward(res, w, mean, rstd)
    # a None cotangent of res (GPT's final norm discards it): no dres
    ctx.set_materialize_grads(False)


def _ln_backward(ctx, dres, dnormed, _dmean, _drstd):
    res, w, mean, rstd = ctx.saved_tensors
    if dnormed is None:
        dnormed = torch.zeros_like(res)
    d, dw, db = fused_residual_layer_norm_bwd(res, w, mean, rstd, dres,
                                              dnormed)
    return d, d, dw, db, None


_ln_fwd_op.register_autograd(_ln_backward, setup_context=_ln_setup_context)

FUSED_LN_FWD_OP = torch.ops.paddle_tpu_torch.fused_residual_layer_norm_fwd \
    .default


def fused_residual_layer_norm(x, y, weight, bias, eps=1e-5, rows=None,
                              interpret=None):
    """Fused residual + LayerNorm over the last axis: x, y ``[..., h]`` ->
    ``(res, normed)``, differentiable (the fused backward kernel).
    ``rows`` and ``interpret`` as :func:`fused_residual_rms_norm`."""
    return _residual_entry("fused_residual_layer_norm", x, y, interpret,
                           lambda a, b: _ln_fwd_op(a, b, weight, bias,
                                                   float(eps))[:2])
