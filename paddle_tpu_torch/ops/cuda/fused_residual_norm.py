"""Fused residual add + RMSNorm, forward and backward, for Hopper.

Replaces the Pallas TPU kernels ``fused_residual_rms_norm_fwd`` and
``fused_residual_rms_norm_bwd`` of
``paddle_tpu/ops/pallas/fused_residual_norm.py`` (the RMS half; the
LayerNorm twins, kernels #9-#10, arrive with GPT's glue-fusion slice),
with the same entries and arithmetic:

* :func:`fused_residual_rms_norm_fwd` ``(x, y, w, eps)`` on 2-D ``[rows,
  h]`` -> ``(res, normed, rstd)``: ``res = x + y`` in the input dtype,
  ``normed = res * rsqrt(mean(res^2) + eps) * w`` with fp32 stats, rstd
  fp32 ``[rows, 1]``;
* :func:`fused_residual_rms_norm_bwd` ``(res, w, rstd, dres, dnormed)``
  -> ``(d, dw)``: ``d`` the shared cotangent of x and y, ``dw`` summed
  over rows in fp32 and cast to w's dtype; ``dres=None`` is zero;
* :func:`fused_residual_rms_norm` ``(x, y, weight, eps)`` over the last
  axis, differentiable: a ``torch.library`` custom op whose autograd
  rule saves ``(res, w, rstd)`` (not x and y), as the JAX custom_vjp
  does, and returns ``d`` for both x and y.

The kernels (``csrc/fused_residual_norm.cu``; design notes in the
source) read each row once. CPU tensors take the plain versions
(:func:`fused_residual_rms_norm_fwd_plain`,
:func:`fused_residual_rms_norm_bwd_plain`); CUDA tensors launch the
kernels (counted in ``fused_residual_rms_norm_fwd.launches`` and
``fused_residual_rms_norm_bwd.launches``, one per call: the backward's
call is its row kernel and the small kernel that sums the dw partials)
or raise.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["fused_residual_rms_norm", "fused_residual_rms_norm_fwd",
           "fused_residual_rms_norm_bwd", "fused_residual_rms_norm_fwd_plain",
           "fused_residual_rms_norm_bwd_plain", "FUSED_RMS_FWD_OP"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fns = None


def _kernels():
    global _fns
    if _fns is None:
        from ._build import load
        lib = load("fused_residual_norm")
        fwd = lib.pdt_rms_fwd
        fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd = lib.pdt_rms_bwd
        bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        lib.pdt_rms_bwd_rows.argtypes = []
        lib.pdt_rms_bwd_rows.restype = ctypes.c_int
        lib.pdt_rms_max_h.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.pdt_rms_max_h.restype = ctypes.c_int
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fwd, bwd, lib.pdt_rms_bwd_rows(), lib.pdt_rms_max_h,
                lib.pdt_cuda_error_string)
    return _fns


# ------------------------------------------------------ plain versions --
def fused_residual_rms_norm_fwd_plain(x, y, w, eps=1e-6):
    """Plain PyTorch forward (any device): ``_rrms_fwd_block``."""
    r = x + y
    r32 = r.float()
    rstd = torch.rsqrt(r32.square().mean(dim=1, keepdim=True) + eps)
    return r, (r32 * rstd * w.float()).to(r.dtype), rstd


def fused_residual_rms_norm_bwd_plain(res, w, rstd, dres, dnormed):
    """Plain PyTorch backward (any device): ``_rrms_bwd_block`` over all
    rows at once; ``dres=None`` is zero."""
    xhat = res.float() * rstd
    g = dnormed.float()
    wg = g * w.float()
    c = (wg * xhat).mean(dim=1, keepdim=True)
    d = rstd * (wg - xhat * c)
    if dres is not None:
        d = dres.float() + d
    return d.to(res.dtype), (g * xhat).sum(dim=0).to(w.dtype)


# ------------------------------------------------------------ kernels --
def _check_rows(name, tensors, h, dtype):
    for tname, t in tensors:
        if t.dim() != 2 or t.shape[1] != h:
            raise ValueError(f"{name}: {tname} must be [rows, {h}], got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {tname} is {t.dtype}, not {dtype}")


def _vec_ok(tensors, h):
    per = 16 // tensors[0].element_size()
    return h % per == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _device(name, tensors):
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def _raise_rc(what, rc, err_str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")


def _kernel_ready(name, tensors, h, vec, max_h):
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"{name}: float32 or bfloat16 rows, got {dt}")
    limit = max_h(_DTYPE_CODE[dt], int(vec))
    if h > limit:
        raise ValueError(f"{name}: row width {h} exceeds the kernel's "
                         f"{limit} for {dt} rows"
                         + ("" if vec else " not 16-byte aligned"))


def fused_residual_rms_norm_fwd(x, y, w, eps=1e-6):
    """The forward kernel's wrapper on 2-D ``[rows, h]``: ``(res, normed,
    rstd)`` as :func:`fused_residual_rms_norm_fwd_plain` gives them."""
    name = "fused_residual_rms_norm_fwd"
    n, h = x.shape
    _check_rows(name, (("x", x), ("y", y)), h, x.dtype)
    if tuple(w.shape) != (h,):
        raise ValueError(f"{name}: w must be [{h}], got {tuple(w.shape)}")
    dev = _device(name, (x, y, w))
    if dev.type == "cpu":
        return fused_residual_rms_norm_fwd_plain(x, y, w, eps)
    fwd, _, _, max_h, err_str = _kernels()
    x, y = x.contiguous(), y.contiguous()
    vec = _vec_ok((x, y), h)
    _kernel_ready(name, (x,), h, vec, max_h)
    w32 = w.float().contiguous()
    res = torch.empty_like(x)
    normed = torch.empty_like(x)
    rstd = torch.empty(n, 1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fwd(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                 w32.data_ptr(), res.data_ptr(), normed.data_ptr(),
                 rstd.data_ptr(), n, h, float(eps), int(vec), stream)
    _raise_rc(name, rc, err_str)
    fused_residual_rms_norm_fwd.launches += 1
    return res, normed, rstd


fused_residual_rms_norm_fwd.launches = 0


def fused_residual_rms_norm_bwd(res, w, rstd, dres, dnormed):
    """The backward kernels' wrapper: ``(d, dw)`` as
    :func:`fused_residual_rms_norm_bwd_plain` gives them; ``dres=None``
    is zero (the kernel reads no residual cotangent then)."""
    name = "fused_residual_rms_norm_bwd"
    n, h = res.shape
    rows = (("dnormed", dnormed),) + (() if dres is None
                                      else (("dres", dres),))
    _check_rows(name, rows, h, res.dtype)
    if tuple(w.shape) != (h,) or tuple(rstd.shape) != (n, 1) or \
            rstd.dtype != torch.float32:
        raise ValueError(f"{name}: w must be [{h}] and rstd float32 "
                         f"[{n}, 1], got {tuple(w.shape)}, {rstd.dtype} "
                         f"{tuple(rstd.shape)}")
    dev = _device(name, [res, w, rstd, dnormed]
                  + ([] if dres is None else [dres]))
    if dev.type == "cpu":
        return fused_residual_rms_norm_bwd_plain(res, w, rstd, dres, dnormed)
    _, bwd, brows, max_h, err_str = _kernels()
    res, dnormed = res.contiguous(), dnormed.contiguous()
    dres = None if dres is None else dres.contiguous()
    rows_t = [res, dnormed] + ([] if dres is None else [dres])
    vec = _vec_ok(rows_t, h)
    _kernel_ready(name, (res,), h, vec, max_h)
    w32, rstd = w.float().contiguous(), rstd.contiguous()
    d = torch.empty_like(res)
    part = torch.empty(-(-n // brows), h, dtype=torch.float32, device=dev)
    dw = torch.empty(h, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = bwd(_DTYPE_CODE[res.dtype], res.data_ptr(), w32.data_ptr(),
                 rstd.data_ptr(), None if dres is None else dres.data_ptr(),
                 dnormed.data_ptr(), d.data_ptr(), part.data_ptr(),
                 dw.data_ptr(), n, h, int(vec), stream)
    _raise_rc(name, rc, err_str)
    fused_residual_rms_norm_bwd.launches += 1
    return d, dw.to(w.dtype)


fused_residual_rms_norm_bwd.launches = 0


# ------------------------------------------------ autograd custom op --
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
    if interpret:
        raise ValueError("fused_residual_rms_norm: interpret= is a Pallas "
                         "mode; the port runs the plain PyTorch version "
                         "for CPU tensors")
    shape = x.shape
    if y.shape != shape:
        raise ValueError(f"fused_residual_rms_norm: x {tuple(shape)} and y "
                         f"{tuple(y.shape)} differ")
    dt = torch.promote_types(x.dtype, y.dtype)
    h = shape[-1]
    r, o, _ = _rms_fwd_op(x.to(dt).reshape(-1, h), y.to(dt).reshape(-1, h),
                          weight, float(eps))
    return r.reshape(shape), o.reshape(shape)
