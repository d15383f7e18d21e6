"""Weight-only int8 matmul for Hopper: ``x @ dequant(qw, scale) [+ bias]``.

Replaces the Pallas TPU kernel ``_pallas_matmul`` (``paddle_tpu/ops/
pallas/quant_matmul.py``; entry ``weight_only_matmul``) with the same
contract:

* ``x`` ``[..., K]`` (any leading dims), ``qw`` ``[K, N]`` int8, ``scale``
  ``[N]``, ``bias`` ``[N]`` or None;
* fp32 accumulation; the per-channel scale applied ONCE per output
  element after the K reduction; the result cast to ``x.dtype`` BEFORE
  the bias add;
* the reference's custom VJP: ``gx = ((g * scale) @ qw^T)`` cast to x's
  dtype, ``gscale = sum_m g * (x @ qw)``, no gradient for the int8
  weight, the bias's as autograd gives it.

The kernels stream the weight as ``[N, K]`` rows (the ``nn.Linear``
layout ``quantization.WeightOnlyLinear`` stores), so ``qw`` is best
passed as the transposed view ``qweight.t()`` of such a buffer: it goes
in without a copy. A row-major ``[K, N]`` int8 matrix is transposed into
that layout once per call.

Two routes on a card, decided by :func:`route` from the number of rows
and x's dtype alone:

* ``"gemv"``: fp32 with at most 16 rows (a decode step): the
  weight-streaming GEMV of ``csrc/quant_matmul.cu`` on the tensor cores
  (``mma.sync``, the int8 weight converted to bf16 in registers, x as
  three bf16 planes, each 64-k block's products into a fresh
  accumulator), 256 output channels a CTA; where the channels do not
  fill the card's SMs, K is cut into slices (:func:`gemv_plan`,
  :func:`gemv_slices`) whose partial sums the last CTA of each channel
  block adds in slice order;
* ``"tc"``: every other call (every bf16 call; fp32 with more than 16
  rows, the serving engine's mixed step): the tensor-core kernel of
  ``csrc/quant_matmul_sm90.cu`` (``wgmma`` with the int8 weight
  converted to bf16 in registers; an fp32 x split first into three
  bf16 planes, hi, mid and lo, whose products are summed). A call whose
  K is not a multiple of 16 goes in with x and the int8 weight
  zero-padded to the next multiple: zeros add nothing to the sums.

Each launch counts in ``weight_only_matmul.launches``, a launch of the
``"tc"`` route also in ``weight_only_matmul.tc_launches``; a fault
raises, and no route
falls back to another. Other dtypes of x raise on a card. Under autograd
the launch sits in a ``torch.autograd.Function`` whose backward is the
reference's (plain PyTorch, as the reference's is plain jnp).

CPU tensors take :func:`quant_matmul_plain`, the plain PyTorch version
of the same function, through the same autograd rule. :func:`tolerance`
gives the limit of a card's result against that plain version.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["weight_only_matmul", "quant_matmul_plain", "route",
           "tolerance", "grad_tolerance", "gemv_plan", "gemv_slices"]

GEMV_MAX_ROWS = 16    # fp32 calls with at most this many rows: the GEMV
GEMV_CHANNELS = 256   # output channels of one GEMV CTA
GEMV_BLOCK = 64       # k of one GEMV accumulator block, the split unit
TC_K_MULTIPLE = 16    # the tensor-core kernel's K multiple (TMA row pitch)

_fn = None
_tc_fn = None
_sms: dict = {}   # device index -> SM count
_gemv_scratch: dict = {}   # (device, stream) -> split partials, tickets


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load
        lib = load("quant_matmul")
        f = lib.pdt_quant_matmul_f32
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        built = (lib.pdt_quant_matmul_gemv_rows(),
                 lib.pdt_quant_matmul_gemv_block())
        if built != (GEMV_CHANNELS, GEMV_BLOCK):
            raise RuntimeError(f"weight_only_matmul: the GEMV library plans "
                               f"(channels, k block) {built}, this module "
                               f"{(GEMV_CHANNELS, GEMV_BLOCK)}")
        _fn = (f, lib.pdt_cuda_error_string)
    return _fn


def gemv_plan(k, n, sms):
    """``(channel blocks, splits)`` of the GEMV for a ``[N, K]`` weight on
    a card with ``sms`` SMs: one CTA per block of ``GEMV_CHANNELS`` output
    channels and K-slice. Where the blocks leave SMs idle, K is cut into
    as many slices as fill them (at most one per ``GEMV_BLOCK`` of K), so
    every SM streams about the same bytes; else one slice."""
    blocks = -(-n // GEMV_CHANNELS)
    if blocks >= sms:
        return blocks, 1
    return blocks, max(1, min(sms // blocks, -(-k // GEMV_BLOCK)))


def gemv_slices(k, splits):
    """The ``(k0, k1)`` of each of the GEMV's K-slices, in the order the
    kernel adds their partial sums: whole ``GEMV_BLOCK``s, as even as
    they divide (the kernel's own rule)."""
    kb = -(-k // GEMV_BLOCK)
    return [(s * kb // splits * GEMV_BLOCK,
             min((s + 1) * kb // splits * GEMV_BLOCK, k))
            for s in range(splits)]


def _gemv_buffers(dev, stream, sms):
    """The GEMV's split partials and its channel blocks' tickets (int32
    zeros, put back to 0 by every launch) for one stream: splits > 1
    only when the blocks number fewer than the SMs, so ``sms *
    GEMV_CHANNELS * GEMV_MAX_ROWS`` floats and ``sms`` tickets hold any
    call's."""
    key = (dev, stream)
    buf = _gemv_scratch.get(key)
    if buf is None:
        buf = (torch.empty(sms * GEMV_CHANNELS * GEMV_MAX_ROWS,
                           dtype=torch.float32, device=dev),
               torch.zeros(sms, dtype=torch.int32, device=dev))
        _gemv_scratch[key] = buf
    return buf


def _tc_kernel():
    global _tc_fn
    if _tc_fn is None:
        from ._build import load
        lib = load("quant_matmul_sm90")
        f = lib.pdt_quant_matmul_sm90
        f.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
            ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.pdt_quant_matmul_sm90_error_string.argtypes = [ctypes.c_int]
        lib.pdt_quant_matmul_sm90_error_string.restype = ctypes.c_char_p
        lib.pdt_quant_matmul_sm90_f32_planes.restype = ctypes.c_int
        _tc_fn = (f, lib.pdt_quant_matmul_sm90_error_string,
                  lib.pdt_quant_matmul_sm90_f32_planes())
    return _tc_fn


def route(m, dtype):
    """The kernel a card runs for ``m`` rows of x and x's ``dtype``:
    ``"gemv"`` or ``"tc"`` (see the module docstring); ``None`` for a
    dtype no kernel takes."""
    if dtype == torch.bfloat16:
        return "tc"
    if dtype != torch.float32:
        return None
    return "gemv" if m <= GEMV_MAX_ROWS else "tc"


def _check(x, qw, scale, bias):
    if qw.dim() != 2:
        raise ValueError(f"weight_only_matmul: qw must be [K, N], got "
                         f"{tuple(qw.shape)}")
    k, n = qw.shape
    if x.dim() < 1 or x.shape[-1] != k:
        raise ValueError(f"weight_only_matmul: x K dim "
                         f"{x.shape[-1] if x.dim() else None} != weight "
                         f"rows {k}")
    if tuple(scale.shape) != (n,):
        raise ValueError(f"weight_only_matmul: scale must be [{n}], got "
                         f"{tuple(scale.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"weight_only_matmul: bias must be [{n}], got "
                         f"{tuple(bias.shape)}")
    if qw.dtype != torch.int8:
        raise TypeError(f"weight_only_matmul: qw must be int8, got "
                        f"{qw.dtype}")
    if not x.is_floating_point():
        raise TypeError(f"weight_only_matmul: x must be floating point, "
                        f"got {x.dtype}")
    devs = {t.device for t in (x, qw, scale) + (() if bias is None
                                                 else (bias,))}
    if len(devs) != 1:
        raise ValueError(f"weight_only_matmul: inputs on several devices "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def _launch(x2, qw, scale, bias):
    """One kernel launch on the card: ``[M, N]`` in x's dtype."""
    dev = x2.device
    k, n = qw.shape
    m = x2.shape[0]
    which = route(m, x2.dtype)
    if which is None:
        raise TypeError(f"weight_only_matmul: the kernels take float32 or "
                        f"bfloat16 activations, got {x2.dtype}")
    out = torch.empty(m, n, dtype=x2.dtype, device=dev)
    if m == 0:
        return out
    x2 = x2.contiguous()
    w = qw.t()                                   # [N, K]
    if not w.is_contiguous():
        w = w.contiguous()
    for name, t in (("x", x2), ("qw", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"weight_only_matmul: {name} must be 16-byte "
                             f"aligned")
    s = scale.to(torch.float32).contiguous()
    b = None
    if bias is not None:     # added after the cast to x's dtype
        b = bias.to(x2.dtype).to(torch.float32).contiguous()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _sms.get(idx)
    if sms is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _sms[idx] = sms
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if which == "tc":
            fn, err_str, planes = _tc_kernel()
            kp = k + -k % TC_K_MULTIPLE
            if kp != k:      # zeros add nothing to the sums
                x2 = torch.nn.functional.pad(x2, (0, kp - k))
                w = torch.nn.functional.pad(w, (0, kp - k))
            f32 = x2.dtype == torch.float32
            # an fp32 x's bf16 planes
            ws = torch.empty(planes * m * kp, dtype=torch.bfloat16,
                             device=dev) if f32 else None
            rc = fn(x2.data_ptr(), int(not f32), w.data_ptr(), s.data_ptr(),
                    None if b is None else b.data_ptr(), out.data_ptr(),
                    None if ws is None else ws.data_ptr(), m, kp, n, sms,
                    stream)
        else:
            fn, err_str = _kernel()
            _, splits = gemv_plan(k, n, sms)
            part, tickets = _gemv_buffers(dev, stream, sms)
            rc = fn(x2.data_ptr(), w.data_ptr(), s.data_ptr(),
                    None if b is None else b.data_ptr(), out.data_ptr(),
                    part.data_ptr(), tickets.data_ptr(), m, k, n, splits,
                    stream)
    if rc != 0:
        raise RuntimeError(f"weight_only_matmul kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    weight_only_matmul.launches += 1
    weight_only_matmul.tc_launches += which == "tc"
    return out


def _forward(x2, qw, scale, bias):
    if x2.device.type == "cpu":
        return quant_matmul_plain(x2, qw, scale, bias)
    return _launch(x2, qw, scale, bias)


class _WeightOnlyMatmul(torch.autograd.Function):
    """The launch (or, on the CPU, the plain version) under the
    reference's custom VJP (``_pallas_matmul_bwd``)."""

    @staticmethod
    def forward(ctx, x2, qw, scale, bias):
        ctx.save_for_backward(x2 if ctx.needs_input_grad[2] else None, qw,
                              scale)
        ctx.x_dtype = x2.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _forward(x2, qw, scale, bias)

    @staticmethod
    def backward(ctx, g):
        x2, qw, scale = ctx.saved_tensors
        g32 = g.to(torch.float32)
        q32 = qw.to(torch.float32)
        gx = gscale = gbias = None
        if ctx.needs_input_grad[0]:
            gx = ((g32 * scale.to(torch.float32)) @ q32.t()).to(ctx.x_dtype)
        if ctx.needs_input_grad[2]:
            acc = x2.to(torch.float32) @ q32
            gscale = (g32 * acc).sum(dim=0).to(scale.dtype)
        if ctx.needs_input_grad[3]:
            gbias = g.sum(dim=0).to(ctx.bias_dtype)
        return gx, None, gscale, gbias


def weight_only_matmul(x, qw, scale, bias=None):
    """``x @ dequant(qw, scale) [+ bias]`` without a float copy of the
    weight. x ``[..., K]`` float, qw ``[K, N]`` int8 (ideally the ``.t()``
    view of an ``[N, K]`` buffer), scale ``[N]``, bias ``[N]`` or None.
    Returns ``[..., N]`` in ``x.dtype``, differentiable in x, scale and
    bias."""
    dev = _check(x, qw, scale, bias)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"weight_only_matmul: no kernel for device {dev}")
    k, n = qw.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, bias)):
        y = _WeightOnlyMatmul.apply(x2, qw, scale, bias)
    else:
        y = _forward(x2, qw, scale, bias)
    return y.reshape(*lead, n)


weight_only_matmul.launches = 0
weight_only_matmul.tc_launches = 0


def quant_matmul_plain(x, qw, scale, bias=None):
    """Plain PyTorch version of :func:`weight_only_matmul` (any device):
    ``(x @ qw.float()) * scale`` in fp32, cast to ``x.dtype``, then
    ``+ bias`` — the JAX package's ``quant_matmul_jnp`` in one dot."""
    k, n = qw.shape
    lead = x.shape[:-1]
    y = (x.reshape(-1, k).to(torch.float32) @ qw.to(torch.float32)) \
        * scale.to(torch.float32)
    y = y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y.reshape(*lead, n)


def tolerance(x, qw, scale, bias=None):
    """Element-by-element limit of ``|kernel - plain|`` for these inputs
    (any device), in fp32 and the output's shape:

    * ``2e-5 sum_k |x_k| |q_k| |s|``: the fp32 summation order and, on
      the tensor cores, what an fp32 x loses beyond its three bf16 terms
      (at most ``2**-24 |x|`` a term);
    * with a bias, ``2e-5 |b| + 1e-6`` for its rounding;
    * for a bf16 x, one bf16 step of each rounded value: ``2**-7 |y|``
      (y before the bias) and, with a bias, ``2**-7 |y + b|``. Two
      results a hair apart that straddle a rounding boundary round to
      neighbours one step apart, and a step is at most ``2**-7`` of the
      value."""
    k, n = qw.shape
    x2 = x.reshape(-1, k).to(torch.float32)
    q32 = qw.to(torch.float32)
    s = scale.to(torch.float32)
    lim = 2e-5 * ((x2.abs() @ q32.abs()) * s.abs())
    b = None if bias is None else bias.to(torch.float32)
    if b is not None:
        lim = lim + 2e-5 * b.abs() + 1e-6
    if x.dtype == torch.bfloat16:
        y = (x2 @ q32) * s
        lim = lim + 2.0 ** -7 * y.abs()
        if b is not None:
            lim = lim + 2.0 ** -7 * (y + b).abs()
    return lim.reshape(*x.shape[:-1], n)


def grad_tolerance(x, qw, scale, g, refs):
    """Limits of the kernel path's ``(gx, gscale, gbias)`` against the
    plain path's ``refs`` for x ``[M, K]``, output gradient ``g``
    ``[M, N]``: :func:`tolerance` carried to each gradient. gx is the
    same kind of product, ``(g s) @ q^T``; gscale sums ``g (x @ q)`` over
    the rows, gbias sums g; for a bf16 x, one bf16 step of each rounded
    gradient (``2**-7`` of its value)."""
    q = qw.to(torch.float32).abs()
    ga = g.to(torch.float32).abs()
    lims = [2e-5 * ((ga * scale.detach().to(torch.float32).abs()) @ q.t()),
            2e-5 * (ga * (x.detach().to(torch.float32).abs() @ q)).sum(0),
            2e-5 * ga.sum(0) + 1e-6]
    if x.dtype == torch.bfloat16:
        lims[0] = lims[0] + 2.0 ** -7 * refs[0].to(torch.float32).abs()
        lims[2] = lims[2] + 2.0 ** -7 * refs[2].to(torch.float32).abs()
    return lims
