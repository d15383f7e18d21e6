"""RMSNorm and LayerNorm over the last axis, forward and backward, for
Hopper.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas/norms.py``,
with the same arithmetic:

* :func:`rms_norm_fwd` ``(x, w, eps)`` on 2-D ``[rows, h]`` -> ``(out,
  rstd)``: ``out = x * rsqrt(mean(x^2) + eps) * w`` in fp32, cast once
  to x's dtype; rstd fp32 ``[rows, 1]`` (``_rms_call``);
* :func:`rms_norm_bwd` ``(x, w, rstd, g)`` -> ``(dx, dw)``
  (``_rms2d_bwd``);
* :func:`layer_norm_fwd` ``(x, w, b, eps)`` -> ``(out, mean, rstd)``:
  two-pass fp32 stats, ``out = (x - mean) * rstd * w + b`` cast once
  (``_ln_call``);
* :func:`layer_norm_bwd` ``(x, w, mean, rstd, g)`` -> ``(dx, dw, db)``
  (``_ln2d_bwd``);
* :func:`rms_norm` ``(x, weight, eps)`` and :func:`layer_norm` ``(x,
  weight, bias, eps)`` over the last axis, differentiable:
  ``torch.library`` custom ops whose autograd saves ``(x, w, rstd)`` /
  ``(x, w, mean, rstd)``, as the JAX custom_vjps do.

dw and db come back in w's dtype, from fp32 sums; the kernels read w
and b in their own dtype (fp32 or bf16) and write dw and db in it. The
kernels
(``csrc/norms.cu``, the row kernels of ``csrc/row_norm.cuh``) read each
row once. CPU tensors take the plain versions (``*_plain``); CUDA
tensors launch the kernels (counted in each wrapper's ``launches``, one
per call; each backward is one kernel, ``ln_bwd_kernel`` templated on
the norm, planned by :func:`ln_bwd_plan`) or raise. The helpers here are
shared with ``fused_residual_norm.py``.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["rms_norm", "layer_norm", "rms_norm_fwd", "rms_norm_bwd",
           "layer_norm_fwd", "layer_norm_bwd", "rms_norm_fwd_plain",
           "rms_norm_bwd_plain", "layer_norm_fwd_plain",
           "layer_norm_bwd_plain", "RMS_NORM_OP", "LAYER_NORM_OP"]

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_RMS, _LAYER = 0, 1

_fns = None


def _kernels():
    global _fns
    if _fns is None:
        from ._build import load
        lib = load("norms")
        fwd = lib.pdt_norm_fwd
        fwd.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        lib.pdt_norm_max_h.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.pdt_norm_max_h.restype = ctypes.c_int
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fwd, lib.pdt_norm_max_h, lib.pdt_cuda_error_string,
                ln_bwd_entries(lib))
    return _fns


def ln_bwd_entries(lib):
    """``(launch, ctas_per_sm)``: the backward's C entries (both norms)
    of a library built over ``csrc/row_norm.cuh`` (``norms`` or
    ``fused_residual_norm``), their argument types set."""
    launch = lib.pdt_ln_bwd
    launch.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    launch.restype = ctypes.c_int
    occ = lib.pdt_ln_bwd_ctas_per_sm
    occ.argtypes = [ctypes.c_int] * 5
    occ.restype = ctypes.c_int
    return launch, occ


# ------------------------------------------------------ plain versions --
def rms_stats(x32, eps):
    """rstd ``[rows, 1]`` of fp32 rows."""
    return torch.rsqrt(x32.square().mean(dim=1, keepdim=True) + eps)


def ln_stats(x32, eps):
    """Two-pass ``(mean, rstd)`` ``[rows, 1]`` of fp32 rows."""
    mean = x32.mean(dim=1, keepdim=True)
    var = (x32 - mean).square().mean(dim=1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def norm_bwd32(x, w, mean, rstd, g):
    """The fp32 ``(dx, dw, db)`` of a row norm's backward over all rows
    at once (``mean=None``: RMS, whose dx has no ``mean(wg)`` term)."""
    x32 = x.float()
    xhat = (x32 if mean is None else x32 - mean) * rstd
    g32 = g.float()
    wg = g32 * w.float()
    c2 = (wg * xhat).mean(dim=1, keepdim=True)
    if mean is None:
        d = rstd * (wg - xhat * c2)
    else:
        d = rstd * (wg - wg.mean(dim=1, keepdim=True) - xhat * c2)
    return d, (g32 * xhat).sum(dim=0), g32.sum(dim=0)


def rms_norm_fwd_plain(x, w, eps=1e-6):
    """Plain PyTorch forward (any device): ``_rms_fwd_kernel``."""
    x32 = x.float()
    rstd = rms_stats(x32, eps)
    return (x32 * rstd * w.float()).to(x.dtype), rstd


def rms_norm_bwd_plain(x, w, rstd, g):
    """Plain PyTorch backward (any device): ``_rms_bwd_kernel`` over all
    rows at once."""
    d, dw, _ = norm_bwd32(x, w, None, rstd, g)
    return d.to(x.dtype), dw.to(w.dtype)


def layer_norm_fwd_plain(x, w, b, eps=1e-5):
    """Plain PyTorch forward (any device): ``_ln_fwd_kernel``."""
    x32 = x.float()
    mean, rstd = ln_stats(x32, eps)
    out = (x32 - mean) * rstd * w.float() + b.float()
    return out.to(x.dtype), mean, rstd


def layer_norm_bwd_plain(x, w, mean, rstd, g):
    """Plain PyTorch backward (any device): ``_ln_bwd_kernel`` over all
    rows at once."""
    d, dw, db = norm_bwd32(x, w, mean, rstd, g)
    return d.to(x.dtype), dw.to(w.dtype), db.to(w.dtype)


# ------------------------------------------------------ backward plan --
# Each backward (both norms) is one launch (``csrc/row_norm.cuh``,
# ``ln_bwd_kernel``): a row to a group of G warps of a 256-thread CTA,
# every group walking rows ``stride`` apart on a grid of as many CTAs as
# the SMs hold (a cooperative launch); each CTA writes one fp32 partial
# row of dw and db (RMS: dw), and past a grid barrier sums a slice of
# the columns over all of them. The plan is a plain function of (n, h,
# dtype, SMs, CTAs an SM, norm), so a card repeats its sums bit for bit.
LN_GROUPS = (1, 2, 4, 8)           # warps a row (a CTA has 8)
LN_LANE_CHUNKS = (1, 2, 3, 4, 6, 8)  # the kernel's chunks a lane
LN_LANE_MOST = 3                   # 16-byte chunks a lane holds, at most,
# where a group of 8 warps does not need more: a row of 768 takes one
# warp in bf16, two in fp32, every lane 3 chunks (an fp32 row on one
# warp, 6 a lane, measured 1-2% slower on an H100: PERF.md)


def ln_bwd_group(h, esize, vec=True, norm=_LAYER):
    """``(G, K)`` for a row of ``h`` elements of ``esize`` bytes: the
    fewest warps G (1, 2, 4 or 8) that hold the row with at most
    LN_LANE_MOST 16-byte chunks a lane (one-element loads, ``vec``
    False: at most 8 elements), and K, the chunks (elements) a lane
    takes, rounded up to the kernel's LN_LANE_CHUNKS. The same rule for
    both norms (``norm``: RMS keeps no db, so it holds fewer registers
    a lane)."""
    if norm not in (_RMS, _LAYER):
        raise ValueError(f"ln_bwd_group: norm {norm} is neither RMS (0) "
                         f"nor Layer (1)")
    per = 16 // esize if vec else 1
    chunks = -(-h // per)
    most = LN_LANE_MOST if vec else LN_LANE_CHUNKS[-1]
    for G in LN_GROUPS:
        k = -(-chunks // (32 * G))
        if k <= most:
            break
    for K in LN_LANE_CHUNKS:
        if k <= K:
            return G, K
    raise ValueError(f"norm backward: row width {h} exceeds the kernel's "
                     f"{LN_LANE_CHUNKS[-1]} chunks a lane of 8 warps")


def ln_bwd_plan(n, h, dtype, sms, ctas_per_sm, vec=True, norm=_LAYER):
    """The backward's launch for ``n`` rows of ``h`` in ``dtype`` on a
    card of ``sms`` SMs that holds ``ctas_per_sm`` of its CTAs: ``G`` and
    ``K`` (:func:`ln_bwd_group`), ``groups`` a CTA, ``ctas``, the rows'
    ``stride`` (group q of CTA b takes rows ``b * groups + q``, then
    every ``stride``-th), ``cols`` floats a partial row (dw and db, RMS
    dw alone, padded to 4) and the scratch, ``part_floats`` (a row a
    CTA)."""
    G, K = ln_bwd_group(h, dtype.itemsize, vec, norm)
    groups = 8 // G
    ctas = max(1, min(sms * ctas_per_sm, -(-n // groups)))
    cols = -(-(2 if norm == _LAYER else 1) * h // 4) * 4
    return dict(G=G, K=K, groups=groups, ctas=ctas, stride=ctas * groups,
                cols=cols, part_floats=ctas * cols)


_ln_occupancy: dict = {}   # (entry, device, norm, dtype, vec, h, G) -> CTAs
_ln_scratch: dict = {}     # (device, stream) -> partial rows
_sms: dict = {}            # device index -> SM count


def ln_bwd_scratch(dev, stream, plan):
    """The backward's fp32 partial rows on one stream, reused by its
    launches (they run in stream order), grown to ``plan``."""
    key = (dev, stream)
    part = _ln_scratch.get(key)
    if part is None or part.numel() < plan["part_floats"]:
        part = _ln_scratch[key] = torch.empty(
            plan["part_floats"], dtype=torch.float32, device=dev)
    return part


def ln_bwd_launch(name, entries, err_str, norm, x, wk, mean, rstd, dres, g,
                  vec):
    """Launch the backward kernel of ``norm`` (one launch) on checked,
    contiguous CUDA rows ``x`` and ``g`` (and ``dres``, or None), w
    ``wk`` as the kernel reads it, fp32 stats (``mean`` None for RMS):
    ``(d, dwdb)``, dwdb ``[2, h]`` (dw, then db; RMS ``[1, h]``, dw) in
    wk's dtype."""
    launch, occupancy = entries
    n, h = x.shape
    dev = x.device
    d = torch.empty_like(x)
    dwdb = torch.empty(2 if norm == _LAYER else 1, h, dtype=wk.dtype,
                       device=dev)
    if n == 0:
        return d, dwdb.zero_()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    G, _ = ln_bwd_group(h, x.element_size(), vec, norm)
    key = (id(occupancy), idx, norm, x.dtype, vec, h, G)
    with torch.cuda.device(dev):
        cps = _ln_occupancy.get(key)
        if cps is None:
            cps = occupancy(norm, DTYPE_CODE[x.dtype], int(vec), h, G)
            raise_rc(name, -min(cps, 0), err_str)
            if cps == 0:
                raise RuntimeError(f"{name}: the kernel fits no CTA on an SM")
            _ln_occupancy[key] = cps
        sms = _sms.get(idx)
        if sms is None:
            sms = _sms[idx] = torch.cuda.get_device_properties(
                idx).multi_processor_count
        p = ln_bwd_plan(n, h, x.dtype, sms, cps, vec, norm)
        stream = torch.cuda.current_stream(dev).cuda_stream
        part = ln_bwd_scratch(dev, stream, p)
        rc = launch(norm, DTYPE_CODE[x.dtype], DTYPE_CODE[wk.dtype],
                    x.data_ptr(), wk.data_ptr(),
                    None if mean is None else mean.data_ptr(),
                    rstd.data_ptr(),
                    None if dres is None else dres.data_ptr(), g.data_ptr(),
                    d.data_ptr(), dwdb.data_ptr(), part.data_ptr(), n, h,
                    int(vec), p["G"], p["ctas"], p["cols"], stream)
    raise_rc(name, rc, err_str)
    return d, dwdb


# ------------------------------------------------------------ wrappers --
def check_rows(name, tensors, h, dtype):
    for tname, t in tensors:
        if t.dim() != 2 or t.shape[1] != h:
            raise ValueError(f"{name}: {tname} must be [rows, {h}], got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {tname} is {t.dtype}, not {dtype}")


def check_stats(name, stats, n):
    for sname, s in stats:
        if tuple(s.shape) != (n, 1) or s.dtype != torch.float32:
            raise ValueError(f"{name}: {sname} must be float32 [{n}, 1], "
                             f"got {s.dtype} {tuple(s.shape)}")


def check_vectors(name, vecs, h):
    for vname, v in vecs:
        if tuple(v.shape) != (h,):
            raise ValueError(f"{name}: {vname} must be [{h}], got "
                             f"{tuple(v.shape)}")


def vec_ok(tensors, h):
    per = 16 // tensors[0].element_size()
    return h % per == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def device_of(name, tensors):
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def raise_rc(what, rc, err_str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")


def kernel_ready(name, t, h, vec, max_h):
    dt = t.dtype
    if dt not in DTYPE_CODE:
        raise TypeError(f"{name}: float32 or bfloat16 rows, got {dt}")
    limit = max_h(DTYPE_CODE[dt], int(vec))
    if h > limit:
        raise ValueError(f"{name}: row width {h} exceeds the kernel's "
                         f"{limit} for {dt} rows"
                         + ("" if vec else " not 16-byte aligned"))


def weight_vectors(w, b=None):
    """``(dtype, w, b)`` as the kernels read them: contiguous, in their
    own dtype when both share one the kernels take (fp32 or bf16), else
    cast to fp32; ``b`` may be None."""
    dt = w.dtype
    if dt not in DTYPE_CODE or (b is not None and b.dtype != dt):
        dt = torch.float32
    return (dt, w.to(dt).contiguous(),
            None if b is None else b.to(dt).contiguous())


def _fwd(name, norm, x, w, b, eps):
    """Check and launch the forward; None on CPU tensors (the caller
    runs the plain version)."""
    n, h = x.shape
    check_rows(name, (("x", x),), h, x.dtype)
    check_vectors(name, (("w", w),) + (() if b is None else (("b", b),)),
                  h)
    dev = device_of(name, [x, w] + ([] if b is None else [b]))
    if dev.type == "cpu":
        return None
    fwd, max_h, err_str, _ = _kernels()
    x = x.contiguous()
    vec = vec_ok((x,), h)
    kernel_ready(name, x, h, vec, max_h)
    wdt, w, b = weight_vectors(w, b)
    out = torch.empty_like(x)
    rstd = torch.empty(n, 1, dtype=torch.float32, device=dev)
    mean = None if b is None else torch.empty_like(rstd)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fwd(norm, DTYPE_CODE[x.dtype], DTYPE_CODE[wdt], x.data_ptr(),
                 w.data_ptr(), None if b is None else b.data_ptr(),
                 out.data_ptr(),
                 None if mean is None else mean.data_ptr(), rstd.data_ptr(),
                 n, h, float(eps), int(vec), stream)
    raise_rc(name, rc, err_str)
    return out, mean, rstd


def _bwd(name, norm, x, w, mean, rstd, g):
    """Check and launch the backward (one kernel): ``(dx, dw, db)`` with
    ``db`` None for RMS; None on CPU tensors."""
    n, h = x.shape
    check_rows(name, (("x", x), ("g", g)), h, x.dtype)
    check_vectors(name, (("w", w),), h)
    stats = (("rstd", rstd),) + (() if mean is None else (("mean", mean),))
    check_stats(name, stats, n)
    dev = device_of(name, [x, w, g] + [s for _, s in stats])
    if dev.type == "cpu":
        return None
    _, max_h, err_str, entries = _kernels()
    x, g = x.contiguous(), g.contiguous()
    vec = vec_ok((x, g), h)
    kernel_ready(name, x, h, vec, max_h)
    _, wk, _ = weight_vectors(w)
    dx, dwdb = ln_bwd_launch(name, entries, err_str, norm, x, wk,
                             None if mean is None else mean.contiguous(),
                             rstd.contiguous(), None, g, vec)
    return (dx, dwdb[0].to(w.dtype),
            None if norm == _RMS else dwdb[1].to(w.dtype))


def rms_norm_fwd(x, w, eps=1e-6):
    """The forward kernel's wrapper on 2-D ``[rows, h]``: ``(out, rstd)``
    as :func:`rms_norm_fwd_plain` gives them."""
    got = _fwd("rms_norm_fwd", _RMS, x, w, None, eps)
    if got is None:
        return rms_norm_fwd_plain(x, w, eps)
    rms_norm_fwd.launches += 1
    return got[0], got[2]


def rms_norm_bwd(x, w, rstd, g):
    """The backward kernel's wrapper: ``(dx, dw)`` as
    :func:`rms_norm_bwd_plain` gives them."""
    got = _bwd("rms_norm_bwd", _RMS, x, w, None, rstd, g)
    if got is None:
        return rms_norm_bwd_plain(x, w, rstd, g)
    if x.shape[0]:            # no rows, no launch
        rms_norm_bwd.launches += 1
    return got[0], got[1]


def layer_norm_fwd(x, w, b, eps=1e-5):
    """The forward kernel's wrapper on 2-D ``[rows, h]``: ``(out, mean,
    rstd)`` as :func:`layer_norm_fwd_plain` gives them."""
    got = _fwd("layer_norm_fwd", _LAYER, x, w, b, eps)
    if got is None:
        return layer_norm_fwd_plain(x, w, b, eps)
    layer_norm_fwd.launches += 1
    return got


def layer_norm_bwd(x, w, mean, rstd, g):
    """The backward kernel's wrapper: ``(dx, dw, db)`` as
    :func:`layer_norm_bwd_plain` gives them."""
    got = _bwd("layer_norm_bwd", _LAYER, x, w, mean, rstd, g)
    if got is None:
        return layer_norm_bwd_plain(x, w, mean, rstd, g)
    if x.shape[0]:            # no rows, no launch
        layer_norm_bwd.launches += 1
    return got


for _f in (rms_norm_fwd, rms_norm_bwd, layer_norm_fwd, layer_norm_bwd):
    _f.launches = 0


# ------------------------------------------------ autograd custom ops --
@torch.library.custom_op("paddle_tpu_torch::rms_norm_fwd", mutates_args=())
def _rms_op(x: torch.Tensor, w: torch.Tensor,
            eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    return rms_norm_fwd(x, w, eps)


@_rms_op.register_fake
def _(x, w, eps):
    return x.new_empty(x.shape), x.new_empty(x.shape[0], 1,
                                             dtype=torch.float32)


def _rms_setup(ctx, inputs, output):
    x, w, _ = inputs
    ctx.save_for_backward(x, w, output[1])
    ctx.set_materialize_grads(False)


def _rms_backward(ctx, g, _drstd):
    x, w, rstd = ctx.saved_tensors
    if g is None:
        g = torch.zeros_like(x)
    dx, dw = rms_norm_bwd(x, w, rstd, g)
    return dx, dw, None


_rms_op.register_autograd(_rms_backward, setup_context=_rms_setup)


@torch.library.custom_op("paddle_tpu_torch::layer_norm_fwd", mutates_args=())
def _ln_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return layer_norm_fwd(x, w, b, eps)


@_ln_op.register_fake
def _(x, w, b, eps):
    stat = x.new_empty(x.shape[0], 1, dtype=torch.float32)
    return x.new_empty(x.shape), stat, stat.new_empty(stat.shape)


def _ln_setup(ctx, inputs, output):
    x, w, _, _ = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, w, mean, rstd)
    ctx.set_materialize_grads(False)


def _ln_backward(ctx, g, _dmean, _drstd):
    x, w, mean, rstd = ctx.saved_tensors
    if g is None:
        g = torch.zeros_like(x)
    dx, dw, db = layer_norm_bwd(x, w, mean, rstd, g)
    return dx, dw, db, None


_ln_op.register_autograd(_ln_backward, setup_context=_ln_setup)

RMS_NORM_OP = torch.ops.paddle_tpu_torch.rms_norm_fwd.default
LAYER_NORM_OP = torch.ops.paddle_tpu_torch.layer_norm_fwd.default


def rms_norm(x, weight, eps=1e-6):
    """RMSNorm over the last axis of ``x [..., h]`` through the kernels,
    differentiable; the output in x's dtype."""
    shape = x.shape
    out, _ = _rms_op(x.reshape(-1, shape[-1]), weight, float(eps))
    return out.reshape(shape)


def layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last axis of ``x [..., h]`` through the
    kernels, differentiable; the output in x's dtype."""
    shape = x.shape
    out, _, _ = _ln_op(x.reshape(-1, shape[-1]), weight, bias, float(eps))
    return out.reshape(shape)
