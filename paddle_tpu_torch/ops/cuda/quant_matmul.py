"""Weight-only int8 matmul for Hopper: ``x @ dequant(qw, scale) [+ bias]``.

Replaces the Pallas TPU kernel ``_pallas_matmul`` (``paddle_tpu/ops/
pallas/quant_matmul.py``; entry ``weight_only_matmul``) with the same
contract:

* ``x`` ``[..., K]`` (any leading dims), ``qw`` ``[K, N]`` int8, ``scale``
  ``[N]``, ``bias`` ``[N]`` or None;
* fp32 accumulation; the per-channel scale applied ONCE per output
  element after the K reduction; the result cast to ``x.dtype`` BEFORE
  the bias add.

The kernel streams the weight as ``[N, K]`` rows (the ``nn.Linear``
layout ``quantization.WeightOnlyLinear`` stores), so ``qw`` is best
passed as the transposed view ``qweight.t()`` of such a buffer: it goes
in without a copy. A row-major ``[K, N]`` int8 matrix is transposed
into that layout once per call. What bounds the kernel, and its two
regimes (a weight-streaming GEMV for M <= 16 rows, a tiled fp32 SIMT
GEMM above), are described in ``csrc/quant_matmul.cu``.

CPU tensors take :func:`quant_matmul_plain`, the plain PyTorch version
of the same function; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["weight_only_matmul", "quant_matmul_plain"]

_fn = None
_sms: dict = {}   # device index -> SM count


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load
        lib = load("quant_matmul")
        f = lib.pdt_quant_matmul_f32
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] * 2
        f.restype = ctypes.c_int
        w = lib.pdt_quant_matmul_workspace_floats
        w.argtypes = [ctypes.c_int] * 4
        w.restype = ctypes.c_size_t
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _fn = (f, w, lib.pdt_cuda_error_string)
    return _fn


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


def weight_only_matmul(x, qw, scale, bias=None):
    """``x @ dequant(qw, scale) [+ bias]`` without a float copy of the
    weight. x ``[..., K]`` float, qw ``[K, N]`` int8 (ideally the ``.t()``
    view of an ``[N, K]`` buffer), scale ``[N]``, bias ``[N]`` or None.
    Returns ``[..., N]`` in ``x.dtype``."""
    dev = _check(x, qw, scale, bias)
    if dev.type == "cpu":
        return quant_matmul_plain(x, qw, scale, bias)
    if dev.type != "cuda":
        raise ValueError(f"weight_only_matmul: no kernel for device {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"weight_only_matmul: the kernel takes float32 "
                        f"activations (the serving path's), got {x.dtype}")
    k, n = qw.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    w = qw.t()                                   # [N, K]
    if not w.is_contiguous():
        w = w.contiguous()
    s = scale.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    for name, t in (("x", x2), ("qw", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"weight_only_matmul: {name} must be 16-byte "
                             f"aligned")
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    if m == 0:
        return out.reshape(*lead, n)
    fn, ws_floats, err_str = _kernel()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _sms.get(idx)
    if sms is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _sms[idx] = sms
    nws = ws_floats(m, k, n, sms)
    ws = torch.empty(nws, dtype=torch.float32, device=dev) if nws else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x2.data_ptr(), w.data_ptr(), s.data_ptr(),
                None if b is None else b.data_ptr(), out.data_ptr(), m, k,
                n, sms, None if ws is None else ws.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"weight_only_matmul kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    weight_only_matmul.launches += 1
    return out.reshape(*lead, n)


weight_only_matmul.launches = 0


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
