"""Fused decode egress for Hopper: two kernels of
``paddle_tpu/ops/pallas/fused_decode_mlp.py``.

* :func:`fused_decode_mlp` replaces ``_mlp_block`` with ``arch="gpt"``
  (run by ``_blocked_call``): ``y1 = x + (att @ wo + bo)``, then
  ``y1 + fc2(gelu_tanh(fc1(norm(y1))))``, the residual stream of the next
  layer, in one cooperative launch.
* :func:`fused_decode_epilogue` replaces ``_epilogue_block``: the final
  LayerNorm, the LM head and the guarded greedy pick. It returns
  ``(logits [B, V] pre-poison, nxt [B], bad [B] bool)``, with ``nxt``
  and ``bad`` exactly ``models.generation.guarded_argmax``'s on the same
  logits (the first maximal index; a row with any non-finite value after
  the poison lane is added is bad and picks 0). ``nxt`` is int64, as
  ``guarded_argmax`` returns it.

The norms are ``fused_decode_qkv._norm_block`` (``var = E[x^2] -
mean^2``). Weights come in the port's ``nn.Linear`` layout ``[out,
in]`` (the JAX package passes ``[in, out]``); the LM head weight is
``[V, H]`` both for the tied embedding (``transpose_lm=True``, JAX's
``matmul(h, wte.T)``) and for an untied head, whose bias ``b_lm`` is
added only when ``transpose_lm`` is False, as in JAX.

CPU tensors take the ``_plain`` versions; CUDA tensors launch the
kernels (``csrc/fused_decode_mlp.cu``) or raise. ``rows=`` and
``interpret=`` are TPU knobs, accepted for call compatibility and not
read. ``arch="llama"`` (SwiGLU) and ``norm="rms"`` raise, naming the
LLaMA slice. The tensor-parallel partial (``_mlp_partial_block``) is not
ported here: it comes with the multi-card serving slice.
"""
from __future__ import annotations

import ctypes

import torch

from .fused_decode_qkv import SMEM_LIMIT, _norm_block

__all__ = ["fused_decode_mlp", "fused_decode_mlp_plain",
           "fused_decode_epilogue", "fused_decode_epilogue_plain"]

_LLAMA = "arrives with the port's LLaMA slice"
_lib = None
_tickets: dict = {}   # device -> the epilogue's int32 ticket (kept at 0)


def _kernels():
    global _lib
    if _lib is None:
        from ._build import load
        lib = load("fused_decode_mlp")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pdt_fused_decode_mlp_f32.argtypes = [P] * 13 + [I] * 4 + [F, P]
        lib.pdt_fused_decode_mlp_f32.restype = I
        lib.pdt_fused_decode_epilogue_f32.argtypes = ([P] * 13 + [I] * 3
                                                      + [F, P])
        lib.pdt_fused_decode_epilogue_f32.restype = I
        lib.pdt_fused_decode_epilogue_grid.argtypes = [I]
        lib.pdt_fused_decode_epilogue_grid.restype = I
        lib.pdt_fused_decode_mlp_smem_bytes.argtypes = [I] * 4
        lib.pdt_fused_decode_mlp_smem_bytes.restype = ctypes.c_size_t
        lib.pdt_fused_decode_epilogue_smem_bytes.argtypes = [I] * 2
        lib.pdt_fused_decode_epilogue_smem_bytes.restype = ctypes.c_size_t
        lib.pdt_cuda_error_string.argtypes = [I]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _gelu_tanh(v):
    return torch.nn.functional.gelu(v, approximate="tanh")


def fused_decode_mlp_plain(x, att, wo, bo, norm_w, norm_b, w1, b1, w2, b2,
                           *, eps):
    """Plain PyTorch version of :func:`fused_decode_mlp` (any device), in
    the JAX ``_mlp_block`` op order."""
    prj = att @ wo.t()
    if bo is not None:
        prj = prj + bo
    y1 = x + prj
    h = _norm_block(y1, norm_w, norm_b, eps)
    f = h @ w1.t()
    if b1 is not None:
        f = f + b1
    f2 = _gelu_tanh(f) @ w2.t()
    if b2 is not None:
        f2 = f2 + b2
    return y1 + f2


def fused_decode_epilogue_plain(x, norm_w, norm_b, w_lm, b_lm, poison, *,
                                eps, transpose_lm):
    """Plain PyTorch version of :func:`fused_decode_epilogue` (any
    device): ``_epilogue_block``'s math, the pick by ``guarded_argmax``'s
    rule."""
    h = _norm_block(x, norm_w, norm_b, eps)
    lg0 = h @ w_lm.t()
    if not transpose_lm and b_lm is not None:
        lg0 = lg0 + b_lm
    lg = lg0.float() + poison.reshape(-1, 1)
    bad = ~torch.isfinite(lg).all(dim=-1)
    nxt = torch.where(bad, 0, lg.argmax(dim=-1))
    return lg0, nxt, bad


def _device(name, tensors):
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def _check_card(name, named):
    for what, t in named:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.dim() == 2 and (t.shape[1] % 4 or t.data_ptr() % 16):
            raise ValueError(f"{name}: {what} rows must be a multiple of 4 "
                             f"floats and 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise(name, rc):
    msg = _kernels().pdt_cuda_error_string(rc).decode()
    raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def _refuse(name, arch, norm, w_up=None):
    if arch == "llama" or w_up is not None:
        raise NotImplementedError(f"{name}: arch='llama' (SwiGLU) {_LLAMA}")
    if arch != "gpt":
        raise ValueError(f"{name}: arch must be 'gpt' or 'llama', got "
                         f"{arch!r}")
    if norm == "rms":
        raise NotImplementedError(f"{name}: norm='rms' {_LLAMA}")
    if norm != "layer":
        raise ValueError(f"{name}: norm must be 'layer' or 'rms', got "
                         f"{norm!r}")


def fused_decode_mlp(x, att, wo, bo, norm_w, norm_b, w1, b1, w2, b2,
                     w_up=None, *, arch="gpt", norm="layer", eps=1e-5,
                     rows=None, interpret=None):
    """x [B, H] residual stream, att [B, A] attention output; wo [H, A],
    w1 [I, H], w2 [H, I] (``[out, in]``), biases [out] or None ->
    [B, H], the residual stream after out-proj + residual + MLP +
    residual."""
    del rows, interpret     # TPU tiling / interpret knobs
    name = "fused_decode_mlp"
    _refuse(name, arch, norm, w_up)
    if x.dim() != 2 or att.dim() != 2 or att.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: x [B, H] and att [B, A] expected, got "
                         f"{tuple(x.shape)} and {tuple(att.shape)}")
    bsz, hid = x.shape
    a_w, inter = att.shape[1], w1.shape[0]
    for what, t, shape in (("wo", wo, (hid, a_w)), ("w1", w1, (inter, hid)),
                           ("w2", w2, (hid, inter)), ("bo", bo, (hid,)),
                           ("b1", b1, (inter,)), ("b2", b2, (hid,)),
                           ("norm_w", norm_w, (hid,)),
                           ("norm_b", norm_b, (hid,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {list(shape)} ([out, "
                             f"in]), got {tuple(t.shape)}")
    dev = _device(name, [x, att, wo, bo, norm_w, norm_b, w1, b1, w2, b2])
    if dev.type == "cpu":
        return fused_decode_mlp_plain(x, att, wo, bo, norm_w, norm_b, w1,
                                      b1, w2, b2, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    _check_card(name, (("x", x), ("att", att), ("wo", wo), ("bo", bo),
                       ("norm_w", norm_w), ("norm_b", norm_b), ("w1", w1),
                       ("b1", b1), ("w2", w2), ("b2", b2)))
    lib = _kernels()
    smem = lib.pdt_fused_decode_mlp_smem_bytes(bsz, hid, a_w, inter)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {bsz} rows of width "
                         f"{max(hid, a_w, inter)} need {smem} B of shared "
                         f"memory > {SMEM_LIMIT}")
    y1 = torch.empty_like(x)
    f = torch.empty(bsz, inter, dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pdt_fused_decode_mlp_f32(
            x.data_ptr(), att.data_ptr(), wo.data_ptr(), _ptr(bo),
            norm_w.data_ptr(), _ptr(norm_b), w1.data_ptr(), _ptr(b1),
            w2.data_ptr(), _ptr(b2), y1.data_ptr(), f.data_ptr(),
            out.data_ptr(), bsz, hid, a_w, inter, float(eps), stream)
    if rc != 0:
        _raise(name, rc)
    fused_decode_mlp.launches += 1
    return out


fused_decode_mlp.launches = 0


def _ticket(dev):
    t = _tickets.get(dev)
    if t is None:
        t = torch.zeros(1, dtype=torch.int32, device=dev)
        _tickets[dev] = t
    return t


def fused_decode_epilogue(x, norm_w, norm_b, w_lm, b_lm, poison, *,
                          norm="layer", eps=1e-5, transpose_lm=False,
                          rows=None, interpret=None):
    """x [B, H] final hidden state, w_lm [V, H], poison [B] float32 (the
    decode guard's lane: 0.0, or NaN for a poisoned slot) ->
    ``(logits [B, V] pre-poison, nxt [B] int64, bad [B] bool)``."""
    del rows, interpret     # TPU tiling / interpret knobs
    name = "fused_decode_epilogue"
    _refuse(name, "gpt", norm)
    if x.dim() != 2 or w_lm.dim() != 2 or w_lm.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: x [B, H] and w_lm [V, H] expected, got "
                         f"{tuple(x.shape)} and {tuple(w_lm.shape)}")
    bsz, hid = x.shape
    vocab = w_lm.shape[0]
    if poison.numel() != bsz:
        raise ValueError(f"{name}: poison must hold {bsz} values, got "
                         f"{tuple(poison.shape)}")
    bias = None if transpose_lm else b_lm
    if bias is not None and tuple(bias.shape) != (vocab,):
        raise ValueError(f"{name}: b_lm must be [{vocab}], got "
                         f"{tuple(bias.shape)}")
    dev = _device(name, [x, norm_w, norm_b, w_lm, bias, poison])
    if dev.type == "cpu":
        return fused_decode_epilogue_plain(x, norm_w, norm_b, w_lm, b_lm,
                                           poison, eps=eps,
                                           transpose_lm=transpose_lm)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    pz = poison.reshape(-1)
    _check_card(name, (("x", x), ("norm_w", norm_w), ("norm_b", norm_b),
                       ("w_lm", w_lm), ("b_lm", bias), ("poison", pz)))
    lib = _kernels()
    smem = lib.pdt_fused_decode_epilogue_smem_bytes(bsz, hid)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {bsz} rows of {hid} need {smem} B of "
                         f"shared memory > {SMEM_LIMIT}")
    grid = lib.pdt_fused_decode_epilogue_grid(vocab)
    logits = torch.empty(bsz, vocab, dtype=x.dtype, device=dev)
    part = torch.empty(3, grid, bsz, dtype=torch.int32, device=dev)
    nxt = torch.empty(bsz, dtype=torch.int64, device=dev)
    bad = torch.empty(bsz, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pdt_fused_decode_epilogue_f32(
            x.data_ptr(), norm_w.data_ptr(), _ptr(norm_b), w_lm.data_ptr(),
            _ptr(bias), pz.data_ptr(), logits.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), part[2].data_ptr(), _ticket(dev).data_ptr(),
            nxt.data_ptr(), bad.data_ptr(), bsz, hid, vocab, float(eps),
            stream)
    if rc != 0:
        _raise(name, rc)
    fused_decode_epilogue.launches += 1
    return logits, nxt, bad


fused_decode_epilogue.launches = 0
