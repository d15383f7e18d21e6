"""Flash attention (forward and backward) for Hopper.

Replaces the Pallas TPU kernels ``_fwd`` and ``_bwd`` of
``paddle_tpu/ops/pallas/flash_attention.py`` with the same public entry,
``flash_attention(q, k, v, causal=..., scale=...)`` in paddle layout
``[batch, seq, heads, head_dim]``, and the same arithmetic: q scaled
once, fp32 scores and softmax state, masked scores at ``NEG_INF =
-1e30``, causal alignment at the bottom-right corner (``offset = Sk -
Sq``), the logsumexp saved by the forward and the probabilities
recomputed from it in the backward, ``delta = rowsum(dO * O)`` in fp32,
fp32 gradients cast to the input dtypes, GQA dk/dv summed over the
group. Rows that attend nothing give ``o = 0`` and zero gradients.

The kernels (``csrc/flash_attention.cu``) are fp32 FMAs on the CUDA
cores, bound far above the tensor-core bound; their design notes are in
the source. CPU tensors take :func:`flash_attention_fwd_plain` and
:func:`flash_attention_bwd_plain`; CUDA tensors launch the kernels or
raise.

The gradient is registered on a ``torch.library`` custom op,
``paddle_tpu_torch::flash_attention_fwd`` returning ``(o, lse)``, whose
autograd rule launches the backward kernel. Selective activation
checkpointing sees only ops that pass through the dispatcher, so this is
what lets ``recompute(..., policy="dots_and_kernels_saveable")`` keep
the forward's output instead of running the kernel again in backward.
"""
import ctypes
import math

import torch

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "NEG_INF", "MAX_HEAD_DIM"]

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARLEN = ("segment_ids (packed varlen sequences) arrive with the port's "
           "varlen slice (flash_attn_unpadded)")

_fns = None


def _kernels():
    global _fns
    if _fns is None:
        from ._build import load
        lib = load("flash_attention")
        fwd = lib.pdt_flash_attention_fwd
        fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                        + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd = lib.pdt_flash_attention_bwd
        bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                        + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _fns = (fwd, bwd, lib.pdt_cuda_error_string)
    return _fns


def _check(q, k, v):
    """Shapes, dtypes and devices of paddle-layout q/k/v; returns the
    device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention: q, k, v must be [batch, seq, heads, "
            f"head_dim], got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    hq, hk = q.shape[2], k.shape[2]
    if hk == 0 or hq % hk != 0:
        raise ValueError(
            f"flash_attention: query heads ({hq}) must be a multiple of "
            f"key/value heads ({hk}) for grouped-query attention")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or \
            k.shape[3] != q.shape[3]:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
            f"do not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v dtypes differ: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: float32 or bfloat16 inputs, "
                        f"got {q.dtype}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {q.shape[3]} exceeds "
                         f"the kernel's {MAX_HEAD_DIM}")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"flash_attention: inputs on several devices "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def _check_kernel_inputs(name, tensors, dtype):
    for tname, t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {tname} is {t.dtype}, not {dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname} must have a contiguous last "
                             f"dim (stride {t.stride(-1)})")


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _strides(t):
    # element strides of a [B, S, H, D] view: (batch, seq, head)
    return t.stride(0), t.stride(1), t.stride(2)


def _vec_ok(tensors):
    """Every row of every tensor starts 16-byte aligned and holds whole
    16-byte chunks: the kernel may then load 16 bytes per thread."""
    per = 16 // tensors[0].element_size()
    return all(t.shape[-1] % per == 0 and t.data_ptr() % 16 == 0
               and all(st % per == 0 for st in _strides(t))
               for t in tensors)


def _mask(sq, sk, causal, device):
    """[Sq, Sk] attend-mask: every pair, or key j <= row i + Sk - Sq."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=device)
    rows = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return torch.arange(sk, device=device)[None, :] <= rows


def _heads_first(x, rep=1):
    """[B, S, H, D] -> fp32 [B, H * rep, S, D] (kv heads repeated)."""
    x = x.float().transpose(1, 2)
    return x.repeat_interleave(rep, dim=1) if rep > 1 else x


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """Plain PyTorch forward (any device): ``(o [B, Sq, Hq, D] in q's
    dtype, lse [B, Hq, Sq] fp32)``. One softmax over the whole row with
    the kernel's masking: masked scores at NEG_INF and probability 0,
    ``o = 0`` and ``lse = -1e30`` for a row that attends nothing."""
    scale = _scale(q, scale)
    rep = q.shape[2] // k.shape[2]
    qt = _heads_first(q) * scale
    kt, vt = _heads_first(k, rep), _heads_first(v, rep)
    mask = _mask(q.shape[1], k.shape[1], causal, q.device)
    s = (qt @ kt.transpose(-1, -2)).masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (p @ vt) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse


def flash_attention_bwd_plain(q, k, v, do, o, lse, causal=False,
                              scale=None):
    """Plain PyTorch backward (any device): ``(dq, dk, dv)`` in the
    dtypes and paddle layouts of q, k, v, from the forward's ``o`` and
    ``lse``. p is recomputed from lse, ``delta = rowsum(dO * O)`` in
    fp32, ``ds = p * (dp - delta)``; dq, dk, dv are computed in fp32, dk
    and dv summed over each GQA group, then cast."""
    scale = _scale(q, scale)
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = hq // hk
    qt = _heads_first(q) * scale
    kt, vt = _heads_first(k, rep), _heads_first(v, rep)
    dot = _heads_first(do)
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    mask = _mask(sq, sk, causal, q.device)
    s = qt @ kt.transpose(-1, -2)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dv = p.transpose(-1, -2) @ dot
    dp = dot @ vt.transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    dk = ds.transpose(-1, -2) @ qt
    dq = (ds @ kt) * scale
    if rep > 1:
        dk = dk.reshape(b, hk, rep, sk, d).sum(dim=2)
        dv = dv.reshape(b, hk, rep, sk, d).sum(dim=2)
    return (dq.transpose(1, 2).to(q.dtype).contiguous(),
            dk.transpose(1, 2).to(k.dtype).contiguous(),
            dv.transpose(1, 2).to(v.dtype).contiguous())


def _raise_rc(what, rc, err_str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """The forward kernel's wrapper: ``(o, lse)`` as
    :func:`flash_attention_fwd_plain` gives them. CPU tensors run the
    plain version; CUDA tensors launch the kernel (counted in
    ``flash_attention_fwd.launches``) or raise."""
    dev = _check(q, k, v)
    scale = _scale(q, scale)
    if dev.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    _check_kernel_inputs("flash_attention", (("q", q), ("k", k), ("v", v)),
                         q.dtype)
    o = torch.empty(b, sq, hq, d, dtype=q.dtype, device=dev)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=dev)
    fwd, _, err_str = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fwd(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, hq, hk, sq,
                 sk, d, *_strides(q), *_strides(k), *_strides(v), scale,
                 int(bool(causal)), int(_vec_ok((q, k, v))), stream)
    _raise_rc("flash_attention forward", rc, err_str)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, do, o, lse, causal=False, scale=None):
    """The backward kernels' wrapper: ``(dq, dk, dv)`` as
    :func:`flash_attention_bwd_plain` gives them. On CUDA one call
    launches the dk/dv kernel and then the dq kernel, and counts one in
    ``flash_attention_bwd.launches``; CPU tensors run the plain
    version."""
    dev = _check(q, k, v)
    scale = _scale(q, scale)
    if do.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"flash_attention backward: do {tuple(do.shape)} "
                         f"and o {tuple(o.shape)} must match q "
                         f"{tuple(q.shape)}")
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: lse must be float32 "
                         f"[{b}, {hq}, {sq}], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, o, lse, causal, scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    do = do.to(q.dtype)
    _check_kernel_inputs("flash_attention backward",
                         (("q", q), ("k", k), ("v", v), ("do", do)),
                         q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()
    lse = lse.contiguous()
    dq = torch.empty(b, sq, hq, d, dtype=q.dtype, device=dev)
    dk = torch.empty(b, sk, hk, d, dtype=k.dtype, device=dev)
    dv = torch.empty(b, sk, hk, d, dtype=v.dtype, device=dev)
    _, bwd, err_str = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = bwd(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, hq, hk, sq, sk, d, *_strides(q),
                 *_strides(k), *_strides(v), *_strides(do), scale,
                 int(bool(causal)), int(_vec_ok((q, k, v, do))), stream)
    _raise_rc("flash_attention backward", rc, err_str)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# ------------------------------------------------ autograd custom op --
@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal, scale)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, scale):
    b, sq, hq, d = q.shape
    return (q.new_empty(b, sq, hq, d),
            q.new_empty(b, hq, sq, dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.scale = causal, scale


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, do, o, lse, ctx.causal,
                                     ctx.scale)
    return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_backward, setup_context=_setup_context)

FLASH_FWD_OP = torch.ops.paddle_tpu_torch.flash_attention_fwd.default


def flash_attention(q, k, v, causal=False, scale=None, interpret=None,
                    blocks=None, segment_ids=None, bwd_blocks=None):
    """Flash attention in paddle layout ``[batch, seq, num_heads,
    head_dim]``, differentiable. ``num_heads(q)`` may be a multiple of
    ``num_heads(k) == num_heads(v)`` (grouped-query attention). Returns
    ``[batch, seq_q, num_heads, head_dim]`` in q's dtype.

    ``blocks`` and ``bwd_blocks`` are accepted for API parity with the
    TPU entry and not read: the kernel picks its own 64 x 64 tiles.
    ``interpret`` (a Pallas mode) is refused; ``segment_ids`` waits for
    the varlen slice."""
    if interpret:
        raise ValueError("flash_attention: interpret= is a Pallas mode; "
                         "the port runs the plain PyTorch version for CPU "
                         "tensors instead")
    if segment_ids is not None:
        raise NotImplementedError(f"flash_attention: {_VARLEN}")
    _check(q, k, v)
    o, _ = _flash_fwd_op(q, k, v, bool(causal), _scale(q, scale))
    return o
