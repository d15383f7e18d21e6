"""Fused decode ingress for Hopper: LayerNorm + fused QKV projection +
paged-KV append of one decode step, in one launch.

Replaces the Pallas TPU kernel ``fused_decode_qkv``
(``paddle_tpu/ops/pallas/fused_decode_qkv.py``, body ``_qkv_kernel``)
for the GPT branch: ``norm="layer"``, one fused projection whose output
columns are ordered ``[3, heads, head_dim]`` with its bias, no rope,
fp32 page pools ``[Hk, P, page_size, D]``. The math is the JAX
``_qkv_block``: the LayerNorm of ``_norm_block`` (``var = E[x^2] -
mean^2``, the bias added only when present; not ``nn.LayerNorm``'s
two-pass variance), the projection plus its bias, and each row's K and
V written at ``(bt[b, min(pos // page_size, NP - 1)], pos % page_size)``
(the JAX ``_page_slot``: positions past the table clamp onto its last
page).

Weights come in the port's ``nn.Linear`` layout ``[out, in]`` (the JAX
package passes ``[in, out]``): each output column is then one contiguous
weight row, which is what the kernel's GEMV streams. The pools are
written IN PLACE (the TPU kernel's ``input_output_aliases``) and
returned.

CPU tensors take :func:`fused_decode_qkv_plain`; CUDA tensors launch the
kernel (``csrc/fused_decode_qkv.cu``) or raise. ``rows=`` and
``interpret=`` are the TPU kernel's tiling and interpret knobs: accepted
for call compatibility and not read. The branches of the JAX function
that this slice does not port raise ``NotImplementedError`` naming the
slice that brings them.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["fused_decode_qkv", "fused_decode_qkv_plain", "_norm_block"]

SMEM_LIMIT = 227 * 1024   # dynamic shared memory one CTA may use (H100)

_LLAMA = "arrives with the port's LLaMA slice"
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load
        lib = load("fused_decode_qkv")
        f = lib.pdt_fused_decode_qkv_f32
        f.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                      + [ctypes.c_float, ctypes.c_void_p])
        f.restype = ctypes.c_int
        smem = lib.pdt_fused_decode_qkv_smem_bytes
        smem.argtypes = [ctypes.c_int] * 2
        smem.restype = ctypes.c_size_t
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _fn = (f, smem, lib.pdt_cuda_error_string)
    return _fn


def _norm_block(x, w, b, eps):
    """LayerNorm as the JAX package's ``_norm_block`` (norm="layer"):
    moments in fp32, ``var = E[x^2] - mean^2``, scale, then the bias
    only when present."""
    v = x.float()
    mean = v.mean(dim=-1, keepdim=True)
    var = torch.square(v).mean(dim=-1, keepdim=True) - torch.square(mean)
    out = ((v - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    out = out * w
    if b is not None:
        out = out + b
    return out


def _page_slot(positions, block_tables, page_size):
    """(page, slot) per row: ``_page_slot`` of the JAX package."""
    p = positions.reshape(-1).long()
    rows = torch.arange(p.shape[0], device=p.device)
    page = block_tables[rows, torch.clamp(
        p // page_size, max=block_tables.shape[1] - 1)].long()
    return page, p % page_size


def _append(kt, vt, k_pages, v_pages, positions, block_tables):
    """Write head-major ``kt``/``vt`` ``[Hk, B, D]`` in place, row by
    row as the JAX kernel does: where two rows share a (page, slot), the
    later row's value stays."""
    ps = k_pages.shape[2]
    page, slot = _page_slot(positions, block_tables, ps)
    key = page * ps + slot
    later = torch.triu(key[:, None] == key[None, :], diagonal=1).any(dim=1)
    keep = ~later
    k_pages[:, page[keep], slot[keep]] = kt[:, keep].to(k_pages.dtype)
    v_pages[:, page[keep], slot[keep]] = vt[:, keep].to(v_pages.dtype)


def fused_decode_qkv_plain(x, norm_w, norm_b, w_qkv, b_qkv, positions,
                           block_tables, k_pages, v_pages, *, eps,
                           n_heads, n_kv_heads, head_dim):
    """Plain PyTorch version of :func:`fused_decode_qkv` (any device)."""
    b = x.shape[0]
    h = _norm_block(x, norm_w, norm_b, eps)
    qkv = h @ w_qkv.t()
    if b_qkv is not None:
        qkv = qkv + b_qkv
    nq, nk = n_heads * head_dim, n_kv_heads * head_dim
    q = qkv[:, :nq].reshape(b, n_heads, head_dim)
    k = qkv[:, nq:nq + nk].reshape(b, n_kv_heads, head_dim).transpose(0, 1)
    v = qkv[:, nq + nk:].reshape(b, n_kv_heads, head_dim).transpose(0, 1)
    _append(k, v, k_pages, v_pages, positions, block_tables)
    return q, k_pages, v_pages


def _one(ws, what):
    """The fused GPT weight (or bias) out of a JAX-style list."""
    if isinstance(ws, (list, tuple)):
        if len(ws) == 3:
            raise NotImplementedError(
                f"fused_decode_qkv: separate q/k/v {what} (the LLaMA "
                f"branch) {_LLAMA}")
        if len(ws) == 0:
            return None
        if len(ws) != 1:
            raise ValueError(f"fused_decode_qkv: expected one fused {what}, "
                             f"got {len(ws)}")
        return ws[0]
    return ws


def _refuse(norm, rope_theta, k_pages, k_scales, v_scales):
    if rope_theta is not None:
        raise NotImplementedError(f"fused_decode_qkv: rope {_LLAMA}")
    if norm == "rms":
        raise NotImplementedError(f"fused_decode_qkv: norm='rms' {_LLAMA}")
    if norm != "layer":
        raise ValueError(f"fused_decode_qkv: norm must be 'layer' or 'rms', "
                         f"got {norm!r}")
    if k_scales is not None or v_scales is not None \
            or k_pages.dtype == torch.int8:
        raise NotImplementedError(
            "fused_decode_qkv: int8 pools with scale pools arrive with the "
            "port's kv_quant slice")
    if k_pages.dtype == torch.bfloat16:
        raise NotImplementedError(
            "fused_decode_qkv: bf16 pools wait for a bf16 variant of the "
            "paged attention")


def fused_decode_qkv(x, norm_w, norm_b, w_qkv, b_qkv, positions,
                     block_tables, k_pages, v_pages, k_scales=None,
                     v_scales=None, *, norm="layer", eps=1e-5, n_heads,
                     n_kv_heads, head_dim, rope_theta=None, rows=None,
                     interpret=None):
    """Fused LayerNorm + QKV + paged append for one decode step.

    x [B, H] token hidden states; norm_w/norm_b [H] (norm_b may be
    None); w_qkv ``[(nh + 2 hk) hd, H]`` (``[out, in]``, columns in the
    GPT order ``[3, nh, hd]``), b_qkv ``[(nh + 2 hk) hd]`` or None (a
    one-element list of either is taken too); positions [B] each row's
    token index; block_tables [B, NP]; k_pages/v_pages fp32
    ``[Hk, P, page_size, hd]``, written in place. Returns
    ``(q [B, nh, hd], k_pages, v_pages)``."""
    del rows, interpret     # TPU tiling / interpret knobs
    _refuse(norm, rope_theta, k_pages, k_scales, v_scales)
    w_qkv, b_qkv = _one(w_qkv, "weights"), _one(b_qkv, "biases")
    if x.dim() != 2 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"fused_decode_qkv: x must be [B, H] and the pools equal "
            f"[Hk, P, page_size, D], got {tuple(x.shape)}, "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    bsz, hid = x.shape
    n_out = (n_heads + 2 * n_kv_heads) * head_dim
    if tuple(w_qkv.shape) != (n_out, hid):
        raise ValueError(f"fused_decode_qkv: w_qkv must be [{n_out}, {hid}] "
                         f"([out, in]), got {tuple(w_qkv.shape)}")
    if b_qkv is not None and tuple(b_qkv.shape) != (n_out,):
        raise ValueError(f"fused_decode_qkv: b_qkv must be [{n_out}], got "
                         f"{tuple(b_qkv.shape)}")
    if k_pages.shape[0] != n_kv_heads or k_pages.shape[3] != head_dim:
        raise ValueError(f"fused_decode_qkv: pools {tuple(k_pages.shape)} do "
                         f"not hold {n_kv_heads} kv heads of {head_dim}")
    if positions.numel() != bsz or block_tables.dim() != 2 \
            or block_tables.shape[0] != bsz:
        raise ValueError(f"fused_decode_qkv: positions [{bsz}] and "
                         f"block_tables [{bsz}, NP] expected, got "
                         f"{tuple(positions.shape)} and "
                         f"{tuple(block_tables.shape)}")
    tensors = [x, norm_w, norm_b, w_qkv, b_qkv, positions, block_tables,
               k_pages, v_pages]
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"fused_decode_qkv: inputs on several devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    kw = dict(eps=eps, n_heads=n_heads, n_kv_heads=n_kv_heads,
              head_dim=head_dim)
    if dev.type == "cpu":
        return fused_decode_qkv_plain(x, norm_w, norm_b, w_qkv, b_qkv,
                                      positions, block_tables, k_pages,
                                      v_pages, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_decode_qkv: no kernel for device {dev}")
    for name, t in (("x", x), ("norm_w", norm_w), ("norm_b", norm_b),
                    ("w_qkv", w_qkv), ("b_qkv", b_qkv),
                    ("k_pages", k_pages), ("v_pages", v_pages)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"fused_decode_qkv: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_decode_qkv: {name} must be contiguous")
    if hid % 4 or x.data_ptr() % 16 or w_qkv.data_ptr() % 16:
        raise ValueError("fused_decode_qkv: H must be a multiple of 4 and x "
                         "and w_qkv 16-byte aligned")
    fn, smem_bytes, err_str = _kernel()
    smem = smem_bytes(bsz, hid)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_decode_qkv: {bsz} rows of {hid} need "
                         f"{smem} B of shared memory > {SMEM_LIMIT}")
    pos = positions.reshape(-1).to(torch.int64).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    q = torch.empty(bsz, n_heads, head_dim, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), norm_w.data_ptr(),
                None if norm_b is None else norm_b.data_ptr(),
                w_qkv.data_ptr(),
                None if b_qkv is None else b_qkv.data_ptr(),
                pos.data_ptr(), bt.data_ptr(), q.data_ptr(),
                k_pages.data_ptr(), v_pages.data_ptr(), bsz, hid, n_heads,
                n_kv_heads, head_dim, k_pages.shape[1], k_pages.shape[2],
                bt.shape[1], float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"fused_decode_qkv kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    fused_decode_qkv.launches += 1
    return q, k_pages, v_pages


fused_decode_qkv.launches = 0
