"""Fused decode ingress for Hopper: norm + QKV projection (+ rope) +
paged-KV append (+ int8 quantize-on-write) of one decode step, in one
launch.

Replaces the Pallas TPU kernel ``fused_decode_qkv``
(``paddle_tpu/ops/pallas/fused_decode_qkv.py``, body ``_qkv_kernel``)
with its branches: ``norm="layer"`` or ``"rms"``, one fused projection
whose output columns are ordered ``[3, heads, head_dim]`` (GPT) or three
separate ``wq``/``wk``/``wv`` (LLaMA), biases or none, GQA (``n_kv_heads
< n_heads``), rotate-half rope at each row's position (``rope_theta``)
and fp32 pools ``[Hk, P, page_size, D]`` or int8 pools with fp32 scale
pools ``[Hk, P, page_size]``. The math is the JAX ``_qkv_block``: the
norm of ``_norm_block`` (LayerNorm: ``var = E[x^2] - mean^2``, not
``nn.LayerNorm``'s two-pass variance; RMSNorm: ``x * rsqrt(E[x^2] +
eps)``; then the weight, and the bias only when present), the
projections plus their biases, rope on q and k, and each row's K and V
written at ``(bt[b, min(pos // page_size, NP - 1)], pos % page_size)``
(the JAX ``_page_slot``: positions past the table clamp onto its last
page), through ``kv_quantize`` into int8 pools (``_quantize_or_cast``).
Where two rows share a (page, slot), the later row's value stays, as
the JAX kernel writes them row by row.

The rope angles have one home, the serving path's
``models.generation._rope_tables`` (fp32 ``theta ** -e``, the JAX
package's traced form): a caller passes ``rope=(cos, sin)`` ``[B, hd]``
made there once for all layers, or ``rope_theta`` and the wrapper makes
them; not both.

Weights come in the port's ``nn.Linear`` layout ``[out, in]`` (the JAX
package passes ``[in, out]``): each output column is then one contiguous
weight row, which is what the kernels' GEMV streams. The pools are
written IN PLACE (the TPU kernel's ``input_output_aliases``) and
returned.

CPU tensors take :func:`fused_decode_qkv_plain`; CUDA tensors launch a
kernel of ``csrc/fused_decode_qkv.cu`` or raise: a call without rope
(GPT's, over fp32 or int8 pools) the split-K kernel, its heads' K cut
into :func:`split_plan`'s slices (counted in
``fused_decode_qkv.split_launches``), a call with rope (LLaMA's) the
per-head kernel. ``rows=`` and ``interpret=`` are the TPU kernel's
tiling and interpret knobs: accepted for call compatibility and not
read. bf16 pools raise: the paged attention has no bf16 variant yet.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["fused_decode_qkv", "fused_decode_qkv_plain", "_norm_block",
           "split_plan", "split_work"]

SMEM_LIMIT = 227 * 1024   # dynamic shared memory one CTA may use (H100)
SPLIT_Q = 64   # float4s of one of the split kernel's K-slices, at most

_lib = None
_split_bufs: dict = {}  # (device, stream, heads, floats) -> counts, sums


def _kernel():
    global _lib
    if _lib is None:
        from ._build import load
        lib = load("fused_decode_qkv")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pdt_fused_decode_qkv_split.argtypes = ([P] * 18 + [I] * 10
                                                   + [ctypes.c_float, P])
        lib.pdt_fused_decode_qkv_split.restype = I
        lib.pdt_fused_decode_qkv_split_smem_bytes.argtypes = [I] * 3
        lib.pdt_fused_decode_qkv_split_smem_bytes.restype = ctypes.c_size_t
        lib.pdt_fused_decode_qkv_split_q.restype = I
        if lib.pdt_fused_decode_qkv_split_q() != SPLIT_Q:
            raise RuntimeError(f"fused_decode_qkv: the library's K-slices "
                               f"hold {lib.pdt_fused_decode_qkv_split_q()} "
                               f"float4s, this module plans {SPLIT_Q}")
        lib.pdt_fused_decode_qkv_heads.argtypes = ([P] * 18 + [I] * 9
                                                   + [ctypes.c_float, P])
        lib.pdt_fused_decode_qkv_heads.restype = I
        lib.pdt_fused_decode_qkv_heads_smem_bytes.argtypes = [I] * 3
        lib.pdt_fused_decode_qkv_heads_smem_bytes.restype = ctypes.c_size_t
        lib.pdt_cuda_error_string.argtypes = [I]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _norm_block(x, w, b, eps, norm="layer"):
    """The JAX package's ``_norm_block``: moments in fp32; LayerNorm
    ``(x - mean) * rsqrt(E[x^2] - mean^2 + eps)`` or RMSNorm ``x *
    rsqrt(E[x^2] + eps)``, then the weight, then the bias only when
    present."""
    v = x.float()
    if norm == "layer":
        mean = v.mean(dim=-1, keepdim=True)
        var = torch.square(v).mean(dim=-1, keepdim=True) - torch.square(mean)
        out = ((v - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    else:
        ms = torch.square(v).mean(dim=-1, keepdim=True)
        out = (v * torch.rsqrt(ms + eps)).to(x.dtype)
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


def _append(kt, vt, k_pages, v_pages, positions, block_tables,
            k_scales=None, v_scales=None):
    """Write head-major ``kt``/``vt`` ``[Hk, B, D]`` in place, row by
    row as the JAX kernel does: where two rows share a (page, slot), the
    later row's value stays. With scale pools, through ``kv_quantize``
    first (``_quantize_or_cast``)."""
    ps = k_pages.shape[2]
    page, slot = _page_slot(positions, block_tables, ps)
    key = page * ps + slot
    later = torch.triu(key[:, None] == key[None, :], diagonal=1).any(dim=1)
    keep = ~later
    page, slot = page[keep], slot[keep]
    kt, vt = kt[:, keep], vt[:, keep]
    if k_scales is not None:
        from ...quantization import kv_quantize
        kt, ks = kv_quantize(kt)
        vt, vs = kv_quantize(vt)
        k_scales[:, page, slot] = ks
        v_scales[:, page, slot] = vs
    k_pages[:, page, slot] = kt.to(k_pages.dtype)
    v_pages[:, page, slot] = vt.to(v_pages.dtype)


def _as_lists(ws, bs):
    """The weights and biases as lists: one fused weight (rows ``[q | k |
    v]``) or three (wq, wk, wv), and as many biases or none; a bare
    tensor or ``None`` is taken too."""
    ws = list(ws) if isinstance(ws, (list, tuple)) else [ws]
    bs = [] if bs is None else \
        list(bs) if isinstance(bs, (list, tuple)) else [bs]
    if len(ws) not in (1, 3) or len(bs) not in (0, len(ws)):
        raise ValueError(f"fused_decode_qkv: one fused weight or three "
                         f"(wq, wk, wv), and as many biases or none; got "
                         f"{len(ws)} weights and {len(bs)} biases")
    return ws, bs


def _split_ptrs(ws, bs, nq, nk, hid):
    """The device addresses of ``wq, wk, wv, bq, bk, bv`` (0 for an
    absent bias): a fused weight and bias give offsets into their
    storage (fp32, ``[out, in]``), three give their own."""
    if len(ws) == 3:
        return [w.data_ptr() for w in ws] + (
            [b.data_ptr() for b in bs] if bs else [0] * 3)
    w0 = ws[0].data_ptr()
    b0 = bs[0].data_ptr() if bs else 0
    offs = (0, nq, nq + nk)
    return [w0 + 4 * o * hid for o in offs] + [
        b0 + 4 * o if bs else 0 for o in offs]


def _rope(x, positions, head_dim, rope_theta, rope):
    """cos/sin ``[B, hd]`` fp32 at each row's position: the caller's
    (checked against x's rows, device and dtype), or made from
    ``rope_theta`` by the one home of the angles. Both at once are
    refused: the tables would silently win over a theta they disagree
    with."""
    if rope is None:
        from ...models.generation import _rope_tables
        return _rope_tables(positions.reshape(-1), head_dim, rope_theta)
    if rope_theta is not None:
        raise ValueError("fused_decode_qkv: pass rope_theta or the rope "
                         "tables rope=(cos, sin), not both")
    cos, sin = rope
    want = (x.shape[0], head_dim)
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != want or t.device != x.device \
                or t.dtype != torch.float32:
            raise ValueError(f"fused_decode_qkv: rope table {name} must be "
                             f"float32 {list(want)} on {x.device}, got "
                             f"{t.dtype} {list(t.shape)} on {t.device}")
    return cos, sin


def fused_decode_qkv_plain(x, norm_w, norm_b, w_qkv, b_qkv, positions,
                           block_tables, k_pages, v_pages, k_scales=None,
                           v_scales=None, *, eps, n_heads, n_kv_heads,
                           head_dim, norm="layer", rope_theta=None,
                           rope=None):
    """Plain PyTorch version of :func:`fused_decode_qkv` (any device):
    ``_qkv_block``'s math, then the append. Returns ``(q, k_pages,
    v_pages)``, and the scale pools after them when given."""
    b = x.shape[0]
    nq, nk = n_heads * head_dim, n_kv_heads * head_dim
    ws, bs = _as_lists(w_qkv, b_qkv)
    h = _norm_block(x, norm_w, norm_b, eps, norm)
    outs = [h @ w.t() for w in ws]
    if bs:
        outs = [o + bias for o, bias in zip(outs, bs)]
    if len(outs) == 1:     # one product, its columns cut as in the JAX
        outs = [outs[0][:, :nq], outs[0][:, nq:nq + nk],
                outs[0][:, nq + nk:]]
    q = outs[0].reshape(b, n_heads, head_dim)
    k = outs[1].reshape(b, n_kv_heads, head_dim)
    v = outs[2].reshape(b, n_kv_heads, head_dim)
    if rope_theta is not None or rope is not None:
        from ...models.generation import _apply_rope
        cos, sin = _rope(x, positions, head_dim, rope_theta, rope)
        cos, sin = cos[:, None, :], sin[:, None, :]
        q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
    _append(k.transpose(0, 1), v.transpose(0, 1), k_pages, v_pages,
            positions, block_tables, k_scales, v_scales)
    if k_scales is not None:
        return q, k_pages, v_pages, k_scales, v_scales
    return q, k_pages, v_pages


def split_plan(hid):
    """K-slices a head of the split kernel for ``hid`` inputs: the fewest
    none longer than ``SPLIT_Q`` float4s (GPT-124M: 3 slices of 256
    floats, 108 CTAs on one card, 54 on a TP=2 rank). More slices, to
    fill the SMs (4 or 6 at 36 heads, 4 to 12 at 18), measured no faster
    on an H100: every CTA stages its rows' statistics and its slice, and
    the head's last CTA adds one more partial sum a slice (``chip_ab.py
    gpt_plans``, PERF.md)."""
    return -(-(hid // 4) // SPLIT_Q)


def split_work(hid, hd, heads, slices):
    """Every CTA's share of the split kernel, the kernel's rule: ``(cta,
    n0, n1, k0, k1)``, CTA ``c`` taking K-slice ``c % slices`` of head
    ``c // slices``'s output columns; the head's last CTA to arrive adds
    the slices' sums in slice order."""
    k4 = hid // 4
    return [(h * slices + s, h * hd, (h + 1) * hd, 4 * (s * k4 // slices),
             4 * ((s + 1) * k4 // slices))
            for h in range(heads) for s in range(slices)]


def _split_buffers(dev, stream, heads, floats):
    """The split kernel's buffers on one stream (reused by its launches,
    which run in stream order): the addresses of the arrival counts a
    head, int32 zeros that every launch puts back to 0, and of the
    slices' sums, ``floats`` of them (slices x B x the outputs)."""
    key = (dev, stream, heads, floats)
    got = _split_bufs.get(key)
    if got is None:
        counts = torch.zeros(heads, dtype=torch.int32, device=dev)
        part = torch.empty(floats, dtype=torch.float32, device=dev)
        got = _split_bufs[key] = (counts.data_ptr(), part.data_ptr(),
                                  counts, part)
    return got


def _check_card(named):
    for name, t in named:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"fused_decode_qkv: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_decode_qkv: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_decode_qkv: {name} must be 16-byte "
                             f"aligned")


def _err(rc):
    msg = _kernel().pdt_cuda_error_string(rc).decode()
    raise RuntimeError(f"fused_decode_qkv kernel launch failed: {msg} "
                       f"(cudaError {rc})")


def fused_decode_qkv(x, norm_w, norm_b, w_qkv, b_qkv, positions,
                     block_tables, k_pages, v_pages, k_scales=None,
                     v_scales=None, *, norm="layer", eps=1e-5, n_heads,
                     n_kv_heads, head_dim, rope_theta=None, rope=None,
                     rows=None, interpret=None):
    """Fused norm + QKV (+ rope) + paged append for one decode step.

    x [B, H] token hidden states; norm_w/norm_b [H] (norm_b may be
    None); w_qkv one fused ``[(nh + 2 hk) hd, H]`` weight (``[out, in]``,
    columns in the order ``[q | k | v]``, GPT's ``[3, nh, hd]``) or a list
    of the three ``[wq, wk, wv]``; b_qkv the matching biases, ``[]`` or
    None; positions [B] each row's token index; block_tables [B, NP];
    k_pages/v_pages ``[Hk, P, page_size, hd]`` fp32, or int8 with
    k_scales/v_scales ``[Hk, P, page_size]`` fp32, written in place;
    ``rope_theta``, or instead precomputed fp32 ``rope=(cos, sin)``
    ``[B, hd]`` on x's device, rotates q and k. Returns ``(q [B, nh, hd], k_pages, v_pages)``, and the scale
    pools after them when given (the JAX function's return)."""
    del rows, interpret     # TPU tiling / interpret knobs
    if norm not in ("layer", "rms"):
        raise ValueError(f"fused_decode_qkv: norm must be 'layer' or 'rms', "
                         f"got {norm!r}")
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError("fused_decode_qkv: pass both k_scales and v_scales "
                         "or neither")
    if quant != (k_pages.dtype == torch.int8) \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"fused_decode_qkv: int8 pools go with scale pools "
                         f"and fp32 pools without; got {k_pages.dtype} and "
                         f"{v_pages.dtype} pools, scales "
                         f"{'given' if quant else 'not given'}")
    if k_pages.dtype == torch.bfloat16:
        raise NotImplementedError(
            "fused_decode_qkv: bf16 pools wait for a bf16 variant of the "
            "paged attention")
    ws, bs = _as_lists(w_qkv, b_qkv)
    if x.dim() != 2 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"fused_decode_qkv: x must be [B, H] and the pools equal "
            f"[Hk, P, page_size, D], got {tuple(x.shape)}, "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    bsz, hid = x.shape
    nq, nk = n_heads * head_dim, n_kv_heads * head_dim
    outs = [nq + 2 * nk] if len(ws) == 1 else [nq, nk, nk]
    for i, (w, n_out) in enumerate(zip(ws, outs)):
        if tuple(w.shape) != (n_out, hid):
            raise ValueError(f"fused_decode_qkv: weight {i} must be "
                             f"[{n_out}, {hid}] ([out, in]), got "
                             f"{tuple(w.shape)}")
        if bs and tuple(bs[i].shape) != (n_out,):
            raise ValueError(f"fused_decode_qkv: bias {i} must be "
                             f"[{n_out}], got {tuple(bs[i].shape)}")
    if k_pages.shape[0] != n_kv_heads or k_pages.shape[3] != head_dim:
        raise ValueError(f"fused_decode_qkv: pools {tuple(k_pages.shape)} do "
                         f"not hold {n_kv_heads} kv heads of {head_dim}")
    if quant and (tuple(k_scales.shape) != tuple(k_pages.shape[:3])
                  or v_scales.shape != k_scales.shape):
        raise ValueError(f"fused_decode_qkv: scale pools must be "
                         f"{list(k_pages.shape[:3])}, got "
                         f"{tuple(k_scales.shape)} and "
                         f"{tuple(v_scales.shape)}")
    if positions.numel() != bsz or block_tables.dim() != 2 \
            or block_tables.shape[0] != bsz:
        raise ValueError(f"fused_decode_qkv: positions [{bsz}] and "
                         f"block_tables [{bsz}, NP] expected, got "
                         f"{tuple(positions.shape)} and "
                         f"{tuple(block_tables.shape)}")
    roped = rope_theta is not None or rope is not None
    if roped and head_dim % 2:
        raise ValueError(f"fused_decode_qkv: rope needs an even head_dim, "
                         f"got {head_dim}")
    tensors = [x, norm_w, norm_b, *ws, *bs, positions, block_tables,
               k_pages, v_pages, k_scales, v_scales]
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"fused_decode_qkv: inputs on several devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    kw = dict(eps=eps, n_heads=n_heads, n_kv_heads=n_kv_heads,
              head_dim=head_dim, norm=norm)
    if dev.type == "cpu":
        return fused_decode_qkv_plain(
            x, norm_w, norm_b, ws, bs, positions, block_tables, k_pages,
            v_pages, k_scales, v_scales, rope_theta=rope_theta, rope=rope,
            **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_decode_qkv: no kernel for device {dev}")
    cos = sin = None
    if roped:
        cos, sin = (t.contiguous() for t in _rope(
            x, positions, head_dim, rope_theta, rope))
    _check_card([("x", x), ("norm_w", norm_w), ("norm_b", norm_b)]
                + [(f"weight {i}", w) for i, w in enumerate(ws)]
                + [(f"bias {i}", b) for i, b in enumerate(bs)]
                + [("cos", cos), ("sin", sin), ("k_scales", k_scales),
                   ("v_scales", v_scales)])
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"fused_decode_qkv: {name} must be contiguous")
    if hid % 4:
        raise ValueError(f"fused_decode_qkv: H must be a multiple of 4, got "
                         f"{hid}")
    lib = _kernel()
    pos = positions.reshape(-1).to(torch.int64).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    q = torch.empty(bsz, n_heads, head_dim, dtype=x.dtype, device=dev)
    if roped:
        smem = lib.pdt_fused_decode_qkv_heads_smem_bytes(bsz, hid, head_dim)
    else:
        smem = lib.pdt_fused_decode_qkv_split_smem_bytes(bsz, hid, head_dim)
    if not 0 < smem <= SMEM_LIMIT:
        raise ValueError(f"fused_decode_qkv: {bsz} rows of {hid} do not fit "
                         f"the {SMEM_LIMIT} B of shared memory of a CTA")
    common = _split_ptrs(ws, bs, nq, nk, hid)
    pools = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             _ptr(k_scales), _ptr(v_scales))
    geo = (bsz, hid, n_heads, n_kv_heads, head_dim, k_pages.shape[1],
           k_pages.shape[2], bt.shape[1])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if roped:
            rc = lib.pdt_fused_decode_qkv_heads(
                x.data_ptr(), norm_w.data_ptr(), _ptr(norm_b), *common,
                cos.data_ptr(), sin.data_ptr(), pos.data_ptr(),
                bt.data_ptr(), *pools, *geo, int(norm == "rms"),
                float(eps), stream)
        else:
            heads = n_heads + 2 * n_kv_heads
            slices = split_plan(hid)
            counts, part = _split_buffers(
                dev, stream, heads, slices * bsz * (nq + 2 * nk))[:2]
            rc = lib.pdt_fused_decode_qkv_split(
                x.data_ptr(), norm_w.data_ptr(), _ptr(norm_b), *common,
                pos.data_ptr(), bt.data_ptr(), *pools, part, counts, *geo,
                slices, int(norm == "rms"), float(eps), stream)
    if rc != 0:
        _err(rc)
    fused_decode_qkv.launches += 1
    fused_decode_qkv.split_launches += not roped
    if quant:
        return q, k_pages, v_pages, k_scales, v_scales
    return q, k_pages, v_pages


def _ptr(t):
    return None if t is None else t.data_ptr()


fused_decode_qkv.launches = 0
fused_decode_qkv.split_launches = 0
