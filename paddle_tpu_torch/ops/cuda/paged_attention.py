"""Ragged paged-KV attention (decode + mixed prefill/decode) for Hopper.

Replaces the Pallas TPU kernel ``_ragged_kernel`` (``paddle_tpu/ops/
pallas/paged_attention.py``; entries ``ragged_paged_attention`` and
``paged_decode_attention``) for fp32 page pools and for int8 page pools
with f32 scale side-pools, with the same signatures and layouts:

* the KV cache is a PAGE POOL ``[num_kv_heads, total_pages, page_size,
  head_dim]``; each sequence owns a block table of page ids;
* ``q`` packs the tokens of ALL sequences in sequence order, each
  segment padded up to a multiple of ``q_block`` — decode rows (q_len 1)
  and prefill chunks share ONE call;
* causality is positional: q token ``i`` of a sequence attends kv
  positions ``<= kv_len - q_len + i``; GQA groups the ``Hq // Hk`` query
  heads of a kv head;
* int8 pools come with ``k_scales``/``v_scales`` ``[Hk, P, page_size]``
  f32 (``quantization.kv_quantize``: one scale per kv head and token
  slot), both or neither; a K/V value is its int8 byte times its slot's
  scale, dequantized inside the kernel's load loop.

What bounds it on the H100 is the KV bytes (4 B x head_dim x 2 per token
and kv head with fp32 pools, head_dim + 4 with int8 ones, read once per
q block); the kernel
(``csrc/paged_attention.cu``) reads only the pages a q block needs, up
to its causal bound, with 16-byte coalesced loads, and keeps scores and
softmax state on chip. Its design notes are in the source.

CPU tensors take :func:`ragged_paged_attention_plain`, the plain PyTorch
version of the same function; CUDA tensors launch the kernel or raise.
``pages_per_block`` is accepted for API parity with the TPU entry and
not read: the TPU autotune cache does not apply to this kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["ragged_paged_attention", "paged_decode_attention",
           "ragged_paged_attention_plain"]

MAX_HEAD_DIM = 128
MAX_ROWS = 64   # q_block * (Hq // Hk) query rows one CTA stages

_fn = None
_ones: dict = {}   # (batch, device) -> int32 ones, the q_lens of a decode


def _cdiv(a, b):
    return (a + b - 1) // b


def _kernel():
    """``(fp32 launcher, int8 launcher, error string)``."""
    global _fn
    if _fn is None:
        from ._build import load
        lib = load("paged_attention")
        f = lib.pdt_ragged_paged_attention_f32
        f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                      + [ctypes.c_float, ctypes.c_void_p])
        f.restype = ctypes.c_int
        f8 = lib.pdt_ragged_paged_attention_i8
        f8.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        f8.restype = ctypes.c_int
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _fn = (f, f8, lib.pdt_cuda_error_string)
    return _fn


def _check(q, k_pages, v_pages, block_tables, kv_lens, q_lens, q_block,
           pages_per_block, k_scales=None, v_scales=None):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(
            f"ragged_paged_attention: q must be [T, Hq, D] and the pools "
            f"[Hk, P, page_size, D], got {tuple(q.shape)} and "
            f"{tuple(k_pages.shape)}")
    t, hq, d = q.shape
    hk, _, _, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(
            f"ragged_paged_attention: pool shapes {tuple(k_pages.shape)}/"
            f"{tuple(v_pages.shape)} do not match q head_dim {d}")
    if hk == 0 or hq % hk != 0:
        raise ValueError(f"ragged_paged_attention: {hq} q heads not a "
                         f"multiple of {hk} kv heads")
    if block_tables.dim() != 2:
        raise ValueError("ragged_paged_attention: block_tables must be "
                         f"[B, pages_per_seq], got {tuple(block_tables.shape)}")
    bsz = block_tables.shape[0]
    if tuple(kv_lens.shape) != (bsz,) or tuple(q_lens.shape) != (bsz,):
        raise ValueError(
            f"ragged_paged_attention: kv_lens/q_lens must be [{bsz}], got "
            f"{tuple(kv_lens.shape)}/{tuple(q_lens.shape)}")
    if int(q_block) < 1:
        raise ValueError(f"q_block must be >= 1, got {q_block}")
    if pages_per_block is not None and int(pages_per_block) < 1:
        raise ValueError(f"pages_per_block must be >= 1, got "
                         f"{pages_per_block}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("ragged_paged_attention: pass both k_scales and "
                         "v_scales or neither")
    quant = k_scales is not None
    if q.dtype != torch.float32:
        raise TypeError(f"ragged_paged_attention: q must be float32, got "
                        f"{q.dtype}")
    pool_dt = torch.int8 if quant else torch.float32
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.dtype != pool_dt:
            raise TypeError(
                f"ragged_paged_attention: {name} must be {pool_dt} "
                + ("with k_scales/v_scales" if quant else
                   "without scales (int8 pools take k_scales/v_scales; "
                   "bf16 pools come with a later slice)")
                + f", got {x.dtype}")
    if quant:
        want = tuple(k_pages.shape[:3])
        for name, x in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(x.shape) != want:
                raise ValueError(f"ragged_paged_attention: {name} must be "
                                 f"{list(want)}, got {tuple(x.shape)}")
            if x.dtype != torch.float32:
                raise TypeError(f"ragged_paged_attention: {name} must be "
                                f"float32, got {x.dtype}")
    for name, x in (("block_tables", block_tables), ("kv_lens", kv_lens),
                    ("q_lens", q_lens)):
        if x.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"ragged_paged_attention: {name} must be an "
                            f"integer tensor, got {x.dtype}")
    devs = {x.device for x in (q, k_pages, v_pages, block_tables, kv_lens,
                               q_lens) + ((k_scales, v_scales) if quant
                                          else ())}
    if len(devs) != 1:
        raise ValueError(f"ragged_paged_attention: inputs on several "
                         f"devices {sorted(map(str, devs))}")
    return devs.pop()


def ragged_paged_attention(q, k_pages, v_pages, block_tables, kv_lens,
                           q_lens, q_block=8, pages_per_block=None,
                           scale=None, k_scales=None, v_scales=None):
    """Attention for a continuously-batched step over a paged KV cache.

    q: [T, Hq, D] packed tokens (segment b starts at
    ``q_block * sum(ceil(q_lens[:b] / q_block))``); k_pages/v_pages:
    [Hk, P, page_size, D] fp32 pools, or int8 pools with
    k_scales/v_scales [Hk, P, page_size] f32, this step's K/V already
    written;
    block_tables: [B, NP] page ids; kv_lens: [B] kv tokens per sequence
    INCLUDING this step's; q_lens: [B] tokens each sequence contributes
    (0 = sits out). Returns [T, Hq, D]; rows of segment padding hold
    values no caller reads, rows past the live segments hold 0.
    """
    dev = _check(q, k_pages, v_pages, block_tables, kv_lens, q_lens,
                 q_block, pages_per_block, k_scales, v_scales)
    if dev.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, block_tables, kv_lens, q_lens,
            q_block=q_block, scale=scale, k_scales=k_scales,
            v_scales=v_scales)
    if dev.type != "cuda":
        raise ValueError(f"ragged_paged_attention: no kernel for device "
                         f"{dev}")
    t, hq, d = q.shape
    hk, npool, page_size, _ = k_pages.shape
    q_block = int(q_block)
    quant = k_scales is not None
    align = 16 if quant else 4
    if d % align or d > MAX_HEAD_DIM:
        raise ValueError(f"ragged_paged_attention: head_dim {d} must be a "
                         f"multiple of {align} and <= {MAX_HEAD_DIM}")
    if q_block * (hq // hk) > MAX_ROWS:
        raise ValueError(
            f"ragged_paged_attention: q_block {q_block} x {hq // hk} q "
            f"heads per kv head exceeds the kernel's {MAX_ROWS} rows")
    scales = (("k_scales", k_scales), ("v_scales", v_scales)) if quant \
        else ()
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables)) + scales:
        if not x.is_contiguous():
            raise ValueError(f"ragged_paged_attention: {name} must be "
                             f"contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("ragged_paged_attention: page pools must be "
                         "16-byte aligned")
    bt = block_tables.to(torch.int32).contiguous()
    kvl = kv_lens.to(torch.int32).contiguous()
    ql = q_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    fn, fn8, err_str = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if quant:
            rc = fn8(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     k_scales.data_ptr(), v_scales.data_ptr(),
                     bt.data_ptr(), kvl.data_ptr(), ql.data_ptr(),
                     out.data_ptr(), t, hq, hk, d, npool, page_size,
                     bt.shape[0], bt.shape[1], q_block, scale, stream)
        else:
            rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    bt.data_ptr(), kvl.data_ptr(), ql.data_ptr(),
                    out.data_ptr(), t, hq, hk, d, npool, page_size,
                    bt.shape[0], bt.shape[1], q_block, scale, stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens,
                           scale=None, pages_per_block=None, k_scales=None,
                           v_scales=None):
    """One decode step: q [B, Hq, D], one token per sequence; seq_lens
    [B] valid tokens including the current one; int8 pools with
    k_scales/v_scales as in :func:`ragged_paged_attention`. This is
    :func:`ragged_paged_attention` with ``q_block=1``; its q_lens (all
    ones) are made once per batch size and device, not per call."""
    key = (q.shape[0], q.device)
    ones = _ones.get(key)
    if ones is None:
        ones = torch.ones(q.shape[0], dtype=torch.int32, device=q.device)
        _ones[key] = ones
    return ragged_paged_attention(q, k_pages, v_pages, block_tables,
                                  seq_lens, ones, q_block=1,
                                  pages_per_block=pages_per_block,
                                  scale=scale, k_scales=k_scales,
                                  v_scales=v_scales)


def ragged_paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 kv_lens, q_lens, q_block=8,
                                 pages_per_block=None, scale=None,
                                 k_scales=None, v_scales=None):
    """Plain PyTorch version of :func:`ragged_paged_attention` (any
    device): per sequence, gather its pages (int8 ones times their
    slots' scales), mask causally, softmax, weight V. Rows the kernel
    writes, it writes: segment padding rows attend like a token past the
    end of the sequence, rows past the live segments and rows that
    attend nothing are 0."""
    t, hq, d = q.shape
    hk, _, page_size, _ = k_pages.shape
    rep = hq // hk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.zeros_like(q)
    kvl = kv_lens.tolist()
    ql = q_lens.tolist()
    row0 = 0
    for b in range(len(ql)):
        n = max(int(ql[b]), 0)
        if n == 0:
            continue
        rows = _cdiv(n, q_block) * q_block
        m = min(rows, t - row0)
        if m <= 0:
            break
        kv = int(kvl[b])
        npg = _cdiv(kv, page_size)
        pages = block_tables[b, :npg].long()
        k = k_pages[:, pages].reshape(hk, npg * page_size, d)[:, :kv]
        v = v_pages[:, pages].reshape(hk, npg * page_size, d)[:, :kv]
        if k_scales is not None:
            ks = k_scales[:, pages].reshape(hk, npg * page_size)[:, :kv]
            vs = v_scales[:, pages].reshape(hk, npg * page_size)[:, :kv]
            k = k.to(torch.float32) * ks[..., None]
            v = v.to(torch.float32) * vs[..., None]
        qs = (q[row0:row0 + m] * scale).reshape(m, hk, rep, d)
        s = torch.einsum("mhrd,hkd->hrmk", qs, k)          # [Hk,rep,m,kv]
        q_pos = kv - n + torch.arange(m, device=q.device)
        allow = (torch.arange(kv, device=q.device)[None, :]
                 <= q_pos[:, None])                         # [m, kv]
        s = s.masked_fill(~allow, float("-inf"))
        p = torch.softmax(s, dim=-1)
        p = torch.where(allow.any(-1)[:, None], p, torch.zeros_like(p))
        o = torch.einsum("hrmk,hkd->mhrd", p, v)
        out[row0:row0 + m] = o.reshape(m, hq, d)
        row0 += rows
    return out
