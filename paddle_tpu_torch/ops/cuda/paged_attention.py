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
  scale.

What bounds it on the H100 is the KV bytes (4 B x head_dim x 2 per token
and kv head with fp32 pools, head_dim + 4 with int8 ones). The kernel
(``csrc/paged_attention.cu``, design notes there) plans flat (segment,
q tile, kv split) units as the TPU kernel does, reads each needed K/V
token once per tile of up to 64 query rows, splits long kv ranges
across CTAs and combines the splits in a fixed order. Two routes, picked
by :func:`route` from static shapes alone (no device length is read):

* ``"mixed"`` (q_block > 1, or a GQA group other than 1, 2 or 4 heads):
  Q.K^T and P.V on the tensor cores, fp32 values as three bf16 planes;
  counted in ``ragged_paged_attention.mixed_launches``;
* ``"decode"`` (q_block 1 and a group of 1, 2 or 4 heads): CUDA-core
  dots with 16-byte loads, split along KV; counted in
  ``ragged_paged_attention.decode_launches``.

:func:`work_plan` is the plain version of the kernel's plan (what each
split covers), for the tests. CPU tensors take
:func:`ragged_paged_attention_plain`, the plain PyTorch version of the
same function; CUDA tensors launch the kernel or raise.
``pages_per_block`` is accepted for API parity with the TPU entry and
not read: the TPU autotune cache does not apply to this kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["ragged_paged_attention", "paged_decode_attention",
           "ragged_paged_attention_plain", "route", "work_plan",
           "HEAD_DIMS"]

# head dims the kernel takes on a card, by pool type
HEAD_DIMS = {"fp32": (8, 16, 32, 64, 128), "int8": (16, 32, 64, 128)}
DECODE_REPS = (1, 2, 4)   # GQA groups the decode route takes
TILE_ROWS = 64            # query rows of one mixed-route tile
CHUNK = 64                # kv tokens a mixed-route CTA stages at a time
MIXED_SPLIT = 128         # the mixed route's scratch holds a unit's
                          # splits down to this many kv tokens
DECODE_SPLIT = 256        # kv tokens of a decode split
CTAS = 264                # resident CTAs :func:`work_plan` assumes (an
                          # H100's 132 SMs, two a SM)
CTAS_PER_UNIT = 2         # resident CTAs a mixed unit (the kernel's
                          # kCtasPerUnit)

_fn = None
_ones: dict = {}      # (batch, device) -> int32 ones, the q_lens of a decode
_scratch: dict = {}   # (device, stream) -> split scratch and unit counts


def _cdiv(a, b):
    return (a + b - 1) // b


def route(q_block, rep):
    """The kernel route for a call with this ``q_block`` and GQA group
    size ``rep`` (``Hq // Hk``): ``"decode"`` for q_block 1 with a group
    of 1, 2 or 4 heads, else ``"mixed"``."""
    return ("decode" if int(q_block) == 1 and int(rep) in DECODE_REPS
            else "mixed")


def max_splits(which, table_width, page_size):
    """Most kv splits a unit of route ``which`` can have: the longest
    table's tokens over the split length (the scratch's depth)."""
    base = MIXED_SPLIT if which == "mixed" else DECODE_SPLIT
    return max(1, _cdiv(int(table_width) * int(page_size), base))


def split_geometry(kv, base, limit):
    """(splits, tokens a split) for a unit that needs ``kv`` tokens:
    ``base`` tokens each or, past ``limit`` splits, ``limit`` splits of a
    multiple of 16 tokens (the kernel's ``split_geom``)."""
    if kv <= 0:
        return 1, base
    n = _cdiv(kv, base)
    if n <= limit:
        return n, base
    length = _cdiv(_cdiv(kv, limit), 16) * 16
    return _cdiv(kv, length), length


def tile_splits(kv_need, rows, work, limit):
    """(splits, tokens a split) of a mixed tile: ``work`` chunk-weights a
    unit (a chunk of a tile of more than 32 rows weighs 2), whole chunks
    each, at most ``limit`` splits (the kernel's ``tile_splits``)."""
    chunks = _cdiv(max(kv_need, 1), CHUNK)
    units = max(1, _cdiv(chunks * (2 if rows > 32 else 1), work))
    length = _cdiv(chunks, units) * CHUNK
    if _cdiv(kv_need, length) > limit:
        length = _cdiv(_cdiv(kv_need, limit), 16) * 16
    return (1 if kv_need <= 0 else _cdiv(kv_need, length)), length


def work_plan(kv_lens, q_lens, q_block, rep, tokens, table_width,
              page_size, kv_heads=1, ctas=CTAS):
    """The kernel's plan for one call, as the plain version of its walk:
    a list of units, each a dict with the sequence ``b``, the query rows
    ``rows`` (``(token, q head of the group)`` pairs, packed token
    index), each row's last attended position ``pos`` (``-1``: none),
    the unit's ``kv`` range ``(lo, hi)`` for each split and ``splits``;
    every kv head runs each unit. ``tokens`` is q's packed length; the
    mixed route sizes its splits for ``ctas`` resident CTAs, about one
    unit every CTAS_PER_UNIT."""
    which = route(q_block, rep)
    limit = max_splits(which, table_width, page_size)
    segs, tok0 = [], 0
    for b, (kv, ql) in enumerate(zip(kv_lens, q_lens)):
        kv, ql = int(kv), max(int(ql), 0)
        seg = _cdiv(ql, q_block) * q_block
        if tok0 >= tokens:
            break
        if seg:
            segs.append((b, kv, ql, tok0, min(seg, tokens - tok0)))
        tok0 += seg
    units, tiles = [], []
    for b, kv, ql, t0, ntok in segs:
        if which == "decode":
            for i in range(ntok):
                n, length = split_geometry(kv, DECODE_SPLIT, limit)
                tiles.append((b, kv, ql, t0, [(t0 + i, r) for r in range(rep)],
                              (n, length)))
            continue
        for r0 in range(0, ntok * rep, TILE_ROWS):
            rows = [(t0 + sr // rep, sr % rep) for sr in
                    range(r0, min(r0 + TILE_ROWS, ntok * rep))]
            tiles.append((b, kv, ql, t0, rows, None))
    if which == "mixed":
        def need(kv, ql, t0, rows):
            return max(0, min(kv, kv - ql + rows[-1][0] - t0 + 1))
        total = sum(_cdiv(max(need(kv, ql, t0, rows), 1), CHUNK)
                    * (2 if len(rows) > 32 else 1)
                    for _, kv, ql, t0, rows, _ in tiles)
        work = max(2, _cdiv(total, max(1, ctas // (CTAS_PER_UNIT
                                                    * kv_heads))))
        tiles = [(b, kv, ql, t0, rows,
                  tile_splits(need(kv, ql, t0, rows), len(rows), work, limit))
                 for b, kv, ql, t0, rows, _ in tiles]
    for b, kv, ql, t0, rows, (n, length) in tiles:
        pos = [kv - ql + (t - t0) for t, _ in rows]
        top = max(0, min(kv, max(pos) + 1))
        units.append(dict(b=b, rows=rows, pos=pos, splits=n, kv=[
            (s * length, min((s + 1) * length, top)) for s in range(n)]))
    return units


def _kernel():
    """``(launcher, error string)``."""
    global _fn
    if _fn is None:
        from ._build import load
        lib = load("paged_attention")
        f = lib.pdt_ragged_paged_attention
        f.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12
                      + [ctypes.c_int] * 11
                      + [ctypes.c_float, ctypes.c_void_p])
        f.restype = ctypes.c_int
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _fn = (f, lib.pdt_cuda_error_string)
    return _fn


def _buffers(dev, stream, n_acc, n_ml, n_count):
    """The split scratch (floats) and the unit counts (int32 zeros, put
    back to 0 by every launch) of one stream, grown as calls need."""
    key = (dev, stream)
    buf = _scratch.get(key)
    if buf is None or buf[0].numel() < n_acc or buf[1].numel() < n_ml \
            or buf[2].numel() < n_count:
        old = buf or (None, None, None)
        grow = [n if t is None or t.numel() < n else t.numel()
                for t, n in zip(old, (n_acc, n_ml, n_count))]
        buf = (torch.empty(grow[0], dtype=torch.float32, device=dev),
               torch.empty(grow[1], dtype=torch.float32, device=dev),
               old[2] if old[2] is not None and old[2].numel() >= n_count
               else torch.zeros(grow[2], dtype=torch.int32, device=dev))
        _scratch[key] = buf
    return buf


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
    dims = HEAD_DIMS["int8" if quant else "fp32"]
    if d not in dims:
        raise ValueError(f"ragged_paged_attention: head_dim {d} is not one "
                         f"the kernel takes with "
                         f"{'int8' if quant else 'fp32'} pools {dims}")
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
    if q.data_ptr() % 16:   # a view at an odd offset: the kernel reads
        q = q.clone()       # q rows with 16-byte loads
    bt = block_tables.to(torch.int32).contiguous()
    kvl = kv_lens.to(torch.int32).contiguous()
    ql = q_lens.to(torch.int32).contiguous()
    nseq, width = bt.shape
    rep = hq // hk
    which = route(q_block, rep)
    splits = max_splits(which, width, page_size)
    units = (t if which == "decode"
             else _cdiv(t * rep, TILE_ROWS) + nseq) * hk
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    fn, err_str = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        acc, ml, count = _buffers(dev, stream, splits * t * hq * d,
                                  splits * t * hq * 2, units)
        rc = fn(int(which == "decode"), int(quant), q.data_ptr(),
                k_pages.data_ptr(), v_pages.data_ptr(),
                k_scales.data_ptr() if quant else None,
                v_scales.data_ptr() if quant else None,
                bt.data_ptr(), kvl.data_ptr(), ql.data_ptr(),
                out.data_ptr(), acc.data_ptr(), ml.data_ptr(),
                count.data_ptr(), t, hq, hk, d, npool, page_size, nseq,
                width, q_block,
                MIXED_SPLIT if which == "mixed" else DECODE_SPLIT, splits,
                scale, stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    ragged_paged_attention.launches += 1
    if which == "decode":
        ragged_paged_attention.decode_launches += 1
    else:
        ragged_paged_attention.mixed_launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.mixed_launches = 0
ragged_paged_attention.decode_launches = 0


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
