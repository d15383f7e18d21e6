"""The serving subset of ``paddle_tpu/models/generation.py``: paged-KV
page writes, the two attention steps the continuous-batching engine
runs (per-slot decode and the ragged mixed prefill+decode step), the
guarded greedy pick, the GPT forwards over them, and the megakernel
decode step (``fused_qkv_step`` -> ``paged_attend`` -> ``fused_mlp_step``
per layer, then ``fused_decode_logits``).

Page pools are updated IN PLACE (the JAX package threads them
functionally and donates the buffers; here an ``index_put_`` writes
the new tokens' K/V straight into the pool), and every function
returns the pools it was given so call sites read like the JAX ones.
Padding tokens route their writes to the reserved null page 0, so
several writes may target the same (page 0, slot 0): the value left
there is unspecified on CUDA, which is harmless only because page 0 is
never read.

``generate()`` and its contiguous KV cache, LLaMA, int8 KV and the
tensor-parallel paths arrive with later slices.
"""
from __future__ import annotations

import torch

from ..ops.cuda.fused_decode_mlp import (fused_decode_epilogue,
                                         fused_decode_mlp)
from ..ops.cuda.fused_decode_qkv import fused_decode_qkv
from ..ops.cuda.paged_attention import (paged_decode_attention,
                                        ragged_paged_attention)


def _split_caches(caches, n_layers):
    """Serving cache-list layout ``[k0, v0, ..., kL-1, vL-1]`` (fp
    pools; the int8 layout that appends scale pools comes with the
    kv_quant slice)."""
    n = 2 * n_layers
    if len(caches) == 2 * n:
        raise NotImplementedError(
            "int8 KV pools with scale side-pools arrive with the port's "
            "kv_quant slice")
    if len(caches) != n:
        raise ValueError(f"expected {n} cache pools for {n_layers} "
                         f"layers, got {len(caches)}")
    return caches


def _slot_page_write(kn, vn, k_pages, v_pages, bt, positions):
    """Write one token per slot into its (page, slot) in place: ``kn``/
    ``vn`` are head-major ``[Hk, B, D]``, ``positions`` [B] each slot's
    current token index."""
    p = positions.reshape(-1).long()
    ps = k_pages.shape[2]
    rows = torch.arange(p.shape[0], device=p.device)
    page = bt[rows, torch.clamp(p // ps, max=bt.shape[1] - 1)].long()
    slot = p % ps
    k_pages[:, page, slot] = kn.to(k_pages.dtype)
    v_pages[:, page, slot] = vn.to(v_pages.dtype)
    return k_pages, v_pages


def _ragged_page_write(kn, vn, k_pages, v_pages, bt, tok_pos, tok_slot,
                       tok_valid):
    """Packed-token analog of :func:`_slot_page_write`: ``kn``/``vn``
    are ``[Hk, T, D]``; invalid tokens route to the null page 0."""
    ps = k_pages.shape[2]
    pos = tok_pos.long()
    ok = tok_valid.bool()
    page = torch.where(
        ok, bt[tok_slot.long(), torch.clamp(pos // ps, max=bt.shape[1] - 1)]
        .long(), 0)
    wslot = torch.where(ok, pos % ps, 0)
    k_pages[:, page, wslot] = kn.to(k_pages.dtype)
    v_pages[:, page, wslot] = vn.to(v_pages.dtype)
    return k_pages, v_pages


def paged_slot_attention(q, k_new, v_new, k_pages, v_pages, positions,
                         block_tables, scale=None, pages_per_block=None):
    """One decode step against a paged KV cache with PER-SLOT state:
    q/k_new/v_new [B, 1, H(q|kv), D]; ``positions`` [B] and
    ``block_tables`` [B, NP] are data (admission and retirement change
    their values, never shapes). Writes each slot's K/V at its own
    (page, slot) and attends with per-slot lengths ``positions + 1``.
    Returns (out [B, 1, Hq, D], k_pages, v_pages)."""
    p = positions.reshape(-1)
    bt = block_tables.to(torch.int32)
    kn = k_new[:, 0].transpose(0, 1)                   # [Hk, B, D]
    vn = v_new[:, 0].transpose(0, 1)
    k_pages, v_pages = _slot_page_write(kn, vn, k_pages, v_pages, bt, p)
    out = paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                 bt, (p + 1).to(torch.int32), scale=scale,
                                 pages_per_block=pages_per_block)
    return out[:, None].to(q.dtype), k_pages, v_pages


def ragged_paged_step(q, k_new, v_new, k_pages, v_pages, tok_pos,
                      tok_slot, tok_valid, kv_lens, q_lens, block_tables,
                      scale=None, q_block=8, pages_per_block=None,
                      attention=ragged_paged_attention):
    """Attention for ONE continuously-batched step over packed tokens:
    q/k_new/v_new [T, H(q|kv), D] in slot order (each segment padded to
    a ``q_block`` multiple); tok_pos/tok_slot/tok_valid [T] per-token
    position, owning slot and validity; kv_lens/q_lens [B] (kv
    INCLUDING this step's tokens). Prefill chunks and single-token
    decodes share this one call. ``attention`` defaults to the kernel
    wrapper; a caller may pass the plain version for a reference run.
    Returns (out [T, Hq, D], k_pages, v_pages)."""
    bt = block_tables.to(torch.int32)
    kn = k_new.transpose(0, 1)                         # [Hk, T, D]
    vn = v_new.transpose(0, 1)
    k_pages, v_pages = _ragged_page_write(kn, vn, k_pages, v_pages, bt,
                                          tok_pos, tok_slot, tok_valid)
    out = attention(q.contiguous(), k_pages, v_pages, bt,
                    kv_lens.to(torch.int32), q_lens.to(torch.int32),
                    q_block=q_block, scale=scale,
                    pages_per_block=pages_per_block)
    return out.to(q.dtype), k_pages, v_pages


def guarded_argmax(lg, poison):
    """Greedy token pick with a per-row finite-ness flag — the device
    half of the serving decode guard. ``lg`` [B, V] logits, ``poison``
    [B] float32 (0.0 normally, NaN for a slot a drill poisons). Returns
    ``(nxt [B] int64, bad [B] bool)``; a bad row's token is 0. Adding
    0.0 is argmax-invariant, and ``torch.argmax`` returns the FIRST
    maximal index, as ``jnp.argmax`` does."""
    lg = lg.float() + poison.reshape(-1, 1)
    bad = ~torch.isfinite(lg).all(dim=-1)
    nxt = torch.where(bad, 0, lg.argmax(dim=-1))
    return nxt, bad


def fused_qkv_step(x, norm_params, weights, biases, positions,
                   block_tables, k_pages, v_pages, k_scales=None,
                   v_scales=None, norm="layer", eps=1e-5, n_heads=1,
                   n_kv_heads=1, head_dim=1, rope_theta=None, rows=None):
    """Megakernel INGRESS: pre-attention norm + QKV projection + paged-KV
    append as ONE fused launch (``ops/cuda/fused_decode_qkv.py``).
    ``x`` [B, H] residual stream, ``norm_params`` [w] or [w, b],
    ``weights`` one fused ``[3 nh hd, H]`` projection (``[out, in]``),
    ``biases`` a matching list or []. Returns ``(q [B, nh, hd], k_pages,
    v_pages)``, the pools written in place."""
    nw = norm_params[0]
    nb = norm_params[1] if len(norm_params) > 1 else None
    return fused_decode_qkv(
        x, nw, nb, list(weights), list(biases), positions.reshape(-1),
        block_tables, k_pages, v_pages, k_scales=k_scales,
        v_scales=v_scales, norm=norm, eps=eps, n_heads=n_heads,
        n_kv_heads=n_kv_heads, head_dim=head_dim, rope_theta=rope_theta,
        rows=rows)


def paged_attend(q, k_pages, v_pages, block_tables, positions, scale=None,
                 pages_per_block=None, k_scales=None, v_scales=None,
                 seq_lens=None):
    """Attention half of :func:`paged_slot_attention` alone (the
    megakernel path appends K/V inside :func:`fused_qkv_step`). ``q``
    [B, nh, hd]; the lengths are ``positions + 1`` as in
    ``paged_slot_attention``. ``seq_lens`` (int32 [B]) passes those
    lengths in when the caller made them once for every layer."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "paged_attend: int8 KV pools with scale side-pools arrive with "
            "the port's kv_quant slice")
    if seq_lens is None:
        seq_lens = (positions.reshape(-1) + 1).to(torch.int32)
    out = paged_decode_attention(q, k_pages, v_pages,
                                 block_tables.to(torch.int32), seq_lens,
                                 scale=scale,
                                 pages_per_block=pages_per_block)
    return out.to(q.dtype)


def fused_mlp_step(x, att, wo, norm_params, w1, w2, bo=None, b1=None,
                   b2=None, w_up=None, arch="gpt", norm="layer", eps=1e-5,
                   rows=None):
    """Megakernel EGRESS: out-projection + residual + post-norm + MLP +
    residual as ONE fused launch (``ops/cuda/fused_decode_mlp.py``).
    ``x`` [B, H] residual stream, ``att`` [B, nh*hd]; returns the next
    layer's residual stream [B, H]."""
    nw = norm_params[0]
    nb = norm_params[1] if len(norm_params) > 1 else None
    return fused_decode_mlp(x, att, wo, bo, nw, nb, w1, b1, w2, b2, w_up,
                            arch=arch, norm=norm, eps=eps, rows=rows)


def fused_decode_logits(x, norm_params, w_lm, poison, b_lm=None,
                        norm="layer", eps=1e-5, transpose_lm=False,
                        rows=None):
    """Megakernel SAMPLING EPILOGUE: final norm + LM head + the
    :func:`guarded_argmax` pick as ONE fused launch. Returns ``(logits
    [B, V] pre-poison, nxt [B], bad [B] bool)``; nxt and bad are exactly
    ``guarded_argmax(logits, poison)``'s."""
    nw = norm_params[0]
    nb = norm_params[1] if len(norm_params) > 1 else None
    return fused_decode_epilogue(x, nw, nb, w_lm, b_lm, poison.reshape(-1),
                                 norm=norm, eps=eps,
                                 transpose_lm=transpose_lm, rows=rows)


def _lm_logits(model, h):
    """Final norm output -> logits; tied head is ``h @ wte.T``."""
    if model.lm_head is not None:
        return model.lm_head(h)
    return h @ model.gpt.wte.weight.t()


def _gpt_decode(model, ids_t, pos, caches, attend):
    """One-token logits for GPTForCausalLM: ``ids_t`` [B, 1], ``pos``
    [B] per-slot positions (or [1], one shared position), flat
    ``[k0, v0, k1, v1, ...]`` page pools; ``attend(q, k, v, kc, vc,
    pos) -> (att, kc, vc)`` is the layer's cache write + attention.
    Returns (logits [B, V], new caches)."""
    gpt = model.gpt
    data = _split_caches(caches, len(gpt.blocks))
    x = gpt.wte(ids_t) + gpt.wpe(pos.reshape(-1, 1))
    new = []
    for li, blk in enumerate(gpt.blocks):
        h = blk.ln1(x)
        b, _, hidden = h.shape
        qkv = blk.attn.qkv(h).reshape(b, 1, 3, blk.attn.num_heads,
                                      blk.attn.head_dim)
        q, k, v = qkv.unbind(2)
        att, kc, vc = attend(q, k, v, data[2 * li], data[2 * li + 1], pos)
        x = x + blk.attn.proj(att.reshape(b, 1, hidden))
        x = x + blk.mlp(blk.ln2(x))
        new.extend((kc, vc))
    logits = _lm_logits(model, gpt.ln_f(x))
    return logits.reshape(logits.shape[0], -1), new


def _gpt_decode_fused(model, ids_t, pos, bt, caches, poison,
                      pages_per_block=None):
    """Megakernel decode step for GPTForCausalLM: one-token forward in
    three launches per layer (:func:`fused_qkv_step` ->
    :func:`paged_attend` -> :func:`fused_mlp_step`) plus the
    :func:`fused_decode_logits` epilogue, against the serving engine's
    per-slot page pools (written in place). ``bt`` [B, NP] and ``pos``
    [B] are data; ``poison`` is the decode guard's [B] lane. The
    attention lengths are made once for all layers. Returns ``(logits
    [B, V], nxt [B], bad [B] bool, caches)``."""
    gpt = model.gpt
    data = _split_caches(caches, len(gpt.blocks))
    p = pos.reshape(-1)
    x = gpt.wte(ids_t) + gpt.wpe(p.reshape(-1, 1))
    b = x.shape[0]
    x = x.reshape(b, x.shape[-1])
    bt = bt.to(torch.int32)
    lens = (p + 1).to(torch.int32)
    new = []
    for li, blk in enumerate(gpt.blocks):
        a = blk.attn
        q, kc, vc = fused_qkv_step(
            x, [blk.ln1.weight, blk.ln1.bias], [a.qkv.weight],
            [a.qkv.bias], p, bt, data[2 * li], data[2 * li + 1],
            norm="layer", eps=blk.ln1.eps, n_heads=a.num_heads,
            n_kv_heads=a.num_heads, head_dim=a.head_dim)
        new.extend((kc, vc))
        att = paged_attend(q, kc, vc, bt, p,
                           pages_per_block=pages_per_block, seq_lens=lens)
        x = fused_mlp_step(x, att.reshape(b, -1), a.proj.weight,
                           [blk.ln2.weight, blk.ln2.bias],
                           blk.mlp.fc1.weight, blk.mlp.fc2.weight,
                           bo=a.proj.bias, b1=blk.mlp.fc1.bias,
                           b2=blk.mlp.fc2.bias, arch="gpt", norm="layer",
                           eps=blk.ln2.eps)
    if model.lm_head is not None:
        w_lm, tr = model.lm_head.weight, False
    else:
        w_lm, tr = gpt.wte.weight, True
    logits, nxt, bad = fused_decode_logits(
        x, [gpt.ln_f.weight, gpt.ln_f.bias], w_lm, poison, norm="layer",
        eps=gpt.ln_f.eps, transpose_lm=tr)
    return logits, nxt, bad, new


def _gpt_ragged_forward(model, ids_t, tok_pos, tok_slot, tok_valid,
                        kv_lens, q_lens, bt, caches, q_block,
                        pages_per_block=None,
                        attention=ragged_paged_attention):
    """Packed-token forward for a continuously-batched serving step:
    ``ids_t`` [1, T] carries prefill chunks AND single decode tokens of
    all slots (segments in slot order, ``q_block``-padded). Returns
    ([T, V] logits — padding rows unspecified — and the page pools)."""
    gpt = model.gpt
    data = _split_caches(caches, len(gpt.blocks))
    t = ids_t.shape[1]
    x = gpt.wte(ids_t) + gpt.wpe(tok_pos.reshape(1, -1))
    new = []
    for li, blk in enumerate(gpt.blocks):
        h = blk.ln1(x)
        hd, nh = blk.attn.head_dim, blk.attn.num_heads
        qkv = blk.attn.qkv(h).reshape(t, 3, nh, hd)
        q, k, v = qkv.unbind(1)                        # [T, nh, hd]
        att, kc, vc = ragged_paged_step(
            q, k, v, data[2 * li], data[2 * li + 1], tok_pos, tok_slot,
            tok_valid, kv_lens, q_lens, bt, q_block=q_block,
            pages_per_block=pages_per_block, attention=attention)
        x = x + blk.attn.proj(att.reshape(1, t, nh * hd))
        x = x + blk.mlp(blk.ln2(x))
        new.extend((kc, vc))
    logits = _lm_logits(model, gpt.ln_f(x))
    return logits.reshape(t, -1), new


def _is_gpt(model):
    from .gpt import GPTForCausalLM
    return isinstance(model, GPTForCausalLM)


def _unsupported(model):
    return TypeError(
        f"serving engine: unsupported model {type(model).__name__}; the "
        "port serves GPTForCausalLM, and LLaMA serving arrives with the "
        "port's LLaMA slice")


def _decode_fn(model):
    """(decode_fn, prefill_fn, hard_position_limit): GPT's learned wpe
    table makes max_seq_len a hard bound. The prefill of ``generate()``
    comes with a later slice, so ``prefill_fn`` is None."""
    if _is_gpt(model):
        return _gpt_decode, None, True
    raise _unsupported(model)


def _decode_fused_fn(model):
    """Megakernel analog of :func:`_decode_fn`: the fused decode step of
    the serving engine's ``megakernel`` path."""
    if _is_gpt(model):
        return _gpt_decode_fused
    raise TypeError(
        f"megakernel: unsupported model {type(model).__name__}; the port's "
        "fused decode serves GPTForCausalLM, and the LLaMA branches arrive "
        "with the port's LLaMA slice")


def _ragged_fn(model):
    """Family dispatch for the packed continuous-batching forward."""
    if _is_gpt(model):
        return _gpt_ragged_forward
    raise _unsupported(model)
