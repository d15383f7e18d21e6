"""The serving subset of ``paddle_tpu/models/generation.py``: paged-KV
page writes (fp32 pools, or int8 pools quantized on write into f32 scale
side-pools), the two attention steps the continuous-batching engine
runs (per-slot decode and the ragged mixed prefill+decode step), the
guarded greedy pick, the GPT and LLaMA forwards over them (LLaMA's rope
at device positions through :func:`rope_at`), and the GPT and LLaMA
megakernel decode steps (``fused_qkv_step`` -> ``paged_attend`` ->
``fused_mlp_step`` per layer, then ``fused_decode_logits``), over fp32
or int8 pools. Under tensor parallelism (the section "Tensor
parallelism" below) the same forwards serve a rank-local model, which
holds the rank's slices of the weights and sums its partial products
with ``distributed.all_reduce``.

Page pools are updated IN PLACE (the JAX package threads them
functionally and donates the buffers; here an ``index_put_`` writes
the new tokens' K/V straight into the pool), and every function
returns the pools it was given so call sites read like the JAX ones.
Padding tokens route their writes to the reserved null page 0, so
several writes may target the same (page 0, slot 0): the value left
there is unspecified on CUDA, which is harmless only because page 0 is
never read.

The cache list is ``[k0, v0, ..., kL-1, vL-1]`` for fp32 pools; int8
serving appends the scale pools ``[ks0, vs0, ...]`` (``_split_caches``).
A weight-only-quantized model (``quantization.weight_only_quantize``)
serves unchanged: every projection is called as a module.

``generate()`` and its contiguous KV cache arrive with a later slice.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed.collective import all_reduce
from ..nn.functional.common import linear
from ..ops.cuda.fused_decode_mlp import (fused_decode_epilogue,
                                         fused_decode_mlp,
                                         fused_decode_mlp_partial)
from ..ops.cuda.fused_decode_qkv import fused_decode_qkv
from ..ops.cuda.paged_attention import (paged_decode_attention,
                                        ragged_paged_attention)
from ..quantization import kv_quantize


def _split_caches(caches, n_layers):
    """Serving cache-list layout: ``[k0, v0, ..., kL-1, vL-1]`` for fp
    pools, with the int8 path APPENDING the scale side-pools ``[ks0,
    vs0, ..., ksL-1, vsL-1]`` (the engine builds the list; its length
    says which). Returns ``(data, scales)``, ``scales == []`` on the fp
    path."""
    n = 2 * n_layers
    if len(caches) == 2 * n:
        return caches[:n], caches[n:]
    if len(caches) != n:
        raise ValueError(
            f"expected {n} (fp) or {2 * n} (int8 + scales) cache pools "
            f"for {n_layers} layers, got {len(caches)}")
    return caches, []


def _write(kn, vn, k_pages, v_pages, page, slot, k_scales, v_scales):
    """Write ``kn``/``vn`` ``[Hk, N, D]`` at (page, slot) in place; with
    scale pools, quantize on write (``kv_quantize``: each token's bytes
    are a function of its own vector, so a page holds the same bytes
    whichever path filled it; K and V go through it together, one set
    of launches for both)."""
    if k_scales is not None:
        q, sc = kv_quantize(torch.stack((kn, vn)))
        kn, vn = q[0], q[1]
        k_scales[:, page, slot] = sc[0]
        v_scales[:, page, slot] = sc[1]
    k_pages[:, page, slot] = kn.to(k_pages.dtype)
    v_pages[:, page, slot] = vn.to(v_pages.dtype)
    return k_pages, v_pages, k_scales, v_scales


def _slot_page_write(kn, vn, k_pages, v_pages, bt, positions,
                     k_scales=None, v_scales=None):
    """Write one token per slot into its (page, slot) in place: ``kn``/
    ``vn`` are head-major ``[Hk, B, D]``, ``positions`` [B] each slot's
    current token index; scales switch on the int8 quantize-on-write
    path. Returns ``(k_pages, v_pages, k_scales, v_scales)``."""
    p = positions.reshape(-1).long()
    ps = k_pages.shape[2]
    rows = torch.arange(p.shape[0], device=p.device)
    page = bt[rows, torch.clamp(p // ps, max=bt.shape[1] - 1)].long()
    slot = p % ps
    return _write(kn, vn, k_pages, v_pages, page, slot, k_scales, v_scales)


def _ragged_page_write(kn, vn, k_pages, v_pages, bt, tok_pos, tok_slot,
                       tok_valid, k_scales=None, v_scales=None):
    """Packed-token analog of :func:`_slot_page_write`: ``kn``/``vn``
    are ``[Hk, T, D]``; invalid tokens route to the null page 0."""
    ps = k_pages.shape[2]
    pos = tok_pos.long()
    ok = tok_valid.bool()
    page = torch.where(
        ok, bt[tok_slot.long(), torch.clamp(pos // ps, max=bt.shape[1] - 1)]
        .long(), 0)
    wslot = torch.where(ok, pos % ps, 0)
    return _write(kn, vn, k_pages, v_pages, page, wslot, k_scales,
                  v_scales)


def _both_or_neither(who, k_scales, v_scales):
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{who}: pass both k_scales and v_scales or "
                         "neither")
    return k_scales is not None


def paged_slot_attention(q, k_new, v_new, k_pages, v_pages, positions,
                         block_tables, scale=None, pages_per_block=None,
                         k_scales=None, v_scales=None):
    """One decode step against a paged KV cache with PER-SLOT state:
    q/k_new/v_new [B, 1, H(q|kv), D]; ``positions`` [B] and
    ``block_tables`` [B, NP] are data (admission and retirement change
    their values, never shapes). Writes each slot's K/V at its own
    (page, slot) and attends with per-slot lengths ``positions + 1``.
    ``k_scales``/``v_scales`` [Hk, P, page_size] switch on the int8 KV
    path (quantize on write, dequantize in the kernel's load loop).
    Returns (out [B, 1, Hq, D], k_pages, v_pages[, k_scales,
    v_scales])."""
    quant = _both_or_neither("paged_slot_attention", k_scales, v_scales)
    p = positions.reshape(-1)
    bt = block_tables.to(torch.int32)
    kn = k_new[:, 0].transpose(0, 1)                   # [Hk, B, D]
    vn = v_new[:, 0].transpose(0, 1)
    k_pages, v_pages, k_scales, v_scales = _slot_page_write(
        kn, vn, k_pages, v_pages, bt, p, k_scales, v_scales)
    out = paged_decode_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                 bt, (p + 1).to(torch.int32), scale=scale,
                                 pages_per_block=pages_per_block,
                                 k_scales=k_scales, v_scales=v_scales)
    out = out[:, None].to(q.dtype)
    if quant:
        return out, k_pages, v_pages, k_scales, v_scales
    return out, k_pages, v_pages


def ragged_paged_step(q, k_new, v_new, k_pages, v_pages, tok_pos,
                      tok_slot, tok_valid, kv_lens, q_lens, block_tables,
                      scale=None, q_block=8, pages_per_block=None,
                      k_scales=None, v_scales=None,
                      attention=ragged_paged_attention):
    """Attention for ONE continuously-batched step over packed tokens:
    q/k_new/v_new [T, H(q|kv), D] in slot order (each segment padded to
    a ``q_block`` multiple); tok_pos/tok_slot/tok_valid [T] per-token
    position, owning slot and validity; kv_lens/q_lens [B] (kv
    INCLUDING this step's tokens). Prefill chunks and single-token
    decodes share this one call. ``k_scales``/``v_scales`` switch on the
    int8 KV path as in :func:`paged_slot_attention`. ``attention``
    defaults to the kernel wrapper; a caller may pass the plain version
    for a reference run. Returns (out [T, Hq, D], k_pages, v_pages[,
    k_scales, v_scales])."""
    quant = _both_or_neither("ragged_paged_step", k_scales, v_scales)
    bt = block_tables.to(torch.int32)
    kn = k_new.transpose(0, 1)                         # [Hk, T, D]
    vn = v_new.transpose(0, 1)
    k_pages, v_pages, k_scales, v_scales = _ragged_page_write(
        kn, vn, k_pages, v_pages, bt, tok_pos, tok_slot, tok_valid,
        k_scales, v_scales)
    kw = {"k_scales": k_scales, "v_scales": v_scales} if quant else {}
    out = attention(q.contiguous(), k_pages, v_pages, bt,
                    kv_lens.to(torch.int32), q_lens.to(torch.int32),
                    q_block=q_block, scale=scale,
                    pages_per_block=pages_per_block, **kw)
    out = out.to(q.dtype)
    if quant:
        return out, k_pages, v_pages, k_scales, v_scales
    return out, k_pages, v_pages


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
                   n_kv_heads=1, head_dim=1, rope_theta=None, rope=None,
                   rows=None):
    """Megakernel INGRESS: pre-attention norm + QKV projection (+ rope) +
    paged-KV append (+ int8 quantize-on-write) as ONE fused launch
    (``ops/cuda/fused_decode_qkv.py``). ``x`` [B, H] residual stream,
    ``norm_params`` [w] or [w, b], ``weights`` one fused ``[3 nh hd, H]``
    projection (GPT) or ``[wq, wk, wv]`` (LLaMA; ``[out, in]``),
    ``biases`` a matching list or []; ``rope_theta`` rotates q and k
    (or instead ``rope``: their cos/sin tables, made once for all
    layers). Returns
    ``(q [B, nh, hd], k_pages, v_pages[, k_scales, v_scales])``, the
    pools written in place."""
    nw = norm_params[0]
    nb = norm_params[1] if len(norm_params) > 1 else None
    return fused_decode_qkv(
        x, nw, nb, list(weights), list(biases), positions.reshape(-1),
        block_tables, k_pages, v_pages, k_scales=k_scales,
        v_scales=v_scales, norm=norm, eps=eps, n_heads=n_heads,
        n_kv_heads=n_kv_heads, head_dim=head_dim, rope_theta=rope_theta,
        rope=rope, rows=rows)


def paged_attend(q, k_pages, v_pages, block_tables, positions, scale=None,
                 pages_per_block=None, k_scales=None, v_scales=None,
                 seq_lens=None):
    """Attention half of :func:`paged_slot_attention` alone (the
    megakernel path appends K/V inside :func:`fused_qkv_step`). ``q``
    [B, nh, hd]; the lengths are ``positions + 1`` as in
    ``paged_slot_attention``. ``seq_lens`` (int32 [B]) passes those
    lengths in when the caller made them once for every layer.
    ``k_scales``/``v_scales`` read int8 pools (the int8 attention)."""
    _both_or_neither("paged_attend", k_scales, v_scales)
    if seq_lens is None:
        seq_lens = (positions.reshape(-1) + 1).to(torch.int32)
    out = paged_decode_attention(q, k_pages, v_pages,
                                 block_tables.to(torch.int32), seq_lens,
                                 scale=scale,
                                 pages_per_block=pages_per_block,
                                 k_scales=k_scales, v_scales=v_scales)
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


def _lm_logits(model, h, embed):
    """Final norm output -> logits; a tied head is ``h @ embed.T``."""
    if model.lm_head is not None:
        return model.lm_head(h)
    return h @ embed.weight.t()


def _attend_layer(attend, q, k, v, data, scales, li, pos):
    """One layer's cache update + attention, fp or int8: returns
    ``(att, new data pair, new scale pair)``. The int8 call passes the
    layer's scale pools and gets them back."""
    kc, vc = data[2 * li], data[2 * li + 1]
    if scales:
        att, kc, vc, ks, vs = attend(q, k, v, kc, vc, pos, scales[2 * li],
                                     scales[2 * li + 1])
        return att, [kc, vc], [ks, vs]
    att, kc, vc = attend(q, k, v, kc, vc, pos)
    return att, [kc, vc], []


def _ragged_attend_layer(q, k, v, data, scales, li, tok_pos, tok_slot,
                         tok_valid, kv_lens, q_lens, bt, q_block,
                         pages_per_block, attention):
    """The :func:`_attend_layer` analog of the mixed step: one layer's
    packed-token page write + ragged attention, fp or int8."""
    kc, vc = data[2 * li], data[2 * li + 1]
    kw = dict(q_block=q_block, pages_per_block=pages_per_block,
              attention=attention)
    if scales:
        att, kc, vc, ks, vs = ragged_paged_step(
            q, k, v, kc, vc, tok_pos, tok_slot, tok_valid, kv_lens, q_lens,
            bt, k_scales=scales[2 * li], v_scales=scales[2 * li + 1], **kw)
        return att, [kc, vc], [ks, vs]
    att, kc, vc = ragged_paged_step(q, k, v, kc, vc, tok_pos, tok_slot,
                                    tok_valid, kv_lens, q_lens, bt, **kw)
    return att, [kc, vc], []


def _gpt_decode(model, ids_t, pos, caches, attend):
    """One-token logits for GPTForCausalLM: ``ids_t`` [B, 1], ``pos``
    [B] per-slot positions (or [1], one shared position), flat
    ``[k0, v0, k1, v1, ...]`` page pools (int8 serving appends the scale
    pools); ``attend(q, k, v, kc, vc, pos[, ks, vs]) -> (att, kc, vc[,
    ks, vs])`` is the layer's cache write + attention. Returns (logits
    [B, V], new caches)."""
    gpt = model.gpt
    data, scales = _split_caches(caches, len(gpt.blocks))
    x = gpt.wte(ids_t) + gpt.wpe(pos.reshape(-1, 1))
    new, new_sc = [], []
    for li, blk in enumerate(gpt.blocks):
        h = blk.ln1(x)
        b = h.shape[0]
        qkv = blk.attn.qkv(h).reshape(b, 1, 3, blk.attn.num_heads,
                                      blk.attn.head_dim)
        q, k, v = qkv.unbind(2)
        att, pair, sc_pair = _attend_layer(attend, q, k, v, data, scales,
                                           li, pos)
        x = x + blk.attn.proj(att.reshape(b, 1, -1))
        x = x + blk.mlp(blk.ln2(x))
        new.extend(pair)
        new_sc.extend(sc_pair)
    logits = _lm_logits(model, gpt.ln_f(x), gpt.wte)
    return logits.reshape(logits.shape[0], -1), new + new_sc


def _rope_tables(pos, d, theta):
    """cos/sin ``[n, d]`` at device positions ``pos`` [n] in float32, as
    the JAX package's ``rope_angles`` computes traced positions (its
    serving programs are jitted, so their positions are traced): the
    same half-rotation convention as ``llama.rope_angles``, whose
    float64 tables serve concrete positions in training. The inverse
    frequencies are ``theta ** -e``, not ``1 / theta ** e``: XLA rewrites
    the latter to the former in a jitted program, and the two differ in
    the last bit of a third of the frequencies, which the position
    multiplies."""
    inv = theta ** -(torch.arange(0, d // 2, device=pos.device) * 2.0 / d)
    ang = pos.to(torch.float32)[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x, cos, sin):
    """Rotate-half application: ``x * cos + [-x2, x1] * sin``."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _rope_for(pos, shape, theta):
    """cos/sin at ``pos`` shaped to broadcast against ``x`` of ``shape``
    ``[B, S, H, D]`` (see :func:`rope_at` for the three position
    shapes)."""
    p = pos.reshape(-1)
    n = p.shape[0]
    cos, sin = _rope_tables(p, shape[-1], theta)        # [n, D]
    if n == 1:
        return cos.reshape(-1), sin.reshape(-1)         # broadcast all
    if n == shape[0]:
        return cos[:, None, None, :], sin[:, None, None, :]
    if n == shape[1]:
        return cos[None, :, None, :], sin[None, :, None, :]
    raise ValueError(f"rope_at: {n} positions do not match x "
                     f"{tuple(shape)}")


def rope_at(x, pos, theta=10000.0):
    """Half-rotation rope at explicit positions (serving), plain
    PyTorch as the JAX package's is jnp. Three position shapes:

    * pos [1]: one position for the whole batch;
    * pos [B] matching x [B, 1, H, D]: per-slot positions (the
      continuous-batching decode step);
    * pos [T] matching x [1, T, H, D]: per-token positions (the packed
      ragged prefill + decode step).
    """
    return _apply_rope(x, *_rope_for(pos, x.shape, theta))


def _llama_qkv(a, h, lead, rope):
    """LLaMA q/k/v of ``h`` as ``[*lead, heads, head_dim]``, q and k
    roped by ``rope`` (the forward's :func:`_rope_for` tables, made once
    for all layers: they share the positions, head_dim and theta)."""
    q = a.q_proj(h).reshape(*lead, a.num_heads, a.head_dim)
    k = a.k_proj(h).reshape(*lead, a.num_kv_heads, a.head_dim)
    v = a.v_proj(h).reshape(*lead, a.num_kv_heads, a.head_dim)
    return _apply_rope(q, *rope), _apply_rope(k, *rope), v


def _llama_rope(lm, lead, pos):
    a = lm.layers[0].attn
    return _rope_for(pos, (*lead, a.num_heads, a.head_dim), a.rope_theta)


def _llama_decode(model, ids_t, pos, caches, attend):
    """One-token logits for LlamaForCausalLM; the arguments and the
    result are :func:`_gpt_decode`'s."""
    lm = model.llama
    data, scales = _split_caches(caches, len(lm.layers))
    x = lm.embed_tokens(ids_t)
    b = x.shape[0]
    rope = _llama_rope(lm, (b, 1), pos)
    new, new_sc = [], []
    for li, layer in enumerate(lm.layers):
        a = layer.attn
        q, k, v = _llama_qkv(a, layer.input_norm(x), (b, 1), rope)
        att, pair, sc_pair = _attend_layer(attend, q, k, v, data, scales,
                                           li, pos)
        x = x + a.o_proj(att.reshape(b, 1, -1))
        x = x + layer.mlp(layer.post_norm(x))
        new.extend(pair)
        new_sc.extend(sc_pair)
    logits = _lm_logits(model, lm.norm(x), lm.embed_tokens)
    return logits.reshape(logits.shape[0], -1), new + new_sc


def _fused_layer_cache(data, scales, li):
    """One layer's ``(k, v, k_scales, v_scales)`` pools; the scales are
    None for fp32 pools."""
    if scales:
        return (data[2 * li], data[2 * li + 1], scales[2 * li],
                scales[2 * li + 1])
    return data[2 * li], data[2 * li + 1], None, None


def _fused_attend(outs, bt, p, lens, pages_per_block, new, new_sc):
    """The attention launch after a fused ingress: attends ``outs``'s q
    (``fused_qkv_step``'s return) over the pools it wrote, and records
    them in ``new`` (and their scale pools in ``new_sc``)."""
    q, kc, vc = outs[:3]
    ks, vs = outs[3:] if len(outs) == 5 else (None, None)
    new.extend((kc, vc))
    if ks is not None:
        new_sc.extend((ks, vs))
    return paged_attend(q, kc, vc, bt, p, pages_per_block=pages_per_block,
                        k_scales=ks, v_scales=vs, seq_lens=lens)


def _gpt_decode_fused(model, ids_t, pos, bt, caches, poison,
                      pages_per_block=None):
    """Megakernel decode step for GPTForCausalLM: one-token forward in
    three launches per layer (:func:`fused_qkv_step` ->
    :func:`paged_attend` -> :func:`fused_mlp_step`) plus the
    :func:`fused_decode_logits` epilogue, against the serving engine's
    per-slot page pools (written in place; int8 pools with their scale
    pools appended to the cache list, quantized on write by the
    ingress). ``bt`` [B, NP] and ``pos`` [B] are data; ``poison`` is the
    decode guard's [B] lane. The attention lengths are made once for all
    layers. Returns ``(logits [B, V], nxt [B], bad [B] bool, caches)``."""
    gpt = model.gpt
    data, scales = _split_caches(caches, len(gpt.blocks))
    p = pos.reshape(-1)
    x = gpt.wte(ids_t) + gpt.wpe(p.reshape(-1, 1))
    b = x.shape[0]
    x = x.reshape(b, x.shape[-1])
    bt = bt.to(torch.int32)
    lens = (p + 1).to(torch.int32)
    new, new_sc = [], []
    for li, blk in enumerate(gpt.blocks):
        a = blk.attn
        kc, vc, ks, vs = _fused_layer_cache(data, scales, li)
        outs = fused_qkv_step(
            x, [blk.ln1.weight, blk.ln1.bias], [a.qkv.weight],
            [a.qkv.bias], p, bt, kc, vc, k_scales=ks, v_scales=vs,
            norm="layer", eps=blk.ln1.eps, n_heads=a.num_heads,
            n_kv_heads=a.num_heads, head_dim=a.head_dim)
        att = _fused_attend(outs, bt, p, lens, pages_per_block,
                            new, new_sc)
        x = _egress(x, att.reshape(b, -1), a.proj,
                    [blk.ln2.weight, blk.ln2.bias], blk.mlp.fc1,
                    blk.mlp.fc2, arch="gpt", norm="layer", eps=blk.ln2.eps)
    if model.lm_head is not None:
        w_lm, tr = model.lm_head.weight, False
    else:
        w_lm, tr = gpt.wte.weight, True
    logits, nxt, bad = fused_decode_logits(
        x, [gpt.ln_f.weight, gpt.ln_f.bias], w_lm, poison, norm="layer",
        eps=gpt.ln_f.eps, transpose_lm=tr)
    return logits, nxt, bad, new + new_sc


def _llama_decode_fused(model, ids_t, pos, bt, caches, poison,
                        pages_per_block=None):
    """Megakernel decode step for LlamaForCausalLM, the JAX package's
    ``_llama_decode_fused``: RMSNorm, the three projections, GQA and
    rope fold into the ingress (the rope tables made once for all
    layers, as :func:`_llama_decode` makes them), SwiGLU into the
    egress, the final RMSNorm and the head into the epilogue; see
    :func:`_gpt_decode_fused`."""
    lm = model.llama
    data, scales = _split_caches(caches, len(lm.layers))
    p = pos.reshape(-1)
    x = lm.embed_tokens(ids_t)
    b = x.shape[0]
    x = x.reshape(b, x.shape[-1])
    bt = bt.to(torch.int32)
    lens = (p + 1).to(torch.int32)
    a0 = lm.layers[0].attn
    rope = _rope_tables(p, a0.head_dim, a0.rope_theta)
    new, new_sc = [], []
    for li, layer in enumerate(lm.layers):
        a, mlp = layer.attn, layer.mlp
        kc, vc, ks, vs = _fused_layer_cache(data, scales, li)
        outs = fused_qkv_step(
            x, [layer.input_norm.weight],
            [a.q_proj.weight, a.k_proj.weight, a.v_proj.weight], [], p, bt,
            kc, vc, k_scales=ks, v_scales=vs, norm="rms",
            eps=layer.input_norm._epsilon, n_heads=a.num_heads,
            n_kv_heads=a.num_kv_heads, head_dim=a.head_dim, rope=rope)
        att = _fused_attend(outs, bt, p, lens, pages_per_block,
                            new, new_sc)
        x = _egress(x, att.reshape(b, -1), a.o_proj,
                    [layer.post_norm.weight], mlp.gate_proj, mlp.down_proj,
                    up=mlp.up_proj, arch="llama", norm="rms",
                    eps=layer.post_norm._epsilon)
    if model.lm_head is not None:
        w_lm, tr = model.lm_head.weight, False
    else:
        w_lm, tr = lm.embed_tokens.weight, True
    logits, nxt, bad = fused_decode_logits(
        x, [lm.norm.weight], w_lm, poison, norm="rms",
        eps=lm.norm._epsilon, transpose_lm=tr)
    return logits, nxt, bad, new + new_sc


def _gpt_ragged_forward(model, ids_t, tok_pos, tok_slot, tok_valid,
                        kv_lens, q_lens, bt, caches, q_block,
                        pages_per_block=None,
                        attention=ragged_paged_attention):
    """Packed-token forward for a continuously-batched serving step:
    ``ids_t`` [1, T] carries prefill chunks AND single decode tokens of
    all slots (segments in slot order, ``q_block``-padded). Returns
    ([T, V] logits — padding rows unspecified — and the page pools)."""
    gpt = model.gpt
    data, scales = _split_caches(caches, len(gpt.blocks))
    t = ids_t.shape[1]
    x = gpt.wte(ids_t) + gpt.wpe(tok_pos.reshape(1, -1))
    new, new_sc = [], []
    for li, blk in enumerate(gpt.blocks):
        h = blk.ln1(x)
        hd, nh = blk.attn.head_dim, blk.attn.num_heads
        qkv = blk.attn.qkv(h).reshape(t, 3, nh, hd)
        q, k, v = qkv.unbind(1)                        # [T, nh, hd]
        att, pair, sc_pair = _ragged_attend_layer(
            q, k, v, data, scales, li, tok_pos, tok_slot, tok_valid,
            kv_lens, q_lens, bt, q_block, pages_per_block, attention)
        x = x + blk.attn.proj(att.reshape(1, t, nh * hd))
        x = x + blk.mlp(blk.ln2(x))
        new.extend(pair)
        new_sc.extend(sc_pair)
    logits = _lm_logits(model, gpt.ln_f(x), gpt.wte)
    return logits.reshape(t, -1), new + new_sc


def _llama_ragged_forward(model, ids_t, tok_pos, tok_slot, tok_valid,
                          kv_lens, q_lens, bt, caches, q_block,
                          pages_per_block=None,
                          attention=ragged_paged_attention):
    """The LLaMA analog of :func:`_gpt_ragged_forward`: rope at each
    packed token's own position."""
    lm = model.llama
    data, scales = _split_caches(caches, len(lm.layers))
    t = ids_t.shape[1]
    x = lm.embed_tokens(ids_t)
    rope = _llama_rope(lm, (1, t), tok_pos)
    new, new_sc = [], []
    for li, layer in enumerate(lm.layers):
        a = layer.attn
        q, k, v = _llama_qkv(a, layer.input_norm(x), (1, t), rope)
        att, pair, sc_pair = _ragged_attend_layer(
            q[0], k[0], v[0], data, scales, li, tok_pos, tok_slot,
            tok_valid, kv_lens, q_lens, bt, q_block, pages_per_block,
            attention)
        x = x + a.o_proj(att.reshape(1, t, -1))
        x = x + layer.mlp(layer.post_norm(x))
        new.extend(pair)
        new_sc.extend(sc_pair)
    logits = _lm_logits(model, lm.norm(x), lm.embed_tokens)
    return logits.reshape(t, -1), new + new_sc


def _family(model):
    """``"gpt"`` or ``"llama"``; any other model raises ``TypeError``."""
    from .gpt import GPTForCausalLM
    from .llama import LlamaForCausalLM
    if isinstance(model, GPTForCausalLM):
        return "gpt"
    if isinstance(model, LlamaForCausalLM):
        return "llama"
    raise TypeError(
        f"serving engine: unsupported model {type(model).__name__}; the "
        "port serves GPT (GPTForCausalLM) and LLaMA (LlamaForCausalLM)")


def _decode_fn(model):
    """(decode_fn, prefill_fn, hard_position_limit): GPT's learned wpe
    table makes max_seq_len a hard bound; LLaMA's rope extrapolates. The
    prefill of ``generate()`` comes with a later slice, so
    ``prefill_fn`` is None."""
    if _family(model) == "gpt":
        return _gpt_decode, None, True
    return _llama_decode, None, False


def _decode_fused_fn(model):
    """Megakernel analog of :func:`_decode_fn`: the fused decode step of
    the serving engine's ``megakernel`` path, GPT or LLaMA over dense
    projections. As in the JAX package, the fused kernels read each
    projection's float weight, so a weight-only-quantized model
    (``WeightOnlyLinear``) is served with the megakernel off."""
    from ..quantization import WeightOnlyLinear
    fn = {"gpt": _gpt_decode_fused,
          "llama": _llama_decode_fused}[_family(model)]
    if any(isinstance(m, WeightOnlyLinear) for m in model.modules()):
        raise NotImplementedError(
            "megakernel: the fused decode kernels serve dense projections "
            "only, as in the JAX package; serve a weight_only_quantize'd "
            "model with megakernel off")
    return fn


def _ragged_fn(model):
    """Family dispatch for the packed continuous-batching forward."""
    if _family(model) == "gpt":
        return _gpt_ragged_forward
    return _llama_ragged_forward


def _kv_heads(model):
    """The kv heads a model's layers attend with: its page pools' head
    dim (a rank-local TP model's share of them)."""
    if _family(model) == "gpt":
        return model.gpt.blocks[0].attn.num_heads
    return model.llama.layers[0].attn.num_kv_heads


# --------------------------------------------------- tensor parallelism --
# The JAX package's manual TP (paddle_tpu/models/generation.py, from
# ``TPParams`` :1263 to ``make_tp_window`` :2025): Megatron's cut, with
# one all-reduce after the attention's output projection and one after
# the MLP's down projection in every layer. Here a rank is a process that
# holds a rank-local model (``tp_shard_params``): the model's own class
# with its layers' head counts cut to this rank's share, the q/k/v (GPT's
# fused qkv) and fc1/gate/up projections column-cut, and the out and
# fc2/down projections row-cut as :class:`RowParallelLinear`, whose
# forward sums the partial product over the group and then adds the
# bias. So the single-device forwards above serve a rank unchanged, with
# its kv heads' page pools; the bias and the residual follow each
# all-reduce in the JAX operand order, every rank holds the same
# residual stream and picks the same tokens from the same logits, and
# greedy streams are the single-device engine's (the split sums differ
# from one device's only in the last bits of the logits). The megakernel
# step differs only in its egress (:func:`_egress`).
#
# Ported: the head-sharded regime (``num_kv_heads % tp == 0``: the kv
# heads and pools are cut with the q heads). The replicated-KV regime
# (GQA with fewer kv heads than ranks), speculative decoding under TP
# (``make_tp_spec``) and weight-only projections raise, naming their
# later slice.

class RowParallelLinear(nn.Module):
    """A row-cut projection: ``weight`` ``[out, in_local]`` holds this
    rank's input columns, ``bias`` (whole, replicated) or None.
    ``forward(x)`` is ``reduce(x @ weight.T)``; ``reduce(t)`` sums a
    partial product over ``group`` in place, then adds the bias."""

    def __init__(self, weight, bias, group):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = (None if bias is None
                     else nn.Parameter(bias, requires_grad=False))
        self.group = group

    def reduce(self, t):
        t = all_reduce(t, self.group)
        return t if self.bias is None else t + self.bias

    def forward(self, x):
        return self.reduce(linear(x, self.weight))


def _egress(x, att, o, norm_params, w1, w2, up=None, **kw):
    """The megakernel step's layer egress from the attention output
    ``att`` [B, nh*hd]: one :func:`fused_mlp_step` launch on one device.
    Under TP (``o`` row-parallel): the out projection, its all-reduce,
    bias and residual give ``y1``; the shard-local MLP
    (:func:`fused_decode_mlp_partial`, no fc2 bias, no residual), its
    all-reduce, the fc2 bias and the residual give the next layer's
    stream (the JAX ``_gpt_tp_decode_body_fused`` /
    ``_llama_tp_decode_body_fused``)."""
    w_up = None if up is None else up.weight
    if isinstance(o, RowParallelLinear):
        y1 = x + o(att)
        nb = norm_params[1] if len(norm_params) > 1 else None
        return y1 + w2.reduce(fused_decode_mlp_partial(
            y1, norm_params[0], nb, w1.weight, w1.bias, w2.weight, w_up,
            **kw))
    return fused_mlp_step(x, att, o.weight, norm_params, w1.weight,
                          w2.weight, bo=o.bias, b1=w1.bias, b2=w2.bias,
                          w_up=w_up, **kw)


class TPParams:
    """One rank's share of a model for TP serving: ``model``, the
    rank-local model the engine serves; ``meta``, the JAX package's;
    ``group``, the process group its all-reduces run over, ``ranks`` its
    global ranks and ``rank`` this process's rank in it. ``names`` and
    ``vals`` list the rank's weights in the JAX package's order and
    names, each a view of the local model's in the port's ``[out, in]``
    layout with the cut dims factored out: GPT ``qkv.w [3, nh_loc, hd,
    h]``, ``qkv.b [3, nh_loc, hd]``, ``proj.w [h, nh_loc, hd]``, ``fc1.w
    [I_loc, h]``, ``fc1.b [I_loc]``, ``fc2.w [h, I_loc]``; LLaMA ``q.w``
    ``[nh_loc, hd, h]`` (``k.w``, ``v.w`` on ``nhk_loc``), ``o.w [h,
    nh_loc, hd]``, ``gate.w``/``up.w [I_loc, h]``, ``down.w [h, I_loc]``;
    every other weight whole."""

    __slots__ = ("model", "meta", "group", "ranks", "rank")

    def __init__(self, model, meta, group, ranks, rank):
        self.model = model
        self.meta = meta
        self.group = group
        self.ranks = ranks
        self.rank = rank

    @property
    def device(self):
        return self.model.device

    def _named(self):
        m, meta = self.model, self.meta
        nh, nhk, hd = meta["nh_loc"], meta["nhk_loc"], meta["hd"]
        out = []
        if meta["family"] == "gpt":
            gpt = m.gpt
            out += [("wte", gpt.wte.weight), ("wpe", gpt.wpe.weight)]
            for li, blk in enumerate(gpt.blocks):
                a, mlp, b = blk.attn, blk.mlp, f"b{li}."
                h = blk.ln1.weight.shape[0]
                out += [(b + "ln1.w", blk.ln1.weight),
                        (b + "ln1.b", blk.ln1.bias),
                        (b + "qkv.w", a.qkv.weight.view(3, nh, hd, h)),
                        (b + "qkv.b", a.qkv.bias.view(3, nh, hd)),
                        (b + "proj.w", a.proj.weight.view(h, nh, hd)),
                        (b + "proj.b", a.proj.bias),
                        (b + "ln2.w", blk.ln2.weight),
                        (b + "ln2.b", blk.ln2.bias),
                        (b + "fc1.w", mlp.fc1.weight),
                        (b + "fc1.b", mlp.fc1.bias),
                        (b + "fc2.w", mlp.fc2.weight),
                        (b + "fc2.b", mlp.fc2.bias)]
            out += [("ln_f.w", gpt.ln_f.weight), ("ln_f.b", gpt.ln_f.bias)]
        else:
            lm = m.llama
            out.append(("wte", lm.embed_tokens.weight))
            for li, layer in enumerate(lm.layers):
                a, mlp, b = layer.attn, layer.mlp, f"b{li}."
                h = layer.input_norm.weight.shape[0]
                out += [(b + "in_norm.w", layer.input_norm.weight),
                        (b + "q.w", a.q_proj.weight.view(nh, hd, h)),
                        (b + "k.w", a.k_proj.weight.view(nhk, hd, h)),
                        (b + "v.w", a.v_proj.weight.view(nhk, hd, h)),
                        (b + "o.w", a.o_proj.weight.view(h, nh, hd)),
                        (b + "post_norm.w", layer.post_norm.weight),
                        (b + "gate.w", mlp.gate_proj.weight),
                        (b + "up.w", mlp.up_proj.weight),
                        (b + "down.w", mlp.down_proj.weight)]
            out.append(("norm.w", lm.norm.weight))
        if m.lm_head is not None:
            out.append(("lm_head", m.lm_head.weight))
        return [(n, t.detach()) for n, t in out]

    @property
    def names(self):
        return [n for n, _ in self._named()]

    @property
    def vals(self):
        return [t for _, t in self._named()]


def _tp_group(mesh, tp_axis):
    """``(process group, axis name)`` of the tensor-parallel dim of
    ``mesh``: a ``torch.distributed.device_mesh.DeviceMesh`` with named
    dims (``tp_axis`` picks one; a 1-D mesh takes its dim, else a dim
    named ``"tp"``, as the JAX engine picks a mesh axis), or a process
    group (a 1-D mesh whose dim is named ``tp_axis``, default ``"tp"``).
    Every rank must have initialized ``torch.distributed`` first."""
    import torch.distributed as dist

    from ..distributed import collective
    if not collective.is_initialized():
        raise RuntimeError(
            "serving TP: mesh= needs an initialized process group in "
            "every rank (paddle_tpu_torch.distributed.init_parallel_env "
            "or torch.distributed.init_process_group)")
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        axes = tuple(mesh.mesh_dim_names or ())
        if not axes:
            raise ValueError("serving TP: the DeviceMesh needs named dims "
                             "(mesh_dim_names)")
        if tp_axis is None:
            if len(axes) == 1:
                tp_axis = axes[0]
            elif "tp" in axes:
                tp_axis = "tp"
            else:
                raise ValueError(
                    f"mesh has axes {axes}: pass tp_axis= to pick the "
                    "tensor-parallel one")
        if tp_axis not in axes:
            raise ValueError(
                f"tp_axis {tp_axis!r} is not a mesh axis {axes}")
        return mesh.get_group(tp_axis), str(tp_axis)
    if isinstance(mesh, collective.Group):
        mesh = mesh.process_group
    if isinstance(mesh, dist.ProcessGroup):
        return mesh, "tp" if tp_axis is None else str(tp_axis)
    raise TypeError(
        "serving TP: mesh must be a torch.distributed DeviceMesh with "
        f"named dims or a process group, got {type(mesh).__name__}")


def _tp_meta(cfg, family, tp, axis):
    """The JAX package's TP ``meta``, with its ``ValueError``s for head
    counts the cut cannot serve; the replicated-KV regime raises
    ``NotImplementedError``."""
    nh, hd = cfg.num_heads, cfg.head_dim
    nhk = getattr(cfg, "num_kv_heads", nh)
    if nh % tp:
        raise ValueError(
            f"serving TP: num_heads {nh} not divisible by tp={tp}")
    if cfg.intermediate_size % tp:
        raise ValueError(
            f"serving TP: intermediate_size {cfg.intermediate_size} "
            f"not divisible by tp={tp}")
    shard_kv = nhk % tp == 0
    if not shard_kv and tp % nhk:
        raise ValueError(
            f"serving TP: GQA kv heads {nhk} neither divisible by nor "
            f"a divisor of tp={tp}")
    if not shard_kv:
        raise NotImplementedError(
            f"serving TP: {nhk} kv heads < tp={tp} replicate the KV side "
            "on every rank (the JAX package's replicated-KV regime); it "
            "comes with a later slice")
    return {"family": family, "tp": tp, "axis": axis,
            "nh_loc": nh // tp, "nhk_loc": nhk // tp,
            "shard_kv": shard_kv, "hd": hd, "shards_per_kv": 1}


def _column(w, b=None):
    """A column-cut projection holding copies of the cut ``w`` ``[out,
    in]`` and ``b``, so the whole weights can be freed."""
    lin = nn.Linear(w.shape[1], w.shape[0], bias=b is not None,
                    device="meta")
    lin.weight = nn.Parameter(w.clone(memory_format=torch.contiguous_format),
                              requires_grad=False)
    if b is not None:
        lin.bias = nn.Parameter(b.clone(), requires_grad=False)
    return lin


def _row(w, b, group):
    return RowParallelLinear(w.clone(memory_format=torch.contiguous_format),
                             b, group)


def tp_shard_params(model, mesh, tp_axis=None, materialize=None):
    """This rank's :class:`TPParams` of a GPT or LLaMA over the
    tensor-parallel dim of ``mesh`` (see :func:`_tp_group`): the
    rank-local model, whose heads are cut head-major as the JAX package
    cuts them (GPT's fused qkv output is ``(3, nh, hd)``-interleaved, so
    it is cut on the head dim, never contiguously), fc1/gate/up
    column-cut with fc1's bias, the out and fc2/down projections
    row-parallel, every other weight shared with ``model``. Raises as
    the JAX package does on head counts the cut cannot serve. The result
    is cached on the model per (group ranks, axis), so an engine on the
    same model and mesh reuses it.

    ``materialize(part)``, when given, is called on each part (the
    embeddings, each block, the final norm, the head) just before its
    weights are taken, and the part goes to the meta device just after:
    a rank that draws a model built on the meta device part by part
    keeps only its share."""
    import copy

    import torch.distributed as dist

    from ..quantization import WeightOnlyLinear
    group, axis = _tp_group(mesh, tp_axis)
    key = (tuple(dist.get_process_group_ranks(group)), axis)
    cache = model.__dict__.setdefault("_tp_params_cache", {})
    if key in cache:
        return cache[key]
    tp, r = dist.get_world_size(group), dist.get_rank(group)
    family = _family(model)
    meta = _tp_meta(model.cfg, family, tp, axis)
    if any(isinstance(m, WeightOnlyLinear) for m in model.modules()):
        raise NotImplementedError(
            "serving TP: weight-only int8 projections are not cut yet; "
            "they come with a later slice")
    nh, hd = model.cfg.num_heads, meta["hd"]
    nhk = getattr(model.cfg, "num_kv_heads", nh)
    heads = slice(r * meta["nh_loc"], (r + 1) * meta["nh_loc"])
    kv_heads = slice(r * meta["nhk_loc"], (r + 1) * meta["nhk_loc"])
    inter = model.cfg.intermediate_size // tp
    cols = slice(r * inter, (r + 1) * inter)

    # the local model: the model's structure with meta-device weights
    # and fresh per-model records, filled part by part below
    memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta"),
                                requires_grad=False)
            for p in model.parameters()}
    for rec in ("_tp_params_cache", "_serving_decoded_geometries"):
        if rec in model.__dict__:
            memo[id(model.__dict__[rec])] = type(model.__dict__[rec])()
    local = copy.deepcopy(model, memo)

    def cut_gpt(blk):
        a, mlp = blk.attn, blk.mlp
        h = a.qkv.weight.shape[1]
        a.qkv = _column(a.qkv.weight.reshape(3, nh, hd, h)[:, heads]
                        .reshape(-1, h),
                        a.qkv.bias.reshape(3, nh, hd)[:, heads].reshape(-1))
        a.proj = _row(a.proj.weight.reshape(h, nh, hd)[:, heads]
                      .reshape(h, -1), a.proj.bias, group)
        a.num_heads = meta["nh_loc"]
        mlp.fc1 = _column(mlp.fc1.weight[cols], mlp.fc1.bias[cols])
        mlp.fc2 = _row(mlp.fc2.weight[:, cols], mlp.fc2.bias, group)

    def cut_llama(layer):
        a, mlp = layer.attn, layer.mlp
        h = a.q_proj.weight.shape[1]
        a.q_proj = _column(a.q_proj.weight.reshape(nh, hd, h)[heads]
                           .reshape(-1, h))
        a.k_proj = _column(a.k_proj.weight.reshape(nhk, hd, h)[kv_heads]
                           .reshape(-1, h))
        a.v_proj = _column(a.v_proj.weight.reshape(nhk, hd, h)[kv_heads]
                           .reshape(-1, h))
        a.o_proj = _row(a.o_proj.weight.reshape(h, nh, hd)[:, heads]
                        .reshape(h, -1), None, group)
        a.num_heads, a.num_kv_heads = meta["nh_loc"], meta["nhk_loc"]
        a._tables = {}
        mlp.gate_proj = _column(mlp.gate_proj.weight[cols])
        mlp.up_proj = _column(mlp.up_proj.weight[cols])
        mlp.down_proj = _row(mlp.down_proj.weight[:, cols], None, group)

    if family == "gpt":
        parts = ["gpt.wte", "gpt.wpe"] + [
            f"gpt.blocks.{i}" for i in range(len(model.gpt.blocks))] \
            + ["gpt.ln_f"]
        cut = cut_gpt
    else:
        parts = ["llama.embed_tokens"] + [
            f"llama.layers.{i}" for i in range(len(model.llama.layers))] \
            + ["llama.norm"]
        cut = cut_llama
    if model.lm_head is not None:
        parts.append("lm_head")
    for name in parts:
        part, mine = model.get_submodule(name), local.get_submodule(name)
        if materialize is not None:
            materialize(part)
        for pname, p in part.named_parameters():
            sub, _, leaf = pname.rpartition(".")
            setattr(mine.get_submodule(sub), leaf,
                    nn.Parameter(p.detach(), requires_grad=False))
        if ".blocks." in name or ".layers." in name:
            cut(mine)
        if materialize is not None:
            part.to("meta")
    tpp = TPParams(local, meta, group, key[0], r)
    cache[key] = tpp
    return tpp
