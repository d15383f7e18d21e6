"""Fused decode egress for Hopper: two kernels of
``paddle_tpu/ops/pallas/fused_decode_mlp.py``.

* :func:`fused_decode_mlp` replaces ``_mlp_block`` (run by
  ``_blocked_call``): ``y1 = x + (att @ wo + bo)``, then ``y1 +
  mlp(norm(y1))``, the residual stream of the next layer, in one
  cooperative launch. ``arch="gpt"``: ``fc2(gelu_tanh(fc1(h)))`` with
  its biases; ``arch="llama"`` (``_mlp_tail``'s SwiGLU): ``(silu(h @
  w_gate) * (h @ w_up)) @ w_down`` (``w1`` is the gate, ``w_up`` the up
  projection, ``w2`` the down; ``b1`` is not read, as in JAX).
* :func:`fused_decode_mlp_partial` replaces ``_mlp_partial_block``
  (``fused_decode_mlp_partial``), the tensor-parallel shard-local MLP:
  ``mlp(norm(y1))`` with a rank's slices of the MLP weights (fc1 or
  gate/up cut by columns, fc2 or down by rows) and no fc2 bias and no
  residual, the partial sum that the layer's all-reduce adds up. It is
  a mode of the kernel that serves the arch without TP.

Both run ``egress_kernel``, one weight stream over the products for
either activation (GELU for ``arch="gpt"``, SwiGLU for ``"llama"``):
each product's K cut into slices of at most 512 floats, every CTA one
slice of one column block, the slices' sums added in slice order by the
block's CTAs, each for its share of the outputs (:func:`egress_plan`;
its plain version :func:`egress_plan_for` and :func:`egress_work`).
* :func:`fused_decode_epilogue` replaces ``_epilogue_block``: the final
  norm, the LM head and the guarded greedy pick. It returns ``(logits
  [B, V] pre-poison, nxt [B], bad [B] bool)``, with ``nxt`` and ``bad``
  exactly ``models.generation.guarded_argmax``'s on the same logits
  (the first maximal index; a row with any non-finite value after the
  poison lane is added is bad and picks 0). ``nxt`` is int64, as
  ``guarded_argmax`` returns it. One persistent wave of CTAs, each a
  span of vocab columns streamed through rings in shared memory, x
  normalised once a CTA; rows in groups of at most 16, x by K-chunks
  where a group's rows do not fit whole, so any B runs
  (:func:`epilogue_plan`; its plain version :func:`epilogue_plan_for`
  and :func:`epilogue_work`).

The norms are ``fused_decode_qkv._norm_block`` (``norm="layer"``: ``var
= E[x^2] - mean^2``; ``norm="rms"``: ``x * rsqrt(E[x^2] + eps)``).
Weights come in the port's ``nn.Linear`` layout ``[out, in]`` (the JAX
package passes ``[in, out]``); the LM head weight is ``[V, H]`` both for
the tied embedding (``transpose_lm=True``, JAX's ``matmul(h, wte.T)``)
and for an untied head, whose bias ``b_lm`` is added only when
``transpose_lm`` is False, as in JAX.

CPU tensors take the ``_plain`` versions; CUDA tensors launch the
kernels (``csrc/fused_decode_mlp.cu``: the egress kernel, for
``arch="gpt"`` with LayerNorm only, and the epilogue for either norm)
or raise; each wrapper's ``gelu_launches`` counts its GELU launches. ``rows=`` and ``interpret=`` are
TPU knobs, accepted for call compatibility and not read.
"""
from __future__ import annotations

import ctypes

import torch

from .fused_decode_qkv import SMEM_LIMIT, _norm_block

__all__ = ["fused_decode_mlp", "fused_decode_mlp_plain",
           "fused_decode_mlp_partial", "fused_decode_mlp_partial_plain",
           "fused_decode_epilogue", "fused_decode_epilogue_plain"]

_lib = None
_tickets: dict = {}   # device -> the epilogue's int32 ticket (kept at 0)
_epilogue_plans: dict = {}   # (device, B, H, V, rms) -> a launch's plan
_egress_plans: dict = {}   # (device, B, H, A, I, gelu, rms, norm bias) ->
#                            a launch's plan and its buffers per stream


def _kernels():
    global _lib
    if _lib is None:
        from ._build import load
        lib = load("fused_decode_mlp")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pdt_fused_decode_epilogue_f32.argtypes = ([P] * 13 + [I] * 3
                                                      + [F, I, P, P])
        lib.pdt_fused_decode_epilogue_f32.restype = I
        lib.pdt_fused_decode_epilogue_plan.argtypes = [I] * 4 + [P]
        lib.pdt_fused_decode_epilogue_plan.restype = I
        lib.pdt_fused_decode_egress_f32.argtypes = ([P] * 15 + [I] * 6
                                                    + [F, P, P])
        lib.pdt_fused_decode_egress_f32.restype = I
        lib.pdt_fused_decode_egress_plan.argtypes = [I] * 7 + [P]
        lib.pdt_fused_decode_egress_plan.restype = I
        lib.pdt_cuda_error_string.argtypes = [I]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _gelu_tanh(v):
    return torch.nn.functional.gelu(v, approximate="tanh")


def _mlp_tail(h, w1, b1, w2, b2, w_up, arch):
    """fc1 -> GELU -> fc2 (GPT) or gate/up -> SwiGLU -> down (LLaMA), in
    the JAX ``_mlp_tail`` op order."""
    if arch == "gpt":
        f = h @ w1.t()
        if b1 is not None:
            f = f + b1
        f = _gelu_tanh(f)
    else:
        f = torch.nn.functional.silu(h @ w1.t()) * (h @ w_up.t())
    f2 = f @ w2.t()
    if b2 is not None:
        f2 = f2 + b2
    return f2


def fused_decode_mlp_plain(x, att, wo, bo, norm_w, norm_b, w1, b1, w2, b2,
                           w_up=None, *, eps, arch="gpt", norm="layer"):
    """Plain PyTorch version of :func:`fused_decode_mlp` (any device), in
    the JAX ``_mlp_block`` op order."""
    prj = att @ wo.t()
    if bo is not None:
        prj = prj + bo
    y1 = x + prj
    h = _norm_block(y1, norm_w, norm_b, eps, norm)
    return y1 + _mlp_tail(h, w1, b1, w2, b2, w_up, arch)


def fused_decode_mlp_partial_plain(y1, norm_w, norm_b, w1, b1, w2,
                                   w_up=None, *, eps, arch="gpt",
                                   norm="layer"):
    """Plain PyTorch version of :func:`fused_decode_mlp_partial` (any
    device), the JAX ``_mlp_partial_block``: ``_mlp_tail`` with no fc2
    bias."""
    h = _norm_block(y1, norm_w, norm_b, eps, norm)
    return _mlp_tail(h, w1, b1, w2, None, w_up, arch)


def fused_decode_epilogue_plain(x, norm_w, norm_b, w_lm, b_lm, poison, *,
                                eps, transpose_lm, norm="layer"):
    """Plain PyTorch version of :func:`fused_decode_epilogue` (any
    device): ``_epilogue_block``'s math, the pick by ``guarded_argmax``'s
    rule."""
    h = _norm_block(x, norm_w, norm_b, eps, norm)
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


def _check_variant(name, arch, norm, w_up=None):
    if arch not in ("gpt", "llama"):
        raise ValueError(f"{name}: arch must be 'gpt' or 'llama', got "
                         f"{arch!r}")
    if (arch == "llama") != (w_up is not None):
        raise ValueError(f"{name}: arch='llama' takes w_up (the SwiGLU up "
                         f"projection) and arch='gpt' none")
    if norm not in ("layer", "rms"):
        raise ValueError(f"{name}: norm must be 'layer' or 'rms', got "
                         f"{norm!r}")


def fused_decode_mlp(x, att, wo, bo, norm_w, norm_b, w1, b1, w2, b2,
                     w_up=None, *, arch="gpt", norm="layer", eps=1e-5,
                     rows=None, interpret=None):
    """x [B, H] residual stream, att [B, A] attention output; wo [H, A],
    w1 [I, H] (fc1, or the gate), w2 [H, I] (fc2, or the down
    projection), w_up [I, H] (``arch="llama"`` only), all ``[out, in]``;
    biases [out] or None -> [B, H], the residual stream after out-proj +
    residual + MLP + residual."""
    del rows, interpret     # TPU tiling / interpret knobs
    name = "fused_decode_mlp"
    _check_variant(name, arch, norm, w_up)
    llama = arch == "llama"
    if llama:
        b1 = None           # _mlp_tail's SwiGLU branch has no fc1 bias
    if x.dim() != 2 or att.dim() != 2 or att.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: x [B, H] and att [B, A] expected, got "
                         f"{tuple(x.shape)} and {tuple(att.shape)}")
    bsz, hid = x.shape
    a_w, inter = att.shape[1], w1.shape[0]
    for what, t, shape in (("wo", wo, (hid, a_w)), ("w1", w1, (inter, hid)),
                           ("w2", w2, (hid, inter)),
                           ("w_up", w_up, (inter, hid)), ("bo", bo, (hid,)),
                           ("b1", b1, (inter,)), ("b2", b2, (hid,)),
                           ("norm_w", norm_w, (hid,)),
                           ("norm_b", norm_b, (hid,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {list(shape)} ([out, "
                             f"in]), got {tuple(t.shape)}")
    dev = _device(name, [x, att, wo, bo, norm_w, norm_b, w1, b1, w2, b2,
                         w_up])
    if dev.type == "cpu":
        return fused_decode_mlp_plain(x, att, wo, bo, norm_w, norm_b, w1,
                                      b1, w2, b2, w_up, eps=eps, arch=arch,
                                      norm=norm)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not llama and norm != "layer":
        raise NotImplementedError(
            f"{name}: the GELU MLP kernel takes norm='layer' (GPT's); the "
            f"JAX package serves no GELU MLP behind an RMSNorm")
    _check_card(name, (("x", x), ("att", att), ("wo", wo), ("bo", bo),
                       ("norm_w", norm_w), ("norm_b", norm_b), ("w1", w1),
                       ("b1", b1), ("w2", w2), ("b2", b2), ("w_up", w_up)))
    if norm_w.data_ptr() % 16:
        raise ValueError(f"{name}: norm_w must be 16-byte aligned")
    out = _egress_launch(name, dev, torch.empty_like(x), norm_w, norm_b, w1,
                         w_up, w2, norm=norm, eps=eps, x=x, att=att, wo=wo,
                         bo=bo, b1=b1, b2=b2)
    fused_decode_mlp.launches += 1
    fused_decode_mlp.gelu_launches += not llama
    return out


fused_decode_mlp.launches = 0
fused_decode_mlp.gelu_launches = 0


def fused_decode_mlp_partial(y1, norm_w, norm_b, w1, b1, w2, w_up=None, *,
                             arch="gpt", norm="layer", eps=1e-5, rows=None,
                             interpret=None):
    """y1 [B, H] the residual stream after the attention's all-reduce;
    w1 [I, H] (a rank's columns of fc1, or of the gate), w2 [H, I] (its
    rows of fc2, or of the down projection), w_up [I, H] (``arch="llama"``
    only), all ``[out, in]``; b1 [I] or None -> the pre-all-reduce partial
    [B, H] of ``mlp(norm(y1))``, with no fc2 bias and no residual."""
    del rows, interpret     # TPU tiling / interpret knobs
    name = "fused_decode_mlp_partial"
    _check_variant(name, arch, norm, w_up)
    llama = arch == "llama"
    if llama:
        b1 = None           # _mlp_tail's SwiGLU branch has no fc1 bias
    if y1.dim() != 2:
        raise ValueError(f"{name}: y1 [B, H] expected, got "
                         f"{tuple(y1.shape)}")
    bsz, hid = y1.shape
    inter = w1.shape[0]
    for what, t, shape in (("w1", w1, (inter, hid)), ("w2", w2, (hid, inter)),
                           ("w_up", w_up, (inter, hid)), ("b1", b1, (inter,)),
                           ("norm_w", norm_w, (hid,)),
                           ("norm_b", norm_b, (hid,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {list(shape)} ([out, "
                             f"in]), got {tuple(t.shape)}")
    dev = _device(name, [y1, norm_w, norm_b, w1, b1, w2, w_up])
    if dev.type == "cpu":
        return fused_decode_mlp_partial_plain(y1, norm_w, norm_b, w1, b1, w2,
                                              w_up, eps=eps, arch=arch,
                                              norm=norm)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not llama and norm != "layer":
        raise NotImplementedError(
            f"{name}: the GELU MLP kernel takes norm='layer' (GPT's); the "
            f"JAX package serves no GELU MLP behind an RMSNorm")
    _check_card(name, (("y1", y1), ("norm_w", norm_w), ("norm_b", norm_b),
                       ("w1", w1), ("b1", b1), ("w2", w2), ("w_up", w_up)))
    if norm_w.data_ptr() % 16:
        raise ValueError(f"{name}: norm_w must be 16-byte aligned")
    out = _egress_launch(name, dev, y1, norm_w, norm_b, w1, w_up, w2,
                         norm=norm, eps=eps, b1=b1)
    fused_decode_mlp_partial.launches += 1
    fused_decode_mlp_partial.gelu_launches += not llama
    return out


fused_decode_mlp_partial.launches = 0
fused_decode_mlp_partial.gelu_launches = 0


PLAN_KEYS = ("grid", "S0", "SA", "SB", "C0", "CA", "CB", "rows", "smem",
             "most")
SLICE_Q = 128   # float4s of one of the egress kernel's K-slices (512 floats)


def egress_plan_for(bsz, hid, a_w, inter, most, gelu=False):
    """Plain version of the library's egress plan (:func:`egress_plan`)
    when ``most`` CTAs may be used (``a_w`` 0: the partial mode, no out
    projection; ``gelu``: the GELU MLP behind GPT's LayerNorm, else
    SwiGLU behind LLaMA's RMSNorm without bias): each product's K cut
    into the fewest slices of at most ``SLICE_Q`` float4s (``S0``,
    ``SA``, ``SB``), the CTAs into as many column blocks a slice as fill
    ``most`` (``C0``, ``CA``, ``CB``: at least two columns a block of
    the out projection, of fc1 and of the second product, one of the
    gate/up product); ``rows`` is B rounded up to the rows a warp's
    registers hold at once (B up to 2, else 4); ``smem`` holds, beside
    the activation slice, the LayerNorm's slices and y1's rows (GELU: a
    norm from full-row statistics; LLaMA's RMSNorm factors 1 / rms out
    of the sums instead)."""
    rt = bsz if bsz <= 2 else 4

    def slices(k):
        return -(-(k // 4) // SLICE_Q)

    s0, sa, sb = slices(a_w), slices(hid), slices(inter)
    c0 = min(most // s0, (hid + 1) // 2) if s0 else 0
    ca = min(most // sa, (inter + 1) // 2 if gelu else inter)
    cb = min(most // sb, (hid + 1) // 2)
    rows = -(-bsz // rt) * rt
    smem = (rows + 2 * gelu) * SLICE_Q * 16 + 4 * (gelu * bsz * hid
                                                   + 2 * bsz)
    return dict(grid=max(c0 * s0, ca * sa, cb * sb), S0=s0, SA=sa, SB=sb,
                C0=c0, CA=ca, CB=cb, rows=rows, smem=smem, most=most)


def egress_work(plan, hid, a_w, inter):
    """Every CTA's share of the egress kernel's products under ``plan``,
    the kernel's rule: ``{"out_proj": [...], "mlp_in": [...],
    "mlp_out": [...]}`` (the out projection, fc1 or gate/up, fc2 or
    down) of ``(cta, k0, k1, n0, n1)``, CTA c taking K-slice ``c % S``
    of column block ``c // S``; once all S are in, each adds the slices,
    in slice order, for its 1/S of the block's outputs."""
    def cut(i, n, parts):
        return i * n // parts

    work = {"out_proj": [], "mlp_in": [], "mlp_out": []}
    for name, k, n, s, c in (("out_proj", a_w, hid, plan["S0"], plan["C0"]),
                             ("mlp_in", hid, inter, plan["SA"], plan["CA"]),
                             ("mlp_out", inter, hid, plan["SB"], plan["CB"])):
        for cta in range(min(plan["grid"], s * c)):
            sl, blk = cta % s, cta // s
            work[name].append((cta, 4 * cut(sl, k // 4, s),
                               4 * cut(sl + 1, k // 4, s), cut(blk, n, c),
                               cut(blk + 1, n, c)))
    return work


def _egress_plan(bsz, hid, a_w, inter, gelu, norm, has_nb, device):
    """The library's plan of one egress launch, made once per card,
    widths, activation and norm: ``(plan, buffers)``, ``plan`` a ctypes
    int array in ``PLAN_KEYS`` order and ``buffers`` a dict, per stream,
    of the launch's scratch and arrival counts."""
    dev = torch.device(device)
    key = (dev.index if dev.index is not None else
           torch.cuda.current_device(), bsz, hid, a_w, inter, gelu,
           norm == "rms", bool(has_nb))
    got = _egress_plans.get(key)
    if got is None:
        plan = (ctypes.c_int * len(PLAN_KEYS))()
        with torch.cuda.device(key[0]):
            rc = _kernels().pdt_fused_decode_egress_plan(
                bsz, hid, a_w, inter, int(gelu), int(norm == "rms"),
                int(bool(has_nb)), plan)
        if rc != 0:
            _raise("fused_decode_mlp", rc)
        got = _egress_plans[key] = (plan, {})
    return got


def egress_plan(bsz, hid, a_w, inter, device=None, gelu=False):
    """The plan of one egress launch (row 5; ``a_w`` 0: its partial
    mode, row 6; ``gelu``: GPT's GELU MLP behind its LayerNorm, else
    LLaMA's SwiGLU behind its RMSNorm) on the card at these widths:
    ``grid`` CTAs; ``S0``, ``SA``, ``SB`` K-slices of the out-projection,
    first and second MLP products (at most 512 wide); ``C0``, ``CA``,
    ``CB`` column blocks of each; ``rows`` (B rounded up to the rows a
    warp's registers hold at once); ``smem`` bytes a CTA; ``most`` CTAs
    the plan may use (every resident one)."""
    norm = "layer" if gelu else "rms"
    return dict(zip(PLAN_KEYS, _egress_plan(
        bsz, hid, a_w, inter, gelu, norm, gelu,
        "cuda" if device is None else device)[0]))


def _egress_buffers(bufs, dev, stream, plan, bsz, hid, a_w, inter, gelu):
    """The scratch and arrival counts of one plan on one stream (reused by
    its launches, which run in stream order): the slices' sums of the
    out projection, of the first and second MLP products, the activation
    and the fast path's sums of squares, in floats; int32 counts, zero at
    first, of the ``C0`` out-projection, ``CA`` first-product and ``CB``
    second-product column blocks, which a launch puts back to 0 before
    the next launch counts them."""
    got = bufs.get(stream)
    if got is None:
        s0, sa, sb, c0, ca, cb = plan[1:7]
        scratch = torch.empty(s0 * bsz * hid + sa * (1 if gelu else 2) * bsz
                              * inter + sb * bsz * hid + bsz * inter
                              + ca * sa * bsz, dtype=torch.float32,
                              device=dev)
        counts = torch.zeros(c0 + ca + cb, dtype=torch.int32, device=dev)
        got = bufs[stream] = (scratch.data_ptr(), counts.data_ptr(),
                              scratch, counts)
    return got


def _egress_launch(name, dev, y1, norm_w, norm_b, w1, wu, w2, *, norm, eps,
                   x=None, att=None, wo=None, bo=None, b1=None, b2=None):
    """One launch of the egress kernel: row 5 with ``x``, ``att``, ``wo``
    (``y1`` the scratch it writes), else row 6 (``y1`` given); GELU
    without ``wu``, else SwiGLU. Returns the output [B, H]."""
    bsz, hid = y1.shape
    a_w, inter = (0 if att is None else att.shape[1]), w1.shape[0]
    gelu = wu is None
    plan, bufs = _egress_plan(bsz, hid, a_w, inter, gelu, norm,
                              norm_b is not None, dev)
    if not 0 < plan[8] <= SMEM_LIMIT:
        raise ValueError(f"{name}: {bsz} rows do not fit the {SMEM_LIMIT} "
                         f"B of shared memory of a CTA")
    out = torch.empty_like(y1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch, counts = _egress_buffers(bufs, dev, stream, plan, bsz, hid,
                                          a_w, inter, gelu)[:2]
        rc = _kernels().pdt_fused_decode_egress_f32(
            _ptr(x), _ptr(att), _ptr(wo), _ptr(bo), norm_w.data_ptr(),
            _ptr(norm_b), w1.data_ptr(), _ptr(b1), _ptr(wu), w2.data_ptr(),
            _ptr(b2), y1.data_ptr(), scratch, counts, out.data_ptr(), bsz,
            hid, a_w, inter, int(gelu), int(norm == "rms"), float(eps), plan,
            stream)
    if rc != 0:
        _raise(name, rc)
    return out


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
    _check_variant(name, "gpt", norm)
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
                                           transpose_lm=transpose_lm,
                                           norm=norm)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    pz = poison.reshape(-1)
    _check_card(name, (("x", x), ("norm_w", norm_w), ("norm_b", norm_b),
                       ("w_lm", w_lm), ("b_lm", bias), ("poison", pz)))
    for what, t in (("norm_w", norm_w), ("norm_b", norm_b)):
        if t is not None and (tuple(t.shape) != (hid,) or t.data_ptr() % 16):
            raise ValueError(f"{name}: {what} must be [{hid}] and 16-byte "
                             f"aligned")
    lib = _kernels()
    plan = _epilogue_plan(bsz, hid, vocab, norm, dev)
    logits = torch.empty(bsz, vocab, dtype=x.dtype, device=dev)
    part = torch.empty(3, plan[0], bsz, dtype=torch.int32, device=dev)
    nxt = torch.empty(bsz, dtype=torch.int64, device=dev)
    bad = torch.empty(bsz, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pdt_fused_decode_epilogue_f32(
            x.data_ptr(), norm_w.data_ptr(), _ptr(norm_b), w_lm.data_ptr(),
            _ptr(bias), pz.data_ptr(), logits.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), part[2].data_ptr(), _ticket(dev).data_ptr(),
            nxt.data_ptr(), bad.data_ptr(), bsz, hid, vocab, float(eps),
            int(norm == "rms"), plan, stream)
    if rc != 0:
        _raise(name, rc)
    fused_decode_epilogue.launches += 1
    return logits, nxt, bad


fused_decode_epilogue.launches = 0


EPILOGUE_KEYS = ("grid", "RT", "kc", "smem", "per_sm", "chunks")
# the kernel's warps, columns a warp dots at once, stages of a warp's ring,
# float4s of a weight row a stage, rows a group at most; its static shared
# memory (the last-CTA flag, as ptxas allots it)
EPI_WARPS, EPI_GROUP, EPI_STAGES, EPI_STAGE_Q, EPI_ROWS_MOST = 8, 8, 2, 32, 16
EPI_STATIC_SMEM = 16


def _epilogue_plan(bsz, hid, vocab, norm, dev):
    """The library's plan of one epilogue launch, made once per card,
    widths and norm: a ctypes int array in ``EPILOGUE_KEYS`` order."""
    key = (dev.index if dev.index is not None else
           torch.cuda.current_device(), bsz, hid, vocab, norm == "rms")
    plan = _epilogue_plans.get(key)
    if plan is None:
        plan = (ctypes.c_int * len(EPILOGUE_KEYS))()
        with torch.cuda.device(key[0]):
            rc = _kernels().pdt_fused_decode_epilogue_plan(
                bsz, hid, vocab, int(norm == "rms"), plan)
        if rc != 0:
            _raise("fused_decode_epilogue", rc)
        plan = _epilogue_plans[key] = plan
    return plan


def epilogue_plan(bsz, hid, vocab, norm="layer", device=None):
    """The plan of one epilogue launch (row 7) on the card at these widths:
    ``grid`` CTAs (one persistent wave); ``RT`` rows a group; ``kc``
    floats of x's K-chunk (``hid`` where the group's rows fit whole);
    ``smem`` bytes a CTA; ``per_sm`` resident CTAs an SM; ``chunks``."""
    dev = torch.device("cuda" if device is None else device)
    return dict(zip(EPILOGUE_KEYS,
                    _epilogue_plan(bsz, hid, vocab, norm, dev)))


def epilogue_plan_for(bsz, hid, vocab, sms, per_sm,
                      smem_most=SMEM_LIMIT - EPI_STATIC_SMEM):
    """Plain version of the library's epilogue plan (:func:`epilogue_plan`)
    on a card of ``sms`` SMs where ``per_sm`` CTAs of this plan's shared
    memory are resident and a CTA may have ``smem_most`` bytes of dynamic
    shared memory: rows in groups of ``RT`` (B rounded up to a power
    of two, at most 16), ``EPI_GROUP`` columns a warp's unit (fewer where
    a lane's sums, columns x RT, would pass 64); x's rows of a group whole
    in shared memory beside the weight rings where they fit (``kc`` =
    ``hid``), every resident CTA, at most one a unit of each of its warps;
    else one CTA an SM and x by the fewest K-chunks of whole stages that
    fit beside the rings and the chunks' running sums of the CTA's
    columns."""
    rt = 1
    while rt < bsz and rt < EPI_ROWS_MOST:
        rt *= 2
    rows, group = min(bsz, rt), epilogue_group(rt)
    units = -(-vocab // (EPI_WARPS * group))

    def smem(kc, cols):
        return (EPI_WARPS * EPI_STAGES * group * EPI_STAGE_Q * 16
                + 4 * (rows * kc + (cols * rt if kc < hid else 0) + 2 * rt
                       + 3 * EPI_WARPS * rt))

    if smem(hid, 0) <= smem_most:
        kc, grid = hid, min(per_sm * sms, units)
    else:
        grid = min(sms, units)
        cols = -(-vocab // grid)
        step = 4 * EPI_STAGE_Q
        kc_most = (smem_most - smem(0, 0) - 4 * cols * rt) // (4 * rows) \
            // step * step
        if kc_most < step:
            raise ValueError(f"fused_decode_epilogue: {bsz} rows of {hid} "
                             f"leave no K-chunk")
        chunks = -(-hid // kc_most)
        kc = -(-hid // (chunks * step)) * step   # whole stages, even
    return dict(grid=grid, RT=rt, kc=kc,
                smem=smem(kc, -(-vocab // grid)), per_sm=per_sm,
                chunks=-(-hid // kc))


def epilogue_group(rt):
    """Columns of a warp's unit with ``rt`` rows a group (the kernel's
    ``epi_group``)."""
    return EPI_GROUP if EPI_GROUP * rt <= 64 else 64 // rt


def epilogue_work(plan, bsz, hid, vocab):
    """The kernel's walk under ``plan``: ``{"cols": [(cta, n0, n1)],
    "units": [(cta, warp, n0, n1)], "chunks": [(k0, k1)], "groups": [(b0,
    b1)]}``: CTA c takes vocab columns ``[c V / grid, (c + 1) V / grid)``,
    its warp w the w-th eighth of them, ``epilogue_group(RT)`` at a time
    (a unit), each through every chunk of every row group."""
    g, kc, rt = plan["grid"], plan["kc"], plan["RT"]
    w = epilogue_group(rt)
    cols, units = [], []
    for c in range(g):
        n0, n1 = c * vocab // g, (c + 1) * vocab // g
        cols.append((c, n0, n1))
        for wp in range(EPI_WARPS):
            a = n0 + wp * (n1 - n0) // EPI_WARPS
            b = n0 + (wp + 1) * (n1 - n0) // EPI_WARPS
            units += [(c, wp, u, min(b, u + w)) for u in range(a, b, w)]
    return {"cols": cols, "units": units,
            "chunks": [(k, min(hid, k + kc)) for k in range(0, hid, kc)],
            "groups": [(b, min(bsz, b + rt)) for b in range(0, bsz, rt)]}
