"""Drive the PyTorch port's serving and training paths once on a CUDA
card.

    python3 chip_smoke.py [--seed N]

1. Header: the card, its power limit (nvidia-smi), TF32 off, and the
   build of every CUDA kernel from ``paddle_tpu_torch/ops/cuda/csrc``
   (one ``nvcc`` per source, all started together).
2. Kernel phase, each kernel against its plain PyTorch version on the
   card at the shapes its main path gives it, timed with CUDA events
   with the L2 flushed before each launch, beside the least time the
   card could take (bound) and, where one PyTorch call computes the
   same function, that call's time (never used by the port):
   * ``ragged_paged_attention`` at the serve phase's engine shapes (a
     mixed prefill + decode step and a decode step at GPT-124M widths)
     and one GQA case; max abs error <= 2e-5 (fp32);
   * ``flash_attention_fwd`` / ``flash_attention_bwd`` at the train
     phase's shape (q, k, v ``[8, 1024, 12, 64]`` bf16 causal, the
     unbound views of a packed qkv), an fp32 case with Sq != Sk and a
     GQA case (Hq 32, Hk 8, D 128, S 512, bf16): fp32 within 2e-5 (o,
     lse) and 1e-4 (grads); bf16 within one bf16 rounding of the plain
     version run in fp32 on the same bf16 inputs;
   * ``fused_update`` (AdamW, lr 1e-4, decay 0.01) on GPT-124M's O2
     buckets (124,437,504 bf16 params with fp32 masters; 38,912 fp32
     LayerNorm params, padded) and the bf16 bucket with a clip scale:
     fp32 state within 1e-6 of its largest value, bf16 weights within
     one bf16 rounding.
3. Serve phase: GPT-124M (``GPTConfig()`` defaults, weights drawn from
   the seed in the JAX package's layout and init) behind
   ``ContinuousBatchingEngine`` serves 16 requests (prompts 16-512
   tokens, 32 new tokens each). Every request must finish by length,
   the page pool must be conserved, and the kernel must have launched
   in both the mixed and the decode steps. A teacher-forced plain fp32
   forward must pick every served token, except where its top-2 margin
   is below 1e-4 (a near tie). One more run under ``torch.profiler``
   breaks the device time down by kernel.
4. Train phase: GPT-124M in ``bench.py``'s training configuration
   (batch 8 x 1024, recompute ``dots_and_kernels_saveable``, AdamW lr
   1e-4, AMP O2 bf16 with fp32 master weights) through the Paddle entry
   points: 2 warm-up steps, 10 timed steps (step ms, tokens/s, MFU
   against 989 TFLOP/s bf16), every step launching the flash forward
   and backward once per layer and the fused update once per bucket;
   every loss finite, the first within 0.5 of ln(vocab), every master
   and bf16 parameter finite after the last step; one more step under
   ``torch.profiler``.
5. Train parity: one fp32 AdamW step (GPT-124M widths, 2 layers, batch
   2 x 256, TF32 off) on the card, through the kernels, against the same
   step of a CPU copy running the plain versions: loss, every grad and
   every updated parameter within the tolerances printed.
6. Prints the ``train`` JSON line, the ``kernels`` JSON line, then
   ``{"ok": true, "device": ...}`` as the last line. Any failed phase
   raises: the exit code is not 0 and no result line is printed.
   Without a card it exits 2 at once.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
TOL = 2e-5                   # fp32, another summation order
MARGIN = 1e-4                # teacher-forced near-tie margin


def log(msg):
    print(f"chip_smoke: {msg}", flush=True)


def header():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {name} x{count}")
    print(smi_line, flush=True)
    log("torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return name, count, smi_line


def build():
    from paddle_tpu_torch.ops.cuda import (_build, flash_attention,
                                           fused_optimizer, paged_attention)
    t0 = time.perf_counter()
    libs = _build.build_all()
    paged_attention._kernel()           # load + bind
    flash_attention._kernels()
    fused_optimizer._kernel()
    secs = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {secs:.2f} s")
    return secs


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from paddle_tpu_torch.ops.cuda import (flash_attention,
                                           fused_optimizer, paged_attention)
    return {"ragged_paged_attention": paged_attention.ragged_paged_attention,
            "flash_attention_fwd": flash_attention.flash_attention_fwd,
            "flash_attention_bwd": flash_attention.flash_attention_bwd,
            "fused_update": fused_optimizer.fused_update}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


# The engine geometry of the serve phase. At GPT-124M (1024 positions)
# it gives the attention calls of the main path these shapes: block
# tables [8, 64], pools [12, 513, 16, 64], q [128, 12, 64] in a mixed
# step (8 slots x q_block + prefill_chunk) and [8, 12, 64] in a decode.
GEO = dict(max_slots=8, page_size=16, decode_window=8, prefill_chunk=64,
           q_block=8)


# ------------------------------------------------------------ kernel --
def _attn_case(gen, kv_lens, q_lens, hq, hk, d, ps, q_block, total_pages,
               NP=None, T=None):
    """Inputs on the card: shuffled block tables ``[B, NP]``, packed q
    ``[T, Hq, D]`` with each segment at a q_block edge (by default one
    trailing padding q block)."""
    dev = torch.device("cuda")
    B = len(kv_lens)
    npg = [-(-kv // ps) for kv in kv_lens]
    NP = max(npg) if NP is None else NP
    perm = torch.randperm(total_pages - 1, generator=gen) + 1
    bt = torch.zeros(B, NP, dtype=torch.int32)
    at = 0
    for b in range(B):
        bt[b, :npg[b]] = perm[at:at + npg[b]]
        at += npg[b]
    live = sum(-(-q // q_block) * q_block for q in q_lens)
    T = live + q_block if T is None else T
    assert live <= T, (live, T)
    cgen = torch.Generator(device=dev).manual_seed(int(
        torch.randint(0, 2**31 - 1, (1,), generator=gen)))
    k = torch.randn(hk, total_pages, ps, d, generator=cgen, device=dev)
    v = torch.randn(hk, total_pages, ps, d, generator=cgen, device=dev)
    q = torch.randn(T, hq, d, generator=cgen, device=dev)
    return (q, k, v, bt.to(dev),
            torch.tensor(kv_lens, dtype=torch.int32, device=dev),
            torch.tensor(q_lens, dtype=torch.int32, device=dev))


def _bound(kv_lens, q_lens, hq, hk, d, page_size):
    """Least time for the work these inputs need: each needed K/V token
    read once per kv head, q read and o written once; 4 d flops per
    attended (row, head, kv position) plus ~5 for the softmax."""
    nbytes = flops = 0
    for kv, ql in zip(kv_lens, q_lens):
        if ql == 0:
            continue
        nbytes += 2 * kv * hk * d * 4 + 2 * ql * hq * d * 4
        attended = sum(kv - ql + i + 1 for i in range(ql))
        flops += hq * attended * (4 * d + 5)
    nbytes += len(kv_lens) * (2 + -(-max(kv_lens) // page_size)) * 4
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations",
            nbytes, flops)


def _time_ms(fn, n, flush):
    """Mean device time of ``fn`` over ``n`` calls, each after an L2
    flush (a 256 MB write), each between its own pair of CUDA events."""
    for _ in range(3):
        fn()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for s, e in evs:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / n


def kernel_phase(seed, power):
    """Kernel vs plain on the card. The two GPT-124M cases have the
    shapes the serve phase's engine gives the kernel (``GEO``); the GQA
    case is a LLaMA-like head layout the main path does not reach."""
    from paddle_tpu_torch.ops.cuda.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    slots, ps, qb = GEO["max_slots"], GEO["page_size"], GEO["q_block"]
    NP = 1024 // ps                               # GPT-124M max_seq_len
    pages = 1 + slots * NP
    budget = slots * qb + GEO["prefill_chunk"]
    # a mixed step: one 64-token prefill chunk, six decodes, an idle slot
    # (kv_len 1, q_len 0), in the engine's padded token budget
    kv_mixed = [int(x) for x in rng.integers(64, 1025, slots)]
    kv_mixed[3] = 1
    q_mixed = [1, 64, 1, 0, 1, 1, 1, 1]
    cases = [
        # name, kv_lens, q_lens, hq, hk, d, page_size, q_block, pages,
        # table width, packed tokens
        ("gpt124m_mixed", kv_mixed, q_mixed, 12, 12, 64, ps, qb, pages,
         NP, budget),
        ("gpt124m_decode", [int(x) for x in rng.integers(1, 1025, slots)],
         [1] * slots, 12, 12, 64, ps, 1, pages, NP, slots),
        ("gqa_32q_8kv_d128", [int(x) for x in rng.integers(64, 1025, 4)],
         [64, 1, 17, 1], 32, 8, 128, 16, 8, 257, None, None),
    ]
    rows = []
    for name, kvl, ql, hq, hk, d, ps, qb, pages, width, T in cases:
        args = _attn_case(gen, kvl, ql, hq, hk, d, ps, qb, pages, width, T)
        out = ragged_paged_attention(*args, q_block=qb)
        ref = ragged_paged_attention_plain(*args, q_block=qb)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= TOL:
            raise AssertionError(f"{name}: kernel vs plain max abs error "
                                 f"{err:.3g} > {TOL}")
        ms = _time_ms(lambda: ragged_paged_attention(*args, q_block=qb),
                      100, flush)
        plain_ms = _time_ms(
            lambda: ragged_paged_attention_plain(*args, q_block=qb), 5,
            flush)
        bound_ms, bound_by, nbytes, flops = _bound(kvl, ql, hq, hk, d,
                                                   ps)
        row = dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   flops=flops, q_shape=list(args[0].shape),
                   pool_shape=list(args[1].shape),
                   table_shape=list(args[3].shape), kv_lens=kvl,
                   q_lens=ql, q_block=qb)
        log(f"kernel {name} q {row['q_shape']} pools {row['pool_shape']} "
            f"tables {row['table_shape']}: max_abs_err {err:.3g}, "
            f"{ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.4f} "
            f"ms by {bound_by}, {bound_ms / ms:.1%} of bound) on {power}")
        rows.append(row)
    del flush
    return rows


# ------------------------------------------------------- train kernels --
def _bf16_err(got, ref):
    """(max abs error, limit): one bf16 rounding of the largest
    reference value, plus 1e-4 for the fp32 summation order."""
    err = float((got.float() - ref.float()).abs().max())
    return err, 2.0 ** -8 * float(ref.float().abs().max()) + 1e-4


def _flash_pairs(b, hq, sq, sk, causal):
    """Attended (row, key) pairs over all batches and q heads."""
    if not causal:
        return b * hq * sq * sk
    off = sk - sq
    return b * hq * sum(max(0, min(sk, i + off + 1)) for i in range(sq))


def _flash_bound(b, hq, hk, sq, sk, d, causal, esize, bwd):
    """Least time: q, k, v (and o, do) read once, o (and dq, dk, dv)
    written once, lse/delta in fp32; 2 products (fwd) or 5 (bwd) of
    2 d flops per attended pair, at the tensor-core rate for bf16 and
    the CUDA-core rate for fp32."""
    q_elems, kv_elems = b * sq * hq * d, b * sk * hk * d
    stats = b * hq * sq * 4
    if bwd:   # q, do, o, dq + k, v, dk, dv; lse and delta read
        nbytes = (4 * q_elems + 4 * kv_elems) * esize + 2 * stats
        flops = 5 * 2 * d * _flash_pairs(b, hq, sq, sk, causal)
    else:     # q, o + k, v; lse written
        nbytes = (2 * q_elems + 2 * kv_elems) * esize + stats
        flops = 2 * 2 * d * _flash_pairs(b, hq, sq, sk, causal)
    rate = BF16_FLOPS_PER_S if esize == 2 else FP32_FLOPS_PER_S
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations",
            nbytes, flops)


def flash_cases(seed, power, flush):
    """Flash forward and backward kernels against their plain versions.
    Returns (fwd rows, bwd rows); the first row of each is the train
    phase's shape."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = [
        # name, b, sq, sk, hq, hk, d, causal, dtype
        ("gpt124m_train", 8, 1024, 1024, 12, 12, 64, True, torch.bfloat16),
        ("f32_sq192_sk320", 2, 192, 320, 4, 4, 64, True, torch.float32),
        ("gqa_32q_8kv_d128", 2, 512, 512, 32, 8, 128, True,
         torch.bfloat16),
    ]
    fwd_rows, bwd_rows = [], []
    for name, b, sq, sk, hq, hk, d, causal, dt in cases:
        if sq == sk and hq == hk:   # the unbound views of a packed qkv
            qkv = torch.randn(b, sq, 3, hq, d, generator=gen, device=dev)
            q, k, v = qkv.to(dt).unbind(2)
        else:
            q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(dt)
            k = torch.randn(b, sk, hk, d, generator=gen, device=dev).to(dt)
            v = torch.randn(b, sk, hk, d, generator=gen, device=dev).to(dt)
        do = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(dt)
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        grads = fa.flash_attention_bwd(q, k, v, do, o, lse, causal)
        f32 = [x.float() for x in (q, k, v, do)]
        ro, rlse = fa.flash_attention_fwd_plain(*f32[:3], causal)
        rgrads = fa.flash_attention_bwd_plain(*f32, o.float(), lse, causal)
        torch.cuda.synchronize()
        errs = {"o": (float((o.float() - ro).abs().max()), 2e-5),
                "lse": (float((lse - rlse).abs().max()), 2e-5)}
        for n, g, r in zip(("dq", "dk", "dv"), grads, rgrads):
            errs[n] = (float((g.float() - r).abs().max()), 1e-4)
        if dt == torch.bfloat16:
            errs["o"] = _bf16_err(o, ro)
            for n, g, r in zip(("dq", "dk", "dv"), grads, rgrads):
                errs[n] = _bf16_err(g, r)
        for n, (err, lim) in errs.items():
            if not err <= lim:
                raise AssertionError(f"flash {name} {n}: kernel vs plain "
                                     f"max abs error {err:.3g} > {lim:.3g}")
        del ro, rlse, rgrads, f32
        plain = [x.to(dt) for x in (q, k, v, do)]
        ms_f = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal),
                        20, flush)
        ms_b = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, do, o, lse,
                                                       causal), 10, flush)
        plain_f = _time_ms(lambda: fa.flash_attention_fwd_plain(
            *plain[:3], causal), 3, flush)
        plain_b = _time_ms(lambda: fa.flash_attention_bwd_plain(
            *plain, o, lse, causal), 3, flush)
        # the library yardstick: torch SDPA in [B, H, S, D], forward and
        # forward + backward (causal alignment differs when Sq != Sk, so
        # only square cases get one); GQA by enable_gqa
        lib_f = lib_fb = None
        if sq == sk:
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            gqa = hq != hk

            def sdpa():
                return tF.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=gqa)

            def sdpa_fb():
                sdpa().backward(dot)

            with torch.no_grad():
                lib_f = _time_ms(sdpa, 20, flush)
            lib_fb = _time_ms(sdpa_fb, 10, flush)
            del qt, kt, vt, dot
        esize = 2 if dt == torch.bfloat16 else 4
        shape = dict(q=[b, sq, hq, d], kv=[b, sk, hk, d], causal=causal,
                     dtype=str(dt).replace("torch.", ""))
        for rows, ms, pl, lib, bwd, which in (
                (fwd_rows, ms_f, plain_f, lib_f, False, ("o", "lse")),
                (bwd_rows, ms_b, plain_b, lib_fb, True, ("dq", "dk", "dv"))):
            bound_ms, bound_by, nbytes, flops = _flash_bound(
                b, hq, hk, sq, sk, d, causal, esize, bwd)
            row = dict(case=name, max_abs_err=max(errs[n][0] for n in which),
                       tolerance={n: errs[n][1] for n in which}, ms=ms,
                       plain_ms=pl, bound_ms=bound_ms, bound_by=bound_by,
                       bytes=nbytes, flops=flops, library_ms=lib,
                       library=("torch sdpa fwd+bwd" if bwd else
                                "torch sdpa fwd") if lib else None, **shape)
            log(f"kernel flash_attention_{'bwd' if bwd else 'fwd'} {name} "
                f"q {shape['q']} kv {shape['kv']} {shape['dtype']}: max_abs_"
                f"err {row['max_abs_err']:.3g}, {ms:.4f} ms (plain "
                f"{pl:.3f} ms, library {lib if lib is None else round(lib, 4)}"
                f" ms, bound {bound_ms:.4f} ms by {bound_by}, "
                f"{bound_ms / ms:.1%} of bound) on {power}")
            rows.append(row)
        del q, k, v, do, o, lse, grads, plain
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def optimizer_cases(seed, power, flush):
    """``fused_update`` (AdamW, lr 1e-4, decay 0.01) against its plain
    version on the GPT-124M O2 buckets, and the library's fused AdamW
    over fp32 params of the big bucket's size (which computes the update
    without the bf16 copy)."""
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    cases = [("gpt124m_o2_bf16_master", 124_437_504, torch.bfloat16, None),
             ("gpt124m_o2_f32_layernorm", 38_912, torch.float32, None),
             ("gpt124m_o2_bf16_master_clip", 124_437_504, torch.bfloat16,
              0.37)]
    rows = []
    for name, n, dt, clip in cases:
        use_master = dt == torch.bfloat16
        spec = fo.UpdateSpec(kind="adamw", decay=0.01, use_master=use_master,
                             has_clip=clip is not None)
        master = torch.randn(n, generator=gen, device=dev) * 0.02
        state = dict(w=master.to(dt),
                     g=(torch.randn(n, generator=gen, device=dev)
                        * 1e-3).to(dt),
                     m=torch.randn(n, generator=gen, device=dev) * 1e-4,
                     v=torch.rand(n, generator=gen, device=dev) * 1e-7,
                     master=master if use_master else None)
        ref = {k: None if t is None else t.clone() for k, t in state.items()}
        b1p = torch.tensor(0.9 ** 4, device=dev)
        b2p = torch.tensor(0.999 ** 4, device=dev)
        kw = dict(lr=1e-4, clip_scale=clip, b1p=b1p, b2p=b2p)
        fo.fused_update(spec, **state, **kw)
        lr = torch.tensor(1e-4, device=dev)
        scale = torch.tensor(1.0 if clip is None else clip, device=dev)
        fo.fused_update_plain(spec, lr, scale, ref["w"], ref["g"],
                              ref["master"], ref["m"], ref["v"],
                              b1p * 0.9, b2p * 0.999)
        torch.cuda.synchronize()
        err = 0.0
        for k in ("w", "master", "m", "v"):
            if state[k] is None:
                continue
            e = float((state[k].float() - ref[k].float()).abs().max())
            big = float(ref[k].float().abs().max())
            lim = (2.0 ** -8 if k == "w" and dt == torch.bfloat16
                   else 1e-6) * big
            if not e <= lim:
                raise AssertionError(f"fused_update {name} {k}: kernel vs "
                                     f"plain max abs error {e:.3g} > "
                                     f"{lim:.3g}")
            err = max(err, e)
        del ref
        ms = _time_ms(lambda: fo.fused_update(spec, **state, **kw), 10,
                      flush)
        plain_ms = _time_ms(lambda: fo.fused_update_plain(
            spec, lr, scale, state["w"], state["g"], state["master"],
            state["m"], state["v"], b1p * 0.9, b2p * 0.999), 3, flush)
        lib_ms = None
        if dt == torch.bfloat16 and clip is None:
            p = torch.nn.Parameter(state["master"].clone())
            p.grad = state["g"].float()
            lib = torch.optim.AdamW([p], lr=1e-4, weight_decay=0.01,
                                    fused=True)
            lib_ms = _time_ms(lib.step, 10, flush)
            del p, lib
        esize = 2 if dt == torch.bfloat16 else 4
        # w read + written, g read, m and v (and master) read + written
        nbytes = n * (3 * esize + (6 if use_master else 4) * 4)
        bound_ms = nbytes / MEM_BYTES_PER_S * 1e3
        row = dict(case=name, n=n, dtype=str(dt).replace("torch.", ""),
                   clip=clip, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
                   library_ms=lib_ms,
                   library="torch.optim.AdamW(fused=True), fp32 params"
                   if lib_ms else None)
        log(f"kernel fused_update {name} n {n} {row['dtype']}: max_abs_err "
            f"{err:.3g}, {ms:.4f} ms (plain {plain_ms:.3f} ms, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
            f"{bound_ms:.4f} ms by bytes, {bound_ms / ms:.1%} of bound) on "
            f"{power}")
        rows.append(row)
        del state, master
        torch.cuda.empty_cache()
    return rows


def train_kernel_phase(seed, power):
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fwd, bwd = flash_cases(seed, power, flush)
    opt = optimizer_cases(seed, power, flush)
    del flush
    torch.cuda.empty_cache()
    return fwd, bwd, opt


# ------------------------------------------------------------- serve --
def jax_layout_gpt_weights(cfg, seed):
    """GPT weights as the JAX package names and lays them out (Linear
    ``[in, out]``), drawn with its init: normal std 0.02, residual
    projections 0.02 / sqrt(2 L), zero biases, unit norms."""
    rng = np.random.default_rng(seed)
    h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    resid = 0.02 / np.sqrt(2 * L)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    w = {"gpt.wte.weight": normal((cfg.vocab_size, h), 0.02),
         "gpt.wpe.weight": normal((cfg.max_seq_len, h), 0.02),
         "gpt.ln_f.weight": np.ones(h, np.float32),
         "gpt.ln_f.bias": np.zeros(h, np.float32)}
    for i in range(L):
        p = f"gpt.block_{i}."
        w.update({
            p + "ln1.weight": np.ones(h, np.float32),
            p + "ln1.bias": np.zeros(h, np.float32),
            p + "attn.qkv.weight": normal((h, 3 * h), 0.02),
            p + "attn.qkv.bias": np.zeros(3 * h, np.float32),
            p + "attn.proj.weight": normal((h, h), resid),
            p + "attn.proj.bias": np.zeros(h, np.float32),
            p + "ln2.weight": np.ones(h, np.float32),
            p + "ln2.bias": np.zeros(h, np.float32),
            p + "mlp.fc1.weight": normal((h, inter), 0.02),
            p + "mlp.fc1.bias": np.zeros(inter, np.float32),
            p + "mlp.fc2.weight": normal((inter, h), resid),
            p + "mlp.fc2.bias": np.zeros(h, np.float32),
        })
    return w


@torch.no_grad()
def teacher_forced_logits(model, ids):
    """Plain fp32 forward over one whole sequence: the same GPT blocks
    with the plain attention version (no kernel), one prefill chunk."""
    from paddle_tpu_torch.models.generation import _gpt_ragged_forward
    from paddle_tpu_torch.ops.cuda.paged_attention import \
        ragged_paged_attention_plain
    dev = model.device
    cfg, ps, qb = model.cfg, 16, 8
    S = len(ids)
    npg = -(-S // ps)
    caches = [torch.zeros(cfg.num_heads, npg + 1, ps, cfg.head_dim,
                          device=dev) for _ in range(2 * cfg.num_layers)]
    bt = torch.arange(1, npg + 1, dtype=torch.int32, device=dev)[None]
    pos = torch.arange(S, device=dev)
    logits, _ = _gpt_ragged_forward(
        model, torch.tensor(ids, device=dev)[None].long(), pos,
        torch.zeros_like(pos), torch.ones_like(pos),
        torch.tensor([S], dtype=torch.int32, device=dev),
        torch.tensor([S], dtype=torch.int32, device=dev), bt, caches, qb,
        attention=ragged_paged_attention_plain)
    return logits


def serve_phase(seed, cfg=None, device="cuda"):
    """Serve 16 requests through the engine and check them. ``cfg``
    defaults to GPT-124M; a smaller one (with ``device="cpu"``)
    rehearses this phase without a card, and without the device-time
    breakdown (:func:`profile_serve`)."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_gpt_from_jax)
    from paddle_tpu_torch.ops.cuda.paged_attention import \
        ragged_paged_attention as rpa

    cfg = GPTConfig() if cfg is None else cfg
    new_tokens = 32
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=device)
    load_gpt_from_jax(model, jax_layout_gpt_weights(cfg, seed))
    log(f"GPT {model.num_params()} params on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s")
    geo = dict(GEO, device=device)
    rng = np.random.default_rng(seed + 1)
    longest = min(512, cfg.max_seq_len - new_tokens)
    prompts = [rng.integers(0, min(cfg.vocab_size, 50257), int(n))
               .astype(np.int32) for n in rng.integers(16, longest + 1, 16)]

    # warm-up on another engine (cuBLAS handles, allocator); it also
    # runs this geometry's first single-step decode
    warm = ContinuousBatchingEngine(model, **geo)
    warm.add_request(prompts[0][:16], 8)
    warm.run()

    eng = ContinuousBatchingEngine(model, **geo)
    rids = [eng.add_request(p, new_tokens) for p in prompts]
    launches = {"mixed": 0, "decode": 0}
    step_ms = {"mixed": [], "decode": []}
    done = {}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    while eng.has_work:
        st = eng.stats
        before = rpa.launches
        ts = time.perf_counter()
        done.update({c.request_id: c for c in eng.step()})
        dt = (time.perf_counter() - ts) * 1e3
        after = eng.stats
        if after["mixed_steps"] > st["mixed_steps"]:
            kind = "mixed"
        elif after["decode_dispatches"] > st["decode_dispatches"]:
            kind = "decode"
        else:
            continue
        launches[kind] += rpa.launches - before
        step_ms[kind].append(dt)
    sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    total_launches = counts["ragged_paged_attention"]
    st = eng.stats

    if sorted(done) != sorted(rids):
        raise AssertionError(f"served {sorted(done)} of {sorted(rids)}")
    for rid in rids:
        c = done[rid]
        if c.finish_reason != "length" or c.tokens.size != new_tokens:
            raise AssertionError(f"request {rid}: {c.finish_reason}, "
                                 f"{c.tokens.size} tokens")
    eng._cache.check()
    if st["pages_in_use"] != 0 or (st["pages_free"] + st["cached_pages"]
                                   != eng.total_pages - 1):
        raise AssertionError(f"page pool not conserved: {st}")
    if device == "cuda" and not (launches["mixed"] > 0
                                 and launches["decode"] > 0):
        raise AssertionError(f"kernel launches by step kind: {launches}")
    gen_tokens = st["tokens_generated"]
    where = torch.cuda.get_device_name(0) if device == "cuda" else device
    log(f"served {len(rids)} requests on {where}, {gen_tokens} tokens in "
        f"{wall:.3f} s = {gen_tokens / wall:.1f} tokens/s; prompt tokens "
        f"{st['prefill_tokens_computed']}; {st['mixed_steps']} mixed "
        f"steps (mean {np.mean(step_ms['mixed']):.2f} ms), "
        f"{len(step_ms['decode'])} decode dispatches (mean "
        f"{np.mean(step_ms['decode']):.2f} ms); kernel launches "
        f"{launches}")
    log(f"stats {json.dumps(st)}")

    # teacher-forced check against a plain fp32 forward
    near_ties = checked = 0
    for rid, p in zip(rids, prompts):
        toks = done[rid].tokens
        seq = np.concatenate([p, toks])
        lg = teacher_forced_logits(model, seq)[p.size - 1:seq.size - 1]
        if not torch.isfinite(lg).all():
            raise AssertionError(f"request {rid}: non-finite logits")
        top2 = lg.topk(2, dim=-1)
        pred = top2.indices[:, 0].cpu().numpy()
        margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
        for i, (t, pr, m) in enumerate(zip(toks, pred, margin)):
            checked += 1
            if t == pr:
                continue
            if m < MARGIN:
                near_ties += 1
                continue
            raise AssertionError(
                f"request {rid} token {i}: served {t}, plain forward "
                f"picks {pr} with top-2 margin {m:.3g}")
    log(f"teacher-forced check: {checked} tokens, {near_ties} near ties "
        f"(top-2 margin < {MARGIN})")
    out = dict(launches=total_launches, counts=counts, by_step=launches,
               wall_s=wall,
               tokens=gen_tokens, tokens_per_s=gen_tokens / wall,
               near_ties=near_ties,
               mixed_step_ms=float(np.mean(step_ms["mixed"])),
               decode_dispatch_ms=float(np.mean(step_ms["decode"])))
    if device == "cuda":
        out["profile"] = profile_serve(model, prompts, new_tokens, geo,
                                       wall)
    return out


def profile_serve(model, prompts, new_tokens, geo, wall):
    """Device time by kernel over one more run of the same requests on a
    fresh engine under ``torch.profiler`` (not the timed run: the
    profiler slows the host). The busy share is the device time over
    ``wall``, the unprofiled run's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, **geo)
    for p in prompts:
        eng.add_request(p, new_tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    return _breakdown(prof, wall * 1e3, prof_wall * 1e3, "the timed run")


def _breakdown(prof, wall_ms, prof_wall_ms, what):
    """Device time by kernel from a profile, and the busy share of
    ``wall_ms`` (an unprofiled run's wall clock)."""
    from torch.autograd import DeviceType
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    log(f"profile: device busy {busy:.3f} ms over {wall_ms:.3f} ms of "
        f"{what} = {busy / wall_ms:.1%} busy (profiled run "
        f"{prof_wall_ms:.3f} ms); {len(kernels)} device kernels/copies, "
        f"{sum(n for *_, n in kernels)} launches")
    for key, ms, n in kernels[:12]:
        log(f"profile:   {ms:9.3f} ms {ms / busy if busy else 0:6.1%} "
            f"x{n:<6d} {key[:100]}")
    return dict(busy_ms=busy, wall_ms=wall_ms, busy_share=busy / wall_ms,
                profiled_wall_ms=prof_wall_ms,
                top=[dict(name=k[:200], ms=ms, count=n)
                     for k, ms, n in kernels[:12]])


# ------------------------------------------------------------- train --
def _batch_fn(cfg, batch, seq, seed):
    """Random ids and labels from numpy, as bench.py makes them."""
    rng = np.random.default_rng(seed)

    def make():
        ids = rng.integers(0, cfg.vocab_size, (batch, seq))
        lab = rng.integers(0, cfg.vocab_size, (batch, seq))
        return ids, lab
    return make


def train_phase(seed, cfg=None, device="cuda", batch=8, seq=1024, warmup=2,
                steps=10, power=""):
    """Train GPT-124M in bench.py's configuration through the Paddle
    entry points and check it. ``cfg``/``device``/``batch``/``seq``
    shrink it to rehearse on the CPU (no launch counts, no profile)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_gpt_from_jax)
    if cfg is None:
        cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                        num_heads=12, max_seq_len=1024, dropout=0.0,
                        recompute=True,
                        recompute_policy="dots_and_kernels_saveable")
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=device)
    load_gpt_from_jax(model, jax_layout_gpt_weights(cfg, seed))
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16", master_weight=True)
    log(f"train: GPT {model.num_params()} params on {model.device}, O2 "
        f"bf16 + fp32 masters, recompute {cfg.recompute_policy}, batch "
        f"{batch} x {seq}, in {time.perf_counter() - t0:.2f} s")
    make = _batch_fn(cfg, batch, seq, seed)

    def to_dev(ids, lab):
        return (torch.from_numpy(ids).to(device),
                torch.from_numpy(lab).to(device))

    def train_step(ids, labels):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = model(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    losses = [train_step(*to_dev(*make())) for _ in range(warmup)]
    sync()
    n_buckets = len(opt._flat or ())
    per_step = []
    batches = [to_dev(*make()) for _ in range(steps)]
    sync()
    reset_counts()
    t0 = time.perf_counter()
    for ids, lab in batches:
        before = read_counts()
        losses.append(train_step(ids, lab))
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    loss_vals = [float(x) for x in losses]

    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"train: non-finite loss in {loss_vals}")
    ln_v = float(np.log(cfg.vocab_size))
    if abs(loss_vals[0] - ln_v) > 0.5:
        raise AssertionError(f"train: first loss {loss_vals[0]:.4f} is not "
                             f"within 0.5 of ln({cfg.vocab_size}) = "
                             f"{ln_v:.4f}")
    if on_card:
        want = {"flash_attention_fwd": cfg.num_layers,
                "flash_attention_bwd": cfg.num_layers,
                "fused_update": n_buckets, "ragged_paged_attention": 0}
        for i, got in enumerate(per_step):
            if got != want:
                raise AssertionError(f"train step {i}: kernel launches "
                                     f"{got}, want {want}")
    with torch.no_grad():
        bad = [n for n, p in model.named_parameters()
               if not torch.isfinite(p).all()]
        bad += [f"master of {tuple(p.shape)}" for p, w in
                opt._master_weights.items() if not torch.isfinite(w).all()]
    if bad:
        raise AssertionError(f"train: non-finite after the last step: "
                             f"{bad[:5]}")
    step_ms = wall / steps * 1e3
    tokens_per_s = batch * seq * steps / wall
    flops_tok = model.flops_per_token(seq)
    # model flops utilisation, a device metric: only from a card run
    mfu = flops_tok * tokens_per_s / BF16_FLOPS_PER_S if on_card else None
    where = torch.cuda.get_device_name(0) if on_card else device
    mfu_txt = f"MFU {mfu:.2%} of 989 TFLOP/s bf16" if on_card else "no MFU"
    log(f"train: {steps} steps on {where} in {wall:.3f} s = {step_ms:.2f} "
        f"ms/step, {tokens_per_s:.1f} tokens/s, {mfu_txt} "
        f"({flops_tok:.4g} flops/token) on {power}; losses "
        f"{[round(x, 4) for x in loss_vals]}; launches {counts}, "
        f"{n_buckets} buckets")
    out = dict(steps=steps, warmup=warmup, batch=batch, seq=seq,
               step_ms=step_ms, tokens_per_s=tokens_per_s, mfu=mfu,
               flops_per_token=flops_tok, losses=loss_vals, counts=counts,
               per_step=per_step[0], buckets=n_buckets,
               bucket_sizes=[g.padded for g in opt._flat or ()],
               peak_mem_gb=(torch.cuda.max_memory_allocated() / 2**30
                            if on_card else None))
    if on_card:
        from torch.profiler import ProfilerActivity, profile
        batch1 = to_dev(*make())
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            train_step(*batch1)
            sync()
            prof_ms = (time.perf_counter() - t1) * 1e3
        out["profile"] = _breakdown(prof, step_ms, prof_ms,
                                    "a timed step (mean)")
        # where the host's time goes (inflated by the profiler itself)
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.self_cpu_time_total > 0), key=lambda r: -r[1])
        for key, ms, n in host[:8]:
            log(f"profile: host {ms:9.3f} ms x{n:<6d} {key[:90]}")
        out["profile"]["host_top"] = [dict(name=k[:200], ms=ms, count=n)
                                      for k, ms, n in host[:8]]
    return out


def train_parity(seed):
    """One fp32 AdamW step on the card (kernels) against a CPU copy
    (plain versions): GPT-124M widths, 2 layers, batch 2 x 256, TF32
    off, no AMP. Tolerances: loss 1e-4; each grad within 1e-4 of its
    largest magnitude; each updated parameter within 1e-6 where the
    reference grad is at least 1e-5 (there Adam's first step,
    lr * g / (|g| + eps), does not hang on the grad's last bits) and
    within 2 lr elsewhere."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_gpt_from_jax)
    cfg = GPTConfig(num_layers=2, recompute=True,
                    recompute_policy="dots_and_kernels_saveable")
    lr = 1e-4
    weights = jax_layout_gpt_weights(cfg, seed + 3)
    ids, lab = _batch_fn(cfg, 2, 256, seed + 4)()
    res = {}
    for dev in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=dev)
        load_gpt_from_jax(model, weights)
        opt = optimizer.AdamW(learning_rate=lr,
                              parameters=model.parameters())
        if dev == "cuda":
            reset_counts()
        loss = model(torch.from_numpy(ids).to(dev),
                     torch.from_numpy(lab).to(dev))
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        opt.step()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
        res[dev] = (float(loss.detach()), grads,
                    {n: p.detach().cpu() for n, p in model.named_parameters()})
        del model, opt
    want = {"flash_attention_fwd": 2, "flash_attention_bwd": 2,
            "fused_update": 1, "ragged_paged_attention": 0}
    if counts != want:
        raise AssertionError(f"train parity: card step launched {counts}, "
                             f"want {want}")
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = res["cuda"], res["cpu"]
    loss_err = abs(l_gpu - l_cpu)
    grad_err = param_err = param_err_small = 0.0
    for n, g in g_cpu.items():
        e = float((g_gpu[n] - g).abs().max())
        lim = 1e-4 * float(g.abs().max()) + 1e-12
        if not e <= lim:
            raise AssertionError(f"train parity: grad {n} max abs error "
                                 f"{e:.3g} > {lim:.3g}")
        grad_err = max(grad_err, e / (float(g.abs().max()) + 1e-12))
        d = (p_gpu[n] - p_cpu[n]).abs()
        big = g.abs() >= 1e-5
        e_big = float(d[big].max()) if big.any() else 0.0
        e_small = float(d[~big].max()) if (~big).any() else 0.0
        if not (e_big <= 1e-6 and e_small <= 2 * lr):
            raise AssertionError(f"train parity: param {n} max abs error "
                                 f"{e_big:.3g} (|g| >= 1e-5) / {e_small:.3g}"
                                 f" (elsewhere)")
        param_err = max(param_err, e_big)
        param_err_small = max(param_err_small, e_small)
    if not loss_err <= 1e-4:
        raise AssertionError(f"train parity: loss {l_gpu} (card) vs "
                             f"{l_cpu} (cpu)")
    log(f"train parity: loss {l_gpu:.6f} (card) vs {l_cpu:.6f} (cpu), "
        f"err {loss_err:.3g}; grads max err {grad_err:.3g} of each grad's "
        f"largest value; params max err {param_err:.3g} where |g| >= 1e-5, "
        f"{param_err_small:.3g} elsewhere; card launches {counts}")
    return dict(loss_card=l_gpu, loss_cpu=l_cpu, loss_err=loss_err,
                grad_rel_err=grad_err, param_err=param_err,
                param_err_small_grad=param_err_small, counts=counts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    name, count, smi_line = header()
    build_s = build()
    rows = kernel_phase(args.seed, smi_line)
    fwd_rows, bwd_rows, opt_rows = train_kernel_phase(args.seed, smi_line)
    serve = serve_phase(args.seed)
    train = train_phase(args.seed, power=smi_line)
    parity = train_parity(args.seed)
    print(json.dumps({"train": train, "train_parity": parity,
                      "build_s": build_s, "power": smi_line}), flush=True)
    src = "paddle_tpu_torch/ops/cuda/csrc/"
    specs = [
        ("ragged_paged_attention", "paged_attention.cu",
         "paddle_tpu/ops/pallas/paged_attention.py:155", rows,
         serve["launches"]),
        ("flash_attention_fwd", "flash_attention.cu",
         "paddle_tpu/ops/pallas/flash_attention.py:80", fwd_rows,
         train["counts"]["flash_attention_fwd"]),
        ("flash_attention_bwd", "flash_attention.cu",
         "paddle_tpu/ops/pallas/flash_attention.py:206", bwd_rows,
         train["counts"]["flash_attention_bwd"]),
        ("fused_update", "fused_optimizer.cu",
         "paddle_tpu/ops/pallas/fused_optimizer.py:121", opt_rows,
         train["counts"]["fused_update"]),
    ]
    out = []
    for kname, source, replaces, cases, launches in specs:
        if launches <= 0:
            raise AssertionError(f"{kname}: no launch on its main path")
        main_row = cases[0]
        out.append({
            "name": kname, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row.get("library_ms"),
            "shape": main_row["case"], "cases": cases})
    print(json.dumps({"kernels": out, "serve": serve, "power": smi_line}),
          flush=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
