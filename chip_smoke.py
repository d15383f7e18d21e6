"""Drive the PyTorch port's serving and training paths once on a CUDA
card.

    python3 chip_smoke.py [--seed N]

1. Header: the card, its power limit (nvidia-smi), TF32 off, and the
   build of every CUDA source in ``paddle_tpu_torch/ops/cuda/csrc``
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
     unbound views of a packed qkv), an fp32 case with Sq != Sk, a
     GQA case (Hq 32, Hk 8, D 128, S 512, bf16) and the LLaMA train
     phase's shape (``[2, 2048, 32, 128]`` bf16 causal): fp32 within
     2e-5 (o, lse) and 1e-4 (grads); bf16 within one bf16 rounding of
     the plain version run in fp32 on the same bf16 inputs;
   * ``fused_update`` (AdamW, lr 1e-4, decay 0.01) on GPT-124M's O2
     buckets (124,437,504 bf16 params with fp32 masters; 38,912 fp32
     LayerNorm params, padded), the bf16 bucket with a clip scale and
     the LLaMA train phase's bucket (1,071,681,536 bf16 params):
     fp32 state within 1e-6 of its largest value, bf16 weights within
     one bf16 rounding;
   * ``fused_decode_qkv``, ``fused_decode_mlp`` and
     ``fused_decode_epilogue`` at the megakernel serve phase's shapes
     (x ``[8, 768]``, pools ``[12, 513, 16, 64]``, tables ``[8, 64]``,
     the tied embedding ``[50304, 768]``): values within 2e-5, tokens and
     bad flags equal except on near ties, a NaN-poisoned row bad with
     token 0; each beside the unfused eager chain it replaces;
   * ``rope`` at the LLaMA train phase's q ``[2, 2048, 32, 128]`` bf16
     with ``[2048, 128]`` half-pairing tables, forward and the
     backward's -sin launch, plus interleaved pairing, per-batch
     ``[2, 2048, 128]`` tables and fp32; ``fused_residual_rms_norm_fwd``
     / ``_bwd`` at its rows (``[4096, 4096]`` bf16), fp32 and 4093 rows:
     bf16 within one bf16 rounding of the plain version run in fp32 on
     the same inputs, fp32 within 1e-5 (dw within 1e-5 of its column's
     sum of magnitudes); each beside the unfused eager chain it replaces.
3. Serve phase: GPT-124M (``GPTConfig()`` defaults, weights drawn from
   the seed in the JAX package's layout and init) behind
   ``ContinuousBatchingEngine`` serves 16 requests (prompts 16-512
   tokens, 32 new tokens each). Every request must finish by length,
   the page pool must be conserved, and every dispatch must launch the
   attention kernel once per layer per step. A teacher-forced plain
   fp32 forward must pick every served token, except where its top-2
   margin is below 1e-4 (a near tie). One more run under
   ``torch.profiler`` breaks the device time down by kernel, and one
   profiled decode window counts the device launches per decode step.
   The megakernel serve phase then serves the same requests with
   ``megakernel=True`` under the same checks; every decode step (the
   warm-up's single step and each step of a window) must launch
   ``fused_decode_qkv``, the attention and ``fused_decode_mlp`` once per
   layer and ``fused_decode_epilogue`` once.
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
6. LLaMA train phase: LLaMA-7B widths (vocab 32000, hidden 4096, 32
   heads of 128, intermediate 11008) at 4 layers, batch 2 x 2048,
   recompute ``dots_and_kernels_saveable``, AdamW lr 1e-4, O2 bf16 with
   fp32 masters, weights drawn from the seed in the JAX package's layout
   and init; run with ``train_glue_fusion`` off, then on: 2 warm-up and
   5 timed steps each (step ms, tokens/s, MFU), every step launching the
   flash forward and backward once per layer, rope 4 times per layer,
   the fused residual + RMSNorm forward and backward 2 L times each with
   glue on (none with it off) and the fused update once per bucket;
   losses finite, the first within 0.5 of the init's expected loss, the
   two runs' first losses within 1e-2; one profiled step each.
7. LLaMA parity: one fp32 AdamW step with glue on (LLaMA-7B widths, 1
   layer, batch 1 x 256) on the card against a CPU copy.
8. Prints the ``train`` JSON line, the ``kernels`` JSON line (ten
   kernels, with both serve phases), then
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
SPIN_CYCLES = 2_000_000      # ~1 ms at the H100's ~2 GHz clock


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
                                           fused_decode_mlp, fused_decode_qkv,
                                           fused_optimizer, fused_residual_norm,
                                           paged_attention, rope)
    t0 = time.perf_counter()
    libs = _build.build_all()
    paged_attention._kernel()           # load + bind
    flash_attention._kernels()
    fused_optimizer._kernel()
    fused_decode_qkv._kernel()
    fused_decode_mlp._kernels()
    rope._kernel()
    fused_residual_norm._kernels()
    secs = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {secs:.2f} s")
    return secs


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from paddle_tpu_torch.ops.cuda import (flash_attention, fused_decode_mlp,
                                           fused_decode_qkv, fused_optimizer,
                                           fused_residual_norm,
                                           paged_attention, rope)
    return {"ragged_paged_attention": paged_attention.ragged_paged_attention,
            "flash_attention_fwd": flash_attention.flash_attention_fwd,
            "flash_attention_bwd": flash_attention.flash_attention_bwd,
            "fused_update": fused_optimizer.fused_update,
            "fused_decode_qkv": fused_decode_qkv.fused_decode_qkv,
            "fused_decode_mlp": fused_decode_mlp.fused_decode_mlp,
            "fused_decode_epilogue": fused_decode_mlp.fused_decode_epilogue,
            "rope": rope.rope,
            "fused_residual_rms_norm_fwd":
                fused_residual_norm.fused_residual_rms_norm_fwd,
            "fused_residual_rms_norm_bwd":
                fused_residual_norm.fused_residual_rms_norm_bwd}


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


def _time_ms(fn, n, flush, spin=False):
    """Mean device time of ``fn`` over ``n`` calls, each after an L2
    flush (a 256 MB write), each between its own pair of CUDA events.
    With ``spin``, a device spin of ~1 ms (SPIN_CYCLES) after the flush
    keeps the card busy while the host enqueues the start event and
    ``fn``'s launches, so the events time the device's work, not the
    host's enqueue (a ``fn`` that waits on the device, or whose host side
    outlasts the spin, still counts its host time)."""
    for _ in range(3):
        fn()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for s, e in evs:
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
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
def _bf16_err(got, ref, roundings=1):
    """(max abs error, limit): ``roundings`` bf16 roundings of the largest
    reference value, plus 1e-4 for the fp32 summation order."""
    err = float((got.float() - ref.float()).abs().max())
    return err, roundings * 2.0 ** -8 * float(ref.float().abs().max()) + 1e-4


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
        # the LLaMA train phase's shape (q and k from rope, contiguous)
        ("llama7b_train", 2, 2048, 2048, 32, 32, 128, True, torch.bfloat16),
    ]
    fwd_rows, bwd_rows = [], []
    for name, b, sq, sk, hq, hk, d, causal, dt in cases:
        if name == "gpt124m_train":   # the unbound views of a packed qkv
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
    version on the GPT-124M O2 buckets and the LLaMA train phase's
    bucket, and the library's fused AdamW over fp32 params of each bf16
    bucket's size (which computes the update without the bf16 copy)."""
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    cases = [("gpt124m_o2_bf16_master", 124_437_504, torch.bfloat16, None),
             ("gpt124m_o2_f32_layernorm", 38_912, torch.float32, None),
             ("gpt124m_o2_bf16_master_clip", 124_437_504, torch.bfloat16,
              0.37),
             # the LLaMA train phase's one bucket (4 layers at 7B widths)
             ("llama7b_4l_o2_bf16_master", 1_071_681_536, torch.bfloat16,
              None)]
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


# ------------------------------------------------------ decode kernels --
def _fp32_bound(nbytes, flops):
    """(least ms, what bounds it): the bytes at the HBM rate or the fp32
    flops at the CUDA-core rate, whichever takes longer."""
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"


def _pick_err(name, nxt, bad, ref_nxt, ref_bad, ref_lg):
    """Tokens and bad flags must equal the plain version's, except where
    the plain logits of the two picks are within MARGIN (a near tie)."""
    if not torch.equal(bad, ref_bad):
        raise AssertionError(f"{name}: bad {bad.tolist()} != plain "
                             f"{ref_bad.tolist()}")
    ties = 0
    for r in torch.nonzero(nxt != ref_nxt).flatten().tolist():
        gap = float((ref_lg[r, ref_nxt[r]] - ref_lg[r, nxt[r]]).abs())
        if bad[r] or gap >= MARGIN:
            raise AssertionError(f"{name} row {r}: kernel picks "
                                 f"{int(nxt[r])}, plain {int(ref_nxt[r])} "
                                 f"(logit gap {gap:.3g})")
        ties += 1
    return ties


def decode_kernel_phase(seed, power):
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = decode_kernel_cases(seed, power, flush)
    del flush
    torch.cuda.empty_cache()
    return rows


def decode_kernel_cases(seed, power, flush):
    """The three fused decode kernels against their plain versions at the
    megakernel serve phase's shapes (GPT-124M, ``GEO``): x ``[8, 768]``,
    pools ``[12, 513, 16, 64]``, tables ``[8, 64]``, the tied embedding
    ``[50304, 768]``. Each row also times the unfused eager chain the
    kernel replaces on the unfused decode path (``unfused_ms``); no single
    library call computes any of these functions (``library_ms`` null).
    All are timed with the device spin of :func:`_time_ms`: a chain's
    launches then run back to back, so ``unfused_ms`` is its device time.
    Values within TOL of the plain version; tokens and bad flags equal
    except on near ties (one epilogue check poisons a row with NaN)."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.models.generation import (_slot_page_write,
                                                    guarded_argmax)
    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    from paddle_tpu_torch.ops.cuda import fused_decode_qkv as fq
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    rng = np.random.default_rng(seed + 5)
    B, ps = GEO["max_slots"], GEO["page_size"]
    H, nh, hd, V, L = 768, 12, 64, 50304, 12
    inter, NP, eps = 4 * H, 1024 // ps, 1e-5
    P = 1 + B * NP
    resid = 0.02 / np.sqrt(2 * L)

    def timed(fn, n):
        return _time_ms(fn, n, flush, spin=True)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    x, att = rn(B, H), rn(B, H)
    ln_w, ln_b = 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    pos = torch.tensor(rng.integers(0, 1024, B), device=dev)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        seed + 5)) + 1
    bt = perm[:B * NP].reshape(B, NP).to(torch.int32).to(dev)
    k0, v0 = rn(nh, P, ps, hd), rn(nh, P, ps, hd)

    def finish(name, err, ms, plain_ms, unfused_ms, nbytes, flops, shape):
        bound_ms, bound_by = _fp32_bound(nbytes, flops)
        row = dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   unfused_ms=unfused_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, flops=flops,
                   library_ms=None, library="none: no single call",
                   shape=shape)
        log(f"kernel {name} {shape}: max_abs_err {err:.3g}, {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, unfused chain {unfused_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of "
            f"bound) on {power}")
        return row

    # ingress: LayerNorm + fused QKV + paged append
    w, b = rn(3 * H, H, std=0.02), rn(3 * H, std=0.02)
    kw = dict(eps=eps, n_heads=nh, n_kv_heads=nh, head_dim=hd)
    kk, vk, kp, vp = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    q, _, _ = fq.fused_decode_qkv(x, ln_w, ln_b, w, b, pos, bt, kk, vk, **kw)
    rq, _, _ = fq.fused_decode_qkv_plain(x, ln_w, ln_b, w, b, pos, bt, kp,
                                         vp, **kw)
    torch.cuda.synchronize()
    err = max(float((q - rq).abs().max()), float((kk - kp).abs().max()),
              float((vk - vp).abs().max()))
    if not err <= TOL:
        raise AssertionError(f"fused_decode_qkv: kernel vs plain max abs "
                             f"error {err:.3g} > {TOL}")

    def unfused_qkv():
        h = tF.layer_norm(x, (H,), ln_w, ln_b, eps)
        qkv = tF.linear(h, w, b).reshape(B, 1, 3, nh, hd)
        _, k, v = qkv.unbind(2)
        _slot_page_write(k[:, 0].transpose(0, 1), v[:, 0].transpose(0, 1),
                         kp, vp, bt, pos)

    n_out = 3 * H
    ms = timed(lambda: fq.fused_decode_qkv(x, ln_w, ln_b, w, b, pos, bt, kk,
                                           vk, **kw), 50)
    plain_ms = timed(lambda: fq.fused_decode_qkv_plain(
        x, ln_w, ln_b, w, b, pos, bt, kp, vp, **kw), 10)
    # W and its bias, x, the norm's w and b read; q, K and V written;
    # positions and one table entry per row read
    qkv_row = finish(
        "gpt124m_decode", err, ms, plain_ms, timed(unfused_qkv, 20),
        4 * (n_out * H + n_out + B * H + 2 * H + B * n_out) + 8 * B + 4 * B,
        2 * B * n_out * H + 8 * B * H,
        dict(x=[B, H], w=[n_out, H], pools=list(k0.shape),
             tables=list(bt.shape)))
    del kk, vk, kp, vp, w, b

    # egress: out-proj + residual + LayerNorm + fc1 + GELU + fc2 + residual
    wo, bo = rn(H, H, std=resid), rn(H, std=0.02)
    w1, b1 = rn(inter, H, std=0.02), rn(inter, std=0.02)
    w2, b2 = rn(H, inter, std=resid), rn(H, std=0.02)
    margs = (x, att, wo, bo, ln_w, ln_b, w1, b1, w2, b2)
    out = fm.fused_decode_mlp(*margs, eps=eps)
    ref = fm.fused_decode_mlp_plain(*margs, eps=eps)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not err <= TOL:
        raise AssertionError(f"fused_decode_mlp: kernel vs plain max abs "
                             f"error {err:.3g} > {TOL}")

    def unfused_mlp():
        y = x + tF.linear(att, wo, bo)
        h = tF.layer_norm(y, (H,), ln_w, ln_b, eps)
        return y + tF.linear(tF.gelu(tF.linear(h, w1, b1),
                                     approximate="tanh"), w2, b2)

    # the three weights and their biases, the norm's w and b, x and att
    # read, the output written
    mlp_row = finish(
        "gpt124m_decode", err,
        timed(lambda: fm.fused_decode_mlp(*margs, eps=eps), 50),
        timed(lambda: fm.fused_decode_mlp_plain(*margs, eps=eps), 10),
        timed(unfused_mlp, 20),
        4 * (H * H + 2 * inter * H + inter + 2 * H + 2 * H + 3 * B * H),
        2 * B * (H * H + 2 * inter * H) + 20 * B * inter,
        dict(x=[B, H], wo=[H, H], w1=[inter, H], w2=[H, inter]))
    del wo, w1, w2, margs

    # epilogue: final LayerNorm + tied LM head + guarded argmax
    wte = rn(V, H, std=0.02)
    zero = torch.zeros(B, device=dev)
    lg, nxt, bad = fm.fused_decode_epilogue(x, ln_w, ln_b, wte, None, zero,
                                            eps=eps, transpose_lm=True)
    rlg, rnxt, rbad = fm.fused_decode_epilogue_plain(
        x, ln_w, ln_b, wte, None, zero, eps=eps, transpose_lm=True)
    torch.cuda.synchronize()
    err = float((lg - rlg).abs().max())
    if not err <= TOL:
        raise AssertionError(f"fused_decode_epilogue: kernel vs plain max "
                             f"abs error {err:.3g} > {TOL}")
    ties = _pick_err("fused_decode_epilogue", nxt, bad, rnxt, rbad, rlg)
    poison = zero.clone()
    poison[2] = float("nan")
    _, pn, pb = fm.fused_decode_epilogue(x, ln_w, ln_b, wte, None, poison,
                                         eps=eps, transpose_lm=True)
    if pb.tolist() != [r == 2 for r in range(B)] or int(pn[2]) != 0 \
            or not torch.equal(pn[pb.logical_not()], nxt[pb.logical_not()]):
        raise AssertionError(f"fused_decode_epilogue poison drill: nxt "
                             f"{pn.tolist()}, bad {pb.tolist()}")

    def unfused_epilogue():
        h = tF.layer_norm(x, (H,), ln_w, ln_b, eps)
        return guarded_argmax(h @ wte.t(), zero)

    ekw = dict(eps=eps, transpose_lm=True)
    # the embedding, x, the norm's w and b and the poison lane read; the
    # logits, nxt (int64) and bad (bool) written
    epi_row = finish(
        "gpt124m_decode", err,
        timed(lambda: fm.fused_decode_epilogue(x, ln_w, ln_b, wte, None,
                                               zero, **ekw), 20),
        timed(lambda: fm.fused_decode_epilogue_plain(x, ln_w, ln_b, wte,
                                                     None, zero, **ekw), 10),
        timed(unfused_epilogue, 10),
        4 * (V * H + B * H + 2 * H + B + B * V) + 9 * B,
        2 * B * V * H + 8 * B * H,
        dict(x=[B, H], w_lm=[V, H], near_ties=ties))
    del wte, k0, v0
    torch.cuda.empty_cache()
    return {"fused_decode_qkv": [qkv_row], "fused_decode_mlp": [mlp_row],
            "fused_decode_epilogue": [epi_row]}


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


def serve_model(seed, cfg=None, device="cuda"):
    """GPT-124M (or ``cfg``) with random weights drawn from the seed in
    the JAX package's layout and init."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_gpt_from_jax)
    cfg = GPTConfig() if cfg is None else cfg
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=device)
    load_gpt_from_jax(model, jax_layout_gpt_weights(cfg, seed))
    log(f"GPT {model.num_params()} params on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


NEW_TOKENS = 32


def serve_prompts(seed, cfg):
    """The serve phases' 16 prompts, 16-512 tokens, from the seed."""
    rng = np.random.default_rng(seed + 1)
    longest = min(512, cfg.max_seq_len - NEW_TOKENS)
    return [rng.integers(0, min(cfg.vocab_size, 50257), int(n))
            .astype(np.int32) for n in rng.integers(16, longest + 1, 16)]


def serve_turns(model, seed, order=(False, True, True, False)):
    """The two decode paths compared in turns on one card: timed runs of
    the serve phases' requests on fresh engines (both geometries already
    bootstrapped by their phases), unfused, megakernel, megakernel,
    unfused. Per run: tokens/s, mean mixed step and decode dispatch ms."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    prompts = serve_prompts(seed, model.cfg)
    runs = []
    for mk in order:
        eng = ContinuousBatchingEngine(model, **GEO, megakernel=mk)
        for p in prompts:
            eng.add_request(p, NEW_TOKENS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, step_ms = _drive(eng, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(megakernel=mk, wall_s=wall,
                         tokens_per_s=eng.stats["tokens_generated"] / wall,
                         mixed_step_ms=float(np.mean(step_ms["mixed"])),
                         decode_dispatch_ms=float(np.mean(step_ms["decode"]))))
    log("serve in turns (unfused, megakernel, megakernel, unfused): "
        + "; ".join(f"{r['tokens_per_s']:.1f} tokens/s, mixed "
                    f"{r['mixed_step_ms']:.2f} ms, decode "
                    f"{r['decode_dispatch_ms']:.2f} ms" for r in runs))
    return runs


def _drive(eng, on_card):
    """Step ``eng`` to the drain. Per dispatch, the kernel launches must be
    what the path makes: a mixed step launches the attention once per
    layer and no fused decode kernel; a decode step (the bootstrap's one,
    or each of a window's ``decode_window``) launches the attention once
    per layer and, with ``megakernel``, ``fused_decode_qkv`` and
    ``fused_decode_mlp`` once per layer and ``fused_decode_epilogue``
    once, else none of them. Returns (completions, launches by dispatch
    kind, host ms by kind)."""
    L = eng.model.cfg.num_layers
    fused = ("fused_decode_qkv", "fused_decode_mlp", "fused_decode_epilogue")
    launches = {"mixed": dict.fromkeys(counters(), 0),
                "decode": dict.fromkeys(counters(), 0)}
    step_ms = {"mixed": [], "decode": []}
    done = {}
    while eng.has_work:
        st = eng.stats
        single = eng._geometry() not in eng._decoded_geometries()
        before = read_counts()
        ts = time.perf_counter()
        done.update({c.request_id: c for c in eng.step()})
        dt = (time.perf_counter() - ts) * 1e3
        after = read_counts()
        got = {k: after[k] - before[k] for k in after}
        if eng.stats["mixed_steps"] > st["mixed_steps"]:
            kind, want = "mixed", {"ragged_paged_attention": L}
        elif eng.stats["decode_dispatches"] > st["decode_dispatches"]:
            kind = "decode"
            k = 1 if single else eng.decode_window
            want = {"ragged_paged_attention": L * k}
            if eng.megakernel:
                want.update(fused_decode_qkv=L * k, fused_decode_mlp=L * k,
                            fused_decode_epilogue=k)
        else:
            continue
        want = {n: want.get(n, 0) for n in ("ragged_paged_attention",)
                + fused}
        if on_card and {n: got[n] for n in want} != want:
            raise AssertionError(f"{kind} dispatch (single step: {single}) "
                                 f"launched {got}, want {want}")
        for n, v in got.items():
            launches[kind][n] += v
        step_ms[kind].append(dt)
    return done, launches, step_ms


def serve_phase(seed, cfg=None, device="cuda", megakernel=False, model=None):
    """Serve 16 requests through the engine and check them, with the
    decode path unfused or (``megakernel``) fused. ``cfg`` defaults to
    GPT-124M; a smaller one (with ``device="cpu"``) rehearses this phase
    without a card, and without launch checks or the device-time
    breakdown (:func:`profile_serve`). ``model`` reuses a model from
    :func:`serve_model`."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    model = serve_model(seed, cfg, device) if model is None else model
    on_card = device == "cuda"
    tag = "megakernel serve" if megakernel else "serve"
    geo = dict(GEO, device=device, megakernel=megakernel)
    prompts = serve_prompts(seed, model.cfg)

    # warm-up on another engine (cuBLAS handles, allocator); it also
    # runs this geometry's first single-step decode (the geometry
    # includes the megakernel switch)
    warm = ContinuousBatchingEngine(model, **geo)
    warm.add_request(prompts[0][:16], 8)
    _drive(warm, on_card)

    eng = ContinuousBatchingEngine(model, **geo)
    rids = [eng.add_request(p, NEW_TOKENS) for p in prompts]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    done, by_step, step_ms = _drive(eng, on_card)
    sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    st = eng.stats

    if sorted(done) != sorted(rids):
        raise AssertionError(f"served {sorted(done)} of {sorted(rids)}")
    for rid in rids:
        c = done[rid]
        if c.finish_reason != "length" or c.tokens.size != NEW_TOKENS:
            raise AssertionError(f"request {rid}: {c.finish_reason}, "
                                 f"{c.tokens.size} tokens")
    eng._cache.check()
    if st["pages_in_use"] != 0 or (st["pages_free"] + st["cached_pages"]
                                   != eng.total_pages - 1):
        raise AssertionError(f"page pool not conserved: {st}")
    if on_card and not (by_step["mixed"]["ragged_paged_attention"] > 0
                        and by_step["decode"]["ragged_paged_attention"] > 0):
        raise AssertionError(f"kernel launches by step kind: {by_step}")
    gen_tokens = st["tokens_generated"]
    where = torch.cuda.get_device_name(0) if on_card else device
    log(f"{tag}: {len(rids)} requests on {where}, {gen_tokens} tokens in "
        f"{wall:.3f} s = {gen_tokens / wall:.1f} tokens/s; prompt tokens "
        f"{st['prefill_tokens_computed']}; {st['mixed_steps']} mixed "
        f"steps (mean {np.mean(step_ms['mixed']):.2f} ms), "
        f"{len(step_ms['decode'])} decode dispatches (mean "
        f"{np.mean(step_ms['decode']):.2f} ms); kernel launches {counts}")
    log(f"{tag}: stats {json.dumps(st)}")

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
    log(f"{tag}: teacher-forced check: {checked} tokens, {near_ties} near "
        f"ties (top-2 margin < {MARGIN})")
    out = dict(megakernel=megakernel,
               launches=counts["ragged_paged_attention"], counts=counts,
               by_step=by_step, wall_s=wall, tokens=gen_tokens,
               tokens_per_s=gen_tokens / wall, near_ties=near_ties,
               mixed_step_ms=float(np.mean(step_ms["mixed"])),
               decode_dispatch_ms=float(np.mean(step_ms["decode"])),
               decode_dispatches=len(step_ms["decode"]))
    if on_card:
        out["profile"] = profile_serve(model, prompts, NEW_TOKENS, geo,
                                       wall)
        out["window"] = profile_window(model, prompts, NEW_TOKENS, geo)
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


def profile_window(model, prompts, new_tokens, geo):
    """Device launches and device ms of ONE decode window with every slot
    decoding: a fresh engine takes the first ``max_slots`` requests
    through their prefill, then one ``step()`` (a window of
    ``decode_window`` steps) runs under ``torch.profiler``. Its host wall
    clock is timed in a second window without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, **geo)
    for p in prompts[:eng.max_slots]:
        eng.add_request(p, new_tokens)
    while eng._queue or any(s.phase == "prefill" for s in eng._slots):
        eng.step()
    k = eng.decode_window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    n = sum(e.count for e in evs)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    log(f"decode window ({'megakernel' if geo['megakernel'] else 'unfused'},"
        f" {k} steps, {eng.max_slots} slots): {n} device launches = "
        f"{n / k:.1f} per decode step, device {dev_ms:.3f} ms = "
        f"{dev_ms / k:.4f} ms per step; unprofiled window {host_ms:.3f} ms "
        f"of wall clock = {host_ms / k:.4f} ms per step, device busy "
        f"{dev_ms / host_ms:.1%}")
    return dict(steps=k, device_launches=n, launches_per_step=n / k,
                device_ms=dev_ms, device_ms_per_step=dev_ms / k,
                wall_ms=host_ms, wall_ms_per_step=host_ms / k,
                busy_share=dev_ms / host_ms)


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


def train_run(model, cfg, seed, device, batch, seq, warmup, steps, want,
              first_loss, tag, power):
    """Train ``model`` (training mode, weights loaded) through the Paddle
    entry points: AdamW lr 1e-4 under ``amp.decorate`` O2 bf16 with fp32
    master weights and ``auto_cast`` O2, ``warmup`` steps then ``steps``
    timed steps on numpy batches from the seed, and check it: on the card
    every timed step launches exactly ``want`` (by kernel name, the rest
    0) and the fused update once per bucket; every loss finite, the first
    within 0.5 of ``first_loss``; every parameter and master finite after
    the last step. On the card one more step runs under
    ``torch.profiler``. Returns the phase's numbers."""
    from paddle_tpu_torch import amp, optimizer
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16", master_weight=True)
    log(f"{tag}: {model.num_params()} params on {model.device}, O2 bf16 + "
        f"fp32 masters, recompute {cfg.recompute_policy}, batch {batch} x "
        f"{seq}")
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

    if on_card:
        torch.cuda.reset_peak_memory_stats()
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
        raise AssertionError(f"{tag}: non-finite loss in {loss_vals}")
    if abs(loss_vals[0] - first_loss) > 0.5:
        raise AssertionError(f"{tag}: first loss {loss_vals[0]:.4f} is not "
                             f"within 0.5 of {first_loss:.4f}")
    if on_card:
        full = dict.fromkeys(counters(), 0)
        full.update(want, fused_update=n_buckets)
        for i, got in enumerate(per_step):
            if got != full:
                raise AssertionError(f"{tag} step {i}: kernel launches "
                                     f"{got}, want {full}")
    with torch.no_grad():
        bad = [n for n, p in model.named_parameters()
               if not torch.isfinite(p).all()]
        bad += [f"master of {tuple(p.shape)}" for p, w in
                opt._master_weights.items() if not torch.isfinite(w).all()]
    if bad:
        raise AssertionError(f"{tag}: non-finite after the last step: "
                             f"{bad[:5]}")
    step_ms = wall / steps * 1e3
    tokens_per_s = batch * seq * steps / wall
    flops_tok = model.flops_per_token(seq)
    # model flops utilisation, a device metric: only from a card run
    mfu = flops_tok * tokens_per_s / BF16_FLOPS_PER_S if on_card else None
    where = torch.cuda.get_device_name(0) if on_card else device
    mfu_txt = f"MFU {mfu:.2%} of 989 TFLOP/s bf16" if on_card else "no MFU"
    log(f"{tag}: {steps} steps on {where} in {wall:.3f} s = {step_ms:.2f} "
        f"ms/step, {tokens_per_s:.1f} tokens/s, {mfu_txt} "
        f"({flops_tok:.4g} flops/token) on {power}; losses "
        f"{[round(x, 4) for x in loss_vals]}; launches {counts}, "
        f"{n_buckets} buckets")
    out = dict(params=model.num_params(), steps=steps, warmup=warmup,
               batch=batch, seq=seq, step_ms=step_ms,
               tokens_per_s=tokens_per_s, mfu=mfu, flops_per_token=flops_tok,
               losses=loss_vals, first_loss_target=first_loss,
               counts=counts, per_step=per_step[0], buckets=n_buckets,
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
    del model, opt
    if on_card:
        torch.cuda.empty_cache()
    return out


def train_phase(seed, cfg=None, device="cuda", batch=8, seq=1024, warmup=2,
                steps=10, power=""):
    """Train GPT-124M in bench.py's configuration through the Paddle
    entry points (:func:`train_run`): the flash forward and backward once
    per layer a step, the first loss within 0.5 of ln(vocab).
    ``cfg``/``device``/``batch``/``seq`` shrink it to rehearse on the
    CPU (no launch counts, no profile)."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_gpt_from_jax)
    if cfg is None:
        cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                        num_heads=12, max_seq_len=1024, dropout=0.0,
                        recompute=True,
                        recompute_policy="dots_and_kernels_saveable")
    model = GPTForCausalLM(cfg, device=device)
    load_gpt_from_jax(model, jax_layout_gpt_weights(cfg, seed))
    L = cfg.num_layers
    return train_run(model, cfg, seed, device, batch, seq, warmup, steps,
                     dict(flash_attention_fwd=L, flash_attention_bwd=L),
                     float(np.log(cfg.vocab_size)), "train: GPT", power)


def parity_step(make_model, ids, lab, lr, want, tag):
    """One fp32 AdamW step of ``make_model(device)`` on the card (kernels)
    against the same step of a CPU copy (plain versions), TF32 off, no
    AMP. The card step must launch exactly ``want`` (by kernel name, the
    rest 0). Tolerances: loss 1e-4; each grad within 1e-4 of its largest
    magnitude; each updated parameter within 1e-6 where the reference
    grad is at least 1e-5 (there Adam's first step, lr * g / (|g| +
    eps), does not hang on the grad's last bits) and within 2 lr
    elsewhere."""
    from paddle_tpu_torch import optimizer
    res, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = make_model(dev)
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
        secs[dev] = time.perf_counter() - t0
        del model, opt
    torch.cuda.empty_cache()
    full = dict.fromkeys(counters(), 0)
    full.update(want)
    if counts != full:
        raise AssertionError(f"{tag}: card step launched {counts}, want "
                             f"{full}")
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = res["cuda"], res["cpu"]
    loss_err = abs(l_gpu - l_cpu)
    grad_err = param_err = param_err_small = 0.0
    for n, g in g_cpu.items():
        e = float((g_gpu[n] - g).abs().max())
        lim = 1e-4 * float(g.abs().max()) + 1e-12
        if not e <= lim:
            raise AssertionError(f"{tag}: grad {n} max abs error {e:.3g} > "
                                 f"{lim:.3g}")
        grad_err = max(grad_err, e / (float(g.abs().max()) + 1e-12))
        d = (p_gpu[n] - p_cpu[n]).abs()
        big = g.abs() >= 1e-5
        e_big = float(d[big].max()) if big.any() else 0.0
        e_small = float(d[~big].max()) if (~big).any() else 0.0
        if not (e_big <= 1e-6 and e_small <= 2 * lr):
            raise AssertionError(f"{tag}: param {n} max abs error "
                                 f"{e_big:.3g} (|g| >= 1e-5) / {e_small:.3g}"
                                 f" (elsewhere)")
        param_err = max(param_err, e_big)
        param_err_small = max(param_err_small, e_small)
    if not loss_err <= 1e-4:
        raise AssertionError(f"{tag}: loss {l_gpu} (card) vs {l_cpu} (cpu)")
    log(f"{tag}: loss {l_gpu:.6f} (card) vs {l_cpu:.6f} (cpu), err "
        f"{loss_err:.3g}; grads max err {grad_err:.3g} of each grad's "
        f"largest value; params max err {param_err:.3g} where |g| >= 1e-5, "
        f"{param_err_small:.3g} elsewhere; card launches {counts}; card "
        f"step {secs['cuda']:.1f} s, CPU step {secs['cpu']:.1f} s")
    return dict(loss_card=l_gpu, loss_cpu=l_cpu, loss_err=loss_err,
                grad_rel_err=grad_err, param_err=param_err,
                param_err_small_grad=param_err_small, counts=counts,
                card_step_s=secs["cuda"], cpu_step_s=secs["cpu"])


def train_parity(seed):
    """:func:`parity_step` at GPT-124M widths, 2 layers, batch 2 x 256,
    recompute ``dots_and_kernels_saveable``."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_gpt_from_jax)
    cfg = GPTConfig(num_layers=2, recompute=True,
                    recompute_policy="dots_and_kernels_saveable")
    weights = jax_layout_gpt_weights(cfg, seed + 3)
    ids, lab = _batch_fn(cfg, 2, 256, seed + 4)()

    def make(dev):
        return load_gpt_from_jax(GPTForCausalLM(cfg, device=dev), weights)
    return parity_step(make, ids, lab, 1e-4,
                       dict(flash_attention_fwd=2, flash_attention_bwd=2,
                            fused_update=1), "train parity")


# ------------------------------------------------------- llama kernels --
def _check_errs(name, errs):
    for n, (err, lim) in errs.items():
        if not err <= lim:
            raise AssertionError(f"{name} {n}: kernel vs plain max abs error "
                                 f"{err:.3g} > {lim:.3g}")


def _err(got, ref, bf16, roundings=1):
    """(max abs error, limit): bf16 within ``roundings`` bf16 roundings of
    the plain version run in fp32 on the same inputs; fp32 within 1e-5."""
    if bf16:
        return _bf16_err(got, ref, roundings)
    return float((got.float() - ref.float()).abs().max()), 1e-5


def rope_cases(seed, power, flush):
    """The rope kernel against its plain version: the LLaMA train phase's
    q ``[2, 2048, 32, 128]`` bf16 with ``[2048, 128]`` half-pairing tables
    (forward, and the backward's -sin launch), then interleaved pairing,
    per-batch ``[2, 2048, 128]`` tables and fp32. ``unfused_ms`` times the
    eager chain a model would run without the kernel: ``x * cos +
    rotate(x) * sin`` in x's dtype (tables cast once, outside the clock).
    No single PyTorch call computes rope (``library_ms`` null)."""
    from paddle_tpu_torch.models import rope_angles
    from paddle_tpu_torch.ops.cuda import rope as rp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    B, S, H, D = 2, 2048, 32, 128
    cos, sin = (t.to(dev) for t in rope_angles(np.arange(S), D, 10000.0))
    pos = torch.randint(0, S, (B, S), generator=gen, device=dev)
    cases = [
        # name, dtype, half pairing, per-batch tables
        ("llama7b_q_bf16", torch.bfloat16, True, False),
        ("llama7b_q_bf16_interleaved", torch.bfloat16, False, False),
        ("llama7b_q_bf16_batched_tables", torch.bfloat16, True, True),
        ("llama7b_q_f32", torch.float32, True, False),
    ]
    fwd_rows, bwd_rows = [], []
    for name, dt, neox, batched in cases:
        c, s = (cos[pos], sin[pos]) if batched else (cos, sin)
        x = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
        g = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
        out = rp.rope(x, c, s, neox)
        dx = rp.rope(g, c, s, neox, neg_sin=True)
        ref = rp.rope_plain(x.float(), c, s, neox)
        dref = rp.rope_plain(g.float(), c, -s, neox)
        torch.cuda.synchronize()
        bf = dt == torch.bfloat16
        errs = {"out": _err(out, ref, bf), "dx": _err(dx, dref, bf)}
        _check_errs(f"rope {name}", errs)
        cl, sl = c.to(dt), s.to(dt)

        def unfused():
            rot = (torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
                   if neox else torch.stack([-x[..., 1::2], x[..., ::2]],
                                            dim=-1).flatten(-2))
            return x * cl[..., None, :] + rot * sl[..., None, :]

        esize = x.element_size()
        nbytes = 2 * x.numel() * esize + 2 * c.numel() * 4
        bound_ms, bound_by = _fp32_bound(nbytes, 6 * x.numel())
        unf = _time_ms(unfused, 20, flush)
        for rows, which, fn, pfn in (
                (fwd_rows, "out", lambda: rp.rope(x, c, s, neox),
                 lambda: rp.rope_plain(x, c, s, neox)),
                (bwd_rows, "dx", lambda: rp.rope(g, c, s, neox, neg_sin=True),
                 lambda: rp.rope_plain(g, c, -s, neox))):
            ms = _time_ms(fn, 50, flush)
            plain_ms = _time_ms(pfn, 10, flush)
            row = dict(case=name + ("" if which == "out" else "_bwd_neg_sin"),
                       max_abs_err=errs[which][0], tolerance=errs[which][1],
                       ms=ms, plain_ms=plain_ms, unfused_ms=unf,
                       bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                       library_ms=None, library="none: no single call",
                       x=[B, S, H, D], tables=list(c.shape),
                       dtype=str(dt).replace("torch.", ""),
                       pairing="half" if neox else "interleaved")
            log(f"kernel rope {row['case']} x {row['x']} tables "
                f"{row['tables']} {row['dtype']}: max_abs_err "
                f"{row['max_abs_err']:.3g}, {ms:.4f} ms (plain "
                f"{plain_ms:.4f} ms, unfused chain {unf:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of "
                f"bound) on {power}")
            rows.append(row)
        del x, g, out, dx, ref, dref
    torch.cuda.empty_cache()
    return fwd_rows + bwd_rows


def rms_cases(seed, power, flush):
    """The fused residual + RMSNorm forward and backward kernels against
    their plain versions: the LLaMA train phase's rows (x, y ``[4096,
    4096]`` bf16, w bf16, as under O2), fp32, and 4093 rows (not a
    multiple of the backward CTA's 8); bf16 ``normed`` within two bf16
    roundings (its residual sum is rounded before the stats, as the TPU
    kernel does, and the plain version in fp32 does not round it).
    ``unfused_ms`` times the glue-off
    path the kernels replace: ``ops.add`` + ``F.rms_norm`` under O2
    auto_cast (forward) and autograd's backward of that chain. No single
    PyTorch call computes either function (``library_ms`` null). The
    fp32 dw is held to 1e-5 of its column's sum of |dnormed * xhat|: a
    sum over 4096 rows in another order."""
    from paddle_tpu_torch import amp, ops
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.cuda import fused_residual_norm as fr
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    eps = 1e-6
    cases = [("llama7b_bf16", 4096, 4096, torch.bfloat16),
             ("llama7b_f32", 4096, 4096, torch.float32),
             ("rows4093_bf16", 4093, 4096, torch.bfloat16)]
    fwd_rows, bwd_rows = [], []
    for name, n, h, dt in cases:
        def rn(*shape, std=1.0):
            return torch.randn(*shape, generator=gen, device=dev) * std
        x, y = rn(n, h).to(dt), rn(n, h).to(dt)
        w = (1.0 + rn(h, std=0.1)).to(dt)
        dres, dn = rn(n, h).to(dt), rn(n, h).to(dt)
        res, normed, rstd = fr.fused_residual_rms_norm_fwd(x, y, w, eps)
        d, dw = fr.fused_residual_rms_norm_bwd(res, w, rstd, dres, dn)
        d0, _ = fr.fused_residual_rms_norm_bwd(res, w, rstd, None, dn)
        f32 = [t.float() for t in (x, y, w, dres, dn)]
        rres, rnormed, rrstd = fr.fused_residual_rms_norm_fwd_plain(
            *f32[:3], eps)
        # the backward's plain version on the kernel's own res and rstd
        rd, rdw = fr.fused_residual_rms_norm_bwd_plain(
            res.float(), f32[2], rstd, f32[3], f32[4])
        rd0, _ = fr.fused_residual_rms_norm_bwd_plain(
            res.float(), f32[2], rstd, None, f32[4])
        torch.cuda.synchronize()
        bf = dt == torch.bfloat16
        # normed rounds twice in bf16: the residual sum before the stats
        # (the plain version in fp32 does not) and the output
        ferrs = {"res": _err(res, rres, bf),
                 "normed": _err(normed, rnormed, bf, roundings=2),
                 "rstd": _err(rstd, rrstd, bf)}
        berrs = {"d": _err(d, rd, bf), "d_without_dres": _err(d0, rd0, bf),
                 "dw": _err(dw, rdw, bf)}
        if not bf:
            xhat = res.float() * rstd
            colsum = float((f32[4] * xhat).abs().sum(dim=0).max())
            berrs["dw"] = (berrs["dw"][0], 1e-5 * colsum)
        _check_errs(f"fused_residual_rms_norm_fwd {name}", ferrs)
        _check_errs(f"fused_residual_rms_norm_bwd {name}", berrs)
        del f32, rres, rnormed, rrstd, rd, rdw, rd0, d0

        xg, yg, wg = (t.detach().clone().requires_grad_() for t in (x, y, w))

        def glue_off():
            with amp.auto_cast(enable=bf, level="O2", dtype="bfloat16"):
                r = ops.add(xg, yg)
                return r, PF.rms_norm(r, wg, epsilon=eps)

        with torch.no_grad():
            unf_f = _time_ms(glue_off, 20, flush)
        r_u, h_u = glue_off()
        unf_b = _time_ms(lambda: torch.autograd.grad(
            (r_u, h_u), (xg, yg, wg), (dres.to(r_u.dtype),
                                       dn.to(h_u.dtype)),
            retain_graph=True), 10, flush)
        del r_u, h_u, xg, yg, wg
        esize = x.element_size()
        rows_bytes = n * h * esize
        specs = (
            (fwd_rows, ferrs, unf_f,
             lambda: fr.fused_residual_rms_norm_fwd(x, y, w, eps),
             lambda: fr.fused_residual_rms_norm_fwd_plain(x, y, w, eps),
             # x, y, w read; res, normed, rstd written
             4 * rows_bytes + h * esize + 4 * n, "fwd"),
            (bwd_rows, berrs, unf_b,
             lambda: fr.fused_residual_rms_norm_bwd(res, w, rstd, dres, dn),
             lambda: fr.fused_residual_rms_norm_bwd_plain(res, w, rstd, dres,
                                                          dn),
             # res, dres, dnormed, w, rstd read; d, dw written
             4 * rows_bytes + 2 * h * esize + 4 * n, "bwd"))
        for rows, errs, unf, fn, pfn, nbytes, which in specs:
            ms = _time_ms(fn, 50, flush)
            plain_ms = _time_ms(pfn, 10, flush)
            bound_ms, bound_by = _fp32_bound(nbytes, 8 * n * h)
            row = dict(case=name, max_abs_err=max(e for e, _ in errs.values()),
                       tolerance={k: lim for k, (_, lim) in errs.items()},
                       ms=ms, plain_ms=plain_ms, unfused_ms=unf,
                       bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                       library_ms=None, library="none: no single call",
                       rows=[n, h], dtype=str(dt).replace("torch.", ""))
            log(f"kernel fused_residual_rms_norm_{which} {name} [{n}, {h}] "
                f"{row['dtype']}: max_abs_err {row['max_abs_err']:.3g}, "
                f"{ms:.4f} ms (plain {plain_ms:.4f} ms, unfused chain "
                f"{unf:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
                f"{bound_ms / ms:.1%} of bound) on {power}")
            rows.append(row)
        del x, y, w, dres, dn, res, normed, rstd, d, dw
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def llama_kernel_phase(seed, power):
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rope_rows = rope_cases(seed, power, flush)
    fwd, bwd = rms_cases(seed, power, flush)
    del flush
    torch.cuda.empty_cache()
    return {"rope": rope_rows, "fused_residual_rms_norm_fwd": fwd,
            "fused_residual_rms_norm_bwd": bwd}


# --------------------------------------------------------- llama train --
def jax_layout_llama_weights(cfg, seed):
    """LLaMA weights as the JAX package names and lays them out (Linear
    ``[in, out]``, an untied ``lm_head`` too), drawn with its init:
    normal std 0.02, ``o_proj``/``down_proj`` 0.02 / sqrt(2 L), unit
    norms."""
    rng = np.random.default_rng(seed)
    h, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    resid = 0.02 / np.sqrt(2 * L)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    w = {"llama.embed_tokens.weight": normal((cfg.vocab_size, h), 0.02),
         "llama.norm.weight": np.ones(h, np.float32)}
    for i in range(L):
        p = f"llama.layer_{i}."
        w.update({
            p + "input_norm.weight": np.ones(h, np.float32),
            p + "attn.q_proj.weight": normal((h, hq), 0.02),
            p + "attn.k_proj.weight": normal((h, hkv), 0.02),
            p + "attn.v_proj.weight": normal((h, hkv), 0.02),
            p + "attn.o_proj.weight": normal((hq, h), resid),
            p + "post_norm.weight": np.ones(h, np.float32),
            p + "mlp.gate_proj.weight": normal((h, inter), 0.02),
            p + "mlp.up_proj.weight": normal((h, inter), 0.02),
            p + "mlp.down_proj.weight": normal((inter, h), resid),
        })
    if not cfg.tie_embeddings:
        w["lm_head.weight"] = normal((h, cfg.vocab_size), 0.02)
    return w


def llama_train_config(num_layers=4):
    """LLaMA-7B widths (the ``LlamaConfig`` defaults: vocab 32000, hidden
    4096, 32 heads, head_dim 128, intermediate 11008, 2048 positions) at
    ``num_layers`` layers, recompute ``dots_and_kernels_saveable``."""
    from paddle_tpu_torch.models import LlamaConfig
    return LlamaConfig(num_layers=num_layers, recompute=True,
                       recompute_policy="dots_and_kernels_saveable")


def expected_first_loss(cfg):
    """The mean cross-entropy of the init at step 0: logits of a unit-RMS
    final norm times an lm_head of std 0.02 are ~normal with variance
    hidden * 0.02^2, and E[logsumexp] of V such logits is about ln V +
    variance / 2: 11.19 at LLaMA-7B widths, where ln V alone (10.37) is
    0.82 below it."""
    return float(np.log(cfg.vocab_size) + cfg.hidden_size * 0.02 ** 2 / 2)


def llama_train_phase(seed, glue, cfg=None, device="cuda", batch=2,
                      seq=2048, warmup=2, steps=5, power="", state=None):
    """Train LLaMA (default: :func:`llama_train_config`) through the
    Paddle entry points (:func:`train_run`) with ``train_glue_fusion`` set
    to ``glue``: every step launches the flash forward and backward once
    per layer, rope four times per layer (q and k, forward and backward)
    and the fused residual + RMSNorm forward and backward 2 L times each
    with glue on (none with it off); the first loss within 0.5 of
    :func:`expected_first_loss`. ``state`` reuses a torch state_dict of
    the weights (one draw for both runs); ``cfg``/``device``/``batch``/
    ``seq`` shrink it to rehearse on the CPU (no launch counts, no
    profile). The flag is restored after."""
    from paddle_tpu_torch.core import state as flags
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         llama_state_from_jax)
    cfg = llama_train_config() if cfg is None else cfg
    if state is None:
        state = llama_state_from_jax(jax_layout_llama_weights(cfg, seed))
    model = LlamaForCausalLM(cfg, device=device)
    model.load_state_dict(state, strict=True)
    L = cfg.num_layers
    want = dict(flash_attention_fwd=L, flash_attention_bwd=L, rope=4 * L)
    if glue:
        want.update(fused_residual_rms_norm_fwd=2 * L,
                    fused_residual_rms_norm_bwd=2 * L)
    old = flags.get_flag("train_glue_fusion")
    flags.set_flags({"train_glue_fusion": glue})
    try:
        out = train_run(model, cfg, seed, device, batch, seq, warmup, steps,
                        want, expected_first_loss(cfg),
                        f"llama train (glue {'on' if glue else 'off'}, "
                        f"{L} layers)", power)
    finally:
        flags.set_flags({"train_glue_fusion": old})
    return dict(out, glue=glue, layers=L)


def llama_train_phases(seed, power):
    """The LLaMA train phase with ``train_glue_fusion`` off, then on, from
    one draw of the weights; both first losses (same weights, same first
    batch) must agree within 1e-2."""
    from paddle_tpu_torch.models import llama_state_from_jax
    cfg = llama_train_config()
    t0 = time.perf_counter()
    state = llama_state_from_jax(jax_layout_llama_weights(cfg, seed))
    log(f"llama train: weights drawn in {time.perf_counter() - t0:.2f} s")
    off = llama_train_phase(seed, False, cfg, power=power, state=state)
    on = llama_train_phase(seed, True, cfg, power=power, state=state)
    del state
    gap = abs(on["losses"][0] - off["losses"][0])
    if not gap <= 1e-2:
        raise AssertionError(f"llama train: first loss glue on "
                             f"{on['losses'][0]:.5f} vs off "
                             f"{off['losses'][0]:.5f}")
    log(f"llama train: first loss glue on {on['losses'][0]:.5f} vs off "
        f"{off['losses'][0]:.5f} (gap {gap:.3g}); step {on['step_ms']:.2f} "
        f"vs {off['step_ms']:.2f} ms")
    return off, on


def llama_parity(seed, num_layers=1, batch=1, seq=256):
    """:func:`parity_step` of LLaMA with ``train_glue_fusion`` on:
    LLaMA-7B widths, ``num_layers`` layer(s), batch ``batch`` x ``seq``,
    recompute ``dots_and_kernels_saveable``."""
    from paddle_tpu_torch.core import state as flags
    from paddle_tpu_torch.models import LlamaForCausalLM, load_llama_from_jax
    cfg = llama_train_config(num_layers)
    weights = jax_layout_llama_weights(cfg, seed + 3)
    ids, lab = _batch_fn(cfg, batch, seq, seed + 4)()

    def make(dev):
        return load_llama_from_jax(LlamaForCausalLM(cfg, device=dev),
                                   weights)
    L = num_layers
    old = flags.get_flag("train_glue_fusion")
    flags.set_flags({"train_glue_fusion": True})
    try:
        out = parity_step(
            make, ids, lab, 1e-4,
            dict(flash_attention_fwd=L, flash_attention_bwd=L, rope=4 * L,
                 fused_residual_rms_norm_fwd=2 * L,
                 fused_residual_rms_norm_bwd=2 * L, fused_update=1),
            f"llama parity ({L} layer(s) at LLaMA-7B widths, batch {batch}"
            f" x {seq}, glue on)")
    finally:
        flags.set_flags({"train_glue_fusion": old})
    return dict(out, layers=L, batch=batch, seq=seq)


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
    dec_rows = decode_kernel_phase(args.seed, smi_line)
    llama_rows = llama_kernel_phase(args.seed, smi_line)
    model = serve_model(args.seed)
    serve = serve_phase(args.seed, model=model)
    serve_mk = serve_phase(args.seed, megakernel=True, model=model)
    turns = serve_turns(model, args.seed)
    del model
    torch.cuda.empty_cache()
    log(f"megakernel vs unfused serve: {serve_mk['tokens_per_s']:.1f} vs "
        f"{serve['tokens_per_s']:.1f} tokens/s; decode dispatch "
        f"{serve_mk['decode_dispatch_ms']:.2f} vs "
        f"{serve['decode_dispatch_ms']:.2f} ms; device launches per decode "
        f"step {serve_mk['window']['launches_per_step']:.1f} vs "
        f"{serve['window']['launches_per_step']:.1f}; busy "
        f"{serve_mk['profile']['busy_share']:.1%} vs "
        f"{serve['profile']['busy_share']:.1%}")
    train = train_phase(args.seed, power=smi_line)
    parity = train_parity(args.seed)
    llama_off, llama_on = llama_train_phases(args.seed, smi_line)
    llama_par = llama_parity(args.seed)
    print(json.dumps({"train": train, "train_parity": parity,
                      "llama_train": [llama_off, llama_on],
                      "llama_parity": llama_par, "build_s": build_s,
                      "power": smi_line}), flush=True)
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
        ("fused_decode_qkv", "fused_decode_qkv.cu",
         "paddle_tpu/ops/pallas/fused_decode_qkv.py:131",
         dec_rows["fused_decode_qkv"],
         serve_mk["counts"]["fused_decode_qkv"]),
        ("fused_decode_mlp", "fused_decode_mlp.cu",
         "paddle_tpu/ops/pallas/fused_decode_mlp.py:55",
         dec_rows["fused_decode_mlp"],
         serve_mk["counts"]["fused_decode_mlp"]),
        ("fused_decode_epilogue", "fused_decode_mlp.cu",
         "paddle_tpu/ops/pallas/fused_decode_mlp.py:75",
         dec_rows["fused_decode_epilogue"],
         serve_mk["counts"]["fused_decode_epilogue"]),
        ("rope", "rope.cu", "paddle_tpu/ops/pallas/rope.py:53",
         llama_rows["rope"], llama_on["counts"]["rope"]),
        ("fused_residual_rms_norm_fwd", "fused_residual_norm.cu",
         "paddle_tpu/ops/pallas/fused_residual_norm.py:259",
         llama_rows["fused_residual_rms_norm_fwd"],
         llama_on["counts"]["fused_residual_rms_norm_fwd"]),
        ("fused_residual_rms_norm_bwd", "fused_residual_norm.cu",
         "paddle_tpu/ops/pallas/fused_residual_norm.py:297",
         llama_rows["fused_residual_rms_norm_bwd"],
         llama_on["counts"]["fused_residual_rms_norm_bwd"]),
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
    print(json.dumps({"kernels": out, "serve": serve,
                      "serve_megakernel": serve_mk, "serve_turns": turns,
                      "power": smi_line}), flush=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
