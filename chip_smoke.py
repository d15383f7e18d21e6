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
     and one GQA case; with int8 pools and scale pools at the LLaMA-7B
     quantized serve phase's shapes (mixed and decode, 32 heads of 128,
     pools ``[32, 1025, 16, 128]``) and a GQA case (32 q heads on 8 kv
     heads); max abs error <= 2e-5 (fp32);
   * ``flash_attention_fwd`` / ``flash_attention_bwd`` at the train
     phase's shape (q, k, v ``[8, 1024, 12, 64]`` bf16 causal, the
     unbound views of a packed qkv), an fp32 case with Sq != Sk, a
     GQA case (Hq 32, Hk 8, D 128, S 512, bf16), the LLaMA train
     phase's shape (``[2, 2048, 32, 128]`` bf16 causal), a ragged bf16
     case (Sq = Sk = 1000, D 128), a bf16 case with Sq > Sk (rows
     that attend nothing) and a bf16 GQA case at head_dim 96, each on
     the route ``tc_route`` gives it (the bf16 cases at head_dim 64 and
     128 the tensor-core kernels, the others the CUDA-core kernels; each
     row names its route): fp32 within 2e-5 (o, lse) and 1e-4 (grads);
     bf16 on the CUDA cores within one bf16 rounding of the largest
     reference value + 1e-4; the tensor-core route element by element
     within ``tc_tolerances`` (P and dS rounded to bf16 before their
     products, carried through each product, plus one bf16 rounding of
     the element and 1e-4), each row with its largest ratio of error to
     limit; lse within 2e-5; timed behind a ~1 ms device spin, beside
     SDPA forward, forward + backward and (their difference) backward;
   * ``fused_update`` (AdamW, lr 1e-4, decay 0.01) on GPT-124M's O2
     buckets (124,437,504 bf16 params with fp32 masters; 38,912 fp32
     LayerNorm params, padded), the bf16 bucket with a clip scale and
     the LLaMA train phase's bucket (1,071,681,536 bf16 params):
     fp32 state within 1e-6 of its largest value, bf16 weights within
     one bf16 rounding;
   * ``fused_decode_qkv``, ``fused_decode_mlp`` and
     ``fused_decode_epilogue`` at the LLaMA-7B megakernel serve's shapes
     (hidden 4096, 32 heads of 128, intermediate 11008, the untied head
     ``[32000, 4096]``, pools ``[32, 1025, 16, 128]`` fp32 or int8 with
     scale pools, tables ``[B, 128]``) at B = 8 (the main case), 1 and 5
     and with GQA (32 q heads on 8 kv heads), and at the GPT megakernel
     serve phase's (x ``[8, 768]``, pools ``[12, 513, 16, 64]``, tables
     ``[8, 64]``, the tied embedding ``[50304, 768]``): values within
     2e-5 of the plain version's largest, int8 pool bytes within one
     step (the count reported) and scales within 1e-6 relative, tokens
     and bad flags equal except on near ties, a NaN-poisoned row bad with
     token 0; each beside the unfused eager chain it replaces;
   * ``fused_decode_mlp_partial`` (the shard-local decode MLP of tensor
     parallelism) at one TP=2 rank's shapes: LLaMA-7B (y1 ``[B, 4096]``,
     gate and up ``[5504, 4096]``, down ``[4096, 5504]``) at B = 8, 5
     and 1, GPT-124M (fc1 ``[1536, 768]``, fc2 ``[768, 1536]``) at B = 8
     and 1: within 2e-5 of the plain version's largest value, beside the
     unfused eager chain;
   * ``rope`` at the LLaMA train phase's q ``[2, 2048, 32, 128]`` bf16
     with ``[2048, 128]`` half-pairing tables, forward and the
     backward's -sin launch, plus interleaved pairing, per-batch
     ``[2, 2048, 128]`` tables and fp32; ``fused_residual_rms_norm_fwd``
     / ``_bwd`` at its rows (``[4096, 4096]`` bf16), fp32 and 4093 rows:
     bf16 within one bf16 rounding of the plain version run in fp32 on
     the same inputs, fp32 within 1e-5 (dw within 1e-5 of its column's
     sum of magnitudes); each beside the unfused eager chain it replaces;
   * ``fused_residual_layer_norm_fwd`` / ``_bwd`` at the GPT glue-on
     train phase's rows (x, y ``[8192, 768]`` bf16), fp32 and 8191 rows,
     beside the unfused chain (add + LayerNorm under O2, and its
     autograd); ``layer_norm_fwd`` / ``_bwd`` at GPT-124M's rows
     (``[8192, 768]`` fp32, as the black list gives them) and 8191 rows,
     ``rms_norm_fwd`` / ``_bwd`` at LLaMA-7B's (``[4096, 4096]`` fp32, and
     bf16 through ``incubate.fused_rms_norm``), beside
     ``torch.nn.functional.layer_norm`` / ``rms_norm`` and their
     autograd backward (the library yardsticks): bf16 within one bf16
     rounding of the plain version run in fp32 (two for ``normed``), fp32
     within 1e-5 (dw, db within 1e-5 of their column's sum of
     magnitudes);
   * ``weight_only_matmul`` at the LLaMA-7B quantized serve phase's
     projections ((K, N) = (4096, 4096), (4096, 11008), (11008, 4096),
     (4096, 32000)) at M = 8 (decode), 128 (the mixed step's token
     budget) and 512, plus M = 1 and odd K and N: each output within
     2e-5 of its sum of |x| |q| s; beside ``torch.matmul`` with the
     weight dequantized beforehand (the library yardstick).
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
   layer and ``fused_decode_epilogue`` once. After the two paths in
   turns, the megakernel serves them once more over int8 KV pages
   (``kv_quant=True``; the teacher replays the quantization, near-tie
   margin twice GPT-124M's own logit gap along the fused decode path,
   measured first).
3b. LLaMA serve phases: LLaMA-7B (``LlamaConfig()``: vocab 32000, hidden
   4096, 32 layers of 32 heads of 128, intermediate 11008) at full depth
   with every projection and the untied ``lm_head`` weight-only int8
   (``quantization.weight_only_quantize``; weights drawn on the card
   from the seed layer by layer, each layer quantized as it is drawn)
   behind ``ContinuousBatchingEngine(kv_quant=True)`` (int8 KV pages),
   the same 16 requests and checks; every forward launches the int8
   attention 32 times and ``weight_only_matmul`` 225 times (7 L + 1),
   and every served token must be the pick of a plain fp32 forward that
   replays the quantization (dequantized weights, each K/V vector
   through ``kv_quantize`` -> ``kv_dequantize``) except near ties (a
   top-2 gap below MARGIN_KV8, whose reason is written beside it); one
   profiled run and one profiled decode window. Then the fp32 LLaMA-7B
   at full depth (27 GB of weights, drawn on the card) with fp32 pools,
   unfused and then with ``megakernel=True`` (every decode step 32
   ``fused_decode_qkv``, 32 attention, 32 ``fused_decode_mlp`` and one
   ``fused_decode_epilogue`` launch), both again in turns (megakernel,
   unfused), then with int8 pools unfused and through the megakernel;
   each under the same checks (teacher margin MARGIN over fp32 pools,
   MARGIN_KV8 over int8 ones) with one profiled decode window.
3c. TP serve phase (after this process frees its LLaMA-7B): two ranks,
   spawned, both on this card over a gloo process group (NCCL refuses two
   ranks on one card; gloo copies the all-reduced tensors through the
   host, so its times say nothing of NVLink), serve the same 16 requests
   through ``ContinuousBatchingEngine(mesh=...)`` at TP=2: GPT-124M
   unfused, megakernel over fp32 pools and over int8 pools, then
   LLaMA-7B at full depth (each rank drawing its slices part by part
   from the seed) unfused and megakernel over fp32 pools, on the first
   8 of the requests (TP_LLAMA_REQUESTS). Each rank
   checks its launches per dispatch (a megakernel decode step: L
   ``fused_decode_qkv``, L attention, L ``fused_decode_mlp_partial``, one
   epilogue and no ``fused_decode_mlp``) and 2 L all-reduces a forward,
   and profiles one decode window; both ranks' streams and ``stats`` must
   be equal, and every served token the pick of the unsharded model's
   plain forward except near ties below max(MARGIN, 2 x the gap measured
   on that leg's TP path).
4. Train phase: GPT-124M in ``bench.py``'s training configuration
   (batch 8 x 1024, recompute ``dots_and_kernels_saveable``, AdamW lr
   1e-4, AMP O2 bf16 with fp32 master weights) through the Paddle entry
   points: 2 warm-up steps, 10 timed steps (step ms, tokens/s, MFU
   against 989 TFLOP/s bf16), every step launching the flash forward
   and backward once per layer, all of them on the tensor-core route,
   and the fused update once per bucket;
   every loss finite, the first within 0.5 of ln(vocab), every master
   and bf16 parameter finite after the last step; one more step under
   ``torch.profiler``. Then from the same weights and batches with
   ``train_glue_fusion`` on (the fused residual + LayerNorm forward and
   backward 24 times each a step: 11 ln1, 12 ln2, ln_f), and with it
   off under the norm backend (``PDTPU_NORM_BACKEND=pallas`` for the
   phase, 5 timed steps: the LayerNorm kernels 25 times each a step);
   each first loss within 1e-2 (FIRST_LOSS_GAP) of glue off's; step ms,
   MFU, busy share and device launches a step side by side. Last, from
   the same weights and batches with ``use_flash_attention=False``
   (the unfused ``_sdpa_plain``: no flash launch), 1 + 2 steps: its
   first loss within FIRST_LOSS_GAP of the flash run's.
5. Train parity: one fp32 AdamW step (GPT-124M widths, 2 layers, batch
   2 x 256, TF32 off) on the card, through the kernels, against the same
   step of a CPU copy running the plain versions: loss, every grad and
   every updated parameter within the tolerances printed; then the same
   with glue on.
6. LLaMA train phase: LLaMA-7B widths (vocab 32000, hidden 4096, 32
   heads of 128, intermediate 11008) at 4 layers, batch 2 x 2048,
   recompute ``dots_and_kernels_saveable``, AdamW lr 1e-4, O2 bf16 with
   fp32 masters, weights drawn from the seed in the JAX package's layout
   and init; run with ``train_glue_fusion`` off, then on: 2 warm-up and
   5 timed steps each (step ms, tokens/s, MFU), every step launching the
   flash forward and backward once per layer (all on the tensor-core
   route), rope 4 times per layer,
   the fused residual + RMSNorm forward and backward 2 L times each with
   glue on (none with it off) and the fused update once per bucket;
   then glue off under the norm backend (the RMSNorm kernels 9 times
   each a step); losses finite, the first within 0.5 of the init's
   expected loss, each first loss within 1e-2 of glue off's; one
   profiled step each.
7. LLaMA parity: one fp32 AdamW step with glue on (LLaMA-7B widths, 1
   layer, batch 1 x 256) on the card against a CPU copy.
8. Prints the ``train`` JSON line, the ``kernels`` JSON line (eighteen
   kernels, each with the launches of its own path: the three fused
   decode kernels those of the fp32 LLaMA-7B megakernel serve,
   ``fused_decode_mlp_partial`` those of the LLaMA-7B TP=2 megakernel
   leg's rank 0, with every megakernel path's count beside them; with
   the serve phases), then
   ``{"ok": true, "device": ...}`` as the last line. Any failed phase
   raises: the exit code is not 0 and no result line is printed.
   Without a card it exits 2 at once.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
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
# ... with int8 KV pages: the served path's K/V come out of another
# summation order than the plain forward's, so kv_quantize rounds some
# of them to the neighbouring int8 step, and the served path's logits
# sit up to ~0.05 from the plain forward's at LLaMA-7B, 32 layers (the
# LLaMA serve phase measures it: ``logit_gap``); a pick may differ only
# where the top-2 gap is below twice that (PERF.md). GPT-124M's
# int8 serve takes twice its own reading instead (``serve_phase``).
MARGIN_KV8 = 0.1
SPIN_CYCLES = 2_000_000      # ~1 ms at the H100's ~2 GHz clock
TP_COLLECTIVE_S = 300        # a TP rank's rendezvous and each collective
TP_JOIN_S = 600              # the TP serve phase's ranks, start to exit
_RANK = ""                   # a TP rank's log prefix


def log(msg):
    print(f"chip_smoke: {_RANK}{msg}", flush=True)


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
                                           norms, paged_attention,
                                           quant_matmul, rope)
    t0 = time.perf_counter()
    libs = _build.build_all()
    paged_attention._kernel()           # load + bind
    flash_attention._kernels()
    flash_attention._tc_kernels()
    fused_optimizer._kernel()
    fused_decode_qkv._kernel()
    fused_decode_mlp._kernels()
    rope._kernel()
    fused_residual_norm._kernels()
    norms._kernels()
    quant_matmul._kernel()
    secs = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {secs:.2f} s")
    return secs


class _TcRoute:
    """A flash wrapper's tensor-core route count, read and reset like a
    wrapper's ``launches`` (``tc_launches`` beside ``launches``)."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.tc_launches

    @launches.setter
    def launches(self, n):
        self.fn.tc_launches = n


def counters():
    """Every kernel wrapper's launch counter, by kernel name, and the
    flash wrappers' tensor-core route counts (``*_tc``)."""
    from paddle_tpu_torch.ops.cuda import (flash_attention, fused_decode_mlp,
                                           fused_decode_qkv, fused_optimizer,
                                           fused_residual_norm, norms,
                                           paged_attention, quant_matmul,
                                           rope)
    frn = fused_residual_norm
    return {"ragged_paged_attention": paged_attention.ragged_paged_attention,
            "flash_attention_fwd": flash_attention.flash_attention_fwd,
            "flash_attention_bwd": flash_attention.flash_attention_bwd,
            "flash_attention_fwd_tc":
                _TcRoute(flash_attention.flash_attention_fwd),
            "flash_attention_bwd_tc":
                _TcRoute(flash_attention.flash_attention_bwd),
            "fused_update": fused_optimizer.fused_update,
            "fused_decode_qkv": fused_decode_qkv.fused_decode_qkv,
            "fused_decode_mlp": fused_decode_mlp.fused_decode_mlp,
            "fused_decode_mlp_partial":
                fused_decode_mlp.fused_decode_mlp_partial,
            "fused_decode_epilogue": fused_decode_mlp.fused_decode_epilogue,
            "rope": rope.rope,
            "fused_residual_rms_norm_fwd":
                fused_residual_norm.fused_residual_rms_norm_fwd,
            "fused_residual_rms_norm_bwd":
                fused_residual_norm.fused_residual_rms_norm_bwd,
            "weight_only_matmul": quant_matmul.weight_only_matmul,
            "fused_residual_layer_norm_fwd":
                frn.fused_residual_layer_norm_fwd,
            "fused_residual_layer_norm_bwd":
                frn.fused_residual_layer_norm_bwd,
            "rms_norm_fwd": norms.rms_norm_fwd,
            "rms_norm_bwd": norms.rms_norm_bwd,
            "layer_norm_fwd": norms.layer_norm_fwd,
            "layer_norm_bwd": norms.layer_norm_bwd}


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
               NP=None, T=None, int8=False):
    """Inputs on the card: shuffled block tables ``[B, NP]``, packed q
    ``[T, Hq, D]`` with each segment at a q_block edge (by default one
    trailing padding q block). With ``int8``, the pools are the int8
    bytes and ``(k_scales, v_scales)`` of random K/V vectors through
    ``quantization.kv_quantize``, returned as a last element."""
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
    scales = {}
    if int8:
        from paddle_tpu_torch.quantization import kv_quantize
        k, ks = kv_quantize(k)
        v, vs = kv_quantize(v)
        scales = dict(k_scales=ks, v_scales=vs)
    return (q, k, v, bt.to(dev),
            torch.tensor(kv_lens, dtype=torch.int32, device=dev),
            torch.tensor(q_lens, dtype=torch.int32, device=dev)), scales


def _bound(kv_lens, q_lens, hq, hk, d, page_size, int8=False):
    """Least time for the work these inputs need: each needed K/V token
    read once per kv head (fp32: 4 d bytes; int8: d bytes and a 4-byte
    scale), q read and o written once; 4 d flops per attended (row,
    head, kv position) plus ~5 for the softmax."""
    per_tok = d + 4 if int8 else 4 * d
    nbytes = flops = 0
    for kv, ql in zip(kv_lens, q_lens):
        if ql == 0:
            continue
        nbytes += 2 * kv * hk * per_tok + 2 * ql * hq * d * 4
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
    case is a LLaMA-like head layout. The int8 cases have the shapes the
    LLaMA-7B quantized serve phase gives it (32 kv heads of 128, pools
    ``[32, 1025, 16, 128]`` int8 with ``[32, 1025, 16]`` scales, tables
    ``[8, 128]``, the serve phase's lengths up to 544 tokens), plus a GQA
    case (32 q heads on 8 kv heads)."""
    from paddle_tpu_torch.ops.cuda.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    slots, ps, qb = GEO["max_slots"], GEO["page_size"], GEO["q_block"]
    NP = 1024 // ps                               # GPT-124M max_seq_len
    pages = 1 + slots * NP
    budget = slots * qb + GEO["prefill_chunk"]
    NP7 = 2048 // ps                              # LLaMA-7B max_seq_len
    longest = 512 + NEW_TOKENS
    rng7 = np.random.default_rng(seed + 7)        # the int8 cases' own
    kv7 = [int(x) for x in rng7.integers(16, longest + 1, slots)]
    kv7[1] = max(kv7[1], 64)                      # the prefill chunk's
    kv7[3] = 1
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
        ("llama7b_int8_mixed", kv7, q_mixed, 32, 32, 128, ps, qb,
         1 + slots * NP7, NP7, budget),
        ("llama7b_int8_decode",
         [int(x) for x in rng7.integers(16, longest + 1, slots)],
         [1] * slots, 32, 32, 128, ps, 1, 1 + slots * NP7, NP7, slots),
        ("int8_gqa_32q_8kv_d128",
         [int(x) for x in rng7.integers(64, 1025, 4)], [64, 1, 17, 1], 32,
         8, 128, 16, 8, 257, None, None),
    ]
    rows = []
    for name, kvl, ql, hq, hk, d, ps, qb, pages, width, T in cases:
        int8 = "int8" in name
        args, sc = _attn_case(gen, kvl, ql, hq, hk, d, ps, qb, pages, width,
                              T, int8=int8)
        out = ragged_paged_attention(*args, q_block=qb, **sc)
        ref = ragged_paged_attention_plain(*args, q_block=qb, **sc)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= TOL:
            raise AssertionError(f"{name}: kernel vs plain max abs error "
                                 f"{err:.3g} > {TOL}")
        ms = _time_ms(lambda: ragged_paged_attention(*args, q_block=qb,
                                                     **sc), 100, flush)
        plain_ms = _time_ms(
            lambda: ragged_paged_attention_plain(*args, q_block=qb, **sc),
            5, flush)
        bound_ms, bound_by, nbytes, flops = _bound(kvl, ql, hq, hk, d,
                                                   ps, int8)
        row = dict(case=name, pools="int8" if int8 else "fp32",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
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
        # ragged tiles; Sq > Sk causal: q rows 0-255 attend nothing
        ("ragged_1000_d128", 2, 1000, 1000, 32, 32, 128, True,
         torch.bfloat16),
        ("sq768_gt_sk512_gqa", 2, 768, 512, 12, 4, 64, True, torch.bfloat16),
        # a bf16 head_dim the tensor cores refuse: the CUDA-core kernels
        ("bf16_d96_gqa", 2, 512, 512, 16, 4, 96, True, torch.bfloat16),
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
        tc = fa.tc_route(q, k, v, do)
        route = "tensor cores" if tc else "CUDA cores"
        n_tc = (fa.flash_attention_fwd.tc_launches,
                fa.flash_attention_bwd.tc_launches)
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        grads = fa.flash_attention_bwd(q, k, v, do, o, lse, causal)
        if (fa.flash_attention_fwd.tc_launches - n_tc[0],
                fa.flash_attention_bwd.tc_launches - n_tc[1]) != (tc, tc):
            raise AssertionError(f"flash {name}: not on the {route} route")
        f32 = [x.float() for x in (q, k, v, do)]
        ro, rlse = fa.flash_attention_fwd_plain(*f32[:3], causal)
        torch.cuda.synchronize()
        # name: (max abs error, limit, largest error / limit); the limit
        # is one number, or "per element" (tc_tolerances)
        errs = {"lse": (float((lse - rlse).abs().max()), 2e-5)}
        if tc:
            lims, (ro, *rgrads) = fa.tc_tolerances(q, k, v, do, o, lse,
                                                   causal)
            for n, g, r in zip(("o", "dq", "dk", "dv"), (o, *grads),
                               (ro, *rgrads)):
                e = (g.float() - r).abs()
                errs[n] = (float(e.max()), "per element",
                           float((e / lims[n]).max()))
            del lims, e
        else:
            rgrads = fa.flash_attention_bwd_plain(*f32, o.float(), lse,
                                                  causal)
            for n, g, r in zip(("o", "dq", "dk", "dv"), (o, *grads),
                               (ro, *rgrads)):
                errs[n] = (_bf16_err(g, r) if dt == torch.bfloat16 else
                           (float((g.float() - r).abs().max()),
                            2e-5 if n == "o" else 1e-4))
        errs = {n: e if len(e) == 3 else (*e, e[0] / e[1])
                for n, e in errs.items()}
        for n, (err, lim, ratio) in errs.items():
            if not ratio <= 1:
                raise AssertionError(f"flash {name} {n}: kernel vs plain "
                                     f"max abs error {err:.3g}, {ratio:.3g}"
                                     f" x its limit ({lim})")
        del ro, rlse, rgrads, f32
        plain = [x.to(dt) for x in (q, k, v, do)]
        ms_f = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal),
                        20, flush, spin=True)
        ms_b = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, do, o, lse,
                                                       causal), 10, flush,
                        spin=True)
        plain_f = _time_ms(lambda: fa.flash_attention_fwd_plain(
            *plain[:3], causal), 3, flush)
        plain_b = _time_ms(lambda: fa.flash_attention_bwd_plain(
            *plain, o, lse, causal), 3, flush)
        # the library yardstick: torch SDPA in [B, H, S, D], forward and
        # forward + backward (causal alignment differs when Sq != Sk, so
        # only square cases get one); GQA by enable_gqa. Its backward
        # alone is taken as fwd+bwd less fwd, from the same run.
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
                lib_f = _time_ms(sdpa, 20, flush, spin=True)
            lib_fb = _time_ms(sdpa_fb, 10, flush, spin=True)
            del qt, kt, vt, dot
        esize = 2 if dt == torch.bfloat16 else 4
        shape = dict(q=[b, sq, hq, d], kv=[b, sk, hk, d], causal=causal,
                     dtype=str(dt).replace("torch.", ""))
        lib_b = None if lib_fb is None else lib_fb - lib_f
        for rows, ms, pl, lib, bwd, which in (
                (fwd_rows, ms_f, plain_f, lib_f, False, ("o", "lse")),
                (bwd_rows, ms_b, plain_b, lib_fb, True, ("dq", "dk", "dv"))):
            bound_ms, bound_by, nbytes, flops = _flash_bound(
                b, hq, hk, sq, sk, d, causal, esize, bwd)
            row = dict(case=name, route=route,
                       source="flash_attention_sm90.cu" if tc else
                       "flash_attention.cu",
                       max_abs_err=max(errs[n][0] for n in which),
                       errors={n: errs[n][0] for n in which},
                       tolerance={n: errs[n][1] for n in which},
                       err_to_limit={n: errs[n][2] for n in which}, ms=ms,
                       plain_ms=pl, bound_ms=bound_ms, bound_by=bound_by,
                       bytes=nbytes, flops=flops, library_ms=lib,
                       library=("torch sdpa fwd+bwd" if bwd else
                                "torch sdpa fwd") if lib else None, **shape)
            if bwd:
                row["library_bwd_ms"] = lib_b
            log(f"kernel flash_attention_{'bwd' if bwd else 'fwd'} {name} "
                f"q {shape['q']} kv {shape['kv']} {shape['dtype']} on the "
                f"{route} route: max abs errors "
                + ", ".join(f"{n} {errs[n][0]:.3g} ({errs[n][2]:.3f} of "
                            f"its limit)" for n in which)
                + f"; {ms:.4f} ms (plain {pl:.3f} ms, library "
                f"{lib if lib is None else round(lib, 4)} ms"
                + (f", library bwd alone {lib_b:.4f} ms, "
                   f"{ms / lib_b:.2f}x its time" if bwd and lib_b else "")
                + f", bound {bound_ms:.4f} ms by {bound_by}, "
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
    for kname, extra in llama_decode_kernel_cases(seed, power,
                                                  flush).items():
        rows[kname] = extra + rows[kname]   # the LLaMA-7B rows first
    rows["fused_decode_mlp_partial"] = tp_partial_cases(seed, power, flush)
    del flush
    torch.cuda.empty_cache()
    return rows


def _decode_row(name, errs, ms, plain_ms, unfused_ms, nbytes, flops, shape,
                power, kname):
    """One kernel case's row and its log line; ``errs`` is (max abs
    error, the plain version's largest |value|) and the case holds when
    the error is within TOL of that largest value."""
    err, largest = errs
    if not err <= TOL * max(largest, 1.0):
        raise AssertionError(f"{kname} {name}: kernel vs plain max abs error "
                             f"{err:.3g} > {TOL} x {largest:.3g}")
    bound_ms, bound_by = _fp32_bound(nbytes, flops)
    log(f"kernel {kname} {name} {shape}: max_abs_err {err:.3g} (largest "
        f"{largest:.3g}), {ms:.4f} ms (plain {plain_ms:.4f} ms, unfused "
        f"chain {unfused_ms:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by}, {bound_ms / ms:.1%} of bound) on {power}")
    return dict(case=name, max_abs_err=err, largest=largest, ms=ms,
                plain_ms=plain_ms, unfused_ms=unfused_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, flops=flops,
                library_ms=None, library="none: no single call",
                shape=shape)


def _max_err(got, ref):
    return (float((got.float() - ref.float()).abs().max()),
            float(ref.float().abs().max()))


def _pool_errs(kname, name, got, ref):
    """Pools after the kernel against the plain version's: fp32 values
    as values; int8 bytes within one step (a rounding tie of
    ``kv_quantize`` on K/V vectors from another summation order), the
    scales within 1e-6 relative. Returns (errs for the values, int8
    bytes off by one)."""
    if got[0].dtype != torch.int8:
        e = [_max_err(g, r) for g, r in zip(got, ref)]
        return (max(a for a, _ in e), max(b for _, b in e)), 0
    off = 0
    for g, r in zip(got[:2], ref[:2]):
        d = (g.int() - r.int()).abs()
        if int(d.max()) > 1:
            raise AssertionError(f"{kname} {name}: int8 pool bytes differ by "
                                 f"{int(d.max())} > 1")
        off += int((d > 0).sum())
    rel = max(float(((g - r).abs() / r.abs()).max())
              for g, r in zip(got[2:], ref[2:]))
    if not rel <= 1e-6:
        raise AssertionError(f"{kname} {name}: scales differ by {rel:.3g} "
                             f"relative > 1e-6")
    return (0.0, 0.0), off


def llama_decode_kernel_cases(seed, power, flush):
    """The three fused decode kernels' LLaMA branches against their plain
    versions at the LLaMA-7B megakernel serve's shapes (``GEO``; hidden
    4096, 32 heads of 128, intermediate 11008, vocab 32000, pools
    ``[32, 1025, 16, 128]`` fp32 or int8 with scale pools, tables ``[B,
    128]``): B = 8 (the engine's slots; the first row of each kernel, its
    main case), 1 and 5, both pool types, and GQA (32 q heads on 8 kv
    heads). Values within TOL of the plain version's largest; int8 pool
    bytes within one step (the count reported), scales within 1e-6
    relative; tokens and bad flags equal except on near ties, a
    NaN-poisoned row bad with token 0. Each case is timed behind the
    device spin, beside the unfused eager chain of the unfused decode
    path (``_llama_decode``'s ops: norm, cuBLAS projections, rope, the
    page write, SiLU, the head and ``guarded_argmax``)."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.models.generation import (_apply_rope,
                                                    _rope_tables,
                                                    _slot_page_write,
                                                    guarded_argmax)
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    from paddle_tpu_torch.ops.cuda import fused_decode_qkv as fq
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    ps, H, nh, hd, inter, V, L = GEO["page_size"], 4096, 32, 128, 11008, \
        32000, 32
    NP, eps, theta = 2048 // ps, 1e-6, 1e4
    resid = 0.02 / np.sqrt(2 * L)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    def timed(fn, n):
        return _time_ms(fn, n, flush, spin=True)

    rows = {"fused_decode_qkv": [], "fused_decode_mlp": [],
            "fused_decode_epilogue": []}
    norm_w = 1.0 + rn(H, std=0.1)
    wq = rn(nh * hd, H, std=0.02)

    # ingress: RMSNorm + q/k/v + rope + paged append (+ int8 quantize)
    for B, hk, int8 in ((8, 32, False), (8, 32, True), (8, 8, True),
                        (1, 32, False), (1, 32, True), (5, 32, False),
                        (5, 32, True)):
        name = (f"llama7b_{'gqa_' if hk < nh else ''}decode_b{B}_"
                f"{'int8' if int8 else 'fp32'}")
        P = 1 + GEO["max_slots"] * NP
        x = rn(B, H)
        wk, wv = rn(hk * hd, H, std=0.02), rn(hk * hd, H, std=0.02)
        ws = [wq, wk, wv]
        pos = torch.randint(0, 2048, (B,), generator=gen, device=dev)
        bt = (torch.randperm(P - 1, generator=gen, device=dev)[:B * NP]
              + 1).reshape(B, NP).to(torch.int32)
        shape = (hk, P, ps, hd)
        if int8:
            pools = [torch.randint(-127, 128, shape, generator=gen,
                                   device=dev, dtype=torch.int8)
                     for _ in range(2)]
            pools += [torch.rand(shape[:3], generator=gen, device=dev) * 0.1
                      + 0.01 for _ in range(2)]
        else:
            pools = [rn(*shape) for _ in range(2)]
        mine = [t.clone() for t in pools]
        rope = _rope_tables(pos, hd, theta)
        kw = dict(eps=eps, n_heads=nh, n_kv_heads=hk, head_dim=hd,
                  norm="rms", rope=rope)
        out = fq.fused_decode_qkv(x, norm_w, None, ws, [], pos, bt, *mine,
                                  **kw)
        ref = fq.fused_decode_qkv_plain(x, norm_w, None, ws, [], pos, bt,
                                        *pools, **kw)
        torch.cuda.synchronize()
        (perr, plargest), off = _pool_errs("fused_decode_qkv", name,
                                           out[1:], ref[1:])
        qerr, qlargest = _max_err(out[0], ref[0])
        errs = (max(qerr, perr), max(qlargest, plargest))
        nk = hk * hd
        kv_bytes = (2 * B * nk + 2 * 4 * B * hk) if int8 else 8 * B * nk
        # the three weights, x and the norm's weight read, q and K/V
        # (and their scales) written; the rope tables, positions and one
        # table entry per row read
        nbytes = (4 * (nh * hd + 2 * nk) * H + 4 * B * H + 4 * H
                  + 4 * B * nh * hd + kv_bytes + 8 * B * hd + 12 * B)
        flops = 2 * B * (nh * hd + 2 * nk) * H + 6 * B * (nh * hd + nk)
        ks, vs = (mine[2], mine[3]) if int8 else (None, None)

        def unfused_qkv():
            h = F.rms_norm(x, norm_w, epsilon=eps)
            q = tF.linear(h, ws[0]).reshape(B, 1, nh, hd)
            k = tF.linear(h, ws[1]).reshape(B, 1, hk, hd)
            v = tF.linear(h, ws[2]).reshape(B, 1, hk, hd)
            cos, sin = _rope_tables(pos, hd, theta)
            cos, sin = cos[:, None, None, :], sin[:, None, None, :]
            q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
            _slot_page_write(k[:, 0].transpose(0, 1),
                             v[:, 0].transpose(0, 1), mine[0], mine[1],
                             bt, pos, ks, vs)
            return q

        ms = timed(lambda: fq.fused_decode_qkv(
            x, norm_w, None, ws, [], pos, bt, *mine, **kw), 30)
        plain_ms = timed(lambda: fq.fused_decode_qkv_plain(
            x, norm_w, None, ws, [], pos, bt, *pools, **kw), 5)
        unfused_ms = timed(unfused_qkv, 10)
        rows["fused_decode_qkv"].append(_decode_row(
            name, errs, ms, plain_ms, unfused_ms, nbytes, flops,
            dict(x=[B, H], wq=list(wq.shape), wk=list(wk.shape),
                 pools=list(shape), dtype="int8" if int8 else "fp32",
                 tables=list(bt.shape), int8_bytes_off_by_one=off),
            power, "fused_decode_qkv"))
        del x, wk, wv, ws, pools, mine, out, ref
    del wq
    torch.cuda.empty_cache()

    # egress: o_proj + residual + RMSNorm + gate/up + SiLU + down +
    # residual
    wo = rn(H, H, std=resid)
    wg, wu = rn(inter, H, std=0.02), rn(inter, H, std=0.02)
    wd = rn(H, inter, std=resid)
    for B in (8, 1, 5):
        x, att = rn(B, H), rn(B, H)
        margs = (x, att, wo, None, norm_w, None, wg, None, wd, None, wu)
        mkw = dict(arch="llama", norm="rms", eps=eps)
        out = fm.fused_decode_mlp(*margs, **mkw)
        ref = fm.fused_decode_mlp_plain(*margs, **mkw)
        torch.cuda.synchronize()

        def unfused_mlp():
            y = x + tF.linear(att, wo)
            h = F.rms_norm(y, norm_w, epsilon=eps)
            return y + tF.linear(tF.silu(tF.linear(h, wg))
                                 * tF.linear(h, wu), wd)

        ms = timed(lambda: fm.fused_decode_mlp(*margs, **mkw), 30)
        plain_ms = timed(lambda: fm.fused_decode_mlp_plain(*margs,
                                                           **mkw), 5)
        unfused_ms = timed(unfused_mlp, 10)
        # the four weights, x, att and the norm's weight read, the output
        # written
        rows["fused_decode_mlp"].append(_decode_row(
            f"llama7b_decode_b{B}", _max_err(out, ref), ms, plain_ms,
            unfused_ms, 4 * (H * H + 3 * inter * H + 3 * B * H + H),
            2 * B * (H * H + 3 * inter * H) + 8 * B * inter,
            dict(x=[B, H], wo=[H, H], w_gate=[inter, H], w_up=[inter, H],
                 w_down=[H, inter],
                 grid=fm.swiglu_grid(B, H, H, inter, dev)),
            power, "fused_decode_mlp"))
        del x, att, margs, out, ref
    del wo, wg, wu, wd
    torch.cuda.empty_cache()

    # epilogue: final RMSNorm + untied head + guarded argmax
    w_lm = rn(V, H, std=0.02)
    for B in (8, 1, 5):
        x = rn(B, H)
        zero = torch.zeros(B, device=dev)
        ekw = dict(norm="rms", eps=eps)
        lg, nxt, bad = fm.fused_decode_epilogue(x, norm_w, None, w_lm, None,
                                                zero, **ekw)
        rlg, rnxt, rbad = fm.fused_decode_epilogue_plain(
            x, norm_w, None, w_lm, None, zero, transpose_lm=False, **ekw)
        torch.cuda.synchronize()
        name = f"llama7b_decode_b{B}"
        ties = _pick_err(f"fused_decode_epilogue {name}", nxt, bad, rnxt,
                         rbad, rlg)
        poison = zero.clone()
        poison[B // 2] = float("nan")
        _, pn, pb = fm.fused_decode_epilogue(x, norm_w, None, w_lm, None,
                                             poison, **ekw)
        if pb.tolist() != [r == B // 2 for r in range(B)] \
                or int(pn[B // 2]) != 0 \
                or not torch.equal(pn[~pb], nxt[~pb]):
            raise AssertionError(f"fused_decode_epilogue {name} poison "
                                 f"drill: nxt {pn.tolist()}, bad "
                                 f"{pb.tolist()}")

        def unfused_epilogue():
            h = F.rms_norm(x, norm_w, epsilon=eps)
            return guarded_argmax(tF.linear(h, w_lm), zero)

        ms = timed(lambda: fm.fused_decode_epilogue(
            x, norm_w, None, w_lm, None, zero, **ekw), 20)
        plain_ms = timed(lambda: fm.fused_decode_epilogue_plain(
            x, norm_w, None, w_lm, None, zero, transpose_lm=False,
            **ekw), 5)
        unfused_ms = timed(unfused_epilogue, 10)
        # the head, x, the norm's weight and the poison lane read; the
        # logits, nxt (int64) and bad (bool) written
        rows["fused_decode_epilogue"].append(_decode_row(
            name, _max_err(lg, rlg), ms, plain_ms, unfused_ms,
            4 * (V * H + B * H + H + B + B * V) + 9 * B,
            2 * B * V * H + 6 * B * H,
            dict(x=[B, H], w_lm=[V, H], near_ties=ties), power,
            "fused_decode_epilogue"))
        del x, lg, rlg
    del w_lm, norm_w
    torch.cuda.empty_cache()
    return rows


def tp_partial_cases(seed, power, flush):
    """``fused_decode_mlp_partial`` (row 6, the shard-local decode MLP of
    TP serving) against its plain version at the shapes the TP=2
    megakernel legs give it: one rank's half of the MLP. LLaMA-7B (y1
    ``[B, 4096]``, gate and up ``[5504, 4096]``, down ``[4096, 5504]``,
    RMSNorm) at B = 8 (the engine's slots; the main case), 5 and 1, and
    GPT-124M (y1 ``[B, 768]``, fc1 ``[1536, 768]`` with its bias, fc2
    ``[768, 1536]``, LayerNorm) at B = 8 and 1. Values within TOL of the
    plain version's largest; each timed behind the device spin beside the
    unfused eager chain (the norm, the cuBLAS projections, the
    activation) of the unfused TP body. No library call computes it."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 19)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    def timed(fn, n):
        return _time_ms(fn, n, flush, spin=True)

    rows = []
    for arch, H, inter, L, cases in (("llama", 4096, 11008 // 2, 32,
                                      (8, 5, 1)),
                                     ("gpt", 768, 3072 // 2, 12, (8, 1))):
        resid = 0.02 / np.sqrt(2 * L)
        norm_w = 1.0 + rn(H, std=0.1)
        w1, w2 = rn(inter, H, std=0.02), rn(H, inter, std=resid)
        if arch == "llama":
            norm_b, b1, w_up, norm, eps = None, None, rn(inter, H, std=0.02), \
                "rms", 1e-6
        else:
            norm_b, b1, w_up, norm, eps = rn(H, std=0.1), rn(inter, std=0.02), \
                None, "layer", 1e-5
        for B in cases:
            y1 = rn(B, H)
            args = (y1, norm_w, norm_b, w1, b1, w2, w_up)
            kw = dict(arch=arch, norm=norm, eps=eps)
            out = fm.fused_decode_mlp_partial(*args, **kw)
            ref = fm.fused_decode_mlp_partial_plain(*args, **kw)
            torch.cuda.synchronize()

            def unfused():
                if arch == "llama":
                    h = F.rms_norm(y1, norm_w, epsilon=eps)
                    f = tF.silu(tF.linear(h, w1)) * tF.linear(h, w_up)
                else:
                    h = tF.layer_norm(y1, (H,), norm_w, norm_b, eps)
                    f = tF.gelu(tF.linear(h, w1, b1), approximate="tanh")
                return tF.linear(f, w2)

            ms = timed(lambda: fm.fused_decode_mlp_partial(*args, **kw), 30)
            plain_ms = timed(lambda: fm.fused_decode_mlp_partial_plain(
                *args, **kw), 5)
            unfused_ms = timed(unfused, 10)
            n_w = (3 if arch == "llama" else 2) * inter * H
            # the weights, y1 and the norm's (and fc1's) vectors read, the
            # partial written
            nbytes = 4 * (n_w + 2 * B * H + H * (1 if norm_b is None else 2)
                          + (inter if b1 is not None else 0))
            flops = 2 * B * n_w + 8 * B * inter
            name = ("llama7b" if arch == "llama" else "gpt124m") \
                + f"_tp2_decode_b{B}"
            shape = dict(y1=[B, H], w1=[inter, H], w2=[H, inter],
                         w_up=None if w_up is None else [inter, H],
                         grid=(fm.swiglu_grid(B, H, 0, inter, dev)
                               if arch == "llama" else None))
            rows.append(_decode_row(name, _max_err(out, ref), ms, plain_ms,
                                    unfused_ms, nbytes, flops, shape, power,
                                    "fused_decode_mlp_partial"))
            del y1, args, out, ref
        del norm_w, norm_b, w1, b1, w2, w_up
        torch.cuda.empty_cache()
    return rows


def decode_kernel_cases(seed, power, flush):
    """The three fused decode kernels against their plain versions at the
    megakernel serve phase's shapes (GPT-124M, ``GEO``): x ``[8, 768]``,
    pools ``[12, 513, 16, 64]``, tables ``[8, 64]``, the tied embedding
    ``[50304, 768]``; the ingress also over int8 pools with their
    ``[12, 513, 16]`` scale pools at B = 8 and 1 (q within TOL of the
    plain version's largest value, int8 bytes within one step with the
    count reported, scales within 1e-6 relative). Each row also times the unfused eager chain the
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
    del kk, vk, kp, vp

    # ... over int8 pools with scale pools (the per-head kernel: the
    # fused weight and bias cut into q/k/v views, quantize-on-write), as
    # the megakernel serve over int8 pools gives it
    qkv8_rows = []
    for b8 in (B, 1):
        x8, pos8, bt8 = x[:b8], pos[:b8], bt[:b8]
        pools = [torch.randint(-127, 128, k0.shape, generator=gen,
                               device=dev, dtype=torch.int8)
                 for _ in range(2)]
        pools += [torch.rand(k0.shape[:3], generator=gen, device=dev) * 0.1
                  + 0.01 for _ in range(2)]
        mine = [t.clone() for t in pools]
        out8 = fq.fused_decode_qkv(x8, ln_w, ln_b, w, b, pos8, bt8, *mine,
                                   **kw)
        ref8 = fq.fused_decode_qkv_plain(x8, ln_w, ln_b, w, b, pos8, bt8,
                                         *pools, **kw)
        torch.cuda.synchronize()
        name = f"gpt124m_decode_b{b8}_int8"
        _, off = _pool_errs("fused_decode_qkv", name, out8[1:], ref8[1:])

        def unfused_qkv8():
            h = tF.layer_norm(x8, (H,), ln_w, ln_b, eps)
            qkv = tF.linear(h, w, b).reshape(b8, 1, 3, nh, hd)
            _, k, v = qkv.unbind(2)
            _slot_page_write(k[:, 0].transpose(0, 1),
                             v[:, 0].transpose(0, 1), mine[0], mine[1], bt8,
                             pos8, mine[2], mine[3])

        # W and its bias, x, the norm's w and b read; q, the K/V bytes and
        # their scales written; positions and one table entry per row read
        qkv8_rows.append(_decode_row(
            name, _max_err(out8[0], ref8[0]),
            timed(lambda: fq.fused_decode_qkv(x8, ln_w, ln_b, w, b, pos8,
                                              bt8, *mine, **kw), 50),
            timed(lambda: fq.fused_decode_qkv_plain(
                x8, ln_w, ln_b, w, b, pos8, bt8, *pools, **kw), 10),
            timed(unfused_qkv8, 20),
            4 * (n_out * H + n_out + b8 * H + 2 * H + b8 * H)
            + 2 * b8 * H + 2 * 4 * b8 * nh + 8 * b8 + 4 * b8,
            2 * b8 * n_out * H + 8 * b8 * H + 6 * b8 * 2 * H,
            dict(x=[b8, H], w=[n_out, H], pools=list(k0.shape),
                 dtype="int8", tables=list(bt8.shape),
                 int8_bytes_off_by_one=off),
            power, "fused_decode_qkv"))
        del pools, mine, out8, ref8
    del w, b

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
    return {"fused_decode_qkv": [qkv_row] + qkv8_rows,
            "fused_decode_mlp": [mlp_row],
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
def teacher_forced_logits(model, ids, kv_quant=False):
    """Plain fp32 forward over one whole sequence: the same GPT blocks
    with the plain attention version (no kernel), one prefill chunk; with
    ``kv_quant``, over int8 pools (each K/V vector through
    ``kv_quantize`` as it is written, dequantized as it is read)."""
    from paddle_tpu_torch.models.generation import _gpt_ragged_forward
    from paddle_tpu_torch.ops.cuda.paged_attention import \
        ragged_paged_attention_plain
    dev = model.device
    cfg, ps, qb = model.cfg, 16, 8
    S = len(ids)
    npg = -(-S // ps)
    shape = (cfg.num_heads, npg + 1, ps, cfg.head_dim)
    caches = [torch.zeros(shape, device=dev, dtype=torch.int8 if kv_quant
                          else torch.float32)
              for _ in range(2 * cfg.num_layers)]
    if kv_quant:
        caches += [torch.zeros(shape[:3], device=dev)
                   for _ in range(2 * cfg.num_layers)]
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


def serve_prompts(seed, cfg, n=16):
    """The serve phases' 16 prompts, 16-512 tokens, from the seed (the
    first ``n`` of them)."""
    rng = np.random.default_rng(seed + 1)
    longest = min(512, cfg.max_seq_len - NEW_TOKENS)
    return [rng.integers(0, min(cfg.vocab_size, 50257), int(n))
            .astype(np.int32) for n in rng.integers(16, longest + 1, 16)][:n]


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
    log(f"{model.cfg.num_layers}-layer {type(model).__name__} served in "
        f"turns: " + "; ".join(
            f"{'megakernel' if r['megakernel'] else 'unfused'} "
            f"{r['tokens_per_s']:.1f} tokens/s, mixed "
            f"{r['mixed_step_ms']:.2f} ms, decode "
            f"{r['decode_dispatch_ms']:.2f} ms" for r in runs))
    return runs


def _drive(eng, on_card):
    """Step ``eng`` to the drain. Per dispatch, the kernel launches must be
    what the path makes: a forward (a mixed step, or each decode step: the
    bootstrap's one, or each of a window's ``decode_window``) launches the
    attention once per layer and ``weight_only_matmul`` once per
    weight-only projection of the model (none for a float model); a
    decode step with ``megakernel`` also ``fused_decode_qkv`` and
    ``fused_decode_mlp`` (under tensor parallelism
    ``fused_decode_mlp_partial`` instead) once per layer and
    ``fused_decode_epilogue`` once, any other step none of them. Under
    tensor parallelism every forward also runs 2 L all-reduces (checked
    on the CPU too). Returns (completions, launches by dispatch kind, host
    ms by kind)."""
    from paddle_tpu_torch.distributed import all_reduce
    from paddle_tpu_torch.quantization import WeightOnlyLinear
    L = eng.model.cfg.num_layers
    n_mm = sum(isinstance(m, WeightOnlyLinear) for m in eng.model.modules())
    tp = eng.tp > 1
    fused = ("fused_decode_qkv", "fused_decode_mlp",
             "fused_decode_mlp_partial", "fused_decode_epilogue",
             "weight_only_matmul")
    launches = {"mixed": dict.fromkeys(counters(), 0),
                "decode": dict.fromkeys(counters(), 0)}
    step_ms = {"mixed": [], "decode": []}
    done = {}
    while eng.has_work:
        st = eng.stats
        single = eng._geometry() not in eng._decoded_geometries()
        before = read_counts()
        reduces = all_reduce.calls
        ts = time.perf_counter()
        done.update({c.request_id: c for c in eng.step()})
        dt = (time.perf_counter() - ts) * 1e3
        after = read_counts()
        got = {k: after[k] - before[k] for k in after}
        if eng.stats["mixed_steps"] > st["mixed_steps"]:
            kind, k = "mixed", 1
            want = {"ragged_paged_attention": L, "weight_only_matmul": n_mm}
        elif eng.stats["decode_dispatches"] > st["decode_dispatches"]:
            kind = "decode"
            k = 1 if single else eng.decode_window
            want = {"ragged_paged_attention": L * k,
                    "weight_only_matmul": n_mm * k}
            if eng.megakernel:
                want.update(fused_decode_qkv=L * k, fused_decode_epilogue=k)
                want["fused_decode_mlp_partial" if tp
                     else "fused_decode_mlp"] = L * k
        else:
            continue
        want = {n: want.get(n, 0) for n in ("ragged_paged_attention",)
                + fused}
        if on_card and {n: got[n] for n in want} != want:
            raise AssertionError(f"{kind} dispatch (single step: {single}) "
                                 f"launched {got}, want {want}")
        if tp and all_reduce.calls - reduces != 2 * L * k:
            raise AssertionError(f"{kind} dispatch (single step: {single}) "
                                 f"ran {all_reduce.calls - reduces} "
                                 f"all-reduces, want {2 * L * k}")
        for n, v in got.items():
            launches[kind][n] += v
        step_ms[kind].append(dt)
    return done, launches, step_ms


def _gpt_teacher(model, prompts, seqs, kv_quant=False):
    """The plain fp32 forward's logits at each sequence's generated
    positions (:func:`teacher_forced_logits`, one sequence at a time)."""
    return [teacher_forced_logits(model, seq, kv_quant)[p.size - 1:
                                                        seq.size - 1]
            for p, seq in zip(prompts, seqs)]


def _gpt_teacher_kv8(model, prompts, seqs):
    return _gpt_teacher(model, prompts, seqs, kv_quant=True)


def serve_phase(seed, cfg=None, device="cuda", megakernel=False, model=None,
                kv_quant=False):
    """Serve 16 requests through the engine and check them, with the
    decode path unfused or (``megakernel``) fused, over fp32 pools or
    (``kv_quant``) int8 pools, whose teacher replays the quantization.
    Over int8 pools the near-tie margin is twice this model's own
    :func:`logit_gap` along the served decode path, measured first (at
    least MARGIN; MARGIN_KV8 is LLaMA-7B's reading), and the gap is
    returned as ``logit_gap``. ``cfg`` defaults to GPT-124M; a
    smaller one (with ``device="cpu"``) rehearses this phase without a
    card, and without launch checks or the device-time breakdown
    (:func:`profile_serve`). ``model`` reuses a model from
    :func:`serve_model`."""
    model = serve_model(seed, cfg, device) if model is None else model
    tag = "megakernel serve" if megakernel else "serve"
    if kv_quant:
        tag += " (int8 KV)"
        gap = logit_gap(model, seed, True, megakernel=megakernel)
        log(f"{tag}: the served path's logits vs the plain forward's, 4 "
            f"prompts + {NEW_TOKENS} tokens"
            + (", each a fused decode step" if megakernel else
               " as one prefill")
            + f": max |difference| {gap:.4g}; near-tie margin twice that")
        out = _serve_run(model, seed, device, tag, _gpt_teacher_kv8,
                         margin=max(MARGIN, 2 * gap), megakernel=megakernel,
                         kv_quant=True)
        out["logit_gap"] = gap
        return out
    return _serve_run(model, seed, device, tag, _gpt_teacher,
                      megakernel=megakernel)


def _serve_run(model, seed, device, tag, teacher, margin=MARGIN,
               full_profile=True, requests=16, **engine_kw):
    """The serve phases' drive and checks: a warm-up engine, then the 16
    requests of :func:`serve_prompts` (the first ``requests``) on a fresh
    engine (``GEO`` and
    ``engine_kw``) with exact launches per dispatch (:func:`_drive`),
    every request finished by length, the page pool conserved, every
    served token the pick of ``teacher(model, prompts, sequences)`` (the
    logits at the generated positions) except near ties below ``margin``
    (:func:`_teacher_check`; with ``teacher`` None the caller checks the
    returned ``sequences``); on the card a profiled decode window and,
    with ``full_profile``, a profiled run. One engine's pools exist at a
    time."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    on_card = device == "cuda"
    megakernel = engine_kw.get("megakernel", False)
    geo = dict(GEO, device=device, **engine_kw)
    prompts = serve_prompts(seed, model.cfg, requests)

    # warm-up on another engine (cuBLAS handles, allocator); it also
    # runs this geometry's first single-step decode (the geometry
    # includes the megakernel switch)
    warm = ContinuousBatchingEngine(model, **geo)
    warm.add_request(prompts[0][:16], 8)
    _drive(warm, on_card)
    del warm

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
    del eng
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

    seqs = [np.concatenate([p, done[rid].tokens]) for rid, p in
            zip(rids, prompts)]
    out = dict(megakernel=megakernel, kv_quant=geo.get("kv_quant", False),
               launches=counts["ragged_paged_attention"], counts=counts,
               by_step=by_step, wall_s=wall, tokens=gen_tokens,
               tokens_per_s=gen_tokens / wall,
               mixed_step_ms=float(np.mean(step_ms["mixed"])),
               decode_dispatch_ms=float(np.mean(step_ms["decode"])),
               decode_dispatches=len(step_ms["decode"]), stats=st)
    if teacher is None:
        out["sequences"] = [q.tolist() for q in seqs]
    else:
        out.update(_teacher_check(model, teacher, prompts, seqs, margin,
                                  tag))
    if on_card:
        if full_profile:
            out["profile"] = profile_serve(model, prompts, NEW_TOKENS, geo,
                                           wall)
        out["window"] = profile_window(model, prompts, NEW_TOKENS, geo)
    return out


def _teacher_check(model, teacher, prompts, seqs, margin, tag):
    """Teacher-forced check against a plain fp32 forward: every served
    token of ``seqs`` (each prompt of ``prompts`` and its served tokens)
    must be the pick of ``teacher(model, prompts, seqs)`` (the logits at
    the generated positions), except near ties below ``margin``."""
    near_ties = checked = 0
    t0 = time.perf_counter()
    ref = teacher(model, prompts, seqs)
    teacher_s = time.perf_counter() - t0
    for rid, (p, seq, lg) in enumerate(zip(prompts, seqs, ref)):
        toks = seq[p.size:]
        if not torch.isfinite(lg).all():
            raise AssertionError(f"request {rid}: non-finite logits")
        top2 = lg.topk(2, dim=-1)
        pred = top2.indices[:, 0].cpu().numpy()
        gaps = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
        for i, (t, pr, m) in enumerate(zip(toks, pred, gaps)):
            checked += 1
            if t == pr:
                continue
            if m < margin:
                near_ties += 1
                continue
            raise AssertionError(
                f"request {rid} token {i}: served {t}, plain forward "
                f"picks {pr} with top-2 margin {m:.3g}")
    log(f"{tag}: teacher-forced check: {checked} tokens, {near_ties} near "
        f"ties (top-2 margin < {margin}); reference forward "
        f"{teacher_s:.2f} s")
    return dict(checked=checked, margin=margin, near_ties=near_ties)


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
    clock is timed in a second window without the profiler, and, under
    tensor parallelism, the host time of its all-reduces beside it: the
    sums alone (``all_reduce.seconds``) and, apart, gloo's wait for the
    device work queued before each sum (``all_reduce.wait_seconds``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.distributed import all_reduce
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
    calls, secs, waits = (all_reduce.calls, all_reduce.seconds,
                          all_reduce.wait_seconds)
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    reduce_ms, calls = (all_reduce.seconds - secs) * 1e3, \
        all_reduce.calls - calls
    wait_ms = (all_reduce.wait_seconds - waits) * 1e3
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    n = sum(e.count for e in evs)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    path = "megakernel" if geo.get("megakernel") else "unfused"
    if geo.get("kv_quant"):
        path += ", int8 KV"
    log(f"decode window ({path}, {k} steps, {eng.max_slots} slots): {n} "
        f"device launches = "
        f"{n / k:.1f} per decode step, device {dev_ms:.3f} ms = "
        f"{dev_ms / k:.4f} ms per step; unprofiled window {host_ms:.3f} ms "
        f"of wall clock = {host_ms / k:.4f} ms per step, device busy "
        f"{dev_ms / host_ms:.1%}")
    out = dict(steps=k, device_launches=n, launches_per_step=n / k,
               device_ms=dev_ms, device_ms_per_step=dev_ms / k,
               wall_ms=host_ms, wall_ms_per_step=host_ms / k,
               busy_share=dev_ms / host_ms)
    if calls:
        out.update(all_reduces_per_step=calls / k,
                   all_reduce_ms_per_call=reduce_ms / calls,
                   all_reduce_share=reduce_ms / host_ms,
                   all_reduce_wait_ms_per_call=wait_ms / calls,
                   all_reduce_wait_share=wait_ms / host_ms)
        log(f"decode window ({path}): {calls / k:.0f} all-reduces a step, "
            f"{reduce_ms / calls:.4f} ms each of host time (gloo, through "
            f"the host) = {reduce_ms / host_ms:.1%} of the window's wall "
            f"clock; before each, {wait_ms / calls:.4f} ms waiting for the "
            f"device work queued before it = {wait_ms / host_ms:.1%}")
    return out


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
    # the flash kernels of both routes (not their wrappers' own ops)
    flash = sum(ms for key, ms, _ in kernels if "flash_" in key)
    if flash:
        log(f"profile: flash kernels {flash:.3f} ms = {flash / busy:.1%} of "
            f"the device time")
    return dict(busy_ms=busy, wall_ms=wall_ms, busy_share=busy / wall_ms,
                profiled_wall_ms=prof_wall_ms, flash_ms=flash,
                flash_share=flash / busy if busy else 0.0,
                launches=sum(n for *_, n in kernels),
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


@contextlib.contextmanager
def phase_settings(glue, norm_backend):
    """``train_glue_fusion`` set to ``glue`` and ``PDTPU_NORM_BACKEND`` set
    to ``pallas`` (or unset) for one phase; both restored after."""
    from paddle_tpu_torch.core import state as flags
    from paddle_tpu_torch.nn.functional.norm import NORM_BACKEND_ENV
    old_flag = flags.get_flag("train_glue_fusion")
    old_env = os.environ.pop(NORM_BACKEND_ENV, None)
    flags.set_flags({"train_glue_fusion": glue})
    if norm_backend:
        os.environ[NORM_BACKEND_ENV] = "pallas"
    try:
        yield
    finally:
        flags.set_flags({"train_glue_fusion": old_flag})
        os.environ.pop(NORM_BACKEND_ENV, None)
        if old_env is not None:
            os.environ[NORM_BACKEND_ENV] = old_env


def gpt_train_config():
    """GPT-124M in bench.py's training configuration (12 layers of 768,
    vocab 50304, 1024 positions), recompute
    ``dots_and_kernels_saveable``."""
    from paddle_tpu_torch.models import GPTConfig
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_seq_len=1024, dropout=0.0,
                     recompute=True,
                     recompute_policy="dots_and_kernels_saveable")


def train_phase(seed, cfg=None, device="cuda", batch=8, seq=1024, warmup=2,
                steps=10, power="", glue=False, norm_backend=False,
                weights=None, flash=True):
    """Train GPT-124M in bench.py's configuration through the Paddle
    entry points (:func:`train_run`): the flash forward and backward once
    per layer a step, all on the tensor-core route (bf16 under O2), the
    first loss within 0.5 of ln(vocab); with ``flash=False``
    (``use_flash_attention=False``) the unfused plain attention and no
    flash launch. With
    ``glue`` (``train_glue_fusion``) also the fused residual + LayerNorm
    forward and backward 2 L times each (L - 1 ln1, L ln2 and ln_f);
    with ``norm_backend`` (``PDTPU_NORM_BACKEND=pallas``) the LayerNorm
    kernels 2 L + 1 times each. ``weights`` reuses one draw (JAX layout);
    ``cfg``/``device``/``batch``/``seq`` shrink it to rehearse on the CPU
    (no launch counts, no profile). The settings are restored after."""
    import dataclasses

    from paddle_tpu_torch.models import GPTForCausalLM, load_gpt_from_jax
    cfg = gpt_train_config() if cfg is None else cfg
    cfg = dataclasses.replace(cfg, use_flash_attention=flash)
    model = GPTForCausalLM(cfg, device=device)
    load_gpt_from_jax(model, jax_layout_gpt_weights(cfg, seed)
                      if weights is None else weights)
    L = cfg.num_layers
    want = dict(flash_attention_fwd=L, flash_attention_bwd=L,
                flash_attention_fwd_tc=L, flash_attention_bwd_tc=L) \
        if flash else {}
    if glue:
        want.update(fused_residual_layer_norm_fwd=2 * L,
                    fused_residual_layer_norm_bwd=2 * L)
    if norm_backend:
        want.update(layer_norm_fwd=2 * L + 1, layer_norm_bwd=2 * L + 1)
    tag = "train: GPT" + (", glue on" if glue else "") + \
        (", norm backend" if norm_backend else "") + \
        ("" if flash else ", use_flash_attention=False")
    with phase_settings(glue, norm_backend):
        out = train_run(model, cfg, seed, device, batch, seq, warmup, steps,
                        want, float(np.log(cfg.vocab_size)), tag, power)
    return dict(out, glue=glue, norm_backend=norm_backend, flash=flash)


# the first losses of two runs from one draw and one first batch, glue or
# the norm backend on and off, or flash attention on and off, agree
# within this (the fused kernels round in another order; the LLaMA runs
# differ by ~3e-4)
FIRST_LOSS_GAP = 1e-2


def _compare_runs(tag, base, other, what, base_name="off"):
    gap = abs(other["losses"][0] - base["losses"][0])
    if not gap <= FIRST_LOSS_GAP:
        raise AssertionError(f"{tag}: first loss {what} "
                             f"{other['losses'][0]:.5f} vs "
                             f"{base['losses'][0]:.5f} (gap {gap:.3g} > "
                             f"{FIRST_LOSS_GAP})")
    gaps = [abs(a - b) for a, b in zip(other["losses"], base["losses"])]
    prof = [r.get("profile", {}) for r in (other, base)]
    log(f"{tag}: {what} vs {base_name}: first loss "
        f"{other['losses'][0]:.5f} vs "
        f"{base['losses'][0]:.5f} (gap {gap:.3g} <= {FIRST_LOSS_GAP}; "
        f"largest gap over the common steps {max(gaps):.3g}); step "
        f"{other['step_ms']:.2f} vs {base['step_ms']:.2f} ms; MFU "
        f"{other['mfu'] or 0:.2%} vs {base['mfu'] or 0:.2%}; busy "
        f"{prof[0].get('busy_share', 0):.1%} vs "
        f"{prof[1].get('busy_share', 0):.1%}; device launches a step "
        f"{prof[0].get('launches')} vs {prof[1].get('launches')}")
    return dict(first_loss_gap=gap, max_loss_gap=max(gaps))


def gpt_train_phases(seed, power):
    """The GPT train phase with glue off, glue on and, with glue off, the
    norm backend (5 timed steps), all from one draw of the weights and
    the same batches; each first loss within FIRST_LOSS_GAP of glue
    off's. Then glue off without flash attention (1 + 2 steps): its
    first loss within FIRST_LOSS_GAP of the flash run's, kept in glue
    off's result as ``no_flash``."""
    cfg = gpt_train_config()
    weights = jax_layout_gpt_weights(cfg, seed)
    off = train_phase(seed, cfg, power=power, weights=weights)
    on = train_phase(seed, cfg, power=power, weights=weights, glue=True)
    backend = train_phase(seed, cfg, power=power, weights=weights,
                          norm_backend=True, steps=5)
    plain = train_phase(seed, cfg, power=power, weights=weights,
                        flash=False, warmup=1, steps=2)
    del weights
    on["vs_glue_off"] = _compare_runs("train: GPT", off, on, "glue on")
    backend["vs_glue_off"] = _compare_runs("train: GPT", off, backend,
                                           "norm backend")
    off["no_flash"] = dict(
        _compare_runs("train: GPT", off, plain, "use_flash_attention=False",
                      "flash attention"),
        losses=plain["losses"], step_ms=plain["step_ms"],
        busy_share=plain.get("profile", {}).get("busy_share"))
    return off, on, backend


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


def train_parity(seed, glue=False):
    """:func:`parity_step` at GPT-124M widths, 2 layers, batch 2 x 256,
    recompute ``dots_and_kernels_saveable``; with ``glue`` under
    ``train_glue_fusion`` (the fused residual + LayerNorm pair 4 times
    each way)."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_gpt_from_jax)
    cfg = GPTConfig(num_layers=2, recompute=True,
                    recompute_policy="dots_and_kernels_saveable")
    weights = jax_layout_gpt_weights(cfg, seed + 3)
    ids, lab = _batch_fn(cfg, 2, 256, seed + 4)()

    def make(dev):
        return load_gpt_from_jax(GPTForCausalLM(cfg, device=dev), weights)
    want = dict(flash_attention_fwd=2, flash_attention_bwd=2, fused_update=1)
    if glue:
        want.update(fused_residual_layer_norm_fwd=4,
                    fused_residual_layer_norm_bwd=4)
    with phase_settings(glue, False):
        out = parity_step(make, ids, lab, 1e-4, want,
                          "train parity" + (" (glue on)" if glue else ""))
    return dict(out, glue=glue)


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


# -------------------------------------------------------- norm kernels --
def _row_case(rows, name, kname, errs, ms, plain_ms, nbytes, flops, power,
              shape, dt, library_ms=None, library="none: no single call",
              unfused_ms=None):
    """One kernel case row (bound from this case's bytes and fp32 flops),
    logged and appended to ``rows``."""
    bound_ms, bound_by = _fp32_bound(nbytes, flops)
    row = dict(case=name, max_abs_err=max(e for e, _ in errs.values()),
               tolerance={k: lim for k, (_, lim) in errs.items()}, ms=ms,
               plain_ms=plain_ms, unfused_ms=unfused_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, library_ms=library_ms,
               library=library, rows=list(shape),
               dtype=str(dt).replace("torch.", ""))
    extra = "" if unfused_ms is None else f", unfused chain {unfused_ms:.4f} ms"
    if library_ms is not None:
        extra += f", library {library_ms:.4f} ms"
    log(f"kernel {kname} {name} {list(shape)} {row['dtype']}: max_abs_err "
        f"{row['max_abs_err']:.3g}, {ms:.4f} ms (plain {plain_ms:.4f} ms"
        f"{extra}, bound {bound_ms:.4f} ms by {bound_by}, "
        f"{bound_ms / ms:.1%} of bound) on {power}")
    rows.append(row)


def ln_pair_cases(seed, power, flush):
    """The fused residual + LayerNorm forward and backward kernels (rows
    9-10) against their plain versions: the GPT glue-on train phase's rows
    (x, y ``[8192, 768]`` bf16, w, b bf16, as under O2), fp32, and 8191
    rows (not a multiple of anything); bf16 within one bf16 rounding of
    the plain version run in fp32 on the same inputs (two for
    ``normed``, whose residual sum the kernel rounds first), fp32 within
    1e-5 (dw, db within 1e-5 of their column's sum of magnitudes).
    ``unfused_ms`` times the glue-off chain: ``ops.add`` + ``F.layer_norm``
    under O2 auto_cast, and autograd's backward of it. No single PyTorch
    call computes either function (``library_ms`` null). Every time is
    taken behind the device spin of :func:`_time_ms`: a launch here is
    shorter than its wrapper's host time."""
    from paddle_tpu_torch import amp, ops
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.cuda import fused_residual_norm as fr
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    eps = 1e-5
    cases = [("gpt124m_bf16", 8192, 768, torch.bfloat16),
             ("gpt124m_f32", 8192, 768, torch.float32),
             ("rows8191_bf16", 8191, 768, torch.bfloat16)]
    fwd_rows, bwd_rows = [], []
    for name, n, h, dt in cases:
        def rn(*shape, std=1.0):
            return torch.randn(*shape, generator=gen, device=dev) * std
        x, y, dres, dn = (rn(n, h).to(dt) for _ in range(4))
        w, b = (1.0 + rn(h, std=0.1)).to(dt), rn(h, std=0.1).to(dt)
        res, normed, mean, rstd = fr.fused_residual_layer_norm_fwd(
            x, y, w, b, eps)
        d, dw, db = fr.fused_residual_layer_norm_bwd(res, w, mean, rstd,
                                                     dres, dn)
        d0, _, _ = fr.fused_residual_layer_norm_bwd(res, w, mean, rstd,
                                                    None, dn)
        f32 = [t.float() for t in (x, y, w, b, dres, dn)]
        rres, rnormed, rmean, rrstd = fr.fused_residual_layer_norm_fwd_plain(
            *f32[:4], eps)
        # the backward's plain version on the kernel's own res and stats
        rd, rdw, rdb = fr.fused_residual_layer_norm_bwd_plain(
            res.float(), f32[2], mean, rstd, f32[4], f32[5])
        rd0, _, _ = fr.fused_residual_layer_norm_bwd_plain(
            res.float(), f32[2], mean, rstd, None, f32[5])
        torch.cuda.synchronize()
        bf = dt == torch.bfloat16
        ferrs = {"res": _err(res, rres, bf),
                 "normed": _err(normed, rnormed, bf, roundings=2),
                 "mean": _err(mean, rmean, bf), "rstd": _err(rstd, rrstd, bf)}
        berrs = {"d": _err(d, rd, bf), "d_without_dres": _err(d0, rd0, bf),
                 "dw": _err(dw, rdw, bf), "db": _err(db, rdb, bf)}
        if not bf:
            xhat = (res.float() - mean) * rstd
            for k, terms in (("dw", f32[5] * xhat), ("db", f32[5])):
                berrs[k] = (berrs[k][0],
                            1e-5 * float(terms.abs().sum(dim=0).max()))
        _check_errs(f"fused_residual_layer_norm_fwd {name}", ferrs)
        _check_errs(f"fused_residual_layer_norm_bwd {name}", berrs)
        del f32, rres, rnormed, rmean, rrstd, rd, rdw, rdb, rd0, d0

        # GPT's LayerNorm weights stay fp32 under O2 (the fused pair gets
        # them cast to bf16)
        xg, yg, wg, bg = (t.detach().clone().requires_grad_()
                          for t in (x, y, w.float(), b.float()))

        def glue_off():
            with amp.auto_cast(enable=bf, level="O2", dtype="bfloat16"):
                r = ops.add(xg, yg)
                return r, PF.layer_norm(r, h, wg, bg, eps)

        with torch.no_grad():
            unf_f = _time_ms(glue_off, 20, flush, spin=True)
        r_u, h_u = glue_off()
        unf_b = _time_ms(lambda: torch.autograd.grad(
            (r_u, h_u), (xg, yg, wg, bg), (dres.to(r_u.dtype),
                                           dn.to(h_u.dtype)),
            retain_graph=True), 10, flush, spin=True)
        del r_u, h_u, xg, yg, wg, bg
        esize = x.element_size()
        rows_bytes = n * h * esize
        for rows, errs, unf, fn, pfn, nbytes, flops, which in (
                (fwd_rows, ferrs, unf_f,
                 lambda: fr.fused_residual_layer_norm_fwd(x, y, w, b, eps),
                 lambda: fr.fused_residual_layer_norm_fwd_plain(x, y, w, b,
                                                                eps),
                 # x, y, w, b read; res, normed, mean, rstd written
                 4 * rows_bytes + 2 * h * esize + 8 * n, 10 * n * h, "fwd"),
                (bwd_rows, berrs, unf_b,
                 lambda: fr.fused_residual_layer_norm_bwd(res, w, mean, rstd,
                                                          dres, dn),
                 lambda: fr.fused_residual_layer_norm_bwd_plain(
                     res, w, mean, rstd, dres, dn),
                 # res, dres, dnormed, w, mean, rstd read; d, dw, db written
                 4 * rows_bytes + 3 * h * esize + 8 * n, 14 * n * h, "bwd")):
            _row_case(rows, name, f"fused_residual_layer_norm_{which}", errs,
                      _time_ms(fn, 50, flush, spin=True),
                      _time_ms(pfn, 10, flush, spin=True),
                      nbytes, flops, power, (n, h), dt, unfused_ms=unf)
        del x, y, w, b, dres, dn, res, normed, mean, rstd, d, dw, db
        torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def norm_cases(seed, power, flush):
    """The norm kernels (rows 13-16) against their plain versions, at the
    shapes of the norm-backend train phases: LayerNorm at GPT-124M's rows
    (``[8192, 768]`` fp32, as the black list casts them under O2; and
    8191 rows), RMSNorm at LLaMA-7B's (``[4096, 4096]`` fp32, and bf16 as
    ``incubate.fused_rms_norm`` gives it under O2; the incubate call must
    launch the kernel once and return its result). Tolerances as
    :func:`ln_pair_cases` (bf16: one rounding). ``library_ms`` times
    ``torch.nn.functional.layer_norm`` / ``rms_norm`` forward, and for a
    backward row autograd's backward of that call (one
    ``torch.autograd.grad``); all behind the device spin, as
    :func:`ln_pair_cases`."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops.cuda import norms as nm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    cases = [("layer", "gpt124m_f32", 8192, 768, torch.float32),
             ("layer", "rows8191_f32", 8191, 768, torch.float32),
             ("rms", "llama7b_f32", 4096, 4096, torch.float32),
             ("rms", "llama7b_bf16_incubate", 4096, 4096, torch.bfloat16)]
    out = {k: [] for k in ("rms_norm_fwd", "rms_norm_bwd", "layer_norm_fwd",
                           "layer_norm_bwd")}
    for norm, name, n, h, dt in cases:
        def rn(*shape, std=1.0):
            return torch.randn(*shape, generator=gen, device=dev) * std
        x, g = rn(n, h).to(dt), rn(n, h).to(dt)
        w, b = (1.0 + rn(h, std=0.1)).to(dt), rn(h, std=0.1).to(dt)
        bf = dt == torch.bfloat16
        f32 = [t.float() for t in (x, w, b, g)]
        layer = norm == "layer"
        if layer:
            eps = 1e-5
            o, mean, rstd = nm.layer_norm_fwd(x, w, b, eps)
            dx, dw, db = nm.layer_norm_bwd(x, w, mean, rstd, g)
            ro, rmean, rrstd = nm.layer_norm_fwd_plain(*f32[:3], eps)
            rdx, rdw, rdb = nm.layer_norm_bwd_plain(f32[0], f32[1], mean,
                                                    rstd, f32[3])
            xhat = (f32[0] - mean) * rstd
            fwd = lambda: nm.layer_norm_fwd(x, w, b, eps)  # noqa: E731
            pfwd = lambda: nm.layer_norm_fwd_plain(x, w, b, eps)  # noqa
            bwd = lambda: nm.layer_norm_bwd(x, w, mean, rstd, g)  # noqa
            pbwd = lambda: nm.layer_norm_bwd_plain(  # noqa: E731
                x, w, mean, rstd, g)
            lib = lambda xx, ww, bb: TF.layer_norm(  # noqa: E731
                xx, (h,), ww, bb, eps)
        else:
            eps = 1e-6
            o, rstd = nm.rms_norm_fwd(x, w, eps)
            dx, dw = nm.rms_norm_bwd(x, w, rstd, g)
            ro, rrstd = nm.rms_norm_fwd_plain(f32[0], f32[1], eps)
            rdx, rdw = nm.rms_norm_bwd_plain(f32[0], f32[1], rstd, f32[3])
            xhat = f32[0] * rstd
            fwd = lambda: nm.rms_norm_fwd(x, w, eps)  # noqa: E731
            pfwd = lambda: nm.rms_norm_fwd_plain(x, w, eps)  # noqa: E731
            bwd = lambda: nm.rms_norm_bwd(x, w, rstd, g)  # noqa: E731
            pbwd = lambda: nm.rms_norm_bwd_plain(x, w, rstd, g)  # noqa
            lib = lambda xx, ww, bb: TF.rms_norm(  # noqa: E731
                xx, (h,), ww, eps)
        if bf:
            # the incubate entry on the card: one kernel launch, the
            # kernel's own result
            before = nm.rms_norm_fwd.launches
            io, ires = IF.fused_rms_norm(x, w, None, eps, -1)
            if nm.rms_norm_fwd.launches != before + 1 or not (
                    torch.equal(io, o) and ires is x):
                raise AssertionError("incubate fused_rms_norm did not take "
                                     "the rms_norm kernel on the card")
        torch.cuda.synchronize()
        ferrs = {"out": _err(o, ro, bf), "rstd": _err(rstd, rrstd, bf)}
        berrs = {"dx": _err(dx, rdx, bf), "dw": _err(dw, rdw, bf)}
        terms = [("dw", f32[3] * xhat)]
        if layer:
            ferrs["mean"] = _err(mean, rmean, bf)
            berrs["db"] = _err(db, rdb, bf)
            terms.append(("db", f32[3]))
        if not bf:
            for k, t in terms:
                berrs[k] = (berrs[k][0],
                            1e-5 * float(t.abs().sum(dim=0).max()))
        kname = "layer_norm" if layer else "rms_norm"
        _check_errs(f"{kname}_fwd {name}", ferrs)
        _check_errs(f"{kname}_bwd {name}", berrs)
        del f32, ro, rrstd, rdx, rdw, xhat

        xg, wg, bg = (t.detach().clone().requires_grad_() for t in (x, w, b))
        with torch.no_grad():
            lib_f = _time_ms(lambda: lib(xg, wg, bg), 20, flush, spin=True)
        lo = lib(xg, wg, bg)
        lib_b = _time_ms(lambda: torch.autograd.grad(
            lo, (xg, wg, bg) if layer else (xg, wg), g, retain_graph=True),
            20, flush, spin=True)
        del lo, xg, wg, bg
        esize = x.element_size()
        rows_bytes = n * h * esize
        nvec = 2 if layer else 1     # w (and b) read; dw (and db) written
        nstat = 8 * n if layer else 4 * n
        for which, errs, fn, pfn, lib_ms, nbytes, flops in (
                ("fwd", ferrs, fwd, pfwd, lib_f,
                 2 * rows_bytes + nvec * h * esize + nstat, 8 * n * h),
                ("bwd", berrs, bwd, pbwd, lib_b,
                 3 * rows_bytes + (1 + nvec) * h * esize + nstat,
                 12 * n * h)):
            _row_case(out[f"{kname}_{which}"], name, f"{kname}_{which}", errs,
                      _time_ms(fn, 50, flush, spin=True),
                      _time_ms(pfn, 10, flush, spin=True),
                      nbytes, flops, power, (n, h), dt, library_ms=lib_ms,
                      library=f"torch.nn.functional.{kname}"
                      + (" backward (autograd.grad)" if which == "bwd"
                         else ""))
        del x, g, w, b, o, rstd, dx, dw
        torch.cuda.empty_cache()
    return out


def norm_kernel_phase(seed, power):
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = norm_cases(seed, power, flush)
    rows["fused_residual_layer_norm_fwd"], \
        rows["fused_residual_layer_norm_bwd"] = ln_pair_cases(seed, power,
                                                               flush)
    del flush
    torch.cuda.empty_cache()
    return rows


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
                      seq=2048, warmup=2, steps=5, power="", state=None,
                      norm_backend=False):
    """Train LLaMA (default: :func:`llama_train_config`) through the
    Paddle entry points (:func:`train_run`) with ``train_glue_fusion`` set
    to ``glue``: every step launches the flash forward and backward once
    per layer, rope four times per layer (q and k, forward and backward)
    and the fused residual + RMSNorm forward and backward 2 L times each
    with glue on (none with it off), and with ``norm_backend``
    (``PDTPU_NORM_BACKEND=pallas``) the RMSNorm kernels 2 L + 1 times
    each; the first loss within 0.5 of :func:`expected_first_loss`.
    ``state`` reuses a torch state_dict of the weights (one draw for
    every run); ``cfg``/``device``/``batch``/``seq`` shrink it to
    rehearse on the CPU (no launch counts, no profile). The settings are
    restored after."""
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         llama_state_from_jax)
    cfg = llama_train_config() if cfg is None else cfg
    if state is None:
        state = llama_state_from_jax(jax_layout_llama_weights(cfg, seed))
    model = LlamaForCausalLM(cfg, device=device)
    model.load_state_dict(state, strict=True)
    L = cfg.num_layers
    want = dict(flash_attention_fwd=L, flash_attention_bwd=L,
                flash_attention_fwd_tc=L, flash_attention_bwd_tc=L,
                rope=4 * L)
    if glue:
        want.update(fused_residual_rms_norm_fwd=2 * L,
                    fused_residual_rms_norm_bwd=2 * L)
    if norm_backend:
        want.update(rms_norm_fwd=2 * L + 1, rms_norm_bwd=2 * L + 1)
    with phase_settings(glue, norm_backend):
        out = train_run(model, cfg, seed, device, batch, seq, warmup, steps,
                        want, expected_first_loss(cfg),
                        f"llama train (glue {'on' if glue else 'off'}"
                        f"{', norm backend' if norm_backend else ''}, "
                        f"{L} layers)", power)
    return dict(out, glue=glue, layers=L, norm_backend=norm_backend)


def llama_train_phases(seed, power):
    """The LLaMA train phase with ``train_glue_fusion`` off, then on, then
    off under the norm backend, from one draw of the weights; each first
    loss (same weights, same first batch) within FIRST_LOSS_GAP of glue
    off's."""
    from paddle_tpu_torch.models import llama_state_from_jax
    cfg = llama_train_config()
    t0 = time.perf_counter()
    state = llama_state_from_jax(jax_layout_llama_weights(cfg, seed))
    log(f"llama train: weights drawn in {time.perf_counter() - t0:.2f} s")
    off = llama_train_phase(seed, False, cfg, power=power, state=state)
    on = llama_train_phase(seed, True, cfg, power=power, state=state)
    backend = llama_train_phase(seed, False, cfg, power=power, state=state,
                                norm_backend=True)
    del state
    on["vs_glue_off"] = _compare_runs("llama train", off, on, "glue on")
    backend["vs_glue_off"] = _compare_runs("llama train", off, backend,
                                           "norm backend")
    return off, on, backend


def llama_parity(seed, num_layers=1, batch=1, seq=256):
    """:func:`parity_step` of LLaMA with ``train_glue_fusion`` on:
    LLaMA-7B widths, ``num_layers`` layer(s), batch ``batch`` x ``seq``,
    recompute ``dots_and_kernels_saveable``."""
    from paddle_tpu_torch.models import LlamaForCausalLM, load_llama_from_jax
    cfg = llama_train_config(num_layers)
    weights = jax_layout_llama_weights(cfg, seed + 3)
    ids, lab = _batch_fn(cfg, batch, seq, seed + 4)()

    def make(dev):
        return load_llama_from_jax(LlamaForCausalLM(cfg, device=dev),
                                   weights)
    L = num_layers
    with phase_settings(True, False):
        out = parity_step(
            make, ids, lab, 1e-4,
            dict(flash_attention_fwd=L, flash_attention_bwd=L, rope=4 * L,
                 fused_residual_rms_norm_fwd=2 * L,
                 fused_residual_rms_norm_bwd=2 * L, fused_update=1),
            f"llama parity ({L} layer(s) at LLaMA-7B widths, batch {batch}"
            f" x {seq}, glue on)")
    return dict(out, layers=L, batch=batch, seq=seq)


# --------------------------------------------------------- llama serve --
def llama_meta_model(seed, cfg, device, quantized):
    """``(model, draw)``: ``cfg``'s LLaMA built on the meta device, and
    ``draw(part)``, which materializes one part on ``device`` with random
    weights in the JAX package's init (normal std 0.02, ``o_proj`` and
    ``down_proj`` 0.02 / sqrt(2 L), unit norms) from one
    ``torch.Generator`` seeded with ``seed`` (with ``quantized``, through
    ``weight_only_quantize`` as drawn). Parts drawn in the same order get
    the same weights."""
    from torch import nn

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn.layers import RMSNorm
    from paddle_tpu_torch.quantization import weight_only_quantize
    dev = torch.device(device)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg, device="meta")
    gen = torch.Generator(device=dev).manual_seed(seed)
    resid = 0.02 / np.sqrt(2 * cfg.num_layers)

    @torch.no_grad()
    def draw(part):
        part.to_empty(device=dev)
        for name, mod in part.named_modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                std = resid if name.endswith(("o_proj", "down_proj")) \
                    else 0.02
                mod.weight.normal_(0.0, std, generator=gen)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        if quantized:
            weight_only_quantize(part)

    return model, draw


def llama_serve_model(seed, cfg=None, device="cuda", quantized=True):
    """LLaMA (default ``LlamaConfig()``: LLaMA-7B, 32 layers) with random
    weights in the JAX package's init (normal std 0.02, ``o_proj`` and
    ``down_proj`` 0.02 / sqrt(2 L), unit norms) drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``. The model is built on the
    meta device and materialized one part at a time; with ``quantized``
    each layer goes through ``quantization.weight_only_quantize`` as soon
    as it is drawn (and the untied ``lm_head`` after it), so the peak
    holds one fp32 layer beside the int8 ones: the 32-layer fp32 weights
    (27 GB) never exist at once."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.quantization import WeightOnlyLinear
    cfg = LlamaConfig() if cfg is None else cfg
    t0 = time.perf_counter()
    model, draw = llama_meta_model(seed, cfg, device, quantized)
    lm = model.llama
    draw(lm.embed_tokens)
    for layer in lm.layers:
        draw(layer)
    draw(lm.norm)
    if model.lm_head is not None:
        draw(model.lm_head)
        if quantized:
            model.lm_head = WeightOnlyLinear(model.lm_head)
    nbytes = sum(t.numel() * t.element_size()
                 for t in list(model.parameters()) + list(model.buffers()))
    log(f"LLaMA {cfg.num_layers} layers at hidden {cfg.hidden_size} "
        f"({'weight-only int8' if quantized else 'fp32'}) on {model.device}:"
        f" {nbytes / 1e9:.3f} GB of weights, drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def _dense(mod):
    """A projection's weight ``[out, in]`` in fp32: an ``nn.Linear``'s
    own, a ``WeightOnlyLinear``'s dequantized (int8 times its channel's
    scale, ``weight_dequantize``)."""
    from paddle_tpu_torch.quantization import (WeightOnlyLinear,
                                               weight_dequantize)
    if isinstance(mod, WeightOnlyLinear):
        return weight_dequantize(mod.qweight.t(), mod.scale).t()
    return mod.weight


def llama_teacher(kv_quant):
    """A teacher for :func:`_serve_run`: the plain fp32 LLaMA forward over
    whole sequences that replays the serve phase's quantization: each
    weight-only projection dequantized (one layer at a time, for all
    sequences, so one layer's fp32 weights exist at once) and, with
    ``kv_quant``, each K/V vector (after rope) through ``kv_quantize`` ->
    ``kv_dequantize``; plain causal softmax attention, GQA by repeat,
    rope through the serving path's ``rope_at``. TF32 is off."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.models.generation import rope_at
    from paddle_tpu_torch.quantization import kv_dequantize, kv_quantize

    @torch.no_grad()
    def teacher(model, prompts, seqs):
        lm, dev = model.llama, model.device
        cfg = model.cfg
        nh, nk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        xs = [lm.embed_tokens.weight[torch.as_tensor(s, device=dev).long()]
              for s in seqs]
        for layer in lm.layers:
            a, mlp = layer.attn, layer.mlp
            wq, wk, wv, wo = (_dense(m) for m in (a.q_proj, a.k_proj,
                                                  a.v_proj, a.o_proj))
            wg, wu, wd = (_dense(m) for m in (mlp.gate_proj, mlp.up_proj,
                                              mlp.down_proj))
            for i, x in enumerate(xs):
                S = x.shape[0]
                pos = torch.arange(S, device=dev)
                h = layer.input_norm(x)
                q = rope_at((h @ wq.t()).reshape(1, S, nh, hd), pos,
                            a.rope_theta)[0]
                k = rope_at((h @ wk.t()).reshape(1, S, nk, hd), pos,
                            a.rope_theta)[0]
                v = (h @ wv.t()).reshape(S, nk, hd)
                if kv_quant:
                    k = kv_dequantize(*kv_quantize(k))
                    v = kv_dequantize(*kv_quantize(v))
                k = k.repeat_interleave(nh // nk, dim=1)
                v = v.repeat_interleave(nh // nk, dim=1)
                sc = torch.einsum("qhd,khd->hqk", q, k) / np.sqrt(hd)
                causal = torch.ones(S, S, dtype=torch.bool,
                                    device=dev).tril()
                p = torch.softmax(sc.masked_fill(~causal, float("-inf")),
                                  dim=-1)
                att = torch.einsum("hqk,khd->qhd", p, v).reshape(S, -1)
                x = x + att @ wo.t()
                h = layer.post_norm(x)
                x = x + (tF.silu(h @ wg.t()) * (h @ wu.t())) @ wd.t()
                xs[i] = x
            del wq, wk, wv, wo, wg, wu, wd
        w_lm = (_dense(model.lm_head) if model.lm_head is not None
                else lm.embed_tokens.weight)
        return [lm.norm(x[p.size - 1:s.size - 1]) @ w_lm.t()
                for x, p, s in zip(xs, prompts, seqs)]

    return teacher


def gap_sequences(seed, cfg, n=4):
    """``n`` of the serve prompts, and each followed by ``NEW_TOKENS``
    random tokens: the inputs of :func:`logit_gap`."""
    rng = np.random.default_rng(seed + 13)
    prompts = serve_prompts(seed, cfg)[:n]
    return prompts, [np.concatenate([p, rng.integers(
        0, cfg.vocab_size, NEW_TOKENS).astype(np.int32)]) for p in prompts]


def family_teacher(model, kv_quant):
    """The plain teacher of the model's family (:func:`llama_teacher`,
    :func:`_gpt_teacher`), replaying int8 KV with ``kv_quant``."""
    if hasattr(model, "llama"):
        return llama_teacher(kv_quant)
    return _gpt_teacher_kv8 if kv_quant else _gpt_teacher


def max_gap(got, ref):
    return max(float((g.to(r.device) - r).abs().max())
               for g, r in zip(got, ref))


@torch.no_grad()
def logit_gap(model, seed, kv_quant, n=4, megakernel=False):
    """Largest |logit| difference between the served path (the kernels,
    fp32 or int8 pools: :func:`served_logits`) and the plain teacher of
    the model's family, over the last ``NEW_TOKENS`` positions of the
    :func:`gap_sequences`."""
    prompts, seqs = gap_sequences(seed, model.cfg, n)
    ref = family_teacher(model, kv_quant)(model, prompts, seqs)
    return max_gap(served_logits(model, prompts, seqs, kv_quant,
                                 megakernel), ref)


@torch.no_grad()
def served_logits(model, prompts, seqs, kv_quant, megakernel=False):
    """The served path's logits at the last ``NEW_TOKENS`` positions of
    each of ``seqs``: each sequence goes through the engine's ragged
    forward as one prefill or, with ``megakernel``, its prompt as one
    prefill and every further token as one fused decode step: the path
    whose picks a megakernel serve checks. A TP rank-local model
    (``TPParams.model``) runs the TP path on its heads and pools (every
    rank must call it with the same inputs)."""
    from paddle_tpu_torch.models import generation as g
    cfg = model.cfg
    ps, L, qb = GEO["page_size"], cfg.num_layers, GEO["q_block"]
    dev, hk = model.device, g._kv_heads(model)
    ragged_fn = g._ragged_fn(model)

    def ragged(*a):
        return ragged_fn(model, *a, qb)

    if megakernel:
        fused_fn = g._decode_fused_fn(model)

        def fused(ids, pos, bt, caches, zero):
            return fused_fn(model, ids, pos, bt, caches, zero)
    rows_out = []
    for p, s in zip(prompts, seqs):
        S = s.size
        npg = -(-S // ps)
        pshape = (hk, npg + 1, ps, cfg.head_dim)
        caches = [torch.zeros(pshape, device=dev, dtype=torch.int8
                              if kv_quant else torch.float32)
                  for _ in range(2 * L)]
        if kv_quant:
            caches += [torch.zeros(pshape[:3], device=dev)
                       for _ in range(2 * L)]
        ids = torch.as_tensor(s, device=dev)[None].long()
        bt = torch.arange(1, npg + 1, dtype=torch.int32, device=dev)[None]
        T = p.size if megakernel else S
        pos = torch.arange(T, device=dev)
        lens = torch.tensor([T], dtype=torch.int32, device=dev)
        lg, caches = ragged(ids[:, :T], pos, torch.zeros_like(pos),
                            torch.ones_like(pos), lens, lens, bt, caches)
        lg = lg[p.size - 1:S - 1]
        if megakernel:
            rows, zero = [lg[0]], torch.zeros(1, device=dev)
            for t in range(p.size, S - 1):
                step, _, _, caches = fused(
                    ids[:, t:t + 1], torch.tensor([t], device=dev), bt,
                    caches, zero)
                rows.append(step[0])
            lg = torch.stack(rows)
        rows_out.append(lg)
    return rows_out


def llama_serve_phase(seed, cfg=None, device="cuda", quantized=True,
                      model=None, megakernel=False, kv_quant=None, gap=True,
                      full_profile=True):
    """Serve the 16 requests of the GPT serve phases through
    ``ContinuousBatchingEngine`` on LLaMA: with ``quantized`` the
    weight-only int8 model of :func:`llama_serve_model`, else the fp32
    model; ``kv_quant`` (default: ``quantized``) int8 KV pages, else fp32
    pools; the decode path unfused or (``megakernel``) fused. The checks
    of :func:`_serve_run`, with exact launches per dispatch (a forward of
    L layers: L attentions, 7 L + 1 weight-only matmuls when quantized;
    a megakernel decode step L ingress, L egress and one epilogue launch)
    and the teacher of :func:`llama_teacher` (near-tie margin MARGIN_KV8
    over int8 pools, MARGIN over fp32 ones); with ``gap``, the served
    path's :func:`logit_gap`. ``cfg`` defaults to LLaMA-7B; a small one
    with ``device="cpu"`` rehearses the phase."""
    kv_quant = quantized if kv_quant is None else kv_quant
    if model is None:
        model = llama_serve_model(seed, cfg, device, quantized)
    L = model.cfg.num_layers
    tag = (f"llama serve ({L} layers, "
           + ("weight-only int8" if quantized else "fp32")
           + (", int8 KV" if kv_quant else "")
           + (", megakernel" if megakernel else "") + ")")
    out = _serve_run(model, seed, device, tag, llama_teacher(kv_quant),
                     margin=MARGIN_KV8 if kv_quant else MARGIN,
                     full_profile=full_profile, kv_quant=kv_quant,
                     megakernel=megakernel)
    out.update(quantized=quantized, layers=L, hidden=model.cfg.hidden_size,
               logit_gap=None)
    if gap:
        out["logit_gap"] = logit_gap(model, seed, kv_quant,
                                     megakernel=megakernel)
        log(f"{tag}: the served path's logits vs the plain forward's, 4 "
            f"prompts + {NEW_TOKENS} tokens"
            + (", each a fused decode step" if megakernel else
               " as one prefill")
            + f": max |difference| {out['logit_gap']:.4g}")
    return out


def llama_megakernel_phases(seed, model, device="cuda"):
    """The fp32 LLaMA (LLaMA-7B at full depth on the card) served with
    fp32 pools unfused and through the megakernel, each with the checks
    of :func:`llama_serve_phase` and a profiled decode window; on the
    card both again in turns (megakernel, unfused: the four runs go
    unfused, megakernel, megakernel, unfused); then with int8 pools
    unfused and through the megakernel. Returns the runs by name."""
    runs = {}
    for name, mk, kvq in (("fp32", False, False),
                          ("fp32_megakernel", True, False),
                          ("turns", None, None), ("int8_kv", False, True),
                          ("int8_kv_megakernel", True, True)):
        if name == "turns":
            if device == "cuda":
                runs["turns"] = serve_turns(model, seed, order=(True, False))
            continue
        runs[name] = llama_serve_phase(
            seed, device=device, quantized=False, model=model,
            megakernel=mk, kv_quant=kvq, full_profile=False)
    if device == "cuda":
        log("llama megakernel vs unfused, decode step (device launches, "
            "device ms, wall ms): " + "; ".join(
                f"{n} {r['window']['launches_per_step']:.1f}, "
                f"{r['window']['device_ms_per_step']:.3f}, "
                f"{r['window']['wall_ms_per_step']:.3f}"
                for n, r in runs.items() if n != "turns"))
    return runs


def quant_matmul_cases(seed, power):
    """``weight_only_matmul`` against its plain version on the card at the
    LLaMA-7B quantized serve phase's shapes: x ``[M, K]`` fp32 and an
    int8 weight ``[N, K]`` (the layout ``WeightOnlyLinear`` keeps) for
    (K, N) in q/k/v/o (4096, 4096), gate/up (4096, 11008), down (11008,
    4096) and the lm_head (4096, 32000), at M = 8 (a decode step of 8
    slots) and M = 128 (the engine's mixed-step token budget), and at
    M = 512; plus M = 1 and odd K and N. Each output within 2e-5 of its
    sum of |x| |q| s. Every launch is timed behind the device spin of
    :func:`_time_ms`. The library yardstick is one ``torch.matmul`` of x
    with the weight dequantized beforehand (int8 times its scale, fp32;
    TF32 off); it is never used by the port."""
    from paddle_tpu_torch.ops.cuda.quant_matmul import (quant_matmul_plain,
                                                        weight_only_matmul)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    shapes = [(4096, 4096, "qkvo"), (4096, 11008, "gate_up"),
              (11008, 4096, "down"), (4096, 32000, "lm_head")]
    cases = [(f"llama7b_{what}_m{m}", m, k, n)
             for m in (8, 128, 512) for k, n, what in shapes]
    cases += [("m1_qkvo", 1, 4096, 4096), ("odd_m3_k4099_n1001", 3, 4099,
                                           1001),
              ("odd_m130_k4099_n1001", 130, 4099, 1001)]
    rows = []
    for name, m, k, n in cases:
        x = torch.randn(m, k, generator=gen, device=dev)
        qw = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                           dtype=torch.int8).t()
        s = torch.rand(n, generator=gen, device=dev) * 0.002 + 1e-4
        out = weight_only_matmul(x, qw, s)
        ref = quant_matmul_plain(x, qw, s)
        mag = (x.abs() @ qw.abs().float()) * s
        torch.cuda.synchronize()
        excess = float(((out - ref).abs() - 2e-5 * mag).max())
        err = float((out - ref).abs().max())
        if not excess <= 0:
            raise AssertionError(f"weight_only_matmul {name}: kernel vs "
                                 f"plain error above 2e-5 of |x| |q| s "
                                 f"(max abs error {err:.3g})")
        del mag
        reps = 20 if m * k * n < 5e10 else 5
        ms = _time_ms(lambda: weight_only_matmul(x, qw, s), reps, flush,
                      spin=True)
        plain_ms = _time_ms(lambda: quant_matmul_plain(x, qw, s), 3, flush,
                            spin=True)
        w_deq = qw.float() * s
        lib_ms = _time_ms(lambda: torch.matmul(x, w_deq), reps, flush,
                          spin=True)
        del w_deq
        # x, the int8 weight and the scales read once, y written once
        nbytes = 4 * m * k + k * n + 4 * n + 4 * m * n
        flops = 2 * m * k * n
        bound_ms, bound_by = _fp32_bound(nbytes, flops)
        row = dict(case=name, m=m, k=k, n=n, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, flops=flops, library_ms=lib_ms,
                   library="torch.matmul(x, dequantized fp32 weight)")
        log(f"kernel weight_only_matmul {name} x [{m}, {k}] w [{n}, {k}] "
            f"int8: max_abs_err {err:.3g}, {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of "
            f"bound) on {power}")
        rows.append(row)
        del x, qw, s, out, ref
    del flush
    torch.cuda.empty_cache()
    return rows


# The LLaMA-7B TP legs serve the first 8 of the 16 requests: two ranks on
# one card time-slice it, and each of their 64 all-reduces a forward waits
# through the host (2-4 ms each on an H100), so the 16 requests took the
# two legs over 250 s there, above the ~150 s this phase allows them.
TP_LLAMA_REQUESTS = 8
TP_LEGS = (("gpt_tp2", "gpt", False, False),
           ("gpt_tp2_megakernel", "gpt", True, False),
           ("gpt_tp2_megakernel_int8_kv", "gpt", True, True),
           ("llama7b_tp2", "llama", False, False),
           ("llama7b_tp2_megakernel", "llama", True, False))


def _tp_leg(model, tpp, seed, device, tag, megakernel, kv_quant,
            requests):
    """One TP serve leg on this rank: :func:`_serve_run` of ``requests``
    of the serve prompts through the engine with ``mesh`` this rank's
    group (no teacher: the parent holds the unsharded model; on the card
    a profiled decode window with its all-reduces' share), and the TP
    path's :func:`served_logits` on the :func:`gap_sequences`."""
    res = _serve_run(model, seed, device, tag, None, full_profile=False,
                     requests=requests, mesh=tpp.group,
                     megakernel=megakernel, kv_quant=kv_quant)
    prompts, seqs = gap_sequences(seed, model.cfg)
    res["gap_logits"] = [r.cpu() for r in served_logits(
        tpp.model, prompts, seqs, kv_quant, megakernel)]
    return res


def tp_rank_main(rank, seed, tmp, device, gpt_cfg, llama_cfg, legs,
                 requests):
    """One of the two ranks of :func:`tp_serve_phases`, spawned: it
    imports the port only. Over a gloo process group (the caller's choice
    of backend: two ranks on one card cannot use NCCL), it serves the
    GPT legs of ``legs`` from GPT-124M's slices (the model drawn as the
    single-card phase draws it, then sent to the meta device), then the
    LLaMA legs from LLaMA-7B's, drawn part by part on ``device`` from the
    seed exactly as :func:`llama_serve_model` draws them, each part's
    slices kept and the part freed; ``requests[family]`` of the requests
    each. Writes its results to ``tmp/rank{rank}.pt``."""
    from datetime import timedelta

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.generation import tp_shard_params
    global _RANK
    _RANK = f"rank {rank}: "
    if device == "cpu":
        torch.set_num_threads(1)
    pdist.init_parallel_env(backend="gloo",
                            init_method=f"file://{tmp}/rendezvous",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=TP_COLLECTIVE_S))
    try:
        group = pdist.get_group()
        out = {}
        for fam in sorted({leg[1] for leg in legs}):
            if fam == "gpt":
                model = serve_model(seed, gpt_cfg, device)
                tpp = tp_shard_params(model, group)
                model.to("meta")   # this rank keeps its slices only
            else:
                cfg = LlamaConfig() if llama_cfg is None else llama_cfg
                t0 = time.perf_counter()
                model, draw = llama_meta_model(seed, cfg, device, False)
                tpp = tp_shard_params(model, group, materialize=draw)
                nbytes = sum(v.numel() * v.element_size() for v in tpp.vals)
                log(f"LLaMA {cfg.num_layers} layers at hidden "
                    f"{cfg.hidden_size}, this rank's slices: "
                    f"{nbytes / 1e9:.3f} GB, drawn in "
                    f"{time.perf_counter() - t0:.2f} s")
            n = requests[fam]
            for name, leg_fam, mk, kvq in legs:
                if leg_fam == fam:
                    t0 = time.perf_counter()
                    out[name] = _tp_leg(model, tpp, seed, device,
                                        f"{name} (TP=2, rank {rank})", mk,
                                        kvq, n)
                    out[name].update(requests=n,
                                     leg_s=time.perf_counter() - t0)
                    log(f"{name}: {n} of the 16 requests, the leg "
                        f"took {out[name]['leg_s']:.1f} s")
            del model, tpp
            if device == "cuda":
                torch.cuda.empty_cache()
        out["modules"] = sorted(m for m in sys.modules if m.split(".")[0]
                                in ("jax", "jaxlib", "paddle_tpu"))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        pdist.destroy_process_group()


def _memo(teacher):
    """``teacher`` computed once per distinct set of sequences."""
    memo = {}

    def run(model, prompts, seqs):
        key = tuple(q.tobytes() for q in seqs)
        if key not in memo:
            memo[key] = teacher(model, prompts, seqs)
        return memo[key]

    return run


def tp_serve_phases(seed, device="cuda", gpt_cfg=None, llama_cfg=None,
                    legs=TP_LEGS, requests=None):
    """Tensor-parallel serving at TP=2 (``legs``, by default ``TP_LEGS``):
    two ranks (:func:`tp_rank_main`, spawned, both on this card over
    gloo) serve the 16 requests of the serve phases through
    ``ContinuousBatchingEngine(mesh=...)``: GPT-124M unfused, through the
    megakernel over fp32 and over int8 pools, and LLaMA-7B at full depth
    unfused and through the megakernel over fp32 pools (the first
    TP_LLAMA_REQUESTS of them; ``requests``, by family, overrides both
    counts). Each rank checks its launches per
    dispatch (:func:`_drive`: under the megakernel every decode step
    ``fused_decode_mlp_partial`` L times and ``fused_decode_mlp`` never;
    2 L all-reduces a forward). This process then holds the two ranks'
    token streams and ``stats`` equal, checks no rank imported JAX or the
    JAX package, and runs the teacher-forced check of each leg against
    the plain forward of the unsharded model, drawn again here, with the
    near-tie margin max(MARGIN, 2 x the gap measured on the leg's own TP
    path). Any rank that fails, or outlives TP_JOIN_S, fails the phase.
    ``gpt_cfg`` and ``llama_cfg`` (with ``device="cpu"``) rehearse it
    without a card. Returns the legs by name (rank 0's numbers, with
    rank 1's decode step beside them)."""
    import multiprocessing as mp
    import tempfile

    from paddle_tpu_torch.models import LlamaConfig
    requests = requests or {"gpt": 16, "llama": TP_LLAMA_REQUESTS}
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=tp_rank_main,
                             args=(r, seed, tmp, device, gpt_cfg, llama_cfg,
                                   legs, requests))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_JOIN_S
        try:
            while time.monotonic() < deadline and any(
                    p.exitcode is None for p in procs) and all(
                    p.exitcode in (None, 0) for p in procs):
                for p in procs:
                    p.join(1.0)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                    p.join(30)
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"TP serve phase: ranks exited {codes} "
                                 f"(a hang past {TP_JOIN_S} s is killed)")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    log(f"TP serve phase: both ranks done in "
        f"{time.perf_counter() - t_start:.1f} s")
    for r, res in enumerate(ranks):
        if res["modules"]:
            raise AssertionError(f"TP rank {r} imported {res['modules']}")
    served = {}
    for name, fam, _mk, _kvq in legs:
        a, b = ranks[0][name], ranks[1][name]
        if a["sequences"] != b["sequences"] or a["stats"] != b["stats"]:
            raise AssertionError(f"{name}: the ranks served different "
                                 "streams or stats")
        if "window" in b:
            a["rank1_window"] = b["window"]
        served[name] = a
    for fam in sorted({leg[1] for leg in legs}):
        if fam == "gpt":
            model = serve_model(seed, gpt_cfg, device)
        else:
            model = llama_serve_model(
                seed, LlamaConfig() if llama_cfg is None else llama_cfg,
                device, quantized=False)
        teachers = {kvq: _memo(family_teacher(model, kvq))
                    for kvq in (False, True)}
        g_prompts, g_seqs = gap_sequences(seed, model.cfg)
        for name, leg_fam, _mk, kvq in legs:
            if leg_fam != fam:
                continue
            res = served[name]
            prompts = serve_prompts(seed, model.cfg, res["requests"])
            gap = max_gap(res.pop("gap_logits"),
                          teachers[kvq](model, g_prompts, g_seqs))
            margin = max(MARGIN, 2 * gap)
            log(f"{name}: the TP path's logits vs the unsharded plain "
                f"forward's, 4 prompts + {NEW_TOKENS} tokens"
                + (", each a fused decode step" if _mk else
                   " as one prefill")
                + f": max |difference| {gap:.4g}; near-tie margin "
                f"{margin:.4g}")
            seqs = [np.asarray(q, np.int32) for q in res.pop("sequences")]
            res.update(_teacher_check(model, teachers[kvq], prompts, seqs,
                                      margin, f"{name} (TP=2)"),
                       logit_gap=gap)
            ranks[1][name].pop("gap_logits", None)
        del model, teachers
        if device == "cuda":
            torch.cuda.empty_cache()
    log(f"TP serve phase passed in {time.perf_counter() - t_start:.1f} s")
    return served


def llama_serve_phases(seed):
    """The quantized LLaMA-7B serve at full depth, then the fp32
    LLaMA-7B at full depth (27 GB of weights) unfused and through the
    megakernel (:func:`llama_megakernel_phases`)."""
    quant = llama_serve_phase(seed, quantized=True)
    torch.cuda.empty_cache()
    model = llama_serve_model(seed, quantized=False)
    runs = llama_megakernel_phases(seed, model)
    del model
    torch.cuda.empty_cache()
    return quant, runs


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
    norm_rows = norm_kernel_phase(args.seed, smi_line)
    qm_rows = quant_matmul_cases(args.seed, smi_line)
    model = serve_model(args.seed)
    serve = serve_phase(args.seed, model=model)
    serve_mk = serve_phase(args.seed, megakernel=True, model=model)
    turns = serve_turns(model, args.seed)
    serve_mk8 = serve_phase(args.seed, megakernel=True, model=model,
                            kv_quant=True)
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
    llama_q, llama_fp = llama_serve_phases(args.seed)
    llama_mk = llama_fp["fp32_megakernel"]
    tp = tp_serve_phases(args.seed)
    tp_mk = tp["llama7b_tp2_megakernel"]
    train, train_glue, train_nb = gpt_train_phases(args.seed, smi_line)
    parity = train_parity(args.seed)
    parity_glue = train_parity(args.seed, glue=True)
    llama_off, llama_on, llama_nb = llama_train_phases(args.seed, smi_line)
    llama_par = llama_parity(args.seed)
    print(json.dumps({"train": train, "train_glue": train_glue,
                      "train_norm_backend": train_nb,
                      "train_parity": [parity, parity_glue],
                      "llama_train": [llama_off, llama_on, llama_nb],
                      "llama_parity": llama_par, "build_s": build_s,
                      "power": smi_line}), flush=True)
    src = "paddle_tpu_torch/ops/cuda/csrc/"
    specs = [
        ("ragged_paged_attention", "paged_attention.cu",
         "paddle_tpu/ops/pallas/paged_attention.py:155", rows,
         serve["launches"]),
        ("flash_attention_fwd", "flash_attention_sm90.cu",
         "paddle_tpu/ops/pallas/flash_attention.py:80", fwd_rows,
         train["counts"]["flash_attention_fwd"]),
        ("flash_attention_bwd", "flash_attention_sm90.cu",
         "paddle_tpu/ops/pallas/flash_attention.py:206", bwd_rows,
         train["counts"]["flash_attention_bwd"]),
        ("fused_update", "fused_optimizer.cu",
         "paddle_tpu/ops/pallas/fused_optimizer.py:121", opt_rows,
         train["counts"]["fused_update"]),
        ("fused_decode_qkv", "fused_decode_qkv.cu",
         "paddle_tpu/ops/pallas/fused_decode_qkv.py:131",
         dec_rows["fused_decode_qkv"],
         llama_mk["counts"]["fused_decode_qkv"]),
        ("fused_decode_mlp", "fused_decode_mlp.cu",
         "paddle_tpu/ops/pallas/fused_decode_mlp.py:55",
         dec_rows["fused_decode_mlp"],
         llama_mk["counts"]["fused_decode_mlp"]),
        ("fused_decode_epilogue", "fused_decode_mlp.cu",
         "paddle_tpu/ops/pallas/fused_decode_mlp.py:75",
         dec_rows["fused_decode_epilogue"],
         llama_mk["counts"]["fused_decode_epilogue"]),
        ("fused_decode_mlp_partial", "fused_decode_mlp.cu",
         "paddle_tpu/ops/pallas/fused_decode_mlp.py:68",
         dec_rows["fused_decode_mlp_partial"],
         tp_mk["counts"]["fused_decode_mlp_partial"]),
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
        ("weight_only_matmul", "quant_matmul.cu",
         "paddle_tpu/ops/pallas/quant_matmul.py:146", qm_rows,
         llama_q["counts"]["weight_only_matmul"]),
        ("fused_residual_layer_norm_fwd", "fused_residual_norm.cu",
         "paddle_tpu/ops/pallas/fused_residual_norm.py:153",
         norm_rows["fused_residual_layer_norm_fwd"],
         train_glue["counts"]["fused_residual_layer_norm_fwd"]),
        ("fused_residual_layer_norm_bwd", "fused_residual_norm.cu",
         "paddle_tpu/ops/pallas/fused_residual_norm.py:205",
         norm_rows["fused_residual_layer_norm_bwd"],
         train_glue["counts"]["fused_residual_layer_norm_bwd"]),
        ("rms_norm_fwd", "norms.cu", "paddle_tpu/ops/pallas/norms.py:65",
         norm_rows["rms_norm_fwd"], llama_nb["counts"]["rms_norm_fwd"]),
        ("rms_norm_bwd", "norms.cu", "paddle_tpu/ops/pallas/norms.py:97",
         norm_rows["rms_norm_bwd"], llama_nb["counts"]["rms_norm_bwd"]),
        ("layer_norm_fwd", "norms.cu", "paddle_tpu/ops/pallas/norms.py:165",
         norm_rows["layer_norm_fwd"], train_nb["counts"]["layer_norm_fwd"]),
        ("layer_norm_bwd", "norms.cu", "paddle_tpu/ops/pallas/norms.py:202",
         norm_rows["layer_norm_bwd"], train_nb["counts"]["layer_norm_bwd"]),
    ]
    # every serve path's own count of the attention launches, and of the
    # fused decode kernels'
    attn_paths = {"gpt_serve": serve["launches"],
                  "gpt_serve_megakernel": serve_mk["launches"],
                  "gpt_serve_megakernel_int8_kv": serve_mk8["launches"],
                  "llama7b_int8_serve": llama_q["launches"]}
    attn_paths.update({f"llama7b_fp32_serve_{n}": r["launches"]
                       for n, r in llama_fp.items() if n != "turns"})
    attn_paths.update({n: r["launches"] for n, r in tp.items()})
    mk_runs = {"gpt_serve_megakernel": serve_mk,
               "gpt_serve_megakernel_int8_kv": serve_mk8,
               "llama7b_fp32_serve_fp32_megakernel": llama_mk,
               "llama7b_fp32_serve_int8_kv_megakernel":
                   llama_fp["int8_kv_megakernel"]}
    tp_mk_runs = {n: r for n, r in tp.items() if r["megakernel"]}
    fused_paths = {k: {p: r["counts"][k] for p, r in mk_runs.items()}
                   for k in ("fused_decode_qkv", "fused_decode_mlp",
                             "fused_decode_epilogue")}
    for k in ("fused_decode_qkv", "fused_decode_epilogue"):
        fused_paths[k].update({p: r["counts"][k]
                               for p, r in tp_mk_runs.items()})
    fused_paths["fused_decode_mlp_partial"] = {
        p: r["counts"]["fused_decode_mlp_partial"]
        for p, r in tp_mk_runs.items()}
    if min(attn_paths.values()) <= 0 or min(
            n for paths in fused_paths.values() for n in paths.values()) <= 0:
        raise AssertionError(f"launches by path: attention {attn_paths}, "
                             f"fused decode {fused_paths}")
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
        if kname == "ragged_paged_attention":
            out[-1]["launches_by_path"] = attn_paths
        if kname in fused_paths:
            out[-1]["launches_by_path"] = fused_paths[kname]
        if kname.startswith("flash_attention"):
            # the main path's bf16 launches take the tensor-core kernels;
            # fp32 and other head dims the CUDA-core ones
            out[-1]["sources"] = {"tensor cores": src + source,
                                  "CUDA cores": src + "flash_attention.cu"}
            out[-1]["tc_launches"] = {
                "gpt_train": train["counts"][kname + "_tc"],
                "llama_train": llama_off["counts"][kname + "_tc"]}
    print(json.dumps({"kernels": out, "serve": serve,
                      "serve_megakernel": serve_mk, "serve_turns": turns,
                      "serve_megakernel_int8_kv": serve_mk8,
                      "llama_serve": llama_q, "llama_serve_fp32": llama_fp,
                      "tp_serve": tp, "power": smi_line}), flush=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
