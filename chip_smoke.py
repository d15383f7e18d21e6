"""Drive the PyTorch port's serving path once on a CUDA card.

    python3 chip_smoke.py [--seed N]

1. Header: the card, its power limit (nvidia-smi), TF32 off, and the
   build of every CUDA kernel from ``paddle_tpu_torch/ops/cuda/csrc``.
2. Kernel phase: ``ragged_paged_attention`` (CUDA) against its plain
   PyTorch version on the card, at the shapes the serve phase's engine
   gives it (a mixed prefill + decode step and a decode step at
   GPT-124M widths) and one GQA case; max abs error
   <= 2e-5; times from CUDA events with the L2 flushed before each
   launch, beside the least time the card could take (bound).
3. Serve phase: GPT-124M (``GPTConfig()`` defaults, weights drawn from
   the seed in the JAX package's layout and init) behind
   ``ContinuousBatchingEngine`` serves 16 requests (prompts 16-512
   tokens, 32 new tokens each). Every request must finish by length,
   the page pool must be conserved, and the kernel must have launched
   in both the mixed and the decode steps. A teacher-forced plain fp32
   forward (plain attention, no kernel) must pick every served token,
   except where its top-2 margin is below 1e-4 (a near tie). One more
   run of the same requests under ``torch.profiler`` breaks the device
   time down by kernel and gives the device's busy share.
4. Prints the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``
   as the last line. Any failed phase raises: the exit code is not 0
   and no result line is printed. Without a card it exits 2 at once.
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
    from paddle_tpu_torch.ops.cuda import _build, paged_attention
    t0 = time.perf_counter()
    libs = _build.build_all()
    paged_attention._kernel()           # load + bind
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")


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
    rpa.launches = 0
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
    total_launches = rpa.launches
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
    out = dict(launches=total_launches, by_step=launches, wall_s=wall,
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
    from torch.autograd import DeviceType
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
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    log(f"profile: device busy {busy:.3f} ms over {wall * 1e3:.3f} ms of "
        f"the timed run = {busy / (wall * 1e3):.1%} busy "
        f"(profiled run {prof_wall * 1e3:.3f} ms); {len(kernels)} device "
        f"kernels/copies, {sum(n for *_, n in kernels)} launches")
    for key, ms, n in kernels[:12]:
        log(f"profile:   {ms:9.3f} ms {ms / busy if busy else 0:6.1%} "
            f"x{n:<6d} {key[:100]}")
    return dict(busy_ms=busy, wall_ms=wall * 1e3,
                busy_share=busy / (wall * 1e3), profiled_wall_ms=prof_wall
                * 1e3, top=[dict(name=k[:200], ms=ms, count=n)
                            for k, ms, n in kernels[:12]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    name, count, smi_line = header()
    build()
    rows = kernel_phase(args.seed, smi_line)
    serve = serve_phase(args.seed)
    main_row = rows[0]
    kernels = {"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/cuda/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:155",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": main_row["case"],
        "cases": rows,
    }], "serve": serve, "power": smi_line}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
