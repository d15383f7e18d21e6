"""Compare checkouts of the PyTorch port on one CUDA card, in turns.

    python3 chip_ab.py {flash,decode,train,glue,nbackend,llama,rms,norm,qmm,qserve,gserve,partial,attn,opt,attn_splits,attn_probe} ROOT [ROOT ...]
    python3 chip_ab.py groups ROOT [NAME ...]
    python3 chip_ab.py ptxas ROOT SOURCE [SOURCE ...]
    python3 chip_ab.py stamps ROOT [decode|norm|epilogue ...]
    python3 chip_ab.py row7 ROOT [ROOT ...]
    python3 chip_ab.py gpt_plans ROOT
    python3 chip_ab.py ln_groups ROOT
    python3 chip_ab.py norm_split ROOT [ROOT ...]

Runs ``chip_smoke.py``'s flash-attention kernel cases (``flash``: kernel
ms per case, forward and backward), THIS checkout's GPT-124M fused
decode kernel cases on ROOT's kernels (``decode``: kernel ms of each, at
B 8, 5 and 1, and a sha256 of the three fp32 kernels' outputs on fixed
inputs) or its train phase (``train``: step
ms, and the device busy ms and launches of the profiled step; ``glue``
the same with ``train_glue_fusion`` on, ``nbackend`` under the norm
backend; ``llama``: the LLaMA train phase glue off, glue on and under
the norm backend, each one's step ms and its profiled step's device ms
and launches), or THIS checkout's norm kernel cases (rows 9-16,
``chip_smoke.norm_kernel_phase``) on ROOT's kernels (``norm``: ms per
case, row 12's also without dres, and a sha256 of each norm kernel's
outputs on fixed inputs, so that the kernels a PR leaves alone can be
held bitwise equal to the parent's and a new one to itself), or the
fused residual + RMSNorm kernels on fixed inputs (``rms``: a sha256 of
the forward's outputs and one of the backward's, so two checkouts'
kernels can be held bitwise equal, and ms per call), or the
weight-only matmul's kernel cases (``qmm``: kernel ms per case), or the TP shard-local decode MLP's (row 6: ``partial``, the
``tp_partial_cases`` with the LLaMA-7B SwiGLU egress cases, row 5,
beside them: kernel ms per case), both at THIS checkout's cases against
ROOT's kernels, or the LLaMA-7B weight-only int8 serve phase (``qserve``:
tokens/s, host ms per mixed step and per decode dispatch, the profiled
run's device time by kernel, and the served logits' largest gap to the
plain forward), or the paged attention's kernel cases (``attn``: ms and
max abs error per case) or the fused optimizer update's (``opt``: ms per
case, and fused AdamW's), both at THIS checkout's cases (its
``chip_smoke.attention_cases`` and ``optimizer_cases``, run against
ROOT's kernels; ``attn_splits``: the attention's decode-route cases at
several decode split lengths, in turns; ``attn_probe``: each case as
served, with every kv_len 1 and with every q_len 0), from each ROOT in the order given, each in a process of its
own, and prints one ``AB`` JSON line per run. Give the roots in turns
(old, new, new, old) so that
drift of the card or its host shows. Needs a card; the kernels build
in each ROOT.

``groups`` builds copies of ROOT's port under ``ROOT/_chipcopy/groups/``
that differ only in one line (``GROUPS``, or the NAMEs given): how
many weight rows a warp dots at once in the per-head ingress and the
epilogue with how many stages the epilogue's rings hold
(``epilogue``), with an L2 prefetch-size hint on its weight copies
(``epi_l2hint``), and without its products (``epi_nodot``: the stream
alone), for which it prints that
kernel's ms at the
LLaMA-7B decode shapes (B = 8 and 1; the epilogue also at B 16 and
at GPT-124M's)
and a sha256 of its outputs; how many resident CTAs the paged
attention's mixed route plans a unit for (``attn_units``), for which it
prints the mixed cases' ms and max abs error; and the most CTAs the
egress plan may use (``egress_cap``), for which it prints GPT-124M's
egress ms (row 5 at B 8, 5 and 1, row 6 at a TP=2 rank's B 8 and 5).

``stamps`` builds a copy of ROOT's port under ``ROOT/_chipcopy/stamps/``
whose GEMV (row 17), egress kernel (rows 5-6) and split-K ingress (row
4) write ``%globaltimer`` stamps at their phases (x staged, slice done,
sums done, grid barrier, exit), and so does the norm backward (rows 10,
12, 14 and 16: the first row's loads landed, rows done, partial row
written, past the grid barrier, dw/db written), and prints for one call of
each (``decode``: the GEMV and the LLaMA egress at the LLaMA-7B decode
shapes, the GELU egress and the ingress at GPT-124M's; ``norm``: the
LayerNorm backward at GPT-124M's training rows, the RMS backwards at
LLaMA-7B's; ``epilogue``: row 7 at LLaMA-7B's B 8, 1 and 16 and
GPT-124M's B 8, on whichever of the designs in ``EPI_STAMPS`` ROOT
holds: entry, x staged, rows normalised, the first weights landed, the
columns done, the partial written, the last CTA's reduce done, with
the SMs used and the most CTAs that ran on one SM at once) the (min,
median, max, count) over CTAs of each stamp, in us from the first
CTA's start.

``row7`` times ROOT's sampling epilogue (row 7) at LLaMA-7B's B 1, 5,
8 and 16 and GPT-124M's B 8, 5 and 1 (ms behind the device spin, L2
flushed) and prints a sha256 of each case's outputs over two calls and
whether the two agree (a B that ROOT's wrapper refuses is printed as
refused), and ``torch.sum`` over each head as a yardstick.

``ln_groups`` times the norm backward (rows 10 and 16 at GPT-124M's
rows, rows 12 and 14 at LLaMA-7B's) on ROOT's kernels under other
plans: the most chunks a lane holds before a row takes more warps
(``norms.LN_LANE_MOST``), in turns, and every count of CTAs an SM (the
partial rows' count too); and after an L2 flush that reads, not
writes.

``norm_split`` profiles ROOT's RMS backwards (rows 12 and 14) at
LLaMA-7B's rows and prints each call's device time by kernel: the row
kernel, a second sum kernel, the casts.

``gpt_plans`` times GPT-124M's split-K ingress at several K-slices a
head, and an empty launch, in one process on ROOT's kernels.

``gserve`` runs ROOT's GPT-124M megakernel serve phases (fp32 and int8
pools, ``chip_smoke.serve_phase``) and prints tokens/s, host ms a decode
dispatch and the profiled decode window's device and wall ms a step.

``ptxas`` compiles each ``csrc/SOURCE.cu`` of ROOT with the port's
``nvcc`` flags and ``--resource-usage`` into a scratch file under
``ROOT/_chipcopy/ptxas/`` and prints ptxas's registers, spills and
shared memory for each kernel.
"""
from __future__ import annotations

import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

# kernel: (source, the line that sets the group (a regex), that line with
# the size in its place, the sizes tried; or a tuple of lines, of lines
# with their sizes, and of size tuples)
GROUPS = {"qkv": ("fused_decode_qkv.cu", r"constexpr int kHeadCols = \d+;",
                  "constexpr int kHeadCols = {};", (1, 2, 4)),
          # the epilogue's (columns a warp dots at once, ring stages)
          "epilogue": ("fused_decode_mlp.cu",
                       (r"constexpr int kEpiGroup = \d+;",
                        r"constexpr int kEpiStages = \d+;"),
                       ("constexpr int kEpiGroup = {};",
                        "constexpr int kEpiStages = {};"),
                       ((8, 2), (8, 3), (4, 4), (8, 2))),
          # the epilogue's weight copies with an L2 prefetch-size hint
          "epi_l2hint": ("fused_decode_mlp.cu",
                         r'cp\.async\.cg\.shared\.global(\.L2::\d+B)? \[%0\], \[%1\], 16;" ::"r"\(dst\), "l"\(src\)\);\n\}\n\n__device__ __forceinline__ void cp_async_commit',
                         'cp.async.cg.shared.global{} [%0], [%1], 16;" ::"r"(dst), "l"(src));\n}}\n\n__device__ __forceinline__ void cp_async_commit',
                         ("", ".L2::128B", ".L2::256B", "")),
          # the epilogue without its products (the stream alone: wrong
          # logits, a diagnostic)
          "epi_nodot": ("fused_decode_mlp.cu",
                        r"        if \(q >= kc4( \|\| true)?\) continue;\n",
                        "        if (q >= kc4{}) continue;\n",
                        ("", " || true", "")),
          # the paged attention's mixed route: resident CTAs a unit
          "attn_units": ("paged_attention.cu",
                         r"constexpr int kCtasPerUnit = \d+;",
                         "constexpr int kCtasPerUnit = {};", (1, 2, 4, 8)),
          # the egress plan's CTAs, at most (264: every resident one on an
          # H100, as the plan has it)
          "egress_cap": ("fused_decode_mlp.cu",
                         r"const int most = per_sm \* sms;",
                         "const int most = min(per_sm * sms, {});",
                         (264, 198, 132, 66, 264))}


def _one(what, root):
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if what not in GROUPS and what != "ln_groups" \
            and not what.startswith("stamps"):
        chip_smoke.build()   # these build only the libraries they load
    if what == "flash":
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
        fwd, bwd = chip_smoke.flash_cases(0, "", flush)
        out = {"fwd": {r["case"]: r["ms"] for r in fwd},
               "bwd": {r["case"]: r["ms"] for r in bwd}}
    elif what == "decode":
        # this checkout's cases (without the shared-slot check, which an
        # older GPT ingress fails), ROOT's kernels
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
        rows = _cases().decode_kernel_cases(0, "", flush, shared_slot=False)
        out = {name: {r["case"]: r["ms"] for r in rs}
               for name, rs in rows.items()}
        out["sha256"] = _decode_digests()
    elif what == "gpt_plans":
        out = _gpt_plans(chip_smoke)
    elif what == "attn_units":
        # the mixed route's cases (this copy's kernel): ms and max abs error
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
        from paddle_tpu_torch.ops.cuda import paged_attention as pa
        gen = torch.Generator().manual_seed(0)
        out = {}
        for (name, kvl, ql, hq, hk, d, ps, qb, pages, width,
             T) in chip_smoke.attention_cases(0):
            if pa.route(qb, hq // hk) != "mixed":
                continue
            args, sc = chip_smoke._attn_case(gen, kvl, ql, hq, hk, d, ps, qb,
                                             pages, width, T,
                                             int8="int8" in name)
            err = float((pa.ragged_paged_attention(*args, q_block=qb, **sc)
                         - pa.ragged_paged_attention_plain(
                             *args, q_block=qb, **sc)).abs().max())
            out[name] = {"ms": chip_smoke._time_ms(
                lambda: pa.ragged_paged_attention(*args, q_block=qb, **sc),
                50, flush, spin=True), "max_abs_err": err}
            del args, sc
    elif what == "egress_cap":
        out = _gpt_egress(chip_smoke)
    elif what in GROUPS:
        out = _group_times(chip_smoke, what)
    elif what == "row7":
        out = _epilogue(chip_smoke)
    elif what == "rms":
        out = _rms_digests(chip_smoke)
    elif what.startswith("stamps"):
        out = _stamps(chip_smoke, what.split(":")[1].split(","))
    elif what == "norm":
        # this checkout's cases (no launch check: an older tree's RMS
        # backwards are several launches), ROOT's kernels
        out = {}
        for name, rs in _cases().norm_kernel_phase(
                0, "", check_launches=False).items():
            out[name] = {r["case"]: r["ms"] for r in rs}
            out[name].update({r["case"] + "_without_dres":
                              r["ms_without_dres"] for r in rs
                              if "ms_without_dres" in r})
        out["sha256"] = _norm_digests()
    elif what == "ln_groups":
        out = _ln_groups(chip_smoke)
    elif what == "norm_split":
        out = _norm_split(chip_smoke)
    elif what in ("qmm", "partial"):
        # this checkout's cases, ROOT's kernels (ROOT is first on sys.path)
        cases = _cases()
        if what == "qmm":
            out = {r["case"]: r["ms"]
                   for r in cases.quant_matmul_cases(0, "")}
        else:
            flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                device="cuda")
            out = {"row6": {r["case"]: r["ms"] for r in
                            cases.tp_partial_cases(0, "", flush)},
                   "row5": {r["case"]: r["ms"] for r in
                            cases.llama_decode_kernel_cases(
                                0, "", flush)["fused_decode_mlp"]}}
    elif what == "attn_splits":
        # the decode route's split length (DECODE_SPLIT) in turns, ROOT's
        # kernel at this checkout's cases
        from paddle_tpu_torch.ops.cuda import paged_attention as pa
        cases = _cases()
        out = []
        for split in (64, 128, 256, 512, 256, 128, 64):
            pa.DECODE_SPLIT = split
            out.append({"decode_split": split,
                        "ms": {r["case"]: r["ms"] for r in
                               cases.kernel_phase(0, "")
                               if r["route"] == "decode"}})
    elif what == "attn_probe":
        # each attention case as served, with every kv_len 1 (the least
        # work), and with every q_len 0 (no unit: the launch, the plan and
        # the zeroed rows alone)
        from paddle_tpu_torch.ops.cuda import paged_attention as pa
        cases = _cases()
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
        gen = torch.Generator().manual_seed(0)
        out = {}
        for (name, kvl, ql, hq, hk, d, ps, qb, pages, width,
             T) in cases.attention_cases(0):
            args, sc = cases._attn_case(gen, kvl, ql, hq, hk, d, ps, qb,
                                        pages, width, T, int8="int8" in name)
            q, k, v, bt, kv, qlen = args
            row = {}
            for what_, kv_, ql_ in (("served", kv, qlen),
                                    ("kv_len_1", torch.ones_like(kv), qlen),
                                    ("q_len_0", kv, torch.zeros_like(qlen))):
                row[what_] = cases._time_ms(
                    lambda: pa.ragged_paged_attention(
                        q, k, v, bt, kv_, ql_, q_block=qb, **sc), 50, flush,
                    spin=True)
            out[name] = row
            del args, sc, q, k, v
            torch.cuda.empty_cache()
    elif what in ("attn", "opt"):
        # this checkout's cases, ROOT's kernels (ROOT is first on sys.path)
        cases = _cases()
        if what == "attn":
            out = {r["case"]: {"ms": r["ms"], "max_abs_err": r["max_abs_err"],
                               "bound_ms": r["bound_ms"]}
                   for r in cases.kernel_phase(0, "", check_routes=False)}
        else:
            flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                device="cuda")
            out = {r["case"]: {"ms": r["ms"], "library_ms": r["library_ms"],
                               "bound_ms": r["bound_ms"]}
                   for r in cases.optimizer_cases(0, "", flush)}
    elif what == "gserve":
        out = {}
        for kv_quant in (False, True):
            s = chip_smoke.serve_phase(0, megakernel=True, kv_quant=kv_quant)
            out["int8_pools" if kv_quant else "fp32_pools"] = dict(
                tokens_per_s=s["tokens_per_s"],
                decode_dispatch_ms=s["decode_dispatch_ms"],
                **{k: s["window"][k] for k in (
                    "launches_per_step", "device_ms_per_step",
                    "wall_ms_per_step", "busy_share")})
            del s
    elif what == "qserve":
        q = chip_smoke.llama_serve_phase(0)
        out = {k: q[k] for k in ("tokens_per_s", "mixed_step_ms",
                                 "decode_dispatch_ms", "logit_gap")}
        out.update(busy_ms=q["profile"]["busy_ms"],
                   busy_share=q["profile"]["busy_share"],
                   top=q["profile"]["top"][:6],
                   decode_device_ms_per_step=q["window"][
                       "device_ms_per_step"],
                   mixed_steps=q["stats"]["mixed_steps"],
                   decode_dispatches=q["decode_dispatches"])
    elif what == "llama":
        # ROOT's LLaMA train phase (4 layers at LLaMA-7B width, 2 x 2048)
        # glue off, glue on and under the norm backend, one draw
        from paddle_tpu_torch.models import llama_state_from_jax
        cfg = chip_smoke.llama_train_config()
        state = llama_state_from_jax(
            chip_smoke.jax_layout_llama_weights(cfg, 0))
        out = {}
        for tag, glue, backend in (("glue_off", False, False),
                                   ("glue_on", True, False),
                                   ("norm_backend", False, True)):
            tr = chip_smoke.llama_train_phase(0, glue, cfg, state=state,
                                              norm_backend=backend)
            out[tag] = {"step_ms": tr["step_ms"],
                        "busy_ms": tr["profile"]["busy_ms"],
                        "busy_share": tr["profile"]["busy_share"],
                        "launches": tr["profile"]["launches"]}
            del tr
    else:
        # an older checkout's train_phase may not take ``glue``
        kw = {"glue": dict(glue=True),
              "nbackend": dict(norm_backend=True, steps=5)}.get(what, {})
        tr = chip_smoke.train_phase(0, **kw)
        out = {"step_ms": tr["step_ms"], "busy_ms": tr["profile"]["busy_ms"],
               "busy_share": tr["profile"]["busy_share"],
               "launches": tr["profile"].get("launches")}
    print("AB", json.dumps({"root": root, what: out}), flush=True)


def _cases():
    """THIS checkout's ``chip_smoke.py`` as a module of its own, its cases
    run against the kernels of the ROOT first on ``sys.path``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", Path(__file__).resolve().parent / "chip_smoke.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    return cases


def _gpt_egress(chip_smoke):
    """GPT-124M's decode egress on ROOT's plan (ms behind the device spin,
    L2 flushed, 50 calls a case, the cases twice in turns): row 5 at B 8,
    5 and 1, row 6 at a TP=2 rank's B 8 and 5."""
    import torch

    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    H = 768

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    nw, nb = 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    full = (rn(8, H), rn(8, H), rn(H, H, std=0.003), rn(H, std=0.02), nw,
            nb, rn(3072, H, std=0.02), rn(3072, std=0.02),
            rn(H, 3072, std=0.003), rn(H, std=0.02))
    part = (rn(8, H), nw, nb, rn(1536, H, std=0.02), rn(1536, std=0.02),
            rn(H, 1536, std=0.003))
    cases = [(f"row5_b{B}", fm.fused_decode_mlp,
              tuple(t[:B] for t in full[:2]) + full[2:]) for B in (8, 5, 1)]
    cases += [(f"row6_tp2_b{B}", fm.fused_decode_mlp_partial,
               (part[0][:B],) + part[1:]) for B in (8, 5)]
    out = {"plan": fm.egress_plan(8, H, H, 3072, gelu=True)}
    for _ in range(2):
        for name, fn, args in cases:
            out.setdefault(name, []).append(chip_smoke._time_ms(
                lambda: fn(*args, eps=1e-5), 50, flush, spin=True))
    return out


def _gpt_plans(chip_smoke):
    """GPT-124M's split-K ingress under other plans (ms behind the device
    spin, L2 flushed): fp32 pools, B 8 and 1, one card's 36 heads and a
    TP=2 rank's 18, at several K-slices a head; and an empty launch."""
    import torch

    from paddle_tpu_torch.ops.cuda import fused_decode_qkv as fq
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, hd, ps = 768, 64, 16

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    def timed(fn):
        return chip_smoke._time_ms(fn, 50, flush, spin=True)

    nw, nb = 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    out = {"ingress": {}}
    # the floor of _time_ms: one launch of a kernel that does nothing
    out["empty_launch"] = timed(lambda: torch.cuda._sleep(1))
    keep = fq.split_plan
    try:
        for nh in (12, 6):
            n = 3 * nh * hd
            w, b = rn(n, H, std=0.02), rn(n, std=0.02)
            pools = [rn(nh, 65, ps, hd) for _ in range(2)]
            for B in (8, 1):
                x = rn(B, H)
                pos = torch.arange(B, device="cuda") * 13
                bt = torch.arange(1, 1 + 8 * B, device="cuda",
                                  dtype=torch.int32).reshape(B, 8)
                kw = dict(eps=1e-5, n_heads=nh, n_kv_heads=nh, head_dim=hd)
                for S in (3, 4, 6, 8, 4, 3):
                    fq.split_plan = lambda *a, S=S: S
                    out["ingress"].setdefault(f"{3 * nh}heads_b{B}_S{S}", []).append(timed(
                        lambda: fq.fused_decode_qkv(x, nw, nb, w, b, pos, bt,
                                                    *pools, **kw)))
    finally:
        fq.split_plan = keep
    return out


def _rms_digests(chip_smoke):
    """sha256 of the fused residual + RMSNorm kernels' outputs, the
    forward's (row 11) apart from the backward's (row 12, with and
    without dres), on inputs drawn from seed 0 at the LLaMA-7B rows
    (bf16, w bf16; fp32) and 4093 rows, and ms per call behind the
    device spin."""
    import torch

    from paddle_tpu_torch.ops.cuda import fused_residual_norm as fr
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, n, dt in (("bf16", 4096, torch.bfloat16),
                        ("f32", 4096, torch.float32),
                        ("rows4093_bf16", 4093, torch.bfloat16)):
        x, y, dres, dn = (torch.randn(n, 4096, generator=gen, device="cuda")
                          .to(dt) for _ in range(4))
        w = (1.0 + 0.1 * torch.randn(4096, generator=gen, device="cuda")
             ).to(dt)
        res, normed, rstd = fr.fused_residual_rms_norm_fwd(x, y, w, 1e-6)
        d, dw = fr.fused_residual_rms_norm_bwd(res, w, rstd, dres, dn)
        d0, dw0 = fr.fused_residual_rms_norm_bwd(res, w, rstd, None, dn)
        torch.cuda.synchronize()
        out[name] = {
            "fwd_sha256": _digest((res, normed, rstd)),
            "bwd_sha256": _digest((d, dw, d0, dw0)),
            "fwd_ms": chip_smoke._time_ms(
                lambda: fr.fused_residual_rms_norm_fwd(x, y, w, 1e-6), 50,
                flush, spin=True),
            "bwd_ms": chip_smoke._time_ms(
                lambda: fr.fused_residual_rms_norm_bwd(res, w, rstd, dres,
                                                       dn), 50, flush,
                spin=True),
            "bwd_ms_without_dres": chip_smoke._time_ms(
                lambda: fr.fused_residual_rms_norm_bwd(res, w, rstd, None,
                                                       dn), 50, flush,
                spin=True)}
    return out


def _norm_digests():
    """sha256 of each norm kernel's outputs (rows 9-16; each backward
    from its own forward's outputs, the fused ones with and without
    dres) on inputs drawn from seed 0 at the train phases' rows:
    LayerNorm at GPT-124M's ``[8192, 768]`` and 8191 rows in bf16 and
    fp32, RMSNorm at LLaMA-7B's ``[4096, 4096]`` and 4093 rows."""
    import torch

    from paddle_tpu_torch.ops.cuda import fused_residual_norm as fr
    from paddle_tpu_torch.ops.cuda import norms as nm
    gen = torch.Generator(device="cuda").manual_seed(0)
    outs = {}

    def add(name, ts):
        outs.setdefault(name, []).extend(ts)
    for n, h, norm in ((8192, 768, "layer"), (8191, 768, "layer"),
                       (4096, 4096, "rms"), (4093, 4096, "rms")):
        for dt in (torch.bfloat16, torch.float32):
            x, y, dres, g = (torch.randn(n, h, generator=gen, device="cuda")
                             .to(dt) for _ in range(4))
            w = (1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
                 ).to(dt)
            b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(dt)
            if norm == "layer":
                f = fr.fused_residual_layer_norm_fwd(x, y, w, b, 1e-5)
                add("fused_residual_layer_norm_fwd", f)
                res, _, mean, rstd = f
                add("fused_residual_layer_norm_bwd",
                    fr.fused_residual_layer_norm_bwd(res, w, mean, rstd,
                                                     dres, g)
                    + fr.fused_residual_layer_norm_bwd(res, w, mean, rstd,
                                                       None, g))
                f = nm.layer_norm_fwd(x, w, b, 1e-5)
                add("layer_norm_fwd", f)
                add("layer_norm_bwd", nm.layer_norm_bwd(x, w, *f[1:], g))
            else:
                f = fr.fused_residual_rms_norm_fwd(x, y, w, 1e-6)
                add("fused_residual_rms_norm_fwd", f)
                res, _, rstd = f
                add("fused_residual_rms_norm_bwd",
                    fr.fused_residual_rms_norm_bwd(res, w, rstd, dres, g)
                    + fr.fused_residual_rms_norm_bwd(res, w, rstd, None, g))
                f = nm.rms_norm_fwd(x, w, 1e-6)
                add("rms_norm_fwd", f)
                add("rms_norm_bwd", nm.rms_norm_bwd(x, w, f[1], g))
            torch.cuda.synchronize()
            del x, y, dres, g
    return {k: _digest(ts) for k, ts in sorted(outs.items())}


def _norm_split(chip_smoke, calls=20):
    """How a call of each RMS backward at LLaMA-7B's rows (``[4096,
    4096]``) divides among its device kernels: row 12 bf16 (w bf16, as
    under O2) with dres and without, row 14 fp32 and bf16. For each,
    ``torch.profiler`` over ``calls`` calls, each after the L2 flush (its
    fill kernel is listed too): device us a call and launches by kernel;
    and the call's ms behind the device spin (``_time_ms``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.cuda import fused_residual_norm as fr
    from paddle_tpu_torch.ops.cuda import norms as nm
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = h = 4096
    out = {}
    for name, dt, fused, with_dres in (
            ("row12_bf16", torch.bfloat16, True, True),
            ("row12_bf16_no_dres", torch.bfloat16, True, False),
            ("row14_f32", torch.float32, False, False),
            ("row14_bf16", torch.bfloat16, False, False)):
        x, dres, g = (torch.randn(n, h, generator=gen, device="cuda")
                      .to(dt) for _ in range(3))
        w = (1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
             ).to(dt)
        rstd = torch.rsqrt(x.float().square().mean(1, keepdim=True) + 1e-6)
        if fused:
            d = dres if with_dres else None
            fn = (lambda x=x, w=w, r=rstd, d=d, g=g:
                  fr.fused_residual_rms_norm_bwd(x, w, r, d, g))
        else:
            fn = (lambda x=x, w=w, r=rstd, g=g:
                  nm.rms_norm_bwd(x, w, r, g))
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        by = {e.key[:120]: {"us_a_call": e.self_device_time_total / calls,
                            "launches_a_call": e.count / calls}
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0}
        out[name] = {"kernels": by,
                     "ms": chip_smoke._time_ms(fn, 50, flush, spin=True)}
        del x, dres, g
    return out


def _ln_groups(chip_smoke):
    """The norm backward under other plans (ms behind the device spin, L2
    flushed), at GPT-124M's rows (row 10: ``[8192, 768]`` bf16 with dres,
    and fp32; row 16: fp32) and LLaMA-7B's (row 12: ``[4096, 4096]`` bf16,
    w bf16, with dres and without; row 14: fp32): LN_LANE_MOST 3 (the
    plan's), 4, 6 and 1 16-byte chunks a lane, in turns, with each plan's
    G; then every count of CTAs an SM from one to the most the SMs hold
    (each CTA writes one partial row, so this is also the partial rows'
    count), in turns; and after a flush that leaves the L2 clean."""
    import torch

    from paddle_tpu_torch.ops.cuda import fused_residual_norm as fr
    from paddle_tpu_torch.ops.cuda import norms as nm
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, norm, n, h, dt, fused, with_dres in (
            ("row10_bf16", nm._LAYER, 8192, 768, torch.bfloat16, True, True),
            ("row10_f32", nm._LAYER, 8192, 768, torch.float32, True, True),
            ("row16_f32", nm._LAYER, 8192, 768, torch.float32, False, False),
            ("row12_bf16", nm._RMS, 4096, 4096, torch.bfloat16, True, True),
            ("row12_bf16_no_dres", nm._RMS, 4096, 4096, torch.bfloat16, True,
             False),
            ("row14_f32", nm._RMS, 4096, 4096, torch.float32, False, False)):
        x, dres, g = (torch.randn(n, h, generator=gen, device="cuda")
                      .to(dt) for _ in range(3))
        w = (1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
             ).to(dt)
        _, mean, rstd = nm.layer_norm_fwd(x, w, torch.zeros_like(w))
        d = dres if with_dres else None
        if norm == nm._RMS:
            fn = (lambda x=x, w=w, r=rstd, d=d, g=g:
                  fr.fused_residual_rms_norm_bwd(x, w, r, d, g)) if fused \
                else (lambda x=x, w=w, r=rstd, g=g:
                      nm.rms_norm_bwd(x, w, r, g))
        else:
            fn = (lambda x=x, w=w, m=mean, r=rstd, d=d, g=g:
                  fr.fused_residual_layer_norm_bwd(x, w, m, r, d, g)) \
                if fused else (lambda x=x, w=w, m=mean, r=rstd, g=g:
                               nm.layer_norm_bwd(x, w, m, r, g))
        cases.append((name, norm, h, dt, fn))
    keep = nm.LN_LANE_MOST
    out = {}
    try:
        for most in (3, 4, 6, 1, 3):
            nm.LN_LANE_MOST = most
            for name, norm, h, dt, fn in cases:
                G, _ = nm.ln_bwd_group(h, dt.itemsize, norm=norm)
                out.setdefault(f"{name}_G{G}", []).append(
                    chip_smoke._time_ms(fn, 50, flush, spin=True))
    finally:
        nm.LN_LANE_MOST = keep

    class ReadFlush:
        """An L2 flush that reads 256 MB: it leaves no dirty line."""
        def zero_(self):
            flush.sum()

    occ = dict(nm._ln_occupancy)
    for name, norm, h, dt, fn in cases:
        fn()  # its occupancy in the cache
        G, _ = nm.ln_bwd_group(h, dt.itemsize, norm=norm)
        keys = [k for k in nm._ln_occupancy
                if k[2:] == (norm, dt, True, h, G)]
        most = min(nm._ln_occupancy[k] for k in keys)
        turns = list(range(most, 0, -1)) + list(range(1, most + 1))
        try:
            for c in turns:
                nm._ln_occupancy.update({k: c for k in keys})
                out.setdefault(f"{name}_{c}cta_per_sm", []).append(
                    chip_smoke._time_ms(fn, 50, flush, spin=True))
        finally:
            nm._ln_occupancy.update(occ)
        out[f"{name}_clean_l2"] = chip_smoke._time_ms(fn, 50, ReadFlush(),
                                                      spin=True)
    return out


def _digest(ts):
    import hashlib

    import torch
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _decode_digests():
    """sha256 of the GPT-124M fused decode kernels' outputs over fp32
    pools (ingress q and pools, egress, epilogue logits, nxt and bad with
    one NaN-poisoned row) on inputs drawn from seed 0 at the megakernel
    serve's shapes."""
    import torch

    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    from paddle_tpu_torch.ops.cuda import fused_decode_qkv as fq
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, nh, hd, V, ps, NP = 8, 768, 12, 64, 50304, 16, 64
    P = 1 + B * NP

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    x, att = rn(B, H), rn(B, H)
    lw, lb = 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    pos = torch.randint(0, 1024, (B,), generator=gen, device="cuda")
    bt = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * NP]
          + 1).reshape(B, NP).to(torch.int32)
    kp, vp = rn(nh, P, ps, hd), rn(nh, P, ps, hd)
    q, kp, vp = fq.fused_decode_qkv(
        x, lw, lb, rn(3 * H, H, std=0.02), rn(3 * H, std=0.02), pos, bt, kp,
        vp, eps=1e-5, n_heads=nh, n_kv_heads=nh, head_dim=hd)
    y = fm.fused_decode_mlp(x, att, rn(H, H, std=0.02), rn(H, std=0.02), lw,
                            lb, rn(4 * H, H, std=0.02), rn(4 * H, std=0.02),
                            rn(H, 4 * H, std=0.02), rn(H, std=0.02),
                            eps=1e-5)
    poison = torch.zeros(B, device="cuda")
    poison[2] = float("nan")
    lg, nxt, bad = fm.fused_decode_epilogue(x, lw, lb, rn(V, H, std=0.02),
                                            None, poison, eps=1e-5,
                                            transpose_lm=True)
    torch.cuda.synchronize()
    return {"qkv": _digest((q, kp, vp)), "mlp": _digest((y,)),
            "epilogue": _digest((lg, nxt, bad))}


def _group_times(chip_smoke, what):
    """ms (behind the device spin, L2 flushed) and a sha256 of the outputs
    of one fused decode kernel at the LLaMA-7B decode shapes, B = 8 and
    1, fp32 (the epilogue, ``epilogue`` and ``epi_nodot``, also at B 16
    and at GPT-124M's LayerNorm and tied head)."""
    import torch

    from paddle_tpu_torch.models.generation import _rope_tables
    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    from paddle_tpu_torch.ops.cuda import fused_decode_qkv as fq
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, nh, hd, V, ps = 4096, 32, 128, 32000, 16

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    nw = 1.0 + rn(H, std=0.1)
    if what == "qkv":
        ws = [rn(nh * hd, H, std=0.02) for _ in range(3)]
        P = 1 + 8 * 128
        pools = [rn(nh, P, ps, hd) for _ in range(2)]
    else:
        w_lm = rn(V, H, std=0.02)
    out = {}
    for B in (8, 1) if what == "qkv" else (8, 1, 16):
        x = rn(B, H)
        if what == "qkv":
            pos = torch.randint(0, 2048, (B,), generator=gen, device="cuda")
            bt = torch.arange(1, 1 + B * 128, device="cuda",
                              dtype=torch.int32).reshape(B, 128)
            kw = dict(eps=1e-6, n_heads=nh, n_kv_heads=nh, head_dim=hd,
                      norm="rms", rope=_rope_tables(pos, hd, 1e4))

            def fn():
                return fq.fused_decode_qkv(x, nw, None, ws, [], pos, bt,
                                           *pools, **kw)
        else:
            zero = torch.zeros(B, device="cuda")

            def fn():
                return fm.fused_decode_epilogue(x, nw, None, w_lm, None,
                                                zero, norm="rms", eps=1e-6)
        res = fn()
        torch.cuda.synchronize()
        out[f"llama7b_b{B}"] = {
            "ms": chip_smoke._time_ms(fn, 30, flush, spin=True),
            "sha256": _digest(res)}
    if what.startswith("epi"):
        del w_lm
        Hg, B = 768, 8
        x, wte = rn(B, Hg), rn(50304, Hg, std=0.02)
        lw, lb, zero = 1.0 + rn(Hg, std=0.1), rn(Hg, std=0.1), \
            torch.zeros(B, device="cuda")

        def fn():
            return fm.fused_decode_epilogue(x, lw, lb, wte, None, zero,
                                            eps=1e-5, transpose_lm=True)
        res = fn()
        torch.cuda.synchronize()
        out["gpt124m_b8"] = {
            "ms": chip_smoke._time_ms(fn, 50, flush, spin=True),
            "sha256": _digest(res)}
    return out


# Row 7's cases (``row7``): (name, hidden, vocab, norm, the B tried)
EPI_CASES = (("llama7b", 4096, 32000, "rms", (1, 5, 8, 16)),
             ("gpt124m", 768, 50304, "layer", (8, 5, 1)))


def _epilogue_case(gen, hid, vocab, norm, rows):
    """Inputs of row 7 at one model's decode shapes for ``rows`` rows
    (drawn at the most rows and cut, so every B of a model reads the
    same weights): ``(args, kwargs)`` of ``fused_decode_epilogue``, the
    poison lane zero."""
    import torch

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    x, nw = rn(max(rows), hid), 1.0 + rn(hid, std=0.1)
    if norm == "rms":    # LLaMA: RMSNorm, an untied head without bias
        nb, kw = None, dict(norm="rms", eps=1e-6)
    else:                # GPT: LayerNorm with bias, the tied embedding
        nb, kw = rn(hid, std=0.1), dict(eps=1e-5, transpose_lm=True)
    w_lm = rn(vocab, hid, std=0.02)
    return x, nw, nb, w_lm, kw


def _epilogue(chip_smoke, calls=30):
    """Row 7 on ROOT's kernel (``EPI_CASES``): LLaMA-7B's RMSNorm and
    untied head ``[32000, 4096]`` at B 1, 5, 8 and 16, GPT-124M's
    LayerNorm and tied ``[50304, 768]`` at B 8, 5 and 1. Per case the
    ms behind the device spin, L2 flushed (``calls`` calls), and the
    sha256 of the outputs (logits, nxt, bad; row B // 2 NaN-poisoned)
    of two calls, with whether they agree; ``"refused: ..."`` where
    ROOT's wrapper raises at that B; and, as a yardstick of how fast the
    card streams the head, the ms of ``torch.sum`` over it."""
    import torch

    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for model, hid, vocab, norm, rows in EPI_CASES:
        x, nw, nb, w_lm, kw = _epilogue_case(gen, hid, vocab, norm, rows)
        out[f"{model}_head_sum_ms"] = chip_smoke._time_ms(
            lambda: torch.sum(w_lm), calls, flush, spin=True)
        for B in rows:
            zero = torch.zeros(B, device="cuda")
            poison = zero.clone()
            poison[B // 2] = float("nan")
            xb = x[:B].contiguous()
            try:
                digests = []
                for _ in range(2):
                    res = fm.fused_decode_epilogue(xb, nw, nb, w_lm, None,
                                                   poison, **kw)
                    torch.cuda.synchronize()
                    digests.append(_digest(res))
            except ValueError as e:
                out[f"{model}_b{B}"] = f"refused: {e}"
                continue
            out[f"{model}_b{B}"] = {
                "ms": chip_smoke._time_ms(
                    lambda: fm.fused_decode_epilogue(xb, nw, nb, w_lm, None,
                                                     zero, **kw),
                    calls, flush, spin=True),
                "sha256": digests[0], "repeat_equal": digests[0] == digests[1]}
        del x, w_lm
        torch.cuda.empty_cache()
    return out


def _group_copies(root, names=()):
    """One copy of ROOT's port a group size, under ROOT/_chipcopy/groups,
    for each of GROUPS (or of ``names``): [(kernel, size, copy root)]."""
    base = Path(root).resolve()
    out = []
    for what, (src, line, fmt, sizes) in GROUPS.items():
        if names and what not in names:
            continue
        for i, n in enumerate(sizes):
            tag = re.sub(r"\W+", "", "x".join(map(str, n))
                         if isinstance(n, tuple) else str(n))
            dst = base / "_chipcopy" / "groups" / f"{what}{tag}_{i}"
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(base / "paddle_tpu_torch", dst / "paddle_tpu_torch",
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            shutil.copy(base / "chip_smoke.py", dst / "chip_smoke.py")
            cu = dst / "paddle_tpu_torch" / "ops" / "cuda" / "csrc" / src
            text = cu.read_text()
            many = isinstance(line, tuple)
            for ln, ft, v in zip(line if many else (line,),
                                 fmt if many else (fmt,),
                                 n if many else (n,)):
                text, k = re.subn(ln, ft.format(v), text)
                if k != 1:
                    raise RuntimeError(f"{src}: {k} lines match {ln!r}")
            cu.write_text(text)
            out.append((what, n, str(dst)))
    return out


# Phase stamps of the decode kernels (``stamps``): a copy of ROOT's port
# under ROOT/_chipcopy/stamps whose sources write %globaltimer at these
# points, thread 0 of each CTA, into a __device__ array (zeroed before
# each traced call) read back with cudaMemcpyFromSymbol: (anchor, stamp
# index) inserted after the anchor's text, (text, replacement, stamp
# index) replaced.
_STAMP_HEAD = """
__device__ unsigned long long g_stamps[4096 * 16];
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned long long stamp_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s + 1ull;
}
extern "C" int pdt_read_stamps(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * 8);
}
extern "C" int pdt_clear_stamps() {
  static unsigned long long zeros[4096 * 16];
  return (int)cudaMemcpyToSymbol(g_stamps, zeros, sizeof(zeros));
}
"""
_STAMP = "if (threadIdx.x == 0) g_stamps[blockIdx.x * 16 + {}] = stamp_now();"
STAMPS = {
    # GEMV: 0 entry, 1 x staged, 2 K-slice done, 3 exit
    "quant_matmul.cu": (
        "#include <stdint.h>\n",
        [("  extern __shared__ __align__(16) uint4 xs[];\n", 0),
         ("        __syncthreads();\n", 1),
         ("  // sum[nt][e]: channel rA (e < 2) or rB, x row 8 nt + 2 t + e % 2\n", 2)],
        [("  if (one) return;", "  if (one) {{ {} return; }}", 3),
         ("  if (!is_last) return;", "  if (!is_last) {{ {} return; }}", 3),
         ("  if (threadIdx.x == 0) a.tickets[rb] = 0;\n}",
          "  if (threadIdx.x == 0) a.tickets[rb] = 0;\n  {}\n}}", 3)]),
    # egress: 0 entry, 1 first activations staged, 2 first MLP product's
    # items done, 3 its sums done, 4 past the grid barrier, 5 second
    # product's items done, 6 exit; row 5: 7 out-projection items done, 8
    # its sums done, 9 past the grid barrier, 10 the MLP's slice staged
    "fused_decode_mlp.cu": (
        '#include "decode_gemv.cuh"\n',
        [("  float* stat = ys + (p.fast ? 0 : (size_t)p.B * p.H);\n", 0),
         ("    if (s0.in) stage_0();\n", 1),
         ("    stage_a();\n  }\n", 1),
         ("  auto boundary_a = [&]() {\n", 2),
         ("    if (!full) reset(tB, p.CB);\n", 3),
         ("    reset(tA, p.CA);\n", 4),
         ("  // after the second product: out = the slices' sum (row 6), y1 + (that +\n"
          "  // b2) (row 5)\n", 5),
         ("  auto boundary_0 = [&]() {\n", 7),
         ("    reset(tB, p.CB);\n    grid.sync();\n", 9),
         ("      arrive(s0.cb, p.S0, s0.s, p.B * cols, e0, e1);\n", 8)],
        [("      p.out[o] = t;\n    }\n  }\n}",
          "      p.out[o] = t;\n    }}\n  }}\n  {}\n}}", 6),
         ("    if (sa.in) stage_a();\n  };",
          "    if (sa.in) stage_a();\n    {}\n  }};", 10)]),
    # split-K ingress: 0 entry, 1 slice staged, 2 slice sums written, 3
    # exit (all but a head's last CTA), 4 the head's last CTA's exit
    "fused_decode_qkv.cu": (
        '#include "decode_gemv.cuh"\n',
        [("  __shared__ int is_last;\n", 0),
         ("    xs[r * kSplitQ + q] = v;\n  }\n  __syncthreads();\n", 1),
         ("  // publish, then count the head's arrivals: its last CTA finishes it\n", 2)],
        [("  if (!is_last) return;", "  if (!is_last) {{ {} return; }}", 3),
         ("  write_head(p, os, keys, which, j);\n}\n\n// Rows the split kernel's",
          "  write_head(p, os, keys, which, j);\n  {}\n}}\n\n// Rows the split kernel's", 4)]),
    # the norm backward: 0 entry, 1 the first row's loads landed
    # (thread 0's), 2 its group's rows done, 3 the CTA's partial row
    # written, 4 past the grid barrier, 5 its slice of dw/db written
    "row_norm.cuh": (
        "#include <stdint.h>\n",
        [("  __shared__ float2 gsum[2][kWarps];\n", 0),
         ("  // rows done: the CTA's partial row [dw | db | 0 pad], groups in order\n", 2),
         ("  // partial row written: every CTA's is in past the grid barrier\n", 3),
         ("  cg::this_grid().sync();\n", 4),
         ("  // dw and db written\n", 5)],
        [("    // first loads landed\n",
          "    // first loads landed\n    if (it == 0) {{ {} }}\n", 1)]),
}
# The epilogue (row 7, ``stamps ROOT epilogue``), one anchor set a design,
# the first of which the source holds every anchor once (the earlier design
# of 64 columns a CTA, "cta64", so that a parent tree can be stamped too): 0 entry, 1 x staged
# (thread 0's loads), 2 rows normalised, 3 the first weights landed (cta64:
# warp 0's first column group done), 4 the CTA's columns done, 5 its
# partial written and the ticket taken (its exit, but for the last CTA's),
# 6 the last CTA's reduce done; persistent: 7 the first rows' statistics
# read; 15 the SM (stamp_smid), at entry.
_SMID = "if (threadIdx.x == 0) g_stamps[blockIdx.x * 16 + 15] = stamp_smid();"
EPI_STAMPS = {
    "cta64": (
        [("  __shared__ int is_last;\n", 0),
         ("  decode::load_rows<1>(hs, p.x, p.B, p.H);\n", 1),
         ("    decode::layer_norm_rows(hs, p.nw, p.nb, p.B, p.H, p.eps);\n", 2),
         ("  // this CTA's partial per row, then the ticket\n", 4),
         ("  if (threadIdx.x == 0) is_last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;\n",
          5)],
        [("      decode::warp_dot_multi<kEpiGroup>(rows, hs + (size_t)r0 * p.H, p.H, nr, acc);\n",
          "      decode::warp_dot_multi<kEpiGroup>(rows, hs + (size_t)r0 * p.H, p.H, nr, acc);\n"
          "      if (threadIdx.x == 0 && g_stamps[blockIdx.x * 16 + 3] == 0) {{ {} }}\n",
          3),
         ("  if (threadIdx.x == 0) *p.ticket = 0u;\n}",
          "  if (threadIdx.x == 0) *p.ticket = 0u;\n  {}\n}}", 6)]),
}
EPI_STAMPS["persistent"] = (
    [("  __shared__ int is_last;\n", 0),
     ("  cp_async_wait<kEpiStages - 1>();\n  __syncthreads();\n", 1),
     ("  if (NC == 1) decode::row_norm_stats(stat, xs, rows_of(0), p.H, kRms, p.eps);\n",
      7),
     ("  float acc[kG][RT];\n", 2),
     ("  // and puts the ticket back to 0\n", 4),
     ("  if (threadIdx.x == 0) is_last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;\n",
      5)],
    [("        cp_async_wait<kEpiStages - 1>();\n        const int q =",
      "        cp_async_wait<kEpiStages - 1>();\n        if (t == 0) {{ {} }}\n"
      "        const int q =", 3),
     ("  if (threadIdx.x == 0) *p.ticket = 0u;\n}",
      "  if (threadIdx.x == 0) *p.ticket = 0u;\n  {}\n}}", 6)])
STAMP_SETS = ("decode", "norm", "epilogue")


def _stamp_copy(root):
    """ROOT's port with the STAMPS points, under ROOT/_chipcopy/stamps."""
    base = Path(root).resolve()
    dst = base / "_chipcopy" / "stamps"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(base / "paddle_tpu_torch", dst / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(base / "chip_smoke.py", dst / "chip_smoke.py")
    for src, (head, after, replace) in STAMPS.items():
        cu = dst / "paddle_tpu_torch" / "ops" / "cuda" / "csrc" / src
        text = cu.read_text()
        edits = [(head, head + _STAMP_HEAD)]
        edits += [(a, a + "  " + _STAMP.format(i) + "\n") for a, i in after]
        edits += [(a, b.format(_STAMP.format(i))) for a, b, i in replace]
        if src == "fused_decode_mlp.cu":
            edits += _epi_edits(text)
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{src}: stamp anchor found "
                                   f"{text.count(old)} times: {old!r}")
            text = text.replace(old, new)
        cu.write_text(text)
    return str(dst)


def _epi_edits(text):
    """The edits of the first EPI_STAMPS design whose anchors ``text``
    holds once each, the SM stamp after the entry stamp's anchor."""
    for after, replace in EPI_STAMPS.values():
        anchors = [a for a, _ in after] + [a for a, _, _ in replace]
        if all(text.count(a) == 1 for a in anchors):
            edits = [(a, a + "  " + _STAMP.format(i) + "\n"
                      + ("  " + _SMID + "\n" if i == 0 else ""))
                     for a, i in after]
            return edits + [(a, b.format(_STAMP.format(i)))
                            for a, b, i in replace]
    raise RuntimeError("fused_decode_mlp.cu: no epilogue stamp design "
                       "matches")


def _stamps(chip_smoke, which=STAMP_SETS):
    """One traced call of each kernel of the sets in ``which``, each after
    the L2 flush and device spin of ``_time_ms``: per stamp, the (min,
    median, max) over the CTAs that wrote it of us since the first CTA
    began, and the call's event ms. ``decode``: the GEMV (M 1 and 8 at
    q/k/v/o, gate/up and the lm_head), the egress (LLaMA-7B: row 6 at
    TP=2, B 8 and 1, row 5 at B 8; GPT-124M: row 5 at B 8 and 1, row 6 at
    TP=2, B 8) and the split-K ingress (GPT-124M, fp32 pools, B 8 and 1,
    one card's 36 heads and a TP=2 rank's 18); ``norm``: the LayerNorm
    backward at GPT-124M's training rows (row 10 bf16 and fp32, row 16
    fp32)."""
    import ctypes

    import numpy as np
    import torch

    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    from paddle_tpu_torch.ops.cuda import fused_decode_qkv as fq
    from paddle_tpu_torch.ops.cuda import quant_matmul as qm
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    def trace(lib_name, fn, grid, points, exit_slot=None):
        lib = _build.load(lib_name)
        lib.pdt_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        if lib.pdt_clear_stamps() != 0:
            raise RuntimeError("clearing the stamps failed")
        flush.zero_()
        torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (4096 * 16))()
        if lib.pdt_read_stamps(buf, 4096 * 16) != 0:
            raise RuntimeError("reading the stamps failed")
        full = np.array(buf, dtype=np.float64).reshape(4096, 16)[:grid]
        ts = full[:, :points].copy()
        ts[ts == 0] = np.nan
        rel = (ts - np.nanmin(ts[:, 0])) / 1e3
        got = {"event_ms": s.elapsed_time(e), "grid": grid, "us": {
            i: [round(float(f(rel[:, i])), 2) for f in (np.nanmin,
                                                         np.nanmedian,
                                                         np.nanmax)]
            + [int(np.isfinite(rel[:, i]).sum())]
            for i in range(points) if np.isfinite(rel[:, i]).any()}}
        if exit_slot is not None:
            got["resident"] = _resident(full[:, 15], ts[:, 0],
                                        ts[:, exit_slot])
        return got

    out = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if "norm" in which:
        out.update(_norm_stamps(trace, rn, sms))
    if "epilogue" in which:
        out.update(_epi_stamps(trace, chip_smoke))
    if "decode" not in which:
        return out
    for k, n in ((4096, 4096), (4096, 11008), (4096, 32000)):
        qw = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                           dtype=torch.int8).t()
        s = torch.rand(n, generator=gen, device=dev) * 0.002 + 1e-4
        blocks, splits = qm.gemv_plan(k, n, sms)
        for m in (1, 8):
            x = rn(m, k)
            out[f"gemv_m{m}_k{k}_n{n}"] = trace(
                "quant_matmul", lambda: qm.weight_only_matmul(x, qw, s),
                blocks * splits, 4)
        del qw
    kw = dict(arch="llama", norm="rms", eps=1e-6)
    H, inter = 4096, 5504
    for B in (8, 1):
        args = (rn(B, H), 1.0 + rn(H, std=0.1), None, rn(inter, H, std=0.02),
                None, rn(H, inter, std=0.0025), rn(inter, H, std=0.02))
        out[f"row6_b{B}"] = trace(
            "fused_decode_mlp",
            lambda: fm.fused_decode_mlp_partial(*args, **kw),
            fm.egress_plan(B, H, 0, inter, dev)["grid"], 7)
        del args
    B, inter = 8, 11008
    args = (rn(B, H), rn(B, H), rn(H, H, std=0.02), None, 1.0 + rn(H, std=0.1),
            None, rn(inter, H, std=0.02), None, rn(H, inter, std=0.0025), None,
            rn(inter, H, std=0.02))
    out["row5_b8"] = trace("fused_decode_mlp",
                           lambda: fm.fused_decode_mlp(*args, **kw),
                           fm.egress_plan(B, H, H, inter, dev)["grid"], 11)
    del args
    # GPT-124M
    H, hd = 768, 64
    nw, nb = 1.0 + rn(H, std=0.1), rn(H, std=0.1)
    for B in (8, 1):
        args = (rn(B, H), rn(B, H), rn(H, H, std=0.003), rn(H, std=0.02), nw,
                nb, rn(3072, H, std=0.02), rn(3072, std=0.02),
                rn(H, 3072, std=0.003), rn(H, std=0.02))
        out[f"gpt_row5_b{B}"] = trace(
            "fused_decode_mlp", lambda: fm.fused_decode_mlp(*args, eps=1e-5),
            fm.egress_plan(B, H, H, 3072, dev, gelu=True)["grid"], 11)
    args = (rn(8, H), nw, nb, rn(1536, H, std=0.02), rn(1536, std=0.02),
            rn(H, 1536, std=0.003))
    out["gpt_row6_tp2_b8"] = trace(
        "fused_decode_mlp",
        lambda: fm.fused_decode_mlp_partial(*args, eps=1e-5),
        fm.egress_plan(8, H, 0, 1536, dev, gelu=True)["grid"], 7)
    for nh in (12, 6):
        w, b = rn(3 * nh * hd, H, std=0.02), rn(3 * nh * hd, std=0.02)
        pools = [rn(nh, 65, 16, hd) for _ in range(2)]
        for B in (8, 1):
            x = rn(B, H)
            pos = torch.arange(B, device=dev) * 13
            bt = torch.arange(1, 1 + 8 * B, device=dev,
                              dtype=torch.int32).reshape(B, 8)
            grid = 3 * nh * fq.split_plan(H)
            out[f"gpt_row4_{3 * nh}heads_b{B}"] = trace(
                "fused_decode_qkv",
                lambda: fq.fused_decode_qkv(x, nw, nb, w, b, pos, bt, *pools,
                                            eps=1e-5, n_heads=nh,
                                            n_kv_heads=nh, head_dim=hd),
                grid, 5)
    return out


def _resident(smid, t0, t1):
    """From each CTA's SM (+1, 0 unset), entry and exit stamps: the SMs
    used and the most CTAs that ran on one SM at once."""
    import numpy as np
    most, sms = 0, set()
    for sm in set(int(v) for v in smid if v > 0):
        sms.add(sm)
        sel = (smid == sm) & np.isfinite(t0) & np.isfinite(t1)
        ev = sorted([(a, 1) for a in t0[sel]] + [(b, -1) for b in t1[sel]],
                    key=lambda e: (e[0], e[1]))
        run = 0
        for _, d in ev:
            run += d
            most = max(most, run)
    return {"sms": len(sms), "most_ctas_an_sm": most}


def _epi_stamps(trace, chip_smoke):
    """The epilogue's stamps (``_stamps``, EPI_STAMPS) on ROOT's design:
    LLaMA-7B (RMSNorm, untied head) at B 8, 1 and 16 and GPT-124M
    (LayerNorm, tied head) at B 8, with the CTAs' residency an SM; a B
    ROOT's wrapper refuses is reported as such."""
    import torch

    from paddle_tpu_torch.ops.cuda import fused_decode_mlp as fm
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for model, hid, vocab, norm, _ in EPI_CASES:
        rows = (8, 1, 16) if model == "llama7b" else (8,)
        x, nw, nb, w_lm, kw = _epilogue_case(gen, hid, vocab, norm, rows)
        for B in rows:
            xb, zero = x[:B].contiguous(), torch.zeros(B, device="cuda")
            if hasattr(fm, "epilogue_plan"):
                grid = fm.epilogue_plan(B, hid, vocab, norm)["grid"]
            else:       # the earlier design: 64 vocab columns a CTA
                grid = -(-vocab // 64)
            try:
                out[f"{model}_b{B}"] = trace(
                    "fused_decode_mlp",
                    lambda: fm.fused_decode_epilogue(xb, nw, nb, w_lm, None,
                                                     zero, **kw),
                    grid, 8, exit_slot=5)
            except ValueError as e:
                out[f"{model}_b{B}"] = f"refused: {e}"
        del x, w_lm
        torch.cuda.empty_cache()
    return out


def _norm_stamps(trace, rn, sms):
    """The norm backward's stamps (``_stamps``): row 10 at ``[8192,
    768]`` bf16 with dres and fp32, row 16 fp32; row 12 at ``[4096,
    4096]`` bf16 (w bf16) with dres and without, row 14 fp32; each on its
    own library's plan."""
    import torch

    from paddle_tpu_torch.ops.cuda import fused_residual_norm as fr
    from paddle_tpu_torch.ops.cuda import norms as nm
    out = {}
    for name, lib, norm, dt, n, h, with_dres in (
            ("row10_bf16", "fused_residual_norm", nm._LAYER, torch.bfloat16,
             8192, 768, True),
            ("row10_f32", "fused_residual_norm", nm._LAYER, torch.float32,
             8192, 768, True),
            ("row16_f32", "norms", nm._LAYER, torch.float32, 8192, 768,
             False),
            ("row12_bf16", "fused_residual_norm", nm._RMS, torch.bfloat16,
             4096, 4096, True),
            ("row12_bf16_no_dres", "fused_residual_norm", nm._RMS,
             torch.bfloat16, 4096, 4096, False),
            ("row14_f32", "norms", nm._RMS, torch.float32, 4096, 4096,
             False)):
        x, dres, g = (rn(n, h).to(dt) for _ in range(3))
        w = (1.0 + rn(h, std=0.1)).to(dt)
        mean = x.float().mean(1, keepdim=True)
        rstd = torch.rsqrt(x.float().var(1, keepdim=True) + 1e-5)
        if norm == nm._RMS:
            mean = None
            rstd = torch.rsqrt(x.float().square().mean(1, keepdim=True)
                               + 1e-6)
        d = dres if with_dres else None
        entries = (nm._kernels() if lib == "norms" else fr._kernels())[-1]
        G, _ = nm.ln_bwd_group(h, dt.itemsize, norm=norm)
        plan = nm.ln_bwd_plan(n, h, dt, sms,
                              entries[1](norm, nm.DTYPE_CODE[dt], 1, h, G),
                              norm=norm)
        if lib == "norms" and norm == nm._RMS:
            fn = lambda: nm.rms_norm_bwd(x, w, rstd, g)  # noqa: E731
        elif lib == "norms":
            fn = lambda: nm.layer_norm_bwd(x, w, mean, rstd, g)  # noqa
        elif norm == nm._RMS:
            fn = lambda: fr.fused_residual_rms_norm_bwd(  # noqa: E731
                x, w, rstd, d, g)
        else:
            fn = lambda: fr.fused_residual_layer_norm_bwd(  # noqa: E731
                x, w, mean, rstd, d, g)
        out[name] = dict(trace(lib, fn, plan["ctas"], 6), plan=plan)
        del x, dres, g
    return out


def _ptxas(root, names):
    """ptxas's resource usage of ``csrc/<name>.cu`` for each of
    ``names`` under ROOT, built with the port's own flags."""
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops.cuda import _build
    out_dir = Path(root) / "_chipcopy" / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in names:
        res = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "--resource-usage",
             "-o", str(out_dir / f"{name}.so"),
             str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True, timeout=600, check=True)
        for line in (res.stdout + res.stderr).splitlines():
            if "ptxas" in line and ("Used" in line or "Compiling" in line
                                    or "spill" in line):
                print("PTXAS", name, line.strip(), flush=True)


def main(argv):
    if len(argv) >= 3 and argv[0] == "ptxas":
        _ptxas(argv[1], argv[2:])
        return 0
    if len(argv) >= 3 and argv[0] == "--one":
        _one(argv[1], argv[2])
        return 0
    if len(argv) >= 2 and argv[0] == "stamps":
        which = ",".join(argv[2:] or STAMP_SETS)
        subprocess.run([sys.executable, __file__, "--one", f"stamps:{which}",
                        _stamp_copy(argv[1])], check=True, timeout=900)
        return 0
    if len(argv) >= 2 and argv[0] == "groups":
        for what, n, root in _group_copies(argv[1], argv[2:]):
            print("GROUP", json.dumps({"kernel": what, "group": n}),
                  flush=True)
            subprocess.run([sys.executable, __file__, "--one", what, root],
                           check=True, timeout=900)
        return 0
    if len(argv) < 2 or argv[0] not in ("flash", "decode", "train", "glue",
                                        "row7",
                                        "nbackend", "rms", "norm", "qmm",
                                        "qserve", "gserve", "partial",
                                        "attn", "opt", "attn_splits",
                                        "attn_probe", "gpt_plans",
                                        "ln_groups", "norm_split",
                                        "llama"):
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", argv[0], root],
                       check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
