"""Compare checkouts of the PyTorch port on one CUDA card, in turns.

    python3 chip_ab.py {flash,decode,train,glue,rms} ROOT [ROOT ...]

Runs ``chip_smoke.py``'s flash-attention kernel cases (``flash``: kernel
ms per case, forward and backward), its fused decode kernel cases
(``decode``: kernel ms of each) or its train phase (``train``: step
ms, and the device busy ms and launches of the profiled step; ``glue``
the same with ``train_glue_fusion`` on), or the fused residual
+ RMSNorm kernels on fixed inputs (``rms``: a sha256 of every output's
bytes, so two checkouts' kernels can be held bitwise equal, and ms per
launch), from each ROOT in the order given, each in a process of its
own, and prints one ``AB`` JSON line per run. Give the roots in turns (old, new, new, old) so that
drift of the card or its host shows. Needs a card; the kernels build
in each ROOT.
"""
from __future__ import annotations

import json
import subprocess
import sys


def _one(what, root):
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.build()
    if what == "flash":
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
        fwd, bwd = chip_smoke.flash_cases(0, "", flush)
        out = {"fwd": {r["case"]: r["ms"] for r in fwd},
               "bwd": {r["case"]: r["ms"] for r in bwd}}
    elif what == "decode":
        rows = chip_smoke.decode_kernel_phase(0, "")
        out = {name: r[0]["ms"] for name, r in rows.items()}
    elif what == "rms":
        out = _rms_digests(chip_smoke)
    else:
        # an older checkout's train_phase may not take ``glue``
        kw = {"glue": True} if what == "glue" else {}
        tr = chip_smoke.train_phase(0, **kw)
        out = {"step_ms": tr["step_ms"], "busy_ms": tr["profile"]["busy_ms"],
               "busy_share": tr["profile"]["busy_share"],
               "launches": tr["profile"].get("launches")}
    print("AB", json.dumps({"root": root, what: out}), flush=True)


def _rms_digests(chip_smoke):
    """sha256 of the fused residual + RMSNorm kernels' outputs (forward,
    backward with and without dres) on inputs drawn from seed 0 at the
    LLaMA-7B rows (bf16, fp32) and 4093 rows, and ms per launch."""
    import hashlib

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
        h = hashlib.sha256()
        for t in (res, normed, rstd, d, dw, d0, dw0):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        out[name] = {
            "sha256": h.hexdigest(),
            "fwd_ms": chip_smoke._time_ms(
                lambda: fr.fused_residual_rms_norm_fwd(x, y, w, 1e-6), 50,
                flush),
            "bwd_ms": chip_smoke._time_ms(
                lambda: fr.fused_residual_rms_norm_bwd(res, w, rstd, dres,
                                                       dn), 50, flush)}
    return out


def main(argv):
    if len(argv) >= 3 and argv[0] == "--one":
        _one(argv[1], argv[2])
        return 0
    if len(argv) < 2 or argv[0] not in ("flash", "decode", "train", "glue",
                                        "rms"):
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", argv[0], root],
                       check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
