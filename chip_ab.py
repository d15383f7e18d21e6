"""Compare checkouts of the PyTorch port on one CUDA card, in turns.

    python3 chip_ab.py {flash,train} ROOT [ROOT ...]

Runs ``chip_smoke.py``'s flash-attention kernel cases (``flash``: kernel
ms per case, forward and backward) or its train phase (``train``: step
ms, and the device busy ms of the profiled step) from each ROOT in the
order given, each in a process of its own, and prints one ``AB`` JSON
line per run. Give the roots in turns (old, new, new, old) so that
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
    else:
        tr = chip_smoke.train_phase(0)
        out = {"step_ms": tr["step_ms"], "busy_ms": tr["profile"]["busy_ms"],
               "busy_share": tr["profile"]["busy_share"]}
    print("AB", json.dumps({"root": root, what: out}), flush=True)


def main(argv):
    if len(argv) >= 3 and argv[0] == "--one":
        _one(argv[1], argv[2])
        return 0
    if len(argv) < 2 or argv[0] not in ("flash", "train"):
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", argv[0], root],
                       check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
