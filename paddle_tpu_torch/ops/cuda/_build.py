"""Build the CUDA kernels of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for Hopper
(``sm_90a``), into a shared library with a plain C interface that
:mod:`ctypes` loads — no PyTorch headers, so a build takes seconds. The
library lands in ``build/`` beside this file (git-ignored), named by a
hash of its source and flags, so an edited source rebuilds and an
unchanged one loads at once. :func:`build_all` starts one ``nvcc`` per
source, all together. A missing ``nvcc`` or a failed build raises,
naming the command and its stderr: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# where nvcc is looked for after $CUDA_HOME/bin and $PATH
NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def find_nvcc() -> str:
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.extend(NVCC_FALLBACKS)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build the CUDA kernels: nvcc not found (looked in "
        f"$CUDA_HOME/bin, $PATH and {', '.join(NVCC_FALLBACKS)}); the "
        "command would have been: nvcc " + " ".join(NVCC_FLAGS)
        + f" -o <lib>.so {CSRC}/<name>.cu")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every listed source (default: all) that has no current
    library yet, one ``nvcc`` process per source, started together.
    Returns ``{name: library path}``."""
    names = sources() if names is None else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        # compile to a private name, then rename: a concurrent build of
        # the same source never loads a half-written library
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures = []
    for n, (cmd, tmp, proc) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"$ {' '.join(cmd)}\n{err.strip()}")
        else:
            os.replace(tmp, paths[n])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n"
                           + "\n\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _loaded[name] = lib
        return lib
