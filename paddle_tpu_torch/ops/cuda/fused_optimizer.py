"""Fused optimizer update (SGD / Momentum / Adam / AdamW) over one flat
dtype bucket, for Hopper.

Replaces the Pallas TPU kernel ``_pallas_call`` (``_kernel``) of
``paddle_tpu/ops/pallas/fused_optimizer.py``, with its entry
:func:`fused_update` and its static :class:`UpdateSpec` (a copy: the
port imports nothing of the JAX package). One pass over the bucket
applies the clip scale, the L2/L1 fold, the moment updates, the AdamW
decoupled decay and the master-weight cast.

The kernel (``csrc/fused_optimizer.cu``, CUDA C++ rather than Triton:
one build path for all the port's kernels) updates w, m, v and the
master weights IN PLACE, as the TPU kernel's ``input_output_aliases``
donate them: the returned tensors are the ones passed in. It takes runs
of 8 elements with 16-byte loads and stores from the first element at
which every array is 16-byte aligned (:func:`vector_plan`), and the
elements outside the runs one at a time. The four
scalars (lr, clip scale, advanced beta powers) travel in a small device
tensor, so no host sync happens. CPU tensors take the plain version,
:func:`_math` transcribed op for op from the JAX package, and write its
results into the same tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

__all__ = ["UpdateSpec", "fused_update", "fused_update_plain"]

_KINDS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 3}
_REGS = {None: 0, "l2": 1, "l1": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

RUN = 8            # elements a thread takes a turn (one 16-byte bf16 load)

_fn = None


@dataclasses.dataclass(frozen=True)
class UpdateSpec:
    """Static configuration of one bucket's fused update (a copy of the
    JAX package's ``UpdateSpec``)."""

    kind: str                 # "sgd" | "momentum" | "adam" | "adamw"
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    momentum: float = 0.9
    nesterov: bool = False
    rescale: float = 1.0
    decay: float = 0.0        # adamw decoupled coefficient
    reg: str | None = None    # "l2" | "l1" | None (grad-folded)
    reg_coeff: float = 0.0
    use_master: bool = False
    has_clip: bool = False    # a clip scale is applied to the grads

    @property
    def has_moment(self):
        return self.kind in ("momentum", "adam", "adamw")

    @property
    def has_adam(self):
        return self.kind in ("adam", "adamw")


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load
        lib = load("fused_optimizer")
        f = lib.pdt_fused_update
        f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                      + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5
                      + [ctypes.c_float] * 9 + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        lib.pdt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdt_cuda_error_string.restype = ctypes.c_char_p
        _fn = (f, lib.pdt_cuda_error_string)
    return _fn


def vector_plan(n, arrays):
    """``(head, runs)``: the kernel takes ``runs`` runs of RUN elements
    from element ``head``, where every array of ``arrays`` (``(address,
    element bytes)`` pairs) is 16-byte aligned, and the ``n - RUN * runs``
    others one at a time. Arrays that share no such element give
    ``(n, 0)``: every element one at a time."""
    for head in range(RUN):
        if head <= n and all((a + head * e) % 16 == 0 for a, e in arrays):
            return head, (n - head) // RUN
    return n, 0


def _folded_grad(spec, g, w32, scale):
    """clip scale + f32 cast + regularizer fold, in the JAX op order."""
    if spec.has_clip:
        g = (g.float() * scale).to(g.dtype)
    g32 = g.float()
    if spec.reg == "l2" and spec.reg_coeff:
        g32 = g32 + spec.reg_coeff * w32
    elif spec.reg == "l1" and spec.reg_coeff:
        g32 = g32 + spec.reg_coeff * torch.sign(w32)
    return g32


def _math(spec, lr, scale, w, g, master, m, v, nb1, nb2):
    """The update arithmetic (``_math`` of the JAX package, op for op).
    ``nb1``/``nb2`` are the ALREADY-advanced beta powers. Returns
    (new_w, new_master, new_m, new_v) as new tensors."""
    w32 = master if spec.use_master else w.float()
    g32 = _folded_grad(spec, g, w32, scale)
    nm = nv = None
    if spec.kind == "sgd":
        new32 = w32 - lr * g32
    elif spec.kind == "momentum":
        if spec.rescale != 1.0:
            g32 = g32 * spec.rescale
        nm = spec.momentum * m + g32
        if spec.nesterov:
            new32 = w32 - lr * (g32 + spec.momentum * nm)
        else:
            new32 = w32 - lr * nm
    else:  # adam / adamw
        if spec.kind == "adamw" and spec.decay:
            w32 = w32 * (1.0 - lr * spec.decay)
        nm = spec.beta1 * m + (1 - spec.beta1) * g32
        nv = spec.beta2 * v + (1 - spec.beta2) * torch.square(g32)
        m_hat = nm / (1 - nb1)
        v_hat = nv / (1 - nb2)
        new32 = w32 - lr * m_hat / (torch.sqrt(v_hat) + spec.eps)
    new_w = new32.to(w.dtype)
    new_master = new32 if spec.use_master else None
    return new_w, new_master, nm, nv


def _check(spec, w, g, master, m, v):
    if spec.kind not in _KINDS:
        raise ValueError(f"fused_update: unknown kind {spec.kind!r}")
    if spec.reg not in _REGS:
        raise ValueError(f"fused_update: unknown reg {spec.reg!r}")
    need = {"master": spec.use_master, "m": spec.has_moment,
            "v": spec.has_adam}
    got = {"master": master, "m": m, "v": v}
    for name, want in need.items():
        if want and got[name] is None:
            raise ValueError(f"fused_update: spec {spec.kind} needs {name}")
    if w.dim() != 1:
        raise ValueError(f"fused_update: w must be a 1-D flat bucket, got "
                         f"{tuple(w.shape)}")
    if g.shape != w.shape or g.dtype != w.dtype:
        raise ValueError(f"fused_update: g {g.dtype} {tuple(g.shape)} must "
                         f"match w {w.dtype} {tuple(w.shape)}")
    for name, t in (("master", master), ("m", m), ("v", v)):
        if t is None or not need[name]:
            continue
        if t.shape != w.shape or t.dtype != torch.float32:
            raise ValueError(f"fused_update: {name} must be float32 "
                             f"{tuple(w.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    devs = {t.device for t in (w, g, master, m, v) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"fused_update: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def _as_f32(x, dev):
    return (x.to(device=dev, dtype=torch.float32) if torch.is_tensor(x)
            else torch.tensor(float(x), dtype=torch.float32, device=dev))


def fused_update_plain(spec, lr, scale, w, g, master, m, v, nb1, nb2):
    """Plain PyTorch version (any device): :func:`_math`, then its
    results written into ``w``, ``master``, ``m``, ``v`` in place."""
    new_w, new_master, nm, nv = _math(spec, lr, scale, w, g, master, m, v,
                                      nb1, nb2)
    with torch.no_grad():
        w.copy_(new_w)
        if new_master is not None:
            master.copy_(new_master)
        if nm is not None:
            m.copy_(nm)
        if nv is not None:
            v.copy_(nv)


def fused_update(spec: UpdateSpec, *, w, g, lr, clip_scale=None,
                 master=None, m=None, v=None, b1p=None, b2p=None):
    """One fused update over a flat bucket, in place.

    All tensors are 1-D flats of equal (ALIGN-padded) length; ``lr`` and
    ``clip_scale`` are f32 scalars (Python numbers or 0-d tensors);
    ``b1p``/``b2p`` are the bucket's CURRENT beta powers (0-d f32
    tensors), advanced here, outside the kernel. Returns ``(new_w,
    new_master, new_m, new_v, new_b1p, new_b2p)`` with ``None`` for
    absent slots; the first four are ``w``, ``master``, ``m``, ``v``
    themselves, updated. CUDA tensors launch the kernel (counted in
    ``fused_update.launches``) or raise."""
    dev = _check(spec, w, g, master, m, v)
    lr = _as_f32(lr, dev)
    scale = (_as_f32(clip_scale, dev) if clip_scale is not None
             else torch.ones((), dtype=torch.float32, device=dev))
    one = torch.ones((), dtype=torch.float32, device=dev)
    nb1 = b1p * spec.beta1 if spec.has_adam else one
    nb2 = b2p * spec.beta2 if spec.has_adam else one
    master = master if spec.use_master else None
    m = m if spec.has_moment else None
    v = v if spec.has_adam else None
    if dev.type == "cpu":
        fused_update_plain(spec, lr, scale, w, g, master, m, v, nb1, nb2)
    elif dev.type == "cuda":
        _launch(spec, dev, lr, scale, w, g, master, m, v, nb1, nb2)
    else:
        raise ValueError(f"fused_update: no kernel for device {dev}")
    return (w, master, m, v, nb1 if spec.has_adam else None,
            nb2 if spec.has_adam else None)


fused_update.launches = 0


def _launch(spec, dev, lr, scale, w, g, master, m, v, nb1, nb2):
    if w.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_update: the kernel takes float32 or "
                        f"bfloat16 buckets, got {w.dtype}")
    for name, t in (("w", w), ("g", g), ("master", master), ("m", m),
                    ("v", v)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_update: {name} must be contiguous")
    scal = torch.stack([lr.reshape(()), scale.reshape(()),
                        nb1.reshape(()).float(), nb2.reshape(()).float()])

    def ptr(t):
        return None if t is None else t.data_ptr()

    reg = spec.reg if spec.reg_coeff else None
    n = w.numel()
    head, runs = vector_plan(n, [(t.data_ptr(), t.element_size())
                                 for t in (w, g, master, m, v)
                                 if t is not None])
    fn, err_str = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_DTYPE_CODE[w.dtype], w.data_ptr(), g.data_ptr(),
                ptr(master), ptr(m), ptr(v), scal.data_ptr(), n, head,
                runs, _KINDS[spec.kind], int(spec.has_clip), _REGS[reg],
                int(spec.use_master), int(spec.nesterov), spec.beta1,
                spec.beta2, 1 - spec.beta1, 1 - spec.beta2, spec.eps,
                spec.momentum, spec.rescale, spec.decay, spec.reg_coeff,
                stream)
    if rc != 0:
        raise RuntimeError(f"fused_update kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    fused_update.launches += 1
