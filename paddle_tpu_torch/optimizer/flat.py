"""Flat dtype-bucketed optimizer state: the multi-tensor fused path (the
port of ``paddle_tpu/optimizer/flat.py``).

Parameters of one dtype (and device) live in one padded 1-D buffer per
state class: params, master weights, moments, grads. The whole update is
one fused kernel per bucket (``ops/cuda/fused_optimizer.py``).

In-place update replaces the JAX package's functional rebinding. There,
arrays are immutable, so a member is a logical view that re-reads its
slice of a new flat array after every step. Here each parameter is
re-bound once (``p.data``) as a real view of the flat param buffer, and
each master weight and moment is a view of its flat buffer, so the
kernel's in-place write is the update: nothing is copied back.

Gradients are the exception. Autograd's ``AccumulateGrad`` replaces a
``None`` ``.grad`` with a fresh tensor, so a grad can never stay bound
as a view once ``clear_grad()`` drops it. :meth:`FlatGroup.gather_grads`
therefore copies this step's grad of every member into the flat grad
buffer with ONE ``torch.cat`` per bucket, as the JAX package gathers
them with one concat (a bf16 grad of an fp32 member widens exactly).
The buffers are padded to a multiple of ``ALIGN`` elements, whose
padding stays zero.
"""
from __future__ import annotations

import torch

__all__ = ["ALIGN", "FlatGroup", "FlatMismatch", "grad_fits"]

ALIGN = 1024


def grad_fits(g, dtype):
    """A grad of ``g``'s dtype goes into a ``dtype`` bucket unrounded:
    the same dtype, or a narrower float widened into an fp32 bucket."""
    return g.dtype == dtype or (dtype == torch.float32
                                and g.is_floating_point()
                                and g.element_size() < 4)


class FlatMismatch(RuntimeError):
    """A member no longer matches its bucket slot (re-bound or re-cast
    after the bucket was built, or without a grad this step). The
    optimizer answers by dissolving the buckets (per-param path)."""


class FlatGroup:
    """One bucket: its members' geometry and the flat buffers."""

    def __init__(self, params, use_master):
        self.params = list(params)
        self.shapes = [tuple(p.shape) for p in self.params]
        self.sizes = [p.numel() for p in self.params]
        self.offsets = []
        off = 0
        for n in self.sizes:
            self.offsets.append(off)
            off += n
        self.total = off
        self.padded = -(-off // ALIGN) * ALIGN
        self.dtype = self.params[0].dtype
        self.device = self.params[0].device
        self.use_master = use_master
        self.param_flat = None
        self.master_flat = None
        self.moments: dict[str, torch.Tensor] = {}
        self.b1p = None       # per-bucket beta powers (0-d fp32)
        self.b2p = None
        self.grad_flat = None
        self._pad = None      # the zero tail of the grad gather

    def flatten(self, values, dtype=None):
        """Member values (in member order) -> one padded flat tensor."""
        dt = dtype or values[0].dtype
        pieces = []
        for i, v in enumerate(values):
            if tuple(v.shape) != self.shapes[i]:
                raise FlatMismatch(f"member {i} shape {tuple(v.shape)} != "
                                   f"bucket slot {self.shapes[i]}")
            pieces.append(v.detach().reshape(-1).to(dt))
        pad = self.padded - self.total
        if pad:
            pieces.append(torch.zeros(pad, dtype=dt, device=self.device))
        return torch.cat(pieces)

    def view(self, flat, i):
        o, n = self.offsets[i], self.sizes[i]
        return flat[o:o + n].view(self.shapes[i])

    def bind_params(self):
        """Copy the members into the flat param buffer and re-bind each
        parameter as a view of its slot."""
        self.param_flat = self.flatten(self.params)
        with torch.no_grad():
            for i, p in enumerate(self.params):
                p.data = self.view(self.param_flat, i)

    def owns(self, p, i):
        """``p`` is still the view of slot ``i`` of the param buffer."""
        flat = self.param_flat
        return (p.dtype == flat.dtype and p.device == flat.device
                and tuple(p.shape) == self.shapes[i]
                and p.data_ptr() == flat.data_ptr()
                + self.offsets[i] * flat.element_size())

    def gather_grads(self, gmap):
        """This step's member grads -> the flat grad buffer, with one
        ``torch.cat`` (into a buffer kept across steps)."""
        gs = [gmap[p] for p in self.params]
        for i, g in enumerate(gs):
            if not grad_fits(g, self.dtype) or \
                    tuple(g.shape) != self.shapes[i]:
                raise FlatMismatch(
                    f"member {i} grad {g.dtype} {tuple(g.shape)} does not "
                    f"match its slot {self.dtype} {self.shapes[i]}")
        pieces = [g.reshape(-1).to(self.dtype) for g in gs]
        pad = self.padded - self.total
        if pad:
            if self._pad is None:
                self._pad = torch.zeros(pad, dtype=self.dtype,
                                        device=self.device)
            pieces.append(self._pad)
        if self.grad_flat is None:
            self.grad_flat = torch.empty(self.padded, dtype=self.dtype,
                                         device=self.device)
        torch.cat(pieces, out=self.grad_flat)
        return self.grad_flat
