"""Activation recompute (the port of ``paddle_tpu/distributed/fleet/
recompute.py``) on ``torch.utils.checkpoint`` (non-reentrant).

Policies, by the JAX package's names:

* ``None`` / ``"full"``: recompute everything in backward;
* ``"dots_saveable"``: keep the outputs of matrix products (``aten.mm``,
  ``addmm``, ``bmm``, ``linear``) and recompute the rest;
* ``"dots_and_kernels_saveable"``: also keep the outputs of the forward
  kernels (``paddle_tpu_torch::flash_attention_fwd``, ``::rope`` and
  ``::fused_residual_rms_norm_fwd``), so they are not run again in
  backward: the JAX policy keeps the outputs of every ``pallas_call``
  and ``custom_vjp_call``.

The last two ride selective activation checkpointing, which sees only
ops that pass through the dispatcher: that is why those kernels are
``torch.library`` custom ops. The function runs again in backward on
autograd's thread, outside the caller's ``auto_cast`` block, so the AMP
state of the forward is captured here and restored for the recompute.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...amp import amp_state, restored
from ...ops.cuda.flash_attention import FLASH_FWD_OP
from ...ops.cuda.fused_residual_norm import FUSED_RMS_FWD_OP
from ...ops.cuda.rope import ROPE_OP

__all__ = ["recompute"]

_aten = torch.ops.aten
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                   _aten.linear.default})
_DOTS_AND_KERNELS = _DOTS | {FLASH_FWD_OP, ROPE_OP, FUSED_RMS_FWD_OP}
_SAVEABLE = {"dots_saveable": _DOTS,
             "dots_and_kernels_saveable": _DOTS_AND_KERNELS}
# the JAX package's other policy names, not ported yet
_LATER = ("everything_saveable", "dots_with_no_batch_dims_saveable",
          "transformer_saveable")


def _policy_fn(saved, ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _context_fn(policy):
    if policy in (None, "full"):
        return None
    if policy in _SAVEABLE:
        return functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_policy_fn, _SAVEABLE[policy]))
    if policy in _LATER:
        raise NotImplementedError(
            f"recompute policy {policy!r} is not ported yet; the port has "
            f"'full', 'dots_saveable' and 'dots_and_kernels_saveable'")
    raise ValueError(f"unknown recompute policy {policy!r}")


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              policy=None, **kwargs):
    """Run ``function(*args, **kwargs)`` with its activations recomputed
    in backward under ``policy`` (see the module docstring).
    ``use_reentrant`` is accepted for API parity: the port always uses
    the non-reentrant checkpoint, which selective policies need."""
    ctx = _context_fn(policy)
    snap = amp_state().snapshot()

    def run(*a, **kw):
        with restored(snap):
            return function(*a, **kw)

    extra = {} if ctx is None else {"context_fn": ctx}
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **extra,
                      **kwargs)
