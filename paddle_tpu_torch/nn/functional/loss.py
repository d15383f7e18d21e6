"""``cross_entropy`` for hard labels (the port of
``paddle_tpu/nn/functional/loss.py``'s), black-listed by the AMP rule:
the logits are cast to fp32. ``ignore_index`` rows add nothing, and the
``mean`` divides by the number of the other rows (at least 1), as the
JAX package does. Soft labels, class weights and label smoothing wait
for a later slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import amp_cast_inputs

__all__ = ["cross_entropy"]

_LATER = ("arrives with a later slice of the port (the GPT path uses hard "
          "labels)")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    ax = axis if axis >= 0 else input.dim() + axis
    # soft exactly where the JAX package calls a label soft: a float
    # label of the logits' rank with n_class entries on the class axis
    # (a float [N, 1] label is a hard one)
    if soft_label or (label.dim() == input.dim()
                      and label.shape[ax] == input.shape[ax]
                      and label.is_floating_point()):
        raise NotImplementedError(f"cross_entropy: soft labels {_LATER}")
    if weight is not None:
        raise NotImplementedError(f"cross_entropy: class weights {_LATER}")
    if label_smoothing:
        raise NotImplementedError(f"cross_entropy: label smoothing {_LATER}")
    if not use_softmax:
        raise NotImplementedError(f"cross_entropy: use_softmax=False {_LATER}")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: reduction must be mean, sum or "
                         f"none, got {reduction!r}")
    (logits,) = amp_cast_inputs("cross_entropy", (input,))
    if ax != logits.dim() - 1:
        logits = logits.movedim(ax, -1)
    idx = label
    if idx.dim() == input.dim():
        idx = idx.squeeze(ax)
    idx = idx.long()
    n_class = logits.shape[-1]
    loss = F.cross_entropy(logits.reshape(-1, n_class), idx.reshape(-1),
                           ignore_index=ignore_index, reduction="none")
    loss = loss.reshape(idx.shape)
    if reduction == "mean":
        n_valid = (idx != ignore_index).sum().to(loss.dtype)
        return loss.sum() / torch.clamp(n_valid, min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
