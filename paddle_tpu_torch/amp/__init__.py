"""paddle_tpu_torch.amp — automatic mixed precision.

The port of ``paddle_tpu/amp`` (``auto_cast``, ``decorate`` and the
per-op lists). The JAX package casts inside its op-dispatch funnel; the
port has no funnel, so the cast rule (:func:`amp_cast_inputs`) is
applied at its functional boundaries on the GPT and LLaMA paths:
``linear``, ``matmul``, ``embedding``, ``add``, ``gelu``, ``layer_norm``,
``rms_norm``, ``fused_residual_norm``, ``scaled_dot_product_attention``,
``cross_entropy`` (``nn/functional``), ``swiglu`` and
``fused_rotary_position_embedding`` (``incubate/nn/functional``, whose
given sin/cos tables are cast too, as the JAX funnel casts every float
input). Under O2 every op except a black-listed one runs in the low
dtype; black-listed ops (``layer_norm``, ``rms_norm``,
``cross_entropy``, ``softmax``, ...) run in fp32. Under O1 only
white-listed ops are cast down.

The state is per thread. Backward runs on autograd's threads, outside
the ``auto_cast`` block, so ``distributed.fleet.recompute`` captures the
state when the forward runs and restores it (:func:`restored`) while the
block is recomputed.

``GradScaler`` (fp16 loss scaling) is not ported: bf16 needs none.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

from ..core.dtype import to_torch_dtype

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_state",
           "amp_cast_inputs", "decorate", "restored"]

# Ops that are numerically safe and bound by matrix products: low dtype.
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "bmm", "mm", "einsum", "addmm",
    "scaled_dot_product_attention", "flash_attn_unpadded", "mv",
}
# Numerically risky reductions and normalizations: pinned to float32.
BLACK_LIST = {
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "bce_with_logits", "binary_cross_entropy", "kl_div",
    "layer_norm", "rms_norm", "batch_norm", "instance_norm", "group_norm",
    "mean", "sum", "exp", "log", "pow", "cumsum", "logsumexp", "norm",
    "softmax_with_cross_entropy", "ctc_loss", "sigmoid_focal_loss",
}


class _AmpState:
    __slots__ = ("enabled", "dtype", "level", "custom_white", "custom_black")

    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = frozenset()
        self.custom_black = frozenset()

    def snapshot(self):
        return (self.enabled, self.dtype, self.level, self.custom_white,
                self.custom_black)

    def restore(self, snap):
        (self.enabled, self.dtype, self.level, self.custom_white,
         self.custom_black) = snap


_local = threading.local()


def amp_state() -> _AmpState:
    """This thread's AMP state."""
    st = getattr(_local, "state", None)
    if st is None:
        st = _local.state = _AmpState()
    return st


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Under O2 every op (except the black list) runs in the low dtype;
    under O1 only the white list does."""
    st = amp_state()
    old = st.snapshot()
    st.enabled = bool(enable)
    st.dtype = to_torch_dtype(dtype)
    st.level = level
    st.custom_white = frozenset(custom_white_list or ())
    st.custom_black = frozenset(custom_black_list or ())
    try:
        yield
    finally:
        st.restore(old)


@contextlib.contextmanager
def restored(snap):
    """Run under an AMP state captured with ``amp_state().snapshot()``
    (for recomputation in backward, on autograd's thread)."""
    st = amp_state()
    old = st.snapshot()
    st.restore(snap)
    try:
        yield
    finally:
        st.restore(old)


def amp_cast_inputs(name, vals):
    """``vals`` cast per the active AMP lists for op ``name`` (a list;
    non-float values and ``None`` pass through)."""
    st = amp_state()
    if not st.enabled:
        return list(vals)
    white = name in WHITE_LIST or name in st.custom_white
    black = (name in BLACK_LIST or name in st.custom_black) and \
        name not in st.custom_white
    if st.level == "O2":
        target = torch.float32 if black else st.dtype
    elif black:
        target = torch.float32
    elif white:
        target = st.dtype
    else:
        return list(vals)
    return [v.to(target) if torch.is_tensor(v) and v.is_floating_point()
            and v.dtype != target else v for v in vals]


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2 casts every float parameter to the low dtype except those of
    norm layers (and of ``excluded_layers``, types or instances); the
    optimizers get fp32 master weights unless ``master_weight=False``.
    Parameters keep their identity (``p.data`` is replaced), so an
    optimizer built before the call still holds them."""
    single_model = isinstance(models, nn.Module)
    model_list = [models] if single_model else list(models)
    if level == "O2":
        low = to_torch_dtype(dtype)
        excl = excluded_layers or []
        excl = excl if isinstance(excl, (list, tuple)) else [excl]
        excl_types = tuple(e for e in excl if isinstance(e, type))
        excl_ids = {id(e) for e in excl if not isinstance(e, type)}
        keep = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm)
        for m in model_list:
            for mod in m.modules():
                if isinstance(mod, keep) or id(mod) in excl_ids or \
                        (excl_types and isinstance(mod, excl_types)):
                    continue
                for p in mod.parameters(recurse=False):
                    if p.is_floating_point():
                        p.data = p.data.to(low)
    if optimizers is None:
        return models if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    if master_weight is not False:
        for o in opt_list:
            o._multi_precision = True
    if single_model and single_opt:
        return models, optimizers
    return model_list, opt_list
