"""Flags the port reads (names, defaults and spellings as in
``paddle_tpu/core/state.py``; env override ``PDTPU_<NAME>``)."""
from __future__ import annotations

import os

_FLAGS: dict[str, object] = {}


def define_flag(name: str, default):
    ftype = type(default)
    env = os.environ.get("PDTPU_" + name.upper())
    val = default
    if env is not None:
        if ftype is bool:
            val = env.lower() in ("1", "true", "yes")
        else:
            val = ftype(env)
    _FLAGS[name] = val
    return val


def get_flag(name: str):
    return _FLAGS[name]


def set_flags(flags: dict):
    """Set defined flags, converted to their default's type."""
    for k, v in flags.items():
        if k not in _FLAGS:
            raise KeyError(f"unknown flag {k!r}")
        _FLAGS[k] = type(_FLAGS[k])(v)


# bounded admission queue; 0 = unbounded
define_flag("serving_max_queue", 0)
# what a full queue does to add_request: 'reject' raises QueueFullError
# (PDT-E017), 'block' steps the engine until room frees
define_flag("serving_queue_policy", "reject")
# default per-request deadline checked at step boundaries; 0 = none
define_flag("serving_deadline_ms", 0.0)
# bounded RE-attempts after a transient dispatch failure (0 = no retry)
define_flag("serving_dispatch_retries", 3)
# cross-request KV prefix cache (inference/prefix_cache.py)
define_flag("serving_prefix_cache", True)
# string spellings that disable the prefix cache
PREFIX_CACHE_OFF_SPELLINGS = ("off", "false", "0", "no")
# strict on/off spellings of the engine's kv_quant/megakernel kwargs
KV_QUANT_OFF_SPELLINGS = PREFIX_CACHE_OFF_SPELLINGS
KV_QUANT_ON_SPELLINGS = ("on", "true", "1", "yes")
# fused decode path of the serving engine (ops/cuda/fused_decode_qkv.py
# + fused_decode_mlp.py): each decode layer runs as three dispatches
# (norm + QKV + paged-KV append, attention, out-proj + residual + MLP +
# residual) plus one sampling epilogue (final norm + LM head + guarded
# argmax). The engine kwarg megakernel overrides it per instance
define_flag("serving_megakernel", False)
# spellings of the megakernel kwarg: the kv_quant sets (strict parse)
MEGAKERNEL_OFF_SPELLINGS = KV_QUANT_OFF_SPELLINGS
MEGAKERNEL_ON_SPELLINGS = KV_QUANT_ON_SPELLINGS
# flat-buffer multi-tensor optimizer path (optimizer/flat.py +
# ops/cuda/fused_optimizer.py): dtype-bucketed flat params/moments
# updated by one fused kernel per bucket. PDTPU_FUSED_OPT=off disables
# it (per-param path)
define_flag("fused_opt", True)
# fused residual-add + norm training glue kernels (the JAX package's
# ops/pallas/fused_residual_norm.py); off by default. LLaMA's training
# forward then runs the RMS pair (ops/cuda/fused_residual_norm.py,
# kernels #11-#12); GPT's needs the LayerNorm pair (kernels #9-#10,
# not ported yet), so a GPT training forward with it on raises
define_flag("train_glue_fusion", False)
