"""Flags the serving slice reads (names, defaults and spellings as in
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
