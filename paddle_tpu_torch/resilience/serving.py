"""Serving-side resilience: the decode guard, the bounded dispatch retry
and the serving fault-site names (as in ``paddle_tpu/resilience/
serving.py``, so the JAX drills replay on the port).

One request whose logits go non-finite must fail alone, never the
engine or its co-resident requests. The host half lives here; the
device half (:func:`paddle_tpu_torch.models.generation.guarded_argmax`)
runs inside the engine's mixed step and decode window as a per-slot
flag, so detection costs no extra host sync.
"""
from __future__ import annotations

import random
import time

import numpy as np

from ..core.errors import NonFiniteLogitsError
from . import faults

__all__ = [
    "FINISH_REASONS", "DecodeGuard", "dispatch_retry",
    "SITE_DISPATCH", "SITE_NAN_DECODE", "SITE_PAGE_PRESSURE",
    "SITE_CACHE_EVICT",
]

#: Every value ``CompletedRequest.finish_reason`` can take.
FINISH_REASONS = ("stop", "length", "timeout", "cancelled", "failed")

SITE_DISPATCH = "engine_dispatch"
SITE_NAN_DECODE = "engine_nan_decode"
SITE_PAGE_PRESSURE = "engine_page_pressure"
SITE_CACHE_EVICT = "engine_cache_evict"


class DecodeGuard:
    """Host half of the serving decode guard: builds the per-slot poison
    vector each dispatch (NaN where the ``engine_nan_decode`` drill
    fires, else 0.0 — adding 0.0 to finite logits is argmax-invariant)
    and turns a device-reported bad flag into the coded error."""

    def __init__(self, max_slots: int):
        self.max_slots = int(max_slots)

    def poison(self, slot_rids, sites=(SITE_NAN_DECODE,)) -> np.ndarray:
        """[max_slots] float32: NaN for slots whose request id fires one
        of ``sites`` this dispatch, 0.0 elsewhere. ``slot_rids`` maps
        slot index -> request id (None = idle)."""
        vec = np.zeros(self.max_slots, np.float32)
        for b, rid in enumerate(slot_rids):
            if rid is None:
                continue
            for site in sites:
                if faults.check(site, key=str(rid)):
                    vec[b] = np.nan
                    break
        return vec

    @staticmethod
    def failure(rid, position) -> NonFiniteLogitsError:
        """The coded error recorded on a guard-failed request."""
        return NonFiniteLogitsError(
            f"request {rid!r}: non-finite logits at position "
            f"{position} — decode guard failed this request only "
            f"[{NonFiniteLogitsError.error_code}]")


# jitter of the retry backoff; seeded so a drill replays identically
_rng = random.Random(0x7E57AB1E)


def dispatch_retry(kind: str, fn, *, max_attempts=3, on_retry=None):
    """Run one engine dispatch under bounded retry. The
    ``engine_dispatch`` fault check sits INSIDE the retried closure, so
    a ``*N``-spec drill is absorbed by ``N`` retries exactly like a real
    transient ``ConnectionError``. Delays stay tiny (5 ms doubling to a
    50 ms cap, +25% jitter): a serving step retried at human backoff
    would blow the latency budget before the second attempt."""
    attempts = max(1, int(max_attempts))
    attempt = 0
    while True:
        try:
            faults.maybe_raise(SITE_DISPATCH, kind)
            return fn()
        except ConnectionError as e:
            attempt += 1
            if attempt >= attempts:
                raise
            if on_retry is not None:
                on_retry(e, attempt)
            delay = min(0.05, 0.005 * 2.0 ** (attempt - 1))
            time.sleep(delay * (1.0 + 0.25 * _rng.random()))
