"""Deterministic fault injection — ``PDTPU_FAULTS`` or programmatic.

The port's copy of ``paddle_tpu/resilience/faults.py``: the same spec
grammar and site names, so the JAX package's serving drills replay on
the port. Sites the serving slice consults:

* ``engine_dispatch``      — a serving engine dispatch raises
  ``InjectedConnectionError`` before touching the device; absorbed by
  the bounded retry every dispatch runs under. Key = dispatch kind
  (``mixed``/``decode``/``window``/``cow``).
* ``engine_nan_decode``    — ONE serving slot's logits are poisoned with
  NaN for one dispatch, drilling the decode guard. Key = request id.
* ``engine_page_pressure`` — the page allocator treats the free list as
  empty for one growth attempt, forcing preempt-and-requeue. Key = the
  request id of the slot being grown.
* ``engine_cache_evict``   — the prefix cache evicts its LRU cached page
  on one allocation even while free pages remain. Key = request id.

Spec grammar (``;``-separated rules)::

    PDTPU_FAULTS="site[:match][*times][@at][;...]"

    site   injection point (above)
    match  fnmatch glob the site key must match (default ``*``)
    times  how many matching occurrences fire (default 1; 0 = every)
    at     1-based matching-occurrence index of the first firing

Counting is per-rule and purely occurrence-based, so a given spec
replays identically on every run.
"""
from __future__ import annotations

import fnmatch
import os
import threading

__all__ = [
    "InjectedConnectionError", "Rule", "inject", "check", "maybe_raise",
    "clear", "reset", "parse",
]


class InjectedConnectionError(ConnectionError):
    """A simulated transient network failure — a real ``ConnectionError``
    (so retry treats it exactly like one) that tests can match on."""


class Rule:
    """One injection rule: fire ``times`` times starting at the
    ``at``-th occurrence whose key matches ``match``."""

    def __init__(self, site, match="*", times=1, at=1):
        self.site = str(site)
        self.match = match or "*"
        self.times = int(times)
        self.at = max(1, int(at))
        self.seen = 0   # matching occurrences observed
        self.fired = 0  # occurrences that fired

    def __repr__(self):
        return (f"Rule({self.site}:{self.match}*{self.times}"
                f"@{self.at} seen={self.seen} fired={self.fired})")


_lock = threading.Lock()
_rules: list[Rule] = []
_env_loaded = False


def parse(spec: str) -> list[Rule]:
    """Parse a ``PDTPU_FAULTS`` spec string into rules."""
    rules = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        at = 1
        if "@" in part:
            part, at_s = part.rsplit("@", 1)
            at = int(at_s)
        times = 1
        # trailing *N is a count; a bare * inside match stays a glob
        head, star, tail = part.rpartition("*")
        if star and tail.isdigit():
            part, times = head, int(tail)
        site, sep, match = part.partition(":")
        rules.append(Rule(site.strip(), match.strip() if sep else "*",
                          times, at))
    return rules


def _load_env(force=False):
    global _env_loaded
    if _env_loaded and not force:
        return
    _env_loaded = True
    spec = os.environ.get("PDTPU_FAULTS", "")
    if spec:
        _rules.extend(parse(spec))


def inject(site, match="*", times=1, at=1) -> Rule:
    """Programmatically arm a rule; returns it (inspect ``.fired``)."""
    rule = Rule(site, match, times, at)
    with _lock:
        _rules.append(rule)
    return rule


def clear():
    """Drop every rule (env rules included; they do NOT re-arm until
    ``reset``)."""
    global _env_loaded
    with _lock:
        _rules.clear()
        _env_loaded = True


def reset():
    """Drop every rule and re-parse ``PDTPU_FAULTS`` from scratch."""
    global _env_loaded
    with _lock:
        _rules.clear()
        _env_loaded = False
        _load_env()


def check(site: str, key: str = "") -> bool:
    """True when an armed rule matches this occurrence (consumes one
    firing). Sites call this at their injection point and act
    themselves — the harness only decides."""
    with _lock:
        _load_env()
        for rule in _rules:
            if rule.site != site:
                continue
            if not fnmatch.fnmatch(str(key), rule.match):
                continue
            rule.seen += 1
            if rule.seen >= rule.at and (rule.times == 0
                                         or rule.fired < rule.times):
                rule.fired += 1
                return True
    return False


def maybe_raise(site: str, key: str, exc_type=InjectedConnectionError):
    """Raise ``exc_type`` when a rule fires — the one-liner for
    transient-failure sites."""
    if check(site, key):
        raise exc_type(f"injected {site} fault (key={key!r})")
