"""Serving: the continuous-batching engine and its prefix cache."""
from .engine import CompletedRequest, ContinuousBatchingEngine
from .prefix_cache import PrefixCache

__all__ = ["ContinuousBatchingEngine", "CompletedRequest", "PrefixCache"]
