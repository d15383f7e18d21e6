"""``distributed.fleet`` of the port: activation recompute."""
from .recompute import recompute

__all__ = ["recompute"]
