"""``paddle.incubate.nn`` of the port (its functionals)."""
from . import functional

__all__ = ["functional"]
