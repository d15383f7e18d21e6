"""``nn`` of the port: the GPT path's functionals and gradient clip."""
from . import functional
from .clip import ClipGradBase, ClipGradByGlobalNorm

__all__ = ["functional", "ClipGradBase", "ClipGradByGlobalNorm"]
