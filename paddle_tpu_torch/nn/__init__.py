"""``nn`` of the port: the GPT and LLaMA paths' functionals, ``RMSNorm``
and gradient clip."""
from . import functional
from .clip import ClipGradBase, ClipGradByGlobalNorm
from .layers import RMSNorm

__all__ = ["functional", "ClipGradBase", "ClipGradByGlobalNorm", "RMSNorm"]
