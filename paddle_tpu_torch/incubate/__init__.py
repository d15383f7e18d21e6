"""``paddle.incubate`` of the port: the fused functionals of the LLaMA
training path (``incubate.nn.functional``)."""
from . import nn

__all__ = ["nn"]
