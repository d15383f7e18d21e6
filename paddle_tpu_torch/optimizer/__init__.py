"""Optimizers of the port (``paddle_tpu/optimizer``): SGD, Momentum,
Adam and AdamW over the fused flat-bucket path."""
from .optimizer import (SGD, Adam, AdamW, L1Decay, L2Decay, Momentum,
                        Optimizer)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "L1Decay",
           "L2Decay"]
