"""Functionals of the port's GPT path (``paddle_tpu/nn/functional``),
each cast by the AMP rule of ``amp``."""
from .activation import gelu
from .attention import (flash_attention, flash_attn_qkvpacked,
                        scaled_dot_product_attention)
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["gelu", "flash_attention", "flash_attn_qkvpacked",
           "scaled_dot_product_attention", "dropout", "embedding", "linear",
           "cross_entropy", "layer_norm"]
