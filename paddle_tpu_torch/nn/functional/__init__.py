"""Functionals of the port's GPT and LLaMA paths
(``paddle_tpu/nn/functional``), each cast by the AMP rule of ``amp``."""
from .activation import gelu
from .attention import (flash_attention, flash_attn_qkvpacked,
                        scaled_dot_product_attention)
from .common import dropout, embedding, linear, linear_layer
from .loss import cross_entropy
from .norm import fused_residual_norm, layer_norm, rms_norm

__all__ = ["gelu", "flash_attention", "flash_attn_qkvpacked",
           "scaled_dot_product_attention", "dropout", "embedding", "linear",
           "linear_layer",
           "cross_entropy", "fused_residual_norm", "layer_norm", "rms_norm"]
