"""PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100).

The JAX package (``paddle_tpu``) stays the reference; this package keeps
its module paths and names so each counterpart is easy to find
(``models/gpt.py``, ``models/generation.py``, ``inference/engine.py``,
``ops/cuda/paged_attention.py`` beside ``ops/pallas/paged_attention.py``).

What is ported so far, each kernel hand-written CUDA for ``sm_90a``:
the serving path — ``inference.ContinuousBatchingEngine`` over
``models.GPTForCausalLM`` — with ragged paged attention
(``ops/cuda/csrc/paged_attention.cu``); and the GPT training step —
forward, loss, backward and ``optimizer.AdamW`` under ``amp`` O2 with
fp32 master weights and ``distributed.fleet.recompute`` — with flash
attention forward and backward (``ops/cuda/csrc/flash_attention.cu``)
and the fused optimizer update (``ops/cuda/csrc/fused_optimizer.cu``);
the GPT decode megakernel (``ops/cuda/csrc/fused_decode_{qkv,mlp}.cu``);
the LLaMA training step (``models.LlamaForCausalLM``) with the rope
kernel (``ops/cuda/csrc/rope.cu``) and, under ``train_glue_fusion``,
the fused residual + RMSNorm forward and backward
(``ops/cuda/csrc/fused_residual_norm.cu``); and LLaMA serving with
weight-only int8 projections (``quantization.weight_only_quantize``,
the weight-only matmul ``ops/cuda/csrc/quant_matmul.cu``) and int8 KV
pages (the engine's ``kv_quant``, the int8 variant of the paged
attention); and the norm family, one row template
(``ops/cuda/csrc/row_norm.cuh``): GPT's glue fusion through the fused
residual + LayerNorm pair, and the norm kernels
(``ops/cuda/csrc/norms.cu``) behind ``PDTPU_NORM_BACKEND=pallas`` and
the incubate fused norms; and tensor-parallel serving over
``torch.distributed`` (the engine's ``mesh=``; each rank holds its
slices of the weights), whose decode MLP under the megakernel is the
shard-local kernel of ``ops/cuda/csrc/fused_decode_mlp.cu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without ``device=`` they raise (:func:`resolve_device`).
On CPU tensors every kernel wrapper runs its plain PyTorch version; on
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, which
    must exist; any explicit ``device`` (``"cpu"``, ``"cuda:1"``, a
    ``torch.device``) is taken as given, a CUDA one checked for a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA card by default and none "
                "is available (torch.cuda.is_available() is False); pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        if dev.index is None:    # "cuda" means the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
