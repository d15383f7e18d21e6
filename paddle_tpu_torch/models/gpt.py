"""GPT-family decoder-only language model (``paddle_tpu/models/gpt.py``).

Same configuration fields and defaults, same module tree
(``gpt.{wte, wpe, blocks[i].{ln1, attn.{qkv, proj}, ln2, mlp.{fc1, fc2}},
ln_f}``, ``lm_head=None`` under tied embeddings) and the same init
(normal, std 0.02; residual projections 0.02 / sqrt(2 L)). Weights are
torch-layout (``Linear.weight`` is ``[out, in]``); ``models/weights.py``
loads the JAX package's ``[in, out]`` arrays.

This slice serves: ``models/generation.py`` drives the blocks token by
token over paged KV. The full-sequence ``forward`` rides the
flash-attention kernel and arrives with the training slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: int = 0  # 0 -> 4*hidden
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = True
    use_flash_attention: bool = True
    recompute: bool = False
    recompute_policy: str = "full"
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


_TRAINING_SLICE = ("the full-sequence forward rides the flash-attention "
                   "kernel (paddle_tpu/ops/pallas/flash_attention.py) and "
                   "arrives with the port's training slice; this slice "
                   "serves through models.generation and "
                   "inference.ContinuousBatchingEngine")


class GPTAttention(nn.Module):
    """Fused qkv projection (columns ordered ``[3, heads, head_dim]``)
    and output projection."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.head_dim
        self.qkv = nn.Linear(h, 3 * h)
        self.proj = nn.Linear(h, h)


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = GPTMLP(cfg)


class GPTModel(nn.Module):
    """Embeddings + transformer stack + final norm."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size)
        self.blocks = nn.ModuleList(GPTBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class GPTForCausalLM(nn.Module):
    """LM head on top (tied to ``wte`` unless ``tie_embeddings=False``).

    ``device=None`` puts the model on ``cuda`` (which must exist);
    ``generator`` seeds the init (a CPU ``torch.Generator``; the weights
    are drawn on the CPU and then moved)."""

    def __init__(self, cfg: GPTConfig, device=None, generator=None):
        super().__init__()
        if cfg.num_experts:
            raise NotImplementedError(
                "GPT MoE (num_experts > 0) is not ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False))
        self._init_weights(generator)
        self.to(dev)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, generator):
        resid_std = 0.02 / math.sqrt(2 * self.cfg.num_layers)
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                std = (resid_std if name.endswith(("attn.proj", "mlp.fc2"))
                       else 0.02)
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def forward(self, input_ids, labels=None):
        raise NotImplementedError(_TRAINING_SLICE)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
