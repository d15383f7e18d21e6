"""LLaMA-family decoder model (``paddle_tpu/models/llama.py``).

Same configuration fields, defaults and sizing rule (``LlamaConfig``),
the same module tree (``llama.{embed_tokens, layers[i].{input_norm,
attn.{q,k,v,o}_proj, post_norm, mlp.{gate,up,down}_proj}, norm},
lm_head``; the JAX package names a layer ``layer_{i}``) and the same
init (normal, std 0.02; ``o_proj`` and ``down_proj`` 0.02 / sqrt(2 L);
norms at one). Weights are torch-layout (``Linear.weight`` is ``[out,
in]``); ``models/weights.py`` loads the JAX package's arrays.

Training: ``LlamaForCausalLM(ids, labels)`` runs grouped-query attention
through the rope kernel (``incubate.nn.functional.
fused_rotary_position_embedding``, half pairing) and the flash-attention
kernel, a SwiGLU MLP and RMSNorm (plain, fp32 under AMP), with block
recompute under ``cfg.recompute_policy``. With the
``train_glue_fusion`` flag on, a training forward threads each layer's
un-added MLP branch into the next layer's ``input_norm`` and each
attention branch into ``post_norm`` as one fused residual + RMSNorm
kernel each (kernels #11-#12), the last branch into the final norm.
The model starts in training mode, as the JAX ``Layer`` does.

Serving: ``models/generation.py`` drives the layers over paged KV (rope
at device positions through ``generation.rope_at``); every projection is
called as a module, so a ``quantization.weight_only_quantize``'d model
serves through the weight-only matmul kernel unchanged.

Not ported yet: the LLaMA branches of the decode megakernel and
``shard_llama`` (the distributed slice).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import ops, resolve_device
from ..core import state
from ..distributed.fleet.recompute import recompute
from ..incubate.nn.functional import fused_rotary_position_embedding, swiglu
from ..nn import functional as F
from ..nn.layers import RMSNorm

__all__ = ["LlamaConfig", "LlamaForCausalLM", "rope_angles"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 0          # 0 -> num_heads (MHA); < heads = GQA
    max_seq_len: int = 2048
    intermediate_size: int = 0     # 0 -> the LLaMA 8/3 * hidden rule
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    use_flash_attention: bool = True
    recompute: bool = False
    recompute_policy: str = "full"

    def __post_init__(self):
        if self.num_kv_heads == 0:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size == 0:
            # LLaMA sizing: 2/3 * 4h rounded up to a multiple of 256
            raw = int(8 * self.hidden_size / 3)
            self.intermediate_size = 256 * ((raw + 255) // 256)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def rope_angles(positions, d, theta):
    """Half-rotation rope tables ``(cos, sin)`` ``[..., d]`` fp32 (CPU
    tensors) for concrete ``positions`` (a sequence, numpy array or CPU
    tensor of integers). Computed in float64 and then cast, as the JAX
    package computes concrete positions (fp32 angles lose ~1e-4 rad at
    position 2048)."""
    inv = 1.0 / theta ** (np.arange(0, d // 2) * 2.0 / d)
    ang = np.asarray(positions, np.float64)[..., None] * inv
    ang = np.concatenate([ang, ang], axis=-1)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)),
            torch.from_numpy(np.sin(ang).astype(np.float32)))


class LlamaAttention(nn.Module):
    """Rope + grouped-query flash attention: the kv projections emit
    ``num_kv_heads`` heads and the kernel maps each q head to its kv
    head. ``use_flash_attention`` is not read, as in the JAX package."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        h, d = cfg.hidden_size, cfg.head_dim
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        self.head_dim = d
        self.rope_theta = cfg.rope_theta
        self.q_proj = nn.Linear(h, cfg.num_heads * d, bias=False)
        self.k_proj = nn.Linear(h, cfg.num_kv_heads * d, bias=False)
        self.v_proj = nn.Linear(h, cfg.num_kv_heads * d, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * d, h, bias=False)
        self._tables = {}

    def _rope_tables(self, s, device):
        """cos/sin ``[s, head_dim]`` for this config's rope_theta on
        ``device``, made once per (length, device)."""
        key = (s, device)
        if key not in self._tables:
            cos, sin = rope_angles(np.arange(s), self.head_dim,
                                   self.rope_theta)
            self._tables[key] = (cos.to(device), sin.to(device))
        return self._tables[key]

    def forward(self, x):
        b, s, _ = x.shape
        q = F.linear_layer(self.q_proj, x).reshape(b, s, self.num_heads,
                                                   self.head_dim)
        k = F.linear_layer(self.k_proj, x).reshape(
            b, s, self.num_kv_heads, self.head_dim)
        v = F.linear_layer(self.v_proj, x).reshape(
            b, s, self.num_kv_heads, self.head_dim)
        # half-rotation convention (LLaMA/HF); explicit tables carry this
        # config's rope_theta (the computed tables use base 10000)
        cos, sin = self._rope_tables(s, x.device)
        q, k, _ = fused_rotary_position_embedding(
            q, k, sin=sin, cos=cos, use_neox_rotary_style=False)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return F.linear_layer(self.o_proj, out.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    """SwiGLU FFN (gate/up/down)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                   bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                 bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   bias=False)

    def forward(self, x):
        return F.linear_layer(self.down_proj,
                              swiglu(F.linear_layer(self.gate_proj, x),
                                     F.linear_layer(self.up_proj, x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps)
        self.attn = LlamaAttention(cfg)
        self.post_norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)
        self._recompute = cfg.recompute
        self._policy = (cfg.recompute_policy
                        if cfg.recompute_policy != "full" else None)

    def _inner(self, x):
        x = ops.add(x, self.attn(self.input_norm(x)))
        return ops.add(x, self.mlp(self.post_norm(x)))

    def forward(self, x):
        if self._recompute and self.training:
            return recompute(self._inner, x, policy=self._policy)
        return self._inner(x)

    def _inner_fused(self, x, pending=None):
        """Glue-fused twin of ``_inner``: the previous layer's un-added
        MLP branch (``pending``) fuses with this layer's input_norm, the
        attention branch with post_norm; each (add, norm) pair is one
        fused residual + RMSNorm kernel. Returns ``(x, mlp branch)``."""
        if pending is None:
            h1 = self.input_norm(x)
        else:
            x, h1 = F.fused_residual_norm(
                x, pending, self.input_norm.weight, norm="rms",
                epsilon=self.input_norm._epsilon)
        a = self.attn(h1)
        x, h2 = F.fused_residual_norm(
            x, a, self.post_norm.weight, norm="rms",
            epsilon=self.post_norm._epsilon)
        return x, self.mlp(h2)

    def forward_fused(self, x, pending=None):
        if self._recompute and self.training:
            if pending is None:
                return recompute(self._inner_fused, x, policy=self._policy)
            return recompute(self._inner_fused, x, pending,
                             policy=self._policy)
        return self._inner_fused(x, pending)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps)

    def forward(self, input_ids):
        x = F.embedding(input_ids, self.embed_tokens.weight)
        if self.training and len(self.layers) and \
                state.get_flag("train_glue_fusion"):
            pending = None
            for layer in self.layers:
                x, pending = layer.forward_fused(x, pending)
            _, h = F.fused_residual_norm(
                x, pending, self.norm.weight, norm="rms",
                epsilon=self.norm._epsilon)
            return h
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """LM head on top; ``forward(ids, labels)`` is the mean next-token
    cross-entropy.

    ``device=None`` puts the model on ``cuda`` (which must exist);
    ``generator`` seeds the init (a CPU ``torch.Generator``; the weights
    are drawn on the CPU and then moved)."""

    def __init__(self, cfg: LlamaConfig, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.llama = LlamaModel(cfg)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False))
        self._init_weights(generator)
        self.to(dev)

    @torch.no_grad()
    def _init_weights(self, generator):
        resid_std = 0.02 / math.sqrt(2 * self.cfg.num_layers)
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                std = (resid_std if name.endswith(("attn.o_proj",
                                                   "mlp.down_proj"))
                       else 0.02)
                mod.weight.normal_(0.0, std, generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    def logits(self, input_ids):
        h = self.llama(input_ids)
        if self.lm_head is not None:
            return F.linear_layer(self.lm_head, h)
        return ops.matmul(h, self.llama.embed_tokens.weight,
                          transpose_y=True)

    def forward(self, input_ids, labels=None):
        """Logits ``[B, S, V]``, or with ``labels`` (already shifted by
        the data pipeline) the mean next-token cross-entropy."""
        logits = self.logits(input_ids)
        if labels is None:
            return logits
        return F.cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                               labels.reshape(-1))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """Standard 6N + attention estimate (per trained token)."""
        c = self.cfg
        return 6.0 * self.num_params() + 12 * c.num_layers * \
            c.hidden_size * seq_len
