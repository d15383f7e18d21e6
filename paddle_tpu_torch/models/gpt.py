"""GPT-family decoder-only language model (``paddle_tpu/models/gpt.py``).

Same configuration fields and defaults, same module tree
(``gpt.{wte, wpe, blocks[i].{ln1, attn.{qkv, proj}, ln2, mlp.{fc1, fc2}},
ln_f}``, ``lm_head=None`` under tied embeddings) and the same init
(normal, std 0.02; residual projections 0.02 / sqrt(2 L)). Weights are
torch-layout (``Linear.weight`` is ``[out, in]``); ``models/weights.py``
loads the JAX package's ``[in, out]`` arrays.

Serving: ``models/generation.py`` drives the blocks token by token over
paged KV. Training: ``GPTForCausalLM(ids, labels)`` runs the
full-sequence forward through the port's functionals (each cast by the
AMP rule), the flash-attention kernel and, with ``cfg.recompute``, block
recompute under ``cfg.recompute_policy``. The model starts in training
mode, as the JAX ``Layer`` does; the serving engine switches it to eval.
With ``train_glue_fusion`` on, training runs the glue-fused forward
(``GPTBlock.forward_fused``): each residual add and the LayerNorm after
it are one fused residual + LayerNorm kernel (#9-#10). MoE is not
ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from .. import ops, resolve_device
from ..core import state
from ..distributed.fleet.recompute import recompute
from ..nn import functional as F


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


_MOE = "GPT MoE (num_experts > 0) arrives with the port's MoE slice"


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
        self.dropout = cfg.dropout
        self.use_flash = cfg.use_flash_attention

    def forward(self, x):
        b, s, h = x.shape
        qkv = F.linear_layer(self.qkv, x)
        q, k, v = qkv.reshape(b, s, 3, self.num_heads,
                              self.head_dim).unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout if self.training else 0.0,
            backend=None if self.use_flash else "xla")
        return F.linear_layer(self.proj, out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = F.gelu(F.linear_layer(self.fc1, x),
                   approximate=True)
        return F.linear_layer(self.fc2, h)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = GPTMLP(cfg)
        self.dropout = cfg.dropout
        self._recompute = cfg.recompute
        self._recompute_policy = (cfg.recompute_policy
                                  if cfg.recompute_policy != "full"
                                  else None)

    def _inner(self, x):
        drop = self.dropout
        x = ops.add(x, F.dropout(self.attn(_ln(self.ln1, x)), drop,
                                 self.training))
        x = ops.add(x, F.dropout(self.mlp(_ln(self.ln2, x)), drop,
                                 self.training))
        return x

    def forward(self, x):
        if self._recompute and self.training:
            return recompute(self._inner, x, policy=self._recompute_policy)
        return self._inner(x)

    def _inner_fused(self, x, pending=None):
        """Glue-fused twin of ``_inner`` (``train_glue_fusion``). A
        pre-norm block cannot fuse its own ln1 with a residual add: the
        add that feeds ln1 belongs to the previous block. So the model
        loop threads the previous block's un-added MLP branch in as
        ``pending``: (x + pending -> ln1) and (x + attn -> ln2) each run
        as one fused kernel, and the block returns its own MLP branch
        un-added for the next block (the last one fuses with ln_f)."""
        drop = self.dropout
        if pending is None:
            h1 = _ln(self.ln1, x)
        else:
            x, h1 = F.fused_residual_norm(x, pending, self.ln1.weight,
                                          self.ln1.bias, epsilon=self.ln1.eps)
        a = F.dropout(self.attn(h1), drop, self.training)
        x, h2 = F.fused_residual_norm(x, a, self.ln2.weight, self.ln2.bias,
                                      epsilon=self.ln2.eps)
        return x, F.dropout(self.mlp(h2), drop, self.training)

    def forward_fused(self, x, pending=None):
        """``(x, pending) -> (x, pending')`` for the glue-fused train
        loop; under block recompute the pending branch rides as a second
        checkpointed argument."""
        if self._recompute and self.training:
            args = (x,) if pending is None else (x, pending)
            return recompute(self._inner_fused, *args,
                             policy=self._recompute_policy)
        return self._inner_fused(x, pending)


def _ln(mod, x):
    return F.layer_norm(x, mod.normalized_shape, mod.weight, mod.bias,
                        mod.eps)


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

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = ops.add(F.embedding(input_ids, self.wte.weight),
                    F.embedding(pos, self.wpe.weight))
        x = F.dropout(x, self.cfg.dropout, self.training)
        if self.training and self.blocks and \
                state.get_flag("train_glue_fusion"):
            pending = None
            for blk in self.blocks:
                x, pending = blk.forward_fused(x, pending)
            # the last block's MLP branch fuses into the final norm
            _, h = F.fused_residual_norm(x, pending, self.ln_f.weight,
                                         self.ln_f.bias,
                                         epsilon=self.ln_f.eps)
            return h
        for blk in self.blocks:
            x = blk(x)
        return _ln(self.ln_f, x)


class GPTForCausalLM(nn.Module):
    """LM head on top (tied to ``wte`` unless ``tie_embeddings=False``).

    ``device=None`` puts the model on ``cuda`` (which must exist);
    ``generator`` seeds the init (a CPU ``torch.Generator``; the weights
    are drawn on the CPU and then moved)."""

    def __init__(self, cfg: GPTConfig, device=None, generator=None):
        super().__init__()
        if cfg.num_experts:
            raise NotImplementedError(_MOE)
        dev = resolve_device(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg)
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

    def logits(self, input_ids):
        h = self.gpt(input_ids)
        if self.lm_head is not None:
            return F.linear_layer(self.lm_head, h)
        return ops.matmul(h, self.gpt.wte.weight, transpose_y=True)

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
