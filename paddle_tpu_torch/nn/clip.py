"""Gradient clipping by global norm (the port of ``paddle_tpu/nn/
clip.py``'s ``ClipGradByGlobalNorm``). Operates on ``(param, grad)``
lists and returns new grads; the optimizer applies them. The scale stays
a device scalar: no host sync. ``ClipGradByValue`` and
``ClipGradByNorm`` wait for a later slice."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _flat_scale(self, sq_terms):
        """The clip scale from sum-of-squares terms (one per flat bucket
        and one per leftover grad): ``clip_norm / max(norm, clip_norm)``."""
        global_norm = torch.sqrt(sum(sq_terms))
        return self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)

    @staticmethod
    def _apply_scale(params_grads, scale):
        """Scale each clippable grad (new tensors; originals untouched)."""
        out = []
        for p, g in params_grads:
            if g is None or getattr(p, "need_clip", True) is False:
                out.append((p, g))
                continue
            out.append((p, (g.float() * scale).to(g.dtype)))
        return out

    def _dygraph_clip(self, params_grads):
        sq = [g.float().square().sum() for p, g in params_grads
              if g is not None and getattr(p, "need_clip", True) is not False]
        if not sq:
            return params_grads
        return self._apply_scale(params_grads, self._flat_scale(sq))
