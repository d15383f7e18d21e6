"""Optimizer base and the SGD / Momentum / Adam / AdamW family (the port
of ``paddle_tpu/optimizer/optimizer.py``).

Two paths, as in the JAX package:

* the fused path (flag ``fused_opt``, on by default): fusable parameters
  are grouped into dtype buckets (``optimizer/flat.py``) at the first
  ``step()``, and each step runs one fused update per bucket
  (``ops/cuda/fused_optimizer.py``), in place;
* the per-param path for what the buckets refuse: per-parameter
  ``optimize_attr['learning_rate']``, ``regularizer`` or
  ``need_clip=False`` under a clip, AdamW's ``lr_ratio`` and
  ``apply_decay_param_fun``, ``amsgrad``, a clip other than
  ``ClipGradByGlobalNorm``, and float16 buckets (the kernel takes
  float32 and bfloat16). Its arithmetic is the JAX per-param path's, op
  for op.

``multi_precision`` (set by ``amp.decorate``) keeps fp32 master weights
for bf16/fp16 parameters; a bucket's masters are made from the
bf16-cast parameters, as the JAX flat path makes them. Each param's
grad is ``amp.grad_of(p)``. Under O2 a norm weight's grad may be wider
than the param (the fp32 grad of a bf16 RMSNorm weight): that param
takes the per-param path, so its master update reads the fp32 grad. A
narrower grad (the bf16 grad of an fp32 LayerNorm weight under glue
fusion) widens exactly into its fp32 bucket. Learning-rate schedulers,
``state_dict`` and the other optimizers of the JAX package are not
ported yet.
"""
from __future__ import annotations

import warnings

import torch

from ..amp import grad_of
from ..core import state as _state
from ..nn.clip import ClipGradBase, ClipGradByGlobalNorm
from ..ops.cuda import fused_optimizer as _fo
from . import flat as _flat

__all__ = ["L1Decay", "L2Decay", "Optimizer", "SGD", "Momentum", "Adam",
           "AdamW"]

_LOW = (torch.bfloat16, torch.float16)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class L2Decay:
    """``paddle.regularizer.L2Decay``: folded into the gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _attr_lr(p):
    return getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)


class Optimizer:
    _FUSED_MOMENTS = {"sgd": (), "momentum": ("velocity",),
                      "adam": ("moment1", "moment2"),
                      "adamw": ("moment1", "moment2")}

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if torch.is_tensor(parameters):
            parameters = [parameters]
        self._parameters = list(parameters)
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers arrive with a later slice of the "
                "port; pass a float")
        self._learning_rate = float(learning_rate)
        if weight_decay is None:
            self._regularization = None
        elif isinstance(weight_decay, (L1Decay, L2Decay)):
            self._regularization = weight_decay
        else:
            self._regularization = L2Decay(float(weight_decay))
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError(f"grad_clip must be a ClipGradBase, got "
                            f"{type(grad_clip).__name__}")
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: dict[str, dict[torch.Tensor, torch.Tensor]] = {}
        self._master_weights: dict[torch.Tensor, torch.Tensor] = {}
        self._flat: list[_flat.FlatGroup] | None = None
        self._fused_off = False
        self._defuse_count = 0
        self._lr_t: dict[torch.device, tuple[float, torch.Tensor]] = {}

    # --- lr -------------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    def _lr_tensor(self, device):
        """The LR as a 0-d fp32 tensor on ``device``, refilled only when
        the LR changes (no host-to-device copy per step)."""
        lr = self.get_lr()
        cached = self._lr_t.get(device)
        if cached is None:
            t = torch.full((), lr, dtype=torch.float32, device=device)
        elif cached[0] != lr:
            t = cached[1].fill_(lr)
        else:
            return cached[1]
        self._lr_t[device] = (lr, t)
        return t

    # --- per-param state ------------------------------------------------
    def _use_master(self, p):
        return self._multi_precision and p.dtype in _LOW

    def _acc(self, name, p, init=None, dtype=None):
        store = self._accumulators.setdefault(name, {})
        if p not in store:
            dt = dtype or (torch.float32 if self._use_master(p) else p.dtype)
            store[p] = torch.full(p.shape, 0.0 if init is None else init,
                                  dtype=dt, device=p.device)
        return store[p]

    def _set_acc(self, name, p, val):
        self._accumulators[name][p].copy_(val)

    def _get_master(self, p):
        if p not in self._master_weights:
            self._master_weights[p] = p.detach().float().clone()
        return self._master_weights[p]

    # --- step -----------------------------------------------------------
    def _collect(self):
        """``(param, grad)`` for each param with a grad this step, the
        grad in the dtype the JAX package gives it (``amp.grad_of``)."""
        pairs = [(p, grad_of(p)) for p in self._parameters
                 if p.requires_grad]
        return [(p, g) for p, g in pairs if g is not None]

    def _apply_decay_to_grad(self, p, g32):
        """L2/L1 regularization folded into the gradient (not AdamW's
        decoupled decay)."""
        reg = getattr(p, "regularizer", None) or self._regularization
        if isinstance(reg, (L1Decay, L2Decay)) and reg.coeff:
            w32 = self._get_master(p) if self._use_master(p) else p.float()
            term = w32 if isinstance(reg, L2Decay) else torch.sign(w32)
            return g32 + reg.coeff * term
        return g32

    @torch.no_grad()
    def step(self):
        pairs = self._collect()
        if self._fused_enabled():
            try:
                if self._fused_step(pairs):
                    return
            except _flat.FlatMismatch as e:
                self._defuse(str(e))
        elif self._flat is not None:
            self._defuse("fused path disabled", count=False)
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        self._apply_pairs(pairs, self.get_lr())

    def _apply_pairs(self, pairs, lr):
        """The per-param update loop (grads already clipped)."""
        for p, g in pairs:
            lr_p = lr * _attr_lr(p)
            g32 = self._apply_decay_to_grad(p, g.float())
            if self._use_master(p):
                master = self._get_master(p)
                master.copy_(self._update(p, master, g32, lr_p))
                p.copy_(master.to(p.dtype))
            else:
                p.copy_(self._update(p, p.float(), g32, lr_p).to(p.dtype))

    def _update(self, p, w, g, lr):
        raise NotImplementedError

    # --- fused path -----------------------------------------------------
    def _fused_kind(self):
        """Fused kernel kind, or None when the per-param path must run."""
        return None

    def _fused_enabled(self):
        if self._fused_off or not _state.get_flag("fused_opt"):
            return False
        if self._fused_kind() is None:
            return False
        gc = self._grad_clip
        return gc is None or isinstance(gc, ClipGradByGlobalNorm)

    @staticmethod
    def _fusable_param(p, clip_active):
        return (p.is_floating_point() and _attr_lr(p) == 1.0
                and getattr(p, "regularizer", None) is None
                and not (clip_active
                         and getattr(p, "need_clip", True) is False))

    def _uniform_beta_pows(self, members):
        """(b1, b2) when every member's beta-power history agrees (the
        normal case); None when it is mixed."""
        out = []
        for name in ("beta1_pow", "beta2_pow"):
            store = self._accumulators.get(name, {})
            ts = [store.get(p) for p in members]
            if all(t is None for t in ts):
                out.append(1.0)
                continue
            if any(t is None for t in ts):
                return None
            vals = {float(t.reshape(-1)[0]) for t in ts}
            if len(vals) != 1 or any((t != t.reshape(-1)[0]).any()
                                     for t in ts):
                return None
            out.append(vals.pop())
        return out[0], out[1]

    def _build_flat(self, pairs):
        """Group the fusable params into (dtype, device) buckets and
        build their flat buffers. Returns the groups, or None when
        nothing can fuse. Every check runs before any param is
        re-bound."""
        kind = self._fused_kind()
        clip_active = isinstance(self._grad_clip, ClipGradByGlobalNorm)
        moments = self._FUSED_MOMENTS[kind]
        by_key: dict = {}
        for p, g in pairs:
            if not self._fusable_param(p, clip_active):
                continue
            dt = p.dtype
            if dt not in _KERNEL_DTYPES or not _flat.grad_fits(g, dt):
                # a grad wider than its param (an O2 norm weight's fp32
                # grad) takes the per-param path, unrounded
                continue
            if dt != torch.float32 and moments and not self._use_master(p):
                # per-param accumulators stay in the param dtype without
                # master weights; the flat moments are fp32
                continue
            by_key.setdefault((dt, p.device), []).append(p)
        betas = {}
        for key, members in by_key.items():
            if kind in ("adam", "adamw"):
                got = self._uniform_beta_pows(members)
                if got is None:
                    return None
                betas[key] = got
            stores = [self._accumulators.get(n, {}) for n in moments]
            if self._use_master(members[0]):
                stores.append(self._master_weights)
            for store in stores:
                for p in members:
                    t = store.get(p)
                    if t is not None and (t.dtype != torch.float32
                                          or t.shape != p.shape):
                        return None
        groups = []
        for key, members in by_key.items():
            use_master = self._use_master(members[0])
            grp = _flat.FlatGroup(members, use_master)
            if use_master:
                # from the bf16-cast params (or masters kept so far)
                grp.master_flat = grp.flatten(
                    [self._master_weights.get(p, p) for p in members],
                    torch.float32)
            grp.bind_params()
            for name in moments:
                store = self._accumulators.setdefault(name, {})
                flat = grp.flatten([store.get(p, torch.zeros_like(
                    p, dtype=torch.float32)) for p in members],
                    torch.float32)
                grp.moments[name] = flat
                for i, p in enumerate(members):
                    store[p] = grp.view(flat, i)
            if use_master:
                for i, p in enumerate(members):
                    self._master_weights[p] = grp.view(grp.master_flat, i)
            if kind in ("adam", "adamw"):
                b1, b2 = betas[key]
                grp.b1p = torch.tensor(b1, dtype=torch.float32,
                                       device=grp.device)
                grp.b2p = torch.tensor(b2, dtype=torch.float32,
                                       device=grp.device)
            groups.append(grp)
        return groups or None

    def _make_spec(self, grp, has_clip):
        kind = self._fused_kind()
        reg = self._regularization
        reg_kind, reg_coeff = None, 0.0
        if isinstance(reg, L2Decay) and reg.coeff:
            reg_kind, reg_coeff = "l2", reg.coeff
        elif isinstance(reg, L1Decay) and reg.coeff:
            reg_kind, reg_coeff = "l1", reg.coeff
        return _fo.UpdateSpec(
            kind=kind, beta1=getattr(self, "_beta1", 0.9),
            beta2=getattr(self, "_beta2", 0.999),
            eps=getattr(self, "_epsilon", 1e-8),
            momentum=getattr(self, "_momentum", 0.0),
            nesterov=getattr(self, "_nesterov", False),
            rescale=getattr(self, "_rescale", 1.0),
            decay=(self._coeff if kind == "adamw" else 0.0),
            reg=reg_kind, reg_coeff=reg_coeff,
            use_master=grp.use_master, has_clip=has_clip)

    def _fused_step(self, pairs):
        if not pairs:
            return False
        fl = self._flat
        if fl is None:
            fl = self._build_flat(pairs)
            if fl is None:
                self._fused_off = True   # structural: stop probing
                return False
            self._flat = fl
        gmap = {p: g for p, g in pairs}
        clip_active = isinstance(self._grad_clip, ClipGradByGlobalNorm)
        for grp in fl:
            for i, p in enumerate(grp.params):
                if p not in gmap:
                    raise _flat.FlatMismatch(
                        "bucketed parameter has no gradient this step")
                if not grp.owns(p, i):
                    raise _flat.FlatMismatch(
                        "parameter re-bound outside its bucket")
                if not self._fusable_param(p, clip_active):
                    raise _flat.FlatMismatch(
                        "per-param attribute changed after bucket build")
        bucketed = set()
        for grp in fl:
            bucketed.update(grp.params)
        leftover = [(p, g) for p, g in pairs if p not in bucketed]
        for grp in fl:
            grp.gather_grads(gmap)
        clip_scale = None
        if clip_active:
            sq = [grp.grad_flat.float().square().sum() for grp in fl]
            sq += [g.float().square().sum() for p, g in leftover
                   if getattr(p, "need_clip", True) is not False]
            clip_scale = self._grad_clip._flat_scale(sq)
        if clip_scale is not None and leftover:
            leftover = ClipGradByGlobalNorm._apply_scale(leftover,
                                                         clip_scale)
        for grp in fl:
            spec = self._make_spec(grp, clip_scale is not None)
            names = self._FUSED_MOMENTS[spec.kind]
            kw = {}
            if names:
                kw["m"] = grp.moments[names[0]]
            if len(names) > 1:
                kw["v"] = grp.moments[names[1]]
            *_, nb1, nb2 = _fo.fused_update(
                spec, w=grp.param_flat, g=grp.grad_flat,
                lr=self._lr_tensor(grp.device), clip_scale=clip_scale,
                master=grp.master_flat, b1p=grp.b1p, b2p=grp.b2p, **kw)
            if nb1 is not None:
                grp.b1p, grp.b2p = nb1, nb2
        if leftover:
            self._apply_pairs(leftover, self.get_lr())
        return True

    def _defuse(self, reason, warn=True, count=True):
        """Dissolve the buckets: the views stay the per-param state, and
        the bucket's beta powers become per-param ones."""
        if self._flat is None:
            return
        for grp in self._flat:
            if grp.b1p is None:
                continue
            for p in grp.params:
                self._accumulators.setdefault("beta1_pow", {})[p] = \
                    grp.b1p.clone()
                self._accumulators.setdefault("beta2_pow", {})[p] = \
                    grp.b2p.clone()
        self._flat = None
        if count:
            self._defuse_count += 1
            if self._defuse_count >= 2:
                self._fused_off = True
        if warn:
            warnings.warn(f"fused optimizer path defused: {reason} "
                          f"(per-param fallback)")

    # --- grads ----------------------------------------------------------
    def clear_grad(self, set_to_zero=False):
        """Drop every parameter's grad (``set_to_zero=True`` zeroes it in
        place instead). The fused path copies grads into its own buffer,
        so either is safe for it."""
        for p in self._parameters:
            mg = getattr(p, "main_grad", None)
            if mg is not None:
                if set_to_zero:
                    mg.zero_()
                else:
                    p.main_grad = None
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None



class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, p, w, g, lr):
        return w - lr * g

    def _fused_kind(self):
        return "sgd"


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._rescale = rescale_grad

    def _update(self, p, w, g, lr):
        if self._rescale != 1.0:
            g = g * self._rescale
        vel = self._momentum * self._acc("velocity", p) + g
        self._set_acc("velocity", p, vel)
        if self._nesterov:
            return w - lr * (g + self._momentum * vel)
        return w - lr * vel

    def _fused_kind(self):
        return "momentum"


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def _fused_kind(self):
        return None if self._amsgrad else "adam"

    def _beta_pows(self, p):
        b1p = self._acc("beta1_pow", p, init=1.0, dtype=torch.float32)
        b2p = self._acc("beta2_pow", p, init=1.0, dtype=torch.float32)
        self._set_acc("beta1_pow", p, b1p * self._beta1)
        self._set_acc("beta2_pow", p, b2p * self._beta2)
        return b1p, b2p

    def _update(self, p, w, g, lr):
        m = self._acc("moment1", p, dtype=torch.float32)
        v = self._acc("moment2", p, dtype=torch.float32)
        b1p, b2p = self._beta_pows(p)
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * torch.square(g)
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        m_hat = m / (1 - b1p)
        if self._amsgrad:
            vmax = torch.maximum(self._acc("moment2_max", p,
                                           dtype=torch.float32), v)
            self._set_acc("moment2_max", p, vmax)
            v_hat = vmax / (1 - b2p)
        else:
            v_hat = v / (1 - b2p)
        return w - lr * m_hat / (torch.sqrt(v_hat) + self._epsilon)


class AdamW(Adam):
    """Decoupled weight decay: ``w * (1 - lr * decay)`` before the
    moments, not through the gradient. ``apply_decay_param_fun``
    receives ``p.name`` (None unless the caller set it)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._coeff = (weight_decay.coeff
                       if isinstance(weight_decay, (L1Decay, L2Decay))
                       else float(weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _fused_kind(self):
        if self._amsgrad or self._lr_ratio is not None or \
                self._apply_decay_param_fun is not None:
            return None
        return "adamw"

    def _update(self, p, w, g, lr):
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        decay = self._coeff
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(getattr(p, "name", None)):
            decay = 0.0
        if decay:
            w = w * (1.0 - lr * decay)
        return super()._update(p, w, g, lr)
