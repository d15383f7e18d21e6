"""Continuous-batching serving engine over paged KV caches.

The port of ``paddle_tpu/inference/engine.py``'s scheduling core. It
makes the same decisions from the same state, so token streams, finish
reasons and ``stats`` counters match the JAX engine exactly on the same
requests:

* ONE page pool per layer ``[Hkv, total_pages, page_size, D]`` with a
  free-list allocator; page 0 is the reserved NULL page that inactive
  slots and packing padding write to. With ``kv_quant`` (kwarg, or the
  ``serving_kv_quant`` flag) the pools are int8 and f32 scale pools
  ``[Hkv, total_pages, page_size]`` are appended to the cache list;
  pages quantize on write and dequantize inside the attention kernel.
  Block tables, the prefix cache, copy-on-write and preemption carry
  the scale pools without knowing they exist.
* The MIXED step packs prefill chunks of admitted requests with one
  token from every ongoing decode (each segment at a ``q_block`` edge,
  idle slots ``kv_lens=1, q_lens=0``) through ONE ragged paged-attention
  call per layer (``models.generation.ragged_paged_step``).
* The DECODE path: the first decode dispatch for a (model, geometry)
  is a single step with a host argmax; after it, every decode dispatch
  is a WINDOW of ``decode_window`` steps whose slot state (tokens,
  positions, finished and guard-bad masks) stays on the device, with
  ONE host read per window. (The JAX engine scans the window inside one
  compiled program and compiles the single step first; the port has no
  compiled programs, so it keeps a per-model record of the geometries
  it has decoded with, and a second engine on the same model skips the
  single step just as the JAX one does.)
* ``megakernel`` (kwarg, or the ``serving_megakernel`` flag): each
  decode step runs as three fused launches per layer (norm + QKV (+
  rope) + paged append, quantized on write with ``kv_quant``; the paged
  attention; out-proj + residual + MLP + residual) plus one epilogue
  (final norm + LM head + guarded argmax),
  ``models.generation._gpt_decode_fused`` or ``_llama_decode_fused``.
  The single step and the window take the epilogue's token and bad flag,
  so there is no host argmax; token streams are the unfused path's. The
  switch is part of the decode geometry.
* Tensor parallelism (``mesh``/``tp_axis``): every rank of a process
  group runs this engine with the same requests. Each serves its
  rank-local model (``models.generation.tp_shard_params``: its slices
  of the weights, two all-reduces a layer; with ``megakernel`` the
  layer's MLP is the shard-local ``fused_decode_mlp_partial`` kernel)
  over its kv heads' pools, through the same mixed step, single step
  and window as one device. Every rank picks the next token from the
  same replicated logits, so the scheduler's host state stays identical
  on all ranks. ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
  with named dims (``tp_axis`` picks one; a 1-D mesh takes its dim,
  else the dim named ``"tp"``) or a process group (``torch.distributed``
  or ``distributed.Group``). The backend is the caller's: NCCL with a
  card a rank, gloo on the CPU or for ranks sharing a card. The ranks
  must see the same requests and the same clock decisions: leave
  deadlines off (each rank reads its own clock). Only the head-sharded
  regime is ported: fewer kv heads than ranks raises.
* On-demand paging with preemption (latest-admitted victim) and
  requeue, eager ``PageBudgetError`` (PDT-E016), bounded queue with the
  ``reject`` (``QueueFullError`` PDT-E017) or ``block`` policy,
  deadlines, ``cancel``, the decode guard (a non-finite request fails
  alone with ``NonFiniteLogitsError`` PDT-E018) and a bounded retry of
  every dispatch.
* The cross-request prefix cache (``inference/prefix_cache.py``) with
  copy-on-write at the divergence page and LRU eviction.

The engine serves ``GPTForCausalLM`` and ``LlamaForCausalLM``, with
float or weight-only int8 projections (``quantization.
weight_only_quantize``); the megakernel path serves both families with
float weights, over fp32 or int8 pools. As in the JAX package, the fused
kernels read dense projections only: ``megakernel`` with weight-only
projections raises ``NotImplementedError``. Greedy decoding only.
Subsystems of the JAX engine that later slices port raise
``NotImplementedError`` when switched on: ``spec_decode`` (with or
without a mesh), ``slo`` and ``watchdog_ms``. Request
export/import/snapshot/restore, ``metrics()`` and tracing are not here
yet either.
"""
from __future__ import annotations

import time
import warnings
from collections import deque

import numpy as np
import torch

from .. import resolve_device
from ..core import state as _state
from ..core.errors import PageBudgetError, QueueFullError
from ..models.generation import (_decode_fn, _decode_fused_fn, _kv_heads,
                                 _ragged_fn, guarded_argmax,
                                 paged_slot_attention, tp_shard_params)
from ..resilience import faults
from ..resilience.serving import (SITE_PAGE_PRESSURE, DecodeGuard,
                                  dispatch_retry)
from .prefix_cache import PrefixCache

__all__ = ["ContinuousBatchingEngine", "CompletedRequest"]

_COUNTERS = (
    "admitted", "retired", "steps", "mixed_steps", "decode_dispatches",
    "tokens_generated", "pages_allocated", "peak_pages_in_use",
    "preemptions", "timeouts", "cancelled", "failed", "rejected",
    "retries", "cache_hits", "cache_hit_tokens",
    "prefill_tokens_requested", "prefill_tokens_computed")


class _Request:
    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "done_toks", "deadline", "preemptions",
                 "requested_counted")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id,
                 deadline=None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.done_toks: list[int] = []  # generated before a preemption
        self.deadline = deadline        # absolute clock() seconds | None
        self.preemptions = 0
        # prefill demand is counted ONCE per request: a preempted
        # request's re-admission must not re-count it
        self.requested_counted = False


class CompletedRequest:
    """Result handed back by :meth:`ContinuousBatchingEngine.step`.

    ``finish_reason`` is one of ``resilience.serving.FINISH_REASONS``:
    ``stop`` (eos), ``length`` (max_new_tokens), ``timeout``,
    ``cancelled`` or ``failed`` (decode guard; the coded error is on
    ``error``). ``tokens`` holds whatever was generated before the cut."""

    __slots__ = ("request_id", "prompt", "tokens", "finish_reason",
                 "error")

    def __init__(self, request_id, prompt, tokens,
                 finish_reason="length", error=None):
        self.request_id = request_id
        self.prompt = prompt          # np.int32 [S]
        self.tokens = tokens          # np.int32 [<= max_new_tokens]
        self.finish_reason = finish_reason
        self.error = error

    @property
    def ok(self):
        """True for a normally-finished request (stop/length)."""
        return self.finish_reason in ("stop", "length")

    @property
    def sequence(self):
        """prompt + generated tokens."""
        return np.concatenate([self.prompt, self.tokens])


class _Slot:
    __slots__ = ("req", "phase", "pages", "cur_tok", "cur_pos",
                 "prefill_ids", "prefill_off", "out_toks", "stop_len",
                 "eos", "admit_seq", "cancelled")

    def __init__(self):
        self.req = None
        self.phase = "free"           # free | prefill | decode
        self.pages = []
        self.cur_tok = 0
        self.cur_pos = 0
        self.prefill_ids = None       # prompt + replayed done_toks
        self.prefill_off = 0
        self.out_toks = []
        self.stop_len = 0
        self.eos = -1
        self.admit_seq = -1
        self.cancelled = False

    @property
    def len_written(self):
        """Tokens resident in the page pools (positions [0, len))."""
        if self.phase == "prefill":
            return self.prefill_off
        return self.cur_pos

    @property
    def done(self):
        if self.req is None:
            return True
        if self.phase == "prefill":
            return False
        if self.cur_pos + 1 >= self.stop_len:
            return True
        return bool(self.eos >= 0 and self.out_toks
                    and self.out_toks[-1] == self.eos)


def _parse_on_off(name, value):
    """Strict parse of an on/off switch (the JAX engine's): a string
    must be one of the on or off spellings, anything else is truthy or
    not."""
    if isinstance(value, str):
        low = value.lower()
        if low in _state.KV_QUANT_ON_SPELLINGS:
            return True
        if low in _state.KV_QUANT_OFF_SPELLINGS:
            return False
        raise ValueError(
            f"{name}={value!r}: expected one of "
            f"{_state.KV_QUANT_ON_SPELLINGS} or "
            f"{_state.KV_QUANT_OFF_SPELLINGS}")
    return bool(value)


def _parse_switch(name, value, later):
    """A subsystem switch of the JAX engine that a later slice ports:
    off spellings pass, on raises ``NotImplementedError`` naming the
    slice, anything else raises ``ValueError`` (strict, as in JAX)."""
    if _parse_on_off(name, value):
        raise NotImplementedError(f"{name} is not ported yet: {later}")


class ContinuousBatchingEngine:
    """Request-level scheduler: ``add_request`` any time, ``step`` until
    it returns completions, or ``run`` to drain.

    Policy knobs (``None`` falls back to the ``serving_*`` flags in
    ``core/state.py``): ``max_queue`` + ``queue_policy`` bound
    admission, ``default_deadline_ms`` applies a TTL to every request,
    ``dispatch_retries`` bounds the per-dispatch retry, ``prefix_cache``
    gates the cross-request KV prefix cache. ``clock`` (tests) replaces
    ``time.monotonic`` for deterministic deadline drills. ``device``
    must be the model's device (default ``cuda``)."""

    def __init__(self, model, *, max_slots=8, page_size=16,
                 max_seq_len=None, total_pages=None, decode_window=8,
                 prefill_chunk=64, q_block=8, pages_per_block=None,
                 max_queue=None, queue_policy=None,
                 default_deadline_ms=None, dispatch_retries=None,
                 prefix_cache=None, kv_quant=None, megakernel=None,
                 spec_decode=None, spec_k=None, spec_proposer=None,
                 spec_temperature=None, spec_rejection_sampling=None,
                 spec_seed=0, clock=None, mesh=None, tp_axis=None,
                 slo=None, watchdog_ms=None, device=None):
        # strict: kv_quant changes numerics, and the megakernel which
        # kernels serve the tokens, so a typo must not pick either
        self.kv_quant = _parse_on_off(
            "kv_quant", _state.get_flag("serving_kv_quant")
            if kv_quant is None else kv_quant)
        _parse_switch("spec_decode", spec_decode,
                      "speculative decoding comes with a later slice")
        if spec_seed or any(v is not None for v in (
                spec_k, spec_proposer, spec_temperature,
                spec_rejection_sampling)):
            raise NotImplementedError(
                "speculative decoding (spec_*) is not ported yet: it "
                "comes with a later slice")
        if slo:
            raise NotImplementedError(
                "SLO guardrails are not ported yet: they come with the "
                "observability slice")
        if watchdog_ms:
            raise NotImplementedError(
                "the stall watchdog is not ported yet: it comes with the "
                "observability slice")
        self.megakernel = _parse_on_off(
            "megakernel", _state.get_flag("serving_megakernel")
            if megakernel is None else megakernel)
        # tensor parallelism: this rank serves its rank-local model
        # (cached on the model per group and axis)
        self.tp, self.tp_axis = 1, None
        if mesh is not None or tp_axis is not None:
            tpp = tp_shard_params(model, mesh, tp_axis)
            model = tpp.model
            self.tp, self.tp_axis = tpp.meta["tp"], tpp.meta["axis"]
        self._decode, _, self._hard_limit = _decode_fn(model)
        self._decode_mk = _decode_fused_fn(model) if self.megakernel else None
        self._ragged = _ragged_fn(model)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"engine device {self.device} but the model lives on "
                f"{model.device}; build the model with the same device=")
        cfg = model.cfg
        self.model = model
        model.eval()   # the engine owns its model: serving is eval-mode
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.max_seq_len = int(max_seq_len or cfg.max_seq_len)
        if self._hard_limit:
            self.max_seq_len = min(self.max_seq_len, cfg.max_seq_len)
        self.decode_window = int(decode_window)
        self.q_block = int(q_block)
        self.prefill_chunk = max(self.q_block, int(prefill_chunk))
        self.pages_per_block = pages_per_block
        # per-slot page-table width covers the engine's length cap
        self.np_per_seq = -(-self.max_seq_len // self.page_size)
        if total_pages is None:
            total_pages = 1 + self.max_slots * self.np_per_seq
        self.total_pages = int(total_pages)
        # token budget of the mixed step: one q_block per slot (the
        # ongoing decodes) + the prefill chunk
        self.token_budget = self.max_slots * self.q_block \
            + self.prefill_chunk

        self.max_queue = int(_state.get_flag("serving_max_queue")
                             if max_queue is None else max_queue)
        self.queue_policy = str(_state.get_flag("serving_queue_policy")
                                if queue_policy is None else queue_policy)
        if self.queue_policy not in ("reject", "block"):
            raise ValueError(
                f"queue_policy must be 'reject' or 'block', "
                f"got {self.queue_policy!r}")
        dl = float(_state.get_flag("serving_deadline_ms")
                   if default_deadline_ms is None else default_deadline_ms)
        self.default_deadline_ms = dl if dl > 0 else None
        self.dispatch_retries = int(
            _state.get_flag("serving_dispatch_retries")
            if dispatch_retries is None else dispatch_retries)
        self._clock = time.monotonic if clock is None else clock
        self._guard = DecodeGuard(self.max_slots)

        # the pools hold this rank's kv heads (the JAX tp_cache_spec cut)
        n_kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
        shape = (_kv_heads(model), self.total_pages, self.page_size,
                 cfg.head_dim)
        kv_dtype = torch.int8 if self.kv_quant else torch.float32
        self._caches = [torch.zeros(shape, dtype=kv_dtype,
                                    device=self.device)
                        for _ in range(2 * cfg.num_layers)]
        if self.kv_quant:   # the scale pools, appended
            self._caches += [torch.zeros(shape[:3], dtype=torch.float32,
                                         device=self.device)
                             for _ in range(2 * cfg.num_layers)]
        # bytes per page across all layers (K and V, data and scales),
        # all kv heads (every rank's pools together, as on one device)
        itemsize = 1 if self.kv_quant else 4
        self._page_bytes = 2 * cfg.num_layers * n_kv * self.page_size \
            * (cfg.head_dim * itemsize + (4 if self.kv_quant else 0))
        self._free_pages = deque(range(1, self.total_pages))  # 0 = null
        pc = (_state.get_flag("serving_prefix_cache")
              if prefix_cache is None else prefix_cache)
        if isinstance(pc, str):
            pc = pc.lower() not in _state.PREFIX_CACHE_OFF_SPELLINGS
        self._cache = PrefixCache(self.page_size, self._free_pages,
                                  enabled=bool(pc),
                                  total_pages=self.total_pages)
        self._bt = np.zeros((self.max_slots, self.np_per_seq), np.int32)
        self._slots = [_Slot() for _ in range(self.max_slots)]
        self._queue: deque[_Request] = deque()
        self._early: list[CompletedRequest] = []  # finalized off-dispatch
        self._next_rid = 0
        self._admit_counter = 0
        self._stats = dict.fromkeys(_COUNTERS, 0)

    # ------------------------------------------------------------ API --
    def _pages_in_use(self) -> int:
        """Pages held by resident slots: the usable pool minus free
        minus cached."""
        return (self.total_pages - 1 - len(self._free_pages)
                - self._cache.cached_pages)

    @property
    def stats(self):
        """Health snapshot, keys in the JAX engine's order: the lifetime
        counters plus live gauges. ``pages_in_use + pages_free +
        cached_pages`` always sums to the usable pool. Keys of
        subsystems not ported yet hold their feature-off values."""
        d = dict(self._stats)
        d["cached_pages"] = self._cache.cached_pages
        d["evictions"] = self._cache.evictions
        d["pages_in_use"] = self._pages_in_use()
        d["pages_free"] = len(self._free_pages)
        d["queue_depth"] = len(self._queue)
        d["kv_quant"] = self.kv_quant
        d["kv_page_bytes"] = self._page_bytes
        d["kv_bytes_in_use"] = d["pages_in_use"] * self._page_bytes
        d["spec_proposed"] = 0
        d["spec_accepted"] = 0
        d["spec_accept_rate"] = 0.0
        d["migrated_in"] = 0
        d["migrated_out"] = 0
        return d

    def add_request(self, prompt, max_new_tokens, eos_token_id=None,
                    request_id=None, deadline_ms=None):
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        total = prompt.size + int(max_new_tokens)
        if total > self.max_seq_len:
            raise ValueError(
                f"request needs {total} tokens > engine max_seq_len "
                f"{self.max_seq_len}")
        # eager page-budget rejection: a request whose full length can
        # never fit the pool fails HERE, not after the queue drains
        need_full = -(-total // self.page_size)
        if need_full > self.total_pages - 1:
            self._stats["rejected"] += 1
            raise PageBudgetError(
                f"request needs {need_full} pages but the pool only has "
                f"{self.total_pages - 1}; raise total_pages or lower "
                f"max_new_tokens [{PageBudgetError.error_code}]")
        if self.max_queue and len(self._queue) >= self.max_queue:
            if self.queue_policy == "reject":
                self._stats["rejected"] += 1
                raise QueueFullError(
                    f"admission queue full ({self.max_queue}); shed load "
                    f"or use queue_policy='block' "
                    f"[{QueueFullError.error_code}]")
            # block: drive the engine until the queue drains one slot
            for _ in range(1_000_000):
                if len(self._queue) < self.max_queue or not self.has_work:
                    break
                self._early.extend(self.step())
            else:
                raise RuntimeError("queue_policy='block': engine made no "
                                   "progress draining the queue")
        if request_id is None:
            rid = self._next_rid
            self._next_rid += 1
        else:
            rid = request_id
            if isinstance(rid, int):  # auto ids must never collide
                self._next_rid = max(self._next_rid, rid + 1)
            in_flight = {r.rid for r in self._queue} | {
                s.req.rid for s in self._slots if s.req is not None}
            if rid in in_flight:
                raise ValueError(f"request_id {rid!r} already in flight")
        dl_ms = (self.default_deadline_ms
                 if deadline_ms is None else float(deadline_ms))
        deadline = (self._clock() + dl_ms / 1e3) if dl_ms else None
        self._queue.append(_Request(
            rid, prompt, max_new_tokens,
            -1 if eos_token_id is None else int(eos_token_id), deadline))
        return rid

    def cancel(self, rid) -> bool:
        """Cancel a queued or resident request; its CompletedRequest
        (``finish_reason == "cancelled"``, tokens generated so far)
        surfaces from the next :meth:`step`. False when ``rid`` is not
        in flight."""
        for i, r in enumerate(self._queue):
            if r.rid == rid:
                del self._queue[i]
                self._stats["cancelled"] += 1
                self._early.append(CompletedRequest(
                    rid, r.prompt, np.asarray(r.done_toks, np.int32),
                    "cancelled"))
                return True
        for s in self._slots:
            if s.req is not None and s.req.rid == rid and not s.cancelled:
                s.cancelled = True   # finalized at the next step boundary
                return True
        return False

    def pending_requests(self):
        """Request ids still in flight (resident slots, then queued)."""
        out = [s.req.rid for s in self._slots if s.req is not None]
        out.extend(r.rid for r in self._queue)
        return out

    @property
    def has_work(self):
        return bool(self._queue) or bool(self._early) or any(
            s.req is not None for s in self._slots)

    def run(self, max_steps=10000):
        """Drain: step until every queued/resident request completes.
        Returns {request_id: CompletedRequest} in completion order."""
        done = {}
        for _ in range(max_steps):
            if not self.has_work:
                break
            for c in self.step():
                done[c.request_id] = c
        for c in self._early:   # finalized after the last step ran
            done[c.request_id] = c
        self._early.clear()
        if self.has_work:
            pend = self.pending_requests()
            warnings.warn(
                f"ContinuousBatchingEngine.run: step budget "
                f"({max_steps}) exhausted with {len(pend)} request(s) "
                f"unfinished — engine.pending_requests() lists them",
                RuntimeWarning, stacklevel=2)
        return done

    # ---------------------------------------------- slot lifecycle ----
    def _release_slot(self, b):
        """Free slot ``b``: its pages drop their resident reference (the
        prefix cache keeps indexed ones CACHED), its block-table row
        goes to the null page. The ONLY way pages leave a slot."""
        s = self._slots[b]
        self._cache.release(s.pages)
        self._bt[b, :] = 0
        self._slots[b] = _Slot()

    def _publish_slot(self, b):
        """Index slot ``b``'s fully-written pages in the prefix cache
        (partial tail pages stay private)."""
        s = self._slots[b]
        n = s.len_written
        if n < self.page_size:
            return
        if s.phase == "prefill":
            ids = s.prefill_ids[:n]
        else:
            ids = np.concatenate(
                [s.req.prompt, np.asarray(s.out_toks, np.int32)])[:n]
        self._cache.publish(ids, s.pages, n)

    def _finalize_slot(self, b, reason, error=None):
        """Retire slot ``b`` off the normal path (timeout / cancelled /
        failed): free its pages, emit the partial result."""
        s = self._slots[b]
        toks = np.asarray(s.out_toks[:s.req.max_new_tokens], np.int32)
        comp = CompletedRequest(s.req.rid, s.req.prompt, toks, reason,
                                error)
        if reason != "failed":  # a guard-failed slot's KV is suspect
            self._publish_slot(b)
        self._release_slot(b)
        return comp

    def _retire(self):
        out = []
        for b, s in enumerate(self._slots):
            if s.req is None or not s.done or s.cancelled:
                continue  # cancelled-but-done: _sweep finalizes it
            toks = s.out_toks[:s.req.max_new_tokens]
            reason = "length"
            if s.eos >= 0 and s.eos in toks:
                toks = toks[:toks.index(s.eos) + 1]
                reason = "stop"
            out.append(CompletedRequest(
                s.req.rid, s.req.prompt, np.asarray(toks, np.int32),
                reason))
            self._publish_slot(b)
            self._release_slot(b)
            self._stats["retired"] += 1
        return out

    def _sweep(self, now):
        """Step-boundary policy sweep: expire deadlines (queued AND
        resident) and finalize cancelled residents."""
        out = []
        if any(r.deadline is not None and now >= r.deadline
               for r in self._queue):
            kept = deque()
            for r in self._queue:
                if r.deadline is not None and now >= r.deadline:
                    self._stats["timeouts"] += 1
                    out.append(CompletedRequest(
                        r.rid, r.prompt,
                        np.asarray(r.done_toks, np.int32), "timeout"))
                else:
                    kept.append(r)
            self._queue = kept
        for b, s in enumerate(self._slots):
            if s.req is None:
                continue
            if s.cancelled:
                self._stats["cancelled"] += 1
                out.append(self._finalize_slot(b, "cancelled"))
            elif s.req.deadline is not None and now >= s.req.deadline:
                self._stats["timeouts"] += 1
                out.append(self._finalize_slot(b, "timeout"))
        return out

    # --------------------------------------------- page allocation ----
    def _admit_need(self, req):
        """Pages an admission reserves: the (resume) prompt plus ONE
        decode slot — growth is on-demand from there."""
        resume = req.prompt.size + len(req.done_toks)
        stop = req.prompt.size + req.max_new_tokens
        target = max(resume, min(resume + 1, stop))
        return max(1, -(-target // self.page_size))

    def _note_peak(self):
        self._stats["peak_pages_in_use"] = max(
            self._stats["peak_pages_in_use"], self._pages_in_use())

    def _admit(self):
        for b, s in enumerate(self._slots):
            if s.req is not None or not self._queue:
                continue
            req = self._queue[0]
            # a preempted request resumes at prompt + tokens_so_far
            if req.done_toks:
                resume_ids = np.concatenate(
                    [req.prompt, np.asarray(req.done_toks, np.int32)])
            else:
                resume_ids = req.prompt
            resume = int(resume_ids.size)
            stop = req.prompt.size + req.max_new_tokens
            need_total = self._admit_need(req)
            # radix walk: the longest indexed prefix rides on its
            # existing pages; a FULL (page-aligned) hit still computes
            # the last position's logits, so the divergence page is
            # copy-on-write
            matched = self._cache.match(resume_ids)
            cow_src = None
            if matched and len(matched) * self.page_size >= resume:
                cow_src = matched.pop()
            prefill_off = (resume - 1 if cow_src is not None
                           else len(matched) * self.page_size)
            self._cache.retain(matched)   # pin before availability math
            n_alloc = need_total - len(matched)
            if n_alloc > self._cache.available():
                self._cache.release(matched)  # unpin: back to the LRU
                break                 # head-of-line: keep arrival order
            self._queue.popleft()
            alloc = [self._cache.acquire(key=str(req.rid))
                     for _ in range(n_alloc)]
            pages = matched + alloc
            s.req = req
            s.phase = "prefill"
            s.pages = pages
            s.prefill_ids = resume_ids
            s.prefill_off = prefill_off
            s.out_toks = list(req.done_toks)
            s.stop_len = stop
            s.eos = req.eos_token_id
            s.admit_seq = self._admit_counter
            self._admit_counter += 1
            self._bt[b, :] = 0
            self._bt[b, :len(pages)] = pages
            if cow_src is not None:
                self._cow_page(cow_src, alloc[0])
            self._stats["admitted"] += 1
            self._stats["pages_allocated"] += len(alloc)
            if not req.requested_counted:
                self._stats["prefill_tokens_requested"] += resume
                req.requested_counted = True
            if prefill_off:
                self._stats["cache_hits"] += 1
                self._stats["cache_hit_tokens"] += prefill_off
        self._note_peak()

    def _pick_victim(self, b):
        """Preemption victim for grower ``b``: the latest-admitted
        resident admitted AFTER ``b``; None when ``b`` is the latest."""
        me = self._slots[b].admit_seq
        victim, vseq = None, me
        for i, s in enumerate(self._slots):
            if i != b and s.req is not None and s.admit_seq > vseq:
                victim, vseq = i, s.admit_seq
        return victim

    def _preempt(self, b):
        """Evict slot ``b``: publish its full pages into the prefix
        cache and requeue the request at the HEAD of the queue."""
        s = self._slots[b]
        req = s.req
        req.done_toks = list(s.out_toks)
        req.preemptions += 1
        self._queue.appendleft(req)
        self._publish_slot(b)
        self._release_slot(b)
        self._stats["preemptions"] += 1

    def _ensure_tokens(self, b, n_tokens):
        """Grow slot ``b``'s block table to hold ``n_tokens`` tokens,
        evicting cached pages, then preempting later-admitted victims.
        False when ``b`` itself had to be preempted."""
        s = self._slots[b]
        need = -(-n_tokens // self.page_size)
        while len(s.pages) < need:
            pg = None
            if not faults.check(SITE_PAGE_PRESSURE, key=str(s.req.rid)):
                pg = self._cache.acquire(key=str(s.req.rid))
            if pg is None:
                victim = self._pick_victim(b)
                if victim is None:
                    self._preempt(b)
                    return False
                self._preempt(victim)
                continue
            self._bt[b, len(s.pages)] = pg
            s.pages.append(pg)
            self._stats["pages_allocated"] += 1
        self._note_peak()
        return True

    # ------------------------------------------------------- step -----
    def step(self):
        """One scheduling step: retire, sweep policies, admit, grow/
        preempt, dispatch. Returns the requests completed by the
        PREVIOUS dispatch plus any policy finalizations."""
        completed = self._retire()
        if self._early:
            completed.extend(self._early)
            self._early.clear()
        completed.extend(self._sweep(self._clock()))
        self._admit()
        self._stats["steps"] += 1
        if any(s.phase == "prefill" for s in self._slots):
            self._run_mixed()
        elif any(s.phase == "decode" for s in self._slots):
            self._run_decode()
        elif self._queue:
            # backstop only: eager PageBudgetError rejects anything the
            # empty pool cannot hold
            req = self._queue[0]
            raise RuntimeError(
                f"request {req.rid} needs {self._admit_need(req)} pages "
                f"but the pool only has {self.total_pages - 1}; raise "
                "total_pages or lower max_new_tokens")
        return completed

    def _fail(self, b):
        """Decode guard hit: fail ONE request with the coded error."""
        s = self._slots[b]
        err = DecodeGuard.failure(s.req.rid, s.len_written)
        self._stats["failed"] += 1
        self._early.append(self._finalize_slot(b, "failed", err))

    def _dispatch(self, kind, fn):
        """Run one device dispatch under the bounded retry. The pools
        are written in place; a retried dispatch rewrites the same
        values at the same places, so a retry is safe."""
        def _on_retry(_exc, _attempt):
            self._stats["retries"] += 1
        return dispatch_retry(kind, fn,
                              max_attempts=self.dispatch_retries + 1,
                              on_retry=_on_retry)

    def _tensor(self, arr, dtype=torch.int64):
        return torch.as_tensor(arr, dtype=dtype).to(self.device)

    def _geometry(self):
        return (self.max_slots, self.page_size, self.np_per_seq,
                self.total_pages, self.token_budget, self.q_block,
                self.pages_per_block, self.kv_quant, self.megakernel)

    def _decoded_geometries(self) -> set:
        """Per-model record of the geometries a decode step has run
        with: the JAX engine runs the single-step bootstrap only while
        no compiled decode step for the (model, geometry) exists, and
        this record stands in for that program cache."""
        rec = self.model.__dict__.get("_serving_decoded_geometries")
        if rec is None:
            rec = set()
            self.model.__dict__["_serving_decoded_geometries"] = rec
        return rec

    # ------------------------------------------- copy-on-write --------
    def _cow_page(self, src, dst):
        """Copy-on-write at the divergence page: duplicate shared page
        ``src``'s KV (every pool of the cache list: data pools and, under
        kv_quant, scale pools) into private page ``dst``."""
        def _cow_call():
            for p in self._caches:
                p[:, dst] = p[:, src]
        self._dispatch("cow", _cow_call)

    # ------------------------------------------------- mixed step -----
    def _plan_prefill(self, plan, budget):
        """Add each prefill slot's next chunk that fits ``budget`` to
        ``plan`` (entries ``(segment, pos0, take)``)."""
        qb = self.q_block
        for b, s in enumerate(self._slots):
            if s.phase != "prefill":
                continue
            rem = s.prefill_ids.size - s.prefill_off
            take = min(rem, budget)
            while take > 0 and -(-take // qb) * qb > budget:
                take -= 1     # q_block padding must fit the budget
            if take <= 0:
                continue      # budget exhausted: sits out this step
            budget -= -(-take // qb) * qb
            plan[b] = (list(s.prefill_ids[s.prefill_off:
                                          s.prefill_off + take]),
                       s.prefill_off, take)

    def _grow_plan(self, plan):
        """Page growth in admission order (earliest first); growth may
        preempt later-admitted slots, so drop plans whose slot got
        evicted or self-preempted."""
        order = sorted(plan, key=lambda b: self._slots[b].admit_seq)
        for b in order:
            s = self._slots[b]
            if s.req is None:           # evicted by an earlier grower
                plan.pop(b)
                continue
            seg, pos0, _take = plan[b]
            if not self._ensure_tokens(b, pos0 + len(seg)):
                plan.pop(b)
        for b in list(plan):
            if self._slots[b].req is None:
                plan.pop(b)

    def _pack_plan(self, plan):
        """Pack the plan's segments into the token-budget vectors, each
        segment at a q_block edge; meters prefill compute."""
        qb, T, B = self.q_block, self.token_budget, self.max_slots
        tok = np.zeros(T, np.int64)
        tpos = np.zeros(T, np.int64)
        tslot = np.zeros(T, np.int64)
        tvalid = np.zeros(T, np.int64)
        kv_lens = np.ones(B, np.int32)
        q_lens = np.zeros(B, np.int32)
        last_idx = np.zeros(B, np.int64)
        cur = 0
        for b in range(B):
            if b not in plan:
                continue
            s = self._slots[b]
            seg, pos0, take = plan[b]
            n = len(seg)
            tok[cur:cur + n] = seg
            tpos[cur:cur + n] = pos0 + np.arange(n)
            tslot[cur:cur + n] = b
            tvalid[cur:cur + n] = 1
            q_lens[b] = n
            kv_lens[b] = s.len_written + n
            last_idx[b] = cur + n - 1
            cur += -(-n // qb) * qb   # next segment at a q_block edge
            if take is not None:      # prefill-compute meter
                self._stats["prefill_tokens_computed"] += take
        return tok, tpos, tslot, tvalid, kv_lens, q_lens, last_idx

    @torch.no_grad()
    def _mixed(self, tok, tpos, tslot, tvalid, kv_lens, q_lens, last_idx,
               poison, bt):
        logits, _ = self._ragged(self.model, tok[None, :], tpos, tslot,
                                 tvalid, kv_lens, q_lens, bt,
                                 self._caches, self.q_block,
                                 self.pages_per_block)
        nxt, bad = guarded_argmax(logits[last_idx], poison)
        out = torch.stack([nxt, bad.long()]).cpu().numpy()  # one host read
        return out[0], out[1].astype(bool)

    def _run_mixed(self):
        """Pack one q_block-aligned segment per active slot — decode
        slots their current token, prefill slots the next chunk that
        fits — grow/preempt for the pages this step writes, and advance
        everything in ONE dispatch."""
        B = self.max_slots
        plan = {}      # b -> (segment, pos0, prefill take | None)
        budget = self.token_budget
        for b, s in enumerate(self._slots):
            if s.phase == "decode":
                plan[b] = ([int(s.cur_tok)], s.cur_pos, None)
                budget -= self.q_block
        self._plan_prefill(plan, budget)
        self._grow_plan(plan)
        if not plan:
            return
        tok, tpos, tslot, tvalid, kv_lens, q_lens, last_idx = \
            self._pack_plan(plan)
        poison = self._guard.poison(
            [self._slots[b].req.rid if b in plan else None
             for b in range(B)])
        args = (self._tensor(tok), self._tensor(tpos), self._tensor(tslot),
                self._tensor(tvalid), self._tensor(kv_lens, torch.int32),
                self._tensor(q_lens, torch.int32), self._tensor(last_idx),
                self._tensor(poison, torch.float32),
                self._tensor(self._bt, torch.int32))
        nxt, bad = self._dispatch("mixed", lambda: self._mixed(*args))
        self._stats["mixed_steps"] += 1
        self._stats["decode_dispatches"] += 1
        for b in sorted(plan):
            s = self._slots[b]
            _seg, _pos0, take = plan[b]
            if bad[b]:
                self._fail(b)
                continue
            if take is None:
                self._accept(s, int(nxt[b]))
            else:
                s.prefill_off += take
                if s.prefill_off >= s.prefill_ids.size:
                    s.phase = "decode"
                    s.cur_pos = s.prefill_ids.size
                    s.cur_tok = int(nxt[b])
                    s.out_toks.append(int(nxt[b]))
                    self._stats["tokens_generated"] += 1

    def _accept(self, s, t):
        s.out_toks.append(t)
        s.cur_tok = t
        s.cur_pos += 1
        self._stats["tokens_generated"] += 1

    # ------------------------------------------------ decode path -----
    def _decode_step(self, tok, pos, bt):
        """One decode step for every slot: logits [B, V] (pools written
        in place)."""
        ppb = self.pages_per_block

        def attend(q, k, v, kc, vc, p, ks=None, vs=None):
            return paged_slot_attention(q, k, v, kc, vc, p, bt,
                                        pages_per_block=ppb, k_scales=ks,
                                        v_scales=vs)

        logits, _ = self._decode(self.model, tok, pos, self._caches,
                                 attend)
        return logits

    def _decode_step_mk(self, tok, pos, bt, poison):
        """One megakernel decode step for every slot: the epilogue's
        ``(nxt [B], bad [B])`` (pools written in place)."""
        _, nxt, bad, _ = self._decode_mk(self.model, tok, pos, bt,
                                         self._caches, poison,
                                         self.pages_per_block)
        return nxt, bad

    def _slot_vectors(self):
        B = self.max_slots
        tok = np.zeros((B, 1), np.int64)
        pos = np.zeros(B, np.int64)
        fin = np.ones(B, bool)
        eos = np.full(B, -1, np.int64)
        stop = np.ones(B, np.int64)
        rids = [None] * B
        for b, s in enumerate(self._slots):
            if s.phase != "decode":
                continue
            tok[b, 0] = s.cur_tok
            pos[b] = s.cur_pos
            fin[b] = s.done
            eos[b] = s.eos
            stop[b] = s.stop_len
            rids[b] = s.req.rid
        return tok, pos, fin, eos, stop, rids

    def _grow_decode_slots(self):
        """Reserve the pages the next decode dispatch can write: up to
        ``decode_window`` tokens per live slot (capped at stop_len),
        preempting under pressure. Earliest-admitted first."""
        order = sorted(
            (b for b, s in enumerate(self._slots) if s.phase == "decode"),
            key=lambda b: self._slots[b].admit_seq)
        for b in order:
            s = self._slots[b]
            if s.req is None:           # evicted by an earlier grower
                continue
            target = min(s.cur_pos + self.decode_window, s.stop_len)
            self._ensure_tokens(b, max(target, s.cur_pos + 1))

    def _run_decode(self):
        self._grow_decode_slots()
        if not any(s.phase == "decode" for s in self._slots):
            return                      # everyone got preempted
        tok, pos, fin, eos, stop, rids = self._slot_vectors()
        geometries = self._decoded_geometries()
        if self._geometry() in geometries:
            self._run_window(tok, pos, fin, eos, stop, rids)
            return
        # first decode dispatch of this (model, geometry): one step,
        # host argmax, the guard applied host-side to the same values;
        # the megakernel step takes the poison lane and returns the
        # guarded pick from its epilogue (no host argmax)
        bt = self._tensor(self._bt, torch.int32)
        tok_t, pos_t = self._tensor(tok), self._tensor(pos)
        if self.megakernel:
            poison_t = self._tensor(self._guard.poison(rids), torch.float32)

            @torch.no_grad()
            def _single_mk():
                nxt, bad = self._decode_step_mk(tok_t, pos_t, bt, poison_t)
                return torch.stack([nxt, bad.long()]).cpu().numpy()

            out = self._dispatch("decode", _single_mk)
            nxt, bad = out[0], out[1].astype(bool)
        else:
            @torch.no_grad()
            def _single():
                return self._decode_step(tok_t, pos_t,
                                         bt).float().cpu().numpy()

            lg = self._dispatch("decode", _single)
            lg = lg + self._guard.poison(rids)[:, None]
            bad = ~np.isfinite(lg).all(-1)
            nxt = np.where(bad, 0, lg.argmax(-1)).astype(np.int32)
        self._stats["decode_dispatches"] += 1
        geometries.add(self._geometry())
        for b, s in enumerate(self._slots):
            if fin[b]:
                continue
            if bad[b]:
                self._fail(b)
                continue
            self._accept(s, int(nxt[b]))

    @torch.no_grad()
    def _window(self, tok, pos, fin, eos, stop, poison, bt):
        """``decode_window`` greedy decode steps with all slot state on
        the device: a finished OR guard-failed slot freezes (token and
        position stop advancing, so its page writes keep landing on
        pages it owns, or on the null page). Returns the stacked tokens
        and cumulative bad flags [K, B] in ONE host read."""
        bad = torch.zeros_like(fin)
        toks, bads = [], []
        for _ in range(self.decode_window):
            if self.megakernel:   # the epilogue's guarded pick
                nxt_raw, row_bad = self._decode_step_mk(tok, pos, bt,
                                                        poison)
            else:
                lg = self._decode_step(tok, pos, bt)
                nxt_raw, row_bad = guarded_argmax(lg, poison)
            bad = bad | (row_bad & ~fin)
            adv = ~(fin | bad)
            nxt = torch.where(adv, nxt_raw, tok[:, 0])
            pos = torch.where(adv, pos + 1, pos)
            fin = fin | bad | ((eos >= 0) & (nxt == eos)) \
                | (pos + 1 >= stop)
            tok = nxt[:, None]
            toks.append(nxt)
            bads.append(bad)
        out = torch.stack([torch.stack(toks),
                           torch.stack(bads).long()]).cpu().numpy()
        return out[0], out[1].astype(bool)

    def _run_window(self, tok, pos, fin, eos, stop, rids):
        """One decode window in one dispatch; the host replays the stop
        rule over its tokens."""
        poison = self._guard.poison(rids)
        args = (self._tensor(tok), self._tensor(pos),
                self._tensor(fin, torch.bool), self._tensor(eos),
                self._tensor(stop), self._tensor(poison, torch.float32),
                self._tensor(self._bt, torch.int32))
        toks, bads = self._dispatch("window", lambda: self._window(*args))
        self._stats["decode_dispatches"] += 1
        self._apply_window(toks, bads, fin, self.decode_window)

    def _apply_window(self, toks, bads, fin, K):
        """Host replay of the device stop rule over one window's tokens
        [K, B] / cumulative bad flags [K, B]; the first bad step fails
        the slot and discards its frozen tail."""
        for b, s in enumerate(self._slots):
            if s.phase != "decode" or fin[b]:
                continue
            for k in range(K):
                if bads[k, b]:
                    self._fail(b)
                    break
                t = int(toks[k, b])
                self._accept(s, t)
                if (s.eos >= 0 and t == s.eos) \
                        or s.cur_pos + 1 >= s.stop_len:
                    break
