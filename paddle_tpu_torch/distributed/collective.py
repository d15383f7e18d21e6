"""Process groups and the one collective that tensor-parallel serving
runs, over ``torch.distributed``.

The subset of ``paddle_tpu/distributed/collective.py`` that serving
needs: :class:`Group` (:31), :func:`new_group` (:139),
:func:`destroy_process_group` (:162) and :func:`is_initialized` (:171).
The JAX package has one controller drive every device, so its group is a
mesh axis and a collective an XLA program. Here each rank is a process
of its own, a group wraps a ``torch.distributed`` process group, and
:func:`all_reduce` is a call of that group's backend: NCCL when each
rank has a card of its own, gloo on the CPU or when several ranks share
one card (gloo copies CUDA tensors through the host). The backend is the
caller's choice (``parallel.init_parallel_env``); nothing here picks
one.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["Group", "get_group", "new_group", "destroy_process_group",
           "is_initialized", "all_reduce"]

_groups: dict = {}
_next_gid = 0


class Group:
    """An ordered list of global ranks and the ``torch.distributed``
    process group over them (``process_group``)."""

    def __init__(self, gid: int, ranks: Sequence[int], process_group):
        self.id = gid
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.process_group = process_group
        self.name = f"pg_{gid}"

    @property
    def world_size(self):
        return self.nranks

    @property
    def rank(self) -> int:
        """This process's rank in the group (-1 outside it)."""
        return self.get_group_rank(dist.get_rank())

    def get_group_rank(self, global_rank: int) -> int:
        return (self.ranks.index(global_rank) if global_rank in self.ranks
                else -1)

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


def is_initialized() -> bool:
    """Whether this process has a default ``torch.distributed`` process
    group (``parallel.init_parallel_env`` makes it)."""
    return dist.is_available() and dist.is_initialized()


def _require_init(what):
    if not is_initialized():
        raise RuntimeError(
            f"{what} needs an initialized process group: call "
            "paddle_tpu_torch.distributed.init_parallel_env (or "
            "torch.distributed.init_process_group) in every rank first")


def _ensure_world() -> Group:
    _require_init("the world group")
    world = _groups.get(0)
    if world is None:
        global _next_gid
        world = Group(0, range(dist.get_world_size()), dist.group.WORLD)
        _groups[0] = world
        _next_gid = max(_next_gid, 1)
    return world


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _ensure_world()
    if gid not in _groups:
        raise ValueError(f"Group {gid} is not initialized by new_group")
    return _groups[gid]


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              timeout=None) -> Group:
    """A group over the global ``ranks`` (default: all). Every rank of
    the world must call it with the same arguments, as
    ``torch.distributed.new_group`` requires."""
    global _next_gid
    world = _ensure_world()
    ranks = sorted(world.ranks if ranks is None else ranks)
    for r in ranks:
        if r not in world.ranks:
            raise ValueError(f"rank {r} not in world {world.ranks}")
    pg = dist.new_group(ranks, timeout=timeout, backend=backend)
    g = Group(_next_gid, ranks, pg)
    _groups[g.id] = g
    _next_gid += 1
    return g


def destroy_process_group(group: Optional[Group] = None):
    """Tear down ``group``, or with None every group and the default
    process group."""
    global _next_gid
    if group is None:
        _groups.clear()
        _next_gid = 0
        if is_initialized():
            dist.destroy_process_group()
        return
    _groups.pop(group.id, None)
    if group.id != 0 and is_initialized():
        dist.destroy_process_group(group.process_group)


def _process_group(group):
    if group is None:
        return _ensure_world().process_group
    if isinstance(group, Group):
        return group.process_group
    return group            # a torch.distributed process group


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over the ranks of ``group`` (a :class:`Group`, a
    ``torch.distributed`` process group, or None for the world), in
    place, and return it. ``all_reduce.calls`` counts the calls and
    ``all_reduce.seconds`` sums the host time the sums block for. Gloo
    first waits for the device work queued before a CUDA tensor's sum;
    that wait is taken here, before the sum, and summed apart in
    ``all_reduce.wait_seconds``, so ``seconds`` holds the collective
    alone."""
    _require_init("all_reduce")
    pg = _process_group(group)
    t0 = time.perf_counter()
    if tensor.is_cuda and dist.get_backend(pg) == "gloo":
        torch.cuda.current_stream(tensor.device).synchronize()
    t1 = time.perf_counter()
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=pg)
    all_reduce.seconds += time.perf_counter() - t1
    all_reduce.wait_seconds += t1 - t0
    all_reduce.calls += 1
    return tensor


all_reduce.calls = 0
all_reduce.seconds = 0.0
all_reduce.wait_seconds = 0.0
