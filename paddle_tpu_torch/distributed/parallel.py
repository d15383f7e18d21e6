"""The parallel environment over ``torch.distributed``: the subset of
``paddle_tpu/distributed/parallel.py`` (``init_parallel_env`` :71,
``get_rank`` :96, ``get_world_size`` :107) that tensor-parallel serving
needs.

The JAX package has one controller per host and reads the launcher's
environment. Here every rank is a process that calls
:func:`init_parallel_env` with its address, world size, rank and backend
itself: nothing on a machine tells a program of its cluster, and the
backend is the caller's choice (NCCL, one card a rank; gloo, on the CPU
or for several ranks on one card).
"""
from __future__ import annotations

import torch.distributed as dist

from . import collective as _coll

__all__ = ["init_parallel_env", "get_rank", "get_world_size"]


def init_parallel_env(*, backend, init_method, world_size, rank,
                      timeout=None):
    """Bring up this process's default process group and return the
    world :class:`~.collective.Group`. ``init_method`` is a
    ``tcp://host:port`` or ``file://`` address all ranks share;
    ``timeout`` (a ``datetime.timedelta``) bounds every collective and
    the rendezvous, so a rank that dies makes the others fail instead of
    hang."""
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "build of PyTorch")
    if not _coll.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, init_method=init_method,
                                world_size=int(world_size), rank=int(rank),
                                **kw)
    return _coll._ensure_world()


def get_rank(group=None) -> int:
    """This process's global rank, or its rank in ``group`` (a
    :class:`~.collective.Group` or a process group); 0 without a process
    group."""
    if not _coll.is_initialized():
        return 0
    return dist.get_rank(None if group is None
                         else _coll._process_group(group))


def get_world_size(group=None) -> int:
    """The number of ranks of the world, or of ``group``; 1 without a
    process group."""
    if not _coll.is_initialized():
        return 1
    return dist.get_world_size(None if group is None
                               else _coll._process_group(group))
