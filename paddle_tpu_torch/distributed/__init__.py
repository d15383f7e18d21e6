"""``distributed`` of the port: activation recompute (``fleet``), the
parallel environment and process groups over ``torch.distributed``, and
the sum all-reduce that tensor-parallel serving runs."""
from .collective import (Group, all_reduce, destroy_process_group,
                         get_group, is_initialized, new_group)
from .parallel import get_rank, get_world_size, init_parallel_env

__all__ = ["Group", "all_reduce", "destroy_process_group", "get_group",
           "is_initialized", "new_group", "init_parallel_env", "get_rank",
           "get_world_size"]
