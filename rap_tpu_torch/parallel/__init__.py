"""Several GPUs over torch.distributed (counterpart of rap_tpu/parallel)."""

from .distributed import initialize, process_group, process_slice, slice_local_batch
from .mesh import Mesh, make_mesh, shard_batch

__all__ = ["Mesh", "initialize", "make_mesh", "process_group", "process_slice",
           "shard_batch", "slice_local_batch"]
