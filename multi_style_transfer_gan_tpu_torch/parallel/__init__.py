"""Data parallelism (port of ``parallel/``): one process per GPU under
torchrun, the gradient and loss all-reduces, the broadcast of a module,
the global batch's blocks, and the batch CLI's local device list; and
height-sharded inference of one image over a list of devices
(``spatial``: ``direct_transform --spatial N``).
"""

from .mesh import (
    active, all_gather_batch, all_reduce_mean_, all_reduce_sum,
    broadcast_module_, close_data_parallel, init_data_parallel, is_writer,
    local_batch_size, local_devices, rank, rank_block, world_size,
)
from .spatial import spatial_apply, spatial_mesh

__all__ = [
    "active", "all_gather_batch", "all_reduce_mean_", "all_reduce_sum",
    "broadcast_module_", "close_data_parallel", "init_data_parallel",
    "is_writer", "local_batch_size", "local_devices", "rank", "rank_block",
    "spatial_apply", "spatial_mesh", "world_size",
]
