"""Batched and multi-device quantization: the one-GPU batch engine, and the
rank mesh, halo exchange, sharded fitness, multi-process runtime and
sharded batch API over `torch.distributed` (the JAX package's `parallel`)."""

from .mesh import (
    DATA_AXIS,
    PIXEL_AXIS,
    POP_AXIS,
    Mesh,
    make_mesh,
    batch_image_sharding,
    batch_state_sharding,
    replicated,
)
from .population import shard_population
from .halo import conv1d_vertical_sharded, exchange_row_halos
from .sharded import (
    build_sharded_fns,
    make_strip_fitness,
    scielab_filter_strip,
    strip_scielab,
)
from .fast import build_sharded_fast_fns, plan_fast
from .batch import BatchQuantizer, ShardedBatchQuantizer

__all__ = [
    "DATA_AXIS",
    "PIXEL_AXIS",
    "POP_AXIS",
    "Mesh",
    "shard_population",
    "make_mesh",
    "batch_image_sharding",
    "batch_state_sharding",
    "replicated",
    "conv1d_vertical_sharded",
    "exchange_row_halos",
    "build_sharded_fns",
    "build_sharded_fast_fns",
    "plan_fast",
    "make_strip_fitness",
    "scielab_filter_strip",
    "strip_scielab",
    "BatchQuantizer",
    "ShardedBatchQuantizer",
]
