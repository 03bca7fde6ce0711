"""Training over devices (counterpart of ``mxnet_tpu.parallel``): the
mesh of ranks, sharding rules, process-group bring-up, explicit
collectives and ``ShardedTrainer`` over data (``dp``) and sequence
(``sp``) parallelism, one process per rank.  Tensor, expert and
pipeline parallelism (``gpipe``) are ROADMAP queue A6."""
from .distributed import barrier, init_distributed, num_workers, rank
from .mesh import AXES, Mesh, axis_size, current_mesh, make_mesh, use_mesh
from .sharding import (DEFAULT_RULES, NamedSharding, PartitionSpec,
                       ShardingRules, annotate, batch_spec, divisible_spec,
                       global_batch_sharding, logical_axes_of,
                       param_sharding, shard_params)
from .trainer import ShardedTrainer

__all__ = [
    "AXES", "Mesh", "NamedSharding", "PartitionSpec", "ShardingRules",
    "ShardedTrainer", "annotate", "axis_size", "barrier", "batch_spec",
    "current_mesh", "divisible_spec", "global_batch_sharding",
    "init_distributed", "logical_axes_of", "make_mesh", "num_workers",
    "param_sharding", "rank", "shard_params", "use_mesh",
    "with_sharding_constraint", "DEFAULT_RULES",
]


def with_sharding_constraint(x, *logical_axes, mesh=None, rules=None):
    """The identity.  The reference pins an activation's layout for GSPMD
    inside a traced computation; under SPMD in each process the layout is
    explicit (each rank holds its own rows and sequence chunk), so there
    is nothing to pin.  A divergence by design (ROADMAP queue C)."""
    return x
