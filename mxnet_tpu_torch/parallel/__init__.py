"""Training over devices (counterpart of ``mxnet_tpu.parallel``): this
slice ports ``ShardedTrainer`` on one device."""
from .trainer import ShardedTrainer

__all__ = ["ShardedTrainer"]
