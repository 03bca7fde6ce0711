"""mxnet_tpu_torch.data — the device half of the input pipeline
(counterpart of ``mxnet_tpu.data``).

``io.py`` stops at host memory: its iterators decode and batch on CPU
threads and hand out NDArrays on ``mx.cpu()``.  This package takes them
to the card:

- :class:`~mxnet_tpu_torch.data.prefetch.DevicePrefetcher` — a feeder
  thread keeps a bounded ring (depth >= 1) of batches already on the
  card, copied from page-locked memory on its own stream while the
  current step computes; the consumer's stream waits on each batch's
  event, with no host synchronization.
- :class:`~mxnet_tpu_torch.data.sharded_loader.ShardedLoader` —
  deterministic global-batch loading for the one-device layout (the
  multi-host split is ROADMAP queue A6).
- :class:`~mxnet_tpu_torch.data.transforms.DeviceTransform` — ship raw
  uint8 pixels and crop / mirror / normalize on the card, one CUDA graph
  per (shape, dtype) lattice point, with the serving lattice's
  compile-freeze contract.

Fault sites ``data.prefetch`` / ``data.device_put`` / ``data.bad_shard``
degrade to a synchronous load / a retried copy / a quarantined skip —
never a lost batch — and the stack stays bit-identical through
``ResilientLoop`` kill/resume (offset replay through
:meth:`DevicePrefetcher.state_dict`).
"""

from .prefetch import DevicePrefetcher
from .sharded_loader import ShardedLoader, host_batch_rows, assemble_global
from .transforms import DeviceTransform

__all__ = ["DevicePrefetcher", "ShardedLoader", "DeviceTransform",
           "host_batch_rows", "assemble_global"]
