"""Multi-process bring-up (counterpart of
``mxnet_tpu/parallel/distributed.py``).

The reference joins jax's coordination service; here every process is
one rank of a ``torch.distributed`` process group, rendezvoused over TCP
at the address that ``tools/launch.py`` sets for each worker
(``MXNET_TPU_COORD_ADDR``, ``MXNET_TPU_RANK``, ``MXNET_TPU_NPROCS``).

The backend is explicit and never switched behind the caller's back:
``nccl`` where CUDA is available and ``gloo`` on a host without it,
unless ``backend`` names one.  ``gloo`` on the card is accepted when
asked for (two ranks on one GPU, which NCCL refuses); its transport
stages CUDA tensors through pinned host memory
(:mod:`~mxnet_tpu_torch.parallel.collectives`).  A failed
initialization raises :class:`MXNetError`.  The group gets a finite
timeout (``timeout`` seconds, default ``MXNET_TPU_DIST_TIMEOUT`` or 300),
so a rank whose peer died fails instead of waiting forever.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..base import MXNetError

__all__ = ["init_distributed", "rank", "num_workers", "barrier",
           "backend", "local_device"]

_BACKENDS = ("nccl", "gloo")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[float] = None) -> None:
    """Join the job's process group (idempotent).

    Arguments default from the env set by ``tools/launch.py``; with no
    address and one process, a free local port.  ``backend``: ``'nccl'``
    (default where CUDA is available) or ``'gloo'`` (default on a host
    without CUDA)."""
    if dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("MXNET_TPU_COORD_ADDR")
    if num_processes is None:
        num_processes = int(os.environ.get("MXNET_TPU_NPROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("MXNET_TPU_RANK", "0"))
    if addr is None:
        if num_processes != 1:
            raise MXNetError(
                f"init_distributed: {num_processes} processes need a "
                "coordinator address (MXNET_TPU_COORD_ADDR, set by "
                "tools/launch.py)")
        addr = f"127.0.0.1:{_free_port()}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in _BACKENDS:
        raise MXNetError(f"init_distributed: backend {backend!r} not in "
                         f"{_BACKENDS}")
    if timeout is None:
        timeout = float(os.environ.get("MXNET_TPU_DIST_TIMEOUT", "300"))
    if backend == "nccl":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise MXNetError("init_distributed: backend 'nccl' needs CUDA "
                             "and a torch built with NCCL")
        torch.cuda.set_device(local_device(process_id))
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}", world_size=num_processes,
            rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    except Exception as e:
        raise MXNetError(f"init_distributed: {backend} process group of "
                         f"{num_processes} at {addr} (rank {process_id}) "
                         f"failed: {type(e).__name__}: {e}") from e


def rank() -> int:
    """This process's index (parity: kvstore.rank)."""
    return dist.get_rank() if dist.is_initialized() else 0


def num_workers() -> int:
    """Total processes (parity: kvstore.num_workers)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    """The process group's backend, or None before ``init_distributed``."""
    return dist.get_backend() if dist.is_initialized() else None


def local_device(process_id: Optional[int] = None) -> torch.device:
    """This rank's device: CUDA device ``rank % device_count`` where CUDA
    is available (two gloo ranks share the one card of a one-GPU host),
    else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    r = rank() if process_id is None else process_id
    return torch.device("cuda", r % torch.cuda.device_count())


def barrier(name: str = "mxnet_tpu_barrier") -> None:
    """Block until every process reaches this point (parity: ps-lite
    Postoffice::Barrier); a no-op in a process without a group."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
