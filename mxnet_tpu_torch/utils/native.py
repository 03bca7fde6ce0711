"""Build and load the port's CUDA kernels.

Each source ``mxnet_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Libraries are built at first use from the sources in the checkout into
``build/kernels/`` at the repository root, named by a hash of the
source, every shared header (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and a stale library is never
loaded.  :func:`build` starts one ``nvcc`` per source, all at once,
and waits for them.  A build holds a thread lock and a file lock
(``build/kernels/.lock``), so two processes of one job (the ranks that
``tools/launch.py`` starts) never write the same library at once: the
second finds it built.

Nothing here runs at import time: the CPU tests import every module,
and this host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from ..analysis.lockwitness import named_lock as _named_lock
from ..base import MXNetError

__all__ = ["KERNELS", "BUILD_DIR", "build", "load", "build_log",
           "stream_ptr"]

#: every kernel source of the package, by name (csrc/<name>.cu)
KERNELS = ("flash_fwd", "flash_bwd", "flash_dq_ring", "paged_attention")

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = _named_lock("native.build", "one-shot kernel library builds")
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own lookup: $CUDA_HOME, then the toolkit's default prefix
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise MXNetError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                     "to build the CUDA kernels")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """What ``nvcc``/``ptxas`` printed for ``name`` (registers, shared
    memory and spills per kernel), or '' if it was not built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str] = KERNELS) -> float:
    """Build every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds it
    took; raises with the compiler's output if any build fails."""
    t0 = time.monotonic()
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            _build_locked(names)
    return time.monotonic() - t0


def _build_locked(names):
    """Start an ``nvcc`` for each library not built yet and wait."""
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + out.with_suffix(".log").read_text())
    if failed:
        raise MXNetError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it first if
    needed.  The caller declares ``argtypes``/``restype``."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build((name,))
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LOADED[name] = lib
    return lib


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``: every
    kernel launches on it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
