"""ctypes bindings and lazy build of the native IO library (libmxtpu_io).

Counterpart of the IO half of ``mxnet_tpu/utils/native.py``: MXNet's
C++ data plane (dmlc RecordIO framing, the threaded JPEG decode and
augment pipeline of ``src/io/iter_image_recordio_2.cc``).  The library
is compiled from ``mxnet_tpu_torch/native/mxtpu_io.cc`` by
``g++ -O3 -std=c++17 -shared -fPIC -pthread ... -ljpeg`` at first use
(plain C ABI, no pybind) into ``build/native/`` at the repository root,
named by a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  A build compiles to a
temporary name and renames it into place, so processes that build at
once never load a half-written file.

``available()`` means "built and loadable": without ``g++`` or libjpeg,
or with ``MXNET_TPU_NO_NATIVE=1`` in the environment, it is False and
the consumers (``io.ImageRecordIter``) take their pure-Python path.  A
caller that asks for the native path itself (:class:`NativeRecordWriter`,
:class:`NativeImagePipeline`) gets an ``MXNetError`` carrying the
compiler's output instead.

Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as onp

from ..base import MXNetError
# one lock and one witness site (``native.build``, the reference's name)
# for every native build of the package: the CUDA kernels' and this one
from .native import _LOCK as _lock

__all__ = ["available", "get_lib", "build", "scan_record_offsets",
           "NativeRecordWriter", "NativeImagePipeline", "SOURCE",
           "BUILD_DIR"]

SOURCE = Path(__file__).resolve().parents[1] / "native" / "mxtpu_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LIBS = ("-ljpeg",)

_lib = None
_error: Optional[str] = None      # why the build or load failed, once


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    return BUILD_DIR / f"libmxtpu_io-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if it is not built yet and return its path;
    raises ``MXNetError`` with the compiler's output if ``g++`` fails."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(SOURCE), "-o", str(tmp), *_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise MXNetError(f"native IO build failed: {' '.join(cmd)}: "
                         f"{e}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f"native IO build failed (g++ exit "
                         f"{proc.returncode}): {' '.join(cmd)}\n"
                         f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib):
    lib.mxio_writer_open.restype = ctypes.c_void_p
    lib.mxio_writer_open.argtypes = [ctypes.c_char_p]
    lib.mxio_writer_tell.restype = ctypes.c_int64
    lib.mxio_writer_tell.argtypes = [ctypes.c_void_p]
    lib.mxio_writer_write.restype = ctypes.c_int
    lib.mxio_writer_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.mxio_writer_close.argtypes = [ctypes.c_void_p]
    lib.mxio_scan.restype = ctypes.c_int64
    lib.mxio_scan.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))]
    lib.mxio_free.argtypes = [ctypes.c_void_p]
    lib.mxio_pipe_open.restype = ctypes.c_void_p
    lib.mxio_pipe_open.argtypes = [
        ctypes.c_char_p,
        onp.ctypeslib.ndpointer(onp.uint64, flags="C_CONTIGUOUS"),
        onp.ctypeslib.ndpointer(onp.uint64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        onp.ctypeslib.ndpointer(onp.float32, flags="C_CONTIGUOUS"),
        onp.ctypeslib.ndpointer(onp.float32, flags="C_CONTIGUOUS"),
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.mxio_pipe_schedule.argtypes = [
        ctypes.c_void_p,
        onp.ctypeslib.ndpointer(onp.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_uint64]
    lib.mxio_pipe_next.restype = ctypes.c_int64
    lib.mxio_pipe_next.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        onp.ctypeslib.ndpointer(onp.float32, flags="C_CONTIGUOUS"),
        onp.ctypeslib.ndpointer(onp.float32, flags="C_CONTIGUOUS"),
        onp.ctypeslib.ndpointer(onp.uint8, flags="C_CONTIGUOUS")]
    lib.mxio_pipe_close.argtypes = [ctypes.c_void_p]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it at the first call; None
    when disabled (``MXNET_TPU_NO_NATIVE``) or unbuildable (one attempt
    a process)."""
    global _lib, _error
    if _lib is not None or os.environ.get("MXNET_TPU_NO_NATIVE"):
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (MXNetError, OSError) as e:
            _error = str(e)
            return None
        _declare(lib)
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library is built and loadable."""
    return get_lib() is not None


def _require():
    lib = get_lib()
    if lib is None:
        why = ("MXNET_TPU_NO_NATIVE is set"
               if os.environ.get("MXNET_TPU_NO_NATIVE") else _error)
        raise MXNetError(f"native IO library unavailable: {why}")
    return lib


# ------------------------------------------------------------------ API


def scan_record_offsets(path):
    """(offsets, lengths) uint64 arrays of LOGICAL records, natively
    scanned; None if the library is unavailable.

    Single-frame records: (payload offset, payload length).  Multipart
    records (dmlc cflag chains): bit 63 of the length is set, the offset
    points at the FIRST FRAME HEADER and the length (bit 63 masked off)
    spans every frame through the last frame's payload — reassemble with
    :func:`mxnet_tpu_torch.recordio.reassemble_span`.
    """
    lib = get_lib()
    if lib is None:
        return None
    po = ctypes.POINTER(ctypes.c_uint64)()
    pl = ctypes.POINTER(ctypes.c_uint64)()
    n = lib.mxio_scan(str(path).encode(), ctypes.byref(po), ctypes.byref(pl))
    if n < 0:
        return None
    offs = onp.ctypeslib.as_array(po, shape=(n,)).copy() if n else \
        onp.zeros(0, onp.uint64)
    lens = onp.ctypeslib.as_array(pl, shape=(n,)).copy() if n else \
        onp.zeros(0, onp.uint64)
    lib.mxio_free(po)
    lib.mxio_free(pl)
    return offs, lens


class NativeRecordWriter:
    """Sequential RecordIO writer running in C (same framing as
    :class:`mxnet_tpu_torch.recordio.MXRecordIO`)."""

    def __init__(self, path):
        lib = _require()
        self._lib = lib
        self._h = lib.mxio_writer_open(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def tell(self):
        return self._lib.mxio_writer_tell(self._h)

    def write(self, buf: bytes):
        if self._lib.mxio_writer_write(self._h, buf, len(buf)):
            raise OSError("record write failed")

    def close(self):
        if self._h:
            self._lib.mxio_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class NativeImagePipeline:
    """Threaded pread + JPEG decode + augment pipeline over a RecordIO
    file (parity: src/io/iter_image_recordio_2.cc).  Yields NCHW float32
    batches in deterministic schedule order; records the C side could not
    decode are flagged so the caller can re-decode them in Python."""

    def __init__(self, path, offsets, lengths, data_shape, resize=-1,
                 rand_crop=False, rand_mirror=False,
                 mean=(0., 0., 0.), std=(1., 1., 1.), seed=0,
                 label_width=1, threads=4, capacity=None):
        if capacity is None:   # MXNET_TPU_PREFETCH: decoded-sample buffer
            capacity = int(os.environ.get("MXNET_TPU_PREFETCH", 256))
        lib = _require()
        c, h, w = data_shape
        if c != 3:
            raise ValueError("native pipeline is RGB-only (C=3)")
        self._lib = lib
        self._shape = (3, h, w)
        self._label_width = label_width
        offs = onp.ascontiguousarray(offsets, onp.uint64)
        lens = onp.ascontiguousarray(lengths, onp.uint64)
        self._seed = int(seed) & (2 ** 64 - 1)
        self._epoch = 0
        self._h = lib.mxio_pipe_open(
            str(path).encode(), offs, lens, len(offs), int(threads), h, w,
            int(resize), int(bool(rand_crop)), int(bool(rand_mirror)),
            onp.asarray(mean, onp.float32), onp.asarray(std, onp.float32),
            self._seed, int(label_width), int(capacity))
        if not self._h:
            raise OSError(f"cannot open {path}")

    def schedule(self, order, seed=None):
        order = onp.ascontiguousarray(order, onp.int64)
        self._epoch += 1
        if seed is None:
            seed = (self._seed + 0x10001 * self._epoch) & (2 ** 64 - 1)
        self._lib.mxio_pipe_schedule(self._h, order, len(order), seed)

    def next_batch(self, batch_size):
        """(data (B,3,H,W) f32, labels (B,label_width) f32, ok (B,) bool,
        n_filled)."""
        c, h, w = self._shape
        data = onp.empty((batch_size, c, h, w), onp.float32)
        labels = onp.empty((batch_size, self._label_width), onp.float32)
        ok = onp.empty((batch_size,), onp.uint8)
        n = self._lib.mxio_pipe_next(self._h, batch_size, data, labels, ok)
        return data, labels, ok.astype(bool), int(n)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.mxio_pipe_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
