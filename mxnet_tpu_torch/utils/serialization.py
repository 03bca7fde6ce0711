"""The ``MXTPU1`` parameter container, read and written with numpy only
(counterpart of ``mxnet_tpu/utils/serialization.py``), so parameter
files cross between the two packages.

Layout: the magic ``MXTPU1\\n``, a little-endian u64 header length, a
JSON header ``{"keyed": bool, "arrays": [{"name", "shape", "dtype",
"nbytes"}, ...]}``, then the raw payloads in header order.  bfloat16
payloads are stored as their uint16 bit patterns under the dtype name
``"bfloat16"``.  numpy has no bfloat16, so :func:`load` widens them to
float32, which is exact (a bf16 value is the top half of an f32).
"""
from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Dict

import numpy as np
import torch

from ..resilience.faults import inject as _inject

MAGIC = b"MXTPU1\n"

__all__ = ["MAGIC", "save", "load"]


def _payload(arr):
    """(dtype name, shape, bytes) of a numpy array or torch tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return "bfloat16", list(t.shape), bits.tobytes()
        arr = t.numpy()
    a = np.ascontiguousarray(arr)
    return str(a.dtype), list(a.shape), a.tobytes()


def save(fname: str, data: Dict[str, object], tee=None):
    """Write ``data`` (name → numpy array or tensor) atomically: the
    container is assembled in a temp file beside ``fname`` and committed
    with one ``os.replace`` (the ``serialization.commit`` fault site sits
    right before it), so a kill mid-write leaves an existing ``fname``
    untouched.

    ``tee`` (an object with ``update(bytes)``, e.g.
    :class:`~mxnet_tpu_torch.resilience.integrity.TreeHasher`) observes
    every byte in write order, so a checkpoint manifest digests the file
    in the same pass that writes it."""
    metas, blobs = [], []
    for name, arr in data.items():
        dtype_name, shape, payload = _payload(arr)
        metas.append({"name": name, "shape": shape, "dtype": dtype_name,
                      "nbytes": len(payload)})
        blobs.append(payload)
    header = json.dumps({"keyed": True, "arrays": metas}).encode()
    dirname = os.path.dirname(os.path.abspath(fname))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(fname) + ".tmp-",
                               dir=dirname)
    try:
        # mkstemp creates 0600: keep an existing target's mode, else 0644
        try:
            mode = os.stat(fname).st_mode & 0o777
        except OSError:
            mode = 0o644
        os.fchmod(fd, mode)
        with os.fdopen(fd, "wb") as f:
            for piece in (MAGIC, struct.pack("<Q", len(header)), header,
                          *blobs):
                f.write(piece)
                if tee is not None:
                    tee.update(piece)
            f.flush()
            os.fsync(f.fileno())
        _inject("serialization.commit")
        os.replace(tmp, fname)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load(fname: str) -> Dict[str, np.ndarray]:
    """Read a container into a name → ``np.ndarray`` dict.  bfloat16
    entries come back as exact float32."""
    with open(fname, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise IOError(f"{fname}: not an MXTPU1 parameter file")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode())
        out = {}
        for meta in header["arrays"]:
            raw = f.read(meta["nbytes"])
            if meta["dtype"] == "bfloat16":
                bits = np.frombuffer(raw, dtype=np.uint16)
                a = (bits.astype(np.uint32) << 16).view(np.float32)
            else:
                a = np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).copy()
            out[meta["name"]] = a.reshape(meta["shape"])
    return out
