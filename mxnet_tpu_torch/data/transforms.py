"""On-device augment and normalize: ship uint8, transform where compute is.

Counterpart of ``mxnet_tpu/data/transforms.py``.  A host pipeline that
casts to float32 before the copy to the card moves 4x the bytes.
``DeviceTransform`` inverts that: the source ships raw uint8 pixels
(``ImageRecordIter(dtype="uint8")``, or a ``DataLoader`` over uint8
images) and crop / mirror / normalize run on the card after the copy, as
the :class:`~mxnet_tpu_torch.data.prefetch.DevicePrefetcher`
``transform=`` hook, so the work also overlaps the previous step.

Compile-freeze contract (the serving bucket lattice's): one entry per
``(batch_shape, dtype)`` lattice point; after :meth:`freeze` a miss
raises.  The function runs eagerly at every call, on the caller's
current stream (the prefetcher's feeder stream), and returns a fresh
tensor: the crop offsets and flips are computed on the device from the
step, so no call reads the card from the host.  A CUDA graph of it was
measured and saves nothing a step can see (PERF.md, PR 16).

Determinism: the augmentation draws are a counter-based hash on the
device, Philox-4x32-10 keyed by ``seed`` over the counter (sample, step)
(:mod:`mxnet_tpu_torch.serving.sampling`), so the same (seed, step) crops
and mirrors identically after a resume.  The bits differ from the JAX
package's ``fold_in`` draws by design; the law (uniform offsets, fair
flips) and the determinism are the contract.
"""
from __future__ import annotations

from typing import Optional

import numpy as onp
import torch

from .. import base as _base
from ..context import resolve_device
from ..serving.sampling import philox4x32

__all__ = ["DeviceTransform"]

_MASK = 0xFFFFFFFF


def augment_draws(seed: int, step, n: int, spans, device):
    """Per-sample crop offsets and flips for ``step`` (an int, or an
    int64 tensor of shape (1,)): ``spans`` = (rows, cols) is how many offsets
    each axis allows.  Returns (oy, ox, flip) int64 tensors of shape
    (n,): word 0 of the Philox block picks the row offset, word 1 the
    column offset (each by a multiply-shift of the 32-bit word, which is
    uniform to 2**-32), word 2's top bit the flip."""
    c0 = torch.arange(n, dtype=torch.int64, device=device)
    if isinstance(step, torch.Tensor):
        step = step.to(device, torch.int64).reshape(-1)[:1]
        c1, c2 = (step & _MASK).expand(n), ((step >> 32) & _MASK).expand(n)
    else:
        c1, c2 = (torch.full((n,), (int(step) >> s) & _MASK,
                             dtype=torch.int64, device=device)
                  for s in (0, 32))
    zero = torch.zeros_like(c0)
    w0, w1, w2, _w3 = philox4x32(c0, c1, c2, zero, seed & _MASK,
                                 (seed >> 32) & _MASK)
    rows, cols = spans
    return (w0 * rows) >> 32, (w1 * cols) >> 32, w2 >> 31


class DeviceTransform:
    """uint8 → float crop / mirror / normalize on the device.

    Parameters
    ----------
    mean, std : float or per-channel sequence, optional
        Normalization applied after the cast to ``dtype``
        (``(x - mean) / std``), along the channel axis.
    crop : int, optional
        Output spatial size: a random ``crop x crop`` window per sample
        (offsets are computed on the device; a new step never
        recompiles).
    mirror : bool
        Random per-sample horizontal flip.
    layout : "NCHW" | "NHWC"
        Axis convention of the incoming batch.
    dtype : str
        Compute/output dtype (default float32).
    seed : int
        Root of the per-step augmentation draws.
    out_layout : "NCHW" | "NHWC", optional
        Axis convention of the result (default: ``layout``).  An NHWC
        result is contiguous, which is channels-last memory for a
        channels-last network: its first convolution needs no
        transpose.

    A tensor or NDArray batch is transformed on its own device; a host
    array on the current context's.
    """

    def __init__(self, mean=None, std=None, crop: Optional[int] = None,
                 mirror: bool = False, layout: str = "NCHW",
                 dtype: str = "float32", seed: int = 0,
                 out_layout: Optional[str] = None):
        for name, lay in (("layout", layout), ("out_layout", out_layout)):
            if lay not in ("NCHW", "NHWC") and not (
                    name == "out_layout" and lay is None):
                raise _base.MXNetError(
                    f"DeviceTransform {name} must be NCHW or NHWC, "
                    f"got {lay!r}")
        if crop is not None and crop < 1:
            raise _base.MXNetError(f"crop must be >= 1, got {crop}")
        self._mean = mean
        self._std = std
        self._crop = crop
        self._mirror = bool(mirror)
        self._layout = layout
        self._out_layout = out_layout or layout
        self._dtype = _base.torch_dtype(dtype)
        self._seed = int(seed)
        self._points: set = set()
        self._const_cache: dict = {}
        self._frozen = False
        # axis positions for (H, W) under the input layout
        self._h, self._w = (2, 3) if layout == "NCHW" else (1, 2)

    # ------------------------------------------------------------ lattice
    @property
    def compile_count(self) -> int:
        """Distinct (shape, dtype) points met so far."""
        return len(self._points)

    def freeze(self):
        """No further compiles: a new lattice point now raises.  Call
        after warmup, like the serving engine's bucket freeze."""
        self._frozen = True
        return self

    def _transform(self, x, step):
        """The function of one lattice point: ``x`` (N, ...) uint8 (or
        any dtype) in ``layout``, ``step`` an int (or an int64 (1,)
        tensor on ``x``'s device, as a graph of this function takes it)."""
        n = x.shape[0]
        h, w = x.shape[self._h], x.shape[self._w]
        crop = self._crop
        hwc = x if self._layout == "NHWC" else x.permute(0, 2, 3, 1)
        if crop is not None or self._mirror:
            ch, cw = (crop, crop) if crop is not None else (h, w)
            rows, cols = self._windows(step, n, (h, w), (ch, cw), x.device)
            hwc = hwc[torch.arange(n, device=x.device)[:, None, None],
                      rows[:, :, None], cols[:, None, :]]
        y = hwc.to(self._dtype, copy=True)       # normalized in place
        mean, std = self._consts(x.device)
        if mean is not None:
            y.sub_(mean)
        if std is not None:
            y.div_(std)
        if self._out_layout == "NCHW":
            y = y.permute(0, 3, 1, 2)
        return y.contiguous()

    def _windows(self, step, n, hw, chw, device):
        """Each sample's window for ``step``: its rows (n, ch) and its
        columns (n, cw, reversed where it is mirrored), int64 on
        ``device``."""
        (h, w), (ch, cw) = hw, chw
        oy, ox, flip = augment_draws(self._seed, step, n,
                                     (h - ch + 1, w - cw + 1), device)
        if self._crop is None:
            oy, ox = torch.zeros_like(oy), torch.zeros_like(ox)
        if not self._mirror:
            flip = torch.zeros_like(flip)
        rows = oy[:, None] + torch.arange(ch, device=device)[None]
        cols = torch.arange(cw, device=device)[None]
        cols = ox[:, None] + torch.where(flip[:, None].bool(),
                                         cw - 1 - cols, cols)
        return rows, cols

    def _consts(self, device):
        """mean and std as tensors on ``device`` along the last (channel)
        axis, made once."""
        got = self._const_cache.get(device)
        if got is None:
            got = self._const_cache[device] = tuple(
                None if v is None else
                torch.as_tensor(onp.asarray(v, onp.float32)).to(
                    device, self._dtype)
                for v in (self._mean, self._std))
        return got

    def _enter(self, x):
        key = (tuple(x.shape), str(x.dtype).replace("torch.", ""))
        if key not in self._points:
            if self._frozen:
                raise _base.MXNetError(
                    f"DeviceTransform is frozen but batch point "
                    f"{key} was never warmed — a compile would land "
                    "on the training loop")
            self._points.add(key)

    # -------------------------------------------------------------- apply
    def apply(self, x, step: int):
        """Transform one image batch for global ``step`` (deterministic
        in (seed, step)).  Accepts tensors, NDArrays or host arrays;
        returns a tensor of ``dtype`` on the batch's device (host
        arrays: the current context's)."""
        from ..ndarray import NDArray
        if isinstance(x, NDArray):
            x = x.tensor
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(onp.ascontiguousarray(x)).to(
                resolve_device(None))
        if x.dim() != 4:
            raise _base.MXNetError(
                f"DeviceTransform expects a 4-d image batch "
                f"({self._layout}), got shape {tuple(x.shape)}")
        if self._crop is not None and (
                x.shape[self._h] < self._crop
                or x.shape[self._w] < self._crop):
            raise _base.MXNetError(
                f"crop={self._crop} larger than input "
                f"{tuple(x.shape)} ({self._layout})")
        self._enter(x)
        return self._transform(x, int(step))

    def __call__(self, data, labels, step: int):
        """:class:`DevicePrefetcher` transform hook: augment the first
        data array (the image tensor), pass labels through."""
        from ..ndarray import NDArray
        if not data:
            return data, labels
        first = data[0]
        y = self.apply(first, step)
        out = NDArray(y) if isinstance(first, NDArray) else y
        return (out,) + tuple(data[1:]), tuple(labels)

    def stats(self) -> dict:
        return {"compiles": self.compile_count,
                "frozen": self._frozen,
                "points": sorted(str(k) for k in self._points)}

    def __repr__(self):
        return (f"DeviceTransform(crop={self._crop}, "
                f"mirror={self._mirror}, layout={self._layout!r}, "
                f"compiles={self.compile_count}, frozen={self._frozen})")
