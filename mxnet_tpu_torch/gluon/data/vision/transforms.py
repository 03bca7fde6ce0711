"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``).

Numpy-based host-side transforms (the decode/augment stage runs on CPU
before the single batched device upload).
"""
from __future__ import annotations

import numpy as onp

from ....ndarray import NDArray, array
from ....utils import colorspace as _colorspace
from ...block import Block
from ...nn.basic_layers import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomLighting", "RandomColorJitter",
           "RandomHue", "RandomGray", "RandomCrop", "CropResize"]


def _to_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return onp.asarray(x)


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class _NpTransform(Block):
    def forward(self, x):
        return self._apply(_to_numpy(x))

    def _apply(self, x: onp.ndarray):
        raise NotImplementedError


class Cast(_NpTransform):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def _apply(self, x):
        return x.astype(self._dtype)


class ToTensor(_NpTransform):
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def _apply(self, x):
        x = x.astype(onp.float32) / 255.0
        if x.ndim == 3:
            return onp.transpose(x, (2, 0, 1))
        if x.ndim == 2:
            return x[None, :, :]
        return onp.transpose(x, (0, 3, 1, 2))


class Normalize(_NpTransform):
    """(x - mean) / std on CHW float input."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, dtype=onp.float32)
        self._std = onp.asarray(std, dtype=onp.float32)

    def _apply(self, x):
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return (x - mean) / std


def _resize_hwc(x, size, interpolation=1):
    """Dependency-free resize (OpenCV replacement for the pure-python
    path; the C++ pipeline handles JPEG decode+resize).  `interpolation`
    follows the cv2 codes: 0 = nearest, 1 = bilinear (default); other
    codes (cubic/area) fall back to bilinear."""
    if isinstance(size, int):
        size = (size, size)
    w, h = size
    src_h, src_w = x.shape[:2]
    if (src_h, src_w) == (h, w):
        return x
    if interpolation == 0:
        rows = (onp.arange(h) * (src_h / h)).astype(onp.int64) \
            .clip(0, src_h - 1)
        cols = (onp.arange(w) * (src_w / w)).astype(onp.int64) \
            .clip(0, src_w - 1)
        return x[rows][:, cols]
    ry = ((onp.arange(h) + 0.5) * (src_h / h) - 0.5).clip(0, src_h - 1)
    rx = ((onp.arange(w) + 0.5) * (src_w / w) - 0.5).clip(0, src_w - 1)
    y0 = onp.floor(ry).astype(onp.int64)
    x0 = onp.floor(rx).astype(onp.int64)
    y1 = onp.minimum(y0 + 1, src_h - 1)
    x1 = onp.minimum(x0 + 1, src_w - 1)
    wy = (ry - y0).astype(onp.float32)[:, None]
    wx = (rx - x0).astype(onp.float32)[None, :]
    if x.ndim == 3:
        wy, wx = wy[..., None], wx[..., None]
    xf = x.astype(onp.float32)
    top = xf[y0][:, x0] * (1 - wx) + xf[y0][:, x1] * wx
    bot = xf[y1][:, x0] * (1 - wx) + xf[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if onp.issubdtype(x.dtype, onp.integer):
        info = onp.iinfo(x.dtype)
        out = onp.rint(out).clip(info.min, info.max)
    return out.astype(x.dtype)


class Resize(_NpTransform):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._interp = interpolation

    def _apply(self, x):
        return _resize_hwc(x, self._size, self._interp)


class CenterCrop(_NpTransform):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._interp = interpolation

    def _apply(self, x):
        w, h = self._size
        src_h, src_w = x.shape[:2]
        y0 = max(0, (src_h - h) // 2)
        x0 = max(0, (src_w - w) // 2)
        out = x[y0:y0 + h, x0:x0 + w]
        if out.shape[0] != h or out.shape[1] != w:
            out = _resize_hwc(out, (w, h), self._interp)
        return out


class RandomResizedCrop(_NpTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def _apply(self, x):
        src_h, src_w = x.shape[:2]
        area = src_h * src_w
        for _ in range(10):
            target_area = onp.random.uniform(*self._scale) * area
            ar = onp.exp(onp.random.uniform(onp.log(self._ratio[0]),
                                            onp.log(self._ratio[1])))
            w = int(round(onp.sqrt(target_area * ar)))
            h = int(round(onp.sqrt(target_area / ar)))
            if w <= src_w and h <= src_h:
                x0 = onp.random.randint(0, src_w - w + 1)
                y0 = onp.random.randint(0, src_h - h + 1)
                crop = x[y0:y0 + h, x0:x0 + w]
                return _resize_hwc(crop, self._size, self._interp)
        return _resize_hwc(x, self._size, self._interp)


class RandomFlipLeftRight(_NpTransform):
    def _apply(self, x):
        if onp.random.rand() < 0.5:
            return x[:, ::-1].copy()
        return x


class RandomFlipTopBottom(_NpTransform):
    def _apply(self, x):
        if onp.random.rand() < 0.5:
            return x[::-1].copy()
        return x


class RandomBrightness(_NpTransform):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def _apply(self, x):
        alpha = 1.0 + onp.random.uniform(-self._b, self._b)
        return (x * alpha).clip(0, 255 if x.dtype == onp.uint8 else None) \
            .astype(x.dtype)


class RandomContrast(_NpTransform):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def _apply(self, x):
        alpha = 1.0 + onp.random.uniform(-self._c, self._c)
        gray = x.mean()
        return ((x - gray) * alpha + gray).clip(
            0, 255 if x.dtype == onp.uint8 else None).astype(x.dtype)


class RandomSaturation(_NpTransform):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def _apply(self, x):
        alpha = 1.0 + onp.random.uniform(-self._s, self._s)
        gray = x.mean(axis=-1, keepdims=True)
        return ((x - gray) * alpha + gray).clip(
            0, 255 if x.dtype == onp.uint8 else None).astype(x.dtype)


class RandomLighting(_NpTransform):
    _eigval = _colorspace.IMAGENET_PCA_EIGVAL
    _eigvec = _colorspace.IMAGENET_PCA_EIGVEC

    def __init__(self, alpha_std):
        super().__init__()
        self._std = alpha_std

    def _apply(self, x):
        alpha = onp.random.normal(0, self._std, 3)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return (x + rgb).clip(0, 255 if x.dtype == onp.uint8 else None) \
            .astype(x.dtype)


class RandomHue(_NpTransform):
    """Random hue jitter (parity: transforms.RandomHue) — HSV rotation via
    the RGB-space approximation upstream uses (YIQ hue matrix)."""

    # constant color-space matrices (shared source: utils.colorspace)
    _T_YIQ = _colorspace.T_YIQ
    _T_RGB = _colorspace.T_RGB

    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def _apply(self, x):
        alpha = onp.random.uniform(-self._h, self._h) * onp.pi
        dtype = x.dtype
        f = x.astype("float32")
        u, w = onp.cos(alpha), onp.sin(alpha)
        rot = onp.array([[1, 0, 0], [0, u, -w], [0, w, u]], "float32")
        m = self._T_RGB @ rot @ self._T_YIQ
        out = f @ m.T
        return out.clip(0, 255 if dtype == onp.uint8 else None).astype(dtype)


class RandomGray(_NpTransform):
    """With probability p, convert to 3-channel grayscale (parity:
    transforms.RandomGray)."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def _apply(self, x):
        if onp.random.uniform() >= self._p:
            return x
        gray = x.astype("float32") @ _colorspace.GRAY_COEF
        out = onp.repeat(gray[..., None], 3, axis=-1)
        return out.clip(0, 255 if x.dtype == onp.uint8 else None)             .astype(x.dtype)


class RandomCrop(_NpTransform):
    """Random crop with optional padding (parity: transforms.RandomCrop —
    the CIFAR augmentation)."""

    def __init__(self, size, pad=None, pad_value=0, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad
        self._pad_value = pad_value
        self._interp = interpolation

    def _apply(self, x):
        if self._pad:
            p = self._pad
            pw = ((p, p), (p, p)) + ((0, 0),) * (x.ndim - 2)
            x = onp.pad(x, pw, mode="constant",
                        constant_values=self._pad_value)
        w, h = self._size
        src_h, src_w = x.shape[:2]
        if src_h < h or src_w < w:
            return _resize_hwc(x, (w, h), self._interp)
        y0 = onp.random.randint(0, src_h - h + 1)
        x0 = onp.random.randint(0, src_w - w + 1)
        return x[y0:y0 + h, x0:x0 + w]


class CropResize(_NpTransform):
    """Fixed crop then optional resize (parity: transforms.CropResize)."""

    def __init__(self, x0, y0, width, height, size=None, interpolation=1):
        super().__init__()
        self._box = (int(x0), int(y0), int(width), int(height))
        self._size = ((size, size) if isinstance(size, int) else size) \
            if size is not None else None
        self._interp = interpolation

    def _apply(self, x):
        x0, y0, w, h = self._box
        out = x[y0:y0 + h, x0:x0 + w]
        if self._size is not None:
            out = _resize_hwc(out, self._size, self._interp)
        return out


class RandomColorJitter(Compose):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        ts = []
        if brightness:
            ts.append(RandomBrightness(brightness))
        if contrast:
            ts.append(RandomContrast(contrast))
        if saturation:
            ts.append(RandomSaturation(saturation))
        if hue:
            ts.append(RandomHue(hue))
        super().__init__(ts)
