"""``mx.image`` — imperative image utilities (counterpart of
``mxnet_tpu/image/__init__.py``; parity: python/mxnet/image/image.py).

PIL-backed, as the reference (no OpenCV): images are HWC NDArrays.  The
decode, the resizes, the crops and every augmenter are host work, so
their arrays live on ``mx.cpu()``, as the ``io`` iterators' batches do
(the consumer ships a batch to the card: the trainer's step or
``data.DevicePrefetcher``).  The random draws are the reference's, from
Python's ``random`` and numpy's global generator, in the same order, so
under the same seeds the uint8 stages give the same bytes and the float
stages the same values (the same numpy arithmetic).
"""
from __future__ import annotations

import io as _io
import os
import random as _pyrandom
from typing import List

import numpy as onp

from .. import base as _base
from ..context import cpu as _cpu
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import NDArray, array as _nd_array
from ..utils import colorspace as _colorspace


def nd_array(a) -> NDArray:
    """A host image array: an NDArray on ``mx.cpu()``."""
    return _nd_array(a, ctx=_cpu())


__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "random_size_crop", "color_normalize",
           "HorizontalFlipAug", "RandomCropAug", "CenterCropAug", "ResizeAug",
           "ForceResizeAug", "ColorNormalizeAug", "CastAug",
           "CreateAugmenter", "Augmenter", "ImageIter",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "ColorJitterAug", "LightingAug", "RandomGrayAug",
           "RandomOrderAug", "imrotate", "copyMakeBorder", "scale_down",
           "parse_lst_line"]


def parse_lst_line(line):
    """Parse one im2rec .lst line 'idx\tlabel...\tpath' →
    (path, label-or-list) or None for malformed lines (single source for
    ImageIter / ImageListDataset / tools)."""
    parts = line.strip().split("\t")
    if len(parts) < 3:
        return None
    labels = [float(x) for x in parts[1:-1]]
    return parts[-1], (labels[0] if len(labels) == 1 else labels)


def _to_pil(img):
    from PIL import Image
    if isinstance(img, NDArray):
        img = img.asnumpy()
    return Image.fromarray(onp.asarray(img).astype(onp.uint8))


def _from_pil(pil) -> NDArray:
    return nd_array(onp.asarray(pil, dtype=onp.uint8))


def imread(filename, flag=1, to_rgb=True) -> NDArray:
    from PIL import Image
    pil = Image.open(filename)
    pil = pil.convert("RGB" if flag else "L")
    arr = onp.asarray(pil)
    if not to_rgb and flag:
        arr = arr[..., ::-1]
    return nd_array(arr)


def imdecode(buf, flag=1, to_rgb=True) -> NDArray:
    from PIL import Image
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    pil = Image.open(_io.BytesIO(bytes(buf)))
    pil = pil.convert("RGB" if flag else "L")
    arr = onp.asarray(pil)
    if not to_rgb and flag:
        arr = arr[..., ::-1]
    return nd_array(arr)


def imresize(src, w, h, interp=1) -> NDArray:
    from PIL import Image
    interp_map = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                  3: Image.NEAREST, 4: Image.LANCZOS}
    pil = _to_pil(src).resize((w, h), interp_map.get(interp, Image.BILINEAR))
    return _from_pil(pil)


def resize_short(src, size, interp=2) -> NDArray:
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2) -> NDArray:
    arr = src.asnumpy() if isinstance(src, NDArray) else onp.asarray(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp)
    return nd_array(out)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(*area) * src_area
        log_ratio = (onp.log(ratio[0]), onp.log(ratio[1]))
        aspect = onp.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round((target_area * aspect) ** 0.5))
        new_h = int(round((target_area / aspect) ** 0.5))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None) -> NDArray:
    arr = src.asnumpy().astype(onp.float32) \
        if isinstance(src, NDArray) else onp.asarray(src, onp.float32)
    mean = mean.asnumpy() if isinstance(mean, NDArray) else onp.asarray(mean)
    arr = arr - mean
    if std is not None:
        std = std.asnumpy() if isinstance(std, NDArray) else onp.asarray(std)
        arr = arr / std
    return nd_array(arr)


# ------------------------------------------------------------- augmenters

class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        return src

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__, self._kwargs])


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            arr = src.asnumpy() if isinstance(src, NDArray) else src
            return nd_array(onp.ascontiguousarray(arr[:, ::-1]))
        return src


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


def _jitter(src, fn):
    arr = src.asnumpy().astype(onp.float32) \
        if isinstance(src, NDArray) else onp.asarray(src, onp.float32)
    return nd_array(fn(arr))


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + onp.random.uniform(-self.brightness, self.brightness)
        return _jitter(src, lambda a: a * alpha)


class ContrastJitterAug(Augmenter):
    _coef = _colorspace.GRAY_COEF

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + onp.random.uniform(-self.contrast, self.contrast)
        def f(a):
            gray = (a @ self._coef).mean()
            return a * alpha + gray * (1.0 - alpha)
        return _jitter(src, f)


class SaturationJitterAug(Augmenter):
    _coef = _colorspace.GRAY_COEF

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + onp.random.uniform(-self.saturation, self.saturation)
        def f(a):
            gray = (a @ self._coef)[..., None]
            return a * alpha + gray * (1.0 - alpha)
        return _jitter(src, f)


class HueJitterAug(Augmenter):
    _t_yiq = _colorspace.T_YIQ
    _t_rgb = _colorspace.T_RGB

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = onp.random.uniform(-self.hue, self.hue) * onp.pi
        u, w = onp.cos(alpha), onp.sin(alpha)
        rot = onp.array([[1, 0, 0], [0, u, -w], [0, w, u]], onp.float32)
        m = self._t_rgb @ rot @ self._t_yiq
        return _jitter(src, lambda a: a @ m.T)


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (parity: RandomOrderAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        """Serialize self plus children (upstream RandomOrderAug.dumps)."""
        import json
        return json.dumps([self.__class__.__name__,
                           [json.loads(t.dumps()) for t in self.ts]])

    def __call__(self, src):
        for i in onp.random.permutation(len(self.ts)):
            src = self.ts[i](src)
        return src


class ColorJitterAug(RandomOrderAug):
    """Random-order brightness/contrast/saturation jitter (parity:
    image.ColorJitterAug is a RandomOrderAug upstream too)."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness:
            ts.append(BrightnessJitterAug(brightness))
        if contrast:
            ts.append(ContrastJitterAug(contrast))
        if saturation:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA-based lighting noise (AlexNet-style; parity: image.LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd,
                         eigval=onp.asarray(eigval).tolist(),
                         eigvec=onp.asarray(eigvec).tolist())
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval, onp.float32)
        self.eigvec = onp.asarray(eigvec, onp.float32)

    def __call__(self, src):
        alpha = onp.random.normal(0, self.alphastd, 3).astype(onp.float32)
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _jitter(src, lambda a: a + rgb)


class RandomGrayAug(Augmenter):
    _coef = _colorspace.GRAY_COEF_IMAGE   # upstream image.py matrix

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if onp.random.uniform() < self.p:
            def f(a):
                return onp.repeat((a @ self._coef)[..., None], 3, axis=-1)
            return _jitter(src, f)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (parity: mx.image.CreateAugmenter)."""
    auglist: List[Augmenter] = []
    crop_size = (data_shape[2], data_shape[1])
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    if rand_resize:
        auglist.append(Augmenter())  # placeholder slot, below picks crop
        auglist[-1] = RandomCropAug(crop_size, inter_method)
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise,
                                   _colorspace.IMAGENET_PCA_EIGVAL,
                                   _colorspace.IMAGENET_PCA_EIGVEC))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


def imrotate(src, rotation_degrees, zoom_in=False, zoom_out=False):
    """Rotate image(s) by the given degrees (parity: image.imrotate —
    upstream contract is CHW / NCHW tensors; HWC also accepted when the
    last dim is 1/3 channels).  Nearest-neighbor sampling, zero fill.
    ``zoom_in`` crops away the black corners, ``zoom_out`` shrinks so the
    whole rotated frame fits (exclusive, like upstream)."""
    if zoom_in and zoom_out:
        raise ValueError("zoom_in and zoom_out are exclusive")
    arr = src.asnumpy() if isinstance(src, NDArray) else onp.asarray(src)
    if arr.ndim == 4:                                   # NCHW
        out = onp.stack([
            imrotate(a, rotation_degrees, zoom_in, zoom_out).asnumpy()
            for a in arr])
        return nd_array(out)
    if arr.ndim == 3 and arr.shape[-1] in (1, 3) \
            and arr.shape[0] not in (1, 3):
        hwc = arr                                        # HWC
        chw = False
    else:                                                # CHW (upstream)
        hwc = onp.transpose(arr, (1, 2, 0))
        chw = True
    theta = onp.deg2rad(float(rotation_degrees))
    h, w = hwc.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    scale = abs(onp.cos(theta)) + abs(onp.sin(theta))
    s = 1.0
    if zoom_in:
        s = 1.0 / scale        # sample a smaller source window: no corners
    elif zoom_out:
        s = scale              # sample a larger window: everything fits
    yy, xx = onp.meshgrid(onp.arange(h), onp.arange(w), indexing="ij")
    # inverse rotation mapping (scaled about the center)
    ys = cy + s * ((yy - cy) * onp.cos(theta) - (xx - cx) * onp.sin(theta))
    xs = cx + s * ((yy - cy) * onp.sin(theta) + (xx - cx) * onp.cos(theta))
    yi = onp.round(ys).astype(onp.int64)
    xi = onp.round(xs).astype(onp.int64)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = onp.zeros_like(hwc)
    out[valid] = hwc[yi[valid], xi[valid]]
    if chw:
        out = onp.transpose(out, (2, 0, 1))
    return nd_array(out)


def copyMakeBorder(src, top, bot, left, right, type=0, value=0):  # noqa: A002
    """Pad an HWC image (parity: the cv2-backed mx.image.copyMakeBorder).
    type 0 = constant, 1 = replicate edge; other border types raise."""
    arr = src.asnumpy() if isinstance(src, NDArray) else onp.asarray(src)
    pw = ((top, bot), (left, right)) + ((0, 0),) * (arr.ndim - 2)
    if type == 0:
        out = onp.pad(arr, pw, mode="constant", constant_values=value)
    elif type == 1:
        out = onp.pad(arr, pw, mode="edge")
    else:
        raise NotImplementedError(f"border type {type} not supported")
    return nd_array(out)


def scale_down(src_size, size):
    """Scale (w, h) down to fit within src_size keeping aspect (parity:
    image.scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


class ImageIter(DataIter):
    """Python-side augmenting image iterator (parity: mx.image.ImageIter):
    reads RecordIO (path_imgrec) or an .lst + image dir (path_imglist)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in ("resize", "rand_crop",
                                                    "rand_mirror", "mean",
                                                    "std")})
        self.shuffle = shuffle
        self._items = []       # (label, payload-or-path, is_raw)
        if path_imgrec:
            from ..recordio import MXRecordIO, unpack
            rec = MXRecordIO(path_imgrec, "r")
            while True:
                r = rec.read()
                if r is None:
                    break
                hdr, payload = unpack(r)
                self._items.append((hdr.label, payload, True))
            rec.close()
        elif path_imglist or imglist is not None:
            rows = []
            if path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        rows.append(parts)
            else:
                rows = [[str(i)] + [str(x) for x in r[:-1]] + [r[-1]]
                        for i, r in enumerate(imglist)]
            for parts in rows:
                label = onp.array([float(x) for x in parts[1:-1]],
                                  dtype=onp.float32)
                if label.size == 1:
                    label = float(label[0])
                self._items.append(
                    (label, os.path.join(path_root, parts[-1]), False))
        else:
            raise _base.MXNetError(
                "ImageIter needs path_imgrec, path_imglist or imglist")
        self._order = onp.arange(len(self._items))
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shp)]

    def reset(self):
        if self.shuffle:
            onp.random.shuffle(self._order)
        self._pos = 0

    def next(self):
        if self._pos + self.batch_size > len(self._items):
            raise StopIteration
        datas, labels = [], []
        for i in self._order[self._pos:self._pos + self.batch_size]:
            label, src, is_raw = self._items[i]
            img = imdecode(src) if is_raw else imread(src)
            for aug in self.auglist:
                img = aug(img)
            arr = img.asnumpy().astype(onp.float32)
            datas.append(arr.transpose(2, 0, 1))  # HWC → CHW
            labels.append(label)
        self._pos += self.batch_size
        return DataBatch([nd_array(onp.stack(datas))],
                         [nd_array(onp.asarray(labels, onp.float32))])


# detection pipeline (parity: python/mxnet/image/detection.py) — imported
# last so it can reuse the augmenter/iterator machinery above
from .detection import (CreateDetAugmenter, DetAugmenter,  # noqa: E402
                        DetBorrowAug, DetHorizontalFlipAug,
                        DetRandomCropAug, DetRandomPadAug,
                        DetRandomSelectAug, ImageDetIter)
__all__ += ["CreateDetAugmenter", "DetAugmenter", "DetBorrowAug",
            "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
            "DetRandomSelectAug", "ImageDetIter"]
