"""Detection image pipeline (counterpart of
``mxnet_tpu/image/detection.py``; parity: python/mxnet/image/detection.py
— ImageDetIter and the Det* augmenter family).

Label convention matches upstream: a record's label vector is
``[header_width, obj_width, <header...>, (cls, x1, y1, x2, y2, ...)*N]``
with corner coordinates normalized to [0, 1].  Geometric augmenters
transform image and boxes together; the iterator pads every batch to a
fixed max-objects count (-1-filled rows), so a batch's shape is the
same at every step (one CUDA-graph signature downstream).  Host work: its
arrays live on ``mx.cpu()``, as :mod:`mxnet_tpu_torch.image`'s.
"""
from __future__ import annotations

import random as _pyrandom
from typing import List, Optional

import numpy as onp

from .. import base as _base
from ..io import DataBatch, DataDesc
from ..ndarray import NDArray
from . import (Augmenter, CreateAugmenter, ImageIter, imdecode, imresize,
               fixed_crop, nd_array)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomPadAug", "DetRandomSelectAug",
           "CreateDetAugmenter", "ImageDetIter"]


# ------------------------------------------------------------- augmenters

class DetAugmenter:
    """Base detection augmenter: __call__(src, label) -> (src, label)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src, label):
        return src, label

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__, self._kwargs])


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only augmenter (color jitter, cast, …) — the label
    passes through untouched (parity: detection.py DetBorrowAug)."""

    def __init__(self, augmenter: Augmenter):
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image AND boxes with probability p."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() < self.p:
            arr = src.asnumpy() if isinstance(src, NDArray) else src
            src = nd_array(onp.ascontiguousarray(arr[:, ::-1]))
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop constrained to keep objects (parity:
    DetRandomCropAug's min_object_covered / area_range contract; boxes are
    clipped to the crop and objects whose center falls outside drop)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.05, 1.0), max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _coverage(self, boxes, x0, y0, x1, y1):
        ix0 = onp.maximum(boxes[:, 1], x0)
        iy0 = onp.maximum(boxes[:, 2], y0)
        ix1 = onp.minimum(boxes[:, 3], x1)
        iy1 = onp.minimum(boxes[:, 4], y1)
        inter = onp.clip(ix1 - ix0, 0, None) * onp.clip(iy1 - iy0, 0, None)
        area = (boxes[:, 3] - boxes[:, 1]) * (boxes[:, 4] - boxes[:, 2])
        return inter / onp.maximum(area, 1e-12)

    def __call__(self, src, label):
        arr = src.asnumpy() if isinstance(src, NDArray) else src
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            area = _pyrandom.uniform(*self.area_range)
            ratio = _pyrandom.uniform(*self.aspect_ratio_range)
            cw = min(1.0, (area * ratio) ** 0.5)
            ch = min(1.0, (area / ratio) ** 0.5)
            x0 = _pyrandom.uniform(0, 1 - cw)
            y0 = _pyrandom.uniform(0, 1 - ch)
            x1, y1 = x0 + cw, y0 + ch
            if label.size:
                cov = self._coverage(label, x0, y0, x1, y1)
                if cov.max(initial=0.0) < self.min_object_covered:
                    continue
                cx = (label[:, 1] + label[:, 3]) / 2
                cy = (label[:, 2] + label[:, 4]) / 2
                keep = (cx > x0) & (cx < x1) & (cy > y0) & (cy < y1)
                if not keep.any():
                    continue
                new = label[keep].copy()
                new[:, 1] = onp.clip((new[:, 1] - x0) / cw, 0, 1)
                new[:, 3] = onp.clip((new[:, 3] - x0) / cw, 0, 1)
                new[:, 2] = onp.clip((new[:, 2] - y0) / ch, 0, 1)
                new[:, 4] = onp.clip((new[:, 4] - y0) / ch, 0, 1)
            else:
                new = label
            px0, py0 = int(x0 * w), int(y0 * h)
            pw, ph = max(1, int(cw * w)), max(1, int(ch * h))
            return fixed_crop(nd_array(arr), px0, py0, pw, ph), new
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Expand the canvas (zoom out) and re-normalize boxes (parity:
    DetRandomPadAug; SSD-style small-object augmentation)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.pad_val = pad_val
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        arr = src.asnumpy() if isinstance(src, NDArray) else src
        h, w = arr.shape[:2]
        expand = _pyrandom.uniform(*self.area_range)
        if expand <= 1.0:
            return src, label
        ratio = _pyrandom.uniform(*self.aspect_ratio_range)
        nw = min(int(w * (expand * ratio) ** 0.5), int(w * expand))
        nh = min(int(h * (expand / ratio) ** 0.5), int(h * expand))
        nw, nh = max(nw, w), max(nh, h)
        ox = _pyrandom.randint(0, nw - w)
        oy = _pyrandom.randint(0, nh - h)
        canvas = onp.empty((nh, nw, arr.shape[2]), arr.dtype)
        canvas[...] = onp.asarray(self.pad_val, arr.dtype)[:arr.shape[2]]
        canvas[oy:oy + h, ox:ox + w] = arr
        if label.size:
            label = label.copy()
            label[:, 1] = (label[:, 1] * w + ox) / nw
            label[:, 3] = (label[:, 3] * w + ox) / nw
            label[:, 2] = (label[:, 2] * h + oy) / nh
            label[:, 4] = (label[:, 4] * h + oy) / nh
        return nd_array(canvas), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly apply one augmenter from a list (or skip, parity:
    DetRandomSelectAug)."""

    def __init__(self, aug_list: List[DetAugmenter], skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return _pyrandom.choice(self.aug_list)(src, label)


class _DetForceResize(DetAugmenter):
    """Resize to exactly (w, h): normalized boxes are scale-invariant."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src, label):
        return imresize(src, self.size[0], self.size[1],
                        self.interp), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, hue=0,
                       pca_noise=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       pad_val=(127, 127, 127)):
    """Standard detection augmenter list (parity: CreateDetAugmenter).

    rand_crop / rand_pad are probabilities of applying the respective
    geometric augmenter.
    """
    auglist: List[DetAugmenter] = []
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])), max_attempts,
                              pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    auglist.append(_DetForceResize((data_shape[2], data_shape[1]),
                                   inter_method))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # photometric / cast / normalize ride the classification augmenters
    for aug in CreateAugmenter(data_shape, mean=mean, std=std,
                               brightness=brightness, contrast=contrast,
                               saturation=saturation, hue=hue,
                               pca_noise=pca_noise,
                               inter_method=inter_method)[1:]:
        # [0] is the crop/center-crop slot — geometry is handled above
        auglist.append(DetBorrowAug(aug))
    return auglist


# --------------------------------------------------------------- iterator

class ImageDetIter(ImageIter):
    """Detection iterator (parity: mx.image.ImageDetIter): labels are
    variable-length object lists padded to a static (max_objects, 5+)
    tensor per image — -1 class ids mark padding rows (one batch shape
    at every step)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None, **kwargs):
        ik = {k: v for k, v in kwargs.items()
              if k in ("resize", "rand_crop", "rand_pad", "rand_mirror",
                       "mean", "std", "min_object_covered", "area_range",
                       "aspect_ratio_range", "brightness", "contrast",
                       "saturation", "pad_val")}
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **ik)
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle,
                         aug_list=[], imglist=imglist)
        self.det_auglist = aug_list
        # normalize stored labels to (N, obj_width) object arrays and find
        # the padded width
        parsed = []
        self._obj_width = 5
        for lab, src, is_raw in self._items:
            objs = self._parse_label(lab)
            self._obj_width = max(self._obj_width, objs.shape[1])
            parsed.append(objs)
        self._max_objects = max((p.shape[0] for p in parsed), default=1)
        self._items = [(p, src, is_raw)
                       for p, (_, src, is_raw) in zip(parsed, self._items)]

    @staticmethod
    def _parse_label(label):
        """[header_width, obj_width, <header...>, objs...] → (N,
        obj_width)."""
        raw = onp.asarray(label, onp.float32).ravel()
        if raw.size < 2:
            return onp.zeros((0, 5), onp.float32)
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if obj_width < 5 or header_width < 2 or raw.size < header_width:
            raise _base.MXNetError(
                f"malformed detection label (header_width={header_width}, "
                f"obj_width={obj_width}, len={raw.size})")
        body = raw[header_width:]
        n = body.size // obj_width
        return body[:n * obj_width].reshape(n, obj_width).copy()

    @property
    def provide_label(self):
        return [DataDesc("label",
                         (self.batch_size, self._max_objects,
                          self._obj_width))]

    def next(self):
        if self._pos + self.batch_size > len(self._items):
            raise StopIteration
        datas, labels = [], []
        for i in self._order[self._pos:self._pos + self.batch_size]:
            objs, src, is_raw = self._items[i]
            from . import imread
            img = imdecode(src) if is_raw else imread(src)
            label = objs.copy()
            for aug in self.det_auglist:
                img, label = aug(img, label)
            arr = img.asnumpy().astype(onp.float32)
            datas.append(arr.transpose(2, 0, 1))
            pad = onp.full((self._max_objects, self._obj_width), -1.0,
                           onp.float32)
            n = min(label.shape[0], self._max_objects)
            if n:
                pad[:n, :label.shape[1]] = label[:n]
            labels.append(pad)
        self._pos += self.batch_size
        return DataBatch([nd_array(onp.stack(datas))],
                         [nd_array(onp.stack(labels))],
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
