"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; MXNet's MNIST, FashionMNIST,
CIFAR10/100, ImageFolderDataset, ImageRecordDataset, ImageListDataset).

This environment has no network egress, so the auto-download path of upstream
is replaced by: (a) load from `root` if the standard raw files exist, else
(b) a DETERMINISTIC synthetic surrogate with the same shapes/classes (clearly
marked via `.synthetic`), so training/convergence tests run hermetically.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp

from ..dataset import ArrayDataset, Dataset

__all__ = ["ImageListDataset", "MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset"]


def _synthetic_images(num, shape, num_classes, seed, proto_seed):
    """Separable class-conditional image blobs: class prototypes are drawn
    from `proto_seed` (SHARED between train and test splits so a model can
    generalize); noise/labels from `seed`.  Deterministic."""
    h, w = shape[:2]
    c = shape[2] if len(shape) > 2 else 1
    protos = onp.random.RandomState(proto_seed).rand(
        num_classes, h, w, c) * 180
    rng = onp.random.RandomState(seed)
    labels = onp.arange(num) % num_classes
    rng.shuffle(labels)
    imgs = protos[labels] + rng.randn(num, h, w, c) * 25
    imgs = imgs.clip(0, 255).astype(onp.uint8)
    if len(shape) == 2:
        imgs = imgs[..., 0]
    return imgs, labels.astype(onp.int32)


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self.synthetic = False
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx]), self._label[idx]
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """28×28×1 grayscale, 10 classes (parity: gluon.data.vision.MNIST)."""

    _train_files = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _test_files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")
    _shape = (28, 28, 1)
    _classes = 10
    _synth_n = (6000, 1000)

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        img_path = os.path.join(self._root, files[0])
        lbl_path = os.path.join(self._root, files[1])
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = onp.frombuffer(f.read(), dtype=onp.uint8) \
                    .astype(onp.int32)
            with gzip.open(img_path, "rb") as f:
                _, num, rows, cols = struct.unpack(">IIII", f.read(16))
                data = onp.frombuffer(f.read(), dtype=onp.uint8) \
                    .reshape(num, rows, cols, 1)
            self._data, self._label = data, label
        else:
            n = self._synth_n[0] if self._train else self._synth_n[1]
            self._data, self._label = _synthetic_images(
                n, self._shape, self._classes,
                seed=42 if self._train else 43, proto_seed=1234)
            self.synthetic = True


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    _shape = (32, 32, 3)
    _classes = 10
    _synth_n = (5000, 1000)

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"), train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _file_list(self):
        if self._train:
            return [f"data_batch_{i}.bin" for i in range(1, 6)]
        return ["test_batch.bin"]

    def _get_data(self):
        paths = [os.path.join(self._root, "cifar-10-batches-bin", f)
                 for f in self._file_list()]
        if all(os.path.exists(p) for p in paths):
            data, label = [], []
            for p in paths:
                raw = onp.fromfile(p, dtype=onp.uint8).reshape(-1, 3073)
                label.append(raw[:, 0].astype(onp.int32))
                data.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                            .transpose(0, 2, 3, 1))
            self._data = onp.concatenate(data)
            self._label = onp.concatenate(label)
        else:
            n = self._synth_n[0] if self._train else self._synth_n[1]
            self._data, self._label = _synthetic_images(
                n, self._shape, self._classes,
                seed=44 if self._train else 45, proto_seed=5678)
            self.synthetic = True


class CIFAR100(CIFAR10):
    _classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"), train=True,
                 transform=None, fine_label=True):
        super().__init__(root, train, transform)


class ImageFolderDataset(Dataset):
    """Images arranged in per-class folders.  Requires PIL-free decodable
    formats (ppm/pgm/npy) or torch-vision-decodable files via torchvision if
    present; falls back to numpy .npy files."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        path, label = self.items[idx]
        img = _decode_image(path)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


def _decode_image(path):
    if path.endswith(".npy"):
        return onp.load(path)
    try:
        from PIL import Image  # optional
        return onp.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        raise IOError(
            f"cannot decode {path}: install the native decode pipeline or "
            "use .npy files")


class ImageRecordDataset(Dataset):
    """Dataset over an image RecordIO pack (parity: ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        record = self._record[idx]
        header, img = unpack_img(record)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageListDataset(Dataset):
    """Dataset over an im2rec-style .lst file, or an in-memory list whose
    entries are (label..., path) — the mx.image.ImageIter imglist order —
    rooted at ``root`` (parity: vision.ImageListDataset)."""

    def __init__(self, root=".", imglist=None, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.items = []
        if isinstance(imglist, str):
            with open(imglist) as f:
                for line in f:
                    parsed = _parse_lst_line(line)
                    if parsed is None:
                        continue
                    path, label = parsed
                    self.items.append(
                        (os.path.join(self._root, path), label))
        elif imglist is not None:
            for entry in imglist:
                # (label..., path): path LAST, like ImageIter's imglist
                path = entry[-1]
                labels = list(entry[:-1])
                label = labels[0] if len(labels) == 1 else labels
                self.items.append((os.path.join(self._root, path), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        import numpy as _np

        path, label = self.items[idx]
        img = _imread(path, self._flag)
        label = _np.float32(label) if not isinstance(label, list) \
            else _np.asarray(label, _np.float32)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


def _parse_lst_line(line):
    """One im2rec ``.lst`` line ``idx\tlabel...\tpath`` → (path,
    label-or-list), or None for a malformed line (the reference's
    ``image.parse_lst_line``)."""
    parts = line.strip().split("\t")
    if len(parts) < 3:
        return None
    labels = [float(x) for x in parts[1:-1]]
    return parts[-1], (labels[0] if len(labels) == 1 else labels)


def _imread(filename, flag=1):
    """An HWC uint8 NDArray on ``mx.cpu()`` decoded by PIL, RGB or
    grayscale by ``flag`` (the reference's ``image.imread``)."""
    from PIL import Image

    from ....context import cpu
    from ....ndarray import array
    pil = Image.open(filename).convert("RGB" if flag else "L")
    return array(onp.asarray(pil), ctx=cpu())
