"""``gluon.data`` against the JAX package's: datasets, all seven samplers,
``DataLoader``, and ``vision``'s datasets and transforms.

Shuffles draw from numpy (the global state, or ``mx.random.host_rng()``,
which ``mx.random.seed`` reseeds in both packages), so every order is
identical after the same seeds.  The synthetic MNIST/CIFAR surrogates
are numpy ``RandomState`` draws and so bit-identical.  The transforms
are the reference's numpy code: identical outputs from the same numpy
seed (exact; the reference's own transform tests hold 1e-5).
"""
import os

import numpy as onp
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P


def _np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return onp.asarray(x)


def _eq(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
        return
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    onp.testing.assert_array_equal(a, b)


def test_datasets_equal_the_reference(tmp_path):
    x = onp.random.RandomState(0).randn(10, 3).astype("float32")
    y = onp.arange(10)

    def run(mod):
        gd = mod.gluon.data
        out = []
        ds = gd.ArrayDataset(x, y)
        out += [ds[i] for i in range(len(ds))]
        out.append(gd.ArrayDataset(x)[3])
        t = ds.transform(lambda a, b: (a * 2, b + 1))
        out += [t[i] for i in (0, 9)]
        out += [ds.transform_first(lambda a: a - 1, lazy=False)[4]]
        out += [ds.filter(lambda s: s[1] % 3 == 0)[i] for i in range(4)]
        out += [ds.take(2)[1], gd.SimpleDataset(list(range(5)))[4]]
        out += [ds.sample(gd.IntervalSampler(10, 3))[i] for i in range(10)]
        return out

    ref, got = run(R), run(P)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        _eq(a, b)
    # RecordFileDataset over a file each package wrote
    p = str(tmp_path / "r.rec")
    w = P.recordio.MXIndexedRecordIO(str(tmp_path / "r.idx"), p, "w")
    for i in range(6):
        w.write_idx(i, P.recordio.pack(P.recordio.IRHeader(0, i, i, 0),
                                       bytes([i]) * (i + 3)))
    w.close()
    rd, pd = R.gluon.data.RecordFileDataset(p), \
        P.gluon.data.RecordFileDataset(p)
    assert len(rd) == len(pd) == 6
    assert [rd[i] for i in range(6)] == [pd[i] for i in range(6)]


def _sampler_orders(mod):
    gd = mod.gluon.data
    onp.random.seed(3)
    mod.random.seed(9)
    lengths = list(onp.random.RandomState(4).randint(3, 40, 57))
    out = {
        "sequential": list(gd.SequentialSampler(7, start=2)),
        "random": list(gd.RandomSampler(13)),
        "filter": list(gd.FilterSampler(lambda v: v % 2, list(range(9)))),
        "interval": list(gd.IntervalSampler(10, 3)),
        "interval_no_roll": list(gd.IntervalSampler(10, 3, rollover=False)),
        "bucket_global": list(gd.FixedBucketSampler(
            lengths, 6, num_buckets=4, shuffle=True)),
        "bucket_global_2": list(gd.FixedBucketSampler(
            lengths, 6, num_buckets=4, shuffle=True)),
        "bucket_seeded": list(gd.FixedBucketSampler(
            lengths, 5, shuffle=True, seed=12, bucket_keys=[10, 20, 40])),
    }
    for last in ("keep", "discard", "rollover"):
        bs = gd.BatchSampler(gd.SequentialSampler(11), 4, last)
        out[f"batch_{last}"] = [list(bs), list(bs), len(bs)]
    fb = gd.FixedBucketSampler(lengths, 6, num_buckets=4)
    out["bucket_meta"] = [fb.bucket_keys, fb.stats(), len(fb)]
    return out


def test_every_sampler_orders_like_the_reference():
    ref, got = _sampler_orders(R), _sampler_orders(P)
    assert set(ref) == set(got) and len(ref) == 12
    for k in ref:
        assert ref[k] == got[k], k


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_equals_the_reference(workers):
    x = onp.random.RandomState(1).randint(0, 255, (23, 4, 4, 3)).astype(
        "uint8")
    y = onp.random.RandomState(2).randn(23).astype("float64")

    def run(mod, **kw):
        onp.random.seed(17)
        ds = mod.gluon.data.ArrayDataset(x, y)
        out = []
        for last in ("keep", "discard", "rollover"):
            dl = mod.gluon.data.DataLoader(ds, batch_size=5, shuffle=True,
                                           last_batch=last,
                                           num_workers=workers, **kw)
            out += [(len(dl),)] + [tuple(_np(b)) for b in dl]
        nd_ds = mod.gluon.data.SimpleDataset(
            [mod.nd.array(x[i], ctx=mod.cpu()) for i in range(6)])
        out += [(_np(b),) for b in mod.gluon.data.DataLoader(
            nd_ds, batch_size=4, num_workers=workers, **kw)]
        return out

    ref, got = run(R), run(P, pin_memory=True, timeout=30)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        _eq(a, b)


@pytest.mark.parametrize("name,cls_kw", [
    ("MNIST", {}), ("MNIST", {"train": False}), ("FashionMNIST", {}),
    ("CIFAR10", {}), ("CIFAR100", {"train": False})])
def test_synthetic_vision_datasets_are_bit_identical(tmp_path, name, cls_kw):
    root = str(tmp_path / "none")               # no raw files: surrogate
    r = getattr(R.gluon.data.vision, name)(root=root, **cls_kw)
    p = getattr(P.gluon.data.vision, name)(root=root, **cls_kw)
    assert r.synthetic and p.synthetic and len(r) == len(p)
    _eq(r._data, p._data)
    _eq(r._label, p._label)
    _eq(r[5], p[5])
    tp = getattr(P.gluon.data.vision, name)(
        root=root, transform=lambda im: im.astype("float32") / 255, **cls_kw)
    tr = getattr(R.gluon.data.vision, name)(
        root=root, transform=lambda im: im.astype("float32") / 255, **cls_kw)
    _eq(tr[7], tp[7])


def test_image_folder_record_and_list_datasets(tmp_path):
    from PIL import Image
    rs = onp.random.RandomState(0)
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / "folder" / c)
        for i in range(2):
            onp.save(tmp_path / "folder" / c / f"{i}.npy",
                     rs.randint(0, 255, (5, 6, 3)).astype("uint8"))
    img = rs.randint(0, 255, (8, 9, 3)).astype("uint8")
    Image.fromarray(img).save(tmp_path / "a.png")
    with open(tmp_path / "list.lst", "w") as f:
        f.write("0\t2.0\ta.png\n1\t1.0\t3.0\ta.png\nbad line\n")
    rec = str(tmp_path / "i.rec")
    w = P.recordio.MXIndexedRecordIO(str(tmp_path / "i.idx"), rec, "w")
    for i in range(3):
        w.write_idx(i, P.recordio.pack_img(
            P.recordio.IRHeader(0, float(i), i, 0), img, img_fmt=".png"))
    w.close()

    def run(mod):
        v = mod.gluon.data.vision
        f = v.ImageFolderDataset(str(tmp_path / "folder"))
        out = [f.synsets, [f[i] for i in range(len(f))]]
        r = v.ImageRecordDataset(rec)
        out.append([r[i] for i in range(len(r))])
        lst = v.ImageListDataset(str(tmp_path), str(tmp_path / "list.lst"))
        out.append([(_np(lst[i][0]), lst[i][1]) for i in range(len(lst))])
        mem = v.ImageListDataset(str(tmp_path), [(4.0, "a.png")])
        out.append(_np(mem[0][0]))
        return out

    ref, got = run(R), run(P)
    assert ref[0] == got[0]
    for a, b in zip(ref[1:], got[1:]):
        _eq(a, b)


def _transforms(mod):
    T = mod.gluon.data.vision.transforms
    return [
        ("Compose", T.Compose([T.Resize(12), T.CenterCrop(10), T.ToTensor()])),
        ("Cast", T.Cast("float16")), ("ToTensor", T.ToTensor()),
        ("Normalize", T.Compose([T.ToTensor(),
                                 T.Normalize((0.4, 0.5, 0.6), (0.2, 0.3,
                                                               0.4))])),
        ("NormalizeScalar", T.Normalize(0.5, 0.25)),
        ("Resize", T.Resize((11, 9))), ("ResizeNearest", T.Resize(7, 0)),
        ("CenterCrop", T.CenterCrop(9)), ("CenterCropUp", T.CenterCrop(30)),
        ("RandomResizedCrop", T.RandomResizedCrop(8)),
        ("RandomFlipLeftRight", T.RandomFlipLeftRight()),
        ("RandomFlipTopBottom", T.RandomFlipTopBottom()),
        ("RandomBrightness", T.RandomBrightness(0.4)),
        ("RandomContrast", T.RandomContrast(0.4)),
        ("RandomSaturation", T.RandomSaturation(0.4)),
        ("RandomLighting", T.RandomLighting(0.2)),
        ("RandomColorJitter", T.RandomColorJitter(0.3, 0.3, 0.3, 0.1)),
        ("RandomHue", T.RandomHue(0.2)), ("RandomGray", T.RandomGray(0.7)),
        ("RandomCrop", T.RandomCrop(10, pad=2)),
        ("CropResize", T.CropResize(2, 3, 10, 8, size=6)),
    ]


def test_all_eighteen_transforms_equal_the_reference():
    img = onp.random.RandomState(5).randint(0, 255, (20, 24, 3)).astype(
        "uint8")
    fimg = img.astype("float32")
    names = set()
    for (name, rt), (_n, pt) in zip(_transforms(R), _transforms(P)):
        cls = type(pt).__name__
        names.add(cls)
        for x in (img, fimg):
            onp.random.seed(31)
            a = _np(rt(x))
            onp.random.seed(31)
            b = _np(pt(x))
            _eq(a, b)
        assert type(rt).__name__ == cls, name
    assert len(names) == 18
    assert set(names) == set(P.gluon.data.vision.transforms.__all__)


def test_colorspace_constants_equal_the_reference():
    from mxnet_tpu.utils import colorspace as rc
    from mxnet_tpu_torch.utils import colorspace as pc
    for n in ("T_YIQ", "T_RGB", "GRAY_COEF", "GRAY_COEF_IMAGE",
              "IMAGENET_PCA_EIGVAL", "IMAGENET_PCA_EIGVEC"):
        _eq(getattr(rc, n), getattr(pc, n))
