"""``mx.image`` of the port against the JAX package's, on the CPU.

The cases of ``tests/test_image_detection.py`` and the image tests of
``tests/test_amp_profiler_image.py``, each run by both packages from the
same seeds (Python's ``random`` and numpy's global generator, which both
packages' augmenters draw from): uint8 stages must give the same bytes,
float stages the same values within 1e-6 (the same numpy arithmetic on
the host), and the port's arrays live on ``mx.cpu()``.
"""
import random

import numpy as onp
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu_torch import image as PI
from mxnet_tpu import image as RI

TOL = 1e-6


def _det_label(objs, header_width=4, obj_width=5):
    head = [float(header_width), float(obj_width), 0.0, 0.0]
    return onp.asarray(head + [v for o in objs for v in o], onp.float32)


def _write_det_rec(mod, path, n=6, seed=0):
    rs = onp.random.RandomState(seed)
    wr = mod.recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = rs.randint(0, 255, (48 + 4 * i, 64, 3), dtype=onp.uint8)
        objs = [[i % 3, 0.1, 0.2, 0.6, 0.7]]
        if i % 2:
            objs.append([1.0, 0.3, 0.3, 0.9, 0.8])
        lab = _det_label(objs)
        wr.write(mod.recordio.pack_img(mod.recordio.IRHeader(
            len(lab), lab, i, 0), img, quality=90))
    wr.close()


def _write_cls_rec(path, n=12, size=40, seed=0):
    rs = onp.random.RandomState(seed)
    wr = P.recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = rs.randint(0, 256, (size, size + 8, 3), dtype=onp.uint8)
        wr.write(P.recordio.pack_img(P.recordio.IRHeader(0, float(i % 4),
                                                         i, 0), img,
                                     quality=90))
    wr.close()


def _seeded(seed):
    random.seed(seed)
    onp.random.seed(seed)


def _batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]


def _same_batches(got, want, tol=TOL):
    assert len(got) == len(want) and got
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd.shape == wd.shape and gd.dtype == wd.dtype
        onp.testing.assert_allclose(gd, wd, rtol=0, atol=tol)
        onp.testing.assert_array_equal(gl, wl)


def test_the_rec_files_of_both_packages_are_the_same_bytes(tmp_path):
    a, b = str(tmp_path / "p.rec"), str(tmp_path / "r.rec")
    _write_det_rec(P, a)
    _write_det_rec(R, b)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_det_iter_shapes_and_padding(tmp_path):
    p = str(tmp_path / "det.rec")
    _write_det_rec(P, p)
    its = [m.ImageDetIter(batch_size=3, data_shape=(3, 32, 32),
                          path_imgrec=p) for m in (PI, RI)]
    got, want = next(iter(its[0])), next(iter(its[1]))
    data, label = got.data[0], got.label[0].asnumpy()
    assert data.shape == (3, 3, 32, 32) and label.shape == (3, 2, 5)
    assert data.context == P.cpu()
    assert label[0, 0, 0] == 0.0 and (label[0, 1] == -1.0).all()
    onp.testing.assert_allclose(data.asnumpy(), want.data[0].asnumpy(),
                                atol=TOL, rtol=0)
    onp.testing.assert_array_equal(label, want.label[0].asnumpy())


@pytest.mark.parametrize("aug", ["flip", "crop", "pad"])
def test_det_augmenters_match_the_reference(aug):
    rs = onp.random.RandomState(1)
    img = rs.randint(0, 255, (64, 48, 3)).astype("uint8")
    label = onp.array([[2, 0.25, 0.25, 0.75, 0.75],
                       [1, 0.1, 0.5, 0.3, 0.9]], onp.float32)
    make = {"flip": lambda m: m.DetHorizontalFlipAug(p=1.0),
            "crop": lambda m: m.DetRandomCropAug(min_object_covered=0.5,
                                                 area_range=(0.5, 1.0)),
            "pad": lambda m: m.DetRandomPadAug(area_range=(2.0, 2.0))}[aug]
    out = []
    for m, mx in ((PI, P), (RI, R)):
        _seeded(3)
        with P.cpu():
            o, lab = make(m)(mx.nd.array(img), label.copy())
        out.append((o.asnumpy(), lab))
    onp.testing.assert_array_equal(out[0][0], out[1][0])
    onp.testing.assert_allclose(out[0][1], out[1][1], atol=1e-7)
    if aug == "flip":
        onp.testing.assert_allclose(out[0][1][0], [2, 0.25, 0.25, 0.75,
                                                   0.75], atol=1e-6)
    if aug == "pad":
        lab = out[0][1]
        assert (lab[:, 3] - lab[:, 1] < 0.5).all()


def test_create_det_augmenter_pipeline(tmp_path):
    p = str(tmp_path / "det2.rec")
    _write_det_rec(P, p, seed=5)
    res = []
    for m in (PI, RI):
        _seeded(7)
        augs = m.CreateDetAugmenter((3, 24, 24), rand_crop=0.5, rand_pad=0.5,
                                    rand_mirror=True, mean=True, std=True,
                                    brightness=0.2)
        res.append(_batches(m.ImageDetIter(
            batch_size=2, data_shape=(3, 24, 24), path_imgrec=p,
            aug_list=augs, shuffle=True)))
    assert [type(a).__name__ for a in PI.CreateDetAugmenter(
        (3, 24, 24), rand_crop=0.5, rand_pad=0.5, mean=True, std=True)] == \
        [type(a).__name__ for a in RI.CreateDetAugmenter(
            (3, 24, 24), rand_crop=0.5, rand_pad=0.5, mean=True, std=True)]
    (gd, gl), (wd, wl) = res[0][0], res[1][0]
    assert gd.shape == (2, 3, 24, 24)
    for (gd, gl), (wd, wl) in zip(*res):
        onp.testing.assert_allclose(gd, wd, atol=1e-4, rtol=0)
        onp.testing.assert_allclose(gl, wl, atol=1e-6)
        valid = gl[gl[:, :, 0] >= 0]
        assert ((valid[:, 1:5] >= -1e-6) & (valid[:, 1:5] <= 1 + 1e-6)).all()


def test_image_ops_match_the_reference():
    img = (onp.random.RandomState(0).rand(48, 64, 3) * 255).astype("uint8")
    outs = []
    for m, mx in ((PI, P), (RI, R)):
        _seeded(11)
        with P.cpu():
            a = mx.nd.array(img)
            r = [m.imresize(a, 32, 24), m.resize_short(a, 32),
                 m.center_crop(a, (32, 32))[0],
                 m.random_crop(a, (16, 16))[0],
                 m.random_size_crop(a, (20, 20), (0.3, 1.0),
                                    (0.75, 1.33))[0],
                 m.fixed_crop(a, 4, 6, 20, 10, size=(10, 5)),
                 m.color_normalize(a, onp.array([128.0, 128.0, 128.0]),
                                   onp.array([64.0, 64.0, 64.0])),
                 m.imrotate(a, 30), m.copyMakeBorder(a, 2, 1, 3, 0, type=1)]
        outs.append([x.asnumpy() for x in r])
    shapes = [(24, 32, 3), (32, 42, 3), (32, 32, 3), (16, 16, 3),
              (20, 20, 3), (5, 10, 3), (48, 64, 3), (48, 64, 3), (51, 67, 3)]
    for g, w, s in zip(*outs, shapes):
        assert g.shape == s and g.dtype == w.dtype
        onp.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    assert PI.scale_down((8, 10), (16, 20)) == (8, 10)
    assert PI.scale_down((100, 100), (16, 20)) == (16, 20)
    assert PI.parse_lst_line("3\t1.0\t2.0\ta.jpg") == ("a.jpg", [1.0, 2.0])


def test_image_decode_and_read_match_the_reference(tmp_path):
    from PIL import Image
    arr = (onp.random.RandomState(2).rand(20, 30, 3) * 255).astype("uint8")
    path = str(tmp_path / "x.png")
    Image.fromarray(arr).save(path)
    buf = open(path, "rb").read()
    with P.cpu():
        for flag, rgb in ((1, True), (0, True), (1, False)):
            g = PI.imdecode(buf, flag, rgb)
            assert g.context == P.cpu()
            onp.testing.assert_array_equal(
                g.asnumpy(), RI.imdecode(buf, flag, rgb).asnumpy())
            onp.testing.assert_array_equal(
                PI.imread(path, flag, rgb).asnumpy(),
                RI.imread(path, flag, rgb).asnumpy())


def test_every_augmenter_matches_the_reference():
    x = (onp.random.RandomState(0).rand(24, 24, 3) * 255).astype("f")

    def augs(m):
        return [m.BrightnessJitterAug(0.3), m.ContrastJitterAug(0.3),
                m.SaturationJitterAug(0.3), m.HueJitterAug(0.3),
                m.ColorJitterAug(0.2, 0.2, 0.2), m.RandomGrayAug(1.0),
                m.LightingAug(0.1, onp.ones(3), onp.eye(3)),
                m.RandomOrderAug([m.BrightnessJitterAug(0.1),
                                  m.ContrastJitterAug(0.1)]),
                m.HorizontalFlipAug(1.0), m.RandomCropAug((16, 12)),
                m.CenterCropAug((16, 12)), m.ResizeAug(20),
                m.ForceResizeAug((10, 14)), m.CastAug("float32"),
                m.ColorNormalizeAug(onp.array([1.0, 2.0, 3.0]),
                                    onp.array([2.0, 2.0, 2.0]))]

    outs = []
    for m, mx in ((PI, P), (RI, R)):
        _seeded(4)
        with P.cpu():
            img = mx.nd.array(x)
            outs.append([(type(a).__name__, a(img).asnumpy(), a.dumps())
                         for a in augs(m)])
    for (n, g, gd), (_, w, wd) in zip(*outs):
        assert g.shape == w.shape, n
        onp.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-6, err_msg=n)
        assert gd == wd, n
    g = dict((n, o) for n, o, _ in outs[0])["RandomGrayAug"]
    onp.testing.assert_allclose(g[..., 0], g[..., 1], rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(resize=40, brightness=0.1, hue=0.1, pca_noise=0.05, rand_gray=0.2),
])
def test_create_augmenter_lists_match_the_reference(kw):
    got = PI.CreateAugmenter((3, 32, 32), **kw)
    want = RI.CreateAugmenter((3, 32, 32), **kw)
    assert [a.dumps() for a in got] == [a.dumps() for a in want]


def test_image_iter_from_rec_gives_the_reference_batches(tmp_path):
    """``ImageIter`` over a ``.rec`` with the whole augmenter list of the
    ResNet recipe, shuffled: the port's batches are the reference's, and
    a second iterator from the same seeds repeats them."""
    p = str(tmp_path / "cls.rec")
    _write_cls_rec(p)

    def run(m):
        _seeded(21)
        augs = m.CreateAugmenter(data_shape=(3, 32, 32), rand_crop=True,
                                 rand_mirror=True, mean=True, std=True,
                                 brightness=0.4, contrast=0.4,
                                 saturation=0.4, pca_noise=0.1)
        it = m.ImageIter(batch_size=4, data_shape=(3, 32, 32),
                         path_imgrec=p, aug_list=augs, shuffle=True)
        out = _batches(it)
        it.reset()
        return out + _batches(it)

    got = run(PI)
    assert len(got) == 6 and got[0][0].shape == (4, 3, 32, 32)
    _same_batches(got, run(RI), tol=1e-4)
    _same_batches(got, run(PI), tol=0)


def test_image_iter_from_imglist(tmp_path):
    from PIL import Image
    rs = onp.random.RandomState(0)
    rows = []
    for i in range(6):
        arr = (rs.rand(40, 40, 3) * 255).astype("uint8")
        name = f"img{i}.png"
        Image.fromarray(arr).save(str(tmp_path / name))
        rows.append([float(i % 2), name])
    lst = tmp_path / "l.lst"
    lst.write_text("".join(f"{i}\t{r[0]}\t{r[1]}\n"
                           for i, r in enumerate(rows)))
    res = []
    for m in (PI, RI):
        _seeded(5)
        a = _batches(m.ImageIter(batch_size=3, data_shape=(3, 32, 32),
                                 imglist=rows, path_root=str(tmp_path),
                                 rand_mirror=True))
        _seeded(5)
        b = _batches(m.ImageIter(batch_size=3, data_shape=(3, 32, 32),
                                 path_imglist=str(lst),
                                 path_root=str(tmp_path), rand_mirror=True))
        res.append(a + b)
    assert res[0][0][0].shape == (3, 3, 32, 32) and \
        res[0][0][1].shape == (3,)
    _same_batches(res[0], res[1])
    it = PI.ImageIter(batch_size=3, data_shape=(3, 32, 32), imglist=rows,
                      path_root=str(tmp_path))
    assert it.provide_data[0].shape == (3, 3, 32, 32)
    assert it.provide_label[0].shape == (3,)
    with pytest.raises(P.MXNetError):
        PI.ImageIter(batch_size=3, data_shape=(3, 32, 32))


def test_imrotate_chw_contract_and_zoom():
    chw = onp.zeros((3, 8, 8), "f")
    chw[:, 0, :] = 1.0
    with P.cpu():
        for args in [(chw, 90), (chw[None], 45), (chw, 30, True),
                     (chw, 30, False, True)]:
            g = PI.imrotate(P.nd.array(args[0]), *args[1:]).asnumpy()
            w = RI.imrotate(R.nd.array(args[0]), *args[1:]).asnumpy()
            onp.testing.assert_array_equal(g, w)
        with pytest.raises(ValueError):
            PI.imrotate(P.nd.array(chw), 30, zoom_in=True, zoom_out=True)
        with pytest.raises(NotImplementedError):
            PI.copyMakeBorder(P.nd.array(chw), 1, 1, 1, 1, type=4)
