"""RecordIO, the native reader and ``mx.io``'s iterators, against the JAX
package's on the same files and seeds.

Records: a file written by either package (plain, multipart, ``.idx``,
by the Python writer or the native one) reads back byte for byte through
the other.  ``ImageRecordIter`` on the native path gives bit-identical
batches and labels in both packages: both run the same C++
(``mxtpu_io.cc``, copied) over the same ``std::mt19937``.  The Python path
(PIL decode, numpy ``RandomState``) and its re-decode of a record the
native reader rejects are held to the reference exactly as well (both
packages run the same numpy code over the same PIL; the reference's own
tolerance between its native and Python paths is 1.5 levels, which the
last test keeps).  ``NDArrayIter``, ``CSVIter``, ``MNISTIter``,
``PrefetchingIter`` and ``ResizeIter`` give identical batches.  The port's
iterators hand out batches on ``mx.cpu()`` whatever the current context
(a divergence by design: the reference's land on jax's default device).
"""
import os
import struct

import numpy as onp
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu import recordio as rrio
from mxnet_tpu.utils import native as rnative
from mxnet_tpu_torch import recordio as prio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import FaultPlan
from mxnet_tpu_torch.utils import native_io as pnative

MAGIC = struct.pack("<I", 0xced7230a)
RECORDS = [b"hello", b"x" * 37, b"", b"yz1", MAGIC, b"abcd" + MAGIC + b"efgh",
           b"ab" + MAGIC + b"cd", MAGIC * 3, b"x" * 8 + MAGIC + b"y" * 5,
           os.urandom(129)]

needs_native = pytest.mark.skipif(
    not (pnative.available() and rnative.available()),
    reason="g++ or libjpeg missing: the native reader does not build")


def _read_all(rec):
    out = []
    while True:
        r = rec.read()
        if r is None:
            return out
        out.append(r)


def _write_img_rec(mod, path, n=24, seed=0, label_width=1, idx=None,
                   png_at=()):
    rs = onp.random.RandomState(seed)
    wr = mod.MXIndexedRecordIO(idx, path, "w") if idx else \
        mod.MXRecordIO(path, "w")
    for i in range(n):
        img = rs.randint(0, 255, (36 + (i % 5), 48, 3), dtype=onp.uint8)
        label = float(i) if label_width == 1 else \
            onp.arange(label_width, dtype=onp.float32) + i
        rec = mod.pack_img(mod.IRHeader(0, label, i, 0), img, quality=95,
                           img_fmt=".png" if i in png_at else ".jpg")
        if idx:
            wr.write_idx(i, rec)
        else:
            wr.write(rec)
    wr.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_records_read_byte_for_byte_across_packages(tmp_path, writer):
    w_mod, r_mod = (rrio, prio) if writer == "reference" else (prio, rrio)
    p, idx = str(tmp_path / "a.rec"), str(tmp_path / "a.idx")
    w = w_mod.MXIndexedRecordIO(idx, p, "w")
    for i, r in enumerate(RECORDS):
        w.write_idx(i, r)
    w.close()
    other = str(tmp_path / "b.rec")
    w2 = r_mod.MXIndexedRecordIO(str(tmp_path / "b.idx"), other, "w")
    for i, r in enumerate(RECORDS):
        w2.write_idx(i, r)
    w2.close()
    assert open(p, "rb").read() == open(other, "rb").read()
    assert open(idx).read() == open(str(tmp_path / "b.idx")).read()
    rd = r_mod.MXIndexedRecordIO(idx, p, "r")
    assert rd.keys == list(range(len(RECORDS)))
    assert [rd.read_idx(k) for k in reversed(rd.keys)] == RECORDS[::-1]
    rd.close()
    assert _read_all(r_mod.MXRecordIO(p, "r")) == RECORDS
    # the magic-aligned records really are multipart chains
    blob = open(p, "rb").read()
    off = 0
    flags = []
    while off < len(blob):
        lrec = struct.unpack_from("<I", blob, off + 4)[0]
        flags.append(lrec >> 29)
        off += 8 + (((lrec & ((1 << 29) - 1)) + 3) & ~3)
    assert 1 in flags and 3 in flags


def test_pack_unpack_and_images_equal_the_reference():
    for label in (3.0, onp.array([1.0, 2.0, 5.0], onp.float32)):
        hr, hp = rrio.IRHeader(0, label, 7, 2), prio.IRHeader(0, label, 7, 2)
        sr, sp = rrio.pack(hr, b"payload"), prio.pack(hp, b"payload")
        assert sr == sp
        (h1, d1), (h2, d2) = rrio.unpack(sr), prio.unpack(sp)
        assert d1 == d2 == b"payload" and h1.flag == h2.flag
        onp.testing.assert_array_equal(h1.label, h2.label)
    img = onp.random.RandomState(0).randint(0, 255, (20, 24, 3), onp.uint8)
    for fmt, q in ((".jpg", 95), (".png", 100)):
        sr = rrio.pack_img(rrio.IRHeader(0, 1.0, 0, 0), img, q, fmt)
        sp = prio.pack_img(prio.IRHeader(0, 1.0, 0, 0), img, q, fmt)
        assert sr == sp
        for iscolor in (-1, 0, 1):
            onp.testing.assert_array_equal(rrio.unpack_img(sr, iscolor)[1],
                                           prio.unpack_img(sp, iscolor)[1])
    span_rec = b"abcd" + MAGIC + b"efgh"
    assert prio.reassemble_span(struct.pack("<II", 0xced7230a, 1 << 29 | 4)
                                + b"abcd" + struct.pack(
                                    "<II", 0xced7230a, 3 << 29 | 4)
                                + b"efgh") == span_rec


@needs_native
def test_native_writer_and_scan_equal_the_reference(tmp_path):
    pp, pr = str(tmp_path / "p.rec"), str(tmp_path / "r.rec")
    with pnative.NativeRecordWriter(pp) as w:
        for r in RECORDS:
            w.write(r)
    w = rnative.NativeRecordWriter(pr)
    for r in RECORDS:
        w.write(r)
    w.close()
    assert open(pp, "rb").read() == open(pr, "rb").read()
    assert _read_all(R.recordio.MXRecordIO(pp, "r")) == RECORDS
    (po, pl), (ro, rl) = pnative.scan_record_offsets(pp), \
        rnative.scan_record_offsets(pp)
    assert onp.array_equal(po, ro) and onp.array_equal(pl, rl)
    with open(pp, "rb") as f:
        for o, n, rec in zip(po, pl, RECORDS):
            f.seek(int(o))
            raw = f.read(int(n) & ~(1 << 63))
            assert (prio.reassemble_span(raw) if int(n) >> 63 else raw) == rec


def test_native_build_is_hashed_atomic_and_raises_when_asked(
        tmp_path, monkeypatch):
    """The library is built into build/native/ under a hash of the
    source and the flags; a failed build raises with the compiler's
    output; it takes the CUDA builder's lock (one witness site,
    ``native.build``, so no two locks share a site)."""
    from mxnet_tpu_torch.utils import native as cuda_native
    assert pnative._lock is cuda_native._LOCK
    if pnative.available():
        lib = pnative._lib_path()
        assert lib.parent == pnative.BUILD_DIR and lib.exists()
        assert lib.name.startswith("libmxtpu_io-")
        assert not list(lib.parent.glob(f"{lib.name}.*.tmp"))
    bad = tmp_path / "bad.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(pnative, "SOURCE", bad)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(MXNetError, match="native IO build failed"):
        pnative.build()
    assert not list((tmp_path / "native").glob("*"))


def test_no_native_knob_takes_the_python_path(tmp_path, monkeypatch):
    p = str(tmp_path / "img.rec")
    _write_img_rec(prio, p, n=8)
    monkeypatch.setenv("MXNET_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(pnative, "_lib", None)
    assert not pnative.available()
    it = P.io.ImageRecordIter(path_imgrec=p, data_shape=(3, 32, 32),
                              batch_size=4)
    assert it._native is None
    with pytest.raises(MXNetError, match="MXNET_TPU_NO_NATIVE"):
        pnative.NativeRecordWriter(str(tmp_path / "w.rec"))


def _batches(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
    return out


def _assert_same(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (d1, l1), (d2, l2) in zip(a, b):
        assert d1.dtype == d2.dtype
        onp.testing.assert_array_equal(d1, d2)
        onp.testing.assert_array_equal(l1, l2)


NATIVE_CASES = {
    "center": dict(),
    "augment": dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=7,
                    resize=40),
    "normalized": dict(mean_r=10., mean_g=5., mean_b=1., std_r=2.,
                       std_g=3., std_b=4.),
    "uint8": dict(dtype="uint8", rand_crop=True, seed=3),
    "labels3": dict(label_width=3),
}


@needs_native
@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_image_record_iter_native_is_bit_identical(tmp_path, case):
    kw = dict(NATIVE_CASES[case])
    p = str(tmp_path / "img.rec")
    _write_img_rec(prio, p, label_width=kw.get("label_width", 1))
    args = dict(path_imgrec=p, data_shape=(3, 32, 32), batch_size=8, **kw)
    ri, pi = R.io.ImageRecordIter(**args), P.io.ImageRecordIter(**args)
    assert ri._native is not None and pi._native is not None
    got = _batches(pi)
    _assert_same(_batches(ri), got)
    ri.reset()
    pi.reset()
    _assert_same(_batches(ri), _batches(pi))      # the second epoch too
    assert got[0][0].dtype == (onp.uint8 if case == "uint8"
                               else onp.float32)


@needs_native
def test_native_idx_subset_and_redecode_of_rejected_records(tmp_path):
    """A ``.idx`` that subsets and reorders records is honored, and the
    records the native reader rejects (PNG) are re-decoded in Python —
    in both packages alike."""
    p, idx = str(tmp_path / "s.rec"), str(tmp_path / "s.idx")
    _write_img_rec(prio, p, n=12, idx=idx, png_at=(3, 6))
    lines = open(idx).read().splitlines()
    with open(idx, "w") as f:
        for k in (9, 6, 3, 0, 1, 4, 7, 10):
            f.write(lines[k] + "\n")
    args = dict(path_imgrec=p, path_imgidx=idx, data_shape=(3, 32, 32),
                batch_size=4, mean_r=3., std_g=2.)
    ri, pi = R.io.ImageRecordIter(**args), P.io.ImageRecordIter(**args)
    assert pi._native is not None
    got = _batches(pi)
    _assert_same(_batches(ri), got)
    assert got[0][1].tolist() == [9.0, 6.0, 3.0, 0.0]


@pytest.mark.parametrize("aug", [False, True])
def test_image_record_iter_python_path_equals_the_reference(
        tmp_path, monkeypatch, aug):
    p = str(tmp_path / "img.rec")
    _write_img_rec(prio, p, n=16, png_at=(2,))
    kw = dict(path_imgrec=p, data_shape=(3, 28, 28), batch_size=8,
              preprocess_threads=2, mean_b=4., std_r=3.)
    if aug:
        kw.update(shuffle=True, rand_crop=True, rand_mirror=True, seed=11,
                  resize=34)
    monkeypatch.setenv("MXNET_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(rnative, "_lib", None)
    ri, pi = R.io.ImageRecordIter(**kw), P.io.ImageRecordIter(**kw)
    assert ri._native is None and pi._native is None
    # one decode thread each keeps the shared RandomState's draw order
    # fixed (a pool of 2 would interleave the draws differently per run)
    if aug:
        ri.n_threads = pi.n_threads = 1
    _assert_same(_batches(ri), _batches(pi))


@needs_native
def test_native_and_python_paths_agree_within_the_reference_tolerance(
        tmp_path, monkeypatch):
    p = str(tmp_path / "img.rec")
    _write_img_rec(prio, p)
    kw = dict(path_imgrec=p, data_shape=(3, 32, 32), batch_size=8)
    nat = _batches(P.io.ImageRecordIter(**kw))
    monkeypatch.setenv("MXNET_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(pnative, "_lib", None)
    py = _batches(P.io.ImageRecordIter(**kw))
    for (d1, l1), (d2, l2) in zip(nat, py):
        onp.testing.assert_allclose(d1, d2, atol=1.5)   # decoder delta
        onp.testing.assert_array_equal(l1, l2)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_equals_the_reference(handle, shuffle):
    data = onp.arange(44, dtype=onp.float32).reshape(11, 4)
    label = onp.arange(11, dtype=onp.int32)

    def run(mod):
        onp.random.seed(5)
        it = mod.io.NDArrayIter({"x": data}, {"y": label}, batch_size=3,
                                shuffle=shuffle, last_batch_handle=handle)
        out = []
        for _ in range(2):
            out += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad,
                     list(b.index)) for b in it]
            it.reset()
        return out, it.provide_data, it.provide_label

    (a, ad, al), (b, bd, bl) = run(R), run(P)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        onp.testing.assert_array_equal(x[0], y[0])
        onp.testing.assert_array_equal(x[1], y[1])
        assert x[1].dtype == y[1].dtype and x[2:] == y[2:]
    assert [tuple(d) for d in ad] == [tuple(d) for d in bd]
    assert [tuple(d) for d in al] == [tuple(d) for d in bl]


def test_quarantine_and_bad_batch_poison_equal_the_reference():
    from mxnet_tpu.resilience import FaultPlan as RFaultPlan
    from mxnet_tpu_torch.observability import default_registry
    data = onp.random.RandomState(0).randn(20, 3).astype("float32")
    data[7, 1] = onp.nan

    def run(mod, plan_cls):
        it = mod.io.NDArrayIter(data, onp.zeros(20, "float32"),
                                batch_size=4, quarantine_nonfinite=True)
        with plan_cls().nonfinite_at("io.bad_batch", at=3):
            out = [b.data[0].asnumpy() for b in it]
        return out, it.quarantined

    counter = default_registry().counter(
        "mxtpu_io_quarantined_batches_total")
    before = counter.value
    (a, qa), (b, qb) = run(R, RFaultPlan), run(P, FaultPlan)
    assert qa == qb == 2 and len(a) == len(b) == 3
    for x, y in zip(a, b):
        onp.testing.assert_array_equal(x, y)
    assert counter.value - before == 2


def test_csv_mnist_prefetching_and_resize_iters_equal_the_reference(
        tmp_path):
    rs = onp.random.RandomState(1)
    d = str(tmp_path / "d.csv")
    lab = str(tmp_path / "l.csv")
    onp.savetxt(d, rs.rand(10, 6), delimiter=",")
    onp.savetxt(lab, rs.randint(0, 3, (10, 1)), delimiter=",")

    def run(mod):
        out = _batches(mod.io.CSVIter(d, (2, 3), label_csv=lab,
                                      batch_size=3))
        onp.random.seed(2)
        mn = mod.io.MNISTIter(batch_size=64, shuffle=True, flat=True,
                              seed=0)
        assert mn.synthetic
        out += _batches(mod.io.ResizeIter(mn, 5))
        base = mod.io.NDArrayIter(onp.arange(24.).reshape(12, 2),
                                  onp.arange(12.), batch_size=5)
        pf = mod.io.PrefetchingIter(base, prefetch_depth=2)
        out += _batches(pf)
        pf.reset()
        out += _batches(pf)
        return out

    _assert_same(run(R), run(P))


def test_batches_live_on_the_host_whatever_the_context(tmp_path):
    """A divergence by design: the port's iterators and loaders hand out
    NDArrays on ``mx.cpu()`` even outside any CPU scope, where the port's
    ``nd.array`` would take the card (and raises without one); the
    reference's land on jax's default device."""
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            P.nd.array([1.0])                # no scope: the card, or raise
    it = P.io.NDArrayIter(onp.ones((6, 2), "float32"), onp.zeros(6),
                          batch_size=2)
    b = it.next()
    assert b.data[0].context == P.cpu() and b.label[0].context == P.cpu()
    p = str(tmp_path / "img.rec")
    _write_img_rec(prio, p, n=4)
    b = P.io.ImageRecordIter(path_imgrec=p, data_shape=(3, 32, 32),
                             batch_size=2).next()
    assert b.data[0].context == P.cpu()
    ds = P.gluon.data.ArrayDataset(onp.ones((4, 3), "float32"),
                                   onp.arange(4))
    x, y = next(iter(P.gluon.data.DataLoader(ds, batch_size=2,
                                             pin_memory=True)))
    assert x.context == P.cpu() and y.context == P.cpu()
    assert x.tensor.is_pinned() == torch.cuda.is_available()
    # the reference's batches are on its default (accelerator or host)
    ref = R.io.NDArrayIter(onp.ones((6, 2), "float32"), batch_size=2).next()
    assert ref.data[0].context == R.context.current_context()
