"""The port's paged attention and int8 KV quantizer against the JAX
package (``mxnet_tpu.ops.paged``, the Pallas kernel in interpret mode),
on the same numpy inputs, mirroring ``tests/test_paged_attn.py``.

Tolerances: float32 max-abs 1e-4 (the reference's own bound for the
kernel against its dense twin); int8 pages are held to the same 1e-4
against the same dequantize path, since both sides read identical int8
values and scales.  On the CPU the port's wrapper runs its plain
version; the CUDA kernel is held to that on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import paged as jpaged
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import paged as tpaged

TOL = 1e-4


def _t(x):
    return torch.from_numpy(onp.array(x))


def _pool(rs, npages, ps, h, d, scale=1.0):
    kp = (rs.randn(npages, ps, h, d) * scale).astype("float32")
    vp = (rs.randn(npages, ps, h, d) * scale).astype("float32")
    kp[-1] = vp[-1] = 0.0             # the never-written zero page
    return kp, vp


def test_kv_quantize_matches_reference_and_zero_is_exact():
    rs = onp.random.RandomState(3)
    x = (rs.randn(6, 8, 4, 16) * rs.gamma(1.0, 2.0, (6, 8, 4, 1))
         ).astype("float32")
    x[2] = 0.0
    qj, sj = jpaged.kv_quantize(x)
    qt, st = tpaged.kv_quantize(_t(x))
    assert qt.dtype == torch.int8 and tuple(st.shape) == (6, 8, 4, 1)
    onp.testing.assert_array_equal(qt.numpy(), onp.asarray(qj))
    onp.testing.assert_array_equal(st.numpy(), onp.asarray(sj))
    dq = tpaged.kv_dequantize(qt, st).numpy()
    onp.testing.assert_array_equal(dq, onp.asarray(
        jpaged.kv_dequantize(qj, sj)))
    onp.testing.assert_array_equal(dq[2], onp.zeros_like(dq[2]))


@pytest.mark.parametrize("b,tq", [(1, 1), (3, 1), (2, 8)])
def test_paged_attention_matches_pallas_fp32(b, tq):
    rs = onp.random.RandomState(11 + b * 10 + tq)
    npages, ps, h, d, p = 7, 8, 4, 16, 4
    kp, vp = _pool(rs, npages, ps, h, d)
    q = rs.randn(b, tq, h, d).astype("float32")
    table = rs.randint(0, npages - 1, (b, p)).astype("int32")
    base = rs.randint(0, p * ps - tq, (b,))
    qpos = (base[:, None] + onp.arange(tq)[None, :]).astype("int32")
    ref = onp.asarray(jpaged.paged_attention(q, kp, vp, table, qpos))
    out = tpaged.paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                                 _t(qpos))
    onp.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("b,tq", [(1, 1), (3, 1), (2, 8)])
def test_paged_attention_int8_matches_pallas(b, tq):
    """Quantized pages: the port and the reference read the same int8
    pages and scales; the port's int8 path also equals its own float
    path over the dequantized pages."""
    rs = onp.random.RandomState(5 + b + tq)
    npages, ps, h, d, p = 5, 8, 4, 16, 3
    kf, vf = _pool(rs, npages, ps, h, d, scale=3.0)
    kq, ks = (onp.asarray(a) for a in jpaged.kv_quantize(kf))
    vq, vs = (onp.asarray(a) for a in jpaged.kv_quantize(vf))
    q = rs.randn(b, tq, h, d).astype("float32")
    table = rs.randint(0, npages - 1, (b, p)).astype("int32")
    base = rs.randint(0, p * ps - tq, (b,))
    qpos = (base[:, None] + onp.arange(tq)[None, :]).astype("int32")
    ref = onp.asarray(jpaged.paged_attention(q, kq, vq, table, qpos,
                                             k_scale=ks, v_scale=vs))
    out = tpaged.paged_attention(_t(q), _t(kq), _t(vq), _t(table),
                                 _t(qpos), k_scale=_t(ks), v_scale=_t(vs))
    onp.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
    unfused = tpaged.paged_attention(
        _t(q), tpaged.kv_dequantize(_t(kq), _t(ks)),
        tpaged.kv_dequantize(_t(vq), _t(vs)), _t(table), _t(qpos))
    onp.testing.assert_allclose(out.numpy(), unfused.numpy(), atol=TOL,
                                rtol=0)
    with pytest.raises(ValueError):
        tpaged.paged_attention(_t(q), _t(kq), _t(vq), _t(table), _t(qpos))


def test_zero_page_rows_are_finite_and_keyless_rows_are_zero():
    """A parked slot (every table entry on the zero page) gives finite
    output, equal to the reference's; a row whose query position is
    before every key gives exactly 0."""
    rs = onp.random.RandomState(7)
    npages, ps, h, d = 3, 8, 2, 16
    kp, vp = _pool(rs, npages, ps, h, d)
    q = rs.randn(2, 1, h, d).astype("float32")
    table = onp.full((2, 2), npages - 1, "int32")
    qpos = onp.zeros((2, 1), "int32")
    ref = onp.asarray(jpaged.paged_attention(q, kp, vp, table, qpos))
    out = tpaged.paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                                 _t(qpos)).numpy()
    assert onp.isfinite(out).all()
    onp.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    keyless = tpaged.paged_attention(
        _t(q), _t(kp), _t(vp), _t(onp.zeros((2, 2), "int32")),
        _t(onp.full((2, 1), -1, "int32"))).numpy()
    assert (keyless == 0).all()


def test_other_devices_raise_instead_of_falling_back():
    q = torch.zeros((1, 1, 2, 16), device="meta")
    pages = torch.zeros((3, 8, 2, 16), device="meta")
    table = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    qpos = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(MXNetError):
        tpaged.paged_attention(q, pages, pages, table, qpos)
