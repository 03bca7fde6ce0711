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
_MASK = -1e30


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


# ------------------------------------------- the kernel's split walk

def _walk_shape(d, itemsize):
    """csrc/paged_attention.cu ``Walk``: lanes per key row (16 bytes a
    lane), key rows a warp takes at once, keys per copied chunk."""
    lanes = min(d * itemsize // 16, 32)
    return 32 // lanes, min(4096 // (d * itemsize), 16)


def _fold(a, b):
    """Two partial softmax states (m, l, acc) into one."""
    m = torch.maximum(a[0], b[0])
    wa, wb = torch.exp(a[0] - m), torch.exp(b[0] - m)
    return m, a[1] * wa + b[1] * wb, a[2] * wa[..., None] + b[2] * wb[..., None]


def split_walk(q, kp, vp, table, qpos, ks, vs, scale, n_splits):
    """B4's two passes in PyTorch, float32, loop for loop: per (slot,
    query tile, head) each split of ``ceil(P / n_splits)`` pages walks its
    keys in chunks, each of the warp's lane groups keeping its own online
    softmax (one rescale per chunk, the masked-safe exp), the groups folded
    in the warp's butterfly order; then every row folds the splits that
    start at or before its position (at most the table's last key), in
    split order.  A split pass 1 did not write is a KeyError here."""
    b, tq, h, d = q.shape
    ps, npt = kp.shape[1], table.shape[1]
    kf, vf = kp.float(), vp.float()
    if ks is not None:
        kf, vf = kf * ks, vf * vs
    groups, kc = _walk_shape(d, kp.element_size())
    qt = 1 if tq == 1 else 4
    sk = -(-npt // n_splits) * ps
    part = {}
    for s in range(b):
        for t0 in range(0, tq, qt):
            rows = list(range(t0, min(t0 + qt, tq)))
            pos = qpos[s, rows].long()
            kend = min(npt * ps, int(pos.max()) + 1)
            qs = q[s, rows].float()                     # (qt, h, d)
            for c in range(n_splits):
                kb = c * sk
                if kb >= kend:
                    continue
                ke = min(kb + sk, kend)
                st = [(torch.full((len(rows), h), _MASK),
                       torch.zeros((len(rows), h)),
                       torch.zeros((len(rows), h, d))) for _ in range(groups)]
                for c0 in range(kb, ke, kc):
                    keys = torch.arange(c0, c0 + kc)
                    live = keys < ke
                    kk = keys.clamp(max=ke - 1)
                    pages = table[s, kk // ps].long()
                    krow = torch.where(live[:, None, None], kf[pages, kk % ps],
                                       torch.zeros(()))
                    vrow = torch.where(live[:, None, None], vf[pages, kk % ps],
                                       torch.zeros(()))
                    sc = torch.einsum("thd,khd->thk", qs, krow) * scale
                    keep = live[None, :] & (keys[None, :] <= pos[:, None])
                    sc = torch.where(keep[:, None, :], sc, torch.full_like(
                        sc, _MASK))
                    for g in range(groups):
                        m, l, acc = st[g]
                        mine = sc[..., g::groups]
                        mc = torch.maximum(m, mine.amax(-1))
                        corr = torch.exp(m - mc)
                        p = torch.where(mine <= _MASK * 0.5,
                                        torch.zeros_like(mine),
                                        torch.exp(mine - mc[..., None]))
                        st[g] = (mc, l * corr + p.sum(-1),
                                 acc * corr[..., None] + torch.einsum(
                                     "thk,khd->thd", p, vrow[g::groups]))
                bit = 1
                while bit < groups:
                    st = [_fold(st[g], st[g ^ bit]) for g in range(groups)]
                    bit *= 2
                for i, t in enumerate(rows):
                    part[s, t, c] = tuple(x[i] for x in st[0])
    out = torch.zeros((b, tq, h, d))
    for s in range(b):
        for t in range(tq):
            qp = int(qpos[s, t])
            n = 0 if qp < 0 else min(n_splits, min(qp, npt * ps - 1) // sk
                                     + 1)
            if n == 0:
                continue
            ms = torch.stack([part[s, t, c][0] for c in range(n)])
            m = ms.amax(0)
            w = torch.exp(ms - m)
            l = sum(part[s, t, c][1] * w[c] for c in range(n))
            o = sum(part[s, t, c][2] * w[c][:, None] for c in range(n))
            out[s, t] = torch.where(l[:, None] <= 0, torch.zeros(()),
                                    o / torch.where(l <= 0, 1.0, l)[:, None])
    return out


def _walk_case(rs, tq, quant, d=64):
    """Six slots over a pool of 14 pages + the zero page, P = 12 pages of
    8 keys (96 keys; the default split is 8 pages, 64 keys), head dim
    ``d``: walks that
    end inside the first split, on its boundary, one key past it, and at
    the table's end; a parked row whose whole walk is the zero page (pos
    = Tmax); a row with no attended key (pos = -1)."""
    npages, ps, h, p = 15, 8, 2, 12
    kf, vf = _pool(rs, npages, ps, h, d, scale=2.0)
    zero = npages - 1
    table = onp.stack([rs.permutation(npages - 1)[:p] for _ in range(6)]
                      ).astype("int32")
    table[4] = zero
    last = onp.array([40, 63, 64, p * ps - 1, p * ps, -1])
    qpos = last[:, None] - onp.arange(tq)[::-1][None, :]
    qpos[5] = -1
    q = rs.randn(6, tq, h, d).astype("float32")
    if not quant:
        return q, kf, vf, table, qpos.astype("int32"), None, None
    kq, ks = (onp.asarray(a) for a in jpaged.kv_quantize(kf))
    vq, vs = (onp.asarray(a) for a in jpaged.kv_quantize(vf))
    return q, kq, vq, table, qpos.astype("int32"), ks, vs


@pytest.mark.parametrize("splits", ["default", "page", "five"])
@pytest.mark.parametrize("tq", [1, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_split_walk_and_merge_match_pallas(quant, tq, splits):
    """The kernel's split walk and lse merge, emulated on the CPU, against
    the Pallas kernel (interpret mode) on the same pages: float32 1e-4,
    int8 1e-4 (both sides dequantize the same int8 pages).  Splits as the
    wrapper picks them (two here), one page per split (twelve), and five
    splits of three pages, the last starting past the table, which the
    parked row's merge must not read."""
    rs = onp.random.RandomState(21 + 2 * tq + quant)
    q, kp, vp, table, qpos, ks, vs = _walk_case(rs, tq, quant)
    ref = onp.asarray(jpaged.paged_attention(q, kp, vp, table, qpos,
                                             k_scale=ks, v_scale=vs))
    ns = {"default": tpaged.split_count(8, 12), "page": 12, "five": 5}[splits]
    got = split_walk(_t(q), _t(kp), _t(vp), _t(table), _t(qpos),
                     None if ks is None else _t(ks),
                     None if vs is None else _t(vs), 64 ** -0.5, ns).numpy()
    assert onp.isfinite(got).all()
    onp.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert (got[5] == 0).all()                 # no attended key


@pytest.mark.parametrize("tq", [1, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_split_walk_at_head_dim_32_matches_pallas(quant, tq):
    """Head dim 32, the smallest the kernel is built for (float32: eight
    lanes a key, four keys a step; int8: two lanes, sixteen keys), splits
    as the wrapper picks them, against the Pallas kernel at 1e-4."""
    rs = onp.random.RandomState(61 + 2 * tq + quant)
    q, kp, vp, table, qpos, ks, vs = _walk_case(rs, tq, quant, d=32)
    ref = onp.asarray(jpaged.paged_attention(q, kp, vp, table, qpos,
                                             k_scale=ks, v_scale=vs))
    got = split_walk(_t(q), _t(kp), _t(vp), _t(table), _t(qpos),
                     None if ks is None else _t(ks),
                     None if vs is None else _t(vs), 32 ** -0.5,
                     tpaged.split_count(8, 12)).numpy()
    onp.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert (got[5] == 0).all()


@pytest.mark.parametrize("ps,npt,want", [(16, 64, 16), (8, 12, 2),
                                         (16, 3, 1), (128, 4, 4)])
def test_split_count_covers_the_table_in_runs_of_about_64_keys(ps, npt,
                                                               want):
    ns = tpaged.split_count(ps, npt)
    assert ns == want
    per = -(-npt // ns)                        # the kernel's pages per split
    assert (ns - 1) * per < npt <= ns * per


def test_other_devices_raise_instead_of_falling_back():
    q = torch.zeros((1, 1, 2, 16), device="meta")
    pages = torch.zeros((3, 8, 2, 16), device="meta")
    table = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    qpos = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(MXNetError):
        tpaged.paged_attention(q, pages, pages, table, qpos)
