"""The arithmetic of B1's bf16 kernel for Hopper, emulated on the CPU.

``csrc/flash_fwd.cu`` ``flash_fwd_wgmma_kernel`` computes bf16 flash
attention at head dims 64 and 128 with wgmma fed by TMA.  No card runs
here, so this file repeats its arithmetic in PyTorch: query items of 128
rows split between two consumer warpgroups of 64, key tiles of 128, the
tiles a warpgroup skips (above its diagonal, or segment ranges that cannot
meet, flash.py ``_run_pred``), masks only on the tiles that need them
(the diagonal, the tile crossing T, packed segments), masked scores as
-inf, the exponent ``exp2(x * sl2 - max * sl2)`` with ``sl2 = |scale| *
log2(e)`` taken as one fused multiply-add, each tile's P rounded to bf16
before P.V (the reference's ``p.astype(v.dtype)``) with the row sums
taken before that rounding, and the previous tile's P.V added before O's
rescale (the kernel issues it beside the next tile's S).  The result is
held to the JAX package's flash forward in Pallas interpret mode on the
same bf16 inputs: O and the logsumexp within ``TOL_BF16``.  The kernel
itself is held to its plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: ``TOL_BF16`` = 2e-2 max-abs, as the card tests hold bf16 B1
(one bf16 ulp of an output near 1 is 3.9e-3; the two sides round P to
bf16 after sums taken in other orders).
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import flash as jflash
from mxnet_tpu_torch.utils import native

TOL_BF16 = 2e-2
MASK = -1e30
LOG2E = 1.4426950408889634
FLT_MIN = float(onp.finfo(onp.float32).tiny)
BQ, BK, WG = 128, 128, 64   # queries an item, keys a tile, rows a warpgroup


def _bf16(x):
    """float32 numpy -> bf16-exact float32 tensor (round to nearest even)."""
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _fma_exp2(x, a, b):
    """exp2(x * a - b) with x * a - b rounded once, as the kernel's FFMA."""
    return torch.exp2((x.double() * a - b.double()).float())


def fwd_wgmma(q, k, v, qseg, kseg, causal, scale):
    """The bf16 kernel's arithmetic on (BH, T, D) float32 tensors holding
    bf16 values; ``qseg``/``kseg`` (BH, T) int or None.  Returns (O rounded
    to bf16, lse (BH, T))."""
    bh, t, d = q.shape
    sl2 = max(abs(scale) * LOG2E, FLT_MIN)
    sign = -1.0 if scale < 0 else 1.0
    has_seg = qseg is not None
    o = torch.zeros((bh, t, d))
    lse = torch.zeros((bh, t))
    for rw0 in range(0, t, WG):                 # one consumer warpgroup
        q0 = rw0 - rw0 % BQ                     # its item's first row
        rows = torch.arange(rw0, min(rw0 + WG, t))
        n_kt = -(-t // BK)
        if causal:
            n_kt = min(n_kt, -(-(q0 + BQ) // BK))
        last = torch.minimum(rows, torch.tensor(t - 1)) if causal else \
            torch.full_like(rows, t - 1)
        m = torch.full((bh, len(rows)), -float("inf"))
        l = torch.zeros((bh, len(rows)))
        acc = torch.zeros((bh, len(rows), d))
        # the last tile's P.V, added at the next tile: before O's rescale
        # if that tile runs, alone if it is skipped
        pend = torch.zeros_like(acc)
        has = torch.zeros((bh,), dtype=torch.bool)
        for kt in range(n_kt):
            k0 = kt * BK
            keys = torch.arange(k0, min(k0 + BK, t))
            run = torch.full((bh,), not (causal and k0 > rw0 + WG - 1))
            if has_seg:
                qs, ks = qseg[:, rows], kseg[:, keys]
                run &= (ks.min(1).values <= qs.max(1).values) & \
                    (ks.max(1).values >= qs.min(1).values)
            # keys past T are zeros in the kernel's tile, masked; here the
            # tile is cut at T
            s = sign * (q[:, rows] @ k[:, keys].transpose(1, 2))
            edge = (causal and k0 + BK - 1 > rw0) or k0 + BK > t or has_seg
            if edge:
                keep = (keys[None, :] <= last[:, None])[None]
                if has_seg:
                    keep = keep & (qseg[:, rows][:, :, None]
                                   == kseg[:, keys][:, None, :])
                s = torch.where(keep, s, torch.full_like(s, -float("inf")))
            mnext = torch.maximum(m, s.amax(-1))
            ms = torch.where(mnext == -float("inf"), torch.zeros_like(mnext),
                             mnext * sl2)
            p = _fma_exp2(s, sl2, ms[..., None])
            corr = torch.where(m == mnext, torch.ones_like(m),
                               torch.exp2((m - mnext) * sl2))
            acc = torch.where(has[:, None, None], acc + pend, acc)
            acc = torch.where(run[:, None, None], acc * corr[..., None], acc)
            l = torch.where(run[:, None], corr * l + p.sum(-1), l)
            m = torch.where(run[:, None], mnext, m)
            pend = p.to(torch.bfloat16).float() @ v[:, keys]
            has = run
        acc = torch.where(has[:, None, None], acc + pend, acc)
        none = l <= 0
        lt = torch.where(none, torch.ones_like(l), l)
        o[:, rows] = torch.where(none[..., None], torch.zeros_like(acc),
                                 acc / lt[..., None])
        lse[:, rows] = torch.where(none, torch.full_like(l, MASK),
                                   m * abs(scale) + torch.log(lt))
    return o.to(torch.bfloat16).float(), lse


def _flat(x):
    """(B, T, H, D) -> (B*H, T, D)."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d)


def _segments(b, t, seed):
    """Packed documents: three per row, cut at random places."""
    rs = onp.random.RandomState(seed)
    seg = onp.zeros((b, t), "int32")
    for i in range(b):
        cuts = onp.sort(rs.choice(onp.arange(1, t), 2, replace=False))
        seg[i] = (onp.arange(t)[:, None] >= cuts[None, :]).sum(1)
    seg[0] = (onp.arange(t)[:, None] >= onp.array([t // 3, t // 3 + t // 4])
              ).sum(1)                          # chip_smoke.py's cuts
    return seg


def _reference(q, k, v, seg, causal, scale):
    """(O float32, lse (B*H, T)) of the JAX package's flash forward in
    Pallas interpret mode on bf16 inputs, one block over the sequence."""
    b, t, h, d = q.shape

    def flat(x):
        return jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1, 3) \
            .reshape(b * h, t, d)

    segs = (None, None) if seg is None else \
        (jnp.asarray(seg)[:, None, :],) * 2
    o, lse = jflash._fwd(flat(q), flat(k), flat(v), *segs, h, causal, scale,
                         t, t, True)
    o = onp.asarray(o.astype(jnp.float32)).reshape(b, h, t, d) \
        .transpose(0, 2, 1, 3)
    return o, onp.asarray(lse)[:, 0, :]


@pytest.mark.parametrize("case", ["causal_t1024_d64", "full_d128",
                                  "causal_segments_t300"])
def test_wgmma_forward_matches_pallas_in_bf16(case):
    """B1's bf16 kernel at the training path's causal T = 1024, D = 64; a
    full D = 128 (two 64-column boxes a row, V's second box through the
    descriptor's leading offset); causal packed segments at T = 300 (a
    partial last tile and item, tiles skipped by segment range)."""
    b, t, h, d, causal, seg = {
        "causal_t1024_d64": (1, 1024, 2, 64, True, False),
        "full_d128": (1, 384, 2, 128, False, False),
        "causal_segments_t300": (2, 300, 2, 64, True, True),
    }[case]
    rs = onp.random.RandomState(t + d)
    q, k, v = (rs.randn(b, t, h, d).astype("float32") for _ in range(3))
    segs = _segments(b, t, 5) if seg else None
    scale = d ** -0.5
    o_ref, lse_ref = _reference(q, k, v, segs, causal, scale)
    qseg = None if segs is None else \
        torch.from_numpy(onp.repeat(segs, h, axis=0))
    o, lse = fwd_wgmma(*(_flat(_bf16(x)) for x in (q, k, v)), qseg, qseg,
                       causal, scale)
    o = o.reshape(b, h, t, d).permute(0, 2, 1, 3).numpy()
    onp.testing.assert_allclose(o, o_ref, atol=TOL_BF16, rtol=0)
    onp.testing.assert_allclose(lse.numpy(), lse_ref, atol=TOL_BF16, rtol=0)
    if seg:
        # the segment skip took place (else this case tests no skip)
        ks = torch.from_numpy(segs[:, 0:BK])
        qs = torch.from_numpy(segs[:, 256:300])
        assert bool((ks.max(1).values < qs.min(1).values).any())


def test_bf16_route_is_wgmma_fed_by_tma_and_no_library_kernel():
    """The bf16 forward at D = 64 and 128 is ``flash_fwd_wgmma_kernel``:
    wgmma products, TMA copies, mbarriers, setmaxnreg (the PTX in
    hopper.cuh); the mma.sync bf16 instantiations are gone from B1's
    dispatch; no source names a library's kernel."""
    csrc = native._CSRC
    hopper = (csrc / "hopper.cuh").read_text()
    for ptx in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                "cp.async.bulk.tensor.4d.shared::cluster.global",
                "mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx",
                "setmaxnreg.inc", "setmaxnreg.dec", "cuTensorMapEncodeTiled",
                "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert ptx in hopper, ptx
    fwd = (csrc / "flash_fwd.cu").read_text()
    assert '#include "hopper.cuh"' in fwd
    assert "flash_fwd_wgmma_kernel(" in fwd
    wg = fwd[fwd.index("namespace wg {"):fwd.index("}  // namespace wg")]
    for call in ("wgmma_ss<", "wgmma_rs_t(", "tma_load_4d(", "mbar_wait(",
                 "mbar_expect_tx(", "mbar_arrive("):
        assert call in wg, call
    kernel = fwd[fwd.index("flash_fwd_wgmma_kernel("):]
    assert "regs_dec<" in kernel and "regs_inc<" in kernel
    dispatch = fwd[fwd.index('extern "C" int mxt_flash_fwd'):]
    bf16 = dispatch[dispatch.index("dtype == 1"):]
    assert "launch_wgmma<64>" in bf16 and "launch_wgmma<128>" in bf16
    assert "launch_tc<bf16" not in fwd and \
        "launch_tc<__nv_bfloat16" not in fwd
    for path in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        text = path.read_text().lower()
        for lib in ("cublas", "cudnn", "cutlass/", "cute/",
                    "scaled_dot_product"):
            assert lib not in text, (path.name, lib)
