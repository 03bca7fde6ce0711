"""The arithmetic of the tensor-core flash kernels, emulated on the CPU.

``csrc/flash_fwd.cu`` (B1) and ``csrc/flash_bwd.cu`` ``flash_dq_tc_kernel``
(B2) and ``flash_dkv_tc_kernel`` (B3) compute every float32 product on the
tensor cores as three TF32
products (``csrc/flash_tc.cuh``): each operand x is split into
``big = rna_tf32(x)`` and ``small = rna_tf32(x - big)``, and a product is
``small_a*big_b + big_a*small_b + big_a*big_b``.  No card runs here, so
this file repeats that arithmetic in PyTorch (the same rounding on the
int32 view, the same tile loop and online softmax) and holds the result
to the JAX package's ``flash_attention`` (Pallas interpret mode) at the
training path's sequence length, T = 1024, D = 64.  The kernels
themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: the float32 max-abs of ``tests/test_torch_flash.py``, 1e-5,
for O and for dQ, dK, dV.  Single-pass TF32 products would miss it by about
two orders of magnitude; run from the repository root as a script
(``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_flash_tc.py``)
it prints the errors of both.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import flash as jflash
from mxnet_tpu_torch.utils import native

F32_TOL = 1e-5
MASK = -1e30
TILE = 64          # keys per tile in B1 and B2, queries per tile in B3


def rna_tf32(x):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, on the 13
    low mantissa bits of float32 ``x``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = rna_tf32(x)
    return big, rna_tf32(x - big)


def mm3(a, b):
    """a @ b as the kernels take it: three TF32 products summed in float32,
    small terms first."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm1(a, b):
    """a @ b as one TF32 pass would take it."""
    return rna_tf32(a) @ rna_tf32(b)


def fwd_tc(q, k, v, causal, scale, mm=mm3):
    """B1's tile loop on (BH, T, D) float32: key tiles of 64, online
    softmax, masked-safe exp; returns (O, lse)."""
    bh, t, d = q.shape
    m = torch.full((bh, t, 1), MASK)
    l = torch.zeros((bh, t, 1))
    acc = torch.zeros((bh, t, d))
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        s = mm(q, kt.transpose(1, 2)) * scale
        if causal:
            cols = k0 + torch.arange(kt.shape[1])[None]
            s = torch.where(cols <= rows, s, torch.full_like(s, MASK))
        mnext = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(s <= MASK * 0.5, torch.zeros_like(s),
                        torch.exp(s - mnext))
        corr = torch.exp(m - mnext)
        l = corr * l + p.sum(-1, keepdim=True)
        m = mnext
        acc = acc * corr + mm(p, vt)
    return acc / l, m + torch.log(l)


def dq_tiles(q, k, v, do, lse, causal, scale, mm=mm3):
    """B2's key tiles of 64 on (BH, T, D) float32: (K tile, P, dP), P
    recomputed from lse and dP = dO.V^T through ``mm``."""
    t = q.shape[1]
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        s = mm(q, kt.transpose(1, 2)) * scale
        p = torch.exp(s - lse[:, :, None])
        if causal:
            cols = k0 + torch.arange(kt.shape[1])[None]
            p = torch.where(cols <= rows, p, torch.zeros_like(p))
        yield kt, p, mm(do, vt.transpose(1, 2))


def dq_tc(q, k, v, do, lse, causal, scale, mm=mm3):
    """B2's two passes over key tiles of 64: each row's delta, sum P dP /
    sum P, then S, dP and dQ += dS.K.  Returns (dQ, delta)."""
    psum, pdp = torch.zeros(q.shape[:2]), torch.zeros(q.shape[:2])
    for _kt, p, dp in dq_tiles(q, k, v, do, lse, causal, scale, mm):
        psum, pdp = psum + p.sum(-1), pdp + (p * dp).sum(-1)
    delta = pdp / psum
    dq = torch.zeros_like(q)
    for kt, p, dp in dq_tiles(q, k, v, do, lse, causal, scale, mm):
        dq = dq + mm(p * (dp - delta[:, :, None]) * scale, kt)
    return dq, delta


def dkv_tc(q, k, v, do, lse, delta, causal, scale, mm=mm3):
    """B3's loop on (BH, T, D) float32: query tiles of 64; S^T, dP^T, then
    dV += P^T.dO and dK += dS^T.Q."""
    t = q.shape[1]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    keys = torch.arange(t)[:, None]
    for q0 in range(0, t, TILE):
        qt, ot = q[:, q0:q0 + TILE], do[:, q0:q0 + TILE]
        st = mm(k, qt.transpose(1, 2)) * scale
        p = torch.exp(st - lse[:, None, q0:q0 + TILE])
        if causal:
            cols = q0 + torch.arange(qt.shape[1])[None]
            p = torch.where(keys <= cols, p, torch.zeros_like(p))
        dpt = mm(v, ot.transpose(1, 2))
        ds = p * (dpt - delta[:, None, q0:q0 + TILE]) * scale
        dv = dv + mm(p, ot)
        dk = dk + mm(ds, qt)
    return dk, dv


def _inputs(seed, b, t, h, d):
    rs = onp.random.RandomState(seed)
    return [rs.randn(b, t, h, d).astype("float32") for _ in range(4)]


def _flat(x):
    """(B, T, H, D) numpy -> (B*H, T, D) float32 tensor."""
    b, t, h, d = x.shape
    return torch.from_numpy(x).permute(0, 2, 1, 3).reshape(b * h, t, d) \
        .contiguous()


def _unflat(x, b, h):
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3).numpy()


def _reference(q, k, v, cot):
    """O and (dQ, dK, dV) of the JAX package's flash attention, causal, in
    Pallas interpret mode."""
    c = jnp.asarray(cot)

    def f(q_, k_, v_):
        out = jflash.flash_attention(q_, k_, v_, causal=True, interpret=True)
        return jnp.sum(out * c), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    return onp.asarray(out), [onp.asarray(g) for g in grads]


def _emulated(q, k, v, cot, mm):
    b, _t, h, d = q.shape
    scale = d ** -0.5
    qf, kf, vf, of = (_flat(x) for x in (q, k, v, cot))
    o, lse = fwd_tc(qf, kf, vf, True, scale, mm)
    dq, delta = dq_tc(qf, kf, vf, of, lse[..., 0], True, scale, mm)
    dk, dv = dkv_tc(qf, kf, vf, of, lse[..., 0], delta, True, scale, mm)
    return _unflat(o, b, h), [_unflat(x, b, h) for x in (dq, dk, dv)]


def _errors(mm, seed=0, shape=(1, 1024, 2, 64)):
    q, k, v, cot = _inputs(seed, *shape)
    o_ref, g_ref = _reference(q, k, v, cot)
    o, g = _emulated(q, k, v, cot, mm)
    return (float(onp.abs(o - o_ref).max()),
            float(onp.abs(g[0] - g_ref[0]).max()),
            max(float(onp.abs(a - r).max()) for a, r in zip(g[1:], g_ref[1:])))


def test_rna_tf32_rounds_half_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10                   # TF32 spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 -
                      2.0 ** -23, 3.0, 0.0], dtype=torch.float32)
    got = rna_tf32(x).tolist()
    assert got == [one + ulp, -(one + ulp), one, 3.0, 0.0]


def test_split_keeps_float32_accuracy():
    x = torch.from_numpy(onp.random.RandomState(1).randn(4096)
                         .astype("float32"))
    big, small = split(x)
    assert bool((rna_tf32(big) == big).all())
    assert bool((rna_tf32(small) == small).all())
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


def test_3xtf32_forward_and_dkv_match_pallas_at_training_length():
    """B1's and B3's arithmetic at T = 1024, D = 64, causal, against the
    JAX package's kernels in interpret mode."""
    q, k, v, cot = _inputs(0, 1, 1024, 2, 64)
    o_ref, g_ref = _reference(q, k, v, cot)
    o, g = _emulated(q, k, v, cot, mm3)
    onp.testing.assert_allclose(o, o_ref, atol=F32_TOL, rtol=0)
    for a, r in zip(g[1:], g_ref[1:]):
        onp.testing.assert_allclose(a, r, atol=F32_TOL, rtol=0)


def test_3xtf32_dq_matches_pallas_at_training_length():
    """B2's arithmetic (key tiles of 64, S and dP through 3xTF32, each
    row's delta from its own P and dP (sum P dP / sum P) where the
    reference takes rowsum(dO * O), dS rounded as the reference does,
    dQ += dS.K) at T = 1024, D = 64, causal, against the Pallas dQ
    kernel in interpret mode."""
    q, k, v, cot = _inputs(1, 1, 1024, 2, 64)
    _o_ref, g_ref = _reference(q, k, v, cot)
    _o, g = _emulated(q, k, v, cot, mm3)
    onp.testing.assert_allclose(g[0], g_ref[0], atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_kernel_library_name_follows_every_header(tmp_path, monkeypatch,
                                                  edit):
    """A library is named by its source, every shared header in csrc/ and
    the flags: editing any of them names another library, so a stale one
    is never loaded.  No nvcc needed."""
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(native, "_CSRC", tmp_path)
    first = native._lib_path("kern")
    assert native._lib_path("kern") == first
    if edit == "header":
        (tmp_path / "shared.cuh").write_text("// v2\n")
    elif edit == "new_header":
        (tmp_path / "other.cuh").write_text("\n")
    else:
        (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n// v2\n')
    assert native._lib_path("kern") != first
    assert native._lib_path("kern").parent == native.BUILD_DIR


def test_flash_sources_use_tensor_cores_and_no_library_kernel():
    """B1, B2 and B3 take their products through the shared ``Mma<T>`` of
    flash_tc.cuh, which issues TF32 (three passes) and bf16 mma.sync; no
    source calls a library's kernel."""
    csrc = native._CSRC
    header = (csrc / "flash_tc.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    assert "mma3(d, a, p[0], p[4]);" in header
    assert "cp.async.cg.shared.global" in header
    for name in ("flash_fwd", "flash_bwd"):
        src = (csrc / f"{name}.cu").read_text()
        assert '#include "flash_tc.cuh"' in src
        assert "M::mma_n(" in src and "M::mma_k(" in src
    bwd = (csrc / "flash_bwd.cu").read_text()
    for kernel in ("flash_dq_tc_kernel", "flash_dkv_tc_kernel"):
        assert f"launch_{kernel.split('_')[1]}_tc<T, 64," in bwd, kernel
    for path in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        text = path.read_text().lower()
        for lib in ("cublas", "cudnn", "cutlass/gemm", "scaled_dot_product"):
            assert lib not in text, (path.name, lib)


if __name__ == "__main__":
    for label, mm in (("3xTF32", mm3), ("1xTF32", mm1)):
        o_err, dq_err, g_err = _errors(mm)
        print(f"{label}: causal B1 T1024 H2 D64 float32, max-abs error vs "
              f"the Pallas kernels (interpret mode): O {o_err:.3e}, "
              f"dQ {dq_err:.3e}, dK/dV {g_err:.3e}")
