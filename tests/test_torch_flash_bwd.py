"""Gradients of the port's flash attention against the JAX package's.

The port's ``ops.flash.flash_attention`` runs through its autograd
Function (plain forward and plain backward on CPU tensors, the glue the
card's B1/B2/B3 kernels sit behind); the reference is ``jax.grad`` of
``mxnet_tpu.ops.flash.flash_attention`` in Pallas interpret mode, its
custom_vjp included.  Both take the gradient of ``sum(out * cot)`` for a
random cotangent, on the same numpy inputs.

Tolerances: float32 max-abs 1e-4 (the two sides sum the same products in
another order; the gradients are O(1) to O(10)).  bf16 inputs are
compared in float32 at 1e-2 of the reference gradient's max-abs: both
sides round P, dS and the outputs to bf16 at the same places, and one
bf16 ulp is 2**-8 = 3.9e-3 of a value.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import flash as jflash
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash as tflash

F32_TOL = 1e-4
BF16_REL_TOL = 1e-2


def _inputs(seed, b, t, h, d):
    rs = onp.random.RandomState(seed)
    return [rs.randn(b, t, h, d).astype("float32") for _ in range(4)]


def _packed_segments(b, t, seed):
    """Non-decreasing segment ids: ragged packed documents per row."""
    rs = onp.random.RandomState(seed)
    seg = onp.zeros((b, t), "int32")
    for i in range(b):
        cuts = onp.sort(rs.choice(onp.arange(1, t), 2, replace=False))
        seg[i] = (onp.arange(t)[:, None] >= cuts[None, :]).sum(1)
    return seg


def _ref_grads(q, k, v, cot, dtype=jnp.float32, **kw):
    kw = {k_: (jnp.asarray(x) if isinstance(x, onp.ndarray) else x)
          for k_, x in kw.items()}
    c = jnp.asarray(cot, dtype)

    def f(q_, k_, v_):
        out = jflash.flash_attention(q_, k_, v_, interpret=True, **kw)
        return jnp.sum((out * c).astype(jnp.float32))

    grads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [onp.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, cot, dtype=torch.float32, **kw):
    kw = {k_: (torch.from_numpy(x) if isinstance(x, onp.ndarray) else x)
          for k_, x in kw.items()}
    xs = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = tflash.flash_attention(*xs, **kw)
    assert out.dtype == dtype
    loss = (out * torch.from_numpy(cot).to(dtype)).float().sum()
    return [g.float().numpy() for g in torch.autograd.grad(loss, xs)]


def _close(got, ref, tol):
    for g, r in zip(got, ref):
        onp.testing.assert_allclose(g, r, atol=tol, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_grads_match_pallas(causal, d):
    q, k, v, cot = _inputs(3 + d, 2, 256, 2, d)
    _close(_port_grads(q, k, v, cot, causal=causal),
           _ref_grads(q, k, v, cot, causal=causal), F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_with_segments_match_pallas(causal):
    q, k, v, cot = _inputs(17, 2, 256, 2, 64)
    seg = _packed_segments(2, 256, 4)
    _close(_port_grads(q, k, v, cot, causal=causal, segment_ids=seg),
           _ref_grads(q, k, v, cot, causal=causal, segment_ids=seg),
           F32_TOL)


def test_flash_grads_of_empty_rows_are_zero_and_match_pallas():
    """kv segments no query shares leave rows with no valid key (lse =
    -1e30): their dQ is zero, keys nobody attends get zero dK/dV, and
    nothing is inf or NaN on either side."""
    b, t, h, d = 2, 128, 2, 64
    q, k, v, cot = _inputs(11, b, t, h, d)
    qseg = _packed_segments(b, t, 5)
    kvseg = qseg.copy()
    kvseg[:, : t // 4] = 99           # early keys belong to no query
    kw = dict(causal=True, segment_ids=qseg, kv_segment_ids=kvseg)
    got = _port_grads(q, k, v, cot, **kw)
    _close(got, _ref_grads(q, k, v, cot, **kw), F32_TOL)
    for g in got:
        assert onp.isfinite(g).all()
    # query rows with no key of their segment at or before them attend
    # nothing, so their gradient is exactly zero
    dq, dk, dv = got
    empty = onp.array([[not (kvseg[i, : j + 1] == qseg[i, j]).any()
                        for j in range(t)] for i in range(b)])
    assert empty.any()
    assert (dq[empty] == 0).all()
    assert (dk[:, : t // 4] == 0).all() and (dv[:, : t // 4] == 0).all()


def test_flash_bf16_grads_match_pallas_in_f32():
    q, k, v, cot = _inputs(21, 2, 256, 2, 64)
    ref = _ref_grads(q, k, v, cot, dtype=jnp.bfloat16, causal=True)
    got = _port_grads(q, k, v, cot, dtype=torch.bfloat16, causal=True)
    for g, r in zip(got, ref):
        assert onp.abs(g - r).max() <= BF16_REL_TOL * onp.abs(r).max()


def test_flash_function_gives_segment_ids_no_gradient():
    q, k, v, cot = (torch.from_numpy(x) for x in _inputs(5, 1, 64, 2, 64))
    q.requires_grad_()
    seg = torch.from_numpy(_packed_segments(1, 64, 2))
    out = tflash.flash_attention(q, k, v, causal=True, segment_ids=seg)
    grads = out.grad_fn.apply(cot)
    assert len(grads) == 7
    assert grads[0].shape == q.shape
    assert all(g is None for g in grads[3:])


def test_dot_product_attention_impl_on_the_cpu():
    """On the CPU ``impl='auto'`` and ``'ref'`` take the reference path
    and agree; ``'flash'`` raises there, as the reference raises off a
    TPU, and for an explicit mask; an unknown impl raises."""
    q, k, v, _c = (torch.from_numpy(x) for x in _inputs(9, 1, 256, 2, 64))
    auto = tattn.dot_product_attention(q, k, v, causal=True)
    ref = tattn.dot_product_attention(q, k, v, causal=True, impl="ref")
    assert torch.equal(auto, ref)
    with pytest.raises(MXNetError):
        tattn.dot_product_attention(q, k, v, causal=True, impl="flash")
    mask = torch.ones((1, 1, 256, 256), dtype=torch.bool)
    with pytest.raises(MXNetError):
        tattn.dot_product_attention(q, k, v, mask=mask, impl="flash")
    with pytest.raises(MXNetError):
        tattn.dot_product_attention(q, k, v, impl="pallas")
