"""The port's flash attention and attention dispatch against the JAX
package (``mxnet_tpu.ops.flash`` in Pallas interpret mode, and
``mxnet_tpu.ops.attention``), on the same numpy inputs.

Tolerances: float32 max-abs 1e-5 (the two sides reassociate the softmax
sums differently, nothing else); bf16 inputs are compared in float32 at
1e-2 (one bf16 ulp of an output near 1 is 3.9e-3).  On the CPU the
port's wrapper runs its plain version; the CUDA kernel itself is held to
that plain version on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops import flash as jflash
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash as tflash

F32_TOL = 1e-5
BF16_TOL = 1e-2


def _qkv(seed, b, t, h, d):
    rs = onp.random.RandomState(seed)
    return [rs.randn(b, t, h, d).astype("float32") for _ in range(3)]


def _packed_segments(b, t, seed):
    """Non-decreasing segment ids: ragged packed documents per row."""
    rs = onp.random.RandomState(seed)
    seg = onp.zeros((b, t), "int32")
    for i in range(b):
        cuts = onp.sort(rs.choice(onp.arange(1, t), 2, replace=False))
        seg[i] = (onp.arange(t)[:, None] >= cuts[None, :]).sum(1)
    return seg


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_matches_pallas(causal, d):
    q, k, v = _qkv(1 + d, 2, 256, 2, d)
    ref = onp.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    out = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    onp.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_segment_ids_match_pallas(causal):
    q, k, v = _qkv(7, 2, 256, 2, 64)
    seg = _packed_segments(2, 256, 3)
    ref = onp.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=jnp.asarray(seg)))
    out = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 segment_ids=torch.from_numpy(seg))
    onp.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=0)


def test_flash_lse_and_empty_rows_match_pallas_fwd():
    """The logsumexp the backward will need, and the empty-row rule:
    kv segments that no query shares leave rows with no valid key, which
    give O = 0 and lse = -1e30 on both sides."""
    b, t, h, d = 2, 128, 2, 64
    q, k, v = _qkv(11, b, t, h, d)
    qseg = _packed_segments(b, t, 5)
    kvseg = qseg.copy()
    kvseg[:, : t // 4] = 99           # early keys belong to no query
    scale = d ** -0.5

    def flat(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)

    o_ref, lse_ref = jflash._fwd(
        flat(q), flat(k), flat(v), jnp.asarray(qseg)[:, None, :],
        jnp.asarray(kvseg)[:, None, :], h, True, scale, t, t, True)
    o, lse = tflash.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qseg), torch.from_numpy(kvseg), causal=True,
        scale=scale)
    o_ref = onp.asarray(o_ref).reshape(b, h, t, d).transpose(0, 2, 1, 3)
    onp.testing.assert_allclose(o.numpy(), o_ref, atol=F32_TOL, rtol=0)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(lse_ref),
                                atol=F32_TOL, rtol=0)
    assert tuple(lse.shape) == (b * h, 1, t)
    empty = lse.numpy()[:, 0, :] <= -1e29
    assert empty.any()
    o_rows = o.numpy().transpose(0, 2, 1, 3).reshape(b * h, t, d)
    assert (o_rows[empty] == 0).all()


def test_flash_bf16_inputs_match_pallas_in_f32():
    q, k, v = _qkv(21, 2, 256, 2, 64)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref = onp.asarray(jflash.flash_attention(*jb, causal=True)
                      .astype(jnp.float32))
    # the same bf16 values on the torch side (bf16 <- f32 rounds to
    # nearest-even in both frameworks)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    out = tflash.flash_attention(*tb, causal=True)
    assert out.dtype == torch.bfloat16
    onp.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_TOL,
                                rtol=0)


def _nd(x):
    return mx.nd.array(x)


@pytest.mark.parametrize("case", ["causal", "segments", "mask",
                                  "causal_tq_gt_tk"])
def test_dot_product_attention_matches_reference(case):
    b, tq, h, d = 2, 16, 2, 16
    q, k, v = _qkv(31, b, tq, h, d)
    kw_j, kw_t = {}, {}
    if case == "causal":
        kw_j = kw_t = {"causal": True}
    elif case == "segments":
        seg = _packed_segments(b, tq, 9)
        kw_j = {"segment_ids": jnp.asarray(seg), "causal": True}
        kw_t = {"segment_ids": torch.from_numpy(seg), "causal": True}
    elif case == "mask":
        rs = onp.random.RandomState(2)
        mask = rs.rand(b, 1, tq, tq) > 0.4
        mask[0, 0, 3, :] = False          # a fully masked row → zeros
        kw_j = {"mask": _nd(mask.astype("float32")) > 0}
        kw_t = {"mask": torch.from_numpy(mask)}
    else:
        # causal with tq > tk: the first tq - tk rows see no key
        k, v = k[:, :10], v[:, :10]
        kw_j = kw_t = {"causal": True}
    ref = jattn.dot_product_attention(_nd(q), _nd(k), _nd(v),
                                      **kw_j).asnumpy()
    out = tattn.dot_product_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), **kw_t)
    onp.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=0)
    if case == "mask":
        assert (out.numpy()[0, 3] == 0).all()


def test_dispatch_and_other_devices_raise():
    """The dispatcher routes to the kernel only for CUDA tensors of the
    shapes it takes, and its CPU answer is the reference's; the kernel
    wrapper picks the plain version only for CPU tensors — any other
    device launches the kernel or raises, never a silent fallback."""
    q, k, v = _qkv(41, 1, 256, 2, 64)
    x = torch.from_numpy(q)
    assert not tattn._use_flash(x, x, None)
    ref = onp.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True)
    onp.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=0)
    m = torch.zeros((1, 256, 2, 64), device="meta")
    with pytest.raises(MXNetError):
        tflash.flash_fwd(m, m, m, causal=True, scale=0.125)
