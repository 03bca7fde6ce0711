"""The port's ring and Ulysses attention against the JAX package's.

Four gloo ranks (``torch_dist_worker.py``, scenario ``ring``), started
once, each pass their own natural-order block (B/dp, T/sp, H, D) of the
same global q, k, v (2 x 32 x 4 heads x 8) over two meshes, sp = 4 and
dp = 2 x sp = 2, and back-propagate a fixed cotangent g; the test
stitches the blocks back together.  The reference computes the same
cases on global arrays with its ``ring_attention`` /
``ulysses_attention`` over the dp = 2 x sp = 2 mesh (``shard_map`` on
its 8-device CPU mesh) and with its single-device ``_attention_ref``
for both meshes.  Cases: ring causal or not, balanced (zigzag) or not,
packed segment ids, and Ulysses causal or not.

Tolerances: outputs 2e-4 and gradients 1e-3 max-abs, the reference's
own ring tests' bounds (``tests/test_ring_attention.py``,
``tests/test_ulysses_attention.py``): blocks merged by their logsumexp
in another order than one softmax.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest

from mxnet_tpu import parallel as jpar
from mxnet_tpu.ops.attention import _attention_ref
from mxnet_tpu.ops.ring import ring_attention as jring
from mxnet_tpu.ops.ulysses import ulysses_attention as julysses

import torch_dist_worker as W

OUT_TOL = 2e-4
GRAD_TOL = 1e-3
CASES = [("ring", False, dict(balance=False)),
         ("ring", True, dict(balance=False)),
         ("ring", True, {}),
         ("ring_seg", False, dict(balance=False)),
         ("ring_seg", True, dict(balance=False)),
         ("ring_seg", True, dict(balance=True)),
         ("ulysses", False, {}), ("ulysses", True, {})]
MESHES = {"sp4": (1, 4), "dp2sp2": (2, 2)}


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    """{(mesh, case): (out, dq, dk, dv)} stitched from the ranks."""
    outs = W.launch(4, "ring", tmp_path_factory.mktemp("ring"))
    got = {}
    b, t = W.QKV["b"], W.QKV["t"]
    for mname, (dp, sp) in MESHES.items():
        for i in range(len(CASES)):
            arrs = []
            for key in ("out", "dq", "dk", "dv"):
                rows = []
                for di in range(dp):
                    rows.append(onp.concatenate(
                        [outs[di * sp + si][f"{mname}:{i}:{key}"]
                         for si in range(sp)], axis=1))
                whole = onp.concatenate(rows, axis=0)
                assert whole.shape[:2] == (b, t)
                arrs.append(whole)
            got[(mname, i)] = arrs
    return got


def _vjp(fn, q, k, v, g):
    """Output and cotangents of ``fn``, jitted (one compile, where the
    reference's ring run eagerly compiles op by op)."""
    @jax.jit
    def both(q, k, v, g):
        out, back = jax.vjp(fn, q, k, v)
        return (out, *back(g))
    return [onp.asarray(x) for x in both(q, k, v, g)]


def _plain(case):
    """The reference's single-device attention of ``case``."""
    name, causal, _kw = CASES[case]
    (q, k, v, g), seg = W.qkv()
    mask = None
    if name == "ring_seg":
        mask = jnp.asarray(seg[:, None, :, None] == seg[:, None, None, :])
    return _vjp(lambda q, k, v: _attention_ref(q, k, v, causal=causal,
                                               mask=mask),
                *(jnp.asarray(a) for a in (q, k, v, g)))


def _sharded(case):
    """The reference's own ring / Ulysses op over dp = 2 x sp = 2."""
    name, causal, kw = CASES[case]
    (q, k, v, g), seg = W.qkv()
    mesh = jpar.make_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    if name == "ulysses":
        def fn(q, k, v):
            return julysses(q, k, v, causal=causal, mesh=mesh)
    else:
        if name == "ring_seg":
            kw = dict(kw, segment_ids=jnp.asarray(seg))

        def fn(q, k, v):
            return jring(q, k, v, causal=causal, mesh=mesh, **kw)
    return _vjp(fn, *(jnp.asarray(a) for a in (q, k, v, g)))


def _close(got, want):
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (OUT_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        onp.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{n}-{'causal' if c else 'full'}"
                              f"{'-' + str(k.get('balance')) if k else ''}"
                              for n, c, k in CASES])
def test_blocks_match_the_reference_attention(blocks, mesh, case):
    _close(blocks[(mesh, case)], _plain(case))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{n}-{'causal' if c else 'full'}"
                              f"{'-' + str(k.get('balance')) if k else ''}"
                              for n, c, k in CASES])
def test_blocks_match_the_reference_sharded_op(blocks, case):
    _close(blocks[("dp2sp2", case)], _sharded(case))


def test_shape_errors_match_the_reference():
    """The port keeps the reference's refusals: a balanced ring without
    causal masking, and Ulysses heads that do not divide over sp."""
    import torch
    import mxnet_tpu_torch.parallel as tpar
    from mxnet_tpu_torch.ops.ring import ring_attention
    from mxnet_tpu_torch.ops.ulysses import ulysses_attention
    mesh = tpar.Mesh(onp.arange(4, dtype=object).reshape(1, 1, 1, 4, 1))
    x = torch.zeros(2, 8, 6, 8)
    jm = jpar.make_mesh(dp=1, sp=4, devices=jax.devices()[:4])
    jx = jnp.zeros((2, 32, 6, 8))
    with pytest.raises(ValueError) as te:
        ring_attention(x, x, x, causal=False, balance=True, mesh=mesh)
    with pytest.raises(ValueError) as je:
        jring(jx, jx, jx, causal=False, balance=True, mesh=jm)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        ulysses_attention(x, x, x, mesh=mesh)
    with pytest.raises(ValueError) as je:
        julysses(jx, jx, jx, mesh=jm)
    assert str(te.value) == str(je.value)
