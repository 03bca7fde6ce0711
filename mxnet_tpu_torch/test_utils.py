"""Test helpers (counterpart of ``mxnet_tpu/test_utils.py``; parity:
python/mxnet/test_utils.py — assert_almost_equal, check_numeric_gradient,
check_consistency, rand_ndarray, with_seed).

``check_consistency`` runs one function on every context of its list,
by default ``mx.cpu()`` and, with a card, ``mx.gpu(0)``, and holds
every output and input gradient to the first context's.  ``download``
keeps the reference's offline behaviour: a file already on disk
resolves, anything else raises.  ``get_mnist`` serves the synthetic
surrogate when the raw files are absent.
"""
from __future__ import annotations

import functools
import random as pyrandom

import numpy as onp

from . import random as _random
from .ndarray import NDArray, array

__all__ = ["default_rtol", "default_atol", "assert_almost_equal",
           "rand_ndarray", "rand_shape_nd", "check_numeric_gradient",
           "with_seed", "same", "check_consistency", "default_context",
           "set_default_context", "list_gpus", "download", "get_mnist",
           "get_mnist_iterator", "mesh_devices"]


def mesh_devices(n):
    """The first ``n`` CUDA devices, or None when the host has fewer
    (the port's mesh is one process a device; callers skip or degrade on
    None, as the reference's)."""
    import torch
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(int(n))] \
        if count >= int(n) else None


def _as_dtype(dtype):
    """A numpy dtype; ``'bfloat16'`` (which numpy lacks) reads as
    float32, whose tolerances are bf16's below."""
    if str(dtype) == "bfloat16":
        return "bfloat16"
    return onp.dtype(dtype)


def default_rtol(dtype=onp.float32):
    dtype = _as_dtype(dtype)
    if dtype == "bfloat16":
        return 2e-2
    return {onp.dtype(onp.float16): 1e-2, onp.dtype(onp.float32): 1e-4,
            onp.dtype(onp.float64): 1e-6}.get(dtype, 1e-4)


def default_atol(dtype=onp.float32):
    dtype = _as_dtype(dtype)
    if dtype == "bfloat16":
        return 2e-2
    return {onp.dtype(onp.float16): 1e-2, onp.dtype(onp.float32): 1e-5,
            onp.dtype(onp.float64): 1e-7}.get(dtype, 1e-5)


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return onp.asarray(x)


def same(a, b):
    return onp.array_equal(_np(a), _np(b))


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    a, b = _np(a), _np(b)
    rtol = rtol if rtol is not None else default_rtol(a.dtype)
    atol = atol if atol is not None else default_atol(a.dtype)
    onp.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                err_msg=f"{names[0]} vs {names[1]}")


def rand_shape_nd(ndim, dim=10):
    return tuple(onp.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, dtype="float32", ctx=None, scale=1.0):
    return array(onp.random.uniform(-scale, scale, size=shape)
                 .astype(dtype), ctx=ctx, dtype=dtype)


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-3):
    """Finite differences of ``fn`` (NDArrays in, a scalar NDArray out)
    against autograd's gradient, input by input, on the inputs'
    device."""
    from . import autograd
    inputs = [x if isinstance(x, NDArray) else array(x) for x in inputs]
    ctxs = [x.context for x in inputs]
    for x in inputs:
        x.attach_grad()
    with autograd.record():
        out = fn(*inputs)
    out.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]

    for k, x in enumerate(inputs):
        base = x.asnumpy().astype(onp.float64)
        num_grad = onp.zeros_like(base)
        flat = base.reshape(-1)
        ng = num_grad.reshape(-1)

        def at():
            return [array(base.astype(onp.float32), ctx=ctxs[k])
                    if j == k else inputs[j] for j in range(len(inputs))]

        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            with autograd.pause():
                fp = float(fn(*at()).asscalar())
            flat[i] = orig - eps
            with autograd.pause():
                fm = float(fn(*at()).asscalar())
            flat[i] = orig
            ng[i] = (fp - fm) / (2 * eps)
        onp.testing.assert_allclose(analytic[k], num_grad, rtol=rtol,
                                    atol=atol,
                                    err_msg=f"gradient of input {k}")


def check_consistency(fn, inputs, ctx_list=None, dtypes=None, rtol=None,
                      atol=None, grad=True):
    """Run ``fn`` (NDArrays in, NDArray out) under every (context, dtype)
    configuration and hold its outputs, and with ``grad`` its input
    gradients, to the first configuration's (parity:
    test_utils.check_consistency, the GPU suite's pattern).  The default
    contexts are ``mx.cpu()`` and, with a card, ``mx.gpu(0)``; on a host
    without one it checks dtypes only.  Returns the (ctx, dtype,
    outputs, grads) of each configuration."""
    from . import autograd, context as ctx_mod

    if ctx_list is None:
        ctx_list = [ctx_mod.cpu()]
        if ctx_mod.num_gpus():
            ctx_list.append(ctx_mod.gpu(0))
    dtypes = list(dtypes or ["float32"])
    inputs = [_np(x) for x in inputs]

    results = []
    for ctx in ctx_list:
        for dt in dtypes:
            xs = []
            for a in inputs:
                floating = onp.issubdtype(a.dtype, onp.floating)
                xs.append(array(a.astype(onp.float32) if floating else a,
                                ctx=ctx, dtype=dt if floating else None))
            if grad:
                for x in xs:
                    x.attach_grad()
                with autograd.record():
                    out = fn(*xs)
                    outs = list(out) if isinstance(out, (tuple, list)) \
                        else [out]
                    head = outs[0].sum() if outs[0].size > 1 else outs[0]
                head.backward()
                grads = [x.grad.asnumpy().astype(onp.float64)
                         if x.grad is not None else None for x in xs]
            else:
                out = fn(*xs)
                outs = list(out) if isinstance(out, (tuple, list)) else [out]
                grads = None
            results.append((ctx, dt,
                            [o.asnumpy().astype(onp.float64) for o in outs],
                            grads))

    ref_ctx, ref_dt, ref_outs, ref_grads = results[0]
    for ctx, dt, outs, grads in results[1:]:
        rt = rtol if rtol is not None else max(default_rtol(dt),
                                               default_rtol(ref_dt))
        at = atol if atol is not None else max(default_atol(dt),
                                               default_atol(ref_dt))
        for i, (a, b) in enumerate(zip(ref_outs, outs)):
            onp.testing.assert_allclose(
                b, a, rtol=rt, atol=at,
                err_msg=f"output {i}: {ctx}/{dt} vs {ref_ctx}/{ref_dt}")
        if grad and ref_grads is not None:
            for i, (a, b) in enumerate(zip(ref_grads, grads)):
                if a is None or b is None:
                    continue
                onp.testing.assert_allclose(
                    b, a, rtol=rt, atol=at,
                    err_msg=f"grad {i}: {ctx}/{dt} vs {ref_ctx}/{ref_dt}")
    return results


def default_context():
    """The current default context (parity: default_context)."""
    from . import context as ctx_mod
    return ctx_mod.current_context()


def set_default_context(ctx):
    """Make ``ctx`` this thread's default context (parity:
    set_default_context): it replaces the innermost ``with ctx:`` scope,
    or becomes the outermost one."""
    from . import context as ctx_mod
    stack = getattr(ctx_mod._SCOPES, "stack", None)
    if stack:
        stack[-1] = ctx
    else:
        ctx_mod._SCOPES.stack = [ctx]


def list_gpus():
    """Indices of the visible CUDA devices (parity: list_gpus)."""
    from . import context as ctx_mod
    return list(range(ctx_mod.num_gpus()))


def download(url, fname=None, dirname=None, overwrite=False):
    """Parity: test_utils.download.  Nothing is fetched: a file already
    on disk resolves, anything else raises."""
    import os
    fname = fname or url.split("/")[-1]
    if dirname:
        fname = os.path.join(dirname, fname)
    if os.path.exists(fname):
        if overwrite:
            import warnings
            warnings.warn(
                f"download({url!r}, overwrite=True): nothing is fetched "
                f"here — using the existing {fname!r} unrefreshed")
        return fname
    from . import base
    raise base.MXNetError(
        f"download({url!r}): nothing is fetched here and {fname!r} does "
        "not exist locally")


def get_mnist():
    """MNIST as a numpy dict (parity: test_utils.get_mnist); the
    deterministic synthetic surrogate when the raw files are absent (the
    data ``gluon.data.vision.MNIST`` serves)."""
    from .gluon.data.vision import MNIST
    tr, te = MNIST(train=True), MNIST(train=False)

    def arr(x):
        return x.asnumpy() if isinstance(x, NDArray) else onp.asarray(x)

    return {
        "train_data": arr(tr._data).reshape(-1, 1, 28, 28)
        .astype(onp.float32) / 255.0,
        "train_label": arr(tr._label).ravel(),
        "test_data": arr(te._data).reshape(-1, 1, 28, 28)
        .astype(onp.float32) / 255.0,
        "test_label": arr(te._label).ravel(),
    }


def get_mnist_iterator(batch_size, input_shape, num_parts=1, part_index=0):
    """(train_iter, val_iter) NDArrayIters over MNIST (parity:
    get_mnist_iterator)."""
    from .io import NDArrayIter
    mnist = get_mnist()
    shape = (-1,) + tuple(input_shape)
    tr_data = mnist["train_data"].reshape(shape)
    te_data = mnist["test_data"].reshape(shape)
    if num_parts > 1:
        n = tr_data.shape[0] // num_parts
        sl = slice(part_index * n, (part_index + 1) * n)
        tr_data, tr_label = tr_data[sl], mnist["train_label"][sl]
    else:
        tr_label = mnist["train_label"]
    train = NDArrayIter(tr_data, tr_label, batch_size, shuffle=True)
    val = NDArrayIter(te_data, mnist["test_label"], batch_size)
    return train, val


def with_seed(seed=None):
    """Decorator seeding Python's, numpy's and the framework's generators
    for a test (parity: tests/python/unittest/common.py)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            s = seed if seed is not None else onp.random.randint(0, 2**31)
            pyrandom.seed(s)
            onp.random.seed(s)
            _random.seed(s)
            try:
                return fn(*args, **kwargs)
            except Exception:
                print(f"Test failed with seed {s}")
                raise
        return wrapper

    return deco
