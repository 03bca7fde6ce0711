"""The port's ``mx.autograd`` against the JAX package's: recording and
training scopes, ``grad_req`` 'write' against 'add', ``mark_variables``,
``autograd.grad``, head gradients and custom ``Function``s, on the same
numpy inputs.  Values and gradients within rtol 1e-5, atol 1e-6 (a few
float32 operations, summed in the same order)."""
import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
X = onp.random.RandomState(0).uniform(-1, 1, (3, 4)).astype("float32")


def _close(a, b):
    onp.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _in(pkg, fn):
    """``fn(pkg)``, inside a CPU scope for the port."""
    if pkg is tmx:
        with tmx.cpu():
            return fn(pkg)
    return fn(pkg)


def _both(fn):
    want = _in(mx, fn)
    got = _in(tmx, fn)
    for a, b in zip(got, want):
        _close(onp.asarray(a), onp.asarray(b))
    return got


def test_scopes_set_the_flags():
    ag = tmx.autograd
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
            with ag.train_mode():
                assert ag.is_training() and not ag.is_recording()
        with ag.predict_mode():
            assert ag.is_recording() and not ag.is_training()
    with ag.record(train_mode=False):
        assert ag.is_recording() and not ag.is_training()
    assert not ag.is_recording() and not ag.is_training()
    prev = ag.set_recording(True)
    assert prev is False and ag.is_recording()
    ag.set_recording(prev)


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_and_add(req):
    """Two recorded iterations without zero_grad: 'write' keeps the
    gradient of one, 'add' sums both; a retained graph backward twice
    does the same."""
    def run(pkg):
        x = pkg.nd.array(X)
        x.attach_grad(grad_req=req)
        out = []
        for _ in range(2):
            with pkg.autograd.record():
                y = (x * x * 3 + pkg.nd.sin(x)).sum()
            y.backward()
            out.append(x.grad.asnumpy())
        with pkg.autograd.record():
            y = pkg.nd.exp(x).sum()
        y.backward(retain_graph=True)
        y.backward()
        out.append(x.grad.asnumpy())
        return out

    got = _both(run)
    one = 6 * X + onp.cos(X)
    _close(got[0], one)
    _close(got[1], one * (2 if req == "add" else 1))
    if req == "write":
        _close(got[2], onp.exp(X))


def test_null_grad_req_and_unrecorded_heads():
    with tmx.cpu():
        x = tmx.nd.array(X)
        x.attach_grad("null")
        assert x.grad is None
        with tmx.autograd.record():
            y = (x * 2).sum()
        with pytest.raises(tmx.MXNetError, match="record"):
            y.backward()
        x.attach_grad()
        y = (x * 2).sum()                       # outside record()
        assert not y.tensor.requires_grad
        with pytest.raises(tmx.MXNetError, match="record"):
            y.backward()
        with tmx.autograd.record():
            with tmx.autograd.pause():
                z = x * 2                       # paused: not recorded
            w = (z * x).sum()
        w.backward()
        _close(x.grad.asnumpy(), 2 * X)


def test_head_gradient_and_several_heads():
    hg = onp.random.RandomState(1).uniform(size=X.shape).astype("float32")

    def run(pkg):
        x = pkg.nd.array(X)
        x.attach_grad()
        with pkg.autograd.record():
            a = x * x
            b = pkg.nd.tanh(x).sum()
        pkg.autograd.backward([a, b], [pkg.nd.array(hg), None])
        g1 = x.grad.asnumpy()
        with pkg.autograd.record():
            c = pkg.nd.relu(x) * 4
        c.backward(pkg.nd.array(hg))
        return g1, x.grad.asnumpy()

    g1, g2 = _both(run)
    _close(g1, 2 * X * hg + 1 - onp.tanh(X) ** 2)
    _close(g2, 4 * hg * (X > 0))


def test_mark_variables_and_functional_grad():
    def run(pkg):
        x, y = pkg.nd.array(X), pkg.nd.array(X[::-1].copy())
        gx, gy = pkg.nd.zeros(X.shape), pkg.nd.zeros(X.shape)
        pkg.autograd.mark_variables([x, y], [gx, gy], grad_reqs="write")
        with pkg.autograd.record():
            z = (x * y + x).sum()
        z.backward()
        got = [gx.asnumpy(), gy.asnumpy()]
        with pkg.autograd.record():
            w = (pkg.nd.exp(x) * y).sum()
        gxs = pkg.autograd.grad(w, [x, y])
        # functional grads leave the buffers as they were
        return got + [g.asnumpy() for g in gxs] + [gx.asnumpy()]

    got = _both(run)
    _close(got[0], X[::-1] + 1)
    _close(got[1], X)
    _close(got[2], onp.exp(X) * X[::-1])
    _close(got[4], got[0])


class _Sigmoid:
    """The MXNet docs' custom sigmoid, for either package."""

    @staticmethod
    def make(pkg):
        class Sigmoid(pkg.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + pkg.nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y) * 2     # a visibly custom gradient
        return Sigmoid()


def test_custom_function():
    def run(pkg):
        x = pkg.nd.array(X)
        x.attach_grad()
        with pkg.autograd.record():
            y = _Sigmoid.make(pkg)(x)
            z = (y * 3).sum()
        z.backward()
        return y.asnumpy(), x.grad.asnumpy()

    y, g = _both(run)
    s = 1 / (1 + onp.exp(-X))
    _close(y, s)
    _close(g, 6 * s * (1 - s))


def test_dropout_follows_train_mode():
    """Dropout is active under record() and off under
    record(train_mode=False) or predict_mode, in the port as in MXNet."""
    with tmx.cpu():
        x = tmx.nd.ones((64, 64))
        with tmx.autograd.record():
            on = tmx.nd.Dropout(x, p=0.5)
        with tmx.autograd.record(train_mode=False):
            off = tmx.nd.Dropout(x, p=0.5)
        with tmx.autograd.train_mode():
            on2 = tmx.nd.Dropout(x, p=0.5)
    kept = on.asnumpy()
    assert set(onp.unique(kept)) <= {0.0, 2.0} and 0.3 < (kept == 0).mean() < 0.7
    onp.testing.assert_array_equal(off.asnumpy(), x.asnumpy())
    assert (on2.asnumpy() == 0).any()
