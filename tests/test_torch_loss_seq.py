"""The port's sequence losses, ``CTCLoss`` and ``SDMLLoss``, against the
JAX package's on the same numpy inputs.

CTC runs in both layouts (``NTC``/``TNC``, labels ``NT``/``TN``), with
-1 padded labels and with explicit ``label_lengths``, with and without
``pred_lengths``; one row's label is longer than its input, an alignment
that cannot exist, where the reference returns ``optax.ctc_loss``'s
finite value built from ``log_epsilon`` (``torch.nn.functional.ctc_loss``
would give ``inf``).  Losses within 1e-4 of their max-abs, input
gradients too but for that row's (a float32 divergence, pinned against
float64), every gradient finite.  The port runs the NDArray convention
(``autograd.record()`` → ``backward``), and the tensor one.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jl
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import loss as tl

torch.set_num_threads(1)

TOL = 1e-4
B, T, K = 3, 7, 5


def _ctc_inputs(seed):
    rs = onp.random.RandomState(seed)
    pred = rs.randn(B, T, K).astype("float32")
    # row 0 repeats a label (needs a blank between), row 1 is padded,
    # row 2 asks for more frames than its pred_length gives
    label = onp.array([[1, 2, 2, 3], [4, 1, -1, -1], [3, 1, 4, 2]],
                      dtype="float32")
    return pred, label


def _rel(a, ref):
    return float(onp.abs(a - ref).max()) / max(float(onp.abs(ref).max()),
                                               1e-30)


def _run(pkg, loss_block, pred, label, extra):
    nd = pkg.nd
    p = nd.array(pred)
    p.attach_grad()
    args = [nd.array(x) for x in extra]
    with pkg.autograd.record():
        out = loss_block(p, nd.array(label), *args)
    out.backward()
    return out.asnumpy(), p.grad.asnumpy()


@pytest.mark.parametrize("lengths", ["padded", "label_lengths",
                                     "pred_lengths"])
@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN"),
                                                 ("TNC", "NT")])
def test_ctc_loss_matches_reference(layout, label_layout, lengths):
    pred, label = _ctc_inputs(len(layout + lengths))
    extra = []
    if lengths == "label_lengths":
        # lengths given, the pads overwritten with a real class
        label_lengths = (label >= 0).sum(1).astype("float32")
        label = onp.where(label < 0, 2, label).astype("float32")
        extra = [onp.full(B, T, "float32"), label_lengths]
    elif lengths == "pred_lengths":
        extra = [onp.array([T, T - 2, 3], "float32")]   # row 2: infeasible
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    want, want_grad = _run(mx, jl.CTCLoss(layout, label_layout), pred,
                           label, extra)
    with tmx.cpu():
        got, grad = _run(tmx, tl.CTCLoss(layout, label_layout), pred,
                         label, extra)
    assert got.shape == (B,)
    assert _rel(got, want) <= TOL
    assert onp.isfinite(grad).all()
    # the infeasible row's gradient is a divergence of float32 rounding
    # (test_ctc_infeasible_gradient_is_nearer_float64)
    feasible = [0, 1] if lengths == "pred_lengths" else [0, 1, 2]
    bat = 1 if layout == "TNC" else 0
    assert _rel(grad.take(feasible, bat), want_grad.take(feasible, bat)) \
        <= TOL
    if lengths == "pred_lengths":
        assert want[2] > 1e4 and onp.isfinite(got[2])


def test_ctc_infeasible_alignment_is_finite_where_torch_gives_inf():
    """A label longer than its input: the port gives the reference's
    finite value (about -log_epsilon); torch's own CTC gives inf."""
    pred, _label = _ctc_inputs(0)
    label = onp.array([[1, 2, 1, 2, 1, 2, 1, 2]] * B, "float32")
    want = jl.CTCLoss()(mx.nd.array(pred), mx.nd.array(label)).asnumpy()
    p = torch.from_numpy(pred).requires_grad_()
    got = tl.CTCLoss()(p, torch.from_numpy(label))
    grad, = torch.autograd.grad(got.sum(), p)
    assert _rel(got.detach().numpy(), want) <= TOL and (want > 1e4).all()
    assert torch.isfinite(grad).all()
    torch_ctc = torch.nn.functional.ctc_loss(
        torch.log_softmax(p.detach(), -1).transpose(0, 1),
        torch.from_numpy(label).long(), torch.full((B,), T),
        torch.full((B,), 8), reduction="none")
    assert torch.isinf(torch_ctc).all()


def test_ctc_infeasible_gradient_is_nearer_float64():
    """A divergence (ROADMAP C): on an alignment that cannot exist the
    loss, near -log_epsilon = 1e5, matches the reference, but its
    gradient differs by up to ~6e-3 of its max-abs.  The float32 spacing
    at 1e5 is 0.0078; jax differentiates ``logaddexp`` as ``exp(x -
    out)``, which carries that rounding of ``out``, torch as ``1 / (1 +
    exp(y - x))``, which does not.  The port's gradient is the nearer to
    the same recursion in float64."""
    pred, label = _ctc_inputs(3)
    plen = onp.array([T, T - 2, 3], "float32")
    p = mx.nd.array(pred)
    p.attach_grad()
    with mx.autograd.record():
        out = jl.CTCLoss()(p, mx.nd.array(label), mx.nd.array(plen))
    out.backward()
    ref = p.grad.asnumpy()[2]
    grads = {}
    for dt in (torch.float32, torch.float64):
        pt = torch.from_numpy(pred).to(dt).requires_grad_()
        loss = tl.CTCLoss()(pt, torch.from_numpy(label).to(dt),
                            torch.from_numpy(plen))
        grads[dt], = torch.autograd.grad(loss.sum(), pt)
    exact = grads[torch.float64].numpy()[2]
    port = grads[torch.float32].numpy()[2]
    assert onp.isfinite(port).all()
    assert TOL < _rel(ref, exact) <= 1e-2
    assert _rel(port, exact) < _rel(ref, exact) / 2


def test_ctc_sample_weight_and_op_form():
    pred, label = _ctc_inputs(3)
    sw = onp.array([1.0, 0.5, 2.0], "float32")
    want = jl.CTCLoss(weight=0.7)(mx.nd.array(pred), mx.nd.array(label),
                                  None, None, mx.nd.array(sw)).asnumpy()
    got = tl.CTCLoss(weight=0.7)(torch.from_numpy(pred),
                                 torch.from_numpy(label), None, None,
                                 torch.from_numpy(sw))
    assert _rel(got.numpy(), want) <= TOL
    with tmx.cpu():
        op = tl.ctc_loss(tmx.nd.array(pred), tmx.nd.array(label))
    assert isinstance(op, tmx.nd.NDArray)
    assert _rel(op.asnumpy() * 0.7 * sw, want) <= TOL


@pytest.mark.parametrize("smoothing", [0.3, 0.0])
def test_sdml_loss_matches_reference(smoothing):
    rs = onp.random.RandomState(4)
    x1 = rs.randn(6, 8).astype("float32")
    x2 = (x1 + 0.3 * rs.randn(6, 8)).astype("float32")
    a, b = mx.nd.array(x1), mx.nd.array(x2)
    a.attach_grad()
    with mx.autograd.record():
        want = jl.SDMLLoss(smoothing)(a, b)
    want.backward()
    with tmx.cpu():
        ta, tb = tmx.nd.array(x1), tmx.nd.array(x2)
        ta.attach_grad()
        with tmx.autograd.record():
            got = tl.SDMLLoss(smoothing)(ta, tb)
        got.backward()
        assert _rel(got.asnumpy(), want.asnumpy()) <= TOL
        g = ta.grad.asnumpy()
    assert onp.isfinite(g).all() and _rel(g, a.grad.asnumpy()) <= TOL
