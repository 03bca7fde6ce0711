"""The port's vision ops and layers against the JAX package's.

The same seeded numpy inputs go through both packages' ``nd`` op (or
``gluon.nn`` layer) under ``autograd.record()`` with a seeded head
gradient; values and every input's gradient are compared.  The cases
cover each layout, strides, dilation, groups and padding, the pooling
conventions where torch's own rule differs from the reference's (a
``full`` window that starts in the padding, an average divisor over a
window that overhangs the input), ``count_include_pad`` both ways,
BatchNorm in training and inference (``use_global_stats``,
``fix_gamma``, ``axis=-1``) and the layer's moving statistics over 3
calls, ``Deconvolution`` with ``adj`` (which the reference does not
apply), and the loss heads' gradients under each ``normalization``.

Tolerances: values and gradients within rtol 1e-4, atol 1e-5 (the same
float32 arithmetic, summed in another order by XLA's and torch's
convolutions and reductions).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.utils.convert import load_numpy_params

RTOL, ATOL = 1e-4, 1e-5

# one intra-op thread per test process (six xdist workers share eight
# cores in the tier-1 run)
torch.set_num_threads(1)


def _close(a, b, what):
    a, b = onp.asarray(a), onp.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    onp.testing.assert_allclose(a.astype("float64"), b.astype("float64"),
                                rtol=RTOL, atol=ATOL, err_msg=what)


def _rand(seed, *shape):
    return onp.random.RandomState(seed).randn(*shape).astype("float32")


def _run(pkg, call, inputs, train_mode=True):
    """Values of ``call(nd, *arrays)`` (an array or a list, the first
    taking the head gradient) and every input's gradient, in ``pkg``."""
    xs = [pkg.nd.array(a) for a in inputs]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record(train_mode=train_mode):
        out = call(pkg.nd, *xs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    hg = onp.random.RandomState(1).uniform(0.5, 1.5, outs[0].shape)
    outs[0].backward(pkg.nd.array(hg.astype("float32")))
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


def _both(call, inputs, train_mode=True):
    want = _run(mx, call, inputs, train_mode)
    with tmx.cpu():
        got = _run(tmx, call, inputs, train_mode)
    for kind, w, g in (("value", want[0], got[0]), ("grad", want[1], got[1])):
        assert len(w) == len(g)
        for i, (a, b) in enumerate(zip(g, w)):
            _close(a, b, f"{kind} {i}")
    return got


# ------------------------------------------------------------ Convolution

def _channels_last(x):
    return onp.ascontiguousarray(onp.moveaxis(x, 1, -1))


CONV_CASES = {
    # name: (data NC* shape, weight shape, kwargs)
    "1d": ((2, 4, 9), (6, 4, 3), dict(stride=(2,), pad=(1,))),
    "2d": ((2, 4, 9, 8), (6, 2, 3, 3),
           dict(stride=(2, 1), dilate=(1, 2), pad=(1, 2), num_group=2)),
    "2d depthwise": ((2, 4, 7, 7), (4, 1, 3, 3),
                     dict(stride=(2, 2), pad=(1, 1), num_group=4)),
    "3d": ((1, 2, 5, 6, 5), (4, 2, 3, 3, 3),
           dict(pad=(1, 1, 1), dilate=(1, 1, 2))),
}
_LAYOUTS = {3: ("NCW", "NWC"), 4: ("NCHW", "NHWC"), 5: ("NCDHW", "NDHWC")}


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["channels-first", "channels-last"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_reference(case, bias, channels_last):
    dshape, wshape, kw = CONV_CASES[case]
    x = _rand(0, *dshape)
    layout = _LAYOUTS[len(dshape)][int(channels_last)]
    if channels_last:
        x = _channels_last(x)
    inputs = [x, _rand(1, *wshape)] + ([_rand(2, wshape[0])] if bias else [])

    def call(F, x, w, *b):
        return F.Convolution(x, w, b[0] if b else None,
                             kernel=wshape[2:], num_filter=wshape[0],
                             no_bias=not b, layout=layout, **kw)
    _both(call, inputs)


def test_convolution_layouts_agree_from_one_weight():
    """NCHW and NHWC convolve the same (O, I, kH, kW) weight alike."""
    x, w = _rand(0, 2, 3, 8, 8), _rand(1, 5, 3, 3, 3)
    with tmx.cpu():
        a = tmx.nd.Convolution(tmx.nd.array(x), tmx.nd.array(w), pad=(1, 1),
                               kernel=(3, 3), num_filter=5, no_bias=True)
        b = tmx.nd.Convolution(tmx.nd.array(_channels_last(x)),
                               tmx.nd.array(w), pad=(1, 1), kernel=(3, 3),
                               num_filter=5, no_bias=True, layout="NHWC")
    _close(onp.moveaxis(b.asnumpy(), -1, 1), a.asnumpy(), "NHWC vs NCHW")


@pytest.mark.parametrize("layout,ndim", [("NHWC", 3), ("NCHW", 5),
                                         ("NCHWX", 4)])
def test_convolution_rejects_a_layout_the_reference_rejects(layout, ndim):
    shape = (1, 2) + (4,) * (ndim - 2)
    w = (3, 2) + (1,) * (ndim - 2)
    with pytest.raises(mx.base.MXNetError):
        mx.nd.Convolution(mx.nd.zeros(shape), mx.nd.zeros(w),
                          kernel=w[2:], num_filter=3, no_bias=True,
                          layout=layout)
    with tmx.cpu(), pytest.raises(MXNetError):
        tmx.nd.Convolution(tmx.nd.zeros(shape), tmx.nd.zeros(w),
                           kernel=w[2:], num_filter=3, no_bias=True,
                           layout=layout)


# ---------------------------------------------------------- Deconvolution

DECONV_CASES = {
    "1d": ((2, 4, 5), (4, 3, 3), dict(stride=(2,), pad=(1,))),
    "2d grouped": ((2, 4, 5, 4), (4, 3, 3, 2),
                   dict(stride=(2, 1), pad=(1, 0), dilate=(1, 2),
                        num_group=2)),
    "3d": ((1, 2, 3, 4, 3), (2, 2, 2, 2, 2), dict(stride=(2, 2, 2))),
}


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconvolution_matches_reference(case):
    dshape, wshape, kw = DECONV_CASES[case]
    cout = wshape[1] * kw.get("num_group", 1)
    inputs = [_rand(0, *dshape), _rand(1, *wshape), _rand(2, cout)]

    def call(F, x, w, b):
        return F.Deconvolution(x, w, b, kernel=wshape[2:], num_filter=cout,
                               no_bias=False, **kw)
    _both(call, inputs)


def test_deconvolution_ignores_adj_as_the_reference_does():
    """The reference names ``adj`` (and ``target_shape``) but does not
    apply them (MXNet would grow the output by ``adj``): the port
    matches the reference, output (in - 1) * stride + k - 2 * pad."""
    x, w = _rand(0, 1, 2, 4, 4), _rand(1, 2, 3, 3, 3)

    def call(F, x, w):
        return F.Deconvolution(x, w, kernel=(3, 3), stride=(2, 2),
                               pad=(1, 1), adj=(1, 1), num_filter=3)
    got = _both(call, [x, w])
    assert got[0][0].shape == (1, 3, 7, 7)


def test_deconvolution_rejects_channels_last():
    x, w = onp.zeros((1, 4, 4, 2), "float32"), onp.zeros((2, 3, 3, 3),
                                                         "float32")
    with tmx.cpu(), pytest.raises(MXNetError):
        tmx.nd.Deconvolution(tmx.nd.array(x), tmx.nd.array(w),
                             kernel=(3, 3), num_filter=3, layout="NHWC")


# ---------------------------------------------------------------- Pooling

POOL_CASES = {
    # name: (data NC* shape, kwargs)
    "max valid pad": ((2, 3, 7, 7), dict(kernel=(3, 3), stride=(2, 2),
                                         pad=(1, 1))),
    # in 5, k 2, s 2, pad 1: the reference's last window starts in the
    # right padding (torch's ceil_mode drops it): 4 outputs, not 3
    "max full window in padding": ((1, 2, 5, 5), dict(
        kernel=(2, 2), stride=(2, 2), pad=(1, 1),
        pooling_convention="full")),
    # in 6, k 3, s 2: the last window overhangs by one; the reference
    # divides by 3, torch's ceil_mode by the 2 it clips to
    "avg full overhang": ((1, 2, 6, 6), dict(
        kernel=(3, 3), stride=(2, 2), pool_type="avg",
        pooling_convention="full")),
    "avg full overhang exclude pad": ((1, 2, 6, 6), dict(
        kernel=(3, 3), stride=(2, 2), pool_type="avg",
        pooling_convention="full", count_include_pad=False)),
    "avg valid pad include": ((2, 3, 6, 5), dict(
        kernel=(3, 3), stride=(1, 2), pad=(1, 1), pool_type="avg")),
    "avg valid pad exclude": ((2, 3, 6, 5), dict(
        kernel=(3, 3), stride=(1, 2), pad=(1, 1), pool_type="avg",
        count_include_pad=False)),
    # a pad over half the window: torch cannot pad it itself
    "avg wide pad exclude": ((1, 2, 5, 5), dict(
        kernel=(3, 3), stride=(2, 2), pad=(2, 2), pool_type="avg",
        count_include_pad=False)),
    "sum full 1d": ((2, 3, 8), dict(kernel=(3,), stride=(2,), pad=(1,),
                                    pool_type="sum",
                                    pooling_convention="full")),
    "lp valid": ((2, 3, 6, 6), dict(kernel=(2, 2), pool_type="lp",
                                    p_value=2)),
    "max 3d": ((1, 2, 4, 5, 4), dict(kernel=(2, 2, 2), stride=(2, 1, 2))),
    "global max": ((2, 3, 5, 4), dict(global_pool=True)),
    "global avg": ((2, 3, 5, 4), dict(global_pool=True, pool_type="avg")),
    "global avg 3d": ((1, 3, 3, 4, 2), dict(global_pool=True,
                                            pool_type="avg")),
}


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["channels-first", "channels-last"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_reference(case, channels_last):
    dshape, kw = POOL_CASES[case]
    x = _rand(0, *dshape)
    layout = None
    if channels_last:
        x, layout = _channels_last(x), _LAYOUTS[len(dshape)][1]
    got = _both(lambda F, x: F.Pooling(x, layout=layout, **kw), [x])
    if case == "max full window in padding":
        assert got[0][0].shape[-2 if channels_last else -1] == 3 + 1


# -------------------------------------------------------------- BatchNorm

def _bn_inputs(c, seed=0):
    rs = onp.random.RandomState(seed)
    return [rs.uniform(0.5, 1.5, c).astype("float32"),
            rs.randn(c).astype("float32"),
            rs.randn(c).astype("float32") * 0.1,
            rs.uniform(0.5, 2.0, c).astype("float32")]


@pytest.mark.parametrize("kw,train_mode", [
    (dict(), True),
    (dict(fix_gamma=True), True),
    (dict(axis=-1), True),
    (dict(use_global_stats=True), True),
    (dict(), False),
    (dict(axis=-1, eps=1e-3), False),
], ids=["train", "train fix_gamma", "train axis=-1", "use_global_stats",
        "inference", "inference axis=-1"])
def test_batchnorm_op_matches_reference(kw, train_mode):
    x = _rand(0, 4, 3, 5, 5)
    if kw.get("axis") == -1:
        x = _channels_last(x)
    inputs = [x] + _bn_inputs(3)
    _both(lambda F, *a: F.BatchNorm(*a, output_mean_var=True, **kw),
          inputs, train_mode=train_mode)


@pytest.mark.parametrize("axis,momentum", [(1, 0.9), (-1, 0.5)])
def test_batchnorm_layer_moving_stats_over_three_calls(axis, momentum):
    """Three training calls move ``running_mean``/``running_var`` as the
    reference's layer does: ``m * old + (1 - m) * batch`` with the
    biased batch variance (the unbiased one is N/(N-1) = 50/49 larger
    here, far outside the tolerance)."""
    xs = [_rand(s, 2, 3, 5, 5) for s in range(3)]
    if axis == -1:
        xs = [_channels_last(x) for x in xs]
    ref = jnn.BatchNorm(axis=axis, momentum=momentum)
    ref.initialize()
    with tmx.cpu():
        port = tnn.BatchNorm(axis=axis, momentum=momentum)
        port.initialize()
        for x in xs:
            with mx.autograd.record():
                want = ref(mx.nd.array(x))
            with tmx.autograd.record():
                got = port(tmx.nd.array(x))
            _close(got.asnumpy(), want.asnumpy(), "output")
        for name in ("running_mean", "running_var"):
            _close(getattr(port, name).detach().numpy(),
                   getattr(ref, name).data().asnumpy(), name)
        # predict mode normalizes by the moving statistics
        _close(port(tmx.nd.array(xs[0])).asnumpy(),
               ref(mx.nd.array(xs[0])).asnumpy(), "predict")


def test_norm_ops_match_reference():
    x = _rand(0, 2, 6, 4, 3)
    g, b = _bn_inputs(6)[:2]
    _both(lambda F, x, g, b: F.GroupNorm(x, g, b, num_groups=3), [x, g, b])
    _both(lambda F, x, g, b: F.InstanceNorm(x, g, b), [x, g, b])
    _both(lambda F, x, g, b: F.InstanceNorm(x, g, b, eps=1e-5), [x, g, b])


# ------------------------------------------------------------ loss heads

@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True],
                         ids=["all", "ignore"])
def test_softmax_output_gradient_matches_reference(normalization,
                                                   use_ignore):
    """The backward is ``(p - onehot) * grad_scale`` normalized, whatever
    head gradient arrives (``_run`` sends a random one)."""
    x = _rand(0, 5, 7)
    y = onp.array([1, 0, 6, 0, 3], "float32")
    got = _both(lambda F, x, y: F.SoftmaxOutput(
        x, y, grad_scale=0.7, use_ignore=use_ignore, ignore_label=0,
        normalization=normalization), [x, y])
    p = onp.exp(x) / onp.exp(x).sum(-1, keepdims=True)
    want = (p - onp.eye(7)[y.astype(int)]) * 0.7
    if use_ignore:
        want *= (y != 0)[:, None]
    want /= {"null": 1, "batch": 5,
             "valid": 3 if use_ignore else 5}[normalization]
    _close(got[1][0], want, "gradient")


def test_linear_regression_output_gradient_matches_reference():
    x, y = _rand(0, 4, 3), _rand(1, 4, 3)
    got = _both(lambda F, x, y: F.LinearRegressionOutput(
        x, y, grad_scale=0.5), [x, y])
    _close(got[1][0], (x - y) * 0.5, "gradient")


# ----------------------------------------------------------- the rest

@pytest.mark.parametrize("name,call,shapes", [
    ("UpSampling nearest", lambda F, x: F.UpSampling(x, scale=2),
     [(2, 3, 4, 5)]),
    ("UpSampling bilinear", lambda F, x: F.UpSampling(
        x, scale=3, sample_type="bilinear"), [(1, 2, 4, 3)]),
    ("Crop like", lambda F, x, y: F.Crop(x, y, offset=(1, 2)),
     [(2, 3, 7, 8), (2, 3, 4, 5)]),
    ("Crop h_w centered", lambda F, x: F.Crop(x, h_w=(3, 4),
                                               center_crop=True),
     [(1, 2, 7, 8)]),
    ("LRN", lambda F, x: F.LRN(x, nsize=3, alpha=0.1), [(2, 6, 3, 3)]),
    ("SoftmaxActivation instance", lambda F, x: F.SoftmaxActivation(x),
     [(2, 3, 4)]),
    ("SoftmaxActivation channel", lambda F, x: F.SoftmaxActivation(
        x, mode="channel"), [(2, 3, 4)]),
    ("depth_to_space", lambda F, x: F.depth_to_space(x, 2), [(2, 8, 3, 2)]),
    ("space_to_depth", lambda F, x: F.space_to_depth(x, 2), [(2, 2, 4, 6)]),
])
def test_vision_op_matches_reference(name, call, shapes):
    _both(call, [_rand(i, *s) for i, s in enumerate(shapes)])


def test_ported_ops_left_the_not_ported_list():
    from mxnet_tpu_torch.ndarray import ops as TOPS
    ported = {"Convolution", "Deconvolution", "Pooling", "BatchNorm",
              "GroupNorm", "InstanceNorm", "SoftmaxOutput",
              "LinearRegressionOutput", "UpSampling", "Crop", "LRN",
              "SoftmaxActivation", "depth_to_space", "space_to_depth"}
    assert not ported & TOPS.NOT_YET_PORTED
    assert ported <= set(TOPS.__all__)
    assert len(TOPS.NOT_YET_PORTED) == 0


# --------------------------------------------------------------- layers

LAYERS = {
    # name: (constructor(nn), data shape)
    "Conv1D": (lambda nn: nn.Conv1D(4, 3, strides=2, padding=1),
               (2, 3, 9)),
    "Conv1D NWC": (lambda nn: nn.Conv1D(4, 3, layout="NWC",
                                        activation="relu"), (2, 9, 3)),
    "Conv2D": (lambda nn: nn.Conv2D(6, (3, 2), strides=(2, 1),
                                    padding=(1, 0), dilation=(1, 2),
                                    groups=2), (2, 4, 8, 7)),
    "Conv2D NHWC no bias": (lambda nn: nn.Conv2D(5, 3, padding=1,
                                                 use_bias=False,
                                                 layout="NHWC"),
                            (2, 6, 6, 3)),
    "Conv3D": (lambda nn: nn.Conv3D(3, 2, activation="tanh"),
               (1, 2, 4, 4, 3)),
    "Conv3D NDHWC": (lambda nn: nn.Conv3D(3, 2, layout="NDHWC"),
                     (1, 4, 4, 3, 2)),
    "Conv1DTranspose": (lambda nn: nn.Conv1DTranspose(3, 3, strides=2),
                        (2, 4, 5)),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, groups=2), (1, 4, 4, 5)),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(2, 2, strides=2),
                        (1, 3, 2, 3, 2)),
    "MaxPool1D": (lambda nn: nn.MaxPool1D(3, 2, 1), (2, 3, 8)),
    "MaxPool2D ceil NHWC": (lambda nn: nn.MaxPool2D(
        3, 2, ceil_mode=True, layout="NHWC"), (2, 8, 8, 3)),
    "MaxPool3D": (lambda nn: nn.MaxPool3D(2), (1, 2, 4, 4, 4)),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(2), (2, 3, 8)),
    "AvgPool2D exclude pad": (lambda nn: nn.AvgPool2D(
        3, 1, 1, count_include_pad=False), (2, 3, 5, 5)),
    "AvgPool3D ceil": (lambda nn: nn.AvgPool3D(3, 2, ceil_mode=True),
                       (1, 2, 6, 5, 6)),
    "GlobalMaxPool1D": (lambda nn: nn.GlobalMaxPool1D(), (2, 3, 5)),
    "GlobalMaxPool2D NHWC": (lambda nn: nn.GlobalMaxPool2D(layout="NHWC"),
                             (2, 4, 5, 3)),
    "GlobalMaxPool3D": (lambda nn: nn.GlobalMaxPool3D(), (1, 2, 3, 3, 3)),
    "GlobalAvgPool1D NWC": (lambda nn: nn.GlobalAvgPool1D(layout="NWC"),
                            (2, 5, 3)),
    "GlobalAvgPool2D": (lambda nn: nn.GlobalAvgPool2D(), (2, 3, 4, 5)),
    "GlobalAvgPool3D NDHWC": (lambda nn: nn.GlobalAvgPool3D(
        layout="NDHWC"), (1, 3, 3, 3, 2)),
    "ReflectionPad2D": (lambda nn: nn.ReflectionPad2D(2), (1, 2, 5, 5)),
    "BatchNorm": (lambda nn: nn.BatchNorm(), (4, 3, 3, 3)),
    "BatchNorm NHWC no scale": (lambda nn: nn.BatchNorm(
        axis=-1, scale=False, center=False), (4, 3, 3, 3)),
    "SyncBatchNorm": (lambda nn: nn.SyncBatchNorm(momentum=0.5),
                      (4, 3, 3, 3)),
    "GroupNorm": (lambda nn: nn.GroupNorm(num_groups=2), (2, 4, 3, 3)),
    "InstanceNorm": (lambda nn: nn.InstanceNorm(epsilon=1e-3),
                     (2, 3, 4, 4)),
}


def _ref_params(block):
    return {k: p.data().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name):
    """Deferred shapes settle on the first call to the reference's
    parameter names and shapes; from the reference's weights the output,
    the input gradient and every parameter gradient agree, and so do
    the moving statistics after the call."""
    make, shape = LAYERS[name]
    x = _rand(0, *shape)
    ref = make(jnn)
    mx.random.seed(0)
    ref.initialize(mx.init.Xavier())
    xr = mx.nd.array(x)
    xr.attach_grad()
    with mx.autograd.record():
        want = ref(xr)
    hg = onp.random.RandomState(1).uniform(0.5, 1.5, want.shape) \
        .astype("float32")
    want.backward(mx.nd.array(hg))
    ref_params = _ref_params(ref)
    with tmx.cpu():
        port = make(tnn)
        port.initialize(tmx.init.Xavier())
        port(tmx.nd.array(x))          # settles the deferred shapes
        got_shapes = {k: p.shape for k, p in port.collect_params().items()}
        assert got_shapes == {k: v.shape for k, v in ref_params.items()}
        # the reference's weights as they were before its forward
        fresh = make(jnn)
        mx.random.seed(0)
        fresh.initialize(mx.init.Xavier())
        fresh(mx.nd.array(x))
        load_numpy_params(port, _ref_params(fresh))
        xt = tmx.nd.array(x)
        xt.attach_grad()
        with tmx.autograd.record():
            got = port(xt)
        got.backward(tmx.nd.array(hg))
    _close(got.asnumpy(), want.asnumpy(), "output")
    _close(xt.grad.asnumpy(), xr.grad.asnumpy(), "data gradient")
    ref_handles = ref._collect_params_with_prefix()
    for k, p in port.collect_params().items():
        rp = ref_handles[k]
        if p.grad_req != "null":
            _close(p.grad().asnumpy(), rp.grad().asnumpy(), f"{k} grad")
        else:
            _close(p.data().asnumpy(), rp.data().asnumpy(), k)


@pytest.mark.parametrize("cls", ["Conv1DTranspose", "Conv2DTranspose",
                                 "Conv3DTranspose"])
def test_transpose_conv_layer_rejects_channels_last(cls):
    layout = {"Conv1DTranspose": "NWC", "Conv2DTranspose": "NHWC",
              "Conv3DTranspose": "NDHWC"}[cls]
    with pytest.raises(mx.base.MXNetError):
        getattr(jnn, cls)(2, 3, layout=layout)
    with pytest.raises(MXNetError):
        getattr(tnn, cls)(2, 3, layout=layout)


def test_amp_runs_convolution_in_bf16_and_batchnorm_in_float32():
    """Under ``amp.init('bfloat16')`` the dtypes at the conv and the norm
    equal the reference's (conv on the target list, BatchNorm on the
    float32 list), and the parameters stay float32."""
    x = _rand(0, 2, 3, 6, 6)

    def dtypes(pkg, nn):
        net = nn.HybridSequential()
        net.add(nn.Conv2D(4, 3), nn.BatchNorm(), nn.GroupNorm(2))
        net.initialize()
        pkg.amp.init("bfloat16")
        try:
            a = net[0](pkg.nd.array(x))
            outs = (a, net[1](a), net[2](a))
        finally:
            pkg.amp.reset()
        return ([str(v.dtype) for v in outs],
                {str(p.data().dtype) for p in net.collect_params().values()})
    want = dtypes(mx, jnn)
    with tmx.cpu():
        got = dtypes(tmx, tnn)
    assert got == want == (["bfloat16", "float32", "float32"], {"float32"})


def test_batchnorm_one_value_a_channel_normalizes_to_beta():
    """A training batch with one value a channel (torch's batch_norm
    refuses it) gives the reference's ``beta``: x - mean is 0."""
    _both(lambda F, *a: F.BatchNorm(*a, output_mean_var=True),
          [_rand(0, 1, 3)] + _bn_inputs(3))


def _bn_net():
    net = tnn.HybridSequential()
    net.add(tnn.Conv2D(4, 3, layout="NHWC"), tnn.BatchNorm(axis=-1),
            tnn.GlobalAvgPool2D(layout="NHWC"), tnn.Dense(3))
    net.initialize()
    return net


def _ce(out, labels, poison):
    return torch.logsumexp(out, -1) - out.gather(
        -1, labels.long()[:, None])[:, 0] + poison


def test_trainer_settles_deferred_shapes_without_moving_statistics():
    """``ShardedTrainer`` settles deferred shapes on a one-sample slice
    in inference mode: the moving statistics stay at their initial
    values until the first step moves them."""
    from mxnet_tpu_torch.parallel import ShardedTrainer
    x = _rand(0, 4, 6, 6, 3)
    with tmx.cpu():
        net = _bn_net()
        tr = ShardedTrainer(net, "sgd", loss=_ce).build(x)
    assert net[0].weight.shape == (4, 3, 3, 3)
    assert torch.equal(net[1].running_mean, torch.zeros(4))
    assert torch.equal(net[1].running_var, torch.ones(4))
    tr.step(x, (onp.zeros(4, "int32"), onp.zeros(4, "float32")))
    assert not torch.equal(net[1].running_mean, torch.zeros(4))


def test_guarded_nonfinite_step_leaves_moving_statistics():
    """A guarded step whose loss is not finite leaves the moving
    statistics bit-identical, as it leaves parameters and optimizer
    state (the reference selects its aux outputs the same way)."""
    from mxnet_tpu_torch.parallel import ShardedTrainer
    x, y = _rand(0, 4, 6, 6, 3), onp.zeros(4, "int32")
    with tmx.cpu():
        net = _bn_net()
        tr = ShardedTrainer(net, "sgd", loss=_ce, guard_nonfinite=True)
        _loss, ok = tr.step(x, (y, onp.zeros(4, "float32")))
        assert bool(ok)
        before = [t.clone() for t in (net[1].running_mean,
                                      net[1].running_var)]
        _loss, ok = tr.step(x, (y, onp.full(4, onp.nan, "float32")))
    assert not bool(ok)
    assert torch.equal(net[1].running_mean, before[0])
    assert torch.equal(net[1].running_var, before[1])
