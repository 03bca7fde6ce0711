"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips on a host without a CUDA device.
Run on the card with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``
(``--noconftest`` because ``tests/conftest.py`` configures JAX).

Tolerances (max-abs): float32 1e-4 (reassociated softmax sums), bf16
2e-2 (one bf16 ulp of an output near 1 is 3.9e-3), int8 pages 1e-4
against the plain version's own dequantize of the same pages.  The
backward kernels are held as max-abs error over the plain version's
max-abs, at the same two numbers: their gradients reach O(10).
"""
import time

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.ops import attention, flash, launches, paged

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _maxabs(a, b):
    return float((a.float() - b.float()).abs().max())


def _launches(fn):
    """A flash wrapper's launches over every dtype."""
    return sum(fn.launches_by_dtype.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,seg,d", [(True, False, 64),
                                          (False, False, 128),
                                          (True, True, 64),
                                          (True, False, 256)])
def test_flash_kernel_matches_plain(dev, dtype, causal, seg, d):
    g = torch.Generator(device=dev).manual_seed(d + causal)
    b, t, h = 2, 300, 3          # T not a multiple of the 64-row tile
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev)
               .to(dtype) for _ in range(3))
    qseg = None
    if seg:
        qseg = (torch.arange(t, device=dev) >= 100).to(torch.int32)
        qseg = (qseg + (torch.arange(t, device=dev) >= 250)).to(torch.int32)
        qseg = qseg[None].expand(b, t).contiguous()
    n0 = _launches(flash.flash_fwd)
    o, lse = flash.flash_fwd(q, k, v, qseg, qseg, causal=causal,
                             scale=d ** -0.5)
    torch.cuda.synchronize()
    assert _launches(flash.flash_fwd) == n0 + 1
    o_ref, lse_ref = flash._fwd_plain(q, k, v, qseg, qseg, causal,
                                      d ** -0.5)
    assert _maxabs(o, o_ref) <= TOL[dtype]
    assert _maxabs(lse, lse_ref) <= TOL[dtype]


def test_flash_kernels_at_training_shape_match_plain_and_repeat(dev):
    """B1, B2 and B3 at the training path's shape (T = 1024, D = 64,
    float32, causal; batch and heads cut to 2): within the float32
    tolerance of their plain versions, and bit-identical on a second
    launch."""
    g = torch.Generator(device=dev).manual_seed(1024)
    b, t, h, d = 2, 1024, 2, 64
    q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev)
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = flash.flash_fwd(q, k, v, causal=True, scale=scale)
    o_ref, lse_ref = flash._fwd_plain(q, k, v, None, None, True, scale)
    assert _maxabs(o, o_ref) <= TOL[torch.float32]
    assert _maxabs(lse, lse_ref) <= TOL[torch.float32]
    o2, lse2 = flash.flash_fwd(q, k, v, causal=True, scale=scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    args = (q, k, v, do, lse, None, None)
    dq, dk, dv = flash.flash_bwd(*args, causal=True, scale=scale)
    for a, r in zip((dq, dk, dv), flash._bwd_plain(*args, True, scale)):
        assert _maxabs(a, r) <= TOL[torch.float32] * float(r.abs().max())
    again = flash.flash_bwd(*args, causal=True, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))


def _segments(dev, b, t):
    qseg = (torch.arange(t, device=dev) >= 100).to(torch.int32)
    qseg = (qseg + (torch.arange(t, device=dev) >= 250)).to(torch.int32)
    return qseg[None].expand(b, t).contiguous()


def _check_bwd(args, dtype, causal, scale):
    """B2 then B3 on ``args`` (q, k, v, dO, lse, segment ids): one launch
    each; B2's dQ and the delta it computes, and B3's dK and dV fed that
    delta, within ``TOL`` of their plain versions (over the plain
    result's max-abs); bit-identical on a second launch."""
    n0 = (_launches(flash.flash_dq), _launches(flash.flash_dkv))
    dq, delta = flash.flash_dq(*args, causal=causal, scale=scale)
    dk, dv = flash.flash_dkv(*args[:5], delta, *args[5:], causal=causal,
                             scale=scale)
    torch.cuda.synchronize()
    assert (_launches(flash.flash_dq), _launches(flash.flash_dkv)) == \
        (n0[0] + 1, n0[1] + 1)
    dq_ref, delta_ref = flash._dq_plain(*args, causal, scale)
    dk_ref, dv_ref = flash._dkv_plain(*args[:5], delta_ref, *args[5:],
                                      causal, scale)
    for a, r in ((dq, dq_ref), (delta, delta_ref), (dk, dk_ref),
                 (dv, dv_ref)):
        assert bool(torch.isfinite(a).all())
        assert _maxabs(a, r) <= TOL[dtype] * float(r.float().abs().max())
    assert all(a.dtype == dtype for a in (dq, dk, dv))
    again = flash.flash_bwd(*args, causal=causal, scale=scale)
    assert all(torch.equal(a, c) for a, c in zip((dq, dk, dv), again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,seg,d", [(True, False, 64),
                                          (False, False, 128),
                                          (True, True, 64),
                                          (True, False, 256),
                                          (False, True, 256)])
def test_flash_dq_ring_modes_match_plain_and_compose(dev, dtype, causal,
                                                     seg, d):
    """B2's ring modes at T = 300: ``partial`` (sum P dP, sum P) and
    ``given`` (dQ from a given delta) within ``TOL`` of their plain
    versions, one launch each, counted by mode; and composed they are
    the single call bit for bit: the single call's delta is partial's
    sums divided, and ``given`` fed it returns the single call's dQ."""
    g = torch.Generator(device=dev).manual_seed(7 * d + causal)
    b, t, h = 2, 300, 3
    q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    qseg = _segments(dev, b, t) if seg else None
    scale = d ** -0.5
    _o, lse = flash.flash_fwd(q, k, v, qseg, qseg, causal=causal,
                              scale=scale)
    args = (q, k, v, do, lse, qseg, qseg)
    kw = dict(causal=causal, scale=scale)
    modes0 = dict(flash.flash_dq.launches_by_mode)
    pdp, psum = flash.flash_dq(*args, mode="partial", **kw)
    dq_own, delta_own = flash.flash_dq(*args, **kw)
    dq_given = flash.flash_dq(*args, mode="given", delta=delta_own, **kw)
    torch.cuda.synchronize()
    assert {m: flash.flash_dq.launches_by_mode[m] - modes0[m]
            for m in modes0} == {"own": 1, "partial": 1, "given": 1}
    rp, rs = flash._dq_partial_plain(*args, causal, scale)
    rdq, _ = flash._dq_plain(*args, causal, scale, delta_own)
    for a, r in ((pdp, rp), (psum, rs), (dq_given, rdq)):
        assert bool(torch.isfinite(a).all())
        assert _maxabs(a, r) <= TOL[dtype] * float(r.float().abs().max())
    delta = torch.where(psum > 0, pdp / torch.where(psum > 0, psum,
                                                    torch.ones_like(psum)),
                        torch.zeros_like(psum))
    assert torch.equal(delta, delta_own)
    assert torch.equal(dq_given, dq_own)
    with pytest.raises(Exception, match="given"):
        flash.flash_dq(*args, mode="given", **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,seg,d", [(True, False, 64),
                                          (False, False, 128),
                                          (True, True, 64),
                                          (True, False, 256),
                                          (False, False, 256)])
def test_flash_bwd_kernels_match_plain_and_repeat(dev, dtype, causal, seg,
                                                  d):
    """B2 and B3 at T = 300 (not a multiple of any tile), every head dim,
    causal or full, with and without segments (:func:`_check_bwd`)."""
    g = torch.Generator(device=dev).manual_seed(d + 7 * causal)
    b, t, h = 2, 300, 3          # T not a multiple of any tile
    q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    qseg = _segments(dev, b, t) if seg else None
    scale = d ** -0.5
    _o, lse = flash.flash_fwd(q, k, v, qseg, qseg, causal=causal,
                              scale=scale)
    _check_bwd((q, k, v, do, lse, qseg, qseg), dtype, causal, scale)


def test_flash_route_is_differentiable_on_card(dev):
    """The repaired fault: attention on the card at T = 256 goes through
    the flash kernels with autograd, so q_proj of a training forward
    gets a gradient, and it equals the reference path's."""
    from mxnet_tpu_torch.base import training_mode
    from mxnet_tpu_torch.models.transformer import MultiHeadAttention
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 256, 2, 64), generator=g, device=dev)
               .requires_grad_() for _ in range(3))
    cot = torch.randn((2, 256, 2, 64), generator=g, device=dev)
    n0 = _launches(flash.flash_dq)
    grads = {}
    for impl in ("auto", "ref"):
        out = attention.dot_product_attention(q, k, v, causal=True,
                                              impl=impl)
        grads[impl] = torch.autograd.grad((out * cot).sum(), (q, k, v))
    assert _launches(flash.flash_dq) == n0 + 1
    for a, r in zip(grads["auto"], grads["ref"]):
        assert _maxabs(a, r) <= 1e-4 * float(r.abs().max())
    mha = MultiHeadAttention(128, 2, causal=True).initialize(device=dev)
    x = torch.randn((2, 256, 128), generator=g, device=dev)
    with training_mode(True):
        mha(x).sum().backward()
    assert mha.q_proj.weight.grad is not None
    assert float(mha.q_proj.weight.grad.abs().max()) > 0


def test_trainer_step_on_card_matches_cpu(dev):
    """Two Adam steps of a small GPT-2 at T = 256 (the card's run takes
    B1/B2/B3) agree with the same steps on the CPU (reference
    attention): losses relative 1e-5, parameters max-abs 1e-4.  On the
    card the step is one graph: B3 launches once a layer in the first
    step's warm-up (before its capture) and once a layer a replay."""
    from mxnet_tpu_torch.models import gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    rs = onp.random.RandomState(0)
    toks, labels = (rs.randint(0, 256, (2, 256)).astype("int32")
                    for _ in range(2))
    nets = {"cpu": _small_gpt2(3, device="cpu")}
    nets["cuda"] = _small_gpt2(3, device=dev)
    nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    losses, n0 = {}, _launches(flash.flash_dkv)
    for where, net in nets.items():
        tr = ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                            optimizer_params={"learning_rate": 1e-3})
        losses[where] = [float(tr.step(toks, labels)) for _ in range(2)]
    assert _launches(flash.flash_dkv) == n0 + 2 + 2 * 2
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-5)
    for (name, a), b in zip(nets["cuda"].named_parameters(),
                            nets["cpu"].parameters()):
        assert _maxabs(a.detach().cpu(), b.detach()) <= 1e-4, name


def test_gluon_loop_on_card_matches_cpu(dev):
    """Two steps of the MXNet loop (``mx.nd`` inputs, ``record()``,
    SoftmaxCE, ``backward``, ``gluon.Trainer`` Adam) on a small GPT-2 at
    T = 256: on the card each step launches B1, B2 and B3 once a layer,
    and the run agrees with the CPU's: losses relative 1e-5, step-1
    gradients max-abs 1e-4 of their own max-abs (``k_proj.bias``, zero in
    exact arithmetic, of the largest), parameters max-abs 1e-4."""
    import mxnet_tpu_torch as mx
    rs = onp.random.RandomState(1)
    toks, labels = (rs.randint(0, 256, (2, 256)).astype("int32")
                    for _ in range(2))
    nets = {"cpu": _small_gpt2(3, device="cpu")}
    nets["cuda"] = _small_gpt2(3, device=dev)
    nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    kernels = (flash.flash_fwd, flash.flash_dq, flash.flash_dkv)
    n0 = [_launches(k) for k in kernels]
    runs = {}
    for where, net in nets.items():
        with (mx.cpu() if where == "cpu" else mx.gpu(0)):
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": 1e-3})
            loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            x = mx.nd.array(toks, dtype="int32")
            y = mx.nd.array(labels, dtype="int32")
            losses, grads = [], None
            for _ in range(2):
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                if grads is None:
                    grads = {k: p.grad().tensor.detach().cpu().clone()
                             for k, p in net.collect_params().items()}
                trainer.step(x.shape[0])
                losses.append(float(loss.mean().asscalar()))
        runs[where] = losses, grads
    assert [_launches(k) - n for k, n in zip(kernels, n0)] == [4, 4, 4]
    assert runs["cuda"][0] == pytest.approx(runs["cpu"][0], rel=1e-5)
    ref = runs["cpu"][1]
    top = max(float(g.abs().max()) for g in ref.values())
    for name, g in runs["cuda"][1].items():
        scale = top if name.endswith("k_proj.bias") else \
            float(ref[name].abs().max())
        assert _maxabs(g, ref[name]) <= 1e-4 * scale, name
    for (name, a), b in zip(nets["cuda"].named_parameters(),
                            nets["cpu"].parameters()):
        assert _maxabs(a.detach().cpu(), b.detach()) <= 1e-4, name


def test_amp_gluon_loop_runs_bf16_kernels_on_card(dev):
    """One step of the MXNet loop under ``amp.init()`` on a small GPT-2
    at T = 256: B1, B2 and B3 launch once a layer with bf16 q/k/v, the
    parameters and gradients stay float32, and the loss agrees with the
    same step under amp on the CPU within 2e-2 relative (bf16 products
    summed in another order)."""
    import mxnet_tpu_torch as mx
    rs = onp.random.RandomState(2)
    toks, labels = (rs.randint(0, 256, (2, 256)).astype("int32")
                    for _ in range(2))
    nets = {"cpu": _small_gpt2(4, device="cpu")}
    nets["cuda"] = _small_gpt2(4, device=dev)
    nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    kernels = (flash.flash_fwd, flash.flash_dq, flash.flash_dkv)
    n0 = [k.launches_by_dtype[torch.bfloat16] for k in kernels]
    losses = {}
    mx.amp.init()
    try:
        for where, net in nets.items():
            with (mx.cpu() if where == "cpu" else mx.gpu(0)):
                trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                           {"learning_rate": 0.1})
                x = mx.nd.array(toks, dtype="int32")
                y = mx.nd.array(labels, dtype="int32")
                with mx.autograd.record():
                    logits = net(x)
                    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(logits, y)
                assert logits.tensor.dtype == torch.bfloat16
                loss.backward()
                trainer.step(x.shape[0])
                losses[where] = float(loss.mean().asscalar())
                for k, p in net.collect_params().items():
                    assert p.data().tensor.dtype == torch.float32, k
                    assert p.grad().tensor.dtype == torch.float32, k
    finally:
        mx.amp.reset()
    assert [k.launches_by_dtype[torch.bfloat16] - n
            for k, n in zip(kernels, n0)] == [2, 2, 2]
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=2e-2)


def test_deferred_mlp_materializes_on_card(dev):
    """The canonical program's net: every shape deferred by
    ``initialize`` materializes on the card at the first batch, and the
    hybridized output equals the imperative one."""
    import mxnet_tpu_torch as mx
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Flatten(),
            mx.gluon.nn.Dense(128, activation="relu"), mx.gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier())
    x = mx.nd.array(onp.random.RandomState(0).rand(8, 1, 28, 28)
                    .astype("float32"), ctx=mx.gpu(0))
    imp = net(x)
    net.hybridize(static_alloc=True)
    assert torch.equal(net(x).tensor, imp.tensor)
    w = net.collect_params()["1.weight"]
    assert w.shape == (128, 784) and w.data().tensor.is_cuda


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("tq", [1, 16])
def test_paged_kernel_matches_plain(dev, kind, tq):
    g = torch.Generator(device=dev).manual_seed(tq)
    b, h, d, ps, npt, n = 5, 4, 64, 16, 8, 30
    kf = torch.randn((n, ps, h, d), generator=g, device=dev)
    vf = torch.randn((n, ps, h, d), generator=g, device=dev)
    kf[-1] = 0
    vf[-1] = 0
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    q = torch.randn((b, tq, h, d), generator=g, device=dev).to(dtype)
    table = torch.randint(0, n - 1, (b, npt), generator=g,
                          device=dev).to(torch.int32)
    table[-1] = n - 1                      # a parked slot
    qpos = (torch.randint(0, npt * ps - tq, (b, 1), generator=g, device=dev)
            + torch.arange(tq, device=dev)).to(torch.int32)
    ks = vs = None
    if kind == "int8":
        kp, ks = paged.kv_quantize(kf)
        vp, vs = paged.kv_quantize(vf)
    else:
        kp, vp = kf.to(dtype), vf.to(dtype)
    out = paged.paged_attention(q, kp, vp, table, qpos, k_scale=ks,
                                v_scale=vs)
    torch.cuda.synchronize()
    ref = paged._paged_plain(q, kp, vp, table, qpos, ks, vs, d ** -0.5)
    assert _maxabs(out, ref) <= TOL[dtype]
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("tq", [1, 16])
def test_paged_kernel_split_walks_match_plain_and_repeat(dev, kind, tq):
    """The split walk and merge on walks of 1, 4, 33 and all 64 pages of
    16 keys (splits of 4 pages: inside the first, on its boundary, past
    the eighth, every split), a parked row on the zero page and a row
    with no key: within tolerance of the plain version, finite, zero for
    the keyless row, bit-identical on a second launch."""
    g = torch.Generator(device=dev).manual_seed(64 + tq)
    h, d, ps, npt = 12, 64, 16, 64
    b, n = 6, 6 * 64 + 1
    kf = torch.randn((n, ps, h, d), generator=g, device=dev)
    vf = torch.randn((n, ps, h, d), generator=g, device=dev)
    kf[-1] = 0
    vf[-1] = 0
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    q = torch.randn((b, tq, h, d), generator=g, device=dev).to(dtype)
    table = torch.randperm(n - 1, generator=g, device=dev)[:b * npt] \
        .reshape(b, npt).to(torch.int32)
    table[4] = n - 1                       # parked on the zero page
    last = torch.tensor([10, 3 * ps + 5, 32 * ps + 7, npt * ps - 1,
                         npt * ps, -1], device=dev)
    qpos = (last[:, None] - torch.arange(tq - 1, -1, -1, device=dev))
    qpos[5] = -1
    qpos = qpos.to(torch.int32).contiguous()
    ks = vs = None
    if kind == "int8":
        kp, ks = paged.kv_quantize(kf)
        vp, vs = paged.kv_quantize(vf)
    else:
        kp, vp = kf.to(dtype), vf.to(dtype)
    n0 = paged.paged_attention.launches
    out = paged.paged_attention(q, kp, vp, table, qpos, k_scale=ks,
                                v_scale=vs)
    torch.cuda.synchronize()
    assert paged.paged_attention.launches == n0 + 1
    ref = paged._paged_plain(q, kp, vp, table, qpos, ks, vs, d ** -0.5)
    assert _maxabs(out, ref) <= TOL[dtype]
    assert bool(torch.isfinite(out).all())
    assert bool((out[5] == 0).all())
    assert torch.equal(out, paged.paged_attention(q, kp, vp, table, qpos,
                                                  k_scale=ks, v_scale=vs))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_paged_kernel_at_head_dim_32_matches_plain(dev, kind):
    """The smallest head dim the kernel is built for, at decode and on
    the parked zero-page row."""
    g = torch.Generator(device=dev).manual_seed(32)
    b, h, d, ps, npt, n = 4, 4, 32, 16, 16, 4 * 16 + 1
    kf = torch.randn((n, ps, h, d), generator=g, device=dev)
    vf = torch.randn((n, ps, h, d), generator=g, device=dev)
    kf[-1] = 0
    vf[-1] = 0
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    q = torch.randn((b, 1, h, d), generator=g, device=dev).to(dtype)
    table = torch.randperm(n - 1, generator=g, device=dev).reshape(b, npt) \
        .to(torch.int32)
    table[-1] = n - 1
    qpos = torch.tensor([[5], [100], [npt * ps - 1], [npt * ps]],
                        dtype=torch.int32, device=dev)
    ks = vs = None
    if kind == "int8":
        kp, ks = paged.kv_quantize(kf)
        vp, vs = paged.kv_quantize(vf)
    else:
        kp, vp = kf.to(dtype), vf.to(dtype)
    out = paged.paged_attention(q, kp, vp, table, qpos, k_scale=ks,
                                v_scale=vs)
    torch.cuda.synchronize()
    ref = paged._paged_plain(q, kp, vp, table, qpos, ks, vs, d ** -0.5)
    assert _maxabs(out, ref) <= TOL[dtype]
    assert bool(torch.isfinite(out).all())


def _small_gpt2(seed, device=None):
    from mxnet_tpu_torch.models import get_gpt2
    net = get_gpt2("gpt2_124m", vocab_size=256, units=128, num_layers=2,
                   num_heads=2, max_length=512, dropout=0.0, device=device)
    return net.initialize(seed=seed)


def test_engine_arms_agree_on_card(dev):
    """Greedy streams of the paged kernel arm, the gather arm and the
    dense layout agree on the card; prompts in the 384 bucket run B1."""
    from mxnet_tpu_torch.serving import InferenceEngine
    net = _small_gpt2(1)
    rs = onp.random.RandomState(0)
    prompts = [rs.randint(0, 256, (n,)).astype("int32")
               for n in (260, 300, 20)]
    outs = {}
    for arm in ("kernel", "gather", "dense"):
        kw = dict(kv_layout="dense") if arm == "dense" else \
            dict(kv_layout="paged", paged_attention=arm)
        eng = InferenceEngine(net, num_slots=4, max_batch=4,
                              seq_buckets=(32, 256, 384), **kw)
        eng.warmup()
        n_flash, n_paged = (_launches(flash.flash_fwd),
                            paged.paged_attention.launches)
        with eng:
            futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            outs[arm] = [f.result(timeout=300) for f in futs]
        assert _launches(flash.flash_fwd) > n_flash
        assert (paged.paged_attention.launches > n_paged) == (arm ==
                                                             "kernel")
    for a, b, c in zip(outs["kernel"], outs["gather"], outs["dense"]):
        onp.testing.assert_array_equal(a, b)
        onp.testing.assert_array_equal(a, c)


def test_engine_refuses_head_dims_the_kernel_lacks(dev):
    """A model of head dim 80 is refused by the kernel read arm when the
    engine is built, not on its first decode step; the gather arm takes
    it."""
    from mxnet_tpu_torch.models import get_gpt2
    from mxnet_tpu_torch.serving import InferenceEngine, ServingError
    net = get_gpt2("gpt2_124m", vocab_size=256, units=160, num_layers=1,
                   num_heads=2, max_length=128, dropout=0.0).initialize(seed=0)
    assert net.kv_heads() == (2, 80)
    with pytest.raises(ServingError, match="head dims"):
        InferenceEngine(net, kv_layout="paged")
    InferenceEngine(net, kv_layout="paged", paged_attention="gather")


def test_bf16_model_kernel_arm_matches_gather_arm(dev):
    """bf16 parameters give bf16 caches and run the bf16 instantiations
    of both kernels; per-step logits of the two read arms agree to bf16
    precision (2e-2 of logits near 1 — two arms round the same values in
    another order)."""
    net = _small_gpt2(2).cast("bfloat16")
    s, ps, npt = 2, 16, 512 // 16
    table = torch.full((s + 1, npt), s * npt, dtype=torch.int32, device=dev)
    table[:s] = torch.arange(s * npt, dtype=torch.int32,
                             device=dev).reshape(s, npt)
    toks = torch.randint(0, 256, (s, 256), dtype=torch.int32, device=dev)
    lens = torch.tensor([256, 200], dtype=torch.int32, device=dev)
    sidx = torch.arange(s, dtype=torch.int32, device=dev)
    caches = {arm: net.init_page_cache(s * npt + 1, ps)
              for arm in ("kernel", "gather")}
    assert caches["kernel"][0]["k"].dtype == torch.bfloat16
    logits = {arm: net.prefill_slots(toks, lens, caches[arm], sidx,
                                     page_table=table,
                                     paged_kernel=arm == "kernel")[0]
              for arm in caches}
    pos = torch.tensor([256, 200, 512], dtype=torch.int32, device=dev)
    for _ in range(3):
        tok = torch.zeros((s + 1,), dtype=torch.int32, device=dev)
        tok[:s] = logits["kernel"][:s].argmax(-1).to(torch.int32)
        for arm in caches:
            logits[arm] = net.decode_step(tok, caches[arm], pos,
                                          page_table=table,
                                          paged_kernel=arm == "kernel")[0]
        assert _maxabs(logits["kernel"][:s], logits["gather"][:s]) <= 2e-2
        pos[:s] += 1


def _moe_params(rs, e, u, h):
    return {"gate": rs.randn(e, u).astype("float32") * 0.3,
            "w1": rs.randn(e, u, h).astype("float32") * 0.1,
            "b1": rs.randn(e, h).astype("float32") * 0.1,
            "w2": rs.randn(e, h, u).astype("float32") * 0.1,
            "b2": rs.randn(e, u).astype("float32") * 0.1}


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_layer_on_card_matches_cpu(dev, capacity_factor):
    """The MoE layer (8 experts, top 2) on the card against the CPU from
    the same weights, at ample capacity and at one that drops: the same
    dropped share, output, aux and router gradient within 1e-5 of their
    max-abs."""
    from mxnet_tpu_torch.models import MoELayer
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    rs = onp.random.RandomState(0)
    params = _moe_params(rs, 8, 128, 512)
    x = torch.from_numpy(rs.randn(2, 256, 128).astype("float32"))
    cot = torch.from_numpy(rs.randn(2, 256, 128).astype("float32"))
    got = {}
    for where in ("cpu", dev):
        layer = load_numpy_params(
            MoELayer(128, 512, 8, capacity_factor=capacity_factor), params,
            device=where)
        y = layer(x.to(where))
        gate_grad, = torch.autograd.grad(
            (y * cot.to(where)).sum() + layer.last_aux, [layer.gate])
        got[str(where)] = [t.detach().cpu() for t in
                           (y, layer.last_aux, gate_grad,
                            layer.last_dropped)]
    (y_c, aux_c, g_c, drop_c), (y_g, aux_g, g_g, drop_g) = got.values()
    assert float(drop_g) == float(drop_c)
    assert (float(drop_c) > 0) == (capacity_factor < 1)
    for a, r in ((y_g, y_c), (aux_g, aux_c), (g_g, g_c)):
        assert _maxabs(a, r) <= 1e-5 * float(r.abs().max())


def test_remat_launch_counts_and_gradients_on_card(dev):
    """A 2-layer MoE GPT-2 at T = 256 with dropout 0.1, one step under
    each ``remat``: without it B1, B2 and B3 launch once a layer; under
    ``True`` and ``'dots'`` B1 launches twice a layer (the recomputation
    runs it again: ``'dots'`` keeps only the products' outputs) and B2,
    B3 once.  All in float32.  The loss and gradients equal the
    run without remat (1e-6 of each max-abs), every thread's aux
    collector ends empty, and the device generator ends where the run
    without remat leaves it."""
    import collections
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import base
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    net = get_gpt2("gpt2_124m", vocab_size=256, units=128, num_layers=2,
                   num_heads=2, max_length=512, dropout=0.1,
                   num_experts=2, device=dev).initialize(seed=0)
    rs = onp.random.RandomState(0)
    toks, labels = (torch.from_numpy(rs.randint(0, 256, (2, 256))
                                     .astype("int32")).to(dev)
                    for _ in range(2))
    pending = collections.Counter()
    rec, pop = base.record_aux_loss, base.pop_aux_losses

    def spy_rec(a):
        pending[threading.get_ident()] += 1
        rec(a)

    def spy_pop():
        out = pop()
        pending[threading.get_ident()] -= len(out)
        return out

    kernels = (flash.flash_fwd, flash.flash_dq, flash.flash_dkv)
    runs = {}
    base.record_aux_loss, base.pop_aux_losses = spy_rec, spy_pop
    try:
        for remat in (False, True, "dots"):
            net._remat = remat
            mx.random.seed(7)
            n0 = [dict(k.launches_by_dtype) for k in kernels]
            with base.training_mode(True), mx.models.aux_loss_scope():
                loss = gpt2_lm_loss(net(toks), labels)
                grads = torch.autograd.grad(loss, list(net.parameters()))
            torch.cuda.synchronize()
            counts = [{str(dt).split(".")[1]: k.launches_by_dtype[dt] - n[dt]
                       for dt in n if k.launches_by_dtype[dt] - n[dt]}
                      for k, n in zip(kernels, n0)]
            runs[remat] = (loss.detach(), grads, counts,
                           mx.random.generator(dev).get_state())
    finally:
        base.record_aux_loss, base.pop_aux_losses = rec, pop
    assert not any(pending.values()), dict(pending)
    assert runs[False][2] == [{"float32": 2}] * 3
    loss0, grads0, _c, state0 = runs[False]
    for remat in (True, "dots"):
        loss, grads, counts, state = runs[remat]
        assert counts == [{"float32": 4}, {"float32": 2}, {"float32": 2}]
        assert _maxabs(loss, loss0) <= 1e-6 * float(loss0.abs())
        for a, r in zip(grads, grads0):
            assert _maxabs(a, r) <= 1e-6 * max(float(r.abs().max()), 1e-30)
        assert torch.equal(state, state0)


def _engine_shape_case(dev, shape, seed):
    """B4's inputs at one of the engine's multi-query shapes, on the
    model's pool layout (real pages, the zero page, the trash page):
    ``chunk`` is a chunk batch of 8 rows x 256 queries whose tables
    share a 32-page (512-token) prefix, half of them at the suffix right
    behind it; ``verify`` is the window of 8 slots x 5 queries plus the
    parked scratch row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, d, ps, npt, shared = 12, 64, 16, 64, 32
    b, tq = (8, 256) if shape == "chunk" else (9, 5)
    n_real = shared + b * (npt - shared)
    perm = torch.randperm(n_real, generator=g, device=dev).to(torch.int32)
    table = torch.empty((b, npt), dtype=torch.int32, device=dev)
    table[:, :shared] = perm[:shared]
    table[:, shared:] = perm[shared:].reshape(b, npt - shared)
    hi = npt * ps - tq
    start = torch.randint(0, hi + 1, (b,), generator=g, device=dev)
    if shape == "chunk":
        start[::2] = shared * ps
    else:
        table[-1] = n_real                       # parked on the zero page
        start[-1] = npt * ps
    qpos = (start[:, None] + torch.arange(tq, device=dev)).to(torch.int32)
    kf = torch.randn((n_real + 2, ps, h, d), generator=g, device=dev)
    vf = torch.randn((n_real + 2, ps, h, d), generator=g, device=dev)
    kf[n_real] = 0
    vf[n_real] = 0
    q = torch.randn((b, tq, h, d), generator=g, device=dev)
    return q, kf, vf, table, qpos.contiguous()


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("shape", ["chunk", "verify"])
def test_paged_kernel_at_engine_chunk_and_verify_shapes(dev, kind, shape):
    """B4 with Tq = 256 (the chunk bucket; tables sharing prefix pages)
    and Tq = 5 (a verify window of k = 4): within tolerance of its plain
    version, counted as a multi-query launch, and bit-identical on a
    second launch."""
    q, kf, vf, table, qpos = _engine_shape_case(dev, shape, 7)
    ks = vs = None
    if kind == "int8":
        kp, ks = paged.kv_quantize(kf)
        vp, vs = paged.kv_quantize(vf)
    else:
        kp, vp = kf, vf
    n0 = paged.paged_attention.multi_query_launches
    out = paged.paged_attention(q, kp, vp, table, qpos, k_scale=ks,
                                v_scale=vs)
    torch.cuda.synchronize()
    assert paged.paged_attention.multi_query_launches == n0 + 1
    ref = paged._paged_plain(q, kp, vp, table, qpos, ks, vs, 64 ** -0.5)
    assert _maxabs(out, ref) <= TOL[torch.float32]
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, paged.paged_attention(q, kp, vp, table, qpos,
                                                  k_scale=ks, v_scale=vs))


def test_engine_kernel_arm_never_takes_the_plain_or_gather_path(
        dev, monkeypatch):
    """Chunked prefill, prefix hits, page pressure with preemption and
    speculative verify under ``paged_attention='kernel'`` read pages
    through B4 only: with the plain version and the gather arm's
    attentions made to raise, the streams equal the gather arm's, and
    B4 ran multi-query launches."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serving import InferenceEngine
    net = _small_gpt2(3)
    rs = onp.random.RandomState(1)
    shared = rs.randint(0, 256, (200,))
    # the second family prompt arrives after the first completed: a hit
    waves = [[rs.randint(0, 256, (n,)).astype("int32") for n in (300, 400)]]
    waves += [[onp.concatenate([shared, rs.randint(0, 256, (n,))])
               .astype("int32")] for n in (20, 40)]
    configs = [dict(prefill_chunk=128),
               dict(num_pages=40, spec_tokens=2)]

    def run(arm, kw):
        eng = InferenceEngine(net, kv_layout="paged", paged_attention=arm,
                              num_slots=4, max_batch=4, page_size=16,
                              seq_buckets=(32, 64, 128), **kw)
        eng.warmup()
        outs = []
        with eng:
            for wave in waves:
                futs = [eng.submit(p, max_new_tokens=24) for p in wave]
                outs += [f.result(timeout=300) for f in futs]
        return outs, eng.stats()["counters"]

    want = [run("gather", kw)[0] for kw in configs]

    def boom(*_a, **_k):
        raise AssertionError("the kernel arm took a plain/gather path")
    monkeypatch.setattr(paged, "_paged_plain", boom)
    monkeypatch.setattr(transformer, "_attention_chunk", boom)
    monkeypatch.setattr(transformer, "_attention_step_slots", boom)
    for kw, ref in zip(configs, want):
        n0 = paged.paged_attention.multi_query_launches
        outs, c = run("kernel", kw)
        assert paged.paged_attention.multi_query_launches > n0
        for a, b in zip(outs, ref):
            onp.testing.assert_array_equal(a, b)
        assert c["prefill_chunks"] > 0 and c["prefix_hits"] > 0
        if "spec_tokens" in kw:
            assert c["spec_cycles"] > 0 and c["preemptions"] > 0


# ------------------------------------------------ the vision ops and layers
# card against CPU, float32 with TF32 off: cuDNN's algorithms (implicit
# GEMM, Winograd, FFT) sum in another order than the CPU's, so each
# result is held as max-abs error over its max-abs within 1e-5

VISION_TOL = 1e-5


@pytest.fixture
def no_tf32(dev):
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield dev
    torch.backends.cudnn.allow_tf32 = saved


def _relerr(a, ref):
    return _maxabs(a, ref) / max(float(ref.abs().max()), 1e-30)


def _card_vs_cpu(dev, fn, *inputs):
    """``fn`` on the card and on the CPU with the same inputs: outputs
    and input gradients (for a seeded head gradient) as relative
    errors."""
    outs = {}
    for d in (dev, torch.device("cpu")):
        xs = [x.to(d).requires_grad_(x.is_floating_point()) for x in inputs]
        y = fn(*xs)
        hg = torch.linspace(0.5, 1.5, y.numel()).reshape(y.shape).to(d)
        grads = torch.autograd.grad(y, [x for x in xs if x.requires_grad],
                                    hg)
        outs[d.type] = (y.detach().cpu(), [g.cpu() for g in grads])
    (yc, gc), (yh, gh) = outs["cuda"], outs["cpu"]
    return [_relerr(yc, yh)] + [_relerr(a, b) for a, b in zip(gc, gh)]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_convolution_pooling_batchnorm_on_card_match_cpu(no_tf32, layout):
    from mxnet_tpu_torch.ndarray import ops
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, 20, 20, generator=g)
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    w = torch.randn(32, 8, 3, 3, generator=g) * 0.1
    gamma, beta = torch.rand(32, generator=g) + 0.5, torch.randn(32,
                                                                 generator=g)
    ax = -1 if layout == "NHWC" else 1

    def conv(x, w):
        return ops.conv(x, w, None, (2, 2), (1, 1), (1, 1), 2, layout)

    def pool(x):
        return ops.pool(x, (3, 3), "max", False, (2, 2), (1, 1), "full",
                        True, layout)

    def stem_pool(x):                   # ResNet's: torch pads it itself
        return ops.pool(x, (3, 3), "max", False, (2, 2), (1, 1), "valid",
                        True, layout)

    def avg(x):
        return ops.pool(x, (3, 3), "avg", False, (2, 2), (1, 1), "valid",
                        False, layout)

    def avg_in(x):
        return ops.pool(x, (3, 3), "avg", False, (1, 1), (1, 1), "valid",
                        True, layout)

    def bn(x, g_, b_):
        return ops.batch_norm(x, g_, b_, None, None, 1e-5, False, True,
                              ax)[0]
    y = conv(x, w).detach()
    for name, fn, inputs in (("conv", conv, (x, w)), ("max pool", pool, (x,)),
                             ("max pool, torch's padding", stem_pool, (x,)),
                             ("avg pool", avg, (x,)),
                             ("avg pool with pad", avg_in, (x,)),
                             ("batch norm", bn, (y, gamma, beta))):
        errs = _card_vs_cpu(no_tf32, fn, *inputs)
        assert max(errs) <= VISION_TOL, (name, errs)


def test_resnet_moving_statistics_after_a_step_on_card_match_cpu(no_tf32):
    """One ``ShardedTrainer`` step of a narrow NHWC ResNet on the card
    and on the CPU from the same weights: loss, the moving statistics
    (moved in place on the card) and the parameters agree."""
    from mxnet_tpu_torch.models import vision
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.utils.convert import load_numpy_params

    def narrow():
        return vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                               [16, 32, 64, 128, 256], classes=10,
                               layout="NHWC")

    def ce(out, y):
        return torch.logsumexp(out, -1) - out.gather(-1, y[:, None])[:, 0]

    rs = onp.random.RandomState(0)
    x = rs.uniform(-1, 1, (8, 64, 64, 3)).astype("float32")
    y = rs.randint(0, 10, (8,)).astype("int64")
    ref = narrow()
    ref.initialize(seed=0, device="cpu")
    ShardedTrainer(ref, "sgd").build(x)
    params = {k: p.detach().numpy().copy() for k, p in
              ref.named_parameters()}
    out = {}
    for d in (no_tf32, torch.device("cpu")):
        net = load_numpy_params(narrow(), params, device=d)
        tr = ShardedTrainer(net, "sgd", loss=ce, optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        loss = float(tr.step(x, (y,)))
        out[d.type] = (loss, {k: p.detach().cpu() for k, p in
                              net.named_parameters()})
    (lc, pc), (lh, ph) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    # a convolution bias that BatchNorm follows takes a zero gradient
    # in exact arithmetic (rounding noise on both sides): its step is
    # held against the largest parameter
    top = max(float(v.abs().max()) for v in ph.values())
    for k in ph:
        scale = top if k.endswith(".bias") and ".body." in k else \
            max(float(ph[k].abs().max()), 1e-30)
        assert _maxabs(pc[k], ph[k]) <= 1e-4 * scale, k
    moved = [k for k in ph if "running_" in k
             and not torch.equal(ph[k], torch.from_numpy(params[k]))]
    assert len(moved) == 17 * 2


# ------------------------------------------------ the language family

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,causal", [(2, 512, 4, False),
                                          (2, 256, 4, False),
                                          (2, 256, 4, True)])
def test_flash_kernels_at_bert_and_nmt_shapes_match_plain(dev, dtype, b, t,
                                                          h, causal):
    """B1, B2 and B3 at BERT's (T 512, non-causal) and NMT's (T 256,
    both) head dim 64, batch and heads cut: within the tolerances of
    their plain versions (whole key tiles: T a multiple of every tile),
    B2 with the delta it computes and B3 fed it, as training runs
    them."""
    g = torch.Generator(device=dev).manual_seed(t + causal)
    d, scale = 64, 64 ** -0.5
    q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    o, lse = flash.flash_fwd(q, k, v, causal=causal, scale=scale)
    o_ref, lse_ref = flash._fwd_plain(q, k, v, None, None, causal, scale)
    assert _maxabs(o, o_ref) <= TOL[dtype]
    assert _maxabs(lse, lse_ref) <= TOL[dtype]
    _check_bwd((q, k, v, do, lse, None, None), dtype, causal, scale)


def test_cross_attention_on_card_matches_reference_path(dev):
    """Cross-attention with source and target of one length takes B1-B3
    (q from the decoder, k and v projections of the memory); its output
    and the gradients of the query input, the memory and every weight
    equal the reference path's (1e-4 of their own max-abs); a source
    mask or another source length sends it to the reference path."""
    from mxnet_tpu_torch.base import training_mode
    from mxnet_tpu_torch.models import transformer
    g = torch.Generator(device=dev).manual_seed(3)
    mha = transformer.MultiHeadAttention(128, 2).initialize(device=dev)
    x, mem = (torch.randn((2, 256, 128), generator=g, device=dev)
              .requires_grad_() for _ in range(2))
    params = [x, mem] + list(mha.parameters())
    runs = {}
    kernels = (flash.flash_fwd, flash.flash_dq, flash.flash_dkv)
    for impl in ("auto", "ref"):
        n0 = [_launches(kk) for kk in kernels]
        orig = transformer.dot_product_attention
        if impl == "ref":
            transformer.dot_product_attention = \
                lambda *a, **kw: orig(*a, impl="ref", **kw)
        try:
            with training_mode(True):
                out = mha(x, None, mem)
                runs[impl] = (out.detach(), torch.autograd.grad(
                    out.square().sum(), params))
        finally:
            transformer.dot_product_attention = orig
        n = [_launches(kk) - c for kk, c in zip(kernels, n0)]
        assert n == ([1, 1, 1] if impl == "auto" else [0, 0, 0])
    assert _maxabs(runs["auto"][0], runs["ref"][0]) <= 1e-4
    # k_proj.bias adds one constant to each row of scores, which the
    # softmax cancels: its gradient is rounding noise on both paths and
    # is held against the largest gradient
    names = ["x", "memory"] + [n for n, _ in mha.named_parameters()]
    top = max(float(r.abs().max()) for r in runs["ref"][1])
    for name, a, r in zip(names, runs["auto"][1], runs["ref"][1]):
        scale = top if name == "k_proj.bias" else float(r.abs().max())
        assert _maxabs(a, r) <= 1e-4 * scale, name
    n0 = _launches(flash.flash_fwd)
    keep = torch.ones((2, 1, 1, 256), dtype=torch.bool, device=dev)
    mha(x, keep, mem)
    mha(x, None, mem[:, :200])
    assert _launches(flash.flash_fwd) == n0


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_fused_rnn_on_card_matches_step_route(no_tf32, mode):
    """cuDNN's recurrent op (the fused route) against the step-by-step
    decomposition on the card, values and gradients, two bidirectional
    layers with dropout between them from one seed: 1e-4 of their own
    max-abs (float32, TF32 off)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.rnn import _rnn_impl
    gates = {"lstm": 4, "gru": 3}.get(mode, 1)
    g = torch.Generator(device=no_tf32).manual_seed(5)
    hid, c, b, t = 64, 48, 8, 35
    params = []
    for li in range(2):
        dirs = []
        for _d in range(2):
            in_sz = c if li == 0 else 2 * hid
            dirs.append(tuple(
                (torch.rand(s, generator=g, device=no_tf32) - 0.5) * 0.2
                for s in ((gates * hid, in_sz), (gates * hid, hid),
                          (gates * hid,), (gates * hid,))))
        params.append(dirs)
    x = torch.randn((t, b, c), generator=g, device=no_tf32)
    h0 = torch.randn((4, b, hid), generator=g, device=no_tf32) * 0.5
    c0 = torch.randn((4, b, hid), generator=g, device=no_tf32) * 0.5
    res = {}
    for impl in ("fused", "step"):
        leaves = [x.clone().requires_grad_()] + [
            w.clone().requires_grad_() for layer in params for ws in layer
            for w in ws]
        it = iter(leaves[1:])
        ps = [[tuple(next(it) for _ in range(4)) for _ in range(2)]
              for _ in range(2)]
        mx.random.seed(11)
        with mx.base.training_mode(True):
            out, h, cc = _rnn_impl.rnn_layer_forward(
                leaves[0], ps, h0, c0 if mode == "lstm" else None, mode,
                p_dropout=0.5, impl=impl)
        outs = [out, h] + ([cc] if mode == "lstm" else [])
        total = sum((o * (i + 1.5)).sum() for i, o in enumerate(outs))
        res[impl] = ([o.detach() for o in outs],
                     torch.autograd.grad(total, leaves))
    for a, r in zip(res["fused"][0] + list(res["fused"][1]),
                    res["step"][0] + list(res["step"][1])):
        assert _relerr(a, r) <= 1e-4


# ------------------------------------------- the nd ops of A1.7 on the card

def _nd_run(ctx, call, inputs, grad):
    """``call(nd, *arrays)`` on ``ctx`` under ``autograd.record()``: its
    outputs and the gradients of the inputs indexed by ``grad`` (a
    seeded head gradient on the first output), as CPU tensors; every
    output and gradient must lie on ``ctx``'s device."""
    import mxnet_tpu_torch as mx
    xs = [mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in inputs]
    for i in grad:
        xs[i].attach_grad()
    with mx.autograd.record():
        out = call(mx.nd, *xs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    if grad:
        hg = onp.random.RandomState(1).uniform(0.5, 1.5, outs[0].shape)
        outs[0].backward(mx.nd.array(hg.astype("float32"), ctx=ctx))
    got = outs + [xs[i].grad for i in grad]
    for a in got:
        assert a.tensor.device.type == torch.device(ctx.torch_device).type
    return [a.tensor.detach().cpu() for a in got]


def _nd_card_vs_cpu(call, inputs, grad=(), tol=1e-5, exact=False):
    """The same port op on the card and on the CPU: each output and
    gradient within ``tol`` of its max-abs; with ``exact``, which
    entries are -1 identical too."""
    import mxnet_tpu_torch as mx
    card = _nd_run(mx.gpu(0), call, inputs, grad)
    cpu = _nd_run(mx.cpu(), call, inputs, grad)
    for i, (a, b) in enumerate(zip(card, cpu)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if exact:
            assert torch.equal(a == -1, b == -1), i
        if a.is_floating_point():
            fin = torch.isfinite(b)
            assert torch.equal(torch.isfinite(a), fin), i
            assert _relerr(a[fin], b[fin]) <= tol, (i, _relerr(a[fin],
                                                               b[fin]))
        else:
            assert torch.equal(a, b), i


def _rs(seed):
    return onp.random.RandomState(seed)


def test_nd_index_and_linalg_ops_on_card_match_cpu(no_tf32):
    rs = _rs(0)
    idx = onp.stack([rs.randint(0, 4, 30), rs.randint(-5, 5, 30)])
    _nd_card_vs_cpu(lambda nd, d, i: nd.scatter_nd(d, i, (4, 5)),
                    [rs.randn(30).astype("float32"), idx.astype("int32")],
                    grad=(0,))
    _nd_card_vs_cpu(lambda nd, i: nd.unravel_index(i, (3, 4)),
                    [onp.array([-13, -1, 0, 5, 11, 100], "float32")])
    _nd_card_vs_cpu(lambda nd, m: nd.ravel_multi_index(m, (3, 4)),
                    [onp.array([[-1, 0, 2, 7], [4, -2, 3, 0]], "float32")])
    _nd_card_vs_cpu(lambda nd, a, i: nd.batch_take(a, i),
                    [rs.randn(3, 4).astype("float32"),
                     onp.array([0, 7, -1], "int32")], grad=(0,))
    x = rs.randn(2, 8, 8)
    spd = (x @ x.transpose(0, 2, 1) / 8 + onp.eye(8)).astype("float32")
    _nd_card_vs_cpu(lambda nd, a: nd.linalg_potrf(a), [spd], grad=(0,),
                    tol=1e-4)
    tri = (onp.tril(rs.randn(2, 8, 8)) * 0.3 + 2 * onp.eye(8)).astype(
        "float32")
    for transpose in (False, True):
        for right in (False, True):
            b = rs.randn(2, 3, 8) if right else rs.randn(2, 8, 3)
            _nd_card_vs_cpu(lambda nd, a, b: nd.linalg_trsm(
                a, b, transpose=transpose, rightside=right, alpha=0.7),
                [tri, b.astype("float32")], grad=(0, 1), tol=1e-4)
    a = (rs.randn(2, 8, 8) + 3 * onp.eye(8)).astype("float32")
    for op in ("linalg_det", "linalg_inverse"):
        _nd_card_vs_cpu(lambda nd, a: getattr(nd, op)(a), [a], grad=(0,),
                        tol=1e-4)
    _nd_card_vs_cpu(lambda nd, a: nd.linalg_slogdet(a)[1], [a], grad=(0,),
                    tol=1e-4)


def _rois(rs, n, size=12.0):
    c = rs.uniform(-0.1 * size, 1.1 * size, (n, 2, 2))
    c.sort(axis=1)
    c[:, 1] += 1.0
    return onp.concatenate([rs.randint(0, 2, (n, 1)), c[:, :, 0], c[:, :, 1]],
                           1)[:, [0, 1, 3, 2, 4]].astype("float32")


def test_nd_spatial_and_roi_ops_on_card_match_cpu(no_tf32):
    rs = _rs(1)
    x = rs.randn(2, 4, 12, 12).astype("float32")
    theta = (onp.tile([1, 0, 0, 0, 1, 0], (2, 1)) + 0.3 * rs.randn(2, 6)
             ).astype("float32")
    grid = rs.uniform(-1.2, 1.2, (2, 2, 5, 6)).astype("float32")
    _nd_card_vs_cpu(lambda nd, t: nd.GridGenerator(t, "affine", (5, 7)),
                    [theta], grad=(0,))
    _nd_card_vs_cpu(lambda nd, t: nd.GridGenerator(t, "warp"),
                    [rs.randn(2, 2, 6, 5).astype("float32")], grad=(0,))
    _nd_card_vs_cpu(lambda nd, x, g: nd.BilinearSampler(x, g), [x, grid],
                    grad=(0, 1), tol=1e-4)
    _nd_card_vs_cpu(lambda nd, x, t: nd.SpatialTransformer(
        x, t, target_shape=(6, 6)), [x, theta], grad=(0, 1), tol=1e-4)
    relu = onp.maximum(onp.round(x), 0)                  # tied maxima
    _nd_card_vs_cpu(lambda nd, x, r: nd.ROIPooling(x, r, (3, 2), 1.0),
                    [relu, _rois(rs, 9)], grad=(0,))
    # bin edges that land on whole pixels (14 rows in 7 bins): CUDA's
    # division by a host scalar (a product with its reciprocal) floors
    # 14 * (1/7) to 1, so the port divides by a device tensor
    whole = onp.array([[0, 0, 0, 13, 13], [1, 2, 3, 15, 9],
                       [0, 0, 0, 20, 27], [1, 7, 7, 27, 20]], "float32")
    _nd_card_vs_cpu(lambda nd, x, r: nd.ROIPooling(x, r, (7, 7), 1.0),
                    [rs.randn(2, 4, 32, 32).astype("float32"), whole],
                    grad=(0,))
    _nd_card_vs_cpu(lambda nd, x, r: nd.ROIAlign(x, r, (3, 3), 0.5, 2),
                    [x, _rois(rs, 7, 24.0)], grad=(0, 1), tol=1e-4)
    _nd_card_vs_cpu(lambda nd, x, r: nd.ROIAlign(
        x, r, (2, 2), 1.0, 2, position_sensitive=True),
        [rs.randn(2, 8, 12, 12).astype("float32"), _rois(rs, 5)],
        grad=(0, 1), tol=1e-4)


def _det_rows(rs, n, batch=2):
    centers = rs.uniform(0.2, 0.8, (4, 2))
    c = centers[rs.randint(0, 4, (batch, n))] + 0.05 * rs.randn(batch, n, 2)
    wh = rs.uniform(0.1, 0.3, (batch, n, 2))
    score = onp.round(rs.uniform(-0.2, 1.0, (batch, n)), 1)
    ids = rs.randint(0, 3, (batch, n))
    return onp.concatenate([ids[..., None], score[..., None], c - wh / 2,
                            c + wh / 2], -1).astype("float32")


def test_nd_detection_ops_on_card_match_cpu(no_tf32):
    rs = _rs(2)
    rows = _det_rows(rs, 40)
    _nd_card_vs_cpu(lambda nd, a, b: nd.box_iou(a, b),
                    [rows[0, :7, 2:], rows[1, :5, 2:]], grad=(0, 1))
    for kw in (dict(), dict(topk=5), dict(id_index=0),
               dict(id_index=0, force_suppress=True),
               dict(in_format="center", out_format="corner")):
        _nd_card_vs_cpu(lambda nd, x: nd.box_nms(x, **kw), [rows],
                        grad=(0,), exact=True)
    feat = onp.zeros((1, 1, 4, 4), "float32")
    _nd_card_vs_cpu(lambda nd, x: nd.MultiBoxPrior(
        x, sizes=(0.3, 0.5), ratios=(1, 2, 0.5)), [feat])
    import mxnet_tpu_torch as mx
    with mx.cpu():
        anchors = mx.nd.MultiBoxPrior(mx.nd.array(feat), sizes=(0.3, 0.5),
                                      ratios=(1, 2, 0.5)).asnumpy()
    lab = -onp.ones((3, 6, 5), "float32")
    for b in range(3):
        k = rs.randint(1, 7)
        lab[b, :k, 0] = rs.randint(0, 4, k)
        lab[b, :k, 1:] = _det_rows(rs, k, 1)[0, :, 2:].clip(0, 1)
    cp = rs.uniform(0, 1, (3, 5, anchors.shape[1])).astype("float32")
    _nd_card_vs_cpu(lambda nd, a, l, c: nd.MultiBoxTarget(
        a, l, c, negative_mining_ratio=3.0), [anchors, lab, cp],
        exact=True)
    logits = rs.randn(2, 5, anchors.shape[1]) * 2
    prob = (onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)).astype(
        "float32")
    loc = (0.5 * rs.randn(2, anchors.shape[1] * 4)).astype("float32")
    _nd_card_vs_cpu(lambda nd, c, l, a: nd.MultiBoxDetection(
        c, l, a, nms_topk=10), [prob, loc, anchors], exact=True)


def test_nd_samplers_draw_on_card_from_its_generator(dev):
    """Each of the 18 samplers on the card: its output on the card, with
    the CPU's shape and dtype; a seed repeats the card's draws."""
    import mxnet_tpu_torch as mx
    calls = {
        "random_uniform": lambda nd: nd.random_uniform(shape=(64,)),
        "uniform": lambda nd: nd.uniform(shape=64),
        "random_normal": lambda nd: nd.random_normal(shape=(64,)),
        "normal": lambda nd: nd.normal(shape=(64,)),
        "random_gamma": lambda nd: nd.random_gamma(shape=(64,), alpha=0.5),
        "random_exponential": lambda nd: nd.random_exponential(shape=64),
        "random_poisson": lambda nd: nd.random_poisson(shape=(64,), lam=3),
        "random_randint": lambda nd: nd.random_randint(shape=(64,), high=9),
        "random_bernoulli": lambda nd: nd.random_bernoulli(0.5, shape=64),
        "random_negative_binomial": lambda nd: nd.random_negative_binomial(
            shape=64, k=3, p=0.4),
        "random_generalized_negative_binomial":
            lambda nd: nd.random_generalized_negative_binomial(shape=64),
        "sample_multinomial": lambda nd: nd.sample_multinomial(
            nd.array([[0.2, 0.8], [0.5, 0.5]]), shape=32, get_prob=True),
        "shuffle": lambda nd: nd.shuffle(nd.arange(64)),
        "sample_uniform": lambda nd: nd.sample_uniform(
            nd.array([0.0, 1.0]), nd.array([1.0, 3.0]), shape=32),
        "sample_normal": lambda nd: nd.sample_normal(
            nd.array([0.0, 1.0]), nd.array([1.0, 3.0]), shape=32),
        "sample_gamma": lambda nd: nd.sample_gamma(
            nd.array([0.5, 1.0]), nd.array([1.0, 3.0]), shape=32),
        "sample_exponential": lambda nd: nd.sample_exponential(
            nd.array([0.5, 1.0]), shape=32),
        "sample_poisson": lambda nd: nd.sample_poisson(
            nd.array([0.5, 4.0]), shape=32),
    }

    def draw(ctx, call, seed):
        mx.random.seed(seed)
        with ctx:
            out = call(mx.nd)
        return out if isinstance(out, (list, tuple)) else [out]
    for name, call in calls.items():
        card = draw(mx.gpu(0), call, 3)
        cpu = draw(mx.cpu(), call, 3)
        again = draw(mx.gpu(0), call, 3)
        for a, b, c in zip(card, cpu, again):
            assert a.tensor.is_cuda and not b.tensor.is_cuda, name
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert torch.equal(a.tensor, c.tensor), name


# ------------------------------------------------ the compiled programs
# The engine's programs as CUDA graphs (``serving/graphs.py``) against
# the same programs run eagerly (``_graphs = False``) on the card: the
# same kernels in the same order, so tokens are identical and the
# caches they write agree to 1e-5 (a cuBLAS algorithm picked under
# capture may sum in another order).

GRAPH_TOL = 1e-5


def _engines(net, **kw):
    """A graphed and an eager engine of one configuration, warmed up."""
    from mxnet_tpu_torch.serving import InferenceEngine
    cfg = dict(num_slots=2, max_batch=2, kv_layout="paged", page_size=16,
               seq_buckets=(32, 256), spec_tokens=2, draft_layers=1)
    cfg.update(kw)
    out = {}
    for graphs in (True, False):
        eng = InferenceEngine(net, **cfg)
        eng._graphs = graphs
        n = eng.warmup()
        assert n == len(eng._programs) == eng.stats()["compile"]["compiles"]
        out[graphs] = eng
    return out[True], out[False]


def _cache_err(a, b):
    """Max-abs between two paged engines' caches, the trash page (the
    last; duplicate writes land there in any order) left out."""
    return max(_maxabs(x[:-1], y[:-1])
               for ca, cb in zip(a._caches, b._caches)
               for x, y in zip(ca.values(), cb.values()))


def _program_calls(eng, rs):
    """One call of every program kind of a paged engine with spec and
    prefix copy, from seeded inputs: (name, thunk) pairs.  Rows 0-1
    prefill (256 bucket: B1) into slot pages, then decode, draft,
    verify and the tail-page copy read and write them."""
    s1 = eng.num_slots + 1
    npt = eng._n_logical
    eng._page_table[:2, :20] = onp.arange(40).reshape(2, 20)
    eng._table_stale = True
    eng._sync_table()
    lens = onp.array([200, 150], "int32")
    toks = rs.randint(0, 256, (2, 256)).astype("int32")
    samp = eng._samp_rows([], 2)
    samp1 = (onp.array([0.8, 0.0, 0.0], "float32"), onp.zeros(s1, "int32"),
             onp.ones(s1, "float32"), onp.array([7, 0, 0], "int64"))
    pos = onp.array([200, 150, eng.max_length], "int32")
    tok = rs.randint(0, 256, (s1,)).astype("int32")
    del npt
    return [
        ("prefill", lambda: eng._run_prefill(toks, lens, onp.array(
            [0, 1], "int32"), samp)),
        ("chunk", lambda: eng._run_prefill(
            toks[:, :32], onp.array([32, 20], "int32"),
            onp.array([0, 1], "int32"), samp, off=lens.copy())),
        ("decode", lambda: eng._run_decode(tok, pos + 32, samp1)),
        ("spec", lambda: eng._run_spec(tok, pos + 60, samp1)),
        ("prefix_copy", lambda: eng._copy_rows(3, 45, 9)),
    ]


PROGRAM_KINDS = ["prefill", "chunk", "decode", "spec", "prefix_copy"]


@pytest.mark.parametrize("kind", PROGRAM_KINDS)
def test_program_replays_equal_eager_calls_after_new_inputs(dev, kind):
    """Each program kind, twice with different inputs (the calls before
    it in ``_program_calls`` set up its state): the graphed engine's
    replay gives the eager engine's tokens, and the caches both wrote
    agree.  A graph that lacked a kernel would replay stale attention
    and part at the second call."""
    net = _small_gpt2(5)
    eg, ee = _engines(net)
    upto = PROGRAM_KINDS.index(kind) + 1
    for rnd in range(2):
        calls = {e: _program_calls(e, onp.random.RandomState(rnd))[:upto]
                 for e in (eg, ee)}
        for (name, fg), (_n, fe) in zip(calls[eg], calls[ee]):
            got, want = fg(), fe()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                if a is not None:
                    onp.testing.assert_array_equal(a, b, err_msg=name)
            torch.cuda.synchronize()
            assert _cache_err(eg, ee) <= GRAPH_TOL, (rnd, name)
    c = eg.stats()["compile"]
    assert c["compiles"] == len(eg._programs)
    # a speculative cycle is two programs, draft and verify
    assert c["bucket_hits"] == 2 * sum(2 if n == "spec" else 1
                                       for n in PROGRAM_KINDS[:upto])


def test_forward_program_replays_equal_eager_and_direct_forward(no_tf32):
    """Forward mode on the card: a small conv net's B4 forward program,
    replayed with two inputs, equals the eager program and the block's
    own predict-mode forward; served requests are its rows."""
    from mxnet_tpu_torch.base import training_mode
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.serving import InferenceEngine
    dev = no_tf32
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=8), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(5, in_units=8))
    net.initialize(device=dev, seed=0)
    shape, key = (3, 16, 16), ((3, 16, 16), "float32")
    engs = {}
    for graphs in (True, False):
        eng = InferenceEngine(net, max_batch=4, device=dev)
        eng._graphs = graphs
        assert eng.warmup(example_shape=shape) == 3
        engs[graphs] = eng
    rs = onp.random.RandomState(0)
    for _ in range(2):
        xs = rs.uniform(-1, 1, (4,) + shape).astype("float32")
        got, want = (engs[g]._forward_program(xs, key).cpu()
                     for g in (True, False))
        with torch.no_grad(), training_mode(False):
            direct = net(torch.from_numpy(xs).to(dev)).cpu()
        assert _maxabs(got, want) <= GRAPH_TOL
        assert _maxabs(got, direct) <= GRAPH_TOL
    with engs[True] as eng:
        rows = [eng.submit(x).result(timeout=60) for x in xs[:3]]
    onp.testing.assert_allclose(onp.stack(rows), direct[:3].numpy(),
                                rtol=GRAPH_TOL, atol=GRAPH_TOL)
    c = engs[True].stats()["counters"]
    assert c["compiles"] == 3 and c["forward_batches"] >= 1


def test_program_launch_counters_move_on_replay(dev):
    """A replay runs no Python, so the program adds its captured
    launches: a decode replay counts one B4 launch a layer, a verify
    replay one multi-query launch a layer, a 256 prefill one B1 a layer
    — the counts the eager engine makes for the same calls."""
    net = _small_gpt2(6)
    eg, ee = _engines(net)
    counts = {}
    for eng in (eg, ee):
        launches.reset()
        for _name, fn in _program_calls(eng, onp.random.RandomState(0)):
            fn()
        total = launches.totals()
        assert total["flash_dq"] == total["flash_dkv"] == 0
        counts[eng._graphs] = (total["paged_attention"],
                               paged.paged_attention.multi_query_launches,
                               total["flash_fwd"])
    assert counts[True] == counts[False]
    n = len(net.blocks)
    # chunk + decode + verify through B4; chunk and verify with Tq > 1
    assert counts[True] == (3 * n, 2 * n, n)


def test_engine_freeze_and_streams_through_feature_traffic(dev):
    """Chunked prefill, prefix hits, page pressure with preemption and
    speculative cycles on the graphed engine: ``compiles`` stays at the
    ``warmup()`` count, every call is a bucket hit, and the greedy
    streams equal the eager engine's."""
    net = _small_gpt2(3)
    rs = onp.random.RandomState(1)
    shared = rs.randint(0, 256, (200,))
    waves = [[rs.randint(0, 256, (n,)).astype("int32") for n in (300, 400)]]
    waves += [[onp.concatenate([shared, rs.randint(0, 256, (n,))])
               .astype("int32")] for n in (20, 40)]
    outs, stats = {}, {}
    for kw in (dict(prefill_chunk=128, seq_buckets=(32, 64, 128)),
               dict(num_pages=40, seq_buckets=(32, 64, 128))):
        for graphs, eng in zip((True, False), _engines(net, num_slots=4,
                                                        max_batch=4, **kw)):
            n_warm = eng.stats()["compile"]["compiles"]
            res = []
            with eng:
                for wave in waves:
                    futs = [eng.submit(p, max_new_tokens=24) for p in wave]
                    res += [f.result(timeout=300) for f in futs]
            outs[graphs], stats[graphs] = res, eng.stats()
            c = stats[graphs]["counters"]
            assert c["compiles"] == n_warm and c["bucket_hits"] > 0
        for a, b in zip(outs[True], outs[False]):
            onp.testing.assert_array_equal(a, b)
        c = stats[True]["counters"]
        assert c["prefill_chunks"] > 0 and c["prefix_hits"] > 0
        assert c["spec_cycles"] > 0
        assert c["bucket_hits"] == stats[False]["counters"]["bucket_hits"]
    assert c["preemptions"] > 0


def test_failed_capture_raises_and_never_falls_back(dev):
    """A program whose capture fails raises ``ServingError`` naming it,
    at every call: nothing runs it eagerly instead."""
    from mxnet_tpu_torch.serving import ServingError
    from mxnet_tpu_torch.serving.graphs import Program
    calls = []

    def fn(x):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            raise RuntimeError("refused under capture")
        return x * 2
    prog = Program(("decode",), fn, (onp.ones(4, "float32"),), dev,
                   graph=True, pool=torch.cuda.graph_pool_handle(),
                   stream=torch.cuda.Stream(dev))
    for _ in range(2):
        with pytest.raises(ServingError, match=r"\('decode',\)"):
            prog(onp.ones(4, "float32"))
    assert prog.outputs is None and calls == [False, True] * 2
    # a host read inside the capture is refused by CUDA itself
    bad = Program(("prefix_copy",), lambda x: x.sum().item(),
                  (onp.ones(4, "float32"),), dev, graph=True,
                  pool=torch.cuda.graph_pool_handle(),
                  stream=torch.cuda.Stream(dev))
    with pytest.raises(ServingError, match="prefix_copy"):
        bad(onp.ones(4, "float32"))
    assert float(torch.ones(3, device=dev).sum()) == 3.0


# ------------------------------------------------ graphed training (A2.2b)

def _gpt2_pair(seed, remat=False, dropout=0.0):
    """Two GPT-2s on the card with one set of weights (flash at D = 64)."""
    from mxnet_tpu_torch.models import get_gpt2
    nets = []
    for _ in range(2):
        net = get_gpt2("gpt2_124m", vocab_size=256, units=128, num_layers=2,
                       num_heads=2, max_length=256, dropout=dropout,
                       remat=remat)
        nets.append(net.initialize(seed=seed))
    return nets


def _flash_totals():
    t = launches.totals()
    return tuple(t[k] for k in ("flash_fwd", "flash_dq", "flash_dkv"))


def test_cached_op_replays_equal_eager_calls_after_new_inputs(dev):
    """A hybridized GPT-2 recorded forward and backward: the replays of
    its forward and backward graphs against the same CachedOp run
    without graphs (its private ``_graphs``), three calls with new
    inputs each: logits, loss and every gradient within 1e-5 of max-abs
    (cuBLAS may pick another algorithm under capture), B1-B3 launches
    from replays equal the eager calls', and one signature.  The
    captured backward's B2 launches on the capture stream (autograd's
    device thread takes the forward's stream) and writes its output in
    the graph's private pool."""
    from mxnet_tpu_torch.models import gpt2_lm_loss
    seen = []
    dq = flash.flash_dq

    def watched(*a, **k):
        out = dq(*a, **k)
        if torch.cuda.is_current_stream_capturing():
            seen.append((torch.cuda.current_stream().cuda_stream,
                         out[0].data_ptr()))
        return out
    graphed, eager = _gpt2_pair(4)
    eager._graphs = False
    for net in (graphed, eager):
        net.hybridize()
    rs = onp.random.RandomState(0)
    for call in range(3):
        toks = torch.from_numpy(rs.randint(0, 256, (2, 256))).to(dev)
        labels = torch.from_numpy(rs.randint(0, 256, (2, 256))).to(dev)
        runs = []
        for net in (graphed, eager):
            launches.reset()
            net.zero_grad()
            # the wrapper counts through its module's name: the dict
            # that launches.reset() just gave it
            watched.launches_by_dtype = dq.launches_by_dtype
            flash.flash_dq = watched
            try:
                logits = net(toks)
            finally:
                flash.flash_dq = dq
            loss = gpt2_lm_loss(logits, labels)
            loss.backward()
            torch.cuda.synchronize()
            runs.append((logits.detach().clone(), float(loss),
                         [p.grad.clone() for p in net.parameters()],
                         _flash_totals()))
            del logits, loss
        (lg, vg, gg, ng), (le, ve, ge, ne) = runs
        assert _relerr(lg, le) <= 1e-5
        assert vg == pytest.approx(ve, rel=1e-5)
        for a, b in zip(gg, ge):
            assert _relerr(a, b) <= 1e-5
        # the first call warms up (eager launches) before its replay
        assert ng == ne == (2, 2, 2) or call == 0, call
    assert len(graphed._cached_op._jit_cache) == 1
    assert graphed._cached_op._jit_cache[
        next(iter(graphed._cached_op._jit_cache))]._train
    # the first call captured the backward: 2 layers' B2 on the stream
    # of the capture, their dQ in a private (graph) pool's segment
    assert [h for h, _p in seen] == [graphed._cached_op._stream
                                     .cuda_stream] * 2
    segments = torch.cuda.memory._snapshot()["segments"]
    for _h, ptr in seen:
        seg = next(g for g in segments
                   if g["address"] <= ptr < g["address"] + g["total_size"])
        assert tuple(seg["segment_pool_id"]) != (0, 0)


def _bn_net(seed):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, layout="NHWC"),
            nn.BatchNorm(axis=3), nn.Activation("relu"),
            nn.GlobalAvgPool2D(layout="NHWC"), nn.Dense(5))
    net.initialize(seed=seed)
    net(torch.zeros((2, 8, 8, 3), device="cuda"))
    return net


@pytest.mark.parametrize("model", ["gpt2", "batchnorm"])
def test_graphed_trainer_steps_equal_eager_steps(no_tf32, model):
    """``ShardedTrainer``'s step captured at its first step and
    replayed, against the same trainer without graphs: 3 steps' losses
    and the parameters and aux state after them within 1e-5 of max-abs,
    B1-B3 launches a step equal (GPT-2: 2 of each) but for the first
    graphed step's warm-up before its capture (2 more), one program.
    The graphed GPT-2 is hybridized: it runs inline in the step's
    program and builds no CachedOp of its own."""
    from mxnet_tpu_torch.models import gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    if model == "gpt2":
        nets, loss = _gpt2_pair(5), gpt2_lm_loss
        nets[0].hybridize()
        rs = onp.random.RandomState(1)
        batches = [(rs.randint(0, 256, (2, 256)).astype("int32"),
                    rs.randint(0, 256, (2, 256)).astype("int32"))
                   for _ in range(3)]
    else:
        nets = [_bn_net(6), _bn_net(6)]

        def loss(out, y):
            return ((out - y) ** 2).mean(-1)
        rs = onp.random.RandomState(2)
        batches = [(rs.randn(4, 8, 8, 3).astype("float32"),
                    rs.randn(4, 5).astype("float32")) for _ in range(3)]
    runs = []
    for graphs, net in zip((True, False), nets):
        tr = ShardedTrainer(net, "adam", loss=loss,
                            optimizer_params={"learning_rate": 1e-3})
        tr._graphs = graphs
        losses, counts = [], []
        for x, y in batches:
            launches.reset()
            losses.append(float(tr.step(x, y)))
            counts.append(_flash_totals())
        assert len(tr._programs) == 1
        runs.append((losses, counts, [p.detach().clone() for p in
                                      net.parameters()]))
    (lg, cg, pg), (le, ce, pe) = runs
    assert lg == pytest.approx(le, rel=1e-5)
    if model == "gpt2":
        assert ce == [(2, 2, 2)] * 3
        assert cg == [(4, 4, 4)] + ce[1:]
        assert nets[0]._cached_op is None
    else:
        assert cg == ce
    for a, b in zip(pg, pe):
        assert _relerr(a, b) <= 1e-5


def test_remat_dropout_under_replay_draws_the_forward_masks(dev):
    """A remat layer ``dropout(x * w)`` inside a hybridized block with
    ``w = 1``: d(sum)/dw is the sum itself only if the recomputation in
    the replayed backward draws the forward's mask.  Two replays draw
    other masks; a reseeded block repeats the first."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.models.transformer import run_blocks

    class Scaled(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.w = self._new_param("w", (1,), init="ones")
            self.drop = nn.Dropout(0.5)

        def forward(self, x):
            return self.drop(x * self.w)

    class Net(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.blk = Scaled()

        def forward(self, x):
            return run_blocks([self.blk], x, remat=True)

    def run(seed):
        mx.random.seed(seed)
        net = Net()
        net.initialize(device=dev)
        net.hybridize()
        x = torch.rand((64, 256), device=dev, generator=torch.Generator(
            device=dev).manual_seed(0)) + 0.5
        out = []
        for _ in range(3):
            with mx.autograd.record():
                y = net(mx.nd.array(x)).sum()
            y.backward()
            grad = float(net.blk.w.grad[0])
            net.blk.w.grad.zero_()
            out.append((float(y.tensor), grad))
        return out
    first = run(7)
    for total, grad in first:
        assert grad == pytest.approx(total, rel=1e-5)
    assert len({t for t, _g in first}) == 3
    assert run(7) == first


def test_capture_with_a_host_read_raises_naming_the_block(dev):
    """A host read inside a capture: the hybridized block raises
    ``MXNetError`` naming its class and the signature, at every call,
    and ``ShardedTrainer`` names itself; the card works on."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import ShardedTrainer

    class Reads(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = nn.Dense(4, in_units=4)

        def forward(self, x):
            y = self.dense(x)
            return y * float(y.sum())

    net = Reads()
    net.initialize(device=dev)
    net.hybridize()
    x = torch.ones((2, 4), device=dev)
    for _ in range(2):
        with pytest.raises(MXNetError, match=r"CachedOp\(Reads\).*\(2, 4\)"):
            with torch.no_grad():
                net(x)
    tr = ShardedTrainer(net, "sgd", loss=lambda out, y: (out - y).sum(-1))
    net.hybridize(False)
    with pytest.raises(MXNetError, match=r"ShardedTrainer\(Reads\)"):
        tr.step(onp.ones((2, 4), "float32"), onp.ones((2, 4), "float32"))
    assert float(torch.ones(3, device=dev).sum()) == 3.0


def test_cached_op_results_outlive_later_calls_and_gan_step(no_tf32):
    """Each call's outputs and gradients are its own: predictions
    collected over batches, and recorded outputs kept across calls,
    equal the eager block's per batch (a replay rewrites the static
    buffers; the caller holds copies).  Gluon's DCGAN discriminator step
    (the hybridized ``netD`` on real and on detached fake data under one
    ``record()``: one signature, two outstanding calls, two programs)
    and the generator's step after it equal the eager arm's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    dev = no_tf32

    def mlp(units, seed):
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="tanh"), nn.Dense(units))
        net.initialize(device=dev, seed=seed)
        net(torch.zeros((4, 10 if units == 5 else 6), device=dev))
        return net
    rs = onp.random.RandomState(0)
    batches = [torch.from_numpy(rs.randn(4, 10).astype("float32")).to(dev)
               for _ in range(3)]
    z = torch.from_numpy(rs.randn(4, 6).astype("float32")).to(dev)
    runs = {}
    for graphs in (True, False):
        d, g = mlp(5, 1), mlp(10, 2)
        for net in (d, g):
            net._graphs = graphs
            net.hybridize()
        with torch.no_grad():
            preds = [d(x) for x in batches]
        with mx.autograd.record():
            recorded = [d(mx.nd.array(x)) for x in batches]
            total = recorded[0].sum() + recorded[1].sum() + \
                recorded[2].sum()
        total.backward()
        d.zero_grad()
        with mx.autograd.record():
            err_real = (d(mx.nd.array(batches[0])) ** 2).mean()
            fake = g(mx.nd.array(z))
            err_fake = ((d(fake.detach()) - 1) ** 2).mean()
            err_d = err_real + err_fake
        err_d.backward()
        d_grads = [p.grad.clone() for p in d.parameters()]
        g.zero_grad()
        with mx.autograd.record():
            err_g = (d(fake) ** 2).mean()
        err_g.backward()
        g_grads = [p.grad.clone() for p in g.parameters()]
        torch.cuda.synchronize()
        runs[graphs] = ([p.clone() for p in preds],
                        [r.tensor.detach().clone() for r in recorded],
                        float(err_d.tensor), float(err_g.tensor),
                        d_grads, g_grads)
        if graphs:
            sigs = d._cached_op._jit_cache
            assert [len(p) for e in sigs.values()
                    for p in e._train.values()] == [3, 1]
    (pg, rg, dg, gg, dgr, ggr), (pe, re_, de, ge, dge, gge) = \
        runs[True], runs[False]
    for a, b in zip(pg + rg + dgr + ggr, pe + re_ + dge + gge):
        assert _maxabs(a, b) <= GRAPH_TOL
    assert not torch.equal(pg[0], pg[-1])
    assert dg == pytest.approx(de, rel=1e-5)
    assert gg == pytest.approx(ge, rel=1e-5)


def test_failed_step_capture_applies_nothing(dev):
    """A ``ShardedTrainer`` step whose capture fails raises before the
    step is applied, at every call: parameters, optimizer state and the
    count stay as they were, and no program is kept."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import ShardedTrainer

    class Reads(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = nn.Dense(4, in_units=4)

        def forward(self, x):
            y = self.dense(x)
            return y * float(y.sum())

    net = Reads()
    net.initialize(device=dev)
    tr = ShardedTrainer(net, "adam", loss=lambda out, y: (out - y).sum(-1),
                        optimizer_params={"learning_rate": 0.1})
    tr.build(onp.ones((2, 4), "float32"))
    before = {k: v.clone() for k, v in tr.state_dict().items()}
    for _ in range(2):
        with pytest.raises(MXNetError, match=r"ShardedTrainer\(Reads\)"):
            tr.step(onp.ones((2, 4), "float32"), onp.ones((2, 4), "float32"))
        after = tr.state_dict()
        for k, v in before.items():
            assert torch.equal(after[k].cpu(), v.cpu()), k
        assert tr.optimizer.num_update == 0 and not tr._programs


def test_failed_step_capture_leaves_the_generators_usable(dev):
    """After a ``ShardedTrainer`` step whose capture failed, the card's
    default generator and the port's own draw again outside a capture
    (torch leaves a generator in capture mode when a capture cannot
    end), and a later graph drawing from the default one replays fresh
    numbers."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import ShardedTrainer

    class Reads(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = nn.Dense(4, in_units=4)

        def forward(self, x):
            y = self.dense(x)
            return y * float(y.sum())

    net = Reads()
    net.initialize(device=dev)
    tr = ShardedTrainer(net, "sgd", loss=lambda out, y: (out - y).sum(-1))
    with pytest.raises(MXNetError, match=r"ShardedTrainer\(Reads\)"):
        tr.step(onp.ones((2, 4), "float32"), onp.ones((2, 4), "float32"))
    a, b = torch.randn(8, device=dev), torch.randn(8, device=dev)
    assert not torch.equal(a, b)
    assert torch.rand(8, device=dev,
                      generator=mxrandom.generator(dev)).is_cuda
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = torch.rand(4, device=dev)
    g.replay()
    first = out.clone()
    g.replay()
    assert not torch.equal(first, out)


def test_hybridized_block_served_in_forward_mode_runs_inline(no_tf32):
    """A hybridized block behind the engine's forward mode: the engine's
    captured program runs it inline (no CachedOp program of its own is
    built or replayed inside the capture), and served rows equal the
    block's direct forward."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.serving import InferenceEngine
    dev = no_tf32
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=8), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(5, in_units=8))
    net.initialize(device=dev, seed=0)
    xs = onp.random.RandomState(1).uniform(
        -1, 1, (3, 3, 16, 16)).astype("float32")
    with torch.no_grad():
        direct = net(torch.from_numpy(xs).to(dev)).cpu()
    net.hybridize()
    eng = InferenceEngine(net, max_batch=4, device=dev)
    assert eng.warmup(example_shape=(3, 16, 16)) == 3
    with eng:
        rows = [eng.submit(x).result(timeout=60) for x in xs]
    onp.testing.assert_allclose(onp.stack(rows), direct.numpy(),
                                rtol=GRAPH_TOL, atol=GRAPH_TOL)
    assert net._cached_op is None


def _guarded_gpt2(seed):
    from mxnet_tpu_torch.amp import LossScaler
    from mxnet_tpu_torch.models import gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.models import get_gpt2
    net = get_gpt2("gpt2_124m", vocab_size=256, units=128, num_layers=2,
                   num_heads=2, max_length=256, dropout=0.0)
    return ShardedTrainer(net.initialize(seed=seed), "adam",
                          loss=gpt2_lm_loss,
                          optimizer_params={"learning_rate": 1e-3},
                          loss_scaler=LossScaler(2.0 ** 10, 2.0, 2000))


def _lm_batch(seed):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, 256, (2, 256)).astype("int32"),
            rs.randint(0, 256, (2, 256)).astype("int32"))


@pytest.mark.parametrize("site", ["trainer.loss_nonfinite",
                                  "trainer.grad_nonfinite"])
def test_poison_at_a_replay_leaves_state_and_next_replay_updates(dev, site):
    """The poisons are device inputs of the step's graph: a fault plan
    that poisons replay k makes exactly that replay non-finite (every
    parameter and optimizer-state tensor bit-identical, the loss scale
    halved), and the replays before and after it update."""
    from mxnet_tpu_torch.resilience import FaultPlan
    tr = _guarded_gpt2(7).build(_lm_batch(0)[0])
    flags, moved = [], []
    with FaultPlan().nonfinite_at(site, at=3):
        for i in range(5):
            before = {k: v.clone() for k, v in tr.state_dict().items()
                      if not k.startswith("meta:")}
            scale = tr.loss_scale
            _loss, finite = tr.step(*_lm_batch(i))
            flags.append(bool(finite))
            after = tr.state_dict()
            moved.append(sum(not torch.equal(after[k], v)
                             for k, v in before.items()))
            if i == 2:
                assert tr.loss_scale == scale / 2
    assert len(tr._programs) == 1 and tr._programs[next(iter(
        tr._programs))].prog.built
    assert flags == [True, True, False, True, True]
    assert moved[2] == 0 and all(m > 0 for i, m in enumerate(moved)
                                 if i != 2)


def test_load_state_dict_into_a_captured_trainer_steers_the_next_replay(
        no_tf32):
    """``load_state_dict`` writes in place into the tensors a captured
    step reads: the next replay continues from the loaded state, equal
    to an eager step from the same state."""
    a, b = _guarded_gpt2(3), _guarded_gpt2(3)
    b._graphs = False
    for i in range(2):
        a.step(*_lm_batch(i))                # captured, then replayed
    src = _guarded_gpt2(11)
    for i in range(3):
        src.step(*_lm_batch(10 + i))
    state = {k: v.clone() for k, v in src.state_dict().items()}
    a.load_state_dict(state)
    b.build(_lm_batch(0)[0])
    b.load_state_dict(state)
    la, fa = a.step(*_lm_batch(20))
    lb, fb = b.step(*_lm_batch(20))
    assert bool(fa) and bool(fb) and a.optimizer.num_update == 4
    assert _relerr(la, lb) <= 1e-5
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        assert _relerr(sa[k].float(), sb[k].float()) <= 1e-5, k


# ------------------------------------------------ NaN through the kernels

def _nonfinite_rows(x):
    """(rows,) bool: rows of a (B, T, H, D) output with a non-finite
    value, over every (T, H, D)."""
    return ~torch.isfinite(x.float()).flatten(1).all(dim=1)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_paged_kernel_nan_at_live_and_masked_keys(dev, kind):
    """B4 at decode (Tq 1), one row per case, each row on pages of its
    own.  A NaN at a live key of the row — in K (int8: its K scale), in
    V (its V scale), and (int8) a whole page's K scale — gives the row
    non-finite values, in the kernel as in the plain version (the
    engine's guard reads it there).  A NaN in K and V at keys past the
    row's position, on pages the row maps, leaves the kernel's row equal
    to the plain version's over clean pages: the walk ends at the row's
    position, so those keys are never read."""
    g = torch.Generator(device=dev).manual_seed(7)
    b, h, d, ps, npt = 4, 4, 64, 16, 4
    n = b * npt + 1
    kf = torch.randn((n, ps, h, d), generator=g, device=dev)
    vf = torch.randn((n, ps, h, d), generator=g, device=dev)
    kf[-1] = 0
    vf[-1] = 0
    table = torch.arange(b * npt, device=dev).reshape(b, npt) \
        .to(torch.int32)
    pos = [40, 40, 40, 20]
    qpos = torch.tensor(pos, dtype=torch.int32, device=dev)[:, None]
    q = torch.randn((b, 1, h, d), generator=g, device=dev)
    if kind == "int8":
        kp, ks = paged.kv_quantize(kf)
        vp, vs = paged.kv_quantize(vf)
    else:
        kp, vp, ks, vs = kf.clone(), vf.clone(), None, None
    clean = paged._paged_plain(q, kp, vp, table, qpos, ks, vs, d ** -0.5)

    def at(row, key):
        return int(table[row, key // ps]), key % ps
    nan = float("nan")
    live = {0: ("k", at(0, 17)), 1: ("v", at(1, 33)),
            2: ("page", at(2, 40))}
    kp2, vp2 = kp.clone(), vp.clone()
    ks2 = None if ks is None else ks.clone()
    vs2 = None if vs is None else vs.clone()
    for row, (what, (pid, off)) in live.items():
        if kind == "int8":
            if what == "page":
                ks2[pid] = nan
            else:
                (ks2 if what == "k" else vs2)[pid, off] = nan
        elif what == "page":
            kp2[pid, off, 1, 3] = nan
        else:
            (kp2 if what == "k" else vp2)[pid, off, 2, 5] = nan
    # row 3 (position 20): NaN at keys 21 and 47, past its position
    for key in (21, 47):
        pid, off = at(3, key)
        if kind == "int8":
            ks2[pid, off] = nan
            vs2[pid, off] = nan
        else:
            kp2[pid, off] = nan
            vp2[pid, off] = nan
    out = paged.paged_attention(q, kp2, vp2, table, qpos, k_scale=ks2,
                                v_scale=vs2)
    torch.cuda.synchronize()
    plain = paged._paged_plain(q, kp2, vp2, table, qpos, ks2, vs2,
                               d ** -0.5)
    assert _nonfinite_rows(out)[:3].tolist() == [True] * 3
    assert _nonfinite_rows(plain)[:3].tolist() == [True] * 3
    assert bool(torch.isfinite(out[3]).all())
    assert _maxabs(out[3], clean[3]) <= TOL[torch.float32]


def test_flash_kernel_nan_at_live_and_masked_keys(dev):
    """B1, causal, float32.  Head 0: NaN in K at key 150 — rows 150 on
    (the key is live) are non-finite in the kernel and the plain
    version; rows before it (the key is masked: its score is replaced,
    not added to) equal the plain version over clean inputs.  Head 1:
    NaN in V at key 250 — rows 250 on non-finite; rows of the query
    tiles before the key's tile (rows < 192: their walk ends before
    key tile 3) equal the clean output; rows 192-249 read the key with
    a zero weight, and 0 · NaN is NaN: non-finite in the kernel as in
    the plain version, where every earlier row reads it so."""
    g = torch.Generator(device=dev).manual_seed(150)
    b, t, h, d = 1, 300, 2, 64
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev)
               for _ in range(3))
    scale = d ** -0.5
    clean, _ = flash._fwd_plain(q, k, v, None, None, True, scale)
    k[0, 150, 0, 7] = float("nan")
    v[0, 250, 1, 9] = float("nan")
    out, _lse = flash.flash_fwd(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    plain, _ = flash._fwd_plain(q, k, v, None, None, True, scale)

    def bad(x, head):
        return ~torch.isfinite(x[0, :, head]).all(dim=-1)
    want0 = torch.arange(t, device=dev) >= 150
    assert torch.equal(bad(out, 0), want0)
    assert torch.equal(bad(plain, 0), want0)
    assert _maxabs(out[0, :150, 0], clean[0, :150, 0]) <= TOL[torch.float32]
    assert bool(bad(out, 1)[250:].all()) and bool(bad(plain, 1)[250:].all())
    assert not bool(bad(out, 1)[:192].any())
    assert _maxabs(out[0, :192, 1], clean[0, :192, 1]) <= TOL[torch.float32]
    assert bool(bad(out, 1)[192:250].all())


def _guarded_engine(net, **kw):
    from mxnet_tpu_torch.serving import InferenceEngine
    cfg = dict(num_slots=2, max_batch=2, kv_layout="paged", page_size=16,
               seq_buckets=(32,))
    cfg.update(kw)
    eng = InferenceEngine(net, **cfg)
    n = eng.warmup()
    assert all(p.graph for p in eng._programs.values())
    return eng, n


def test_in_place_scrub_reaches_the_next_replay(dev):
    """The decode program captured the caches: a NaN written in place
    into a page row 0 reads makes the next replay's finite flag for row
    0 drop (the flag rides the tokens' copy), and ``_scrub_pages``,
    which zeroes the page in place, makes the replay after it finite
    again — no capture in between, launches credited by replays."""
    net = _small_gpt2(8)
    eng, n_warm = _guarded_engine(net)
    s1 = eng.num_slots + 1
    eng._page_table[0, :2] = [3, 4]
    eng._table_stale = True
    eng._sync_table()
    g = torch.Generator(device=dev).manual_seed(3)
    for layer in eng._caches:
        for a in layer.values():
            a[3:5] = torch.randn(a[3:5].shape, generator=g, device=dev)
    tok = onp.arange(s1, dtype=onp.int32)
    pos = onp.array([20] + [eng.max_length] * (s1 - 1), onp.int32)
    samp = eng._samp_rows([], s1)
    flags = []
    launches.reset()
    flags.append(eng._run_decode(tok, pos, samp)[1, 0])
    eng._caches[0]["k"][3, 5] = float("nan")
    flags.append(eng._run_decode(tok, pos, samp)[1, 0])
    eng._scrub_pages([3])
    assert not bool(eng._caches[0]["k"][3].any())
    flags.append(eng._run_decode(tok, pos, samp)[1, 0])
    assert flags == [1, 0, 1]
    assert eng.stats()["compile"]["compiles"] == n_warm
    assert launches.totals()["paged_attention"] == 3 * len(net.blocks)
    assert eng.metrics.counters["pages_scrubbed"] == 1


def test_draft_poison_input_is_read_at_a_replay(dev):
    """``serving.draft_logits`` is a float32 input of the draft program:
    replays of the graph captured with 0.0 read a NaN poison (every
    draft proposes the NaN row's argmax) and then 0.0 again (the clean
    drafts come back bit for bit), with no capture between."""
    net = _small_gpt2(9)
    eng, n_warm = _guarded_engine(net, spec_tokens=2, draft_layers=1)
    s1 = eng.num_slots + 1
    rs = onp.random.RandomState(4)
    eng._page_table[:2, :2] = [[3, 4], [5, 6]]
    eng._table_stale = True
    eng._sync_table()
    toks = rs.randint(0, 256, (2, 32)).astype("int32")
    eng._run_prefill(toks, onp.array([30, 25], "int32"),
                     onp.array([0, 1], "int32"), eng._samp_rows([], 2))
    tok = rs.randint(0, 256, (s1,)).astype("int32")
    pos = onp.array([30, 25, eng.max_length], "int32")
    samp = eng._samp_rows([], s1)
    runs = [eng._run_draft(tok, pos, samp, pois=p).cpu().numpy()
            for p in (0.0, float("nan"), 0.0)]
    assert onp.array_equal(runs[0], runs[2])
    assert not onp.array_equal(runs[0][:2], runs[1][:2])
    assert len(set(runs[1][:2].ravel().tolist())) == 1
    assert eng.stats()["compile"]["compiles"] == n_warm


# ------------------------------------------------------- the data pipeline

@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_delivers_the_bytes_while_a_graph_replays(dev, depth):
    """``DevicePrefetcher`` over a ring of ``depth`` hands over the same
    bytes as a synchronous ``.to("cuda")``, while a captured graph
    replays on the consumer's stream between batches and reads each
    batch after its hand-over (~2 ms of work a replay): a slot rewritten
    before its reader finished would show as a wrong sum."""
    from mxnet_tpu_torch.data import DevicePrefetcher
    rs = onp.random.RandomState(depth)
    host = [(rs.randint(0, 255, (64, 256, 256)).astype("uint8"),
             onp.full(4, i, "float32")) for i in range(12)]
    static = torch.zeros((64, 256, 256), dtype=torch.uint8, device=dev)
    a = torch.randn((2048, 2048), device=dev)
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        for _ in range(2):                       # warm up, then capture
            busy = a
            for _ in range(8):
                busy = busy @ a / 2048
            out = static.sum(dtype=torch.int64) + busy.sum().to(torch.int64) * 0
    torch.cuda.current_stream(dev).wait_stream(stream)
    with torch.cuda.graph(g):
        busy = a
        for _ in range(8):
            busy = busy @ a / 2048
        out = static.sum(dtype=torch.int64) + busy.sum().to(torch.int64) * 0
    pf = DevicePrefetcher(host, shardings=dev, depth=depth)
    got = []
    for d, l in pf:
        static.copy_(d.tensor)                   # the graph's input
        g.replay()
        got.append((out.clone(), l.tensor.clone(), d.tensor.sum(
            dtype=torch.int64)))
    pf.close()
    torch.cuda.synchronize()
    assert len(got) == len(host)
    for (s_graph, lab, s_direct), (x, y) in zip(got, host):
        want = int(torch.from_numpy(x).to(dev).sum(dtype=torch.int64))
        assert int(s_graph) == want and int(s_direct) == want
        assert torch.equal(lab.cpu(), torch.from_numpy(y))
    st = pf.stats()
    assert st["batches_shipped"] == 12 and st["batches_fallback"] == 0


def test_device_transform_on_the_card_equals_the_cpu(dev):
    """The transform on the card against the same transform on the CPU,
    at several steps, NHWC and NCHW in: bit for bit (integer draws, a
    gather, a cast, one subtraction and one division a value)."""
    from mxnet_tpu_torch.data import DeviceTransform
    x = torch.from_numpy(onp.random.RandomState(0).randint(
        0, 256, (16, 40, 40, 3)).astype("uint8"))
    kw = dict(mean=(123.68, 116.779, 103.939), std=(58.393, 57.12, 57.375),
              crop=32, mirror=True, layout="NHWC", seed=5)
    tf = DeviceTransform(**kw)
    for step in (0, 1, 7, 1 << 33):
        a, b = tf.apply(x.to(dev), step), tf.apply(x, step)
        assert a.is_cuda and a.is_contiguous() and torch.equal(a.cpu(), b)
    assert tf.compile_count == 1          # one (shape, dtype) point
    nchw = DeviceTransform(**dict(kw, layout="NCHW", out_layout="NHWC"))
    assert torch.equal(nchw.apply(x.permute(0, 3, 1, 2).contiguous().to(dev),
                                  7).cpu(), tf.apply(x, 7))


def test_step_capture_meets_a_working_feeder(no_tf32):
    """A ``ShardedTrainer``'s first step is captured while the
    prefetcher's feeder is still at work (pinning, copying and
    transforming a batch every few ms on its stream, with nothing
    settled first): the losses equal those of the same transformed
    batches fed resident."""
    from mxnet_tpu_torch.data import DevicePrefetcher, DeviceTransform
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import ShardedTrainer
    rs = onp.random.RandomState(11)
    n = 32
    host = [(rs.randint(0, 256, (64, 128, 128, 3)).astype("uint8"),
             rs.uniform(-1, 1, (64, 10)).astype("float32"))
            for _ in range(n)]

    def slow():
        for b in host:
            time.sleep(0.003)
            yield b

    def trainer():
        net = nn.HybridSequential()
        net.add(nn.Flatten(), nn.Dense(10, in_units=112 * 112 * 3))
        net.initialize(device=no_tf32, seed=0)
        return ShardedTrainer(net, "adam",
                              loss=lambda out, y: ((out - y) ** 2).sum(-1),
                              optimizer_params={"learning_rate": 1e-3})

    kw = dict(mean=(123.68, 116.779, 103.939), std=(58.393, 57.12, 57.375),
              crop=112, mirror=True, layout="NHWC", seed=3)
    tr = trainer()
    pf = tr.attach_data_source(DevicePrefetcher(
        slow(), depth=n, transform=DeviceTransform(**kw)))
    d, l = pf.next()
    piped = [float(tr.step(d, l))]
    fed = pf.stats()["fed"]
    piped += [float(tr.step(d, l)) for d, l in pf]
    pf.close()
    assert fed < n, "the feeder finished before the capture did"
    tf, tr = DeviceTransform(**kw), trainer()
    resident = [float(tr.step(tf.apply(torch.from_numpy(x).to(no_tf32), i),
                              torch.from_numpy(y).to(no_tf32)))
                for i, (x, y) in enumerate(host)]
    assert piped == resident


def test_prefetched_batch_trains_like_a_resident_one(no_tf32):
    """A batch fed into a ``ShardedTrainer`` graph from the prefetcher
    (page-locked ``DataLoader`` → feeder stream) gives the losses of the
    same batches fed as resident tensors."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.context import cpu
    from mxnet_tpu_torch.data import DevicePrefetcher
    from mxnet_tpu_torch.models import gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    rs = onp.random.RandomState(3)
    toks = rs.randint(0, 256, (20, 129)).astype("int32")
    ds = gluon.data.ArrayDataset(toks[:, :-1], toks[:, 1:])
    losses = {}
    for arm, net in zip(("pipeline", "resident"), _gpt2_pair(7)):
        tr = ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                            optimizer_params={"learning_rate": 1e-3})
        dl = gluon.data.DataLoader(ds, batch_size=4, pin_memory=True)
        if arm == "pipeline":
            src = tr.attach_data_source(DevicePrefetcher(dl, depth=2))
        else:
            src = [(d.tensor.to(no_tf32), l.tensor.to(no_tf32))
                   for d, l in dl]
        losses[arm] = [float(tr.step(d, l)) for d, l in src]
        if arm == "pipeline":
            assert src.stats()["batches_shipped"] == 5
            assert next(iter(dl))[0].tensor.is_pinned()
            assert next(iter(dl))[0].context == cpu()
            src.close()
    assert len(losses["pipeline"]) == 5
    assert losses["pipeline"] == losses["resident"]


def test_one_rank_nccl_mesh_engine_graphed_equals_no_mesh(dev):
    """``InferenceEngine(mesh=1)`` under a one-rank NCCL group: every
    program a CUDA graph, the mesh point ``1dev:tp=1``, and the greedy
    and sampled streams of the paged gather arm and the dense layout
    bit-identical to ``mesh=None``'s."""
    import torch.distributed as dist
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.serving import InferenceEngine
    if dist.is_initialized():
        pytest.skip("a process group is already up")
    net = _small_gpt2(5)
    rs = onp.random.RandomState(4)
    prompts = [rs.randint(0, 256, (n,)).astype("int32")
               for n in (260, 30, 120)]
    samp = [dict(), dict(temperature=0.9, top_k=20, seed=3), dict()]
    par.init_distributed(None, 1, 0, backend="nccl")
    try:
        for layout in ("paged", "dense"):
            kw = dict(kv_layout="paged", page_size=16,
                      paged_attention="gather") if layout == "paged" else {}
            outs = {}
            for mesh in (None, 1):
                eng = InferenceEngine(net, num_slots=4, max_batch=4,
                                      seq_buckets=(32, 128, 384), **kw,
                                      mesh=mesh)
                n = eng.warmup()
                assert all(p.graph for p in eng._programs.values())
                with eng:
                    futs = [eng.submit(p, max_new_tokens=16, **s)
                            for p, s in zip(prompts, samp)]
                    outs[mesh] = [f.result(timeout=300) for f in futs]
                    st = eng.stats()
                assert st["compile"]["compiles"] == n
                assert st["mesh"]["mesh_point"] == \
                    ("1dev" if mesh is None else "1dev:tp=1")
            for a, b in zip(outs[None], outs[1]):
                onp.testing.assert_array_equal(a, b)
    finally:
        dist.destroy_process_group()
