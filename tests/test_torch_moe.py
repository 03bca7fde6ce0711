"""The port's MoE layers and the routed GPT-2 against the JAX package's.

The layer (4 experts of 16 → 32 → 16, top 2) runs the same numpy inputs
and weights in both packages at ample capacity and at one that drops
choices: output, aux loss and the router's and experts' gradients within
1e-5 of each max-abs, and the same (expert, slot) → token table, read off
the reference's dispatch.  The routed GPT-2 (vocab 128, 32 units, 2
layers of 4 heads, 2 experts in h1, 64 positions, dropout 0) takes its
weights from the reference through ``load_numpy_params``: logits 1e-5,
the loss with its aux term 1e-5, every gradient 1e-4 of its max-abs;
``ShardedTrainer`` steps with LAMB and RMSProp against the reference's
(losses 1e-5, parameters 1e-4), resumed from the reference's state dict;
``grad_accum=2`` against the full batch at the reference's own rtol 2e-3
(``tests/test_moe_pipeline.py:257``).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as par
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.models import gpt2_lm_loss as jloss
from mxnet_tpu.models import moe as jmoe
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.models import gpt2_lm_loss as tloss
from mxnet_tpu_torch.models import moe as tmoe
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.utils.convert import load_numpy_params, load_numpy_state

torch.set_num_threads(1)

E, U, H, B, T = 4, 16, 32, 2, 8
LAYER_TOL = 1e-5
CFG = dict(vocab_size=128, units=32, num_layers=2, num_heads=4,
           max_length=64, dropout=0.0, num_experts=2, moe_every=2)
LOGIT_TOL, LOSS_RTOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-4, 1e-4
WEIGHT_SEED = 5


def _layer_params(rs, h=H):
    return {"gate": rs.randn(E, U).astype("float32") * 0.5,
            "w1": rs.randn(E, U, h).astype("float32") * 0.2,
            "b1": rs.randn(E, h).astype("float32") * 0.1,
            "w2": rs.randn(E, h, U).astype("float32") * 0.2,
            "b2": rs.randn(E, U).astype("float32") * 0.1}


def _ref_layer(params, **kw):
    layer = jmoe.MoELayer(U, H, E, **kw)
    layer.initialize()
    for k, p in layer._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    return layer


def _rel(a, ref):
    ref = onp.asarray(ref)
    return float(onp.abs(onp.asarray(a) - ref).max()) / max(
        float(onp.abs(ref).max()), 1e-30)


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5],
                         ids=["ample", "dropping"])
def test_moe_layer_matches_reference(capacity_factor):
    rs = onp.random.RandomState(0)
    params = _layer_params(rs)
    x = rs.randn(B, T, U).astype("float32")
    cot = rs.randn(B, T, U).astype("float32")
    ref = _ref_layer(params, top_k=2, capacity_factor=capacity_factor)
    with mx.autograd.record():
        y = ref(mx.nd.array(x))
        aux = jmoe.pop_aux_losses()
        assert len(aux) == 1
        loss = (y * mx.nd.array(cot)).sum() + aux[0]
    loss.backward()
    ref_grads = {k: p.grad().asnumpy()
                 for k, p in ref._collect_params_with_prefix().items()}

    layer = load_numpy_params(
        tmoe.MoELayer(U, H, E, top_k=2, capacity_factor=capacity_factor),
        params, device="cpu")
    with tmoe.aux_loss_scope():
        yt = layer(torch.from_numpy(x))
        auxt = tmoe.pop_aux_losses()
    assert len(auxt) == 1 and tmoe.pop_aux_losses() == []
    grads = torch.autograd.grad(
        (yt * torch.from_numpy(cot)).sum() + auxt[0],
        list(layer.parameters()))
    assert _rel(yt.detach(), y.asnumpy()) <= LAYER_TOL
    assert _rel(auxt[0].detach(), aux[0].asnumpy()) <= LAYER_TOL
    for (k, _p), g in zip(layer.named_parameters(), grads):
        assert _rel(g, ref_grads[k]) <= LAYER_TOL, k
    assert (float(layer.last_dropped) > 0) == (capacity_factor < 1)


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5],
                         ids=["ample", "dropping"])
def test_moe_routing_drops_the_reference_set(capacity_factor):
    """The (expert, slot) → token table of the port's index dispatch
    equals the reference's one-hot dispatch, read off its expert input:
    with identity ``w1`` (hidden = units) and zero ``b1`` the activation
    sees ``x_e`` itself, whose rows are the dispatched tokens."""
    rs = onp.random.RandomState(1)
    params = _layer_params(rs, h=U)
    params["w1"] = onp.broadcast_to(onp.eye(U, dtype="float32"),
                                    (E, U, U)).copy()
    params["b1"][:] = 0
    x = rs.randn(B, T, U).astype("float32")
    xf = x.reshape(-1, U)
    n, k = B * T, 2
    cap = max(int(onp.ceil(k * n / E * capacity_factor)), k)
    seen = []

    def capture(h):
        seen.append(onp.asarray(h))
        return jax.nn.gelu(h)

    jmoe._moe_ffn(jnp.asarray(x), *(jnp.asarray(params[p]) for p in
                                    ("gate", "w1", "b1", "w2", "b2")),
                  num_experts=E, top_k=k, capacity=cap, activation=capture)
    x_e = seen[0]                                     # (E, C, U)
    ref_table = onp.full((E, cap), -1)
    for e in range(E):
        for c in range(cap):
            if onp.abs(x_e[e, c]).max() > 0:
                ref_table[e, c] = int(onp.argmin(
                    onp.abs(xf - x_e[e, c]).max(-1)))
    _p, gates, idx, pos, in_cap = tmoe._route(
        torch.from_numpy(xf), torch.from_numpy(params["gate"]), E, k, cap)
    table = onp.full((E, cap), -1)
    kept = (in_cap & (gates > 0)).numpy()
    for tok, j in zip(*onp.nonzero(kept)):
        table[int(idx[tok, j]), int(pos[tok, j])] = tok
    onp.testing.assert_array_equal(table, ref_table)
    assert (kept.sum() < n * k) == (capacity_factor < 1)


def test_full_topk_equals_dense_mixture():
    """top_k == E at ample capacity is the softmax-weighted mixture of
    every expert: the reference's closed form
    (``tests/test_moe_pipeline.py:20-41``), at its 1e-4."""
    rs = onp.random.RandomState(0)
    params = _layer_params(rs)
    x = rs.randn(B, T, U).astype("float32")
    layer = load_numpy_params(
        tmoe.MoELayer(U, H, E, top_k=E, capacity_factor=8.0), params,
        device="cpu")
    with torch.no_grad():
        y = layer(torch.from_numpy(x)).numpy()
    xf = x.reshape(-1, U)
    logits = xf @ params["gate"].T
    probs = onp.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    h = onp.asarray(jax.nn.gelu(jnp.asarray(
        onp.einsum("nd,edh->neh", xf, params["w1"]) + params["b1"][None])))
    ye = onp.einsum("neh,ehd->ned", h, params["w2"]) + params["b2"][None]
    want = onp.einsum("ne,ned->nd", probs, ye).reshape(B, T, U)
    onp.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)


def test_hybridized_equals_imperative_and_records_once_per_call():
    """The hybridized layer (its CachedOp) computes what the imperative
    one does: the same output and aux bit
    for bit, one aux entry per call inside ``autograd.record()``, none
    outside it, and ``moe_ffn`` as an op on NDArrays records too."""
    rs = onp.random.RandomState(3)
    params = _layer_params(rs)
    with tmx.cpu():
        layer = load_numpy_params(tmoe.MoELayer(U, H, E), params)
        x = tmx.nd.array(rs.randn(B, T, U).astype("float32"))
        with tmx.autograd.record():
            y_i = layer(x)
            aux_i = tmoe.pop_aux_losses()
        layer.hybridize(static_alloc=True)
        with tmx.autograd.record():
            y_h = layer(x)
            aux_h = tmoe.pop_aux_losses()
        assert len(aux_i) == len(aux_h) == 1
        assert torch.equal(y_h.tensor, y_i.tensor)
        assert torch.equal(aux_h[0], aux_i[0])
        layer(x)
        assert tmoe.pop_aux_losses() == []
        with tmx.autograd.record():
            y_op, aux_op = tmoe.moe_ffn(
                x, *(layer.collect_params()[k].data()
                     for k in ("gate", "w1", "b1", "w2", "b2")),
                num_experts=E, top_k=2, capacity=layer.capacity(B * T))
        assert torch.equal(y_op.tensor, y_i.tensor)
        assert y_op.tensor.requires_grad and aux_op.tensor.requires_grad


# ------------------------------------------------------- routed GPT-2

@pytest.fixture(scope="module")
def params():
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(WEIGHT_SEED)
    jn.initialize()
    return {k: p.data().asnumpy()
            for k, p in jn._collect_params_with_prefix().items()}


def _ref_net(params):
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(WEIGHT_SEED)
    jn.initialize()
    for k, p in jn._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    return jn


def _port_net(params):
    return load_numpy_params(tget_gpt2("gpt2_124m", device="cpu", **CFG),
                             params)


def _batch(seed, b=8, t=16):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, 128, (b, t)).astype("int32"),
            rs.randint(0, 128, (b, t)).astype("int32"))


def test_moe_names_and_shapes_carry_across(params):
    """Every parameter of the routed model, MoE experts included, has the
    same structural name, shape and order in both packages."""
    jn = _ref_net(params)
    ref = [(k, tuple(p.shape))
           for k, p in jn._collect_params_with_prefix().items()]
    net = _port_net(params)
    port = [(k, tuple(p.shape)) for k, p in net.named_parameters()]
    assert sorted(ref) == sorted(port)
    assert ("h1.moe.w1", (2, 32, 128)) in port
    assert not any(k.startswith("h0.moe") for k, _s in port)


def test_moe_gpt2_matches_reference(params):
    toks, labels = _batch(0)
    jn = _ref_net(params)
    with mx.autograd.record():
        jl = jn(mx.nd.array(toks, dtype="int32"))
        jloss_v = jloss(jl, mx.nd.array(labels, dtype="int32"))
    jloss_v.backward()
    ref_grads = {k: p.grad().asnumpy()
                 for k, p in jn._collect_params_with_prefix().items()}
    net = _port_net(params)
    with tbase.training_mode(True), tmoe.aux_loss_scope():
        logits = net(torch.from_numpy(toks))
        loss = tloss(logits, torch.from_numpy(labels))
        assert tmoe.pop_aux_losses() == []
    grads = torch.autograd.grad(loss, list(net.parameters()))
    assert _rel(logits.detach(), jl.asnumpy()) <= LOGIT_TOL
    assert float(loss.detach()) == pytest.approx(
        float(jloss_v.asscalar()), rel=LOSS_RTOL)
    # the aux term is in: without it the loss moves by 0.01 * aux ~ 1e-2
    with torch.no_grad():
        dense = tloss(net(torch.from_numpy(toks)),
                      torch.from_numpy(labels))
    assert abs(float(loss.detach()) - float(dense)) > 1e-3
    # k_proj.bias adds one constant to a row's scores, which the softmax
    # cancels: zero in exact arithmetic, held against the largest
    top = max(float(onp.abs(g).max()) for g in ref_grads.values())
    for (k, _p), g in zip(net.named_parameters(), grads):
        err = float(onp.abs(g.numpy() - ref_grads[k]).max())
        scale = top if k.endswith("k_proj.bias") else \
            float(onp.abs(ref_grads[k]).max())
        assert err <= GRAD_TOL * scale, k


def _ref_trainer(params, name):
    mesh = par.make_mesh(dp=1, devices=jax.devices()[:1])
    net = _ref_net(params)
    with par.use_mesh(mesh):
        tr = par.ShardedTrainer(net, name, loss=jloss, mesh=mesh,
                                optimizer_params={"learning_rate": 1e-3,
                                                  "wd": 0.01})
    return mesh, net, tr


@pytest.mark.parametrize("name", ["lamb", "rmsprop"])
def test_trainer_steps_and_state_dict_carry_across(params, name):
    """Two ``ShardedTrainer`` steps in both packages (losses 1e-5,
    parameters 1e-4), then the reference's ``state_dict()`` loaded into a
    fresh port trainer (``load_numpy_state``): its third step equals the
    reference's.  The aux collector is empty after every port step."""
    mesh, jn, jtr = _ref_trainer(params, name)
    tr = ShardedTrainer(_port_net(params), name, loss=tloss,
                        optimizer_params={"learning_rate": 1e-3,
                                          "wd": 0.01})
    for seed in (0, 1):
        toks, labels = _batch(seed)
        with par.use_mesh(mesh):
            want = float(jtr.step(mx.nd.array(toks, dtype="int32"),
                                  mx.nd.array(labels, dtype="int32"))
                         .asnumpy())
        got = float(tr.step(toks, labels))
        assert tbase.pop_aux_losses() == []
        assert got == pytest.approx(want, rel=LOSS_RTOL)
    ref_state = {k: onp.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                                else v)
                 for k, v in jtr.state_dict().items()}
    fresh = ShardedTrainer(_port_net(params), name, loss=tloss,
                           optimizer_params={"learning_rate": 1e-3,
                                             "wd": 0.01})
    load_numpy_state(fresh, ref_state)
    toks, labels = _batch(2)
    with par.use_mesh(mesh):
        want = float(jtr.step(mx.nd.array(toks, dtype="int32"),
                              mx.nd.array(labels, dtype="int32")).asnumpy())
    assert float(fresh.step(toks, labels)) == pytest.approx(want,
                                                            rel=LOSS_RTOL)
    ref_params = {k: p.data().asnumpy()
                  for k, p in jn._collect_params_with_prefix().items()}
    for k, p in fresh.net.named_parameters():
        onp.testing.assert_allclose(p.detach().numpy(), ref_params[k],
                                    atol=PARAM_TOL, rtol=0, err_msg=k)


def test_grad_accum_matches_full_batch(params):
    """``grad_accum=2`` (an aux scope per microbatch; capacity from the
    microbatch's own tokens) against the full batch over 3 Adam steps,
    at the reference's rtol 2e-3; the collector is empty after each."""
    def train(accum):
        tr = ShardedTrainer(_port_net(params), "adam", loss=tloss,
                            optimizer_params={"learning_rate": 1e-2},
                            grad_accum=accum)
        toks, labels = _batch(0)
        out = []
        for _ in range(3):
            out.append(float(tr.step(toks, labels)))
            assert tbase.pop_aux_losses() == []
        return out

    onp.testing.assert_allclose(train(1), train(2), rtol=2e-3, atol=1e-4)
