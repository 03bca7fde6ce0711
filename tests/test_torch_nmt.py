"""The port's Transformer NMT against the JAX package's, on one set of
weights.

A 2 + 2-layer model (units 32, hidden 64, 4 heads, source vocab 32,
target vocab 40, dropout 0) is built in both packages; the port gets
the reference's parameters by ``load_numpy_params`` (and a
``shared_embed`` model through the reference's ``save_parameters``
file, which names the shared table twice).  Compared: logits with and
without ``src_valid_length`` and at equal and unequal source and target
lengths, ``nmt_loss`` with and without ``valid_length``, every
parameter's gradient, the gradient of the encoder's output through the
decoder's cross-attention, and greedy and beam ``translate`` tokens,
which must be identical.  The port's decoder remat is held to its plain
forward.

Tolerance: max-abs 1e-5 on logits and losses, gradients within 1e-5 of
their own max-abs (float32).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu_torch.models import TransformerNMT, get_nmt, nmt_loss
from mxnet_tpu_torch.models import nmt as tnmt
from mxnet_tpu_torch.utils.convert import load_numpy_params

torch.set_num_threads(1)

CFG = dict(src_vocab_size=32, tgt_vocab_size=40, units=32, hidden_size=64,
           num_layers=2, num_heads=4, dropout=0.0)
TOL = 1e-5
B = 3
# an id these weights emit, so EOS handling is exercised
EOS = 29


def _reference(**kw):
    cfg = dict(CFG, **kw)
    jn = jmodels.TransformerNMT(**cfg)
    mx.random.seed(0)
    jn.initialize()
    rs = onp.random.RandomState(1)
    params, seen = {}, {}
    for k, p in jn._collect_params_with_prefix().items():
        if id(p) in seen:          # the shared table's second name
            params[k] = params[seen[id(p)]]
            continue
        seen[id(p)] = k
        # seeded weights, LayerNorm gains near 1; the decoder's block
        # outputs scaled up so they, not the tied embedding of the last
        # token, decide the argmax: random weights then decode varied
        # tokens, EOS included
        v = rs.uniform(-0.3, 0.3, p.shape)
        if k.endswith("gamma"):
            v = 1.0 + 0.2 * v
        if k.startswith("dec") and k.endswith(("out_proj.weight",
                                               "fc2.weight")):
            v = 6.0 * v
        v = v.astype("float32")
        p.set_data(mx.nd.array(v))
        params[k] = v
    return jn, params


@pytest.fixture(scope="module")
def nets():
    jn, params = _reference()
    tn = load_numpy_params(TransformerNMT(**CFG), params, device="cpu")
    return jn, tn


def _data(ts, tt, seed=0):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, 32, (B, ts)).astype("int32"),
            rs.randint(0, 40, (B, tt)).astype("int32"),
            onp.array([ts, ts - 3, 2], "int32"),
            rs.randint(0, 40, (B, tt)).astype("int32"))


def _j(a):
    return None if a is None else mx.nd.array(a, dtype="int32")


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(a, b, what, tol=TOL):
    a, b = onp.asarray(a), onp.asarray(b)
    assert a.shape == b.shape, what
    assert onp.abs(a - b).max() <= tol, (what, onp.abs(a - b).max())


def _grads_close(tn, grads, jparams):
    for (k, _p), g in zip(tn.named_parameters(), grads):
        want = jparams[k].grad().asnumpy()
        scale = 1.0 if k.endswith("k_proj.bias") else \
            max(float(onp.abs(want).max()), 1e-30)
        _close(g.numpy() / scale, want / scale, f"gradient {k}")


@pytest.mark.parametrize("with_vlen", [False, True])
@pytest.mark.parametrize("ts,tt", [(12, 12), (12, 7)])
def test_logits_loss_and_gradients_match(nets, ts, tt, with_vlen):
    jn, tn = nets
    src, tgt, vlen, labels = _data(ts, tt)
    v = vlen if with_vlen else None
    lvl = onp.array([tt, tt - 2, 3], "int32") if with_vlen else None
    with mx.autograd.record():
        jlog = jn(_j(src), _j(tgt), _j(v))
        jl = jmodels.nmt_loss(jlog, _j(labels), _j(lvl))
    jl.backward()
    tlog = tn(_t(src), _t(tgt), _t(v))
    tl = nmt_loss(tlog, _t(labels), _t(lvl))
    _close(tlog.detach().numpy(), jlog.asnumpy(), "logits")
    _close(float(tl.detach()), float(jl.asscalar()), "nmt_loss")
    grads = torch.autograd.grad(tl, list(tn.parameters()))
    _grads_close(tn, grads, jn._collect_params_with_prefix())


@pytest.mark.parametrize("ts,tt", [(12, 12), (12, 7)])
def test_encoder_output_gradient_through_cross_attention(nets, ts, tt):
    """d loss / d memory, the sum over every decoder layer's cross
    attention (its k and v are projections of the encoder output)."""
    jn, tn = nets
    src, tgt, _v, labels = _data(ts, tt, seed=3)
    mem = jn.encode(_j(src))
    mem.attach_grad()
    with mx.autograd.record():
        jl = jmodels.nmt_loss(jn.decode(_j(tgt), mem), _j(labels))
    jl.backward()
    tmem = tn.encode(_t(src)).detach().requires_grad_()
    tl = nmt_loss(tn.decode(_t(tgt), tmem), _t(labels))
    (g,) = torch.autograd.grad(tl, [tmem])
    _close(tmem.detach().numpy(), mem.asnumpy(), "encoder output")
    want = mem.grad.asnumpy()
    _close(g.numpy() / onp.abs(want).max(), want / onp.abs(want).max(),
           "encoder output gradient")


@pytest.mark.parametrize("beam,with_vlen", [(1, False), (4, True)])
def test_greedy_and_beam_tokens_identical(nets, beam, with_vlen):
    jn, tn = nets
    src, _t_, vlen, _l = _data(10, 10, seed=5)
    v = vlen if with_vlen else None
    kw = dict(max_length=6, beam_size=beam, alpha=0.8, eos_id=EOS)
    want = jn.translate(_j(src), _j(v), **kw)
    got = tn.translate(src, v, **kw)
    assert got.dtype == onp.int32
    onp.testing.assert_array_equal(got, onp.asarray(want))
    assert (got == EOS).any() and len(onp.unique(got)) > 2


def test_shared_embedding_from_a_reference_file(tmp_path):
    jn, params = _reference(tgt_vocab_size=32, shared_embed=True)
    assert "tgt_embed.weight" in jn._collect_params_with_prefix()
    path = str(tmp_path / "shared.params")
    jn.save_parameters(path)
    cfg = dict(CFG, tgt_vocab_size=32, shared_embed=True)
    tn = TransformerNMT(**cfg)
    tn.load_parameters(path, device="cpu")
    assert tn.tgt_embed is tn.src_embed
    src, tgt, _v, _l = _data(9, 6, seed=7)
    tgt = tgt % 32
    want = jn(_j(src), _j(tgt)).asnumpy()
    with torch.no_grad():
        got = tn(_t(src), _t(tgt)).numpy()
    _close(got, want, "shared-embedding logits")
    # the port's file names the table twice too, and loads back
    tn.save_parameters(str(tmp_path / "port.params"))
    jn2 = jmodels.TransformerNMT(**cfg)
    jn2.load_parameters(str(tmp_path / "port.params"))
    onp.testing.assert_array_equal(
        jn2.src_embed.weight.data().asnumpy(), params["src_embed.weight"])
    with pytest.raises(ValueError):
        TransformerNMT(**dict(CFG, shared_embed=True))


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_matches_plain(nets, remat):
    _jn, tn = nets
    src, tgt, vlen, labels = _data(12, 7, seed=9)
    res = {}
    for r in (False, remat):
        tn._remat = r
        loss = nmt_loss(tn(_t(src), _t(tgt), _t(vlen)), _t(labels))
        res[r] = (loss.detach(), torch.autograd.grad(
            loss, list(tn.parameters())))
    tn._remat = False
    assert torch.equal(res[False][0], res[remat][0])
    for a, b in zip(res[False][1], res[remat][1]):
        assert torch.allclose(a, b, rtol=0, atol=1e-7)


def test_sinusoidal_positions_and_configs():
    x = torch.zeros(1, 5, 8)
    pe = tnmt._sinusoidal_positions(x, 8)[0]
    pos, dim = onp.arange(5)[:, None], onp.arange(4)[None]
    ang = pos / onp.power(10000.0, 2.0 * dim / 8)
    onp.testing.assert_allclose(pe.numpy(), onp.concatenate(
        [onp.sin(ang), onp.cos(ang)], -1), rtol=0, atol=1e-6)
    big = get_nmt("transformer_big", device="cpu", src_vocab_size=100)
    assert (len(big.enc_layers), big._units,
            big.dec_layers[0].ffn.fc1._units) == (6, 1024, 4096)
    assert big.dec_layers[0].cross_attn._num_heads == 16
