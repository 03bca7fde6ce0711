"""The port's BERT against the JAX package's, on one set of weights.

A 2-layer BERT (units 64, 4 heads, vocab 96, ``max_length`` 32,
dropout 0) with its pretraining heads is built in both packages; the
port gets the reference's parameters by ``load_numpy_params`` and,
once, through a reference ``save_parameters`` file.  Compared: the
sequence and pooled outputs with and without ``valid_length``, the
masked-LM logits at the masked positions and the next-sentence logits,
and every parameter's gradient of ``bench.py``'s MLM + NSP loss (the
tied word embedding's sums both of its uses).  The port's ``remat``
('dots' and full) is held to its plain forward and gradients.

Tolerance: max-abs 1e-5 on outputs and logits, gradients within 1e-5
of their own max-abs (float32, one function summed in another order).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import get_bert as jget_bert
from mxnet_tpu.models.bert import BERTForPretrain as JPretrain
from mxnet_tpu_torch.models import BERTForPretrain, get_bert
from mxnet_tpu_torch.utils.convert import load_numpy_params

torch.set_num_threads(1)

CFG = dict(vocab_size=96, units=64, num_layers=2, num_heads=4,
           max_length=32, dropout=0.0)
TOL = 1e-5
B, T, M = 3, 24, 5


def _batch(seed=0):
    rs = onp.random.RandomState(seed)
    toks = rs.randint(0, 96, (B, T)).astype("int32")
    types = (onp.arange(T)[None] >= rs.randint(4, T, (B, 1))) \
        .astype("int32")
    vlen = onp.array([T, 17, 9], "int32")
    pos = onp.stack([onp.sort(rs.choice(9, M, replace=False))
                     for _ in range(B)]).astype("int32")
    mlm = rs.randint(0, 96, (B, M)).astype("int32")
    nsp = rs.randint(0, 2, (B,)).astype("int32")
    return toks, types, vlen, pos, mlm, nsp


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    jn = JPretrain(jget_bert("bert_base", **CFG))
    mx.random.seed(0)
    jn.initialize()
    jn(*(mx.nd.array(a, dtype="int32") for a in _batch()[:4]))
    rs = onp.random.RandomState(0)
    params = {}
    for k, p in jn._collect_params_with_prefix().items():
        # biases and LayerNorm shifts away from their zero init too
        v = p.data().asnumpy() + rs.uniform(-0.05, 0.05, p.shape)
        p.set_data(mx.nd.array(v.astype("float32")))
        params[k] = v.astype("float32")
    tn = load_numpy_params(BERTForPretrain(get_bert("bert_base",
                                                    device="cpu", **CFG)),
                           params)
    path = str(tmp_path_factory.mktemp("bert") / "ref.params")
    jn.save_parameters(path)
    tf = BERTForPretrain(get_bert("bert_base", device="cpu", **CFG))
    tf.load_parameters(path)
    return jn, tn, tf, params


def _j(*arrays):
    return [None if a is None else mx.nd.array(a, dtype="int32")
            for a in arrays]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _close(a, b, what, tol=TOL):
    a, b = onp.asarray(a), onp.asarray(b)
    assert a.shape == b.shape, what
    assert onp.abs(a - b).max() <= tol, (what, onp.abs(a - b).max())


def test_names_and_both_load_routes(nets):
    jn, tn, tf, params = nets
    names = list(tn.collect_params().keys())
    assert names == list(jn._collect_params_with_prefix().keys())
    assert "backbone.layer1.attn.k_proj.bias" in names
    for (k, a), b in zip(tn.named_parameters(), tf.parameters()):
        onp.testing.assert_array_equal(a.detach().numpy(), params[k])
        onp.testing.assert_array_equal(b.detach().numpy(), params[k])


@pytest.mark.parametrize("with_vlen", [False, True])
def test_backbone_outputs_match(nets, with_vlen):
    jn, tn, _tf, _p = nets
    toks, types, vlen, *_ = _batch()
    v = vlen if with_vlen else None
    jseq, jpool = jn.backbone(*_j(toks, types, v))
    with torch.no_grad():
        tseq, tpool = tn.backbone(*_t(toks, types, v))
    _close(tseq.numpy(), jseq.asnumpy(), "sequence output")
    _close(tpool.numpy(), jpool.asnumpy(), "pooled output")
    if with_vlen:
        # a padded row's real positions differ from the unmasked run's
        full, _ = tn.backbone(*_t(toks, types, None))
        assert onp.abs(full[2, :9].detach().numpy()
                       - tseq[2, :9].numpy()).max() > 1e-3


@pytest.mark.parametrize("with_vlen", [False, True])
def test_pretrain_heads_and_gradients_match(nets, with_vlen):
    jn, tn, _tf, _p = nets
    toks, types, vlen, pos, mlm, nsp = _batch(1)
    v = vlen if with_vlen else None

    def loss_of(F, outs, y_mlm, y_nsp):
        m, n = outs
        lm = (F.logsumexp(m, axis=-1) - F.pick(m, y_mlm, axis=-1)).mean()
        ln = (F.logsumexp(n, axis=-1) - F.pick(n, y_nsp, axis=-1)).mean()
        return lm + ln

    with mx.autograd.record():
        jout = jn(*_j(toks, types, v, pos))
        jl = loss_of(mx.nd, jout, *_j(mlm, nsp))
    jl.backward()
    tout = tn(*_t(toks, types, v, pos))
    tm, tnsp = tout
    y_mlm, y_nsp = (torch.from_numpy(a).long() for a in (mlm, nsp))
    tl = ((tm.logsumexp(-1) - tm.gather(-1, y_mlm[..., None])[..., 0])
          .mean() + (tnsp.logsumexp(-1) -
                     tnsp.gather(-1, y_nsp[:, None])[:, 0]).mean())
    grads = torch.autograd.grad(tl, list(tn.parameters()))
    assert tm.shape == (B, M, 96) and tnsp.shape == (B, 2)
    _close(tm.detach().numpy(), jout[0].asnumpy(), "MLM logits")
    _close(tnsp.detach().numpy(), jout[1].asnumpy(), "NSP logits")
    _close(float(tl.detach()), float(jl.asscalar()), "loss")
    jp = jn._collect_params_with_prefix()
    for (k, _x), g in zip(tn.named_parameters(), grads):
        want = jp[k].grad().asnumpy()
        scale = max(float(onp.abs(want).max()), 1e-30)
        # k_proj.bias: zero in exact arithmetic (the softmax cancels it)
        if k.endswith("k_proj.bias"):
            scale = 1.0
        _close(g.numpy() / scale, want / scale, f"gradient {k}")


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_matches_plain(nets, remat):
    _jn, tn, _tf, _p = nets
    toks, types, vlen, pos, _m, _n = _batch(2)
    args = _t(toks, types, vlen, pos)
    res = {}
    for r in (False, remat):
        tn.backbone._remat = r
        m, n = tn(*args)
        loss = m.square().mean() + n.square().mean()
        res[r] = (loss.detach(), torch.autograd.grad(
            loss, list(tn.parameters())))
    tn.backbone._remat = False
    assert torch.equal(res[False][0], res[remat][0])
    for a, b in zip(res[False][1], res[remat][1]):
        assert torch.allclose(a, b, rtol=0, atol=1e-7)


def test_length_checks(nets):
    _jn, tn, _tf, _p = nets
    with pytest.raises(ValueError):
        tn.backbone(torch.zeros((1, 33), dtype=torch.int32))
    with pytest.raises(KeyError):
        get_bert("bert_huge", device="cpu")


def test_attention_dropout_only_in_training_and_off_the_flash_route():
    """``attention_dropout`` drops attention weights in training (masks
    from the device's generator: one seed, one mask), leaves inference
    untouched, and keeps attention off the flash kernels, as the
    reference's dispatch does (``impl='flash'`` refuses it)."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.base import MXNetError, training_mode
    from mxnet_tpu_torch.models.transformer import MultiHeadAttention
    from mxnet_tpu_torch.ops import attention
    x = torch.from_numpy(onp.random.RandomState(0).randn(2, 8, 32)
                         .astype("float32"))
    plain = MultiHeadAttention(32, 4).initialize(seed=1, device="cpu")
    drop = load_numpy_params(
        MultiHeadAttention(32, 4, attention_dropout=0.5),
        {k: v.detach() for k, v in plain.named_parameters()}, device="cpu")
    with torch.no_grad():
        assert torch.equal(drop(x), plain(x))
        outs = []
        for seed in (3, 3, 4):
            tmx.random.seed(seed)
            with training_mode(True):
                outs.append(drop(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], outs[2])
    assert not torch.allclose(outs[0], plain(x))
    q = torch.zeros(1, 256, 2, 64)
    assert not attention._use_flash(q, q, None, dropout=0.1)
    with pytest.raises(MXNetError):
        attention.dot_product_attention(q, q, q, dropout=0.1, impl="flash")
