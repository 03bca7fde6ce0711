"""BERT and Transformer NMT under tensor and sequence parallelism, the
port's against the JAX package's.

The port runs one gloo process per rank, four of them, started once by
``tools/launch.py`` (``torch_dist_worker.py``, scenario ``lang``); the
reference runs GSPMD on its CPU devices (``tests/conftest.py``) over the
same meshes.  A tiny BERT (vocab 64, 32 units, 2 layers, 4 heads) with
``valid_length`` (so the key mask goes through the gathered attention
under ``sp``) and a tiny shared-vocabulary NMT (vocab 32, with its
cross-attention) take 3 Adam steps on the same global batches at dp 2 x
tp 2 and at tp 2 x sp 2.  Losses are held relative 1e-5 and each rank's
blocks max-abs 1e-4 to the reference's slices (``torch_parallel_ref``).
NMT's greedy and beam ``translate`` under each mesh, from the starting
weights, give the reference's tokens.
"""
import os

import jax
import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.models import BERTForPretrain, get_bert
from mxnet_tpu.models.nmt import get_nmt, nmt_loss
from mxnet_tpu.ndarray import ops as F

import torch_dist_worker as W
from torch_parallel_ref import LOSS_RTOL, PARAM_TOL, block_of

EOS = W.NMT_EOS


def _ref_net(kind):
    if kind == "bert":
        net = BERTForPretrain(get_bert("bert_base", **W.BERT_CFG))
    else:
        net = get_nmt("transformer_base", **W.NMT_CFG)
    mx.random.seed(0)
    net.initialize()
    return net


def _params(kind):
    """BERT: the reference's initial weights.  NMT: seeded weights,
    LayerNorm gains near 1, the decoder's block outputs scaled up so
    they, not the tied embedding of the last token, decide the argmax
    (``test_torch_nmt.py``): random weights then translate to varied
    tokens."""
    net = _ref_net(kind)
    if kind == "bert":
        return {k: p.data().asnumpy()
                for k, p in net._collect_params_with_prefix().items()}
    rs = onp.random.RandomState(1)
    out, seen = {}, {}
    for k, p in net._collect_params_with_prefix().items():
        if id(p) in seen:          # the shared table's second name
            out[k] = out[seen[id(p)]]
            continue
        seen[id(p)] = k
        v = rs.uniform(-0.3, 0.3, p.shape)
        if k.endswith("gamma"):
            v = 1.0 + 0.2 * v
        if kind == "nmt" and k.startswith("dec") and \
                k.endswith(("out_proj.weight", "fc2.weight")):
            v = 6.0 * v
        out[k] = v.astype("float32")
    return out


def _set(net, params):
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    return net


def _ref_loss(kind):
    if kind == "nmt":
        return nmt_loss

    def loss(outs, mlm_labels, nsp_labels):
        mlm, nsp = outs
        lm = (F.logsumexp(mlm, axis=-1) -
              F.pick(mlm, mlm_labels, axis=-1)).mean()
        ln = (F.logsumexp(nsp, axis=-1) -
              F.pick(nsp, nsp_labels, axis=-1)).mean()
        return lm + ln
    return loss


def _ref_run(kind, params, tag):
    mesh = jpar.make_mesh(devices=jax.devices()[:4], **W.LANG_MESHES[tag])
    specs = W.lang_specs(jpar, "sp" in W.LANG_MESHES[tag])[kind]
    net = _set(_ref_net(kind), params)
    losses = []
    batches = W.bert_batches() if kind == "bert" else W.nmt_batches()
    with jpar.use_mesh(mesh):
        tr = jpar.ShardedTrainer(net, "adam", loss=_ref_loss(kind),
                                 mesh=mesh, data_specs=specs[0],
                                 label_specs=specs[1],
                                 optimizer_params={"learning_rate":
                                                   W.GPT_LR})
        for x, y in batches:
            losses.append(float(tr.step(
                [mx.nd.array(a, dtype="int32") for a in x],
                [mx.nd.array(a, dtype="int32") for a in y]).asnumpy()))
    return losses, {k: p.data().asnumpy()
                    for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("lang")
    params = {kind: _params(kind) for kind in ("bert", "nmt")}
    for kind, p in params.items():
        onp.savez(os.path.join(d, f"{kind}.npz"), **p)
    return params, W.launch(4, "lang", d)


@pytest.fixture(scope="module")
def refs(run):
    return {(kind, tag): _ref_run(kind, run[0][kind], tag)
            for kind in ("bert", "nmt") for tag in W.LANG_MESHES}


@pytest.mark.parametrize("tag", sorted(W.LANG_MESHES))
@pytest.mark.parametrize("kind", ["bert", "nmt"])
@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_three_adam_steps_match_the_reference(run, refs, kind, tag, rank):
    """Losses relative 1e-5 and every parameter this rank holds (its
    blocks of the split ones) max-abs 1e-4 after 3 steps."""
    out = run[1][rank]
    losses, params = refs[(kind, tag)]
    onp.testing.assert_allclose(out[f"{kind}{tag}:losses"], losses,
                                rtol=LOSS_RTOL, atol=0)
    prefix = f"{kind}{tag}:param:"
    names = [k[len(prefix):] for k in out if k.startswith(prefix)]
    assert len(names) == len({id(p) for p in _ref_net(kind)
                               ._collect_params_with_prefix().values()})
    for k in names:
        onp.testing.assert_allclose(
            out[prefix + k], block_of(out, f"{kind}{tag}", k, params[k]),
            atol=PARAM_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", ["bert", "nmt"])
def test_tp_splits_the_vocabulary_and_the_heads(run, kind):
    """Each tp rank holds its half of the word embedding (one shared
    table in NMT) and of a layer's query projection."""
    emb = "backbone.word_embed.weight" if kind == "bert" else \
        "src_embed.weight"
    q = "backbone.layer0.attn.q_proj.weight" if kind == "bert" else \
        "enc0.attn.q_proj.weight"
    vocab = 64 if kind == "bert" else 32
    for rank, out in enumerate(run[1]):
        tp = rank % 2
        for tag in W.LANG_MESHES:
            assert out[f"{kind}{tag}:slice:{emb}"].tolist() == \
                [[vocab // 2 * tp, vocab // 2 * (tp + 1)], [0, 32]]
            assert out[f"{kind}{tag}:slice:{q}"].tolist() == \
                [[16 * tp, 16 * tp + 16], [0, 32]]


@pytest.mark.parametrize("beam", [1, 4])
def test_translate_under_each_mesh_matches_the_reference(run, beam):
    """Greedy and beam decode of a net split over tp (every rank of the
    mesh together, the last position's block gathered) give the
    reference's tokens, EOS included."""
    params = run[0]["nmt"]
    jn = _set(_ref_net("nmt"), params)
    src, _t, vlen = W.nmt_batches()[0][0]
    want = onp.asarray(jn.translate(
        mx.nd.array(src[:3], dtype="int32"),
        mx.nd.array(vlen[:3], dtype="int32"), max_length=6,
        beam_size=beam, alpha=0.8, eos_id=EOS))
    assert (want == EOS).any() and (want != EOS).any()
    for out in run[1]:
        for tag in W.LANG_MESHES:
            onp.testing.assert_array_equal(
                out[f"nmt{tag}:translate{beam}"], want)


def test_an_nd_op_on_a_vocabulary_block_computes_on_the_whole(run):
    """``nd.log_softmax`` handed a rank's vocabulary block (a tied head's
    logits under tp) gives the whole logits' (the block gathered first),
    and the gradient that reaches the block is its columns of the
    whole's: an op never computes on a block as if it were whole."""
    whole = onp.random.RandomState(31).randn(2, 3, 8).astype("float32")
    y = mx.nd.log_softmax(mx.nd.array(whole), axis=-1)
    g = jax.grad(lambda a: (jax.nn.log_softmax(a, axis=-1)
                            * whole).sum())(jax.numpy.asarray(whole))
    for rank, out in enumerate(run[1]):
        tp = rank % 2
        onp.testing.assert_allclose(out["nd:log_softmax"], y.asnumpy(),
                                    rtol=1e-6, atol=1e-6)
        onp.testing.assert_allclose(out["nd:grad"],
                                    onp.asarray(g)[..., 4 * tp:4 * tp + 4],
                                    rtol=1e-5, atol=1e-6)
