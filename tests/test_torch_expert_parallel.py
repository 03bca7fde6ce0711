"""The port's routed GPT-2 over a mesh against the JAX package's.

Four gloo ranks (``torch_dist_worker.py``, scenario ``expert``) train
the routed GPT-2 of ``torch_dist_worker.MOE_CFG`` (vocab 64, 32 units, 2
layers, the second an MoE layer of 4 experts, top 2, capacity factor
1.0, so that some choices are dropped) for 3 Adam steps on the global
batches (4 x 16) from the reference's weights: at dp 2 (ranks 0 and 1)
against the reference's ``make_mesh(dp=2)``, and at ep 2 x tp 2 against
the reference's ``make_mesh(dp=2, ep=2, tp=2)``.

The reference's GSPMD routes the global batch: capacity from the global
token count, each choice's position from a cumulative sum over the whole
batch, the aux loss from global means.  The port's layer before this
slice routed each dp rank's own rows (capacity and positions per rank,
the aux loss a mean of the ranks'), which keeps another set of choices;
the layer now gathers the choices over the data axes (ROADMAP queue C
records the fault and its repair).  The kept (token, choice) pairs, the
aux losses and the dropped shares of each step are held to the port's
one-process layer on the global batch, whose routing
``tests/test_torch_moe.py`` holds to the reference's dispatch.
Tolerances are ``test_torch_parallel.py``'s.
"""
import os

import jax
import numpy as onp
import pytest

from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.models import gpt2_lm_loss as tloss
from mxnet_tpu_torch.models import moe as tmoe
from mxnet_tpu_torch.utils.convert import load_numpy_params

import torch_dist_worker as W
from torch_parallel_ref import held, params_of, ref_net, ref_run


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("expert")
    params = params_of(ref_net(**W.MOE_CFG))
    onp.savez(os.path.join(d, "params.npz"), **params)
    return d, params, W.launch(4, "expert", d)


@pytest.fixture(scope="module")
def one(run):
    """The port's one-process run: losses, and the MoE layer's aux loss
    and dropped share at each step and its kept pairs at the first."""
    net = load_numpy_params(tget_gpt2("gpt2_124m", device="cpu",
                                      **dict(W.GPT_CFG, **W.MOE_CFG)),
                            run[1])
    tr = tpar.ShardedTrainer(net, "adam", loss=tloss,
                             optimizer_params={"learning_rate": W.GPT_LR})
    aux, dropped = [], []
    for i, (x, y) in enumerate(W.batches()):
        tr.step(x, y)
        layer = net.blocks[1].moe
        aux.append(float(layer.last_aux))
        dropped.append(float(layer.last_dropped))
        if i == 0:
            kept = layer._last_kept.numpy()
    return aux, dropped, kept


@pytest.fixture(scope="module")
def ref_dp2(run):
    return ref_run(run[1], jpar.make_mesh(dp=2, devices=jax.devices()[:2]),
                   cfg=W.MOE_CFG)


@pytest.fixture(scope="module")
def ref_dp2ep2tp2(run):
    return ref_run(run[1], jpar.make_mesh(dp=2, ep=2, tp=2,
                                          devices=jax.devices()[:8]),
                   cfg=W.MOE_CFG)


@pytest.mark.parametrize("rank", [0, 1])
def test_routed_gpt2_at_dp2_matches_reference(run, ref_dp2, rank):
    held(run[2][rank], "dp2", ref_dp2)
    assert "dp2:losses" not in run[2][2]


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_routed_gpt2_at_ep2_tp2_matches_reference(run, ref_dp2ep2tp2,
                                                  rank):
    held(run[2][rank], "ep2tp2", ref_dp2ep2tp2)


@pytest.mark.parametrize("tag,ranks", [("dp2", [0, 1]),
                                       ("ep2tp2", [0, 1, 2, 3])])
def test_kept_pairs_aux_and_dropped_are_the_global_batchs(run, one, tag,
                                                         ranks):
    """Each rank keeps the (token, choice) pairs that routing the whole
    batch keeps (under dp, its own rows of them), and its aux loss and
    dropped share are the global batch's at every step."""
    aux, dropped, kept = one
    rows = kept.reshape(W.GPT_B, W.GPT_T, -1)
    for r in ranks:
        out = run[2][r]
        want = rows[2 * r:2 * r + 2] if tag == "dp2" else rows
        assert onp.array_equal(out[f"{tag}:kept1"],
                               want.reshape(-1, kept.shape[1]))
        onp.testing.assert_allclose(
            [float(out[f"{tag}:aux1:{i}"]) for i in range(3)], aux,
            rtol=1e-5)
        assert [float(out[f"{tag}:dropped1:{i}"]) for i in range(3)] == \
            dropped
    assert 0 < dropped[0] < 1


def test_routing_each_dp_rank_alone_keeps_other_pairs(run, one):
    """The fault the repair removes: routing each dp rank's rows alone
    (capacity and positions from its own tokens, PR 17's layer) keeps
    another set of pairs than the global batch's, which the dp ranks now
    keep (previous test)."""
    import torch
    params = run[1]
    layer = tmoe.MoELayer(32, 128, 4, top_k=2, capacity_factor=1.0)
    layer.initialize(seed=0, device="cpu")
    load_numpy_params(layer, {k.split("moe.", 1)[1]: v
                              for k, v in params.items()
                              if k.startswith("h1.moe.")})
    xs = torch.from_numpy(onp.random.RandomState(0).randn(
        W.GPT_B, W.GPT_T, 32).astype("float32"))
    layer(xs)
    whole = layer._last_kept.numpy().reshape(W.GPT_B, W.GPT_T, -1)
    alone = []
    for r in range(2):
        layer(xs[2 * r:2 * r + 2])
        alone.append(layer._last_kept.numpy().reshape(2, W.GPT_T, -1))
    assert not onp.array_equal(onp.concatenate(alone), whole)


def test_each_rank_holds_its_experts_and_its_hidden_units(run):
    """Under ep 2 x tp 2 the rank at (ep i, tp j) holds experts [2i,
    2i + 2) and, of w1, b1 and w2, the hidden units [64j, 64j + 64):
    the slices the reference's device at that position holds."""
    jn = ref_net(**W.MOE_CFG)
    jm = jpar.make_mesh(dp=2, ep=2, tp=2, devices=jax.devices()[:8])
    jpar.shard_params(jn, jm)
    ref = dict(jn._collect_params_with_prefix())
    for r, out in enumerate(run[2]):
        e, t = divmod(r, 2)
        assert out["ep2tp2:slice:h1.moe.w1"].tolist() == \
            [[2 * e, 2 * e + 2], [0, 32], [64 * t, 64 * t + 64]]
        assert out["ep2tp2:slice:h1.moe.b2"].tolist() == \
            [[2 * e, 2 * e + 2], [0, 32]]
        assert "ep2tp2:slice:h1.moe.gate" not in out
        for name in ("w1", "b1", "w2", "b2"):
            arr = ref[f"h1.moe.{name}"].data().jax
            # the reference's device at (dp 0, ep e, tp t)
            dev = jm.devices[0, 0, e, 0, t]
            shard = next(s for s in arr.addressable_shards
                         if s.device == dev)
            want = [list(s.indices(n)[:2])
                    for s, n in zip(shard.index, arr.shape)]
            assert out[f"ep2tp2:slice:h1.moe.{name}"].tolist() == want
