"""The port's tensor parallelism against the JAX package's.

The port runs one gloo process per rank, four of them, started once by
``tools/launch.py`` (``torch_dist_worker.py``, scenario ``tensor``); the
reference runs GSPMD on its 8-device CPU mesh (``tests/conftest.py``).
A tiny GPT-2 (vocab 64, 32 units, 2 layers, 4 heads, 32 positions) gets
the reference's weights on rank 0 only (the others start from their own
seeds; ``shard_params`` broadcasts rank 0's and keeps each rank's
block) and takes 3 Adam steps on the same global batches (4 x 16): at
dp 2 x tp 2 against the reference's dp 4 x tp 2, and at tp 2 x sp 2
through the ring and Ulysses against the reference's dp 2 x sp 2 x tp 2.
Each rank's blocks are held to the same slices of the reference's
parameters.  Tolerances are ``test_torch_parallel.py``'s (losses
relative 1e-5, parameters max-abs 1e-4).
"""
import os

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.models import gpt2_lm_loss as jloss
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.models import get_stacked_gpt2 as tget_stacked
from mxnet_tpu_torch.models import gpt2_lm_loss as tloss
from mxnet_tpu_torch.utils.convert import load_numpy_params

import torch_dist_worker as W
from torch_parallel_ref import (LOSS_RTOL, PARAM_TOL, block_of, held,
                                params_of, ref_net, ref_run)

MLP_X = onp.random.RandomState(1).randn(16, 16).astype("float32")
MLP_Y = onp.random.RandomState(2).randn(16, 8).astype("float32")


def _mlp_params():
    rs = onp.random.RandomState(42)
    return {"0.weight": rs.randn(32, 16).astype("float32") * 0.1,
            "0.bias": rs.randn(32).astype("float32") * 0.1,
            "1.weight": rs.randn(8, 32).astype("float32") * 0.1,
            "1.bias": rs.randn(8).astype("float32") * 0.1}


def _vocab_inputs():
    rs = onp.random.RandomState(9)
    return (rs.randn(2, 8, 64).astype("float32") * 3,
            rs.randint(0, 64, (2, 8)).astype("int32"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor")
    params = params_of(ref_net())
    onp.savez(os.path.join(d, "params.npz"), **params)
    onp.savez(os.path.join(d, "mlp.npz"), **_mlp_params())
    onp.save(os.path.join(d, "mlp_x.npy"), MLP_X)
    onp.save(os.path.join(d, "mlp_y.npy"), MLP_Y)
    logits, labels = _vocab_inputs()
    onp.save(os.path.join(d, "logits.npy"), logits)
    onp.save(os.path.join(d, "labels.npy"), labels)
    return d, params, W.launch(4, "tensor", d)


@pytest.fixture(scope="module")
def ref_dp4tp2(run):
    return ref_run(run[1], jpar.make_mesh(dp=4, tp=2,
                                          devices=jax.devices()[:8]))


@pytest.fixture(scope="module")
def ref_tp2sp2(run):
    mesh = jpar.make_mesh(dp=2, sp=2, tp=2, devices=jax.devices()[:8])
    out = {}
    for mode in ("ring", "ulysses"):
        os.environ["MXNET_TPU_SEQ_PARALLEL"] = mode
        try:
            out[mode] = ref_run(run[1], mesh, seq_axis=1)
        finally:
            os.environ.pop("MXNET_TPU_SEQ_PARALLEL", None)
    return out


# ------------------------------------------------------ mesh and sharding


def test_mesh_axes_rules_and_errors_equal_the_reference(run):
    """``tests/test_parallel.py:23-55``: the axes, dp inferred from the
    others, the error of an axis that does not divide the devices, the
    rules' specs with overrides."""
    devs = jax.devices()[:4]
    for out in run[2]:
        assert int(out["mesh:inferred_dp"]) == jpar.axis_size(
            jpar.make_mesh(tp=2, devices=devs), "dp")
        with pytest.raises(Exception) as je:
            jpar.make_mesh(tp=3, devices=devs)
        assert str(out["mesh:tp3"]) == str(je.value)
    assert tpar.AXES == jpar.AXES
    for rules in ((), ({"heads": None},)):
        tr, jr = tpar.ShardingRules(*rules), jpar.ShardingRules(*rules)
        for axes in (("heads", "embed"), ("vocab", "embed"), None,
                     ("expert", "embed", "mlp"), ("layers", None)):
            assert tuple(tr.spec(axes)) == tuple(jr.spec(axes))


def test_shard_params_blocks_equal_the_reference_shards():
    """Every parameter's block on each rank of a dp 4 x tp 2 mesh is the
    slice the reference's device of the same position holds, and rank
    0's values are the reference's shard on device 0."""
    jn = ref_net()
    jm = jpar.make_mesh(dp=4, tp=2, devices=jax.devices()[:8])
    jpar.shard_params(jn, jm)
    tn = load_numpy_params(tget_gpt2("gpt2_124m", device="cpu",
                                     **W.GPT_CFG), params_of(jn))
    tm = tpar.Mesh(onp.arange(8, dtype=object).reshape(1, 4, 1, 1, 2))
    tpar.shard_params(tn, tm)
    ref = dict(jn._collect_params_with_prefix())
    cut = 0
    for name, p in tn.named_parameters():
        arr = ref[name].data().jax
        assert tuple(p._sharding.spec) == tuple(arr.sharding.spec), name
        shape = tuple(arr.shape)
        for shard in arr.addressable_shards:
            pos = [int(i) for i in onp.argwhere(
                jm.devices == shard.device)[0]]
            rank = int(tm.devices[tuple(pos)])
            got = p._sharding.local_slices(shape, rank)
            want = tuple(slice(*s.indices(n)[:2])
                         for s, n in zip(shard.index, shape))
            assert got == want, (name, rank)
            if rank == 0:
                onp.testing.assert_array_equal(p.detach().numpy(),
                                               onp.asarray(shard.data))
        cut += tuple(p.shape) != shape
    # a layer's q/k/v weights and biases, out_proj's weight, fc1's weight
    # and bias, fc2's weight; and wte
    assert cut == 2 * 10 + 1


# ---------------------------------------------------------- training


def test_mlp_sgd_step_at_dp2_tp2_equals_one_device(run):
    """``tests/test_parallel.py:86-127``: an unannotated MLP is
    replicated along tp; one SGD step over dp 2 x tp 2 equals the
    reference's one-device imperative Trainer step."""
    net = jnn.HybridSequential()
    net.add(jnn.Dense(32, activation="relu", in_units=16),
            jnn.Dense(8, in_units=32))
    net.initialize()
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(_mlp_params()[k]))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    with mx.autograd.record():
        loss = ((net(mx.nd.array(MLP_X)) - mx.nd.array(MLP_Y)) ** 2).mean()
    loss.backward()
    tr.step(1, ignore_stale_grad=True)
    want = params_of(net)
    for out in run[2]:
        onp.testing.assert_allclose(float(out["mlp:loss"]),
                                    float(loss.asnumpy()), rtol=LOSS_RTOL)
        for k, v in want.items():
            assert f"mlp:slice:{k}" not in out
            onp.testing.assert_allclose(out[f"mlp:param:{k}"], v,
                                        rtol=2e-5, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_gpt2_dp2_tp2_matches_reference(run, ref_dp4tp2, rank):
    out = run[2][rank]
    held(out, "dp2tp2", ref_dp4tp2)
    # this rank's tp index holds its half of q_proj's rows and wte's
    tp = rank % 2
    assert out["dp2tp2:slice:h0.attn.q_proj.weight"].tolist() == \
        [[16 * tp, 16 * tp + 16], [0, 32]]
    assert out["dp2tp2:slice:wte.weight"].tolist() == \
        [[32 * tp, 32 * tp + 32], [0, 32]]
    # the batch splits over dp and is the same on the two ranks of a tp line
    assert list(out["dp2tp2:shardings"]) == ["('dp', None)"] * 2


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_gpt2_tp2_sp2_matches_reference(run, ref_tp2sp2, mode, rank):
    """B1-B3's glue on each rank's 2 heads of 4, the sequence in chunks
    of 8: the ring, and Ulysses (local heads 2 divide by |sp| 2)."""
    held(run[2][rank], f"tp2sp2_{mode}", ref_tp2sp2[mode])


def test_vocab_parallel_loss_equals_the_loss_of_the_whole_logits(run):
    """At tp 4 each rank holds 16 of the 64 columns of the logits; the
    loss from the three reductions equals the reference's
    ``gpt2_lm_loss`` on the whole logits, and each rank's gradient is
    its columns of the whole gradient."""
    logits, labels = _vocab_inputs()

    def f(x):
        return jloss(mx.nd.NDArray(x), mx.nd.array(labels,
                                                    dtype="int32")).jax
    want, grad = jax.value_and_grad(f)(jnp.asarray(logits))
    for r, out in enumerate(run[2]):
        onp.testing.assert_allclose(out["vocab:loss"], float(want),
                                    rtol=1e-6)
        onp.testing.assert_allclose(out["vocab:grad"],
                                    onp.asarray(grad)[..., 16 * r:16 * r + 16],
                                    atol=1e-7, rtol=0)


@pytest.mark.parametrize("line", [(0, 1), (2, 3)])
def test_dropout_keeps_the_parameters_of_a_tp_line_replicated(run, line):
    """Dropout 0.1, ranks seeded apart: the trainer gives a tp line one
    generator state, so the masks on the activations the line shares
    agree and every replicated parameter is bit-identical after 3 steps,
    while the blocks differ."""
    a, b = (run[2][r] for r in line)
    shared = [k for k in a if k.startswith("dropout:param:")
              and k.replace(":param:", ":slice:") not in a]
    blocks = [k for k in a if k.startswith("dropout:slice:")]
    assert len(shared) == 15 and len(blocks) == 21
    for k in shared:
        assert onp.array_equal(a[k], b[k]), k
    for k in blocks:
        name = k.replace(":slice:", ":param:")
        assert not onp.array_equal(a[name], b[name]), name
    assert onp.isfinite(a["dropout:losses"]).all()


def test_tp2_checkpoint_loads_at_tp1_and_continues(run):
    """Step 2's checkpoint of the dp 2 x tp 2 run (each rank wrote its
    blocks at their offsets), loaded by a one-process trainer, continues
    to the run's step-3 loss and parameters."""
    d, params, outs = run
    net = load_numpy_params(tget_gpt2("gpt2_124m", device="cpu",
                                      **W.GPT_CFG), params)
    tr = tpar.ShardedTrainer(net, "adam", loss=tloss,
                             optimizer_params={"learning_rate": W.GPT_LR})
    x, y = W.batches()[2]
    tr.build(x, y)
    tr.load_checkpoint(os.path.join(d, "ckpt"))
    assert tr.optimizer.num_update == 2
    loss = float(tr.step(x, y))
    onp.testing.assert_allclose(loss, outs[0]["dp2tp2:losses"][2],
                                rtol=LOSS_RTOL)
    for out in outs:
        for k, p in net.named_parameters():
            onp.testing.assert_allclose(
                out[f"dp2tp2:param:{k}"],
                block_of(out, "dp2tp2", k, p.detach().numpy()),
                atol=PARAM_TOL, rtol=0, err_msg=k)


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("stacked", [False, True])
def test_a_vocabulary_tp_does_not_divide_raises(stacked):
    """63 rows over tp 2: ``jax.device_put`` refuses the reference's
    placement, and the port's ``shard_params`` raises before any
    parameter changes."""
    from mxnet_tpu.models.stacked import get_stacked_gpt2 as jget_stacked
    cfg = dict(vocab_size=63)
    if stacked:
        jn = jget_stacked("gpt2_124m", vocab_size=63, units=32,
                          num_layers=2, num_heads=4, max_length=32)
        mx.random.seed(0)
        jn.initialize()
        tn = tget_stacked("gpt2_124m", device="cpu", vocab_size=63,
                          units=32, num_layers=2, num_heads=4,
                          max_length=32)
    else:
        jn = ref_net(**cfg)
        tn = tget_gpt2("gpt2_124m", device="cpu", **dict(W.GPT_CFG, **cfg))
    tn.initialize(seed=0)
    with pytest.raises(Exception):
        jpar.shard_params(jn, jpar.make_mesh(dp=4, tp=2,
                                             devices=jax.devices()[:8]))
    tm = tpar.Mesh(onp.arange(2, dtype=object).reshape(1, 1, 1, 1, 2))
    before = [p.detach().clone() for p in tn.parameters()]
    with pytest.raises(MXNetError, match="does not divide"):
        tpar.shard_params(tn, tm)
    assert all(torch.equal(a, p) for a, p in zip(before, tn.parameters()))


def test_a_tp_sharded_net_called_outside_its_mesh_raises():
    """A divergence by design (ROADMAP queue C): the reference's sharded
    arrays gather silently outside the mesh; the port's blocks need
    their layer's collectives and raise."""
    tn = tget_gpt2("gpt2_124m", device="cpu", **W.GPT_CFG)
    tn.initialize(seed=0)
    tm = tpar.Mesh(onp.arange(2, dtype=object).reshape(1, 1, 1, 1, 2))
    tpar.shard_params(tn, tm)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(MXNetError, match="use_mesh"):
        tn(toks)
