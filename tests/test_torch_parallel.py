"""The port's data- and sequence-parallel training against the JAX
package's.

The reference runs on its 8-device CPU mesh (``tests/conftest.py``);
the port runs one gloo process per rank, four of them, started once by
``tools/launch.py`` (``torch_dist_worker.py``, scenario ``parallel``).
A tiny GPT-2 (vocab 64, 32 units, 2 layers, 4 heads, 32 positions) gets
the reference's weights on rank 0 only (the others start from their own
seeds, so the trainer's broadcast is what makes them equal) and takes 3
Adam steps on the same global batches (4 x 16), on a dp = 2 mesh and on
a dp = 2 x sp = 2 mesh (ring attention over sp); the reference trains
with its ``ShardedTrainer`` over the same mesh shapes.

Tolerances are ``test_torch_train.py``'s: losses relative 1e-5 (the same
float32 math summed in another order, here also across ranks), and
parameters max-abs 1e-4 after Adam steps at lr 1e-3.
"""
import os

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.models import gpt2_lm_loss as jloss
from mxnet_tpu.resilience import FaultPlan as JFaultPlan
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.models import gpt2_lm_loss as tloss
from mxnet_tpu_torch.utils.convert import load_numpy_params

import torch_dist_worker as W

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4


def _ref_params():
    jn = jget_gpt2("gpt2_124m", **W.GPT_CFG)
    mx.random.seed(0)
    jn.initialize()
    return {k: p.data().asnumpy()
            for k, p in jn._collect_params_with_prefix().items()}


def _ref_run(params, mesh, plan=None, **kw):
    jn = jget_gpt2("gpt2_124m", **W.GPT_CFG)
    mx.random.seed(0)
    jn.initialize()
    for k, p in jn._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    losses, flags = [], []
    with jpar.use_mesh(mesh), (plan or JFaultPlan()):
        tr = jpar.ShardedTrainer(jn, "adam", loss=jloss, mesh=mesh,
                                 optimizer_params={"learning_rate":
                                                   W.GPT_LR}, **kw)
        for x, y in W.batches():
            got = tr.step(mx.nd.array(x, dtype="int32"),
                          mx.nd.array(y, dtype="int32"))
            if isinstance(got, tuple):
                flags.append(bool(got[1].asnumpy()))
                got = got[0]
            losses.append(float(got.asnumpy()))
    return losses, flags, {k: p.data().asnumpy() for k, p in
                           jn._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    params = _ref_params()
    onp.savez(os.path.join(d, "params.npz"), **params)
    return d, params, W.launch(4, "parallel", d)


@pytest.fixture(scope="module")
def ref_dp2(run):
    return _ref_run(run[1], jpar.make_mesh(dp=2, devices=jax.devices()[:2]))


@pytest.fixture(scope="module")
def ref_dp2sp2(run):
    mesh = jpar.make_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    return _ref_run(run[1], mesh, seq_axis=1)


@pytest.fixture(scope="module")
def ref_guarded(run):
    mesh = jpar.make_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    plan = JFaultPlan().nonfinite_at("trainer.grad_nonfinite", at=2)
    return _ref_run(run[1], mesh, plan=plan, seq_axis=1, grad_accum=2,
                    guard_nonfinite=True, clip_global_norm=0.05)


def _held(out, tag, ref):
    losses, flags, params = ref
    onp.testing.assert_allclose(out[f"{tag}:losses"], losses,
                                rtol=LOSS_RTOL, atol=0)
    if flags:
        assert list(out[f"{tag}:flags"]) == flags
    for k, v in params.items():
        onp.testing.assert_allclose(out[f"{tag}:param:{k}"], v,
                                    atol=PARAM_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_dp2_matches_reference(run, ref_dp2, rank):
    _held(run[2][rank], "dp2", ref_dp2)
    assert "dp2:losses" not in run[2][2]        # ranks outside the mesh


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_dp2_sp2_ring_matches_reference(run, ref_dp2sp2, rank):
    out = run[2][rank]
    _held(out, "dp2sp2", ref_dp2sp2)
    assert not out["dp2sp2:graphed"]            # gloo: eager steps
    assert list(out["dp2sp2:shardings"]) == ["('dp', 'sp')"] * 2


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_guarded_accumulated_clipped_step_agrees_across_ranks(
        run, ref_guarded, rank):
    """grad_accum 2, clip at a global norm of 0.05 and the guard, with
    one rank's gradients poisoned at step 2: every rank skips that step,
    as the reference does under the same plan."""
    assert ref_guarded[1] == [True, False, True]
    _held(run[2][rank], "guarded", ref_guarded)


def test_checkpoint_saved_at_dp2_loads_at_dp1(run):
    """Step 2's DCP checkpoint of the dp = 2 run, loaded by a one-process
    trainer, continues to the run's step-3 loss and parameters."""
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
    onp.testing.assert_allclose(loss, outs[0]["dp2:losses"][2],
                                rtol=LOSS_RTOL)
    for k, p in net.named_parameters():
        onp.testing.assert_allclose(p.detach().numpy(),
                                    outs[0][f"dp2:param:{k}"],
                                    atol=PARAM_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_attention_under_sp_equals_the_whole_sequence(run, mode):
    for out in run[2]:
        assert float(out[f"mha:{mode}"]) < 1e-5


def test_loader_and_prefetcher_hand_each_rank_its_block(run):
    for out in run[2]:
        assert bool(out["loader:block"]) and bool(out["prefetch:block"])
        # the loader's block steps as the global batch does
        assert out["loader:losses"][0] == out["loader:losses"][1]


# ------------------------------------------------------- in one process


def test_mesh_errors_and_specs_equal_the_reference():
    devs = jax.devices()[:8]
    for kw in (dict(dp=3), dict(tp=3), dict(dp=2, sp=2)):
        with pytest.raises(Exception) as je:
            jpar.make_mesh(devices=devs, **kw)
        with pytest.raises(MXNetError) as te:
            tpar.make_mesh(devices=list(range(8)), **kw)
        assert str(te.value) == str(je.value)
    assert tpar.AXES == jpar.AXES
    rules = [({}, {}), ({"mlp": None}, {"heads": "sp"})]
    axes = [(), ("heads", "embed"), ("embed", "mlp"), ("vocab", "embed"),
            ("seq", "embed"), ("batch", "seq", None), ("expert", None,
                                                       "norm")]
    for base, over in rules:
        jr, tr = jpar.ShardingRules(base, **over), \
            tpar.ShardingRules(base, **over)
        assert dict(jr) == dict(tr)
        for a in axes:
            assert tuple(tr.spec(a)) == tuple(jr.spec(a))
    for nd, ba, sa in [(2, 0, None), (2, 0, 1), (3, 1, 2)]:
        assert tuple(tpar.batch_spec(nd, ba, sa)) == \
            tuple(jpar.batch_spec(nd, ba, sa))
    jm = jpar.make_mesh(dp=2, sp=2, tp=2, devices=devs)
    tm = tpar.Mesh(onp.arange(8, dtype=object).reshape(1, 2, 1, 2, 2))
    assert tuple(tpar.global_batch_sharding(tm, 2, seq_axis=1).spec) == \
        tuple(jpar.global_batch_sharding(jm, 2, seq_axis=1).spec)
    for shape, la in [((97, 32), ("vocab", "embed")),
                      ((64, 32), ("heads", "embed")), ((8,), ("seq",))]:
        mapping = {"vocab": "tp", "heads": "tp", "seq": "sp"}
        assert tuple(tpar.divisible_spec(shape, la, tm, mapping)) == \
            tuple(jpar.divisible_spec(shape, la, jm, mapping))
    assert tpar.with_sharding_constraint("x", "batch", mesh=tm) == "x"


def test_parameter_annotations_equal_the_reference():
    jn = jget_gpt2("gpt2_124m", **W.GPT_CFG)
    jn.initialize()
    tn = tget_gpt2("gpt2_124m", device="cpu", **W.GPT_CFG)
    tn.initialize(seed=0)
    ref = {k: jpar.logical_axes_of(p)
           for k, p in jn._collect_params_with_prefix().items()}
    got = {k: tpar.logical_axes_of(p) for k, p in tn.named_parameters()}
    assert got == ref
    assert any(v is not None for v in got.values())


def test_meshes_past_dp_and_sp_raise_naming_a6():
    from mxnet_tpu_torch.data.sharded_loader import host_batch_rows
    for kw in (dict(tp=2), dict(ep=2), dict(pp=2)):
        with pytest.raises(MXNetError, match="queue A6"):
            tpar.make_mesh(devices=[0, 1], **kw)
    tm = tpar.Mesh(onp.arange(2, dtype=object).reshape(1, 1, 1, 1, 2))
    with pytest.raises(MXNetError, match="queue A6"):
        host_batch_rows(tpar.global_batch_sharding(tm, 2), (4, 8))


def test_one_rank_mesh_is_bit_identical_to_no_mesh():
    """``mesh=make_mesh(dp=1)`` outside a job runs no collective and
    steps exactly as ``mesh=None``."""
    params = _ref_params()
    runs = []
    for mesh in (None, tpar.make_mesh(dp=1)):
        net = load_numpy_params(tget_gpt2("gpt2_124m", device="cpu",
                                          **W.GPT_CFG), params)
        tr = tpar.ShardedTrainer(net, "adam", loss=tloss, mesh=mesh,
                                 optimizer_params={"learning_rate": 1e-3})
        losses = [float(tr.step(x, y)) for x, y in W.batches()]
        runs.append((losses, [p.detach().clone()
                              for p in net.parameters()]))
        assert tr.stats().get("mesh") == (None if mesh is None else
                                          dict(mesh.shape))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_init_distributed_refuses_nccl_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal is for hosts without")
    with pytest.raises(MXNetError, match="nccl"):
        tpar.init_distributed("127.0.0.1:1", 1, 0, backend="nccl")
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_masked_attention_under_sp_raises_naming_a6():
    """Ring and Ulysses run plain self-attention; a mask under an sp mesh
    would attend only inside the rank's chunk, so it raises."""
    from mxnet_tpu_torch.models.transformer import MultiHeadAttention
    attn = MultiHeadAttention(16, 4)
    attn.initialize(seed=0, device="cpu")
    mesh = tpar.Mesh(onp.arange(2, dtype=object).reshape(1, 1, 1, 2, 1))
    x = torch.zeros(1, 4, 16)
    mask = torch.ones(1, 1, 4, 4, dtype=torch.bool)
    with tpar.use_mesh(mesh), pytest.raises(MXNetError, match="queue A6"):
        attn(x, mask)
