"""The port's pipeline parallelism against the JAX package's.

Four gloo ranks (``torch_dist_worker.py``, scenario ``pipeline``) run
``parallel.gpipe`` over a 4-stage and a 2-stage pipeline (pp 4, and dp 2
x pp 2) of the reference test's tanh stages
(``tests/test_moe_pipeline.py:156-193``), outputs and gradients, and the
stacked GPT-2 (vocab 64, 32 units, 4 layers, 4 heads) at dp 2 x pp 2:
its piped forward and 3 Adam steps from the reference's weights on the
global batches (4 x 16), against the reference's GPipe over its CPU mesh
(``:196-227``).  The stacked GPT-2 on one process is held to the
reference's forward and gradients.  Tolerances: the reference test's
for ``gpipe`` (1e-5 outputs, 1e-4 gradients), ``test_torch_parallel
.py``'s for training.
"""
import os

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.models import gpt2_lm_loss as jloss
from mxnet_tpu.models.stacked import get_stacked_gpt2 as jget_stacked
from mxnet_tpu.parallel.pipeline import gpipe as jgpipe
from mxnet_tpu_torch.models import get_stacked_gpt2 as tget_stacked
from mxnet_tpu_torch.models import gpt2_lm_loss as tloss
from mxnet_tpu_torch.utils.convert import load_numpy_params

import torch_dist_worker as W
from torch_parallel_ref import held, params_of, ref_run

D = 16
# the port's meshes and the reference's of the same stage count
MESHES = {"pp4": (4, dict(dp=2, pp=4)), "dp2pp2": (2, dict(dp=4, pp=2))}


def _gpipe_inputs():
    rs = onp.random.RandomState(0)
    out = {"x": rs.randn(8, D).astype("float32")}
    for p in (2, 4):
        out[f"ws{p}"] = (rs.randn(p, D, D) * 0.3).astype("float32")
        out[f"bs{p}"] = (rs.randn(p, D) * 0.1).astype("float32")
    return out


def _jstage(p, x):
    w, b = p
    return jnp.tanh(x @ w + b)


def _stacked_ref():
    net = jget_stacked("gpt2_124m", **W.STACKED_CFG)
    mx.random.seed(0)
    net.initialize()
    # biases and norms off their initial zeros and ones
    rs = onp.random.RandomState(4)
    for p in net._collect_params_with_prefix().values():
        v = p.data().asnumpy()
        p.set_data(mx.nd.array(v + 0.02 * rs.randn(*v.shape).astype(
            "float32")))
    return net


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    onp.savez(os.path.join(d, "gpipe.npz"), **_gpipe_inputs())
    params = params_of(_stacked_ref())
    onp.savez(os.path.join(d, "stacked.npz"), **params)
    return d, params, W.launch(4, "pipeline", d)


@pytest.mark.parametrize("tag", ["pp4", "dp2pp2"])
def test_gpipe_matches_the_reference_outputs_and_gradients(run, tag):
    """Each rank's output rows are the reference's GPipe output rows;
    the stages' parameter gradients (each stage's on its ranks, summed
    over dp) and stage 0's input gradient are ``jax.grad`` of the
    reference's piped sum of squares."""
    p, kw = MESHES[tag]
    g = _gpipe_inputs()
    ws, bs, x = (jnp.asarray(g[k]) for k in (f"ws{p}", f"bs{p}", "x"))
    mesh = jpar.make_mesh(devices=jax.devices()[:8], **kw)
    with jpar.use_mesh(mesh):
        y = onp.asarray(jgpipe(_jstage, (ws, bs), x, num_microbatches=2))
        grads = jax.grad(lambda w, b, x: jnp.sum(jgpipe(
            _jstage, (w, b), x, num_microbatches=2) ** 2),
            argnums=(0, 1, 2))(ws, bs, x)
    outs = run[2]
    dws = sum(o[f"{tag}:dws"] for o in outs)
    dbs = sum(o[f"{tag}:dbs"] for o in outs)
    onp.testing.assert_allclose(dws, onp.asarray(grads[0]), rtol=1e-4,
                                atol=1e-4)
    onp.testing.assert_allclose(dbs, onp.asarray(grads[1]), rtol=1e-4,
                                atol=1e-4)
    for r, o in enumerate(outs):
        rows = slice(*o[f"{tag}:rows"])
        onp.testing.assert_allclose(o[f"{tag}:y"], y[rows], rtol=1e-5,
                                    atol=1e-5)
        # only the first stage feeds x into the pipeline
        want = onp.asarray(grads[2])[rows] if r < 4 // p else 0 * y[rows]
        onp.testing.assert_allclose(o[f"{tag}:dx"], want, rtol=1e-4,
                                    atol=1e-4)


def test_gpipe_rejects_microbatching_that_does_not_divide(run):
    """The reference's ``ValueError``, word for word: 6 rows over dp 2
    in microbatches of 2 leave 3 rows a dp rank."""
    mesh = jpar.make_mesh(dp=2, pp=4, devices=jax.devices()[:8])
    z = jnp.zeros((6, D))
    with jpar.use_mesh(mesh), pytest.raises(ValueError) as je:
        jgpipe(_jstage, (jnp.zeros((4, D, D)), jnp.zeros((4, D))), z,
               num_microbatches=2)
    assert str(run[2][0]["dp2pp2:error"]) == str(je.value)
    assert str(run[2][0]["pp4:error"]).startswith("per-dp-shard batch 3")


def test_stacked_gpt2_on_one_process_matches_reference():
    """Forward logits and every parameter's gradient of the LM loss,
    from one set of weights, through the flash route (its plain versions
    on the CPU) under remat."""
    jn = _stacked_ref()
    params = params_of(jn)
    tn = load_numpy_params(tget_stacked("gpt2_124m", device="cpu",
                                        **W.STACKED_CFG), params)
    assert {n: tuple(p.shape) for n, p in tn.named_parameters()} == \
        {k: v.shape for k, v in params.items()}
    x, y = W.batches()[0]
    with mx.autograd.record():
        logits = jn(mx.nd.array(x, dtype="int32"))
        loss = jloss(logits, mx.nd.array(y, dtype="int32"))
    loss.backward()
    tl = tn(torch.from_numpy(x))
    tloss(tl, torch.from_numpy(y)).backward()
    onp.testing.assert_allclose(tl.detach().numpy(), logits.asnumpy(),
                                atol=1e-5, rtol=0)
    ref = dict(jn._collect_params_with_prefix())
    for n, p in tn.named_parameters():
        want = ref[n].grad().asnumpy()
        onp.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5,
                                    rtol=1e-4, err_msg=n)


def test_stacked_gpt2_default_microbatches_follow_the_reference():
    """``m = max(2 * pp, 2)``, lowered until it divides the rows of a dp
    rank (``mxnet_tpu/models/stacked.py:136-143``); an explicit count is
    kept."""
    net = tget_stacked("gpt2_124m", device="cpu", **W.STACKED_CFG)
    assert [net.microbatches(b, 2) for b in (8, 6, 2, 3)] == [4, 3, 2, 3]
    assert net.microbatches(10, 4) == 5
    net._num_microbatches = 3
    assert net.microbatches(8, 2) == 3


@pytest.fixture(scope="module")
def ref_dp2pp2(run):
    mesh = jpar.make_mesh(dp=2, pp=2, devices=jax.devices()[:4])
    jn = _stacked_ref()
    x, _y = W.batches()[0]
    with jpar.use_mesh(mesh):
        logits = jn(mx.nd.array(x, dtype="int32")).asnumpy()
    return logits, ref_run(run[1], mesh, get=jget_stacked,
                           cfg=W.STACKED_CFG)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_stacked_gpt2_at_dp2_pp2_matches_reference(run, ref_dp2pp2, rank):
    """The piped forward (each rank's dp rows) at 1e-5, then 3 Adam
    steps: losses and every parameter (each stage's block of the
    stack)."""
    logits, ref = ref_dp2pp2
    out = run[2][rank]
    dp = rank % 2
    onp.testing.assert_allclose(out["stacked:logits"],
                                logits[2 * dp:2 * dp + 2], atol=1e-5,
                                rtol=0)
    held(out, "stacked", ref)
    stage = rank // 2
    assert out["stacked:slice:wqkv"][0].tolist() == [2 * stage,
                                                     2 * stage + 2]
    assert "stacked:slice:wte.weight" not in out
