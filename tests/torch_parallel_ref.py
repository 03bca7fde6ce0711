"""The JAX package's side of the port's multi-process tests
(``test_torch_tensor_parallel.py``, ``test_torch_expert_parallel.py``,
``test_torch_pipeline.py``): the reference's models and
``ShardedTrainer`` on its 8-device CPU mesh, and the comparison of the
ranks' outputs (``torch_dist_worker.py``) with its results."""
import numpy as onp

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.models import gpt2_lm_loss as jloss

import torch_dist_worker as W

# test_torch_parallel.py's tolerances: losses relative 1e-5 (the same
# float32 math summed in another order, also across ranks), parameters
# max-abs 1e-4 after 3 Adam steps at lr 1e-3
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4


def ref_net(get=jget_gpt2, **cfg):
    """The reference's GPT-2 of ``W.GPT_CFG`` updated by ``cfg`` (another
    ``get``: of ``cfg`` alone), initialized from a seed."""
    net = get("gpt2_124m", **(dict(W.GPT_CFG, **cfg) if get is jget_gpt2
                              else cfg))
    mx.random.seed(0)
    net.initialize()
    return net


def params_of(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def ref_run(params, mesh, get=jget_gpt2, cfg=None, **kw):
    """3 Adam steps of the reference's trainer over ``mesh`` from
    ``params`` on ``W.batches()``: (losses, final parameters)."""
    jn = ref_net(get, **(cfg or {}))
    for k, p in jn._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    losses = []
    with jpar.use_mesh(mesh):
        tr = jpar.ShardedTrainer(jn, "adam", loss=jloss, mesh=mesh,
                                 optimizer_params={"learning_rate":
                                                   W.GPT_LR}, **kw)
        for x, y in W.batches():
            losses.append(float(tr.step(mx.nd.array(x, dtype="int32"),
                                        mx.nd.array(y, dtype="int32"))
                                .asnumpy()))
    return losses, params_of(jn)


def block_of(out, tag, name, whole):
    """The part of ``whole`` that a rank's ``tag:param:name`` holds."""
    sl = out.get(f"{tag}:slice:{name}")
    if sl is None:
        return whole
    return whole[tuple(slice(int(a), int(b)) for a, b in sl)]


def held(out, tag, ref):
    """A rank's losses and every parameter (its blocks) against the
    reference's run ``ref``."""
    losses, params = ref
    onp.testing.assert_allclose(out[f"{tag}:losses"], losses,
                                rtol=LOSS_RTOL, atol=0)
    for k, v in params.items():
        onp.testing.assert_allclose(out[f"{tag}:param:{k}"],
                                    block_of(out, tag, k, v),
                                    atol=PARAM_TOL, rtol=0, err_msg=k)
