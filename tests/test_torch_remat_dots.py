"""``remat='dots'`` without a per-op dispatch hook.

The port's ``'dots'`` keeps each product's output of a layer and reads
it back in the recomputation (``mxnet_tpu_torch/ops/dots.py``), where it
had been torch's selective-checkpoint policy, a Python callback on every
aten op of every layer, forward and recomputation.  On the same 2-layer
GPT-2 of width 32 as ``test_torch_remat.py`` (dense, or 2 experts in h1,
whose router and expert products are kept too), on the CPU:

- while a ``'dots'`` layer runs, in its forward and in its
  recomputation, no Python dispatch mode is active;
- counted over backward only (a dispatch mode of this test's around
  ``autograd.grad``), aten ``mm``, ``addmm``, ``bmm`` and ``linear`` are
  issued exactly as often under ``'dots'`` as without remat (the
  gradients' products, none of the forward's again), and more often
  under ``remat=True``, which multiplies again in its recomputation;
- a layer keeps one output a product, in order, and its recomputation
  returns them without multiplying.
"""
import collections

import numpy as onp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import base
from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
from mxnet_tpu_torch.models.moe import aux_loss_scope
from mxnet_tpu_torch.ops import dots

torch.set_num_threads(1)

CFG = dict(vocab_size=64, units=32, num_layers=2, num_heads=2,
           max_length=64)
PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.linear.default}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in PRODUCTS
        return func(*args, **(kwargs or {}))


def _net(experts, dropout=0.0):
    return get_gpt2("gpt2_124m", device="cpu", dropout=dropout,
                    num_experts=experts, **CFG).initialize(seed=0)


def _batch():
    rs = onp.random.RandomState(0)
    return tuple(torch.from_numpy(rs.randint(0, 64, (2, 16)).astype("int32"))
                 for _ in range(2))


def _forward(net, remat):
    net._remat = remat
    tmx.random.seed(5)
    toks, labels = _batch()
    with base.training_mode(True), aux_loss_scope():
        loss = gpt2_lm_loss(net(toks), labels)
    return loss


@pytest.mark.parametrize("experts", [0, 2], ids=["dense", "moe"])
def test_backward_issues_the_products_of_no_remat(experts):
    net = _net(experts)
    counts = {}
    for remat in (False, "dots", True):
        loss = _forward(net, remat)
        with _Count() as c:
            torch.autograd.grad(loss, list(net.parameters()))
        counts[remat] = c.n
    assert counts["dots"] == counts[False] < counts[True], counts


@pytest.mark.parametrize("experts", [0, 2], ids=["dense", "moe"])
def test_no_dispatch_mode_while_a_dots_layer_runs(experts):
    """A forward hook on every sublayer of h0 reads the dispatch mode
    stack in the forward and again in the recomputation."""
    net = _net(experts, dropout=0.1)
    seen = collections.Counter()

    def hook(m, i, o):
        seen[torch._C._len_torch_dispatch_stack()] += 1
    handles = [m.register_forward_hook(hook)
               for m in net.get_submodule("h0").modules()]
    try:
        loss = _forward(net, "dots")
        n_forward = sum(seen.values())
        torch.autograd.grad(loss, list(net.parameters()))
    finally:
        for h in handles:
            h.remove()
    assert set(seen) == {0} and sum(seen.values()) > n_forward


def test_dots_keeps_one_output_a_product_and_reads_it_back():
    """The kept outputs of a layer are its products' outputs, in order,
    and the recomputation returns them without multiplying."""
    kept = []
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(5, 4, requires_grad=True)
    with dots.keep(kept, replay=False):
        y = dots.linear(x, w)
        z = dots.matmul(y, w)
    assert len(kept) == 2 and torch.equal(kept[0], y.detach())
    with dots.keep(kept, replay=True), _Count() as c:
        y2 = dots.linear(x, w)
        z2 = dots.matmul(y2, w)
    assert c.n == 0 and torch.equal(z2, z)
    assert "Product" in y.grad_fn.name()
    assert "Product" not in dots.linear(x, w).grad_fn.name()   # outside
