"""Remat in the port (``run_blocks(..., remat=True | "dots")``, the
reference's ``transformer.py:710-752``) against the same model run
without it.

A 2-layer GPT-2 of width 32 (vocab 64, 2 heads, 64 positions), dense or
with 2 experts in h1, on the CPU.  ``True`` and ``"dots"`` give outputs
within 1e-6 of the plain run and gradients within 1e-6 of each max-abs
(they recompute the same float32 ops; here they read equal bit for bit).
With dropout 0.1 the recomputation replays the forward's masks, and the
device generator ends where the plain run leaves it; the same holds when
backward runs on another thread, as autograd's device thread runs it for
CUDA tensors.  Two routed ``ShardedTrainer`` steps under remat give the
plain run's losses and leave every thread's aux collector empty.
"""
import collections
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp, base
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss, transformer
from mxnet_tpu_torch.models.moe import aux_loss_scope
from mxnet_tpu_torch.parallel import ShardedTrainer

torch.set_num_threads(1)

CFG = dict(vocab_size=64, units=32, num_layers=2, num_heads=2,
           max_length=64)
OUT_TOL, GRAD_TOL = 1e-6, 1e-6
REMATS = [True, "dots"]


def _net(dropout=0.0, experts=0, remat=False):
    return get_gpt2("gpt2_124m", device="cpu", dropout=dropout,
                    num_experts=experts, remat=remat, **CFG).initialize(
                        seed=0)


def _batch(seed=0, b=2, t=16):
    rs = onp.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randint(0, 64, (b, t)).astype("int32"))
                 for _ in range(2))


def _step(net, remat, toks, labels, backward_thread=False):
    """Loss, logits and gradients of one training forward/backward under
    ``remat``, dropout drawn from seed 5; the CPU generator's state
    after it."""
    net._remat = remat
    tmx.random.seed(5)
    params = list(net.parameters())
    with base.training_mode(True), aux_loss_scope():
        logits = net(toks)
        loss = gpt2_lm_loss(logits, labels)
    if backward_thread:
        out = []
        th = threading.Thread(
            target=lambda: out.append(torch.autograd.grad(loss, params)))
        th.start()
        th.join()
        grads = out[0]
    else:
        grads = torch.autograd.grad(loss, params)
    return (loss.detach(), logits.detach(), grads,
            tmx.random.generator("cpu").get_state())


def _rel(a, ref):
    return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


@pytest.mark.parametrize("experts", [0, 2], ids=["dense", "moe"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("remat", REMATS, ids=["full", "dots"])
def test_remat_equals_plain(remat, dropout, experts):
    net = _net(dropout, experts)
    toks, labels = _batch()
    loss0, out0, grads0, state0 = _step(net, False, toks, labels)
    loss, out, grads, state = _step(net, remat, toks, labels)
    assert _rel(out, out0) <= OUT_TOL and _rel(loss, loss0) <= OUT_TOL
    for (name, _p), g, g0 in zip(net.named_parameters(), grads, grads0):
        assert _rel(g, g0) <= GRAD_TOL, name
    assert torch.equal(state, state0)
    assert base.pop_aux_losses() == []


@pytest.mark.parametrize("remat", REMATS, ids=["full", "dots"])
def test_recomputation_on_another_thread_replays_masks_and_policy(remat):
    """Backward on a thread of its own (training flag off, no amp policy,
    no aux scope there) under ``amp.init('bfloat16')`` with dropout: the
    recomputation reinstates the forward's flags, policy and generator
    state, so the gradients equal the plain run's."""
    net = _net(dropout=0.1, experts=2)
    toks, labels = _batch(1)
    amp.init("bfloat16")
    try:
        _l, _o, grads0, state0 = _step(net, False, toks, labels)
        _l, _o, grads, state = _step(net, remat, toks, labels,
                                     backward_thread=True)
    finally:
        amp.reset()
    for (name, _p), g, g0 in zip(net.named_parameters(), grads, grads0):
        assert _rel(g, g0) <= GRAD_TOL, name
    assert torch.equal(state, state0)


def test_layers_run_again_in_the_recomputation_and_hooks_see_it():
    """A divergence (ROADMAP C): the recomputation runs a layer's
    sublayers again, up to the last one whose activations backward
    needs (torch stops it there), so a forward hook on ``h0.attn`` fires
    twice a step under remat and once without; one on ``h0`` itself,
    whose forward the recomputation does not finish, fires once.  The
    reference's ``jax.checkpoint`` reruns no Python.  A hook that changes
    an output must run in the recomputation too, or the gradients would
    be wrong, so the port leaves torch's behaviour as it is."""
    net = _net()
    calls = collections.Counter()
    for name in ("h0", "h0.attn"):
        net.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: calls.update([name]))
    toks, labels = _batch()
    for remat, want in ((False, 1), (True, 2), ("dots", 2)):
        calls.clear()
        _step(net, remat, toks, labels)
        assert calls == {"h0": 1, "h0.attn": want}, remat
        calls.clear()
        with torch.no_grad():
            net(toks)
        assert calls == {"h0": 1, "h0.attn": 1}


def test_remat_arguments():
    """Only False/True/'dots' are taken; ``scan_layers`` is accepted and
    changes nothing."""
    toks, _labels = _batch()
    net = _net(remat="all")
    with pytest.raises(MXNetError):
        net(toks)
    with torch.no_grad():
        plain = _net()(toks)
        scanned = get_gpt2("gpt2_124m", device="cpu", dropout=0.0,
                           scan_layers=True, **CFG).initialize(seed=0)(toks)
    assert torch.equal(plain, scanned)
    assert transformer.run_blocks([], plain, scan=True, remat=True) is plain


def test_two_moe_trainer_steps_under_remat_match_and_leave_no_aux():
    """Two Adam steps of the routed model through ``ShardedTrainer``
    under remat give the plain run's losses (1e-6 relative); each
    thread's collector is back to empty after every step (a spy counts
    what each thread records and drains)."""
    pending = collections.Counter()
    rec, pop = base.record_aux_loss, base.pop_aux_losses

    def spy_rec(a):
        pending[threading.get_ident()] += 1
        rec(a)

    def spy_pop():
        out = pop()
        pending[threading.get_ident()] -= len(out)
        return out

    toks, labels = _batch(2, b=4)
    losses = {}
    base.record_aux_loss, base.pop_aux_losses = spy_rec, spy_pop
    try:
        for remat in (False, True, "dots"):
            tmx.random.seed(3)
            tr = ShardedTrainer(_net(dropout=0.1, experts=2, remat=remat),
                                "adam", loss=gpt2_lm_loss,
                                optimizer_params={"learning_rate": 1e-2})
            losses[remat] = []
            for _ in range(2):
                losses[remat].append(float(tr.step(toks, labels)))
                assert not any(pending.values()), dict(pending)
    finally:
        base.record_aux_loss, base.pop_aux_losses = rec, pop
    for remat in REMATS:
        assert losses[remat] == pytest.approx(losses[False], rel=1e-6)
