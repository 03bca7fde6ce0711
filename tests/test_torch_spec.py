"""The port's speculative-decode model surface against the JAX package's.

A 2-layer GPT-2 (units 64, heads 4, vocab 128, max_length 96) is built
in both packages from one set of weights.  Three prompts are prefilled
into slots 0-2 of a 4-row cache (row 3 parked at ``Tmax``); then
``verify_slots`` runs a window of k + 1 = 4 tokens and ``draft_slots``
drafts k = 3 tokens, in the dense layout, the paged gather arm, the
paged kernel arm (its plain version here; the reference's Pallas
kernel in interpret mode) and int8 pages.

Tolerances: float32 logits max-abs 1e-5 (the frameworks differ only in
summation order); int8 pages 5e-3, as ``tests/test_torch_gpt2.py``
holds them (a value on a rounding boundary can land one int8 step
apart between frameworks).  Greedy draft tokens are identical.  Also,
on the port alone: the verify window equals sequential decode steps
(1e-5), the drafter never writes the caches, and a drafter over every
layer proposes the tokens greedy decode gives.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.serving import request_key
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.utils.convert import load_numpy_params

torch.set_num_threads(1)

CFG = dict(vocab_size=128, units=64, num_layers=2, num_heads=4,
           max_length=96, dropout=0.0)
F32_TOL = 1e-5
INT8_PORT_TOL = 5e-3
WEIGHT_SEED = 3
S, PS, TMAX, K = 3, 8, 96, 3
LENS = (7, 16, 21)
ARMS = [("dense", None, None), ("paged", None, "gather"),
        ("paged", None, "kernel"), ("paged", "int8", "gather")]
ARM_IDS = ["dense", "paged-gather", "paged-kernel", "int8-gather"]


@pytest.fixture(scope="module")
def nets():
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(WEIGHT_SEED)
    jn.initialize()
    params = {k: p.data().asnumpy()
              for k, p in jn._collect_params_with_prefix().items()}
    tn = load_numpy_params(tget_gpt2("gpt2_124m", device="cpu", **CFG),
                           params)
    return jn, tn


class _Side:
    """One package's view of the same slots: array constructors, the
    caches with three prompts prefilled, and the paged keyword args."""

    def __init__(self, net, port, layout, quant, arm):
        self.net, self.port = net, port
        npt = TMAX // PS
        rs = onp.random.RandomState(11)
        toks = onp.zeros((S, 32), "int32")
        for i, n in enumerate(LENS):
            toks[i, :n] = rs.randint(0, 128, n)
        self.last = toks[onp.arange(S), onp.array(LENS) - 1].copy()
        self.kw = {}
        if layout == "paged":
            table = onp.full((S + 1, npt), S * npt, "int32")
            # distinct pages, three logical pages a slot: 24 positions
            table[:S, :4] = onp.arange(S * 4).reshape(S, 4)[:, ::-1]
            self.caches = net.init_page_cache(S * npt + 1, PS,
                                              kv_quant=quant)
            self.kw = dict(page_table=self.A(table),
                           paged_kernel=arm == "kernel")
        else:
            self.caches = net.init_slot_cache(S + 1, TMAX)
        lens = onp.array(LENS, "int32") - 1    # the last token decodes
        _lg, self.caches = net.prefill_slots(
            self.tok(toks), self.A(lens), self.caches,
            self.A(onp.arange(S, dtype="int32")), **self.kw)
        self.pos = onp.append(lens, TMAX).astype("int32")

    def A(self, x):
        x = onp.asarray(x)
        return torch.from_numpy(x) if self.port else jnp.asarray(x)

    def tok(self, x):
        return self.A(x) if self.port else NDArray(jnp.asarray(x))

    def L(self, x):
        if self.port:
            return x.numpy()
        return onp.asarray(x.jax if isinstance(x, NDArray) else x)

    def verify(self, window):
        lg, self.caches = self.net.verify_slots(
            self.tok(window), self.caches, self.A(self.pos), **self.kw)
        return self.L(lg)

    def draft(self, tok, layers=1):
        greedy = (self.A(onp.zeros(S + 1, "float32")),
                  self.A(onp.zeros(S + 1, "int32")),
                  self.A(onp.ones(S + 1, "float32")))
        seeds = onp.zeros(S + 1, "int64") if self.port else \
            jnp.stack([request_key(0)] * (S + 1))
        kw = {"page_table": self.kw["page_table"]} if self.kw else {}
        out = self.net.draft_slots(self.tok(tok), self.caches,
                                   self.A(self.pos), K, layers, *greedy,
                                   seeds, **kw)
        return self.L(out)


def _window(seed):
    rs = onp.random.RandomState(seed)
    return rs.randint(0, 128, (S + 1, K + 1)).astype("int32")


@pytest.mark.parametrize("layout,quant,arm", ARMS, ids=ARM_IDS)
def test_verify_window_matches_reference(nets, layout, quant, arm):
    """Two windows in a row: the second reads the K/V the first wrote."""
    jn, tn = nets
    ref, port = (_Side(n, p, layout, quant, arm)
                 for n, p in ((jn, False), (tn, True)))
    tol = F32_TOL if quant is None else INT8_PORT_TOL
    for step in range(2):
        w = _window(step)
        w[:S, 0] = ref.last
        r, o = ref.verify(w), port.verify(w)
        assert o.shape == (S + 1, K + 1, CFG["vocab_size"])
        assert onp.abs(o[:S] - r[:S]).max() <= tol
        for side in (ref, port):
            side.last = w[:S, -1]
            side.pos[:S] += K + 1


@pytest.mark.parametrize("layout,quant,arm", ARMS, ids=ARM_IDS)
def test_draft_tokens_match_reference(nets, layout, quant, arm):
    jn, tn = nets
    ref, port = (_Side(n, p, layout, quant, arm)
                 for n, p in ((jn, False), (tn, True)))
    tok = onp.append(ref.last, 0).astype("int32")
    before = [{k: v.clone() for k, v in c.items()} for c in port.caches]
    r, o = ref.draft(tok), port.draft(tok)
    assert o.shape == (S + 1, K) and o.dtype == onp.int32
    onp.testing.assert_array_equal(o[:S], r[:S])
    # read-only: the drafter leaves every cache leaf as it found it
    for c, b in zip(port.caches, before):
        for k in c:
            assert torch.equal(c[k], b[k]), k


@pytest.mark.parametrize("layout,arm", [("dense", None),
                                        ("paged", "kernel")])
def test_verify_equals_sequential_decode(nets, layout, arm):
    """The window's logits are the decode steps' over the same tokens."""
    _jn, tn = nets
    a = _Side(tn, True, layout, None, arm)
    b = _Side(tn, True, layout, None, arm)
    w = _window(5)
    w[:S, 0] = a.last
    win = a.verify(w)
    for i in range(K + 1):
        lg, b.caches = tn.decode_step(torch.from_numpy(w[:, i].copy()),
                                      b.caches, torch.from_numpy(b.pos),
                                      **b.kw)
        assert onp.abs(lg.numpy()[:S] - win[:S, i]).max() <= F32_TOL
        b.pos[:S] += 1


def test_full_depth_drafter_proposes_greedy_decode(nets):
    """With every layer the drafter is the model: its k tokens are the
    ones k greedy decode steps give."""
    _jn, tn = nets
    a = _Side(tn, True, "paged", None, "gather")
    b = _Side(tn, True, "paged", None, "gather")
    tok = onp.append(a.last, 0).astype("int32")
    drafts = a.draft(tok, layers=CFG["num_layers"])
    cur = tok.copy()
    for i in range(K):
        lg, b.caches = tn.decode_step(torch.from_numpy(cur), b.caches,
                                      torch.from_numpy(b.pos), **b.kw)
        cur = lg.numpy().argmax(-1).astype("int32")
        onp.testing.assert_array_equal(drafts[:S, i], cur[:S])
        b.pos[:S] += 1
