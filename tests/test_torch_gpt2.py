"""The port's GPT-2 against the JAX package's, on one set of weights.

A 2-layer GPT-2 (units 64, heads 4, vocab 128, max_length 96) is built
in both packages; the port gets the reference's parameters twice — by
``load_numpy_params`` and through a reference ``save_parameters`` file
read by the port's ``load_parameters``.  Compared: forward logits, the
serving surface (``prefill_slots`` full and offset, ``decode_step``) in
the dense layout, the paged gather arm and the paged kernel arm (its
plain version here), in float32 and int8, and greedy ``generate``.

Tolerances: float32 logits max-abs 1e-4 (the reference's fp32 bound for
its paged arms; the two frameworks differ only in summation order).
int8 port vs int8 reference 5e-3: both quantize the same K/V, but a
value sitting on a rounding boundary can land one int8 step apart
between frameworks.  int8 vs float32 holds the reference's 5e-2
contract (``tests/test_paged_attn.py``).  Greedy tokens are identical.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.utils import serialization
from mxnet_tpu_torch.utils.convert import load_numpy_params

CFG = dict(vocab_size=128, units=64, num_layers=2, num_heads=4,
           max_length=96, dropout=0.0)
F32_TOL = 1e-4
INT8_PORT_TOL = 5e-3
INT8_CONTRACT = 5e-2
# the reference weights' seed: the same weights whatever ran before
WEIGHT_SEED = 0


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(WEIGHT_SEED)
    jn.initialize()
    params = {k: p.data().asnumpy()
              for k, p in jn._collect_params_with_prefix().items()}
    tn = load_numpy_params(tget_gpt2("gpt2_124m", device="cpu", **CFG),
                           params)
    path = str(tmp_path_factory.mktemp("gpt2") / "ref.params")
    jn.save_parameters(path)
    tn_file = tget_gpt2("gpt2_124m", device="cpu", **CFG)
    tn_file.load_parameters(path)
    return jn, tn, tn_file, params


def test_structural_names_and_both_load_routes(nets):
    jn, tn, tn_file, params = nets
    names = list(tn.collect_params().keys())
    assert names == list(jn._collect_params_with_prefix().keys())
    assert "h0.attn.q_proj.weight" in names and "h1.ln2.gamma" in names
    for (k, a), b in zip(tn.named_parameters(), tn_file.parameters()):
        onp.testing.assert_array_equal(a.detach().numpy(), params[k])
        onp.testing.assert_array_equal(b.detach().numpy(), params[k])
    # Dense weights are (out, in) in both packages
    assert tuple(tn.h0.ffn.fc1.weight.shape) == (256, 64)


def test_port_file_loads_in_reference_and_bf16_round_trips(nets, tmp_path):
    jn, tn, _tf, params = nets
    path = str(tmp_path / "port.params")
    tn.save_parameters(path)
    jn2 = jget_gpt2("gpt2_124m", **CFG)
    jn2.load_parameters(path)
    for k, p in jn2._collect_params_with_prefix().items():
        onp.testing.assert_array_equal(p.data().asnumpy(), params[k])
    # bf16: the reference writes uint16 bit patterns; the port reads them
    # (widened exactly) into a bf16 model, bit for bit
    jb = jget_gpt2("gpt2_124m", **CFG)
    jb.load_parameters(path)
    jb.cast("bfloat16")
    bpath = str(tmp_path / "ref_bf16.params")
    jb.save_parameters(bpath)
    tb = tget_gpt2("gpt2_124m", device="cpu", **CFG).cast("bfloat16")
    tb.load_parameters(bpath)
    w_ref = jb.wte.weight.data().asnumpy().astype("float32")
    assert tb.wte.weight.dtype == torch.bfloat16
    onp.testing.assert_array_equal(tb.wte.weight.float().detach().numpy(),
                                   w_ref)
    raw = serialization.load(bpath)
    onp.testing.assert_array_equal(raw["wte.weight"], w_ref)
    tb.save_parameters(str(tmp_path / "port_bf16.params"))
    again = serialization.load(str(tmp_path / "port_bf16.params"))
    onp.testing.assert_array_equal(again["wte.weight"], w_ref)


def test_forward_logits_match(nets):
    jn, tn, _tf, _p = nets
    tok = onp.random.RandomState(0).randint(0, 128, (2, 24)).astype("int32")
    ref = jn(mx.nd.array(tok, dtype="int32")).asnumpy()
    out = tn(torch.from_numpy(tok)).detach().numpy()
    onp.testing.assert_allclose(out, ref, atol=F32_TOL, rtol=0)


def _serving_run(net, port, layout, quant, arm):
    """Prefill two prompts (full) into slots 0/1, chunk-prefill one more
    piece behind them (offset), then 2 decode steps over 3 rows (row 2
    parked at Tmax).  Returns the list of per-stage logits (numpy)."""
    s, ps, tmax = 2, 8, 96
    npt = tmax // ps
    rs = onp.random.RandomState(4)
    lens = onp.array([5, 11], "int32")
    toks = onp.zeros((s, 16), "int32")
    for i, n in enumerate(lens):
        toks[i, :n] = rs.randint(0, 128, n)
    chunk = rs.randint(0, 128, (s, 8)).astype("int32")
    clens = onp.array([3, 8], "int32")
    table = onp.full((s + 1, npt), s * npt, "int32")      # zero page
    table[:s, :4] = onp.arange(s * 4).reshape(s, 4)       # 32 positions
    if port:
        def A(x):
            return torch.from_numpy(onp.asarray(x))

        def L(x):
            return x.numpy()
        tok_in = A
    else:
        A = jnp.asarray

        def L(x):
            return onp.asarray(x.jax if isinstance(x, NDArray) else x)

        def tok_in(x):
            return NDArray(jnp.asarray(x))
    kw = {}
    if layout == "paged":
        caches = net.init_page_cache(s * npt + 1, ps, kv_quant=quant)
        kw = dict(page_table=A(table), paged_kernel=arm == "kernel")
    else:
        caches = net.init_slot_cache(s + 1, tmax)
    out = []
    sidx = A(onp.arange(s, dtype="int32"))
    lg, caches = net.prefill_slots(tok_in(toks), A(lens), caches, sidx,
                                   **kw)
    out.append(L(lg))
    lg, caches = net.prefill_slots(tok_in(chunk), A(clens), caches, sidx,
                                   offset=A(lens), **kw)
    out.append(L(lg))
    pos = onp.array([lens[0] + clens[0], lens[1] + clens[1], tmax], "int32")
    tok = onp.array([7, 9, 0], "int32")
    for _ in range(2):
        lg, caches = net.decode_step(tok_in(tok), caches, A(pos), **kw)
        lg = L(lg)
        out.append(lg[:s])
        tok[:s] = lg[:s].argmax(-1)
        pos[:s] += 1
    return out


@pytest.fixture(scope="module")
def ref_dense(nets):
    return _serving_run(nets[0], False, "dense", None, None)


@pytest.mark.parametrize("layout,quant,arm", [
    ("dense", None, None), ("paged", None, "gather"),
    ("paged", None, "kernel"), ("paged", "int8", "gather"),
    ("paged", "int8", "kernel")])
def test_serving_surface_matches(nets, ref_dense, layout, quant, arm):
    jn, tn, _tf, _p = nets
    ref = ref_dense if layout == "dense" else \
        _serving_run(jn, False, layout, quant, arm)
    out = _serving_run(tn, True, layout, quant, arm)
    tol = F32_TOL if quant is None else INT8_PORT_TOL
    for r, o in zip(ref, out):
        onp.testing.assert_allclose(o, r, atol=tol, rtol=0)
    if quant is not None:
        # the reference's bounded-divergence contract against float32
        for r, o in zip(ref_dense, out):
            assert onp.abs(o - r).max() <= INT8_CONTRACT


def test_greedy_generate_token_identical(nets):
    jn, tn, _tf, _p = nets
    rs = onp.random.RandomState(8)
    for n in (6, 13):
        p = rs.randint(0, 128, (1, n)).astype("int32")
        ref = jn.generate(mx.nd.array(p, dtype="int32"), 10,
                          temperature=0).asnumpy()
        out = tn.generate(p, 10, temperature=0)
        assert out.dtype == torch.int32
        onp.testing.assert_array_equal(out.numpy(), ref)


def test_sampled_generate_is_seeded(nets):
    _jn, tn, _tf, _p = nets
    p = onp.arange(5, dtype="int32")[None]
    a = tn.generate(p, 8, temperature=0.9, top_k=20, seed=3)
    b = tn.generate(p, 8, temperature=0.9, top_k=20, seed=3)
    onp.testing.assert_array_equal(a.numpy(), b.numpy())


def test_initialize_is_seeded_and_follows_name_rules():
    a = tget_gpt2("gpt2_124m", device="cpu", **CFG).initialize(seed=5)
    b = tget_gpt2("gpt2_124m", device="cpu", **CFG).initialize(seed=5)
    for (k, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), k
    w = a.h0.attn.q_proj.weight.detach()
    assert float(w.abs().max()) <= 0.07 and float(w.std()) > 0.01
    assert (a.h0.attn.q_proj.bias == 0).all()
    assert (a.h0.ln1.gamma == 1).all() and (a.h0.ln1.beta == 0).all()
