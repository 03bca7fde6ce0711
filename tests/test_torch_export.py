"""``HybridBlock.export`` → ``SymbolBlock.imports`` in the port, against
the JAX package's, on the CPU; and the custom op that is B1's one route.

Mirrors ``tests/test_export.py``: round trips of an MLP, a conv net and
a 2-layer GPT-2, each imported block's output held to the reference's
imported block from the same parameters (copied across with
``save_parameters`` / ``load_parameters``); another batch size through
the symbolic batch; the MoE layer's single output; the typed refusal of
the reference's StableHLO format; and ``torch.library.opcheck`` of
``mxnet_tpu_torch::flash_fwd``, traced into a program whose output is
the reference's ``flash_attention`` run as its own tests run it on the
CPU (Pallas interpret mode).  Tolerances are the reference's: 1e-5
relative and 1e-6 absolute, 1e-4 / 1e-5 for the conv net, 1e-4
absolute for GPT-2's logits (the float32 parity bound of the port's
GPT-2 tests).
"""
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu.gluon.block import SymbolBlock as RSymbolBlock
from mxnet_tpu_torch.gluon.block import SymbolBlock

TOL = {"mlp": (1e-5, 1e-6), "cnn": (1e-4, 1e-5), "gpt2": (0.0, 1e-4)}


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(32, activation="relu"), mx.gluon.nn.Dense(10))
    return net


def _cnn(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
            nn.Activation("relu"), nn.MaxPool2D(2), nn.Flatten(),
            nn.Dense(5))
    return net


_GPT = dict(vocab_size=64, units=64, num_layers=2, num_heads=2,
            max_length=64, dropout=0.0)


def _gpt2(mx):
    if mx is P:
        return P.models.get_gpt2("gpt2_124m", device="cpu", **_GPT)
    from mxnet_tpu.models import get_gpt2
    return get_gpt2("gpt2_124m", **_GPT)


def _inputs(kind, batch, seed):
    rs = onp.random.RandomState(seed)
    if kind == "gpt2":
        return rs.randint(0, 64, (batch, 32)).astype("int32")
    shape = (batch, 16) if kind == "mlp" else (batch, 3, 12, 12)
    return rs.uniform(-1, 1, shape).astype("f")


BUILD = {"mlp": _mlp, "cnn": _cnn, "gpt2": _gpt2}


def _pair(kind, tmp_path):
    """The reference net initialized and exported, and the port's net
    loaded from its params, called once and exported."""
    x = _inputs(kind, 4, seed=1)
    rnet = BUILD[kind](R)
    R.random.seed(0)
    rnet.initialize()
    rnet(R.nd.array(x))
    r_sym, r_par = rnet.export(str(tmp_path / f"ref_{kind}"))
    with P.cpu():
        pnet = BUILD[kind](P)
        pnet.load_parameters(r_par, ctx=P.cpu())
        pnet(P.nd.array(x))
    p_sym, p_par = pnet.export(str(tmp_path / f"port_{kind}"))
    return (rnet, r_sym, r_par), (pnet, p_sym, p_par)


@pytest.mark.parametrize("kind", ["mlp", "cnn", "gpt2"])
def test_roundtrip_matches_the_reference_symbol_block(kind, tmp_path):
    """The port's imported block equals the reference's imported block
    from the same parameters, at the export batch and at another one
    (the symbolic batch); its meta carries the reference's keys."""
    (rnet, r_sym, r_par), (pnet, p_sym, p_par) = _pair(kind, tmp_path)
    rtol, atol = TOL[kind]
    rblk = RSymbolBlock.imports(r_sym, ["data"], r_par)
    ref_meta = json.load(open(r_sym))
    with P.cpu():
        pblk = SymbolBlock.imports(p_sym, ["data"], p_par)
        for batch, seed in ((4, 1), (7, 2)):
            x = _inputs(kind, batch, seed)
            # the reference's GPT-2 exports a static batch: at another
            # batch the port's imported block is held to its net
            ref = rblk if batch == 4 or ref_meta["symbolic_batch"] \
                else rnet
            want = ref(R.nd.array(x)).asnumpy()
            got = pblk(P.nd.array(x))
            assert isinstance(got, P.nd.NDArray)
            onp.testing.assert_allclose(got.asnumpy(), want, rtol=rtol,
                                        atol=atol)
            onp.testing.assert_allclose(
                got.asnumpy(), pnet(P.nd.array(x)).asnumpy(), rtol=rtol,
                atol=atol)
    meta = json.load(open(p_sym))
    assert set(ref_meta) <= set(meta)
    assert (meta["framework"], meta["format"]) == ("mxnet_tpu_torch",
                                                   "torch.export")
    assert meta["symbolic_batch"] and meta["n_inputs"] == 1
    assert meta["out_tree"] == ref_meta["out_tree"] == ["nd", None]


def test_params_files_cross_and_imports_need_no_model_class(tmp_path):
    """The port's imported block runs from the reference's params file
    too, and its parameters are the file's, frozen, under their
    structural names; mutating the live net after export changes
    nothing."""
    (rnet, r_sym, r_par), (pnet, p_sym, p_par) = _pair("mlp", tmp_path)
    x = _inputs("mlp", 4, seed=1)
    with P.cpu():
        want = pnet(P.nd.array(x)).asnumpy()
        with torch.no_grad():
            for p in pnet.parameters():
                p.zero_()
        blk = SymbolBlock.imports(p_sym, ["data"], param_file=r_par)
        onp.testing.assert_allclose(blk(P.nd.array(x)).asnumpy(), want,
                                    rtol=1e-5, atol=1e-6)
    names = sorted(blk.collect_params())
    assert names == ["0_bias", "0_weight", "1_bias", "1_weight"]
    assert not any(p.requires_grad for p in blk.parameters())


def test_export_needs_a_prior_call_and_keeps_its_signature(tmp_path):
    """Export traces the last real call's signature, and the trace leaves
    it (and the children's) in place: a second export works."""
    with P.cpu():
        net = _mlp(P)
        net.initialize()
        with pytest.raises(P.MXNetError, match="prior forward"):
            net.export("unused")
        net(P.nd.array(_inputs("mlp", 3, 0)))
        kept = [m._export_args for m in net.modules()]
        first = net.export(str(tmp_path / "a"))
        assert [m._export_args for m in net.modules()] == kept
        second = net.export(str(tmp_path / "b"))
        x = P.nd.array(_inputs("mlp", 5, 1))
        outs = [SymbolBlock.imports(f, ["data"], p)(x).asnumpy()
                for f, p in (first, second)]
    onp.testing.assert_array_equal(outs[0], outs[1])


def test_moe_export_carries_exactly_its_declared_output(tmp_path):
    """An exported MoE layer has one output (its aux loss stays out of
    the program), and reloads to the layer's output."""
    from mxnet_tpu_torch.models import MoELayer
    rs = onp.random.RandomState(0)
    x = rs.randn(2, 8, 16).astype("float32")
    with P.cpu():
        net = MoELayer(16, 32, num_experts=4, top_k=2)
        net.initialize()
        ref = net(P.nd.array(x)).asnumpy()
        sym_f, par_f = net.export(str(tmp_path / "moe"))
        ep = torch.export.load(str(tmp_path / "moe-symbol.pt2"))
        assert len(ep.graph_signature.output_specs) == 1
        blk = SymbolBlock.imports(sym_f, ["data"], par_f)
        onp.testing.assert_allclose(blk(P.nd.array(x)).asnumpy(), ref,
                                    rtol=1e-5, atol=1e-6)


def test_reference_format_is_refused_by_name(tmp_path):
    """A reference export (StableHLO) is refused with a typed error that
    names both formats."""
    rnet = _mlp(R)
    rnet.initialize()
    rnet(R.nd.array(_inputs("mlp", 2, 0)))
    r_sym, r_par = rnet.export(str(tmp_path / "ref"))
    with pytest.raises(P.MXNetError, match="stablehlo") as e:
        SymbolBlock.imports(r_sym, ["data"], r_par, ctx=P.cpu())
    assert "torch.export" in str(e.value)


def test_a_program_traced_on_another_device_is_refused(tmp_path):
    """A program exported on one kind of device is refused on another
    with a typed error naming both (the reference refuses a program
    exported for another platform): a transformer traced on the CPU
    holds the plain attention ops, which must not run on the card in
    place of B1."""
    import json
    with P.cpu():
        net = _mlp(P)
        net.initialize()
        net(P.nd.array(_inputs("mlp", 2, 0)))
        sym_f, par_f = net.export(str(tmp_path / "mlp"))
    with open(sym_f) as f:
        meta = json.load(f)
    assert meta["device"] == "cpu"
    meta["device"] = "cuda:0"       # as if traced on the card
    with open(sym_f, "w") as f:
        json.dump(meta, f)
    with pytest.raises(P.MXNetError, match="exported on cuda:0") as e:
        SymbolBlock.imports(sym_f, ["data"], par_f, ctx=P.cpu())
    assert "imported on cpu" in str(e.value)


def _qkv(seed, b=2, t=128, h=2, d=64):
    rs = onp.random.RandomState(seed)
    return [rs.randn(b, t, h, d).astype("float32") for _ in range(3)]


def test_flash_op_passes_opcheck():
    """The custom op's schema, fake implementation (symbolic shapes
    included) and dispatch pass ``torch.library.opcheck`` on CPU
    tensors, with and without segment ids."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3))
    seg = torch.zeros((2, 128), dtype=torch.int32)
    seg[:, 64:] = 1
    op = torch.ops.mxnet_tpu_torch.flash_fwd.default
    for args in ((q, k, v, None, None, True, 0.125),
                 (q, k, v, seg, seg, False, 0.125)):
        torch.library.opcheck(op, args)


class _DirectFlash(torch.nn.Module):
    def forward(self, q, k, v):
        return torch.ops.mxnet_tpu_torch.flash_fwd(q, k, v, None, None,
                                                   True, 0.125)[0]


def test_a_program_holds_the_op_and_gives_the_reference_attention():
    """A module that calls the op directly, traced by ``torch.export``,
    holds it as one node; the program's output equals the reference's
    ``flash_attention`` in interpret mode."""
    from mxnet_tpu.ops import flash as rflash
    q, k, v = _qkv(5)
    ep = torch.export.export(
        _DirectFlash(), tuple(torch.from_numpy(a) for a in (q, k, v)),
        strict=False)
    ops = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert torch.ops.mxnet_tpu_torch.flash_fwd.default in ops
    got = ep.module()(*(torch.from_numpy(a) for a in (q, k, v)))
    want = rflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, scale=0.125,
                                  interpret=True)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), rtol=0,
                                atol=1e-5)


def test_exported_gpt2_on_the_flash_route_carries_the_op(tmp_path,
                                                         monkeypatch):
    """GPT-2 traced with its attention on the flash route (the card's
    route, opened to CPU tensors here) carries one op node per layer;
    the imported block, run on the CPU route, equals the net."""
    from mxnet_tpu_torch.ops import attention
    cfg = dict(_GPT, units=128, max_length=256)
    monkeypatch.setattr(attention, "_use_flash",
                        lambda q, k, mask, dropout=0.0: mask is None
                        and dropout == 0.0 and q.shape[1] >= 256)
    toks = onp.random.RandomState(0).randint(0, 64, (2, 256)).astype("int32")
    with P.cpu():
        net = P.models.get_gpt2("gpt2_124m", device="cpu", **cfg)
        net.initialize()
        ref = net(P.nd.array(toks)).asnumpy()
        sym_f, par_f = net.export(str(tmp_path / "gpt"))
    ep = torch.export.load(str(tmp_path / "gpt-symbol.pt2"))
    n_ops = sum(n.target is torch.ops.mxnet_tpu_torch.flash_fwd.default
                for n in ep.graph.nodes)
    assert n_ops == cfg["num_layers"]
    monkeypatch.undo()
    with P.cpu():
        blk = SymbolBlock.imports(sym_f, ["data"], par_f)
        out = blk(P.nd.array(toks)).asnumpy()
    onp.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_op_registration_survives_a_module_reload():
    """Reloading ``ops/flash.py`` reuses the registration (no second
    registration raises) and the op runs the reloaded module's
    implementation (in a subprocess: a reload must not leak into other
    tests)."""
    code = (
        "import importlib, torch\n"
        "from mxnet_tpu_torch.ops import flash\n"
        "op = torch.ops.mxnet_tpu_torch.flash_fwd.default\n"
        "q = torch.randn(1, 128, 2, 64)\n"
        "a = flash.flash_fwd(q, q, q, causal=True, scale=0.1)[0]\n"
        "flash = importlib.reload(flash)\n"
        "calls = []\n"
        "impl = flash._flash_fwd_impl\n"
        "flash._flash_fwd_impl = lambda *x: calls.append(1) or impl(*x)\n"
        "b = flash.flash_fwd(q, q, q, causal=True, scale=0.1)[0]\n"
        "assert flash._FLASH_FWD_OP is op and calls == [1]\n"
        "assert torch.equal(a, b)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


def test_the_attention_function_takes_the_op():
    """``_FlashAttention`` (the differentiable route of training) reaches
    B1 through the op, so forward and backward still hold to the plain
    versions on CPU tensors."""
    from mxnet_tpu_torch.ops import flash
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(7))
    calls = []
    impl = flash._flash_fwd_impl
    try:
        flash._flash_fwd_impl = lambda *a: calls.append(1) or impl(*a)
        out = flash.flash_attention(q, k, v, causal=True)
    finally:
        flash._flash_fwd_impl = impl
    assert calls == [1]
    want, _lse = flash._fwd_plain(q.detach(), k.detach(), v.detach(), None,
                                  None, True, 64 ** -0.5)
    onp.testing.assert_allclose(out.detach().numpy(), want.numpy(),
                                rtol=0, atol=0)
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
