"""The port's ONNX export and import (``mxnet_tpu_torch.onnx``) against
the JAX package's, on the CPU.

Mirrors ``tests/test_onnx.py``: an MLP, conv+BN+pool, ResNet-18 and an
activations-and-broadcast block, each from the same parameters in both
packages (copied with ``save_parameters`` / ``load_parameters``).  Files
cross both ways: the port's file runs in the reference's
``import_model`` and the reference's in the port's, each equal to the
source net; both packages' ``proto`` parsers read both files.
Tolerances: the reference's 1e-4 relative, with its absolute bounds
(1e-5; 1e-4 for conv+BN+pool, 1e-3 for ResNet-18).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu.onnx import proto as rproto
from mxnet_tpu_torch.onnx import proto as pproto


def _mlp(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(5))
    return net


def _cnn(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
            nn.Activation("relu"), nn.MaxPool2D(2), nn.Flatten(),
            nn.Dense(4))
    return net


def _resnet18(mx):
    if mx is P:
        from mxnet_tpu_torch.models.vision import get_model
    else:
        from mxnet_tpu.models.vision import get_model
    return get_model("resnet18_v1", classes=10)


class _RMixed(R.gluon.nn.HybridBlock):
    def __init__(self):
        super().__init__()
        self.d = R.gluon.nn.Dense(6, flatten=False)

    def forward(self, x):
        from mxnet_tpu.ndarray import ops as F
        h = self.d(x)
        return (F.sigmoid(h) + F.tanh(h)) * F.Activation(
            h, act_type="gelu") - h.mean()


class _PMixed(P.gluon.nn.HybridBlock):
    def __init__(self):
        super().__init__()
        self.d = P.gluon.nn.Dense(6, flatten=False)

    def hybrid_forward(self, F, x):
        h = self.d(x)
        return (F.sigmoid(h) + F.tanh(h)) * F.Activation(
            h, act_type="gelu") - h.mean()


NETS = {
    "mlp": (_mlp, (3, 8), 1e-5),
    "conv_bn_pool": (_cnn, (2, 3, 16, 16), 1e-4),
    "resnet18": (_resnet18, (2, 3, 32, 32), 1e-3),
    "mixed": (lambda mx: _PMixed() if mx is P else _RMixed(), (4, 5, 6),
              1e-5),
}


def _pair(kind, x, tmp_path):
    build = NETS[kind][0]
    rnet = build(R)
    R.random.seed(0)
    rnet.initialize()
    ref = rnet(R.nd.array(x)).asnumpy()
    f = str(tmp_path / f"{kind}.params")
    rnet.save_parameters(f)
    with P.cpu():
        pnet = build(P)
        pnet.load_parameters(f, ctx=P.cpu())
        got = pnet(P.nd.array(x)).asnumpy()
    return rnet, pnet, ref, got


@pytest.mark.parametrize("kind", sorted(NETS))
def test_files_cross_both_ways(kind, tmp_path):
    """The port's file runs in both importers and the reference's file in
    the port's, each equal to the source net; the port's initializers
    carry the parameters by structural name."""
    _build, shape, atol = NETS[kind]
    x = onp.random.RandomState(len(kind)).uniform(-1, 1, shape).astype("f")
    rnet, pnet, ref, got = _pair(kind, x, tmp_path)
    onp.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)
    p_file, r_file = str(tmp_path / "port.onnx"), str(tmp_path / "ref.onnx")
    with P.cpu():
        assert P.onnx.export_model(pnet, p_file, shape) == p_file
        blk, args, aux = P.onnx.import_model(p_file)
        own = blk(P.nd.array(x)).asnumpy()
        R.onnx.export_model(rnet, r_file, shape)
        pblk, _, _ = P.onnx.import_model(r_file)
        from_ref = pblk(x).asnumpy()
    rblk, _, _ = R.onnx.import_model(p_file)
    in_ref = rblk(R.nd.array(x)).asnumpy()
    for out, want in ((own, got), (in_ref, got), (from_ref, ref)):
        onp.testing.assert_allclose(out, want, rtol=1e-4, atol=atol)
    assert aux == {}
    structural = {k.replace(".", "_") for k, _ in pnet.named_parameters()}
    assert structural <= set(args)
    assert all(isinstance(v, P.nd.NDArray) for v in args.values())


def test_file_structure_parses_in_both_packages(tmp_path):
    """The emitted bytes are a well-formed ONNX ModelProto to both
    parsers: opset 13, one ``data`` input, one output that a node
    produces."""
    with P.cpu():
        net = P.gluon.nn.HybridSequential()
        net.add(P.gluon.nn.Dense(3))
        net.initialize()
        net(P.nd.array(onp.zeros((1, 4), "f")))
        p = str(tmp_path / "m.onnx")
        P.onnx.export_model(net, p, (1, 4))
    raw = open(p, "rb").read()
    for proto in (pproto, rproto):
        m = proto.parse_model(raw)
        g = m["graph"]
        assert m["opset"] == 13
        assert g["inputs"][0][0] == "data" and list(g["inputs"][0][2]) == \
            [1, 4]
        assert len(g["outputs"]) == 1
        produced = {o for n in g["nodes"] for o in n["outputs"]}
        assert g["outputs"][0][0] in produced
    rt = pproto.parse_model(raw)
    assert sorted(rt["graph"]["initializers"]) == \
        sorted(rproto.parse_model(raw)["graph"]["initializers"])
    with pytest.raises(P.MXNetError, match="opset"):
        P.onnx.export_model(net, p, (1, 4), opset=11)


def test_an_op_outside_the_vocabulary_is_named(monkeypatch, tmp_path):
    """An op with no ONNX form raises a typed error naming it: the flash
    kernel's custom op among them, as ``pallas_call`` is for the
    reference, also where an unsupported ATen op (GPT-2's embedding)
    comes first."""
    from mxnet_tpu_torch.ops import attention

    class Direct(P.gluon.nn.HybridBlock):
        def forward(self, q):
            return torch.ops.mxnet_tpu_torch.flash_fwd(
                q, q, q, None, None, True, 0.125)[0]

    flash = "unsupported op 'mxnet_tpu_torch::flash_fwd'"
    with P.cpu():
        with pytest.raises(P.MXNetError, match=flash):
            P.onnx.export_model(Direct(), str(tmp_path / "d.onnx"),
                                (1, 128, 2, 64))
        monkeypatch.setattr(attention, "_use_flash",
                            lambda q, k, mask, dropout=0.0: mask is None
                            and dropout == 0.0 and q.shape[1] >= 256)
        gpt = P.models.get_gpt2("gpt2_124m", device="cpu", vocab_size=64,
                                units=128, num_layers=1, num_heads=2,
                                max_length=256, dropout=0.0)
        gpt.initialize()
        with pytest.raises(P.MXNetError, match=flash):
            P.onnx.export_model(gpt, str(tmp_path / "g.onnx"), (2, 256),
                                input_dtype="int64")
        monkeypatch.undo()
        with pytest.raises(P.MXNetError, match="'aten::embedding'"):
            P.onnx.export_model(gpt, str(tmp_path / "g.onnx"), (2, 256),
                                input_dtype="int64")
