"""Minimal ONNX protobuf wire codec (counterpart of
``mxnet_tpu/onnx/proto.py``, kept as the port's own copy: it imports only
``struct`` and numpy).

No ``onnx`` package is needed: the subset of the public ``onnx.proto``
schema that the exporter emits is encoded/decoded directly at the
protobuf wire level (field numbers follow the public ONNX schema, so the
files are standard ONNX), and files written by either package parse in
both.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as onp

# ---- ONNX enums (public schema values) ----
# TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64, BOOL, FLOAT16, DOUBLE = \
    1, 2, 3, 6, 7, 9, 10, 11
BFLOAT16 = 16

NP2ONNX = {
    onp.dtype(onp.float32): FLOAT, onp.dtype(onp.uint8): UINT8,
    onp.dtype(onp.int8): INT8, onp.dtype(onp.int32): INT32,
    onp.dtype(onp.int64): INT64, onp.dtype(onp.bool_): BOOL,
    onp.dtype(onp.float16): FLOAT16, onp.dtype(onp.float64): DOUBLE,
}
try:  # bf16 (the AMP default target) rides ml_dtypes
    import ml_dtypes as _mld
    NP2ONNX[onp.dtype(_mld.bfloat16)] = BFLOAT16
except ImportError:
    pass
ONNX2NP = {v: k for k, v in NP2ONNX.items()}

# AttributeProto.AttributeType
A_FLOAT, A_INT, A_STRING, A_TENSOR, A_FLOATS, A_INTS, A_STRINGS = \
    1, 2, 3, 4, 6, 7, 8


# ------------------------------------------------------------ wire writer

def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


class W:
    """Append-only message writer."""

    def __init__(self):
        self.buf = bytearray()

    def int_(self, field, v):
        self.buf += _key(field, 0) + _varint(int(v))
        return self

    def bytes_(self, field, b):
        self.buf += _key(field, 2) + _varint(len(b)) + bytes(b)
        return self

    def str_(self, field, s):
        return self.bytes_(field, s.encode())

    def msg(self, field, w: "W"):
        return self.bytes_(field, w.buf)

    def float_(self, field, v):
        self.buf += _key(field, 5) + struct.pack("<f", float(v))
        return self

    def packed_int64(self, field, vals):
        body = b"".join(_varint(int(v)) for v in vals)
        return self.bytes_(field, body)

    def packed_float(self, field, vals):
        return self.bytes_(field, struct.pack(f"<{len(vals)}f", *vals))

    def done(self) -> bytes:
        return bytes(self.buf)


# ------------------------------------------------------------ wire reader

def _read_varint(buf, p):
    n = shift = 0
    while True:
        b = buf[p]
        p += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, p
        shift += 7


def parse(buf) -> Dict[int, List]:
    """Decode one message level → {field: [value, ...]} (wire-typed:
    ints for varint/fixed, bytes for length-delimited)."""
    out: Dict[int, List] = {}
    p = 0
    n = len(buf)
    while p < n:
        key, p = _read_varint(buf, p)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, p = _read_varint(buf, p)
        elif wire == 2:
            ln, p = _read_varint(buf, p)
            v = bytes(buf[p:p + ln])
            p += ln
        elif wire == 5:
            v = struct.unpack("<I", buf[p:p + 4])[0]
            p += 4
        elif wire == 1:
            v = struct.unpack("<Q", buf[p:p + 8])[0]
            p += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def parse_packed_int64(b: bytes) -> List[int]:
    vals, p = [], 0
    while p < len(b):
        v, p = _read_varint(b, p)
        if v >= 1 << 63:
            v -= 1 << 64
        vals.append(v)
    return vals


# ------------------------------------------------------- ONNX constructors

def tensor(name: str, arr: onp.ndarray) -> W:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = onp.ascontiguousarray(arr)
    w = W()
    for d in arr.shape:
        w.int_(1, d)
    w.int_(2, NP2ONNX[arr.dtype])
    w.str_(8, name)
    w.bytes_(9, arr.tobytes())
    return w


def parse_tensor(b: bytes) -> Tuple[str, onp.ndarray]:
    f = parse(b)
    dims = [int(v) for v in f.get(1, [])]
    dtype = ONNX2NP[int(f[2][0])]
    name = f.get(8, [b""])[0].decode()
    if 9 in f:
        arr = onp.frombuffer(f[9][0], dtype=dtype).reshape(dims)
    elif 4 in f:   # float_data (packed)
        arr = onp.array(
            struct.unpack(f"<{len(f[4][0]) // 4}f", f[4][0]),
            dtype=onp.float32).reshape(dims)
    elif 7 in f:   # int64_data (packed)
        arr = onp.array(parse_packed_int64(f[7][0]),
                        dtype=onp.int64).reshape(dims)
    else:
        arr = onp.zeros(dims, dtype)
    return name, arr


def attr(name: str, value) -> W:
    """AttributeProto: name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 type=20."""
    w = W()
    w.str_(1, name)
    if isinstance(value, bool):
        w.int_(3, int(value)).int_(20, A_INT)
    elif isinstance(value, int):
        w.int_(3, value).int_(20, A_INT)
    elif isinstance(value, float):
        w.float_(2, value).int_(20, A_FLOAT)
    elif isinstance(value, str):
        w.str_(4, value).int_(20, A_STRING)
    elif isinstance(value, onp.ndarray):
        w.msg(5, tensor("", value)).int_(20, A_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            w.packed_float(7, value).int_(20, A_FLOATS)
        else:
            w.packed_int64(8, value).int_(20, A_INTS)
    else:
        raise TypeError(f"attr {name}: {type(value)}")
    return w


def parse_attr(b: bytes):
    f = parse(b)
    name = f[1][0].decode()
    typ = int(f.get(20, [0])[0])
    if typ == A_INT:
        return name, int(f[3][0]) - (1 << 64 if f[3][0] >= 1 << 63 else 0)
    if typ == A_FLOAT:
        return name, struct.unpack("<f", struct.pack("<I", f[2][0]))[0]
    if typ == A_STRING:
        return name, f[4][0].decode()
    if typ == A_TENSOR:
        return name, parse_tensor(f[5][0])[1]
    if typ == A_INTS:
        return name, parse_packed_int64(f[8][0]) if 8 in f else []
    if typ == A_FLOATS:
        raw = f.get(7, [b""])[0]
        return name, list(struct.unpack(f"<{len(raw) // 4}f", raw))
    raise ValueError(f"attr {name}: unsupported type {typ}")


def node(op_type: str, inputs, outputs, name="", **attrs) -> W:
    """NodeProto: input=1 output=2 name=3 op_type=4 attribute=5."""
    w = W()
    for i in inputs:
        w.str_(1, i)
    for o in outputs:
        w.str_(2, o)
    if name:
        w.str_(3, name)
    w.str_(4, op_type)
    for k, v in attrs.items():
        w.msg(5, attr(k, v))
    return w


def value_info(name: str, dtype, shape) -> W:
    """ValueInfoProto{name=1, type=2}; TypeProto{tensor_type=1};
    Tensor{elem_type=1, shape=2}; TensorShapeProto{dim=1};
    Dimension{dim_value=1, dim_param=2}."""
    shp = W()
    for d in shape:
        dim = W()
        if isinstance(d, str):
            dim.str_(2, d)
        else:
            dim.int_(1, int(d))
        shp.msg(1, dim)
    tt = W()
    tt.int_(1, NP2ONNX[onp.dtype(dtype)])
    tt.msg(2, shp)
    tp = W()
    tp.msg(1, tt)
    w = W()
    w.str_(1, name)
    w.msg(2, tp)
    return w


def parse_value_info(b: bytes):
    f = parse(b)
    name = f[1][0].decode()
    tt = parse(parse(f[2][0])[1][0])
    elem = int(tt[1][0])
    dims = []
    if 2 in tt:
        for d in parse(tt[2][0]).get(1, []):
            df = parse(d)
            dims.append(int(df[1][0]) if 1 in df
                        else df.get(2, [b"?"])[0].decode())
    return name, ONNX2NP.get(elem, onp.dtype(onp.float32)), dims


def graph(nodes, name, initializers, inputs, outputs) -> W:
    """GraphProto: node=1 name=2 initializer=5 input=11 output=12."""
    w = W()
    for nd in nodes:
        w.msg(1, nd)
    w.str_(2, name)
    for t in initializers:
        w.msg(5, t)
    for vi in inputs:
        w.msg(11, vi)
    for vi in outputs:
        w.msg(12, vi)
    return w


def model(graph_w: W, opset: int = 13, producer="mxnet_tpu_torch") -> bytes:
    """ModelProto: ir_version=1 producer_name=2 graph=7 opset_import=8."""
    ops = W()
    ops.str_(1, "")          # default domain
    ops.int_(2, opset)
    w = W()
    w.int_(1, 8)             # IR version 8
    w.str_(2, producer)
    w.msg(7, graph_w)
    w.msg(8, ops)
    return w.done()


def parse_model(buf: bytes):
    """→ dict(graph=..., opset=int).  graph: dict(nodes, initializers,
    inputs, outputs, name)."""
    f = parse(buf)
    g = parse(f[7][0])
    nodes = []
    for nb in g.get(1, []):
        nf = parse(nb)
        nodes.append({
            "op": nf[4][0].decode(),
            "inputs": [x.decode() for x in nf.get(1, [])],
            "outputs": [x.decode() for x in nf.get(2, [])],
            "name": nf.get(3, [b""])[0].decode(),
            "attrs": dict(parse_attr(a) for a in nf.get(5, [])),
        })
    inits = dict(parse_tensor(t) for t in g.get(5, []))
    ins = [parse_value_info(v) for v in g.get(11, [])]
    outs = [parse_value_info(v) for v in g.get(12, [])]
    opset = 13
    for o in f.get(8, []):
        of = parse(o)
        if of.get(1, [b""])[0] == b"":
            opset = int(of.get(2, [13])[0])
    return {"graph": {"nodes": nodes, "initializers": inits,
                      "inputs": ins, "outputs": outs,
                      "name": g.get(2, [b""])[0].decode()},
            "opset": opset}
