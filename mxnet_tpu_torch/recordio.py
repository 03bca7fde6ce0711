"""RecordIO: chunked binary record files (counterpart of
``mxnet_tpu/recordio.py``; MXNet's ``python/mxnet/recordio.py`` over
dmlc-core's ``recordio.h`` framing).

Byte-format compatible with dmlc RecordIO: every record is framed
``[kMagic:u32][lrecord:u32][data][pad to 4B]`` where lrecord packs a 3-bit
continuation flag and 29-bit length; files written by upstream MXNet's
``im2rec`` or by the JAX package load here and vice versa.  A C++ fast
path for bulk sequential reads lives in
:mod:`mxnet_tpu_torch.utils.native_io` (used by ``io.ImageRecordIter``
when built); this pure-Python implementation is the always-available one.
Host-only: nothing here touches torch.
"""
from __future__ import annotations

import io
import numbers
import os
import struct
from collections import namedtuple
from typing import List, Optional

import numpy as onp

from . import base as _base

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img", "reassemble_span"]

_kMagic = 0xced7230a
_LEN_MASK = (1 << 29) - 1


class MXRecordIO:
    """Sequential RecordIO reader/writer (parity: mx.recordio.MXRecordIO)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise _base.MXNetError(f"invalid flag {self.flag!r}")
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None
        d["is_open"] = False
        d["_reopen_pos"] = self.handle.tell() if self.is_open else 0
        return d

    def __setstate__(self, d):
        pos = d.pop("_reopen_pos", 0)
        self.__dict__.update(d)
        self.open()
        if self.flag == "r":
            self.handle.seek(pos)

    def reset(self):
        self.close()
        self.open()

    def write(self, buf: bytes):
        """dmlc framing incl. multipart splitting: any 4-byte-aligned magic
        word inside the payload becomes the frame delimiter of the next
        part (cflag 1=start, 2=middle, 3=end), exactly like
        dmlc::RecordIOWriter::WriteRecord — so upstream readers reassemble
        our files bit-for-bit."""
        if not self.writable:
            raise _base.MXNetError("not opened for writing")
        n = len(buf)
        if n > _LEN_MASK:
            raise _base.MXNetError(
                f"record of {n} bytes exceeds the 29-bit RecordIO length "
                "field (dmlc framing)")
        magic_bytes = struct.pack("<I", _kMagic)
        parts = []
        dptr = 0
        for i in range(0, n & ~3, 4):
            if buf[i:i + 4] == magic_bytes:
                parts.append((1 if dptr == 0 else 2, buf[dptr:i]))
                dptr = i + 4
        parts.append((3 if dptr else 0, buf[dptr:]))
        for cflag, part in parts:
            lrec = (cflag << 29) | len(part)
            self.handle.write(struct.pack("<II", _kMagic, lrec))
            self.handle.write(part)
        pad = (4 - (n & 3)) & 3
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        """Read one logical record, reassembling multipart frames (cflag
        1/2/3) with the magic word re-inserted between parts — the inverse
        of write()'s splitting (dmlc::RecordIOReader::NextRecord)."""
        if self.writable:
            raise _base.MXNetError("not opened for reading")
        out = None
        while True:
            hdr = self.handle.read(8)
            if len(hdr) < 8:
                if out is not None:
                    raise _base.MXNetError(
                        f"truncated multipart record at EOF in {self.uri}")
                return None
            magic, lrec = struct.unpack("<II", hdr)
            if magic != _kMagic:
                raise _base.MXNetError(
                    f"invalid RecordIO magic {magic:#x} in {self.uri}")
            cflag = lrec >> 29
            n = lrec & _LEN_MASK
            data = self.handle.read(n)
            pad = (4 - (n & 3)) & 3
            if pad:
                self.handle.read(pad)
            if cflag == 0:
                return data
            if cflag == 1:
                out = bytearray(data)
            else:
                if out is None:
                    raise _base.MXNetError(
                        f"multipart record continuation (cflag={cflag}) "
                        f"without a start frame in {self.uri}")
                out += struct.pack("<I", _kMagic)
                out += data
                if cflag == 3:
                    return bytes(out)

    def tell(self) -> int:
        return self.handle.tell()


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a ``.idx`` sidecar for random access
    (parity: mx.recordio.MXIndexedRecordIO; key \\t offset lines)."""

    def __init__(self, idx_path: str, uri: str, flag: str,
                 key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys: List = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        k = key_type(parts[0])
                        self.idx[k] = int(parts[1])
                        self.keys.append(k)

    def close(self):
        if getattr(self, "is_open", False) and self.writable:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx) -> bytes:
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf: bytes):
        pos = self.tell()
        self.write(buf)
        self.idx[idx] = pos
        self.keys.append(idx)


# MXNet's Python alias used by gluon RecordFileDataset
IndexedRecordIO = MXIndexedRecordIO


def reassemble_span(span: bytes) -> bytes:
    """Reassemble one multipart logical record from its raw frame span
    (starting at the first frame's header): parts are rejoined with the
    magic word re-inserted between them (dmlc::RecordIOReader semantics)."""
    out = bytearray()
    p = 0
    started = False
    while p + 8 <= len(span):
        magic, lrec = struct.unpack_from("<II", span, p)
        if magic != _kMagic:
            raise _base.MXNetError(
                f"invalid RecordIO magic {magic:#x} in multipart span")
        cflag = lrec >> 29
        n = lrec & _LEN_MASK
        p += 8
        if p + n > len(span):
            break
        if cflag == 1:
            started = True
            out = bytearray(span[p:p + n])
        elif cflag in (2, 3) and started:
            out += struct.pack("<I", _kMagic)
            out += span[p:p + n]
            if cflag == 3:
                return bytes(out)
        else:
            raise _base.MXNetError(
                f"malformed multipart chain (cflag={cflag})")
        p += n + ((4 - (n & 3)) & 3)
    raise _base.MXNetError("truncated multipart record span")

# ---------------------------------------------------------------- IRHeader

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a label header + payload (parity: mx.recordio.pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        hdr = struct.pack(_IR_FORMAT, header.flag, float(header.label),
                          header.id, header.id2)
        return hdr + s
    label = onp.asarray(header.label, dtype=onp.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s: bytes):
    """Unpack to (IRHeader, payload)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = onp.frombuffer(s[:flag * 4], dtype=onp.float32)
        s = s[flag * 4:]
        header = IRHeader(flag, label, id_, id2)
    else:
        header = IRHeader(flag, label, id_, id2)
    return header, s


def pack_img(header: IRHeader, img, quality=95, img_fmt=".jpg") -> bytes:
    """Encode an HWC uint8 image and pack it (PIL-backed; parity:
    mx.recordio.pack_img which uses OpenCV)."""
    from PIL import Image
    arr = onp.asarray(img, dtype=onp.uint8)
    pil = Image.fromarray(arr)
    buf = io.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    kw = {"quality": quality} if fmt == "JPEG" else {}
    pil.save(buf, format=fmt, **kw)
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor=-1):
    """Unpack to (IRHeader, HWC uint8 ndarray)."""
    from PIL import Image
    header, payload = unpack(s)
    pil = Image.open(io.BytesIO(payload))
    if iscolor == 0:
        pil = pil.convert("L")
    elif iscolor == 1 or (iscolor == -1 and pil.mode != "L"):
        pil = pil.convert("RGB")
    return header, onp.asarray(pil)
