"""KV migration transport for disaggregated prefill/decode serving
(counterpart of ``mxnet_tpu/serving/migration.py``).

A prefill-role :class:`~.engine.InferenceEngine` finishes a request's
prefill and, instead of decoding it, exports its K/V as a
:class:`MigrationBundle`: a layer-major host copy of exactly the rows or
pages the prompt wrote, plus what the decode side needs to resume the
request token-identically (the prompt, the first token, the remaining
budget and the sampling state).  Every sampling draw hashes the
request's seed with its absolute position (:mod:`.sampling`), so the
decode-role engine continues the stream the prefill engine would have
produced: migration moves where decode runs, never what it produces.

Integrity: the bundle carries a BLAKE2b-128 tree digest
(:class:`~mxnet_tpu_torch.resilience.integrity.TreeHasher`) over a
canonical header and every array's bytes.  :func:`verify_bundle`
recomputes it on the receiving side before any slot or page is claimed,
so a torn transfer is a typed :class:`~.errors.MigrationDigestError` and
the decode pool stays as it was.

The arrays are numpy, one per cache leaf in the reference's leaf order
(each layer's keys sorted: ``k``, ``k_scale``, ``v``, ``v_scale``) and
shapes: pages ``(n, page_size, H, D)`` and scales ``(n, page_size, H,
1)``, or a dense slot's rows ``[0, prompt_len)``.  The header and the
digest are the reference's, so a bundle either package builds carries
the same digest in the other, and either package's engine adopts it.
:class:`PrefixSeed` is the same transport for one cached prefix entry
(the fleet's scale-down path and the tier's host copies).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..resilience.integrity import TreeHasher
from .errors import MigrationDigestError, MigrationError

__all__ = ["MigrationBundle", "MIGRATION_SCHEMA_VERSION",
           "export_bundle", "bundle_digest", "verify_bundle",
           "PrefixSeed", "PREFIX_SEED_SCHEMA_VERSION",
           "seed_digest", "verify_seed", "cache_leaves", "HostCopy",
           "begin_export"]

#: bump when the bundle field layout changes: adopt() refuses a bundle
#: of another schema instead of misreading it (v2: ``kv_quant``)
MIGRATION_SCHEMA_VERSION = 2

#: the same for :class:`PrefixSeed`
PREFIX_SEED_SCHEMA_VERSION = 2


def cache_leaves(caches):
    """The cache tensors in the reference's leaf order: layer by layer,
    each layer's keys sorted (``jax.tree_util.tree_leaves`` of a list of
    dicts)."""
    return [layer[k] for layer in caches for k in sorted(layer)]


_NP_DTYPES = {torch.float32: np.float32, torch.float16: np.float16,
              torch.int8: np.int8, torch.int32: np.int32,
              torch.uint8: np.uint8}


class HostCopy:
    """Host numpy copies of device tensors, taken through one page-locked
    staging buffer.  Construction enqueues the copies on the current
    stream behind the work that made the tensors and records an event;
    :meth:`result` waits for that event alone (on any thread) and returns
    one array per tensor, each its own copy (a bundle or a tier entry
    outlives the buffer).  CPU tensors are copied at construction."""

    __slots__ = ("_metas", "_stage", "_event", "_arrays")

    def __init__(self, tensors):
        tensors = [t.detach() for t in tensors]
        self._arrays = None
        if not tensors or tensors[0].device.type != "cuda":
            self._arrays = [t.cpu().numpy().copy() for t in tensors]
            return
        self._metas = [(tuple(t.shape), t.dtype, t.numel() * t.element_size())
                       for t in tensors]
        self._stage = torch.empty((sum(m[2] for m in self._metas),),
                                  dtype=torch.uint8, pin_memory=True)
        off = 0
        for t, (_shape, _dt, n) in zip(tensors, self._metas):
            self._stage[off:off + n].copy_(
                t.contiguous().reshape(-1).view(torch.uint8),
                non_blocking=True)
            off += n
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(tensors[0].device))

    def result(self) -> List[np.ndarray]:
        if self._arrays is None:
            self._event.synchronize()
            host, off, out = self._stage.numpy(), 0, []
            for shape, dt, n in self._metas:
                out.append(host[off:off + n].copy().view(
                    _NP_DTYPES[dt]).reshape(shape))
                off += n
            self._arrays, self._stage = out, None
        return self._arrays


class MigrationBundle:
    """One request's migratable state.  ``arrays`` holds one host numpy
    array per cache leaf (:func:`cache_leaves` order): ``(n_pages,
    page_size, ...)`` page gathers for the paged layout, ``(prompt_len,
    ...)`` row slices for dense.  The rest are plain scalars and lists,
    so the bundle pickles across process boundaries."""

    __slots__ = ("schema", "source", "layout", "page_size", "kv_quant",
                 "prompt", "prompt_len", "first_token", "max_new_tokens",
                 "eos_id", "deadline", "priority", "temperature", "top_k",
                 "top_p", "seed", "n_pages", "arrays", "trace_id",
                 "route_hint", "digest")

    def __init__(self, *, source: str, layout: str, page_size: int,
                 prompt, first_token: int, max_new_tokens: int,
                 eos_id: Optional[int], deadline: Optional[float],
                 priority: int, temperature: float, top_k: int,
                 top_p: float, seed: int, n_pages: int,
                 arrays: List[np.ndarray],
                 trace_id: Optional[str] = None,
                 route_hint: Optional[bytes] = None,
                 kv_quant: Optional[str] = None):
        self.schema = MIGRATION_SCHEMA_VERSION
        self.source = source
        self.layout = layout
        self.page_size = int(page_size)
        # the storage arm (None: float pages, 'int8': int8 pages with
        # their scale leaves), digest-pinned so an engine of the other
        # arm refuses the bundle
        self.kv_quant = kv_quant
        self.prompt = np.asarray(prompt, "int32")
        self.prompt_len = int(self.prompt.shape[0])
        self.first_token = int(first_token)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.deadline = deadline
        self.priority = int(priority)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.n_pages = int(n_pages)
        self.arrays = arrays
        self.trace_id = trace_id
        # the fleet router's affinity key from submit(route_hint=): it
        # places the decode half by the key it routed the prefill by
        self.route_hint = None if route_hint is None else bytes(route_hint)
        self.digest: Optional[str] = None

    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.arrays) + self.prompt.nbytes)

    def __repr__(self):
        return (f"MigrationBundle(source={self.source!r}, "
                f"layout={self.layout!r}, prompt_len={self.prompt_len}, "
                f"n_pages={self.n_pages}, leaves={len(self.arrays)}, "
                f"{self.nbytes()} bytes)")


def _header_bytes(b) -> bytes:
    """The canonical bytes of everything but the array payload: the
    scalar fields and each array's shape and dtype, so the digest pins
    metadata and data together."""
    head = (b.schema, b.layout, b.page_size, b.kv_quant, b.prompt_len,
            b.first_token, b.max_new_tokens, b.eos_id, b.priority,
            b.temperature, b.top_k, b.top_p, b.seed, b.n_pages,
            b.route_hint,
            tuple((tuple(a.shape), str(a.dtype)) for a in b.arrays))
    return repr(head).encode()


def _hash_arrays(h, arrays):
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())


def bundle_digest(b) -> str:
    """BLAKE2b-128 tree digest over the header, the prompt and every
    array's bytes, in leaf order."""
    h = TreeHasher()
    h.update(_header_bytes(b))
    h.update(np.ascontiguousarray(b.prompt).tobytes())
    _hash_arrays(h, b.arrays)
    return h.hexdigest()


def verify_bundle(b) -> None:
    """The receiving side's gate: the schema must match and the digest
    recomputed must equal the one stamped at export.  Raises typed; run
    before any slot or page is claimed."""
    if getattr(b, "schema", None) != MIGRATION_SCHEMA_VERSION:
        raise MigrationError(
            f"migration bundle schema {getattr(b, 'schema', None)!r} != "
            f"{MIGRATION_SCHEMA_VERSION} — refusing to reinterpret a "
            f"foreign layout")
    if not b.digest:
        raise MigrationDigestError(
            "migration bundle carries no digest — refusing an "
            "unverifiable transfer")
    got = bundle_digest(b)
    if got != b.digest:
        raise MigrationDigestError(
            f"migration bundle digest mismatch (want {b.digest}, got "
            f"{got}): torn or corrupted transfer — bundle NOT adopted, "
            f"decode pool untouched")


class PendingBundle:
    """A bundle whose K/V is still on its way to the host: the request's
    fields and the :class:`HostCopy` of its leaves.  :meth:`seal` waits
    for the copy and stamps the digest, off the scheduler thread."""

    __slots__ = ("fields", "copy")

    def __init__(self, fields: dict, copy: HostCopy):
        self.fields, self.copy = fields, copy

    def seal(self) -> MigrationBundle:
        b = MigrationBundle(arrays=self.copy.result(), **self.fields)
        b.digest = bundle_digest(b)
        return b


def begin_export(eng, slot: int, st, first_token: int) -> PendingBundle:
    """Start host-copying one slot's K/V off ``eng`` right after its
    prefill (``st.filled == st.prompt_len``, nothing generated yet), on
    the scheduler thread under the step lock: the leaves are gathered on
    the device and their copy to the host is enqueued, nothing waits.
    Paged: the slot's pages in table order (shared prefix pages too: the
    copy takes their content); dense: the slot's first ``prompt_len``
    rows."""
    req = st.request
    if eng._paged:
        # the prompt's pages: a slot whose prefill ends this cycle also
        # holds its first decode page already
        pages = st.pages[:eng._pool.pages_for(st.prompt_len)]
        leaves = eng._gather_leaves(pages=pages)
        n_pages = len(pages)
    else:
        leaves = eng._gather_leaves(row=slot, length=st.prompt_len)
        n_pages = 0
    return PendingBundle(dict(
        source=eng.name, layout=eng.kv_layout,
        page_size=eng.page_size if eng._paged else 0,
        prompt=req.payload, first_token=first_token,
        max_new_tokens=st.max_new_tokens, eos_id=req.eos_id,
        deadline=req.deadline, priority=req.priority,
        temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
        seed=req.seed, n_pages=n_pages, trace_id=req.trace_id,
        route_hint=req.route_hint, kv_quant=eng.kv_quant),
        HostCopy(leaves))


def export_bundle(eng, slot: int, st, first_token: int) -> MigrationBundle:
    """:func:`begin_export` and its seal, on the caller's thread: the
    digest-stamped bundle."""
    return begin_export(eng, slot, st, first_token).seal()


# --------------------------------------------------- prefix-seed transport

class PrefixSeed:
    """One cached prefix entry's migratable state: the tokens the entry
    spells and a host copy of its K/V (dense: the pool row's first
    ``length`` positions per leaf; paged: the entry's whole pages).  A
    replica leaving the fleet exports its hot entries as seeds and the
    router plants them on survivors through the ordinary prefix insert,
    so warm prompt families survive scale-down.  Digest discipline as
    :class:`MigrationBundle`."""

    __slots__ = ("schema", "source", "layout", "page_size", "kv_quant",
                 "tokens", "length", "arrays", "digest")

    def __init__(self, *, source: str, layout: str, page_size: int,
                 tokens, length: int, arrays: List[np.ndarray],
                 kv_quant: Optional[str] = None):
        self.schema = PREFIX_SEED_SCHEMA_VERSION
        self.source = source
        self.layout = layout
        self.page_size = int(page_size)
        self.kv_quant = kv_quant
        self.tokens = np.asarray(tokens, "int32")
        self.length = int(length)
        self.arrays = arrays
        self.digest: Optional[str] = None

    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.arrays) + self.tokens.nbytes)

    def __repr__(self):
        return (f"PrefixSeed(source={self.source!r}, "
                f"layout={self.layout!r}, length={self.length}, "
                f"leaves={len(self.arrays)}, {self.nbytes()} bytes)")


def _seed_header_bytes(s) -> bytes:
    head = (s.schema, s.layout, s.page_size, s.kv_quant, s.length,
            tuple((tuple(a.shape), str(a.dtype)) for a in s.arrays))
    return repr(head).encode()


def seed_digest(s) -> str:
    """BLAKE2b-128 tree digest over the header, the tokens and every
    array's bytes, in leaf order."""
    h = TreeHasher()
    h.update(_seed_header_bytes(s))
    h.update(np.ascontiguousarray(s.tokens).tobytes())
    _hash_arrays(h, s.arrays)
    return h.hexdigest()


def verify_seed(s) -> None:
    """The importing side's gate, as :func:`verify_bundle`: checked
    before any row or page is claimed."""
    if getattr(s, "schema", None) != PREFIX_SEED_SCHEMA_VERSION:
        raise MigrationError(
            f"prefix seed schema {getattr(s, 'schema', None)!r} != "
            f"{PREFIX_SEED_SCHEMA_VERSION} — refusing to reinterpret "
            f"a foreign layout")
    if not s.digest:
        raise MigrationDigestError(
            "prefix seed carries no digest — refusing an unverifiable "
            "transfer")
    got = seed_digest(s)
    if got != s.digest:
        raise MigrationDigestError(
            f"prefix seed digest mismatch (want {s.digest}, got {got}):"
            f" torn or corrupted transfer — seed NOT planted, prefix "
            f"pool untouched")
