"""Crash-atomic step checkpoints: tmp-dir write + rename commit
(counterpart of ``mxnet_tpu/resilience/checkpoint.py``; the two packages
read each other's step directories).

The reference's orbax-backed ``utils/checkpoint.py`` is its sharded
path (the port's writes DCP's); this module is the *resilience* path —
a synchronous, self-contained format whose commit point is a
single ``os.rename`` of a fully written temp directory, so a kill at
ANY instant of a save leaves either the previous committed checkpoint
or the new one, never a torn "latest":

1. the leaves are copied to the host (one snapshot: a trainer's
   ``state_dict()`` shares the live device storage, which the next step
   rewrites), then serialized into ``<dir>/.tmp-<step>-<pid>/state.mxtpu``
   (the ``MXTPU1`` container of
   :mod:`mxnet_tpu_torch.utils.serialization`, itself written atomically,
   digested in the same pass) plus a small ``meta.json``;
2. the temp dir is renamed to ``<dir>/step-<NNNNNNNN>`` — POSIX-atomic;
   the injection site ``"checkpoint.commit"`` sits right before this
   rename, so chaos tests can kill mid-save and prove nothing corrupts;
3. ``latest_step()`` only ever sees fully renamed directories; stale
   ``.tmp-*`` dirs from killed saves are swept on construction.

There is deliberately NO separate "latest" marker file: the set of
committed directories IS the source of truth, so no ordering bug between
"write data" and "write marker" can exist.

Atomicity alone is trust-on-read: the rename proves a save COMPLETED,
not that the bytes on disk today are the bytes committed then.  So every
save also writes a ``MANIFEST.json`` (per-file BLAKE2b digest + size,
:mod:`.integrity`) inside the tmp dir *before* the commit rename — the
manifest is atomic with the data — and ``restore`` verifies digests
before deserializing.  A corrupt/torn/missing step is QUARANTINED
(renamed ``corrupt-<step>``, never deleted) and restore falls back down
the chain to the newest intact step, raising the typed
:class:`~.integrity.CheckpointCorruptError` only when no intact step
exists.  ``_gc`` verifies-or-skips: it never deletes the newest intact
step (or the last step a restore verified), so a commit whose bytes rot
immediately after the rename — the ``"checkpoint.corrupt"`` fault site
simulates exactly this — can no longer take every restorable fallback
with it.  See docs/integrity.md.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..observability.trace import active as _trace_active
from .faults import inject, poison
from .integrity import (CheckpointCorruptError, TreeHasher,
                        _count_registry, _warn_legacy_once, flip_bytes,
                        verify_step_dir, write_manifest,
                        MANIFEST_SCHEMA_VERSION)

__all__ = ["AtomicCheckpointer", "CheckpointCorruptError"]

_STEP_PREFIX = "step-"
_TMP_PREFIX = ".tmp-"
_CORRUPT_PREFIX = "corrupt-"
_STATE_FILE = "state.mxtpu"
_META_FILE = "meta.json"


def _snapshot(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The leaves (tensors, numpy arrays, or anything with ``asnumpy()``)
    as host arrays.  CUDA tensors are copied into page-locked buffers
    without blocking and waited for once, at the end: on an H100's host,
    GPT-2 124M's 1.49 GB of trainer state in ~30 ms where a ``.cpu()``
    per tensor took 0.45-1.0 s (``tools/time_commit.py``; torch's caching
    host allocator keeps the buffers for the next commit).  The copies
    are ordered before whatever the device runs next, so the next step
    cannot overwrite a leaf before it is copied.  bfloat16 tensors stay
    tensors (numpy has no bfloat16; the container stores their bits)."""
    host, devices = {}, set()
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            t = v.detach()
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                devices.add(t.device)
                t = buf
            host[k] = t if t.dtype == torch.bfloat16 else t.numpy()
        elif hasattr(v, "asnumpy"):
            host[k] = v.asnumpy()
        else:
            host[k] = np.asarray(v)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return host


class AtomicCheckpointer:
    """Commit-or-nothing step checkpoints under one directory.

    ``save(step, tree)`` takes a flat ``{name: tensor or array}`` dict
    (see ``ShardedTrainer.state_dict()``); ``restore(step=None)``
    returns ``(tree, meta)`` for the requested or latest committed step,
    the tree's values CPU tensors (bfloat16 leaves widened to float32,
    exactly).  ``last_save`` holds the last commit's step, bytes and
    seconds by phase: ``snapshot_s`` (device to host), ``write_s`` (the
    container written and digested, the manifest) and ``rename_s``
    (the commit rename).
    ``max_to_keep`` garbage-collects oldest committed steps AFTER each
    successful commit (never before — a failed save must not eat the
    fallback).
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(str(directory))
        self.max_to_keep = max_to_keep
        # the newest step a restore() actually verified + deserialized:
        # _gc never collects it, whatever max_to_keep says
        self._last_verified: Optional[int] = None
        self.last_save: Optional[dict] = None
        os.makedirs(self.directory, exist_ok=True)
        self._sweep_tmp()

    # ----------------------------------------------------------- inventory
    def _sweep_tmp(self):
        for name in os.listdir(self.directory):
            if not name.startswith(_TMP_PREFIX):
                continue
            path = os.path.join(self.directory, name)
            if name.startswith(_TMP_PREFIX + "old-"):
                # a re-commit moved a COMMITTED step aside and was killed
                # before finishing: if the step dir is gone, the aside
                # copy is the only committed state — recover it
                try:
                    step = int(name[len(_TMP_PREFIX + "old-"):].split("-")[0])
                except ValueError:
                    step = None
                if step is not None and not os.path.isdir(
                        self._step_dir(step)):
                    os.rename(path, self._step_dir(step))
                    continue
            shutil.rmtree(path, ignore_errors=True)

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(_STEP_PREFIX):
                try:
                    out.append(int(name[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def quarantined(self) -> List[str]:
        """Names of quarantined (``corrupt-*``) directories — kept for
        forensics, never restored from, never GC'd."""
        return sorted(name for name in os.listdir(self.directory)
                      if name.startswith(_CORRUPT_PREFIX)
                      and os.path.isdir(os.path.join(self.directory, name)))

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step:08d}")

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Dict[str, Any],
             meta: Optional[dict] = None) -> str:
        """Write and atomically commit one step.  Returns the committed
        path.  Re-committing an existing step replaces it (the
        resume-replays-a-step case; earlier steps stay as fallback)."""
        inject("checkpoint.save")
        tr = _trace_active()
        if tr is None:
            return self._save(step, tree, meta)
        # context-managed like every other site, so a failed save tags
        # its span with error=<type> instead of looking clean
        with tr.span("checkpoint.save", step=int(step)):
            return self._save(step, tree, meta)

    def _save(self, step: int, tree: Dict[str, Any],
              meta: Optional[dict]) -> str:
        from ..utils.serialization import save as _save

        step = int(step)
        t0 = time.monotonic()
        host = _snapshot(tree)
        t1 = time.monotonic()
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step:08d}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        # tee-digest the state file in the same pass that writes it —
        # the manifest records exactly the bytes that went through the
        # writer, with no re-read between write and digest
        hasher = TreeHasher()
        _save(os.path.join(tmp, _STATE_FILE), host, tee=hasher)
        with open(os.path.join(tmp, _META_FILE), "w") as f:
            # the integrity stamp lets verify tell a DELETED manifest
            # (corrupt) from a pre-manifest legacy checkpoint; stamped
            # AFTER the caller's meta so a round-tripped meta dict can
            # never mask the reserved step/integrity keys
            doc = dict(meta or {})
            doc["step"] = step
            doc["integrity"] = MANIFEST_SCHEMA_VERSION
            json.dump(doc, f)
        # manifest INSIDE the tmp dir, before the commit rename: the
        # digests are atomic with the data they describe
        write_manifest(tmp, precomputed={_STATE_FILE: hasher.hexdigest()})
        t2 = time.monotonic()
        inject("checkpoint.commit")
        final = self._step_dir(step)
        aside = None
        if os.path.exists(final):
            # re-committing an existing step: move the old dir ASIDE
            # (rename, not delete) so a kill between here and the commit
            # rename still leaves one committed copy of this step —
            # .old- dirs are swept with the tmp dirs on construction
            aside = os.path.join(self.directory,
                                 f"{_TMP_PREFIX}old-{step:08d}-{os.getpid()}")
            shutil.rmtree(aside, ignore_errors=True)
            os.rename(final, aside)
        try:
            os.rename(tmp, final)      # THE commit point
        except BaseException:
            if aside is not None and not os.path.exists(final):
                os.rename(aside, final)    # roll the old commit back in
                aside = None
            raise
        t3 = time.monotonic()
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        self.last_save = {"step": step,
                          "bytes": sum(a.nbytes for a in host.values()),
                          "snapshot_s": t1 - t0, "write_s": t2 - t1,
                          "rename_s": t3 - t2}
        if poison("checkpoint.corrupt") is not None:
            # chaos: post-commit bit rot on the committed state file —
            # fires BEFORE _gc so the verify-or-skip GC contract is
            # exercised on exactly the save that rotted
            flip_bytes(os.path.join(final, _STATE_FILE))
        self._gc()
        # fleet counter for DIRECT checkpointer users; ResilientLoop
        # additionally counts its own commits into stats()["resilience"]
        try:
            from ..observability.registry import default_registry
            default_registry().counter(
                "mxtpu_checkpoint_commits_total",
                help="atomic checkpoint commits (rename succeeded)").inc()
        except Exception:
            pass
        return final

    def _gc(self):
        """Collect oldest committed steps beyond ``max_to_keep`` —
        verify-or-skip: quarantined dirs are invisible here (they left
        the ``step-`` namespace), and at least one INTACT step always
        survives.  The old blind version could delete every fallback
        right after a commit whose bytes were already corrupt on disk,
        leaving zero restorable state."""
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        excess = steps[:max(0, len(steps) - self.max_to_keep)]
        if not excess:
            return
        newest_intact = None
        for s in reversed(steps):
            status, _why = verify_step_dir(self._step_dir(s), _META_FILE)
            if status != "corrupt":          # legacy counts as restorable
                newest_intact = s
                break
        if newest_intact is None:
            # every step is corrupt: delete NOTHING — the dirs are
            # evidence, and restore() will quarantine + raise typed
            return
        keep = {newest_intact, self._last_verified}
        for s in excess:
            if s in keep:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------- restore
    def _quarantine(self, step: int, reason: str) -> str:
        """Move a corrupt step dir aside as ``corrupt-<step>`` (suffixed
        for uniqueness if the step rots more than once) — NEVER deleted:
        the bytes are the only forensic evidence of what went wrong."""
        src = self._step_dir(step)
        dst = os.path.join(self.directory, f"{_CORRUPT_PREFIX}{step:08d}")
        n = 1
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(self.directory,
                               f"{_CORRUPT_PREFIX}{step:08d}-{n}")
        os.rename(src, dst)
        try:
            with open(os.path.join(dst, "QUARANTINE.txt"), "w") as f:
                f.write(reason + "\n")
        except OSError:
            pass                   # evidence preservation is best-effort
        _count_registry("mxtpu_checkpoint_quarantined_total",
                        help="corrupt checkpoint step dirs quarantined "
                             "(renamed corrupt-<step>, kept on disk)")
        return dst

    def restore(self, step: Optional[int] = None) \
            -> Tuple[Dict[str, Any], dict]:
        """Verified restore of the requested (or latest) step.

        Each candidate is digest-verified BEFORE deserialization; a
        corrupt/torn/missing-file step is quarantined and restore falls
        back to the next-older step — so the returned ``meta["step"]``
        may be older than asked, and callers resuming training replay
        from it (``ResilientLoop`` already keys its replay off the
        meta).  Manifest-less legacy steps restore with a one-time
        warning.  Raises :class:`CheckpointCorruptError` (carrying the
        steps this call quarantined) only when no intact step remains;
        asking for a step that never existed keeps raising the plain
        ``MXNetError``.
        """
        from ..utils.serialization import load as _load

        inject("checkpoint.restore")
        steps = self.all_steps()
        if step is None:
            if not steps:
                raise MXNetError(
                    f"no checkpoint found under {self.directory} "
                    f"(all_steps={self.all_steps()})")
            candidates = steps[::-1]
        else:
            step = int(step)
            if not os.path.isdir(self._step_dir(step)):
                raise MXNetError(
                    f"no checkpoint for step {step} under "
                    f"{self.directory} (all_steps={self.all_steps()})")
            candidates = [s for s in steps if s <= step][::-1]
        quarantined: List[int] = []
        for s in candidates:
            path = self._step_dir(s)
            status, why = verify_step_dir(path, _META_FILE)
            if status == "corrupt":
                self._quarantine(s, why or "verification failed")
                quarantined.append(s)
                continue
            if status == "legacy":
                _warn_legacy_once(path)
            try:
                tree = _load(os.path.join(path, _STATE_FILE))
                with open(os.path.join(path, _META_FILE)) as f:
                    meta = json.load(f)
            except Exception as e:
                # digests matched (or legacy had none) yet the payload
                # would not deserialize — same failure class, same
                # response.  BaseException (SimulatedPreemption, ^C)
                # still propagates: a kill is not corruption.
                self._quarantine(s, f"deserialize failed: {e!r}")
                quarantined.append(s)
                continue
            self._last_verified = s
            return {k: torch.from_numpy(v) for k, v in tree.items()}, meta
        raise CheckpointCorruptError(
            f"no intact checkpoint under {self.directory}: "
            f"{len(quarantined)} step(s) quarantined this call "
            f"({quarantined}, newest first); corrupt-* dirs kept for "
            "forensics", quarantined=quarantined)

    def __repr__(self):
        return (f"AtomicCheckpointer({self.directory!r}, "
                f"steps={self.all_steps()})")
