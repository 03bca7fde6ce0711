#!/usr/bin/env python3
"""Where an ``AtomicCheckpointer`` commit of ``chip_smoke.py`` phase 17's
trainer state spends its time, on the card.

    python3 tools/time_commit.py [--reps 3]

Builds phase 17's trainer (GPT-2 124M under amp, Adam, the loss scaler;
built, not stepped: the state's shapes and bytes are a step's) and times,
``--reps`` times each, in turns:

- ``snapshot``: the checkpointer's copy of the state to the host
  (page-locked buffers, non-blocking, one wait), and ``snapshot_cpu``:
  ``.cpu()`` per tensor, as the reference's ``asnumpy()`` per leaf;
- ``write``: ``utils.serialization.save`` of the host state with a
  ``TreeHasher`` tee (what the checkpointer does), then without the tee,
  then with the tee but ``os.fsync`` a no-op;
- ``digest``: a ``TreeHasher`` over the same bytes with no file, and
  ``digest_copying``: the same digest by the reference's update, which
  copies every byte three times on the way to the pool;
- ``commit``: one whole ``AtomicCheckpointer.save`` (``last_save``'s
  phases beside it).

Files go to a temporary directory that the script removes.  It prints
one JSON line of milliseconds with the bytes, the host's CPU count and
the card's name and power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_commit: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.resilience import AtomicCheckpointer, integrity
    from mxnet_tpu_torch.resilience.checkpoint import _snapshot
    from mxnet_tpu_torch.resilience.integrity import TreeHasher
    from mxnet_tpu_torch.utils import serialization

    card = cs.card_line()
    mx.amp.init("bfloat16")
    try:
        tr = cs.res_trainer(mx)
        tr.build(next(cs.res_batches())[0])
    finally:
        mx.amp.reset()
    state = tr.state_dict()
    nbytes = sum(v.nbytes for v in state.values())
    root = tempfile.mkdtemp(prefix="mxtpu-time-commit-")
    out = {k: [] for k in ("snapshot", "snapshot_cpu", "write",
                           "write_no_tee", "write_no_fsync", "digest",
                           "digest_copying", "commit")}
    phases = []

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        out[key].append((time.perf_counter() - t0) * 1e3)
        return r

    class CopyingHasher(TreeHasher):
        """The reference's ``TreeHasher.update``: the piece appended to a
        buffer, each leaf sliced and copied out of it."""

        def update(self, data):
            self._buf += data
            while len(self._buf) >= integrity._TREE_CHUNK:
                leaf = bytes(self._buf[:integrity._TREE_CHUNK])
                del self._buf[:integrity._TREE_CHUNK]
                self._submit(leaf)

    def digest(cls, pieces):
        h = cls()
        for p in pieces:
            h.update(p)
        return h.hexdigest()

    real_fsync = os.fsync
    try:
        for rep in range(args.reps):
            host = timed("snapshot", lambda: _snapshot(state))
            timed("snapshot_cpu", lambda: {k: v.cpu().numpy()
                                           for k, v in state.items()})
            f = os.path.join(root, "state.mxtpu")
            timed("write", lambda: serialization.save(f, host,
                                                      tee=TreeHasher()))
            timed("write_no_tee", lambda: serialization.save(f, host))
            os.fsync = lambda fd: None
            try:
                timed("write_no_fsync", lambda: serialization.save(
                    f, host, tee=TreeHasher()))
            finally:
                os.fsync = real_fsync
            pieces = [a.tobytes() for a in host.values()]
            want = timed("digest", lambda: digest(TreeHasher, pieces))
            if timed("digest_copying",
                     lambda: digest(CopyingHasher, pieces)) != want:
                raise AssertionError("the two digests differ")
            del pieces
            ck = AtomicCheckpointer(os.path.join(root, "ck"), max_to_keep=2)
            timed("commit", lambda: ck.save(rep + 1, state))
            phases.append({k: round(v * 1e3, 1) if k.endswith("_s") else v
                           for k, v in ck.last_save.items()})
    finally:
        os.fsync = real_fsync
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({
        "card": card, "cpus": os.cpu_count(), "bytes": nbytes,
        "tensors": len(state), "reps": args.reps,
        "ms": {k: [round(x, 1) for x in v] for k, v in out.items()},
        "median_ms": {k: round(statistics.median(v), 1)
                      for k, v in out.items()},
        "commit_phases_ms": phases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
