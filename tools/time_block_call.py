#!/usr/bin/env python3
"""Time the host work of ``Block.__call__`` in ``mxnet_tpu_torch`` on
the CPU, for one tree or two in turns.

    python3 tools/time_block_call.py                    # this tree
    python3 tools/time_block_call.py --root build/parent --root .

With two roots it runs them as A, B, B, A, each in a fresh process with
one torch thread.  Three readings per run, each the best of ``--repeats``
means over ``--calls`` calls:

- ``noop``: a HybridBlock whose forward returns its input, called with
  a tensor: ``Block.__call__`` and torch's ``Module.__call__`` alone;
- ``dense``: ``Dense(8, in_units=8)`` on a (1, 8) tensor: the same plus
  one small product;
- ``decode``: one ``decode_step`` of a 2-layer, 64-unit GPT-2 over 4
  slots with dense caches: about 30 module calls, the serving engine's
  host-bound step in small.

Prints one JSON line per run: the root and microseconds per call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
calls, repeats = int(sys.argv[2]), int(sys.argv[3])
import torch
torch.set_num_threads(1)
from mxnet_tpu_torch.gluon.block import HybridBlock
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.models import get_gpt2

class Noop(HybridBlock):
    def forward(self, x):
        return x

def best(fn, n):
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
    return min(out)

x = torch.ones(1, 8)
noop = Noop()
dense = Dense(8, in_units=8)
dense.initialize(device="cpu")
net = get_gpt2("gpt2_124m", vocab_size=128, units=64, num_layers=2,
               num_heads=4, max_length=64, dropout=0.0, device="cpu")
net.initialize(seed=0)
caches = net.init_slot_cache(4)
tok = torch.zeros(4, dtype=torch.int32)
pos = torch.full((4,), 3, dtype=torch.int32)
with torch.no_grad():
    res = {"noop_us": best(lambda: noop(x), calls),
           "dense_us": best(lambda: dense(x), calls),
           "decode_us": best(lambda: net.decode_step(tok, caches, pos),
                             max(calls // 50, 1))}
print(json.dumps({"root": sys.argv[1], **res}))
"""


def run(root, calls, repeats):
    out = subprocess.run(
        [sys.executable, "-c", CHILD, os.path.abspath(root), str(calls),
         str(repeats)], capture_output=True, text=True, check=True,
        timeout=1800)
    line = out.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append",
                    help="a tree holding mxnet_tpu_torch/ (repeatable; "
                         "default: this one)")
    ap.add_argument("--calls", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    roots = args.root or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    order = roots if len(roots) == 1 else \
        [roots[0], roots[1], roots[1], roots[0]]
    for root in order:
        run(root, args.calls, args.repeats)


if __name__ == "__main__":
    main()
