#!/usr/bin/env python3
"""How often torch.profiler drops the first kernel records of a traced
GPT-2 step on the card, with and without ``chip_smoke.profiled``'s wait
before the traced call.

    python3 tools/profiler_head.py [--reps 10]

Builds phase 16b's graphed GPT-2 124M ``ShardedTrainer`` step under amp
(16 x 1024, Adam), captures it, then ``--reps`` times, in turns, profiles
one replay after an untraced one the way ``chip_smoke.profiled`` does
(the traced call 0.1 s after ``prof.step()``) and the way it did before
(at once), and counts the B1/B2/B3 records and the device-busy ms each
trace holds.  A replay launches 12 of each.  Prints one JSON line with
the card's name and power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def at_once(torch, fn):
    """``chip_smoke.profiled`` without its wait."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
    return prof, None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_head: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.utils import native

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    native.build()
    toks, labels = cs.train_batch()
    mx.amp.init("bfloat16")
    try:
        net = get_gpt2("gpt2_124m", dropout=0.0).initialize(seed=cs.SEED)
        tr = ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                            optimizer_params={"learning_rate": cs.TRAIN_LR})
        tr.step(toks, labels)                    # capture, then replay
        out = {"wait": [], "at_once": []}
        for rep in range(args.reps):
            arms = (("wait", cs.profiled), ("at_once", at_once))
            for name, prof_fn in (arms if rep % 2 == 0 else arms[::-1]):
                prof, _ms = prof_fn(torch, lambda: tr.step(toks, labels))
                seen = cs._device_counts(torch, prof, cs.RES_FLASH)
                busy = sum(ms for _k, ms in cs._device_rows(torch, prof))
                out[name].append({"records": list(seen.values()),
                                  "busy_ms": round(busy, 3)})
                time.sleep(0.05)
    finally:
        mx.amp.reset()
    short = {k: sum(r["records"] != [12, 12, 12] for r in v)
             for k, v in out.items()}
    print(json.dumps({"card": card, "reps": args.reps,
                      "traces_missing_records": short, "traces": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
