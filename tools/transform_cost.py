#!/usr/bin/env python3
"""What a CUDA graph of ``DeviceTransform`` would save on the card.

    python3 tools/transform_cost.py [--reps 20] [--rounds 2]

The port runs the transform eagerly on the caller's stream.  Against it
stands the same function captured once as a graph
(``utils.graphs.Program``, the batch and the step as its inputs) and
replayed, its output cloned for the caller, at ``chip_smoke.py`` phase
19 (b)'s shape: 128 x 256 x 256 x 3 uint8 images cropped to 224,
mirrored and normalized, NHWC.

1. The call alone, on a side stream as the prefetcher's feeder runs it,
   the two forms in turns over ``--rounds`` rounds: host ms a call (the
   thread's time to queue ``--reps`` calls), device ms a call (CUDA
   events around them), and the outputs held bit for bit.
2. The step: phase 19 (b)'s graphed ResNet-50 v1 NHWC step under amp,
   fed by ``DataLoader`` -> ``DevicePrefetcher`` with either form as its
   ``transform=``, ``--rounds`` rounds of 5 timed steps each, in turns:
   images/s and the input wait.

Prints one JSON line with the card's name and power limit.  Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class Graphed:
    """``tf``'s function as one CUDA graph a lattice point, captured at
    its first call (on the caller's thread), replayed after; each call
    returns a clone of the graph's output."""

    def __init__(self, tf):
        self.tf, self.progs = tf, {}

    def apply(self, x, step):
        from mxnet_tpu_torch.utils.graphs import Program
        prog = self.progs.get(tuple(x.shape))
        if prog is None:
            prog = self.progs[tuple(x.shape)] = Program(
                [x, np.zeros((1,), np.int64)], x.device, True,
                lambda e: RuntimeError(f"transform capture failed: {e}"))
        prog.copy_in([x, np.array([step], np.int64)])
        if not prog.built:
            def fn():
                return self.tf._transform(*prog.inputs)
            prog.out = prog.build(fn, fn)[0]
        prog.replay()
        return prog.out.clone()

    def __call__(self, data, labels, step):
        from mxnet_tpu_torch.ndarray import NDArray
        first = data[0]
        y = self.apply(first.tensor if isinstance(first, NDArray) else first,
                       step)
        return (NDArray(y),) + tuple(data[1:]), tuple(labels)


def call_cost(torch, forms, x, reps, rounds):
    """Part 1: {form: {"host_ms": [...], "device_ms": [...]}}, and
    whether the forms' outputs agree bit for bit at every step."""
    side = torch.cuda.Stream()
    out = {name: {"host_ms": [], "device_ms": []} for name in forms}
    got = {}
    with torch.cuda.stream(side):
        for name, fn in forms.items():        # warm-up (the capture)
            got[name] = [fn(x, i) for i in range(3)]
        for rnd in range(rounds):
            names = list(forms) if rnd % 2 == 0 else list(forms)[::-1]
            for name in names:
                fn = forms[name]
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record(side)
                t0 = time.perf_counter()
                for i in range(reps):
                    fn(x, i)
                host = time.perf_counter() - t0
                e1.record(side)
                e1.synchronize()
                out[name]["host_ms"].append(host * 1e3 / reps)
                out[name]["device_ms"].append(e0.elapsed_time(e1) / reps)
    torch.cuda.synchronize()
    a, b = got.values()
    return out, all(torch.equal(p, q) for p, q in zip(a, b))


def step_cost(torch, mx, cs, hooks, rounds, card):
    """Part 2: {form: {"images_per_s": [...], "input_wait_ms_p50": x}}."""
    from mxnet_tpu_torch.data import DevicePrefetcher
    from mxnet_tpu_torch.parallel import ShardedTrainer
    rs = np.random.RandomState(cs.SEED)
    n = (1 + rounds * cs.DATA_STEPS + cs.DATA_DEPTH) * cs.VISION_B
    x = rs.randint(0, 256, (n, cs.DATA_IMG, cs.DATA_IMG, 3), dtype=np.uint8)
    y = rs.randint(0, 100, (n,)).astype(np.int32)
    arms = {}
    for name, hook in hooks.items():
        net = cs.resnet50()
        net.initialize(seed=cs.SEED)
        tr = ShardedTrainer(net, "sgd", loss=cs.vision_ce,
                            optimizer_params=cs.VISION_OPT)
        dl = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(x, y),
                                      batch_size=cs.VISION_B,
                                      pin_memory=True, num_workers=2)
        pf = tr.attach_data_source(DevicePrefetcher(
            dl, depth=cs.DATA_DEPTH, transform=hook))
        d, l = pf.next()
        float(tr.step(d, (l,)))               # the step's capture
        arms[name] = dict(tr=tr, pf=pf, rates=[], waits=[])
    for rnd in range(rounds):
        names = list(arms) if rnd % 2 == 0 else list(arms)[::-1]
        for name in names:
            a = arms[name]

            def step(a=a):
                d, l = a["pf"].next()
                a["waits"].append(a["pf"].last_wait_seconds)
                return a["tr"].step(d, (l,))
            _losses, ms, _mib, _per = cs.timed_steps(
                torch, step, cs.DATA_STEPS, ("images", cs.VISION_B), card,
                f"transform {name}, round {rnd + 1}, ResNet-50 amp")
            a["rates"].append(cs.VISION_B * 1e3 / ms)
    out = {}
    for name, a in arms.items():
        a["pf"].close()
        w = sorted(a["waits"])
        out[name] = {"images_per_s": a["rates"],
                     "input_wait_ms_p50": w[len(w) // 2] * 1e3,
                     "input_wait_ms_max": w[-1] * 1e3,
                     "input_wait_ms": [v * 1e3 for v in a["waits"]]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("transform_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import mxnet_tpu_torch as mx

    card = cs.card_line()
    print(card, flush=True)
    rs = np.random.RandomState(cs.SEED)
    x = torch.from_numpy(rs.randint(
        0, 256, (cs.VISION_B, cs.DATA_IMG, cs.DATA_IMG, 3),
        dtype=np.uint8)).cuda()
    eager = cs.data_transform()
    graphed = Graphed(cs.data_transform())
    call, same = call_cost(torch, {"eager": eager.apply,
                                   "graphed": graphed.apply},
                           x, args.reps, args.rounds)
    print(f"transform alone, a call (host ms, device ms by round): "
          f"{json.dumps(call)}; outputs bit-identical: {same} [{card}]",
          flush=True)
    if not same:
        raise AssertionError("the graphed transform differs from the eager")
    del x
    cs.free(torch)
    # the graphed hook's capture happens here, on this thread, before any
    # feeder runs it
    graphed_hook = Graphed(cs.data_transform())
    x0 = torch.from_numpy(cs.data_images()[0][:cs.VISION_B]).cuda()
    graphed_hook.apply(x0, 0)
    del x0
    mx.amp.init("bfloat16")
    try:
        step = step_cost(torch, mx, cs, {"eager": cs.data_transform(),
                                         "graphed": graphed_hook},
                         args.rounds, card)
    finally:
        mx.amp.reset()
    print(json.dumps({"card": card, "call": call, "call_bit_identical": same,
                      "step_amp": step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
