#!/usr/bin/env python3
"""BERT-large's step-1 gradients through the flash kernels, against the
reference attention path in float32 and in float64, beside the plain
backward fed the reference's delta from B1's O and from an exact O, and
the host cost of the amp Gluon step under each ``remat`` form.

    python3 tools/bert_attention_grads.py [--batch 4] [--steps 5]

Precision: one set of seeded weights (``chip_smoke.bert_net``, dropout
0), ``chip_smoke.bert_batch`` without ``valid_length``, the MLM + NSP
loss in the parameters' dtype; the gradients of (a) the kernels as the
training backward runs them (B2 computes each row's delta from its own
P and dP), B1's forward with the plain backward (``flash._bwd_tiles``
and ``flash._dkv_plain``, float32 with TF32 off) fed the reference's
delta = rowsum(dO * O) with O (b) B1's or (c) the plain forward's
(float32 FMAs), (d) ``impl='ref'`` attention in float32 and (e) in
float64.  For each pair
it prints the worst leaf's max-abs error over its own max-abs (a
``k_proj.bias`` over the largest gradient: the softmax cancels it),
the median leaf, and the loss's relative gap.

Host cost: the Gluon loop of ``chip_smoke.py`` phase 11 (b) under
``amp.init('bfloat16')`` at batch 8 x 512 with ``remat`` 'dots', True
and False, one net in two rounds of opposite order: ms/step and the
process's CPU time a step (every thread, sync waits included) over
``--steps`` steps after a warm-up, the peak
memory of the step and of its forward and backward alone (there
'dots' must peak between True and False), and one profiled
step's device busy time and idle share, with the CPU ops that took the
most self time under 'dots'.  Needs one CUDA device; prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _loss(outs, mlm, nsp):
    m, n = outs
    lm = m.logsumexp(-1) - m.gather(-1, mlm.long()[..., None])[..., 0]
    ln = n.logsumexp(-1) - n.gather(-1, nsp.long()[:, None])[:, 0]
    return (lm.mean(-1) + ln).mean()


def precision(torch, cs, batch):
    from mxnet_tpu_torch.base import training_mode
    from mxnet_tpu_torch.ops import flash
    net = cs.bert_net(0.0)
    dev = net.device
    toks, types, _v, pos, mlm, nsp = (torch.from_numpy(a).to(dev)
                                      for a in cs.bert_batch(batch))
    names = [n for n, _ in net.named_parameters()]
    own_bwd = flash._FlashAttention.backward

    def delta_from_o(fwd, ctx, do):
        # O recomputed by ``fwd`` (B1 repeats bit for bit) and rowsum(dO *
        # O), the reference's delta, fed to the plain backward
        q, k, v, q_seg, kv_seg, lse = ctx.saved_tensors
        b, t, h, _d = q.shape
        o = fwd(q, k, v, q_seg, kv_seg, ctx.causal, ctx.scale)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .reshape(b * h, 1, t).contiguous()
        args = (q, k, v, do, lse, delta, q_seg, kv_seg, ctx.causal,
                ctx.scale)
        _p, ds, _delta = flash._bwd_tiles(*args)
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)
        return (dq, *flash._dkv_plain(*args), None, None, None, None)

    b1_o = functools.partial(delta_from_o, lambda *a: flash.flash_fwd(
        *a[:5], causal=a[5], scale=a[6])[0])
    exact_o = functools.partial(delta_from_o,
                                lambda *a: flash._fwd_plain(*a)[0])
    runs, arms = {}, (("kernels", own_bwd), ("B1's O, plain backward", b1_o),
                      ("exact O, plain backward", exact_o))
    for tag, bwd in arms + (("ref f32", own_bwd), ("ref f64", own_bwd)):
        if tag == "ref f64":
            net.cast("float64")
        flash._FlashAttention.backward = staticmethod(bwd)
        try:
            impl = "ref" if tag.startswith("ref") else "auto"
            with cs.attention_impl(impl), training_mode(True):
                loss = _loss(net(toks, types, None, pos), mlm, nsp)
                grads = torch.autograd.grad(loss, list(net.parameters()))
        finally:
            flash._FlashAttention.backward = own_bwd
        runs[tag] = (float(loss.detach()), [g.double() for g in grads])
        del loss, grads
    pairs = [(a, ref) for ref in ("ref f32", "ref f64") for a, _ in arms]
    for a, b in pairs + [("ref f32", "ref f64")]:
        errs = cs.grad_errors(names, runs[a][1], runs[b][1])
        worst = int(np.argmax(errs))
        gap = abs(runs[a][0] - runs[b][0]) / abs(runs[b][0])
        print(f"  {a} vs {b}: worst {names[worst]} {errs[worst]:.3e}, "
              f"median leaf {float(np.median(errs)):.3e}, loss "
              f"{gap:.3e}", flush=True)
    del net, runs
    cs.free(torch)


def host_cost(torch, cs, card, steps):
    """The amp Gluon step under each ``remat``, one net and trainer for
    all, in two rounds of opposite order (the host's speed drifts within
    a run): ms and CPU ms a step, the peaks, one profiled step each."""
    import mxnet_tpu_torch as mx
    from torch.profiler import ProfilerActivity, profile
    toks, types, _v, pos, mlm, nsp = cs.bert_batch()
    peaks = {}
    try:
        mx.amp.init("bfloat16")
        net = cs.bert_net(cs.BERT_DROPOUT)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": cs.BERT_LR})
        x = [mx.nd.array(a, dtype="int32")
             for a in (toks, types, pos, mlm, nsp)]

        def fwd_bwd():
            with mx.autograd.record():
                loss = cs.bert_loss(net(x[0], x[1], None, x[2]), x[3], x[4])
            loss.backward()
            return loss

        def step():
            loss = fwd_bwd()
            trainer.step(cs.BERT_B)
            return loss

        for order in (("dots", True, False), (False, True, "dots")):
            for remat in order:
                net.backbone._remat = remat
                step()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0, cpu0 = time.monotonic(), time.process_time()
                for _ in range(steps):
                    step()
                torch.cuda.synchronize()
                ms = (time.monotonic() - t0) / steps * 1e3
                cpu = (time.process_time() - cpu0) / steps * 1e3
                mib = torch.cuda.max_memory_allocated() / 2 ** 20
                # the activations' peak: forward and backward alone
                # (Adam's update, which peaks alike in every arm, left out)
                torch.cuda.reset_peak_memory_stats()
                fwd_bwd()
                torch.cuda.synchronize()
                peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 20
                line = (f"  amp Gluon step B{cs.BERT_B} remat={remat!r}: "
                        f"{ms:.1f} ms/step, host CPU {cpu:.1f} ms/step, "
                        f"peak {mib:.0f} MiB (forward and backward "
                        f"{peaks[remat]:.0f})")
                if order[0] != "dots":
                    print(line + f" [{card}]", flush=True)
                    continue
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                busy = sum(t for _k, t in cs._device_rows(torch, prof))
                print(f"{line}; profiled wall {wall:.1f} ms, device busy "
                      f"{busy:.1f} ms (idle {1 - busy / wall:.1%}) [{card}]",
                      flush=True)
                if remat == "dots":
                    rows = sorted(prof.key_averages(),
                                  key=lambda e: -e.self_cpu_time_total)[:8]
                    for e in rows:
                        print(f"    cpu {e.self_cpu_time_total / 1e3:8.2f} "
                              f"ms x{e.count:6d}  {e.key[:70]}", flush=True)
    finally:
        mx.amp.reset()
    del trainer, net
    cs.free(torch)
    between = peaks[True] <= peaks["dots"] <= peaks[False]
    print(f"  forward and backward peaks: remat=True {peaks[True]:.0f} <= "
          f"'dots' {peaks['dots']:.0f} <= False {peaks[False]:.0f} MiB: "
          f"{'ok' if between else 'FAIL'} [{card}]", flush=True)
    if not between:
        raise AssertionError("remat='dots' does not peak between True and "
                             "False")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bert_attention_grads: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mxnet_tpu_torch.utils import native
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    native.build()
    print(f"BERT-large step-1 gradients, batch {args.batch} x {cs.BERT_T}, "
          f"dropout 0, no valid_length [{card}]:", flush=True)
    precision(torch, cs, args.batch)
    host_cost(torch, cs, card, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
