#!/usr/bin/env python3
"""Time B1 (``ops.flash.flash_fwd``) in bf16 at the main paths' shapes
for the ``mxnet_tpu_torch`` package of another tree, so that two trees
can be compared on one card in one call.

    python3 tools/time_flash_fwd.py --root DIR [--reps 3]

DIR is the root of a checkout (this repository's root, or an unpacked
``git archive`` of another commit).  The script builds DIR's forward
kernel, checks it against DIR's plain version at each shape, then
``--reps`` times reads the mean of 20 calls two ways: by CUDA events
(``chip_smoke.Timer``, L2 flushed before each call, the wrapper's host
work included) and by torch.profiler's device time (the kernel alone),
and the same for ``scaled_dot_product_attention`` on the same inputs.
Shapes: the GPT-2 training path's causal B16 T1024 H12 D64 and
BERT-large's full B8 T512 H16 D64 (phases 7 and 11 under amp), and full
B4 T1024 H8 D128.  It prints one JSON line with every reading, the
kernel names the profiler saw and the card's name and power limit.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = {"train causal B16 T1024 H12 D64": (16, 1024, 12, 64, True),
          "bert full B8 T512 H16 D64": (8, 512, 16, 64, False),
          "full B4 T1024 H8 D128": (4, 1024, 8, 128, False)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose mxnet_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    # this tree's chip_smoke (timer, tolerances); its imports of the
    # package happen at call time, so they resolve under ``root``
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("time_flash_fwd: no CUDA device", file=sys.stderr)
        return 2
    import mxnet_tpu_torch
    if Path(mxnet_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"time_flash_fwd: imported "
                         f"{mxnet_tpu_torch.__file__}, not the package "
                         f"under {root}")
    from mxnet_tpu_torch.ops import flash as F
    from mxnet_tpu_torch.utils import native
    native.build(("flash_fwd",))

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(cs.SEED)
    timer = cs.Timer(torch, dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    result = {}
    for tag, (b, t, h, d, causal) in SHAPES.items():
        q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        o, lse = F.flash_fwd(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = F._fwd_plain(q, k, v, None, None, causal, scale)
        err = max(cs.maxabs(o, o_ref), cs.maxabs(lse, lse_ref))
        cs.check(f"flash_fwd {tag} bf16", err, cs.TOL_BF16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        calls = {"kernel": lambda: F.flash_fwd(q, k, v, causal=causal,
                                               scale=scale),
                 "sdpa": lambda: sdpa(qt, kt, vt, is_causal=causal)}
        reads = {f"{how}_{c}": [] for how in ("events", "device")
                 for c in calls}
        names = {}
        for _ in range(args.reps):
            for c, fn in calls.items():
                reads[f"events_{c}"].append(timer(fn))
                rows = [r for r in timer.rows(fn) if "flash" in r[0]
                        or "fmha" in r[0] or "attention" in r[0]]
                reads[f"device_{c}"].append(
                    sum(ms for _n, ms in rows) / 20 if rows else None)
                names[c] = sorted({n.rsplit("(", 1)[0][:120] for n, _ms in rows})
        result[tag] = dict(max_abs_err=err, ms=reads, kernels=names)
    print(json.dumps({"root": str(root), "card": cs.card_line(),
                      "shapes": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
