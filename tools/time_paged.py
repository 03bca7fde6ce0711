#!/usr/bin/env python3
"""Time B4 (paged attention) at ``chip_smoke.py``'s main-path decode step
for the ``mxnet_tpu_torch`` package of another tree, so that two trees
can be compared on one card in one call.

    python3 tools/time_paged.py --root DIR [--reps 5]

DIR is the root of a checkout (this repository's root, or an unpacked
``git archive`` of another commit).  The script builds DIR's
paged-attention kernel, checks it against DIR's plain version, then
``--reps`` times reads the mean of 20 calls two ways, each with the
parked scratch row and without it: by CUDA events (``chip_smoke.Timer``,
the wrapper's host work included) and by torch.profiler's device time
(the kernels alone).  The inputs are the main path's: 8 slots on the
engine's page table at their prompt lengths + 16, the parked row at
pos = 1024, H12 D64, 16-position pages, float32.  It prints one JSON line
with every reading and the card's name and power limit.  Needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose mxnet_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    # this tree's chip_smoke (timer, page table, prompts); its imports of
    # the package happen at call time, so they resolve under ``root``
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("time_paged: no CUDA device", file=sys.stderr)
        return 2
    import mxnet_tpu_torch
    if Path(mxnet_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"time_paged: imported {mxnet_tpu_torch.__file__}, "
                         f"not the package under {root}")
    from mxnet_tpu_torch.ops import paged as P
    from mxnet_tpu_torch.utils import native
    native.build(("paged_attention",))

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(cs.SEED + 1)
    lens = [len(p) for p in cs.make_prompts()]
    n, npt, ps, h, d = len(lens), 64, 16, 12, 64
    table, n_pool = cs.engine_table(lens, 32, ps, npt)
    table = torch.from_numpy(table).to(dev)
    # the model's pool layout: pages, the zero page, a trash page
    kp = torch.randn((n_pool + 2, ps, h, d), generator=g, device=dev) * 2
    vp = torch.randn((n_pool + 2, ps, h, d), generator=g, device=dev) * 2
    kp[n_pool] = 0
    vp[n_pool] = 0
    q = torch.randn((n + 1, 1, h, d), generator=g, device=dev)
    qpos = torch.tensor([[x + 16] for x in lens] + [[npt * ps]],
                        dtype=torch.int32, device=dev)
    rows = {"with": (q, table, qpos),
            "without": (q[:n].contiguous(), table[:n].contiguous(),
                        qpos[:n].contiguous())}
    out = P.paged_attention(q, kp, vp, table, qpos)
    torch.cuda.synchronize()
    err = cs.maxabs(out, P._paged_plain(q, kp, vp, table, qpos, None, None,
                                        d ** -0.5))
    cs.check("paged_attention main-path decode B9 H12 D64 ps16 P64 f32", err,
             cs.TOL_F32)

    timer = cs.Timer(torch, dev)
    reads = {f"{how}_{row}": [] for how in ("events", "device")
             for row in rows}
    for _ in range(args.reps):
        for row, (q_, t_, p_) in rows.items():
            def call(q_=q_, t_=t_, p_=p_):
                return P.paged_attention(q_, kp, vp, t_, p_)
            reads[f"events_{row}"].append(timer(call))
            reads[f"device_{row}"].append(timer.device(call, "paged_"))
    print(json.dumps({"root": str(root), "card": cs.card_line(),
                      "max_abs_err": err, "ms": reads}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
