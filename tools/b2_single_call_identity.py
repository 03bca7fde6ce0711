#!/usr/bin/env python3
"""B2's single call (``mxt_flash_dq``, its own delta) against another
tree's build of ``csrc/flash_bwd.cu``, bit for bit, on the card.

A kernel change that adds modes to B2 must leave the single call's
output unchanged.  Unpack the other tree (for example the parent commit,
``git archive <commit> mxnet_tpu_torch/csrc | tar -x -C build/parent``)
and run from the repository root:

    python3 tools/b2_single_call_identity.py --other build/parent

It builds the other tree's ``flash_bwd.cu`` with the port's nvcc flags,
launches both libraries' ``mxt_flash_dq`` on the same inputs (float32
and bf16, D = 64, 128 and 256, causal, full and packed segment ids) and
prints, per case, whether dQ and delta are bit-identical, and the card.
Exits non-zero if any case differs.
"""
import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mxnet_tpu_torch.ops import flash as F  # noqa: E402
from mxnet_tpu_torch.utils import native  # noqa: E402

CASES = [(8, 512, 12, 64, torch.float32, True, False),
         (8, 512, 12, 64, torch.float32, False, False),
         (4, 512, 12, 64, torch.bfloat16, True, False),
         (2, 256, 4, 128, torch.float32, False, True),
         (2, 256, 4, 256, torch.float32, True, False),
         (2, 256, 4, 256, torch.float32, False, True)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--other", required=True,
                    help="root of the other tree (holds mxnet_tpu_torch/)")
    args = ap.parse_args()
    native.build(("flash_bwd",))
    lib = os.path.join(args.other, "libflash_bwd_other.so")
    flags = [f for f in native._FLAGS if f != "-Xptxas=-v"]
    subprocess.run([native._nvcc(), *flags, "-o", lib, os.path.join(
        args.other, "mxnet_tpu_torch", "csrc", "flash_bwd.cu")], check=True)
    fn = ctypes.CDLL(lib).mxt_flash_dq
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float, i, p]
    fn.restype = i
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    same_all = True
    for b, t, h, d, dt, causal, seg in CASES:
        g = torch.Generator(device="cpu").manual_seed(0)
        q, k, v, do = (torch.randn(b, t, h, d, generator=g).to(dev, dt)
                       for _ in range(4))
        qs = None
        if seg:
            qs = torch.sort(torch.randint(0, 3, (b, t), generator=g), 1)[0]
            qs = qs.to(dev, torch.int32).contiguous()
        scale = d ** -0.5
        _o, lse = F.flash_fwd(q, k, v, qs, qs, causal=causal, scale=scale)
        dq, delta = F.flash_dq(q, k, v, do, lse, qs, qs, causal=causal,
                               scale=scale)
        odq, odelta = torch.empty_like(dq), torch.empty_like(delta)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), odelta.data_ptr(),
                 qs.data_ptr() if qs is not None else None,
                 qs.data_ptr() if qs is not None else None, odq.data_ptr(),
                 b, t, h, d, int(causal), scale, F._DTYPE_CODE[dt],
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        same = err == 0 and torch.equal(dq, odq) and torch.equal(delta,
                                                                 odelta)
        same_all &= same
        print(f"B{b} T{t} H{h} D{d} {str(dt).split('.')[1]} causal={causal}"
              f" segments={seg}: bit-identical {same} [{card}]")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
