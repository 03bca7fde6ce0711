"""Time the route to B1 (``ops.flash.flash_fwd``) on the card, for the
tree at ROOT:

    python3 tools/time_flash_route.py ROOT

Two shapes, float32 and causal: B1 T256 H1 D64, where the host's work
per call sets the rate, and phase 3's prefill, B8 T512 H12 D64, where
the kernel does.  For each: ``host_us``, the wall time of 2000 calls
made back to back over their count (the card drained before and after),
and ``ms``, CUDA events around 50 calls over their count.  Routes:
``flash_fwd`` (the public wrapper), and where the tree registers B1 as
the op ``mxnet_tpu_torch::flash_fwd``, also the op called directly and
the op's implementation called without the dispatcher (``impl``, the
work of a wrapper that launches B1 itself).  Prints one line
``ROUTE {json}`` with the card's name and power limit.  To compare two
trees, unpack one with ``git archive`` under ``build/`` (git-ignored)
and run them in turns in one call (parent, change, change, parent)."""
import json
import os
import subprocess
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch  # noqa: E402
from mxnet_tpu_torch.ops import flash as F  # noqa: E402
from mxnet_tpu_torch.utils import native  # noqa: E402

SHAPES = {"host": (1, 256, 1, 64), "prefill": (8, 512, 12, 64)}
HOST_CALLS, EVENT_CALLS = 2000, 50


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def routes(q, k, v, scale):
    out = {"flash_fwd": lambda: F.flash_fwd(q, k, v, causal=True,
                                            scale=scale)}
    if hasattr(F, "_flash_fwd_impl"):
        op = torch.ops.mxnet_tpu_torch.flash_fwd.default
        out["op"] = lambda: op(q, k, v, None, None, True, scale)
        out["impl"] = lambda: F._flash_fwd_impl(q, k, v, None, None, True,
                                                scale)
    return out


def host_us(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / HOST_CALLS * 1e6


def event_ms(fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(EVENT_CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / EVENT_CALLS


def main():
    build_s = native.build(["flash_fwd"])
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"root": root, "build_s": round(build_s, 1), "shapes": {}}
    for tag, shape in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   for _ in range(3))
        scale = shape[3] ** -0.5
        want = F._fwd_plain(q, k, v, None, None, True, scale)[0]
        row = {}
        for name, fn in routes(q, k, v, scale).items():
            got = fn()[0]
            err = (got - want).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"{tag} {name}: max-abs {err}")
            for _ in range(20):      # warm
                fn()
            row[name] = {"host_us": host_us(fn), "ms": event_ms(fn),
                         "max_abs_err": err}
        result["shapes"][tag] = {"shape": list(shape), "routes": row}
    result["card"] = card()
    print("ROUTE " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
