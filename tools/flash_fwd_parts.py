#!/usr/bin/env python3
"""Take B1's bf16 kernel (``csrc/flash_fwd.cu`` ``flash_fwd_wgmma_kernel``)
apart on the card, to see what its time is made of.

    python3 tools/flash_fwd_parts.py [--mode parts|items|host]

``parts`` (the default) builds the source as it is and copies with one
part of a tile's work removed, each by an edit of the source's text (the
script fails if an edit no longer matches): ``no_softmax`` (P is S as it
is, no mask, max, exponent or sum), ``no_s`` (no S = Q.K^T product),
``no_pv`` (no O += P.V product beside the next tile's S) and
``no_tile`` (every tile skipped: the loads, barriers and epilogue stay).
Each is timed by torch.profiler's device time, the mean of 20 calls with
L2 flushed before each (``chip_smoke.Timer``), at the GPT-2 training
shape (causal B16 T1024 H12 D64), BERT-large's (full B8 T512 H16 D64)
and full B4 T1024 H8 D128.  The copies compute wrong numbers; only their
times are read.

``items`` builds a copy whose first consumer thread stamps
``%globaltimer`` when each item's Q has arrived, when its tiles are done
and when its output store is issued, and reads, at the training and
BERT shapes: the cost of a tile (least squares over the items' tile
counts), the epilogue, the wait for the next item's Q, and the spread of
the blocks' end times (the static schedule's balance).

``host`` reads the host microseconds of one call at B1 T256 H2 D64 with
no wait for the card between calls: the C entry through ctypes, the op's
implementation and the public wrapper, bf16 and float32.

Copies are built under ``build/flash_fwd_parts/`` (git-ignored).  Prints
one JSON line with the readings and the card's name and power limit.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "mxnet_tpu_torch" / "csrc"
OUT = ROOT / "build" / "flash_fwd_parts"
SHAPES = {"train causal B16 T1024 H12 D64": (16, 1024, 12, 64, True),
          "bert full B8 T512 H16 D64": (8, 512, 16, 64, False),
          "full B4 T1024 H8 D128": (4, 1024, 8, 128, False)}


def _edit(src, old, new):
    if src.count(old) != 1:
        raise SystemExit(f"flash_fwd_parts: the source no longer holds "
                         f"{old.strip()[:60]!r} once")
    return src.replace(old, new)


def _cut(src, start, end, repl=""):
    i = src.index(start)
    return src[:i] + repl + src[src.index(end, i):]


def _no_softmax(s):
    return _cut(s, "      auto softmax = [&]() {",
                "      // one branch holds",
                "      auto softmax = [&]() { corr[0] = corr[1] = 1.f; };\n")


def _no_s(s):
    return _edit(s, """      if (neg)
        issue_s<D, true>(sacc, sq, sm + L::k + s * L::kTileKV);
      else
        issue_s<D, false>(sacc, sq, sm + L::k + s * L::kTileKV);
""", "")


def _no_pv(s):
    return _edit(s, """        issue_pv<D>(oacc, p, sm + L::v + pend * L::kTileKV);
        wg_commit();
        turn_pass();""", """        wg_commit();
        turn_pass();""")


def _no_tile(s):
    return _edit(s, "bool run = nq > 0 && !(causal",
                 "bool run = false && !(causal")


PARTS = {"base": lambda s: s, "no_softmax": _no_softmax, "no_s": _no_s,
         "no_pv": _no_pv, "no_tile": _no_tile}

_STAMPS = '''__device__ long long* g_stamps = nullptr;
__device__ __forceinline__ long long stamp_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''


def _items(s):
    """Each item's [Q arrived, tiles done, store issued, tiles] in ns."""
    s = _edit(s, "namespace wg {\n", _STAMPS + "namespace wg {\n")
    s = _edit(s, "    mbar_wait(&q_full[qb], (round / QS) & 1);\n",
              "    mbar_wait(&q_full[qb], (round / QS) & 1);\n"
              "    const int sidx = round * gridDim.x + ((round & 1) ? "
              "gridDim.x - 1 - blockIdx.x : blockIdx.x);\n"
              "    if (g_stamps && ct == 0 && c == 0) {\n"
              "      g_stamps[sidx * 4] = stamp_now();\n"
              "      g_stamps[sidx * 4 + 3] = w.n_kt;\n    }\n")
    s = _edit(s, "    // this warpgroup reads Q no more",
              "    if (g_stamps && ct == 0 && c == 0) "
              "g_stamps[sidx * 4 + 1] = stamp_now();\n"
              "    // this warpgroup reads Q no more")
    s = _edit(s, "      bulk_commit();\n    }\n",
              "      bulk_commit();\n    }\n"
              "    if (g_stamps && ct == 0 && c == 0) "
              "g_stamps[sidx * 4 + 2] = stamp_now();\n")
    return s + ('\nextern "C" int mxt_set_stamps(void* p) {\n'
                '  return cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n')


def _build(names_to_src, nvcc, flags):
    """One nvcc per copy, all at once; {name: loaded library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT / h.name)
    procs = {}
    for name, src in names_to_src.items():
        (OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-o", str(OUT / f"lib{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"flash_fwd_parts: {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        fn = libs[name].mxt_flash_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float, i, p]
        fn.restype = i
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("parts", "items", "host"),
                    default="parts")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_parts: no CUDA device", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.ops import flash as F
    from mxnet_tpu_torch.utils import native

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(cs.SEED)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def inputs(b, t, h, d, dtype=torch.bfloat16):
        q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        return q, k, v, torch.empty_like(q), torch.empty(
            (b * h, 1, t), device=dev)

    def caller(fn, q, k, v, o, lse, causal, code=1):
        b, t, h, d = q.shape
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                          None, o.data_ptr(), lse.data_ptr(), b, t, h, d,
                          int(causal), d ** -0.5, code, stream)

    src = (CSRC / "flash_fwd.cu").read_text()
    result = {}
    if args.mode == "parts":
        libs = _build({n: f(src) for n, f in PARTS.items()}, native._nvcc(),
                      native._FLAGS)
        timer = cs.Timer(torch, dev)
        for tag, (b, t, h, d, causal) in SHAPES.items():
            q, k, v, o, lse = inputs(b, t, h, d)
            row = {}
            for name, lib in libs.items():
                call = caller(lib.mxt_flash_fwd, q, k, v, o, lse, causal)
                if call():
                    raise SystemExit(f"flash_fwd_parts: {name} failed to "
                                     "launch")
                row[name] = timer.device(call, "flash_fwd_wgmma")
                if name == "base":
                    torch.cuda.synchronize()
                    o_ref, lse_ref = F._fwd_plain(q, k, v, None, None,
                                                  causal, d ** -0.5)
                    cs.check(f"{tag} as built", max(cs.maxabs(o, o_ref),
                             cs.maxabs(lse, lse_ref)), cs.TOL_BF16)
            result[tag] = row
    elif args.mode == "items":
        lib = _build({"items": _items(src)}, native._nvcc(),
                     native._FLAGS)["items"]
        lib.mxt_set_stamps.argtypes = [ctypes.c_void_p]
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        for tag, (b, t, h, d, causal) in list(SHAPES.items())[:2]:
            q, k, v, o, lse = inputs(b, t, h, d)
            call = caller(lib.mxt_flash_fwd, q, k, v, o, lse, causal)
            n_qt = (t + 127) // 128
            n_items = b * h * n_qt
            stamps = torch.zeros((n_items, 4), dtype=torch.int64,
                                 device=dev)
            for _ in range(3):
                call()
            lib.mxt_set_stamps(stamps.data_ptr())
            call()
            torch.cuda.synchronize()
            lib.mxt_set_stamps(None)
            a = stamps.cpu().numpy().astype(np.float64)
            a[:, :3] = (a[:, :3] - a[:, 0].min()) / 1e3    # microseconds
            tiles = a[:, 3]
            fit = np.linalg.lstsq(np.stack([tiles, np.ones_like(tiles)], 1),
                                  a[:, 1] - a[:, 0], rcond=None)[0]
            grid = min(n_items, n_sm)
            gaps, ends = [], []
            for blk in range(grid):
                mine = [r * grid + (grid - 1 - blk if r % 2 else blk)
                        for r in range(n_items // grid + 2)]
                mine = [i for i in mine if i < n_items]
                gaps += [a[j, 0] - a[i, 2] for i, j in zip(mine, mine[1:])]
                ends.append(a[mine, 2].max())
            result[tag] = dict(
                us_per_tile=float(fit[0]), us_per_item_loop=float(fit[1]),
                epilogue_us=float(np.mean(a[:, 2] - a[:, 1])),
                next_q_wait_us=float(np.mean(gaps)),
                block_end_us=[float(min(ends)), float(np.mean(ends)),
                              float(max(ends))])
    else:
        fn = native.load("flash_fwd").mxt_flash_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float, i, p]
        fn.restype = i

        def per_call(f, n=500):
            for _ in range(20):
                f()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                f()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            return (t1 - t0) / n * 1e6

        for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
            q, k, v, o, lse = inputs(1, 256, 2, 64, dtype)
            result[str(dtype)] = dict(
                ctypes_us=per_call(caller(fn, q, k, v, o, lse, True, code)),
                impl_us=per_call(lambda: F._flash_fwd_impl(
                    q, k, v, None, None, True, 0.125)),
                wrapper_us=per_call(lambda: F.flash_fwd(
                    q, k, v, causal=True, scale=0.125)))
    print(json.dumps({"mode": args.mode, "card": cs.card_line(),
                      "readings": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
