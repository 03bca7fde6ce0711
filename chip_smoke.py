#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and builds the kernels from ``csrc/`` itself.

Phases (any failure exits non-zero and prints no result line):

1. Environment and build: the card's name and power limit (nvidia-smi),
   torch/CUDA versions, and the time to build every kernel (one nvcc
   per source, all at once).
2. Kernels vs their plain PyTorch versions on the card, at the stated
   tolerances, with kernel / plain / library timings (CUDA events, L2
   flushed before each launch) at the shapes the main path gives them.
3. The main path at full width: GPT-2 124M (12 layers, 768 units, 12
   heads, vocab 50257, 1024 positions; random weights from a seed)
   served by ``InferenceEngine`` with paged KV and the paged-attention
   kernel: 8 requests of 300-500 prompt tokens (the 512 seq bucket, so
   prefill runs the flash kernel) and 32 new tokens each.  Both kernels'
   launch counters must move.  The same requests replay through the
   gather read arm; per-step logits of the two arms are held together at
   the model level; the whole phase repeats with int8 KV pages.  Then
   ``torch.profiler`` shows where one prefill and 8 decode steps spend
   their time (wall, device-busy share, top kernels).
4. A ``{"kernels": [...]}`` line, the card line again, and the last
   line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
VOCAB = 50257

# tolerances (max-abs, in float32): float32 kernels reassociate the
# softmax sums only; bf16 rounds inputs and the probability tile; int8
# is held against the plain version's own dequantize of the same pages
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
TOL_INT8 = 1e-4
# full-width logits, kernel read arm vs gather arm over the same pages:
# 12 layers of reassociated attention sums in float32
TOL_LOGITS = 1e-3

# H100 SXM published peaks (dense): HBM bytes/s, float32 on the CUDA
# cores, bf16 on the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# where each kernel's Pallas original lives
REPLACES = {"flash_fwd": "mxnet_tpu/ops/flash.py:100",
            "paged_attention": "mxnet_tpu/ops/paged.py:82"}
SOURCES = {"flash_fwd": "mxnet_tpu_torch/csrc/flash_fwd.cu",
           "paged_attention": "mxnet_tpu_torch/csrc/paged_attention.cu"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def maxabs(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def check(name, err, tol):
    ok = err <= tol
    print(f"  {name}: max_abs_err={err:.3e} tol={tol:g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: max-abs error {err} > {tol}")


class Timer:
    """Mean milliseconds per call by CUDA events, with a 128 MiB buffer
    rewritten before each call so every launch starts from a cold L2."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(32 << 20, dtype=torch.float32,
                                     device=device)

    def __call__(self, fn, iters=20, warm=3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound(bytes_moved, flops, dtype):
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- kernels

def flash_cases(torch, dev, timer, card):
    """B1 against its plain version in every configuration the port
    takes; returns the main-path case's numbers."""
    from mxnet_tpu_torch.ops import flash as F
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def run(tag, b, t, h, d, dtype, causal, seg=False, tol=TOL_F32):
        q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        keep = torch.ones((t, t), dtype=torch.bool, device=dev)
        if causal:
            keep = torch.tril(keep)
        qseg = None
        if seg:
            # packed rows: three documents of ragged lengths per row
            cuts = torch.tensor([t // 3, t // 3 + t // 4], device=dev)
            qseg = (torch.arange(t, device=dev)[:, None] >= cuts).sum(1)
            qseg = qseg.to(torch.int32)[None].expand(b, t).contiguous()
            keep = keep & (qseg[0][:, None] == qseg[0][None, :])
        scale = d ** -0.5
        o, lse = F.flash_fwd(q, k, v, qseg, qseg, causal=causal,
                             scale=scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = F._fwd_plain(q, k, v, qseg, qseg, causal, scale)
        err = max(maxabs(o, o_ref), maxabs(lse, lse_ref))
        check(f"flash_fwd {tag}", err, tol)
        ms = timer(lambda: F.flash_fwd(q, k, v, qseg, qseg, causal=causal,
                                       scale=scale))
        plain_ms = timer(lambda: F._fwd_plain(q, k, v, qseg, qseg, causal,
                                              scale))
        lib_ms = None
        if not seg:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal))
        # bytes: q, k, v read and o written once, lse (and segment ids);
        # operations: two multiply-adds per (query, attended key, lane)
        io_bytes = (4 * b * t * h * d * q.element_size() + b * h * t * 4
                    + (2 * b * t * 4 if seg else 0))
        flops = 4 * d * b * h * int(keep.sum())
        b_ms, b_by = bound(io_bytes, flops, str(dtype).split(".")[1])
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a"
        print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib}, "
              f"bound {b_ms:.4f} ms ({b_by}) [{card}]", flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    print("B1 flash_fwd vs plain:", flush=True)
    run("causal B4 T512 H12 D64 f32", 4, 512, 12, 64, torch.float32, True)
    run("causal B4 T512 H12 D64 bf16", 4, 512, 12, 64, torch.bfloat16, True,
        tol=TOL_BF16)
    run("causal+segments B2 T512 H4 D64 f32", 2, 512, 4, 64, torch.float32,
        True, seg=True)
    run("full B2 T256 H4 D128 f32", 2, 256, 4, 128, torch.float32, False)
    run("causal B1 T256 H2 D256 bf16", 1, 256, 2, 256, torch.bfloat16, True,
        tol=TOL_BF16)
    # the main path's prefill shape: 8 prompts in the 512 bucket, f32
    return run("main-path causal B8 T512 H12 D64 f32", 8, 512, 12, 64,
               torch.float32, True)


def engine_table(lens, max_new, ps, npt):
    """The page table ``InferenceEngine`` builds for requests of prompt
    lengths ``lens``: its own ``PagePool`` of ``len(lens) * npt`` pages
    gives each slot the distinct pages of prompt + ``max_new`` positions,
    and unassigned entries and the parked last row point at the zero
    page (id = pool size).  Returns the (slots + 1, npt) int32 table and
    the pool size."""
    from mxnet_tpu_torch.serving.kv_pages import PagePool
    pool = PagePool(len(lens) * npt, ps)
    table = np.full((len(lens) + 1, npt), pool.scratch, np.int32)
    for i, n in enumerate(lens):
        pages = pool.alloc(pool.pages_for(min(n + max_new, npt * ps)))
        table[i, :len(pages)] = pages
    return table, pool.num_pages


def paged_cases(torch, dev, timer, card, lens):
    """B4 against its plain version; returns the main-path case's
    numbers.  ``lens`` are the main path's prompt lengths."""
    from mxnet_tpu_torch.ops import paged as P
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    rs = np.random.RandomState(SEED + 1)

    def case(tag, b, tq, h, d, ps, npt, dtype, quant=False, layout=None,
             qpos=None, tol=TOL_F32):
        """``layout`` is ``engine_table``'s (table, pool size); by default
        distinct pages in random order, the last row parked on the zero
        page."""
        if layout is None:
            n_pool = b * npt
            table = rs.permutation(n_pool).astype(np.int32).reshape(b, npt)
            table[-1] = n_pool
        else:
            table, n_pool = layout
        table = torch.from_numpy(table).to(dev)
        # the model's pool layout: pages, the zero page, a trash page
        n_pages, zero = n_pool + 2, n_pool
        kf = torch.randn((n_pages, ps, h, d), generator=g, device=dev) * 2
        vf = torch.randn((n_pages, ps, h, d), generator=g, device=dev) * 2
        kf[zero] = 0
        vf[zero] = 0
        q = torch.randn((b, tq, h, d), generator=g, device=dev).to(dtype)
        if qpos is None:
            base = torch.randint(0, npt * ps - tq, (b, 1), generator=g,
                                 device=dev)
            qpos = base + torch.arange(tq, device=dev)[None]
        qpos = qpos.to(torch.int32).contiguous()
        ks = vs = None
        if quant:
            kp, ks = P.kv_quantize(kf)
            vp, vs = P.kv_quantize(vf)
        else:
            kp, vp = kf.to(dtype), vf.to(dtype)
        out = P.paged_attention(q, kp, vp, table, qpos, k_scale=ks,
                                v_scale=vs)
        torch.cuda.synchronize()
        ref = P._paged_plain(q, kp, vp, table, qpos, ks, vs, d ** -0.5)
        err = maxabs(out, ref)
        check(f"paged_attention {tag}", err, tol)
        if not bool(torch.isfinite(out[-1]).all()):
            raise AssertionError("parked zero-page row is not finite")
        ms = timer(lambda: P.paged_attention(q, kp, vp, table, qpos,
                                             k_scale=ks, v_scale=vs))
        plain_ms = timer(lambda: P._paged_plain(q, kp, vp, table, qpos, ks,
                                                vs, d ** -0.5))
        # bytes: every distinct physical page holding a key <= some
        # row's last query read once (k and v, plus their scales when
        # int8; the zero page once however many rows walk it), q read,
        # out written, table and positions; operations: two multiply-adds
        # per (query, attended key, lane)
        qp = qpos.long().clamp(max=npt * ps - 1)
        walked = (qp.max(dim=1).values // ps + 1).tolist()
        pages = torch.cat([table[r, :n] for r, n in enumerate(walked)]) \
            .unique().numel()
        per_pos = h * d * kp.element_size() + (h * 4 if quant else 0)
        io_bytes = (2 * pages * ps * per_pos + 2 * q.numel() *
                    q.element_size() + table.numel() * 4 + qpos.numel() * 4)
        flops = 4 * d * h * int((qp + 1).sum())
        b_ms, b_by = bound(io_bytes, flops, "float32")
        print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) [{card}]", flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

    print("B4 paged_attention vs plain:", flush=True)
    case("decode B8 H12 D64 ps16 P64 f32", 8, 1, 12, 64, 16, 64,
         torch.float32)
    case("decode B8 H12 D64 ps16 P64 int8", 8, 1, 12, 64, 16, 64,
         torch.float32, quant=True, tol=TOL_INT8)
    case("decode B8 H12 D64 ps16 P64 bf16", 8, 1, 12, 64, 16, 64,
         torch.bfloat16, tol=TOL_BF16)
    case("chunk Tq16 B4 H12 D64 ps16 P64 f32", 4, 16, 12, 64, 16, 64,
         torch.float32)
    # the main path's decode step halfway through its 32 new tokens: 8
    # slots on the engine's page layout + the parked scratch row (pos =
    # Tmax walks all 64 zero-page entries), 512 pages, f32
    npt = 64
    qpos = torch.tensor([[n + 16] for n in lens] + [[npt * 16]], device=dev)
    return case("main-path decode B9 H12 D64 ps16 P64 f32", 9, 1, 12, 64,
                16, npt, torch.float32, layout=engine_table(lens, 32, 16, npt),
                qpos=qpos)


# ------------------------------------------------------------ main path

def make_prompts():
    rs = np.random.RandomState(SEED)
    return [rs.randint(0, VOCAB, (int(n),)).astype(np.int32)
            for n in rs.randint(300, 501, size=8)]


def serve(torch, net, prompts, card, **kw):
    from mxnet_tpu_torch.ops import flash, paged
    from mxnet_tpu_torch.serving import InferenceEngine
    eng = InferenceEngine(net, kv_layout="paged", num_slots=8, max_batch=8,
                          page_size=16, seq_buckets=(64, 128, 256, 512),
                          **kw)
    n_warm = eng.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.flash_fwd.launches = 0
    paged.paged_attention.launches = 0
    t0 = time.monotonic()
    futs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.start()
    outs = [f.result(600) for f in futs]
    wall = time.monotonic() - t0
    launches = {"flash_fwd": flash.flash_fwd.launches,
                "paged_attention": paged.paged_attention.launches}
    eng.stop()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    s = eng.stats()
    for p, o in zip(prompts, outs):
        if o.shape != (len(p) + 32,) or not np.array_equal(o[:len(p)], p) \
                or o.min() < 0 or o.max() >= VOCAB:
            raise AssertionError("served sequence has the wrong shape or "
                                 "out-of-vocab tokens")
    gen = s["counters"]["tokens_generated"]
    arm = kw.get("paged_attention"), kw.get("kv_quant")
    print(f"  serve arm={arm}: warmup shapes {n_warm}, {gen} tokens in "
          f"{wall:.3f} s = {gen / wall:.1f} tokens/s, TTFT p50 "
          f"{s['latency']['ttft']['p50'] * 1e3:.1f} ms, peak memory "
          f"{peak:.0f} MiB, launches {launches} [{card}]", flush=True)
    return outs, launches


class PagedBatch:
    """One engine-shaped paged batch of the 8 prompts at the model level:
    the engine's page table (``engine_table``), the prompts padded to the
    512 bucket with their lengths and slot ids, and the decode positions
    (the parked row at ``max_length``)."""

    PS = 16

    def __init__(self, torch, net, prompts):
        self.torch, self.net, dev = torch, net, net.device
        s, npt = len(prompts), net.max_length // self.PS
        lens = np.array([len(p) for p in prompts], np.int32)
        table, self.n_pool = engine_table(lens, 32, self.PS, npt)
        toks = np.zeros((s, 512), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        self.table, self.toks, self.lens = (torch.from_numpy(a).to(dev)
                                            for a in (table, toks, lens))
        self.sidx = torch.arange(s, dtype=torch.int32, device=dev)
        self.pos = np.full((s + 1,), net.max_length, np.int32)
        self.pos[:s] = lens

    def caches(self, kv_quant=None):
        return self.net.init_page_cache(self.n_pool + 1, self.PS,
                                        kv_quant=kv_quant)

    def prefill(self, caches, kernel):
        logits, _ = self.net.prefill_slots(
            self.toks, self.lens, caches, self.sidx, page_table=self.table,
            paged_kernel=kernel)
        return logits

    def decode(self, tok, caches, kernel):
        """One decode step of ``tok`` (slots + 1,) at the current
        positions; the caller advances ``pos``."""
        dev = self.net.device
        logits, _ = self.net.decode_step(
            self.torch.from_numpy(tok).to(dev), caches,
            self.torch.from_numpy(self.pos).to(dev), page_table=self.table,
            paged_kernel=kernel)
        return logits


def logits_parity(torch, net, prompts, kv_quant):
    """Per-step logits of the kernel and gather read arms over the same
    page tables and tokens: one prefill of all 8 prompts in the 512
    bucket, then 8 decode steps."""
    pb = PagedBatch(torch, net, prompts)
    s = len(prompts)
    caches = {arm: pb.caches(kv_quant) for arm in ("kernel", "gather")}
    logits = {arm: pb.prefill(caches[arm], arm == "kernel")
              for arm in caches}
    worst = maxabs(logits["kernel"], logits["gather"])
    tok = np.zeros((s + 1,), np.int32)
    for _step in range(8):
        tok[:s] = logits["kernel"][:s].argmax(-1).cpu().numpy()
        for arm in caches:
            logits[arm] = pb.decode(tok, caches[arm], arm == "kernel")
        worst = max(worst, maxabs(logits["kernel"][:s],
                                  logits["gather"][:s]))
        pb.pos[:s] += 1
    check(f"logits kernel vs gather arm (kv_quant={kv_quant})", worst,
          TOL_LOGITS)
    return worst


def _device_rows(torch, prof):
    """(name, device ms) of the kernels and copies a profile recorded."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3))
    return sorted(rows, key=lambda r: -r[1])


def profile_steps(torch, net, prompts, card):
    """Where the main path's time goes: torch.profiler over one prefill
    of the 8 prompts in the 512 bucket, then 8 decode steps of the
    kernel arm, each ending in a host read of its tokens as the
    engine's steps do.  Prints wall time, device-busy time and share,
    and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    pb = PagedBatch(torch, net, prompts)
    s = len(prompts)
    caches = pb.caches()
    last = np.zeros((s + 1,), np.int32)

    def prefill():
        last[:s] = pb.prefill(caches, True).argmax(-1).cpu().numpy()

    def decode():
        for _ in range(8):
            last[:] = pb.decode(last, caches, True).argmax(-1).cpu().numpy()
            pb.pos[:s] += 1

    print("where the time goes (kernel arm, f32):", flush=True)
    for name, fn in (("prefill B8 T512", prefill), ("8 decode steps", decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = _device_rows(torch, prof)
        busy = sum(ms for _k, ms in rows)
        if not rows:
            print(f"  {name}: wall {wall:.3f} ms; the profiler recorded "
                  f"no device time [{card}]", flush=True)
            continue
        print(f"  {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"({busy / wall:.1%}; idle {1 - busy / wall:.1%}) [{card}]",
              flush=True)
        for key, ms in rows[:8]:
            print(f"    {ms:9.3f} ms {ms / busy:6.1%}  {key[:100]}",
                  flush=True)


def main_path(torch, card, prompts):
    from mxnet_tpu_torch.models import get_gpt2
    net = get_gpt2("gpt2_124m", dropout=0.0)
    net.initialize(seed=SEED)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"GPT-2 124M: {n_params} parameters on {net.device}", flush=True)
    print(f"  prompt lengths {[len(p) for p in prompts]}", flush=True)
    outs, launches = serve(torch, net, prompts, card,
                           paged_attention="kernel")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
    outs_g, _ = serve(torch, net, prompts, card, paged_attention="gather")
    same = np.mean([np.mean(a[len(p):] == b[len(p):])
                    for a, b, p in zip(outs, outs_g, prompts)])
    print(f"  greedy tokens identical kernel vs gather arm: {same:.4f}",
          flush=True)
    logits_parity(torch, net, prompts, None)
    outs_q, _ = serve(torch, net, prompts, card, paged_attention="kernel",
                      kv_quant="int8")
    same_q = np.mean([np.mean(a[len(p):] == b[len(p):])
                      for a, b, p in zip(outs, outs_q, prompts)])
    print(f"  greedy tokens identical int8 vs f32 pages: {same_q:.4f}",
          flush=True)
    logits_parity(torch, net, prompts, "int8")
    profile_steps(torch, net, prompts, card)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.utils import native
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    secs = native.build()
    print(f"kernel build: {secs:.1f} s", flush=True)
    for name in native.KERNELS:
        print(f"--- ptxas {name}:\n{native.build_log(name).strip()}")
    timer = Timer(torch, dev)
    prompts = make_prompts()
    record = {"flash_fwd": flash_cases(torch, dev, timer, card),
              "paged_attention": paged_cases(torch, dev, timer, card,
                                             [len(p) for p in prompts])}
    launches = main_path(torch, card, prompts)
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    **record[name]) for name in native.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
