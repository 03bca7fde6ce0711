"""Chaos sweep on the PyTorch port: execute the resilience fault matrix
against ``mxnet_tpu_torch`` and write a JSON report.

The counterpart of ``tools/chaos_sweep.py``: the same scenarios (same
function names, scenario ``name``s, ``detail`` keys and report schema),
run through the port's engines, fleets, trainers and loops.

- serving scenarios (fresh engine per scenario): scheduler crash, hung
  step, retryable fault, non-retryable step fault, queue overflow,
  request deadline, SIGTERM drain, fault-free control — the invariant
  checked is *no stranded futures*: every submitted request resolves
  with a result or a typed error within its timeout; then the prefix,
  paged, spill, quant, spec, exporter and overload storms, sharded
  parity (a 2-rank mesh engine over gloo against a one-device engine),
  and the fleet's replica kill, rolling restart, retry storm, gray
  replica, flash spike and disaggregated prefill/decode kills;
- training scenarios: kill/resume determinism (K kills at distinct
  steps; final params must match the fault-free run bit for bit),
  kill-mid-checkpoint-commit, checkpoint corruption, the NaN storm and
  persistent-NaN rewind, bad-batch quarantine and the input stall;
- the forensics check (every scenario left a flight-recorder bundle),
  and with ``--corroborate`` the cold-site probes and the diff of the
  port's guard map against the lock witness's acquisitions.

What the port adds to the reference's surface, and nothing else:

- ``--device``: the sweep runs on the current CUDA device unless
  ``--device cpu`` is given; without a card and without ``--device cpu``
  it raises (it never falls back).  ``--layers`` sets the card's depth.
- The card's lengths.  On the CPU the nets are the reference's tiny
  GPT-2 (vocab 61, 16 units, 2 heads, 32 positions) at its lengths
  (seq bucket 8, pages of 8 tokens), so the verdicts and counters equal
  the reference sweep's.  At that width the port's attention takes the
  plain path everywhere (head dim 8), so on the card the serving nets
  are GPT-2 124M at full width (768 units, 12 heads of 64, vocab 50257,
  1024 positions) with seeded random weights, float32, TF32 off, cut to
  ``--layers`` layers (default 2), and every token length of a serving
  scenario (prompts, shared prefixes, seq bucket, page size, positions)
  is 32 times the CPU's: prefills run at a 256-token bucket through
  B1 (flash forward) and paged decode through B4.  Request counts, new
  tokens and page counts stay the reference's.
- The training scenarios' model on the card: GPT-2 at full width (768
  units, 12 heads of 64), one layer, vocab 512, over sequences of 256
  tokens (batch 2), so each step runs B1-B3; the vocabulary and depth
  are cut so that the ~35 checkpoint commits of the training scenarios
  stay small.  ``bad_batch_quarantine`` keeps the reference's MLP on
  both devices: a poisoned batch is a float batch.
- The card's engines run their programs eagerly (``_graphs = False``),
  to keep the matrix inside its time on the card.  A request there takes 5-10x the CPU's
  (32x the tokens), so ``gray_replica``'s slow replica sleeps 0.5 s a
  decode step (0.1 s on the CPU) and its probation is 5 s (1 s), to stay
  an outlier over the router's 3x bar until the fault lifts.
- The report also records the kernels' launch counts
  (``ops/launches.py``) over the serving and the training scenarios:
  ``serve``/``train`` those of the traffic under test, and
  ``serve_aside``/``train_aside`` those made while a fault-free
  reference or an engine's warm-up ran.

Usage::

    python tools/chaos_sweep_torch.py --device cpu --out chaos.json
    python tools/chaos_sweep_torch.py --corroborate --kills 2 --steps 6

Exit code 0 iff every scenario passed.  Imports the port and the
stdlib-only ``tools/obs_bundle.py`` (and numpy-only ``tools/loadgen.py``)
and nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

_TOOLS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TOOLS)
sys.path.insert(0, _REPO)


# ----------------------------------------------------------------- config

class SweepConfig:
    """Where the sweep runs and at what size (see the module docstring)."""

    def __init__(self, device="cuda", layers=2):
        card = device == "cuda"
        self.device = device
        self.scale = 32 if card else 1
        self.vocab = 50257 if card else 61
        self.units = 768 if card else 16
        self.heads = 12 if card else 2
        self.layers = int(layers) if card else 1
        self.max_length = 1024 if card else 32
        # paged_storm's poisoned position and the prompt that decodes
        # across it; every other prompt (with its padded chunk) stays
        # below it
        self.nan_prompt, self.nan_pos = (512, 518) if card else (6, 20)
        self.host_pool_bytes = (512 << 20) if card else (32 << 20)
        # gray_replica's delay a decode step and its probation: the
        # delay ~10x a healthy replica's request on the CPU's tiny net;
        # the card's requests (32x the tokens, three engines' host work)
        # take 0.16-0.35 s, so there 0.1 s a step stays under the
        # router's 3x outlier bar, and a 1 s probation ends while the
        # fault is still on (a wave waits ~1.1 s for the slow replica)
        self.gray_delay, self.gray_probation = (0.5, 5.0) if card \
            else (0.1, 1.0)
        # training: GPT-2 over 256-token sequences on the card, the
        # reference's MLP on the CPU
        self.train_gpt = card
        self.train_cfg = dict(vocab_size=512, units=768, num_layers=1,
                              num_heads=12, max_length=256, dropout=0.0)
        self.train_b, self.train_t = 2, 256

    def as_dict(self):
        return {"device": self.device, "length_scale": self.scale,
                "vocab": self.vocab, "units": self.units,
                "heads": self.heads, "layers": self.layers,
                "max_length": self.max_length,
                "training": ({"model": "gpt2", **self.train_cfg,
                              "batch": self.train_b,
                              "seq_len": self.train_t}
                             if self.train_gpt else {"model": "mlp"})}


CFG = SweepConfig()


def configure(device="cuda", layers=2) -> SweepConfig:
    """Set the sweep's device and sizes; 'cuda' needs a card."""
    global CFG
    import torch
    if device not in ("cpu", "cuda"):
        raise ValueError(f"--device must be 'cpu' or 'cuda', got "
                         f"{device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "chaos_sweep_torch: no CUDA device; pass --device cpu to "
                "run the sweep on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    CFG = SweepConfig(device, layers)
    return CFG


def _L(n):
    """A token length of the reference's sweep at this device's scale."""
    return int(n) * CFG.scale


def _toks(rs, n):
    """``n`` (already scaled) random token ids, drawn as the reference's
    ``rs.randint(0, 61, (n,))``."""
    return rs.randint(0, CFG.vocab, (n,)).astype("int32")


def _ctx():
    import torch

    import mxnet_tpu_torch as mx
    return mx.Context(torch.device(CFG.device))


# ----------------------------------------------------------------- helpers

def _gpt2(num_layers=None, seed=0):
    from mxnet_tpu_torch.models import get_gpt2
    net = get_gpt2("gpt2_124m", vocab_size=CFG.vocab, units=CFG.units,
                   num_layers=num_layers or CFG.layers,
                   num_heads=CFG.heads, max_length=CFG.max_length,
                   dropout=0.0, device=CFG.device)
    net.initialize(seed=seed)
    return net


def _tiny_gpt2():
    return _gpt2()


def _gen(net, p, n):
    """Fault-free greedy reference: ``net.generate`` of ``n`` tokens."""
    with _aside():
        return net.generate(p[None], n, temperature=0)[0].cpu().numpy()


def _prompts(lens, seed=1):
    import numpy as onp
    rs = onp.random.RandomState(seed)
    return [_toks(rs, _L(l)) for l in lens]


def _engine(net, **kw):
    from mxnet_tpu_torch.serving import InferenceEngine
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_batch", 2)
    kw.setdefault("seq_buckets", (_L(8),))
    kw.setdefault("default_max_new_tokens", 4)
    kw.setdefault("watchdog_interval", 0.05)
    kw.setdefault("retry_backoff", 0.001)
    kw.setdefault("device", CFG.device)
    eng = InferenceEngine(net, **kw)
    eng._graphs = False
    warm = eng.warmup

    def warmup(*a, **k):
        # the sweep's and the fleet's warm-ups alike
        with _aside():
            return warm(*a, **k)
    eng.warmup = warmup
    return eng


def _host(a):
    import numpy as onp
    return onp.asarray(a.float().cpu().numpy() if a.is_floating_point()
                       else a.cpu().numpy())


def _pool_clean(eng):
    """No NaN in any page of the pool, and the never-written zero page
    (one past the real pages) still all zeros, in every leaf."""
    import numpy as onp
    return all(bool(onp.isfinite(_host(a[:eng.num_pages]).astype(
        "float32")).all()) and bool((_host(a[eng.num_pages]) == 0).all())
        for layer in eng._caches for a in layer.values())


def _join_zombies(timeout=30):
    """Wait for the scheduler threads of stopped engines to end, so the
    next scenario does not share the interpreter with them."""
    deadline = time.monotonic() + timeout
    for th in threading.enumerate():
        if th.name == "mxnet_tpu_torch-serving":
            th.join(max(0.1, deadline - time.monotonic()))


def _resolve_all(futs, timeout=60):
    """(ok_count, typed_error_count, stranded_count)"""
    ok = typed = stranded = 0
    for f in futs:
        try:
            f.result(timeout=timeout)
            ok += 1
        except TimeoutError:
            stranded += 1
        except Exception:
            typed += 1
    return ok, typed, stranded


# -------------------------------------------------------- serving scenarios

def _serving_scenario(net, name, plan, submit_kw=None, engine_kw=None,
                      n_requests=6, sigterm=False):
    from mxnet_tpu_torch.serving import ServingError
    eng = _engine(net, **(engine_kw or {}))
    submitted = rejected_typed = 0
    futs = []
    with plan:
        eng.start()
        if sigterm:
            eng.install_signal_handlers()
        for p in _prompts(tuple(range(2, 2 + n_requests)), seed=9):
            try:
                futs.append(eng.submit(p, max_new_tokens=3,
                                       **(submit_kw or {})))
                submitted += 1
            except ServingError:
                rejected_typed += 1
        if sigterm:
            os.kill(os.getpid(), signal.SIGTERM)
        ok, typed, stranded = _resolve_all(futs, timeout=45)
        try:
            eng.stop(timeout=15)
        except ServingError:
            pass
        if sigterm:
            eng.uninstall_signal_handlers()
    _join_zombies()
    passed = stranded == 0 and (ok + typed) == submitted \
        and (submitted + rejected_typed) == n_requests
    return {
        "name": f"serving/{name}",
        "passed": bool(passed),
        "detail": {"submitted": submitted, "rejected_typed": rejected_typed,
                   "ok": ok, "typed_errors": typed, "stranded": stranded,
                   "faults_fired": plan.fired(),
                   "health": eng.health(),
                   "resilience": eng.stats()["resilience"]},
    }


def serving_scenarios(net):
    """(name, thunk) pairs — each thunk builds its plan fresh and runs
    one engine through it."""
    from mxnet_tpu_torch.resilience import FaultPlan
    return [
        ("control", lambda: _serving_scenario(net, "control", FaultPlan())),
        ("scheduler_crash", lambda: _serving_scenario(
            net, "scheduler_crash",
            FaultPlan().raise_at("serving.scheduler", at=3))),
        ("hung_step", lambda: _serving_scenario(
            net, "hung_step",
            FaultPlan().delay_at("serving.decode_step", 1.0, at=1),
            engine_kw={"hang_timeout": 0.3})),
        ("retryable_fault", lambda: _serving_scenario(
            net, "retryable_fault",
            FaultPlan().raise_at("serving.prefill", at=1, retryable=True))),
        ("nonretryable_step_fault", lambda: _serving_scenario(
            net, "nonretryable_step_fault",
            FaultPlan().raise_at("serving.decode_step", at=2))),
        ("queue_full", lambda: _serving_scenario(
            net, "queue_full", FaultPlan(),
            engine_kw={"queue_depth": 2, "max_wait_us": 50000.0})),
        ("deadline", lambda: _serving_scenario(
            net, "deadline", FaultPlan(),
            submit_kw={"timeout": 0.01},
            engine_kw={"max_wait_us": 100000.0})),
        ("sigterm_drain", lambda: _serving_scenario(
            net, "sigterm_drain", FaultPlan(), sigterm=True)),
        ("prefix_storm", lambda: serving_prefix_storm(net)),
        ("paged_storm", lambda: serving_paged_storm(net)),
        ("spill_storm", lambda: serving_spill_storm(net)),
        ("quant_storm", lambda: serving_quant_storm(net)),
        ("spec_storm", serving_spec_storm),
        ("sharded_parity", lambda: serving_sharded_parity(net)),
        ("exporter_storm", lambda: serving_exporter_storm(net)),
        ("replica_kill", lambda: fleet_replica_kill(net)),
        ("rolling_restart", lambda: fleet_rolling_restart(net)),
        ("overload_storm", lambda: serving_overload_storm(net)),
        ("retry_storm", lambda: fleet_retry_storm(net)),
        ("gray_replica", lambda: fleet_gray_replica(net)),
        ("flash_spike", lambda: fleet_flash_spike(net)),
        ("disagg_prefill_kill", lambda: disagg_prefill_kill(net)),
        ("disagg_decode_kill", lambda: disagg_decode_kill(net)),
    ]


def _sharded_prompts():
    import numpy as onp
    rs = onp.random.RandomState(17)
    prompts = [_toks(rs, _L(l)) for l in (3, 5, 7, 4, 6, 5)]
    samp = [{} if i % 2 == 0
            else dict(temperature=1.0, top_k=8, seed=50 + i)
            for i in range(len(prompts))]
    return prompts, samp


def _sharded_rank(out_dir):
    """One gloo rank of ``serving_sharded_parity`` (started by
    ``tools/launch.py -n 2``): every rank builds the same net and the
    2-rank mesh engine; rank 0 also serves the one-device engine, holds
    the fault plan, submits, and writes the scenario's record."""
    import numpy as onp

    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.resilience import FaultPlan
    par.init_distributed(backend="gloo")
    lead = par.rank() == 0
    net = _tiny_gpt2()
    prompts, samp = _sharded_prompts()
    eng2 = _engine(net, mesh=2, name="chaos_sharded_mesh")
    if lead:
        eng1 = _engine(net, name="chaos_sharded_1dev")
        warm1 = eng1.warmup()
    warm2 = eng2.warmup()
    plan = (FaultPlan()
            .raise_at(f"serving.decode_step@{eng2.name}", at=2,
                      retryable=True)
            .raise_at(f"serving.prefill@{eng2.name}", at=1,
                      retryable=True)) if lead else FaultPlan()
    lost = mismatched = 0
    with plan:
        if not lead:
            with eng2:
                pass
            par.barrier()
            return
        with eng1, eng2:
            futs1 = [eng1.submit(p, max_new_tokens=4, **k)
                     for p, k in zip(prompts, samp)]
            futs2 = [eng2.submit(p, max_new_tokens=4, **k)
                     for p, k in zip(prompts, samp)]
            for f1, f2 in zip(futs1, futs2):
                try:
                    a = f1.result(timeout=60)
                    b = f2.result(timeout=60)
                    if not onp.array_equal(a, b):
                        mismatched += 1
                except Exception:
                    lost += 1
            s1, s2 = eng1.stats(), eng2.stats()
    _join_zombies()
    frozen = (s1["compile"]["compiles"] == warm1
              and s2["compile"]["compiles"] == warm2)
    passed = (lost == 0 and mismatched == 0 and frozen
              and s2["resilience"]["retries"] >= 2
              and plan.fired() == 2
              and s2["mesh"]["devices"] == 2)
    rec = {
        "name": "serving/sharded_parity",
        "passed": bool(passed),
        "detail": {"requests": len(prompts), "lost": lost,
                   "mismatched": mismatched,
                   "faults_fired": plan.fired(),
                   "retries": s2["resilience"]["retries"],
                   "compile_frozen": frozen,
                   "mesh": s2["mesh"],
                   "compile_by_mesh_point": {
                       **s1["compile"]["by_mesh_point"],
                       **s2["compile"]["by_mesh_point"]}},
    }
    with open(os.path.join(out_dir, "sharded_parity.json"), "w") as f:
        json.dump(rec, f, default=str)
    par.barrier()


def serving_sharded_parity(net):
    """Sharded serving chaos: the same mixed greedy+sampled burst
    through a 1-device engine and a 2-rank mesh engine (two gloo ranks
    through ``tools/launch.py``, as the port's sharded-serving tests
    run), with retryable faults injected on the MESH engine's dispatch
    path only (scoped ``serving.decode_step@`` / ``serving.prefill@``).
    Invariants: zero lost requests, the mesh streams TOKEN-IDENTICAL to
    the 1-device engine's, faults contained (retried within budget,
    never a failed request), and zero compiles post-warmup at either
    (bucket, mesh) point.  ``net`` is rebuilt from the same seed on
    each rank."""
    out_dir = tempfile.mkdtemp(prefix="chaos_sharded_")
    try:
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   MXNET_TPU_DIST_TIMEOUT="120")
        env.pop("MXTPU_LOCKWITNESS", None)
        proc = subprocess.run(
            [sys.executable, os.path.join(_TOOLS, "launch.py"), "-n", "2",
             sys.executable, os.path.abspath(__file__), "--device",
             CFG.device, "--layers", str(CFG.layers), "--sharded-rank",
             out_dir],
            env=env, capture_output=True, text=True, timeout=600)
        path = os.path.join(out_dir, "sharded_parity.json")
        if proc.returncode or not os.path.exists(path):
            return {"name": "serving/sharded_parity", "passed": False,
                    "detail": {"error": f"ranks exited {proc.returncode}",
                               "stderr": proc.stderr[-3000:]}}
        with open(path) as f:
            return json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# --------------------------------------------------------- fleet scenarios

def _fleet(net, n=3, **kw):
    from mxnet_tpu_torch.fleet import FleetRouter

    def factory(name):
        return _engine(net, name=name, prefix_pool_rows=2,
                       prefix_min_tokens=_L(2))

    kw.setdefault("health_interval", 0.03)
    kw.setdefault("probation", 0.3)
    return FleetRouter(factory=factory, num_replicas=n, **kw)


def _family_prompts(seed, n, shared=10, tail=3):
    import numpy as onp
    rs = onp.random.RandomState(seed)
    head = _toks(rs, _L(shared))
    return [onp.concatenate([head, _toks(rs, _L(tail))]) for _ in range(n)]


def fleet_replica_kill(net):
    """Fleet chaos: one of three replicas CRASHES mid-traffic (injected
    scheduler fault).  Invariants: ZERO lost requests — every
    in-flight/queued request on the corpse fails over to a healthy
    replica within its budget and completes token-correct — the death
    is probation-gated, the monitor re-admits a REBUILT replica after
    the window, and a post-recovery wave of shared-prefix traffic hits
    the prefix cache again (the hit rate recovers)."""
    import numpy as onp

    from mxnet_tpu_torch.resilience import FaultPlan

    prompts = _family_prompts(3, 10)
    refs = [_gen(net, p, 3) for p in prompts]
    fleet = _fleet(net, n=3, name="chaos_kill")
    fleet.warmup()
    plan = FaultPlan().raise_at("serving.scheduler", at=5)
    lost = mismatched = 0
    recovered = False
    hit_rate_after = None
    with plan:
        with fleet:
            futs = [fleet.submit(p, max_new_tokens=3) for p in prompts]
            for ref, f in zip(refs, futs):
                try:
                    out = f.result(timeout=60)
                    if not onp.array_equal(out, ref):
                        mismatched += 1
                except Exception:
                    lost += 1
            deaths = fleet.stats()["router"].get("replica_deaths", 0)
            # wait out probation: the monitor rebuilds the corpse
            deadline = time.monotonic() + 20
            while len(fleet._healthy()) < 3 and time.monotonic() < deadline:
                time.sleep(0.05)
            recovered = len(fleet._healthy()) == 3
            # post-recovery wave: shared-prefix traffic must hit again
            for ref, p in zip(refs, prompts):
                try:
                    out = fleet.infer(p, max_new_tokens=3)
                    if not onp.array_equal(out, ref):
                        mismatched += 1
                except Exception:
                    lost += 1
            s = fleet.stats()
            hit_rate_after = s["aggregate"]["prefix_hit_rate"]
    _join_zombies()
    passed = (lost == 0 and mismatched == 0 and deaths >= 1 and recovered
              and (hit_rate_after or 0) > 0
              and plan.fired("serving.scheduler") == 1)
    return {
        "name": "fleet/replica_kill",
        "passed": bool(passed),
        "detail": {"requests": 2 * len(prompts), "lost": lost,
                   "mismatched": mismatched, "replica_deaths": deaths,
                   "readmitted": recovered,
                   "prefix_hit_rate_after": hit_rate_after,
                   "router": fleet.stats()["router"],
                   "faults_fired": plan.fired()},
    }


def fleet_rolling_restart(net):
    """Fleet chaos: drain + rebuild every replica in sequence while a
    background submitter keeps traffic flowing.  Invariants: NO request
    errors (traffic steers around the draining replica; queued requests
    on it finish before it stops), every output token-correct, and all
    replicas end healthy having restarted exactly once."""
    import numpy as onp

    prompts = _family_prompts(4, 24)
    refs = [_gen(net, p, 3) for p in prompts]
    fleet = _fleet(net, n=3, name="chaos_roll")
    fleet.warmup()
    done = threading.Event()
    results = []

    def submitter():
        for ref, p in zip(refs, prompts):
            try:
                out = fleet.infer(p, max_new_tokens=3)
                results.append(bool(onp.array_equal(out, ref)))
            except Exception:
                results.append(None)
            time.sleep(0.02)
        done.set()

    with fleet:
        t = threading.Thread(target=submitter, daemon=True)
        t.start()
        time.sleep(0.1)
        fleet.rolling_restart(timeout=60)
        done.wait(timeout=120)
        t.join(10)
        s = fleet.stats()
    _join_zombies()
    errors = sum(1 for r in results if r is None)
    mismatched = sum(1 for r in results if r is False)
    restarts = {n_: rep["restarts"] for n_, rep in s["replicas"].items()}
    passed = (errors == 0 and mismatched == 0
              and len(results) == len(prompts)
              and all(v == 1 for v in restarts.values())
              and s["fleet"]["healthy"] == 3)
    return {
        "name": "fleet/rolling_restart",
        "passed": bool(passed),
        "detail": {"requests": len(results), "errors": errors,
                   "mismatched": mismatched, "restarts": restarts,
                   "healthy": s["fleet"]["healthy"],
                   "router": s["router"]},
    }


def serving_exporter_storm(net):
    """Observability exporter chaos: an engine with a tight-interval
    :class:`BackgroundExporter` attached CRASHES (injected scheduler
    fault) while SIGTERM lands mid-export-loop.  Invariants: the
    exporter thread always joins, its output file is never torn (a
    truncated write would FAIL ``parse_prometheus`` — exports are
    temp-file + atomic rename), the final flush carries the engine's
    counters, and no future is stranded."""
    from mxnet_tpu_torch.observability import (BackgroundExporter,
                                               parse_prometheus)
    from mxnet_tpu_torch.resilience import FaultPlan
    from mxnet_tpu_torch.serving import ServingError

    workdir = tempfile.mkdtemp(prefix="obs_storm_")
    out = os.path.join(workdir, "metrics.prom")
    exp = BackgroundExporter(path=out, interval=0.002)
    eng = _engine(net, name="exporter_storm")
    eng.attach_exporter(exp)
    plan = FaultPlan().raise_at("serving.scheduler", at=3)
    futs = []
    submitted = rejected = 0
    try:
        with plan:
            eng.start()
            eng.install_signal_handlers()
            for p in _prompts(tuple(range(2, 8)), seed=11):
                try:
                    futs.append(eng.submit(p, max_new_tokens=3))
                    submitted += 1
                except ServingError:
                    rejected += 1
            os.kill(os.getpid(), signal.SIGTERM)   # mid-export: 2ms period
            ok, typed, stranded = _resolve_all(futs, timeout=45)
            try:
                eng.stop(timeout=15)
            except ServingError:
                pass
            eng.uninstall_signal_handlers()
        _join_zombies()
        exp.stop(flush=True)           # idempotent if stop() already drained
        joined = not exp.is_alive()
        torn, has_counters = False, False
        try:
            with open(out) as f:
                parsed = parse_prometheus(f.read())
            has_counters = any(name.startswith("mxtpu_serving")
                               for name, _labels in parsed)
        except Exception:
            torn = True
        passed = (joined and not torn and has_counters and stranded == 0
                  and (ok + typed) == submitted and exp.exports >= 1)
        return {
            "name": "serving/exporter_storm",
            "passed": bool(passed),
            "detail": {"submitted": submitted, "ok": ok,
                       "typed_errors": typed, "stranded": stranded,
                       "exporter_joined": joined, "torn_output": torn,
                       "exports": exp.exports, "export_errors": exp.errors,
                       "has_serving_counters": has_counters,
                       "faults_fired": plan.fired()},
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def serving_prefix_storm(net):
    """Prefix-cache chaos: a 1-row pool THRASHED by shared-prefix
    prompts of varying lengths (insert-evict churn on every request)
    while faults land mid-copy (plain and retryable) and mid-lookup.
    The invariant is NO STALE K/V SERVED: every request must complete
    with tokens identical to a fault-free per-request ``net.generate``.
    Prompts are longer than the seq bucket, so the storm also crosses
    the chunked-prefill path."""
    import numpy as onp

    from mxnet_tpu_torch.resilience import FaultPlan

    rs = onp.random.RandomState(5)
    shared = _toks(rs, _L(12))
    prompts = [onp.concatenate([shared[:_L(8 + (i % 5))],
                                _toks(rs, _L(4))])
               for i in range(8)]
    refs = [_gen(net, p, 3) for p in prompts]
    plan = (FaultPlan()
            .raise_at("serving.prefix_copy", at=2)
            .raise_at("serving.prefix_copy", at=5, retryable=True)
            .raise_at("serving.prefix_lookup", at=4))
    eng = _engine(net, prefix_pool_rows=1, prefix_min_tokens=_L(2))
    mismatched = stranded = 0
    with plan:
        eng.start()
        for p, ref in zip(prompts, refs):
            try:
                out = eng.infer(p, max_new_tokens=3)
                if not onp.array_equal(out, ref):
                    mismatched += 1
            except Exception:
                stranded += 1
        try:
            eng.stop(timeout=15)
        except Exception:
            pass
    _join_zombies()
    s = eng.stats()
    passed = (mismatched == 0 and stranded == 0
              and s["prefix_cache"]["prefix_hits"] >= 1
              and s["prefix_cache"]["prefix_faults"] >= 2)
    return {
        "name": "serving/prefix_storm",
        "passed": bool(passed),
        "detail": {"requests": len(prompts), "mismatched": mismatched,
                   "stranded": stranded,
                   "prefix": s["prefix_cache"],
                   "faults_fired": plan.fired(),
                   "prefix_disabled": s["engine"]["prefix_disabled"]},
    }


def _wpe(net):
    """The position table: the parameter of shape (max_length, units)."""
    return [p for n, p in net.named_parameters()
            if tuple(p.shape) == (CFG.max_length, CFG.units)][0]


def serving_paged_storm(net):
    """Paged-KV chaos: a page pool at ONE page of headroom over the
    worst-case request, thrashed by shared-prefix prompts of mixed
    lengths through more slots than the pool can hold at once, while
    faults land on the page allocator and mid-tail-page-copy AND a
    poisoned position embedding drives one long request non-finite
    mid-decode.  Invariants: ZERO lost requests (everything resolves —
    the poisoned one with a typed NonFiniteOutputError, the rest
    token-identical to fault-free ``net.generate``), page faults
    actually fired (the park-by-reference relief valve ran),
    scrub-on-NaN SCRUBBED pages (counter moved, and no NaN survives
    anywhere in the page pool afterwards), and the storm compiled
    NOTHING after warmup."""
    import numpy as onp
    import torch

    from mxnet_tpu_torch.resilience import FaultPlan
    from mxnet_tpu_torch.serving import NonFiniteOutputError

    rs = onp.random.RandomState(6)
    shared = _toks(rs, _L(10))
    prompts = [onp.concatenate([shared[:_L(7 + (i % 4))], _toks(rs, _L(3))])
               for i in range(8)]
    refs = [_gen(net, p, 3) for p in prompts]
    nan_prompt = _toks(rs, CFG.nan_prompt)
    plan = (FaultPlan()
            .raise_at("serving.page_copy", at=1)
            .raise_at("serving.page_alloc", at=3)
            .raise_at("serving.page_alloc", at=9, retryable=True))
    # worst case needs max_length / page_size = 4 pages; the pool holds
    # 5 — every burst of 3 slots must fault, evict, and park to make
    # progress
    eng = _engine(net, num_slots=3, max_batch=3, kv_layout="paged",
                  page_size=_L(8), num_pages=5, prefix_min_tokens=_L(2))
    n_warm = eng.warmup()
    wpe = _wpe(net)
    orig = wpe.detach().clone()
    mismatched = stranded = 0
    nan_typed = False
    pool_clean = False
    s = None
    try:
        with torch.no_grad():
            # poison ONE position: every parity request (and its padded
            # prefill chunk) stays below it
            wpe[CFG.nan_pos].fill_(float("nan"))
        with plan:
            eng.start()
            futs = [eng.submit(p, max_new_tokens=3) for p in prompts]
            # crosses the poisoned position mid-decode -> typed failure
            nan_fut = eng.submit(nan_prompt, max_new_tokens=20)
            for ref, f in zip(refs, futs):
                try:
                    out = f.result(timeout=60)
                    if not onp.array_equal(out, ref):
                        mismatched += 1
                except Exception:
                    stranded += 1
            try:
                nan_fut.result(timeout=60)
            except NonFiniteOutputError:
                nan_typed = True
            except Exception:
                stranded += 1
            s = eng.stats()
            # scrub proof: no NaN survives anywhere in the page pool,
            # and the never-written ZERO page is still pristine
            pool_clean = _pool_clean(eng)
            try:
                eng.stop(timeout=15)
            except Exception:
                pass
    finally:
        with torch.no_grad():
            wpe.copy_(orig)
    _join_zombies()
    passed = (mismatched == 0 and stranded == 0 and nan_typed
              and pool_clean
              and s["slots"]["page_faults"] >= 2
              and s["slots"]["pages_scrubbed"] >= 1
              and s["prefix_cache"]["prefix_faults"] >= 1
              and s["compile_cache"]["compiles"] == n_warm
              and plan.fired("serving.page_copy") >= 1
              and plan.fired("serving.page_alloc") >= 2)
    return {
        "name": "serving/paged_storm",
        "passed": bool(passed),
        "detail": {"requests": len(prompts) + 1, "mismatched": mismatched,
                   "stranded": stranded, "nan_typed": nan_typed,
                   "pool_clean_after_scrub": pool_clean,
                   "slots": s["slots"],
                   "prefix": s["prefix_cache"],
                   "compiles_warmup": n_warm,
                   "compiles_total": s["compile_cache"]["compiles"],
                   "preemptions": s["overload"]["preemptions"],
                   "faults_fired": plan.fired()},
    }


def serving_spill_storm(net):
    """Tiered-KV chaos: a working set of shared-prefix families far
    larger than the device page pool forces continuous demotion to the
    host tier and promotion back, while faults land on both tier worker
    paths AND a rot fault flips bytes in sealed bundles so
    verify-on-promote is exercised end-to-end.  Invariants: ZERO lost
    requests, demotions and promotions both happened, at least one
    rotted bundle was REJECTED at verify, the device pool stays NaN-free
    with a pristine zero page, the tier never self-disabled, and the
    storm compiled NOTHING after warmup."""
    import numpy as onp

    from mxnet_tpu_torch.resilience import FaultPlan

    rs = onp.random.RandomState(8)
    # 5 families of 13-token prompts (10 shared + 3 tail) at page_size
    # 8 => 2 pages each; 5 live families want 10 pages against a
    # 6-page pool, so every wave evicts-and-demotes somebody
    families = [_toks(rs, _L(10)) for _ in range(5)]
    waves = [[onp.concatenate([fam, _toks(rs, _L(3))]) for fam in families]
             for _ in range(3)]
    refs = {}
    for wave in waves:
        for p in wave:
            refs[p.tobytes()] = _gen(net, p, 3)
    plan = (FaultPlan()
            .raise_at("serving.tier_demote", at=2)
            .raise_at("serving.tier_promote", at=2)
            .corrupt_at("serving.tier_rot", every=3))
    # fault_limit 4 > the 2 single-shot worker faults: the tier
    # degrades each fault to a counted drop/miss but must NOT disable
    eng = _engine(net, num_slots=3, max_batch=3, kv_layout="paged",
                  page_size=_L(8), num_pages=6, prefix_min_tokens=_L(2),
                  host_pool_bytes=CFG.host_pool_bytes, tier_fault_limit=4)
    n_warm = eng.warmup()
    mismatched = stranded = 0
    with plan:
        eng.start()
        # resolve waves serially so each revisit lands AFTER the
        # previous wave's evictions demoted its family to the tier
        for wave in waves:
            futs = [eng.submit(p, max_new_tokens=3) for p in wave]
            for p, f in zip(wave, futs):
                try:
                    out = f.result(timeout=60)
                    if not onp.array_equal(out, refs[p.tobytes()]):
                        mismatched += 1
                except Exception:
                    stranded += 1
        if eng._tier is not None:
            eng._tier.drain(timeout=10)
        s = eng.stats()
        tier_enabled = bool(eng._tier is not None and eng._tier.enabled)
        pool_clean = _pool_clean(eng)
        try:
            eng.stop(timeout=15)
        except Exception:
            pass
    _join_zombies()
    t = s["tier"]
    passed = (mismatched == 0 and stranded == 0 and pool_clean
              and tier_enabled
              and t["tier_demotes"] >= 2
              and t["tier_promotes"] >= 1
              and t["tier_hits"] >= 1
              and t["tier_verify_failures"] >= 1
              and s["compile_cache"]["compiles"] == n_warm
              and plan.fired("serving.tier_demote") >= 1
              and plan.fired("serving.tier_promote") >= 1
              and plan.fired("serving.tier_rot") >= 1)
    return {
        "name": "serving/spill_storm",
        "passed": bool(passed),
        "detail": {"requests": sum(len(w) for w in waves),
                   "mismatched": mismatched, "stranded": stranded,
                   "pool_clean": pool_clean,
                   "tier_enabled": tier_enabled,
                   "tier": t,
                   "prefix": s["prefix_cache"],
                   "compiles_warmup": n_warm,
                   "compiles_total": s["compile_cache"]["compiles"],
                   "faults_fired": plan.fired()},
    }


def serving_quant_storm(net):
    """Quantized-KV chaos: an int8 paged engine on the kernel arm (B4
    with the dequant fused on the card), page pool at ONE page of
    headroom, shared-prefix families cycling through the host tier,
    while a fault aborts one quantize-on-write prefill AND every 3rd
    decode-cycle claim NaN-poisons a live page's scale sidecar.
    Invariants: every completer is token-identical to the same int8
    engine run fault-free, zero stranded futures (scale-poison victims
    fail TYPED), the quantize fault degraded to a counted recompute,
    demotions and promotions of int8 bundles both happened, the device
    pool ends pristine, and the storm compiled NOTHING after warmup."""
    import numpy as onp

    from mxnet_tpu_torch.resilience import FaultPlan
    from mxnet_tpu_torch.serving import NonFiniteOutputError

    rs = onp.random.RandomState(9)
    families = [_toks(rs, _L(10)) for _ in range(4)]
    waves = [[onp.concatenate([fam, _toks(rs, _L(3))]) for fam in families]
             for _ in range(3)]
    kw = dict(num_slots=2, max_batch=2, kv_layout="paged", page_size=_L(8),
              num_pages=5, prefix_min_tokens=_L(2), kv_quant="int8",
              paged_attention="kernel", host_pool_bytes=CFG.host_pool_bytes,
              tier_fault_limit=4)
    # the int8 reference arm: the SAME engine config run fault-free
    refs = {}
    ref_eng = _engine(net, **kw)
    ref_eng.warmup()
    with ref_eng, _aside():
        for wave in waves:
            futs = [ref_eng.submit(p, max_new_tokens=3) for p in wave]
            for p, f in zip(wave, futs):
                refs[p.tobytes()] = f.result(timeout=60)
    _join_zombies()
    plan = (FaultPlan()
            .raise_at("serving.kv_quant", at=2)
            .nonfinite_at("serving.kv_scale", every=3))
    eng = _engine(net, **kw)
    n_warm = eng.warmup()
    mismatched = stranded = typed = completed = 0
    with plan:
        eng.start()
        for wave in waves:
            futs = [eng.submit(p, max_new_tokens=3) for p in wave]
            for p, f in zip(wave, futs):
                try:
                    out = f.result(timeout=60)
                    completed += 1
                    if not onp.array_equal(out, refs[p.tobytes()]):
                        mismatched += 1
                except NonFiniteOutputError:
                    typed += 1          # scale-poison victim, contained
                except Exception:
                    stranded += 1
        if eng._tier is not None:
            eng._tier.drain(timeout=10)
        s = eng.stats()
        pool_clean = _pool_clean(eng)
        try:
            eng.stop(timeout=15)
        except Exception:
            pass
    _join_zombies()
    q = s["quantized_kv"]
    t = s["tier"]
    passed = (mismatched == 0 and stranded == 0 and pool_clean
              and completed >= len(families)
              and typed >= 1
              and q["kv_quant_faults"] >= 1
              and q["kv_dequant_faults"] >= 1
              and q["kv_quant_pages"] >= 1
              and t["tier_demotes"] >= 1
              and t["tier_promotes"] >= 1
              and s["compile_cache"]["compiles"] == n_warm
              and plan.fired("serving.kv_quant") >= 1
              and plan.fired("serving.kv_scale") >= 1)
    return {
        "name": "serving/quant_storm",
        "passed": bool(passed),
        "detail": {"requests": sum(len(w) for w in waves),
                   "completed": completed, "mismatched": mismatched,
                   "typed_nan": typed, "stranded": stranded,
                   "pool_clean": pool_clean,
                   "quantized_kv": q, "tier": t,
                   "compiles_warmup": n_warm,
                   "compiles_total": s["compile_cache"]["compiles"],
                   "faults_fired": plan.fired()},
    }


def serving_spec_storm():
    """Speculative-decode chaos: a paged pool at ONE page of headroom
    serves mixed greedy/sampled traffic through a speculating engine
    while faults land on the draft and verify dispatches AND the draft
    head's logits are NaN-poisoned every few cycles.  Invariants: ZERO
    lost requests, greedy rows token-identical to fault-free
    ``net.generate``, the rewound pages of rejected speculation come
    back refcount-clean, no NaN anywhere in the page pool, and the
    storm compiled NOTHING after warmup."""
    import numpy as onp

    from mxnet_tpu_torch.resilience import FaultPlan

    # the shared 1-layer CPU net cannot draft (draft_layers must be
    # < num_layers): build the 2-layer sibling
    net = _gpt2(num_layers=max(2, CFG.layers))
    rs = onp.random.RandomState(8)
    greedy = [_toks(rs, _L(4 + (i % 4))) for i in range(6)]
    refs = [_gen(net, p, 6) for p in greedy]
    sampled = [_toks(rs, _L(5)) for _ in range(3)]
    plan = (FaultPlan()
            .raise_at("serving.draft", at=2)
            .raise_at("serving.verify", at=1, retryable=True)
            .raise_at("serving.verify", at=4)
            .nonfinite_at("serving.draft_logits", every=3))
    eng = _engine(net, num_slots=3, max_batch=3, kv_layout="paged",
                  page_size=_L(8), num_pages=5, spec_tokens=2,
                  draft_layers=1, prefix_min_tokens=_L(2))
    n_warm = eng.warmup()
    mismatched = stranded = 0
    with plan:
        eng.start()
        futs = [eng.submit(p, max_new_tokens=6) for p in greedy]
        sfuts = [eng.submit(p, max_new_tokens=6, temperature=1.0,
                            top_k=12, seed=i)
                 for i, p in enumerate(sampled)]
        for ref, f in zip(refs, futs):
            try:
                out = f.result(timeout=60)
                if not onp.array_equal(out, ref):
                    mismatched += 1
            except Exception:
                stranded += 1
        for f in sfuts:
            try:
                f.result(timeout=60)
            except Exception:
                stranded += 1
        s = eng.stats()
        # refcount-clean: with every request drained, evicting the
        # prefix cache's entries returns EVERY page to the free list
        with eng._step_lock:
            eng._prefix.evict_pages(eng.num_pages)
        refcount_clean = (eng._pool.free_count == eng.num_pages
                          and all(r == 0 for r in eng._pool._refs))
        pool_clean = _pool_clean(eng)
        try:
            eng.stop(timeout=15)
        except Exception:
            pass
    _join_zombies()
    sp = s["speculative"]
    passed = (mismatched == 0 and stranded == 0
              and refcount_clean and pool_clean
              and sp["spec_cycles"] >= 1
              and sp["spec_faults"] >= 2
              and s["compile_cache"]["compiles"] == n_warm
              and plan.fired("serving.draft") >= 1
              and plan.fired("serving.verify") >= 2
              and plan.fired("serving.draft_logits") >= 1)
    return {
        "name": "serving/spec_storm",
        "passed": bool(passed),
        "detail": {"requests": len(greedy) + len(sampled),
                   "mismatched": mismatched, "stranded": stranded,
                   "refcount_clean": refcount_clean,
                   "pool_clean": pool_clean,
                   "speculative": sp,
                   "slots": s["slots"],
                   "compiles_warmup": n_warm,
                   "compiles_total": s["compile_cache"]["compiles"],
                   "faults_fired": plan.fired()},
    }


def serving_overload_storm(net):
    """Overload chaos: 3x sustained overload at mixed priority classes
    through one engine.  Invariants: ZERO ``interactive``-class sheds
    and every interactive request completes; 100% of SERVED requests
    meet their deadlines; at least one ``best_effort`` request is
    PREEMPTED mid-decode and resumes via prefix hit with
    token-identical output (every completed output is an exact prefix
    of its fault-free ``net.generate`` reference); the controller
    enters brownout under the storm and LIFTS it after; a post-storm
    shared-prefix wave sees the hit rate recover with zero sheds; and
    the storm compiles NOTHING after warmup."""
    import numpy as onp

    from mxnet_tpu_torch.serving import (DeadlineInfeasibleError,
                                         QueueFullError,
                                         RequestTimeoutError)

    rs = onp.random.RandomState(7)
    eng = _engine(net, queue_depth=6, prefix_pool_rows=4,
                  prefix_min_tokens=_L(4), default_max_new_tokens=4)
    n_warm = eng.warmup()

    def mk(l):
        return _toks(rs, _L(l))
    ref_of = {}

    def ref(p, n):
        key = (tuple(int(t) for t in p), n)
        if key not in ref_of:
            ref_of[key] = _gen(net, p, n)
        return ref_of[key]

    outcomes = {"ok": 0, "shed": 0, "timeout": 0, "infeasible": 0,
                "mismatch": 0, "other": 0}
    ia_bad = 0
    with eng:
        # phase 1 — steady state: builds the latency history the
        # deadline-admission gate estimates from
        for i in range(8):
            p = mk(5 + (i % 3))
            out = eng.infer(p, max_new_tokens=4, priority="batch")
            if not onp.array_equal(out, ref(p, 4)):
                outcomes["mismatch"] += 1
        # phase 2 — the storm: first occupy both slots with long
        # best_effort decodes (the preemption victims) ...
        storm = []
        d0 = eng.metrics.counters["decode_steps"]
        for _i in range(2):
            p = mk(6)
            storm.append(("best_effort", p, 8,
                          eng.submit(p, max_new_tokens=8, timeout=30.0,
                                     priority="best_effort")))
        deadline = time.monotonic() + 30
        # ... wait until they are actually DECODING in slots ...
        while eng.metrics.counters["decode_steps"] <= d0 and \
                time.monotonic() < deadline:
            time.sleep(0.002)
        # ... then 3x capacity of interleaved mixed-class arrivals,
        # interactive paced below service capacity (at most 4
        # outstanding — less than the queue depth)
        classes = ("best_effort", "batch", "interactive") * 8
        ia_open = []
        for i, cls in enumerate(classes):
            p = mk(5 + (i % 4))
            n = 2 if cls == "interactive" else 6
            if cls == "interactive":
                ia_open = [f for f in ia_open if not f.done()]
                while len(ia_open) >= 4 and time.monotonic() < deadline:
                    time.sleep(0.002)
                    ia_open = [f for f in ia_open if not f.done()]
            try:
                f = eng.submit(p, max_new_tokens=n, timeout=30.0,
                               priority=cls)
                storm.append((cls, p, n, f))
                if cls == "interactive":
                    ia_open.append(f)
            except Exception as e:
                if isinstance(e, DeadlineInfeasibleError):
                    outcomes["infeasible"] += 1
                elif isinstance(e, QueueFullError):
                    outcomes["shed"] += 1
                else:
                    outcomes["other"] += 1
                if cls == "interactive":
                    ia_bad += 1
        for cls, p, n, f in storm:
            try:
                out = f.result(timeout=60)
            except RequestTimeoutError:
                outcomes["timeout"] += 1
                if cls == "interactive":
                    ia_bad += 1
                continue
            except QueueFullError:
                outcomes["shed"] += 1       # evicted by a higher class
                if cls == "interactive":
                    ia_bad += 1
                continue
            except Exception:
                outcomes["other"] += 1
                if cls == "interactive":
                    ia_bad += 1
                continue
            r = ref(p, n)
            # brownout may CAP a budget (shorter output) but must never
            # corrupt tokens: every completed output is an exact prefix
            if len(out) > len(r) or \
                    not onp.array_equal(out, r[:len(out)]) or \
                    len(out) <= len(p):
                outcomes["mismatch"] += 1
            else:
                outcomes["ok"] += 1
        mid = eng.stats()
        # phase 3 — recovery: the brownout must LIFT unaided ...
        deadline = time.monotonic() + 20
        while eng._overload.factor < 1.0 and time.monotonic() < deadline:
            time.sleep(0.02)
        recovered = eng._overload.factor == 1.0
        # ... and a shared-prefix wave sees the cache working again
        shared = mk(10)
        hits0 = eng.metrics.counters["prefix_hits"]
        wave_bad = 0
        for _i in range(6):
            p = onp.concatenate([shared, mk(3)])
            try:
                out = eng.infer(p, max_new_tokens=3, priority="batch")
                if not onp.array_equal(out, ref(p, 3)):
                    wave_bad += 1
            except Exception:
                wave_bad += 1
        hit_recovered = eng.metrics.counters["prefix_hits"] > hits0
        s = eng.stats()
        eng.stop(timeout=30)
    _join_zombies()
    ia_sheds = sum(v.get("interactive", 0)
                   for v in s["overload"]["sheds"].values())
    passed = (ia_bad == 0 and ia_sheds == 0
              and outcomes["timeout"] == 0
              and outcomes["mismatch"] == 0 and outcomes["other"] == 0
              and s["overload"]["preemptions"] >= 1
              and s["overload"]["preempt_resumes"] >= 1
              and s["prefix_cache"]["prefix_hits"] >= 1
              and mid["overload"]["brownouts"] >= 1
              and recovered and hit_recovered and wave_bad == 0
              and s["compile_cache"]["compiles"] == n_warm)
    return {
        "name": "serving/overload_storm",
        "passed": bool(passed),
        "detail": {"outcomes": outcomes,
                   "interactive_failures": ia_bad,
                   "interactive_sheds": ia_sheds,
                   "overload": s["overload"],
                   "brownout_lifted": recovered,
                   "hit_rate_recovered": hit_recovered,
                   "wave_failures": wave_bad,
                   "compiles_after_warmup":
                       s["compile_cache"]["compiles"] - n_warm},
    }


def fleet_retry_storm(net):
    """Retry-storm chaos: a replica CRASHES while the whole fleet is
    saturated.  Invariants: the token-bucket retry budget CAPS failover
    amplification (failovers never exceed burst + refill; at least one
    resubmission is DENIED and surfaces the original typed error) — no
    thundering herd — and every submitted request still resolves."""
    import numpy as onp

    from mxnet_tpu_torch.resilience import FaultPlan

    rs = onp.random.RandomState(11)
    prompts = [_toks(rs, _L(5 + (i % 3))) for i in range(18)]
    fleet = _fleet(net, n=3, name="chaos_retry", routing="least_loaded",
                   retry_budget_rate=0.5, retry_budget_burst=2,
                   max_failovers=3, probation=20.0)
    fleet.warmup()
    plan = FaultPlan().raise_at("serving.scheduler", at=10)
    accepted = rejected = 0
    futs = []
    t0 = time.monotonic()
    with plan:
        with fleet:
            for p in prompts:
                try:
                    futs.append(fleet.submit(p, max_new_tokens=3,
                                             timeout=20.0))
                    accepted += 1
                except Exception:
                    rejected += 1       # typed shed at submit: fine
            ok, typed, stranded = _resolve_all(futs, timeout=60)
            r = fleet.stats()["router"]
    storm_s = time.monotonic() - t0
    _join_zombies()
    failovers = r.get("failovers", 0)
    denied = r.get("retry_budget_exhausted", 0)
    deaths = r.get("replica_deaths", 0)
    # budget bound: burst (2) + whatever refilled (rate 0.5/s) over the
    # MEASURED storm window
    max_failovers_allowed = 2 + math.ceil(0.5 * storm_s)
    passed = (stranded == 0 and (ok + typed) == accepted
              and deaths >= 1 and failovers <= max_failovers_allowed
              and denied >= 1
              and plan.fired("serving.scheduler") == 1)
    return {
        "name": "fleet/retry_storm",
        "passed": bool(passed),
        "detail": {"requests": len(prompts), "accepted": accepted,
                   "rejected_at_submit": rejected, "ok": ok,
                   "typed_errors": typed, "stranded": stranded,
                   "replica_deaths": deaths, "failovers": failovers,
                   "failover_bound": max_failovers_allowed,
                   "storm_window_s": round(storm_s, 2),
                   "retry_budget_denied": denied,
                   "router": r,
                   "faults_fired": plan.fired()},
    }


def fleet_gray_replica(net):
    """Gray-failure chaos: one replica of three serves ~10x slow — a
    scoped delay fault at ITS decode-step site — while still answering
    ``health()``.  Invariants: the router SUSPECT-ejects it off the
    completion-latency outlier signal with ZERO lost requests; request
    p99 RECOVERS once placement skips it; the ejection is never read as
    saturation (no coordinated brownout); and when the fault lifts the
    replica is re-admitted WITHOUT a rebuild and takes load again with
    the prefix cache still hitting."""
    import numpy as onp

    from mxnet_tpu_torch.resilience import FaultPlan

    rs = onp.random.RandomState(13)
    shared = _toks(rs, _L(8))
    prompts = [onp.concatenate([shared[:_L(4 + (i % 3))], _toks(rs, _L(3))])
               for i in range(6)]
    refs = [_gen(net, p, 3) for p in prompts]
    fleet = _fleet(net, n=3, name="chaos_gray", routing="least_loaded",
                   health_interval=0.02, gray_min_samples=4,
                   gray_multiplier=3.0, probation=CFG.gray_probation)
    n_warm = sum(fleet.warmup().values())
    slow = fleet._by_name["chaos_gray-r1"]
    plan = FaultPlan().delay_at("serving.decode_step@chaos_gray-r1",
                                CFG.gray_delay, every=1)
    lost = mismatched = 0

    def wave(latencies=None):
        nonlocal lost, mismatched
        futs = [(ref, time.monotonic(),
                 fleet.submit(p, max_new_tokens=3, timeout=30.0))
                for p, ref in zip(prompts, refs)]
        for ref, t0, f in futs:
            try:
                out = f.result(60)
                if latencies is not None:
                    latencies.append(time.monotonic() - t0)
                if not onp.array_equal(out, ref):
                    mismatched += 1
            except Exception:
                lost += 1

    storm_lat, after_lat = [], []
    with fleet:
        plan.__enter__()
        try:
            ejected = False
            for _burst in range(8):
                wave(storm_lat)
                if fleet.stats()["router"].get("gray_ejections", 0):
                    ejected = True
                    break
            routed0 = slow.routed
            for _ in range(3):
                wave(after_lat)
            suspect_skipped = slow.routed == routed0
        finally:
            plan.__exit__(None, None, None)
        storm_lat.sort()
        after_lat.sort()
        p99_storm = storm_lat[int(0.99 * (len(storm_lat) - 1))] \
            if storm_lat else 0.0
        p99_after = after_lat[int(0.99 * (len(after_lat) - 1))] \
            if after_lat else 0.0
        brownouts = fleet.stats()["router"].get("fleet_brownouts", 0)
        # fault lifted: the monitor re-admits without a rebuild
        deadline = time.monotonic() + 20
        while slow.state == "suspect" and time.monotonic() < deadline:
            time.sleep(0.05)
        readmitted = slow.state == "healthy"
        hits0 = fleet.stats()["aggregate"]["prefix_hits"]
        routed1 = slow.routed
        for _ in range(3):
            wave()
        s = fleet.stats()
        took_traffic = slow.routed > routed1
        hit_recovered = s["aggregate"]["prefix_hits"] > hits0
        compiles = sum(rep["stats"]["compile_cache"]["compiles"]
                       for rep in s["replicas"].values())
    _join_zombies()
    passed = (lost == 0 and mismatched == 0 and ejected
              and suspect_skipped and p99_after < p99_storm
              and p99_storm >= CFG.gray_delay   # the delay showed
              and brownouts == 0 and readmitted and took_traffic
              and hit_recovered
              and s["replicas"]["chaos_gray-r1"]["restarts"] == 0
              and compiles == n_warm)
    return {
        "name": "fleet/gray_replica",
        "passed": bool(passed),
        "detail": {"requests": len(storm_lat) + len(after_lat) + 18,
                   "lost": lost, "mismatched": mismatched,
                   "ejected": ejected, "suspect_skipped": suspect_skipped,
                   "p99_storm_s": round(p99_storm, 3),
                   "p99_after_ejection_s": round(p99_after, 3),
                   "brownouts": brownouts, "readmitted": readmitted,
                   "took_traffic_after": took_traffic,
                   "hit_rate_recovered": hit_recovered,
                   "rebuilds": s["replicas"]["chaos_gray-r1"]["restarts"],
                   "compiles_after_warmup": compiles - n_warm,
                   "suspect_reason": slow.last_error,
                   "router": s["router"]},
    }


def fleet_flash_spike(net):
    """Elastic-fleet chaos: a loadgen flash-spike trace (10x
    arrival-rate step) replays against a 1-replica fleet with the
    autoscaler ON.  Invariants: ZERO interactive requests lost (typed
    refusals land on best_effort); the autoscaler grows the fleet off
    sustained pressure and its decision events carry the justifying
    signals; a scale-DOWN executed under live load loses zero requests
    and zero tokens; and no replica compiles on traffic after its
    warmup — including newcomers, which warm BEFORE joining."""
    import numpy as onp

    from mxnet_tpu_torch.fleet import FleetAutoscaler, FleetRouter
    from mxnet_tpu_torch.observability import flightrecorder as _flightrec
    from mxnet_tpu_torch.resilience import FaultPlan

    sys.path.insert(0, _TOOLS)
    import loadgen

    trace = loadgen.flash_spike(
        duration=6.0, base_rps=8.0, spike_factor=10.0,
        spike_start=0.25, spike_len=0.3, seed=17, families=3,
        shared_len=_L(10), tail_len=_L(3), vocab=CFG.vocab,
        max_new_tokens=3, interactive_frac=0.5)

    def spike_factory(name):
        # deep admission queue: interactive absorbs the spike front by
        # WAITING (brownout sheds best_effort)
        return _engine(net, name=name, prefix_pool_rows=2,
                       prefix_min_tokens=_L(2), queue_depth=256)

    fleet = FleetRouter(factory=spike_factory, num_replicas=1,
                        name="chaos_spike", health_interval=0.03,
                        probation=0.3, breaker_threshold=100)
    fleet.warmup()
    scaler = FleetAutoscaler(
        fleet, min_replicas=1, max_replicas=3, interval=0.03,
        queue_high=3, queue_low=1, util_low=0.9,
        up_cycles=2, down_cycles=200,
        up_cooldown=0.5, down_cooldown=0.5)
    # an unscoped decode-step delay makes the model SLOW relative to
    # the spike; it applies to newcomers too
    plan = FaultPlan().delay_at("serving.decode_step", 0.02, every=1)
    lost_post = mismatched = 0
    with fleet:
        with scaler:
            with plan:
                report = loadgen.replay(trace, fleet, timeout=120.0)
        grew = fleet.stats()["router"].get("scale_ups", 0)
        fr = _flightrec.active()
        ups = fr.events("fleet.scale_up") if fr is not None else []
        signals_attached = all("sig_queue_max" in e.attrs for e in ups)
        # scale-down UNDER LOAD
        prompts = _family_prompts(29, 8)
        refs = [_gen(net, p, 3) for p in prompts]
        if len(fleet._healthy()) == 1:
            fleet.scale_up(signals={"reason": "chaos_setup"})
        futs = [fleet.submit(p, max_new_tokens=3,
                             priority="interactive") for p in prompts]
        removed = fleet.scale_down(signals={"reason": "chaos"})
        for ref, f in zip(refs, futs):
            try:
                out = f.result(60)
                if not onp.array_equal(out, ref):
                    mismatched += 1
            except Exception:
                lost_post += 1
        # compile freeze over a verification wave
        s0 = fleet.stats()
        compiles0 = {n: rep["stats"]["compile_cache"]["compiles"]
                     for n, rep in s0["replicas"].items()
                     if "stats" in rep}
        for ref, p in zip(refs, prompts):
            try:
                out = fleet.infer(p, max_new_tokens=3, timeout=30.0,
                                  priority="interactive")
                if not onp.array_equal(out, ref):
                    mismatched += 1
            except Exception:
                lost_post += 1
        s = fleet.stats()
        compiles1 = {n: rep["stats"]["compile_cache"]["compiles"]
                     for n, rep in s["replicas"].items()
                     if "stats" in rep}
        frozen = compiles1 == compiles0
    _join_zombies()
    inter = report["by_priority"].get("interactive",
                                      {"issued": 0, "lost": 0,
                                       "errors": 0, "rejected": 0})
    issued = max(1, inter["issued"] + inter["rejected"])
    inter_err_frac = (inter["lost"] + inter["errors"]
                      + inter["rejected"]) / issued
    passed = (report["lost"] == 0 and lost_post == 0
              and mismatched == 0
              and inter["lost"] == 0
              and inter_err_frac <= 0.1
              and grew >= 1 and signals_attached
              and removed is not None
              and s["router"].get("scale_downs", 0) >= 1
              and frozen)
    return {
        "name": "fleet/flash_spike",
        "passed": bool(passed),
        "detail": {"trace_events": report["events"],
                   "replay": {k: report[k] for k in
                              ("issued", "completed", "rejected",
                               "errors", "lost")},
                   "interactive": inter,
                   "interactive_error_fraction":
                       round(inter_err_frac, 4),
                   "scale_ups": grew,
                   "scale_up_events_with_signals": signals_attached,
                   "scaled_down_under_load": removed,
                   "post_wave_lost": lost_post,
                   "mismatched": mismatched,
                   "compile_frozen_post_scale": frozen,
                   "router": s["router"]},
    }


def _disagg_kill(net, label, role_of, site, at, prompts):
    """Shared body for the disaggregated kill scenarios: a role-split
    paged fleet loses one replica to an injected kill at ``site`` while
    family traffic flows.  Invariants: ZERO lost requests, every output
    token-correct, the monitor rebuilds the corpse AND re-wires its
    migration egress, the survivors' compile counters stay frozen, and
    a full prefix eviction returns every page of every pool with zero
    refs."""
    import numpy as onp

    from mxnet_tpu_torch.fleet import FleetRouter
    from mxnet_tpu_torch.resilience import FaultPlan

    refs = [_gen(net, p, 3) for p in prompts]

    def factory(nm):
        return _engine(net, name=nm, kv_layout="paged", page_size=_L(8),
                       prefix_pool_rows=2, prefix_min_tokens=_L(2),
                       role=role_of(nm))

    fleet = FleetRouter(factory=factory, num_replicas=3, name=label,
                        health_interval=0.03, probation=0.3)
    fleet.warmup()
    warm = {h.name: h.engine.stats()["compile_cache"]["compiles"]
            for h in fleet._handles}
    plan = FaultPlan().kill_at(site, at=at)
    lost = mismatched = 0
    with plan:
        with fleet:
            futs = [fleet.submit(p, max_new_tokens=3) for p in prompts]
            for ref, f in zip(refs, futs):
                try:
                    out = f.result(timeout=60)
                    if not onp.array_equal(out, ref):
                        mismatched += 1
                except Exception:
                    lost += 1
            mid = fleet.stats()["router"]
            deaths = mid.get("replica_deaths", 0)
            mig_before = mid.get("migrations", 0)
            deadline = time.monotonic() + 20
            while len(fleet._healthy()) < 3 and time.monotonic() < deadline:
                time.sleep(0.05)
            recovered = len(fleet._healthy()) == 3
            for ref, p in zip(refs, prompts):
                try:
                    out = fleet.infer(p, max_new_tokens=3)
                    if not onp.array_equal(out, ref):
                        mismatched += 1
                except Exception:
                    lost += 1
            s = fleet.stats()
            mig_after = s["router"].get("migrations", 0)
            restarted = {h.name for h in fleet._handles if h.restarts}
            rewired = all(h.engine.stats()["engine"]["migrate_target"]
                          for h in fleet._handles if h.role == "prefill")
            frozen = all(h.engine.stats()["compile_cache"]["compiles"]
                         == warm[h.name]
                         for h in fleet._handles
                         if h.name not in restarted)
            # refcount audit: drain every pool's parked prefix entries,
            # then every page must be free with zero readers
            clean = True
            for h in fleet._handles:
                eng = h.engine
                with eng._step_lock:
                    eng._prefix.evict_pages(eng.num_pages)
                clean = clean and (
                    eng._pool.free_count == eng.num_pages
                    and all(r == 0 for r in eng._pool._refs))
    _join_zombies()
    passed = (lost == 0 and mismatched == 0 and deaths >= 1 and recovered
              and plan.fired(site) >= 1 and mig_after > mig_before
              and mig_before > 0 and rewired and frozen and clean)
    return {
        "name": f"fleet/{label.replace('chaos_', 'disagg_')}",
        "passed": bool(passed),
        "detail": {"requests": 2 * len(prompts), "lost": lost,
                   "mismatched": mismatched, "replica_deaths": deaths,
                   "readmitted": recovered, "rewired": rewired,
                   "compile_frozen": frozen, "pools_refcount_clean": clean,
                   "migrations_before_kill_wave": mig_before,
                   "migrations_total": mig_after,
                   "restarted": sorted(restarted),
                   "roles": s["fleet"]["roles"],
                   "directory": s["fleet"]["directory"],
                   "router": s["router"],
                   "faults_fired": plan.fired()},
    }


def disagg_prefill_kill(net):
    """Kill a PREFILL replica mid-migration (the kill fires at its
    ``serving.migrate_out`` site): riders fail over to the surviving
    prefill replica and keep migrating to the decode pool."""
    return _disagg_kill(
        net, "chaos_pkill",
        role_of=lambda nm: "decode" if nm.endswith("r2") else "prefill",
        site="serving.migrate_out@chaos_pkill-r0", at=1,
        prompts=_family_prompts(6, 10))


def disagg_decode_kill(net):
    """Kill a DECODE replica mid-stream (second decode cycle after it
    adopted migrated requests): its riders fail over, re-prefill, and
    re-migrate to the surviving decode pool — token-identical."""
    # varied (non-family) prompts so decode placement spreads over BOTH
    # decode replicas and the scoped victim is guaranteed traffic
    prompts = _prompts(tuple(range(4, 14)), seed=6)
    return _disagg_kill(
        net, "chaos_dkill",
        role_of=lambda nm: "prefill" if nm.endswith("r0") else "decode",
        site="serving.decode_step@chaos_dkill-r1", at=2, prompts=prompts)


# ------------------------------------------------------- training scenarios

def _make_trainer(mlp=False, **kw):
    """The reference's MLP trainer (6 -> 16 -> 2, Adam 0.01) on the
    CPU, or with ``CFG.train_gpt`` the card's GPT-2 trainer (Adam 1e-3,
    one seeded set of weights)."""
    import numpy as onp

    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    if CFG.train_gpt and not mlp:
        from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
        net = get_gpt2("gpt2_124m", device=CFG.device, **CFG.train_cfg)
        net.initialize(seed=0)
        return par.ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                                  optimizer_params={"learning_rate": 1e-3},
                                  **kw)
    w1 = onp.random.RandomState(42).randn(16, 6).astype("float32") * 0.1
    w2 = onp.random.RandomState(43).randn(2, 16).astype("float32") * 0.1
    with _ctx():
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu", in_units=6),
                nn.Dense(2, in_units=16))
        net.initialize()
    load_numpy_params(net, {"0.weight": w1,
                            "0.bias": onp.zeros(16, "float32"),
                            "1.weight": w2,
                            "1.bias": onp.zeros(2, "float32")})
    return par.ShardedTrainer(
        net, "adam", loss=gluon.loss.SoftmaxCrossEntropyLoss(),
        optimizer_params={"learning_rate": 0.01}, **kw)


def _make_iter():
    import numpy as onp

    def gen():
        for i in range(100):
            rs = onp.random.RandomState(1000 + i)
            if CFG.train_gpt:
                v = CFG.train_cfg["vocab_size"]
                shape = (CFG.train_b, CFG.train_t)
                yield (rs.randint(0, v, shape).astype("int32"),
                       rs.randint(0, v, shape).astype("int32"))
                continue
            X = rs.randn(8, 6).astype("float32")
            yield (X, (X.sum(1) > 0).astype("int32"))
    return gen()


def _params(tr):
    return [p.detach().cpu().numpy().copy() for _n, p in tr._trainable]


def training_kill_resume(kills=3, steps=12):
    import numpy as onp

    from mxnet_tpu_torch.resilience import (FaultPlan, ResilientLoop,
                                            SimulatedPreemption)
    workdir = tempfile.mkdtemp(prefix="chaos_sweep_")
    try:
        tr = _make_trainer()
        loop = ResilientLoop(tr, os.path.join(workdir, "ref"),
                             save_every=2, seed=7)
        loop.run(_make_iter, steps)
        ref = _params(tr)

        plan = FaultPlan(seed=0)
        for k in range(kills):
            plan.kill_at("trainer.step", at=3 + 4 * k)
        seen_kills, report = 0, None
        with plan:
            for _ in range(kills + 3):
                tr2 = _make_trainer()
                loop2 = ResilientLoop(tr2, os.path.join(workdir, "chaos"),
                                      save_every=2, seed=7)
                try:
                    report = loop2.run(_make_iter, steps)
                    break
                except SimulatedPreemption:
                    seen_kills += 1
        got = _params(tr2)
        exact = all(onp.array_equal(a, b) for a, b in zip(ref, got))
        passed = (seen_kills == kills and report is not None
                  and report["completed_steps"] == steps and exact)
        return {
            "name": "training/kill_resume_determinism",
            "passed": bool(passed),
            "detail": {"kills": seen_kills,
                       "resumed_from": report and report["resumed_from"],
                       "params_bit_identical": bool(exact),
                       "commits": loop2.metrics.counters[
                           "checkpoint_commits"]},
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def training_commit_kill():
    import numpy as onp
    import torch

    from mxnet_tpu_torch.resilience import (AtomicCheckpointer, FaultPlan,
                                            SimulatedPreemption)
    workdir = tempfile.mkdtemp(prefix="chaos_sweep_")
    dev = torch.device(CFG.device)
    try:
        ck = AtomicCheckpointer(workdir)
        ck.save(1, {"w": torch.ones(4, device=dev)})
        died = False
        with FaultPlan().kill_at("checkpoint.commit", at=1):
            try:
                ck.save(2, {"w": torch.zeros(4, device=dev)})
            except SimulatedPreemption:
                died = True
        tree, _ = AtomicCheckpointer(workdir).restore()
        intact = bool(onp.array_equal(onp.asarray(tree["w"]),
                                      onp.ones(4, "float32")))
        return {
            "name": "training/kill_mid_commit",
            "passed": died and ck.latest_step() == 1 and intact,
            "detail": {"died_mid_save": died, "latest": ck.latest_step(),
                       "previous_intact": intact},
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def verify_checkpoint_dir(directory: str) -> dict:
    """``tools/verify_checkpoint.py``'s report over an
    ``AtomicCheckpointer`` directory, through the port's
    ``verify_step_dir``."""
    from mxnet_tpu_torch.resilience.integrity import verify_step_dir
    directory = os.path.abspath(directory)
    steps, quarantined = {}, []
    counts = {"intact": 0, "legacy": 0, "corrupt": 0}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if not os.path.isdir(path):
            continue
        if name.startswith("corrupt-"):
            quarantined.append(name)
            continue
        if not name.startswith("step-"):
            continue
        status, reason = verify_step_dir(path)
        rec = {"status": status}
        if reason:
            rec["reason"] = reason
        steps[name] = rec
        counts[status] += 1
    return {"directory": directory, "steps": steps,
            "quarantined": quarantined, **counts,
            "ok": counts["corrupt"] == 0}


def _verify_cli(ckdir):
    """Run this file's ``--verify-checkpoint`` in a fresh process (the
    reference's scenario runs ``tools/verify_checkpoint.py``)."""
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--verify-checkpoint",
         ckdir], capture_output=True, text=True)


def training_checkpoint_corruption(steps=12):
    """Verified-checkpoint chaos: training is KILLED, and the latest
    committed step's bytes rot on disk (the ``checkpoint.corrupt`` fault
    flips them right after the commit rename).  Contract: the resumed
    run detects the corruption via the manifest, QUARANTINES the dir,
    falls back to the newest intact step, replays forward, and finishes
    with parameters BIT-IDENTICAL to the fault-free run — and the
    checkpoint verifier flags the rotted dir with a nonzero exit before
    quarantine, zero after."""
    import numpy as onp

    from mxnet_tpu_torch.resilience import (FaultPlan, ResilientLoop,
                                            SimulatedPreemption)
    workdir = tempfile.mkdtemp(prefix="chaos_sweep_")
    ckdir = os.path.join(workdir, "chaos")
    try:
        tr = _make_trainer()
        loop = ResilientLoop(tr, os.path.join(workdir, "ref"),
                             save_every=2, seed=7)
        loop.run(_make_iter, steps)
        ref = _params(tr)

        # saves land after steps 2/4/6; corrupt_at(at=3) rots the
        # step-6 commit, kill_at(at=7) dies on the 7th step
        plan = (FaultPlan()
                .kill_at("trainer.step", at=7)
                .corrupt_at("checkpoint.corrupt", at=3))
        died = False
        with plan:
            tr2 = _make_trainer()
            loop2 = ResilientLoop(tr2, ckdir, save_every=2, seed=7)
            try:
                loop2.run(_make_iter, steps)
            except SimulatedPreemption:
                died = True
            cli = _verify_cli(ckdir)
            flagged = cli.returncode == 1 and '"corrupt"' in cli.stdout
            tr3 = _make_trainer()              # "fresh process"
            loop3 = ResilientLoop(tr3, ckdir, save_every=2, seed=7)
            report = loop3.run(_make_iter, steps)
        got = _params(tr3)
        exact = all(onp.array_equal(a, b) for a, b in zip(ref, got))
        quarantined = loop3.checkpointer.quarantined()
        cli2 = _verify_cli(ckdir)
        passed = (died and flagged
                  and report["resumed_from"] == 4
                  and report["completed_steps"] == steps
                  and report["checkpoint_fallbacks"] == 1
                  and quarantined == ["corrupt-00000006"]
                  and exact and cli2.returncode == 0)
        return {
            "name": "training/checkpoint_corruption",
            "passed": bool(passed),
            "detail": {"died": died, "cli_flagged_corruption": flagged,
                       "resumed_from": report["resumed_from"],
                       "checkpoint_fallbacks":
                           report["checkpoint_fallbacks"],
                       "quarantined": quarantined,
                       "params_bit_identical": bool(exact),
                       "cli_exit_after_quarantine": cli2.returncode,
                       "faults_fired": plan.fired()},
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ------------------------------------------------- guardrail scenarios

def _finite(tr):
    import numpy as onp
    return all(bool(onp.isfinite(p).all()) for p in _params(tr))


def training_nan_storm(steps=10):
    """NaN storm: 3 consecutive steps with injected non-finite
    gradients.  Contract: each bad step SKIPS the update (params stay
    finite), the dynamic loss scale halves per bad step, and training
    then recovers and completes."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.resilience import FaultPlan, ResilientLoop
    workdir = tempfile.mkdtemp(prefix="chaos_sweep_")
    try:
        tr = _make_trainer(loss_scaler=amp.LossScaler(init_scale=2.0 ** 16))
        loop = ResilientLoop(tr, os.path.join(workdir, "storm"),
                             save_every=2, seed=7)
        plan = FaultPlan().nonfinite_at("trainer.grad_nonfinite",
                                        every=1, max_fires=3)
        with plan:
            report = loop.run(_make_iter, steps)
        scale = tr.loss_scale
        finite = _finite(tr)
        passed = (report["completed_steps"] == steps
                  and report["bad_steps"] == 3
                  and scale == 2.0 ** 13      # halved 3x, no regrow
                  and finite)
        return {
            "name": "training/nan_storm_scale_halves",
            "passed": bool(passed),
            "detail": {"bad_steps": report["bad_steps"],
                       "loss_scale": scale,
                       "params_finite": bool(finite),
                       "faults_fired": plan.fired()},
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def training_persistent_nan_rewind(steps=10):
    """Persistent NaN: 4 consecutive poisoned steps trip the
    ``on_bad_step='rewind'`` policy — the loop restores the last
    committed checkpoint (params + loss scale) and completes."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.resilience import FaultPlan, ResilientLoop
    workdir = tempfile.mkdtemp(prefix="chaos_sweep_")
    try:
        tr = _make_trainer(loss_scaler=amp.LossScaler())
        loop = ResilientLoop(tr, os.path.join(workdir, "rewind"),
                             save_every=2, seed=7,
                             on_bad_step="rewind", rewind_after=2)
        plan = FaultPlan()
        for hit in (5, 6, 7, 8):
            plan.nonfinite_at("trainer.grad_nonfinite", at=hit)
        with plan:
            report = loop.run(_make_iter, steps)
        finite = _finite(tr)
        passed = (report["completed_steps"] == steps
                  and report["bad_steps"] == 4
                  and report["rewinds"] >= 1 and finite)
        return {
            "name": "training/persistent_nan_rewind",
            "passed": bool(passed),
            "detail": {"bad_steps": report["bad_steps"],
                       "rewinds": report["rewinds"],
                       "params_finite": bool(finite),
                       "faults_fired": plan.fired()},
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def training_bad_batch_quarantine(steps=4):
    """A poisoned INPUT batch (``io.bad_batch``) is quarantined by the
    iterator — skipped and counted, never fed to the trainer — so the
    training step count is unaffected.  The reference's MLP on both
    devices: the poison is a float batch's NaN."""
    import numpy as onp

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.resilience import FaultPlan, ResilientLoop
    from mxnet_tpu_torch.serving.metrics import ServingMetrics
    workdir = tempfile.mkdtemp(prefix="chaos_sweep_")
    try:
        metrics = ServingMetrics("resilience")
        tr = _make_trainer(mlp=True, guard_nonfinite=True)
        rs = onp.random.RandomState(0)
        X = rs.randn(40, 6).astype("float32")
        y = (X.sum(1) > 0).astype("int32")
        with _ctx():
            it = mx.io.NDArrayIter(X, y, batch_size=8,
                                   quarantine_nonfinite=True,
                                   last_batch_handle="discard",
                                   metrics=metrics)

        def make_iter():
            it.reset()
            return ((b.data[0], b.label[0]) for b in it)

        loop = ResilientLoop(tr, os.path.join(workdir, "quar"),
                             save_every=2, seed=3, metrics=metrics)
        plan = FaultPlan().nonfinite_at("io.bad_batch", at=2)
        with plan:
            report = loop.run(make_iter, steps)
        exported = metrics.stats()["resilience"]["quarantined_batches"]
        passed = (report["completed_steps"] == steps
                  and it.quarantined == 1 and exported == 1
                  and report["bad_steps"] == 0)
        return {
            "name": "training/bad_batch_quarantine",
            "passed": bool(passed),
            "detail": {"quarantined": it.quarantined,
                       "quarantined_batches_exported": exported,
                       "completed_steps": report["completed_steps"],
                       "bad_steps": report["bad_steps"],
                       "faults_fired": plan.fired()},
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def training_input_stall(steps=12):
    """Input-pipeline chaos: training runs behind a
    ``DevicePrefetcher`` whose feeder is faulted three ways —
    ``data.prefetch`` raises (degrade that batch to a synchronous host
    hand-off), ``data.device_put`` raises (retry once, then host-array
    fallback), and a ``kill_at`` crashes the feeder THREAD mid-epoch
    (the consumer takes over at the clean offset).  Contract: the run
    completes without a restart, parameters are BIT-IDENTICAL to the
    unprefetched reference, every degrade is counted, the feeder crash
    lands in the flight recorder, and the on-device augment lattice
    stays frozen — zero compiles post-warmup."""
    import numpy as onp

    from mxnet_tpu_torch.data import DevicePrefetcher, DeviceTransform
    from mxnet_tpu_torch.observability import flightrecorder as _flightrec
    from mxnet_tpu_torch.resilience import FaultPlan, ResilientLoop
    workdir = tempfile.mkdtemp(prefix="chaos_sweep_")
    try:
        tr = _make_trainer()
        loop = ResilientLoop(tr, os.path.join(workdir, "ref"),
                             save_every=2, seed=7)
        loop.run(_make_iter, steps)
        ref = _params(tr)

        tr2 = _make_trainer()
        loop2 = ResilientLoop(tr2, os.path.join(workdir, "chaos"),
                              save_every=2, seed=7)
        pf_box = []

        def make_iter():
            with _ctx():
                pf = DevicePrefetcher(_make_iter(), depth=2)
            pf_box.append(pf)
            return pf

        plan = (FaultPlan(seed=0)
                .raise_at("data.prefetch", every=3)
                .raise_at("data.device_put", at=1)
                .kill_at("data.prefetch", at=5))
        with plan:
            report = loop2.run(make_iter, steps)
        got = _params(tr2)
        exact = all(onp.array_equal(a, b) for a, b in zip(ref, got))
        st = pf_box[-1].stats()
        fr = _flightrec.active()
        crash_seen = any(e.name == "data.feeder_crash"
                         for e in fr.events()) if fr else False

        # on-device augment lattice: warm one (shape, dtype) point,
        # freeze, and replay the epoch — any post-warmup compile would
        # raise out of apply()
        with _ctx():
            tf = DeviceTransform(mean=(0.5, 0.5, 0.5), std=(0.25,) * 3,
                                 crop=6, mirror=True, layout="NHWC",
                                 dtype="float32", seed=3)
            x = onp.random.RandomState(9).randint(
                0, 255, size=(8, 8, 8, 3)).astype("uint8")
            tf.apply(x, step=0)
            tf.freeze()
            for s in range(1, steps):
                tf.apply(x, step=s)
        frozen_ok = tf.compile_count == 1

        passed = (report is not None
                  and report["completed_steps"] == steps
                  and exact
                  and st["crashed"] == "SimulatedPreemption"
                  and st["batches_fallback"] > 0
                  and st["batches_shipped"] > 0
                  and frozen_ok)
        return {
            "name": "training/input_stall",
            "passed": bool(passed),
            "detail": {"completed_steps": report["completed_steps"],
                       "params_bit_identical": bool(exact),
                       "feeder_crashed": st["crashed"],
                       "feeder_crash_recorded": bool(crash_seen),
                       "batches_shipped": st["batches_shipped"],
                       "batches_fallback": st["batches_fallback"],
                       "input_wait_seconds_total": round(
                           st["input_wait_seconds_total"], 4),
                       "augment_compiles": tf.compile_count,
                       "faults_fired": plan.fired()},
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ------------------------------------------------- raceguard corroboration

def corroboration_probes(net):
    """Drive the guard sites the matrix's scenarios legitimately never
    reach: each probe takes the cold lock on its PUBLIC surface so the
    statically-claimed guard is proven to be the lock actually acquired
    at runtime.  Returns a list of (site, how) records for the report."""
    import numpy as onp

    probed = []
    # standalone DynamicBatcher: engines pass their own condition in,
    # so the batcher's named condition only exists standalone
    from mxnet_tpu_torch.serving.batcher import DynamicBatcher
    from mxnet_tpu_torch.serving.engine import Request
    b = DynamicBatcher(max_depth=4)
    b.put(Request("forward", onp.zeros((2, 2), "float32")))
    b.drain()
    b.close()
    probed.append(("serving.batcher.cond",
                   "standalone DynamicBatcher put/drain/close"))
    # tracer lifecycle: the global active-tracer swap and the ring lock
    from mxnet_tpu_torch.observability import trace
    tr = trace.enable(capacity=16)
    tr.event("chaos.corroboration_probe")
    trace.disable()
    probed.append(("obs.trace_global + obs.trace_ring",
                   "trace.enable/event/disable"))
    # process RNG reseed (the generator lock)
    import mxnet_tpu_torch as mx
    mx.random.seed(20260804)
    probed.append(("random.generator", "mx.random.seed"))
    # seeded-random routing: the only policy that takes the router's
    # rng lock — a 2-replica fleet serving a few requests through it
    fleet = _fleet(net, n=2, name="probe_rand", routing="random")
    fleet.warmup()
    with fleet:
        for p in _prompts((3, 4, 5), seed=21):
            fleet.infer(p, max_new_tokens=2)
    _join_zombies()
    probed.append(("fleet.router.rng", "routing='random' fleet wave"))
    # multi-leaf digest: the shared leaf-hash pool (and its lock) only
    # exists for files >= one tree chunk
    from mxnet_tpu_torch.resilience.integrity import _TREE_CHUNK, file_digest
    workdir = tempfile.mkdtemp(prefix="probe_digest_")
    try:
        big = os.path.join(workdir, "big.bin")
        with open(big, "wb") as f:
            f.write(os.urandom(2 * _TREE_CHUNK + 17))
        file_digest(big)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    probed.append(("integrity.digest_pool",
                   "file_digest of a multi-leaf (2 MB) file"))
    # all-replicas-shed saturation tracking: a 1-replica fleet with a
    # depth-1 queue, flooded until a submit sheds fleet-wide
    from mxnet_tpu_torch.fleet import FleetRouter
    from mxnet_tpu_torch.serving import QueueFullError

    def tiny_factory(name):
        return _engine(net, name=name, queue_depth=1,
                       max_wait_us=200000.0)

    sat = FleetRouter(factory=tiny_factory, num_replicas=1,
                      name="probe_sat", health_interval=0.05,
                      saturation_threshold=1)
    sat.warmup()
    sheds = 0
    with sat:
        futs = []
        for p in _prompts(tuple(range(2, 14)), seed=23):
            try:
                futs.append(sat.submit(p, max_new_tokens=3))
            except QueueFullError:
                sheds += 1
        _resolve_all(futs, timeout=60)
    _join_zombies()
    probed.append(("fleet.router.saturation",
                   f"1-replica depth-1 flood ({sheds} fleet-wide sheds)"))
    # SLO tracker state lock: only constructed when objectives are
    # declared, which the matrix scenarios themselves never do
    from mxnet_tpu_torch.observability import SLO, SLOTracker
    from mxnet_tpu_torch.serving.metrics import ServingMetrics
    sm = ServingMetrics("probe_slo", register=False)
    sm.count("completed", 5)
    trk = SLOTracker(SLO("probe_slo", availability=0.99), sm,
                     register=False)
    trk.evaluate()
    trk.reset()
    probed.append(("obs.slo", "SLOTracker evaluate/reset over probe "
                              "metrics"))
    return probed


def raceguard_corroboration(witness, probed):
    """Close the static<->dynamic loop: every lock site the port's
    guard map claims must have been ACQUIRED somewhere in the sweep
    (minus the device's justified exemptions), and every site the
    witness saw must be statically mapped."""
    from mxnet_tpu_torch.analysis import raceguard
    gmap = raceguard.build_guard_map(
        [os.path.join(_REPO, "mxnet_tpu_torch")], root=_REPO)
    verdict = raceguard.corroborate(
        gmap, witness.report()["per_site"],
        exempt=raceguard.corroboration_exempt(CFG.device))
    return {
        "name": "raceguard_corroboration",
        "passed": bool(verdict["passed"]),
        "detail": {
            "mapped_sites": verdict["mapped_sites"],
            "witnessed_sites": verdict["witnessed_sites"],
            "unexercised": verdict["unexercised"],
            "unmapped": verdict["unmapped"],
            "exempt": verdict["exempt"],
            "probes": [f"{site}: {how}" for site, how in probed],
            "acquisitions_per_mapped_site":
                verdict["acquisitions_per_mapped_site"],
        },
    }


# --------------------------------------------------------------- forensics

#: scenarios whose failure path must hit an AUTOMATIC flight-recorder
#: trigger (not the end-of-scenario dump): scenario -> acceptable
#: trigger names
FORENSICS_AUTO = {
    "scheduler_crash": ("watchdog.trip", "serving.crash"),
    "hung_step": ("watchdog.trip", "serving.crash"),
    "sigterm_drain": ("signal.sigterm",),
    "exporter_storm": ("signal.sigterm", "watchdog.trip",
                       "serving.crash"),
    "replica_kill": ("fleet.replica_death", "watchdog.trip",
                     "serving.crash"),
    "retry_storm": ("fleet.replica_death", "watchdog.trip",
                    "serving.crash"),
    "disagg_prefill_kill": ("fleet.replica_death", "watchdog.trip",
                            "serving.crash"),
    "disagg_decode_kill": ("fleet.replica_death", "watchdog.trip",
                           "serving.crash"),
}


def forensics_scenario(forensic_log, obs_bundle):
    """The failure-time forensics contract: every scenario in the
    matrix produced at least one bundle, every bundle parses through
    ``tools/obs_bundle.py`` and names its triggering event, and the
    scenarios whose failure path crosses an automatic trigger bundled
    themselves AT the failure edge."""
    problems = []
    parsed = 0
    auto_ok = {}
    for entry in forensic_log:
        name = entry["scenario"]
        if not entry["bundles"]:
            problems.append(f"{name}: no bundle on disk")
            continue
        triggers = []
        for path in entry["bundles"]:
            try:
                b = obs_bundle.load_bundle(path)
            except obs_bundle.BundleError as e:
                problems.append(f"{name}: {e}")
                continue
            parsed += 1
            triggers.append(b["trigger"]["name"])
        if not triggers:
            problems.append(f"{name}: no parseable bundle")
            continue
        expect = FORENSICS_AUTO.get(name)
        if expect is not None:
            hit = [t for t in triggers if t in expect]
            auto_ok[name] = bool(hit)
            if not hit:
                problems.append(
                    f"{name}: expected an automatic trigger from "
                    f"{expect}, bundles carried {triggers}")
    return {
        "name": "forensics",
        "passed": not problems,
        "detail": {
            "scenarios_checked": len(forensic_log),
            "bundles_parsed": parsed,
            "auto_triggered": auto_ok,
            "problems": problems,
            "per_scenario": [
                {"scenario": e["scenario"],
                 "auto_bundles": e["auto_bundles"],
                 "events": e["event_names"]}
                for e in forensic_log],
        },
    }


# -------------------------------------------------------------------- main

def _launches():
    """{kernel wrapper: launches so far} (``ops/launches.py``)."""
    import mxnet_tpu_torch.ops  # noqa: F401  (registers the wrappers)
    from mxnet_tpu_torch.ops import launches
    return launches.totals()


# launches made while a fault-free reference or a warm-up ran: while at
# least one runs (any thread), every launch goes here
_ASIDE = {"depth": 0, "since": {}, "n": {}}
_ASIDE_LOCK = threading.Lock()


@contextlib.contextmanager
def _aside():
    """Keep the body's launches (a fault-free reference, a warm-up) out of
    the counts of the traffic under test.  The counters are global, so
    what an engine serves meanwhile goes aside too: :func:`counted`'s
    served counts are lower bounds, never inflated by a reference."""
    with _ASIDE_LOCK:
        if _ASIDE["depth"] == 0:
            _ASIDE["since"] = _launches()
        _ASIDE["depth"] += 1
    try:
        yield
    finally:
        with _ASIDE_LOCK:
            _ASIDE["depth"] -= 1
            if _ASIDE["depth"] == 0:
                now, since, n = _launches(), _ASIDE["since"], _ASIDE["n"]
                for k, v in now.items():
                    n[k] = n.get(k, 0) + v - since.get(k, 0)


def counted(body):
    """Run ``body()``; returns ({kernel: launches of the traffic under
    test}, {kernel: launches of its references and warm-ups})."""
    before, aside0 = _launches(), dict(_ASIDE["n"])
    body()
    after = _launches()
    aside = {k: _ASIDE["n"].get(k, 0) - aside0.get(k, 0) for k in after}
    return ({k: after[k] - before.get(k, 0) - aside[k] for k in after},
            aside)


def _platform():
    import torch
    if CFG.device == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chaos_report.json")
    ap.add_argument("--kills", type=int, default=3)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the sweep runs (default: the card; "
                         "raises without one)")
    ap.add_argument("--layers", type=int, default=2,
                    help="GPT-2 layers of the card's serving nets")
    ap.add_argument("--lockwitness", action="store_true",
                    help="run the WHOLE sweep under the lock-order "
                         "witness; appends a 'lockwitness' scenario that "
                         "fails on any witnessed cycle or unallowlisted "
                         "finding")
    ap.add_argument("--corroborate", action="store_true",
                    help="cross-check the port's static guard map "
                         "against the witness acquisition dump (implies "
                         "--lockwitness); appends a "
                         "'raceguard_corroboration' scenario")
    ap.add_argument("--sharded-rank", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--verify-checkpoint", default=None, metavar="DIR",
                    help="print the integrity report of a checkpoint "
                         "directory; exit 1 on corruption")
    args = ap.parse_args(argv)

    if args.verify_checkpoint is not None:
        rep = verify_checkpoint_dir(args.verify_checkpoint)
        print(json.dumps(rep, indent=2))
        return 0 if rep["ok"] else 1

    if args.corroborate:
        args.lockwitness = True

    witness = None
    if args.lockwitness and args.sharded_rank is None:
        # enable via the env knob BEFORE the first port import: the
        # package's eager imports construct module-level locks, and the
        # env check runs in lockwitness's module body, ahead of every
        # named_lock call in the tree
        os.environ["MXTPU_LOCKWITNESS"] = "1"
        from mxnet_tpu_torch.analysis import lockwitness as _lw
        witness = _lw.active_witness() or _lw.enable()

    configure(args.device, args.layers)
    if args.sharded_rank is not None:
        _sharded_rank(args.sharded_rank)
        return 0
    platform = _platform()

    from mxnet_tpu_torch.observability import flightrecorder as _flightrec
    sys.path.insert(0, _TOOLS)
    import obs_bundle as _obs_bundle

    bundles_root = tempfile.mkdtemp(prefix="mxtpu-chaos-bundles-")
    forensic_log = []
    scenarios = []
    launches = {}

    def run(fn, *a, _label=None, **kw):
        label = _label or getattr(fn, "__name__", str(fn))
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in label)
        fr = _flightrec.enable(
            bundle_dir=os.path.join(bundles_root, safe),
            min_interval=0.25)
        t0 = time.perf_counter()
        try:
            rec = fn(*a, **kw)
            recs = rec if isinstance(rec, list) else [rec]
        except Exception:
            recs = [{"name": label,
                     "passed": False,
                     "detail": {"error": traceback.format_exc(limit=5)}}]
        auto = fr.bundles()
        if not auto:
            fr.dump("chaos.scenario_end", scenario=label)
        forensic_log.append({
            "scenario": label,
            "auto_bundles": [os.path.basename(p) for p in auto],
            "bundles": fr.bundles(),
            "event_names": sorted({e.name for e in fr.events()}),
        })
        _flightrec.disable()
        for r in recs:
            r["seconds"] = round(time.perf_counter() - t0, 2)
            scenarios.append(r)
            print(f"[{'PASS' if r['passed'] else 'FAIL'}] {r['name']} "
                  f"({r['seconds']}s)", flush=True)

    net = _tiny_gpt2()

    def serving():
        for _name, thunk in serving_scenarios(net):
            run(thunk, _label=_name)

    def training():
        run(training_kill_resume, kills=args.kills, steps=args.steps)
        run(training_commit_kill)
        run(training_checkpoint_corruption)
        run(training_nan_storm)
        run(training_persistent_nan_rewind)
        run(training_bad_batch_quarantine)
        run(training_input_stall, steps=args.steps)

    launches["serve"], launches["serve_aside"] = counted(serving)
    launches["train"], launches["train_aside"] = counted(training)

    run(lambda: forensics_scenario(forensic_log, _obs_bundle),
        _label="forensics")

    probed = []
    if witness is not None and args.corroborate:
        # cold-site probes run UNDER the witness, before its report is
        # cut, so the lockwitness scenario covers their acquisitions too
        try:
            probed = corroboration_probes(net)
        except Exception:
            scenarios.append({
                "name": "raceguard_corroboration", "passed": False,
                "seconds": 0.0,
                "detail": {"error": traceback.format_exc(limit=5)}})
            args.corroborate = False

    if witness is not None:
        wrep = witness.report()
        scenarios.append({
            "name": "lockwitness",
            "passed": wrep["cycles"] == 0 and not wrep["findings"],
            "seconds": 0.0,
            "detail": {
                "nodes": wrep["nodes"],
                "edges": wrep["edges"],
                "acquisitions": wrep["acquisitions"],
                "cycles": wrep["cycles"],
                "findings": wrep["findings"],
                "allowed": [f["sites"] for f in wrep["allowed"]],
                "edge_list": wrep["edge_list"],
            },
        })
        print(f"[{'PASS' if scenarios[-1]['passed'] else 'FAIL'}] "
              f"lockwitness (nodes={wrep['nodes']} edges={wrep['edges']} "
              f"cycles={wrep['cycles']} "
              f"findings={len(wrep['findings'])})", flush=True)

    if witness is not None and args.corroborate:
        t0 = time.perf_counter()
        try:
            rec = raceguard_corroboration(witness, probed)
        except Exception:
            rec = {"name": "raceguard_corroboration", "passed": False,
                   "detail": {"error": traceback.format_exc(limit=5)}}
        rec["seconds"] = round(time.perf_counter() - t0, 2)
        scenarios.append(rec)
        d = rec["detail"]
        print(f"[{'PASS' if rec['passed'] else 'FAIL'}] "
              f"raceguard_corroboration "
              f"(mapped={d.get('mapped_sites')} "
              f"witnessed={d.get('witnessed_sites')} "
              f"unexercised={d.get('unexercised')} "
              f"unmapped={d.get('unmapped')})", flush=True)

    shutil.rmtree(bundles_root, ignore_errors=True)
    report = {
        "platform": platform,
        "config": CFG.as_dict(),
        "passed": all(s["passed"] for s in scenarios),
        "n_scenarios": len(scenarios),
        "n_failed": sum(not s["passed"] for s in scenarios),
        "scenarios": scenarios,
        "launches": launches,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"chaos_sweep_torch: {report['n_scenarios'] - report['n_failed']}"
          f"/{report['n_scenarios']} passed -> {args.out}", flush=True)
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
