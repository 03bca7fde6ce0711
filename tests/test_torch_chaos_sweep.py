"""The port's chaos sweep (``tools/chaos_sweep_torch.py``) against the
reference's (``tools/chaos_sweep.py``) on the CPU.

One process (``torch_chaos_worker.py``, started with the lock witness
on before either package is imported) builds the reference's tiny GPT-2
(vocab 61, 16 units, 2 heads, one layer), copies its weights into the
port's, and runs the eight serving scenarios and
``training_kill_resume(kills=2, steps=6)`` through both sweeps.  Each
scenario's name and verdict are equal, and so are the fields a run
fixes: the submitted/rejected/ok/typed/stranded counts and the faults
fired of a serving scenario (the faults land at fixed hits), and the
kills, resume step and checkpoint commits of kill/resume.  Two
scenarios race the clock by design, ``queue_full`` (how many requests
the scheduler pops before the queue of 2 fills) and ``deadline`` (how
many finish inside 10 ms): of those, the requests made (submitted +
rejected) and the stranded count are compared, and every submitted one
resolved (ok + typed).  Then the port's
``corroboration_probes`` run under the same witness: the port's guard
map holds no site the witness did not see (``unmapped``), and every
probed site was acquired.  The
whole matrix (``--device cpu``) is run by hand; its report is in
CHANGES.md, and chip_smoke.py's phase 24 runs it on the card.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chaos_sweep_torch as tsweep  # noqa: E402

SERVING = ("control", "scheduler_crash", "hung_step", "retryable_fault",
           "nonretryable_step_fault", "queue_full", "deadline",
           "sigterm_drain")
SERVING_FIELDS = ("submitted", "rejected_typed", "ok", "typed_errors",
                  "stranded")
TRAIN_FIELDS = ("kills", "resumed_from", "params_bit_identical", "commits")
TIMED = ("queue_full", "deadline")
PROBED_SITES = ("serving.batcher.cond", "obs.trace_global",
                "obs.trace_ring", "random.generator", "fleet.router.rng",
                "integrity.digest_pool", "fleet.router.saturation",
                "obs.slo")


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    out = tmp_path_factory.mktemp("chaos") / "sweeps.json"
    env = dict(os.environ, MXTPU_LOCKWITNESS="1", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "torch_chaos_worker.py"), str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("scenario", SERVING + ("kill_resume",))
def test_scenario_matches_the_reference_sweep(sweeps, scenario):
    ref, port = sweeps["ref"][scenario], sweeps["port"][scenario]
    assert port["name"] == ref["name"]
    assert port["passed"] and ref["passed"], (port, ref)
    assert set(port["detail"]) == set(ref["detail"])
    if scenario in TIMED:
        def fixed(d):
            assert d["ok"] + d["typed_errors"] == d["submitted"], d
            return d["submitted"] + d["rejected_typed"], d["stranded"]
        assert fixed(port["detail"]) == fixed(ref["detail"]), (port, ref)
        fields = ()
    else:
        fields = TRAIN_FIELDS if scenario == "kill_resume" \
            else SERVING_FIELDS
    for k in fields:
        assert port["detail"][k] == ref["detail"][k], (k, port, ref)
    if scenario != "kill_resume":
        assert port["detail"]["faults_fired"] == ref["detail"]["faults_fired"]


def test_corroboration_probes_under_the_witness(sweeps):
    c = sweeps["corroboration"]
    assert c["verdict"]["unmapped"] == [], c["verdict"]
    assert set(PROBED_SITES) <= {s for p in c["probed"]
                                 for s in p.split(" + ")}
    for site in PROBED_SITES:
        assert c["per_site"].get(site, 0) > 0, site
    assert c["verdict"]["mapped_sites"] >= 30


def test_sweep_refuses_to_fall_back_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsweep.main(["--out", str(tmp_path / "r.json")])
    with pytest.raises(RuntimeError):
        tsweep.configure("cuda")
    # the card is the default: a bare configure() names it and raises
    assert tsweep.SweepConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsweep.configure()
    cfg = tsweep.configure("cpu")
    assert (cfg.vocab, cfg.units, cfg.heads, cfg.max_length) == \
        (61, 16, 2, 32)
    card = tsweep.SweepConfig("cuda", layers=2)
    # the card's nets reach the flash kernel: head dim 64, 256-token
    # buckets, 1024 positions
    assert card.units // card.heads == 64
    assert 8 * card.scale == 256 and card.max_length == 1024
