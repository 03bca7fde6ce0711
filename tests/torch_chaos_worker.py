"""Both packages' chaos sweeps side by side, in a process of its own.

Started by ``tests/test_torch_chaos_sweep.py``:

    MXTPU_LOCKWITNESS=1 python tests/torch_chaos_worker.py OUT.json

The witness knob is set before either package is imported, so the
port's lock witness records every acquisition from the first lock on.
The reference's tiny GPT-2 (``tools/chaos_sweep.py`` ``_tiny_gpt2``) is
built and its weights copied into the port's (``load_numpy_params``);
the eight serving scenarios and ``training_kill_resume(kills=2,
steps=6)`` run through the reference's sweep and then the port's (fault
plans are process-global: one after the other).  Then the port's
``corroboration_probes`` run, and the port's guard map is held to the
witness's acquisitions.  Each record goes to OUT.json.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SERVING = ("control", "scheduler_crash", "hung_step", "retryable_fault",
           "nonretryable_step_fault", "queue_full", "deadline",
           "sigterm_drain")


def main(out_path):
    import chaos_sweep as jsweep
    import chaos_sweep_torch as tsweep
    from mxnet_tpu_torch.analysis import lockwitness
    from mxnet_tpu_torch.analysis import raceguard
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    from torch_ref_nets import preserved

    witness = lockwitness.active_witness()
    assert witness is not None, "MXTPU_LOCKWITNESS=1 was not set"
    tsweep.configure("cpu")
    with preserved():
        jnet = jsweep._tiny_gpt2()
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tnet = load_numpy_params(tsweep._tiny_gpt2(), params)
    jthunks = dict(jsweep.serving_scenarios(jnet))
    tthunks = dict(tsweep.serving_scenarios(tnet))
    out = {"ref": {}, "port": {}}
    for name in SERVING:
        out["ref"][name] = jthunks[name]()
        out["port"][name] = tthunks[name]()
    out["ref"]["kill_resume"] = jsweep.training_kill_resume(kills=2,
                                                            steps=6)
    with tsweep._ctx():
        out["port"]["kill_resume"] = tsweep.training_kill_resume(kills=2,
                                                                 steps=6)
    probed = tsweep.corroboration_probes(tnet)
    gmap = raceguard.build_guard_map([os.path.join(ROOT, "mxnet_tpu_torch")],
                                     root=ROOT)
    per_site = witness.report()["per_site"]
    out["corroboration"] = {
        "verdict": raceguard.corroborate(
            gmap, per_site, exempt=raceguard.corroboration_exempt("cpu")),
        "probed": [site for site, _how in probed],
        "per_site": per_site,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


if __name__ == "__main__":
    main(sys.argv[1])
