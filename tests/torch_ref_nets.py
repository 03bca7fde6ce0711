"""Seeded reference nets that leave the process's random state alone.

The reference's initializers draw from its process-global ``mx.random``
state, whose counters every earlier test on a worker has advanced.  A
fixture that reseeds or advances that state (or numpy's global
generator) changes the draws of every test that runs after it on the
same worker.  ``seeded`` runs its body with numpy's, torch's and both
packages' generators seeded, and puts each of them back as it found it;
``preserved`` only puts them back (a module's autouse fixture, around
tests whose reference engines draw keys).
"""
import contextlib

import numpy as onp
import torch


@contextlib.contextmanager
def seeded(seed=0):
    """Seed numpy, torch and both packages' ``mx.random`` for the body;
    restore all of them afterwards."""
    import mxnet_tpu.random as jrandom
    import mxnet_tpu_torch.random as trandom
    with preserved():
        onp.random.seed(seed)
        torch.manual_seed(seed)
        jrandom.seed(seed)
        trandom.seed(seed)
        yield


@contextlib.contextmanager
def preserved():
    """Put numpy's, torch's and both packages' ``mx.random`` states back
    as they were before the body."""
    import mxnet_tpu.random as jrandom
    import mxnet_tpu_torch.random as trandom
    np_state = onp.random.get_state()
    torch_state = torch.random.get_rng_state()
    js = jrandom.get_state()
    # seed() rebinds these and a draw updates them in place: keep copies
    j_saved = (dict(js._keys), dict(js._counters), js._base_seed,
               js._host_rng)
    j_host = js._host_rng.get_state()
    with trandom._LOCK:
        t_base, t_twins = trandom._BASE[0], dict(trandom._TWINS)
        t_gens = {d: g.get_state() for d, g in trandom._GENS.items()}
    t_host = trandom.get_state()._host_rng
    t_host_state = t_host.get_state()
    try:
        yield
    finally:
        onp.random.set_state(np_state)
        torch.random.set_rng_state(torch_state)
        with js._lock:
            js._keys, js._counters, js._base_seed, js._host_rng = j_saved
            js._host_rng.set_state(j_host)
        with trandom._LOCK:
            trandom._BASE[0] = t_base
            trandom._TWINS.clear()
            trandom._TWINS.update(t_twins)
            for d, g in trandom._GENS.items():
                if d in t_gens:
                    g.set_state(t_gens[d])
                else:
                    g.manual_seed(trandom._device_seed(d, t_base))
        t_host.set_state(t_host_state)
        trandom.get_state()._host_rng = t_host


def gpt2_pair(seed=0, **cfg):
    """The reference's GPT-2 initialized under ``seed`` and the port's
    CPU GPT-2 holding the same weights."""
    from mxnet_tpu.models import get_gpt2 as jget_gpt2
    from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    with seeded(seed):
        jn = jget_gpt2("gpt2_124m", **cfg)
        jn.initialize()
        params = {k: p.data().asnumpy()
                  for k, p in jn._collect_params_with_prefix().items()}
        tn = load_numpy_params(tget_gpt2("gpt2_124m", device="cpu", **cfg),
                               params)
    return jn, tn
