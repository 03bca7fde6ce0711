"""One rank of the port's multi-process CPU tests.

Started by ``tools/launch.py -n N`` from a module-scoped fixture of
``tests/test_torch_parallel.py``, ``test_torch_ring_ulysses.py``,
``test_torch_kvstore.py`` or ``test_torch_distributed.py``:

    python tools/launch.py -n 4 python tests/torch_dist_worker.py SCENARIO DIR

Each rank joins a gloo group (``parallel.init_distributed`` reads the
launcher's env), runs the scenario's cases on the CPU, and writes what
it computed to ``DIR/SCENARIO_r<rank>.npz``; the test compares those
arrays with the JAX package's on the same inputs.  Inputs come from
``DIR`` (the reference's weights, ``params.npz``) or from numpy seeds
that the test shares (``batches``, ``qkv``).  Imports torch and the
port only.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import parallel as par  # noqa: E402
from mxnet_tpu_torch.parallel import collectives as coll  # noqa: E402

GPT_CFG = dict(vocab_size=64, units=32, num_layers=2, num_heads=4,
               max_length=32, dropout=0.0)
GPT_B, GPT_T, GPT_LR, GPT_STEPS = 4, 16, 1e-3, 3
QKV = dict(b=2, t=32, h=4, d=8)
MLP_B, MLP_STEPS = 8, 3


def batches(n=GPT_STEPS, b=GPT_B, t=GPT_T, vocab=64, seed=11):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab, (b, t)).astype("int32"),
             rs.randint(0, vocab, (b, t)).astype("int32"))
            for _ in range(n)]


def qkv(seed=0, b=QKV["b"], t=QKV["t"], h=QKV["h"], d=QKV["d"]):
    """q, k, v, the output cotangent g and packed segment ids (B, T)."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(b, t, h, d).astype("float32") for _ in range(4)]
    seg = np.sort(rs.randint(0, 3, (b, t)), axis=1).astype("int32")
    return arrs, seg


def mlp_batches(n=MLP_STEPS, b=MLP_B, seed=5):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, 16).astype("float32"),
             rs.randint(0, 8, (b,)).astype("int32")) for _ in range(n)]


def _gpt(params):
    from mxnet_tpu_torch.models import get_gpt2
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    net = get_gpt2("gpt2_124m", device="cpu", **GPT_CFG)
    # ranks seeded apart: shard_params must make them start equal
    net.initialize(seed=100 + par.rank())
    return load_numpy_params(net, params) if par.rank() == 0 else net


def _train(out, tag, params, mesh, ckpt=None, **kw):
    """GPT_STEPS Adam steps over the global batches on ``mesh``."""
    from mxnet_tpu_torch.models import gpt2_lm_loss
    net = _gpt(params)
    tr = par.ShardedTrainer(net, "adam", loss=gpt2_lm_loss, mesh=mesh,
                            optimizer_params={"learning_rate": GPT_LR},
                            **kw)
    losses, flags = [], []
    for i, (x, y) in enumerate(batches()):
        got = tr.step(x, y)
        if isinstance(got, tuple):
            flags.append(bool(got[1]))
            got = got[0]
        losses.append(float(got))
        if ckpt is not None and i == 1:
            tr.save_checkpoint(ckpt, 2).wait_until_finished()
    out[f"{tag}:losses"] = np.array(losses)
    if flags:
        out[f"{tag}:flags"] = np.array(flags)
    for n, p in net.named_parameters():
        out[f"{tag}:param:{n}"] = p.detach().numpy()
    out[f"{tag}:graphed"] = np.array(tr.stats()["graphed"])
    out[f"{tag}:shardings"] = np.array(
        [str(tuple(s.spec)) for s in tr.batch_shardings])
    return tr


def scenario_parallel(out, d):
    from mxnet_tpu_torch.data import DevicePrefetcher, ShardedLoader
    from mxnet_tpu_torch.models.transformer import MultiHeadAttention
    from mxnet_tpu_torch.resilience import FaultPlan
    params = dict(np.load(os.path.join(d, "params.npz")))
    r = par.rank()
    # dp = 2 over ranks 0 and 1; every rank makes the mesh
    dp2 = par.make_mesh(dp=2, devices=[0, 1])
    if r < 2:
        _train(out, "dp2", params, dp2, ckpt=os.path.join(d, "ckpt"))
    full = par.make_mesh(dp=2, sp=2)
    _train(out, "dp2sp2", params, full, seq_axis=1)
    # one rank's gradient poison: every rank skips the same step
    plan = FaultPlan()
    if r == 3:
        plan.nonfinite_at("trainer.grad_nonfinite", at=2)
    with plan:
        _train(out, "guarded", params, full, seq_axis=1, grad_accum=2,
               guard_nonfinite=True, clip_global_norm=0.05)
    # attention routed through the ring equals the whole-sequence one
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(2, 16, 16).astype("float32"))
    for mode in ("ring", "ulysses"):
        attn = MultiHeadAttention(16, 4, causal=True, seq_parallel=mode)
        attn.initialize(seed=0, device="cpu")
        whole = attn(x).detach()
        sp4 = par.make_mesh(dp=1, sp=4)
        with par.use_mesh(sp4):
            mine = attn(x[:, r * 4:(r + 1) * 4].contiguous()).detach()
        out[f"mha:{mode}"] = np.array(
            (mine - whole[:, r * 4:(r + 1) * 4]).abs().max().item())
    # the loader and the prefetcher over a mesh placement hand each rank
    # its block, which the trainer takes as it is
    sh = par.global_batch_sharding(full, 2, seq_axis=1)
    glob = batches()

    def load(ids):
        return (np.stack([glob[0][0][i] for i in ids]),
                np.stack([glob[0][1][i] for i in ids]))

    sl = ShardedLoader(load, GPT_B, GPT_B, sample_shape=(GPT_T,),
                       label_shape=(GPT_T,), data_sharding=sh,
                       label_sharding=sh, dtype="int32",
                       label_dtype="int32")
    xb, yb = sl.next()
    rows, cols = sh.local_slices((GPT_B, GPT_T))
    out["loader:block"] = np.array(
        np.array_equal(xb.asnumpy(), glob[0][0][rows, cols])
        and np.array_equal(yb.asnumpy(), glob[0][1][rows, cols])
        and par.sharding.is_local_shard(xb))
    with mx.cpu():
        pf = DevicePrefetcher(iter([glob[0]]), shardings=[sh, sh])
        px, py = next(iter(pf))
        pf.close()
    out["prefetch:block"] = np.array(
        np.array_equal(px.asnumpy(), glob[0][0][rows, cols])
        and par.sharding.is_local_shard(px))
    from mxnet_tpu_torch.models import gpt2_lm_loss
    losses = []
    for src in ((glob[0][0], glob[0][1]), (xb, yb)):
        tr = par.ShardedTrainer(_gpt(params), "adam", loss=gpt2_lm_loss,
                                mesh=full, seq_axis=1)
        losses.append(float(tr.step(*src)))
    out["loader:losses"] = np.array(losses)


def scenario_ring(out, d):
    from mxnet_tpu_torch.ops.ring import ring_attention
    from mxnet_tpu_torch.ops.ulysses import ulysses_attention
    r = par.rank()
    meshes = {"sp4": par.make_mesh(dp=1, sp=4),
              "dp2sp2": par.make_mesh(dp=2, sp=2)}
    (q, k, v, g), seg = qkv()
    for mname, mesh in meshes.items():
        sh = par.NamedSharding(mesh, par.PartitionSpec("dp", "sp"))
        rows, cols = sh.local_slices(seg.shape)
        cases = [("ring", False, dict(balance=False)),
                 ("ring", True, dict(balance=False)),
                 ("ring", True, {}),                       # balanced
                 ("ring_seg", False, dict(balance=False)),
                 ("ring_seg", True, dict(balance=False)),
                 ("ring_seg", True, dict(balance=True)),
                 ("ulysses", False, {}), ("ulysses", True, {})]
        for i, (name, causal, kw) in enumerate(cases):
            if name == "ring_seg":
                kw = dict(kw, segment_ids=seg[rows, cols])
            local = [torch.tensor(a[rows, cols]).requires_grad_()
                     for a in (q, k, v)]
            fn = ulysses_attention if name == "ulysses" else ring_attention
            with par.use_mesh(mesh):
                o = fn(*local, causal=causal, **kw)
            (o * torch.tensor(g[rows, cols])).sum().backward()
            tag = f"{mname}:{i}"
            out[f"{tag}:out"] = o.detach().numpy()
            for nm, t in zip("qkv", local):
                out[f"{tag}:d{nm}"] = t.grad.numpy()


def scenario_kvstore(out, d):
    from mxnet_tpu_torch import gluon, autograd
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    params = dict(np.load(os.path.join(d, "mlp.npz")))
    r, n = par.rank(), par.num_workers()
    for tag, kw in [("sync", dict(kvstore="dist_sync")),
                    ("sync_uok", dict(kvstore="dist_sync",
                                      update_on_kvstore=True)),
                    ("sync_2bit", dict(kvstore="dist_sync",
                                       compression_params={
                                           "type": "2bit",
                                           "threshold": 0.05}))]:
        with mx.cpu():
            net = nn.HybridSequential()
            net.add(nn.Dense(32, activation="relu", in_units=16),
                    nn.Dense(8, in_units=32))
            net.initialize(seed=r)
            if r == 0:
                load_numpy_params(net, params)
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               **kw)
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            b = MLP_B // n
            for x, y in mlp_batches():
                xs = mx.nd.array(x[r * b:(r + 1) * b])
                ys = mx.nd.array(y[r * b:(r + 1) * b], dtype="int32")
                with autograd.record():
                    loss = loss_fn(net(xs), ys)
                loss.backward()
                tr.step(MLP_B)
            for nm, p in net.named_parameters():
                out[f"{tag}:param:{nm}"] = p.detach().numpy()
    # dist_async: every worker's pushes applied one by one, in rank order
    kv = mx.kv.create("dist_async")
    from mxnet_tpu_torch import optimizer as opt
    kv.set_optimizer(opt.create("sgd", learning_rate=0.5))
    kv.init(0, mx.nd.zeros((3,), ctx=mx.cpu()))
    kv.push(0, [mx.nd.array(np.full(3, r + 1.0, "float32"), ctx=mx.cpu())])
    o = mx.nd.zeros((3,), ctx=mx.cpu())
    kv.pull(0, out=o)
    out["async"] = o.asnumpy()
    out["rank_workers"] = np.array([kv.rank, kv.num_workers])


def scenario_distributed(out, d):
    import torch.distributed as dist
    r, n = par.rank(), par.num_workers()
    out["env"] = np.array([r, n, int(dist.get_backend() == "gloo")])
    par.barrier()
    coll.reset_stats()
    # bucketed all-reduce over mixed dtypes and a tiny bucket size
    ts = [torch.full((5,), float(r + 1)), torch.full((2, 3), r + 10.0),
          torch.arange(4, dtype=torch.int64) * (r + 1)]
    coll.all_reduce_(ts, dist.group.WORLD, bucket_bytes=24)
    out["all_reduce"] = np.concatenate([t.double().reshape(-1).numpy()
                                        for t in ts])
    got = coll.ring_shift([torch.full((2,), float(r))], dist.group.WORLD)
    out["ring_shift"] = got[0].numpy()
    x = torch.arange(n * 2 * 3, dtype=torch.float32).reshape(n * 2, 3) + \
        100 * r
    out["all_to_all"] = coll.all_to_all(x, dist.group.WORLD, 0, 1).numpy()
    out["all_gather"] = torch.stack(coll.all_gather(
        torch.tensor([r, r * r]), dist.group.WORLD)).numpy()
    b = torch.tensor([float(r)] * 3)
    coll.broadcast_([b], 0, dist.group.WORLD)
    out["broadcast"] = b.numpy()
    peer = (r + 1) % n
    got = coll.exchange([(torch.tensor([r, 7]), peer)],
                        [(torch.zeros(2, dtype=torch.int64), (r - 1) % n)],
                        dist.group.WORLD)
    out["exchange"] = got[0].numpy()
    st = coll.stats()
    out["stats"] = np.array([st.get("all_reduce", 0), st.get("bytes", 0),
                             st.get("staged_bytes_d2h", 0)])
    # a checkpoint of the whole group, written once and read back
    from mxnet_tpu_torch.utils.checkpoint import CheckpointManager
    with CheckpointManager(os.path.join(d, "dcp"), max_to_keep=2) as m:
        for step in (1, 2, 3):
            m.save(step, {"w": torch.full((4,), float(step)),
                          "n": torch.tensor(step)})
        m.wait_until_finished()
        par.barrier()         # rank 0 has dropped the oldest step
        out["dcp_steps"] = np.array(m.all_steps())
        out["dcp_w"] = m.restore()["w"].numpy()


def scenario_dead_peer(out, d):
    """Rank 1 leaves without joining the collective; rank 0's call must
    fail, not hang."""
    import torch.distributed as dist
    if par.rank() == 1:
        os._exit(3)
    try:
        dist.all_reduce(torch.ones(4))
        out["raised"] = np.array(False)
    except Exception:
        out["raised"] = np.array(True)


def launch(n, scenario, d, timeout=300, dist_timeout=120):
    """Run ``scenario`` on ``n`` ranks through ``tools/launch.py``;
    returns the ranks' outputs.  A collective waits at most
    ``dist_timeout`` seconds for a peer, and a hung rank fails the
    caller's test at ``timeout`` seconds instead of running the suite out
    of time."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MXNET_TPU_DIST_TIMEOUT=str(dist_timeout),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "launch.py"), "-n",
         str(n), sys.executable, os.path.abspath(__file__), scenario,
         str(d)], env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"{scenario} ranks failed:\n{proc.stderr[-4000:]}")
    return [dict(np.load(os.path.join(d, f"{scenario}_r{r}.npz")))
            for r in range(n)]


def main():
    scenario, d = sys.argv[1], sys.argv[2]
    par.init_distributed(backend="gloo")
    torch.manual_seed(0)
    out = {}
    globals()[f"scenario_{scenario}"](out, d)
    np.savez(os.path.join(d, f"{scenario}_r{par.rank()}.npz"), **out)
    if scenario != "dead_peer":
        par.barrier()


if __name__ == "__main__":
    main()
