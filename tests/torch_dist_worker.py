"""One rank of the port's multi-process CPU tests.

Started by ``tools/launch.py -n N`` from a module-scoped fixture of
``tests/test_torch_parallel.py``, ``test_torch_ring_ulysses.py``,
``test_torch_kvstore.py``, ``test_torch_distributed.py``,
``test_torch_tensor_parallel.py``, ``test_torch_expert_parallel.py``,
``test_torch_pipeline.py``, ``test_torch_parallel_lang.py``,
``test_torch_sharded_serving.py`` or ``test_torch_parallel_bn.py``:

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
import time

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


def emb_batches(n=3, b=8, vocab=40, seed=6):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (b, 3)).astype("int32") for _ in range(n)]


def mlp_batches(n=MLP_STEPS, b=MLP_B, seed=5):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, 16).astype("float32"),
             rs.randint(0, 8, (b,)).astype("int32")) for _ in range(n)]


def _gpt(params, **cfg):
    from mxnet_tpu_torch.models import get_gpt2
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    net = get_gpt2("gpt2_124m", device="cpu", **dict(GPT_CFG, **cfg))
    # ranks seeded apart: shard_params must make them start equal
    net.initialize(seed=100 + par.rank())
    return load_numpy_params(net, params) if par.rank() == 0 else net


def _blocks(out, tag, net):
    """Each parameter of ``net`` (this rank's block) and, for a block,
    its slices of the whole parameter (``tag:slice:name``, (ndim, 2))."""
    from mxnet_tpu_torch.parallel.sharding import global_shape, is_block
    for n, p in net.named_parameters():
        out[f"{tag}:param:{n}"] = p.detach().numpy()
        if is_block(p):
            out[f"{tag}:slice:{n}"] = np.array(
                [[x.start, x.stop] for x in
                 p._sharding.local_slices(global_shape(p))])


def _train(out, tag, params, mesh, ckpt=None, net=None, probe=None, **kw):
    """GPT_STEPS Adam steps over the global batches on ``mesh``
    (``probe(i, net)`` after step i)."""
    from mxnet_tpu_torch.models import gpt2_lm_loss
    net = _gpt(params) if net is None else net
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
        if probe is not None:
            probe(i, net)
        if ckpt is not None and i == 1:
            tr.save_checkpoint(ckpt, 2).wait_until_finished()
    out[f"{tag}:losses"] = np.array(losses)
    if flags:
        out[f"{tag}:flags"] = np.array(flags)
    _blocks(out, tag, net)
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
    # a sparse-grad embedding under dist_sync: each rank's row-sparse
    # gradient is summed over the ranks in its dense form (as the
    # reference's _reduce reads every pushed value's dense form)
    table = np.load(os.path.join(d, "emb.npz"))["table"]
    for tag, kw in [("sparse", dict(kvstore="dist_sync")),
                    ("sparse_uok", dict(kvstore="dist_sync",
                                        update_on_kvstore=True))]:
        with mx.cpu():
            emb = nn.Embedding(*table.shape, sparse_grad=True)
            emb.initialize()
            w = emb.collect_params()["weight"]
            w.set_data(mx.nd.array(table if r == 0 else table * 0))
            tr = gluon.Trainer(emb.collect_params(), "sgd",
                               {"learning_rate": 0.5}, **kw)
            for ids in emb_batches():
                part = ids[r * len(ids) // n:(r + 1) * len(ids) // n]
                with autograd.record():
                    (emb(mx.nd.array(part, dtype="int32")) ** 2).sum()\
                        .backward()
                tr.step(len(ids))
            out[f"{tag}:table"] = w.data().asnumpy()
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



def scenario_tensor(out, d):
    """Tensor parallelism on 4 ranks: GPT-2 at dp 2 x tp 2 (a checkpoint
    at step 2), at tp 2 x sp 2 through the ring and Ulysses, with
    dropout (the replicated parameters of a tp line stay equal), the MLP
    at dp 2 x tp 2, and the vocabulary-parallel loss at tp 4."""
    from mxnet_tpu_torch import random as trandom
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.models import gpt2_lm_loss
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    params = dict(np.load(os.path.join(d, "params.npz")))
    r = par.rank()
    out["mesh:inferred_dp"] = np.array(par.axis_size(par.make_mesh(tp=2),
                                                     "dp"))
    try:
        par.make_mesh(tp=3)
    except mx.base.MXNetError as e:
        out["mesh:tp3"] = np.array(str(e))
    dptp = par.make_mesh(dp=2, tp=2)
    _train(out, "dp2tp2", params, dptp, ckpt=os.path.join(d, "ckpt"))
    tpsp = par.make_mesh(dp=1, sp=2, tp=2)
    for mode in ("ring", "ulysses"):
        os.environ["MXNET_TPU_SEQ_PARALLEL"] = mode
        _train(out, f"tp2sp2_{mode}", params, tpsp, seq_axis=1)
    os.environ.pop("MXNET_TPU_SEQ_PARALLEL")
    # dropout: each rank's generator seeded apart; the trainer aligns the
    # tp lines' generators, so the masks on shared activations agree
    trandom.seed(1000 + r)
    _train(out, "dropout", params, dptp, net=_gpt(params, dropout=0.1))
    # the MLP: unannotated, so replicated along tp
    mlp = dict(np.load(os.path.join(d, "mlp.npz")))
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu", in_units=16),
                nn.Dense(8, in_units=32))
        net.initialize(seed=r)
        if r == 0:
            load_numpy_params(net, mlp)
        tr = par.ShardedTrainer(
            net, "sgd", loss=lambda o, y: ((o - y) ** 2).mean(),
            optimizer_params={"learning_rate": 0.1}, mesh=dptp)
        x, y = (np.load(os.path.join(d, f"mlp_{k}.npy")) for k in "xy")
        out["mlp:loss"] = np.array(float(tr.step(x, y)))
        _blocks(out, "mlp", net)
    # the loss of a rank's vocabulary block at tp = 4
    tp4 = par.make_mesh(dp=1, tp=4)
    logits = np.load(os.path.join(d, "logits.npy"))
    labels = np.load(os.path.join(d, "labels.npy"))
    v = logits.shape[-1] // 4
    blk = torch.tensor(logits[..., r * v:(r + 1) * v]).requires_grad_()
    marked = par.sharding.mark_local_shard(
        blk * 1.0, par.NamedSharding(tp4, par.PartitionSpec("dp", "sp",
                                                            "tp")))
    loss = gpt2_lm_loss(marked, torch.tensor(labels))
    loss.backward()
    out["vocab:loss"] = loss.detach().numpy()
    out["vocab:grad"] = blk.grad.numpy()



MOE_CFG = dict(num_experts=4, moe_every=2, moe_top_k=2,
               moe_capacity_factor=1.0)


def _moe_probe(i, net, out, tag):
    """Each MoE layer's aux loss and dropped share at step ``i`` and its
    kept (token, choice) pairs at the first step."""
    from mxnet_tpu_torch.models.moe import MoETransformerBlock
    for j, blk in enumerate(net.blocks):
        if isinstance(blk, MoETransformerBlock):
            out[f"{tag}:aux{j}:{i}"] = blk.moe.last_aux.numpy()
            out[f"{tag}:dropped{j}:{i}"] = blk.moe.last_dropped.numpy()
            if i == 0:
                out[f"{tag}:kept{j}"] = blk.moe._last_kept.numpy()


def scenario_expert(out, d):
    """The routed GPT-2 on 4 ranks: at dp 2 (ranks 0 and 1; global
    routing) and at ep 2 x tp 2."""
    params = dict(np.load(os.path.join(d, "params.npz")))
    r = par.rank()
    dp2 = par.make_mesh(dp=2, devices=[0, 1])
    eptp = par.make_mesh(dp=1, ep=2, tp=2)
    if r < 2:
        _train(out, "dp2", params, dp2, net=_gpt(params, **MOE_CFG),
               probe=lambda i, net: _moe_probe(i, net, out, "dp2"))
    _train(out, "ep2tp2", params, eptp, net=_gpt(params, **MOE_CFG),
           probe=lambda i, net: _moe_probe(i, net, out, "ep2tp2"))


STACKED_CFG = dict(vocab_size=64, units=32, num_layers=4, num_heads=4,
                   max_length=32)


def _stage(p, x):
    w, b = p
    return torch.tanh(x @ w + b)


def scenario_pipeline(out, d):
    """GPipe on 4 ranks at pp 4 and at dp 2 x pp 2 (outputs and
    gradients, and the microbatching error), the stacked GPT-2 at dp 2 x
    pp 2: the piped forward and 3 Adam steps."""
    from mxnet_tpu_torch.models import get_stacked_gpt2
    r = par.rank()
    g = dict(np.load(os.path.join(d, "gpipe.npz")))
    for tag, kw in (("pp4", dict(dp=1, pp=4)), ("dp2pp2", dict(dp=2,
                                                               pp=2))):
        mesh = par.make_mesh(**kw)
        p = kw["pp"]
        ws = torch.tensor(g[f"ws{p}"]).requires_grad_()
        bs = torch.tensor(g[f"bs{p}"]).requires_grad_()
        rows = par.NamedSharding(mesh, par.PartitionSpec("dp")).local_slices(
            g["x"].shape)
        x = torch.tensor(g["x"][rows]).requires_grad_()
        with par.use_mesh(mesh):
            y = par.gpipe(_stage, (ws, bs), x, num_microbatches=2)
        (y ** 2).sum().backward()
        out[f"{tag}:y"] = y.detach().numpy()
        out[f"{tag}:rows"] = np.array([rows[0].start, rows[0].stop])
        out[f"{tag}:dws"] = ws.grad.numpy()
        out[f"{tag}:dbs"] = bs.grad.numpy()
        out[f"{tag}:dx"] = x.grad.numpy()
        try:
            with par.use_mesh(mesh):
                par.gpipe(_stage, (ws, bs), x[:3], num_microbatches=2)
            out[f"{tag}:error"] = np.array("")
        except ValueError as e:
            out[f"{tag}:error"] = np.array(str(e))
    params = dict(np.load(os.path.join(d, "stacked.npz")))
    mesh = par.make_mesh(dp=2, pp=2)
    net = get_stacked_gpt2("gpt2_124m", device="cpu", **STACKED_CFG)
    net.initialize(seed=100 + r)
    if r == 0:
        from mxnet_tpu_torch.utils.convert import load_numpy_params
        load_numpy_params(net, params)
    par.shard_params(net, mesh)
    x, _y = batches()[0]
    rows = par.NamedSharding(mesh, par.PartitionSpec("dp")).local_slices(
        x.shape)
    with par.use_mesh(mesh), torch.no_grad():
        out["stacked:logits"] = net(torch.tensor(x[rows])).numpy()
    _train(out, "stacked", params, mesh, net=net)


BERT_CFG = dict(vocab_size=64, units=32, num_layers=2, num_heads=4,
                max_length=32, dropout=0.0)
NMT_CFG = dict(src_vocab_size=32, shared_embed=True, units=32,
               hidden_size=64, num_layers=2, num_heads=4, dropout=0.0)
LANG_B, LANG_T, LANG_M = 4, 16, 4
# an id the NMT test's weights emit, so translate's EOS handling runs
NMT_EOS = 19
# dp 2 x tp 2, and tp 2 x sp 2 (the sequence in chunks of 8)
LANG_MESHES = {"dp2tp2": dict(dp=2, tp=2), "tp2sp2": dict(dp=1, sp=2, tp=2)}


def bert_batches(n=GPT_STEPS, seed=21):
    """(tokens, types, valid_length, masked positions), (MLM labels, NSP
    labels) per step: valid lengths that end inside either sequence
    chunk, masked positions below them."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        vlen = rs.randint(5, LANG_T + 1, (LANG_B,)).astype("int32")
        pos = np.stack([rs.choice(v, LANG_M, replace=False)
                        for v in vlen]).astype("int32")
        out.append(((rs.randint(0, 64, (LANG_B, LANG_T)).astype("int32"),
                     rs.randint(0, 2, (LANG_B, LANG_T)).astype("int32"),
                     vlen, pos),
                    (rs.randint(0, 64, (LANG_B, LANG_M)).astype("int32"),
                     rs.randint(0, 2, (LANG_B,)).astype("int32"))))
    return out


def nmt_batches(n=GPT_STEPS, seed=22):
    """(source, shifted target, source valid length), (labels,)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src = rs.randint(3, 32, (LANG_B, LANG_T)).astype("int32")
        tgt = rs.randint(3, 32, (LANG_B, LANG_T + 1)).astype("int32")
        tgt[:, 0] = 1
        out.append(((src, tgt[:, :-1].copy(),
                     rs.randint(5, LANG_T + 1, (LANG_B,)).astype("int32")),
                    (tgt[:, 1:].copy(),)))
    return out


def nmt_vl_batches(n=GPT_STEPS, seed=23):
    """NMT batches whose labels carry the target's valid length: rows of
    unequal lengths, so the ranks' counts differ over dp and sp."""
    rs = np.random.RandomState(seed)
    return [((src, tgt, vlen), (lab, rs.randint(3, LANG_T + 1, (LANG_B,))
                                .astype("int32")))
            for (src, tgt, vlen), (lab,) in nmt_batches(n, seed)]


def nmt_vl_loss(logits, labels, valid_length):
    from mxnet_tpu_torch.models import nmt_loss
    return nmt_loss(logits, labels, valid_length)


def lang_specs(par_mod, sp):
    """The data and label specs of BERT's and NMT's batches: rows over
    dp, the sequences over sp (valid lengths, masked positions and the
    MLM labels are per row)."""
    P = par_mod.PartitionSpec
    seq = P("dp", "sp") if sp else P("dp", None)
    return {"bert": ([seq, seq, P("dp"), P("dp", None)],
                     [P("dp", None), P("dp")]),
            "nmt": ([seq, seq, P("dp")], [seq]),
            "nmtvl": ([seq, seq, P("dp")], [seq, P("dp")])}


def bert_loss(outs, mlm_labels, nsp_labels):
    """bench.py's BERT loss per sample (MLM mean over the masked
    positions plus NSP); its mean is bench.py's."""
    from mxnet_tpu_torch.ndarray.ops import apply_op

    def f(m, n, ym, yn):
        m, n = m.float(), n.float()
        lm = m.logsumexp(-1) - m.gather(-1, ym.long()[..., None])[..., 0]
        ln = n.logsumexp(-1) - n.gather(-1, yn.long()[:, None])[:, 0]
        return lm.mean(-1) + ln
    return apply_op("bert_loss", f, [outs[0], outs[1], mlm_labels,
                                     nsp_labels])


def _lang_net(kind, params):
    from mxnet_tpu_torch.models import BERTForPretrain, get_bert, get_nmt
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    if kind == "bert":
        net = BERTForPretrain(get_bert("bert_base", device="cpu",
                                       **BERT_CFG))
    else:
        net = get_nmt("transformer_base", device="cpu", **NMT_CFG)
    net.initialize(seed=100 + par.rank())
    return load_numpy_params(net, params) if par.rank() == 0 else net


def scenario_lang(out, d):
    """BERT and NMT on 4 ranks at dp 2 x tp 2 and tp 2 x sp 2: 3 Adam
    steps each (BERT with valid_length, so its masked attention runs;
    NMT with its cross-attention), and NMT's greedy and beam translate
    under each mesh from the starting weights."""
    from mxnet_tpu_torch.models import nmt_loss
    for kind, loss, batches in (("bert", bert_loss, bert_batches()),
                                ("nmt", nmt_loss, nmt_batches()),
                                ("nmtvl", nmt_vl_loss, nmt_vl_batches())):
        params = dict(np.load(os.path.join(d, "nmt.npz" if kind == "nmtvl"
                                           else f"{kind}.npz")))
        for tag, kw in LANG_MESHES.items():
            mesh = par.make_mesh(**kw)
            net = _lang_net(kind, params)
            specs = lang_specs(par, "sp" in kw)[kind]
            tr = par.ShardedTrainer(net, "adam", loss=loss, mesh=mesh,
                                    data_specs=specs[0],
                                    label_specs=specs[1],
                                    optimizer_params={"learning_rate":
                                                      GPT_LR})
            tr.build(*batches[0])
            if kind == "nmt":
                src, _t, vlen = batches[0][0]
                for beam in (1, 4):
                    out[f"{kind}{tag}:translate{beam}"] = net.translate(
                        src[:3], vlen[:3], max_length=6, beam_size=beam,
                        alpha=0.8, eos_id=NMT_EOS)
            losses = [float(tr.step(x, y)) for x, y in batches]
            out[f"{kind}{tag}:losses"] = np.array(losses)
            _blocks(out, f"{kind}{tag}", net)
    # an nd op handed a rank's vocabulary block computes on the whole
    # logits (the block gathered over tp), and its gradient is the
    # rank's columns of the whole's
    mesh = par.make_mesh(dp=2, tp=2)
    whole = np.random.RandomState(31).randn(2, 3, 8).astype("float32")
    tp = mesh.axis_index("tp")
    blk = torch.tensor(whole[..., 4 * tp:4 * tp + 4]).requires_grad_()
    marked = par.sharding.mark_local_shard(blk * 1.0, par.NamedSharding(
        mesh, par.PartitionSpec("dp", "sp", "tp")))
    with mx.cpu():
        with mx.autograd.record():
            y = mx.nd.log_softmax(mx.nd.NDArray(marked), axis=-1)
            loss = (y * mx.nd.NDArray(torch.tensor(whole))).sum()
        loss.backward()
    out["nd:log_softmax"] = y.asnumpy()
    out["nd:grad"] = blk.grad.numpy()
    _masked_sp_attention(out, d)


def attn_inputs():
    """Causal self-attention's inputs: x (4, 16, 32), a mask with a query
    axis (4, 1, 16, 16) that keeps the diagonal, and the output weights
    of the scalar whose gradient is taken."""
    rs = np.random.RandomState(41)
    x = rs.randn(4, LANG_T, 32).astype("float32")
    mask = rs.rand(4, 1, LANG_T, LANG_T) < 0.6
    mask |= np.eye(LANG_T, dtype=bool)[None, None]
    w = rs.randn(4, LANG_T, 32).astype("float32")
    return x, mask, w


def _masked_sp_attention(out, d):
    """Attention under dp 2 x sp 2 with a mask that has a query axis:
    each rank takes its rows and its query chunk of the global mask over
    the whole key axis; its output, its input gradient and the typed
    error of a global mask."""
    from mxnet_tpu_torch.models.transformer import MultiHeadAttention
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    net = MultiHeadAttention(32, 4, causal=True)
    net.initialize(seed=0, device="cpu")
    load_numpy_params(net, dict(np.load(os.path.join(d, "attn.npz"))))
    mesh = par.make_mesh(dp=2, sp=2)
    x, mask, w = attn_inputs()
    i, j, t = mesh.axis_index("dp"), mesh.axis_index("sp"), LANG_T // 2
    rows, cols = slice(2 * i, 2 * i + 2), slice(t * j, t * j + t)
    xl = torch.tensor(x[rows, cols]).requires_grad_()
    with par.use_mesh(mesh):
        y = net(xl, mask=torch.tensor(mask[rows][:, :, cols]))
        (y * torch.tensor(w[rows, cols])).sum().backward()
        try:
            net(xl.detach(), mask=torch.tensor(mask[rows]))
            out["attn:error"] = np.array("")
        except mx.base.MXNetError as e:
            out["attn:error"] = np.array(str(e))
    out["attn:out"] = y.detach().numpy()
    out["attn:dx"] = xl.grad.numpy()


SERVE_CFG = dict(vocab_size=97, units=32, num_layers=2, num_heads=4,
                 max_length=64, dropout=0.0)


def serve_prompts(lens, seed=1, vocab=97):
    """``tests/test_sharded_serving.py``'s ``_prompts``."""
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)).astype("int32") for n in lens]


def shared_prompts(vocab=97):
    """``test_sharded_serving_prefix...``'s three prompts sharing a
    24-token prefix."""
    rs = np.random.RandomState(5)
    shared = rs.randint(0, vocab, (24,)).astype("int32")
    return [np.concatenate([shared, rs.randint(0, vocab, (4,)).astype(
        "int32")]) for _ in range(3)]


SAMPLED = [dict(), dict(temperature=1.0, top_k=5, seed=7),
           dict(temperature=0.8, top_p=0.9, seed=11),
           dict(temperature=1.3, seed=13)]
SPEC = [dict(), dict(temperature=1.0, top_k=5, seed=7), dict(),
        dict(temperature=0.9, seed=23)]
SAMPLED_2D = [dict(), dict(temperature=1.0, top_k=7, seed=3), dict(),
              dict(temperature=0.7, seed=9), dict()]

# the sharded-serving cases: (prompts, sampling, engine keywords, mesh)
SERVE_CASES = {
    "greedy": (dict(lens=(3, 5, 9, 12, 5, 16)), None, {}, "tp"),
    "sampled": (dict(lens=(4, 7, 10, 6), seed=2), SAMPLED, {}, "tp"),
    "spec": (dict(lens=(3, 9, 12, 5), seed=3), SPEC,
             dict(spec_tokens=2, draft_layers=1), "tp"),
    "paged": (dict(lens=(3, 9, 12, 5), seed=4), None,
              dict(kv_layout="paged", page_size=8), "tp"),
    "int8": (dict(lens=(3, 9, 12, 5), seed=4), SAMPLED,
             dict(kv_layout="paged", page_size=8, kv_quant="int8"), "tp"),
    "slot": (dict(lens=(3, 9, 5), seed=6), None,
             dict(num_slots=3, max_batch=3, mesh_axes=("tp", "dp")),
             "dp"),
    "slot_spec": (dict(lens=(3, 9, 12, 5), seed=3), SPEC,
                  dict(num_slots=3, max_batch=3, spec_tokens=2,
                       draft_layers=1, mesh_axes=("tp", "dp")), "dp"),
    "points": (dict(lens=(5, 9), seed=8), None, {}, "tp"),
    "vocab96": (dict(lens=(3, 9, 12, 5), seed=10, vocab=96), SAMPLED,
                dict(kv_layout="paged", page_size=8), "tp"),
}
SERVE_2D = (dict(lens=(3, 7, 12, 9, 5), seed=7), SAMPLED_2D,
            dict(num_slots=3, max_batch=3, prefix_pool_rows=2,
                 prefix_min_tokens=4))


def _serve_net(params, **cfg):
    from mxnet_tpu_torch.models import get_gpt2
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    net = get_gpt2("gpt2_124m", device="cpu", **dict(SERVE_CFG, **cfg))
    return load_numpy_params(net, params)


def _engine(net, **kw):
    from mxnet_tpu_torch.serving import InferenceEngine
    for k, v in dict(num_slots=2, max_batch=2, seq_buckets=(8, 16),
                     default_max_new_tokens=8, device="cpu").items():
        kw.setdefault(k, v)
    return InferenceEngine(net, **kw)


def _serve(out, tag, eng, prompts, samp=None, max_new=8, infer=False):
    """Warm ``eng`` up and serve ``prompts`` through it: rank 0 submits
    (the others follow its plans inside ``with eng``) and records each
    stream, the compile counts and the stats sections the tests read."""
    import json
    n_warm = eng.warmup()
    with eng:
        if not eng._follower:
            if infer:
                outs = [eng.infer(p, max_new_tokens=max_new)
                        for p in prompts]
            else:
                futs = [eng.submit(p, max_new_tokens=max_new,
                                   **((samp or [{}] * len(prompts))[i]))
                        for i, p in enumerate(prompts)]
                outs = [f.result(timeout=120) for f in futs]
            st = eng.stats()
    if eng._follower:
        return
    for i, o in enumerate(outs):
        out[f"{tag}:out{i}"] = o
    out[f"{tag}:warm"] = np.array(n_warm)
    out[f"{tag}:stats"] = np.array(json.dumps({
        k: st[k] for k in ("mesh", "compile", "speculative", "prefix_cache",
                           "batches", "resilience", "requests", "slots",
                           "plans") if k in st}))


def _one_device(out, tag, net, prompts, samp=None, **kw):
    """The port's one-device engine over the same prompts (rank 0)."""
    if par.rank() == 0:
        kw = {k: v for k, v in kw.items() if k not in ("mesh_axes",)}
        _serve(out, f"{tag}:base", _engine(net, name=f"{tag}_base", **kw),
               prompts, samp)


def _serve_logits(out, net):
    """The mesh engine's program net on 2 prompts of 8 tokens: the
    prefill's last-position logits and one decode step's, beside the
    one-device net's."""
    eng = _engine(net, mesh=2, name="logits")
    toks = torch.tensor(np.stack(serve_prompts((8, 8), seed=12)))
    lens = torch.full((2,), 8, dtype=torch.int32)
    sidx = torch.arange(2, dtype=torch.int32)
    for tag, model in (("mesh", eng._model), ("one", net)):
        with par.use_mesh(eng.mesh), torch.no_grad():
            caches = model.init_slot_cache(2, 64)
            pre, _ = model.prefill_slots(toks, lens, caches, sidx)
            nxt = pre.argmax(-1).to(torch.int32)
            dec, _ = model.decode_step(nxt, caches, lens)
        out[f"logits:{tag}:prefill"] = pre.numpy()
        out[f"logits:{tag}:decode"] = dec.numpy()
        out[f"logits:{tag}:next"] = nxt.numpy()
    out["logits:kv_heads"] = np.array(eng._model.kv_heads())
    eng.stop(drain=False)


def _validation(out):
    """Every incompatible mesh configuration: the message of the
    ServingError each raises at construction, on every rank."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.serving import InferenceEngine, ServingError
    net = _serve_net(dict(np.load(os.path.join(_DIR[0], "params.npz"))))
    dense = nn.Dense(4, in_units=4)
    dense.initialize(seed=0, device="cpu")
    cases = {
        "heads": lambda: _engine(net, mesh=3),
        "paged": lambda: _engine(net, mesh=2, kv_layout="paged",
                                 page_size=8, mesh_axes=("tp", "dp")),
        "devices": lambda: _engine(net, mesh=4),
        "axis": lambda: _engine(net, mesh=2, mesh_axes="bogus"),
        "distinct": lambda: _engine(net, mesh=2, mesh_axes=("tp", "tp")),
        "zero": lambda: _engine(net, mesh=0),
        "type": lambda: _engine(net, mesh="tp"),
        "rows": lambda: _engine(net, mesh=par.make_mesh(dp=2, tp=1),
                                mesh_axes=("tp", "dp"), num_slots=2,
                                prefix_pool_rows=0),
        "forward": lambda: InferenceEngine(dense, mode="forward", mesh=2,
                                           device="cpu"),
        "kernel": lambda: _engine(net, mesh=2, kv_layout="paged",
                                  page_size=8, paged_attention="kernel"),
        "parity": lambda: _engine(net, mesh=2, kv_layout="paged",
                                  page_size=8, debug_parity=True),
        "role_slot": lambda: _engine(net, mesh=par.make_mesh(dp=2, tp=1),
                                     mesh_axes=("tp", "dp"), num_slots=3,
                                     max_batch=3, role="decode"),
    }
    for tag, make in cases.items():
        try:
            make()
            out[f"invalid:{tag}"] = np.array("")
        except ServingError as e:
            out[f"invalid:{tag}"] = np.array(str(e))


_DIR = []


def scenario_serving(out, d):
    """The sharded-serving contracts on 2 ranks
    (``tests/test_sharded_serving.py``): each case's mesh engine and, on
    rank 0, the one-device engine; the prefix cache with chunked
    prefill; the step logits; the gauge and the stats section; the typed
    validation; fault containment at the dispatch sites."""
    import json
    from mxnet_tpu_torch.observability.export import flatten
    from mxnet_tpu_torch.resilience import FaultPlan
    _DIR.append(d)
    params = dict(np.load(os.path.join(d, "params.npz")))
    net = _serve_net(params)
    for tag, (pr, samp, kw, axis) in SERVE_CASES.items():
        n = net
        if "vocab" in pr:
            n = _serve_net(dict(np.load(os.path.join(d, "params96.npz"))),
                           vocab_size=pr["vocab"])
        prompts = serve_prompts(**pr)
        mesh = 2 if axis == "tp" else par.make_mesh(dp=2, tp=1)
        _one_device(out, tag, n, prompts, samp, **kw)
        _serve(out, tag, _engine(n, mesh=mesh, name=f"shard_{tag}", **kw),
               prompts, samp)
    # prefix hits and chunked prefill, one request at a time
    _serve(out, "prefix", _engine(net, mesh=2, prefix_pool_rows=2,
                                  prefill_chunk=8, prefix_min_tokens=4,
                                  name="shard_prefix"),
           shared_prompts(), max_new=4, infer=True)
    _serve_logits(out, net)
    # the gauge and the stats section, of a mesh engine and of one device
    eng = _engine(net, mesh=2, name="shard_gauge")
    flat = flatten(prefix="mxtpu_serving_mesh_devices")
    out["gauge:mesh"] = np.array([v for k, v in flat.items()
                                  if "shard_gauge" in k])
    out["gauge:stats"] = np.array(json.dumps(eng.stats()["mesh"]))
    eng.stop(drain=False)
    one = _engine(net, name="shard_gauge1")
    out["gauge:one"] = np.array([one.mesh_devices,
                                 int(one.stats()["mesh"]["enabled"])])
    one.stop(drain=False)
    _validation(out)
    # retryable faults at the dispatch sites, on rank 0 (they fire
    # there, before the plan leaves)
    plan = FaultPlan()
    if par.rank() == 0:
        plan.raise_at("serving.decode_step", at=2, retryable=True)
        plan.raise_at("serving.prefill", at=1, retryable=True)
    eng = _engine(net, mesh=2, name="shard_fault")
    with plan:
        _serve(out, "fault", eng, serve_prompts((5, 9), seed=9))
    out["fault:fired"] = np.array([plan.fired("serving.decode_step"),
                                   plan.fired("serving.prefill")])
    _follower_fault(out, net)
    _beat_fault(out, net)
    _scale_scan(out, net)
    _mesh_migration(out, net)
    _mesh_tiers(out, net)


def scan_family(vocab=97):
    """``tests/test_paged_attn.py``'s family: 12 shared tokens (1.5
    pages of 8) and 3 of each member's own."""
    rs = np.random.RandomState(31)
    shared = rs.randint(0, vocab, (12,)).astype("int32")
    return [np.concatenate([shared, rs.randint(0, vocab, (3,))
                            .astype("int32")]) for _ in range(3)]


def _scale_scan(out, net):
    """A NaN int8 K scale (the ``kscale`` surgery of the
    ``serving.kv_scale`` poison) on the first page of a cached prefix,
    in heads only rank 1 holds (rank 0 skips the surgery on its own):
    the family's next member reads it and fails typed, the scan over
    both ranks' heads counts one dequant fault and drops the entry over
    the page, and the member after recomputes clean.  Rank 0's own scan
    sees only the NaN its victim wrote into its own tail page."""
    from mxnet_tpu_torch.serving import NonFiniteOutputError
    eng = _engine(net, mesh=2, kv_layout="paged", page_size=8,
                  kv_quant="int8", prefix_min_tokens=4, name="shard_scan")
    eng.warmup()
    if par.rank() == 0:
        apply = eng._apply

        def skip(op, *args):
            if op != "kscale":
                return apply(op, *args)
        eng._apply = skip
    fam = scan_family()
    with eng:
        if par.rank() == 0:
            eng.infer(fam[0], max_new_tokens=4)
            with eng._step_lock:
                entry, = eng._prefix._entries
                eng._effect("kscale", entry.pages[0], float("nan"))
            try:
                eng.infer(fam[1], max_new_tokens=4)
                out["scan:victim"] = np.array("")
            except NonFiniteOutputError as e:
                out["scan:victim"] = np.array(type(e).__name__)
            out["scan:entries"] = np.array(len(eng._prefix))
            out["scan:next"] = eng.infer(fam[2], max_new_tokens=4)
            s = eng.stats()
            out["scan:counts"] = np.array([
                s["quantized_kv"]["kv_dequant_faults"],
                s["prefix_cache"]["prefix_hits"],
                s["prefix_cache"]["prefix_inserts"]])


MIG_KW = dict(kv_layout="paged", page_size=8)


def _capture(into):
    from mxnet_tpu_torch.serving import MigrationError

    def target(bundle, future):
        into.append(bundle)
        raise MigrationError("captured")
    return target


def _mesh_migration(out, net):
    """A prefill engine at tp = 2 hands its requests to a one-process
    decode engine, and a one-process prefill engine to a decode engine
    at tp = 2: the mesh's bundles carry whole heads (gathered over tp),
    and either decode side continues the colocated greedy streams."""
    from mxnet_tpu_torch.serving.migration import bundle_digest
    prompts = serve_prompts((5, 11, 14), seed=14)
    one_bundles, mesh_bundles = [], []
    if par.rank() == 0:
        one = _engine(net, role="prefill", name="mig_one", **MIG_KW)
        one.migrate_to(_capture(one_bundles))
        _serve(out, "mig:one", one, prompts)
    pre = _engine(net, mesh=2, role="prefill", name="mig_pre", **MIG_KW)
    if par.rank() == 0:
        pre.migrate_to(_capture(mesh_bundles))
    _serve(out, "mig:pre", pre, prompts)
    dec2 = _engine(net, mesh=2, role="decode", name="mig_dec2", **MIG_KW)
    dec2.warmup()
    with dec2:
        if par.rank() == 0:
            for i, b in enumerate(one_bundles):
                out[f"mig:back{i}"] = dec2.adopt(b).result(timeout=60)
    if par.rank():
        return
    for i, b in enumerate(mesh_bundles):
        out[f"mig:digest{i}"] = np.array([b.digest, bundle_digest(b)])
        out[f"mig:prompt{i}"] = b.prompt
        for j, a in enumerate(b.arrays):
            out[f"mig:b{i}:leaf{j}"] = a
    dec = _engine(net, role="decode", name="mig_dec1", **MIG_KW)
    dec.warmup()
    with dec:
        for i, b in enumerate(mesh_bundles):
            out[f"mig:fwd{i}"] = dec.adopt(b).result(timeout=60)


def tier_traffic(vocab=97):
    """A family of 24 shared tokens, fillers that evict its pages, and
    the family again (``tests/test_kv_tiers.py``'s shape)."""
    rs = np.random.RandomState(3)
    fam = rs.randint(0, vocab, (24,)).astype("int32")
    members = [np.concatenate([fam, rs.randint(0, vocab, (4,))
                               .astype("int32")]) for _ in range(3)]
    fill = [np.random.RandomState(200 + i).randint(0, vocab, (16,))
            .astype("int32") for i in range(6)]
    return [members[0]] + fill + members[1:]


def _mesh_tiers(out, net):
    """The tiered prefix cache at tp = 2: a demotion gathers the heads
    to rank 0, a promotion sends each rank its heads; the streams equal
    the one-device engine's, and the prefix seeds a live mesh engine
    exports carry whole heads."""
    kw = dict(num_pages=12, prefix_min_tokens=8, seq_buckets=(8, 16, 32),
              host_pool_bytes=64 << 20, **MIG_KW)
    eng = _engine(net, mesh=2, name="tier_mesh", **kw)
    eng.warmup()
    with eng:
        if par.rank() == 0:
            for i, p in enumerate(tier_traffic()):
                if i == 7:
                    eng._tier.drain()
                out[f"tier:out{i}"] = eng.infer(p, max_new_tokens=4)
            eng._tier.drain()
            s = eng.stats()["tier"]
            out["tier:counts"] = np.array([s["tier_demotes"],
                                           s["tier_promotes"],
                                           s["tier_hits"]])
            seeds = eng.export_prefix_seeds(limit=1)
            out["tier:seed_shapes"] = np.array([a.shape for a in
                                                seeds[0].arrays])


def _beat_fault(out, net):
    """A fault at ``serving.decode_step`` fails rank 0's first request,
    whose cleanup zeroes the caches; that surgery rides the next idle
    beat, and rank 1 fails to apply it.  Rank 1 reports it at the next
    call's status word, so rank 0's second request fails with
    ``EngineCrashedError`` before any program reads the caches."""
    from mxnet_tpu_torch.resilience import FaultPlan
    from mxnet_tpu_torch.serving import EngineCrashedError
    from mxnet_tpu_torch.serving.sharded import BEAT
    eng = _engine(net, mesh=2, name="shard_beat")
    eng.warmup()
    plan, carriers = FaultPlan(), []
    if par.rank() == 0:
        plan.raise_at("serving.decode_step", at=1)
    else:
        apply, receive = eng._apply, eng._mesh.receive

        def fail(op, *args):
            if op == "zero":
                raise RuntimeError("a follower's fault")
            return apply(op, *args)

        def watched():
            msg = receive()
            if any(e[0] == "zero" for e in msg[2]):
                carriers.append(msg[0])
            return msg
        eng._apply, eng._mesh.receive = fail, watched
    got, start = [], ""
    try:
        with plan, eng:
            if par.rank() == 0:
                for p in serve_prompts((5, 6), seed=9):
                    try:
                        eng.submit(p, max_new_tokens=4).result(timeout=60)
                        got.append("")
                    except Exception as e:
                        got.append(type(e).__name__)
                    time.sleep(3 * BEAT)
                out["beat:health"] = np.array(eng.health()["live"])
    except EngineCrashedError as e:
        start = type(e).__name__
    out["beat:requests"] = np.array(got)
    out["beat:carriers"] = np.array(carriers)
    out["beat:start"] = np.array(start)


def _follower_fault(out, net):
    """Rank 1 fails to apply a plan (the page table's upload): the status
    word after that plan tells rank 0, which fails the request and
    condemns the engine, and rank 1's ``start()`` raises; nothing
    hangs."""
    from mxnet_tpu_torch.serving import EngineCrashedError
    eng = _engine(net, mesh=2, kv_layout="paged", page_size=8,
                  name="shard_crash")
    eng.warmup()
    if par.rank() == 1:
        apply = eng._apply

        def fail(op, *args):
            if op == "table":
                raise RuntimeError("a follower's fault")
            return apply(op, *args)
        eng._apply = fail
    out["crash:request"] = out["crash:start"] = np.array("")
    try:
        with eng:
            if par.rank() == 0:
                fut = eng.submit(serve_prompts((5,), seed=9)[0],
                                 max_new_tokens=4)
                try:
                    fut.result(timeout=60)
                except Exception as e:
                    out["crash:request"] = np.array(type(e).__name__)
                out["crash:health"] = np.array(eng.health()["live"])
    except EngineCrashedError as e:
        out["crash:start"] = np.array(type(e).__name__)


def scenario_serving2d(out, d):
    """The 2-D mesh on 4 ranks: tp 2 x a dp slot axis of 2, the prefix
    cache on, greedy and sampled requests."""
    params = dict(np.load(os.path.join(d, "params.npz")))
    net = _serve_net(params)
    pr, samp, kw = SERVE_2D
    prompts = serve_prompts(**pr)
    _one_device(out, "2d", net, prompts, samp, **kw)
    mesh = par.make_mesh(dp=2, tp=2)
    _serve(out, "2d", _engine(net, mesh=mesh, mesh_axes=("tp", "dp"),
                              name="shard_2x2", **kw), prompts, samp)


BN_B, BN_STEPS, BN_LR, BN_SHIFT = 8, 3, 0.1, 3.0


def bn_batches(n=BN_STEPS, b=BN_B, seed=31):
    """(images (b, 3, 8, 8), labels): the second half of each batch (rank
    1's rows at dp 2) is shifted by ``BN_SHIFT``, so each rank's own
    statistics differ from the batch's."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.uniform(-1, 1, (b, 3, 8, 8)).astype("float32")
        x[b // 2:] += BN_SHIFT
        out.append((x, rs.randint(0, 10, (b,)).astype("int32")))
    return out


def bn_net(nn):
    """Conv 3->8, BatchNorm, ReLU, Dense 10 over ``nn`` (either
    package's ``gluon.nn``), every shape given."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=8), nn.Activation("relu"),
            nn.Flatten(), nn.Dense(10, in_units=8 * 8 * 8))
    return net


def bn_ce(logits, labels):
    return torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.long()[:, None])[:, 0]


def bn_train(params, mesh, device="cpu"):
    """BN_STEPS SGD steps of :func:`bn_net` from ``params`` on ``mesh``
    (None: this process alone); (losses, the trainer's state dict as
    numpy)."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    with mx.Context(torch.device(device)):
        net = bn_net(nn)
        net.initialize()
    load_numpy_params(net, params)
    tr = par.ShardedTrainer(net, "sgd", loss=bn_ce, mesh=mesh,
                            optimizer_params={"learning_rate": BN_LR})
    losses = [float(tr.step(x, (y,))) for x, y in bn_batches()]
    return np.array(losses), {k: v.cpu().numpy()
                              for k, v in tr.state_dict().items()}


def scenario_bn(out, d):
    """The BatchNorm net at dp 2: its statistics are the global batch's
    (the ranks' rows differ by ``BN_SHIFT``)."""
    params = dict(np.load(os.path.join(d, "params.npz")))
    device = os.environ.get("BN_DEVICE", "cpu")
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    losses, state = bn_train(params, par.make_mesh(dp=2), device)
    out["bn:losses"] = losses
    for k, v in state.items():
        out[f"bn:{k}"] = v


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
