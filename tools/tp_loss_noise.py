"""The float32 noise of phase 22's BERT-large and Transformer-big runs
(``chip_smoke.py``'s models, batches, seed and DP_STEPS Adam steps):
the same steps on one process in float64 (the plain attention path) and
in float32 (the flash kernels), and in float32 at tp = 2 on two gloo
ranks of this card (``chip_smoke.shard_train_rank``).  On the card, from
the repository root:

    python3 tools/tp_loss_noise.py

It prints each step's loss in the three runs, the float32 runs'
distances to float64 and to each other (relative), and the parameters'
max-abs distances after the last step (the tp ranks' blocks against the
same slices), with the parameters that part most.  It tells whether a
gap between the tp = 2 run and one process is the size of float32's own
error on the model."""
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

KINDS = ("bert", "nmt")


def rank(d):
    """One of the two tp = 2 ranks: chip_smoke's phase 22 (b) and (c)."""
    import torch
    from mxnet_tpu_torch import parallel as par
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    par.init_distributed(backend="gloo")
    torch.cuda.set_device(par.distributed.local_device())
    out = {}
    for kind in KINDS:
        cs.shard_train_rank(torch, kind, par.rank(), d, out)
    np.savez(os.path.join(d, f"noise_r{par.rank()}.npz"), **out)
    par.barrier()


def float64_loss(kind):
    """Phase 22's loss, taken in float64 (chip_smoke's widens to
    float32)."""
    def bert(outs, mlm_labels, nsp_labels):
        m, n = outs[0].double(), outs[1].double()
        lm = m.logsumexp(-1) - m.gather(-1, mlm_labels.long()[..., None])[
            ..., 0]
        ln = n.logsumexp(-1) - n.gather(-1, nsp_labels.long()[:, None])[
            :, 0]
        return lm.mean(-1) + ln

    def nmt(logits, labels):
        x = logits.double()
        lse = x.logsumexp(-1)
        picked = x.gather(-1, labels.long()[..., None])[..., 0]
        return (0.9 * (lse - picked) + 0.1 * (lse - x.mean(-1))).mean()
    return bert if kind == "bert" else nmt


def one_process(torch, kind, dtype):
    """DP_STEPS steps on one process: (losses, parameters)."""
    from mxnet_tpu_torch import parallel as par
    data, labels, loss, lr = cs.shard_lang_step(kind)
    if dtype == "float64":
        loss = float64_loss(kind)
    net = cs.shard_lang_net(kind).initialize(seed=cs.SEED)
    net.cast(dtype)
    tr = par.ShardedTrainer(net, "adam", loss=loss,
                            optimizer_params={"learning_rate": lr})
    with cs.attention_impl("ref") if dtype == "float64" else \
            cs.contextlib.nullcontext():
        losses = [float(tr.step(data, labels)) for _ in range(cs.DP_STEPS)]
    params = {n: p.detach().double() for n, p in net.named_parameters()}
    del net, tr
    cs.free(torch)
    return losses, params


def rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def main():
    import torch
    from mxnet_tpu_torch.utils import native
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    native.build()
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "launch.py"), "-n",
                        "2", sys.executable, os.path.abspath(__file__),
                        "--rank", d], check=True, timeout=1200)
        r0 = dict(np.load(os.path.join(d, "noise_r0.npz")))
        for kind in KINDS:
            tp = r0[f"{kind}:losses"].tolist()
            f64, p64 = one_process(torch, kind, "float64")
            f32, p32 = one_process(torch, kind, "float32")
            print(f"{kind} losses: float64 {f64}, float32 {f32}, float32 "
                  f"tp = 2 {tp}; float32 from float64 {rel(f32, f64):.3e}, "
                  f"tp from float64 {rel(tp, f64):.3e}, tp from float32 "
                  f"{rel(tp, f32):.3e} (worst step, relative) [{card}]",
                  flush=True)
            d32 = {n: float((p32[n] - p64[n]).abs().max()) for n in p64}
            tp32, tp64 = {}, {}
            for r in (0, 1):
                blocks = torch.load(os.path.join(d, f"{kind}_params_r{r}.pt"))
                for n, (b, sl) in blocks.items():
                    sel = tuple(slice(*x) for x in sl) if sl else ...
                    b = b.cuda().double()
                    tp32[n] = max(tp32.get(n, 0.0),
                                  float((b - p32[n][sel]).abs().max()))
                    tp64[n] = max(tp64.get(n, 0.0),
                                  float((b - p64[n][sel]).abs().max()))
            worst = sorted(tp32, key=tp32.get, reverse=True)[:5]
            print(f"{kind} parameters after {cs.DP_STEPS} steps (max-abs): "
                  f"float32 from float64 {max(d32.values()):.3e}, tp from "
                  f"float64 {max(tp64.values()):.3e}, tp from float32 "
                  f"{max(tp32.values()):.3e}; parting most (tp from float32"
                  f" / float32 from float64): "
                  f"{[(n, round(tp32[n], 8), round(d32[n], 8)) for n in worst]}"
                  f" [{card}]", flush=True)
            del p64, p32
            cs.free(torch)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank(sys.argv[2])
    else:
        main()
