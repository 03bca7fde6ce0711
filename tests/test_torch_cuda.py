"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips on a host without a CUDA device.
Run on the card with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``
(``--noconftest`` because ``tests/conftest.py`` configures JAX).

Tolerances (max-abs): float32 1e-4 (reassociated softmax sums), bf16
2e-2 (one bf16 ulp of an output near 1 is 3.9e-3), int8 pages 1e-4
against the plain version's own dequantize of the same pages.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.ops import flash, paged

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _maxabs(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,seg,d", [(True, False, 64),
                                          (False, False, 128),
                                          (True, True, 64),
                                          (True, False, 256)])
def test_flash_kernel_matches_plain(dev, dtype, causal, seg, d):
    g = torch.Generator(device=dev).manual_seed(d + causal)
    b, t, h = 2, 300, 3          # T not a multiple of the 64-row tile
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev)
               .to(dtype) for _ in range(3))
    qseg = None
    if seg:
        qseg = (torch.arange(t, device=dev) >= 100).to(torch.int32)
        qseg = (qseg + (torch.arange(t, device=dev) >= 250)).to(torch.int32)
        qseg = qseg[None].expand(b, t).contiguous()
    n0 = flash.flash_fwd.launches
    o, lse = flash.flash_fwd(q, k, v, qseg, qseg, causal=causal,
                             scale=d ** -0.5)
    torch.cuda.synchronize()
    assert flash.flash_fwd.launches == n0 + 1
    o_ref, lse_ref = flash._fwd_plain(q, k, v, qseg, qseg, causal,
                                      d ** -0.5)
    assert _maxabs(o, o_ref) <= TOL[dtype]
    assert _maxabs(lse, lse_ref) <= TOL[dtype]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("tq", [1, 16])
def test_paged_kernel_matches_plain(dev, kind, tq):
    g = torch.Generator(device=dev).manual_seed(tq)
    b, h, d, ps, npt, n = 5, 4, 64, 16, 8, 30
    kf = torch.randn((n, ps, h, d), generator=g, device=dev)
    vf = torch.randn((n, ps, h, d), generator=g, device=dev)
    kf[-1] = 0
    vf[-1] = 0
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    q = torch.randn((b, tq, h, d), generator=g, device=dev).to(dtype)
    table = torch.randint(0, n - 1, (b, npt), generator=g,
                          device=dev).to(torch.int32)
    table[-1] = n - 1                      # a parked slot
    qpos = (torch.randint(0, npt * ps - tq, (b, 1), generator=g, device=dev)
            + torch.arange(tq, device=dev)).to(torch.int32)
    ks = vs = None
    if kind == "int8":
        kp, ks = paged.kv_quantize(kf)
        vp, vs = paged.kv_quantize(vf)
    else:
        kp, vp = kf.to(dtype), vf.to(dtype)
    out = paged.paged_attention(q, kp, vp, table, qpos, k_scale=ks,
                                v_scale=vs)
    torch.cuda.synchronize()
    ref = paged._paged_plain(q, kp, vp, table, qpos, ks, vs, d ** -0.5)
    assert _maxabs(out, ref) <= TOL[dtype]
    assert bool(torch.isfinite(out).all())


def _small_gpt2(seed):
    from mxnet_tpu_torch.models import get_gpt2
    net = get_gpt2("gpt2_124m", vocab_size=256, units=128, num_layers=2,
                   num_heads=2, max_length=512, dropout=0.0)
    return net.initialize(seed=seed)


def test_engine_arms_agree_on_card(dev):
    """Greedy streams of the paged kernel arm, the gather arm and the
    dense layout agree on the card; prompts in the 384 bucket run B1."""
    from mxnet_tpu_torch.serving import InferenceEngine
    net = _small_gpt2(1)
    rs = onp.random.RandomState(0)
    prompts = [rs.randint(0, 256, (n,)).astype("int32")
               for n in (260, 300, 20)]
    outs = {}
    for arm in ("kernel", "gather", "dense"):
        kw = dict(kv_layout="dense") if arm == "dense" else \
            dict(kv_layout="paged", paged_attention=arm)
        eng = InferenceEngine(net, num_slots=4, max_batch=4,
                              seq_buckets=(32, 256, 384), **kw)
        eng.warmup()
        n_flash, n_paged = (flash.flash_fwd.launches,
                            paged.paged_attention.launches)
        with eng:
            futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            outs[arm] = [f.result(timeout=300) for f in futs]
        assert flash.flash_fwd.launches > n_flash
        assert (paged.paged_attention.launches > n_paged) == (arm ==
                                                             "kernel")
    for a, b, c in zip(outs["kernel"], outs["gather"], outs["dense"]):
        onp.testing.assert_array_equal(a, b)
        onp.testing.assert_array_equal(a, c)


def test_bf16_model_kernel_arm_matches_gather_arm(dev):
    """bf16 parameters give bf16 caches and run the bf16 instantiations
    of both kernels; per-step logits of the two read arms agree to bf16
    precision (2e-2 of logits near 1 — two arms round the same values in
    another order)."""
    net = _small_gpt2(2).cast("bfloat16")
    s, ps, npt = 2, 16, 512 // 16
    table = torch.full((s + 1, npt), s * npt, dtype=torch.int32, device=dev)
    table[:s] = torch.arange(s * npt, dtype=torch.int32,
                             device=dev).reshape(s, npt)
    toks = torch.randint(0, 256, (s, 256), dtype=torch.int32, device=dev)
    lens = torch.tensor([256, 200], dtype=torch.int32, device=dev)
    sidx = torch.arange(s, dtype=torch.int32, device=dev)
    caches = {arm: net.init_page_cache(s * npt + 1, ps)
              for arm in ("kernel", "gather")}
    assert caches["kernel"][0]["k"].dtype == torch.bfloat16
    logits = {arm: net.prefill_slots(toks, lens, caches[arm], sidx,
                                     page_table=table,
                                     paged_kernel=arm == "kernel")[0]
              for arm in caches}
    pos = torch.tensor([256, 200, 512], dtype=torch.int32, device=dev)
    for _ in range(3):
        tok = torch.zeros((s + 1,), dtype=torch.int32, device=dev)
        tok[:s] = logits["kernel"][:s].argmax(-1).to(torch.int32)
        for arm in caches:
            logits[arm] = net.decode_step(tok, caches[arm], pos,
                                          page_table=table,
                                          paged_kernel=arm == "kernel")[0]
        assert _maxabs(logits["kernel"][:s], logits["gather"][:s]) <= 2e-2
        pos[:s] += 1
