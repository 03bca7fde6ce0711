"""The port engine's compiled programs and forward mode against the JAX
package's engine.

One 2-layer GPT-2 (units 64, heads 4, vocab 128, max_length 96) in both
packages from one set of weights, the prompts of
``tests/test_torch_serving_features.py`` (three chunked, three sharing a
28-token prefix), 8 new tokens, every request submitted before
``start()`` so both engines schedule alike.  On the CPU a program runs
its function on its static buffers (the card replays a CUDA graph;
``tests/test_torch_cuda.py`` holds those), so here the copy-in and
read-out path and the accounting are what is checked:

- ``warmup()`` compiles as many programs as the reference's, in six
  configurations (dense, paged, int8 pages, chunked, prefix, and
  speculation under page pressure);
- ``compiles`` stays at that count through the traffic (full and chunk
  prefill, prefix hits, preemptions, speculative cycles) and every call
  is a bucket hit, as many as the reference counts;
- greedy streams equal the reference engine's (float32; int8 pages their
  first two tokens, the reference's int8 contract);
- the sampler: Philox-4x32-10's published test vectors, uniforms
  strictly inside (0, 1) (finite noise at the top word), ``top_k=1``
  always the argmax, and a sampled stream through the engine's programs
  equals ``generate``'s plain calls, with speculation too, depends only
  on its seed and not on its batch;
- the one registry of kernel launch counters that replays count through;
- forward mode within 1e-5 of the reference's forward mode, for a
  ``Dense`` and a small conv net carried across by
  ``utils.convert.load_numpy_params``, with the same compile accounting
  and ``stats()`` keys; a block with two outputs gives each request a
  tuple of rows.

The margins of these prompts' greedy streams (top-2 logit gap above
1e-4 at every generated position) are held by
``test_torch_serving_features.py``; its weights and prompts are reused
here unchanged.  The reference engines use small lattices (one batch
bucket) to keep their compiles cheap.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.serving import InferenceEngine as JEngine
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.serving import InferenceEngine
from mxnet_tpu_torch.serving.sampling import (gumbel_noise, philox4x32,
                                              sample_tokens,
                                              uniform_from_words)
from mxnet_tpu_torch.utils.convert import load_numpy_params

torch.set_num_threads(1)

CFG = dict(vocab_size=128, units=64, num_layers=2, num_heads=4,
           max_length=96, dropout=0.0)
NEW = 8
WEIGHT_SEED = 9
PROMPT_SEED = 26
SHARED = 28
FWD_TOL = 1e-5
LATTICE = dict(num_slots=4, max_batch=4, batch_buckets=(4,),
               seq_buckets=(16, 32), page_size=8)


@pytest.fixture(scope="module")
def setup():
    jn = jget_gpt2("gpt2_124m", **CFG)
    mx.random.seed(WEIGHT_SEED)
    jn.initialize()
    params = {k: p.data().asnumpy()
              for k, p in jn._collect_params_with_prefix().items()}
    tn = load_numpy_params(tget_gpt2("gpt2_124m", device="cpu", **CFG),
                           params)
    rs = onp.random.RandomState(PROMPT_SEED)
    shared = rs.randint(0, 128, (SHARED,))
    prompts = [rs.randint(0, 128, (n,)) for n in (40, 12, 70, 20, 45)]
    prompts += [onp.concatenate([shared, rs.randint(0, 128, (n,))])
                for n in (5, 9, 14)]
    return jn, tn, [p.astype("int32") for p in prompts]


def _serve(eng, prompts, **kw):
    """Warm up, submit everything, then start: (warmup count, outputs,
    stats)."""
    n = eng.warmup()
    futs = [eng.submit(p, max_new_tokens=NEW, **kw) for p in prompts]
    eng.start()
    try:
        outs = [f.result(timeout=300) for f in futs]
    finally:
        eng.stop()
    return n, outs, eng.stats()


CONFIGS = {
    "dense": dict(kv_layout="dense"),
    "paged": dict(kv_layout="paged"),
    "paged-int8": dict(kv_layout="paged", kv_quant="int8"),
    "chunked": dict(kv_layout="paged", prefill_chunk=16),
    "prefix": dict(kv_layout="dense", prefix_pool_rows=2),
    "spec-pressure": dict(kv_layout="paged", num_pages=12, spec_tokens=2),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_compile_accounting_and_streams_equal_the_reference(setup, name):
    jn, tn, prompts = setup
    kw = dict(LATTICE, **CONFIGS[name])
    n_ref, ref_outs, rs = _serve(JEngine(jn, **kw), prompts)
    n, outs, s = _serve(InferenceEngine(tn, device="cpu", **kw), prompts)
    assert n == n_ref
    c = s["counters"]
    # frozen: traffic compiled nothing, every call was a bucket hit
    assert c["compiles"] == n == s["compile"]["programs"]
    assert s["compile"]["compiles"] == s["compile_cache"]["compiles"] == n
    assert s["compile"]["by_mesh_point"] == {"1dev": n}
    assert c["bucket_hits"] == rs["compile_cache"]["bucket_hits"] > 0
    assert s["compile_cache"]["hit_rate"] == \
        rs["compile_cache"]["hit_rate"]
    for r, o, p in zip(ref_outs, outs, prompts):
        if CONFIGS[name].get("kv_quant"):
            onp.testing.assert_array_equal(o[:len(p) + 2], r[:len(p) + 2])
        else:
            onp.testing.assert_array_equal(o, r)
    assert c["prefill_chunks"] > 0 and c["completed"] == len(prompts)
    if name in ("prefix", "paged", "spec-pressure"):
        assert c["prefix_hits"] > 0
    if name == "spec-pressure":
        assert c["spec_cycles"] > 0 and c["preemptions"] > 0
        assert c["decode_steps"] > 0 and c["prefill_batches"] > 0


def test_stats_sections_carry_the_reference_keys(setup):
    """``stats()["compile"]`` and ``stats()["compile_cache"]`` have the
    reference's keys; before any call they read zero compiles and no hit
    rate."""
    jn, tn, _prompts = setup
    ref = JEngine(jn, **LATTICE).stats()
    got = InferenceEngine(tn, device="cpu", **LATTICE).stats()
    for key in ("compile", "compile_cache"):
        assert set(got[key]) == set(ref[key]), key
    assert got["compile"] == {"mesh_point": "1dev", "by_mesh_point": {},
                              "compiles": 0, "bucket_hits": 0,
                              "programs": 0}
    assert got["compile_cache"]["hit_rate"] is None


def test_philox_matches_published_vectors():
    """Random123's known-answer vectors for Philox-4x32-10."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = philox4x32(*(torch.tensor([c], dtype=torch.int64)
                           for c in ctr + key))
        assert tuple(int(g) for g in got) == want


def test_uniforms_stay_inside_the_open_interval():
    """The extreme words map strictly inside (0, 1), so the noise is
    finite; at GPT-2's vocabulary, seed 0 and position 454 hash entry
    48947 to the top word (its top 24 bits all ones), where a 24-bit
    mapping would round to 1.0 and give that entry infinite noise."""
    words = torch.tensor([0, 1, 0xFF, 0x1FF, 0xFFFFFF00, 0xFFFFFE00,
                          0xFFFFFFFF], dtype=torch.int64)
    u = uniform_from_words(words)
    assert u.dtype == torch.float32
    assert bool((u > 0).all()) and bool((u < 1).all())
    assert bool(torch.isfinite(-torch.log(-torch.log(u))).all())
    seed, pos = torch.tensor([0]), torch.tensor([454])
    noise = gumbel_noise(seed, pos, 50257)
    assert bool(torch.isfinite(noise).all())
    assert int(noise[0].argmax()) == 48947


def test_top_k_one_always_draws_the_argmax():
    """With ``top_k=1`` every other entry is filtered out, so the draw
    is the argmax at any seed, position and temperature, the row at
    which a top word's noise would have been infinite included."""
    rs = onp.random.RandomState(1)
    n = 64 * 16
    logits = torch.from_numpy(rs.randn(n, 128).astype("float32") * 3)
    seeds = torch.arange(64).repeat_interleave(16) * 7919 - 3
    pos = torch.arange(16).repeat(64) * 37
    temp = torch.from_numpy(rs.uniform(0.3, 2.0, n).astype("float32"))
    topk = torch.ones(n, dtype=torch.int32)
    topp = torch.from_numpy(rs.choice([1.0, 0.9], n).astype("float32"))
    got = sample_tokens(logits, temp, topk, topp, seeds, pos)
    assert torch.equal(got.long(), logits.argmax(dim=-1))
    wide = torch.from_numpy(rs.randn(1, 50257).astype("float32"))
    wide[0, 48947] = wide.min() - 1.0
    one = sample_tokens(wide, [1.0], [1], [1.0], [0], [454])
    assert int(one[0]) == int(wide[0].argmax())


def test_sampler_rows_depend_on_their_seed_and_position_only():
    """A row's draw is a function of its logits, filters, seed and
    position: the same in any batch and at any row, another with another
    seed or position; greedy rows are the argmax."""
    rs = onp.random.RandomState(0)
    logits = torch.from_numpy(rs.randn(6, 128).astype("float32") * 3)
    temp = torch.tensor([0.9, 0.9, 0.9, 0.0, 0.7, 1.3])
    topk = torch.tensor([0, 20, 0, 0, 5, 0], dtype=torch.int32)
    topp = torch.tensor([1.0, 1.0, 0.9, 1.0, 0.8, 1.0])
    seeds = torch.tensor([3, 3, 3, 3, 2 ** 40 + 7, -5])
    pos = torch.tensor([10, 10, 11, 12, 13, 95])
    full = sample_tokens(logits, temp, topk, topp, seeds, pos)
    assert full.dtype == torch.int32
    assert int(full[3]) == int(logits[3].argmax())
    for i in range(6):
        alone = sample_tokens(logits[i:i + 1], temp[i:i + 1],
                              topk[i:i + 1], topp[i:i + 1],
                              seeds[i:i + 1], pos[i:i + 1])
        assert int(alone[0]) == int(full[i])
    flip = torch.arange(5, -1, -1)
    back = sample_tokens(logits[flip], temp[flip], topk[flip], topp[flip],
                         seeds[flip], pos[flip])
    assert torch.equal(back[flip], full)
    draws = {int(sample_tokens(logits[:1], temp[:1], topk[:1], topp[:1],
                               torch.tensor([s]), torch.tensor([p]))[0])
             for s in range(4) for p in range(4)}
    assert len(draws) > 4


@pytest.mark.parametrize("spec", [0, 2], ids=["plain", "spec"])
def test_sampled_streams_through_programs_equal_plain_generate(setup,
                                                                spec):
    """The engine's programs (decode, or draft + verify) sample each
    token at its (seed, position): the stream equals ``generate``'s
    plain calls with the same seed, whatever the batch."""
    _jn, tn, prompts = setup
    short = [p for p in prompts if len(p) <= 32]
    samp = dict(temperature=0.8, top_k=20)
    eng = InferenceEngine(tn, device="cpu", spec_tokens=spec,
                          kv_layout="paged", **LATTICE)
    _n, outs, s = _serve(eng, short, seed=11, **samp)
    for p, o in zip(short, outs):
        want = tn.generate(p[None], NEW, seed=11, **samp)[0].numpy()
        onp.testing.assert_array_equal(o, want)
    assert s["counters"]["spec_cycles"] > 0 or not spec
    greedy = tn.generate(short[0][None], NEW, temperature=0)[0].numpy()
    assert not onp.array_equal(outs[0], greedy)


def test_full_depth_drafter_samples_what_decode_samples(setup):
    """The drafter's step i samples at position ``pos + i`` with the
    request's seed: over every layer it is the model, so its sampled
    proposals are the tokens of k sampled decode steps."""
    _jn, tn, prompts = setup
    s, k = 3, 3
    caches = tn.init_slot_cache(s + 1, CFG["max_length"])
    toks = torch.zeros((s, 32), dtype=torch.int32)
    lens = torch.tensor([12, 20, 30], dtype=torch.int32)
    for i, n in enumerate(lens.tolist()):
        toks[i, :n] = torch.from_numpy(prompts[4 + i][:n])
    tn.prefill_slots(toks, lens, caches, torch.arange(s, dtype=torch.int32))
    pos = torch.cat([lens, torch.tensor([CFG["max_length"]])]).int()
    temp = torch.tensor([0.9, 1.2, 0.7, 0.0])
    topk = torch.tensor([0, 10, 0, 0], dtype=torch.int32)
    topp = torch.tensor([1.0, 1.0, 0.9, 1.0])
    seeds = torch.tensor([4, 5, 6, 0])
    tok = torch.tensor([7, 8, 9, 0], dtype=torch.int32)
    drafts = tn.draft_slots(tok, caches, pos, k, CFG["num_layers"], temp,
                            topk, topp, seeds)
    cur, p = tok, pos.clone()
    for i in range(k):
        lg, caches = tn.decode_step(cur, caches, p)
        cur = sample_tokens(lg, temp, topk, topp, seeds, p)
        assert torch.equal(drafts[:s, i], cur[:s]), i
        p[:s] += 1


def _forward_both(jblock, tblock, example_shape, xs, max_batch=4):
    """Serve ``xs`` one example a request through both engines in
    forward mode: (warmup counts, outputs, stats) of each."""
    out = []
    for eng in (JEngine(jblock, max_batch=max_batch),
                InferenceEngine(tblock, max_batch=max_batch, device="cpu")):
        assert eng.mode == "forward"
        n = eng.warmup(example_shape=example_shape)
        with eng:
            res = [f.result(timeout=120) for f in
                   [eng.submit(x) for x in xs]]
        out.append((n, res, eng.stats()))
    return out


def _check_forward(ref, got, n_req):
    (n_ref, ref_outs, rs), (n, outs, s) = ref, got
    assert n == n_ref
    onp.testing.assert_allclose(onp.stack(outs), onp.stack(ref_outs),
                                rtol=FWD_TOL, atol=FWD_TOL)
    c = s["counters"]
    assert c["compiles"] == s["compile"]["compiles"] == n
    assert c["bucket_hits"] == rs["compile_cache"]["bucket_hits"]
    assert c["completed"] == rs["requests"]["completed"] == n_req
    assert c["forward_batches"] == rs["batches"]["forward_batches"]
    assert set(s["compile"]) == set(rs["compile"])


def test_launch_registry_holds_every_kernel_wrapper():
    """The one registry the programs replay counts through holds every
    kernel wrapper's counters: a change taken by ``snapshot`` and given
    back by ``add`` moves them, ``reset`` zeroes them, also after a
    caller rebinds a counter dict."""
    from mxnet_tpu_torch.ops import flash, launches, paged
    assert launches.wrappers() == {
        "flash_fwd": flash.flash_fwd, "flash_dq": flash.flash_dq,
        "flash_dkv": flash.flash_dkv,
        "paged_attention": paged.paged_attention}
    saved = launches.snapshot()
    try:
        launches.reset()
        before = launches.snapshot()
        paged.paged_attention.launches += 2
        paged.paged_attention.multi_query_launches += 1
        flash.flash_fwd.launches_by_dtype = dict(
            flash.flash_fwd.launches_by_dtype)
        flash.flash_fwd.launches_by_dtype[torch.bfloat16] += 3
        delta = {k: n - before[k] for k, n in launches.snapshot().items()}
        launches.add(delta)
        assert launches.totals() == {"flash_fwd": 6, "flash_dq": 0,
                                     "flash_dkv": 0, "paged_attention": 4}
        assert paged.paged_attention.multi_query_launches == 2
        assert launches.by_dtype()["flash_fwd"] == {"float32": 0,
                                                    "bfloat16": 6}
        launches.reset()
        assert not any(launches.snapshot().values())
    finally:
        launches.reset()
        launches.add(saved)


def test_forward_mode_dense_matches_the_reference():
    """The reference's forward-mode test block: ``Dense(8, in_units=16)``
    from one seeded set of weights, 5 requests at ``max_batch=4``."""
    rs = onp.random.RandomState(4)
    params = {"weight": rs.randn(8, 16).astype("float32"),
              "bias": rs.randn(8).astype("float32")}
    jd = jnn.Dense(8, in_units=16)
    jd.initialize()
    for k, p in jd._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    td = load_numpy_params(tnn.Dense(8, in_units=16), params, device="cpu")
    xs = rs.randn(5, 16).astype("float32")
    ref, got = _forward_both(jd, td, (16,), xs)
    _check_forward(ref, got, 5)
    assert got[0] == 3          # batch buckets 1, 2, 4


def _conv_net(nn):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(6, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=6), nn.Activation("relu"),
            nn.MaxPool2D(2), nn.Conv2D(8, 3, in_channels=6),
            nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(5, in_units=8))
    return net


def test_forward_mode_conv_net_matches_the_reference():
    """A small conv net (convolutions, BatchNorm on its moving
    statistics, pooling, a classifier) from one set of seeded weights,
    carried across by ``load_numpy_params``: 7 requests of 3 x 12 x 12
    at ``max_batch=4`` (a full batch, then 3 padded to 4)."""
    jnet = _conv_net(jnn)
    jnet.initialize()
    handles = jnet._collect_params_with_prefix()
    rs = onp.random.RandomState(5)
    params = {}
    for k, p in handles.items():
        if k.endswith(("gamma", "running_var")):
            v = rs.uniform(0.5, 1.5, p.shape)
        else:
            v = rs.randn(*p.shape) * 0.3
        params[k] = v.astype("float32")
        p.set_data(mx.nd.array(params[k]))
    tnet = load_numpy_params(_conv_net(tnn), params, device="cpu")
    xs = rs.uniform(-1, 1, (7, 3, 12, 12)).astype("float32")
    ref, got = _forward_both(jnet, tnet, (3, 12, 12), xs)
    _check_forward(ref, got, 7)
    # predict mode: the moving statistics neither used from the batch
    # nor updated
    assert onp.array_equal(tnet[1].running_mean.detach().numpy(),
                           params["1.running_mean"])


def test_forward_mode_returns_each_output_of_a_block():
    """A block with two outputs: each request's result is the tuple of
    its rows, through the program and the batch padding."""
    from mxnet_tpu_torch.gluon import HybridBlock

    class TwoHeads(HybridBlock):
        def __init__(self):
            super().__init__()
            self.a = tnn.Dense(3, in_units=4)
            self.b = tnn.Dense(2, in_units=4)

        def forward(self, x):
            return self.a(x), self.b(x)
    net = TwoHeads()
    net.initialize(device="cpu", seed=0)
    xs = onp.random.RandomState(6).randn(3, 4).astype("float32")
    eng = InferenceEngine(net, max_batch=4, device="cpu")
    assert eng.mode == "forward" and eng.warmup(example_shape=(4,)) == 3
    futs = [eng.submit(x) for x in xs]
    with eng:
        outs = [f.result(timeout=60) for f in futs]
    with torch.no_grad():
        want = net(torch.from_numpy(xs))
    for i, o in enumerate(outs):
        assert isinstance(o, tuple) and len(o) == 2
        for got, w in zip(o, want):
            onp.testing.assert_allclose(got, w[i].numpy(), rtol=1e-6,
                                        atol=1e-6)
    assert eng.stats()["counters"]["compiles"] == 3


def test_forward_mode_refuses_decode_knobs_and_groups_shapes(setup):
    """Forward mode refuses the paged layout, speculation and sampling
    parameters; requests of two shapes form two batches."""
    from mxnet_tpu_torch.serving import InvalidRequestError, ServingError
    _jn, tn, _p = setup
    td = tnn.Dense(3, in_units=4, flatten=False)
    td.initialize(device="cpu")
    with pytest.raises(ServingError, match="paged"):
        InferenceEngine(td, kv_layout="paged", device="cpu")
    with pytest.raises(ServingError, match="spec_tokens"):
        InferenceEngine(td, spec_tokens=2, device="cpu")
    with pytest.raises(ServingError, match="decode surface"):
        InferenceEngine(td, "decode", device="cpu")
    assert InferenceEngine(tn, device="cpu").mode == "decode"
    eng = InferenceEngine(td, max_batch=4, device="cpu")
    with pytest.raises(ServingError, match="example_shape"):
        eng.warmup()
    with pytest.raises(InvalidRequestError):
        eng.submit(onp.zeros(4, "float32"), temperature=0.5)
    xs = [onp.ones((4,), "float32"), onp.ones((2, 4), "float32"),
          onp.full((4,), 2.0, "float32")]
    futs = [eng.submit(x) for x in xs]
    with eng:
        outs = [f.result(timeout=60) for f in futs]
    w = td.weight.detach().numpy()
    b = td.bias.detach().numpy()
    for x, o in zip(xs, outs):
        onp.testing.assert_allclose(o, x @ w.T + b, rtol=1e-6, atol=1e-6)
    c = eng.stats()["counters"]
    assert c["forward_batches"] == 2 and c["compiles"] == 2
