"""The port's sharded serving against the JAX package's
(``tests/test_sharded_serving.py``'s contracts).

The port runs one gloo process per rank, started by ``tools/launch.py``
(``torch_dist_worker.py``): scenario ``serving`` on 2 ranks and
``serving2d`` on 4 (the 2-D mesh).  Every rank builds each engine; rank
0 schedules and its streams are compared here.  The reference runs its
mesh engine on its CPU devices (``tests/conftest.py``).  The net, the
prompts and the seeds are that file's (vocabulary 97, 32 units, 2
layers, 4 heads, 64 positions); one more case serves a vocabulary of 96,
which tp = 2 splits.  Streams are token-identical to the reference's
mesh engine and to the port's one-device engine; a sampled row is held
to the port's one-device engine only, since the port's sampler draws its
noise from a Philox hash of (seed, position) where the reference uses
jax's keys (a divergence by design, ``test_torch_surface.py``).  The
step logits of the mesh engine's program net agree with the reference's
forward within 1e-5 relative to their largest value.
"""
import json
import os

import jax
import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import get_gpt2
from mxnet_tpu.parallel import make_mesh
from mxnet_tpu.serving import InferenceEngine, ServingError

import torch_dist_worker as W
from torch_ref_nets import preserved, seeded

VOCAB = 97


def _ref_net(vocab=VOCAB):
    with seeded(0):
        n = get_gpt2("gpt2_124m", **dict(W.SERVE_CFG, vocab_size=vocab))
        n.initialize()
    return n


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module", autouse=True)
def _random_states_as_found():
    """The module leaves numpy's, torch's and both ``mx.random`` states
    as it found them (its reference engines draw keys)."""
    with preserved():
        yield


@pytest.fixture(scope="module")
def nets():
    return {VOCAB: _ref_net(), 96: _ref_net(96)}


@pytest.fixture(scope="module")
def run(tmp_path_factory, nets):
    d = tmp_path_factory.mktemp("serving")
    onp.savez(os.path.join(d, "params.npz"), **_params(nets[VOCAB]))
    onp.savez(os.path.join(d, "params96.npz"), **_params(nets[96]))
    ranks = W.launch(2, "serving", d)
    return ranks[0], W.launch(4, "serving2d", d)[0], ranks


def _ref_engine(net, mesh=None, **kw):
    for k, v in dict(num_slots=2, max_batch=2, seq_buckets=(8, 16),
                     default_max_new_tokens=8).items():
        kw.setdefault(k, v)
    return InferenceEngine(net, mesh=mesh, **kw)


def _ref_serve(eng, prompts, samp=None, max_new=8):
    n_warm = eng.warmup()
    with eng:
        futs = [eng.submit(p, max_new_tokens=max_new,
                           **((samp or [{}] * len(prompts))[i]))
                for i, p in enumerate(prompts)]
        outs = [f.result(timeout=300) for f in futs]
        s = eng.stats()
    assert s["compile"]["compiles"] == n_warm
    return outs, s


def _outs(out, tag):
    n = sum(1 for k in out if k.startswith(f"{tag}:out"))
    return [out[f"{tag}:out{i}"] for i in range(n)]


def _stats(out, tag):
    return json.loads(str(out[f"{tag}:stats"]))


def _generate(net, prompts, n=8):
    return [net.generate(mx.nd.array(p[None], dtype="int32"), n,
                         temperature=0).asnumpy()[0] for p in prompts]


def _same(a, b, samp=None):
    """Streams ``a`` and ``b`` equal; with ``samp``, only the greedy
    rows (``b`` the reference's)."""
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if samp is None or not samp[i].get("temperature"):
            onp.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("case", ["greedy", "sampled", "spec", "paged",
                                  "int8", "slot", "slot_spec", "vocab96"])
def test_streams_equal_the_reference_mesh_engine_and_one_device(
        run, nets, case):
    """Greedy across buckets, seeded sampling, speculation (greedy and
    sampled rows), the paged layout (against the one-device dense
    engine), int8 pages, the dense slot axis (also under speculation),
    and a vocabulary tp splits: rank 0's streams equal the reference's
    mesh engine's and the port's one-device engine's, and the compile
    count froze at warmup()."""
    out = run[0]
    pr, samp, kw, axis = W.SERVE_CASES[case]
    prompts = W.serve_prompts(**pr)
    got = _outs(out, case)
    _same(got, _outs(out, f"{case}:base"))
    net = nets[pr.get("vocab", VOCAB)]
    mesh = 2 if axis == "tp" else make_mesh(dp=2, tp=1,
                                            devices=jax.devices()[:2])
    want, s = _ref_serve(_ref_engine(net, mesh=mesh, name=f"ref_{case}",
                                     **kw), prompts, samp)
    _same(got, want, samp)
    st = _stats(out, case)
    assert st["compile"]["compiles"] == int(out[f"{case}:warm"])
    assert st["compile"]["by_mesh_point"] == \
        {st["mesh"]["mesh_point"]: int(out[f"{case}:warm"])}
    assert st["mesh"] == s["mesh"]
    if "spec" in case:
        assert st["speculative"]["spec_cycles"] > 0
    if case == "paged":
        assert st["slots"]["pages_total"] > 0
    if case.startswith("slot"):
        assert st["mesh"]["slot_axis"] == "dp"


def test_paged_mesh_equals_the_one_device_dense_engine(run, nets):
    """The strictest cross-layout, cross-placement pin: the paged mesh
    engine's greedy streams equal the reference's one-device dense
    engine's."""
    pr, _s, _kw, _a = W.SERVE_CASES["paged"]
    want, _ = _ref_serve(_ref_engine(nets[VOCAB], name="ref_dense"),
                         W.serve_prompts(**pr))
    _same(_outs(run[0], "paged"), want)


def test_prefix_and_chunked_prefill_compose(run, nets):
    out = run[0]
    _same(_outs(out, "prefix"), _generate(nets[VOCAB], W.shared_prompts(),
                                         4))
    st = _stats(out, "prefix")
    assert st["prefix_cache"]["prefix_hits"] > 0
    assert st["batches"]["prefill_chunks"] > 0
    assert st["compile"]["compiles"] == int(out["prefix:warm"])


def test_two_d_mesh_equals_the_reference_and_one_device(run, nets):
    """tp 2 x a dp slot axis of 2 on 4 ranks, prefix cache on, greedy
    and sampled rows (the reference's slow 4-device test)."""
    out = run[1]
    pr, samp, kw = W.SERVE_2D
    got = _outs(out, "2d")
    _same(got, _outs(out, "2d:base"))
    mesh = make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    want, s = _ref_serve(_ref_engine(nets[VOCAB], mesh=mesh,
                                     mesh_axes=("tp", "dp"), name="ref_2x2",
                                     **kw), W.serve_prompts(**pr), samp)
    _same(got, want, samp)
    st = _stats(out, "2d")
    assert st["mesh"] == s["mesh"]
    assert st["mesh"]["devices"] == 4
    assert st["mesh"]["axes"] == {"tp": 2, "dp": 2}
    assert st["compile"]["compiles"] == int(out["2d:warm"])


def test_step_logits_agree_with_the_reference(run, nets):
    """The mesh engine's program net (each rank's 2 of the 4 heads) on 2
    prompts: the prefill's last-position logits and one decode step's
    agree with the reference's forward within 1e-5 of their largest
    value, and with the one-device net's."""
    out = run[0]
    toks = onp.stack(W.serve_prompts((8, 8), seed=12))
    assert out["logits:kv_heads"].tolist() == [2, 8]
    jn = nets[VOCAB]
    nxt = out["logits:mesh:next"]
    want_pre = jn(mx.nd.array(toks, dtype="int32")).asnumpy()[:, -1]
    want_dec = jn(mx.nd.array(onp.concatenate([toks, nxt[:, None]], 1),
                              dtype="int32")).asnumpy()[:, -1]
    for kind, want in (("prefill", want_pre), ("decode", want_dec)):
        for tag in ("mesh", "one"):
            got = out[f"logits:{tag}:{kind}"]
            scale = onp.abs(want).max()
            assert onp.abs(got - want).max() <= 1e-5 * scale, (kind, tag)
    onp.testing.assert_array_equal(out["logits:one:next"], nxt)


# --------------------------------------------------- freeze + observability


def test_compile_freeze_at_distinct_mesh_points(run):
    out = run[0]
    s1, s2 = _stats(out, "points:base"), _stats(out, "points")
    assert s1["compile"]["mesh_point"] == "1dev"
    assert s2["compile"]["mesh_point"] == "2dev:tp=2"
    merged = dict(s1["compile"]["by_mesh_point"])
    merged.update(s2["compile"]["by_mesh_point"])
    assert merged == {"1dev": int(out["points:base:warm"]),
                      "2dev:tp=2": int(out["points:warm"])}


def test_mesh_devices_gauge_and_stats_section(run):
    out = run[0]
    assert out["gauge:mesh"].tolist() == [2]
    assert json.loads(str(out["gauge:stats"])) == {
        "enabled": True, "devices": 2, "axes": {"tp": 2},
        "model_axis": "tp", "slot_axis": None, "mesh_point": "2dev:tp=2"}
    assert out["gauge:one"].tolist() == [1, 0]


# ------------------------------------------------------------- validation


# each case's words in the reference's message for the same mistake
# (``test_sharded_serving.py:test_mesh_config_validation_typed``), or
# the port's own for its refusals
VALIDATION = {"heads": "attention heads", "paged": "paged",
              "devices": "devices", "axis": "axis", "distinct": "DISTINCT",
              "zero": ">= 1", "type": "Mesh", "rows": "row count",
              "forward": "decode-mode", "kernel": "kernel",
              "parity": "debug_parity", "role_slot": "slot axis"}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_every_incompatible_mesh_raises_typed_at_construction(run, nets,
                                                              case):
    msg = str(run[0][f"invalid:{case}"])
    assert VALIDATION[case] in msg, msg
    ref = {"heads": dict(mesh=3), "devices": dict(mesh=4096),
           "axis": dict(mesh=2, mesh_axes="bogus"),
           "distinct": dict(mesh=2, mesh_axes=("tp", "tp")),
           "zero": dict(mesh=0), "type": dict(mesh="tp"),
           "paged": dict(mesh=2, kv_layout="paged", page_size=8,
                         mesh_axes=("tp", "dp")),
           "kernel": dict(mesh=2, kv_layout="paged", page_size=8,
                          paged_attention="kernel"),
           "parity": dict(mesh=2, kv_layout="paged", page_size=8,
                          debug_parity=True)}.get(case)
    if ref is not None:
        with pytest.raises(ServingError, match=VALIDATION[case]):
            _ref_engine(nets[VOCAB], name=f"ref_bad_{case}", **ref)


# ------------------------------------------------------------ containment


def test_dispatch_faults_are_contained(run, nets):
    """Retryable faults at ``serving.decode_step`` and
    ``serving.prefill`` fire on rank 0 before the plan leaves, retry
    within budget, and the streams stay token-identical."""
    out = run[0]
    assert out["fault:fired"].tolist() == [1, 1]
    _same(_outs(out, "fault"), _generate(nets[VOCAB],
                                         W.serve_prompts((5, 9), seed=9)))
    st = _stats(out, "fault")
    assert st["resilience"]["retries"] >= 2
    assert st["requests"]["completed"] == 2


def test_a_follower_failing_a_plan_condemns_the_engine_without_a_hang(run):
    """Rank 1 fails to apply the page table's upload: the status word
    after that plan reaches rank 0, whose request fails with
    ``EngineCrashedError`` and whose engine is condemned; rank 1's
    ``start()`` raises the same; both ranks go on to the end."""
    ranks = run[2]
    assert str(ranks[0]["crash:request"]) == "EngineCrashedError"
    assert not bool(ranks[0]["crash:health"])
    assert str(ranks[1]["crash:start"]) == "EngineCrashedError"
    assert str(ranks[0]["crash:start"]) == ""


def test_a_follower_failing_a_beat_plan_condemns_the_engine_at_the_next_call(
        run):
    """The caches' zeroing after rank 0's failed first request rides an
    idle beat, and rank 1 fails to apply it: the next call's status word
    carries that failure, so the second request fails with
    ``EngineCrashedError`` and the engine is condemned; rank 1's
    ``start()`` raises the same."""
    ranks = run[2]
    assert ranks[1]["beat:carriers"].tolist() == ["beat"]
    assert ranks[0]["beat:requests"].tolist() == ["InjectedFault",
                                                  "EngineCrashedError"]
    assert not bool(ranks[0]["beat:health"])
    assert str(ranks[1]["beat:start"]) == "EngineCrashedError"
    assert str(ranks[0]["beat:start"]) == ""


# -------------------------------------- the int8 scale scan over ranks


def test_a_nan_scale_in_a_head_only_rank_1_holds_is_found(run, nets):
    """The scale scan takes the union over the ranks' heads: the reader
    of a NaN scale in rank 1's heads fails typed, one dequant fault is
    counted, the entry over the tainted page is dropped, and the
    family's next member recomputes (no second hit) with the reference
    mesh engine's tokens."""
    out = run[0]
    assert str(out["scan:victim"]) == "NonFiniteOutputError"
    faults, hits, inserts = out["scan:counts"].tolist()
    assert (faults, hits) == (1, 1) and inserts >= 2
    assert int(out["scan:entries"]) == 0
    fam = W.scan_family()
    want, _s = _ref_serve(_ref_engine(nets[VOCAB], mesh=2, name="ref_scan",
                                      kv_layout="paged", page_size=8,
                                      kv_quant="int8", prefix_min_tokens=4),
                          fam[2:], max_new=4)
    onp.testing.assert_array_equal(out["scan:next"], want[0])


# ------------------------------------------- migration and tiers at tp 2


def _ref_bundles(net, prompts, mesh):
    from mxnet_tpu.serving import MigrationError
    got = []

    def target(bundle, future):
        got.append(bundle)
        raise MigrationError("captured")
    eng = _ref_engine(net, mesh=mesh, role="prefill", name=f"ref_mig{mesh}",
                      **W.MIG_KW)
    eng.migrate_to(target)
    _ref_serve(eng, prompts)
    return got


def test_a_tp2_prefill_hands_off_to_one_process_and_back(run, nets):
    """The tp = 2 prefill engine's bundles hold whole heads, equal to the
    reference mesh engine's bundles (its digest recomputes in both
    packages); a one-process decode engine continues them, and a tp = 2
    decode engine continues a one-process engine's, greedy streams equal
    to the reference's."""
    from mxnet_tpu.serving.migration import bundle_digest as jdigest
    out = run[0]
    net = nets[VOCAB]
    prompts = W.serve_prompts((5, 11, 14), seed=14)
    want = _generate(net, prompts)
    refs = _ref_bundles(net, prompts, 2)
    for i, p in enumerate(prompts):
        d_want, d_got = out[f"mig:digest{i}"].tolist()
        assert d_want == d_got
        onp.testing.assert_array_equal(out[f"mig:prompt{i}"], p)
        leaves = [out[f"mig:b{i}:leaf{j}"]
                  for j in range(len(refs[i].arrays))]
        for a, b in zip(leaves, refs[i].arrays):
            assert a.shape == onp.asarray(b).shape
            onp.testing.assert_allclose(a, onp.asarray(b), rtol=1e-5,
                                        atol=1e-5)
        ref_b = refs[i]
        ref_b.arrays = leaves
        ref_b.digest = str(d_want)
        assert jdigest(ref_b) == str(d_want)
        onp.testing.assert_array_equal(out[f"mig:fwd{i}"], want[i])
        onp.testing.assert_array_equal(out[f"mig:back{i}"], want[i])
        onp.testing.assert_array_equal(out[f"mig:pre:out{i}"], want[i])


def test_tiers_at_tp2_equal_the_reference_mesh_engine(run, nets):
    """A demotion gathers the heads to rank 0 and a promotion sends each
    rank its heads: greedy streams and the tier's counts equal the
    reference mesh engine's on the same traffic, and an exported prefix
    seed carries whole heads."""
    out = run[0]
    net = nets[VOCAB]
    traffic = W.tier_traffic()
    eng = _ref_engine(net, mesh=2, name="ref_tier", num_pages=12,
                      prefix_min_tokens=8, seq_buckets=(8, 16, 32),
                      host_pool_bytes=64 << 20, **W.MIG_KW)
    eng.warmup()
    with eng:
        want = []
        for i, p in enumerate(traffic):
            if i == 7:
                eng._tier.drain()
            want.append(eng.infer(p, max_new_tokens=4))
        eng._tier.drain()
        s = eng.stats()["tier"]
    for i, w in enumerate(want):
        onp.testing.assert_array_equal(out[f"tier:out{i}"], w)
    counts = [s["tier_demotes"], s["tier_promotes"], s["tier_hits"]]
    assert out["tier:counts"].tolist() == counts and counts[1] >= 1
    # the model's 4 heads, both ranks' blocks
    assert all(sh[-2] == 4 for sh in out["tier:seed_shapes"].tolist())
