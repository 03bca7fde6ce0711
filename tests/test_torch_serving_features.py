"""The port engine's chunked prefill, prefix cache, page pressure and
speculative decode against the JAX package.

One 2-layer GPT-2 (units 64, heads 4, vocab 128, max_length 96) in both
packages from one set of weights; seq buckets 16 and 32, 8-position
pages.  Eight prompts: three longer than the largest bucket (chunked),
two short ones, and three sharing a 28-token prefix (prefix hits).
Greedy streams of the port engine must be token-identical to the
reference's ``net.generate`` in every arm: chunked prefill (dense, paged
gather, paged kernel arm's plain version), the prefix cache (dense pool
rows, paged), a pool so small it preempts and resumes, and speculation
with k = 2 and 3 (dense, paged; rewinds release their pages); and a
preempted request resumes by a hit on its own parked entry.  So that
a near-tie cannot flip a token between frameworks, the reference's
top-2 logit margin is first held above 1e-4 at every generated position.
With every request submitted before ``start()`` the port engine makes
the reference engine's scheduling decisions: its counts of prefill
chunks, prefix hits, tokens saved, preemptions and accepted drafts
equal the reference's.  Sampled streams are identical with speculation
on and off.  No write lands in the positions a prefix entry caches, nor
in the zero page.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu.serving import InferenceEngine as JEngine
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.serving import InferenceEngine
from mxnet_tpu_torch.utils.convert import load_numpy_params

torch.set_num_threads(1)

CFG = dict(vocab_size=128, units=64, num_layers=2, num_heads=4,
           max_length=96, dropout=0.0)
NEW = 8
MARGIN = 1e-4
WEIGHT_SEED = 9
PROMPT_SEED = 26
SHARED = 28


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
    prompts = [p.astype("int32") for p in prompts]
    refs = [jn.generate(mx.nd.array(p[None], dtype="int32"), NEW,
                        temperature=0).asnumpy()[0] for p in prompts]
    return jn, tn, prompts, refs


def _engine(cls, net, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_batch", 4)
    kw.setdefault("seq_buckets", (16, 32))
    kw.setdefault("page_size", 8)
    if cls is InferenceEngine:
        kw["device"] = "cpu"
    return cls(net, **kw)


def _serve(eng, prompts, warm=True, new=NEW, **kw):
    """Every request submitted before ``start()``: the schedule is then
    the same in both packages."""
    if warm:
        eng.warmup()
    futs = [eng.submit(p, max_new_tokens=new, **kw) for p in prompts]
    eng.start()
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        eng.stop()


def _assert_clear_margins(jn, prompts, refs):
    width = max(len(r) for r in refs)
    batch = onp.zeros((len(refs), width), "int32")
    for i, r in enumerate(refs):
        batch[i, :len(r)] = r
    all_logits = jn(mx.nd.array(batch, dtype="int32")).asnumpy()
    for p, r, logits in zip(prompts, refs, all_logits):
        for t in range(len(p) - 1, len(r) - 1):
            top2 = onp.sort(logits[t])[-2:]
            assert top2[1] - top2[0] > MARGIN, (len(p), t)


def test_reference_streams_have_clear_margins(setup):
    jn, _tn, prompts, refs = setup
    _assert_clear_margins(jn, prompts, refs)


ARMS = {
    "chunked-dense": dict(kv_layout="dense"),
    "chunked-paged-gather": dict(kv_layout="paged",
                                 paged_attention="gather"),
    "chunked-paged-kernel": dict(kv_layout="paged"),
    "prefix-dense": dict(kv_layout="dense", prefix_pool_rows=2),
    "prefix-paged": dict(kv_layout="paged", prefix_min_tokens=8),
    "pressure-paged": dict(kv_layout="paged", num_pages=12),
    "spec2-dense": dict(kv_layout="dense", spec_tokens=2),
    "spec3-dense": dict(kv_layout="dense", spec_tokens=3,
                        prefix_pool_rows=2),
    "spec2-paged": dict(kv_layout="paged", spec_tokens=2,
                        prefix_min_tokens=200),
    "spec3-paged": dict(kv_layout="paged", spec_tokens=3,
                        prefix_min_tokens=200),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_greedy_streams_token_identical_to_reference(setup, arm):
    _jn, tn, prompts, refs = setup
    eng = _engine(InferenceEngine, tn, **ARMS[arm])
    outs = _serve(eng, prompts)
    for r, o in zip(refs, outs):
        onp.testing.assert_array_equal(o, r)
    s = eng.stats()
    c = s["counters"]
    assert c["completed"] == len(prompts)
    assert c["tokens_generated"] == NEW * len(prompts)
    # three prompts exceed the 32 bucket: at least two chunks each
    assert c["prefill_chunks"] >= 6
    if arm.startswith("prefix"):
        assert c["prefix_hits"] >= 1
        assert c["prefix_tokens_saved"] >= 8
    if arm == "pressure-paged":
        assert c["preemptions"] >= 1 and c["preempt_resumes"] >= 1
        assert c["page_faults"] >= 1
    if arm.startswith("spec"):
        assert c["spec_cycles"] >= 1
        assert 0 < c["spec_tokens_accepted"] <= c["spec_tokens_proposed"]
        assert s["rates"]["spec_acceptance_rate"] == round(
            c["spec_tokens_accepted"] / c["spec_tokens_proposed"], 4)
    if arm.startswith("spec") and arm.endswith("paged"):
        # nothing cached (prefix_min_tokens > any prompt): rewinds and
        # releases hand every page back
        assert c["spec_pages_rewound"] >= 1
        assert eng._pool.free_count == eng.num_pages
        assert all(eng._pool.refs(p) == 0 for p in range(eng.num_pages))


@pytest.mark.parametrize("kw", [
    dict(kv_layout="dense", prefix_pool_rows=2),
    dict(kv_layout="paged", num_pages=12, spec_tokens=2),
], ids=["dense-prefix", "paged-pressure-spec"])
def test_schedule_counts_equal_the_reference_engine(setup, kw):
    jn, tn, prompts, refs = setup
    ref_eng = _engine(JEngine, jn, **kw)
    ref_outs = _serve(ref_eng, prompts, warm=False)
    eng = _engine(InferenceEngine, tn, **kw)
    outs = _serve(eng, prompts)
    for r, a, b in zip(refs, ref_outs, outs):
        onp.testing.assert_array_equal(a, r)
        onp.testing.assert_array_equal(b, r)
    rs, c = ref_eng.stats(), eng.stats()["counters"]
    want = {"prefill_chunks": rs["batches"]["prefill_chunks"],
            "prefix_hits": rs["prefix_cache"]["prefix_hits"],
            "prefix_tokens_saved": rs["prefix_cache"]["prefix_tokens_saved"],
            "preemptions": rs["overload"]["preemptions"],
            "spec_tokens_accepted":
                rs["speculative"]["spec_tokens_accepted"]}
    assert {k: c[k] for k in want} == want
    assert want["prefill_chunks"] >= 6 and want["prefix_hits"] >= 1


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sampled_streams_identical_with_speculation_on_and_off(setup,
                                                               layout):
    _jn, tn, prompts, _refs = setup
    samp = dict(temperature=0.8, top_k=20, top_p=0.95, seed=5)
    outs = {k: _serve(_engine(InferenceEngine, tn, kv_layout=layout,
                              spec_tokens=k), prompts, **samp)
            for k in (0, 3)}
    for a, b in zip(outs[0], outs[3]):
        onp.testing.assert_array_equal(a, b)
    greedy = _serve(_engine(InferenceEngine, tn, kv_layout=layout),
                    prompts[:1])[0]
    assert not onp.array_equal(outs[0][0], greedy)


def _pages_kv(caches, pages, n):
    """Every leaf's positions [0, n) held by a list of pages."""
    pages = torch.tensor(list(pages))
    return [a[pages].reshape((-1,) + tuple(a.shape[2:]))[:n].clone()
            for layer in caches for a in layer.values()]


def _entry_kv(caches, entry, ps):
    """Every leaf's positions [0, length) of a paged prefix entry."""
    return _pages_kv(caches, entry.pages, entry.length)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_writes_never_land_in_cached_prefix_positions(setup, kv_quant):
    """Wave 1 fills the prefix cache; wave 2 (prefix hits, chunked
    suffixes, speculative windows and their rewinds) must leave every
    surviving entry's cached positions bit for bit as they were, and the
    zero page zero: a hit's suffix starts past the shared whole pages
    and its tail page is a private copy.  Wave 2 holds new suffixes
    behind the 28-token family prefix: their hits end inside a page
    (28 = 3 pages of 8 + 4) whose cached positions past 28 differ."""
    _jn, tn, prompts, _refs = setup
    rs = onp.random.RandomState(3)
    fresh = [onp.concatenate([prompts[5][:SHARED], rs.randint(0, 128, n)])
             .astype("int32") for n in (6, 11)]
    eng = _engine(InferenceEngine, tn, kv_layout="paged", kv_quant=kv_quant,
                  spec_tokens=2, prefix_min_tokens=8)
    eng.warmup()
    with eng:
        for f in [eng.submit(p, max_new_tokens=NEW) for p in prompts[5:]]:
            f.result(timeout=300)
        before = {id(e): _entry_kv(eng._caches, e, eng.page_size)
                  for e in eng._prefix._entries}
        assert before
        c0 = eng.stats()["counters"]
        for f in [eng.submit(p, max_new_tokens=NEW)
                  for p in prompts + fresh]:
            f.result(timeout=300)
        c = eng.stats()["counters"]
        assert c["prefix_hits"] - c0["prefix_hits"] >= 5
        # the fresh suffixes' hits copied tails: 3 whole pages + 4
        assert c["prefix_tokens_saved"] - c0["prefix_tokens_saved"] >= \
            2 * SHARED
        kept = [e for e in eng._prefix._entries if id(e) in before]
        assert kept
        for e in kept:
            for a, b in zip(_entry_kv(eng._caches, e, eng.page_size),
                            before[id(e)]):
                assert torch.equal(a, b)
    zero = eng.num_pages
    for layer in eng._caches:
        for name, a in layer.items():
            assert (a[zero] == 0).all(), name


# three unrelated prompts, 16 new tokens each, k = 2, and a 13-page pool:
# the youngest request is preempted mid-decode at a position inside a
# page, and its parked entry survives to its resume, because releasing
# the victim hands back the page its next write had claimed
RESUME_LENS = (35, 41, 48)
RESUME_NEW = 16
RESUME_SEED = 3


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_preempted_request_resumes_by_hit_on_its_parked_entry(setup,
                                                               kv_quant):
    """A decoding victim parks ``[0, pos)`` (its prompt and generated
    tokens) as a prefix entry; its continuation, whose prompt now ends
    with those generated tokens, is admitted by a hit on that entry:
    the whole pages shared, the partly written tail page copied, int8
    scales included.  No two prompts share a prefix, so every hit is a
    resume.  The streams equal the reference's ``generate`` and the
    reference engine counts the same preemptions, hits and tokens
    saved."""
    jn, tn, _prompts, _refs = setup
    rs = onp.random.RandomState(RESUME_SEED)
    prompts = [rs.randint(0, 128, (n,)).astype("int32")
               for n in RESUME_LENS]
    assert len({tuple(p[:4]) for p in prompts}) == len(prompts)
    refs = [jn.generate(mx.nd.array(p[None], dtype="int32"), RESUME_NEW,
                        temperature=0).asnumpy()[0] for p in prompts]
    _assert_clear_margins(jn, prompts, refs)
    kw = dict(kv_layout="paged", kv_quant=kv_quant, num_pages=13,
              spec_tokens=2, prefix_min_tokens=4)
    eng = _engine(InferenceEngine, tn, **kw)
    parked = []
    preempt = eng._preempt

    def record(slot, st):
        if not st.prefilling:
            parked.append((st.pos, len(st.generated)))
        preempt(slot, st)
    eng._preempt = record
    resumed = []
    admit = eng._prefix_admit_paged

    def check(st, slot, entry, match):
        # the resumed slot's pages hold the parked K/V bit for bit
        admit(st, slot, entry, match)
        if st.request.preempted and st.filled:
            got = _pages_kv(eng._caches, st.pages, st.filled)
            want = _pages_kv(eng._caches, entry.pages, st.filled)
            resumed.append((st.filled, all(torch.equal(a, b)
                                           for a, b in zip(got, want))))
    eng._prefix_admit_paged = check
    outs = _serve(eng, prompts, new=RESUME_NEW)
    for r, o in zip(refs, outs):
        onp.testing.assert_array_equal(o, r)
    c = eng.stats()["counters"]
    # a victim with generated tokens, parked inside a page, and resumed
    # over its parked positions: whole pages shared, the tail copied
    assert any(g > 0 and pos % eng.page_size for pos, g in parked), parked
    assert any(n % eng.page_size for n, _same in resumed), resumed
    assert all(same for _n, same in resumed), resumed
    assert c["preempt_resumes"] == c["preemptions"] >= 1
    assert c["prefix_hits"] >= 1
    assert c["prefix_tokens_saved"] >= max(pos for pos, _g in parked)
    ref_eng = _engine(JEngine, jn, **kw)
    _serve(ref_eng, prompts, warm=False, new=RESUME_NEW)
    rs_ = ref_eng.stats()
    assert (c["preemptions"], c["prefix_hits"], c["prefix_tokens_saved"]) \
        == (rs_["overload"]["preemptions"],
            rs_["prefix_cache"]["prefix_hits"],
            rs_["prefix_cache"]["prefix_tokens_saved"])
