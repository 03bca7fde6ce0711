"""The port's ``InferenceEngine`` against the JAX package's GPT-2.

Greedy streams of the port engine — dense, paged with the gather arm,
paged with the kernel arm (its plain version on the CPU) — must be
token-identical to the reference's ``net.generate`` on the same weights,
across two seq buckets.  So that a near-tie cannot flip a token between
frameworks, the test first asserts that the reference's top-2 logit
margin exceeds 1e-4 at every generated position of its prompts (the
frameworks' float32 logits differ by ~1e-6 here).  int8 pages hold the
reference's contract: logits within 5e-2 of float32 and the first two
greedy tokens exact (``tests/test_paged_attn.py``); so that the 5e-2
logit error cannot flip one of those tokens, the test first asserts
that the reference's top-2 margin exceeds 5e-2 at both positions of
every prompt.  The reference weights are drawn from a fixed seed
(``WEIGHT_SEED``), so they do not depend on which tests ran before in
the same process.  Also: parked rows
and unassigned pages never write the zero page, a sampled stream depends
only on its seed, the port imports no JAX, and nothing runs on a
missing card.
"""
import ast
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import get_gpt2 as jget_gpt2
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import get_gpt2 as tget_gpt2
from mxnet_tpu_torch.serving import InferenceEngine, InvalidRequestError
from mxnet_tpu_torch.utils.convert import load_numpy_params

CFG = dict(vocab_size=128, units=64, num_layers=2, num_heads=4,
           max_length=96, dropout=0.0)
NEW = 8
LENS = (5, 12, 20, 27)            # seq buckets 16 and 32
MARGIN = 1e-4
INT8_CONTRACT = 5e-2
# the reference's weights and the prompts: chosen so that every prompt's
# two int8 horizon positions have a top-2 margin above INT8_CONTRACT
WEIGHT_SEED = 9
PROMPT_SEED = 26
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    prompts = [rs.randint(0, 128, (n,)).astype("int32") for n in LENS]
    refs = [jn.generate(mx.nd.array(p[None], dtype="int32"), NEW,
                        temperature=0).asnumpy()[0] for p in prompts]
    return jn, tn, prompts, refs


def _engine(tn, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_batch", 4)
    kw.setdefault("seq_buckets", (16, 32))
    kw.setdefault("page_size", 8)
    return InferenceEngine(tn, device="cpu", **kw)


def _serve(eng, prompts, **kw):
    eng.warmup()
    with eng:
        futs = [eng.submit(p, max_new_tokens=NEW, **kw) for p in prompts]
        return [f.result(timeout=120) for f in futs]


def test_reference_streams_have_clear_margins(setup):
    """No near-tie anywhere the parity tests read a token.  One batched
    reference forward over the right-padded streams (causal: padding
    never reaches an earlier position)."""
    jn, _tn, prompts, refs = setup
    width = max(len(r) for r in refs)
    batch = onp.zeros((len(refs), width), "int32")
    for i, r in enumerate(refs):
        batch[i, :len(r)] = r
    all_logits = jn(mx.nd.array(batch, dtype="int32")).asnumpy()
    for p, r, logits in zip(prompts, refs, all_logits):
        for t in range(len(p) - 1, len(r) - 1):
            top2 = onp.sort(logits[t])[-2:]
            assert top2[1] - top2[0] > MARGIN, (len(p), t)
            assert logits[t].argmax() == r[t + 1]


@pytest.mark.parametrize("kw", [
    dict(kv_layout="dense"),
    dict(kv_layout="paged", paged_attention="gather"),
    dict(kv_layout="paged", paged_attention="kernel"),
], ids=["dense", "paged-gather", "paged-kernel"])
def test_greedy_streams_token_identical_to_reference(setup, kw):
    _jn, tn, prompts, refs = setup
    eng = _engine(tn, **kw)
    outs = _serve(eng, prompts)
    for r, o in zip(refs, outs):
        assert o.dtype == onp.int32
        onp.testing.assert_array_equal(o, r)
    s = eng.stats()
    assert s["counters"]["completed"] == len(prompts)
    assert s["counters"]["tokens_generated"] == NEW * len(prompts)
    assert s["latency"]["ttft"]["count"] == len(prompts)


def _top2_margin(logits):
    top2 = onp.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def test_int8_pages_hold_reference_contract(setup):
    jn, tn, prompts, refs = setup
    # the two horizon positions of every prompt (the logits that choose
    # its first two new tokens) must be further apart than the int8
    # logit error, or a token comparison below could flip on a tie
    for p, r in zip(prompts, refs):
        logits = jn(mx.nd.array(r[None, :len(p) + 1],
                                dtype="int32")).asnumpy()[0]
        for t in (len(p) - 1, len(p)):
            margin = _top2_margin(logits[t])
            assert margin > INT8_CONTRACT, (len(p), t, margin)
    outs = _serve(_engine(tn, kv_layout="paged", kv_quant="int8"), prompts)
    for p, r, o in zip(prompts, refs, outs):
        onp.testing.assert_array_equal(o[:len(p) + 2], r[:len(p) + 2])
    # logits: int8 paged port vs float32 reference, along the reference
    # stream (prefill, then teacher-forced decode steps)
    p, r = prompts[3], refs[3]
    ref_logits = jn(mx.nd.array(r[None], dtype="int32")).asnumpy()[0]
    n, ps = len(p), 8
    caches = tn.init_page_cache(12 + 1, ps, kv_quant="int8")
    table = torch.full((2, 12), 12, dtype=torch.int32)
    table[0] = torch.arange(12, dtype=torch.int32)
    toks = torch.zeros((1, 32), dtype=torch.int32)
    toks[0, :n] = torch.from_numpy(p)
    lg, caches = tn.prefill_slots(toks, torch.tensor([n], dtype=torch.int32),
                                  caches, torch.tensor([0], dtype=torch.int32),
                                  page_table=table, paged_kernel=True)
    worst = float(onp.abs(lg[0].numpy() - ref_logits[n - 1]).max())
    for t in range(n, len(r) - 1):
        lg, caches = tn.decode_step(
            torch.tensor([int(r[t]), 0], dtype=torch.int32), caches,
            torch.tensor([t, 96], dtype=torch.int32), page_table=table,
            paged_kernel=True)
        worst = max(worst, float(onp.abs(lg[0].numpy()
                                         - ref_logits[t]).max()))
    assert worst <= INT8_CONTRACT


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_parked_rows_and_unassigned_pages_never_write_the_zero_page(
        setup, kv_quant):
    """Every decode step runs parked rows at pos = Tmax, and prefill
    padding spills into logical pages a slot never claimed: those writes
    must land in the trash page, so the zero page stays exactly zero."""
    _jn, tn, prompts, _refs = setup
    eng = _engine(tn, kv_layout="paged", kv_quant=kv_quant, num_slots=4,
                  num_pages=40)
    _serve(eng, prompts[:2])
    zero, trash = eng.num_pages, eng.num_pages + 1
    for layer in eng._caches:
        assert layer["k"].shape[0] == eng.num_pages + 2
        for name, a in layer.items():
            assert (a[zero] == 0).all(), name
        assert (layer["k"][trash] != 0).any()


def test_eos_ends_a_stream_early(setup):
    """A request stops right after its eos token, which it keeps; a
    stream without it runs to max_new_tokens."""
    _jn, tn, prompts, refs = setup
    eos = int(refs[2][len(prompts[2]) + 3])

    def expected(p, r):
        gen = list(r[len(p):])
        return r[:len(p) + gen.index(eos) + 1] if eos in gen else r
    outs = _serve(_engine(tn, kv_layout="paged", eos_id=eos),
                  [prompts[2], prompts[0]])
    assert len(outs[0]) <= len(prompts[2]) + 4
    for p, r, o in zip((prompts[2], prompts[0]), (refs[2], refs[0]), outs):
        onp.testing.assert_array_equal(o, expected(p, r))


def test_sampled_stream_depends_only_on_seed(setup):
    _jn, tn, prompts, _refs = setup
    samp = dict(temperature=0.8, top_k=20, top_p=0.95)
    eng = _engine(tn, kv_layout="paged")
    eng.warmup()
    with eng:
        alone = eng.submit(prompts[1], max_new_tokens=NEW, seed=7,
                           **samp).result(timeout=120)
    crowd = _serve(_engine(tn, kv_layout="paged"),
                   [prompts[0], prompts[1], prompts[2]], seed=7, **samp)
    onp.testing.assert_array_equal(alone, crowd[1])
    other = _serve(_engine(tn, kv_layout="paged"), [prompts[1]], seed=8,
                   **samp)[0]
    assert not onp.array_equal(alone, other)


def test_page_budget_holds_requests_until_pages_free(setup):
    """A pool of 12 pages (one worst-case request, Tmax / 8) against four
    requests whose lifetimes need 2 + 3 + 4 + 5 pages.  Admission claims
    only prompt + 1 position (1 + 2 + 3 + 4 pages), so all four are
    admitted at once; when decode growth runs the pool dry the youngest
    slot is preempted by reference and requeued, and every stream stays
    token-identical (as in the reference's engine, the pool is too small
    for the parked prefix to survive to the resume).  Afterwards only
    prefix entries hold pages, all of them evictable."""
    _jn, tn, prompts, refs = setup
    eng = _engine(tn, kv_layout="paged", num_pages=12)
    outs = _serve(eng, prompts)
    for r, o in zip(refs, outs):
        onp.testing.assert_array_equal(o, r)
    s = eng.stats()
    c = s["counters"]
    assert s["slots"]["active_highwater"] == 4
    assert c["page_faults"] >= 1
    assert c["preemptions"] >= 1 and c["preempt_resumes"] >= 1
    assert c["tokens_generated"] == NEW * len(prompts)
    assert s["slots"]["pages_free"] + eng._prefix.evictable_pages() == 12


def test_queue_full_and_stop_without_start(setup):
    """Backpressure: past the queue depth, submit sheds; stopping an
    engine that never ran fails its queued requests typed."""
    from mxnet_tpu_torch.serving import EngineStoppedError, QueueFullError
    _jn, tn, prompts, _refs = setup
    eng = _engine(tn)
    futs = [eng.submit(prompts[0]) for _ in range(eng.QUEUE_DEPTH)]
    with pytest.raises(QueueFullError):
        eng.submit(prompts[0])
    eng.stop()
    for f in futs:
        with pytest.raises(EngineStoppedError):
            f.result(timeout=5)
    with pytest.raises(EngineStoppedError):
        eng.submit(prompts[0])
    assert eng.stats()["counters"]["shed"] == 1


def test_submit_rejects_what_it_cannot_serve(setup):
    """A prompt over the largest seq bucket (32) is served in chunks, up
    to ``max_length - max_new_tokens``; past that, or with a bad
    sampling parameter, submit refuses."""
    _jn, tn, _prompts, _refs = setup
    eng = _engine(tn)
    with pytest.raises(InvalidRequestError):
        eng.submit(onp.zeros(30, "int32"), max_new_tokens=70)
    with pytest.raises(InvalidRequestError):
        eng.submit(onp.zeros(91, "int32"), max_new_tokens=6)
    with pytest.raises(InvalidRequestError):
        eng.submit(onp.zeros(4, "int32"), temperature=-1.0)
    long = (onp.arange(96 - NEW) * 7 % 128).astype("int32")
    outs = _serve(eng, [long[:33], long])
    assert [o.shape for o in outs] == [(33 + NEW,), (96,)]
    onp.testing.assert_array_equal(outs[1][:96 - NEW], long)
    # one chunk batch a cycle, both rows in it: 32 + 32, then 1 + 32,
    # then the longer prompt's last 24
    assert eng.stats()["counters"]["prefill_chunks"] == 3
    assert eng.stats()["counters"]["rejected"] == 3


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and mxnet_tpu out
    of sys.modules, and chip_smoke.py imports neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mxnet_tpu_torch as m\n"
        "for i in pkgutil.walk_packages(m.__path__, 'mxnet_tpu_torch.'):\n"
        "    importlib.import_module(i.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'mxnet_tpu' or "
        "k.startswith('mxnet_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "mxnet_tpu"}, names


def test_entry_points_refuse_a_missing_card():
    """Without device='cpu' the entry points want the card; on a host
    without one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(MXNetError):
        tget_gpt2("gpt2_124m", **CFG)
    net = tget_gpt2("gpt2_124m", device="cpu", **CFG)
    net._device = None
    with pytest.raises(MXNetError):
        net.initialize()
    net.initialize(device="cpu")
    with pytest.raises(MXNetError):
        InferenceEngine(net)
