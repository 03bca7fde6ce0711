"""The port's public surface against the JAX package's.

For every module present in both packages, every public name of the
reference (its ``__all__``, else the public names it defines) must exist
in the port; for every class among them, every public attribute of the
reference's class; and for every public function, constructor and public
method, every parameter name of the reference's (a port signature with
``**kwargs`` takes them all).  A reference module the port lacks must be
listed.  Each gap the port keeps is listed below with its reason: by
design (the reference's jax machinery, which the port replaces), or
queued, with the ROADMAP queue that ports it.  A listed gap that the port
has since filled fails the test, so the lists only shrink.

Names are keyed by where they are defined: ``module:name`` for a module
attribute, ``module.Class.attr`` for a class attribute and
``module.func(param)`` for a parameter (``*`` matches any class or
function).  The reference's IO bindings (``utils/native.py``) live in the
port's ``utils/native_io.py``; its ``utils/native.py`` builds the CUDA
kernels.

Also here: the dense-cache decode API (``GPT2Model.init_cache`` /
``prefill`` / ``forward_step``) decodes the reference's greedy tokens.
"""
import fnmatch
import importlib
import inspect
import pkgutil

import numpy as onp
import pytest

import mxnet_tpu
import mxnet_tpu_torch

_JAX = "the reference's jax machinery; the port's counterpart is torch's"
_KEYS = ("jax's functional PRNG keys; the port draws from per-device "
         "torch generators (random.generator, GraphDraws) and Philox")
_A7 = "queue A7 (serving tiers, migration and the fleet)"
_A8 = "queue A8 (tools and analysis)"
_A9 = "queue A9 (the long tail)"

# reference modules with no port counterpart
MODULES = {
    "analysis.lint": _A8, "analysis.raceguard": _A8,
    "autograd.tape": "by design: torch's autograd records the tape",
    "ops._smap": "by design: jax's shard_map",
    "utils.platform": "by design: the TPU plugin's platform forcing",
    "serving.kv_tiers": _A7, "serving.migration": _A7, "fleet": _A7,
    "fleet.autoscaler": _A7, "fleet.directory": _A7, "fleet.policy": _A7,
    "fleet.replica": _A7, "fleet.router": _A7,
    **{m: _A9 for m in (
        "attribute", "callback", "contrib", "contrib.quantization",
        "engine", "gluon.contrib", "gluon.contrib.estimator",
        "gluon.contrib.estimator.estimator",
        "gluon.contrib.estimator.event_handler", "gluon.contrib.nn",
        "image", "image.detection", "library", "metric", "model", "module",
        "monitor", "name", "ndarray.sparse", "numpy", "numpy.linalg",
        "numpy.random", "numpy_extension", "onnx", "onnx.mx2onnx",
        "onnx.onnx2mx", "onnx.proto", "operator", "rtc", "runtime",
        "subgraph", "symbol", "symbol.passes", "test_utils", "util",
        "visualization")},
}

# the port module that holds a reference module's names, where it differs
RENAMED = {"utils.native": "utils.native_io"}

# public names, attributes and parameters the port lacks
GAPS = {
    # by design
    "ndarray.ndarray:from_jax": _JAX,
    "ndarray.ndarray.NDArray.jax": _JAX,
    "ndarray.ndarray.NDArray.__init__(ctx)": "by design: the NDArray "
        "constructor wraps one torch tensor (NDArray(tensor, alias))",
    "ndarray.ndarray.NDArray.__init__(_base_arr)": "by design: as ctx",
    "ndarray.ndarray.NDArray.__init__(_key)": "by design: as ctx",
    "base:canonical_dtype": "by design: the port maps dtypes with "
        "base.torch_dtype",
    "base:dtype_np_to_jax": _JAX,
    "context:tpu": "by design: no TPU on the port's hosts",
    "context:num_tpus": "by design: no TPU on the port's hosts",
    "context.Context.jax_device": _JAX + " (Context.torch_device)",
    "random:next_key": _KEYS, "random:push_trace_key": _KEYS,
    "random:pop_trace_key": _KEYS, "random.RandomState.next_key": _KEYS,
    "models.gpt2.GPT2Model.draft_slots(keys)": _KEYS,
    "gluon.loss.PoissonNLLLoss.hybrid_forward(x)": "by design: the port's "
        "loss implements hybrid_forward(F, pred, target); the reference's "
        "implements forward and inherits the base's hybrid_forward(F, x)",
    "gluon.cached_op:make_pure_fn": "by design: the pure_fn jax traces; "
        "the port's CachedOp captures CUDA graphs",
    "gluon.cached_op:collect_block_params": "by design: as make_pure_fn",
    "gluon.cached_op:param_snapshot": "by design: as make_pure_fn",
    "ops.flash:DEFAULT_BLOCK_Q": "by design: block_q/block_k are the TPU "
        "kernel's tiles; the CUDA kernels pick their own",
    "ops.flash:DEFAULT_BLOCK_K": "by design: as DEFAULT_BLOCK_Q",
    "ops.flash.flash_attention(block_q)": "by design: as DEFAULT_BLOCK_Q",
    "ops.flash.flash_attention(block_k)": "by design: as DEFAULT_BLOCK_Q",
    "*(interpret)": "by design: Pallas interpret mode; a wrapper takes "
        "its plain version for CPU tensors",
    "gluon.rnn._rnn_impl.rnn_layer_forward(dropout_keys)": _KEYS,
    "serving.sampling:request_key": _KEYS,
    "serving.sampling.sample_tokens(keys)": "by design: the noise is a "
        "Philox hash of (seed, position) computed on the device",
    "serving.engine.Request.key": _KEYS,
    "models.transformer.*.forward_step_window(cache)": "by design: the "
        "port's drafter reads the gathered cache rows (cache_rows), "
        "taken once for all draft steps",
    "models.transformer.*.forward_step_window(page_table)": "by design: "
        "as forward_step_window(cache)",
    # queued
    "*.export": _A9, "*.optimize_for": _A9,
    "gluon.block:SymbolBlock": _A9,
    "gluon.parameter.Parameter.var": _A9,
    "ndarray.ndarray.NDArray.stype": _A9 + " (sparse storage)",
    "ndarray.ndarray.NDArray.tostype": _A9 + " (sparse storage)",
    "ndarray:Custom": _A9 + " (operator.py)",
    "gluon.parameter.Constant.var": _A9,
    **{f"profiler:{n}": _A9 for n in (
        "Frame", "Task", "dump", "dumps", "pause", "resume", "set_config",
        "set_state")},
    **{f"analysis:{n}": _A8 for n in (
        "Finding", "RULES", "build_guard_map", "corroborate", "raceguard",
        "run_lint")},
    # jax's own mesh and sharding classes: the port's Mesh is a grid of
    # ranks with process groups, its NamedSharding a mesh and a spec that
    # compute a rank's block
    "_src.mesh.Mesh.*": _JAX, "sharding.NamedSharding.*": _JAX,
    "sharding.PartitionSpec.*": _JAX,
    "kvstore.KVStore.row_sparse_pull": _A9 + " (sparse storage)",
    **{f"serving:{n}": _A7 for n in (
        "HostKVTier", "MIGRATION_SCHEMA_VERSION", "MigrationBundle",
        "TierHandle", "bundle_digest", "export_bundle", "verify_bundle")},
    "serving:request_key": _KEYS,
    **{f"serving.engine.InferenceEngine.{n}": _A7 for n in (
        "adopt", "export_prefix_seeds", "migrate_to", "seed_prefix")},
    "serving.engine.InferenceEngine.submit(route_hint)": _A7,
    "serving.engine.Request.route_hint": _A7,
    "serving.engine.Request.__init__(route_hint)": _A7,
    "serving.kv_pages.PagedPrefixCache.upgrade": _A7,
    "serving.kv_pages.PagedPrefixCache.__init__(demote_hook)": _A7,
    "serving.kv_pages.PagedPrefixEntry.tier": _A7,
    "serving.prefix_cache.PrefixEntry.tier": _A7,
    "serving.kv_slots.SlotState.tier_promo": _A7,
}


def _modules(pkg):
    out = {"": pkg.__name__}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[m.name.split(".", 1)[1]] = m.name
    return out


def _rel(obj):
    """``obj``'s defining module, relative to its package."""
    mod = getattr(obj, "__module__", "") or ""
    return mod.split(".", 1)[1] if "." in mod else ""


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items() if not n.startswith("_")
                 and not inspect.ismodule(v)
                 and getattr(v, "__module__", mod.__name__) == mod.__name__]
    return sorted(set(names))


def _params(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None, True
    ps = sig.parameters.values()
    return ([p.name for p in ps if p.kind not in (p.VAR_POSITIONAL,
                                                  p.VAR_KEYWORD)],
            any(p.kind == p.VAR_KEYWORD for p in ps))


def _listed(key):
    if key in GAPS:
        return True
    return any(fnmatch.fnmatchcase(key, k) for k in GAPS if "*" in k)


def _surface_gaps():
    """(gaps, module gaps): every reference name, attribute and parameter
    the port lacks, keyed as GAPS keys them."""
    ref, port = _modules(mxnet_tpu), _modules(mxnet_tpu_torch)
    missing_modules = sorted(set(ref) - set(port) - set(RENAMED))
    gaps = set()
    for name in sorted(set(ref) & (set(port) | set(RENAMED))):
        r = importlib.import_module(ref[name])
        p = importlib.import_module(port[RENAMED.get(name, name)])
        for n in _public(r):
            a = getattr(r, n, None)
            if not hasattr(p, n):
                gaps.add(f"{name}:{n}")
                continue
            b = getattr(p, n)
            pairs = []
            if inspect.isclass(a) and inspect.isclass(b):
                cls = f"{_rel(a)}.{a.__qualname__}"
                for attr in dir(a):
                    if attr.startswith("_"):
                        continue
                    if not hasattr(b, attr):
                        gaps.add(f"{cls}.{attr}")
                    elif inspect.isfunction(getattr(a, attr)):
                        pairs.append((f"{cls}.{attr}", getattr(a, attr),
                                      getattr(b, attr)))
                pairs.append((f"{cls}.__init__", a.__init__, b.__init__))
            elif inspect.isfunction(a) and callable(b):
                pairs.append((f"{_rel(a)}.{a.__name__}", a, b))
            for key, fa, fb in pairs:
                pa, _ = _params(fa)
                pb, var_kw = _params(fb)
                if pa is None or pb is None or var_kw:
                    continue
                for q in pa:
                    if q not in pb:
                        gaps.add(f"{key}({q})")
    return gaps, missing_modules


@pytest.fixture(scope="module")
def surface():
    return _surface_gaps()


def test_no_unlisted_gap(surface):
    gaps, missing_modules = surface
    unlisted = sorted(g for g in gaps if not _listed(g))
    assert not unlisted, f"reference names missing from the port: {unlisted}"
    assert sorted(m for m in missing_modules if m not in MODULES) == [], \
        "reference modules missing from the port"


def test_every_listed_gap_is_still_a_gap_and_has_a_reason(surface):
    gaps, missing_modules = surface
    stale = sorted(k for k in GAPS if "*" not in k and k not in gaps)
    assert not stale, f"listed gaps the port has filled: {stale}"
    wild = [k for k in GAPS if "*" in k]
    assert all(any(fnmatch.fnmatchcase(g, k) for g in gaps) for k in wild)
    assert sorted(m for m in MODULES if m not in missing_modules) == [], \
        "listed modules the port now has"
    for reason in (*GAPS.values(), *MODULES.values()):
        assert reason.startswith(("by design", "queue A", _JAX, _KEYS))


@pytest.mark.parametrize("module", [
    "recordio", "io", "data", "data.prefetch", "data.transforms",
    "data.sharded_loader", "gluon.data", "gluon.data.dataset",
    "gluon.data.sampler", "gluon.data.dataloader", "gluon.data.vision",
    "gluon.data.vision.datasets", "gluon.data.vision.transforms",
    "utils.colorspace", "utils.native_io"])
def test_the_data_pipeline_is_ported(module):
    """Queue A4's modules exist under the reference's names, with every
    public name of the reference's."""
    p = importlib.import_module(f"mxnet_tpu_torch.{module}")
    ref_name = {"utils.native_io": "utils.native"}.get(module, module)
    r = importlib.import_module(f"mxnet_tpu.{ref_name}")
    assert [n for n in _public(r) if not hasattr(p, n)] == []


def test_queue_c_names_behave(tmp_path):
    """A few of the filled names, held to the reference's values."""
    import mxnet_tpu as R
    import mxnet_tpu_torch as P
    x = onp.random.RandomState(0).randn(3, 4).astype("float32")
    with P.cpu():
        a, b = P.nd.array(x), R.nd.array(x)
        for m, kw in [("std", {}), ("var", {"axis": 1}),
                      ("cumsum", {"axis": 0}), ("sort", {}),
                      ("argsort", {"axis": 0}), ("all", {"axis": 1}),
                      ("any", {"keepdims": True}), ("ravel", {})]:
            got, want = getattr(a, m)(**kw).asnumpy(), \
                getattr(b, m)(**kw).asnumpy()
            assert got.dtype == want.dtype, m
            onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for g, w in zip(a.nonzero(), b.nonzero()):
            assert onp.array_equal(g.asnumpy(), w.asnumpy())
        assert a.itemsize == b.itemsize == 4
        assert list(a.flat) == list(b.flat)
        assert a.device == a.context and a.as_in_ctx(P.cpu()).shape == (3, 4)
        onp.testing.assert_array_equal(
            P.nd.linspace(0, 1, 7, dtype="int32").asnumpy(),
            R.nd.linspace(0, 1, 7, dtype="int32").asnumpy())
        onp.testing.assert_array_equal(P.nd.eye(3, 4, k=1).asnumpy(),
                                       R.nd.eye(3, 4, k=1).asnumpy())
    assert P.context.num_gpus() == (
        __import__("torch").cuda.device_count())
    assert P.Device is P.Context and P.context.current_device is \
        P.context.current_context
    assert P.base.numeric_types == R.base.numeric_types
    assert P.base.integer_types == R.base.integer_types
    assert P.base.string_types == R.base.string_types
    for seed in (0, 7):
        R.random.seed(seed)
        P.random.seed(seed)
        assert onp.array_equal(R.random.host_rng().permutation(50),
                               P.random.host_rng().permutation(50))
    assert isinstance(P.random.get_state(), P.random.RandomState)
    opt = P.optimizer.Optimizer.create_optimizer("sgd", learning_rate=0.5)
    assert type(opt).__name__ == "SGD" and opt.learning_rate == 0.5


def test_dense_cache_decode_matches_reference_greedy():
    """``init_cache`` / ``prefill`` / ``forward_step`` decode the
    reference's greedy tokens at the small GPT-2, and the logits of each
    step agree to the float32 parity bound (1e-4)."""
    import mxnet_tpu as R
    from mxnet_tpu.models import get_gpt2 as jget
    from mxnet_tpu_torch.models import get_gpt2 as tget
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    cfg = dict(vocab_size=128, units=64, num_layers=2, num_heads=4,
               max_length=48, dropout=0.0)
    jn = jget("gpt2_124m", **cfg)
    R.random.seed(0)
    jn.initialize()
    params = {k: p.data().asnumpy()
              for k, p in jn._collect_params_with_prefix().items()}
    tn = load_numpy_params(tget("gpt2_124m", device="cpu", **cfg), params)
    prompt = onp.random.RandomState(3).randint(0, 128, (2, 7)).astype(
        "int32")

    def decode(net, nd_array, to_np, new=8):
        caches = net.init_cache(2, 24)
        logits, caches = net.prefill(nd_array(prompt), caches)
        toks, all_logits = [], [to_np(logits)]
        tok = all_logits[-1].argmax(-1).astype("int32")[:, None]
        for i in range(new):
            toks.append(tok[:, 0])
            logits, caches = net.forward_step(nd_array(tok), caches,
                                              prompt.shape[1] + i)
            all_logits.append(to_np(logits))
            tok = all_logits[-1].argmax(-1).astype("int32")[:, None]
        return onp.stack(toks, 1), all_logits

    jt, jl = decode(jn, R.nd.array, lambda x: x.asnumpy())
    with mxnet_tpu_torch.cpu():
        tt, tl = decode(tn, mxnet_tpu_torch.nd.array, lambda x: x.asnumpy())
    assert onp.array_equal(jt, tt)
    for a, b in zip(jl, tl):
        onp.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
