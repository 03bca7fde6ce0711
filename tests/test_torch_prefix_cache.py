"""The port's prefix caches and page pool against the JAX package's.

The same seeded sequence of operations — inserts, lookups, pins,
removals, and for the paged cache page claims with the eviction hook,
page sharing by refcount, releases and eviction sweeps — runs on the
reference's ``PrefixCache`` / ``PagedPrefixCache`` / ``PagePool`` and
on the port's.  After every operation both must report the same result
(rows, page lists, match lengths, freed ids) and the same state: free
and shared page counts, every page's refcount, ``evictable_pages``, the
entry count and the eviction counter.  Host structures only: exact.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu.serving import kv_pages as jpages
from mxnet_tpu.serving import prefix_cache as jprefix
from mxnet_tpu_torch.serving import kv_pages as tpages
from mxnet_tpu_torch.serving import prefix_cache as tprefix
from mxnet_tpu_torch.serving.errors import ServingError

torch.set_num_threads(1)

PS = 4
FAMILIES = onp.random.RandomState(0).randint(0, 9, (3, 24))


def _tokens(rs):
    """A prompt from one of three families: a family prefix, sometimes
    with a short suffix from a small alphabet (so prefixes recur)."""
    fam = FAMILIES[rs.randint(3)]
    n = int(rs.choice([4, 8, 10, 16, 24]))
    toks = fam[:n]
    if rs.rand() < 0.5:
        toks = onp.concatenate([toks, rs.randint(0, 3, rs.randint(1, 6))])
    return toks.astype("int32")


def _entry(e):
    if e is None:
        return None
    return (e.row, tuple(getattr(e, "pages", ())), e.length, e.refs)


def _drive_dense(mod, seed, n_ops=120):
    rs = onp.random.RandomState(seed)
    cache = mod.PrefixCache(3, row_base=5, min_tokens=4)
    pinned, trace = [], []
    for _ in range(n_ops):
        op = rs.randint(5)
        entries = cache._entries
        if op == 0:
            trace.append(("insert", _entry(cache.insert(_tokens(rs)))))
        elif op == 1:
            hit = cache.lookup(_tokens(rs))
            trace.append(("lookup", None if hit is None
                          else (hit[0], _entry(hit[1]))))
        elif op == 2 and entries:
            e = entries[rs.randint(len(entries))]
            cache.pin(e)
            pinned.append(e)
        elif op == 3 and pinned:
            cache.unpin(pinned.pop(rs.randint(len(pinned))))
        elif op == 4 and entries:
            e = entries[rs.randint(len(entries))]
            if e.refs == 0:
                cache.remove(e)
        trace.append((len(cache), cache.free_rows, cache.evictions,
                      sorted(_entry(e) for e in cache._entries)))
    return trace


def _drive_paged(mod, seed, n_ops=160):
    rs = onp.random.RandomState(seed)
    pool = mod.PagePool(24, PS)
    cache = mod.PagedPrefixCache(pool, min_tokens=4)
    live, pinned, trace = [], [], []
    for _ in range(n_ops):
        op = rs.randint(9)
        entries = list(cache._entries)
        if op == 0:
            toks = _tokens(rs)
            pages = pool.alloc(pool.pages_for(len(toks)), cache.evict_pages)
            trace.append(("alloc", pages))
            if pages is not None:
                live.append((toks, pages))
        elif op == 1 and live:
            toks, pages = live[rs.randint(len(live))]
            n = rs.randint(1, len(toks) + 1)
            e = cache.insert(toks[:n], pages[:pool.pages_for(n)], n)
            trace.append(("insert", _entry(e)))
        elif op == 2 and live:
            _toks, pages = live.pop(rs.randint(len(live)))
            trace.append(("release", pool.release(pages)))
        elif op == 3:
            hit = cache.lookup(_tokens(rs))
            trace.append(("lookup", None if hit is None
                          else (hit[0], _entry(hit[1]))))
        elif op == 4 and entries:
            # a hit sharing an entry's whole pages by refcount
            e = entries[rs.randint(len(entries))]
            n_full = e.length // PS
            for pid in e.pages[:n_full]:
                pool.ref(pid)
            if n_full:
                live.append((onp.zeros(n_full * PS, "int32"),
                             list(e.pages[:n_full])))
        elif op == 5 and entries:
            e = entries[rs.randint(len(entries))]
            cache.pin(e)
            pinned.append(e)
        elif op == 6 and pinned:
            cache.unpin(pinned.pop(rs.randint(len(pinned))))
        elif op == 7:
            trace.append(("evict", cache.evict_pages(rs.randint(1, 6))))
        elif op == 8 and entries:
            e = entries[rs.randint(len(entries))]
            if e.refs == 0:
                cache.remove(e)
        trace.append((pool.free_count, pool.shared_count,
                      cache.evictable_pages(), len(cache), cache.evictions,
                      [pool.refs(p) for p in range(pool.num_pages)]))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_dense_prefix_cache_matches_reference(seed):
    ref = _drive_dense(jprefix, seed)
    assert any(t[0] == "lookup" and t[1] is not None for t in ref
               if isinstance(t[0], str))
    assert ref[-1][2] > 0, "no eviction exercised"
    assert _drive_dense(tprefix, seed) == ref


@pytest.mark.parametrize("seed", range(8))
def test_paged_prefix_cache_and_pool_match_reference(seed):
    ref = _drive_paged(jpages, seed)
    ops = {t[0] for t in ref if isinstance(t[0], str)}
    assert {"alloc", "insert", "release", "lookup", "evict"} <= ops
    assert max(t[1] for t in ref if not isinstance(t[0], str)) >= 1, \
        "no page was ever shared"
    assert _drive_paged(tpages, seed) == ref


def test_shared_pages_survive_eviction():
    """An entry's eviction drops only its own claim on pages a slot
    still reads: nothing frees until the slot releases them too, and
    an entry a reader pins is never a victim."""
    for mod in (jpages, tpages):
        pool = mod.PagePool(8, PS)
        cache = mod.PagedPrefixCache(pool, min_tokens=4)
        pages = pool.alloc(3)
        toks = FAMILIES[0][:12]
        cache.insert(toks, pages, 12)
        assert [pool.refs(p) for p in pages] == [2, 2, 2]
        assert cache.evictable_pages() == 0       # the slot still reads
        assert cache.evict_pages(3) == 0
        assert len(cache) == 0 and cache.evictions == 1
        assert [pool.refs(p) for p in pages] == [1, 1, 1]
        assert cache.lookup(toks) is None
        e = cache.insert(toks, pages, 12)
        cache.pin(e)
        pool.release(pages)
        assert cache.evictable_pages() == 0 and cache.evict_pages(3) == 0
        cache.unpin(e)
        assert cache.evictable_pages() == 3
        assert cache.evict_pages(1) == 3 and pool.free_count == 8


def test_zero_page_is_never_a_pool_page():
    """The zero page (id num_pages) can be neither allocated, shared nor
    released; the trash page past it exists on the device only."""
    pool = tpages.PagePool(4, PS)
    got = pool.alloc(4)
    assert sorted(got) == [0, 1, 2, 3] and pool.scratch == 4
    assert pool.alloc(1) is None
    for bad in (pool.ref, pool.unref):
        with pytest.raises(ServingError):
            bad(pool.scratch)
        with pytest.raises(ServingError):
            bad(pool.scratch + 1)
