"""The port's prefix retention (``serving.paged_kv_cache`` with
``prefix_retention=True``, the default, as in the reference) against
``repro.serving.paged_kv_cache``: the traces of
``tests/test_prefix_cache.py`` replayed side by side on the JAX manager
and the port's, with equal tables, refcounts, free lists, retained pages
and tree counters after every operation and page conservation
(slot-mapped + tree-retained + free == pool):

* the page high-water tracker stays three ints over 500 requests;
* an evicted chain never matches on re-admit (LRU leaf-end eviction
  under pool pressure, back to front);
* a ring recycle clears the registry entries of the pages it rewrites;
* the radix tree's eviction order through branches;
* a ring drop whose retained orphans a live slot still maps;
* retention off: the registry dies with its pages' last sharer.

Then the warm prefix hit: two serve waves on one engine, the second
sharing the first's prompt head after every first-wave request released.
Its greedy streams equal a cold engine's (retention off) and the JAX
engine's warm streams, on the fp and the int8 pool, source and qp merge.
Tolerance: identity of token lists and of manager state."""
import jax
import numpy as np
import pytest

from repro import configs as jcfg
from repro.core import merge_skipless as jax_merge
from repro.models import init_params as jax_init_params
from repro.serving import Engine as JaxEngine
from repro.serving import PagedCacheAdapter as JaxPagedAdapter
from repro.serving import PagedQ8CacheAdapter as JaxQ8Adapter
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving.radix_tree import RadixPrefixTree as JaxTree
from repro_torch import configs as tcfg
from repro_torch.convert import to_torch
from repro_torch.serving import (Engine, PagedCacheAdapter,
                                 PagedQ8CacheAdapter, ServeConfig)
from repro_torch.serving import paged_kv_cache as tpkv
from repro_torch.serving.radix_tree import RadixPrefixTree
from test_torch_sched_plan import _conservation, _Pair

BLOCK = 8  # the page size of test_torch_sched_plan's managers


def _pair(n_blocks=10, window=0, retention=True):
    """The JAX manager and the port's (4 slots, max_len 64, pages of 8)."""
    return _Pair(window, n_slots=4, n_blocks=n_blocks, retention=retention)


def test_request_page_hwm_state_is_o1():
    pair = _pair(n_blocks=24)
    for i in range(500):
        toks = (np.arange(4 + (i % 3) * 8, dtype=np.int32) * 7 + i) % 97
        assert pair.do("admit", 0, toks) is not None
        pair.do("release", 0)
        pair.do("drop_prefix_cache")
    hwm = pair.t.request_page_hwm
    assert tpkv.RequestPageHwm.__slots__ == ("max", "count", "last")
    assert not hasattr(hwm, "__dict__")
    assert (hwm.count, hwm.max) == (500, 3)
    assert (hwm.max, hwm.last, hwm.count) == (
        pair.j.request_page_hwm.max, pair.j.request_page_hwm.last,
        pair.j.request_page_hwm.count)


def test_evicted_prefix_never_matches_on_readmit():
    pair = _pair(n_blocks=10)
    prompt = (np.arange(27, dtype=np.int32) * 3 + 1) % 97  # 4 pages
    assert pair.do("admit", 0, prompt) == 0
    pair.do("release", 0)
    assert len(pair.t.tree.retained) == 4
    # pressure: an 8-page prompt needs 2 more than the free list holds;
    # eviction reclaims exactly those, leaf-end first (the chain's tail)
    big = (np.arange(8 * BLOCK, dtype=np.int32) * 7 + 2) % 97
    assert pair.do("admit", 1, big) == 0
    assert pair.t.tree.n_evicted == 2
    pages, covered = pair.match(prompt)
    assert len(pages) == 2 and covered == 2 * BLOCK
    pair.do("release", 1)
    pair.do("drop_prefix_cache")
    assert pair.match(prompt) == ([], 0), "stale match after eviction"
    assert pair.do("admit", 2, prompt) == 0
    pair.do("release", 2)
    pair.do("drop_prefix_cache")
    assert pair.t.allocator.n_used == 0
    assert pair.t.tree.n_pages == 0 and pair.t.tree.n_nodes == 0


def test_ring_recycle_clears_registry_for_retained_chain():
    pair = _pair(n_blocks=10, window=16)  # a ring of 3
    prompt = (np.arange(12, dtype=np.int32) * 5 + 1) % 97
    assert pair.do("admit", 0, prompt) == 0
    while int(pair.t.lengths[0]) < 40:
        assert pair.do("ensure_appendable", 0)
        pair.do("advance", 0)
    assert pair.t.allocator.n_recycled > 0
    assert pair.match(prompt) == ([], 0), "a rolled-over page still matches"
    pair.do("release", 0)
    assert pair.t.allocator.n_used == len(pair.t.tree.retained)
    pair.do("drop_prefix_cache")
    assert pair.t.allocator.n_used == 0


def test_evict_order_lru_leaf_end_through_branches():
    orders = []
    for cls in (RadixPrefixTree, JaxTree):
        tree = cls(block_size=4)
        head = list(range(8))
        a = np.asarray(head + [20, 21, 22, 23, 30], np.int32)
        b = np.asarray(head + [40, 41, 42, 43], np.int32)
        tree.insert(a, [0, 1, 2, 3])
        tree.insert(b, [0, 1, 4])
        tree.match(b)  # branch b is the more recently used
        tree.retained = set(tree.pages())
        orders.append(tree.evict(100, lambda p: True))
        assert tree.n_pages == 0 and tree.n_nodes == 0 and not tree.retained
        assert tree.evict(1, lambda p: True) == []
    assert orders[0] == orders[1] == [3, 2, 4, 1, 0]


def test_ring_drop_with_live_sharer_of_retained_descendants():
    """C registers b0..b3; D shares them, decodes until its ring detaches
    from b0 and releases (the tree adopts b1..b3); when C's window rolls
    past b0 the dropped subtree's retained orphans are still mapped by C
    and must lose only the tree's reference."""
    pair = _pair(n_blocks=12, window=32)  # a ring of 5
    prompt = (np.arange(32, dtype=np.int32) * 3 + 1) % 97
    assert pair.do("admit", 0, prompt) == 0
    assert pair.do("admit", 1, prompt.copy()) == 4
    b0 = pair.t._slots[0].blocks[0]
    while int(pair.t.lengths[1]) < 41:
        assert pair.do("ensure_appendable", 1)
        pair.do("advance", 1)
    assert int(pair.t.allocator.ref[b0]) == 1, "D detached from b0"
    pair.do("release", 1)
    assert len(pair.t.tree.retained) == 3
    while int(pair.t.lengths[0]) < 41:
        assert pair.do("ensure_appendable", 0)
        pair.do("advance", 0)
    assert not pair.t.tree.retained and pair.t.tree.n_pages == 0
    pair.do("release", 0)
    pair.do("drop_prefix_cache")
    assert pair.t.allocator.n_used == 0


def test_retention_off_restores_old_registry_lifecycle():
    pair = _pair(n_blocks=10, retention=False)
    prompt = (np.arange(20, dtype=np.int32) * 3 + 2) % 97
    assert pair.do("admit", 0, prompt) == 0
    assert pair.do("admit", 1, prompt.copy()) == 3, "live sharing still works"
    pair.do("release", 0)
    pair.do("release", 1)
    assert pair.t.allocator.n_used == 0
    assert pair.t.tree.n_pages == 0 and not pair.t.tree.retained
    assert pair.do("admit", 2, prompt.copy()) == 0, "nothing survives to hit"
    pair.do("release", 2)
    assert pair.t.allocator.n_used == 0


# ---------------------------------------------------------------------------
# warm prefix hit == recompute == the JAX engine, fp and int8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_models():
    base = dict(block_style="skipless", dtype="float32",
                param_dtype="float32", n_kv_heads=4, sliding_window=0)
    jc = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(**base)
    tc = tcfg.reduce_config(tcfg.get_config("mistral-7b")).with_(**base)
    p = jax_init_params(jax.random.PRNGKey(0), jc)
    p["embed"]["table"] = p["embed"]["table"] * 50.0
    mp, mc = jax_merge(p, jc, "qp")
    return {merged: (c, pp, tc.with_(block_style=c.block_style,
                                     merged_variant=c.merged_variant),
                     to_torch(jax.tree.map(np.asarray, pp), device="cpu"))
            for merged, (c, pp) in ((False, (jc, p)), (True, (mc, mp)))}


def _waves(vocab):
    head = (np.arange(16, dtype=np.int32) * 5 + 1) % vocab
    wave1 = [head.copy(), np.concatenate([head, np.full((4,), 7, np.int32)])]
    wave2 = [np.concatenate([head, np.full((3,), 11, np.int32)]),
             head.copy()]
    return wave1, wave2


@pytest.mark.parametrize("q8", [False, True], ids=["fp", "q8"])
@pytest.mark.parametrize("merged", [False, True], ids=["source", "qp"])
def test_warm_prefix_hit_token_identical_to_cold(small_models, q8, merged):
    jc, jp, tc, tp = small_models[merged]
    wave1, wave2 = _waves(jc.vocab_size)
    cls, jcls = ((PagedQ8CacheAdapter, JaxQ8Adapter) if q8
                 else (PagedCacheAdapter, JaxPagedAdapter))

    def engine(retention):
        return Engine(tc, tp, ServeConfig(n_slots=2, max_len=64),
                      impl="torch", device="cpu",
                      cache=cls(block_size=BLOCK, n_blocks=24,
                                prefix_retention=retention))

    warm = engine(True)
    warm.generate(wave1, max_new_tokens=4)
    assert not warm.pm._slots, "wave 1 must have fully released"
    assert warm.pm.tree.retained, "the released prefix must be retained"
    hits0 = warm.pm.tree.hit_tokens
    warm_outs = warm.generate(wave2, max_new_tokens=4)
    assert warm.pm.tree.hit_tokens > hits0, "wave 2 must hit warm"
    cold_outs = engine(False).generate(wave2, max_new_tokens=4)
    jax_eng = JaxEngine(jc, jp, JaxServeConfig(n_slots=2, max_len=64),
                        impl="xla", cache=jcls(block_size=BLOCK,
                                               n_blocks=24))
    jax_eng.generate(wave1, max_new_tokens=4)
    jax_outs = jax_eng.generate(wave2, max_new_tokens=4)
    assert [list(o) for o in warm_outs] == [list(o) for o in cold_outs] \
        == [list(o) for o in jax_outs]
    warm.pm.drop_prefix_cache()
    assert warm.pm.allocator.n_used == 0
    _conservation(warm.pm)
