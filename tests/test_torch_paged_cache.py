"""The port's paged cache against the JAX package's: the host manager
(``serving.paged_kv_cache``) replays seeded traces side by side with
``repro.serving.paged_kv_cache.PagedCacheManager``, both with prefix
retention off (``tests/test_torch_prefix_cache.py`` replays it on), with
identical tables, lengths, refcounts, free lists and counters after
every operation; and the model's paged prefill and decode
(``forward_prefill`` with a ``PagedPrefillDest``, ``forward_step`` on a
``PagedDecodeCache``) match the JAX logits and written pages, generic and
merged, with and without a window.

Tolerances: logits atol 1e-4 after dividing both sides by the larger of 1
and the reference's largest |logit| (as in ``test_torch_model.py``);
pages atol 1e-4 on the same scale (float32 on both sides, products summed
in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.core import merge_skipless as jax_merge
from repro.serving import paged_kv_cache as jpkv
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.convert import to_torch
from repro_torch.serving import paged_kv_cache as tpkv

ATOL = 1e-4


def _cfgs(**kw):
    return (jcfg.reduce_config(jcfg.get_config("mistral-7b"), **kw),
            tcfg.reduce_config(tcfg.get_config("mistral-7b"), **kw))


# ---------------------------------------------------------------------------
# manager traces
# ---------------------------------------------------------------------------

def _managers(window, n_blocks, n_slots=4, max_len=64, bs=8):
    jc, tc = _cfgs(sliding_window=window)
    kw = dict(n_slots=n_slots, max_len=max_len, block_size=bs,
              n_blocks=n_blocks)
    return (jpkv.PagedCacheManager(jc, prefix_retention=False, **kw),
            tpkv.PagedCacheManager(tc, device="cpu", prefix_retention=False,
                                   **kw))


def _same_state(j, t, where):
    np.testing.assert_array_equal(t.tables, np.asarray(j.tables), where)
    np.testing.assert_array_equal(t.lengths, np.asarray(j.lengths), where)
    np.testing.assert_array_equal(t.allocator.ref, np.asarray(j.allocator.ref),
                                  where)
    assert t.allocator._free == j.allocator._free, where
    for k in ("n_free", "peak_used", "n_cow", "n_shared_hits", "n_recycled"):
        assert getattr(t.allocator, k) == getattr(j.allocator, k), (where, k)
    assert t.ring == j.ring and t.table_blocks == j.table_blocks
    assert (t.request_page_hwm.max, t.request_page_hwm.count) == \
        (j.request_page_hwm.max, j.request_page_hwm.count), where


def _prompts(rng, n):
    """Identical prompts, prompts sharing a prefix (whole blocks and a
    partial tail), and unrelated ones."""
    base = rng.integers(0, 128, 40)
    out = []
    for _ in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:
            out.append(base[:int(rng.choice([12, 16, 21]))].copy())
        elif kind == 1:
            m = int(rng.integers(8, 24))
            out.append(np.concatenate([base[:m],
                                       rng.integers(0, 128, rng.integers(1, 9))]))
        else:
            out.append(rng.integers(0, 128, rng.integers(3, 30)))
    return out


def _replay(seed, window, n_blocks, n_ops=160):
    """Admit / (ensure_appendable + advance) / release at random on both
    managers; a failed ensure_appendable releases the slot (what the
    engine's preemption does to the manager)."""
    rng = np.random.default_rng(seed)
    jm_, tm_ = _managers(window, n_blocks)
    prompts = _prompts(rng, 12)
    live = {}
    events = {"admit": 0, "deferred": 0, "append": 0, "exhausted": 0}
    for step in range(n_ops):
        free = [s for s in range(4) if s not in live]
        op = rng.choice(3, p=[0.3, 0.55, 0.15])
        where = f"seed {seed} op {step}"
        if op == 0 and free:
            slot, toks = free[0], prompts[rng.integers(0, len(prompts))]
            a, b = jm_.admit(slot, toks), tm_.admit(slot, toks)
            assert a == b, where
            if a is None:
                events["deferred"] += 1
            else:
                live[slot] = len(toks)
                events["admit"] += 1
        elif op == 1 and live:
            slot = list(live)[rng.integers(0, len(live))]
            if live[slot] + 1 >= 64:
                jm_.release(slot), tm_.release(slot)
                del live[slot]
            else:
                a, b = jm_.ensure_appendable(slot), tm_.ensure_appendable(slot)
                assert a == b, where
                if a:
                    jm_.advance(slot), tm_.advance(slot)
                    live[slot] += 1
                    events["append"] += 1
                else:
                    events["exhausted"] += 1
                    jm_.release(slot), tm_.release(slot)
                    del live[slot]
        elif op == 2 and live:
            slot = list(live)[rng.integers(0, len(live))]
            jm_.release(slot), tm_.release(slot)
            del live[slot]
        _same_state(jm_, tm_, where)
        for slot in live:
            np.testing.assert_array_equal(
                tm_.prefill_block_ids(slot, 32 if live[slot] <= 32 else 64),
                np.asarray(jm_.prefill_block_ids(
                    slot, 32 if live[slot] <= 32 else 64)), where)
    return tm_, events


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("window,n_blocks", [(0, 40), (0, 12), (16, 40),
                                             (16, 9), (12, 14)])
def test_manager_replays_the_jax_managers_trace(seed, window, n_blocks):
    tm_, ev = _replay(seed, window, n_blocks)
    assert ev["admit"] and ev["append"], ev
    if window:
        assert tm_.ring, "a window shorter than max_len rings the table"


def test_traces_cover_sharing_cow_recycling_and_exhaustion():
    """Across the seeds above the traces do exercise every path."""
    seen = {"n_shared_hits": 0, "n_cow": 0, "n_recycled": 0}
    exhausted = deferred = 0
    for seed in range(4):
        for window, n_blocks in ((0, 12), (16, 9), (16, 40)):
            tm_, ev = _replay(seed, window, n_blocks)
            for k in seen:
                seen[k] += getattr(tm_.allocator, k)
            exhausted += ev["exhausted"]
            deferred += ev["deferred"]
    assert all(seen.values()) and exhausted and deferred, (seen, exhausted,
                                                           deferred)


def _lockstep(window, ops, n_blocks=32, bs=8):
    """Run a scripted op list on both managers, comparing after each."""
    jm_, tm_ = _managers(window, n_blocks, n_slots=2, bs=bs)
    for i, (op, slot, *arg) in enumerate(ops):
        if op == "admit":
            assert jm_.admit(slot, arg[0]) == tm_.admit(slot, arg[0])
        elif op == "append":
            assert jm_.ensure_appendable(slot) == tm_.ensure_appendable(slot)
            jm_.advance(slot), tm_.advance(slot)
        else:
            jm_.release(slot), tm_.release(slot)
        _same_state(jm_, tm_, f"op {i} {op}")
    return tm_


def test_staggered_sharing_copies_the_shared_tail_on_write():
    """``tests/test_paged_prefill.py``'s staggered case at the manager: A
    decodes into its partial tail page, B admits the same prompt (shares
    both pages; its prefill writes none of them) and its first append
    copies the tail (copy-on-write), as the JAX manager does."""
    prompt = (np.arange(12) * 5 + 1) % 128  # 1 full + 1 partial page
    ops = [("admit", 0, prompt)] + [("append", 0)] * 3 + \
        [("admit", 1, prompt.copy())] + [("append", 1), ("append", 0)] * 6
    tm_ = _lockstep(0, ops)
    assert tm_.allocator.n_shared_hits >= 2 and tm_.allocator.n_cow >= 1
    assert tm_.tables[0, 1] != tm_.tables[1, 1]
    assert tm_.tables[0, 0] == tm_.tables[1, 0]


def test_window_rollover_detaches_a_page_a_peer_still_reads():
    """``tests/test_paged_prefill.py``'s ring case at the manager: two
    prefix-sharing windowed streams decode staggered; the faster one's
    ring rolls over a slot whose page the slower peer still maps, and the
    recycle detaches (copy-on-write without a copy) instead of reusing it
    in place; a solely-owned page is recycled in place."""
    prompt = (np.arange(12) * 5 + 1) % 128
    ops = [("admit", 0, prompt)] + [("append", 0)] * 3 + \
        [("admit", 1, prompt.copy())] + [("append", 0), ("append", 1)] * 15
    tm_ = _lockstep(16, ops)
    assert tm_.ring == 3
    assert tm_.allocator.n_cow >= 2 and tm_.allocator.n_recycled >= 1


def test_manager_refuses_what_it_does_not_serve():
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="multiple"):
        tpkv.PagedCacheManager(tc, n_slots=2, max_len=30, block_size=8,
                               n_blocks=8, device="cpu")
    m = tpkv.PagedCacheManager(tc, n_slots=2, max_len=32, block_size=8,
                               n_blocks=8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        m.admit(0, np.arange(40))
    # the pools start as zeros: a masked page-0 gather can carry no NaN
    assert not m.k.any() and not m.v.any()


# ---------------------------------------------------------------------------
# the model's paged prefill and decode
# ---------------------------------------------------------------------------

NB, BS, MAXLEN = 12, 4, 32
PROMPT = (np.arange(11) * 7 + 3) % 128
FEED = [5, 9, 77, 31, 2]
STYLES = ("generic", "merged")
WINDOWS = (0, 6)


def _layout(window):
    """(block_ids of the bucket-padded prefill, decode table row): the
    prompt's first live block is marked -1 (a prefix-shared page: its
    pool content must survive the prefill) and the bucket's padding block
    too; under window 6 (R = 3 < 8 table slots) the table is a ring."""
    if window:  # ring of 3: blocks 0..2 at slots 0..2, block 3 -> slot 0
        return np.array([-1, 2, 9, -1], np.int32), [7, 2, 9]
    return np.array([-1, 2, 9, -1], np.int32), [7, 2, 9, 4, 11, -1, -1, -1]


@pytest.fixture(scope="module")
def jax_paged():
    """Per (style, window): the JAX side's logits and pools after a
    bucket-padded paged prefill and each decode step, from a shared
    random starting pool."""
    out = {}
    pool0 = np.random.default_rng(5).standard_normal(
        (2, NB, BS, 1, 16)).astype(np.float32)
    for window in WINDOWS:
        jc, _ = _cfgs(block_style="skipless", sliding_window=window)
        params = jm.init_params(jax.random.PRNGKey(3), jc)
        params["embed"]["table"] = params["embed"]["table"] * 50.0
        models = {"generic": (jc, params)}
        mp, mc = jax_merge(params, jc, "qp")
        models["merged"] = (mc, mp)
        for style, (c, p) in models.items():
            bids, row = _layout(window)
            x = jnp.asarray(np.concatenate([PROMPT, np.zeros(5, np.int32)]),
                            jnp.int32)[None]
            dest = jm.PagedPrefillDest(jnp.asarray(pool0), jnp.asarray(-pool0),
                                       jnp.asarray(bids))
            lg, (kp, vp) = jm.forward_prefill(
                p, c, x, dest, true_len=jnp.asarray([len(PROMPT)], jnp.int32))
            logits, pools = [np.asarray(lg)], [(np.asarray(kp),
                                                np.asarray(vp))]
            bt = np.full((2, len(row)), -1, np.int32)
            bt[0] = row  # row 1 is an idle slot
            cache = jm.PagedDecodeCache(
                k=kp, v=vp, block_tables=jnp.asarray(bt),
                length=jnp.asarray([len(PROMPT), 0], jnp.int32))
            for t in FEED:
                lg, cache = jm.forward_step(p, c, jnp.asarray([t, 0],
                                                              jnp.int32),
                                            cache)
                logits.append(np.asarray(lg))
                pools.append((np.asarray(cache.k), np.asarray(cache.v)))
            out[(style, window)] = (c, jax.tree.map(np.asarray, p), pool0,
                                    bt, logits, pools)
    return out


def _scaled_close(got, want, msg):
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               rtol=0, atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("window", WINDOWS)
def test_paged_prefill_and_steps_match_the_jax_model(jax_paged, style,
                                                     window):
    jc, params, pool0, bt, want_logits, want_pools = \
        jax_paged[(style, window)]
    _, tc = _cfgs(block_style=jc.block_style, sliding_window=window)
    tc = tc.with_(merged_variant=jc.merged_variant)
    p = to_torch(params, device="cpu")
    bids, _ = _layout(window)
    kp, vp = torch.from_numpy(pool0.copy()), torch.from_numpy(-pool0)
    x = torch.as_tensor(np.concatenate([PROMPT, np.zeros(5, np.int64)]))[None]
    with torch.no_grad():
        lg, (k2, v2) = tm.forward_prefill(
            p, tc, x, tm.PagedPrefillDest(kp, vp, torch.from_numpy(bids)),
            true_len=torch.tensor([len(PROMPT)]))
        assert k2 is kp and v2 is vp, "the pools are written in place"
        _scaled_close(lg.numpy(), want_logits[0], "prefill logits")
        for got, want in zip((kp, vp), want_pools[0]):
            _scaled_close(got.numpy(), want, "prefill pages")
        # untouched: the -1 blocks' pages (shared / padding) and the rest
        assert torch.equal(kp[:, 7], torch.from_numpy(pool0[:, 7]))
        cache = tm.PagedDecodeCache(
            k=kp, v=vp, block_tables=torch.from_numpy(bt.copy()),
            length=torch.tensor([len(PROMPT), 0], dtype=torch.int32))
        for i, t in enumerate(FEED):
            lg, cache = tm.forward_step(p, tc, torch.tensor([t, 0]), cache)
            _scaled_close(lg.numpy(), want_logits[i + 1], f"step {i}")
            for got, want in zip((cache.k, cache.v), want_pools[i + 1]):
                _scaled_close(got.numpy(), want, f"step {i} pages")
    assert cache.length.tolist() == [len(PROMPT) + len(FEED), len(FEED)]


def test_paged_prefill_refuses_bad_destinations():
    _, tc = _cfgs()
    p = tm.init_params(tc, 0, device="cpu")
    c = tm.init_paged_cache(tc, 8, 4, 2, 32, device="cpu")
    bids = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="one request at a time"):
        tm.forward_prefill(p, tc, torch.zeros(2, 8, dtype=torch.long),
                           tm.PagedPrefillDest(c.k, c.v, bids))
    with pytest.raises(ValueError, match="too few"):
        tm.forward_prefill(p, tc, torch.zeros(1, 9, dtype=torch.long),
                           tm.PagedPrefillDest(c.k, c.v, bids))
    ssm = tc.with_(family="ssm")
    with pytest.raises(ValueError, match="attention-only"):
        tm.forward_prefill(p, ssm, torch.zeros(1, 8, dtype=torch.long),
                           tm.PagedPrefillDest(c.k, c.v, bids))
    with pytest.raises(ValueError, match="attention-only"):
        tm.init_paged_cache(ssm, 8, 4, 2, 32, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        tpkv.PagedCacheManager(ssm, n_slots=2, max_len=32, block_size=4,
                               n_blocks=8, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        tm.forward_step(p, ssm, torch.zeros(2, dtype=torch.long), c)
    # an encoder has no decode step (the reference's engine asserts a
    # decoder)
    with pytest.raises(ValueError, match="encoder"):
        tm.forward_step(p, tc.with_(family="audio", causal=False),
                        torch.zeros(2, dtype=torch.long), c)


def test_paged_cache_spec_matches_the_jax_package():
    for window, max_len, bs in ((0, 64, 8), (16, 64, 8), (16, 32, 16),
                                (4096, 512, 16), (64, 512, 16)):
        jc, tc = _cfgs(sliding_window=window)
        js = jm.paged_cache_spec(jc, 10, bs, 3, max_len)
        ts = tm.paged_cache_spec(tc, 10, bs, 3, max_len)
        for k in ("k", "v", "block_tables", "length"):
            assert tuple(ts[k][0]) == tuple(js[k][0]), (window, k)
        assert tm.paged_table_blocks(tc, bs, max_len) == \
            jm.transformer.paged_table_blocks(jc, bs, max_len)
