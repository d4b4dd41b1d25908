"""The port's int8 paged pool (``paged_q8``) against the JAX package's:

* the host manager (``serving.paged_kv_cache.PagedQ8CacheManager``)
  replays seeded traces side by side with
  ``repro.serving.paged_kv_cache.PagedQ8CacheManager``, both with prefix
  retention off: equal tables, lengths and refcounts after every operation, and
  scale rows that travel with their page (both managers stamp the same
  marker into each newly mapped page's scale rows; after every operation
  the scale arrays are equal, and every live page still carries its own
  marker, or its copy-on-write source's);
* the model's int8 prefill and decode (``forward_prefill`` with a
  ``PagedQ8PrefillDest``, ``forward_step`` on a ``PagedQ8DecodeCache``)
  give the JAX logits, generic and merged, with and without a window;
* ``Engine(cache="paged_q8", impl="torch", device="cpu")`` emits the JAX
  q8 engine's greedy streams token for token on the reference's q8 grids
  (``tests/test_backend_registry.py``: the x50 grid in all four weight
  styles, the windowed ring row, q8 vs fp on the unscaled model) and
  through a pool small enough to defer and preempt (a resumed request
  re-prefills whole pages, so its stream is the JAX engine's resumed one).

Tolerances: logits atol 1e-4 after dividing both sides by the larger of 1
and the reference's largest |logit| (as in ``test_torch_paged_cache.py``).
Pools written from K/V that the two frameworks compute with different
matmuls may round to neighbouring ints, so written ints may differ by one
(and scales by float32 rounding, rtol 1e-5); untouched pages are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.core import merge_skipless as jax_merge
from repro.models import init_params as jax_init_params
from repro.serving import Engine as JaxEngine
from repro.serving import PagedQ8CacheAdapter as JaxQ8Adapter
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import paged_kv_cache as jpkv
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.convert import to_torch
from repro_torch.serving import (Engine, PagedCacheAdapter,
                                 PagedQ8CacheAdapter, ServeConfig)
from repro_torch.serving import paged_kv_cache as tpkv

ATOL = 1e-4


def _cfgs(**kw):
    return (jcfg.reduce_config(jcfg.get_config("mistral-7b"), **kw),
            tcfg.reduce_config(tcfg.get_config("mistral-7b"), **kw))


# ---------------------------------------------------------------------------
# manager traces: tables, refcounts and scale rows
# ---------------------------------------------------------------------------

class _Lockstep:
    """Both q8 managers, driven op by op; each newly mapped page gets a
    fresh marker in its scale rows on both sides, a copying copy-on-write
    moves its source's marker."""

    def __init__(self, window, n_blocks, n_slots=4, max_len=64, bs=8):
        jc, tc = _cfgs(sliding_window=window)
        kw = dict(n_slots=n_slots, max_len=max_len, block_size=bs,
                  n_blocks=n_blocks)
        self.j = jpkv.PagedQ8CacheManager(jc, prefix_retention=False, **kw)
        self.t = tpkv.PagedQ8CacheManager(tc, device="cpu",
                                          prefix_retention=False, **kw)
        self.expected = {}
        self.marker = 1.0

    def _live(self):
        return {p for s, info in self.t._slots.items() for p in info.blocks
                if p >= 0}

    def do(self, fn, where):
        before = self._live()
        cow0, rec0 = self.t.allocator.n_cow, self.t.allocator.n_recycled
        a, b = fn(self.j), fn(self.t)
        assert a == b, where
        after = self._live()
        new, gone = after - before, before - after
        d_cow = self.t.allocator.n_cow - cow0
        d_rec = self.t.allocator.n_recycled - rec0
        if d_cow and not d_rec and len(new) == 1 and len(gone) == 1:
            # a copying copy-on-write: the copy carried the source's rows
            self.expected[new.pop()] = self.expected[gone.pop()]
        for p in sorted(new):
            self._stamp(p)
        self.check(where)
        return b

    def _stamp(self, p):
        m = self.marker
        self.marker += 1.0
        self.expected[p] = m
        self.j.k_scale = self.j.k_scale.at[:, p].set(m)
        self.j.v_scale = self.j.v_scale.at[:, p].set(-m)
        self.t.k_scale[:, p] = m
        self.t.v_scale[:, p] = -m

    def check(self, where):
        j, t = self.j, self.t
        np.testing.assert_array_equal(t.tables, np.asarray(j.tables), where)
        np.testing.assert_array_equal(t.lengths, np.asarray(j.lengths), where)
        np.testing.assert_array_equal(t.allocator.ref,
                                      np.asarray(j.allocator.ref), where)
        assert t.allocator._free == j.allocator._free, where
        for k in ("n_cow", "n_shared_hits", "n_recycled", "peak_used"):
            assert getattr(t.allocator, k) == getattr(j.allocator, k), \
                (where, k)
        np.testing.assert_array_equal(t.k_scale.numpy(),
                                      np.asarray(j.k_scale), where)
        np.testing.assert_array_equal(t.v_scale.numpy(),
                                      np.asarray(j.v_scale), where)
        for p in self._live():
            assert float(t.k_scale[0, p, 0]) == self.expected[p], (where, p)
            assert float(t.v_scale[-1, p, -1]) == -self.expected[p], \
                (where, p)


def test_q8_scales_survive_cow_and_recycle_like_the_jax_manager():
    """The case of ``test_q8_scales_survive_cow_and_recycle_without_
    hypothesis`` (``tests/test_paged_properties.py``): two identical
    windowed prompts share pages, decode forks them (copy-on-write carries
    the scale rows) and rolls the ring over recycled pages."""
    ls = _Lockstep(16, n_blocks=10, n_slots=2)
    prompt = np.arange(20, dtype=np.int32)
    for slot in (0, 1):
        assert ls.do(lambda m: m.admit(slot, prompt.copy()),
                     f"admit {slot}") is not None
    assert ls.t.allocator.n_shared_hits > 0
    for i in range(24):
        for slot in (0, 1):
            def app(m):
                ok = m.ensure_appendable(slot)
                if ok:
                    m.advance(slot)
                return ok
            ls.do(app, f"step {i} slot {slot}")
    assert ls.t.allocator.n_cow > 0 and ls.t.allocator.n_recycled > 0
    for slot in (0, 1):
        ls.do(lambda m: m.release(slot), f"release {slot}")
    assert ls.t.allocator.n_used == 0


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("window,n_blocks", [(0, 12), (16, 9), (5, 14)])
def test_q8_manager_replays_the_jax_managers_trace(seed, window, n_blocks):
    """Random admit / append / release traces over shared and unrelated
    prompts on a small pool (deferral and exhaustion)."""
    rng = np.random.default_rng(seed)
    ls = _Lockstep(window, n_blocks)
    base = rng.integers(0, 128, 40)
    prompts = [base[:int(n)].copy() for n in rng.choice([9, 12, 16, 21], 4)]
    prompts += [rng.integers(0, 128, rng.integers(3, 30)) for _ in range(4)]
    live = {}
    for step in range(120):
        free = [s for s in range(4) if s not in live]
        op = rng.choice(3, p=[0.3, 0.55, 0.15])
        where = f"seed {seed} op {step}"
        if op == 0 and free:
            slot, toks = free[0], prompts[rng.integers(0, len(prompts))]
            if ls.do(lambda m: m.admit(slot, toks), where) is not None:
                live[slot] = len(toks)
        elif op in (1, 2) and live:
            slot = list(live)[rng.integers(0, len(live))]
            if op == 1 and live[slot] + 1 < 64:
                def app(m):
                    ok = m.ensure_appendable(slot)
                    if ok:
                        m.advance(slot)
                    return ok
                if ls.do(app, where):
                    live[slot] += 1
                    continue
            ls.do(lambda m: m.release(slot), where)
            del live[slot]
    assert ls.marker > 5


def test_q8_manager_pool_hooks_and_bytes():
    """The q8 manager overrides only the pool hooks: int8 pools, float32
    scales, zero-filled; ``pool_bytes`` counts both; copy-on-write moves
    a page's ints and scale rows together."""
    _, tc = _cfgs()
    m = tpkv.PagedQ8CacheManager(tc, n_slots=2, max_len=32, block_size=8,
                                 n_blocks=6, device="cpu")
    assert m.k.dtype == torch.int8 and m.k_scale.dtype == torch.float32
    assert not m.k.any() and not m.k_scale.any()
    L, NB, bs, Hkv, Dh = m.k.shape
    assert m.k_scale.shape == (L, NB, Hkv)
    assert m.pool_bytes == 2 * L * NB * bs * Hkv * Dh + 2 * 4 * L * NB * Hkv
    fp = tpkv.PagedCacheManager(tc, n_slots=2, max_len=32, block_size=8,
                                n_blocks=6, device="cpu")
    assert fp.pool_bytes == 2 * 4 * L * NB * bs * Hkv * Dh
    assert type(m).__dict__.keys() & {"admit", "_cow", "device_cache",
                                      "ensure_appendable"} == set()
    m.k[:, 2] = 7
    m.k_scale[:, 2] = 0.5
    m._copy_block_device(2, 4)
    assert torch.equal(m.k[:, 4], m.k[:, 2])
    assert torch.equal(m.k_scale[:, 4], m.k_scale[:, 2])
    dc = m.device_cache()
    assert isinstance(dc, tm.PagedQ8DecodeCache) and dc.k is m.k


# ---------------------------------------------------------------------------
# the model's int8 prefill and decode
# ---------------------------------------------------------------------------

NB, BS = 12, 4
PROMPT = (np.arange(11) * 7 + 3) % 128
FEED = [5, 9, 77, 31, 2]
STYLES = ("generic", "merged")
WINDOWS = (0, 6)


def _layout(window):
    """(block_ids of the 16-token padded prefill, decode table row): the
    prompt's first block is -1 (a prefix-shared page whose pool content
    must survive) and the padding block too."""
    if window:  # ring of 3: blocks 0..2 at slots 0..2, block 3 -> slot 0
        return np.array([-1, 2, 9, -1], np.int32), [7, 2, 9]
    return np.array([-1, 2, 9, -1], np.int32), [7, 2, 9, 4, 11, -1, -1, -1]


@pytest.fixture(scope="module")
def jax_q8():
    """Per (style, window): the JAX side's logits, pools and scales after
    a padded q8 prefill and each decode step, from a shared random
    starting pool."""
    out = {}
    rng = np.random.default_rng(5)
    pool0 = rng.integers(-127, 128, (2, 2, NB, BS, 1, 16)).astype(np.int8)
    sc0 = rng.uniform(0.01, 0.1, (2, 2, NB, 1)).astype(np.float32)
    for window in WINDOWS:
        jc, _ = _cfgs(block_style="skipless", sliding_window=window)
        params = jm.init_params(jax.random.PRNGKey(3), jc)
        params["embed"]["table"] = params["embed"]["table"] * 50.0
        mp, mc = jax_merge(params, jc, "qp")
        for style, (c, p) in {"generic": (jc, params),
                              "merged": (mc, mp)}.items():
            bids, row = _layout(window)
            x = jnp.asarray(np.concatenate([PROMPT, np.zeros(5, np.int32)]),
                            jnp.int32)[None]
            dest = jm.PagedQ8PrefillDest(
                *(jnp.asarray(a) for a in (pool0[0], pool0[1], sc0[0],
                                           sc0[1])), jnp.asarray(bids))
            lg, (kp, vp, ks, vs) = jm.forward_prefill(
                p, c, x, dest, true_len=jnp.asarray([len(PROMPT)], jnp.int32))
            logits = [np.asarray(lg)]
            pools = [tuple(np.asarray(a) for a in (kp, vp, ks, vs))]
            bt = np.full((2, len(row)), -1, np.int32)
            bt[0] = row  # row 1 is an idle slot
            cache = jm.PagedQ8DecodeCache(
                k=kp, v=vp, k_scale=ks, v_scale=vs,
                block_tables=jnp.asarray(bt),
                length=jnp.asarray([len(PROMPT), 0], jnp.int32))
            for t in FEED:
                lg, cache = jm.forward_step(
                    p, c, jnp.asarray([t, 0], jnp.int32), cache)
                logits.append(np.asarray(lg))
                pools.append(tuple(np.asarray(a) for a in (
                    cache.k, cache.v, cache.k_scale, cache.v_scale)))
            out[(style, window)] = (c, jax.tree.map(np.asarray, p), pool0,
                                    sc0, bt, logits, pools)
    return out


def _scaled_close(got, want, msg):
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               rtol=0, atol=ATOL, err_msg=msg)


def _pools_close(got, want, msg):
    for g, w in zip(got[:2], want[:2]):
        d = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
        assert d.max() <= 1, msg
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=0,
                                   err_msg=msg)


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("window", WINDOWS)
def test_q8_prefill_and_steps_match_the_jax_model(jax_q8, style, window):
    jc, params, pool0, sc0, bt, want_logits, want_pools = \
        jax_q8[(style, window)]
    _, tc = _cfgs(block_style=jc.block_style, sliding_window=window)
    tc = tc.with_(merged_variant=jc.merged_variant)
    p = to_torch(params, device="cpu")
    bids, _ = _layout(window)
    kp, vp = (torch.from_numpy(a.copy()) for a in pool0)
    ks, vs = (torch.from_numpy(a.copy()) for a in sc0)
    x = torch.as_tensor(np.concatenate([PROMPT, np.zeros(5, np.int64)]))[None]
    with torch.no_grad():
        lg, out = tm.forward_prefill(
            p, tc, x, tm.PagedQ8PrefillDest(kp, vp, ks, vs,
                                            torch.from_numpy(bids)),
            true_len=torch.tensor([len(PROMPT)]))
        assert all(a is b for a, b in zip(out, (kp, vp, ks, vs))), \
            "the pools and scales are written in place"
        _scaled_close(lg.numpy(), want_logits[0], "prefill logits")
        _pools_close((kp, vp, ks, vs), want_pools[0], "prefill pages")
        # untouched: the -1 blocks' pages (shared / padding) and scales
        assert torch.equal(kp[:, 7], torch.from_numpy(pool0[0][:, 7]))
        assert torch.equal(ks[:, 7], torch.from_numpy(sc0[0][:, 7]))
        cache = tm.PagedQ8DecodeCache(
            k=kp, v=vp, k_scale=ks, v_scale=vs,
            block_tables=torch.from_numpy(bt.copy()),
            length=torch.tensor([len(PROMPT), 0], dtype=torch.int32))
        for i, t in enumerate(FEED):
            lg, cache = tm.forward_step(p, tc, torch.tensor([t, 0]), cache)
            _scaled_close(lg.numpy(), want_logits[i + 1], f"step {i}")
            _pools_close((cache.k, cache.v, cache.k_scale, cache.v_scale),
                         want_pools[i + 1], f"step {i} pages")
    assert cache.length.tolist() == [len(PROMPT) + len(FEED), len(FEED)]


def test_q8_prefill_refuses_a_partial_page_and_the_engine_aligns():
    _, tc = _cfgs()
    p = tm.init_params(tc, 0, device="cpu")
    c = tm.init_paged_q8_cache(tc, 8, 8, 2, 32, device="cpu")
    dest = tm.PagedQ8PrefillDest(c.k, c.v, c.k_scale, c.v_scale,
                                 torch.tensor([0, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of the page size"):
        tm.forward_prefill(p, tc, torch.zeros(1, 12, dtype=torch.long), dest)
    spec = tm.paged_q8_cache_spec(tc, 8, 8, 2, 32)
    assert spec["k"][1] == torch.int8 and \
        spec["k_scale"][0] == (tc.n_layers, 8, tc.n_kv_heads)
    # the engine pads every prompt to whole pages, bucketed or not
    sc = ServeConfig(n_slots=2, max_len=64, block_size=16)
    eng = Engine(tc, p, sc, impl="torch", cache="paged_q8", device="cpu")
    assert eng.kv.bucket_align == 16
    assert [len(eng._bucket_pad(np.arange(n))[0]) for n in (5, 9, 17, 64)] \
        == [16, 16, 32, 64]
    eng._bucketing = False
    assert [len(eng._bucket_pad(np.arange(n))[0]) for n in (5, 16, 17)] == \
        [16, 16, 32]
    fp = Engine(tc, p, sc, impl="torch", cache="paged", device="cpu")
    assert fp.kv.bucket_align == 1 and len(fp._bucket_pad(np.arange(5))[0]) \
        == 8
    with pytest.raises(ValueError, match="impl='cuda'"):
        Engine(tc, p, sc, impl="cuda", cache="paged_q8", device="cpu")
    with pytest.raises(ValueError, match="paged_q8"):
        Engine(tc, p, sc, impl="torch", cache="int4", device="cpu")


# ---------------------------------------------------------------------------
# engines: the reference's q8 grids
# ---------------------------------------------------------------------------

def _ref_models(key, mult, **kw):
    """The reference grids' base model (MHA, float32, reduced Mistral) and
    its three merged rewrites; ``mult`` scales the embedding table."""
    jc = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(
        block_style="skipless", dtype="float32", param_dtype="float32",
        n_kv_heads=4, **kw)
    params = jax_init_params(jax.random.PRNGKey(key), jc)
    params["embed"]["table"] = params["embed"]["table"] * mult
    models = {"generic": (jc, params)}
    for variant in ("qp", "kp", "vp"):
        mp, mc = jax_merge(params, jc, variant)
        models[variant] = (mc, mp)
    return models


def _port(c, p):
    tc = tcfg.reduce_config(tcfg.get_config("mistral-7b")).with_(
        **{f: getattr(c, f) for f in ("n_kv_heads", "sliding_window",
                                      "block_style", "merged_variant",
                                      "dtype", "param_dtype")})
    return tc, to_torch(jax.tree.map(np.asarray, p), device="cpu")


def _jax_streams(c, p, adapter, prompts, n, n_slots=2, max_len=48):
    eng = JaxEngine(c, p, JaxServeConfig(n_slots=n_slots, max_len=max_len),
                    impl="xla", cache=adapter)
    return [list(map(int, o)) for o in eng.generate(prompts,
                                                    max_new_tokens=n)], eng


def _port_streams(c, p, adapter, prompts, n, n_slots=2, max_len=48):
    eng = Engine(c, p, ServeConfig(n_slots=n_slots, max_len=max_len),
                 impl="torch", cache=adapter, device="cpu")
    return [list(o) for o in eng.generate(prompts, max_new_tokens=n)], eng


# the reference grids (tests/test_backend_registry.py): MAX_NEW, WIN,
# WIN_BLOCK, WIN_MAX_NEW and their prompts
PROMPTS = [np.arange(5) % 128 + 3 * i for i in range(2)]
WIN_PROMPTS = [np.arange(7) % 128, (np.arange(2) * 7 + 2) % 128]
SMALL_PROMPTS = [np.arange(8, dtype=np.int32) + i for i in range(3)]


@pytest.fixture(scope="module")
def jax_grids():
    """The JAX q8 engine's streams on each grid (prefix retention off, on
    the port's side too)."""
    out = {}
    x50 = _ref_models(0, 50.0)
    out["x50"] = (x50, _jax_streams(*x50["generic"], JaxQ8Adapter(
        block_size=8, prefix_retention=False), PROMPTS, 4)[0])
    win = _ref_models(1, 50.0, sliding_window=3)
    out["window"] = (win, _jax_streams(*win["generic"], JaxQ8Adapter(
        block_size=2, prefix_retention=False), WIN_PROMPTS, 5,
        max_len=32)[0])
    plain = _ref_models(0, 1.0)
    out["unscaled"] = (plain, {s: _jax_streams(*plain[s], JaxQ8Adapter(
        block_size=8, prefix_retention=False), PROMPTS, 4)[0]
        for s in ("generic", "qp")})
    small = {}
    for s in ("generic", "qp"):
        streams, eng = _jax_streams(*x50[s], JaxQ8Adapter(
            block_size=8, n_blocks=7, prefix_retention=False),
            SMALL_PROMPTS, 20, n_slots=3, max_len=64)
        small[s] = (streams, eng.stats["n_preempted"],
                    eng.stats["n_deferred"])
    out["small"] = (x50, small)
    return out


@pytest.mark.parametrize("style", ["generic", "qp", "kp", "vp"])
def test_q8_grid_streams_match_the_jax_q8_engine(jax_grids, style):
    """The x50 q8 grid: every weight style serves through the paged_q8 row
    (the merged fast path for qp) and emits the JAX (generic, xla) q8
    cell's streams, which every JAX cell equals."""
    models, want = jax_grids["x50"]
    c, p = _port(*models[style])
    got, eng = _port_streams(c, p, PagedQ8CacheAdapter(
        block_size=8, prefix_retention=False), PROMPTS, 4)
    assert eng.backend.key == ("paged_q8", tm.serving_style_key(c), "torch")
    assert eng.prefill_backend.key == ("paged_q8", tm.prefill_style_key(c),
                                       "torch")
    assert eng.merged_fast_path == eng.merged_prefill_fast_path == \
        (style == "qp")
    assert got == want, (style, got, want)


@pytest.mark.parametrize("style", ["generic", "qp", "kp", "vp"])
def test_q8_windowed_grid_rings_like_the_jax_engine(jax_grids, style):
    """The windowed row: a window of 3 over pages of 2 rings the table (3
    slots) and recycles pages with their scale rows; the streams equal the
    JAX windowed q8 cell's."""
    models, want = jax_grids["window"]
    c, p = _port(*models[style])
    got, eng = _port_streams(c, p, PagedQ8CacheAdapter(
        block_size=2, prefix_retention=False), WIN_PROMPTS, 5, max_len=32)
    assert got == want, (style, got, want)
    assert eng.pm.ring == 3 and eng.pm.allocator.n_recycled > 0
    assert eng.pm.request_page_hwm.max <= eng.pm.ring_bound


@pytest.mark.parametrize("style", ["generic", "qp"])
def test_q8_matches_fp_paged_on_the_unscaled_model(jax_grids, style):
    """On the unscaled model the int8 pool's streams equal the JAX q8
    engine's and the port's own fp pool's (quantization noise stays under
    the argmax margins, as the reference's gate asserts)."""
    models, want = jax_grids["unscaled"]
    c, p = _port(*models[style])
    q8, _ = _port_streams(c, p, PagedQ8CacheAdapter(
        block_size=8, prefix_retention=False), PROMPTS, 4)
    fp, _ = _port_streams(c, p, PagedCacheAdapter(
        block_size=8, prefix_retention=False), PROMPTS, 4)
    assert q8 == want[style] == fp, (style, q8, want[style], fp)


@pytest.mark.parametrize("style", ["generic", "qp"])
def test_q8_small_pool_defers_and_preempts_like_the_jax_engine(jax_grids,
                                                               style):
    models, small = jax_grids["small"]
    want, n_pre, n_def = small[style]
    c, p = _port(*models[style])
    got, eng = _port_streams(c, p, PagedQ8CacheAdapter(
        block_size=8, n_blocks=7, prefix_retention=False), SMALL_PROMPTS,
        20, n_slots=3, max_len=64)
    assert got == want
    assert (eng.stats["n_preempted"], eng.stats["n_deferred"]) == \
        (n_pre, n_def)
    assert n_pre and n_def
    assert eng.pm.allocator.n_used == 0


def test_launcher_serves_paged_q8(capsys):
    """``python -m repro_torch.launch.serve --cache paged_q8`` serves
    through a pool small enough to preempt and prints the resident
    bytes of the int8 pages and scales."""
    from repro_torch.launch.serve import main

    args = ["--arch", "mistral-7b", "--smoke", "--merged-from-skipless",
            "--requests", "4", "--max-new", "6", "--max-len", "64",
            "--prompt-len", "14", "--device", "cpu", "--block-size", "8",
            "--n-blocks", "5"]
    outs = main(args + ["--cache", "paged_q8"])
    assert [len(o) for o in outs] == [6] * 4
    text = capsys.readouterr().out
    _, tc = _cfgs()
    L, Hkv, D = tc.n_layers, tc.n_kv_heads, tc.d_head
    want = 2 * L * 5 * 8 * Hkv * D + 2 * 4 * L * 5 * Hkv
    assert f"q8 pool: {want:,d} bytes resident" in text
    assert "'n_preempted': " in text
