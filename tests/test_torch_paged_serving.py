"""The port's ``Engine(cache="paged")`` against ``repro.serving.Engine``'s
paged engine: on the same weights (the JAX package's init and qp merge,
copied by the bridge) and prompts, the greedy streams are identical — and
equal to the port's dense engine — for MHA and GQA, with and without a
sliding window (a ring table), merged and source, through a pool small
enough to defer and preempt (with the same deferral and preemption counts
as the JAX engine, both with prefix retention off), and through the
staggered prefix-sharing and window-rollover scenarios of
``tests/test_paged_prefill.py``; and each adapter's ``cache_bytes``
against the JAX adapter's for the same config."""
import jax
import numpy as np
import pytest

from repro import configs as jcfg
from repro.core import merge_skipless as jax_merge
from repro.models import init_params as jax_init_params
from repro.serving import DenseCacheAdapter as JaxDenseAdapter
from repro.serving import Engine as JaxEngine
from repro.serving import PagedCacheAdapter as JaxPagedAdapter
from repro.serving import PagedQ8CacheAdapter as JaxQ8Adapter
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import configs as tcfg
from repro_torch.convert import to_torch
from repro_torch.serving import (Engine, PagedCacheAdapter, Request,
                                 ServeConfig, make_adapter)

STYLES = ("generic", "qp")


def _mixed_prompts(n=5):
    rng = np.random.RandomState(3)
    return [rng.randint(0, 128, size=(int(s),)).astype(np.int32)
            for s in rng.randint(3, 20, size=n)]


GRIDS = {
    # name: (cfg overrides, prompts, max_new, n_slots, n_blocks); bs 8,
    # max_len 64.  "gqa" keeps the reduced Mistral's window of 16 (a ring
    # of 3 table slots); "small-pool" defers and preempts
    "mha": (dict(n_kv_heads=4, sliding_window=0), _mixed_prompts(), 6, 4, 16),
    "gqa": (dict(n_kv_heads=2), _mixed_prompts(), 6, 4, 16),
    "small-pool": (dict(n_kv_heads=2),
                   [np.arange(8, dtype=np.int32) + i for i in range(3)], 20,
                   3, 7),
}


def _models(jc, seed=0):
    params = jax_init_params(jax.random.PRNGKey(seed), jc)
    params["embed"]["table"] = params["embed"]["table"] * 50.0
    mp, mc = jax_merge(params, jc, "qp")
    return {"generic": (jc, params), "qp": (mc, mp)}


def _port(c, p):
    tc = tcfg.reduce_config(tcfg.get_config("mistral-7b")).with_(
        **{f: getattr(c, f) for f in ("n_kv_heads", "sliding_window",
                                      "block_style", "merged_variant",
                                      "dtype", "param_dtype")})
    return tc, to_torch(jax.tree.map(np.asarray, p), device="cpu")


@pytest.fixture(scope="module")
def jax_streams():
    """Per (grid, style): the port's config and weights, and the JAX paged
    engine's streams and scheduler counters (prefix retention off)."""
    out = {}
    for name, (kw, prompts, max_new, n_slots, n_blocks) in GRIDS.items():
        jc = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(
            block_style="skipless", dtype="float32", param_dtype="float32",
            **kw)
        for style, (c, p) in _models(jc).items():
            eng = JaxEngine(c, p, JaxServeConfig(n_slots=n_slots, max_len=64),
                            cache=JaxPagedAdapter(block_size=8,
                                                  n_blocks=n_blocks,
                                                  prefix_retention=False))
            want = [list(o) for o in eng.generate(prompts,
                                                  max_new_tokens=max_new)]
            out[(name, style)] = (*_port(c, p), want, eng.stats)
    return out


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_paged_streams_match_the_jax_paged_engine(jax_streams, grid, style):
    cfg, params, want, jstats = jax_streams[(grid, style)]
    _, prompts, max_new, n_slots, n_blocks = GRIDS[grid]
    eng = Engine(cfg, params, ServeConfig(n_slots=n_slots, max_len=64),
                 impl="torch", device="cpu",
                 cache=PagedCacheAdapter(block_size=8, n_blocks=n_blocks,
                                         prefix_retention=False))
    merged = style == "qp"
    assert eng.backend.key == ("paged", "merged" if merged else "generic",
                               "torch")
    assert eng.merged_fast_path == eng.merged_prefill_fast_path == merged
    assert eng.pm.ring == (3 if cfg.sliding_window else 0)
    # the pool stores absolute positions, so windowed prompts bucket too
    assert len(eng._bucket_pad(np.arange(5, dtype=np.int32))[0]) == 8
    outs = eng.generate(prompts, max_new_tokens=max_new)
    assert [list(o) for o in outs] == want
    assert (eng.stats["n_preempted"], eng.stats["n_deferred"]) == \
        (jstats["n_preempted"], jstats["n_deferred"])
    if grid == "small-pool":
        assert eng.stats["n_preempted"] and eng.stats["n_deferred"]
    # a drained engine holds no page (no retention)
    assert eng.pm.allocator.n_used == 0
    # the port's dense engine gives the same streams
    dense = Engine(cfg, params, ServeConfig(n_slots=n_slots, max_len=64),
                   impl="torch", device="cpu")
    assert [list(o) for o in dense.generate(
        prompts, max_new_tokens=max_new)] == want


def _staggered(make_engine, make_request, prompt, lead, new_a, new_b):
    """Submit A, decode ``lead`` steps, submit B with A's prompt, drain."""
    eng = make_engine()
    ra = make_request(prompt=prompt, max_new_tokens=new_a)
    assert eng.submit(ra)
    for _ in range(lead):
        eng.step()
    rb = make_request(prompt=prompt.copy(), max_new_tokens=new_b)
    assert eng.submit(rb)
    while eng.active:
        eng.step()
    return eng, ra.out_tokens, rb.out_tokens


@pytest.mark.parametrize("window,new_a,new_b", [(0, 6, 6), (16, 24, 16)])
def test_staggered_sharing_matches_the_jax_engine(window, new_a, new_b):
    """``tests/test_paged_prefill.py``'s staggered cases: B shares A's
    prompt pages while A decodes into the shared tail (B's prefill must
    not rewrite them, its first append copies the tail); with a window of
    16 A's ring also rolls over a page B still reads (detached, not
    reused).  Both streams equal the JAX engine's."""
    jc = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(
        block_style="skipless", sliding_window=window)
    c, p = _models(jc, seed=1)["qp"]
    prompt = (np.arange(12) * 5 + 1) % 128  # 1 full + partial page
    _, want_a, want_b = _staggered(
        lambda: JaxEngine(c, p, JaxServeConfig(n_slots=2, max_len=64),
                          cache=JaxPagedAdapter(block_size=8, n_blocks=32,
                                                prefix_retention=False)),
        JaxRequest, prompt, 3, new_a, new_b)
    tc, tp = _port(c, p)
    eng, got_a, got_b = _staggered(
        lambda: Engine(tc, tp, ServeConfig(n_slots=2, max_len=64),
                       impl="torch", device="cpu",
                       cache=PagedCacheAdapter(block_size=8, n_blocks=32,
                                               prefix_retention=False)),
        Request, prompt, 3, new_a, new_b)
    assert (got_a, got_b) == (want_a, want_b)
    alloc = eng.pm.allocator
    assert alloc.n_shared_hits >= 2 and alloc.n_cow >= (2 if window else 1)
    if window:
        assert eng.pm.ring == 3 and alloc.n_recycled >= 1


def test_paged_engine_refusals(jax_streams):
    cfg, params, _, _ = jax_streams[("mha", "generic")]
    eng = Engine(cfg, params, ServeConfig(n_slots=2, max_len=32,
                                          block_size=8),
                 impl="torch", cache="paged", device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.generate([np.arange(30) % 128], max_new_tokens=8)
    with pytest.raises(ValueError, match="impl='cuda'"):
        Engine(cfg, params, ServeConfig(), impl="cuda", cache="paged",
               device="cpu")
    with pytest.raises(RuntimeError, match="n_blocks"):
        # one request that outgrows the whole pool cannot be preempted
        Engine(cfg, params, ServeConfig(n_slots=2, max_len=32, block_size=8,
                                        n_blocks=1),
               impl="torch", cache="paged", device="cpu").generate(
            [np.arange(6)], max_new_tokens=6)


def test_launcher_serves_paged_like_dense(capsys):
    """``python -m repro_torch.launch.serve --cache paged`` prints the
    dense cache's tokens, through a pool small enough to preempt."""
    from repro_torch.launch.serve import main

    args = ["--arch", "mistral-7b", "--smoke", "--merged-from-skipless",
            "--requests", "4", "--max-new", "6", "--max-len", "64",
            "--prompt-len", "14", "--device", "cpu"]
    dense = [list(o) for o in main(args)]
    paged = [list(o) for o in main(args + ["--cache", "paged",
                                           "--block-size", "8",
                                           "--n-blocks", "5"])]
    assert paged == dense
    assert "'n_preempted': " in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dense", "paged", "paged_q8"])
def test_cache_bytes_equal_the_jax_adapters(kind, dtype):
    """Dense: the bytes of k and v; the pools: ``pm.pool_bytes`` (int8
    pages and their float32 scales), as the JAX adapters count them."""
    jc = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(
        dtype=dtype, param_dtype=dtype)
    tc = tcfg.reduce_config(tcfg.get_config("mistral-7b")).with_(
        dtype=dtype, param_dtype=dtype)
    kw = dict(n_slots=4, max_len=64, block_size=8, n_blocks=12)
    jax_adapter = {"dense": JaxDenseAdapter, "paged": JaxPagedAdapter,
                   "paged_q8": JaxQ8Adapter}[kind]()
    jax_adapter.init(jc, JaxServeConfig(**kw))
    port = make_adapter(kind)
    port.init(tc, ServeConfig(**kw), "cpu")
    assert port.cache_bytes == jax_adapter.cache_bytes > 0
