"""The port's ``ScheduledEngine`` on the dense cache against
``repro.serving.ScheduledEngine``: chunked prefill must be scheduling,
never math.  On the reduced, windowless, float32 Mistral with scaled
embeddings of ``tests/test_sched.py`` (weights from the JAX package's
init and merges, copied by the bridge), the port's greedy streams equal
the JAX ``ScheduledEngine``'s and the JAX whole-prompt oracle's for the
source and its qp / kp / vp merges; with a BINDING sliding window the
dense cache falls back to monolithic jobs and still matches the oracle.
Around the grid: the engine's build-time and submit-time refusals.

The paged rows of the grid are in ``tests/test_torch_sched_paged.py``,
which imports this file's setup helpers.  Tolerance: identity of token
lists."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jcfg
from repro.core import merge_skipless as jax_merge
from repro.models import forward_seq as jax_forward_seq
from repro.models import init_params as jax_init_params
from repro.serving import SchedConfig as JaxSchedConfig
from repro.serving import ScheduledEngine as JaxScheduledEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import configs as tcfg
from repro_torch.convert import to_torch
from repro_torch.serving import (Engine, PagedCacheAdapter, Request,
                                 SchedConfig, ScheduledEngine, ServeConfig)

MAX_NEW = 4
CHUNK = 8
WIN = 3  # sliding-window row: window smaller than prompt 0
WIN_MAX_NEW = 5
STYLES = ("generic", "qp", "kp", "vp")


def greedy_oracle(params, cfg, prompt, n):
    """The JAX package's full-sequence greedy continuation."""
    toks = list(prompt)
    out = []
    for _ in range(n):
        lg, _, _ = jax_forward_seq(params, cfg,
                                   jnp.asarray(toks, jnp.int32)[None])
        t = int(jnp.argmax(lg[0, -1, :cfg.vocab_size]))
        out.append(t)
        toks.append(t)
    return out


def port_model(c, p):
    """The port's config and weights for a JAX (config, params)."""
    tc = tcfg.reduce_config(tcfg.get_config("mistral-7b")).with_(
        **{f: getattr(c, f) for f in ("n_kv_heads", "sliding_window",
                                      "block_style", "merged_variant",
                                      "dtype", "param_dtype")})
    return tc, to_torch(jax.tree.map(np.asarray, p), device="cpu")


def base_models(window=0, seed=0):
    """{style: (JAX config, JAX params)}: ``tests/test_sched.py``'s setup
    (MHA, so kp/vp apply); merges only without a window."""
    cfg = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(
        block_style="skipless", dtype="float32", param_dtype="float32",
        n_kv_heads=4, sliding_window=window)
    params = jax_init_params(jax.random.PRNGKey(seed), cfg)
    params["embed"]["table"] = params["embed"]["table"] * 50.0
    models = {"generic": (cfg, params)}
    if not window:
        for variant in ("qp", "kp", "vp"):
            mp, mc = jax_merge(params, cfg, variant)
            models[variant] = (mc, mp)
    return models


def grid_prompts(vocab):
    """Prompt 1 longer than one chunk, prompt 0 shorter."""
    return [np.arange(5) % vocab, (np.arange(11) * 3 + 2) % vocab]


def window_prompts(vocab):
    return [np.arange(7) % vocab, (np.arange(2) * 7 + 2) % vocab]


def jax_sched_streams(c, p, prompts, max_new, cache="dense", chunk=CHUNK,
                      budget=None, n_slots=2, max_len=48):
    eng = JaxScheduledEngine(
        c, p, JaxServeConfig(n_slots=n_slots, max_len=max_len),
        scfg=JaxSchedConfig(token_budget=budget or 4 * chunk,
                            chunk_tokens=chunk), impl="xla", cache=cache)
    return [list(o) for o in eng.generate(prompts, max_new_tokens=max_new)]


def port_sched(tc, tp, cache="dense", chunk=CHUNK, budget=None, n_slots=2,
               max_len=48, **sc):
    return ScheduledEngine(
        tc, tp, ServeConfig(n_slots=n_slots, max_len=max_len, **sc),
        SchedConfig(token_budget=budget or 4 * chunk, chunk_tokens=chunk),
        impl="torch", cache=cache, device="cpu")


@pytest.fixture(scope="module")
def grid():
    """Per style: the port's model, the JAX scheduled engine's dense
    streams; and the oracle (all styles are one model)."""
    models = base_models()
    cfg, params = models["generic"]
    prompts = grid_prompts(cfg.vocab_size)
    oracle = [greedy_oracle(params, cfg, p, MAX_NEW) for p in prompts]
    out = {}
    for style, (c, p) in models.items():
        out[style] = (*port_model(c, p),
                      jax_sched_streams(c, p, prompts, MAX_NEW))
    return out, prompts, oracle


@pytest.mark.parametrize("style", STYLES)
def test_chunked_dense_matches_the_jax_scheduler_and_oracle(grid, style):
    models, prompts, oracle = grid
    tc, tp, want = models[style]
    eng = port_sched(tc, tp)
    assert eng._chunked, "windowless attention stacks must chunk"
    outs = eng.generate(prompts, max_new_tokens=MAX_NEW)
    assert [list(o) for o in outs] == want == oracle
    assert eng.n_iterations > 0 and eng.n_chunks_run >= len(prompts)
    assert eng.stats["sched_chunks"] == eng.n_chunks_run
    assert all(o.new_tokens == MAX_NEW for o in outs)
    # drained: every slot free, host lengths back to 0
    assert sorted(eng.free_slots) == [0, 1] and not eng.kv._lengths.any()


def test_binding_window_dense_takes_monolithic_jobs():
    """The window row, dense: a window below max_len makes the cache a
    window-sized ring, so jobs are monolithic (still queued, still
    budget-charged) and the streams equal the JAX scheduler's and the
    oracle's."""
    models = base_models(window=WIN, seed=1)
    cfg, params = models["generic"]
    prompts = window_prompts(cfg.vocab_size)
    oracle = [greedy_oracle(params, cfg, p, WIN_MAX_NEW) for p in prompts]
    want = jax_sched_streams(cfg, params, prompts, WIN_MAX_NEW)
    tc, tp = port_model(cfg, params)
    eng = port_sched(tc, tp)
    assert not eng._chunked, "binding-window dense must not chunk"
    outs = eng.generate(prompts, max_new_tokens=WIN_MAX_NEW)
    assert [list(o) for o in outs] == want == oracle
    assert eng.n_chunks_run == len(prompts)  # one monolithic job each


def test_scheduled_engine_refusals(grid):
    models, _, _ = grid
    tc, tp, _ = models["generic"]
    with pytest.raises(ValueError):
        SchedConfig(token_budget=4, chunk_tokens=8)  # budget < chunk
    with pytest.raises(ValueError):
        SchedConfig(token_budget=8, chunk_tokens=0)
    with pytest.raises(ValueError, match="multiple of"):
        port_sched(tc, tp, max_len=44)  # 44 % 8 != 0
    with pytest.raises(ValueError, match="block size"):
        # a paged chunk must be block-aligned (chunk 4, block 8)
        port_sched(tc, tp, chunk=4, budget=16,
                   cache=PagedCacheAdapter(block_size=8))
    with pytest.raises(ValueError, match="one\\s+block"):
        # a ring (windowed) paged table pins the chunk to one block
        port_sched(tc.with_(sliding_window=WIN), tp, chunk=8,
                   cache=PagedCacheAdapter(block_size=4))
    eng = port_sched(tc, tp)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(prompt=np.zeros((47,), np.int32),
                           max_new_tokens=8))
    # submit only enqueues: rids in arrival order, nothing admitted
    a, b = (Request(prompt=np.arange(4), max_new_tokens=2) for _ in "ab")
    assert eng.submit(a) and eng.submit(b)
    assert (a.rid, b.rid) == (0, 1) and a.slot == b.slot == -1
    assert [j.req for j in eng.waiting] == [a, b] and not eng.prefilling
    assert isinstance(eng, Engine)
