"""The paged rows of the port's chunked-prefill grid against
``repro.serving.ScheduledEngine`` (setup of
``tests/test_torch_sched_dense.py``):

* the paged pool with the source and its qp / kp / vp merges: the port's
  greedy streams equal the JAX scheduler's and the JAX whole-prompt
  oracle's;
* the int8 pool (``paged_q8``), source and qp: equal to the JAX
  synchronous q8 engine's streams (chunked and whole-prompt q8 prefill
  write the same pool bits);
* the window row: a ring table chunks at one block and matches the JAX
  scheduler and the oracle;
* the pool-starved row: deferral or preemption fires, the streams stay
  the oracle's, and once the prefix cache is dropped no page is in use.

Tolerance: identity of token lists."""
import numpy as np
import pytest

from repro.serving import Engine as JaxEngine
from repro.serving import PagedCacheAdapter as JaxPagedAdapter
from repro.serving import PagedQ8CacheAdapter as JaxQ8Adapter
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.serving import PagedCacheAdapter, PagedQ8CacheAdapter
from test_torch_sched_dense import (CHUNK, MAX_NEW, STYLES, WIN,
                                    WIN_MAX_NEW, base_models, greedy_oracle,
                                    grid_prompts, jax_sched_streams,
                                    port_model, port_sched, window_prompts)

WIN_BLOCK = 2  # the ring pins the chunk width to the block size


def _jax_paged(block=CHUNK, n_blocks=None):
    return JaxPagedAdapter(block_size=block,
                           n_blocks=n_blocks or 2 * 48 // block)


def _paged(block=CHUNK, n_blocks=None):
    return PagedCacheAdapter(block_size=block,
                             n_blocks=n_blocks or 2 * 48 // block)


@pytest.fixture(scope="module")
def grid():
    """Per style: the port's model, the JAX scheduler's paged streams and
    (generic, qp) the JAX synchronous q8 engine's; and the oracle."""
    models = base_models()
    cfg, params = models["generic"]
    prompts = grid_prompts(cfg.vocab_size)
    oracle = [greedy_oracle(params, cfg, p, MAX_NEW) for p in prompts]
    out = {}
    for style, (c, p) in models.items():
        q8 = None
        if style in ("generic", "qp"):
            sync = JaxEngine(c, p, JaxServeConfig(n_slots=2, max_len=48),
                             impl="xla", cache=JaxQ8Adapter(block_size=CHUNK))
            q8 = [list(o) for o in sync.generate(prompts,
                                                 max_new_tokens=MAX_NEW)]
        out[style] = (*port_model(c, p),
                      jax_sched_streams(c, p, prompts, MAX_NEW,
                                        cache=_jax_paged()), q8)
    return out, prompts, oracle


@pytest.mark.parametrize("style", STYLES)
def test_chunked_paged_matches_the_jax_scheduler_and_oracle(grid, style):
    models, prompts, oracle = grid
    tc, tp, want, _ = models[style]
    eng = port_sched(tc, tp, cache=_paged())
    assert eng._chunked and eng.kv.supports_chunked
    outs = eng.generate(prompts, max_new_tokens=MAX_NEW)
    assert [list(o) for o in outs] == want == oracle
    assert eng.n_chunks_run >= len(prompts)
    assert not eng.pm.shielded, "every activated slot is unshielded"


@pytest.mark.parametrize("style", ["generic", "qp"])
def test_chunked_q8_matches_the_jax_synchronous_q8_engine(grid, style):
    models, prompts, _ = grid
    tc, tp, _, want = models[style]
    eng = port_sched(tc, tp, cache=PagedQ8CacheAdapter(
        block_size=CHUNK, n_blocks=2 * 48 // CHUNK))
    assert eng._chunked, "windowless q8 combos chunk like fp paged"
    outs = eng.generate(prompts, max_new_tokens=MAX_NEW)
    assert [list(o) for o in outs] == want
    assert eng.n_chunks_run >= len(prompts)


def test_paged_window_row_chunks_at_one_block():
    models = base_models(window=WIN, seed=1)
    cfg, params = models["generic"]
    prompts = window_prompts(cfg.vocab_size)
    oracle = [greedy_oracle(params, cfg, p, WIN_MAX_NEW) for p in prompts]
    want = jax_sched_streams(cfg, params, prompts, WIN_MAX_NEW,
                             cache=_jax_paged(WIN_BLOCK, 24),
                             chunk=WIN_BLOCK, budget=8)
    tc, tp = port_model(cfg, params)
    eng = port_sched(tc, tp, cache=_paged(WIN_BLOCK, 24), chunk=WIN_BLOCK,
                     budget=8)
    assert eng._chunked and eng.pm.ring
    outs = eng.generate(prompts, max_new_tokens=WIN_MAX_NEW)
    assert [list(o) for o in outs] == want == oracle
    assert eng.pm.allocator.n_recycled > 0


def test_starved_pool_defers_and_preempts_with_identical_streams(grid):
    """Deferred admissions queue (FCFS), chunks evict live decoders when
    no page maps, preempted requests resume, and the streams still equal
    the oracle's and the JAX scheduler's on the same starved pool."""
    models, prompts, oracle = grid
    tc, tp, _, _ = models["generic"]
    cfg, params = base_models()["generic"]
    many = prompts + [(np.arange(9) * 5 + 1) % cfg.vocab_size,
                      (np.arange(6) * 11 + 4) % cfg.vocab_size]
    want = oracle + [greedy_oracle(params, cfg, p, MAX_NEW)
                     for p in many[2:]]
    # a budget wide enough that all four requests chunk in the same
    # iteration: 8 final blocks demanded of 6
    jax_want = jax_sched_streams(cfg, params, many, MAX_NEW, n_slots=4,
                                 budget=64, cache=_jax_paged(n_blocks=6))
    eng = port_sched(tc, tp, cache=_paged(n_blocks=6), n_slots=4, budget=64)
    outs = eng.generate(many, max_new_tokens=MAX_NEW)
    assert eng.stats["n_deferred"] + eng.stats["n_preempted"] > 0, \
        "a pool sized to starve must defer or preempt"
    assert [list(o) for o in outs] == want == jax_want
    eng.pm.drop_prefix_cache()
    assert eng.pm.allocator.n_used == 0, "a drained pool leaks no pages"
    assert sorted(eng.free_slots) == [0, 1, 2, 3]
