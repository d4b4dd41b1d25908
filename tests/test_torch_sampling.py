"""Temperature / top-k sampling in the port's engines: one private
``torch.Generator`` per request, seeded from (``ServeConfig.seed``, the
request's submission index) and advanced only by its own draws.  JAX's
PRNG draws cannot be reproduced in torch, so these tests hold the
reference's sampling properties inside the port
(``tests/test_serving.py``, ``tests/test_paged.py``):

* padded vocabulary ids are never drawn;
* a request's stream is the same alone and beside other traffic;
* a pool tight enough to preempt gives the roomy pool's sampled streams
  (the preempted request resumes its generator's saved state);
* ``top_k=1`` is greedy;
* the ``ScheduledEngine``'s sampled streams equal the synchronous
  ``Engine``'s at the same seed, on the dense, paged and int8 caches;
* and sampling samples: other seeds give other streams.

All on the reduced Mistral (standard blocks, float32, logits O(1)) built
by the port's own init, on the CPU.  Tolerance: identity of token
lists."""
import numpy as np
import pytest

from repro_torch import configs as tcfg
from repro_torch.models import init_params
from repro_torch.serving import (Engine, PagedCacheAdapter,
                                 PagedQ8CacheAdapter, SchedConfig,
                                 ScheduledEngine, ServeConfig)

MAX_LEN = 64


@pytest.fixture(scope="module")
def model():
    cfg = tcfg.reduce_config(tcfg.get_config("mistral-7b")).with_(
        dtype="float32", param_dtype="float32", sliding_window=0)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _prompts(vocab, n=4):
    rng = np.random.RandomState(7)
    return [rng.randint(0, vocab, size=(int(s),)).astype(np.int32)
            for s in rng.randint(4, 14, size=n)]


def _serve(cfg, params, prompts, max_new=8, sched=False, cache="dense",
           **sc):
    kw = dict(n_slots=3, max_len=MAX_LEN, temperature=1.0, seed=11)
    kw.update(sc)
    if sched:
        eng = ScheduledEngine(cfg, params, ServeConfig(**kw),
                              SchedConfig(token_budget=32, chunk_tokens=8),
                              impl="torch", cache=cache, device="cpu")
    else:
        eng = Engine(cfg, params, ServeConfig(**kw), impl="torch",
                     cache=cache, device="cpu")
    return [list(o) for o in eng.generate(prompts, max_new_tokens=max_new)], \
        eng


@pytest.mark.parametrize("sched", [False, True], ids=["sync", "sched"])
def test_padded_vocabulary_ids_are_never_sampled(model, sched):
    cfg, _ = model
    c = cfg.with_(vocab_size=100)  # 100 real ids, 128 rows
    assert c.padded_vocab == 128
    params = init_params(c, seed=0, device="cpu")
    assert params["unembed"]["table"].shape[-1] == 128 or \
        params["unembed"]["table"].shape[0] == 128
    outs, _ = _serve(c, params, [np.arange(4), np.arange(4)], max_new=20,
                     sched=sched, temperature=2.0, seed=3)
    assert all(t < 100 for o in outs for t in o), "a padded id was drawn"


@pytest.mark.parametrize("sched", [False, True], ids=["sync", "sched"])
def test_sampled_stream_is_traffic_independent(model, sched):
    cfg, params = model
    p0 = np.arange(5)
    others = _prompts(cfg.vocab_size, 3)
    solo, _ = _serve(cfg, params, [p0], sched=sched)
    busy, _ = _serve(cfg, params, [p0] + others, sched=sched)
    assert solo[0] == busy[0], "sampling depends on co-scheduled traffic"


# (slots, prompts, new tokens, pages of a tight pool).  The synchronous
# engine: two requests outgrow 5 pages while decoding.  The scheduler: its
# decode step cannot evict a prefilling job (as in the reference, it then
# raises), so the pool is starved at admission instead: four requests, 8
# final pages demanded of 6, chunks evicting live decoders
PREEMPT = {False: (2, [np.arange(8), np.arange(8) + 50], 20, 5),
           True: (4, [np.arange(5), np.arange(11) * 3 + 2,
                      np.arange(9) * 5 + 1, np.arange(6) * 11 + 4], 4, 6)}


@pytest.mark.parametrize("sched", [False, True], ids=["sync", "sched"])
def test_preemption_resumes_the_sampling_stream(model, sched):
    cfg, params = model
    n_slots, prompts, max_new, tight_pages = PREEMPT[sched]
    kw = dict(max_new=max_new, sched=sched, n_slots=n_slots, seed=5)
    roomy, r_eng = _serve(cfg, params, prompts, cache=PagedCacheAdapter(
        block_size=8, n_blocks=4 * tight_pages), **kw)
    assert r_eng.stats["n_preempted"] == 0
    tight, t_eng = _serve(cfg, params, prompts, cache=PagedCacheAdapter(
        block_size=8, n_blocks=tight_pages), **kw)
    assert t_eng.stats["n_preempted"] > 0, "a pool sized to preempt"
    assert tight == roomy


def test_top_k_one_is_greedy(model):
    cfg, params = model
    prompts = _prompts(cfg.vocab_size)
    greedy, _ = _serve(cfg, params, prompts, temperature=0.0)
    top1, _ = _serve(cfg, params, prompts, temperature=0.7, top_k=1)
    assert top1 == greedy


@pytest.mark.parametrize("cache", ["dense", "paged", "paged_q8"])
def test_scheduled_sampled_streams_equal_the_synchronous_engine(model,
                                                                cache):
    cfg, params = model
    prompts = _prompts(cfg.vocab_size)

    def adapter():
        if cache == "dense":
            return "dense"
        cls = PagedCacheAdapter if cache == "paged" else PagedQ8CacheAdapter
        return cls(block_size=8)

    kw = dict(temperature=0.8, top_k=20, seed=2)
    sync, _ = _serve(cfg, params, prompts, cache=adapter(), **kw)
    sched, eng = _serve(cfg, params, prompts, cache=adapter(), sched=True,
                        **kw)
    assert eng._chunked and eng.n_chunks_run >= len(prompts)
    assert sched == sync


def test_sampling_samples(model):
    """Other seeds draw other streams, and none is the greedy one: the
    properties above are not met by a sampler that never samples."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size)
    greedy, _ = _serve(cfg, params, prompts, temperature=0.0)
    runs = [_serve(cfg, params, prompts, seed=s)[0] for s in (1, 2)]
    assert runs[0] != runs[1] and greedy not in runs
