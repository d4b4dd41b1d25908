"""The reference's five other dense configs in the port (Llama-3.2-1B,
Phi-3-medium-14B, Qwen2.5-32B, Pythia-6.9B, ChatGLM3-6B), held against
``repro.configs``, ``repro.models`` and ``repro.serving`` on the same
weights (the JAX package's init, with nonzero QKV biases where the config
has them, and its qp merge, copied by the bridge):

* each config's fields equal the reference's, full and reduced;
* the reduced skipless forward's logits, source and qp-merged, equal the
  JAX forward's (atol 1e-4 after dividing both by the larger of 1 and the
  reference's largest |logit|: float32 on both sides, summed in another
  order; as ``tests/test_torch_model.py``);
* the greedy streams of the port's ``Engine`` equal the JAX engine's on
  the dense cache and the paged pool, source and merged, and the
  ``ScheduledEngine`` gives the same streams (chunks of 8); on the int8
  pool the scheduled streams equal the synchronous ones;
* ``merged_fast_path`` / ``merged_prefill_fast_path`` agree with the JAX
  engine's (QKV biases and ChatGLM's half-dimension interleaved RoPE
  ride the merged fast path);
* Pythia-6.9B's parallel blocks make ``merge_skipless`` raise in both
  packages: it serves as the source model only.

Tolerance of the streams: identity of token lists."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.core import merge_skipless as jax_merge
from repro.serving import Engine as JaxEngine
from repro.serving import PagedCacheAdapter as JaxPagedAdapter
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.convert import to_torch
from repro_torch.core import merge_skipless
from repro_torch.serving import (Engine, PagedCacheAdapter,
                                 PagedQ8CacheAdapter, SchedConfig,
                                 ScheduledEngine, ServeConfig)

ARCHS = ("llama3.2-1b", "phi3-medium-14b", "qwen2.5-32b", "pythia-6.9b",
         "chatglm3-6b")
MERGEABLE = tuple(a for a in ARCHS if a != "pythia-6.9b")
ATOL = 1e-4
MAX_NEW, MAX_LEN, PAGE = 6, 48, 8
CACHES = ("dense", "paged")


def _close_logits(got, want, msg=""):
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               rtol=0, atol=ATOL, err_msg=msg)


def _prompts(vocab):
    return [np.arange(5) % vocab, (np.arange(11) * 3 + 2) % vocab]


def _jax_adapter(cache):
    return "dense" if cache == "dense" else JaxPagedAdapter(block_size=PAGE)


def _adapter(cache):
    return {"dense": lambda: "dense",
            "paged": lambda: PagedCacheAdapter(block_size=PAGE),
            "paged_q8": lambda: PagedQ8CacheAdapter(block_size=PAGE)}[
        cache]()


@pytest.fixture(scope="module")
def refs():
    """Per arch and style ("source", "qp"): the port's config and weights,
    the JAX forward logits on seeded tokens, the JAX engine's greedy
    streams per cache and its fast-path flags."""
    tokens = np.random.default_rng(0).integers(0, 128, (2, 11)) \
        .astype(np.int32)
    out = {}
    for i, arch in enumerate(ARCHS):
        jc = jcfg.reduce_config(jcfg.get_config(arch)).with_(
            block_style="skipless", dtype="float32", param_dtype="float32")
        p = jax.tree.map(np.asarray,
                         jm.init_params(jax.random.PRNGKey(i), jc))
        p["embed"]["table"] = p["embed"]["table"] * 50.0
        if jc.qkv_bias:  # nonzero biases: the merge's affine extension
            rng = np.random.default_rng(10 + i)
            for n in ("bq", "bk", "bv"):
                p["layers"]["attn"][n] = rng.standard_normal(
                    p["layers"]["attn"][n].shape).astype(np.float32) * 0.1
        models = {"source": (jc, p)}
        if arch in MERGEABLE:
            mp, mc = jax_merge(jax.tree.map(jnp.asarray, p), jc, "qp")
            models["qp"] = (mc, jax.tree.map(np.asarray, mp))
        for style, (c, w) in models.items():
            lg, _, _ = jm.forward_seq(jax.tree.map(jnp.asarray, w), c,
                                      jnp.asarray(tokens))
            streams, flags = {}, None
            for cache in CACHES:
                eng = JaxEngine(c, w, JaxServeConfig(n_slots=2,
                                                     max_len=MAX_LEN),
                                impl="xla", cache=_jax_adapter(cache))
                streams[cache] = [list(o) for o in eng.generate(
                    _prompts(c.vocab_size), max_new_tokens=MAX_NEW)]
                flags = (eng.merged_fast_path, eng.merged_prefill_fast_path)
            # every field of the JAX config (the merge unties a tied
            # embedding: its config says so)
            out[(arch, style)] = dict(
                cfg=tcfg.ModelConfig(**{f.name: getattr(c, f.name) for f in
                                        dataclasses.fields(c)}),
                params=to_torch(w, device="cpu"), logits=np.asarray(lg),
                streams=streams, flags=flags)
    return tokens, out


CELLS = [(a, s) for a in ARCHS for s in ("source", "qp")
         if s == "source" or a in MERGEABLE]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_reference(arch):
    want = jcfg.get_config(arch)
    got = tcfg.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tcfg.reduce_config(got)) == \
        dataclasses.asdict(jcfg.reduce_config(want))
    assert arch in tcfg.list_archs()


@pytest.mark.parametrize("arch,style", CELLS)
def test_reduced_forward_matches_jax(refs, arch, style):
    tokens, out = refs
    r = out[(arch, style)]
    got, _, _ = tm.forward_seq(r["params"], r["cfg"],
                               torch.as_tensor(tokens))
    _close_logits(got.numpy(), r["logits"], f"{arch} {style}")


@pytest.mark.parametrize("arch", MERGEABLE)
def test_port_merge_gives_the_source_logits(refs, arch):
    """The port's own qp merge of the bridged source weights gives the
    source's logits (and the JAX merge's)."""
    tokens, out = refs
    src = out[(arch, "source")]
    mp, mc = merge_skipless(src["params"], src["cfg"], "qp")
    got, _, _ = tm.forward_seq(mp, mc, torch.as_tensor(tokens))
    _close_logits(got.numpy(), src["logits"], arch)
    _close_logits(got.numpy(), out[(arch, "qp")]["logits"], arch)


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("arch,style", CELLS)
def test_engine_streams_match_the_jax_engine(refs, arch, style, cache):
    _, out = refs
    r = out[(arch, style)]
    prompts = _prompts(r["cfg"].vocab_size)
    sc = ServeConfig(n_slots=2, max_len=MAX_LEN)
    eng = Engine(r["cfg"], r["params"], sc, impl="torch",
                 cache=_adapter(cache), device="cpu")
    assert (eng.merged_fast_path, eng.merged_prefill_fast_path) == \
        r["flags"] == (style == "qp",) * 2
    outs = eng.generate(prompts, max_new_tokens=MAX_NEW)
    assert [list(o) for o in outs] == r["streams"][cache]
    # the scheduler's chunks land the same tokens
    sched = ScheduledEngine(r["cfg"], r["params"], sc,
                            SchedConfig(token_budget=32, chunk_tokens=PAGE),
                            impl="torch", cache=_adapter(cache), device="cpu")
    assert sched._chunked
    outs = sched.generate(prompts, max_new_tokens=MAX_NEW)
    assert [list(o) for o in outs] == r["streams"][cache]


@pytest.mark.parametrize("arch,style", CELLS)
def test_int8_pool_scheduled_equals_synchronous(refs, arch, style):
    _, out = refs
    r = out[(arch, style)]
    prompts = _prompts(r["cfg"].vocab_size)
    sc = ServeConfig(n_slots=2, max_len=MAX_LEN)
    sync = Engine(r["cfg"], r["params"], sc, impl="torch",
                  cache=_adapter("paged_q8"), device="cpu")
    want = [list(o) for o in sync.generate(prompts, max_new_tokens=MAX_NEW)]
    sched = ScheduledEngine(r["cfg"], r["params"], sc,
                            SchedConfig(token_budget=32, chunk_tokens=PAGE),
                            impl="torch", cache=_adapter("paged_q8"),
                            device="cpu")
    assert [list(o) for o in sched.generate(
        prompts, max_new_tokens=MAX_NEW)] == want
    assert all(len(o) == MAX_NEW for o in want)


def test_pythia_merge_raises_in_both_packages(refs):
    _, out = refs
    r = out[("pythia-6.9b", "source")]
    assert r["cfg"].parallel_block
    jc = jcfg.reduce_config(jcfg.get_config("pythia-6.9b")).with_(
        block_style="skipless")
    with pytest.raises(ValueError, match="parallel"):
        jax_merge(jm.init_params(jax.random.PRNGKey(0), jc), jc, "qp")
    with pytest.raises(ValueError, match="parallel"):
        merge_skipless(r["params"], r["cfg"], "qp")
