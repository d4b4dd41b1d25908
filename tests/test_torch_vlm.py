"""The VLM (Llama-3.2-Vision-11B) in the port, held against
``repro.configs``, ``repro.models``, ``repro.core.merge`` and
``repro.serving`` on the same weights (the JAX package's init with the x50
embedding gain of the dense tests, and its qp merge, copied by the bridge)
and the same seeded vision tokens, at ``reduce_config`` shapes (4 layers,
a cross-attention layer every 2nd, 8 vision tokens):

* the config's fields equal the reference's, full and reduced;
* the bridge carries the nested (n_groups, self_per_group, …) self stack
  and the (n_groups, …) cross stack both ways;
* ``forward_seq`` logits, source and qp-merged, equal the JAX forward's
  (atol 1e-4 after dividing both by the larger of 1 and the reference's
  largest |logit|: float32 on both sides, summed in another order; as
  ``tests/test_torch_model.py``);
* prefill then decode steps give the full forward's logits, and the
  cache's cross K/V equal the JAX prefill's;
* the port ``Engine``'s greedy streams with vision equal the JAX
  ``Engine``'s on the dense cache, source and merged, and merged ==
  source (identity of token lists); with the observer on, each request's
  events equal the JAX engine's;
* ``merge_skipless`` refuses kp/vp as the reference does; the removed
  weights equal ``core.analysis.weight_table``'s;
* the cross step's in-place decode wrapper and the non-causal flash
  wrapper (Sk = the vision tokens != Sq) equal the JAX Pallas kernels in
  interpret mode on CPU tensors (atol 1e-5);
* the refusals: the paged pools and ``ScheduledEngine`` refuse vision, a
  VLM request without vision and vision for a config without
  cross-attention raise ValueError."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.core import merge_skipless as jax_merge
from repro.kernels import ops as jops
from repro.serving import Engine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch import obs as O
from repro_torch.convert import from_torch, to_torch
from repro_torch.core import (merge_skipless, removed_weight_count,
                              weight_table)
from repro_torch.kernels import ops as tops
from repro_torch.serving import (Engine, PagedCacheAdapter,
                                 PagedQ8CacheAdapter, Request, SchedConfig,
                                 ScheduledEngine, ServeConfig)

ARCH = "llama3.2-vision-11b"
ATOL = 1e-4
MAX_NEW, MAX_LEN = 6, 32


def _close_logits(got, want, msg=""):
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               rtol=0, atol=ATOL, err_msg=msg)


def _prompts(vocab):
    return [np.arange(5) % vocab, (np.arange(11) * 3 + 2) % vocab,
            (np.arange(3) * 7 + 1) % vocab]


def _port_cfg(c):
    return tcfg.ModelConfig(**{f.name: getattr(c, f.name)
                               for f in dataclasses.fields(c)})


@pytest.fixture(scope="module")
def ref():
    """The JAX side: per style ("source", "qp") the port's config and
    weights, the JAX forward logits on seeded tokens and vision, the JAX
    prefill's cross K/V, and the JAX engine's greedy streams and
    per-request event names (observer on) on the dense cache."""
    jc = jcfg.reduce_config(jcfg.get_config(ARCH)).with_(
        block_style="skipless", dtype="float32", param_dtype="float32")
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jc))
    p["embed"]["table"] = p["embed"]["table"] * 50.0
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab_size, (2, 11)).astype(np.int32)
    vision = rng.standard_normal(
        (2, jc.n_vision_tokens, jc.d_model)).astype(np.float32)
    prompts = _prompts(jc.vocab_size)
    pvision = [rng.standard_normal((jc.n_vision_tokens, jc.d_model))
               .astype(np.float32) for _ in prompts]
    mp, mc = jax_merge(jax.tree.map(jnp.asarray, p), jc, "qp")
    out = {"jax_params": p, "jc": jc}
    for style, (c, w) in {"source": (jc, p),
                          "qp": (mc, jax.tree.map(np.asarray, mp))}.items():
        jw = jax.tree.map(jnp.asarray, w)
        lg, _, _ = jm.forward_seq(jw, c, jnp.asarray(tokens),
                                  vision=jnp.asarray(vision))
        _, cache = jm.forward_prefill(jw, c, jnp.asarray(tokens[:, :7]),
                                      jm.DensePrefillDest(MAX_LEN),
                                      vision=jnp.asarray(vision))
        eng = JaxEngine(c, w, JaxServeConfig(n_slots=2, max_len=MAX_LEN,
                                             obs=True), impl="xla")
        streams = [list(o) for o in eng.generate(
            prompts, max_new_tokens=MAX_NEW, vision=pvision)]
        names = [[(e["ph"], e["name"]) for e in
                  O.request_events(eng.obs.trace, rid)]
                 for rid in range(len(prompts))]
        out[style] = dict(
            cfg=_port_cfg(c), params=to_torch(w, device="cpu"),
            logits=np.asarray(lg), cross=(np.asarray(cache.cross_k),
                                          np.asarray(cache.cross_v)),
            streams=streams, names=names,
            removed=None if style == "source" else
            jm.count_params(p) - jm.count_params(w))
    return tokens, vision, prompts, pvision, out


def test_config_fields_equal_the_reference():
    want, got = jcfg.get_config(ARCH), tcfg.get_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tcfg.reduce_config(got)) == \
        dataclasses.asdict(jcfg.reduce_config(want))
    assert ARCH in tcfg.list_archs()
    assert tm.layer_plan(got) == {"kind": "vlm", "n_groups": 8,
                                  "self_per_group": 4}


def test_bridge_carries_the_nested_stacks(ref):
    out = ref[-1]
    p = out["jax_params"]
    tp = to_torch(p, device="cpu")
    assert tuple(tp["layers"]["attn"]["wq"].shape) == \
        p["layers"]["attn"]["wq"].shape  # (n_groups, self_per_group, d, d)
    assert tuple(tp["cross_layers"]["ffn"]["w_down"].shape) == \
        p["cross_layers"]["ffn"]["w_down"].shape
    back = from_torch(tp)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    # the port's own init has the reference's tree
    mine = tm.init_params(out["source"]["cfg"], device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, p)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, from_torch(mine)))
    assert all(a.shape == tuple(b.shape) for a, b in zip(
        jax.tree.leaves(p), jax.tree.leaves(from_torch(mine))))


@pytest.mark.parametrize("style", ["source", "qp"])
def test_forward_matches_jax(ref, style):
    tokens, vision, _, _, out = ref
    r = out[style]
    got, _, _ = tm.forward_seq(r["params"], r["cfg"], torch.as_tensor(tokens),
                               vision=torch.as_tensor(vision))
    _close_logits(got.numpy(), r["logits"], style)


@pytest.mark.parametrize("style", ["source", "qp"])
def test_prefill_then_decode_equals_the_full_forward(ref, style):
    """As ``tests/test_decode.py``: prefill 7 tokens, decode the rest one
    at a time; every step's logits equal the full forward's, and the
    cache's cross K/V (native (n_groups, B, nv, Hkv, Dh) layout) equal the
    JAX prefill's."""
    tokens, vision, _, _, out = ref
    r = out[style]
    c, p = r["cfg"], r["params"]
    toks, vis = torch.as_tensor(tokens), torch.as_tensor(vision)
    last, cache = tm.forward_prefill(p, c, toks[:, :7],
                                     tm.DensePrefillDest(MAX_LEN), vision=vis)
    for got, want in zip((cache.cross_k, cache.cross_v), r["cross"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    _close_logits(last.numpy(), r["logits"][:, 6], f"{style} prefill")
    for t in range(7, tokens.shape[1]):
        lg, cache = tm.forward_step(p, c, toks[:, t], cache)
        _close_logits(lg.numpy(), r["logits"][:, t], f"{style} step {t}")
    assert int(cache.length[0]) == tokens.shape[1]


def test_engine_streams_match_jax_and_merged_equals_source(ref):
    _, _, prompts, pvision, out = ref
    got = {}
    for style in ("source", "qp"):
        r = out[style]
        eng = Engine(r["cfg"], r["params"],
                     ServeConfig(n_slots=2, max_len=MAX_LEN, obs=True),
                     impl="torch", device="cpu")
        assert eng.merged_fast_path == (style == "qp")
        assert not eng.merged_prefill_fast_path  # VLM prefill is generic
        got[style] = [list(o) for o in eng.generate(
            prompts, max_new_tokens=MAX_NEW, vision=pvision)]
        assert got[style] == r["streams"], style
        tr = eng.obs.trace
        assert tr.n_dropped == 0 and tr.open_spans() == []
        names = [[(e["ph"], e["name"]) for e in O.request_events(tr, rid)]
                 for rid in range(len(prompts))]
        assert names == r["names"], style
    assert got["qp"] == got["source"]
    assert len({tuple(s) for s in got["source"]}) > 1  # not degenerate


def test_merge_refusals_and_removed_weights(ref):
    out = ref[-1]
    jc, p = out["jc"], out["jax_params"]
    r = out["source"]
    for variant in ("kp", "vp"):
        with pytest.raises(ValueError, match="qp"):
            jax_merge(jax.tree.map(jnp.asarray, p), jc, variant)
        with pytest.raises(ValueError, match="qp"):
            merge_skipless(r["params"], r["cfg"], variant)
    mp, mc = merge_skipless(r["params"], r["cfg"], "qp")
    assert removed_weight_count(r["params"], mp) == out["qp"]["removed"] \
        == weight_table(r["cfg"])["removed"]
    assert set(mp["cross_layers"]["attn"]) == {"wk", "wv"}
    assert "input_proj" not in mp
    with pytest.raises(ValueError, match="qp"):
        tm.init_params(r["cfg"].with_(block_style="skipless_merged",
                                      merged_variant="kp"), device="cpu")


def test_cross_kernel_wrappers_match_the_pallas_kernels():
    """The cross step's decode wrapper reads (B, nv, Hkv, D) in place; the
    cross prefill's flash wrapper runs non-causal with Sk != Sq.  On CPU
    tensors both run their plain versions, through the same layout
    plumbing the card takes."""
    rng = np.random.default_rng(1)
    B, Hq, Hkv, D, nv, Sq = 2, 8, 2, 16, 24, 11

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v = rand(B, Hq, D), rand(B, nv, Hkv, D), rand(B, nv, Hkv, D)
    kvp = np.broadcast_to(np.arange(nv, dtype=np.int32), (B, nv)).copy()
    qp = np.full((B,), nv + 1, np.int32)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), kv_positions=kvp,
                                 q_position=qp, interpret=True)
    got = tops.decode_attention_native(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        kv_positions=torch.as_tensor(kvp), q_position=torch.as_tensor(qp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    u = rand(B, Sq, Hq, D)
    want = jops.flash_attention(jnp.asarray(u), jnp.asarray(k),
                                jnp.asarray(v), causal=False, interpret=True)
    got = tops.flash_attention(torch.as_tensor(u), torch.as_tensor(k),
                               torch.as_tensor(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_refusals(ref):
    _, _, prompts, pvision, out = ref
    r = out["qp"]
    c, p = r["cfg"], r["params"]
    sc = ServeConfig(n_slots=2, max_len=MAX_LEN)
    eng = Engine(c, p, sc, impl="torch", device="cpu")
    with pytest.raises(ValueError, match="vision"):
        eng.submit(Request(prompt=prompts[0], max_new_tokens=2))
    with pytest.raises(ValueError, match="vision"):
        eng.submit(Request(prompt=prompts[0], max_new_tokens=2),
                   vision=pvision[0][:4])
    with pytest.raises(ValueError, match="vision"):
        tm.forward_seq(p, c, torch.zeros((1, 4), dtype=torch.long))
    # the paged pools serve attention-only stacks, in both packages
    for adapter in (PagedCacheAdapter, PagedQ8CacheAdapter):
        with pytest.raises(ValueError, match="attention-only"):
            Engine(c, p, sc, impl="torch", cache=adapter(block_size=8),
                   device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        tm.forward_prefill(p, c, torch.zeros((1, 8), dtype=torch.long),
                           tm.PagedPrefillDest(None, None, torch.zeros(1)),
                           vision=torch.zeros(1, c.n_vision_tokens,
                                              c.d_model))
    with pytest.raises(ValueError, match="attention-only"):
        ScheduledEngine(c, p, sc, SchedConfig(token_budget=16,
                                              chunk_tokens=8),
                        impl="torch", device="cpu").generate(
            prompts, max_new_tokens=2, vision=pvision)
    sched = ScheduledEngine(c, p, sc, impl="torch", device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        sched.submit(Request(prompt=prompts[0]), vision=pvision[0])
    with pytest.raises(ValueError, match="vision"):
        sched.submit(Request(prompt=prompts[0]))
    # a dense config's engines: a paged adapter given vision, and vision
    # for a config without cross-attention
    dc = tcfg.reduce_config(tcfg.get_config("mistral-7b"))
    dp = tm.init_params(dc, device="cpu")
    for adapter in (PagedCacheAdapter, PagedQ8CacheAdapter):
        deng = Engine(dc, dp, sc, impl="torch", cache=adapter(block_size=8),
                      device="cpu")
        deng.kv.admit(0, np.arange(8, dtype=np.int32))
        with pytest.raises(ValueError, match="vision"):
            deng.kv.prefill(dp, 0, torch.zeros((1, 8), dtype=torch.long), 8,
                            0, torch.zeros((1, 8, dc.d_model)))
        with pytest.raises(ValueError, match="cross-attention"):
            deng.submit(Request(prompt=prompts[0]),
                        vision=np.zeros((8, dc.d_model), np.float32))
