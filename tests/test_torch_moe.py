"""The port's MoE (``repro_torch.models.moe``) and the two MoE configs
(Phi-3.5-MoE, Moonshot-v1-16B-A3B), held against ``repro.models.moe``,
``repro.models``, ``repro.core.merge`` and ``repro.serving`` on the same
weights (the JAX package's init, copied by the bridge) and the same
numpy-seeded inputs, on reduced configs (4 experts, top-2, d_model 64):

* ``apply_moe``'s output and aux loss equal the reference's in both
  dispatches ("scatter", "einsum"), dropless and with a capacity small
  enough to drop pairs, over one group, several groups and a token count
  that is not a multiple of the group (atol 1e-5, float32); the two
  dispatches agree with each other; a tie in the top-k goes to the lower
  expert index; a token whose every pair is dropped gets exactly zero;
* each config's fields equal the reference's;
* the skipless forward's logits and aux, source and qp-merged (Moonshot,
  MHA: kp and vp too), at the no-drop capacity ``n_experts`` and at the
  default 1.25, equal the JAX forward's (atol 1e-4 after dividing both by
  the larger of 1 and the reference's largest |logit|, as
  ``tests/test_torch_dense_configs.py``); the port's own merge of the
  bridged source gives the source's logits and removes
  ``weight_table(cfg)["removed"]`` weights, and keeps the router float32;
* the greedy streams of ``Engine`` and ``ScheduledEngine`` (chunks of 8)
  equal the JAX engines' on the dense cache and the paged pool, source
  and merged, at both capacities, with ``bucket_prompts`` on and off
  (under capacity dropping the padded tail joins the prefill's routing
  group, so the streams depend on it); on the int8 pool the scheduled
  streams equal the synchronous ones at the no-drop capacity, and at the
  default capacity a page-aligned prefill that drops a real token's pair
  drops the same pair as the reference, and the streams equal the JAX
  engine's;
* ``eos_token`` ends the streams where the JAX engines end them (one MoE
  config and Mistral-7B; ``Engine`` and ``ScheduledEngine``, dense and
  paged).

The weights are the JAX init as it is (no embedding gain): activations
stay O(1), the router's probabilities stay apart (the gap between a
token's k-th and (k+1)-th choice is > 1e-4 on these prompts, far above
float32 rounding), and the default capacity drops real tokens' pairs.  Tolerance of the streams:
identity of token lists."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.core import merge_skipless as jax_merge
from repro.models import moe as jmoe
from repro.serving import Engine as JaxEngine
from repro.serving import PagedCacheAdapter as JaxPagedAdapter
from repro.serving import PagedQ8CacheAdapter as JaxQ8Adapter
from repro.serving import SchedConfig as JaxSchedConfig
from repro.serving import ScheduledEngine as JaxScheduledEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.convert import from_torch, to_torch
from repro_torch.core import (merge_skipless, removed_weight_count,
                              weight_table)
from repro_torch.models import moe as tmoe
from repro_torch.serving import (Engine, PagedCacheAdapter,
                                 PagedQ8CacheAdapter, SchedConfig,
                                 ScheduledEngine, ServeConfig)

ARCHS = ("phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b")
MHA = "moonshot-v1-16b-a3b"
CAPS = ("nodrop", "default")
ATOL_MOE = 1e-5
ATOL = 1e-4
MAX_NEW, MAX_LEN, PAGE = 6, 48, 8
CACHES = ("dense", "paged")


def _close_logits(got, want, msg=""):
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               rtol=0, atol=ATOL, err_msg=msg)


def _prompts(vocab):
    """5 and 11 tokens: bucketed to 8 and 16, page-aligned to 8 and 16."""
    return [np.arange(5) % vocab, (np.arange(11) * 3 + 2) % vocab]


def _with_cap(c, cap):
    return c.with_(capacity_factor=float(c.n_experts)) if cap == "nodrop" \
        else c


def _port_cfg(c):
    return tcfg.ModelConfig(**{f.name: getattr(c, f.name)
                               for f in dataclasses.fields(c)})


def _jax_adapter(cache):
    return {"dense": lambda: "dense",
            "paged": lambda: JaxPagedAdapter(block_size=PAGE),
            "paged_q8": lambda: JaxQ8Adapter(block_size=PAGE)}[cache]()


def _adapter(cache):
    return {"dense": lambda: "dense",
            "paged": lambda: PagedCacheAdapter(block_size=PAGE),
            "paged_q8": lambda: PagedQ8CacheAdapter(block_size=PAGE)}[
        cache]()


def _jax_streams(c, w, cache, prompts, sched=False, **sc_kw):
    sc = JaxServeConfig(n_slots=2, max_len=MAX_LEN, **sc_kw)
    if sched:
        eng = JaxScheduledEngine(c, w, sc, JaxSchedConfig(token_budget=32,
                                                          chunk_tokens=PAGE),
                                 impl="xla", cache=_jax_adapter(cache))
    else:
        eng = JaxEngine(c, w, sc, impl="xla", cache=_jax_adapter(cache))
    return [list(o) for o in eng.generate(prompts, max_new_tokens=MAX_NEW)]


def _streams(c, p, cache, prompts, sched=False, **sc_kw):
    sc = ServeConfig(n_slots=2, max_len=MAX_LEN, **sc_kw)
    kw = dict(impl="torch", cache=_adapter(cache), device="cpu")
    if sched:
        eng = ScheduledEngine(c, p, sc, SchedConfig(token_budget=32,
                                                    chunk_tokens=PAGE), **kw)
        assert eng._chunked
    else:
        eng = Engine(c, p, sc, **kw)
    return [list(o) for o in eng.generate(prompts, max_new_tokens=MAX_NEW)]


def _jax_models(i, arch):
    """{style: (JAX config at the default capacity, numpy params)}."""
    jc = jcfg.reduce_config(jcfg.get_config(arch)).with_(
        block_style="skipless", dtype="float32", param_dtype="float32")
    p = jm.init_params(jax.random.PRNGKey(i), jc)
    models = {"source": (jc, jax.tree.map(np.asarray, p))}
    for variant in ("qp", "kp", "vp") if arch == MHA else ("qp",):
        mp, mc = jax_merge(p, jc, variant)
        models[variant] = (mc, jax.tree.map(np.asarray, mp))
    return models


@pytest.fixture(scope="module")
def refs():
    """Per (arch, style, capacity): the port's config and weights, the JAX
    forward's logits and aux on seeded tokens, and (source and qp) the JAX
    engines' greedy streams keyed (cache, bucket_prompts, scheduled)."""
    tokens = np.random.default_rng(0).integers(0, 128, (2, 11)) \
        .astype(np.int32)
    out = {}
    for i, arch in enumerate(ARCHS):
        for style, (c0, w) in _jax_models(i, arch).items():
            params = to_torch(w, device="cpu")
            for cap in CAPS:
                c = _with_cap(c0, cap)
                lg, aux, _ = jm.forward_seq(jax.tree.map(jnp.asarray, w), c,
                                            jnp.asarray(tokens))
                streams = {}
                if style in ("source", "qp"):
                    for cache in CACHES:
                        for bucket in (True, False):
                            for sched in (False, True):
                                streams[(cache, bucket, sched)] = \
                                    _jax_streams(c, w, cache,
                                                 _prompts(c.vocab_size),
                                                 sched, bucket_prompts=bucket)
                out[(arch, style, cap)] = dict(
                    cfg=_port_cfg(c), params=params, logits=np.asarray(lg),
                    aux=float(aux), streams=streams)
    return tokens, out


# ---------------------------------------------------------------------------
# apply_moe against the reference
# ---------------------------------------------------------------------------

E, K, D, F = 4, 2, 64, 96
GROUPINGS = {"one": ((2, 12), 2048), "several": ((2, 12), 8),
             "ragged": ((1, 10), 4)}


def _moe_weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((D, E)).astype(np.float32),
            "w_gate": rng.standard_normal((E, D, F)).astype(np.float32) / 8,
            "w_up": rng.standard_normal((E, D, F)).astype(np.float32) / 8,
            "w_down": rng.standard_normal((E, F, D)).astype(np.float32) / 10}


def _both_moe(w, x, **kw):
    """(port out, port aux, JAX out, JAX aux) as numpy."""
    jo, ja = jmoe.apply_moe({k: jnp.asarray(v) for k, v in w.items()},
                            jnp.asarray(x), **kw)
    to, ta = tmoe.apply_moe({k: torch.as_tensor(v) for k, v in w.items()},
                            torch.as_tensor(x), **kw)
    return to.numpy(), float(ta), np.asarray(jo), float(ja)


def _dropped(w, x, group_size, cap_factor):
    """Pairs the port's routing drops over ``x``'s groups."""
    tokens = x.shape[0] * x.shape[1]
    g = min(group_size, tokens)
    g = tokens if tokens % g else g
    cap = tmoe._capacity(g, E, K, cap_factor)
    n = 0
    for xg in torch.as_tensor(x).reshape(-1, g, D):
        n += int((~tmoe.route(torch.as_tensor(w["router"]), xg, K,
                              cap)[3]).sum())
    return n


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("impl", ["scatter", "einsum"])
def test_apply_moe_matches_jax(impl, dropless, grouping):
    shape, gs = GROUPINGS[grouping]
    w = _moe_weights()
    x = np.random.default_rng(1).standard_normal(shape + (D,)) \
        .astype(np.float32)
    kw = dict(n_experts=E, experts_per_token=K, capacity_factor=0.5,
              group_size=gs, dropless=dropless, impl=impl)
    to, ta, jo, ja = _both_moe(w, x, **kw)
    np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL_MOE)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=ATOL_MOE)
    if not dropless:  # the capacity did bite, and dropping changed rows
        assert _dropped(w, x, gs, 0.5) > 0
        full, _, _, _ = _both_moe(w, x, **dict(kw, dropless=True))
        assert np.abs(full - to).max() > 1e-3


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("dropless", [False, True])
def test_dispatches_agree(dropless, grouping):
    shape, gs = GROUPINGS[grouping]
    w = {k: torch.as_tensor(v) for k, v in _moe_weights(2).items()}
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        shape + (D,)).astype(np.float32))
    kw = dict(n_experts=E, experts_per_token=K, capacity_factor=0.5,
              group_size=gs, dropless=dropless)
    so, sa = tmoe.apply_moe(w, x, impl="scatter", **kw)
    eo, ea = tmoe.apply_moe(w, x, impl="einsum", **kw)
    np.testing.assert_allclose(so.numpy(), eo.numpy(), rtol=0,
                               atol=ATOL_MOE)
    assert float(sa) == float(ea)


def test_top_k_tie_goes_to_the_lower_expert():
    """Experts 1 and 3 have the same router column, so every token's
    probabilities tie between them, behind expert 0 and ahead of expert 2
    (positive inputs): the second choice is the tie, which
    ``jax.lax.top_k`` breaks toward the lower index.  The experts differ,
    so choosing 3 would change the output."""
    w = _moe_weights(4)
    w["router"][:, 0] = 0.0
    w["router"][:, 1] = w["router"][:, 3] = -0.01
    w["router"][:, 2] = -1.0
    x = np.abs(np.random.default_rng(5).standard_normal((1, 6, D))) \
        .astype(np.float32)
    _, idx, _, _, _ = tmoe.route(torch.as_tensor(w["router"]),
                                 torch.as_tensor(x[0]), K, 6)
    assert idx.tolist() == [[0, 1]] * 6
    for impl in ("scatter", "einsum"):
        to, _, jo, _ = _both_moe(w, x, n_experts=E, experts_per_token=K,
                                 dropless=True, impl=impl)
        np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL_MOE)
        swapped = dict(w, w_down=w["w_down"][[0, 3, 2, 1]])
        so, _, _, _ = _both_moe(swapped, x, n_experts=E,
                                experts_per_token=K, dropless=True,
                                impl=impl)
        assert np.abs(so - to).max() > 1e-3


def test_a_token_whose_pairs_are_all_dropped_gets_zero():
    """Every token (positive inputs) chooses expert 0, then expert 1;
    capacity 1 keeps only the first token's pairs, so every other row is
    exactly zero in both dispatches, as in the reference."""
    w = _moe_weights(6)
    w["router"][:, 0] = 0.0
    w["router"][:, 1] = -0.01
    w["router"][:, 2:] = -1.0
    x = np.abs(np.random.default_rng(7).standard_normal((1, 8, D))) \
        .astype(np.float32)
    assert tmoe._capacity(8, E, K, 0.25) == 1
    for impl in ("scatter", "einsum"):
        to, _, jo, _ = _both_moe(w, x, n_experts=E, experts_per_token=K,
                                 capacity_factor=0.25, impl=impl)
        assert np.all(to[0, 1:] == 0.0) and np.all(jo[0, 1:] == 0.0)
        assert np.abs(to[0, 0]).max() > 0
        np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL_MOE)


# ---------------------------------------------------------------------------
# configs, forward and merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_reference(arch):
    want = jcfg.get_config(arch)
    got = tcfg.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tcfg.reduce_config(got)) == \
        dataclasses.asdict(jcfg.reduce_config(want))
    assert arch in tcfg.list_archs()


FWD = [(a, s) for a in ARCHS
       for s in (("source", "qp", "kp", "vp") if a == MHA
                 else ("source", "qp"))]


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("arch,style", FWD)
def test_reduced_forward_matches_jax(refs, arch, style, cap):
    tokens, out = refs
    r = out[(arch, style, cap)]
    got, aux, _ = tm.forward_seq(r["params"], r["cfg"],
                                 torch.as_tensor(tokens))
    _close_logits(got.numpy(), r["logits"], f"{arch} {style} {cap}")
    assert abs(float(aux) - r["aux"]) <= ATOL_MOE, (float(aux), r["aux"])
    assert float(aux) > 0


@pytest.mark.parametrize("arch,variant", [(a, s) for a, s in FWD
                                          if s != "source"])
def test_port_merge_gives_the_source_logits(refs, arch, variant):
    """The port's own merge of the bridged source weights gives the
    source's (and the JAX merge's) logits at the no-drop capacity, removes
    exactly ``weight_table(cfg)["removed"]`` weights and keeps the router
    float32 (one layer and one expert at a time)."""
    tokens, out = refs
    src = out[(arch, "source", "nodrop")]
    mp, mc = merge_skipless(src["params"], src["cfg"], variant)
    got, aux, _ = tm.forward_seq(mp, mc, torch.as_tensor(tokens))
    _close_logits(got.numpy(), src["logits"], f"{arch} {variant}")
    _close_logits(got.numpy(), out[(arch, variant, "nodrop")]["logits"])
    assert abs(float(aux) - src["aux"]) <= ATOL_MOE
    assert removed_weight_count(src["params"], mp) == \
        weight_table(src["cfg"])["removed"]
    assert mp["layers"]["moe"]["router"].dtype == torch.float32
    want = out[(arch, variant, "nodrop")]["params"]["layers"]["moe"]
    for name, w in mp["layers"]["moe"].items():
        np.testing.assert_allclose(w.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_merge_of_bf16_weights_keeps_a_float32_router():
    cfg = tcfg.reduce_config(tcfg.get_config(ARCHS[0])).with_(
        block_style="skipless", param_dtype="bfloat16", dtype="bfloat16")
    params = tm.init_params(cfg, seed=1, device="cpu")
    moe = params["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == torch.bfloat16
    assert moe["w_gate"].shape == (cfg.n_layers, cfg.n_experts,
                                   cfg.d_model, cfg.d_ff)
    mp, _ = merge_skipless(params, cfg, "qp")
    assert mp["layers"]["moe"]["router"].dtype == torch.float32
    assert mp["layers"]["moe"]["w_down"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_the_bridge_carries_moe_trees(arch):
    """``convert`` is a tree map: the MoE leaves cross with the JAX
    tree's structure, shapes and values, both ways."""
    jc, w = _jax_models(ARCHS.index(arch), arch)["source"]
    t = to_torch(w, device="cpu")
    assert set(t["layers"]["moe"]) == {"router", "w_gate", "w_up",
                                       "w_down"}
    back = from_torch(t)
    for name, a in w["layers"]["moe"].items():
        assert back["layers"]["moe"][name].shape == a.shape
        np.testing.assert_array_equal(back["layers"]["moe"][name], a)
    assert tm.count_params(t) == tm.count_params(
        tm.init_params(_port_cfg(jc), device="cpu"))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

ENG = [(a, s, c, cap, b) for a in ARCHS for s in ("source", "qp")
       for c in CACHES for cap in CAPS for b in (True, False)]


@pytest.mark.parametrize("arch,style,cache,cap,bucket", ENG)
def test_engine_streams_match_the_jax_engine(refs, arch, style, cache, cap,
                                             bucket):
    _, out = refs
    r = out[(arch, style, cap)]
    got = _streams(r["cfg"], r["params"], cache, _prompts(128),
                   bucket_prompts=bucket)
    assert got == r["streams"][(cache, bucket, False)]
    assert all(len(o) == MAX_NEW for o in got)


@pytest.mark.parametrize("arch,style,cache,cap,bucket", ENG)
def test_scheduled_streams_match_the_jax_scheduler(refs, arch, style, cache,
                                                   cap, bucket):
    """Chunks route dropless, in both packages."""
    _, out = refs
    r = out[(arch, style, cap)]
    got = _streams(r["cfg"], r["params"], cache, _prompts(128), sched=True,
                   bucket_prompts=bucket)
    assert got == r["streams"][(cache, bucket, True)]


@pytest.mark.parametrize("arch", ARCHS)
def test_merged_equals_source_at_both_capacities(refs, arch):
    _, out = refs
    for cap in CAPS:
        a = out[(arch, "source", cap)]["streams"]
        b = out[(arch, "qp", cap)]["streams"]
        assert a == b, (arch, cap)


def test_bucketing_changes_the_default_capacity_streams(refs):
    """Under capacity dropping the padded tail competes for the experts'
    slots: in the reference and the port, bucketed and unbucketed prompts
    give different streams on at least one config (at the no-drop
    capacity they never do)."""
    _, out = refs
    differ = []
    for arch in ARCHS:
        for cap in CAPS:
            s = out[(arch, "source", cap)]["streams"]
            differ.append((cap, s[("dense", True, False)] !=
                           s[("dense", False, False)]))
    assert ("default", True) in differ
    assert ("nodrop", True) not in differ


@pytest.mark.parametrize("arch,style", [(a, s) for a in ARCHS
                                        for s in ("source", "qp")])
def test_int8_pool_scheduled_equals_synchronous(refs, arch, style):
    _, out = refs
    r = out[(arch, style, "nodrop")]
    want = _streams(r["cfg"], r["params"], "paged_q8", _prompts(128))
    got = _streams(r["cfg"], r["params"], "paged_q8", _prompts(128),
                   sched=True)
    assert got == want and all(len(o) == MAX_NEW for o in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_pool_drops_what_the_reference_drops(refs, monkeypatch, arch):
    """At the default capacity, unbucketed: the int8 pool still pads each
    prompt to whole pages, and the pad tokens route with the prompt.  On
    every prefill MoE call the port's output equals the reference's
    ``apply_moe`` on the same input and weights (so the same pairs are
    dropped); at least one real token loses a pair, and routing it would
    change its row; the streams equal the JAX engine's."""
    _, out = refs
    r = out[(arch, "qp", "default")]
    calls = []
    real = tmoe.apply_moe

    def recording(params, x, **kw):
        o, a = real(params, x, **kw)
        if not kw["dropless"]:
            calls.append((params, x, kw, o))
        return o, a

    monkeypatch.setattr(tmoe, "apply_moe", recording)
    prompts = _prompts(128)
    got = _streams(r["cfg"], r["params"], "paged_q8", prompts,
                   bucket_prompts=False)
    monkeypatch.undo()
    c = r["cfg"]
    assert [x.shape[1] for _, x, _, _ in calls] == \
        [8] * c.n_layers + [16] * c.n_layers
    real_dropped = 0
    for n, (p, x, kw, o) in enumerate(calls):
        n_real = len(prompts[n // c.n_layers])
        jo, _ = jmoe.apply_moe({k: jnp.asarray(v.numpy())
                                for k, v in p.items()},
                               jnp.asarray(x.numpy()), **kw)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0,
                                   atol=ATOL_MOE)
        cap = tmoe._capacity(x.shape[1], c.n_experts, c.experts_per_token,
                             c.capacity_factor)
        keep = tmoe.route(p["router"], x[0], c.experts_per_token, cap)[3]
        rows = torch.nonzero(~keep[:n_real].all(-1)).flatten()
        if len(rows):
            full, _ = real(p, x, **dict(kw, dropless=True))
            assert float((full - o)[0, rows].abs().max()) > 1e-4
            real_dropped += len(rows)
    assert real_dropped > 0
    jc, w = _jax_models(ARCHS.index(arch), arch)["qp"]
    assert got == _jax_streams(jc, w, "paged_q8", prompts,
                               bucket_prompts=False)


# ---------------------------------------------------------------------------
# eos_token
# ---------------------------------------------------------------------------

def _mistral():
    """Windowless, so that the scheduler chunks its prompts."""
    jc = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(
        block_style="skipless", dtype="float32", param_dtype="float32",
        sliding_window=0)
    p = jm.init_params(jax.random.PRNGKey(0), jc)
    p["embed"]["table"] = p["embed"]["table"] * 50.0
    return jc, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("sched", [False, True])
@pytest.mark.parametrize("model", ["moe", "mistral"])
def test_eos_token_ends_the_streams_as_the_reference(model, sched, cache):
    """The eos is the third token of prompt 0's stream without one: that
    request stops there, the other runs on (or stops at its own eos)."""
    jc, w = _jax_models(0, ARCHS[0])["qp"] if model == "moe" \
        else _mistral()
    tc, tp = _port_cfg(jc), to_torch(w, device="cpu")
    prompts = _prompts(jc.vocab_size)
    free = _streams(tc, tp, cache, prompts, sched)
    eos = free[0][2]
    got = _streams(tc, tp, cache, prompts, sched, eos_token=eos)
    assert got[0] == free[0][:free[0].index(eos) + 1]
    assert got == _jax_streams(jc, w, cache, prompts, sched, eos_token=eos)
