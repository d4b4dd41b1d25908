"""The port's model (init, sequence forward, prefill, decode) and merge,
held against ``repro.models`` / ``repro.core.merge`` on the same weights:
the JAX package initialises each model, the bridge copies the weights,
and both sides run the same numpy-seeded tokens.

Tolerances: logits atol 1e-4 after dividing both sides by the larger of
1 and the reference's largest |logit| (float32 on both sides, the
products summed in another order over a few layers; skipless stacks with
scaled embeddings reach |logits| ~ 1e6, where float32 itself resolves
only ~0.1); merged tensors rtol 1e-6 (both merges compute in float64 and
round once to float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.core import merge as jmerge
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.convert import from_torch, to_torch
from repro_torch.core import merge as tmerge

ATOL = 1e-4
STYLES = [("standard", False), ("standard", True), ("skipless", False),
          ("skipless", True), ("residual_qpfree", False),
          ("residual_qpfree", True), ("skipless_merged", True)]


def _close_logits(got, want, msg=""):
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               rtol=0, atol=ATOL, err_msg=msg)


def _cfgs(**kw):
    """The same reduced config on both sides (GQA: 4 query heads over 1)."""
    return (jcfg.reduce_config(jcfg.get_config("mistral-7b"), **kw),
            tcfg.reduce_config(tcfg.get_config("mistral-7b"), **kw))


def _jax_params(jc, seed, embed_gain=1.0):
    p = jm.init_params(jax.random.PRNGKey(seed), jc)
    p["embed"]["table"] = p["embed"]["table"] * embed_gain
    return jax.tree.map(np.asarray, p)


def _prefill_and_steps(mod, params, cfg, prompt, feed, cache_len, *,
                       true_len=None, torch_side):
    """Last-prompt-position logits, then one step per token in ``feed``."""
    if torch_side:
        x = torch.as_tensor(prompt)[None]
        tl = None if true_len is None else torch.tensor([true_len])
        lg, cache = mod.forward_prefill(params, cfg, x,
                                        mod.DensePrefillDest(cache_len),
                                        true_len=tl)
        out = [lg.numpy()]
        for t in feed:
            lg, cache = mod.forward_step(params, cfg, torch.tensor([t]),
                                         cache)
            out.append(lg.numpy())
        return out
    x = jnp.asarray(prompt, jnp.int32)[None]
    tl = None if true_len is None else jnp.asarray([true_len], jnp.int32)
    lg, cache = mod.forward_prefill(params, cfg, x,
                                    mod.DensePrefillDest(cache_len),
                                    true_len=tl)
    step = jax.jit(lambda p, t, c: mod.forward_step(p, cfg, t, c))
    out = [np.asarray(lg)]
    for t in feed:
        lg, cache = step(params, jnp.asarray([t], jnp.int32), cache)
        out.append(np.asarray(lg))
    return out


MERGE_CASES = [(v, b, t) for v in ("qp", "kp", "vp")
               for b, t in ((False, False), (True, False), (False, True))]


def _seq_refs():
    """JAX forward_seq logits for every block style, serial and parallel."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, (2, 11)).astype(np.int32)
    out = {}
    for style, parallel in STYLES:
        jc, tc = _cfgs(block_style=style, parallel_block=parallel)
        p = _jax_params(jc, 0)
        lg, _, kvs = jm.forward_seq(jax.tree.map(jnp.asarray, p), jc,
                                    jnp.asarray(tokens), collect_kv=True)
        out[(style, parallel)] = (tc, p, np.asarray(lg),
                                  tuple(np.asarray(x) for x in kvs))
    return tokens, out


@pytest.mark.parametrize("style,parallel", STYLES)
def test_forward_seq_matches(refs, style, parallel):
    tokens, seq = refs["seq"]
    tc, p, want, kvs = seq[(style, parallel)]
    got, _, tkvs = tm.forward_seq(to_torch(p, device="cpu"), tc,
                                  torch.as_tensor(tokens), collect_kv=True)
    _close_logits(got.numpy(), want)
    for a, b in zip(tkvs, kvs):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("style,parallel", STYLES)
def test_init_params_tree_matches_the_reference(refs, style, parallel):
    tc, p, _, _ = refs["seq"][1][(style, parallel)]
    t = tm.init_params(tc, seed=0, device="cpu")
    shapes = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), p)
    got = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                       from_torch(t))
    assert got == shapes
    assert tm.count_params(t) == jm.count_params(p)


def _serving_refs():
    """A skipless windowed model, its qp merge (JAX merge), and an
    unwindowed standard model — with the JAX prefill/step logits."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 128, 9).astype(np.int32)
    feed = rng.integers(0, 128, 4).astype(np.int32)
    out = {}
    for name, kw, gain in (
            ("skipless_window", dict(block_style="skipless",
                                     sliding_window=5), 50.0),
            ("standard", dict(block_style="standard"), 1.0)):
        jc, tc = _cfgs(**kw)
        p = _jax_params(jc, 2, gain)
        models = {"source": (jc, tc, p)}
        if kw["block_style"] == "skipless":
            jp, jmc = jmerge.merge_skipless(jax.tree.map(jnp.asarray, p), jc,
                                            "qp")
            models["qp"] = (jmc, tc.with_(block_style="skipless_merged"),
                            jax.tree.map(np.asarray, jp))
        for tag, (jc_, tc_, p_) in models.items():
            jp_ = jax.tree.map(jnp.asarray, p_)
            for true_len in ((None, 7) if name == "skipless_window"
                             else (None,)):
                out[(name, tag, 32, true_len)] = (
                    tc_, p_, prompt, _prefill_and_steps(
                        jm, jp_, jc_, prompt, feed, 32, true_len=true_len,
                        torch_side=False))
    return feed, out


def test_prefill_and_decode_logits_match(refs):
    """forward_prefill + forward_step against the JAX dispatchers: the
    windowed cells ring-roll a prompt longer than the window, the true_len
    cells right-pad the prompt (a bucket) and mask the padding."""
    feed, out = refs["serving"]
    assert len(out) == 5
    for key, (tc, p, prompt, want) in out.items():
        got = _prefill_and_steps(tm, to_torch(p, device="cpu"), tc, prompt,
                                 feed, key[2], true_len=key[3],
                                 torch_side=True)
        for i, (a, b) in enumerate(zip(got, want)):
            _close_logits(a, b, f"{key} step {i}")


def test_merged_and_source_decode_agree_through_the_port(refs):
    """The port's merged model (qp, fast path in both phases) gives the
    source's logits step for step."""
    feed, out = refs["serving"]
    for tl in (None, 7):
        a, b = (_prefill_and_steps(
            tm, to_torch(p, device="cpu"), tc, prompt, feed, 32, true_len=tl,
            torch_side=True)
            for tc, p, prompt, _ in (out[("skipless_window", tag, 32, tl)]
                                     for tag in ("source", "qp")))
        for x, y in zip(a, b):
            _close_logits(x, y)
    tc = out[("skipless_window", "qp", 32, None)][0]
    assert tm.serving_style_key(tc) == tm.prefill_style_key(tc) == "merged"


def _mha(**kw):
    return _cfgs(block_style="skipless", n_kv_heads=4, **kw)


def _merge_refs():
    """Per merge case: the source weights (nonzero QKV biases where asked)
    and the JAX merge of them."""
    out = {}
    for variant, bias, tied in MERGE_CASES:
        jc, _ = _mha(qkv_bias=bias, tie_embeddings=tied)
        p = _jax_params(jc, 3)
        if bias:  # nonzero biases so the affine extension is exercised
            rng = np.random.default_rng(4)
            for n in ("bq", "bk", "bv"):
                p["layers"]["attn"][n] = rng.standard_normal(
                    p["layers"]["attn"][n].shape).astype(np.float32) * 0.1
        jp, jmc = jmerge.merge_skipless(jax.tree.map(jnp.asarray, p), jc,
                                        variant)
        out[(variant, bias, tied)] = (
            p, jax.tree.map(np.asarray, jp), jmc,
            jmerge.condition_numbers(p, jc, variant))
    return out


@pytest.fixture(scope="module")
def refs():
    """Everything this file compares against, computed once by the JAX
    package."""
    return {"seq": _seq_refs(), "serving": _serving_refs(),
            "merge": _merge_refs()}


@pytest.mark.parametrize("variant,bias,tied", MERGE_CASES)
def test_merge_matches_the_jax_merge(refs, variant, bias, tied):
    p, want, jmc, conds = refs["merge"][(variant, bias, tied)]
    _, tc = _mha(qkv_bias=bias, tie_embeddings=tied)
    src = to_torch(p, device="cpu")
    tp, tmc = tmerge.merge_skipless(src, tc, variant)
    assert (tmc.block_style, tmc.merged_variant, tmc.tie_embeddings) == \
        (jmc.block_style, jmc.merged_variant, jmc.tie_embeddings)
    got = from_torch(tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        assert a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
    assert tmerge.removed_weight_count(src, tp) == \
        jmerge.removed_weight_count(p, want)
    np.testing.assert_allclose(tmerge.condition_numbers(src, tc, variant),
                               conds, rtol=1e-6)


def test_unsupported_inputs_raise():
    _, tc = _cfgs(block_style="skipless")
    params = tm.init_params(tc, device="cpu")
    with pytest.raises(ValueError, match="skipless"):
        tmerge.merge_skipless(params, tc.with_(block_style="standard"))
    with pytest.raises(ValueError, match="serial"):
        tmerge.merge_skipless(params, tc.with_(parallel_block=True))
    with pytest.raises(ValueError, match="cache_len"):
        tm.forward_prefill(params, tc, torch.zeros((1, 3), dtype=torch.long),
                           tm.DensePrefillDest(0))
    with pytest.raises(ValueError, match="destination"):
        tm.forward_prefill(params, tc, torch.zeros((1, 3), dtype=torch.long),
                           (1, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.init_params(tc.with_(family="moe", n_experts=4), device="cpu")
    with pytest.raises(KeyError, match="registered"):
        tm.backends.get_backend("paged", "merged", "cuda")
    assert tm.backends.registered_backends() == [
        ("dense", s, i) for s in ("generic", "merged")
        for i in ("cuda", "torch")]
    assert tm.cache_spec(tc.with_(sliding_window=8), 2, 32)["k"][0] == \
        (tc.n_layers, 2, 8, tc.n_kv_heads, tc.d_head)
