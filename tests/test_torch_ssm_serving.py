"""The port's SSM and hybrid stacks against the JAX package: reduced
Hymba-1.5B (skipless, and its exact qp merge, which removes Q only) and
reduced Mamba2-2.7B (standard), on the JAX package's weights carried by
the bridge and the same numpy-seeded tokens — the sequence forward, the
dense prefill's cache (K/V, positions, SSM state and conv tail), decode
over a sliding window that wraps, the hybrid merge leaf by leaf, and the
``Engine``'s greedy streams on ``tests/test_serving.py``'s grid.

Tolerances: logits 1e-4 after dividing both sides by the larger of 1 and
the reference's largest |logit|, cache tensors 1e-5 (float32 on both
sides, the same products summed in another order over two layers);
merged weights rtol 1e-6 (both merges compute in float64 and round once
to float32)."""
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
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.convert import from_torch, to_torch
from repro_torch.core import merge_skipless, removed_weight_count
from repro_torch.serving import Engine, ServeConfig

ATOL = 1e-4
CACHE_TOL = 1e-5
# name: (arch, block style, merged)
MODELS = {"hybrid": ("hymba-1.5b", "skipless", False),
          "hybrid_merged": ("hymba-1.5b", "skipless", True),
          "mamba2": ("mamba2-2.7b", "standard", False)}
GRID_PROMPTS = [np.arange(5) % 128 + i for i in range(5)]  # 3 slots, 5 reqs
PREFILL_LEN, CACHE_LEN = 21, 32  # longer than the reduced window (16)
WRAP_WINDOW, WRAP_PREFILL, WRAP_LEN = 6, 4, 20


def _cfgs(arch, **kw):
    return (jcfg.reduce_config(jcfg.get_config(arch)).with_(**kw),
            tcfg.reduce_config(tcfg.get_config(arch)).with_(**kw))


def _port_cfg(tc, jc):
    """The port's config of the JAX config ``jc`` (a merge changes style,
    variant and tying)."""
    return tc.with_(block_style=jc.block_style,
                    merged_variant=jc.merged_variant,
                    tie_embeddings=jc.tie_embeddings)


def _close_logits(got, want, msg=""):
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               rtol=0, atol=ATOL, err_msg=msg)


def _jax_decode(params, cfg, prompt, feed, cache_len):
    """JAX prefill + one step per token of ``feed`` -> (logits, cache)."""
    lg, cache = jm.forward_prefill(params, cfg, jnp.asarray(prompt)[None],
                                   jm.DensePrefillDest(cache_len))
    step = jax.jit(lambda p, t, c: jm.forward_step(p, cfg, t, c))
    out = [np.asarray(lg)]
    for t in feed:
        lg, cache = step(params, jnp.asarray([t], jnp.int32), cache)
        out.append(np.asarray(lg))
    return out


def _port_decode(params, cfg, prompt, feed, cache_len):
    lg, cache = tm.forward_prefill(params, cfg, torch.as_tensor(prompt)[None],
                                   tm.DensePrefillDest(cache_len))
    out = [lg.numpy()]
    for t in feed:
        lg, cache = tm.forward_step(params, cfg, torch.tensor([t]), cache)
        out.append(lg.numpy())
    return out


@pytest.fixture(scope="module")
def ref():
    """Per model: JAX config and numpy weights, and every JAX result the
    tests compare with."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 128, (2, PREFILL_LEN))
    wrap = rng.integers(0, 128, WRAP_LEN)
    out = {"toks": toks, "wrap": wrap}
    for name, (arch, style, merged) in MODELS.items():
        jc, _ = _cfgs(arch, block_style=style)
        params = jm.init_params(jax.random.PRNGKey(0), jc)
        entry = {"source": jax.tree.map(np.asarray, params)}
        if merged:
            params, jc = jax_merge(params, jc, "qp")
        p = jax.tree.map(np.asarray, params)
        logits, _, _ = jm.forward_seq(params, jc, jnp.asarray(toks))
        lg, cache = jm.forward_prefill(params, jc, jnp.asarray(toks[:1]),
                                       jm.DensePrefillDest(CACHE_LEN))
        fields = {f: getattr(cache, f) for f in ("k", "v", "kv_pos",
                                                  "length")}
        fields.update(ssm=cache.ssm.ssm, conv=cache.ssm.conv)
        wcfg = jc.with_(sliding_window=WRAP_WINDOW) if jc.has_attention \
            else jc
        eng = JaxEngine(jc, params, JaxServeConfig(n_slots=3, max_len=64))
        entry.update(
            cfg=jc, params=p, logits=np.asarray(logits),
            prefill_logits=np.asarray(lg),
            cache={k: None if v is None else np.asarray(v)
                   for k, v in fields.items()},
            wrap=_jax_decode(params, wcfg, wrap[:WRAP_PREFILL],
                             wrap[WRAP_PREFILL:], 32),
            streams=[list(o) for o in eng.generate(GRID_PROMPTS,
                                                   max_new_tokens=6)])
        out[name] = entry
    # a parallel (Fig 3) hybrid: the full forward over prompt + fed tokens
    jc, _ = _cfgs("hymba-1.5b", parallel_block=True)
    params = jm.init_params(jax.random.PRNGKey(2), jc)
    logits, _, _ = jm.forward_seq(params, jc, jnp.asarray(wrap)[None])
    out["parallel"] = {"params": jax.tree.map(np.asarray, params),
                       "logits": np.asarray(logits)[0]}
    return out


def _port(ref, name):
    r = ref[name]
    arch = MODELS[name][0]
    _, tc = _cfgs(arch)
    return _port_cfg(tc, r["cfg"]), to_torch(r["params"], device="cpu")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_seq_matches_the_reference(ref, name):
    cfg, params = _port(ref, name)
    got, aux, kvs = tm.forward_seq(params, cfg, torch.as_tensor(ref["toks"]))
    _close_logits(got.numpy(), ref[name]["logits"], name)
    assert float(aux) == 0.0 and kvs is None


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefilled_cache_matches_the_reference(ref, name):
    """One pass over the prompt fills K/V (a window-sized ring, rolled
    into phase), positions and, per layer, the SSM state and conv tail:
    the reference's second SSM pass gives the same states."""
    cfg, params = _port(ref, name)
    lg, cache = tm.forward_prefill(params, cfg,
                                   torch.as_tensor(ref["toks"][:1]),
                                   tm.DensePrefillDest(CACHE_LEN))
    want = ref[name]["cache"]
    _close_logits(lg.numpy(), ref[name]["prefill_logits"], name)
    got = {"k": cache.k, "v": cache.v, "kv_pos": cache.kv_pos,
           "length": cache.length, "ssm": cache.ssm.ssm,
           "conv": cache.ssm.conv}
    for field, w in want.items():
        g = got[field]
        if w is None:
            assert g is None, field
            continue
        assert tuple(g.shape) == w.shape, field
        np.testing.assert_allclose(g.numpy(), w, atol=CACHE_TOL,
                                   rtol=CACHE_TOL, err_msg=field)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_decode_through_a_wrapping_window_matches_the_reference(ref, name):
    """A 4-token prompt, then 16 decode steps: the attention ring (window
    6) wraps twice while the SSM state and conv tail carry on."""
    cfg, params = _port(ref, name)
    if cfg.has_attention:
        cfg = cfg.with_(sliding_window=WRAP_WINDOW)
    got = _port_decode(params, cfg, ref["wrap"][:WRAP_PREFILL],
                       ref["wrap"][WRAP_PREFILL:], 32)
    for t, (g, w) in enumerate(zip(got, ref[name]["wrap"])):
        _close_logits(g, w, f"{name} step {t}")


def test_parallel_hybrid_decode_continues_the_full_forward(ref):
    """Parallel hybrid blocks: prefill's SSM states come from the one pass
    that computes the logits, so decode continues the reference's full
    forward exactly.  (The reference's second SSM pass,
    ``_prefill_ssm_states``, wires a parallel block as a serial one; its
    own decode leaves its full forward there, so the full forward is the
    oracle here.)"""
    _, tc = _cfgs("hymba-1.5b", parallel_block=True)
    params = to_torch(ref["parallel"]["params"], device="cpu")
    got = _port_decode(params, tc, ref["wrap"][:WRAP_PREFILL],
                       ref["wrap"][WRAP_PREFILL:-1], 32)
    want = ref["parallel"]["logits"][WRAP_PREFILL - 1:]
    for t, (g, w) in enumerate(zip(got, want)):
        _close_logits(g[0], w, f"position {WRAP_PREFILL - 1 + t}")


def test_hybrid_merge_matches_the_reference_leaf_by_leaf(ref):
    """Q removed, P kept, the SSM in_proj rotated into the stream basis;
    exactly L·d·ad weights go."""
    _, tc = _cfgs("hymba-1.5b", block_style="skipless")
    src = to_torch(ref["hybrid_merged"]["source"], device="cpu")
    merged, mcfg = merge_skipless(src, tc, "qp")
    assert (mcfg.block_style, mcfg.merged_variant) == ("skipless_merged", "qp")
    want = ref["hybrid_merged"]["params"]
    got = from_torch(merged)
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, w), (_, g) in zip(wl, gl):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
    assert "wq" not in merged["layers"]["attn"]
    assert merged["layers"]["attn"]["wp"] is src["layers"]["attn"]["wp"]
    assert removed_weight_count(src, merged) == \
        tc.n_layers * tc.d_model * tc.attn_dim


def test_merge_refuses_ssm_stacks_and_biased_hybrids(ref):
    _, mc = _cfgs("mamba2-2.7b", block_style="skipless")
    params = tm.init_params(mc, 0, device="cpu")
    with pytest.raises(ValueError, match="no Q/K/V/P"):
        merge_skipless(params, mc, "qp")
    _, hc = _cfgs("hymba-1.5b", block_style="skipless", qkv_bias=True)
    with pytest.raises(NotImplementedError, match="biases"):
        merge_skipless(tm.init_params(hc, 0, device="cpu"), hc, "qp")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_engine_streams_match_the_jax_engine(ref, name):
    """``tests/test_serving.py``'s grid: 3 slots, max_len 64, 5 prompts,
    6 new tokens, slots reused; unbucketed prompts (SSM state is not
    position-masked)."""
    cfg, params = _port(ref, name)
    eng = Engine(cfg, params, ServeConfig(n_slots=3, max_len=64),
                 impl="torch", device="cpu")
    assert eng.backend.key == ("dense", "generic", "torch")
    assert not eng.merged_fast_path and not eng.merged_prefill_fast_path
    assert not eng._bucketing
    assert eng._bucket_pad(np.arange(5, dtype=np.int32))[0].shape == (5,)
    outs = eng.generate(GRID_PROMPTS, max_new_tokens=6)
    assert [list(o) for o in outs] == ref[name]["streams"]
    assert eng.stats["peak_active"] == 3


def test_merged_hybrid_serves_the_source_streams(ref):
    assert ref["hybrid_merged"]["streams"] == ref["hybrid"]["streams"]


@pytest.mark.parametrize("cache", ["paged", "paged_q8"])
@pytest.mark.parametrize("name", ["hybrid", "mamba2"])
def test_paged_pools_refuse_stateful_stacks(ref, name, cache):
    cfg, params = _port(ref, name)
    with pytest.raises(ValueError, match="attention-only"):
        Engine(cfg, params, ServeConfig(n_slots=2, max_len=32, block_size=8),
               impl="torch", cache=cache, device="cpu")


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-2.7b"])
def test_configs_params_and_cache_spec_match_the_reference(arch):
    for reduced in (False, True):
        j, t = jcfg.get_config(arch), tcfg.get_config(arch)
        if reduced:
            j, t = jcfg.reduce_config(j), tcfg.reduce_config(t)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    jc, tc = _cfgs(arch)
    shapes = {str(p): tuple(x.shape) for p, x in
              jax.tree_util.tree_leaves_with_path(
                  jax.eval_shape(lambda: jm.init_params(
                      jax.random.PRNGKey(0), jc)))}
    tparams = from_torch(tm.init_params(tc, 0, device="cpu"))
    assert shapes == {str(p): x.shape for p, x in
                      jax.tree_util.tree_leaves_with_path(tparams)}
    js, ts = jm.cache_spec(jc, 3, 40), tm.cache_spec(tc, 3, 40)
    assert sorted(js) == sorted(ts)
    for k in js:
        sub = js[k] if k == "ssm" else {k: js[k]}
        tsub = ts[k] if k == "ssm" else {k: ts[k]}
        for f, (shape, dt) in sub.items():
            assert tuple(tsub[f][0]) == tuple(shape), (k, f)
            assert str(tsub[f][1]).split(".")[-1] == np.dtype(dt).name


@pytest.mark.parametrize("arch,merge", [("hymba-1.5b", True),
                                        ("mamba2-2.7b", False)])
def test_launcher_serves_the_new_archs(capsys, arch, merge):
    """``python -m repro_torch.launch.serve --arch hymba-1.5b
    --merged-from-skipless`` prints the skipless source's tokens;
    ``--arch mamba2-2.7b`` serves its standard stack."""
    from repro_torch.launch.serve import main

    args = ["--arch", arch, "--smoke", "--requests", "3", "--max-new", "5",
            "--device", "cpu"]
    if not merge:
        outs = main(args)
        assert len(outs) == 3 and all(len(o) == 5 for o in outs)
        return
    merged = [list(o) for o in main(args + ["--merged-from-skipless"])]
    source = [list(o) for o in main(args + ["--block-style", "skipless"])]
    assert merged == source
    assert "Q removal" in capsys.readouterr().out
