"""The port's ``Engine`` against ``repro.serving.Engine``: on the same
weights (the JAX package's init and merges, copied by the bridge) and the
same prompts, the dense-cache greedy streams are identical — for the
unmerged source and its qp / kp / vp merges, with and without a sliding
window shorter than a prompt.  The grids are the dense rows of
``tests/test_backend_registry.py``'s ``setup`` / ``setup_windowed``."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import merge_skipless as jax_merge
from repro.models import init_params as jax_init_params
from repro.serving import Engine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import configs as tcfg
from repro_torch.convert import to_torch
from repro_torch.serving import Engine, ServeConfig, make_adapter

STYLES = ("generic", "qp", "kp", "vp")
GRIDS = {
    # name: (cfg overrides, seed, prompts, max_new, max_len)
    "full": (dict(), 0,
             [np.arange(5) % 128 + 3 * i for i in range(2)], 4, 48),
    "windowed": (dict(sliding_window=3), 1,
                 [np.arange(7) % 128, (np.arange(2) * 7 + 2) % 128], 5, 32),
}


@pytest.fixture(scope="module")
def grids():
    """Per grid and style: the port's config, the weights, and the JAX
    engine's greedy streams."""
    out = {}
    for name, (kw, seed, prompts, max_new, max_len) in GRIDS.items():
        base = dict(block_style="skipless", dtype="float32",
                    param_dtype="float32", n_kv_heads=4, **kw)
        jc = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(**base)
        tc = tcfg.reduce_config(tcfg.get_config("mistral-7b")).with_(**base)
        params = jax_init_params(jax.random.PRNGKey(seed), jc)
        params["embed"]["table"] = params["embed"]["table"] * 50.0
        models = {"generic": (jc, params)}
        for variant in ("qp", "kp", "vp"):
            mp, mc = jax_merge(params, jc, variant)
            models[variant] = (mc, mp)
        for style, (c, p) in models.items():
            eng = JaxEngine(c, p, JaxServeConfig(n_slots=2, max_len=max_len))
            want = [list(o) for o in eng.generate(prompts,
                                                  max_new_tokens=max_new)]
            port_cfg = tc.with_(block_style=c.block_style,
                                merged_variant=c.merged_variant)
            out[(name, style)] = (port_cfg, jax.tree.map(np.asarray, p),
                                  want)
        if name == "full":  # window-free, so the JAX engine buckets
            eng = JaxEngine(jc.with_(sliding_window=0), params,
                            JaxServeConfig(n_slots=1, max_len=max_len))
            out["bucketed"] = [list(o) for o in eng.generate(
                prompts, max_new_tokens=max_new)]
    return out


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_greedy_streams_match_the_jax_engine(grids, grid, style):
    cfg, params, want = grids[(grid, style)]
    _, _, prompts, max_new, max_len = GRIDS[grid]
    eng = Engine(cfg, to_torch(params, device="cpu"),
                 ServeConfig(n_slots=2, max_len=max_len), impl="torch",
                 device="cpu")
    assert eng.backend.key == ("dense", "merged" if style == "qp"
                               else "generic", "torch")
    assert eng.merged_fast_path == eng.merged_prefill_fast_path == \
        (style == "qp")
    outs = eng.generate(prompts, max_new_tokens=max_new)
    assert [list(o) for o in outs] == want
    assert all(o.new_tokens == max_new and o.prompt_len == len(p)
               for o, p in zip(outs, prompts))
    # all four styles of one grid are one model: same streams
    assert want == grids[(grid, "generic")][2]


def test_single_token_requests_finish_at_submit(grids):
    cfg, params, want = grids[("full", "qp")]
    eng = Engine(cfg, to_torch(params, device="cpu"),
                 ServeConfig(n_slots=2, max_len=48), impl="torch",
                 device="cpu")
    outs = eng.generate(GRIDS["full"][2], max_new_tokens=1)
    assert [list(o) for o in outs] == [w[:1] for w in want]
    assert eng.stats["n_steps"] == 0
    assert all(o.decode_tok_s is None for o in outs)
    assert not eng.active and sorted(eng.free_slots) == [0, 1]


def test_more_prompts_than_slots_reuse_freed_slots(grids):
    cfg, params, want = grids[("full", "generic")]
    prompts = GRIDS["full"][2] * 3  # 6 requests through 2 slots
    eng = Engine(cfg, to_torch(params, device="cpu"),
                 ServeConfig(n_slots=2, max_len=48), impl="torch",
                 device="cpu")
    outs = eng.generate(prompts, max_new_tokens=4)
    assert [list(o) for o in outs] == want * 3
    assert eng.stats["peak_active"] == 2


def test_bucketing_pads_only_window_free_configs(grids):
    cfg, params, _ = grids[("full", "generic")]
    p = to_torch(params, device="cpu")
    eng = Engine(cfg.with_(sliding_window=0), p,
                 ServeConfig(n_slots=1, max_len=48), impl="torch",
                 device="cpu")
    padded, n = eng._bucket_pad(np.arange(5, dtype=np.int32))
    assert (len(padded), n) == (8, 5)
    assert len(eng._bucket_pad(np.arange(9, dtype=np.int32))[0]) == 16
    # and bucketed prompts serve the same streams as the JAX engine's
    outs = eng.generate(GRIDS["full"][2], max_new_tokens=4)
    assert [list(o) for o in outs] == grids["bucketed"]
    wcfg, wparams, _ = grids[("windowed", "generic")]
    weng = Engine(wcfg, to_torch(wparams, device="cpu"),
                  ServeConfig(n_slots=1, max_len=32), impl="torch",
                  device="cpu")
    padded, n = weng._bucket_pad(np.arange(5, dtype=np.int32))
    assert (len(padded), n) == (5, 5)  # ragged length reaches prefill


def test_unported_options_and_bad_requests_raise(grids):
    cfg, params, _ = grids[("full", "generic")]
    p = to_torch(params, device="cpu")
    with pytest.raises(ValueError, match="'dense'"):
        make_adapter("paged_q4")
    eng = Engine(cfg.with_(sliding_window=0), p,
                 ServeConfig(n_slots=1, max_len=8), impl="torch",
                 device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate([np.arange(6)], max_new_tokens=4)
    with pytest.raises(ValueError, match="params lie on"):
        Engine(cfg, {"embed": {"table": torch.zeros(1, device="meta")}},
               ServeConfig(), impl="torch", device="cpu")


def test_launcher_serves_the_merge_token_identically(capsys):
    """``python -m repro_torch.launch.serve --merged-from-skipless`` and the
    same seed's skipless source print the same tokens."""
    from repro_torch.launch.serve import main

    args = ["--arch", "mistral-7b", "--smoke", "--requests", "3",
            "--max-new", "5", "--device", "cpu"]
    merged = [list(o) for o in main(args + ["--merged-from-skipless"])]
    source = [list(o) for o in main(args + ["--block-style", "skipless"])]
    assert merged == source
    assert "QP removal" in capsys.readouterr().out
