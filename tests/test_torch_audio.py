"""The audio encoder (HuBERT-XLarge) in the port, held against
``repro.configs``, ``repro.models`` and ``repro.core.merge`` on the same
weights (the JAX package's init, copied by the bridge) and the same seeded
frame embeddings, at ``reduce_config`` shapes (2 layers, conv width 5):

* the config's fields equal the reference's, full and reduced;
* ``apply_conv_pos`` equals ``repro.models.layers.apply_conv_pos`` at even
  and odd widths (the padding is asymmetric at an even width; atol 1e-5,
  float32 on both sides);
* ``forward_seq`` logits of the encoder (non-causal), source and its qp,
  kp and vp merges, equal the JAX forward's (atol 1e-4 after dividing both
  by the larger of 1 and the reference's largest |logit|, as
  ``tests/test_torch_model.py``); the merges keep T_0 as ``input_proj``
  and the embedding table as it is, and the removed weights equal
  ``core.analysis.weight_table``'s;
* the bridge carries ``conv_pos`` and a merge's ``input_proj`` both
  ways;
* the non-causal flash wrapper at head dim 80 equals the JAX Pallas
  kernel in interpret mode on CPU tensors (atol 1e-5);
* an encoder has no cache, prefill, decode step or engine: each raises
  ValueError (the reference's engine asserts a decoder)."""
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
from repro.models import layers as jlayers
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch.convert import from_torch, to_torch
from repro_torch.core import (merge_skipless, removed_weight_count,
                              weight_table)
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers
from repro_torch.serving import Engine, ServeConfig

ARCH = "hubert-xlarge"
ATOL = 1e-4
VARIANTS = ("qp", "kp", "vp")


def _close_logits(got, want, msg=""):
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               rtol=0, atol=ATOL, err_msg=msg)


@pytest.fixture(scope="module")
def ref():
    """Per style ("source" and the three merges): the port's config and
    weights, the JAX forward logits on seeded frames, and the weights the
    JAX merge removed."""
    jc = jcfg.reduce_config(jcfg.get_config(ARCH)).with_(
        block_style="skipless", dtype="float32", param_dtype="float32")
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jc))
    frames = np.random.default_rng(0).standard_normal(
        (2, 13, jc.d_model)).astype(np.float32)
    models = {"source": (jc, p)}
    for v in VARIANTS:
        mp, mc = jax_merge(jax.tree.map(jnp.asarray, p), jc, v)
        models[v] = (mc, jax.tree.map(np.asarray, mp))
    out = {}
    for style, (c, w) in models.items():
        lg, _, _ = jm.forward_seq(jax.tree.map(jnp.asarray, w), c,
                                  jnp.asarray(frames))
        out[style] = dict(
            cfg=tcfg.ModelConfig(**{f.name: getattr(c, f.name)
                                    for f in dataclasses.fields(c)}),
            params=to_torch(w, device="cpu"), logits=np.asarray(lg),
            removed=jm.count_params(p) - jm.count_params(w))
    return frames, out


def test_config_fields_equal_the_reference():
    want, got = jcfg.get_config(ARCH), tcfg.get_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tcfg.reduce_config(got)) == \
        dataclasses.asdict(jcfg.reduce_config(want))
    assert ARCH in tcfg.list_archs()
    assert not got.causal and got.conv_pos_width == 128 and got.d_head == 80


@pytest.mark.parametrize("width", [4, 5, 128])
def test_conv_pos_matches_jax(width):
    rng = np.random.default_rng(width)
    dim, S = 12, 37
    kernel = rng.standard_normal((width, 1, dim)).astype(np.float32)
    bias = rng.standard_normal((dim,)).astype(np.float32)
    x = rng.standard_normal((2, S, dim)).astype(np.float32)
    want = jlayers.apply_conv_pos({"kernel": jnp.asarray(kernel),
                                   "bias": jnp.asarray(bias)}, jnp.asarray(x))
    got = tlayers.apply_conv_pos({"kernel": torch.as_tensor(kernel),
                                  "bias": torch.as_tensor(bias)},
                                 torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    p = tlayers.init_conv_pos(gen, dim, width)
    assert tuple(p["kernel"].shape) == (width, 1, dim)
    assert tuple(p["bias"].shape) == (dim,)


@pytest.mark.parametrize("style", ("source",) + VARIANTS)
def test_encoder_forward_matches_jax(ref, style):
    frames, out = ref
    r = out[style]
    got, _, _ = tm.forward_seq(r["params"], r["cfg"], torch.as_tensor(frames))
    _close_logits(got.numpy(), r["logits"], style)
    assert float(np.abs(r["logits"]).max()) > 1e-3  # not degenerate


@pytest.mark.parametrize("variant", VARIANTS)
def test_merges_match_the_reference(ref, variant):
    frames, out = ref
    src = out["source"]
    mp, mc = merge_skipless(src["params"], src["cfg"], variant)
    want = out[variant]
    assert mc.merged_variant == variant and not mc.causal
    assert set(mp) == set(want["params"])
    assert "input_proj" in mp and "conv_pos" in mp
    torch.testing.assert_close(mp["input_proj"],
                               src["params"]["layers"]["attn"]["w" +
                                                               variant[0]][0])
    assert mp["embed"]["table"] is src["params"]["embed"]["table"]
    assert removed_weight_count(src["params"], mp) == want["removed"] \
        == weight_table(src["cfg"])["removed"]
    got, _, _ = tm.forward_seq(mp, mc, torch.as_tensor(frames))
    _close_logits(got.numpy(), src["logits"], variant)


def test_bridge_carries_conv_pos_and_input_proj():
    jc = jcfg.reduce_config(jcfg.get_config(ARCH)).with_(
        block_style="skipless")
    p = jm.init_params(jax.random.PRNGKey(3), jc)
    mp, _ = jax_merge(p, jc, "kp")
    mp = jax.tree.map(np.asarray, mp)
    tp = to_torch(mp, device="cpu")
    assert tuple(tp["conv_pos"]["kernel"].shape) == (5, 1, jc.d_model)
    assert tuple(tp["input_proj"].shape) == (jc.d_model, jc.d_model)
    back = from_torch(tp)
    assert jax.tree.structure(back) == jax.tree.structure(mp)
    for a, b in zip(jax.tree.leaves(mp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_flash_wrapper_at_head_dim_80_matches_the_pallas_kernel():
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 19, 2, 80
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False, interpret=True)
    got = tops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_encoder_refuses_the_cache_paths(ref):
    _, out = ref
    r = out["qp"]
    c, p = r["cfg"], r["params"]
    frames = torch.zeros((1, 4, c.d_model))
    with pytest.raises(ValueError, match="encoder"):
        tm.init_cache(c, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        tm.forward_prefill(p, c, frames, tm.DensePrefillDest(8))
    cache = tm.init_cache(c.with_(causal=True), 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        tm.forward_step(p, c, frames[:, 0], cache)
    with pytest.raises(ValueError, match="decoder"):
        Engine(c, p, ServeConfig(n_slots=1, max_len=8), impl="torch",
               device="cpu")
