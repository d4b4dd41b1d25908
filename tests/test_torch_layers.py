"""The port's layer primitives and FFNs against ``repro.models.layers`` /
``repro.models.ffn`` on the same numpy-seeded inputs (float32, atol 1e-5:
both sides compute in float32; only the order of sums and the libm
differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ffn as jffn
from repro.models import layers as jl
from repro_torch.convert import to_torch
from repro_torch.models import ffn as tffn
from repro_torch.models import layers as tl

ATOL = 1e-5


@pytest.fixture(scope="module")
def data():
    """Inputs made once from a seed; the JAX side's reference outputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    stream = rng.standard_normal((2, 7, 64)).astype(np.float32)
    scale = rng.standard_normal((64,)).astype(np.float32)
    table = rng.standard_normal((256, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, (2, 7)).astype(np.int32)
    ffn = {t: jax.tree.map(np.asarray, jffn.init_ffn(
        jax.random.PRNGKey(i), 64, 96, 64, t))
        for i, t in enumerate(("swiglu", "geglu", "gelu_mlp"))}
    ref = {
        "rope": {(style, frac): np.asarray(jl.apply_rope(
            jnp.asarray(x), jnp.asarray(pos), style=style, theta=10_000.0,
            fraction=frac))
            for style in ("half", "chatglm2d", "none")
            for frac in (1.0, 0.5)},
        "rms": np.asarray(jl.apply_rmsnorm({"scale": jnp.asarray(scale)},
                                           jnp.asarray(stream))),
        "embed": np.asarray(jl.apply_embedding(
            {"table": jnp.asarray(table)}, jnp.asarray(tokens), jnp.float32)),
        "unembed": np.asarray(jl.apply_unembedding(
            {"table": jnp.asarray(table)}, jnp.asarray(stream))),
        "ffn": {t: np.asarray(jffn.apply_ffn(
            jax.tree.map(jnp.asarray, p), jnp.asarray(stream), t))
            for t, p in ffn.items()},
        "cos_sin": tuple(np.asarray(a) for a in jl.rope_cos_sin(
            jnp.arange(40, dtype=jnp.int32), 16, 500.0)),
        "init_shapes": {t: {k: tuple(v.shape) for k, v in jffn.init_ffn(
            jax.random.PRNGKey(0), 64, 96, 32, t).items()}
            for t in ("swiglu", "gelu_mlp")},
    }
    return dict(x=x, pos=pos, stream=stream, scale=scale, table=table,
                tokens=tokens, ffn=ffn, ref=ref)


@pytest.mark.parametrize("style", ["half", "chatglm2d", "none"])
@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_apply_rope_matches(data, style, frac):
    got = tl.apply_rope(torch.from_numpy(data["x"]),
                        torch.from_numpy(data["pos"]), style=style,
                        theta=10_000.0, fraction=frac)
    np.testing.assert_allclose(got.numpy(), data["ref"]["rope"][(style, frac)],
                               rtol=0, atol=ATOL)


def test_rope_frequencies_and_cos_sin_match(data):
    np.testing.assert_array_equal(tl.rope_frequencies(16, 500.0),
                                  jl.rope_frequencies(16, 500.0))
    jc, js = data["ref"]["cos_sin"]
    tc, ts = tl.rope_cos_sin(torch.arange(40, dtype=torch.int32), 16, 500.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=ATOL)


def test_rmsnorm_matches(data):
    got = tl.apply_rmsnorm({"scale": torch.from_numpy(data["scale"])},
                           torch.from_numpy(data["stream"]))
    np.testing.assert_allclose(got.numpy(), data["ref"]["rms"], rtol=0,
                               atol=ATOL)


def test_embedding_and_padded_unembedding_match(data):
    p = {"table": torch.from_numpy(data["table"])}
    got = tl.apply_embedding(p, torch.from_numpy(data["tokens"]).long(),
                             torch.float32)
    np.testing.assert_array_equal(got.numpy(), data["ref"]["embed"])
    logits = tl.apply_unembedding(p, torch.from_numpy(data["stream"]))
    assert logits.dtype == torch.float32 and logits.shape[-1] == 256
    np.testing.assert_allclose(logits.numpy(), data["ref"]["unembed"],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("ffn_type", ["swiglu", "geglu", "gelu_mlp"])
def test_ffn_matches(data, ffn_type):
    p = to_torch(data["ffn"][ffn_type], device="cpu")
    got = tffn.apply_ffn(p, torch.from_numpy(data["stream"]), ffn_type)
    np.testing.assert_allclose(got.numpy(), data["ref"]["ffn"][ffn_type],
                               rtol=0, atol=ATOL)
    # and the two halves compose to the whole
    h = tffn.ffn_hidden(p, torch.from_numpy(data["stream"]), ffn_type)
    assert h.shape[-1] == 96
    np.testing.assert_allclose(tffn.ffn_out(p, h, ffn_type).numpy(),
                               got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("ffn_type", ["swiglu", "gelu_mlp"])
def test_init_shapes_match_the_reference(data, ffn_type):
    g = torch.Generator().manual_seed(0)
    t = tffn.init_ffn(g, 64, 96, 32, ffn_type, torch.float32,
                      init_fn=tl.orthogonal_init)
    assert {k: tuple(v.shape) for k, v in t.items()} == \
        data["ref"]["init_shapes"][ffn_type]
    assert tl.init_embedding(g, 256, 64)["table"].shape == (256, 64)
    assert tl.init_rmsnorm(64)["scale"].shape == (64,)
    assert tl.dtype_of("bfloat16") == torch.bfloat16


@pytest.mark.parametrize("fan_in,fan_out", [(64, 64), (64, 16), (16, 96)])
def test_orthogonal_init_is_norm_preserving(fan_in, fan_out):
    w = tl.orthogonal_init(torch.Generator().manual_seed(3), fan_in, fan_out)
    assert w.shape == (fan_in, fan_out)
    small = min(fan_in, fan_out)
    gram = w.T @ w if fan_in >= fan_out else w @ w.T
    np.testing.assert_allclose(gram.numpy(), np.eye(small), atol=1e-5)
    d = tl.dense_init(torch.Generator().manual_seed(3), 256, 128)
    assert abs(float(d.std()) - 256 ** -0.5) < 0.01
