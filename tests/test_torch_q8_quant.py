"""The port's int8 quantization (``repro_torch.kernels.quant``) against the
JAX package's (``repro.kernels.quant``): on the same float32 inputs, made
from numpy seeds, the ints and the scales are EQUAL, bit for bit — pages,
sequences with a ``valid`` mask (bucket padding zeroed before the absmax),
the dequant, and decode appends that enter fresh pages (offset 0: the
stale scale is ignored), grow a page's scale (the stored ints are
rescaled), keep it, and drop unmapped rows (the JAX side's ``mode="drop"``
scatter; the port is handed only the mapped rows)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jq
from repro_torch.kernels import quant as tq


@pytest.fixture(scope="module")
def jax_side():
    """Per case: numpy inputs and the JAX results."""
    rng = np.random.default_rng(0)
    out = {}
    for name, shape, amp in (("mistral-pages", (2, 3, 16, 8, 128), 1.0),
                             ("tiny-pages", (4, 8, 2, 16), 1e-3),
                             ("loud-pages", (5, 4, 3, 8), 300.0)):
        x = (rng.standard_normal(shape) * amp).astype(np.float32)
        x[..., 0, :, :, :] = 0.0  # an all-zero block: scale floors at EPS
        ints, sc = jq.q8_quantize_pages(jnp.asarray(x))
        out[name] = (x, np.asarray(ints), np.asarray(sc))
    B, S, Hkv, D, bs = 2, 32, 2, 16, 8
    kv = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    kv[:, 20:] *= 40.0  # loud padding: must not reach a real block's scale
    valid = np.arange(S)[None, :] < np.array([[13], [32]])
    ints, sc = jq.q8_quantize_seq(jnp.asarray(kv), bs, jnp.asarray(valid))
    deq = jq.q8_dequant_seq(ints, sc, jnp.float32)
    out["seq"] = (kv, valid, bs, np.asarray(ints), np.asarray(sc),
                  np.asarray(deq))
    # decode appends: pool and scales after each call of a scripted run
    NB, bs, Hkv, D = 6, 4, 2, 16
    pool = np.zeros((NB, bs, Hkv, D), np.int8)
    scale = np.zeros((NB, Hkv), np.float32)
    steps = []
    jp, js = jnp.asarray(pool), jnp.asarray(scale)
    for t in range(10):
        # rows: page 1 from offset 0 (fresh), page 3 entered at t = 4, an
        # unmapped row (NB: dropped), and page 5 re-entered at offset 0
        # after holding stale content
        safe = np.array([1, 3 if t >= 4 else NB, NB, 5], np.int32)
        off = np.array([t % bs, (t - 4) % bs, 0, t % 2], np.int32)
        amp = np.array([(3, 5, 1, 0.5, 6, 2, 1, 7, 0.3, 1)[t], 1.0, 7.0,
                        3.0 - 0.2 * t], np.float32)
        tok = (rng.standard_normal((4, Hkv, D)) *
               amp[:, None, None]).astype(np.float32)
        jp, js = jq.q8_append_token(jp, js, jnp.asarray(tok),
                                    jnp.asarray(safe), jnp.asarray(off))
        steps.append((tok, safe, off, np.asarray(jp), np.asarray(js)))
    out["append"] = (pool, scale, steps)
    return out


@pytest.mark.parametrize("name", ["mistral-pages", "tiny-pages",
                                  "loud-pages"])
def test_quantize_pages_is_bit_equal(jax_side, name):
    x, ints, sc = jax_side[name]
    ti, ts = tq.q8_quantize_pages(torch.from_numpy(x))
    assert ti.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), ints)
    np.testing.assert_array_equal(ts.numpy(), sc)
    assert float(ts.min()) == np.float32(tq.Q8_EPS)  # zero block: EPS
    assert int(ti.abs().max()) == 127


def test_quantize_seq_masks_padding_and_dequantizes_bit_equal(jax_side):
    kv, valid, bs, ints, sc, deq = jax_side["seq"]
    ti, ts = tq.q8_quantize_seq(torch.from_numpy(kv), bs,
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(ti.numpy(), ints)
    np.testing.assert_array_equal(ts.numpy(), sc)
    np.testing.assert_array_equal(
        tq.q8_dequant_seq(ti, ts, torch.float32).numpy(), deq)
    # row 0 is valid up to 13: its positions >= 13 quantize to zero
    assert not ti[0, 13:].any() and ti[1, 20:].any()
    # bfloat16 dequant is the float32 dequant rounded once
    assert torch.equal(tq.q8_dequant_seq(ti, ts, torch.bfloat16),
                       torch.from_numpy(deq).to(torch.bfloat16))


def test_append_token_is_bit_equal_with_dropped_rows(jax_side):
    pool, scale, steps = jax_side["append"]
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scale.copy())
    NB = pool.shape[0]
    grew = kept = 0
    for t, (tok, safe, off, want_pool, want_scale) in enumerate(steps):
        mapped = safe < NB
        before = ts.clone()
        tq.q8_append_token(tp, ts, torch.from_numpy(tok[mapped]),
                           torch.from_numpy(safe[mapped]).long(),
                           torch.from_numpy(off[mapped]).long())
        np.testing.assert_array_equal(tp.numpy(), want_pool, f"step {t}")
        np.testing.assert_array_equal(ts.numpy(), want_scale, f"step {t}")
        grew += int((ts[1] > before[1]).any() and off[0] > 0)
        kept += int((ts[1] == before[1]).all() and off[0] > 0)
    assert grew and kept, "the run must both grow and keep a page's scale"


def test_fresh_page_ignores_its_stale_scale():
    """At offset 0 the page's old scale (and content) is ignored: the new
    scale is the token's own, even when the stale one is larger."""
    pool = torch.full((2, 4, 1, 8), 100, dtype=torch.int8)
    scale = torch.full((2, 1), 50.0)
    tok = torch.linspace(-1, 1, 8).reshape(1, 1, 8)
    tq.q8_append_token(pool, scale, tok, torch.tensor([1]),
                       torch.tensor([0]))
    assert torch.allclose(scale[1], torch.tensor([1.0 / 127]))
    assert int(pool[1, 0].abs().max()) == 127
    assert float(scale[0, 0]) == 50.0  # the other page is untouched
