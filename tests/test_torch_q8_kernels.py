"""The port's int8 (paged_q8) attention: the plain versions
(``kernels.ref``), the kernel wrappers on CPU tensors, the model-layout
ops and the q8 attention cores — held against the JAX package on the same
numpy-seeded inputs: the Pallas q8 kernels in interpret mode
(``repro.kernels.ops``), their jnp oracles (``repro.kernels.ref``) and the
XLA cores (``repro.models.attention``).

Decode grids: those of ``tests/test_torch_paged_kernels.py`` (MHA / GQA /
MQA, with and without a window, a wrapped ring, a table with -1 holes and
an idle row), over int8 pools with seeded per-(page, head) scales.  Flash
grid: causal merged prefill over int8 K*/V* with page scales (sg 8 and
16), with and without a window.  Tolerances: float32 atol 1e-5; bfloat16
queries (the same bf16 values on both sides) compared in float32 at atol
2e-2, the JAX test's bf16 tolerance (both round the float32 result to
bf16 once)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import paging as jpaging
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (name, dtype, B, Hq, Hkv, D, NB, bs, MB, window): as in
# tests/test_torch_paged_kernels.py
GRID = [
    ("gqa", "float32", 3, 4, 2, 64, 16, 16, 4, 0),
    ("gqa-bf16", "bfloat16", 3, 4, 2, 64, 16, 16, 4, 0),
    ("mqa", "float32", 2, 8, 1, 32, 12, 8, 4, 0),
    ("mha-window", "float32", 2, 4, 4, 16, 14, 8, 6, 11),
    ("ring-wrapped", "float32", 3, 4, 2, 16, 24, 4, 4, 10),
    ("ring-wrapped-bf16", "bfloat16", 3, 4, 2, 16, 24, 4, 4, 10),
    ("holes", "float32", 3, 4, 2, 16, 20, 4, 6, 0),
]
CASES = {g[0]: g for g in GRID}

# (name, dtype, B, Sq, Hq, Hkv, D, sg, window)
FLASH = [
    ("flash", "float32", 2, 32, 4, 2, 64, 8, 0),
    ("flash-window", "float32", 1, 48, 4, 1, 32, 16, 11),
    ("flash-bf16", "bfloat16", 2, 32, 4, 2, 64, 8, 0),
    ("flash-mha", "float32", 1, 64, 2, 2, 16, 16, 0),
]
FLASH_CASES = {g[0]: g for g in FLASH}


def _tables(rng, B, MB, NB, bs, q_pos, ring, holes):
    """Distinct pages for every table slot a query at ``q_pos`` has
    entered, -1 elsewhere; ``holes`` unmaps one entered slot per row past
    the first and idles the last row."""
    bt = np.full((B, MB), -1, np.int32)
    perm = iter(rng.permutation(NB).tolist())
    for b, qp in enumerate(q_pos):
        lb = qp // bs
        for j in range(MB):
            entered = lb - (lb + ring - j) % ring >= 0 if ring else j <= lb
            if entered:
                bt[b, j] = next(perm)
    if holes:
        for b in range(1, B - 1):
            bt[b, rng.integers(0, q_pos[b] // bs + 1)] = -1
        bt[B - 1] = -1
    return bt


def _q8(rng, shape):
    """Seeded int8 values over the full range."""
    ints = rng.integers(-127, 128, shape).astype(np.int8)
    return ints


def _jdt(dt):
    return jnp.bfloat16 if dt == "bfloat16" else jnp.float32


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """Per grid case: the numpy inputs and the JAX outputs."""
    out = {}
    for name, dt, B, Hq, Hkv, D, NB, bs, MB, w in GRID:
        rng = np.random.default_rng(100 + len(out))
        ring = jpaging.paged_ring_active(w, bs, MB)
        if ring:  # row 0 has not wrapped, the others have
            q_pos = [bs + 1, ring * bs + 3, 4 * ring * bs + 2][:B]
        else:
            q_pos = [int(x) for x in rng.integers(1, MB * bs - 1, size=B)]
        bt = _tables(rng, B, MB, NB, bs, q_pos, ring, name == "holes")
        qp = np.asarray(q_pos, np.int32)
        u = rng.standard_normal((B, Hq * D)).astype(np.float32)
        kp, vp = (_q8(rng, (NB, bs, Hkv, D)) for _ in range(2))
        ks, vs = (rng.uniform(0.002, 0.03, (NB, Hkv)).astype(np.float32)
                  for _ in range(2))
        ju = jnp.asarray(u, _jdt(dt))
        j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                 block_tables=jnp.asarray(bt), q_position=jnp.asarray(qp))
        jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
        G = Hq // Hkv
        res = dict(
            u=u, kp=kp, vp=vp, ks=ks, vs=vs, bt=bt, qp=qp, ring=ring,
            kernel=_f32(jops.decode_attention_paged_q8(
                ju.reshape(B, Hq, D), jkp, jvp, sliding_window=w,
                interpret=True, **j)),
            merged=_f32(jops.decode_attention_paged_q8_merged(
                ju, jkp, jvp, n_kv_heads=Hkv, sliding_window=w,
                interpret=True, **j)),
            oracle=_f32(jref.ref_decode_attention_paged_q8(
                ju.reshape(B, Hkv, G, D), jkp, jvp, j["k_scale"],
                j["v_scale"], j["block_tables"], j["q_position"],
                sliding_window=w, ring_blocks=ring)),
            oracle_merged=_f32(jref.ref_decode_attention_paged_q8_merged(
                ju, jkp, jvp, j["k_scale"], j["v_scale"], j["block_tables"],
                j["q_position"], n_kv_heads=Hkv, sliding_window=w,
                ring_blocks=ring)),
            dequant=_f32(jref.ref_q8_dequant_pool(jkp, j["k_scale"])))
        if dt == "float32":
            res["core"] = _f32(jattn.decode_attention_core_paged_q8(
                ju.reshape(B, Hq, D), jkp, jvp, j["k_scale"], j["v_scale"],
                block_tables=j["block_tables"], q_position=j["q_position"],
                sliding_window=w))
            res["core_merged"] = _f32(
                jattn.decode_attention_core_paged_q8_merged(
                    ju, jkp, jvp, j["k_scale"], j["v_scale"],
                    block_tables=j["block_tables"],
                    q_position=j["q_position"], n_kv_heads=Hkv,
                    sliding_window=w))
        out[name] = res
    for name, dt, B, S, Hq, Hkv, D, sg, w in FLASH:
        rng = np.random.default_rng(200 + len(out))
        u = rng.standard_normal((B, S, Hq * D)).astype(np.float32)
        k, v = (_q8(rng, (B, S, Hkv, D)) for _ in range(2))
        ks, vs = (rng.uniform(0.002, 0.03, (B, S // sg, Hkv))
                  .astype(np.float32) for _ in range(2))
        ju = jnp.asarray(u, _jdt(dt))
        jk, jv, jks, jvs = (jnp.asarray(x) for x in (k, v, ks, vs))
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
        res = dict(
            u=u, k=k, v=v, ks=ks, vs=vs,
            kernel=_f32(jops.flash_attention_merged_q8(
                ju, jk, jv, k_scale=jks, v_scale=jvs, n_kv_heads=Hkv,
                sliding_window=w, interpret=True)),
            oracle=_f32(jref.ref_flash_attention_merged_q8(
                ju, jk, jv, jks, jvs, n_kv_heads=Hkv, sliding_window=w)))
        if dt == "float32":
            res["core"] = _f32(jattn.attention_core_merged(
                ju, jk, jv, q_positions=pos, kv_positions=pos,
                n_kv_heads=Hkv, sliding_window=w, k_scale=jks, v_scale=jvs))
        out[name] = res
    return out


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x).copy())
    return t if dtype is None else t.to(dtype)


def _tdt(dt):
    return torch.bfloat16 if dt == "bfloat16" else torch.float32


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dt])


def _decode_inputs(c, dt):
    return (_t(c["u"], _tdt(dt)), _t(c["kp"]), _t(c["vp"]), _t(c["ks"]),
            _t(c["vs"]), _t(c["bt"]), _t(c["qp"]))


@pytest.mark.parametrize("name", list(CASES))
def test_q8_decode_plain_versions_and_wrappers_match_jax(jax_side, name):
    _, dt, B, Hq, Hkv, D, NB, bs, MB, w = CASES[name]
    c = jax_side[name]
    u, kp, vp, ks, vs, bt, qp = _decode_inputs(c, dt)
    G, ring = Hq // Hkv, c["ring"]
    qg = u.reshape(B, Hkv, G, D)
    np.testing.assert_array_equal(tref.ref_q8_dequant_pool(kp, ks).numpy(),
                                  c["dequant"])
    # the plain versions against the jnp oracles
    _close(tref.ref_decode_attention_paged_q8(
        qg, kp, vp, ks, vs, bt, qp, sliding_window=w, ring_blocks=ring)
        .reshape(B, Hq, D), c["oracle"].reshape(B, Hq, D), dt)
    _close(tref.ref_decode_attention_paged_q8_merged(
        u.reshape(B, Hq, D), kp, vp, ks, vs, bt, qp, sliding_window=w,
        ring_blocks=ring).reshape(B, -1), c["oracle_merged"], dt)
    # the kernel wrappers on CPU tensors, and the model-layout ops, against
    # the Pallas kernels in interpret mode
    out = dk.decode_attention_paged_q8_bhsd(qg, kp, vp, ks, vs, bt, qp,
                                            sliding_window=w,
                                            ring_blocks=ring)
    assert out.dtype == u.dtype
    _close(out.reshape(B, Hq, D), c["kernel"], dt)
    _close(dk.decode_attention_paged_q8_merged_bsd(
        u.reshape(B, Hq, D), kp, vp, ks, vs, bt, qp, sliding_window=w,
        ring_blocks=ring).reshape(B, -1), c["merged"], dt)
    _close(tops.decode_attention_paged_q8(
        u.reshape(B, Hq, D), kp, vp, k_scale=ks, v_scale=vs,
        block_tables=bt, q_position=qp, sliding_window=w), c["kernel"], dt)
    _close(tops.decode_attention_paged_q8_merged(
        u, kp, vp, k_scale=ks, v_scale=vs, block_tables=bt, q_position=qp,
        n_kv_heads=Hkv, sliding_window=w), c["merged"], dt)


@pytest.mark.parametrize("name", [n for n, g in CASES.items()
                                  if g[1] == "float32"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_q8_decode_cores_match_the_jax_cores(jax_side, name, impl):
    """impl="torch" is the port of the XLA core (dequantize the gathered
    view into q's dtype, defer to the dense core); impl="cuda" routes to
    the kernel wrappers, which on CPU tensors run the plain versions: each
    route against its own reference, idle rows included."""
    _, dt, B, Hq, Hkv, D, NB, bs, MB, w = CASES[name]
    c = jax_side[name]
    u, kp, vp, ks, vs, bt, qp = _decode_inputs(c, dt)
    got = tattn.decode_attention_core_paged_q8(
        u.reshape(B, Hq, D), kp, vp, ks, vs, block_tables=bt, q_position=qp,
        sliding_window=w, impl=impl)
    _close(got, c["core"] if impl == "torch" else c["kernel"], dt)
    got = tattn.decode_attention_core_paged_q8_merged(
        u, kp, vp, ks, vs, block_tables=bt, q_position=qp, n_kv_heads=Hkv,
        sliding_window=w, impl=impl)
    _close(got, c["core_merged"] if impl == "torch" else c["merged"], dt)


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_q8_flash_plain_version_and_wrappers_match_jax(jax_side, name):
    _, dt, B, S, Hq, Hkv, D, sg, w = FLASH_CASES[name]
    c = jax_side[name]
    u = _t(c["u"], _tdt(dt))
    k, v, ks, vs = (_t(c[n]) for n in ("k", "v", "ks", "vs"))
    uh = u.reshape(B, S, Hq, D)
    _close(tref.ref_flash_attention_merged_q8(uh, k, v, ks, vs,
                                              sliding_window=w)
           .reshape(B, S, -1), c["oracle"], dt)
    out = fk.flash_attention_merged_q8_bsd(uh, k, v, ks, vs, sliding_window=w)
    assert out.dtype == u.dtype
    _close(out.reshape(B, S, -1), c["kernel"], dt)
    _close(tops.flash_attention_merged_q8(
        u, k, v, k_scale=ks, v_scale=vs, n_kv_heads=Hkv, sliding_window=w),
        c["kernel"], dt)


@pytest.mark.parametrize("name", [n for n, g in FLASH_CASES.items()
                                  if g[1] == "float32"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_q8_merged_prefill_core_matches_the_jax_core(jax_side, name, impl):
    _, dt, B, S, Hq, Hkv, D, sg, w = FLASH_CASES[name]
    c = jax_side[name]
    u = _t(c["u"])
    k, v, ks, vs = (_t(c[n]) for n in ("k", "v", "ks", "vs"))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    got = tattn.attention_core_merged(
        u, k, v, q_positions=pos, kv_positions=pos, n_kv_heads=Hkv,
        sliding_window=w, impl=impl, cache_kind="paged_q8", k_scale=ks,
        v_scale=vs)
    _close(got, c["core"] if impl == "torch" else c["kernel"], dt)


def test_q8_table_rows_and_idle_row():
    """The four paged_q8 rows of the kernel table (generic prefill rides
    the fp flash kernel, as in the reference); a table row with nothing
    mapped is exactly 0 on the kernel route."""
    assert tops.attention_kernel("decode", "paged_q8", "generic") is \
        tops.decode_attention_paged_q8
    assert tops.attention_kernel("decode", "paged_q8", "merged") is \
        tops.decode_attention_paged_q8_merged
    assert tops.attention_kernel("prefill", "paged_q8", "generic") is \
        tops.flash_attention
    assert tops.attention_kernel("prefill", "paged_q8", "merged") is \
        tops.flash_attention_merged_q8
    assert sorted(k for k in tops.ATTENTION_KERNELS if k[1] == "paged_q8") \
        == sorted(k for k in jops.ATTENTION_KERNELS if k[1] == "paged_q8")
    u = torch.randn(2, 4, 16)
    kp = torch.randint(-127, 128, (6, 4, 2, 16), dtype=torch.int8)
    sc = torch.rand(6, 2)
    bt = torch.full((2, 3), -1, dtype=torch.int32)
    out = dk.decode_attention_paged_q8_merged_bsd(
        u, kp, kp, sc, sc, bt, torch.tensor([5, 2], dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))


def test_q8_wrappers_take_the_plain_version_only_on_the_cpu():
    """On CPU tensors the q8 wrappers run the plain version and count no
    launch; mixed devices raise rather than fall back."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    u = torch.randn(2, 4, 64)
    kp = torch.randint(-127, 128, (6, 4, 2, 64), dtype=torch.int8)
    sc = torch.rand(6, 2)
    bt = torch.tensor([[0, 1, -1], [2, -1, -1]], dtype=torch.int32)
    qp = torch.tensor([5, 2], dtype=torch.int32)
    out = dk.decode_attention_paged_q8_merged_bsd(u, kp, kp, sc, sc, bt, qp)
    assert out.shape == u.shape and torch.isfinite(out).all()
    k = torch.randint(-127, 128, (1, 8, 2, 64), dtype=torch.int8)
    ks = torch.rand(1, 2, 2)
    out = fk.flash_attention_merged_q8_bsd(torch.randn(1, 8, 4, 64), k, k,
                                           ks, ks)
    assert out.shape == (1, 8, 4, 64) and torch.isfinite(out).all()
    assert sum(launch_counts().values()) == 0
    with pytest.raises(ValueError, match="several devices"):
        dk.decode_attention_paged_q8_bhsd(u.reshape(2, 2, 2, 64), kp, kp,
                                          sc, sc.to("meta"), bt, qp)
    with pytest.raises(ValueError, match="several devices"):
        fk.flash_attention_merged_q8_bsd(torch.randn(1, 8, 4, 64), k, k, ks,
                                         ks.to("meta"))
