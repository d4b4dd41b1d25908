"""The port's Mamba2 SSD scan and mixer (``repro_torch.kernels.ssd_scan``,
``kernels.ops.ssd_scan``, ``kernels.ref``, ``models.mamba2``) against the
JAX package on the same numpy-seeded inputs and weights.

On the CPU the kernel wrapper runs its plain version (the chunked scan of
the reference's XLA path), so these tests hold the port's plain scan and
the wrapper's plumbing (a = dt·A, the chunk rule, the D skip, the cast,
the zero-state restriction) against JAX's Pallas kernel in interpret mode
and its sequential oracle.  Tolerances: the scan at the reference's own
test tolerances, 2e-4 (float32) and 6e-2 (bfloat16 inputs: both sides
read the same bf16 values, the outputs differ by summation order and by
the bf16 rounding of y); the mixer and its decode step at 1e-5 (float32,
O(1) outputs, the same products in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jm2
from repro_torch import configs as tcfg
from repro_torch.convert import to_torch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tsk
from repro_torch.models import mamba2 as tm2

# (dtype, B, S, H, P, N, chunk): tests/test_kernels.py's geometries
GEOMETRIES = [
    ("float32", 2, 64, 4, 16, 8, 16),
    ("bfloat16", 2, 64, 4, 16, 8, 16),
    ("float32", 1, 128, 2, 32, 16, 32),
    ("bfloat16", 1, 96, 3, 64, 128, 32),  # mamba2-2.7b head geometry
    ("float32", 2, 32, 1, 16, 8, 32),  # single chunk
]
CHUNKS = (8, 16, 32, 64)
MIXER_ARCHS = ("mamba2-2.7b", "hymba-1.5b")
TOL = {"float32": 2e-4, "bfloat16": 6e-2}
MIXER_TOL = 1e-5


def _scan_inputs(seed, B, S, H, P, N):
    """float32 numpy operands of the scan: x, dt (softplus of a normal),
    A (negative), Bm, Cm."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, S, H, N), np.float32)
    Cm = rng.standard_normal((B, S, H, N), np.float32)
    return x, dt, A, Bm, Cm


def _jax(t, dtype="float32"):
    return jnp.asarray(t).astype(dtype)


def _torch(t, dtype="float32"):
    return torch.from_numpy(np.array(t, copy=True)).to(getattr(torch, dtype))


def _mixer_cfgs(arch):
    return (jcfg.reduce_config(jcfg.get_config(arch)),
            tcfg.reduce_config(tcfg.get_config(arch)))


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX result the tests compare with, computed once."""
    out = {"scan": {}, "invariance": {}, "mixer": {}}
    for g in GEOMETRIES:
        dtype, B, S, H, P, N, chunk = g
        x, dt, A, Bm, Cm = _scan_inputs(3, B, S, H, P, N)
        y, fin = jops.ssd_scan(_jax(x, dtype), _jax(dt), _jax(A),
                               _jax(Bm, dtype), _jax(Cm, dtype), chunk=chunk,
                               interpret=True)
        dtf = jnp.asarray(dt)
        y_ref, fin_ref = jref.ref_ssd(
            _jax(x, dtype).astype(jnp.float32), dtf, dtf * jnp.asarray(A),
            _jax(Bm, dtype).astype(jnp.float32),
            _jax(Cm, dtype).astype(jnp.float32))
        out["scan"][g] = tuple(np.asarray(t, np.float32)
                               for t in (y, fin, y_ref, fin_ref))
    x, dt, A, Bm, Cm = _scan_inputs(7, 1, 64, 2, 8, 4)
    dtf = jnp.asarray(dt)
    out["invariance"] = tuple(np.asarray(t) for t in jref.ref_ssd(
        jnp.asarray(x), dtf, dtf * jnp.asarray(A), jnp.asarray(Bm),
        jnp.asarray(Cm)))
    for arch in MIXER_ARCHS:
        jc, _ = _mixer_cfgs(arch)
        params = jm2.init_mamba2(jax.random.PRNGKey(1), jc)
        rng = np.random.default_rng(5)
        u = rng.standard_normal((2, 19, jc.d_model), np.float32)
        tok = rng.standard_normal((2, jc.d_model), np.float32)
        y, st = jm2.apply_mamba2_seq(params, jnp.asarray(u[:, :11]), jc,
                                     return_state=True)
        y2, st2 = jm2.apply_mamba2_seq(params, jnp.asarray(u[:, 11:]), jc,
                                       init_state=st, return_state=True)
        step, st3 = jm2.apply_mamba2_step(params, jnp.asarray(tok), jc, st2)
        H, P, N = jc.ssm_n_heads, jc.ssm_head_dim, jc.ssm_state
        sx, sdt, sA, sB, sC = _scan_inputs(11, 2, 1, H, P, N)
        sstate = rng.standard_normal((2, H, P, N), np.float32)
        sy, snew = jm2.ssd_step(
            jnp.asarray(sx[:, 0]), jnp.asarray(sdt[:, 0]), jnp.asarray(sA),
            jnp.asarray(sB[:, 0]), jnp.asarray(sC[:, 0]),
            jnp.asarray(sstate), D=jnp.ones((H,), jnp.float32))
        out["mixer"][arch] = {
            "params": jax.tree.map(np.asarray, params), "u": u, "tok": tok,
            "seq": [np.asarray(t) for t in (y, st.ssm, st.conv)],
            "cont": [np.asarray(t) for t in (y2, st2.ssm, st2.conv)],
            "step": [np.asarray(t) for t in (step, st3.ssm, st3.conv)],
            "ssd_step_in": (sx[:, 0], sdt[:, 0], sA, sB[:, 0], sC[:, 0],
                            sstate),
            "ssd_step": (np.asarray(sy), np.asarray(snew))}
    return out


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=lambda g: "-".join(map(str, g)))
def test_plain_scan_matches_the_jax_kernel_and_oracle(jax_ref, geometry):
    dtype, B, S, H, P, N, chunk = geometry
    x, dt, A, Bm, Cm = _scan_inputs(3, B, S, H, P, N)
    y, fin = tops.ssd_scan(_torch(x, dtype), _torch(dt), _torch(A),
                           _torch(Bm, dtype), _torch(Cm, dtype), chunk=chunk)
    assert y.dtype == getattr(torch, dtype) and fin.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(fin.shape) == (B, H, P, N)
    j_y, j_fin, r_y, r_fin = jax_ref["scan"][geometry]
    tol = TOL[dtype]
    for got, want in ((y, j_y), (fin, j_fin), (y, r_y), (fin, r_fin)):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)
    # the port's sequential oracle is the reference's
    xt, Bt, Ct = (_torch(t, dtype).float() for t in (x, Bm, Cm))
    dtt = _torch(dt)
    s_y, s_fin = tref.ref_ssd(xt, dtt, dtt * _torch(A), Bt, Ct)
    np.testing.assert_allclose(s_y.numpy(), r_y, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(s_fin.numpy(), r_fin, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunking_is_only_a_tiling(jax_ref, chunk):
    """The chunk is a tiling of one recurrence: every chunk gives the
    sequential oracle's y and final state."""
    x, dt, A, Bm, Cm = (_torch(t) for t in _scan_inputs(7, 1, 64, 2, 8, 4))
    y, fin = tsk.ssd_chunk_scan(x, dt, dt * A, Bm, Cm, chunk=chunk)
    want_y, want_fin = jax_ref["invariance"]
    np.testing.assert_allclose(y.numpy(), want_y, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(fin.numpy(), want_fin, atol=2e-4, rtol=2e-4)


def test_continuation_from_a_state_and_the_zero_state_rule():
    """The plain route continues from ``init_state`` exactly as one scan
    over the whole sequence; the kernel route refuses a state (the TPU
    kernel starts from zeros), on the CPU too."""
    x, dt, A, Bm, Cm = (_torch(t) for t in _scan_inputs(9, 2, 48, 3, 16, 8))
    D = torch.linspace(0.5, 1.5, 3)
    y, fin = tm2.ssd_chunked(x, dt, A, Bm, Cm, chunk=16, D=D)
    y1, st = tm2.ssd_chunked(x[:, :20], dt[:, :20], A, Bm[:, :20],
                             Cm[:, :20], chunk=16, D=D)
    y2, fin2 = tm2.ssd_chunked(x[:, 20:], dt[:, 20:], A, Bm[:, 20:],
                               Cm[:, 20:], chunk=16, D=D, init_state=st)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(fin2, fin, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="zero state"):
        tm2.ssd_chunked(x, dt, A, Bm, Cm, chunk=16, init_state=st,
                        impl="cuda")
    with pytest.raises(ValueError, match="unknown ssd impl"):
        tm2.ssd_chunked(x, dt, A, Bm, Cm, chunk=16, impl="xla")


def test_kernel_route_on_the_cpu_is_the_plain_route_with_broadcast_groups():
    """``impl="cuda"`` on CPU tensors runs the wrapper's plain version: the
    same y and state as ``impl="torch"``, with B and C broadcast from one
    group as zero-stride views (what the kernel reads on the card)."""
    cfg = tcfg.reduce_config(tcfg.get_config("hymba-1.5b"))
    H, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    x, dt, A, _, _ = (_torch(t) for t in _scan_inputs(4, 2, 24, H, P, N))
    bg, cg = torch.randn(2, 24, 1, N), torch.randn(2, 24, 1, N)
    Bm, Cm = (tm2._broadcast_groups(t, cfg) for t in (bg, cg))
    assert Bm.stride(2) == 0 and tuple(Bm.shape) == (2, 24, H, N)
    D = torch.ones(H)
    got = tm2.ssd_chunked(x, dt, A, Bm, Cm, chunk=8, D=D, impl="cuda")
    want = tm2.ssd_chunked(x, dt, A, Bm.contiguous(), Cm.contiguous(),
                           chunk=8, D=D)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_ssd_step_matches_the_reference(jax_ref, arch):
    ref = jax_ref["mixer"][arch]
    sx, sdt, sA, sB, sC, sstate = (_torch(t) for t in ref["ssd_step_in"])
    y, new = tm2.ssd_step(sx, sdt, sA, sB, sC, sstate,
                          D=torch.ones(sA.shape[0]))
    for got, want in zip((y, new), ref["ssd_step"]):
        np.testing.assert_allclose(got.numpy(), want, atol=MIXER_TOL,
                                   rtol=MIXER_TOL)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_mixer_sequence_continuation_and_step_match_the_reference(jax_ref,
                                                                  arch):
    """``apply_mamba2_seq`` (y, final state, conv tail), its continuation
    from that state, and ``apply_mamba2_step`` after it, on the JAX
    package's weights."""
    ref = jax_ref["mixer"][arch]
    _, tc = _mixer_cfgs(arch)
    params = to_torch(ref["params"], device="cpu")
    u = torch.from_numpy(ref["u"])
    y, st = tm2.apply_mamba2_seq(params, u[:, :11], tc, return_state=True)
    y2, st2 = tm2.apply_mamba2_seq(params, u[:, 11:], tc, init_state=st,
                                   return_state=True)
    step, st3 = tm2.apply_mamba2_step(params, torch.from_numpy(ref["tok"]),
                                      tc, st2)
    for name, got in (("seq", (y, st.ssm, st.conv)),
                      ("cont", (y2, st2.ssm, st2.conv)),
                      ("step", (step, st3.ssm, st3.conv))):
        for g, w in zip(got, ref[name]):
            np.testing.assert_allclose(g.numpy(), w, atol=MIXER_TOL,
                                       rtol=MIXER_TOL, err_msg=name)
    assert tuple(st.conv.shape) == (2, tc.ssm_conv_width - 1,
                                    tm2.conv_channels(tc))
    fresh = tm2.init_ssm_state(tc, 2)
    assert fresh.ssm.shape == st.ssm.shape and not fresh.ssm.any()


def test_init_matches_the_reference_shapes_and_dt_bias():
    """The port's seeded init has the reference's leaves and shapes, and
    draws ``dt_bias`` from the same numpy stream (so softplus(dt_bias)
    spans [1e-3, 1e-1] identically); A_log, D and the norm are
    deterministic."""
    jc, tc = _mixer_cfgs("mamba2-2.7b")
    j = jax.tree.map(np.asarray, jm2.init_mamba2(jax.random.PRNGKey(0), jc))
    gen = torch.Generator().manual_seed(0)
    t = tm2.init_mamba2(gen, tc)
    assert sorted(j) == sorted(t)
    for k in ("A_log", "D", "dt_bias", "conv_bias"):
        np.testing.assert_allclose(t[k].numpy(), j[k], rtol=1e-6, err_msg=k)
    for k in ("in_proj", "conv_kernel", "out_proj"):
        assert tuple(t[k].shape) == j[k].shape, k
    np.testing.assert_array_equal(t["norm"]["scale"].numpy(),
                                  j["norm"]["scale"])
