"""The port's paged decode: ring addressing (``kernels.paging``), the plain
versions (``kernels.ref``), the kernel wrappers on CPU tensors, the
model-layout ops and the paged attention cores — held against the JAX
package on the same numpy-seeded inputs: the Pallas paged kernels in
interpret mode (``repro.kernels.ops``), their jnp oracles
(``repro.kernels.ref``) and the XLA cores (``repro.models.attention``).

Grids: those of ``tests/test_paged.py``'s kernel tests (generic and
merged, MHA / GQA / MQA, with and without a window), plus a wrapped ring
(q_position >= R * bs) and a table with -1 holes and an idle row.
Tolerances: float32 atol 1e-5; bfloat16 inputs (the same bf16 values on
both sides) compared in float32 at atol 2e-2, the JAX test's bf16
tolerance (both round the float32 result to bf16 once)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import paging as jpaging
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paging as tpaging
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (name, dtype, B, Hq, Hkv, D, NB, bs, MB, window): the grids of
# tests/test_paged.py's generic (:35-40) and merged (:63-67) kernel tests,
# then a wrapped ring (window 10, bs 4: R = 4 = MB) and a table with holes
GRID = [
    ("gqa", "float32", 3, 4, 2, 64, 16, 16, 4, 0),
    ("gqa-bf16", "bfloat16", 3, 4, 2, 64, 16, 16, 4, 0),
    ("mqa", "float32", 2, 8, 1, 32, 12, 8, 4, 0),
    ("mqa-bf16", "bfloat16", 2, 4, 1, 32, 12, 8, 4, 0),
    ("mha-window", "float32", 2, 4, 4, 16, 14, 8, 6, 11),
    ("ring-wrapped", "float32", 3, 4, 2, 16, 24, 4, 4, 10),
    ("ring-wrapped-bf16", "bfloat16", 3, 4, 2, 16, 24, 4, 4, 10),
    ("holes", "float32", 3, 4, 2, 16, 20, 4, 6, 0),
]
CASES = {g[0]: g for g in GRID}


def _tables(rng, B, MB, NB, bs, q_pos, ring, holes):
    """Distinct pages (a seeded permutation of the pool) for every table
    slot a query at ``q_pos`` has entered, -1 elsewhere; ``holes`` unmaps
    one entered slot per row past the first and idles the last row."""
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


@pytest.fixture(scope="module")
def jax_side():
    """Per grid case: the numpy inputs and the JAX outputs."""
    out = {}
    for name, dt, B, Hq, Hkv, D, NB, bs, MB, w in GRID:
        rng = np.random.default_rng(len(out))
        ring = jpaging.paged_ring_active(w, bs, MB)
        if ring:  # row 0 has not wrapped, the others have
            q_pos = [bs + 1, ring * bs + 3, 4 * ring * bs + 2][:B]
        else:
            q_pos = [int(x) for x in rng.integers(1, MB * bs - 1, size=B)]
        bt = _tables(rng, B, MB, NB, bs, q_pos, ring, name == "holes")
        qp = np.asarray(q_pos, np.int32)
        u, kp, vp = (rng.standard_normal(s).astype(np.float32) for s in
                     ((B, Hq * D), (NB, bs, Hkv, D), (NB, bs, Hkv, D)))
        jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
        ju, jkp, jvp = (jnp.asarray(x, jdt) for x in (u, kp, vp))
        jbt, jqp = jnp.asarray(bt), jnp.asarray(qp)
        G = Hq // Hkv
        f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
        res = dict(
            u=u, kp=kp, vp=vp, bt=bt, qp=qp, ring=ring,
            kernel=f32(jops.decode_attention_paged(
                ju.reshape(B, Hq, D), jkp, jvp, block_tables=jbt,
                q_position=jqp, sliding_window=w, interpret=True)),
            merged=f32(jops.decode_attention_paged_merged(
                ju, jkp, jvp, block_tables=jbt, q_position=jqp,
                n_kv_heads=Hkv, sliding_window=w, interpret=True)),
            oracle=f32(jref.ref_decode_attention_paged(
                ju.reshape(B, Hkv, G, D), jkp, jvp, jbt, jqp,
                sliding_window=w, ring_blocks=ring)),
            oracle_merged=f32(jref.ref_decode_attention_paged_merged(
                ju, jkp, jvp, jbt, jqp, n_kv_heads=Hkv, sliding_window=w,
                ring_blocks=ring)),
            positions=np.asarray(jattn.paged_kv_positions(
                jbt, bs, jqp, ring)),
            gather=np.asarray(jref.ref_paged_gather(jnp.asarray(kp), jbt)))
        if dt == "float32":
            res["core"] = f32(jattn.decode_attention_core_paged(
                ju.reshape(B, Hq, D), jkp, jvp, block_tables=jbt,
                q_position=jqp, sliding_window=w))
            res["core_merged"] = f32(jattn.decode_attention_core_paged_merged(
                ju, jkp, jvp, block_tables=jbt, q_position=jqp,
                n_kv_heads=Hkv, sliding_window=w))
        out[name] = res
    return out


def _inputs(c, dt):
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    u, kp, vp = (torch.from_numpy(c[n].copy()).to(tdt)
                 for n in ("u", "kp", "vp"))
    return u, kp, vp, torch.from_numpy(c["bt"].copy()), \
        torch.from_numpy(c["qp"].copy())


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dt])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_versions_and_wrappers_match_the_jax_kernels(jax_side, name):
    _, dt, B, Hq, Hkv, D, NB, bs, MB, w = CASES[name]
    c = jax_side[name]
    u, kp, vp, bt, qp = _inputs(c, dt)
    G, ring = Hq // Hkv, c["ring"]
    qg = u.reshape(B, Hkv, G, D)
    # the plain versions against the jnp oracles
    _close(tref.ref_decode_attention_paged(qg, kp, vp, bt, qp,
                                           sliding_window=w, ring_blocks=ring),
           c["oracle"], dt)
    _close(tref.ref_decode_attention_paged_merged(
        u.reshape(B, Hq, D), kp, vp, bt, qp, sliding_window=w,
        ring_blocks=ring).reshape(B, -1), c["oracle_merged"], dt)
    # the kernel wrappers on CPU tensors, and the model-layout ops, against
    # the Pallas kernels in interpret mode
    _close(dk.decode_attention_paged_bhsd(qg, kp, vp, bt, qp,
                                          sliding_window=w, ring_blocks=ring)
           .reshape(B, Hq, D), c["kernel"], dt)
    _close(dk.decode_attention_paged_merged_bsd(
        u.reshape(B, Hq, D), kp, vp, bt, qp, sliding_window=w,
        ring_blocks=ring).reshape(B, -1), c["merged"], dt)
    _close(tops.decode_attention_paged(u.reshape(B, Hq, D), kp, vp,
                                       block_tables=bt, q_position=qp,
                                       sliding_window=w), c["kernel"], dt)
    _close(tops.decode_attention_paged_merged(
        u, kp, vp, block_tables=bt, q_position=qp, n_kv_heads=Hkv,
        sliding_window=w), c["merged"], dt)


@pytest.mark.parametrize("name", [n for n, g in CASES.items()
                                  if g[1] == "float32"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_paged_cores_match_the_xla_cores(jax_side, name, impl):
    """impl="torch" is the port of the XLA core (a row with nothing to
    attend to averages the gathered view, as the XLA core does);
    impl="cuda" routes to the kernel wrappers, which on CPU tensors run
    the plain versions (such a row is exactly 0, as in the Pallas kernel):
    each route against its own reference, idle rows included."""
    _, dt, B, Hq, Hkv, D, NB, bs, MB, w = CASES[name]
    c = jax_side[name]
    u, kp, vp, bt, qp = _inputs(c, dt)
    got = tattn.decode_attention_core_paged(
        u.reshape(B, Hq, D), kp, vp, block_tables=bt, q_position=qp,
        sliding_window=w, impl=impl)
    _close(got, c["core"] if impl == "torch" else c["kernel"], dt)
    got = tattn.decode_attention_core_paged_merged(
        u, kp, vp, block_tables=bt, q_position=qp, n_kv_heads=Hkv,
        sliding_window=w, impl=impl)
    _close(got, c["core_merged"] if impl == "torch" else c["merged"], dt)


def test_idle_row_is_zero_on_the_kernel_route_only(jax_side):
    """The holes case idles its last row (table all -1): the kernel route
    and the Pallas kernel give exactly 0, the XLA core and its port the
    mean of the gathered page-0 rows."""
    _, dt, B, Hq, Hkv, D, NB, bs, MB, w = CASES["holes"]
    c = jax_side["holes"]
    u, kp, vp, bt, qp = _inputs(c, dt)
    out = dk.decode_attention_paged_merged_bsd(u.reshape(B, Hq, D), kp, vp,
                                               bt, qp)
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))
    assert not np.any(c["merged"][-1])
    assert np.any(c["core_merged"][-1])


@pytest.mark.parametrize("name", list(CASES))
def test_positions_and_gather_match(jax_side, name):
    _, dt, B, Hq, Hkv, D, NB, bs, MB, w = CASES[name]
    c = jax_side[name]
    bt, qp = torch.from_numpy(c["bt"].copy()), torch.from_numpy(c["qp"].copy())
    pos = tattn.paged_kv_positions(bt, bs, qp, c["ring"])
    np.testing.assert_array_equal(
        pos.numpy(), np.broadcast_to(c["positions"], pos.shape))
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(
        tref.ref_paged_gather(torch.from_numpy(c["kp"].copy()), bt).numpy(),
        c["gather"])


def test_ring_and_absolute_addressing_agree_before_a_wrap():
    """Ring positions equal absolute ones while lb < R, and differ after."""
    bs, R = 4, 4
    bt = torch.arange(R, dtype=torch.int32)[None].repeat(2, 1)
    qp = torch.tensor([R * bs - 1, R * bs], dtype=torch.int32)
    ring = tattn.paged_kv_positions(bt, bs, qp, R)
    absolute = tattn.paged_kv_positions(bt, bs, qp, 0)
    assert torch.equal(ring[0], absolute[0])
    assert not torch.equal(ring[1], absolute[1])
    assert int(ring[1, 0]) == R * bs  # slot 0 now holds block R


@pytest.mark.parametrize("window", [0, 1, 3, 7, 8, 9, 16, 17, 64, 4096])
@pytest.mark.parametrize("bs", [1, 4, 8, 16])
def test_paging_rules_match_the_jax_package(window, bs):
    assert tpaging.paged_ring_blocks(window, bs) == \
        jpaging.paged_ring_blocks(window, bs)
    for width in range(1, 12):
        assert tpaging.paged_ring_active(window, bs, width) == \
            jpaging.paged_ring_active(window, bs, width)


def test_paged_wrappers_take_the_plain_version_only_on_the_cpu():
    """On CPU tensors the paged wrappers run the plain version and count
    no launch; mixed devices raise rather than fall back."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    u, kp = torch.randn(2, 4, 64), torch.randn(6, 4, 2, 64)
    bt = torch.tensor([[0, 1, -1], [2, -1, -1]], dtype=torch.int32)
    qp = torch.tensor([5, 2], dtype=torch.int32)
    out = dk.decode_attention_paged_merged_bsd(u, kp, kp, bt, qp)
    assert out.shape == u.shape and torch.isfinite(out).all()
    assert sum(launch_counts().values()) == 0
    with pytest.raises(ValueError, match="several devices"):
        dk.decode_attention_paged_bhsd(u.reshape(2, 2, 2, 64), kp, kp, bt,
                                       qp.to("meta"))
