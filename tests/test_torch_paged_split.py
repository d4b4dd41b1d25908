"""The paged decode cores split over page ranges, as ranks hold them where
the mesh's model axis splits a pool (``models.attention``'s
``_paged_on_mesh``: the paged decode wrappers' partial-state twins,
``kernels.ops.DECODE_STATES``, and ``distribution.placed.combine_softmax``),
without processes: a seeded pool is cut into 2 and 4 ranges of pages, each
range's partial softmax state is computed over the table of GLOBAL width
whose other ranges' pages are -1 (``placed.own_pages``: ring positions
come from the table slot), and the states, combined, are held against the
port's whole-pool cores (``decode_attention_core_paged``, ``…_merged``,
``…_q8``, ``…_q8_merged``, impl "torch") and the JAX oracles
(``repro.kernels.ref``) on the same inputs.

Tables: an absolute one and a ring (window 10, 4-token pages: R = 4 table
slots) with wrapped rows; every row attends to something (an idle row's
output is discarded by the engine, and its average is over another view
on each side).  Tolerances: float32 within 1e-6 of the largest output
(the combine reorders the softmax sums) against the cores, atol 1e-5
against the oracles; bfloat16 queries and pools (the same bf16 values on
both sides) at atol 2e-2, ``tests/test_torch_paged_kernels.py``'s."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paging as jpaging
from repro.kernels import ref as jref
from repro_torch.distribution.placed import combine_softmax, own_pages
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as tattn

B, HQ, HKV, D, NB = 3, 4, 2, 16, 24
TABLES = {"absolute": (8, 6, 0), "ring": (4, 4, 10)}  # bs, MB, window
CORES = ("paged", "merged", "q8", "q8_merged")


def _inputs(table, dtype):
    """Seeded numpy inputs: the stream, fp and int8 pools with scales; a
    table of distinct pages for every slot a query has entered, and the
    query positions."""
    bs, MB, w = TABLES[table]
    rng = np.random.default_rng(list(TABLES).index(table))
    ring = jpaging.paged_ring_active(w, bs, MB)
    q_pos = [bs + 1, ring * bs + 3, 4 * ring * bs + 2] if ring else \
        [5, 2 * bs + 1, MB * bs - 2]
    bt = np.full((B, MB), -1, np.int32)
    # distinct pages strided over the pool (7 is prime to NB), so each
    # range of a cut holds some of them
    perm = iter((7 * i + 3) % NB for i in range(NB))
    for b, qp in enumerate(q_pos):
        lb = qp // bs
        for j in range(MB):
            if (lb - (lb + ring - j) % ring >= 0) if ring else j <= lb:
                bt[b, j] = next(perm)
    return dict(
        u=rng.standard_normal((B, HQ * D)).astype(np.float32),
        kp=rng.standard_normal((NB, bs, HKV, D)).astype(np.float32),
        vp=rng.standard_normal((NB, bs, HKV, D)).astype(np.float32),
        k8=rng.integers(-127, 128, (NB, bs, HKV, D)).astype(np.int8),
        v8=rng.integers(-127, 128, (NB, bs, HKV, D)).astype(np.int8),
        ks=rng.uniform(0.001, 0.02, (NB, HKV)).astype(np.float32),
        vs=rng.uniform(0.001, 0.02, (NB, HKV)).astype(np.float32),
        bt=bt, qp=np.asarray(q_pos, np.int32), bs=bs, w=w, ring=ring,
        dtype=dtype)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _pools(c, core):
    tdt = getattr(torch, c["dtype"])
    if core.startswith("q8"):
        return (_t(c["k8"]), _t(c["v8"])), (_t(c["ks"]), _t(c["vs"]))
    return (_t(c["kp"], tdt), _t(c["vp"], tdt)), None


def _whole(c, core):
    """The port's whole-pool core (impl "torch")."""
    tdt = getattr(torch, c["dtype"])
    u = _t(c["u"], tdt)
    (kp, vp), sc = _pools(c, core)
    kw = dict(block_tables=_t(c["bt"]), q_position=_t(c["qp"]),
              sliding_window=c["w"], impl="torch")
    merged = core.endswith("merged")
    q = u if merged else u.reshape(B, HQ, D)
    if merged:
        kw["n_kv_heads"] = HKV
    fn = {"paged": tattn.decode_attention_core_paged,
          "merged": tattn.decode_attention_core_paged_merged,
          "q8": tattn.decode_attention_core_paged_q8,
          "q8_merged": tattn.decode_attention_core_paged_q8_merged}[core]
    out = fn(q, kp, vp, *sc, **kw) if sc else fn(q, kp, vp, **kw)
    return out.float().reshape(B, HQ * D).numpy()


def _split(c, core, n_ranges):
    """Each range's partial state from its pages and the table of global
    width (the twin's plain version on these CPU tensors), stacked,
    combined."""
    tdt = getattr(torch, c["dtype"])
    u = _t(c["u"], tdt)
    (kp, vp), sc = _pools(c, core)
    merged = core.endswith("merged")
    twin = kops.DECODE_STATES[("paged_q8" if sc else "paged",
                               "merged" if merged else "generic")]
    n = NB // n_ranges
    states = []
    for r in range(n_ranges):
        lo = r * n
        kw = {} if sc is None else dict(k_scale=sc[0][lo:lo + n],
                                        v_scale=sc[1][lo:lo + n])
        if merged:
            kw["n_kv_heads"] = HKV
        states.append(twin(
            u if merged else u.reshape(B, HQ, D), kp[lo:lo + n],
            vp[lo:lo + n], block_tables=own_pages(_t(c["bt"]), lo, n),
            q_position=_t(c["qp"]), sliding_window=c["w"], **kw))
    out = combine_softmax(*(torch.stack(s) for s in zip(*states)))
    return out.to(tdt).float().reshape(B, HQ * D).numpy()


def _oracle(c, core):
    """The JAX package's jnp oracle on the same values."""
    jdt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
    u = jnp.asarray(c["u"], jdt)
    bt, qp = jnp.asarray(c["bt"]), jnp.asarray(c["qp"])
    kw = dict(sliding_window=c["w"], ring_blocks=c["ring"])
    if core.startswith("q8"):
        pools = (jnp.asarray(c["k8"]), jnp.asarray(c["v8"]),
                 jnp.asarray(c["ks"]), jnp.asarray(c["vs"]))
    else:
        pools = (jnp.asarray(c["kp"], jdt), jnp.asarray(c["vp"], jdt))
    if core.endswith("merged"):
        fn = jref.ref_decode_attention_paged_q8_merged if core == \
            "q8_merged" else jref.ref_decode_attention_paged_merged
        out = fn(u, *pools, bt, qp, n_kv_heads=HKV, **kw)
    else:
        fn = jref.ref_decode_attention_paged_q8 if core == "q8" else \
            jref.ref_decode_attention_paged
        out = fn(u.reshape(B, HKV, HQ // HKV, D), *pools, bt, qp, **kw)
    return np.asarray(out, np.float32).reshape(B, HQ * D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_ranges", [2, 4])
@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("core", CORES)
def test_split_pool_states_combine_to_the_whole_pool_cores(core, table,
                                                           n_ranges, dtype):
    c = _inputs(table, dtype)
    assert (c["bt"] >= 0).any(axis=1).all()
    got = _split(c, core, n_ranges)
    want, oracle = _whole(c, core), _oracle(c, core)
    assert np.isfinite(got).all()
    if dtype == "float32":
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-6 * scale
        np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
        np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-2)


def test_every_range_holds_some_of_the_pages_the_tables_map():
    """The cut really splits the rows' pages: each of the 4 ranges holds a
    page some row attends to, so the combine does work."""
    for table in TABLES:
        bt = _inputs(table, "float32")["bt"]
        held = {p // (NB // 4) for p in bt[bt >= 0].tolist()}
        assert held == {0, 1, 2, 3}, (table, held)


def test_combine_weighs_an_empty_range_zero():
    """A range where every score sits at the -1e30 mask (m = -1e30,
    p = 1 everywhere) adds nothing beside a range with a real score."""
    rng = np.random.default_rng(5)
    m = torch.tensor([[0.3], [tattn.NEG_INF]])
    l_ = torch.tensor([[2.0], [7.0]])
    o = torch.from_numpy(rng.standard_normal((2, 1, 4)).astype(np.float32))
    got = combine_softmax(m, l_, o)
    torch.testing.assert_close(got, o[0] / 2.0, rtol=0, atol=0)
