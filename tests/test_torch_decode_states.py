"""The decode kernel's partial-state mode, held on the CPU through its
plain version (``kernels.ref.ref_decode_states*``, what the operators
``torch.ops.repro_torch.<row>_states`` run on CPU tensors): for each of
the six decode rows (dense generic and merged, paged, paged merged,
int8 paged, int8 paged merged), the keys or pages are cut into 2 and 4 ranges,
as the ranks of a mesh whose model axis splits the cache's sequence or
the pool's pages hold them; each range's state comes from the wrappers'
partial-state twins (``kernels.ops.*_states``; a paged range gets its
pool slice and a table of the global width whose other pages are -1,
``placed.own_pages``), and the states, stacked and combined
(``placed.combine_softmax``), are held against the whole wrapper's plain
version and the JAX package's Pallas decode kernel in interpret mode on
the same numpy inputs.

The inputs hold the cases a split makes: a range with no key to attend
(its keys past every query, or none of a row's pages), an idle row
(nothing to attend anywhere: 0 on every side, never NaN), a sliding
window on the dense cache, a ring table (window 10, 4-token pages) and
int8 pages with their scales.  Tolerances: float32 within 1e-6 of the
largest output against the whole plain version (the combine reorders the
softmax sums), atol 1e-5 against the Pallas kernel; bfloat16 (the same
bf16 values on both sides) at atol 2e-2, ``test_torch_paged_split.py``'s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdk
from repro.kernels import paging as jpaging
from repro_torch.distribution.placed import combine_softmax, own_pages
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG

B, HQ, HKV, D, S, NB = 4, 4, 2, 64, 48, 24
DENSE_WINDOWS = {"full": 0, "window": 16}
TABLES = {"absolute": (8, 6, 0), "ring": (4, 4, 10)}  # bs, MB, window
ROWS = ("bhsd", "merged", "paged", "paged_merged", "paged_q8",
        "paged_q8_merged")


def _dense_inputs(variant, dtype):
    """Seeded dense inputs: rows 0-1 attend to positions 0..20 and 0..30
    (the last 12-key range of a 4-way cut lies past both: nothing to
    attend), row 2 to 0..47 with holes, row 3 is idle (every slot -1)."""
    rng = np.random.default_rng(list(DENSE_WINDOWS).index(variant))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[2, rng.random(S) < 0.2] = -1
    pos[3] = -1
    return dict(
        q=rng.standard_normal((B, HQ, D)).astype(np.float32),
        k=rng.standard_normal((B, S, HKV, D)).astype(np.float32),
        v=rng.standard_normal((B, S, HKV, D)).astype(np.float32),
        pos=pos, qp=np.asarray([20, 30, S - 1, 40], np.int32),
        w=DENSE_WINDOWS[variant], dtype=dtype)


def _paged_inputs(table, dtype):
    """Seeded paged inputs: distinct pages strided over the pool (7 is
    prime to NB) for every table slot rows 0-2 have entered, and an idle
    row 3 (its table all -1)."""
    bs, MB, w = TABLES[table]
    rng = np.random.default_rng(10 + list(TABLES).index(table))
    ring = jpaging.paged_ring_active(w, bs, MB)
    q_pos = [bs + 1, ring * bs + 3, 4 * ring * bs + 2] if ring else \
        [5, 2 * bs + 1, MB * bs - 2]
    bt = np.full((B, MB), -1, np.int32)
    perm = iter((7 * i + 3) % NB for i in range(NB))
    for b, qp in enumerate(q_pos):
        lb = qp // bs
        for j in range(MB):
            if (lb - (lb + ring - j) % ring >= 0) if ring else j <= lb:
                bt[b, j] = next(perm)
    return dict(
        q=rng.standard_normal((B, HQ, D)).astype(np.float32),
        k=rng.standard_normal((NB, bs, HKV, D)).astype(np.float32),
        v=rng.standard_normal((NB, bs, HKV, D)).astype(np.float32),
        k8=rng.integers(-127, 128, (NB, bs, HKV, D)).astype(np.int8),
        v8=rng.integers(-127, 128, (NB, bs, HKV, D)).astype(np.int8),
        ks=rng.uniform(0.001, 0.02, (NB, HKV)).astype(np.float32),
        vs=rng.uniform(0.001, 0.02, (NB, HKV)).astype(np.float32),
        bt=bt, qp=np.asarray(q_pos + [q_pos[-1]], np.int32), w=w,
        ring=ring, dtype=dtype)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _query(c, row):
    q = _t(c["q"], getattr(torch, c["dtype"]))
    return q.reshape(B, HQ * D) if row.endswith("merged") else q


def _kv(c, row, lo=0, hi=None):
    """The K/V operands of a row over keys (dense) or pages [lo, hi)."""
    tdt = getattr(torch, c["dtype"])
    if row.startswith("paged_q8"):
        return (_t(c["k8"][lo:hi]), _t(c["v8"][lo:hi])), dict(
            k_scale=_t(c["ks"][lo:hi]), v_scale=_t(c["vs"][lo:hi]))
    if row.startswith("paged"):
        return (_t(c["k"][lo:hi], tdt), _t(c["v"][lo:hi], tdt)), {}
    return (_t(c["k"][:, lo:hi], tdt), _t(c["v"][:, lo:hi], tdt)), dict(
        kv_positions=_t(c["pos"][:, lo:hi]))


def _call(c, row, states, lo=0, hi=None):
    """The whole wrapper (``states`` False) or its partial-state twin over
    the range [lo, hi) of the keys or pages."""
    kv, kw = _kv(c, row, lo, hi)
    kw.update(q_position=_t(c["qp"]), sliding_window=c["w"])
    if row.endswith("merged"):
        kw["n_kv_heads"] = HKV
    if row.startswith("paged"):
        bt = _t(c["bt"])
        kw["block_tables"] = bt if hi is None else \
            own_pages(bt, lo, hi - lo)
    name = {"bhsd": "decode_attention", "merged": "decode_attention_merged",
            "paged": "decode_attention_paged",
            "paged_merged": "decode_attention_paged_merged",
            "paged_q8": "decode_attention_paged_q8",
            "paged_q8_merged": "decode_attention_paged_q8_merged"}[row]
    fn = getattr(kops, name + ("_states" if states else ""))
    return fn(_query(c, row), *kv, **kw)


def _split(c, row, n_ranges):
    n = (NB if row.startswith("paged") else S) // n_ranges
    states = [_call(c, row, True, r * n, (r + 1) * n)
              for r in range(n_ranges)]
    m, l_, o = (torch.stack(x) for x in zip(*states))
    return combine_softmax(m, l_, o), states


def _pallas(c, row):
    """The JAX package's Pallas decode kernel, interpret mode."""
    jdt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
    q = jnp.asarray(c["q"], jdt)
    qp = jnp.asarray(c["qp"])[:, None]
    grouped = q.reshape(B, HKV, HQ // HKV, D)
    if not row.startswith("paged"):
        k, v = jnp.asarray(c["k"], jdt), jnp.asarray(c["v"], jdt)
        pos, w = jnp.asarray(c["pos"]), c["w"]
        if row == "merged":
            out = jdk.decode_attention_merged_bsd(
                q, k, v, pos, qp, sliding_window=w, block_k=16,
                interpret=True)
        else:
            out = jdk.decode_attention_bhsd(
                grouped, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
                pos, qp, sliding_window=w, block_k=16, interpret=True)
        return np.asarray(out, np.float32).reshape(B, HQ * D)
    if row.startswith("paged_q8"):
        pools = (jnp.asarray(c["k8"]), jnp.asarray(c["v8"]),
                 jnp.asarray(c["ks"]), jnp.asarray(c["vs"]))
    else:
        pools = (jnp.asarray(c["k"], jdt), jnp.asarray(c["v"], jdt))
    fn = getattr(jdk, f"decode_attention_{row}_" +
                 ("bsd" if row.endswith("merged") else "bhsd"))
    out = fn(q if row.endswith("merged") else grouped, *pools,
             jnp.asarray(c["bt"]), qp, sliding_window=c["w"],
             ring_blocks=c["ring"], interpret=True)
    return np.asarray(out, np.float32).reshape(B, HQ * D)


def _inputs(row, variant, dtype):
    if row.startswith("paged"):
        return _paged_inputs(variant, dtype)
    return _dense_inputs(variant, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_ranges", [2, 4])
@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("row", ROWS)
def test_partial_states_combine_to_the_whole_kernel(row, variant, n_ranges,
                                                    dtype):
    """``variant``: the dense rows' full cache or sliding window, the
    paged rows' absolute or ring table."""
    kinds = TABLES if row.startswith("paged") else DENSE_WINDOWS
    c = _inputs(row, sorted(kinds)[variant], dtype)
    got, states = _split(c, row, n_ranges)
    got = got.to(getattr(torch, dtype)).float().reshape(B, HQ * D).numpy()
    whole = _call(c, row, False).float().reshape(B, HQ * D).numpy()
    pallas = _pallas(c, row)
    assert np.isfinite(got).all()
    # the idle row is 0 on every side, and some range of a live row has
    # nothing to attend: its state is (NEG, 0, 0)
    assert (got[3] == 0).all() and (whole[3] == 0).all()
    assert not np.abs(pallas[3]).any()
    empty = [(m[:3] == NEG).all(-1) for m, _, _ in states]
    assert any(e.any() for e in empty), "a range with no keys"
    for m, l_, o in states:
        dead = m == NEG
        assert (l_[dead] == 0).all() and (o[dead] == 0).all()
    if dtype == "float32":
        assert np.abs(got - whole).max() <= 1e-6 * np.abs(whole).max()
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, whole, rtol=0, atol=2e-2)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=2e-2)


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("row", ROWS)
def test_the_states_of_the_whole_range_normalise_to_the_whole_kernel(row,
                                                                     variant):
    """One range: o / l is the whole wrapper's output where l > 0, and the
    operator's outputs are float32 (B, Hq) and (B, Hq, D).  ``variant``
    as in the split test."""
    kinds = TABLES if row.startswith("paged") else DENSE_WINDOWS
    c = _inputs(row, sorted(kinds)[variant], "float32")
    hi = NB if row.startswith("paged") else S
    m, l_, o = _call(c, row, True, 0, hi)
    assert (m.shape, l_.shape, o.shape) == ((B, HQ), (B, HQ), (B, HQ, D))
    assert {m.dtype, l_.dtype, o.dtype} == {torch.float32}
    whole = _call(c, row, False).reshape(B, HQ, D)
    live = l_ > 0
    assert live[:3].all() and not live[3].any()
    torch.testing.assert_close((o / l_[..., None])[live], whole[live],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("states", [False, True])
@pytest.mark.parametrize("row", [r for r in ROWS if r.endswith("merged")])
def test_merged_wrappers_name_their_kernel_on_a_head_mismatch(row, states):
    """A merged wrapper and its twin share one plumbing helper; given kv
    heads other than ``n_kv_heads`` both raise ValueError naming the
    kernel entry point they were to call."""
    c = _inputs(row, "absolute" if row.startswith("paged") else "full",
                "float32")
    kv, kw = _kv(c, row)
    kw.update(q_position=_t(c["qp"]), n_kv_heads=HKV + 1)
    if row.startswith("paged"):
        kw["block_tables"] = _t(c["bt"])
    name = "decode_attention_" + row
    with pytest.raises(ValueError, match=name + "_bsd"):
        getattr(kops, name + ("_states" if states else ""))(
            _query(c, row), *kv, **kw)


def test_combine_gives_zero_where_no_range_has_a_key():
    """The decode kernel's states of an idle row (m at the mask, l = 0,
    o = 0) on every range combine to 0, not 0/0; beside a range with a
    real score an empty one weighs nothing."""
    m = torch.tensor([[NEG, 0.5], [NEG, NEG]])
    l_ = torch.tensor([[0.0, 3.0], [0.0, 0.0]])
    o = torch.zeros(2, 2, 4)
    o[0, 1] = torch.arange(4.0)
    got = combine_softmax(m, l_, o)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[0], torch.zeros(4), rtol=0, atol=0)
    torch.testing.assert_close(got[1], torch.arange(4.0) / 3.0, rtol=0,
                               atol=0)
