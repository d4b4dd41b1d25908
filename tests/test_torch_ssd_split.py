"""The SSD kernel's span plan (``kernels.ssd_scan.ssd_split``) and the
span decomposition it relies on, held without a card.

The CUDA scan cuts the sequence of each (batch, head) into ``n_span``
spans of whole 64-row tiles, the blocks of one thread-block cluster: each
scans its span from a zero state (local end state and decay sum), the
cluster combines those into each span's entering state
``Sin_k = sum_{j<k} exp(sum_{j<i<k} Asum_i) Sloc_j`` (as the chain
``Sin_{j+1} = exp(Asum_j) Sin_j + Sloc_j``), and each span then produces
its y rows from its entering state.  So the plan must fit the cluster
(``n_span <= MAX_SPAN``), use whole tiles, cover the sequence and launch
no empty span; and the decomposition, written here in plain PyTorch with
the kernel's 64-row tile duality, must give the sequential recurrence.

It is held against the JAX package's sequential oracle
(``repro.kernels.ref.ref_ssd``) and its Pallas kernel in interpret mode
(``ssd_scan_pallas``) on numpy-seeded float32 inputs.  Tolerance: 3e-5 of
the oracle's largest |value| (the card's gate for the kernel), for float32
sums taken in another order and decay sums over 64-row tiles and spans.
The Pallas kernel gets the largest chunk up to 80 rows that divides S: a
chunk that does not divide S makes it one chunk of all S rows, whose
float32 cumulative decay sums over 1,500-2,100 rows cancel to ~1e-4 of
the output's scale (against float64: the oracle 1e-7, this model 2e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan as tsk

TOL_REL = 3e-5
SPLIT_RANGES = [(1, 64), (65, 512), (513, 2048), (2049, 8192)]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-2.7b"])
@pytest.mark.parametrize("lo,hi", SPLIT_RANGES)
def test_ssd_split_plan_fits_the_cluster_and_covers_the_sequence(arch, lo,
                                                                  hi):
    H = get_config(arch).ssm_n_heads
    for S in range(lo, hi + 1):
        n_span, span = tsk.ssd_split(S)
        tiles = -(-S // tsk.TILE)
        assert 1 <= n_span <= tsk.MAX_SPAN, (S, n_span)
        assert span >= tsk.TILE and span % tsk.TILE == 0, (S, span)
        assert n_span * span >= S, (S, n_span, span)
        assert (n_span - 1) * span < S, (S, n_span, span)  # no empty span
        # one span per tile up to the cap, each the fewest whole tiles
        assert n_span == min(tiles, tsk.MAX_SPAN) or \
            span // tsk.TILE > 1, (S, n_span)
        assert span // tsk.TILE == -(-tiles // min(tiles, tsk.MAX_SPAN))
        # the grid grows from H blocks to n_span * H, at most 8 H
        assert H <= n_span * H <= tsk.MAX_SPAN * H


@pytest.mark.parametrize("S,plan", [
    (1, (1, 64)), (63, (1, 64)), (64, (1, 64)), (65, (2, 64)),
    (130, (3, 64)),  # the card test's ragged last tile
    (250, (4, 64)),  # Hymba's 250-token row: 200 blocks
    (256, (4, 64)), (512, (8, 64)),  # Mamba2's 512-token row: 640 blocks
    (600, (5, 128)), (2048, (8, 256)),
    (2100, (7, 320)),  # the last span 3 tiles, the last tile ragged
    (8192, (8, 1024)),
])
def test_ssd_split_plan_at_the_card_shapes(S, plan):
    assert tsk.ssd_split(S) == plan


def spans_scan(x, dt, a, Bm, Cm):
    """The kernel's decomposition in plain float32 PyTorch: zero-state
    spans of 64-row tiles, the cluster's combine, then y per span from its
    entering state.  Returns (y (B,S,H,P), final state (B,H,P,N))."""
    Bsz, S, H, P = x.shape
    L = tsk.TILE
    n_span, span = tsk.ssd_split(S)

    def tiles(s_beg, s_end):
        for s0 in range(s_beg, s_end, L):
            sl = slice(s0, min(s_end, s0 + L))
            ac = torch.cumsum(a[:, sl], dim=1)  # (B, l, H)
            yield sl, ac, ac[:, -1]

    def step(state, sl, ac, asum):
        """The tile's y from the entering state, and the state after it."""
        xc, Bc, Cc, dtc = x[:, sl], Bm[:, sl], Cm[:, sl], dt[:, sl]
        l = xc.shape[1]
        seg = ac[:, :, None] - ac[:, None]  # (B, l, l, H): Acum_i - Acum_j
        tril = torch.ones(l, l, dtype=torch.bool).tril()[None, :, :, None]
        m = torch.where(tril, torch.exp(seg), 0.0) * \
            torch.einsum("bihn,bjhn->bijh", Cc, Bc) * dtc[:, None]
        y = torch.einsum("bijh,bjhp->bihp", m, xc) + torch.exp(ac)[..., None] \
            * torch.einsum("bihn,bhpn->bihp", Cc, state)
        w = Bc * (dtc * torch.exp(asum[:, None] - ac))[..., None]
        state = state * torch.exp(asum)[..., None, None] + \
            torch.einsum("bjhp,bjhn->bhpn", xc, w)
        return y, state

    bounds = [(k * span, min(S, (k + 1) * span)) for k in range(n_span)]
    zero = x.new_zeros((Bsz, H, P, Bm.shape[-1]))
    sloc, asums = [], []
    for s_beg, s_end in bounds:  # pass (a): each span from a zero state
        st, tot = zero, torch.zeros_like(a[:, 0])
        for sl, ac, asum in tiles(s_beg, s_end):
            st = step(st, sl, ac, asum)[1]
            tot = tot + asum
        sloc.append(st)
        asums.append(tot)
    sin = [zero]  # the combine
    for st, tot in zip(sloc, asums):
        sin.append(sin[-1] * torch.exp(tot)[..., None, None] + st)
    ys = []
    for (s_beg, s_end), st in zip(bounds, sin):  # pass (c)
        for sl, ac, asum in tiles(s_beg, s_end):
            y, st = step(st, sl, ac, asum)
            ys.append(y)
    return torch.cat(ys, dim=1), sin[-1]


def _inputs(seed, B, S, H, P, N, a_scale):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5 + a_scale).astype(np.float32)
    Bm = rng.standard_normal((B, S, H, N), np.float32)
    Cm = rng.standard_normal((B, S, H, N), np.float32)
    return x, dt, (dt * A).astype(np.float32), Bm, Cm


# (B, S, H, P, N, a_scale): one span of one row, one full tile, a ragged
# last tile over three one-tile spans, spans of two tiles, the 8-span cap
# with a ragged last span, and a strongly negative a over a long sequence
GEOMETRIES = [
    (1, 1, 2, 16, 8, 0.0),
    (2, 64, 2, 16, 16, 0.0),
    (2, 130, 3, 16, 8, 0.0),
    (1, 600, 2, 32, 16, 0.0),
    (1, 2100, 2, 16, 8, 0.0),
    (1, 1500, 2, 16, 8, 2.5),
]


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=[f"S{g[1]}-a{g[5]}" for g in GEOMETRIES])
def test_span_decomposition_matches_the_jax_oracle_and_kernel(geometry):
    B, S, H, P, N, a_scale = geometry
    x, dt, a, Bm, Cm = _inputs(S + N, B, S, H, P, N, a_scale)
    y, fin = spans_scan(*(torch.from_numpy(t) for t in (x, dt, a, Bm, Cm)))
    jx = [jnp.asarray(t) for t in (x, dt, a, Bm, Cm)]
    chunk = max(d for d in range(1, 81) if S % d == 0)
    want = {"oracle": jref.ref_ssd(*jx),
            "pallas": ssd_scan_pallas(*jx, chunk=chunk, interpret=True)}
    for name, (wy, wf) in want.items():
        for got, ref in ((y, wy), (fin, wf)):
            ref = np.asarray(ref)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                got.numpy(), ref, rtol=0,
                atol=TOL_REL * float(np.abs(ref).max()), err_msg=name)
