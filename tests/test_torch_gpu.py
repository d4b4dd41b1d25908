"""The port's CUDA kernels against their plain versions, on the card:
the attention kernels and the SSD scan, and the engines that run them.

Every test here carries the ``gpu`` marker and decides inside the test
whether a card is present (never at import: the suite runs under several
workers that must collect the same tests).  Without a card each test
skips; on the H100 run them with

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: float32 kernels sum in another order than the plain version
(both accumulate in float32), so 5e-5 absolute on O(1) outputs; bfloat16
outputs are rounded once from float32 on both sides, so they may differ by
about one bf16 ulp (2**-7 relative): two ulps at the reference's largest
magnitude, capped at 2e-2 for O(1) outputs.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch._tree import tree_map
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import (decode_attention as dk, flash_attention as fk,
                                 launch_counts, ref, reset_launch_counts)

pytestmark = pytest.mark.gpu


def _tol(want: torch.Tensor) -> float:
    if want.dtype == torch.float32:
        return 5e-5
    return min(2e-2, 2 * 2.0 ** -7 * float(want.float().abs().max()))


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu "
                    "tests/test_torch_gpu.py` on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ring_positions(rng, B, S, q_pos, hole_frac=0.1):
    """kv positions of a ring cache of S slots after writing 0..q_pos:
    slot s holds the latest position p = s (mod S) not beyond q_pos, -1 if
    none; a few extra slots are emptied."""
    s = np.arange(S)[None, :]
    qp = np.asarray(q_pos)[:, None]
    pos = s + S * ((qp - s) // S)
    pos = np.where(s <= qp, pos, -1)
    pos = np.where(rng.random((B, S)) < hole_frac, -1, pos)
    return pos.astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (8, 64), (12, 128),
                                 (16, 64), (16, 128)])
@pytest.mark.parametrize("window", [0, 37])
def test_decode_kernels_match_plain(dtype, G, D, window):
    dev = _cuda()
    rng = np.random.default_rng(G * 1000 + D + window)
    B, Hkv, S = 3, 2, 200
    q_pos = np.array([5, 199, 731])
    kvp = torch.from_numpy(_ring_positions(rng, B, S, q_pos)).to(dev)
    qp = torch.from_numpy(q_pos.astype(np.int32)).to(dev)
    u = torch.from_numpy(rng.standard_normal((B, Hkv * G, D),
                                             np.float32)).to(dev, dtype)
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D),
                                             np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D),
                                             np.float32)).to(dev, dtype)
    got = dk.decode_attention_merged_bsd(u, k, v, kvp, qp,
                                         sliding_window=window)
    want = ref.ref_decode_attention_merged(u, k, v, kvp, qp,
                                           sliding_window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))
    qg = u.reshape(B, Hkv, G, D)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    got = dk.decode_attention_bhsd(qg, kh, vh, kvp, qp, sliding_window=window)
    want = ref.ref_decode_attention(qg, kh, vh, kvp, qp,
                                    sliding_window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))


def test_decode_row_with_nothing_to_attend_is_exactly_zero():
    dev = _cuda()
    B, Hkv, G, S, D = 2, 2, 4, 70, 128
    u = torch.randn(B, Hkv * G, D, device=dev)
    k = torch.randn(B, S, Hkv, D, device=dev)
    kvp = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    qp = torch.tensor([3, 9], dtype=torch.int32, device=dev)
    out = dk.decode_attention_merged_bsd(u, k, k, kvp, qp)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("Sq", [1, 37, 64, 65, 130, 257, 1000])
@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("window", [0, 17, 64])
@pytest.mark.parametrize("sk_delta", [0, 29, -11])
def test_flash_kernels_match_plain(dtype, D, Sq, G, window, sk_delta):
    """Both layouts against the plain version: Sq crossing and straddling
    the 32- and 64-row q tiles and 64-key kv tiles, GQA groups of 1, 4 and
    5, windows cutting tiles mid-way, B = 2, and Sk longer or shorter than
    Sq (keys past the last query are never attended; queries past the last
    key attend all of them within the window)."""
    dev = _cuda()
    Sk = max(1, Sq + sk_delta)
    rng = np.random.default_rng(D + Sq + 7 * G + window + sk_delta)
    B, Hkv = 2, 2
    Hq = G * Hkv
    u = torch.from_numpy(rng.standard_normal((B, Sq, Hq, D),
                                             np.float32)).to(dev, dtype)
    k = torch.from_numpy(rng.standard_normal((B, Sk, Hkv, D),
                                             np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal((B, Sk, Hkv, D),
                                             np.float32)).to(dev, dtype)
    got = fk.flash_attention_merged_bsd(u, k, v, sliding_window=window)
    want = ref.ref_flash_attention_merged(u, k, v, sliding_window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (u, k, v))
    got = fk.flash_attention_bhsd(qh, kh, vh, sliding_window=window)
    want = ref.ref_attention(qh, kh, vh, sliding_window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("window", [0, 17, 64])
def test_flash_paired_heads_match_plain(D, window):
    """Enough blocks that the bf16 body pairs the two query heads of a kv
    group in one block (64 query heads over 16 kv heads, 5 q tiles, B 2),
    fp and q8 K/V, against the plain versions."""
    dev = _cuda()
    from repro_torch.kernels import quant
    rng = np.random.default_rng(D + window)
    B, S, Hq, Hkv = 2, 304, 64, 16
    dtype = torch.bfloat16
    u = torch.from_numpy(rng.standard_normal((B, S, Hq, D),
                                             np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D), np.float32))
            .to(dev) for _ in range(2))
    got = fk.flash_attention_merged_bsd(u, k.to(dtype), v.to(dtype),
                                        sliding_window=window)
    want = ref.ref_flash_attention_merged(u, k.to(dtype), v.to(dtype),
                                          sliding_window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))
    (k8, ks), (v8, vs) = (quant.q8_quantize_seq(x, 16) for x in (k, v))
    got = fk.flash_attention_merged_q8_bsd(u, k8, v8, ks, vs,
                                           sliding_window=window)
    want = ref.ref_flash_attention_merged_q8(u, k8, v8, ks, vs,
                                             sliding_window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_generic_flash_equals_contiguous(dtype):
    """``ops.flash_attention`` launches the generic kernel on the
    sequence-major views it is given (here q a head-major tensor seen
    sequence-major, k and v slices of one fused kv tensor: no view is
    contiguous) with their own strides: the same numbers as the
    head-major contiguous launch, counted under the same key."""
    from repro_torch.kernels import ops
    dev = _cuda()
    rng = np.random.default_rng(5)
    B, S, Hq, Hkv, D = 2, 130, 8, 2, 128
    q = torch.from_numpy(rng.standard_normal(
        (B, Hq, S, D), np.float32)).to(dev, dtype).transpose(1, 2)
    kv = torch.from_numpy(rng.standard_normal(
        (B, S, 2 * Hkv * D), np.float32)).to(dev, dtype)
    k = kv[..., :Hkv * D].unflatten(-1, (Hkv, D))
    v = kv[..., Hkv * D:].unflatten(-1, (Hkv, D))
    assert not any(t.is_contiguous() for t in (q, k, v))
    reset_launch_counts()
    got = ops.flash_attention(q, k, v, sliding_window=17)
    assert launch_counts()["flash_attention_bhsd"] == 1
    want = fk.flash_attention_bhsd(
        *(t.transpose(1, 2).contiguous() for t in (q, k, v)),
        sliding_window=17).transpose(1, 2)
    assert got.shape == (B, S, Hq, D)
    assert torch.equal(got, want)


def test_bf16_flash_rejects_head_dim_96():
    dev = _cuda()
    u = torch.zeros((1, 16, 8, 96), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((1, 16, 2, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fk.flash_attention_merged_bsd(u, k, k)
    with pytest.raises(ValueError, match="head dim"):
        fk.flash_attention_bhsd(u.transpose(1, 2).contiguous(),
                                k.transpose(1, 2).contiguous(),
                                k.transpose(1, 2).contiguous())


def test_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    u = torch.randn(2, 8, 128, device=dev)
    k = torch.randn(2, 16, 2, 128, device=dev)
    qp = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    kvp = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        dk.decode_attention_merged_bsd(u, k, k, kvp.long(), qp)
    with pytest.raises(ValueError, match="several devices"):
        dk.decode_attention_merged_bsd(u, k, k, kvp.cpu(), qp)
    with pytest.raises(ValueError, match="head dim"):
        k96 = k[..., :96].contiguous()
        fk.flash_attention_merged_bsd(u[:, None, :, :96].contiguous(), k96,
                                      k96)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fk.flash_attention_merged_bsd(u[:, None].half(), k.half(), k.half())


def test_engine_on_the_card_matches_the_cpu_engine():
    """A reduced skipless model (head dim 64, which the kernels take) and
    its qp merge serve the same greedy streams through the CUDA kernels as
    through the plain versions on the CPU, and the counters show which
    kernels each engine launched."""
    dev = _cuda()
    from repro_torch.core.merge import merge_skipless
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    cfg = reduce_config(get_config("mistral-7b")).with_(
        block_style="skipless", d_model=256, n_heads=4, n_kv_heads=2,
        d_head=64, sliding_window=24)
    params = init_params(cfg, seed=0, device="cpu")
    mparams, mcfg = merge_skipless(params, cfg, "qp")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 19, 40)]
    sc = ServeConfig(n_slots=2, max_len=64)
    names = {"generic": ("flash_attention_bhsd", "decode_attention_bhsd"),
             "merged": ("flash_attention_merged_bsd",
                        "decode_attention_merged_bsd")}
    for c, p, kind in ((cfg, params, "generic"), (mcfg, mparams, "merged")):
        cpu = Engine(c, p, sc, impl="torch", device="cpu").generate(
            prompts, max_new_tokens=6)
        reset_launch_counts()
        eng = Engine(c, tree_map(lambda t: t.to(dev), p), sc, impl="cuda",
                     device=dev)
        gpu = eng.generate(prompts, max_new_tokens=6)
        assert [list(o) for o in gpu] == [list(o) for o in cpu], kind
        flash, decode = names[kind]
        want = {k: 0 for k in launch_counts()}
        want[flash] = cfg.n_layers * len(prompts)
        want[decode] = cfg.n_layers * eng.stats["n_steps"]
        assert launch_counts() == want, kind


def _paged_case(rng, B, Hkv, G, D, NB, bs, MB, q_pos, ring, dtype, dev):
    """Pages from a seeded permutation for every table slot the queries
    entered (row 1's first block shares row 0's page, row 2 has a -1
    hole); pages no table maps, and rows of mapped pages past a query's
    position, are NaN — a kernel that loaded them would return NaN."""
    bt = np.full((B, MB), -1, np.int32)
    perm = iter(rng.permutation(NB).tolist())
    for b, qp in enumerate(q_pos):
        lb = qp // bs
        for j in range(MB):
            if (lb - (lb + ring - j) % ring >= 0) if ring else j <= lb:
                bt[b, j] = next(perm)
    bt[1, 0] = bt[0, 0]
    bt[2, rng.integers(0, MB)] = -1
    u = rng.standard_normal((B, Hkv * G, D), np.float32)
    kp, vp = (rng.standard_normal((NB, bs, Hkv, D), np.float32)
              for _ in range(2))
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    bt_t, qp_t = t(bt), t(np.asarray(q_pos, np.int32))
    pos = ref.ref_paged_positions(bt_t, bs, qp_t, ring).cpu().numpy()
    poisoned = []
    for pool in (kp, vp):
        bad = pool.copy()
        live = np.zeros((NB, bs), bool)
        for b in range(B):
            for j in range(MB):
                if bt[b, j] >= 0:
                    p = pos[b, j * bs:(j + 1) * bs]
                    live[bt[b, j]] |= (p >= 0) & (p <= q_pos[b])
        bad[~live] = np.nan
        pool[~live] = 0.0
        poisoned.append(t(bad).to(dtype))
    clean = [t(p).to(dtype) for p in (kp, vp)]
    return t(u).to(dtype), clean, poisoned, bt_t, qp_t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (8, 64), (12, 128),
                                 (16, 64), (16, 128)])
@pytest.mark.parametrize("window,bs,MB,q_pos", [
    (0, 16, 32, (15, 36, 264)),  # absolute, MB*bs = 512
    (37, 16, 32, (15, 99, 480)),  # absolute with a window
    (64, 16, 5, (37, 130, 1000)),  # ring R = 5, rows 1 and 2 wrapped
    (10, 4, 4, (5, 19, 66)),  # ring R = 4 of small pages
])
def test_paged_decode_kernels_match_plain(dtype, G, D, window, bs, MB,
                                          q_pos):
    """Both paged kernels against their plain versions on permuted,
    shared and holed tables, absolute and wrapped rings; unmapped pages
    and future rows are NaN in the kernels' pools, so agreement also
    shows that the kernels never load them."""
    dev = _cuda()
    from repro_torch.kernels.paging import paged_ring_active
    rng = np.random.default_rng(G * 100 + D + window)
    B, Hkv, NB = 3, 2, 140
    ring = paged_ring_active(window, bs, MB)
    u, (kp, vp), (kbad, vbad), bt, qp = _paged_case(
        rng, B, Hkv, G, D, NB, bs, MB, q_pos, ring, dtype, dev)
    got = dk.decode_attention_paged_merged_bsd(
        u, kbad, vbad, bt, qp, sliding_window=window, ring_blocks=ring)
    want = ref.ref_decode_attention_paged_merged(
        u, kp, vp, bt, qp, sliding_window=window, ring_blocks=ring)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))
    qg = u.reshape(B, Hkv, G, D)
    got = dk.decode_attention_paged_bhsd(qg, kbad, vbad, bt, qp,
                                         sliding_window=window,
                                         ring_blocks=ring)
    want = ref.ref_decode_attention_paged(qg, kp, vp, bt, qp,
                                          sliding_window=window,
                                          ring_blocks=ring)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))


def test_paged_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    u = torch.randn(2, 8, 128, device=dev)
    kp = torch.randn(6, 16, 2, 128, device=dev)
    bt = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    qp = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="ring_blocks"):
        dk.decode_attention_paged_merged_bsd(u, kp, kp, bt, qp, ring_blocks=2)
    with pytest.raises(ValueError, match="int32"):
        dk.decode_attention_paged_merged_bsd(u, kp, kp, bt.long(), qp)
    with pytest.raises(ValueError, match="pools"):
        dk.decode_attention_paged_bhsd(u.reshape(2, 4, 2, 128), kp, kp, bt,
                                       qp)
    # an idle row (table all -1) is exactly zero
    out = dk.decode_attention_paged_merged_bsd(u, kp, kp, bt - 1, qp)
    assert torch.equal(out, torch.zeros_like(out))


def test_paged_engine_on_the_card_matches_the_cpu_engine():
    """The paged engine through the CUDA kernels emits the CPU engine's
    streams, through a pool small enough to defer and preempt and a window
    that rings the table, and launches only the paged decode kernels."""
    dev = _cuda()
    from repro_torch.core.merge import merge_skipless
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    cfg = reduce_config(get_config("mistral-7b")).with_(
        block_style="skipless", d_model=256, n_heads=4, n_kv_heads=2,
        d_head=64, sliding_window=24)
    params = init_params(cfg, seed=0, device="cpu")
    mparams, mcfg = merge_skipless(params, cfg, "qp")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 19, 40)]
    sc = ServeConfig(n_slots=3, max_len=64, block_size=8, n_blocks=7)
    names = {"generic": ("flash_attention_bhsd", "decode_attention_paged_bhsd"),
             "merged": ("flash_attention_merged_bsd",
                        "decode_attention_paged_merged_bsd")}
    for c, p, kind in ((cfg, params, "generic"), (mcfg, mparams, "merged")):
        cpu = Engine(c, p, sc, impl="torch", cache="paged",
                     device="cpu").generate(prompts, max_new_tokens=12)
        reset_launch_counts()
        eng = Engine(c, tree_map(lambda t: t.to(dev), p), sc, impl="cuda",
                     cache="paged", device=dev)
        gpu = eng.generate(prompts, max_new_tokens=12)
        assert [list(o) for o in gpu] == [list(o) for o in cpu], kind
        assert eng.pm.ring and eng.stats["n_deferred"] and \
            eng.stats["n_preempted"], eng.stats
        flash, decode = names[kind]
        want = {k: 0 for k in launch_counts()}
        want[flash] = cfg.n_layers * (len(prompts) + eng.stats["n_preempted"])
        want[decode] = cfg.n_layers * eng.stats["n_steps"]
        assert launch_counts() == want, kind


# ---------------------------------------------------------------------------
# int8 (paged_q8) kernels
# ---------------------------------------------------------------------------

def _q8_pools(kp, vp, bt, dev):
    """Quantize the float pools page by page (``kernels.quant``): returns
    (k, v, k_scale, v_scale), and the two scales with NaN in the rows of
    every page no table entry maps (a kernel that read an unmapped page's
    scale would return NaN)."""
    from repro_torch.kernels import quant
    (k, ks), (v, vs) = (quant.q8_quantize_pages(torch.from_numpy(p).to(dev))
                        for p in (kp, vp))
    unmapped = torch.ones(kp.shape[0], dtype=torch.bool, device=dev)
    unmapped[bt[bt >= 0].long()] = False
    bad = [torch.where(unmapped[:, None], float("nan"), s) for s in (ks, vs)]
    return (k, v, ks, vs), bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (8, 64), (12, 128),
                                 (16, 64), (16, 128)])
@pytest.mark.parametrize("window,bs,MB,q_pos", [
    (0, 16, 32, (15, 36, 264)),  # absolute, MB*bs = 512
    (37, 16, 32, (15, 99, 480)),  # absolute with a window
    (64, 16, 5, (37, 130, 1000)),  # ring R = 5, rows 1 and 2 wrapped
    (10, 4, 4, (5, 19, 66)),  # ring R = 4 of small pages
])
def test_paged_q8_decode_kernels_match_plain(dtype, G, D, window, bs, MB,
                                             q_pos):
    """Both q8 paged kernels against their plain versions on permuted,
    shared and holed tables, absolute and wrapped rings, on int8 pools
    quantized from seeded pages; the scale rows of unmapped pages are NaN
    in the kernels' inputs, so agreement also shows the kernels never read
    them."""
    dev = _cuda()
    from repro_torch.kernels.paging import paged_ring_active
    rng = np.random.default_rng(G * 100 + D + window + 7)
    B, Hkv, NB = 3, 2, 140
    ring = paged_ring_active(window, bs, MB)
    u, _, _, bt, qp = _paged_case(rng, B, Hkv, G, D, NB, bs, MB, q_pos, ring,
                                  dtype, dev)
    kp, vp = (rng.standard_normal((NB, bs, Hkv, D), np.float32)
              for _ in range(2))
    (k8, v8, ks, vs), (kbad, vbad) = _q8_pools(kp, vp, bt, dev)
    kw = dict(sliding_window=window, ring_blocks=ring)
    got = dk.decode_attention_paged_q8_merged_bsd(u, k8, v8, kbad, vbad, bt,
                                                  qp, **kw)
    want = ref.ref_decode_attention_paged_q8_merged(u, k8, v8, ks, vs, bt,
                                                    qp, **kw)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))
    qg = u.reshape(B, Hkv, G, D)
    got = dk.decode_attention_paged_q8_bhsd(qg, k8, v8, kbad, vbad, bt, qp,
                                            **kw)
    want = ref.ref_decode_attention_paged_q8(qg, k8, v8, ks, vs, bt, qp,
                                             **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("S,sg", [(16, 16), (48, 8), (72, 8), (144, 16),
                                  (264, 8), (1008, 16)])
@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("window", [0, 17, 64])
def test_flash_q8_kernel_matches_plain(dtype, D, S, sg, G, window):
    dev = _cuda()
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import quant
    rng = np.random.default_rng(D + S + sg + 7 * G + window)
    B, Hkv = 2, 2
    Hq = G * Hkv
    u = torch.from_numpy(rng.standard_normal((B, S, Hq, D),
                                             np.float32)).to(dev, dtype)
    kv = [torch.from_numpy(rng.standard_normal((B, S, Hkv, D),
                                               np.float32)).to(dev)
          for _ in range(2)]
    (k8, ks), (v8, vs) = (quant.q8_quantize_seq(x, sg) for x in kv)
    got = fk.flash_attention_merged_q8_bsd(u, k8, v8, ks, vs,
                                           sliding_window=window)
    want = ref.ref_flash_attention_merged_q8(u, k8, v8, ks, vs,
                                             sliding_window=window)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))


@pytest.mark.parametrize("sg", [8, 16])
@pytest.mark.parametrize("window", [0, 17])
def test_flash_q8_never_reads_the_scale_of_an_unattended_page(sg, window):
    """Sk > Sq, causal: the pages wholly past the last query row are
    attended by no row.  Their scales are NaN here, and the bf16 body's
    output equals the plain version's with the true scales (a kernel
    that read them would turn its rows NaN).  The float32 FMA body, kept
    as it was, dequantizes every key of a loaded tile, so it is not held
    to this."""
    dev = _cuda()
    dtype = torch.bfloat16
    from repro_torch.kernels import quant
    rng = np.random.default_rng(sg + window)
    B, Sq, Sk, Hq, Hkv, D = 2, 70, 160, 8, 2, 128
    u = torch.from_numpy(rng.standard_normal((B, Sq, Hq, D),
                                             np.float32)).to(dev, dtype)
    kv = [torch.from_numpy(rng.standard_normal((B, Sk, Hkv, D),
                                               np.float32)).to(dev)
          for _ in range(2)]
    (k8, ks), (v8, vs) = (quant.q8_quantize_seq(x, sg) for x in kv)
    first_unread = -(-Sq // sg)  # pages from here hold keys >= Sq only
    ks_nan, vs_nan = ks.clone(), vs.clone()
    ks_nan[:, first_unread:] = float("nan")
    vs_nan[:, first_unread:] = float("nan")
    got = fk.flash_attention_merged_q8_bsd(u, k8, v8, ks_nan, vs_nan,
                                           sliding_window=window)
    want = ref.ref_flash_attention_merged_q8(u, k8, v8, ks, vs,
                                             sliding_window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))


def test_q8_quantize_on_the_card_equals_the_cpu():
    """Quantize-on-write is plain torch on every route: the card's ints
    and scales equal the CPU's on the same input (pages, a masked
    sequence, appends that enter fresh pages and grow scales)."""
    dev = _cuda()
    from repro_torch.kernels import quant
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 16, 8, 128), np.float32))
    for d in (x, x * 1e-3, x * 300):
        a, b = quant.q8_quantize_pages(d), quant.q8_quantize_pages(d.to(dev))
        assert torch.equal(a[0], b[0].cpu()) and torch.equal(a[1],
                                                              b[1].cpu())
    pool = torch.zeros((6, 16, 8, 128), dtype=torch.int8)
    scale = torch.zeros((6, 8))
    gpool, gscale = pool.to(dev), scale.to(dev)
    for t in range(20):
        tok = torch.from_numpy(rng.standard_normal((2, 8, 128), np.float32)
                               * (1 + t % 5))
        page = torch.tensor([1, 4 + t // 16])
        off = torch.tensor([t % 16, t % 16])
        quant.q8_append_token(pool, scale, tok, page, off)
        quant.q8_append_token(gpool, gscale, tok.to(dev), page.to(dev),
                              off.to(dev))
        assert torch.equal(pool, gpool.cpu()) and torch.equal(scale,
                                                              gscale.cpu())


def test_q8_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    from repro_torch.kernels import flash_attention as fk
    u = torch.randn(2, 8, 128, device=dev)
    k8 = torch.zeros((6, 16, 2, 128), dtype=torch.int8, device=dev)
    sc = torch.ones((6, 2), device=dev)
    bt = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    qp = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int8"):
        dk.decode_attention_paged_q8_merged_bsd(u, k8.float(), k8.float(),
                                                sc, sc, bt, qp)
    with pytest.raises(ValueError, match="int8"):
        dk.decode_attention_paged_q8_merged_bsd(u, k8, k8, sc.half(),
                                                sc.half(), bt, qp)
    with pytest.raises(ValueError, match="scales"):
        dk.decode_attention_paged_q8_merged_bsd(u, k8, k8, sc[:5], sc[:5],
                                                bt, qp)
    ks = torch.ones((1, 3, 2), device=dev)
    k = torch.zeros((1, 40, 2, 128), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="sg"):  # 3 pages do not tile 40
        fk.flash_attention_merged_q8_bsd(u[:1, None].expand(1, 40, 8, 128)
                                         .contiguous(), k, k, ks, ks)
    # an idle row (table all -1) is exactly zero
    out = dk.decode_attention_paged_q8_merged_bsd(u, k8, k8, sc, sc, bt - 1,
                                                  qp)
    assert torch.equal(out, torch.zeros_like(out))


def test_paged_q8_engine_on_the_card_matches_the_cpu_engine():
    """The int8 paged engine through the CUDA kernels emits the CPU
    engine's streams through a pool small enough to defer and preempt and
    a window that rings the table, and launches only the q8 kernels (the
    fp flash kernel for the source model's prefill)."""
    dev = _cuda()
    from repro_torch.core.merge import merge_skipless
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    cfg = reduce_config(get_config("mistral-7b")).with_(
        block_style="skipless", d_model=256, n_heads=4, n_kv_heads=2,
        d_head=64, sliding_window=24)
    params = init_params(cfg, seed=0, device="cpu")
    mparams, mcfg = merge_skipless(params, cfg, "qp")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 19, 40)]
    sc = ServeConfig(n_slots=3, max_len=64, block_size=8, n_blocks=7)
    names = {"generic": ("flash_attention_bhsd",
                         "decode_attention_paged_q8_bhsd"),
             "merged": ("flash_attention_merged_q8_bsd",
                        "decode_attention_paged_q8_merged_bsd")}
    for c, p, kind in ((cfg, params, "generic"), (mcfg, mparams, "merged")):
        cpu = Engine(c, p, sc, impl="torch", cache="paged_q8",
                     device="cpu").generate(prompts, max_new_tokens=12)
        reset_launch_counts()
        eng = Engine(c, tree_map(lambda t: t.to(dev), p), sc, impl="cuda",
                     cache="paged_q8", device=dev)
        gpu = eng.generate(prompts, max_new_tokens=12)
        assert [list(o) for o in gpu] == [list(o) for o in cpu], kind
        assert eng.pm.ring and eng.stats["n_deferred"] and \
            eng.stats["n_preempted"], eng.stats
        flash, decode = names[kind]
        want = {k: 0 for k in launch_counts()}
        want[flash] = cfg.n_layers * (len(prompts) + eng.stats["n_preempted"])
        want[decode] = cfg.n_layers * eng.stats["n_steps"]
        assert launch_counts() == want, kind


# ---------------------------------------------------------------------------
# the SSD scan (Mamba2 / Hymba prefill)
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, B, S, H, P, N, dtype, dev):
    x = torch.from_numpy(rng.standard_normal((B, S, H, P),
                                             np.float32)).to(dev, dtype)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H), np.float32)).to(dev))
    A = -torch.exp(0.5 * torch.from_numpy(
        rng.standard_normal(H, np.float32)).to(dev))
    bm, cm = (torch.from_numpy(rng.standard_normal(
        (B, S, 1, N), np.float32)).to(dev, dtype).expand(B, S, H, N)
        for _ in range(2))
    return x, dt, dt * A, bm, cm


def _ssd_check(args):
    """The kernel's y and final state against ``ref_ssd`` within 3e-5 of
    the oracle's largest |value| (float32 outputs on both sides; sums in
    another order)."""
    from repro_torch.kernels import ssd_scan as sk

    y, fin = sk.ssd_chunk_scan(*args, chunk=256)
    want_y, want_fin = ref.ref_ssd(*args)
    for got, want in ((y, want_y), (fin, want_fin)):
        assert got.dtype == torch.float32
        assert torch.isfinite(got).all()
        torch.testing.assert_close(
            got, want, rtol=0, atol=3e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,P,N", [(50, 64, 16), (80, 64, 128), (4, 16, 8)])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 130, 512, 2100, 8192])
def test_ssd_kernel_matches_the_sequential_oracle(dtype, H, P, N, S):
    """Hymba-1.5B's and Mamba2-2.7B's scan geometries (and the reduced
    one), B and C broadcast from one group by a zero head stride: one
    span of one row, of a tile less one row and of a full tile, two spans
    (the second of one row), three with a ragged last tile, the full
    cluster of eight one-tile spans (512), seven spans of five tiles with a
    ragged last span (2100) and eight of sixteen (8192)."""
    dev = _cuda()
    rng = np.random.default_rng(H + N + S)
    _ssd_check(_ssd_inputs(rng, 2, S, H, P, N, dtype, dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [65, 600])
def test_ssd_kernel_takes_per_head_and_strided_b_and_c(dtype, S):
    """B and C with their own value per head (a nonzero head stride), and
    x, B and C as views into one (B, S, H*P + 2 H*N) tensor, as the model's
    split of the conv output hands them over (row strides of the whole
    row)."""
    dev = _cuda()
    rng = np.random.default_rng(S)
    Bsz, H, P, N = 2, 6, 64, 32
    x, dt, a, _, _ = _ssd_inputs(rng, Bsz, S, H, P, N, dtype, dev)
    bm, cm = (torch.from_numpy(rng.standard_normal(
        (Bsz, S, H, N), np.float32)).to(dev, dtype) for _ in range(2))
    _ssd_check((x, dt, a, bm, cm))
    whole = torch.from_numpy(rng.standard_normal(
        (Bsz, S, H * (P + 2 * N)), np.float32)).to(dev, dtype)
    xv, bv, cv = torch.split(whole, [H * P, H * N, H * N], dim=-1)
    xv, bv, cv = (t.reshape(Bsz, S, H, -1) for t in (xv, bv, cv))
    assert xv.stride(1) == whole.shape[-1] and not bv.is_contiguous()
    _ssd_check((xv, dt, a, bv, cv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_strong_decay_over_a_long_sequence(dtype):
    """A strongly negative a (A = -exp(normal + 3), |a| up to ~100 a row)
    over 4096 rows: every decay is exp of a difference <= 0, so nothing
    overflows, and the spans' states still pass on what survives."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    x, dt, _, bm, cm = _ssd_inputs(rng, 1, 4096, 8, 64, 128, dtype, dev)
    A = -torch.exp(torch.from_numpy(rng.standard_normal(
        8, np.float32)).to(dev) + 3.0)
    _ssd_check((x, dt, dt * A, bm, cm))


def test_ssd_split_of_the_kernel_is_the_python_plan():
    """The CUDA launcher's own cut of the sequence (reported by its
    occupancy call) is ``ssd_split``'s, for S from 0 to 8192."""
    _cuda()
    from repro_torch.kernels import ssd_scan as sk

    for S in list(range(0, 600)) + list(range(600, 8193, 37)):
        got = sk.occupancy(torch.bfloat16, 64, 128, S)[3:]
        assert got == sk.ssd_split(S), (S, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [250, 2048])
def test_each_ssd_call_is_one_device_kernel(dtype, S):
    """Each ``ssd_chunk_scan`` call launches exactly one device kernel
    (the spans pass their states inside it), and counts it once."""
    dev = _cuda()
    from repro_torch.kernels import ssd_scan as sk

    rng = np.random.default_rng(S)
    args = _ssd_inputs(rng, 1, S, 80, 64, 128, dtype, dev)
    before = sk.launches["ssd_chunk_scan"]
    sk.ssd_chunk_scan(*args, chunk=256)
    assert sk.launches["ssd_chunk_scan"] - before == 1
    assert _device_kernels(lambda: sk.ssd_chunk_scan(*args, chunk=256),
                           calls=3) == 3


def test_ssd_wrapper_rejects_unaligned_or_narrow_state():
    """The kernel reads x, B and C rows in 16-byte pieces: a state width
    that is not a multiple of 8, or an operand whose pointer is not 16-byte
    aligned, is refused, not read."""
    dev = _cuda()
    from repro_torch.kernels import ssd_scan as sk

    rng = np.random.default_rng(0)
    x, dt, a, bm, cm = _ssd_inputs(rng, 1, 8, 2, 64, 16, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        sk.ssd_chunk_scan(x, dt, a, bm[..., :12], cm[..., :12], chunk=8)
    xs = torch.zeros(x.numel() + 1, device=dev,
                     dtype=x.dtype)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        sk.ssd_chunk_scan(xs, dt, a, bm, cm, chunk=8)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _cuda()
    from repro_torch.kernels import ssd_scan as sk

    rng = np.random.default_rng(0)
    x, dt, a, bm, cm = _ssd_inputs(rng, 1, 8, 2, 64, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="float32"):
        sk.ssd_chunk_scan(x, dt.half(), a, bm, cm, chunk=8)
    with pytest.raises(ValueError, match="share"):
        sk.ssd_chunk_scan(x.bfloat16(), dt, a, bm, cm, chunk=8)
    with pytest.raises(ValueError, match="head dim"):
        sk.ssd_chunk_scan(x[..., :48].contiguous(), dt, a, bm, cm, chunk=8)
    with pytest.raises(ValueError, match="one set of strides"):
        sk.ssd_chunk_scan(x, dt, a, bm, cm.contiguous(), chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        sk.ssd_chunk_scan(x.transpose(2, 3).contiguous().transpose(2, 3),
                          dt, a, bm, cm, chunk=8)
    with pytest.raises(ValueError, match="several devices"):
        sk.ssd_chunk_scan(x, dt.cpu(), a, bm, cm, chunk=8)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-2.7b"])
def test_ssm_engines_on_the_card_match_the_cpu_engine(arch):
    """Reduced Hymba (head dim 64, which the attention kernels take; its
    window cut to 24 so the ring wraps), source and qp merge, and reduced
    Mamba2 serve the CPU engine's greedy streams through the CUDA kernels,
    and the counters show the flash, decode and SSD launches of each."""
    dev = _cuda()
    from repro_torch.core.merge import merge_skipless
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    cfg = reduce_config(get_config(arch))
    models = []
    if arch == "hymba-1.5b":
        cfg = cfg.with_(block_style="skipless", d_model=256, n_heads=4,
                        n_kv_heads=1, d_head=64, sliding_window=24)
        params = init_params(cfg, seed=0, device="cpu")
        mparams, mcfg = merge_skipless(params, cfg, "qp")
        models = [(cfg, params), (mcfg, mparams)]
    else:
        models = [(cfg, init_params(cfg, seed=0, device="cpu"))]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 19, 40)]
    sc = ServeConfig(n_slots=2, max_len=64)
    for c, p in models:
        cpu = Engine(c, p, sc, impl="torch", device="cpu").generate(
            prompts, max_new_tokens=12)
        reset_launch_counts()
        eng = Engine(c, tree_map(lambda t: t.to(dev), p), sc, impl="cuda",
                     device=dev)
        gpu = eng.generate(prompts, max_new_tokens=12)
        assert [list(o) for o in gpu] == [list(o) for o in cpu], c.name
        want = {k: 0 for k in launch_counts()}
        want["ssd_chunk_scan"] = c.n_layers * len(prompts)
        if c.has_attention:
            want["flash_attention_bhsd"] = c.n_layers * len(prompts)
            want["decode_attention_bhsd"] = c.n_layers * eng.stats["n_steps"]
        assert launch_counts() == want, c.name


# ---------------------------------------------------------------------------
# the decode body: long caches, masked splits, one launch per call
# ---------------------------------------------------------------------------

# Hkv, G, D
DECODE_SHAPES = {"mistral": (8, 4, 128), "hymba": (5, 5, 64),
                 "chatglm": (2, 16, 128)}
DECODE_KINDS = ("dense", "paged", "paged_q8")
LONG_BS = 16  # page size of the long tables


def _decode_inputs(rng, kind, Hkv, G, D, pos, q_pos, window, dtype, dev):
    """Inputs of the merged decode wrapper of ``kind`` for the logical
    positions ``pos`` (B, S) (-1 empty; on the paged kinds a page is mapped
    iff one of its S / 16 rows holds a position, and a page's rows hold
    positions j * 16 + r, absolute addressing).  Returns (kernel's args,
    plain version's args): every K/V row, and on the q8 pool every page
    scale, that no query may attend is NaN in the kernel's copy only, so
    agreement shows the kernel never loads it."""
    B, S = pos.shape
    ok = (pos >= 0) & (pos <= q_pos[:, None])
    if window:
        ok &= q_pos[:, None] - pos < window
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    u = t(rng.standard_normal((B, Hkv * G, D), np.float32)).to(dtype)
    qp = t(q_pos.astype(np.int32))
    if kind == "dense":
        k, v = (rng.standard_normal((B, S, Hkv, D), np.float32)
                for _ in range(2))
        bad = [x.copy() for x in (k, v)]
        for x in bad:
            x[~ok] = np.nan
        kvp = t(pos.astype(np.int32))
        return ((u, *(t(x).to(dtype) for x in bad), kvp, qp),
                (u, *(t(x).to(dtype) for x in (k, v)), kvp, qp))
    MB = S // LONG_BS
    mapped = (pos.reshape(B, MB, LONG_BS) >= 0).any(-1)
    NB = int(mapped.sum()) + 3
    bt = np.full((B, MB), -1, np.int32)
    bt[mapped] = rng.permutation(NB)[:int(mapped.sum())]
    live = np.zeros((NB, LONG_BS), bool)
    live[bt[mapped]] = ok.reshape(B, MB, LONG_BS)[mapped]
    kp, vp = (rng.standard_normal((NB, LONG_BS, Hkv, D), np.float32)
              for _ in range(2))
    bt_t = t(bt)
    if kind == "paged":
        bad = [x.copy() for x in (kp, vp)]
        for x in bad:
            x[~live] = np.nan
        return ((u, *(t(x).to(dtype) for x in bad), bt_t, qp),
                (u, *(t(x).to(dtype) for x in (kp, vp)), bt_t, qp))
    from repro_torch.kernels import quant
    (k8, ks), (v8, vs) = (quant.q8_quantize_pages(t(x)) for x in (kp, vp))
    dead = t(~live.any(1))[:, None]
    ks_bad, vs_bad = (torch.where(dead, float("nan"), s) for s in (ks, vs))
    return ((u, k8, v8, ks_bad, vs_bad, bt_t, qp),
            (u, k8, v8, ks, vs, bt_t, qp))


def _decode_pair(kind, window, args):
    """(merged kernel, plain merged) outputs, then (generic kernel, plain
    generic), of ``kind`` on ``_decode_inputs``'s args (B, Hq, D)."""
    infix = {"dense": "", "paged": "_paged", "paged_q8": "_paged_q8"}[kind]
    kw = dict(sliding_window=window)
    if kind != "dense":
        kw["ring_blocks"] = 0
    outs = []
    for merged in (True, False):
        name = f"decode_attention{infix}_" + ("merged_bsd" if merged
                                              else "bhsd")
        fn, oracle = getattr(dk, name), getattr(
            ref, f"ref_decode_attention{infix}" + ("_merged" if merged
                                                   else ""))
        for f, (u, *rest) in ((fn, args[0]), (oracle, args[1])):
            B, Hq, D = u.shape
            Hkv = rest[0].shape[2]
            if not merged:
                u = u.reshape(B, Hkv, Hq // Hkv, D)
                if kind == "dense":
                    rest = [x.transpose(1, 2).contiguous() for x in rest[:2]] \
                        + rest[2:]
            outs.append(f(u, *rest, **kw).reshape(B, Hq, D))
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
@pytest.mark.parametrize("kind", DECODE_KINDS)
@pytest.mark.parametrize("window", [0, 1500])
def test_decode_long_cache_reaches_the_cluster_cap(dtype, shape, kind,
                                                   window):
    """B = 1, S = 4096 at Mistral-7B's, Hymba-1.5B's and ChatGLM3-6B's
    (G 16: two parts of the query group) shapes: the plan
    takes the cluster's 8 splits of 512 keys (several double-buffered
    tiles each), and with q_pos 2900, 5% holes and a window of 1500 the
    splits of the one cluster straddle attended and masked keys (future,
    empty, out of window).  Both queries of each kind against the plain
    versions; masked rows and dead page scales are NaN in the kernels'
    inputs."""
    dev = _cuda()
    Hkv, G, D = DECODE_SHAPES[shape]
    B, S = 1, 4096
    assert dk.kv_split(B, Hkv, S, G) == (dk.MAX_SPLIT, 512)
    rng = np.random.default_rng(Hkv + D + window + DECODE_KINDS.index(kind))
    q_pos = np.array([2900])
    pos = np.where(np.arange(S)[None] <= q_pos[:, None], np.arange(S)[None],
                   -1)
    if kind == "dense":
        pos = np.where(rng.random(pos.shape) < 0.05, -1, pos)
    else:  # a hole: one unmapped page
        pos[0, 16 * 40:16 * 41] = -1
    args = _decode_inputs(rng, kind, Hkv, G, D, pos, q_pos, window, dtype,
                          dev)
    outs = _decode_pair(kind, window, args)
    for got, want in zip(outs[::2], outs[1::2]):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=_tol(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_whole_splits_masked(dtype, kind):
    """S = 4096, B = 3 at Mistral-7B's shape (8 splits of 512 keys): row 0
    attends nothing (exactly 0), row 1 has an early q_pos (100: seven of
    its eight splits attend nothing), row 2 attends only keys of split 5."""
    dev = _cuda()
    Hkv, G, D = DECODE_SHAPES["mistral"]
    B, S = 3, 4096
    n_split, chunk = dk.kv_split(B, Hkv, S)
    assert (n_split, chunk) == (8, 512)
    rng = np.random.default_rng(17 + DECODE_KINDS.index(kind))
    s = np.arange(S)
    pos = np.full((B, S), -1)
    pos[1] = np.where(s <= 100, s, -1)
    lo, hi = 5 * chunk + 32, 5 * chunk + 160  # whole pages of split 5
    pos[2, lo:hi] = s[lo:hi]
    q_pos = np.array([7, 100, 4000])
    args = _decode_inputs(rng, kind, Hkv, G, D, pos, q_pos, 0, dtype, dev)
    outs = _decode_pair(kind, 0, args)
    for got, want in zip(outs[::2], outs[1::2]):
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        assert bool(got[1:].float().abs().amax(-1).gt(0).all())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=_tol(want))


def _device_kernels(fn, calls):
    """Device kernels ``torch.profiler`` records over ``calls`` calls,
    after a warm-up call (it builds the library).  A profile that recorded
    fewer kernels than kernel-launch API calls lost a record and is taken
    again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = sum(e.count for e in events
                      if e.device_type == DeviceType.CUDA)
        api = sum(e.count for e in events if e.device_type == DeviceType.CPU
                  and "LaunchKernel" in e.key)
        if kernels >= api:
            break
    return kernels


@pytest.mark.parametrize("name", sorted(dk.launches))
def test_each_decode_wrapper_call_is_one_device_kernel(name):
    """Each of the six decode wrappers launches exactly one device kernel
    per call (the splits combine inside it), and counts it once."""
    dev = _cuda()
    kind = "paged_q8" if "_q8" in name else \
        "paged" if "_paged" in name else "dense"
    Hkv, G, D = DECODE_SHAPES["mistral"]
    rng = np.random.default_rng(5)
    B, S = 4, 512
    q_pos = np.array([15, 100, 300, 511])
    pos = np.where(np.arange(S)[None] <= q_pos[:, None], np.arange(S)[None],
                   -1)
    (u, *rest), _ = _decode_inputs(rng, kind, Hkv, G, D, pos, q_pos, 0,
                                   torch.bfloat16, dev)
    if not name.endswith("merged_bsd"):
        u = u.reshape(B, Hkv, G, D)
        if kind == "dense":
            rest = [x.transpose(1, 2).contiguous() for x in rest[:2]] \
                + rest[2:]
    fn = getattr(dk, name)
    before = dk.launches[name]
    fn(u, *rest)
    assert dk.launches[name] - before == 1
    assert _device_kernels(lambda: fn(u, *rest), calls=3) == 3


@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_wrappers_reject_17_query_heads_per_kv_head(kind):
    """G 16 is the widest group the decode kernel takes (two parts of 8);
    G 17 raises ValueError before any launch, on every wrapper."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    B, S, Hkv, G, D = 2, 64, 2, 17, 64
    q_pos = np.array([10, 40])
    pos = np.where(np.arange(S)[None] <= q_pos[:, None], np.arange(S)[None],
                   -1)
    (u, *rest), _ = _decode_inputs(rng, kind, Hkv, G, D, pos, q_pos, 0,
                                   torch.float32, dev)
    infix = {"dense": "", "paged": "paged_", "paged_q8": "paged_q8_"}[kind]
    for merged in (True, False):
        name = f"decode_attention_{infix}" + ("merged_bsd" if merged
                                              else "bhsd")
        q, kv = u, rest
        if not merged:
            q = u.reshape(B, Hkv, G, D)
            if kind == "dense":
                kv = [x.transpose(1, 2).contiguous() for x in rest[:2]] \
                    + rest[2:]
        before = dk.launches[name]
        with pytest.raises(ValueError, match="1..16"):
            getattr(dk, name)(q, *kv)
        assert dk.launches[name] == before


def test_engine_serves_a_16_head_group_through_the_decode_kernel():
    """A reduced skipless ChatGLM3-6B widened to ChatGLM3's G 16 (16 query
    heads over one kv head of 64; QKV biases, half-dimension interleaved
    RoPE) and its qp merge serve the CPU engine's greedy streams through
    the CUDA kernels, one decode launch per layer and step."""
    dev = _cuda()
    from repro_torch.core.merge import merge_skipless
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    cfg = reduce_config(get_config("chatglm3-6b")).with_(
        block_style="skipless", d_model=1024, n_heads=16, n_kv_heads=1,
        d_head=64)
    params = init_params(cfg, seed=0, device="cpu")
    mparams, mcfg = merge_skipless(params, cfg, "qp")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 19, 40)]
    sc = ServeConfig(n_slots=3, max_len=64)
    for c, p, merged in ((cfg, params, False), (mcfg, mparams, True)):
        for cache in ("dense", "paged"):
            cpu = Engine(c, p, sc, impl="torch", cache=cache,
                         device="cpu").generate(prompts, max_new_tokens=6)
            reset_launch_counts()
            eng = Engine(c, tree_map(lambda t: t.to(dev), p), sc,
                         impl="cuda", cache=cache, device=dev)
            gpu = eng.generate(prompts, max_new_tokens=6)
            assert [list(o) for o in gpu] == [list(o) for o in cpu], \
                (merged, cache)
            decode = "decode_attention_" + ("paged_" if cache == "paged"
                                             else "") + \
                ("merged_bsd" if merged else "bhsd")
            assert launch_counts()[decode] == \
                cfg.n_layers * eng.stats["n_steps"] > 0


def test_decode_wrappers_reject_unaligned_kv():
    """The decode body copies K/V rows in 16-byte chunks: a K/V operand
    whose pointer is not 16-byte aligned is refused, not read."""
    dev = _cuda()
    B, S, Hkv, D = 2, 16, 2, 128
    u = torch.randn(B, 4 * Hkv, D, device=dev, dtype=torch.bfloat16)
    k = torch.randn(B * S * Hkv * D + 1, device=dev,
                    dtype=torch.bfloat16)[1:].view(B, S, Hkv, D)
    kvp = torch.zeros((B, S), dtype=torch.int32, device=dev)
    qp = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    assert k.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        dk.decode_attention_merged_bsd(u, k, k, kvp, qp)


# ---------------------------------------------------------------------------
# the scheduler on the card: shielded rows, chunked serving, sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["paged", "paged_q8"])
def test_decode_shielded_paged_row_is_zero(dtype, kind):
    """A slot mid-chunked-prefill reaches the paged decode kernels (rows
    6-9) with its table row all -1 and a length at its chunk frontier (>
    0): its output row is exactly zero (no NaN, though every unmapped
    page's K/V rows and q8 scales are NaN), and the other rows equal the
    plain versions'."""
    dev = _cuda()
    Hkv, G, D = DECODE_SHAPES["mistral"]
    B, S = 4, 512
    rng = np.random.default_rng(23 + DECODE_KINDS.index(kind))
    q_pos = np.array([15, 64, 300, 511])  # row 1: shielded at frontier 64
    pos = np.where(np.arange(S)[None] <= q_pos[:, None], np.arange(S)[None],
                   -1)
    pos[1] = -1  # no page mapped: the masked decode view of the slot
    args = _decode_inputs(rng, kind, Hkv, G, D, pos, q_pos, 0, dtype, dev)
    assert bool((args[0][-2][1] == -1).all())  # the table row
    outs = _decode_pair(kind, 0, args)
    for got, want in zip(outs[::2], outs[1::2]):
        assert torch.equal(got[1], torch.zeros_like(got[1]))
        rows = [0, 2, 3]
        torch.testing.assert_close(got[rows].float(), want[rows].float(),
                                   rtol=0, atol=_tol(want[rows]))


STATE_ROWS = ("bhsd", "merged", "paged", "paged_merged", "paged_q8",
              "paged_q8_merged")


def _states_case(rng, row, Hkv, G, D, ring, dtype, dev):
    """(query, K/V operands, keywords, the kv axis to cut) of a decode row
    at the path's shapes (B 4, 512 keys or 16-token pages), with row 0's
    keys all in the first quarter (the other ranges of a cut have nothing
    for it), row 3 idle (no key); ``ring``: a windowed ring table (window
    64: 5 slots) on the paged rows, a window of 64 on the dense ones."""
    B, S, bs = 4, 512, 16
    t = lambda x, dt=dtype: torch.from_numpy(x).to(dev, dt)  # noqa: E731
    q_pos = np.array([100, 300, 511, 511], np.int32)
    u = t(rng.standard_normal((B, Hkv * G, D), np.float32))
    q = u.reshape(B, Hkv * G * D) if row.endswith("merged") else u
    kw = dict(q_position=t(q_pos, torch.int32),
              sliding_window=64 if ring else 0)
    if row.endswith("merged"):
        kw["n_kv_heads"] = Hkv
    if not row.startswith("paged"):
        pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        pos[3] = -1
        kw["kv_positions"] = t(pos, torch.int32)
        kv = [t(rng.standard_normal((B, S, Hkv, D), np.float32))
              for _ in range(2)]
        return q, kv, kw, S
    MB = 5 if ring else S // bs
    NB = 4 * MB + 8
    bt = np.full((B, MB), -1, np.int32)
    pages = iter(rng.permutation(NB))
    for b in range(3):
        lb = q_pos[b] // bs
        for j in range(MB):
            if (lb - (lb + MB - j) % MB >= 0) if ring else j <= lb:
                bt[b, j] = next(pages)
    kw["block_tables"] = t(bt, torch.int32)
    if row.startswith("paged_q8"):
        kv = [t(rng.integers(-127, 128, (NB, bs, Hkv, D)).astype(np.int8),
                torch.int8) for _ in range(2)]
        kw.update(k_scale=t(rng.uniform(.001, .02, (NB, Hkv)).astype(
            np.float32), torch.float32), v_scale=t(rng.uniform(
                .001, .02, (NB, Hkv)).astype(np.float32), torch.float32))
    else:
        kv = [t(rng.standard_normal((NB, bs, Hkv, D), np.float32))
              for _ in range(2)]
    return q, kv, kw, NB


def _states_range(row, q, kv, kw, lo, hi):
    """The partial-state twin of ``row``'s wrapper over keys (pages)
    [lo, hi): a dense slice with its positions, or a pool slice with its
    scales and the table of global width whose other pages are -1."""
    from repro_torch.distribution.placed import own_pages
    from repro_torch.kernels import ops as kops
    kw = dict(kw)
    if row.startswith("paged"):
        kv = [x[lo:hi] for x in kv]
        kw["block_tables"] = own_pages(kw["block_tables"], lo, hi - lo)
        for k in ("k_scale", "v_scale"):
            if k in kw:
                kw[k] = kw[k][lo:hi].contiguous()
    else:
        kv = [x[:, lo:hi].contiguous() for x in kv]
        kw["kv_positions"] = kw["kv_positions"][:, lo:hi].contiguous()
    name = {"bhsd": "decode_attention", "merged": "decode_attention_merged"
            }.get(row, "decode_attention_" + row)
    return getattr(kops, name + "_states")(q, *kv, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["mistral", "chatglm"])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("row", STATE_ROWS)
def test_partial_states_on_the_card_combine_to_the_whole_kernel(row, ring,
                                                                shape,
                                                                dtype):
    """Rows 4-9 in the partial-state mode over the ranges of 2- and 4-way
    cuts of the keys or pages, as the ranks of a model axis hold them:
    each range's states equal the plain version's on the CPU, and
    combined (``placed.combine_softmax``) they equal the whole kernel's
    output, the idle row exactly 0.  One launch per range."""
    dev = _cuda()
    from repro_torch.distribution.placed import combine_softmax
    from repro_torch.kernels import ops as kops
    Hkv, G, D = DECODE_SHAPES[shape]
    rng = np.random.default_rng(STATE_ROWS.index(row) + 10 * ring)
    q, kv, kw, n = _states_case(rng, row, Hkv, G, D, ring, dtype, dev)
    name = {"bhsd": "decode_attention", "merged": "decode_attention_merged"
            }.get(row, "decode_attention_" + row)
    whole = getattr(kops, name)(q, *kv, **kw).reshape(4, Hkv * G, D)
    cpu = lambda x: x.cpu() if torch.is_tensor(x) else x  # noqa: E731
    for cut in (2, 4):
        reset_launch_counts()
        states = [_states_range(row, q, kv, kw, r * n // cut,
                                (r + 1) * n // cut) for r in range(cut)]
        torch.cuda.synchronize()
        assert sum(launch_counts().values()) == cut
        for r, got in enumerate(states):
            want = _states_range(row, q.cpu(), [x.cpu() for x in kv],
                                 {k: cpu(x) for k, x in kw.items()},
                                 r * n // cut, (r + 1) * n // cut)
            for a, b in zip(got, want):
                tol = 5e-5 * max(1.0, float(b.abs().max()))
                assert float((a.cpu() - b).abs().max()) <= tol, (cut, r)
        got = combine_softmax(*(torch.stack(x) for x in zip(*states)))
        got = got.to(dtype)
        assert torch.isfinite(got.float()).all()
        assert torch.equal(got[3], torch.zeros_like(got[3]))
        torch.testing.assert_close(got.float(), whole.float(), rtol=0,
                                   atol=_tol(whole))


def _sched_model(window=0):
    from repro_torch.core.merge import merge_skipless
    from repro_torch.models import init_params
    cfg = reduce_config(get_config("mistral-7b")).with_(
        block_style="skipless", d_model=256, n_heads=4, n_kv_heads=2,
        d_head=64, sliding_window=window)
    params = init_params(cfg, seed=0, device="cpu")
    mparams, mcfg = merge_skipless(params, cfg, "qp")
    return {"generic": (cfg, params), "merged": (mcfg, mparams)}


@pytest.mark.parametrize("cache", ["dense", "paged", "paged_q8"])
def test_scheduled_engine_on_the_card_matches_the_cpu_engine(cache):
    """The ``ScheduledEngine`` through the CUDA decode kernels emits the
    CPU scheduler's streams (chunks of 8; a repeated prompt hits the
    paged pools' prefix cache), and launches only its cache's decode
    kernel, once per layer and decode step: no flash kernel runs on chunk
    steps."""
    dev = _cuda()
    from repro_torch.serving import (SchedConfig, ScheduledEngine,
                                     ServeConfig, make_adapter)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n) for n in (5, 19, 40, 40)]
    prompts[3] = prompts[2].copy()  # a prefix hit on the paged pools
    sc = ServeConfig(n_slots=3, max_len=64, block_size=8)
    scfg = SchedConfig(token_budget=32, chunk_tokens=8)
    infix = {"dense": "", "paged": "paged_", "paged_q8": "paged_q8_"}[cache]
    for kind, (c, p) in _sched_model().items():
        cpu = ScheduledEngine(c, p, sc, scfg, impl="torch",
                              cache=make_adapter(cache), device="cpu")
        want = [list(o) for o in cpu.generate(prompts, max_new_tokens=12)]
        reset_launch_counts()
        eng = ScheduledEngine(c, tree_map(lambda t: t.to(dev), p), sc, scfg,
                              impl="cuda", cache=make_adapter(cache),
                              device=dev)
        got = [list(o) for o in eng.generate(prompts, max_new_tokens=12)]
        assert got == want, (cache, kind)
        assert eng._chunked and eng.n_chunks_run > len(prompts)
        decode = f"decode_attention_{infix}" + (
            "merged_bsd" if kind == "merged" else "bhsd")
        counts = launch_counts()
        assert counts[decode] == c.n_layers * eng.stats["n_steps"]
        assert sum(counts.values()) == counts[decode], counts


def test_sampling_on_the_card():
    """Temperature sampling through the CUDA engines: a request's stream
    is the same alone and beside other traffic, the scheduler's equals the
    synchronous engine's, and top_k=1 is greedy."""
    dev = _cuda()
    from repro_torch.serving import (Engine, SchedConfig, ScheduledEngine,
                                     ServeConfig)
    c, p = _sched_model()["merged"]
    p = tree_map(lambda t: t.to(dev), p)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128, n) for n in (6, 17, 30)]

    def run(ps, sched=False, **kw):
        sc = ServeConfig(**{**dict(n_slots=3, max_len=64, temperature=0.8,
                                   top_k=50, seed=4, block_size=8), **kw})
        eng = ScheduledEngine(c, p, sc, SchedConfig(32, 8), impl="cuda",
                              cache="paged", device=dev) if sched else \
            Engine(c, p, sc, impl="cuda", cache="paged", device=dev)
        return [list(o) for o in eng.generate(ps, max_new_tokens=10)]

    busy = run(prompts)
    assert run(prompts[:1]) == busy[:1]
    assert run(prompts, sched=True) == busy
    assert run(prompts, top_k=1) == run(prompts, temperature=0.0)


# ---------------------------------------------------------------------------
# the VLM and the audio encoder: non-causal flash with Sk != Sq, head dim 80,
# the cross step's decode over the vision K/V read in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("Sq", [1, 37, 250, 1000])
@pytest.mark.parametrize("Sk", [64, 100, 1600])
@pytest.mark.parametrize("G", [1, 4])
def test_flash_kernels_non_causal_match_plain(dtype, D, Sq, Sk, G):
    """``causal=False`` (VLM cross prefill: Sk = the vision tokens; the
    encoder: Sk = Sq) in rows 1-3 against the plain versions: Sk a whole
    tile (64), not a multiple of it (100) and the VLM's 1600, Sq shorter
    and longer than Sk and straddling the q tiles, head dims 64, 80 and
    128.  Row 1 also through ``ops.flash_attention`` on sequence-major
    views."""
    dev = _cuda()
    from repro_torch.kernels import ops, quant
    rng = np.random.default_rng(D + Sq + Sk + G)
    B, Hkv = 2, 2
    Hq = G * Hkv
    u = torch.from_numpy(rng.standard_normal((B, Sq, Hq, D),
                                             np.float32)).to(dev, dtype)
    kv = [torch.from_numpy(rng.standard_normal((B, Sk, Hkv, D),
                                               np.float32)).to(dev)
          for _ in range(2)]
    k, v = (x.to(dtype) for x in kv)
    got = fk.flash_attention_merged_bsd(u, k, v, causal=False)
    want = ref.ref_flash_attention_merged(u, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (u, k, v))
    got = fk.flash_attention_bhsd(qh, kh, vh, causal=False)
    want_h = ref.ref_attention(qh, kh, vh, causal=False)
    torch.testing.assert_close(got.float(), want_h.float(), rtol=0,
                               atol=_tol(want_h))
    got = ops.flash_attention(u, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))
    (k8, ks), (v8, vs) = (quant.q8_quantize_seq(x, 4) for x in kv)
    got = fk.flash_attention_merged_q8_bsd(u, k8, v8, ks, vs, causal=False)
    want = ref.ref_flash_attention_merged_q8(u, k8, v8, ks, vs,
                                             causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_tol(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_decode_reads_the_vision_cache_in_place(dtype):
    """The VLM cross step's shape (B 4, Hkv 8, G 4, D 128, 1600 vision
    tokens, all attended at q_position 1601): ``ops.decode_attention_native``
    launches the generic decode kernel once on the (B, nv, Hkv, D) cache's
    own strides, allocates no copy of it, and equals the head-major launch
    and the plain version."""
    dev = _cuda()
    from repro_torch.kernels import ops
    rng = np.random.default_rng(11)
    B, Hkv, G, D, nv = 4, 8, 4, 128, 1600
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, D),
                                             np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, nv, Hkv, D),
                                                 np.float32)).to(dev, dtype)
            for _ in range(2))
    kvp = torch.arange(nv, dtype=torch.int32, device=dev).expand(B, nv)
    qp = torch.full((B,), nv + 1, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    got = ops.decode_attention_native(q, k, v, kv_positions=kvp,
                                      q_position=qp)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < k.numel() * \
        k.element_size() // 4
    counts = launch_counts()
    assert counts["decode_attention_bhsd"] == 1 and sum(counts.values()) == 1
    want = ops.decode_attention(q, k, v, kv_positions=kvp, q_position=qp)
    assert torch.equal(got, want)  # same kernel, same order of sums
    plain = ref.ref_decode_attention(
        q.reshape(B, Hkv, G, D), k.transpose(1, 2), v.transpose(1, 2), kvp,
        qp).reshape(B, Hkv * G, D)
    torch.testing.assert_close(got.float(), plain.float(), rtol=0,
                               atol=_tol(plain))


def test_decode_wrappers_keep_head_dims_64_and_128():
    """Head dim 80 is a flash-only domain (the encoder has no decode)."""
    dev = _cuda()
    u = torch.zeros((2, 8, 80), device=dev)
    k = torch.zeros((2, 16, 2, 80), device=dev)
    kvp = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    qp = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        dk.decode_attention_merged_bsd(u, k, k, kvp, qp)
    with pytest.raises(ValueError, match="head dim"):
        dk.decode_attention_bshd(u.reshape(2, 2, 4, 80), k, k, kvp, qp)


def test_vlm_engine_on_the_card_matches_the_cpu_engine():
    """A reduced skipless VLM (head dim 64, 4 layers, a cross layer every
    2nd, 40 vision tokens) and its qp merge serve the same greedy streams
    with vision through the CUDA kernels as through the plain versions on
    the CPU; each prefill launches the generic flash kernel once per layer
    (cross layers non-causal over the vision tokens), each decode step the
    merged (merged self layers) or generic decode kernel per self layer
    and the generic one per cross layer."""
    dev = _cuda()
    from repro_torch.core.merge import merge_skipless
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    cfg = reduce_config(get_config("llama3.2-vision-11b")).with_(
        block_style="skipless", d_model=256, n_heads=4, n_kv_heads=2,
        d_head=64, n_vision_tokens=40)
    params = init_params(cfg, seed=0, device="cpu")
    params["embed"]["table"] *= 50.0
    mparams, mcfg = merge_skipless(params, cfg, "qp")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 19, 40)]
    vision = [rng.standard_normal((40, 256)).astype(np.float32)
              for _ in prompts]
    sc = ServeConfig(n_slots=2, max_len=64)
    n_cross = 2
    for c, p, merged in ((cfg, params, False), (mcfg, mparams, True)):
        cpu = Engine(c, p, sc, impl="torch", device="cpu").generate(
            prompts, max_new_tokens=6, vision=vision)
        reset_launch_counts()
        eng = Engine(c, tree_map(lambda t: t.to(dev), p), sc, impl="cuda",
                     device=dev)
        gpu = eng.generate(prompts, max_new_tokens=6, vision=vision)
        assert [list(o) for o in gpu] == [list(o) for o in cpu], merged
        steps = eng.stats["n_steps"]
        want = {k: 0 for k in launch_counts()}
        want["flash_attention_bhsd"] = cfg.n_layers * len(prompts)
        n_self = cfg.n_layers - n_cross
        if merged:
            want["decode_attention_merged_bsd"] = n_self * steps
            want["decode_attention_bhsd"] = n_cross * steps
        else:
            want["decode_attention_bhsd"] = cfg.n_layers * steps
        assert launch_counts() == want, merged


@pytest.mark.parametrize("variant", ["source", "qp", "kp", "vp"])
def test_encoder_on_the_card_matches_the_cpu(variant):
    """The reduced encoder at HuBERT's head dim 80 (d 160, 2 heads): the
    kernels' forward (non-causal flash, D 80, one launch per layer) against
    the plain forward on the CPU, float32, source and the three merges."""
    dev = _cuda()
    from repro_torch.core.merge import merge_skipless
    from repro_torch.models import forward_seq, init_params

    cfg = reduce_config(get_config("hubert-xlarge")).with_(
        block_style="skipless", d_model=160, n_heads=2, n_kv_heads=2,
        d_head=80)
    params = init_params(cfg, seed=0, device="cpu")
    if variant != "source":
        params, cfg = merge_skipless(params, cfg, variant)
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 77, 160)).astype(np.float32))
    want, _, _ = forward_seq(params, cfg, frames)
    reset_launch_counts()
    got, _, _ = forward_seq(tree_map(lambda t: t.to(dev), params), cfg,
                            frames.to(dev), impl="cuda")
    assert launch_counts()["flash_attention_bhsd"] == cfg.n_layers
    scale = float(want.abs().max())
    assert 0 < scale and float((got.cpu() - want).abs().max()) <= 1e-4 * scale


# ---------------------------------------------------------------------------
# training on the card: the plain forward and its autograd backward (the
# kernels have no backward and refuse to run under autograd)
# ---------------------------------------------------------------------------

TRAIN_STYLES = ("standard", "skipless", "skipless_merged", "residual_qpfree")


def _train_cases():
    from repro_torch.configs import list_archs
    out = []
    for arch in list_archs():
        for style in TRAIN_STYLES:
            try:
                get_config(arch).with_(block_style=style).validate_style()
            except ValueError:
                continue
            out += [(arch, style, a)
                    for a in ((1, 2) if style == "standard" else (1,))]
    return out


class _RecordingOptimizer:
    """Keeps the gradients that reach the optimizer, then applies it."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        self.grads = grads
        return self.inner.update(grads, state, params)


@pytest.mark.parametrize("arch,style,grad_accum", _train_cases())
def test_train_step_on_the_card_matches_the_cpu(arch, style, grad_accum):
    """One ``make_train_step`` (remat on) from the same params and batch on
    the card and on the CPU: the loss and the updated params within 1e-5
    of their scale, the gradients that reach the optimizer within 1e-4 of
    each leaf's largest (``None`` on both sides alike).  AdamW with eps 1
    keeps the step smooth in the gradient (at eps 1e-8 a first step is
    lr * sign(g), and a gradient at rounding level would flip a whole
    2 lr)."""
    dev = _cuda()
    from repro_torch._tree import tree_leaves
    from repro_torch.models import init_params
    from repro_torch.training import DataConfig, make_dataset, make_train_step
    from repro_torch.training.optimizer import AdamW, constant_schedule

    cfg = reduce_config(get_config(arch), block_style=style)
    p0 = init_params(cfg, seed=0, device="cpu")
    np_batch = make_dataset(cfg, DataConfig(global_batch=4, seq_len=16,
                                            seed=0)).batch_at(0)
    res = []
    for d in (torch.device("cpu"), dev):
        opt = _RecordingOptimizer(AdamW(lr=constant_schedule(1e-3), eps=1.0,
                                        weight_decay=0.0))
        step = make_train_step(cfg, opt, grad_accum=grad_accum, remat=True)
        params = tree_map(lambda t: t.clone().to(d), p0)
        batch = {k: torch.from_numpy(v).to(d) for k, v in np_batch.items()}
        params, _, m = step(params, opt.init(params), batch)
        res.append((tree_leaves(tree_map(lambda t: t.cpu(), params)),
                    [None if g is None else g.cpu()
                     for g in tree_leaves(opt.grads)], float(m["loss"])))
    (pc, gc, lc), (pg, gg, lg) = res
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(pg, pc):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for a, b in zip(gg, gc):
        assert (a is None) == (b is None)
        if b is not None:
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _kernel_wrappers():
    from repro_torch.kernels import ssd_scan as sk
    return [(fk.flash_attention_bhsd, 3), (fk.flash_attention_bshd, 3),
            (fk.flash_attention_merged_bsd, 3),
            (fk.flash_attention_merged_q8_bsd, 5),
            (dk.decode_attention_bhsd, 5), (dk.decode_attention_bshd, 5),
            (dk.decode_attention_merged_bsd, 5),
            (dk.decode_attention_paged_bhsd, 5),
            (dk.decode_attention_paged_merged_bsd, 5),
            (dk.decode_attention_paged_q8_bhsd, 7),
            (dk.decode_attention_paged_q8_merged_bsd, 7),
            (sk.ssd_chunk_scan, 5)]


@pytest.mark.parametrize("fn,n_operands", _kernel_wrappers(),
                         ids=lambda x: getattr(x, "__name__", str(x)))
def test_kernel_wrappers_refuse_autograd_on_the_card(fn, n_operands):
    """A wrapper given a CUDA operand that requires grad raises before it
    launches: its output would carry no gradient."""
    dev = _cuda()
    args = [torch.zeros(1, 1, 1, 64, device=dev) for _ in range(n_operands)]
    args[0].requires_grad_()
    kw = {"chunk": 64} if fn.__name__ == "ssd_chunk_scan" else {}
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args, **kw)
    assert sum(launch_counts().values()) == 0


def test_forward_through_the_kernels_refuses_params_that_require_grad():
    dev = _cuda()
    from repro_torch.models import forward_seq, init_params

    cfg = reduce_config(get_config("mistral-7b")).with_(
        d_model=256, n_heads=4, n_kv_heads=2, d_head=64)  # D the kernels take
    params = tree_map(lambda t: t.requires_grad_(),
                      init_params(cfg, seed=0, device=dev))
    x = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        forward_seq(params, cfg, x, impl="cuda")
    with torch.no_grad():
        forward_seq(params, cfg, x, impl="cuda")
    lg, _, _ = forward_seq(params, cfg, x, impl="torch")
    lg.sum().backward()
    assert params["layers"]["attn"]["wk"].grad is not None


# ---------------------------------------------------------------------------
# the mesh path at world size 1 (NCCL), in a subprocess: no process group
# lives in the test process
# ---------------------------------------------------------------------------

_MESH_SCRIPT = r"""
import json, os, sys
sys.path.insert(0, {src!r})
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import merge_skipless
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params
from repro_torch.serving import Engine, ScheduledEngine, SchedConfig, ServeConfig
from repro_torch.training import DataConfig, Trainer, TrainerConfig

dist.init_process_group("nccl", init_method="file://" + {pg!r}, rank=0,
                        world_size=1)
mesh = make_mesh((1, 1), ("data", "model"))
out = {{}}
cfg = reduce_config(get_config("mistral-7b")).with_(
    block_style="skipless", d_model=256, n_heads=4, n_kv_heads=2,
    d_head=64, dtype="float32", param_dtype="float32")
params = init_params(cfg, seed=0, device="cuda")
params["embed"]["table"].mul_(50.0)
mp, mc = merge_skipless(params, cfg, "qp")
rng = np.random.default_rng(0)
prompts = [rng.integers(0, 128, n) for n in (5, 11, 3, 8)]
sc = ServeConfig(n_slots=4, max_len=48)
for name, (c, p) in (("source", (cfg, params)), ("merged", (mc, mp))):
    for kind in ("engine", "sched"):
        res = {{}}
        for tag, m in (("plain", None), ("mesh", mesh)):
            eng = (Engine(c, p, sc, impl="cuda", device="cuda", mesh=m)
                   if kind == "engine" else
                   ScheduledEngine(c, p, sc, SchedConfig(token_budget=16,
                                                         chunk_tokens=8),
                                   impl="cuda", device="cuda", mesh=m))
            torch.cuda.synchronize()
            reset_launch_counts()
            outs = eng.generate(prompts, max_new_tokens=6)
            torch.cuda.synchronize()
            res[tag] = ([list(map(int, o)) for o in outs],
                        {{k: v for k, v in launch_counts().items() if v}})
        out[name + "/" + kind] = res
tcfg_ = reduce_config(get_config("llama3.2-1b"))
losses = {{}}
for tag, m in (("plain", None), ("mesh", mesh)):
    tr = Trainer(tcfg_, TrainerConfig(steps=3, log_every=1, ckpt_every=100,
                                      ckpt_dir={ck!r} + tag, lr=1e-3,
                                      warmup=1),
                 DataConfig(global_batch=4, seq_len=16, seed=0),
                 device="cuda", mesh=m)
    tr.run()
    losses[tag] = [x["loss"] for x in tr.metrics_log]
out["train"] = losses
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_mesh_path_at_world_size_1_on_the_card(tmp_path):
    """Engine and ScheduledEngine on a (1, 1) mesh through the kernels
    (source: rows 1 and 4; merged: rows 2 and 5): the same greedy streams
    and launch counts as without the mesh; a meshed Trainer's losses equal
    the unmeshed one's within 1e-6 relative."""
    import json
    import os
    import subprocess
    import sys

    _cuda()
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = _MESH_SCRIPT.format(src=os.path.abspath(src),
                               pg=str(tmp_path / "pg"),
                               ck=str(tmp_path / "ck_"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for key in ("source/engine", "source/sched", "merged/engine",
                "merged/sched"):
        plain, meshed = out[key]["plain"], out[key]["mesh"]
        assert meshed == plain, key
        assert sum(plain[1].values()) > 0, key
    merged = out["merged/engine"]["plain"][1]
    assert set(merged) == {"flash_attention_merged_bsd",
                           "decode_attention_merged_bsd"}, merged
    a, b = out["train"]["mesh"], out["train"]["plain"]
    assert len(a) == 3 and all(abs(x - y) <= 1e-6 * abs(y)
                               for x, y in zip(a, b)), (a, b)


# ---------------------------------------------------------------------------
# the kernel operators (torch.library) and the lint on the card
# ---------------------------------------------------------------------------

def _op_cases(dev, dtype):
    """(name, CUDA args, kwargs) of each ``repro_torch`` operator at
    shapes the kernels take (D 64, G 2, 16-byte aligned)."""
    g = torch.Generator().manual_seed(0)

    def rn(*s, dt=dtype):
        return torch.randn(*s, generator=g).to(dev, dt)

    B, S, Hkv, G, D, NB, bs = 2, 64, 2, 2, 64, 6, 16
    kvp = torch.arange(S, dtype=torch.int32, device=dev).expand(
        B, S).contiguous()
    qp = torch.tensor([63, 30], dtype=torch.int32, device=dev)
    tbl = torch.tensor([[0, 1, 2, 3], [4, 5, -1, -1]], dtype=torch.int32,
                       device=dev)
    pool = rn(NB, bs, Hkv, D)
    p8 = (rn(NB, bs, Hkv, D, dt=torch.float32) * 20).to(torch.int8)
    # scales that keep the dequantized K/V, and so the outputs, O(1)
    sc = (rn(NB, Hkv, dt=torch.float32).abs() + 0.01) * 0.02
    k8 = (rn(B, S, Hkv, D, dt=torch.float32) * 20).to(torch.int8)
    s8 = rn(B, 4, Hkv, dt=torch.float32).abs() * 0.01
    qg, qm = rn(B, Hkv, G, D), rn(B, Hkv * G, D)
    cases = [
        ("decode_attention_bhsd", (qg, rn(B, Hkv, S, D), rn(B, Hkv, S, D),
                                   kvp, qp), {"sliding_window": 16}),
        ("decode_attention_bshd", (qg, rn(B, S, Hkv, D), rn(B, S, Hkv, D),
                                   kvp, qp), {}),
        ("decode_attention_merged_bsd", (qm, rn(B, S, Hkv, D),
                                         rn(B, S, Hkv, D), kvp, qp), {}),
        ("decode_attention_paged_bhsd", (qg, pool, pool, tbl, qp), {}),
        ("decode_attention_paged_merged_bsd", (qm, pool, pool, tbl, qp),
         {}),
        ("decode_attention_paged_q8_bhsd", (qg, p8, p8, sc, sc, tbl, qp),
         {}),
        ("decode_attention_paged_q8_merged_bsd", (qm, p8, p8, sc, sc, tbl,
                                                  qp), {}),
        ("flash_attention_bhsd", (rn(B, 4, S, D), rn(B, Hkv, S, D),
                                  rn(B, Hkv, S, D)), {}),
        ("flash_attention_bshd", (rn(B, S, 4, D), rn(B, S, Hkv, D),
                                  rn(B, S, Hkv, D)), {"sliding_window": 9}),
        ("flash_attention_merged_bsd", (rn(B, S, 4, D), rn(B, S, Hkv, D),
                                        rn(B, S, Hkv, D)), {}),
        ("flash_attention_merged_q8_bsd", (rn(B, S, 4, D), k8, k8, s8, s8),
         {}),
        ("ssd_chunk_scan", (rn(1, S, 2, 16), rn(1, S, 2,
                                                dt=torch.float32).abs(),
                            -rn(1, S, 2, dt=torch.float32).abs(),
                            rn(1, S, 2, 8), rn(1, S, 2, 8)), {"chunk": 64}),
    ]
    # each decode operator's partial-state twin takes its operands (the
    # in-place bshd launch has none)
    return cases + [(n + "_states", a, kw) for n, a, kw in cases
                    if n.startswith("decode")
                    and n != "decode_attention_bshd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_operators_on_the_card_equal_their_plain_versions(dtype):
    """Each ``torch.ops.repro_torch`` operator on CUDA tensors launches its
    kernel once and equals the same operator on the tensors moved to the
    CPU (its plain version); its fake implementation gives the real
    output's shapes and dtypes."""
    dev = _cuda()
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import _build
    cases = _op_cases(dev, dtype)
    assert sorted(n for n, _, _ in cases) == sorted(_build.OPS)
    for name, args, kw in cases:
        op = getattr(torch.ops.repro_torch, name)
        reset_launch_counts()
        got = op(*args, **kw)
        torch.cuda.synchronize()
        assert sum(launch_counts().values()) == 1, name
        want = op(*[a.cpu() for a in args], **kw)
        with FakeTensorMode() as mode:
            fake = op(*[mode.from_tensor(a) for a in args], **kw)
        got, want, fake = ((x,) if not isinstance(x, tuple) else x
                           for x in (got, want, fake))
        for a, b, f in zip(got, want, fake):
            assert (a.shape, a.dtype) == (b.shape, b.dtype) == \
                (f.shape, f.dtype), name
            # the float32 states of the partial-state twins are sums over
            # the keys (l, o): within 5e-5 of their largest, or absolute
            tol = 3e-5 * float(b.abs().max()) if name == "ssd_chunk_scan" \
                else 5e-5 * max(1.0, float(b.abs().max())) \
                if name.endswith("_states") else _tol(b)
            assert float((a.float().cpu() - b.float()).abs().max()) <= tol, \
                name


def test_lint_sweep_on_the_card_is_clean():
    """The sweep with the "cuda" combos traced on the card: CLEAN, each
    decode and prefill kernel target one kernel node and one launch per
    attention layer, the decode programs free of host syncs."""
    _cuda()
    from repro_torch.lint import sweep
    rep = sweep(device="cuda")
    assert rep.ok, [str(f) for f in rep.findings]
    assert (rep.n_decode_targets, rep.n_prefill_targets,
            rep.n_chunk_targets) == (12, 12, 12)
    for t in rep.targets:
        assert t.device == ("cuda" if t.impl == "cuda" else "cpu"), t.key
        want = t.n_attn_layers if t.impl == "cuda" and t.phase != "chunk" \
            else 0
        assert t.n_kernel_nodes == t.launches == want, t.key
        if t.phase == "decode":
            assert t.host_syncs == [], t.key


@pytest.mark.parametrize("kind", ["paged", "paged_q8", "dense"])
def test_decode_step_on_the_card_makes_no_host_sync(kind):
    """One decode step through the kernels, idle rows included, under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises."""
    dev = _cuda()
    import importlib
    from repro_torch.models import (forward_step, init_cache,
                                    init_paged_cache, init_paged_q8_cache)
    sw = importlib.import_module("repro_torch.lint.sweep")
    cfg, params = sw.sweep_models(dev)["merged"]
    if kind == "dense":
        cache = init_cache(cfg, 4, 64, device=dev)
    else:
        init = init_paged_cache if kind == "paged" else init_paged_q8_cache
        cache = init(cfg, 12, 8, 4, 64, device=dev)
        tbl = torch.full((4, cache.block_tables.shape[1]), -1,
                         dtype=torch.int32)
        tbl[1, :2] = torch.tensor([3, 4])
        tbl[3, :1] = 7
        cache = cache._replace(
            block_tables=tbl.to(dev),
            length=torch.tensor([0, 9, 0, 5], dtype=torch.int32, device=dev))
    toks = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=dev)
    with torch.no_grad():
        forward_step(params, cfg, toks, cache, impl="cuda")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = forward_step(params, cfg, toks, cache, impl="cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(logits.float()).all()


# ---------------------------------------------------------------------------
# chip_smoke_4.py: four cards, one NCCL rank each
# ---------------------------------------------------------------------------

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def test_chip_smoke_4_refuses_fewer_than_four_cards():
    """With one card visible the four-card script exits non-zero, names
    the count, and prints no result line (no fallback to fewer ranks, to
    gloo or to the CPU)."""
    _cuda()
    import subprocess
    import sys
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    r = subprocess.run([sys.executable, os.path.join(_ROOT,
                                                     "chip_smoke_4.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=_ROOT, env=env)
    assert r.returncode != 0
    assert "needs 4 CUDA cards" in r.stderr and "is 1" in r.stderr, r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_4_serves_and_trains_on_four_cards():
    """The four ranks of ``chip_smoke_4.py`` (every part on (1, 4), (2, 2)
    and (4, 1)) exit 0 and the script's last line counts four cards.
    Skips where fewer than four cards are present."""
    _cuda()
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four CUDA cards; {torch.cuda.device_count()} "
                    f"present")
    import json
    import subprocess
    import sys
    r = subprocess.run([sys.executable, os.path.join(_ROOT,
                                                     "chip_smoke_4.py")],
                       capture_output=True, text=True, timeout=1300,
                       cwd=_ROOT)
    assert r.returncode == 0, r.stdout[-5000:] + r.stderr[-5000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["count"] == 4, last
