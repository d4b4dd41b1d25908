"""The port's CUDA kernels against their plain versions, on the card.

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
@pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (8, 64)])
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
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq", [1, 37, 130])
@pytest.mark.parametrize("window", [0, 17])
def test_flash_kernels_match_plain(dtype, D, Sq, window):
    dev = _cuda()
    rng = np.random.default_rng(D + Sq + window)
    B, Hq, Hkv = 2, 8, 2
    u = torch.from_numpy(rng.standard_normal((B, Sq, Hq, D),
                                             np.float32)).to(dev, dtype)
    k = torch.from_numpy(rng.standard_normal((B, Sq, Hkv, D),
                                             np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal((B, Sq, Hkv, D),
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
