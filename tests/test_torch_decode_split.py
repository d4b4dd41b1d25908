"""The decode kernel's split plan (``kernels.decode_attention.kv_split``),
held without a card.

The CUDA decode body cuts the kv axis of each (batch, kv head) into
``n_split`` ranges of ``chunk`` keys; the splits of one (batch, kv head)
form one thread-block cluster, which combines them inside the kernel, so
``n_split`` may not exceed the cluster cap (``MAX_SPLIT``), every chunk
must be whole 64-key tiles, the chunks must cover the kv axis, and no split
may start past it (a cluster rank with no keys would still be launched).
The shapes are those ``chip_smoke.py``, the card tests and the engines give
the plan: Mistral-7B's and Hymba-1.5B's kv heads, dense caches of their
``max_len``, absolute page tables (MB * bs) and ring tables
(``paged_ring_blocks(window, bs) * bs``), B from 1 to 16, kv axes up to
4096.
"""
import pytest

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels.paging import paged_ring_blocks

ARCHS = ("mistral-7b", "hymba-1.5b")
BATCHES = (1, 2, 3, 4, 8, 16)
PAGES = (4, 8, 16)  # block sizes of the engines and the tests


def _kv_axes(kind, window):
    """Kv axis lengths of ``kind``: dense max_len, absolute MB * bs, or
    ring tables for the arch's window and the small test windows."""
    if kind == "dense":
        return (1, 63, 64, 65, 70, 200, 512, 1000, 1024, 2048, 4096)
    if kind == "absolute":
        return tuple(mb * bs for bs in PAGES for mb in (1, 3, 4, 5, 32, 64,
                                                        256)
                     if mb * bs <= 4096)
    return tuple(paged_ring_blocks(w, bs) * bs for bs in PAGES
                 for w in (10, 24, 64, 1024, window)
                 if paged_ring_blocks(w, bs) * bs <= 4096 + bs)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["dense", "absolute", "ring"])
@pytest.mark.parametrize("B", BATCHES)
def test_kv_split_plan_fits_the_cluster_and_covers_the_axis(arch, kind, B):
    cfg = get_config(arch)
    Hkv = cfg.n_kv_heads
    want = -(-dk._TARGET_BLOCKS // (B * Hkv))
    for S in _kv_axes(kind, cfg.sliding_window):
        n_split, chunk = dk.kv_split(B, Hkv, S)
        assert 1 <= n_split <= dk.MAX_SPLIT, (S, n_split)
        assert n_split <= want, (S, n_split)
        assert chunk >= dk.TILE and chunk % dk.TILE == 0, (S, chunk)
        assert n_split * chunk >= S, (S, n_split, chunk)
        assert (n_split - 1) * chunk < S, (S, n_split, chunk)
        # the chunk is the fewest whole tiles that cover the axis in
        # min(want, MAX_SPLIT) ranges
        per = -(-S // min(want, dk.MAX_SPLIT))
        assert chunk - dk.TILE < per <= chunk, (S, chunk)


@pytest.mark.parametrize("B,Hkv,S,plan", [
    (4, 8, 512, (8, 64)),  # Mistral rows 4-5 and the dense serving cache
    (4, 5, 512, (8, 64)),  # Hymba's row 4
    (4, 5, 1024, (8, 128)),  # Hymba's serving cache: two tiles a split
    (1, 8, 4096, (8, 512)),  # long cache, cluster cap reached
    (1, 5, 4096, (8, 512)),
    (3, 8, 4096, (8, 512)),  # whole splits masked (card test)
    (16, 8, 4096, (3, 1408)),  # enough blocks: fewer, longer splits
    (4, 8, 80, (2, 64)),  # ring of 5 pages of 16 (window 64)
    (3, 2, 200, (4, 64)),  # the card tests' dense grid
    (64, 8, 512, (1, 512)),  # the grid alone fills the card
])
def test_kv_split_plan_at_the_card_shapes(B, Hkv, S, plan):
    assert dk.kv_split(B, Hkv, S) == plan
