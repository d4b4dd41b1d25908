"""The decode kernel's split plan (``kernels.decode_attention.kv_split``),
held without a card.

The CUDA decode body cuts the kv axis of each (batch, kv head, group
part) into ``n_split`` ranges of ``chunk`` keys (a group of G query heads
is cut into ``group_parts(G)`` parts of at most 8 heads); the splits of
one (batch, kv head, part) form one thread-block cluster, which combines them inside the kernel, so
``n_split`` may not exceed the cluster cap (``MAX_SPLIT``), every chunk
must be whole 64-key tiles, the chunks must cover the kv axis, and no split
may start past it (a cluster rank with no keys would still be launched).
The shapes are those ``chip_smoke.py``, the card tests and the engines give
the plan: the kv heads and groups of every attention config of the port
(Mistral-7B, Hymba-1.5B and the dense configs up to ChatGLM3-6B's G 16), dense caches of their
``max_len``, absolute page tables (MB * bs) and ring tables
(``paged_ring_blocks(window, bs) * bs``), B from 1 to 16, kv axes up to
4096.
"""
import pytest

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels.paging import paged_ring_blocks

ARCHS = ("mistral-7b", "hymba-1.5b", "llama3.2-1b", "phi3-medium-14b",
         "qwen2.5-32b", "pythia-6.9b", "chatglm3-6b")
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
    # a config without a window (0) has no ring of its own
    return tuple(paged_ring_blocks(w, bs) * bs for bs in PAGES
                 for w in (10, 24, 64, 1024, window)
                 if w and paged_ring_blocks(w, bs) * bs <= 4096 + bs)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["dense", "absolute", "ring"])
@pytest.mark.parametrize("B", BATCHES)
def test_kv_split_plan_fits_the_cluster_and_covers_the_axis(arch, kind, B):
    cfg = get_config(arch)
    Hkv, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    want = -(-dk._TARGET_BLOCKS // (B * Hkv * dk.group_parts(G)))
    for S in _kv_axes(kind, cfg.sliding_window):
        n_split, chunk = dk.kv_split(B, Hkv, S, G)
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


@pytest.mark.parametrize("B,Hkv,S,G,plan", [
    (4, 2, 512, 16, (8, 64)),  # ChatGLM3's decode rows: 2 parts, 128 blocks
    (4, 2, 512, 12, (8, 64)),  # a part that is not full
    (16, 2, 4096, 16, (5, 832)),  # 64 clusters: fewer, longer splits
    (64, 2, 512, 16, (2, 256)),  # 256 (batch, kv head, part) triples
    (64, 2, 512, 8, (3, 192)),  # one part: half the blocks per split
])
def test_kv_split_counts_the_group_parts(B, Hkv, S, G, plan):
    assert dk.kv_split(B, Hkv, S, G) == plan


def test_group_parts_cut_the_group_into_eights():
    assert [dk.group_parts(G) for G in range(1, 17)] == [1] * 8 + [2] * 8
    assert dk.MAX_G == 2 * dk.PART_G == 16
