"""DENSE-cache slot operations over the batched ``DecodeCache``.

Counterpart of ``repro.serving.kv_cache``.  Every slot owns a fixed
``max_len`` (or window) stretch of one batched cache; these helpers write a
freshly-prefilled batch-1 cache into slot ``i`` and mark finished slots
idle.  Both update the batched cache IN PLACE (the reference donates it to
a jitted update for the same reason: no copy of the whole cache per
request).  Merged (Q/P-removed) models use the same layout — K*/V* fill
the same (L, B, Sc, Hkv, Dh) buffers — so both are style-agnostic.
"""
from __future__ import annotations

from repro_torch.models.transformer import DecodeCache


def insert_request(cache: DecodeCache, one: DecodeCache,
                   slot: int) -> DecodeCache:
    """Copy the batch-1 cache ``one`` into slot ``slot`` of ``cache``."""
    cache.k[:, slot].copy_(one.k[:, 0])
    cache.v[:, slot].copy_(one.v[:, 0])
    cache.kv_pos[slot].copy_(one.kv_pos[0])
    cache.length[slot] = one.length[0]
    return cache


def clear_slot(cache: DecodeCache, slot: int) -> DecodeCache:
    """Mark a slot idle: zero its length and invalidate its positions (its
    K/V rows need no clearing: every position is masked)."""
    cache.kv_pos[slot] = -1
    cache.length[slot] = 0
    return cache
