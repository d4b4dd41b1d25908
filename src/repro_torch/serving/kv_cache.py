"""DENSE-cache slot operations over the batched ``DecodeCache``.

Counterpart of ``repro.serving.kv_cache``.  Every slot owns a fixed
``max_len`` (or window) stretch of one batched cache; these helpers write a
freshly-prefilled batch-1 cache into slot ``i`` and mark finished slots
idle.  Both update the batched cache IN PLACE (the reference donates it to
a jitted update for the same reason: no copy of the whole cache per
request).  Merged (Q/P-removed) models use the same layout — K*/V* fill
the same (L, B, Sc, Hkv, Dh) buffers — so both are style-agnostic.
Stacks with SSM layers also keep each slot's scan state (L, B, H, P, N)
and conv tail (L, B, W-1, C); a pure SSM stack has no K/V at all.  A VLM
keeps each slot's cross K/V over its vision tokens (n_groups, B, nv, Hkv,
Dh).
"""
from __future__ import annotations

from repro_torch.distribution.placed import put_
from repro_torch.models.transformer import DecodeCache

_ALL = slice(None)


def insert_request(cache: DecodeCache, one: DecodeCache,
                   slot: int) -> DecodeCache:
    """Copy the batch-1 cache ``one`` into slot ``slot`` of ``cache``:
    K/V and positions where the stack has attention, the SSM state and
    conv tail where it has SSM layers, a VLM's cross K/V.  Under a mesh
    (DTensors) each rank writes the part of the slot in its own shard."""
    if cache.k is not None:
        put_(cache.k, (_ALL, slot), one.k[:, 0])
        put_(cache.v, (_ALL, slot), one.v[:, 0])
        put_(cache.kv_pos, (slot,), one.kv_pos[0])
    if cache.cross_k is not None:
        put_(cache.cross_k, (_ALL, slot), one.cross_k[:, 0])
        put_(cache.cross_v, (_ALL, slot), one.cross_v[:, 0])
    if cache.ssm is not None:
        put_(cache.ssm.ssm, (_ALL, slot), one.ssm.ssm[:, 0])
        put_(cache.ssm.conv, (_ALL, slot), one.ssm.conv[:, 0])
    put_(cache.length, (slot,), one.length[0])
    return cache


def clear_slot(cache: DecodeCache, slot: int) -> DecodeCache:
    """Mark a slot idle: zero its length and invalidate its positions (its
    K/V rows need no clearing: every position is masked).  Its SSM state
    needs none either: the next request's insert overwrites all of it, and
    an idle slot's state is never read into a live stream."""
    if cache.kv_pos is not None:
        put_(cache.kv_pos, (slot,), -1)
    put_(cache.length, (slot,), 0)
    return cache
