"""KVCacheAdapter: the cache side of the serving API seam.

Counterpart of ``repro.serving.adapters`` for the dense cache, the paged
pool and the int8 paged pool.  The engine speaks to its cache through one
interface, so cache layouts stay out of the scheduling code; a new layout
is a new adapter plus its registered attention backends
(``models.backends``).  The chunked-prefill part of the interface and the
observer gauges are later slices of the port (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (DensePrefillDest, PagedPrefillDest,
                                PagedQ8PrefillDest, forward_prefill,
                                init_cache)
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving import paged_kv_cache as pkv


class KVCacheAdapter:
    """Interface the engine drives.  Subclasses set ``kind`` to the
    cache_kind axis of the backend-registry key."""

    kind: str = "?"

    #: prompts handed to prefill are padded to a multiple of this (the
    #: engine's ``_bucket_pad`` rounds its bucket up); the int8 pool sets
    #: its page size: pages are quantized whole, so no prefill may end
    #: mid-page
    bucket_align: int = 1

    def init(self, cfg: ModelConfig, sc, device: torch.device) -> None:
        """Allocate the device cache for (cfg, ServeConfig) on ``device``."""
        raise NotImplementedError

    def build_prefill(self, impl: str) -> None:
        """Bind this cache kind's prefill program (a
        ``models.forward_prefill`` dispatch)."""
        raise NotImplementedError

    def device_cache(self):
        raise NotImplementedError

    def update(self, new) -> None:
        """Absorb the cache returned by the decode step."""
        raise NotImplementedError

    def admit(self, slot: int, tokens: np.ndarray) -> Optional[int]:
        """Admission control: the number of prefix-shared pages (0 for
        the dense cache, which always admits), or None to defer the
        request (a pool that is out of pages)."""
        raise NotImplementedError

    def prefill(self, params, slot: int, padded_row, true_n: int):
        """Prefill ``padded_row`` (1, S) and install its KV for ``slot``;
        returns the last real position's logits (1, V)."""
        raise NotImplementedError

    def ensure_appendable(self, slot: int) -> bool:
        """Make room for ``slot``'s next token; False when out of
        resources (the engine preempts).  The dense cache always has
        room."""
        return True

    def advance(self, slot: int) -> None:
        """Host bookkeeping after a decode step wrote ``slot``'s token
        (the dense cache advances its device lengths in the step)."""

    def release(self, slot: int) -> None:
        raise NotImplementedError


class DenseCacheAdapter(KVCacheAdapter):
    """Worst-case-length slot cache: every slot owns a ``max_len`` (or
    window) stretch of one batched ``DecodeCache``, and, on stacks with SSM
    layers, its scan state and conv tail.  Serves attention, ssm and
    hybrid stacks."""

    kind = "dense"

    def init(self, cfg, sc, device):
        self.cfg, self.sc = cfg, sc
        self._cache = init_cache(cfg, sc.n_slots, sc.max_len, device=device)

    def build_prefill(self, impl):
        dest = DensePrefillDest(cache_len=self.sc.max_len)
        cfg = self.cfg

        def run(params, tokens, true_len):
            return forward_prefill(params, cfg, tokens, dest, impl=impl,
                                   true_len=true_len)

        self._prefill = run

    def device_cache(self):
        return self._cache

    def update(self, new):
        self._cache = new

    def admit(self, slot, tokens):
        return 0

    def prefill(self, params, slot, padded_row, true_n):
        tl = torch.full((1,), true_n, dtype=torch.int32,
                        device=padded_row.device)
        logits, one = self._prefill(params, padded_row, tl)
        self._cache = kvc.insert_request(self._cache, one, slot)
        return logits

    def release(self, slot):
        self._cache = kvc.clear_slot(self._cache, slot)


class PagedCacheAdapter(KVCacheAdapter):
    """Block-pool cache: slots map variable numbers of fixed-size physical
    pages (free-list allocation, prefix sharing, copy-on-write, admission
    control — ``serving.paged_kv_cache``).  Attention-only stacks: the
    manager refuses ssm and hybrid configs at construction (ValueError),
    as the reference does (SSM state has no pages).

    ``block_size``/``n_blocks`` default to the ServeConfig's values at
    ``init`` (n_blocks 0 means dense-equivalent memory: n_slots·max_len/bs
    pages).  Prefill writes the prompt's KV straight into its mapped pages
    (``forward_prefill`` with a ``PagedPrefillDest``), in place: no
    max_len-sized intermediate buffer, no second scatter pass."""

    kind = "paged"
    manager_cls = pkv.PagedCacheManager

    def __init__(self, block_size: Optional[int] = None,
                 n_blocks: Optional[int] = None,
                 prefix_retention: bool = False):
        self._block_size, self._n_blocks = block_size, n_blocks
        self._prefix_retention = prefix_retention

    def init(self, cfg, sc, device):
        self.cfg, self.sc = cfg, sc
        bs = self._block_size or sc.block_size
        n_blocks = self._n_blocks or sc.n_blocks \
            or sc.n_slots * (sc.max_len // bs)
        self.pm = self.manager_cls(
            cfg, n_slots=sc.n_slots, max_len=sc.max_len, block_size=bs,
            n_blocks=n_blocks, prefix_retention=self._prefix_retention,
            device=device)

    def build_prefill(self, impl):
        cfg = self.cfg

        def run(params, tokens, true_len, block_ids):
            return forward_prefill(params, cfg, tokens, self._dest(block_ids),
                                   impl=impl, true_len=true_len)

        self._prefill = run

    def _dest(self, block_ids):
        """The prefill destination: the mapped pages of the pools."""
        return PagedPrefillDest(self.pm.k, self.pm.v, block_ids)

    def device_cache(self):
        return self.pm.device_cache()

    def update(self, new):
        pass  # the step wrote the pools in place; tables live on the host

    def admit(self, slot, tokens):
        return self.pm.admit(slot, tokens)

    def prefill(self, params, slot, padded_row, true_n):
        dev = padded_row.device
        bids = self.pm.prefill_block_ids(slot, padded_row.shape[1])
        tl = torch.full((1,), true_n, dtype=torch.int32, device=dev)
        logits, _ = self._prefill(params, padded_row, tl,
                                  torch.from_numpy(bids).to(dev))
        return logits

    def ensure_appendable(self, slot):
        return self.pm.ensure_appendable(slot)

    def advance(self, slot):
        self.pm.advance(slot)

    def release(self, slot):
        self.pm.release(slot)


class PagedQ8CacheAdapter(PagedCacheAdapter):
    """The block-pool cache with int8 pages and per-(page, kv-head)
    float32 scales (``pkv.PagedQ8CacheManager``).  Everything on the host
    (allocator, tables, copy-on-write, ring recycling, prefix sharing) is
    the paged adapter's: a page id means the same thing, and its scale
    rows travel with it.  What differs is on the device: the prefill
    writes ints and scales (``PagedQ8PrefillDest``), the decode step reads
    a ``PagedQ8DecodeCache`` through the registered ``paged_q8``
    backends, and prompts are padded to whole pages (``bucket_align``).
    The pools take a quarter of float32 pools' bytes (half of bfloat16's)
    plus 8 bytes of scales per page, kv head and layer."""

    kind = "paged_q8"
    manager_cls = pkv.PagedQ8CacheManager

    @property
    def bucket_align(self) -> int:
        return self.pm.bs

    def _dest(self, block_ids):
        return PagedQ8PrefillDest(self.pm.k, self.pm.v, self.pm.k_scale,
                                  self.pm.v_scale, block_ids)


def make_adapter(kind: str) -> KVCacheAdapter:
    """Adapter for a cache-kind name."""
    if kind == "dense":
        return DenseCacheAdapter()
    if kind == "paged":
        return PagedCacheAdapter()
    if kind == "paged_q8":
        return PagedQ8CacheAdapter()
    raise ValueError(
        f"unknown cache kind {kind!r}; expected 'dense', 'paged', "
        "'paged_q8' or a KVCacheAdapter instance")
