"""KVCacheAdapter: the cache side of the serving API seam.

Counterpart of ``repro.serving.adapters`` for the dense cache.  The engine
speaks to its cache through one interface, so cache layouts stay out of
the scheduling code; a new layout is a new adapter plus its registered
attention backends (``models.backends``).  The paged and int8 pools are
later slices of the port (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import DensePrefillDest, forward_prefill, init_cache
from repro_torch.serving import kv_cache as kvc


class KVCacheAdapter:
    """Interface the engine drives.  Subclasses set ``kind`` to the
    cache_kind axis of the backend-registry key."""

    kind: str = "?"

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

    def admit(self, slot: int, tokens: np.ndarray) -> bool:
        """Admission control: False defers the request (a pool that is out
        of pages); the dense cache always admits."""
        raise NotImplementedError

    def prefill(self, params, slot: int, padded_row, true_n: int):
        """Prefill ``padded_row`` (1, S) and install its KV for ``slot``;
        returns the last real position's logits (1, V)."""
        raise NotImplementedError

    def release(self, slot: int) -> None:
        raise NotImplementedError


class DenseCacheAdapter(KVCacheAdapter):
    """Worst-case-length slot cache: every slot owns a ``max_len`` (or
    window) stretch of one batched ``DecodeCache``."""

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
        return True

    def prefill(self, params, slot, padded_row, true_n):
        tl = torch.full((1,), true_n, dtype=torch.int32,
                        device=padded_row.device)
        logits, one = self._prefill(params, padded_row, tl)
        self._cache = kvc.insert_request(self._cache, one, slot)
        return logits

    def release(self, slot):
        self._cache = kvc.clear_slot(self._cache, slot)


def make_adapter(kind: str) -> KVCacheAdapter:
    """Adapter for a cache-kind name."""
    if kind == "dense":
        return DenseCacheAdapter()
    raise ValueError(
        f"unknown cache kind {kind!r}; the port serves 'dense' (the paged "
        "and int8 pools are queued in ROADMAP.md) or a KVCacheAdapter "
        "instance")
