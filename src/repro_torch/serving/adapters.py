"""KVCacheAdapter: the cache side of the serving API seam.

Counterpart of ``repro.serving.adapters`` for the dense cache, the paged
pool and the int8 paged pool.  The engine speaks to its cache through one
interface, so cache layouts stay out of the scheduling code; a new layout
is a new adapter plus its registered attention backends
(``models.backends``).  ``obs_gauges`` lifts a cache's telemetry into the
engine's metrics as lazy gauges (``repro_torch.obs``).

Chunked prefill (``serving.sched``) adds a third program per adapter:
``build_chunk`` binds one fixed-width slice program
(``models.forward_prefill_chunk``), and ``admit_chunked`` /
``chunk_ready`` / ``chunk_step`` / ``finish_chunked`` / ``unshield``
drive a prompt into the SHARED batched cache chunk by chunk while decode
steps go on for the other slots.  A mid-prefill slot is protected per
kind:

  * dense: the adapter keeps HOST lengths for every slot and copies them
    into the cache's device lengths before each decode step, so the step's
    write for a mid-prefill slot parks AT the chunk frontier (the next
    chunk overwrites it) and never advances the slot;
  * paged: the manager SHIELDS mid-prefill slots (their table rows ship
    as -1, so the decode write drops) while the chunk program gets the
    true row; ``unshield`` exposes the slot only after the activating
    decode step.

Under a device mesh ``place`` puts the cache on the mesh per ``pspecs``
(``distribution.sharding.serving_cache_pspecs``) and the programs take a
``qkv_sharding`` spec.  The dense cache runs on every mesh; the paged
pools raise NotImplementedError there (their page writes gather rows
through ``torch.nonzero`` and flat ``index_copy_``, which DTensors do not
carry).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import sharding as shd
from repro_torch.distribution.placed import assign_, is_placed
from repro_torch.models import (DenseChunkDest, DensePrefillDest,
                                PagedChunkDest, PagedPrefillDest,
                                PagedQ8ChunkDest, PagedQ8PrefillDest,
                                forward_prefill, forward_prefill_chunk,
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

    def build_prefill(self, impl: str, qkv_sharding=None) -> None:
        """Bind this cache kind's prefill program (a
        ``models.forward_prefill`` dispatch); ``qkv_sharding`` re-anchors
        q/k/v under a mesh."""
        raise NotImplementedError

    def pspecs(self, rules):
        """Partition specs of the device cache (mesh serving)."""
        return shd.serving_cache_pspecs(self.cfg, rules, self.device_cache())

    def place(self, mesh, rules) -> None:
        """Put the device cache on ``mesh`` per ``pspecs(rules)``."""
        raise NotImplementedError(
            f"the {self.kind!r} cache does not run under a device mesh yet")

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

    def prefill(self, params, slot: int, padded_row, true_n: int,
                n_shared: int = 0, vision=None):
        """Prefill ``padded_row`` (1, S) and install its KV for ``slot``;
        returns the last real position's logits (1, V).  ``n_shared`` is
        what ``admit`` returned: the paged pools skip writing those
        prefix-shared pages.  ``vision`` (1, nv, d_model) is a VLM
        request's patch embeddings (the dense cache only)."""
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

    # -- chunked prefill (serving.sched) ----------------------------------

    @property
    def supports_chunked(self) -> bool:
        """True when this adapter (as initialised) can run chunked
        prefill; False routes every request through the scheduler's
        monolithic whole-prompt jobs."""
        return False

    def enable_chunked(self) -> None:
        """Switch to chunked mode (host bookkeeping only), before the first
        ``device_cache()`` the scheduled engine ships."""
        raise NotImplementedError

    def build_chunk(self, chunk_tokens: int, impl: str,
                    qkv_sharding=None) -> None:
        """Bind this cache kind's fixed-width chunk program
        (``models.forward_prefill_chunk``)."""
        raise NotImplementedError

    def admit_chunked(self, slot: int, tokens: np.ndarray) -> Optional[int]:
        """Admission for a chunked prefill: reserve ``slot`` for ``tokens``
        without running anything.  Returns the prefix-shared pages (0
        where that does not apply) or None to defer."""
        raise NotImplementedError

    def chunk_ready(self, slot: int, start: int, end: int) -> bool:
        """Make the chunk's write targets writable (paged: map or recycle
        ring pages); False when out of resources (the scheduler
        preempts)."""
        return True

    def chunk_step(self, params, slot: int, chunk_row, start: int,
                   true_len: int):
        """Run ONE chunk of ``slot``'s prompt; returns the logits (1, V) of
        the chunk's last real position (meaningful on the final chunk)."""
        raise NotImplementedError

    def finish_chunked(self, slot: int, tokens: np.ndarray) -> None:
        """All chunks landed: publish the slot's full length (paged:
        register the prompt's pages for prefix sharing)."""
        raise NotImplementedError

    def unshield(self, slot: int) -> None:
        """Expose the slot to batched decode writes, after the activating
        decode step."""

    def set_length(self, slot: int, n: int) -> None:
        """Host length bookkeeping after a MONOLITHIC prefill installed
        ``n`` tokens into ``slot``."""

    def obs_gauges(self):
        """name -> (zero-arg callable, help) of this cache's telemetry,
        lifted into ``Engine.metrics`` as LAZY gauges: each reads host
        integers only, at ``collect()`` time, never on the serving path.
        The dense cache has no pool to report."""
        return {}


class DenseCacheAdapter(KVCacheAdapter):
    """Worst-case-length slot cache: every slot owns a ``max_len`` (or
    window) stretch of one batched ``DecodeCache``, and, on stacks with SSM
    layers, its scan state and conv tail, on a VLM its cross K/V over the
    request's vision tokens.  Serves every decoder stack."""

    kind = "dense"

    def init(self, cfg, sc, device):
        self.cfg, self.sc = cfg, sc
        self._cache = init_cache(cfg, sc.n_slots, sc.max_len, device=device)
        self._chunked = False

    def place(self, mesh, rules):
        self._cache = shd.distribute_tree(self._cache, self.pspecs(rules),
                                          mesh)

    def build_prefill(self, impl, qkv_sharding=None):
        dest = DensePrefillDest(cache_len=self.sc.max_len)
        cfg = self.cfg

        def run(params, tokens, true_len, vision):
            return forward_prefill(params, cfg, tokens, dest, vision=vision,
                                   impl=impl, true_len=true_len,
                                   qkv_sharding=qkv_sharding)

        self._prefill = run

    def device_cache(self):
        if self._chunked:
            # chunked mode: the HOST lengths are authoritative (a
            # mid-prefill slot's length is its chunk frontier).  One copy
            # per step from a pinned staging tensor; the previous copy must
            # have read the staging buffer before it is rewritten
            if self._staged is not None:
                self._staged.synchronize()
            self._stage_np[:] = self._lengths
            length = self._cache.length
            if is_placed(length):
                assign_(length, self._stage.to(length.device))
                return self._cache
            length.copy_(self._stage, non_blocking=True)
            if length.is_cuda:
                self._staged = torch.cuda.Event()
                self._staged.record()
        return self._cache

    def update(self, new):
        self._cache = new

    def admit(self, slot, tokens):
        return 0

    def prefill(self, params, slot, padded_row, true_n, n_shared=0,
                vision=None):
        tl = torch.full((1,), true_n, dtype=torch.int32,
                        device=padded_row.device)
        logits, one = self._prefill(params, padded_row, tl, vision)
        self._cache = kvc.insert_request(self._cache, one, slot)
        return logits

    def advance(self, slot):
        if self._chunked:
            self._lengths[slot] += 1

    def release(self, slot):
        self._cache = kvc.clear_slot(self._cache, slot)
        if self._chunked:
            self._lengths[slot] = 0

    # -- chunked prefill --------------------------------------------------

    @property
    def supports_chunked(self):
        # a BINDING window (window < max_len) makes the cache a
        # window-sized ring that cannot hold a partial prompt at absolute
        # positions: the scheduler takes monolithic jobs there
        w = self.cfg.sliding_window
        return not (w and w < self.sc.max_len)

    def enable_chunked(self):
        self._chunked = True
        self._lengths = np.zeros((self.sc.n_slots,), np.int32)
        dev = self._cache.length.device
        self._stage = torch.zeros((self.sc.n_slots,), dtype=torch.int32,
                                  pin_memory=dev.type == "cuda")
        self._stage_np = self._stage.numpy()
        self._staged = None

    def build_chunk(self, chunk_tokens, impl, qkv_sharding=None):
        cfg, max_len = self.cfg, self.sc.max_len
        self._chunk_tokens = chunk_tokens

        def run(params, tokens, start, true_len, slot):
            return forward_prefill_chunk(
                params, cfg, tokens, DenseChunkDest(self._cache, slot),
                start=start, true_len=true_len, impl=impl, max_len=max_len,
                qkv_sharding=qkv_sharding)

        self._chunk = run

    def admit_chunked(self, slot, tokens):
        self._lengths[slot] = 0
        return 0

    def chunk_step(self, params, slot, chunk_row, start, true_len):
        logits, self._cache = self._chunk(params, chunk_row, start, true_len,
                                          slot)
        self._lengths[slot] = min(start + self._chunk_tokens, true_len)
        return logits

    def finish_chunked(self, slot, tokens):
        self._lengths[slot] = len(tokens)

    def set_length(self, slot, n):
        if self._chunked:
            self._lengths[slot] = n


class PagedCacheAdapter(KVCacheAdapter):
    """Block-pool cache: slots map variable numbers of fixed-size physical
    pages (free-list allocation, prefix sharing, copy-on-write, admission
    control — ``serving.paged_kv_cache``).  Attention-only stacks: the
    manager refuses ssm and hybrid configs at construction (ValueError),
    as the reference does (SSM state has no pages).

    ``block_size``/``n_blocks`` default to the ServeConfig's values at
    ``init`` (n_blocks 0 means dense-equivalent memory: n_slots·max_len/bs
    pages).  ``prefix_retention`` (default on, as in the reference) keeps
    a released request's registered pages in the prefix cache until pool
    pressure evicts them (``pm.drop_prefix_cache()`` drops them all).
    Prefill writes the prompt's KV straight into its mapped pages
    (``forward_prefill`` with a ``PagedPrefillDest``), in place: no
    max_len-sized intermediate buffer, no second scatter pass."""

    kind = "paged"
    manager_cls = pkv.PagedCacheManager

    def __init__(self, block_size: Optional[int] = None,
                 n_blocks: Optional[int] = None,
                 prefix_retention: bool = True):
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

    def build_prefill(self, impl, qkv_sharding=None):
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

    def prefill(self, params, slot, padded_row, true_n, n_shared=0,
                vision=None):
        if vision is not None:
            raise ValueError("paged serving is attention-only: vision "
                             "prefill needs the dense cache")
        # the shared pages are the slot's first ``first_owned`` blocks:
        # prefill_block_ids marks them -1, so they are not rewritten
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

    # -- chunked prefill --------------------------------------------------

    @property
    def supports_chunked(self):
        return True

    def enable_chunked(self):
        pass  # the shields and frontiers live in the manager

    def build_chunk(self, chunk_tokens, impl, qkv_sharding=None):
        if chunk_tokens % self.pm.bs:
            raise ValueError(
                f"chunk_tokens ({chunk_tokens}) must be a multiple of the "
                f"block size ({self.pm.bs})")
        if self.pm.ring and chunk_tokens != self.pm.bs:
            raise ValueError(
                f"ring (windowed) paged chunking pins chunk_tokens to one "
                f"block ({self.pm.bs}); got {chunk_tokens}")
        cfg = self.cfg
        self._chunk_tokens = chunk_tokens

        def run(params, tokens, start, true_len, table_row, block_ids):
            return forward_prefill_chunk(
                params, cfg, tokens, self._chunk_dest(table_row, block_ids),
                start=start, true_len=true_len, impl=impl)

        self._chunk = run

    def _chunk_dest(self, table_row, block_ids):
        """The chunk's destination: the pools, the slot's true table row
        and the chunk's pages."""
        return PagedChunkDest(self.pm.k, self.pm.v, table_row, block_ids)

    def admit_chunked(self, slot, tokens):
        return self.pm.admit_chunked(slot, tokens)

    def chunk_ready(self, slot, start, end):
        return self.pm.ensure_chunk(slot, start, end)

    def chunk_step(self, params, slot, chunk_row, start, true_len):
        C = self._chunk_tokens
        dev = chunk_row.device
        bids = self.pm.chunk_block_ids(slot, start, start + C, true_len)
        # the TRUE table row (the decode view masks shielded slots), copied:
        # the manager mutates its tables between steps
        row = torch.from_numpy(self.pm.tables[slot:slot + 1].copy()).to(dev)
        logits, _ = self._chunk(params, chunk_row, start, true_len, row,
                                torch.from_numpy(bids).to(dev))
        self.pm.set_frontier(slot, min(start + C, true_len))
        return logits

    def finish_chunked(self, slot, tokens):
        self.pm.finish_chunked(slot, tokens)

    def unshield(self, slot):
        self.pm.unshield(slot)

    def obs_gauges(self):
        a, tree = self.pm.allocator, self.pm.tree
        return {
            "pool_blocks_used": (lambda: a.n_used, "pages mapped now"),
            "pool_blocks_free": (lambda: a.n_free, "pages on the free list"),
            "pool_peak_used": (lambda: a.peak_used,
                               "pool occupancy high-water (pages)"),
            "pool_recycled": (lambda: a.n_recycled,
                              "ring pages recycled in place"),
            "pool_cow": (lambda: a.n_cow, "copy-on-write page splits"),
            "pool_prefix_hits": (lambda: a.n_shared_hits,
                                 "prefix pages shared at admit"),
            "prefix_tree_nodes": (lambda: tree.n_nodes,
                                  "radix prefix-tree nodes resident"),
            "prefix_retained_pages": (
                lambda: len(tree.retained),
                "pages held only by the prefix tree (retention)"),
            "prefix_hit_tokens": (lambda: tree.hit_tokens,
                                  "prompt tokens served from the prefix "
                                  "cache"),
            "prefix_evicted": (lambda: tree.n_evicted,
                               "retained pages evicted under pressure"),
        }


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

    def _chunk_dest(self, table_row, block_ids):
        return PagedQ8ChunkDest(self.pm.k, self.pm.v, self.pm.k_scale,
                                self.pm.v_scale, table_row, block_ids)

    def obs_gauges(self):
        pm = self.pm
        # int8 pages: one byte an element; an fp16 pool of the same pages
        # takes two (sizes from the shapes: no device read)
        elems = pm.k.numel() + pm.v.numel()
        g = dict(super().obs_gauges())
        g.update({
            "q8_pool_bytes": (lambda: pm.pool_bytes,
                              "int8 pool + scale bytes resident"),
            "q8_bytes_saved_vs_fp16": (
                lambda: elems * 2 - pm.pool_bytes,
                "device memory saved vs an fp16 pool of the same page "
                "count"),
        })
        return g


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
