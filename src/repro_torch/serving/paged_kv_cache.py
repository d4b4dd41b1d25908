"""Paged KV cache: a block pool + free-list allocator + per-slot block tables.

Counterpart of ``repro.serving.paged_kv_cache`` (vLLM-style serving
memory).  The dense ``DecodeCache`` sizes every slot for the worst-case
sequence; here physical memory is a pool of fixed (block_size, Hkv, Dh)
pages per layer and each request maps only the pages its sequence
occupies.

Division of labor:
  * DEVICE — the page pools, (L, NB, bs, Hkv, Dh) tensors on the engine's
    device, updated IN PLACE: the prefill program writes a prompt's KV
    straight into its mapped pages (``models.forward_prefill`` with a
    ``PagedPrefillDest``), the decode step appends each token's row
    (``models.forward_step``), and ``copy_block`` implements
    copy-on-write.  Nothing here reallocates.  The int8 pool
    (``PagedQ8CacheManager``) adds per-(page, kv-head) scale arrays that
    travel with their page; it differs from the fp manager only in the
    pool hooks (``_init_pools``, ``_copy_block_device``).
  * HOST — ``BlockAllocator`` (free list + per-page refcounts) and
    ``PagedCacheManager`` (block tables, admission, prefix sharing,
    copy-on-write policy, ring recycling).  Tables and lengths are numpy
    int32 arrays, copied to the device once per step
    (``device_cache``).

Prefix sharing: requests with identical prompt prefixes map the same
physical pages, registered in a radix tree over block-aligned token runs
(``serving.radix_tree``).  Full prompt blocks are immutable once written;
the trailing PARTIAL block is registered under the entire prompt and may
later be extended by its owner's decoded tokens, which is safe because a
sharer's causal mask hides positions beyond its own length and any append
into a page with refcount > 1 first copies it (copy-on-write).  Sharing
is exact, so the greedy streams are the same with it as without it.

Retention (``prefix_retention``, on by default as in the reference): the
pages of a released request that the tree references are ADOPTED instead
of freed (``BlockAllocator.retain``: the tree becomes a holder), so a
popular prefix outlives its last sharer and later requests hit it warm.
Retained pages are reclaimable: ``_alloc`` evicts LRU leaf-end pages that
only the tree holds before reporting the pool exhausted, and
``drop_prefix_cache`` evicts them all.  The refcount invariant becomes
``ref[p] == live slots mapping p + (1 if tree-retained)``; every write
path already copies on write at ref > 1, so a retained page that is
shared again is never written in place.  With retention off the registry
dies with its pages' last sharer.

Chunked prefill (``serving.sched``): ``admit_chunked`` maps a prompt
without running anything, the chunk methods (``ensure_chunk``,
``chunk_block_ids``, ``set_frontier``, ``finish_chunked``) walk it in,
and the slot stays SHIELDED until the scheduler activates it: its table
row ships as -1 in ``device_cache()``, so interleaved decode steps drop
their write for it.

Sliding-window ring-of-pages: with a sliding window a request's block
table is a bounded RING of ``ceil(window/bs)+1`` slots (absolute block b
at slot b % ring — ``kernels.paging``):

  * ``admit`` maps (and prefix-shares) only the LIVE window's blocks of
    the prompt, and ``prefill_block_ids`` marks the dead ones -1 so the
    direct-to-page write drops them;
  * on entering a new absolute block, ``ensure_appendable`` RECYCLES the
    ring slot's stale page in place (every offset of the recycled page
    reconstructs to a position beyond the query until decode overwrites
    it).  A stale page that is still prefix-SHARED is detached instead
    (the ring variant of copy-on-write: release our reference and take a
    fresh page), so a sharer's window rolling forward never corrupts a
    slower peer;
  * recycling a solely-owned page drops its registry entries.  Prompts
    longer than the window register nothing: a prefix chain must start
    at block 0, which such a prompt no longer maps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution.placed import copy_page_, place_local
from repro_torch.models.transformer import (PagedDecodeCache,
                                            init_paged_cache,
                                            init_paged_q8_cache, layer_plan,
                                            paged_table_blocks)
from repro_torch.serving.radix_tree import RadixPrefixTree


def copy_block(k_pool: torch.Tensor, v_pool: torch.Tensor, src: int,
               dst: int) -> None:
    """Copy-on-write: duplicate physical page ``src`` into ``dst`` in
    every layer of the (L, NB, bs, Hkv, Dh) pools, in place.  On placed
    pools whose pages split over the model axis the page travels from the
    rank that holds ``src`` to the one that holds ``dst``
    (``placed.copy_page_``); nothing is read on the host."""
    copy_page_(k_pool, src, dst)
    copy_page_(v_pool, src, dst)


def copy_block_q8(k_pool: torch.Tensor, v_pool: torch.Tensor,
                  k_scale: torch.Tensor, v_scale: torch.Tensor, src: int,
                  dst: int) -> None:
    """Copy-on-write on the int8 pool: a page's ints and its (L, Hkv)
    scale rows are one unit, copied together in place (a copy without its
    scales would dequantize under the wrong scale); split the same way,
    the scale rows travel with their page."""
    copy_block(k_pool, v_pool, src, dst)
    copy_page_(k_scale, src, dst)
    copy_page_(v_scale, src, dst)


# ---------------------------------------------------------------------------
# host-side free-list allocator
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Free list + refcounts over ``n_blocks`` physical pages.

    Refcount > 1 means the page is prefix-shared; writers must
    copy-on-write (the manager enforces this, the allocator only counts).
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks))
        self.ref = np.zeros((n_blocks,), np.int32)
        # counters the engine, the tests and chip_smoke.py read
        self.peak_used = 0
        self.n_cow = 0
        self.n_shared_hits = 0
        self.n_recycled = 0  # windowed ring: stale pages reused in place

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages (refcount 1 each); None if the pool is exhausted."""
        if n > len(self._free):
            return None
        ids, self._free = self._free[:n], self._free[n:]
        for i in ids:
            self.ref[i] = 1
        self.peak_used = max(self.peak_used, self.n_used)
        return ids

    def retain(self, ids: List[int]) -> None:
        """Take a reference without counting a shared hit: the prefix tree
        adopting a released request's pages, or an admission pinning its
        matched chain against eviction before it knows it will succeed."""
        for i in ids:
            if self.ref[i] <= 0:
                raise RuntimeError(f"retain of free page {i}")
            self.ref[i] += 1

    def release(self, ids: List[int]) -> List[int]:
        """Drop one reference per page; returns the pages that became free."""
        freed = []
        for i in ids:
            if self.ref[i] <= 0:
                raise RuntimeError(f"release of free page {i}")
            self.ref[i] -= 1
            if self.ref[i] == 0:
                self._free.append(i)
                freed.append(i)
        return freed


class RequestPageHwm:
    """Running max / count / last of per-request page high-water marks
    (three ints, O(1) in requests served)."""

    __slots__ = ("max", "count", "last")

    def __init__(self):
        self.max = 0
        self.count = 0
        self.last = 0

    def record(self, hwm: int) -> None:
        if hwm > self.max:
            self.max = hwm
        self.last = hwm
        self.count += 1

    def __bool__(self) -> bool:
        return self.count > 0

    def __repr__(self):
        return (f"RequestPageHwm(max={self.max}, last={self.last}, "
                f"count={self.count})")


# ---------------------------------------------------------------------------
# manager: tables + admission + prefix sharing + copy-on-write
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SlotInfo:
    blocks: List[int]  # physical pages: logical order (absolute mode) or
    #                    ring-slot order with -1 unmapped (ring mode)
    abs_blocks: Optional[List[int]] = None  # ring mode: absolute block
    #                    currently held per ring slot (-1 = never entered)
    first_owned: int = 0  # first absolute block NOT prefix-shared (the
    #                       prefill write starts here)
    hwm: int = 0  # most pages this request ever mapped at once


class PagedCacheManager:
    """Owns the device pools and every host-side paging decision.

    The engine calls, per request lifecycle:
      ``admit(slot, tokens)``        admission control + prefix sharing
      ``prefill_block_ids(slot, …)`` per-logical-block destinations for
                                     the direct-to-page prefill write
      ``ensure_appendable(slot)``    map/recycle/CoW the page ``length``
                                     falls in
      ``advance(slot)`` / ``release(slot)``
    and per decode step ``device_cache()``.  The scheduler's chunked
    prefill replaces ``admit``/``prefill_block_ids`` by ``admit_chunked``,
    ``ensure_chunk``, ``chunk_block_ids``, ``set_frontier``,
    ``finish_chunked`` and ``unshield``.

    The pools ``k``/``v`` are (L, NB, bs, Hkv, Dh) tensors on ``device``,
    zero-filled at construction and written in place by the prefill and
    decode programs.  Every host-side decision here moves whole pages and
    never looks inside one; what a page is on the device lives behind two
    hooks, ``_init_pools`` and ``_copy_block_device``, which a new pool
    layout overrides (``PagedQ8CacheManager``).
    """

    def __init__(self, cfg: ModelConfig, *, n_slots: int, max_len: int,
                 block_size: int, n_blocks: int,
                 prefix_retention: bool = True, device="cuda"):
        if layer_plan(cfg)["kind"] != "attn":
            raise ValueError("paged serving supports attention-only stacks")
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} must be a multiple of the "
                             f"block size {block_size}")
        self.cfg = cfg
        self.bs = block_size
        self.max_blocks = max_len // block_size  # admission bound
        # table width: the ring bound when a sliding window makes it
        # strictly smaller than the absolute table (kernels.paging derives
        # ring addressing from this width: one rule for writer and readers)
        self.table_blocks = paged_table_blocks(cfg, block_size, max_len)
        self.ring = self.table_blocks if self.table_blocks < self.max_blocks \
            else 0
        self.n_slots = n_slots
        self._init_pools(cfg, n_blocks, block_size, n_slots, max_len, device)
        self._placed = None  # (mesh, table placements, length placements)
        self.tables = np.full((n_slots, self.table_blocks), -1, np.int32)
        self.lengths = np.zeros((n_slots,), np.int32)
        self.allocator = BlockAllocator(n_blocks)
        self._slots: Dict[int, _SlotInfo] = {}
        # slots mid-CHUNKED-prefill: their table rows ship as -1 in
        # device_cache(), so interleaved decode steps drop their write
        self.shielded: set = set()
        self.request_page_hwm = RequestPageHwm()
        self.prefix_retention = prefix_retention
        self.tree = RadixPrefixTree(block_size)

    @property
    def ring_bound(self) -> int:
        """Most pages one request may ever hold: ``ceil(window/bs)+1``
        under a sliding window, else the full table."""
        return self.ring or self.max_blocks

    # -- pool representation hooks ---------------------------------------

    def _init_pools(self, cfg: ModelConfig, n_blocks: int, block_size: int,
                    n_slots: int, max_len: int, device) -> None:
        """Allocate the device cache whose pools this manager owns
        (``self._pools``; its tables and lengths are replaced by every
        ``device_cache``)."""
        self._pools = init_paged_cache(cfg, n_blocks, block_size, n_slots,
                                       max_len, device=device)

    def _copy_block_device(self, src: int, dst: int) -> None:
        """Copy-on-write of page ``src`` into ``dst`` on the device."""
        copy_block(self.k, self.v, src, dst)

    def place(self, mesh, specs) -> None:
        """Put the pools (and scales) on ``mesh`` per ``specs``, a spec tree
        of the device cache (``sharding.paged_cache_pspecs`` or
        ``paged_q8_cache_pspecs``; after ``evenly``): their page axis over
        the model axis.  Every later ``device_cache`` ships its tables and
        lengths with their specs' placements (batch over the data axes)."""
        from repro_torch.distribution import sharding as shd

        specs = shd.evenly(specs, self._pools, mesh)
        self._pools = shd.distribute_tree(
            self._pools, specs._replace(block_tables=None, length=None),
            mesh)
        tm = shd.torch_mesh(mesh)
        self._placed = (tm, shd.placements(specs.block_tables, tm),
                        shd.placements(specs.length, tm))

    # -- device view ----------------------------------------------------

    @property
    def k(self) -> torch.Tensor:
        return self._pools.k

    @property
    def v(self) -> torch.Tensor:
        return self._pools.v

    def device_cache(self, upload=None) -> PagedDecodeCache:
        """The pools (a ``PagedDecodeCache``, or a ``PagedQ8DecodeCache``
        from the int8 manager) with a COPY of the host tables and lengths
        on the pools' device: the manager mutates its numpy arrays between
        steps, and ``torch.from_numpy(...).to("cpu")`` would share their
        memory.  ``upload(array)`` makes each copy: the engine's step
        passes its counted ingestion seam (``Engine.host_to_device``); by
        default a plain copy to the pools' device.  On a mesh (``place``)
        each rank keeps its rows of the tables and lengths, placed
        batch-sharded; every rank's host copy is the same, so no
        collective runs."""
        if upload is None:
            dev = self.k.device
            upload = lambda x: torch.from_numpy(x.copy()).to(dev)  # noqa: E731
        tbl = self.tables.copy()
        if self.shielded:
            # mid-chunked-prefill slots: the decode step's write for them
            # drops and its output for them is discarded; the true rows
            # stay on the host and feed the chunk programs
            tbl[sorted(self.shielded), :] = -1
        tables = upload(tbl)
        length = upload(self.lengths)
        if self._placed is not None:
            mesh, tp, lp = self._placed
            tables = place_local(tables, mesh, tp)
            length = place_local(length, mesh, lp)
        return self._pools._replace(block_tables=tables, length=length)

    def host_mutable_buffers(self):
        """Named numpy buffers this manager mutates in place between steps:
        the ones ``device_cache`` must copy before they reach the device
        and ``repro_torch.lint.aliasing`` checks program inputs against."""
        return {"pm.tables": self.tables, "pm.lengths": self.lengths,
                "pm.allocator.ref": self.allocator.ref}

    @property
    def pool_bytes(self) -> int:
        """Resident bytes of the pools (and of their scales, if any); on a
        mesh, of the whole (global) pools, as the reference counts them."""
        return sum(t.numel() * t.element_size()
                   for name, t in self._pools._asdict().items()
                   if name not in ("block_tables", "length"))

    # -- prefix sharing (radix tree) -------------------------------------

    def _drop_page(self, bid: int) -> None:
        """Page ``bid``'s bytes are being rewritten (ring recycle) or it
        was freed: its registry entries, and the subtree they anchor, die
        with it.  Retained pages that fall out with the subtree lose the
        tree's reference here.  Such an orphan is not necessarily freed
        by that release: a live slot whose ring already rolled past
        ``bid`` may still map a retained descendant, and the page then
        dies with its last slot."""
        orphans = self.tree.drop_page(bid)
        if orphans:
            self.allocator.release(orphans)

    def _alloc(self, n: int) -> Optional[List[int]]:
        """``allocator.alloc`` with retention-aware admission: under pool
        pressure, reclaim LRU retained leaf-end pages whose only reference
        is the tree's before reporting exhaustion (a page a live slot maps
        has ref >= 1 from the slot, so the ref == 1 guard can only free
        tree-only pages)."""
        ids = self.allocator.alloc(n)
        if ids is not None or not self.prefix_retention:
            return ids
        evicted = self.tree.evict(
            n - self.allocator.n_free,
            lambda p: int(self.allocator.ref[p]) == 1)
        if evicted:
            freed = self.allocator.release(evicted)
            if len(freed) != len(evicted):
                raise RuntimeError("an evicted page had holders beyond the "
                                   "prefix tree")
        return self.allocator.alloc(n)

    def drop_prefix_cache(self) -> int:
        """Evict EVERY reclaimable retained page (returns the pool to its
        live requests' pages; retained pages a live sharer still maps
        stay).  Returns the pages reclaimed."""
        evicted = self.tree.evict(
            self.allocator.n_blocks,
            lambda p: int(self.allocator.ref[p]) == 1)
        if evicted:
            self.allocator.release(evicted)
        return len(evicted)

    # -- request lifecycle ----------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.bs)

    def _first_live_block(self, n_tokens: int) -> int:
        """First absolute block any future query can still attend: the
        next decode query sits at position ``n_tokens`` and reaches back
        to ``n_tokens - window + 1``; earlier blocks are never mapped (0
        without a window)."""
        if not self.ring:
            return 0
        return max(0, n_tokens - self.cfg.sliding_window + 1) // self.bs

    def admit(self, slot: int, tokens: np.ndarray) -> Optional[int]:
        """Try to map ``tokens`` into ``slot``.  Returns the number of
        prefix-SHARED pages, or None when the pool is exhausted (admission
        control: the caller retries after other requests finish).  A
        prompt longer than ``max_len`` raises ValueError.

        Ring mode maps only the live window's blocks; a prompt longer than
        the window shares and registers nothing."""
        nb = self.blocks_for(len(tokens))
        if nb > self.max_blocks:
            raise ValueError(
                f"prompt of {len(tokens)} tokens exceeds max_len "
                f"({self.max_blocks * self.bs})")
        b_min = self._first_live_block(len(tokens))
        shared, covered = self.tree.match(tokens) if b_min == 0 else ([], 0)
        # pin the matched chain BEFORE allocating: _alloc may evict
        # retained pages, and the pages just matched must not be among them
        self.allocator.retain(shared)
        fresh = self._alloc(nb - b_min - len(shared))
        if fresh is None:
            if self.allocator.release(shared):  # unpin
                raise RuntimeError("a pinned tree page had no other holder")
            return None
        self.allocator.n_shared_hits += len(shared)
        self.tree.hit_tokens += covered
        chain = shared + fresh  # absolute blocks b_min..nb-1, in order
        if self.ring:
            pages = [-1] * self.ring
            absb = [-1] * self.ring
            for i, bid in enumerate(chain):
                pages[(b_min + i) % self.ring] = bid
                absb[(b_min + i) % self.ring] = b_min + i
            info = _SlotInfo(blocks=pages, abs_blocks=absb,
                             first_owned=b_min + len(shared), hwm=len(chain))
        else:
            info = _SlotInfo(blocks=chain, first_owned=len(shared),
                             hwm=len(chain))
        self._slots[slot] = info
        self.tables[slot, :] = -1
        self.tables[slot, :len(info.blocks)] = info.blocks
        self.lengths[slot] = len(tokens)
        if b_min == 0:
            self.tree.insert(tokens, chain)
        return len(shared)

    def prefill_block_ids(self, slot: int, padded_len: int) -> np.ndarray:
        """Physical destination per logical (absolute) block of a (bucket-
        padded) prefill.  Entries are -1 (the write drops them) for
        prefix-SHARED pages, bucket-padding blocks past the prompt and,
        under a sliding window, prompt blocks already out of every future
        query's window (never mapped)."""
        info = self._slots[slot]
        nb = self.blocks_for(int(self.lengths[slot]))
        nbk = -(-padded_len // self.bs)
        if nbk < nb:
            raise ValueError(f"padded length {padded_len} is shorter than "
                             f"the prompt ({self.lengths[slot]} tokens)")
        ids = np.full((nbk,), -1, np.int32)
        if self.ring:
            for b in range(info.first_owned, nb):
                ids[b] = info.blocks[b % self.ring]
        else:
            ids[info.first_owned:nb] = info.blocks[info.first_owned:nb]
        return ids

    def _cow(self, slot: int, info: _SlotInfo, idx: int, *,
             copy: bool) -> bool:
        """Detach table entry ``idx`` from its shared page onto a fresh
        one.  ``copy`` copies the bytes on the device (mid-block append:
        earlier offsets are live shared content); a windowed recycle skips
        the copy (every offset of the new block is rewritten before any
        query can attend it)."""
        bid = info.blocks[idx]
        # _alloc may evict retained pages; the source is safe: its ref > 1
        # (why it is detached) fails the eviction guard
        fresh = self._alloc(1)
        if fresh is None:
            return False
        if copy:
            self._copy_block_device(bid, fresh[0])
        self.allocator.release([bid])
        info.blocks[idx] = fresh[0]
        self.tables[slot, idx] = fresh[0]
        self.allocator.n_cow += 1
        return True

    def _ensure_ring_block(self, slot: int, info: _SlotInfo, b: int) -> bool:
        """Make absolute block ``b``'s ring slot safely writable: map it if
        never entered, CoW if shared at the same block, and RECYCLE the
        slot's out-of-window page when the window rolled past it (in place
        when solely owned; detached via ``_cow`` when a prefix-sharing
        peer still holds it).  Returns False on pool exhaustion."""
        rs = b % self.ring
        bid = info.blocks[rs]
        if bid < 0:  # ring slot never entered: map a fresh page
            fresh = self._alloc(1)
            if fresh is None:
                return False
            info.blocks[rs] = fresh[0]
            info.abs_blocks[rs] = b
            self.tables[slot, rs] = fresh[0]
            info.hwm = max(info.hwm, sum(1 for p in info.blocks if p >= 0))
            return True
        if info.abs_blocks[rs] == b:  # current block: append in place
            if self.allocator.ref[bid] > 1:
                return self._cow(slot, info, rs, copy=True)
            return True
        # window rolled past the slot's old block: recycle
        if self.allocator.ref[bid] > 1:
            # a prefix-sharing peer or the tree's retention still holds
            # the old bytes: detach, never rewrite in place
            if not self._cow(slot, info, rs, copy=False):
                return False
        else:
            self._drop_page(bid)  # bytes no longer hold the prefix
        self.allocator.n_recycled += 1
        info.abs_blocks[rs] = b
        return True

    def ensure_appendable(self, slot: int) -> bool:
        """Make the page that position ``lengths[slot]`` falls into safely
        writable: map it if unmapped, copy-on-write if prefix-shared, and
        under a sliding window recycle the ring slot's out-of-window page.
        Returns False when the pool is exhausted (the caller preempts)."""
        info = self._slots[slot]
        li = int(self.lengths[slot]) // self.bs  # absolute block of write
        if li >= self.max_blocks:
            raise ValueError(f"slot {slot} hit max_len; request too long")
        if self.ring:
            return self._ensure_ring_block(slot, info, li)
        if li >= len(info.blocks):
            fresh = self._alloc(1)
            if fresh is None:
                return False
            info.blocks.append(fresh[0])
            self.tables[slot, li] = fresh[0]
            info.hwm = max(info.hwm, len(info.blocks))
            return True
        if self.allocator.ref[info.blocks[li]] > 1:
            # shared page: copy before writing
            return self._cow(slot, info, li, copy=True)
        return True

    def advance(self, slot: int) -> None:
        self.lengths[slot] += 1

    def release(self, slot: int) -> None:
        """Return a finished or preempted request's pages (shared pages
        stay resident for their other holders).  With ``prefix_retention``
        the pages the radix tree references are ADOPTED first: the tree
        takes a reference, so registered prefixes survive their last
        sharer until pool pressure evicts them."""
        info = self._slots.pop(slot, None)
        self.shielded.discard(slot)
        if info is None:
            return
        self.request_page_hwm.record(info.hwm)
        live = [p for p in info.blocks if p >= 0]
        if self.prefix_retention:
            for p in live:
                if p not in self.tree.retained and self.tree.references(p):
                    self.allocator.retain([p])
                    self.tree.retained.add(p)
        for bid in self.allocator.release(live):
            self._drop_page(bid)
        self.tables[slot, :] = -1
        self.lengths[slot] = 0

    # -- chunked prefill (serving.sched) ----------------------------------

    def admit_chunked(self, slot: int, tokens: np.ndarray) -> Optional[int]:
        """Admission for CHUNKED prefill: like ``admit``, except that

        * ``lengths[slot]`` tracks the chunk FRONTIER (0 now, moved by
          ``set_frontier`` after each chunk, the total at
          ``finish_chunked``);
        * prefix REGISTRATION waits for ``finish_chunked``: a sharer
          admitted mid-prefill would attend pages whose chunks have not
          run (so two identical prompts in flight at once do not share
          with each other, only with finished residents);
        * ring (sliding-window) mode maps NOTHING up front: early chunks
          need blocks that are dead for the final query but live for
          their own, so ``ensure_chunk`` maps each chunk's block in turn
          and the ring recycles them as the window rolls; ring mode
          neither shares nor registers;
        * the slot is SHIELDED until the scheduler activates it.

        Returns the number of prefix-shared pages, or None when the pool
        cannot hold the prompt's fresh pages now (the caller re-queues)."""
        nb = self.blocks_for(len(tokens))
        if nb > self.max_blocks:
            raise ValueError(
                f"prompt of {len(tokens)} tokens exceeds max_len "
                f"({self.max_blocks * self.bs})")
        if self.ring:
            info = _SlotInfo(blocks=[-1] * self.ring,
                             abs_blocks=[-1] * self.ring, first_owned=0,
                             hwm=0)
            shared: List[int] = []
        else:
            shared, covered = self.tree.match(tokens)
            self.allocator.retain(shared)  # pin against eviction (admit)
            fresh = self._alloc(nb - len(shared))
            if fresh is None:
                if self.allocator.release(shared):  # unpin
                    raise RuntimeError("a pinned tree page had no other "
                                       "holder")
                return None
            self.allocator.n_shared_hits += len(shared)
            self.tree.hit_tokens += covered
            info = _SlotInfo(blocks=shared + fresh, first_owned=len(shared),
                             hwm=nb)
        self._slots[slot] = info
        self.tables[slot, :] = -1
        self.tables[slot, :len(info.blocks)] = info.blocks
        self.lengths[slot] = 0  # the chunk frontier
        self.shielded.add(slot)
        return len(shared)

    def ensure_chunk(self, slot: int, start: int, end: int) -> bool:
        """Make the pages of chunk [start, end) writable.  Absolute mode
        mapped the whole prompt at ``admit_chunked`` (a no-op here); ring
        mode maps or recycles each of the chunk's blocks in turn.  Returns
        False when the pool is exhausted (the caller preempts)."""
        info = self._slots[slot]
        if not self.ring:
            return True
        for b in range(start // self.bs, -(-end // self.bs)):
            if not self._ensure_ring_block(slot, info, b):
                return False
        return True

    def chunk_block_ids(self, slot: int, start: int, end: int,
                        n_tokens: int) -> np.ndarray:
        """Physical destination per logical block of chunk [start, end) of
        an ``n_tokens``-long prompt, the per-chunk slice of the
        ``prefill_block_ids`` contract: -1 (no write) for prefix-shared
        pages and for padding blocks wholly past the prompt."""
        info = self._slots[slot]
        b0, b1 = start // self.bs, -(-end // self.bs)
        nb = self.blocks_for(n_tokens)
        ids = np.full((b1 - b0,), -1, np.int32)
        for b in range(b0, min(b1, nb)):
            if self.ring:
                if info.abs_blocks[b % self.ring] == b:
                    ids[b - b0] = info.blocks[b % self.ring]
            elif b >= info.first_owned:
                ids[b - b0] = info.blocks[b]
        return ids

    def set_frontier(self, slot: int, n: int) -> None:
        """Move the chunk frontier: tokens [0, n) of the slot's prompt are
        resident (= the next chunk's start)."""
        self.lengths[slot] = n

    def finish_chunked(self, slot: int, tokens: np.ndarray) -> None:
        """Chunked prefill complete: publish the full length and (absolute
        mode) register the written pages for prefix sharing.  The shield
        stays ON until the scheduler activates the slot, so a decode step
        dispatched in the same iteration cannot write into a shared
        trailing page."""
        info = self._slots[slot]
        self.lengths[slot] = len(tokens)
        if not self.ring:
            self.tree.insert(tokens, info.blocks)

    def unshield(self, slot: int) -> None:
        """Expose the slot's true table row to decode steps again (at
        decode activation, after the iteration's decode step)."""
        self.shielded.discard(slot)


# ---------------------------------------------------------------------------
# int8 pool: int8 pages + per-(page, kv-head) float32 scales
# ---------------------------------------------------------------------------

class PagedQ8CacheManager(PagedCacheManager):
    """``PagedCacheManager`` over int8 pools with per-(page, kv-head)
    float32 scale arrays (``kernels.quant`` layout).

    Every host-side decision (admission, prefix sharing, copy-on-write,
    ring recycling, the registry) is inherited: those move pages, and a q8
    page is (int8 ints, scale row) instead of float rows.  Only the pool
    hooks differ, so the scales travel with their page:

      * ``_init_pools`` allocates int8 pools and zero scales;
      * ``_copy_block_device`` copies ints AND scale rows
        (``copy_block_q8``), so a detached page dequantizes as its source;
      * a recycled or freshly mapped page keeps its stale scale, like its
        stale ints: decode resets the scale when it enters the page at
        offset 0 (``kernels.quant.q8_append_token``).
    """

    def _init_pools(self, cfg: ModelConfig, n_blocks: int, block_size: int,
                    n_slots: int, max_len: int, device) -> None:
        self._pools = init_paged_q8_cache(cfg, n_blocks, block_size, n_slots,
                                          max_len, device=device)

    def _copy_block_device(self, src: int, dst: int) -> None:
        copy_block_q8(self.k, self.v, self.k_scale, self.v_scale, src, dst)

    @property
    def k_scale(self) -> torch.Tensor:
        return self._pools.k_scale

    @property
    def v_scale(self) -> torch.Tensor:
        return self._pools.v_scale
