"""NoWriteIntoHeldPage: the shared-page-mutation class as a check.

Counterpart of ``repro.lint.retention``.  A paged pool page with refcount
> 1 is held by someone besides the writer — a prefix-sharing peer, or the
radix prefix TREE itself, retaining a released request's prefix for
future hits.  Writing such a page in place corrupts another request's
live KV or silently rewrites bytes the prefix cache will later serve as a
"hit".  The manager's rule is: every write path detaches first
(``_cow``), eviction only ever reclaims pages whose ONLY holder is the
tree, and a retained page is never recycled in place.  This audit keeps
the class out:

``audit_manager(pm)`` arms spies on the manager's write-authorization
seams and drives a scripted lifecycle — prefix-sharing admits, decode
appends across block boundaries, release-time adoption, warm re-admits,
pool-pressure eviction, and (windowed) ring rollovers:

  1. **append seam** — after ``ensure_appendable`` / ``ensure_chunk``
     authorizes a write, the target page must have refcount exactly 1
     (the writing slot) and must not be tree-retained;
  2. **CoW seam** — ``_copy_block_device`` must copy into a page no one
     else holds (ref 1, unknown to the tree) and never onto its source;
  3. **eviction seam** — every page ``tree.evict`` returns must be
     tree-only (ref 1) and mapped by NO live slot;
  4. **retention ledger** — after every op, each retained page holds a
     reference and is absent from the free list.

``audit_retention()`` runs the audit over reduced fp (absolute +
sliding-window) and q8 managers, then runs a POSITIVE CONTROL: a
sabotaged manager whose ``ensure_appendable`` skips detach-on-shared
MUST fire the append seam — if it does not, the audit is not observing
the seam and fails itself rather than passing vacuously.

Each hit is a :class:`repro_torch.lint.rules.Finding`, the same currency
as the graph rules, so ``python -m repro_torch.lint --retention``
reports it in the one run.
"""
from __future__ import annotations

import contextlib
from typing import List

import numpy as np

from repro_torch.lint.rules import Finding

RULE_RETENTION = "NoWriteIntoHeldPage"


def _check_write_target(pm, slot: int, findings: List[Finding],
                        context: str, seam: str) -> None:
    """The page a just-authorized write will land in must be exclusively
    the writer's: ref == 1 and not tree-retained."""
    info = pm._slots[slot]
    li = int(pm.lengths[slot]) // pm.bs
    bid = info.blocks[li % pm.ring] if pm.ring else info.blocks[li]
    if bid < 0:
        return
    ref = int(pm.allocator.ref[bid])
    if ref != 1:
        findings.append(Finding(
            rule=RULE_RETENTION, target=context,
            message=f"{seam} authorized a write into page {bid} with "
                    f"refcount {ref} — a prefix-sharing peer or the "
                    f"retention tree still holds its bytes; the write "
                    f"path must detach (CoW) first",
            detail={"seam": seam, "page": bid, "ref": ref}))
    if bid in pm.tree.retained:
        findings.append(Finding(
            rule=RULE_RETENTION, target=context,
            message=f"{seam} authorized a write into TREE-RETAINED page "
                    f"{bid} — the prefix cache would later serve the "
                    f"overwritten bytes as a hit",
            detail={"seam": seam, "page": bid}))


@contextlib.contextmanager
def _armed(pm, findings: List[Finding], context: str):
    """Arm the write-authorization / CoW / eviction spies on ``pm``."""
    orig_append = pm.ensure_appendable
    orig_chunk = pm.ensure_chunk
    orig_copy = pm._copy_block_device
    orig_evict = pm.tree.evict

    def spy_append(slot):
        ok = orig_append(slot)
        if ok:
            _check_write_target(pm, slot, findings, context,
                                "ensure_appendable")
        return ok

    def spy_chunk(slot, start, end):
        ok = orig_chunk(slot, start, end)
        if ok:
            info = pm._slots[slot]
            for b in range(start // pm.bs, -(-end // pm.bs)):
                bid = (info.blocks[b % pm.ring]
                       if pm.ring and info.abs_blocks[b % pm.ring] == b
                       else (info.blocks[b] if not pm.ring
                             and b < len(info.blocks) else -1))
                if bid < 0 or (not pm.ring and b < info.first_owned):
                    continue  # shared / unmapped: the write skips it
                ref = int(pm.allocator.ref[bid])
                if ref != 1 or bid in pm.tree.retained:
                    findings.append(Finding(
                        rule=RULE_RETENTION, target=context,
                        message=f"ensure_chunk authorized a write into "
                                f"held page {bid} (ref {ref}, retained="
                                f"{bid in pm.tree.retained})",
                        detail={"seam": "ensure_chunk", "page": bid,
                                "ref": ref}))
        return ok

    def spy_copy(src, dst):
        ref = int(pm.allocator.ref[dst])
        if src == dst or ref != 1 or pm.tree.references(dst):
            findings.append(Finding(
                rule=RULE_RETENTION, target=context,
                message=f"CoW copies into page {dst} (src {src}, ref "
                        f"{ref}, in-tree={pm.tree.references(dst)}) — "
                        f"the destination must be a fresh page nobody "
                        f"else holds",
                detail={"seam": "_copy_block_device", "src": src,
                        "dst": dst, "ref": ref}))
        return orig_copy(src, dst)

    def spy_evict(need, evictable):
        mapped = {p for info in pm._slots.values()
                  for p in info.blocks if p >= 0}
        out = orig_evict(need, evictable)
        for bid in out:
            ref = int(pm.allocator.ref[bid])
            if ref != 1 or bid in mapped:
                findings.append(Finding(
                    rule=RULE_RETENTION, target=context,
                    message=f"eviction reclaimed page {bid} that is not "
                            f"tree-only (ref {ref}, live-mapped="
                            f"{bid in mapped}) — evicting under a live "
                            f"sharer frees KV a request still reads",
                    detail={"seam": "tree.evict", "page": bid,
                            "ref": ref}))
        return out

    pm.ensure_appendable = spy_append
    pm.ensure_chunk = spy_chunk
    pm._copy_block_device = spy_copy
    pm.tree.evict = spy_evict
    try:
        yield
    finally:
        pm.ensure_appendable = orig_append
        pm.ensure_chunk = orig_chunk
        pm._copy_block_device = orig_copy
        pm.tree.evict = orig_evict


def _check_ledger(pm, findings: List[Finding], context: str) -> None:
    """Every retained page holds a reference and is not on the free
    list — the adoption bookkeeping the append/evict seams rely on."""
    free = set(pm.allocator._free)
    for bid in pm.tree.retained:
        ref = int(pm.allocator.ref[bid])
        if ref < 1 or bid in free:
            findings.append(Finding(
                rule=RULE_RETENTION, target=context,
                message=f"retained page {bid} has ref {ref} and "
                        f"free={bid in free} — the tree's reference was "
                        f"lost; its next reuse double-books the page",
                detail={"seam": "ledger", "page": bid, "ref": ref}))


def _drive(pm, findings: List[Finding], context: str) -> None:
    """The scripted lifecycle: every policy path the rule governs."""
    vocab = pm.cfg.vocab_size
    # windowed: keep the prompt inside the window so it registers (a
    # longer prompt's block 0 is dead at admit and shares nothing)
    n_tok = pm.bs + 4 if pm.ring else 3 * pm.bs + 3
    prompt = (np.arange(n_tok, dtype=np.int32) * 3 + 1) % vocab

    def step(slot):
        if pm.ensure_appendable(slot):
            pm.advance(slot)
        _check_ledger(pm, findings, context)

    with _armed(pm, findings, context):
        assert pm.admit(0, prompt) is not None
        for _ in range(2):          # owner decodes into its tail first
            step(0)
        assert pm.admit(1, prompt.copy()) is not None  # prefix sharer
        # both decode across a block boundary: tail CoW for the sharer,
        # (windowed) ring rollovers past the shared pages for both
        for _ in range(2 * pm.bs):
            step(0)
            step(1)
        pm.release(1)
        pm.release(0)               # last sharer out: tree adopts
        _check_ledger(pm, findings, context)
        if pm.admit(2, prompt.copy()) is not None:  # warm hit on retained
            for _ in range(2):
                step(2)
            pm.release(2)
        # pool pressure: a distinct prompt too big for the free list
        # alone — _alloc must evict retained pages, never live ones
        big = (np.arange(7 * pm.bs, dtype=np.int32) * 7 + 2) % vocab
        if pm.admit(3, big) is not None:
            step(3)
            pm.release(3)
        _check_ledger(pm, findings, context)
        pm.drop_prefix_cache()
        _check_ledger(pm, findings, context)


def audit_manager(pm, context: str) -> List[Finding]:
    """Drive ``pm`` through the scripted lifecycle with the spies armed;
    returns every confirmed finding (empty == clean)."""
    findings: List[Finding] = []
    _drive(pm, findings, context)
    return findings


def _positive_control(cfg, context: str, device) -> List[Finding]:
    """A manager with detach-on-shared removed MUST fire the append
    seam; a silent pass means the audit observes nothing."""
    from repro_torch.serving.paged_kv_cache import PagedCacheManager

    class _UncheckedWriteManager(PagedCacheManager):
        # the sabotage: append in place even when the page is held
        def ensure_appendable(self, slot):
            info = self._slots[slot]
            li = int(self.lengths[slot]) // self.bs
            if self.ring or li >= len(info.blocks):
                return super().ensure_appendable(slot)
            return True

    pm = _UncheckedWriteManager(cfg, n_slots=4, max_len=64, block_size=8,
                                n_blocks=24, device=device)
    fired = audit_manager(pm, context)
    if not fired:
        return [Finding(
            rule=RULE_RETENTION, target=context,
            message="positive control FAILED: a manager stripped of "
                    "detach-on-shared produced no finding — the audit "
                    "is not observing the write seams and cannot "
                    "certify the real managers",
            detail={})]
    return []


def audit_retention(cfg=None, *, device="cpu") -> List[Finding]:
    """Audit reduced fp (absolute + sliding-window) and q8 managers whose
    pools lie on ``device`` (copy-on-write copies pages there), plus the
    positive control; returns every confirmed finding."""
    from repro_torch._device import resolve_device
    from repro_torch.lint.submitpath import audit_config
    from repro_torch.serving.paged_kv_cache import (PagedCacheManager,
                                                    PagedQ8CacheManager)

    dev = resolve_device(device)
    if cfg is None:
        cfg = audit_config()
    wcfg = cfg.with_(sliding_window=16)
    findings: List[Finding] = []
    # n_blocks=10 < the workload's footprint, so _drive's pressure admit
    # really evicts
    kw = dict(n_slots=4, max_len=64, block_size=8, n_blocks=10, device=dev)
    for pm, name in (
            (PagedCacheManager(cfg, **kw), "PagedCacheManager[absolute]"),
            (PagedCacheManager(wcfg, **kw), "PagedCacheManager[ring]"),
            (PagedQ8CacheManager(cfg, **kw),
             "PagedQ8CacheManager[absolute]")):
        findings += audit_manager(pm, name)
    findings += _positive_control(cfg, "UncheckedWriteManager[control]",
                                  dev)
    return findings
