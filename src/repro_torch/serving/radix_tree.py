"""Radix tree over block-aligned token runs: the paged prefix cache.

A copy of ``repro.serving.radix_tree`` (the port imports nothing of the
JAX package).  The port's manager uses it as its prefix registry, with
retention and LRU eviction (``serving.paged_kv_cache``).

``PagedCacheManager`` used to keep a flat ``Dict[token-prefix, page]``
registry: one full token-tuple key PER REGISTERED BLOCK, so a distinct
L-token prompt cost O(L²/bs) host bytes to register and every
``_match_prefix`` re-sliced O(L²/bs) tuple prefixes — and an entry died
with its page's last sharer, so a hot system prompt was recomputed for
every request lifetime.  This module replaces it (SGLang-style):

  * **Structure** — a path-compressed tree whose edges are block-aligned
    token RUNS.  A node holds one resident page per block of its run,
    children keyed by the first block (``bs`` tokens) of their run, and
    a ``tails`` dict of PARTIAL trailing blocks (registered under the
    leftover sub-block tokens, matched only on an exact whole-prompt
    hit — the flat registry's semantics, kept bit-for-bit).  Matching an
    L-token prompt walks L tokens once: O(L) time, and resident state is
    O(tokens actually cached), not O(L²/bs).

  * **Retention** — the tree holds NO refcount while any live slot maps
    a page (refcounts stay exactly "number of live sharers", as before).
    When the LAST sharer releases, the manager ADOPTS every
    tree-referenced page (``BlockAllocator.retain`` — the tree becomes a
    holder) instead of freeing it, so popular prefixes persist across
    request lifetimes.  Invariant: ``ref[p] == live slots mapping p +
    (1 if p in tree.retained else 0)``.

  * **Eviction** — retained pages are reclaimable: under pool pressure
    the manager asks ``evict(need, evictable)`` for LRU leaf-END pages
    whose only reference is the tree's (a live sharer pins its whole
    prefix chain, so interior pages of anything in use are never
    candidates).  Tails go before their node's last block page; a node
    emptied of pages is unlinked.  ``drop_page`` (ring recycle of a
    registered page whose bytes are being rewritten) removes the page
    AND its now-unreachable subtree, returning any retained descendants
    for the manager to release — registry state can never outlive the
    bytes it describes.

The tree never touches device memory: eviction and retention move page
IDs between host-side sets; the pages' bytes (and, for ``paged_q8``,
their scale rows) are simply left in place until a future write claims
the page through the normal alloc path.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Set, Tuple

TokenRun = Tuple[int, ...]


class _Node:
    """One path-compressed edge: ``run`` is a block-aligned token run,
    ``pages[i]`` the resident page of its i-th block.  ``children`` is
    keyed by the first block (``bs`` tokens) of each child's run;
    ``tails`` maps a partial (sub-block) trailing token run — attached
    at the END of this node's run — to its page."""

    __slots__ = ("run", "pages", "children", "tails", "parent", "last_used")

    def __init__(self, run: TokenRun, pages: List[int],
                 parent: Optional["_Node"]):
        self.run = run
        self.pages = pages
        self.children: Dict[TokenRun, "_Node"] = {}
        self.tails: Dict[TokenRun, int] = {}
        self.parent = parent
        self.last_used = 0

    @property
    def empty(self) -> bool:
        return not (self.pages or self.children or self.tails)


class RadixPrefixTree:
    """Block-aligned radix prefix cache (module docstring).

    The manager owns the lifecycle; the tree only answers:
      ``match``      longest resident chain covering a prompt prefix
      ``insert``     register a prompt's pages (first registration wins)
      ``drop_page``  page bytes rewritten: remove it + its subtree
      ``evict``      reclaim LRU retained leaf-end pages under pressure
      ``references`` is this page resident in the tree?
    """

    def __init__(self, block_size: int):
        self.bs = block_size
        self.root = _Node((), [], None)
        # page -> (node, where): where is an int block index into
        # node.pages, or the TokenRun key of a tail entry
        self._loc: Dict[int, Tuple[_Node, object]] = {}
        # pages whose ONLY holder may be the tree (adopted at the last
        # sharer's release); the manager keeps ref in lockstep
        self.retained: Set[int] = set()
        self._tick = 0  # LRU clock: bumped per match/insert
        # observability (adapters lift these as lazy gauges)
        self.hit_tokens = 0   # prompt tokens served from resident pages
        self.n_evicted = 0    # retained pages reclaimed under pressure
        self.n_nodes = 0      # live interior/leaf nodes (root excluded)

    # -- lookup ----------------------------------------------------------

    def match(self, tokens) -> Tuple[List[int], int]:
        """Longest chain of resident pages covering a prefix of
        ``tokens``: full blocks by content chain, plus the trailing
        partial block on an exact whole-prompt match.  Returns
        ``(pages, n_covered_tokens)`` and touches the walked nodes'
        LRU stamps."""
        toks = tuple(int(t) for t in tokens)
        nb_full = len(toks) // self.bs
        self._tick += 1
        node, pos = self.root, 0  # pos: blocks consumed within node.run
        pages: List[int] = []
        matched = 0
        while matched < nb_full:
            nxt = toks[matched * self.bs:(matched + 1) * self.bs]
            if pos == len(node.pages):
                child = node.children.get(nxt)
                if child is None:
                    break
                node, pos = child, 0
                node.last_used = self._tick
            if node.run[pos * self.bs:(pos + 1) * self.bs] != nxt:
                break
            pages.append(node.pages[pos])
            pos += 1
            matched += 1
        covered = matched * self.bs
        tail = toks[nb_full * self.bs:]
        if tail and matched == nb_full and pos == len(node.pages):
            # a registered tail always sits at a node boundary (insert
            # splits to create one), so ending mid-run means no tail
            bid = node.tails.get(tail)
            if bid is not None:
                pages.append(bid)
                covered = len(toks)
                node.last_used = self._tick
        return pages, covered

    def references(self, page: int) -> bool:
        return page in self._loc

    # -- registration ----------------------------------------------------

    def insert(self, tokens, blocks: List[int]) -> None:
        """Register ``tokens``'s pages (``blocks[i]`` holds block ``i``;
        a trailing partial block's page is last).  First registration
        wins: blocks already resident under the same token run keep
        their incumbent page — exactly the flat registry's
        ``if key not in registry`` rule (two identical prompts in flight
        register once; the loser's pages just die with their request)."""
        toks = tuple(int(t) for t in tokens)
        nb_full = len(toks) // self.bs
        self._tick += 1
        node, pos = self.root, 0
        i = 0  # blocks consumed
        while i < nb_full:
            nxt = toks[i * self.bs:(i + 1) * self.bs]
            if pos == len(node.pages):
                child = node.children.get(nxt)
                if child is None:
                    run = toks[i * self.bs:nb_full * self.bs]
                    child = _Node(run, list(blocks[i:nb_full]), node)
                    child.last_used = self._tick
                    node.children[nxt] = child
                    self.n_nodes += 1
                    for j, bid in enumerate(child.pages):
                        self._loc[bid] = (child, j)
                    node, pos, i = child, len(child.pages), nb_full
                    break
                node, pos = child, 0
                node.last_used = self._tick
                continue
            if node.run[pos * self.bs:(pos + 1) * self.bs] != nxt:
                node = self._split(node, pos)  # divergence mid-run
                pos = len(node.pages)
                continue
            pos += 1
            i += 1
        tail = toks[nb_full * self.bs:]
        if tail and i == nb_full:
            if pos < len(node.pages):
                # the tail needs a boundary here: split the run so the
                # partial block attaches where the prompt actually ends
                node = self._split(node, pos)
            if tail not in node.tails:  # first registration wins
                node.tails[tail] = blocks[nb_full]
                self._loc[blocks[nb_full]] = (node, tail)
            node.last_used = self._tick

    def _split(self, node: _Node, k: int) -> _Node:
        """Split ``node`` after its first ``k`` blocks; returns the upper
        node (run[:k]).  The lower node keeps the children and tails —
        they attach to the END of the original run."""
        assert node.parent is not None and 0 < k < len(node.pages)
        upper = _Node(node.run[:k * self.bs], node.pages[:k], node.parent)
        upper.last_used = node.last_used
        node.parent.children[node.run[:self.bs]] = upper
        node.run = node.run[k * self.bs:]
        node.pages = node.pages[k:]
        node.parent = upper
        upper.children[node.run[:self.bs]] = node
        self.n_nodes += 1
        for j, bid in enumerate(upper.pages):
            self._loc[bid] = (upper, j)
        for j, bid in enumerate(node.pages):
            self._loc[bid] = (node, j)
        return upper

    # -- removal ---------------------------------------------------------

    def drop_page(self, page: int) -> List[int]:
        """Forget ``page`` (its bytes are being rewritten — ring recycle)
        and everything below it: later blocks of its node, tails, and
        the whole child subtree are unreachable without it (a prefix
        chain must be contiguous from block 0).  Returns the RETAINED
        pages removed — the caller must drop the tree's reference on
        each."""
        loc = self._loc.get(page)
        if loc is None:
            return []
        node, where = loc
        dropped: List[int] = []
        if isinstance(where, int):
            for bid in node.pages[where:]:
                self._loc.pop(bid)
                if bid in self.retained:
                    self.retained.discard(bid)
                    dropped.append(bid)
            node.pages = node.pages[:where]
            node.run = node.run[:where * self.bs]
            dropped += self._drop_below(node)
        else:  # a tail entry: no descendants
            node.tails.pop(where)
            self._loc.pop(page)
            if page in self.retained:
                self.retained.discard(page)
                dropped.append(page)
        self._unlink_if_empty(node)
        return dropped

    def _drop_below(self, node: _Node) -> List[int]:
        """Remove every tail and child subtree under ``node``; returns
        the retained pages removed."""
        dropped: List[int] = []
        for bid in node.tails.values():
            self._loc.pop(bid)
            if bid in self.retained:
                self.retained.discard(bid)
                dropped.append(bid)
        node.tails.clear()
        for child in node.children.values():
            for bid in child.pages:
                self._loc.pop(bid)
                if bid in self.retained:
                    self.retained.discard(bid)
                    dropped.append(bid)
            dropped += self._drop_below(child)
            self.n_nodes -= 1
        node.children.clear()
        return dropped

    def _unlink_if_empty(self, node: _Node) -> _Node:
        """Unlink ``node`` (and any ancestors emptied by that) from the
        tree; returns the first SURVIVING node on the path to the root —
        eviction watches it, since losing its last child may have just
        made its own last page a leaf-end candidate."""
        while node.parent is not None and node.empty:
            parent = node.parent
            for key, child in list(parent.children.items()):
                if child is node:
                    del parent.children[key]
                    self.n_nodes -= 1
                    break
            node = parent
        return node

    # -- eviction --------------------------------------------------------

    def evict(self, need: int,
              evictable: Callable[[int], bool]) -> List[int]:
        """Reclaim up to ``need`` retained pages, LRU leaf-END first:
        only a node's LAST page (and only when the node has no children
        and no tails — nothing below depends on it) or a tail entry is
        a candidate, so a resident chain is always consumed back to
        front and never broken in the middle.  ``evictable(p)`` is the
        manager's refcount guard (tree-only reference); the caller
        releases the returned pages.

        ONE traversal collects every candidate into a heap ordered by
        ``(last_used, tail_first)``; victims pop cheapest-first, each
        re-validated against the live tree (a popped entry may be stale:
        its node shrank or unlinked since the push).  Evicting a page
        EXPOSES at most one new candidate — the node's next page up, or
        the first surviving ancestor's last page once the emptied node
        unlinks — which is pushed as it appears.  Total host work is
        O(nodes + reclaimed·log(candidates)) per call, not one full DFS
        per reclaimed page."""
        out: List[int] = []
        if need <= 0:
            return out
        # entries: (last_used, tail_first, seq, node, where, page) — seq
        # is the traversal/exposure order, so ties pop first-seen-first
        # (matching the old full-scan's DFS first-win) and heapq never
        # compares _Node objects
        heap: List[Tuple[int, int, int, _Node, object, int]] = []
        seq = 0

        def push(node: _Node, where, bid: int, tail_first: int) -> None:
            nonlocal seq
            heapq.heappush(
                heap, (node.last_used, tail_first, seq, node, where, bid))
            seq += 1

        def push_leaf_end(node: _Node) -> None:
            if node.pages and not node.children and not node.tails:
                push(node, len(node.pages) - 1, node.pages[-1], 1)

        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            # the root holds no pages but CAN hold tails (prompts
            # shorter than one block register on the root itself)
            for key, bid in node.tails.items():
                push(node, key, bid, 0)
            push_leaf_end(node)
        while len(out) < need and heap:
            _, _, _, node, where, bid = heapq.heappop(heap)
            if isinstance(where, int):
                live = (not node.children and not node.tails
                        and node.pages and node.pages[-1] == bid)
            else:
                live = node.tails.get(where) == bid
            if not live or bid not in self.retained or not evictable(bid):
                # stale entry, or pinned by a live sharer — a pinned
                # leaf-end stays put and (as before) shields the rest
                # of its node's chain for the duration of this call
                continue
            if isinstance(where, int):
                node.pages.pop()
                node.run = node.run[:len(node.pages) * self.bs]
            else:
                node.tails.pop(where)
            self._loc.pop(bid)
            self.retained.discard(bid)
            push_leaf_end(self._unlink_if_empty(node))
            self.n_evicted += 1
            out.append(bid)
        return out

    # -- introspection ---------------------------------------------------

    @property
    def n_pages(self) -> int:
        """Resident pages (retained or live-shared)."""
        return len(self._loc)

    def pages(self) -> Set[int]:
        return set(self._loc)
