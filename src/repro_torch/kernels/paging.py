"""Ring-of-pages addressing for windowed paged KV caches (pure math).

A copy of ``repro.kernels.paging`` (the port imports nothing of the JAX
package).

A sliding window of ``W`` tokens means a decode query at position ``L``
attends only positions ``> L - W``, so at most

    R = ceil(W / block_size) + 1

physical pages per request are ever live: the window spans at most
``ceil(W/bs)`` whole blocks plus the block currently being written.  A
windowed paged request therefore keeps a BOUNDED block table of exactly
``R`` slots, addressed as a ring — absolute block ``b`` lives at table
slot ``b % R`` — and the serving layer recycles the stale page in place
when the window rolls past it (``serving.paged_kv_cache``).

Because table slots no longer encode absolute order, readers reconstruct
each slot's absolute block from the query position:

    lb = q_position // block_size            # block being written
    b  = lb - ((lb + R - j) % R)             # latest block ≡ j (mod R)

which is exact for every live slot (the manager recycles eagerly on
entering each new block, so slot ``j`` always holds the most recent
absolute block congruent to ``j``); slots holding ``b < 0`` (never
entered) are unmapped (-1 in the table) and masked.  Offsets of the
current block that have not been overwritten yet reconstruct to positions
``> q_position`` and are hidden by the causal mask — the exact invariant
the dense ring buffer relies on.

Ring addressing is DERIVED, never flagged: a paged block table is a ring
iff its width equals ``R`` (``paged_ring_active``).  The manager sizes
windowed tables to exactly ``R`` slots; every wider table (windowed
configs whose window covers ``max_len``, manually built absolute tables
in tests) keeps absolute addressing.  The two schemes agree bit-for-bit
whenever no wrap has happened (``lb < R``), so the rule is safe even for
absolute tables that happen to be ``R`` wide.
"""
from __future__ import annotations


def paged_ring_blocks(sliding_window: int, block_size: int) -> int:
    """Ring size (table slots) bounding a windowed paged request:
    ``ceil(window / block_size) + 1`` — the window's blocks plus the block
    being written while the oldest is still partially in-window.  0 when
    there is no window (absolute addressing)."""
    if sliding_window <= 0:
        return 0
    return -(-sliding_window // block_size) + 1


def paged_ring_active(sliding_window: int, block_size: int,
                      n_table_blocks: int) -> int:
    """Ring size iff the given block table is ring-addressed (its width
    equals ``paged_ring_blocks``), else 0 (absolute addressing).  This is
    the single rule every layer derives ring mode from — manager, write
    path, XLA cores, Pallas wrappers, oracles — so a table can never be
    written in one scheme and read in the other."""
    r = paged_ring_blocks(sliding_window, block_size)
    return r if 0 < r == n_table_blocks else 0
