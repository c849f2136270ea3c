# A copy of repro/serve/kv_cache.py: the port keeps its own copy so that it
# imports nothing of the JAX package.
"""Paged decode-state bookkeeping (host side).

The device state — per-layer K/V (or MLA latent) block pools and
fixed-size recurrent state pools — lives in the cache pytree built by
``Model.init_paged_cache``; this module owns the free-list allocators and
the per-sequence logical->physical block tables that tell ``paged_step``
where each sequence's tokens live.  Heterogeneous prompt/generation
lengths share one preallocated pool instead of each request carrying its
own ``cache_len`` buffer.

Two allocators, matching the two kinds of paged state:

  * ``BlockAllocator`` — token-granular block pools that grow with the
    sequence (plain K/V and MLA latent blocks page identically; only the
    per-token payload differs);
  * ``StateSlotAllocator`` — O(1)-per-sequence recurrent state (ssm SSD
    state + conv window, rglru hidden + conv window).  A slot is a whole
    sequence's decode state; there is nothing to grow, so allocation is
    one slot per live sequence.

Physical block 0 / state slot 0 is never allocated: it is the trash
target that inactive rows point at, so their (masked) writes can't
corrupt live data.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

TRASH_BLOCK = 0
TRASH_SLOT = 0


class BlockAllocator:
    """LIFO free-list over ``num_blocks`` fixed-size blocks.

    LIFO keeps the pool hot (recently freed blocks are reused first) and
    makes fragmentation behaviour easy to property-test: any interleaving
    of alloc/free must conserve ``num_free`` and never hand out block 0
    or a block twice.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the trash block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._allocated: set = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks, or None (never partial) if the pool can't cover it."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"double/foreign free of block {b}")
            self._allocated.remove(b)
            self._free.append(b)


class StateSlotAllocator:
    """LIFO free-list over ``num_slots`` fixed-size recurrent-state slots.

    Slot 0 is the trash slot (stale/padded engine rows write there); every
    live sequence holds exactly one slot for its whole lifetime.  Same
    conservation invariants as ``BlockAllocator``, property-tested the
    same way.
    """

    def __init__(self, num_slots: int):
        if num_slots < 2:
            raise ValueError("need >= 2 slots (slot 0 is the trash slot)")
        self.num_slots = num_slots
        self._free: List[int] = list(range(num_slots - 1, 0, -1))
        self._owner: Dict[int, int] = {}          # rid -> slot

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, rid: int) -> Optional[int]:
        """One slot for sequence ``rid``; None if the pool is exhausted.
        Idempotent: a rid that already holds a slot gets the same one."""
        if rid in self._owner:
            return self._owner[rid]
        if not self._free:
            return None
        slot = self._free.pop()
        self._owner[rid] = slot
        return slot

    def slot_of(self, rid: Optional[int]) -> int:
        """The slot held by ``rid`` (TRASH_SLOT for None/unknown rids —
        an inactive row's state writes must land in the trash)."""
        if rid is None:
            return TRASH_SLOT
        return self._owner.get(rid, TRASH_SLOT)

    def free(self, rid: int) -> None:
        slot = self._owner.pop(rid, None)
        if slot is None:
            raise ValueError(f"free of rid {rid} holding no slot")
        self._free.append(slot)

    def free_if_held(self, rid: int) -> None:
        if rid in self._owner:
            self.free(rid)

    def release_all(self) -> None:
        """Free every held slot (post-mortem reclaim: the owning engine
        is being emptied after its worker died)."""
        for rid in list(self._owner):
            self.free(rid)


class PagedKVCache:
    """Block tables for live sequences + the allocator behind them.

    With ``window > 0`` (the model's reclaim window: the largest sliding
    window when EVERY block-pooled layer is windowed), leading blocks
    that fell entirely out of the attention window are freed as the
    query frontier advances: logical block ``b`` covers positions
    ``[b*bs, (b+1)*bs)`` and no query at position ``q >= query_start``
    can attend ``kpos <= q - window``, so once
    ``(b+1)*bs - 1 <= query_start - window`` the block is dead for
    every future step.  The freed entry stays in the table as a
    TRASH_BLOCK placeholder — logical slot ``b`` must keep its index so
    the device-side position math is untouched; gathers of a trashed
    slot read garbage the window mask already discards.  Long
    sliding-window generations therefore hold O(window) pool blocks
    instead of O(generated).
    """

    def __init__(self, num_blocks: int, block_size: int,
                 blocks_per_seq: int, window: int = 0):
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.block_size = block_size
        self.blocks_per_seq = blocks_per_seq
        self.window = window
        self._tables: Dict[int, List[int]] = {}
        self._m: Optional[dict] = None

    def attach_metrics(self, registry, **labels) -> None:
        """Wire pool occupancy / reserve-pressure metrics into a
        :class:`repro_torch.serve.telemetry.MetricsRegistry`.  Optional: with
        no registry attached the cache is metrics-free (zero overhead).
        """
        self._m = {
            "free": registry.gauge("kv_blocks_free", **labels),
            "reclaimed": registry.counter("kv_blocks_reclaimed", **labels),
            "reserves": registry.counter("kv_reserve_requests", **labels),
            "truncations": registry.counter(
                "kv_reserve_truncations", **labels),
        }
        self._m["free"].set(self.allocator.num_free)

    def _sync_free(self) -> None:
        if self._m is not None:
            self._m["free"].set(self.allocator.num_free)

    def _reclaim(self, have: List[int], query_start: Optional[int]) -> None:
        """Free leading blocks that fell entirely out of the sliding
        window relative to ``query_start`` (trash placeholders keep
        their logical index)."""
        if not self.window or query_start is None:
            return
        dead = max(0, query_start - self.window + 1) // self.block_size
        freed = 0
        for b in range(min(dead, len(have))):
            if have[b] != TRASH_BLOCK:
                self.allocator.free([have[b]])
                have[b] = TRASH_BLOCK
                freed += 1
        if freed and self._m is not None:
            self._m["reclaimed"].inc(freed)

    def ensure_capacity(self, rid: int, num_tokens: int,
                        query_start: Optional[int] = None) -> bool:
        """Grow sequence ``rid``'s table to cover ``num_tokens`` positions.
        Returns False — no growth, though out-of-window blocks may have
        been reclaimed (that mutation is the point: freeing dead blocks
        is what gives a starved retry a chance) — if the pool cannot
        cover the remainder.  All-or-nothing: a refused grow leaves the
        table untouched (``reserve`` is the partial-growth variant).

        ``query_start`` is the lowest position this step's queries for
        ``rid`` will attend FROM (the decode position, or a prefill
        chunk's start); with a sliding window it lets leading
        out-of-window blocks be reclaimed before the growth is sized,
        so a starved pool frees dead blocks instead of preempting."""
        need = self.allocator.blocks_for(num_tokens)
        if need > self.blocks_per_seq:
            raise ValueError(
                f"sequence needs {need} blocks > blocks_per_seq="
                f"{self.blocks_per_seq} (raise engine max_seq_len)")
        have = self._tables.setdefault(rid, [])
        self._reclaim(have, query_start)
        grow = need - len(have)
        if grow <= 0:
            self._sync_free()
            return True
        blocks = self.allocator.alloc(grow)
        if blocks is None:
            self._sync_free()
            return False
        have.extend(blocks)
        self._sync_free()
        return True

    def reserve(self, rid: int, num_tokens: int,
                query_start: Optional[int] = None) -> int:
        """Partial-growth headroom reservation for depth-N decode
        dispatch: grow ``rid``'s table toward ``num_tokens`` positions,
        keeping whatever prefix the pool can cover when it cannot cover
        everything.  Returns the number of leading token positions the
        table now covers — the engine turns ``covered - next_pos`` into
        the row's on-device loop-step budget, and the device-side
        capacity predicate (trash frontier entry) enforces the same
        boundary, so an under-reserved row truncates its loop instead
        of corrupting cache.  Partial blocks are never wasted: the
        caller uses every covered position this same dispatch."""
        need = self.allocator.blocks_for(num_tokens)
        if need > self.blocks_per_seq:
            raise ValueError(
                f"sequence needs {need} blocks > blocks_per_seq="
                f"{self.blocks_per_seq} (raise engine max_seq_len)")
        have = self._tables.setdefault(rid, [])
        self._reclaim(have, query_start)
        grow = need - len(have)
        granted_all = True
        if grow > 0:
            blocks = self.allocator.alloc(min(grow, self.allocator.num_free))
            if blocks:
                have.extend(blocks)
            granted_all = len(blocks or ()) == grow
        if self._m is not None:
            self._m["reserves"].inc()
            if not granted_all:
                self._m["truncations"].inc()
            self._sync_free()
        return len(have) * self.block_size

    def free_seq(self, rid: int) -> None:
        blocks = self._tables.pop(rid, None)
        if blocks:
            live = [b for b in blocks if b != TRASH_BLOCK]
            if live:
                self.allocator.free(live)
        self._sync_free()

    def release_all(self) -> None:
        """Free every sequence's blocks (release-on-death: a dead
        replica's engine must hand its whole pool back before its
        requests fail over, so a respawned worker on the same engine
        starts from a clean allocator).  Idempotent."""
        for rid in list(self._tables):
            self.free_seq(rid)

    def num_blocks_of(self, rid: int) -> int:
        """Pool blocks ``rid`` actually holds (reclaimed window
        placeholders excluded)."""
        return sum(1 for b in self._tables.get(rid, ())
                   if b != TRASH_BLOCK)

    def table_row(self, rid: Optional[int]) -> np.ndarray:
        """(blocks_per_seq,) int32 row; unassigned tail (and rows for
        rid=None, i.e. inactive slots) point at the trash block."""
        row = np.full((self.blocks_per_seq,), TRASH_BLOCK, np.int32)
        if rid is not None:
            blocks = self._tables.get(rid, ())
            row[:len(blocks)] = blocks
        return row

    def table_array(self, rids: Sequence[Optional[int]]) -> np.ndarray:
        """(len(rids), blocks_per_seq) int32 block-table batch."""
        return np.stack([self.table_row(r) for r in rids])
