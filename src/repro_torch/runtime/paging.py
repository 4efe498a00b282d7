"""Paged KV serving memory: block allocator + prefix index behind the
block-table cache.

The port's own copy of ``repro.runtime.paging`` (numpy only, the same
code): the allocator and the index are host-side bookkeeping, so both
packages share their semantics op for op.

A dense stacked cache gives every serving slot its own ``cap``-length ring,
so KV memory scales with ``slots x max_context`` even when most requests are
short. The paged layout replaces the per-slot rings with ONE global pool of
fixed-size blocks (``(n_layers, n_blocks, block_size, kv_heads, head_dim)``
page arrays) plus a small per-slot **block table** mapping logical block
``i`` of a slot to a physical block id. Memory then scales with the *live
token count* of the workload, rounded up to blocks — the same trick
production LLM engines use (vLLM-style paged attention).

Blocks are the unit of SHARING, not just placement: each physical block
carries a **refcount**, so the same block can appear in several slots'
tables at once (copy-on-write prefix caching — requests with a common
prompt prefix map the same prompt blocks read-only and skip prefill for
those positions). The :class:`PrefixIndex` maps hash-chained full-block
token prefixes to live block ids so admission can find reusable blocks in
O(prompt blocks).

Blocks are ALSO the unit of device **placement**: when the page pools
shard their block dim over a ``data`` mesh axis (the JAX package's meshed
engine, and the port's ``LMServer(mesh=...)``), the ``data``-shard of
physical block ``b`` is ``b // (n_blocks // n_shards)`` (the sharded dim
splits into equal contiguous chunks) and its row in that shard's pool
``b % (n_blocks // n_shards)`` (:meth:`BlockAllocator.locate`).
Slots shard over the same axis, so a slot's page-gather decode is LOCAL
exactly when its table references blocks homed on its own shard. The
allocator therefore keeps **per-shard free lists** and prefers same-shard
blocks for each slot (``placement="locality"``), falling back to a remote
shard only when the home shard runs dry (counted in
:attr:`BlockAllocator.spilled_allocs`);
``placement="round_robin"`` is the locality-blind baseline the serving
benchmark gates against. With ``n_shards=1`` (the single-device default)
all of this degrades to the original one-heap behavior bit-for-bit.

Split of responsibilities:

  * the **allocator** (this module) is host-side bookkeeping: lowest-id
    free heaps (one per shard), per-slot tables, refcounts,
    alloc/share/fork/free/defrag. It owns the authoritative ``tables``
    array and mirrors it to the device cache leaf ``bt`` (the server syncs
    lazily via :attr:`BlockAllocator.dirty`);
  * the **device** side only ever sees plain tensors: the page pools and
    the ``(slots, max_blocks)`` int32 table whose unmapped entries hold the
    OOB sentinel ``n_blocks`` — scatter-writes through a sentinel drop on
    device, gathers clamp and are hidden by the position validity mask.

Freed blocks re-enter their home shard's min-heap, so reuse prefers LOW
physical ids within each shard: after a burst retires, the live region
compacts toward the front of every shard's range (defrag-on-retirement),
which is what makes :meth:`resize_pool` (elastic pool shrink/grow,
``runtime.elastic.resize_block_pool``) cheap.
"""

from __future__ import annotations

import hashlib
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def blocks_for(n_positions: int, block_size: int) -> int:
    """Blocks needed to hold ``n_positions`` tokens."""
    return -(-max(int(n_positions), 0) // block_size)


class BlockAllocator:
    """Free-heap block allocator with per-slot block tables, per-block
    refcounts (shared read-only blocks for copy-on-write prefix caching)
    and per-shard free lists (block-locality placement under data-sharded
    page pools).

    A slot's mapped logical blocks form the contiguous range ``[lo, hi)``
    of its table row (``lo > 0`` after :meth:`trim_below` dropped
    behind-window blocks for SWA decoding; ``hi`` == :attr:`n_owned`).

    Invariants (asserted by :meth:`check_invariants`, property-tested in
    ``tests/test_paging.py``):
      * ``refcount[b]`` equals the number of table entries referencing
        ``b`` across all slots (shared blocks count once per slot);
      * a block is on a free heap iff its refcount is zero, and it sits on
        its OWN shard's heap (``shard_of_block``);
      * within one slot the mapped entries are distinct block ids; entries
        outside ``[lo, hi)`` hold the sentinel ``n_blocks``;
      * with ``placement="locality"`` a block allocated while its home
        shard had free blocks is local (spills only happen on exhaustion).
    """

    PLACEMENTS = ("locality", "round_robin")

    def __init__(self, n_blocks: int, block_size: int, n_slots: int,
                 max_blocks_per_slot: Optional[int] = None,
                 n_shards: int = 1, placement: str = "locality"):
        if n_blocks < 1 or block_size < 1:
            raise ValueError(f"bad pool geometry: n_blocks={n_blocks} "
                             f"block_size={block_size}")
        if n_shards < 1 or n_blocks % n_shards:
            raise ValueError(
                f"n_shards={n_shards} must divide n_blocks={n_blocks} "
                f"(the sharded block dim splits into equal contiguous "
                f"chunks)")
        if placement not in self.PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r} "
                             f"(expected one of {self.PLACEMENTS})")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.n_slots = int(n_slots)
        self.max_blocks_per_slot = int(max_blocks_per_slot or n_blocks)
        self.n_shards = int(n_shards)
        self.placement = placement
        self.sentinel = self.n_blocks
        self._per_shard = self.n_blocks // self.n_shards
        # one lowest-id min-heap per shard; shard k owns the contiguous id
        # range [k * per_shard, (k+1) * per_shard)
        self._free: List[List[int]] = [
            list(range(k * self._per_shard, (k + 1) * self._per_shard))
            for k in range(self.n_shards)]
        for h in self._free:
            heapq.heapify(h)
        self.tables = np.full((self.n_slots, self.max_blocks_per_slot),
                              self.sentinel, np.int32)
        self.refcount = np.zeros((self.n_blocks,), np.int64)
        self.n_owned = np.zeros((self.n_slots,), np.int64)   # hi watermark
        self.lo = np.zeros((self.n_slots,), np.int64)        # first mapped
        self.peak_in_use = 0
        # placement telemetry: how many allocations landed on the owning
        # slot's home shard vs spilled to a remote one (round_robin counts
        # the same way, so the benchmark compares policies directly)
        self.local_allocs = 0
        self.spilled_allocs = 0
        self._rr = 0                 # round_robin rotation cursor
        # blocks withheld from allocation by fault injection (chaos pool
        # squeeze): off every free heap but still refcount-zero
        self.quarantined: set = set()
        # host->device table sync flag: the server pushes ``tables`` to the
        # cache's ``bt`` leaf only when this is set (and clears it)
        self.dirty = True

    # -- shard geometry --------------------------------------------------

    def shard_of_block(self, block: int) -> int:
        """The ``data``-shard holding physical block ``block`` (the pool's
        block dim is split into equal contiguous chunks)."""
        return int(block) // self._per_shard

    def shard_of_slot(self, slot: int) -> int:
        """The ``data``-shard holding ``slot``'s row of the stacked state
        (same contiguous-chunk rule on the slot dim). Robust to slot counts
        that don't divide evenly (locality then degrades gracefully)."""
        return min(int(slot) * self.n_shards // max(self.n_slots, 1),
                   self.n_shards - 1)

    def locate(self, blocks, n_parts: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(shard, row within the shard's pool) of each global block id in
        ``blocks`` over ``n_parts`` equal contiguous parts of the block
        dim (default: the allocator's ``n_shards``): the address a data
        rank's local page pool holds the block at. The sentinel maps to
        shard ``n_parts``."""
        n = self.n_shards if n_parts is None else int(n_parts)
        b = np.asarray(blocks, np.int64)
        per = self.n_blocks // n
        return np.where(b < self.n_blocks, b // per, n), b % per

    def reshard(self, n_shards: int) -> None:
        """Re-cut the free lists into ``n_shards`` home shards (a snapshot
        of another mesh restored into this engine): every block keeps its
        id, tables and refcounts; only which heap a free block sits on
        changes."""
        n_shards = int(n_shards)
        if n_shards < 1 or self.n_blocks % n_shards:
            raise ValueError(f"n_shards={n_shards} must divide "
                             f"n_blocks={self.n_blocks}")
        free = sorted(b for h in self._free for b in h)
        self.n_shards = n_shards
        self._per_shard = self.n_blocks // n_shards
        self._free = [[] for _ in range(n_shards)]
        for b in free:
            self._free[self.shard_of_block(b)].append(b)
        for h in self._free:
            heapq.heapify(h)
        self._rr = 0

    # -- queries ---------------------------------------------------------

    @property
    def free_count(self) -> int:
        return sum(len(h) for h in self._free)

    def free_by_shard(self) -> List[int]:
        """Free-list depth per shard (the per-shard observability gauge)."""
        return [len(h) for h in self._free]

    @property
    def used_count(self) -> int:
        return self.n_blocks - self.free_count

    @property
    def occupancy(self) -> float:
        """In-use fraction of the whole pool."""
        return self.used_count / self.n_blocks

    @property
    def fragmentation(self) -> float:
        """Free holes inside the live region — the span ``[0, hwm)`` up to
        the highest live block id — as a fraction of that span. 0 means
        the live blocks sit compacted at the front (the state the lowest-id
        free heap converges to after retirements); high values mean an
        elastic pool shrink (``resize_pool``) would have to move blocks."""
        live = np.flatnonzero(self.refcount > 0)
        if live.size == 0:
            return 0.0
        hwm = int(live[-1]) + 1
        return (hwm - live.size) / hwm

    def remote_fraction(self) -> float:
        """Fraction of live (slot, block) table references whose block is
        homed on a DIFFERENT shard than the slot — each such reference is a
        cross-shard page gather every decode tick (the collective GSPMD
        inserts). 0.0 means fully local decode."""
        total = remote = 0
        for s in range(self.n_slots):
            home = self.shard_of_slot(s)
            for b in self.tables[s, self.lo[s]:self.n_owned[s]]:
                total += 1
                if self.shard_of_block(int(b)) != home:
                    remote += 1
        return remote / total if total else 0.0

    def can_fit(self, n_positions: int) -> bool:
        return blocks_for(n_positions, self.block_size) <= self.free_count

    def slot_blocks(self, slot: int) -> List[int]:
        """The slot's currently mapped physical block ids (logical order)."""
        return [int(b)
                for b in self.tables[slot, self.lo[slot]:self.n_owned[slot]]]

    def is_shared(self, block: int) -> bool:
        return self.refcount[block] > 1

    # -- mutation --------------------------------------------------------

    def _pop_free(self, home: int) -> int:
        """Pop one free block for a slot homed on shard ``home``.

        ``locality``: the home shard's lowest free id, spilling to the
        remote shard with the deepest free list (ties -> lowest shard)
        only when home is dry. ``round_robin``: rotate across shards
        regardless of home (the placement-blind baseline). Both count
        local vs spilled against ``home`` so the policies are comparable.
        """
        if not any(self._free):
            raise RuntimeError(
                f"block pool exhausted ({self.n_blocks} blocks of "
                f"{self.block_size}); grow n_blocks or admit less")
        if self.placement == "round_robin" and self.n_shards > 1:
            for d in range(self.n_shards):
                k = (self._rr + d) % self.n_shards
                if self._free[k]:
                    self._rr = (k + 1) % self.n_shards
                    break
        elif self._free[home]:
            k = home
        else:
            k = max(range(self.n_shards), key=lambda j: len(self._free[j]))
        if k == home:
            self.local_allocs += 1
        else:
            self.spilled_allocs += 1
        return heapq.heappop(self._free[k])

    def _push_free(self, block: int) -> None:
        heapq.heappush(self._free[self.shard_of_block(block)], block)

    def ensure(self, slot: int, n_positions: int) -> None:
        """Grow ``slot``'s table until it covers ``n_positions`` tokens,
        preferring blocks homed on the slot's own shard.

        Raises :class:`RuntimeError` on pool exhaustion and
        :class:`ValueError` when the slot's table itself is full (the
        request outgrew ``max_blocks_per_slot * block_size`` capacity).
        """
        need = blocks_for(n_positions, self.block_size)
        if need > self.max_blocks_per_slot:
            raise ValueError(
                f"slot {slot} needs {need} blocks for {n_positions} "
                f"positions but tables hold {self.max_blocks_per_slot} "
                f"(capacity {self.max_blocks_per_slot * self.block_size})")
        if need - self.n_owned[slot] > self.free_count:
            # atomic: a failed grow leaves the slot untouched
            raise RuntimeError(
                f"block pool exhausted ({self.n_blocks} blocks of "
                f"{self.block_size}); grow n_blocks or admit less")
        home = self.shard_of_slot(slot)
        while self.n_owned[slot] < need:
            b = self._pop_free(home)
            self.tables[slot, self.n_owned[slot]] = b
            self.refcount[b] = 1
            self.n_owned[slot] += 1
            self.dirty = True
        self.peak_in_use = max(self.peak_in_use, self.used_count)

    def share(self, slot: int, blocks: Sequence[int]) -> None:
        """Map already-live ``blocks`` (a matched prompt prefix) into
        ``slot``'s table read-only, bumping their refcounts. The slot's
        table must have room; blocks must be live (refcount >= 1)."""
        n = int(self.n_owned[slot])
        if n + len(blocks) > self.max_blocks_per_slot:
            raise ValueError(
                f"slot {slot}: sharing {len(blocks)} blocks past "
                f"{self.max_blocks_per_slot}-entry table")
        for b in blocks:
            b = int(b)
            if not (0 <= b < self.n_blocks) or self.refcount[b] < 1:
                raise ValueError(f"cannot share dead block {b}")
        for b in blocks:
            self.tables[slot, n] = int(b)
            self.refcount[int(b)] += 1
            n += 1
        self.n_owned[slot] = n
        if blocks:
            self.dirty = True

    def fork_cow(self, slot: int, logical: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write fork: give ``slot`` a private copy of its logical
        block ``logical`` if that block is shared. The copy prefers the
        slot's home shard (a fork is the one chance to bring a remote
        shared block local). Returns ``(src, dst)`` physical ids so the
        caller can copy the page rows on device, or ``None`` when no fork
        is needed (unmapped / already private). Raises
        :class:`RuntimeError` if the pool has no free block."""
        b = int(self.tables[slot, logical])
        if b == self.sentinel or self.refcount[b] <= 1:
            return None
        nb = self._pop_free(self.shard_of_slot(slot))
        self.refcount[b] -= 1
        self.refcount[nb] = 1
        self.tables[slot, logical] = nb
        self.peak_in_use = max(self.peak_in_use, self.used_count)
        self.dirty = True
        return b, nb

    def _drop_entry(self, slot: int, logical: int,
                    freed: List[int]) -> None:
        b = int(self.tables[slot, logical])
        if b == self.sentinel:
            return
        self.refcount[b] -= 1
        assert self.refcount[b] >= 0, f"double free of block {b}"
        if self.refcount[b] == 0:
            self._push_free(b)
            freed.append(b)
        self.tables[slot, logical] = self.sentinel
        self.dirty = True

    def release(self, slot: int) -> List[int]:
        """Drop all of ``slot``'s references; blocks whose refcount hits
        zero return to their home shard's heap (defrag-on-retirement: each
        min-heap hands low ids back first). Returns the list of block ids
        actually FREED (shared blocks survive in their other holders'
        tables) so the caller can evict them from the prefix index."""
        freed: List[int] = []
        for j in range(int(self.lo[slot]), int(self.n_owned[slot])):
            self._drop_entry(slot, j, freed)
        self.n_owned[slot] = 0
        self.lo[slot] = 0
        return freed

    def trim_below(self, slot: int, pos: int) -> List[int]:
        """Free ``slot``'s blocks that lie wholly below position ``pos``
        (sliding-window decode: KV behind the window is dead weight — the
        validity mask already hides it). Refcount-aware: a shared prefix
        block outlives one slot's trim. Returns the freed block ids."""
        new_lo = min(max(int(pos), 0) // self.block_size,
                     int(self.n_owned[slot]))
        freed: List[int] = []
        for j in range(int(self.lo[slot]), new_lo):
            self._drop_entry(slot, j, freed)
        if new_lo > self.lo[slot]:
            self.lo[slot] = new_lo
        return freed

    def remap_slots(self, keep: Sequence[int], new_slots: int) -> List[int]:
        """Elastic slot-count change: compact the kept slots' table rows to
        the front (row ``i`` <- old row ``keep[i]``), release everything
        else. Mirrors ``elastic.resize_serving_state`` slot compaction.
        Returns the block ids freed by the dropped slots. Kept slots may
        change home shard (their row index moved): their existing blocks
        keep their ids — locality degrades to a remote gather, never to an
        error — and future growth prefers the NEW home."""
        keep = list(keep)
        if len(keep) > new_slots:
            raise ValueError(f"{len(keep)} kept slots do not fit {new_slots}")
        freed: List[int] = []
        for s in range(self.n_slots):
            if s not in keep:
                freed.extend(self.release(s))
        new_tables = np.full((new_slots, self.max_blocks_per_slot),
                             self.sentinel, np.int32)
        new_owned = np.zeros((new_slots,), np.int64)
        new_lo = np.zeros((new_slots,), np.int64)
        for i, s in enumerate(keep):
            new_tables[i] = self.tables[s]
            new_owned[i] = self.n_owned[s]
            new_lo[i] = self.lo[s]
        self.tables, self.n_owned, self.lo, self.n_slots = \
            new_tables, new_owned, new_lo, new_slots
        self.dirty = True
        return freed

    def resize_pool(self, new_n_blocks: int) -> Tuple[np.ndarray, np.ndarray]:
        """Elastic pool resize with shard-preserving compaction: live
        blocks (refcount > 0) keep their SHARD and compact toward the
        front of that shard's new id range, in increasing old-id order —
        a block that decoded locally before the resize still decodes
        locally after it. A shard whose live blocks outgrow its new range
        overflows into other shards' free space (lowest shard first);
        single-shard pools reduce to the original global renumbering.
        Returns ``(old_ids, new_ids)`` (aligned arrays, arbitrary order)
        so the caller can move the page-array rows
        (``new_pages[:, new_ids] = old_pages[:, old_ids]``) and remap a
        prefix index; tables are rewritten in place (sentinel value
        changes with the pool size) and refcounts move with the
        renumbering, so shared blocks stay shared."""
        new_n_blocks = int(new_n_blocks)
        if self.quarantined:
            raise RuntimeError(
                f"{len(self.quarantined)} blocks are quarantined; "
                f"unquarantine before resizing the pool")
        if new_n_blocks < 1 or new_n_blocks % self.n_shards:
            raise ValueError(
                f"new_n_blocks={new_n_blocks} must be a positive multiple "
                f"of n_shards={self.n_shards}")
        used = np.sort(np.where(self.refcount > 0)[0])
        if len(used) > new_n_blocks:
            raise ValueError(f"{len(used)} blocks in use do not fit a pool "
                             f"of {new_n_blocks}")
        new_per = new_n_blocks // self.n_shards
        fill = [0] * self.n_shards          # next free offset per new shard
        old_ids = [int(b) for b in used]
        new_ids: List[Optional[int]] = [None] * len(old_ids)
        overflow: List[int] = []            # indexes into old_ids
        for i, b in enumerate(old_ids):
            k = self.shard_of_block(b)
            if fill[k] < new_per:
                new_ids[i] = k * new_per + fill[k]
                fill[k] += 1
            else:
                overflow.append(i)
        for i in overflow:                  # spill into remaining capacity
            k = next(j for j in range(self.n_shards) if fill[j] < new_per)
            new_ids[i] = k * new_per + fill[k]
            fill[k] += 1
        old_to_new = np.full((self.n_blocks,), new_n_blocks, np.int64)
        old_to_new[np.asarray(old_ids, np.int64)] = \
            np.asarray(new_ids, np.int64)
        new_refcount = np.zeros((new_n_blocks,), np.int64)
        new_refcount[np.asarray(new_ids, np.int64)] = self.refcount[used]
        mapped = self.tables < self.sentinel
        new_tables = np.full_like(self.tables, new_n_blocks)
        new_tables[mapped] = old_to_new[self.tables[mapped]]
        self.n_blocks = new_n_blocks
        self.sentinel = self.n_blocks
        self._per_shard = new_per
        self.tables = new_tables.astype(np.int32)
        self.refcount = new_refcount
        self._free = [[b for b in range(k * new_per, (k + 1) * new_per)
                       if new_refcount[b] == 0]
                      for k in range(self.n_shards)]
        for h in self._free:
            heapq.heapify(h)
        self.peak_in_use = min(self.peak_in_use, self.n_blocks)
        self.dirty = True
        return (np.asarray(old_ids, np.int64),
                np.asarray(new_ids, np.int64))

    # -- fault injection -------------------------------------------------

    def quarantine(self, n: int) -> List[int]:
        """Withhold up to ``n`` FREE blocks from allocation (chaos fault
        site ``pool_exhaustion``: simulated pressure without touching any
        live data). Quarantined blocks leave their shard's free heap —
        ``free_count`` drops, so admission and :meth:`ensure` hit the real
        exhaustion paths — but keep refcount zero and rejoin the pool via
        :meth:`unquarantine`. Pops HIGHEST ids first so the squeeze does
        not fight defrag-on-retirement's preference for low ids. Returns
        the block ids actually withheld (may be < ``n`` on a dry pool)."""
        taken: List[int] = []
        for h in self._free:
            h.sort(reverse=True)         # temporary: pop high ids
        while len(taken) < int(n) and any(self._free):
            k = max(range(self.n_shards), key=lambda j: len(self._free[j]))
            taken.append(self._free[k].pop(0))
        for h in self._free:
            heapq.heapify(h)
        self.quarantined.update(taken)
        return taken

    def unquarantine(self, blocks: Optional[Sequence[int]] = None) -> None:
        """Return ``blocks`` (default: all) from quarantine to their home
        shards' free heaps."""
        ids = list(self.quarantined) if blocks is None else \
            [int(b) for b in blocks]
        for b in ids:
            if b not in self.quarantined:
                raise ValueError(f"block {b} is not quarantined")
            self.quarantined.discard(b)
            self._push_free(b)

    # -- integrity -------------------------------------------------------

    def check_invariants(self) -> None:
        free_all: List[int] = []
        for k, h in enumerate(self._free):
            assert all(self.shard_of_block(b) == k for b in h), \
                f"shard {k} heap holds a foreign block"
            free_all.extend(h)
        free = set(free_all)
        assert len(free) == len(free_all), "duplicate ids on the free heaps"
        refs = np.zeros((self.n_blocks,), np.int64)
        for s in range(self.n_slots):
            lo, hi = int(self.lo[s]), int(self.n_owned[s])
            row = self.tables[s]
            assert 0 <= lo <= hi <= self.max_blocks_per_slot, \
                f"slot {s}: bad lo/hi {lo}/{hi}"
            assert np.all(row[hi:] == self.sentinel), \
                f"slot {s}: mapped entries beyond n_owned"
            assert np.all(row[:lo] == self.sentinel), \
                f"slot {s}: mapped entries below lo"
            blocks = [int(b) for b in row[lo:hi]]
            assert all(0 <= b < self.n_blocks for b in blocks), \
                f"slot {s}: block id out of range"
            assert len(blocks) == len(set(blocks)), \
                f"slot {s}: duplicate block in one table row"
            for b in blocks:
                refs[b] += 1
        assert np.array_equal(refs, self.refcount), \
            "refcount != live table references"
        q = {int(b) for b in self.quarantined}
        assert not (free & q), "quarantined block on a free heap"
        assert all(self.refcount[b] == 0 for b in q), \
            "quarantined block has live references"
        zero = {b for b in range(self.n_blocks) if self.refcount[b] == 0}
        assert free | q == zero, \
            "free heaps + quarantine != zero-refcount blocks"


class PrefixIndex:
    """Hash-chain prefix index over FULL prompt blocks.

    Key for logical block ``i`` of a prompt: ``sha1(key_{i-1} || tokens of
    block i)`` — chained, so a key identifies the whole token prefix
    through block ``i``, not just that block's tokens (``hash()`` is
    process-salted and unusable for a stable content key). ``match`` walks
    the chain until the first miss; ``insert_chain`` registers a prompt's
    full blocks after their KV is written. First insert wins: duplicate
    content keeps the original (already shareable) block.

    The index only ever references LIVE blocks: the server evicts ids the
    allocator reports freed (release/trim/remap) and ids it is about to
    overwrite (copy-on-write guard), and remaps ids on pool resize.
    """

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self.by_key: Dict[bytes, int] = {}
        self.by_block: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return len(self.by_key)

    def _chain_keys(self, prompt: np.ndarray, n_blocks: int) -> List[bytes]:
        toks = np.asarray(prompt, np.int32)
        keys, h = [], b"\x00"
        for i in range(n_blocks):
            h = hashlib.sha1(
                h + toks[i * self.block_size:(i + 1) * self.block_size]
                .tobytes()).digest()
            keys.append(h)
        return keys

    def match(self, prompt: np.ndarray) -> List[int]:
        """Longest indexed full-block prefix of ``prompt``: the physical
        block ids for blocks ``0..K-1`` (consecutive from the start)."""
        n_full = len(prompt) // self.block_size
        ids: List[int] = []
        for key in self._chain_keys(prompt, n_full):
            b = self.by_key.get(key)
            if b is None:
                break
            ids.append(b)
        return ids

    def insert_chain(self, prompt: np.ndarray, block_ids: Sequence[int]) -> None:
        """Register a prompt's full blocks (``block_ids[i]`` holds the KV of
        prompt block ``i``). Keys already present keep their original block."""
        keys = self._chain_keys(prompt, min(len(prompt) // self.block_size,
                                            len(block_ids)))
        for key, b in zip(keys, block_ids):
            if key in self.by_key:
                continue
            b = int(b)
            if b in self.by_block:       # block re-registered under a new
                del self.by_key[self.by_block[b]]   # chain: drop stale key
            self.by_key[key] = b
            self.by_block[b] = key

    def contains_block(self, block: int) -> bool:
        return int(block) in self.by_block

    def evict_blocks(self, blocks: Sequence[int]) -> None:
        """Drop freed / about-to-be-overwritten blocks from the index."""
        for b in blocks:
            key = self.by_block.pop(int(b), None)
            if key is not None:
                del self.by_key[key]

    def remap(self, old_to_new: Dict[int, int]) -> None:
        """Renumber block ids after an elastic pool resize (ids not in the
        mapping were freed by the resize and are evicted)."""
        by_key, by_block = {}, {}
        for key, b in self.by_key.items():
            nb = old_to_new.get(b)
            if nb is None:
                continue
            by_key[key] = int(nb)
            by_block[int(nb)] = key
        self.by_key, self.by_block = by_key, by_block
