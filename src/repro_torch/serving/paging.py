"""Paged KV-cache bookkeeping: the host-side ``BlockAllocator``.

A copy of ``repro.serving.paging`` (pure Python; the port keeps its own).
The paged slot store splits a replica's KV memory into fixed-size *blocks*
(``[n_periods, num_blocks, block_size, ...]`` pool leaves on the device);
each in-flight sequence owns an ordered *block table* mapping its logical
blocks (position ``p`` lives in logical block ``p // block_size``) to
physical pool rows.  This module is the control plane for that layout:

  * **refcounted allocation** — a physical block may back several sequences
    (prompt-prefix sharing / fork); it returns to the free list only when the
    last reference drops.
  * **prompt-prefix sharing** — ``alloc`` content-hashes each *full* block of
    the prompt (chained ``(parent_block, tokens)`` keys, so equal keys imply
    equal prefixes) and reuses a live block with identical content instead of
    allocating + rewriting it.  Only full blocks strictly inside the prompt
    are shared, so the first decode write of a sequence always lands in an
    exclusively-owned block.
  * **copy-on-write** — ``append`` into a block shared with another sequence
    (possible after ``fork``) first moves the writer onto a private copy and
    reports the ``(src, dst)`` pair so the caller can copy the device block.
  * **reuse before growth** — previously-freed blocks are handed out before
    never-used ones, so a long-running replica's footprint is its high-water
    mark, not its allocation count.

The allocator never touches device memory; the serving engine turns its
decisions into block-table tensors for the paged write / decode / copy steps
in ``repro_torch.serving.steps``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Number of blocks covering ``n_tokens`` positions."""
    return -(-n_tokens // block_size)


@dataclasses.dataclass
class AllocResult:
    handle: int
    table: list[int]  # physical block per logical block
    shared: list[bool]  # True where the block was reused from the prefix map
    new_blocks: list[int]  # blocks this call took from the pool


@dataclasses.dataclass
class AppendResult:
    block: int  # physical block the new token's position lives in
    offset: int  # position within that block
    new_block: bool  # the append crossed into a freshly-allocated block
    cow: tuple[int, int] | None  # (src, dst) if a shared block was copied


class BlockAllocator:
    """Refcounted block pool with prefix sharing and copy-on-write.

    Physical blocks are ids ``0 .. num_blocks - 1``; the device pool usually
    reserves one extra trailing row as the trash block for padded batch rows,
    which this allocator never sees.
    """

    def __init__(self, num_blocks: int, block_size: int, prefix_sharing: bool = True):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_sharing = prefix_sharing
        self._ref = [0] * num_blocks
        self._free: deque[int] = deque()  # previously used, now free
        self._fresh = 0  # next never-used block id
        self._prefix_to_block: dict = {}  # chain key -> block id
        self._block_prefix: dict[int, object] = {}  # block id -> chain key
        self._tables: dict[int, list[int]] = {}  # handle -> block table
        self._lengths: dict[int, int] = {}  # handle -> tokens written
        self._next_handle = 0

    # -- pool accounting ----------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free) + (self.num_blocks - self._fresh)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def used_fraction(self) -> float:
        return self.used_blocks / self.num_blocks

    def occupancy_stats(self) -> dict:
        """Pool-accounting snapshot for the instrumentation stream /
        metrics registry (JSON-able, O(sequences))."""
        shared = sum(1 for r in self._ref if r > 1)
        return {
            "num_blocks": self.num_blocks,
            "used_blocks": self.used_blocks,
            "free_blocks": self.free_blocks,
            "used_fraction": self.used_fraction,
            "shared_blocks": shared,
            "live_sequences": len(self._tables),
        }

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def table(self, handle: int) -> list[int]:
        return list(self._tables[handle])

    def length(self, handle: int) -> int:
        return self._lengths[handle]

    def blocks_needed(self, n_tokens: int) -> int:
        """Worst-case (sharing-blind) blocks a prompt of ``n_tokens`` needs —
        the conservative admission-gating bound."""
        return blocks_for(n_tokens, self.block_size)

    # -- internals ----------------------------------------------------------
    def _take_block(self) -> int | None:
        """Freed blocks are reused before never-used ones ("pool growth")."""
        if self._free:
            b = self._free.popleft()
        elif self._fresh < self.num_blocks:
            b = self._fresh
            self._fresh += 1
        else:
            return None
        assert self._ref[b] == 0, f"block {b} on free path with refcount {self._ref[b]}"
        self._ref[b] = 1
        return b

    def _release_block(self, block: int) -> None:
        self._ref[block] -= 1
        if self._ref[block] < 0:
            raise ValueError(f"block {block} double-freed")
        if self._ref[block] == 0:
            key = self._block_prefix.pop(block, None)
            if key is not None and self._prefix_to_block.get(key) == block:
                del self._prefix_to_block[key]
            self._free.append(block)

    # -- sequence lifecycle -------------------------------------------------
    def alloc(self, tokens: Sequence[int]) -> AllocResult | None:
        """Admit a prompt: blocks for every position of ``tokens``.

        Full blocks whose chained content key matches a live block are shared
        (refcount bump, caller must NOT write them); the partial tail block —
        and every block when sharing is off — is freshly owned.  Returns
        ``None`` (no state change) if the pool can't cover the unshared part.
        """
        n_tokens = len(tokens)
        if n_tokens < 1:
            raise ValueError("cannot allocate an empty sequence")
        bs = self.block_size
        n_logical = blocks_for(n_tokens, bs)
        n_full = n_tokens // bs

        # resolve sharing first (no mutation), then check capacity, then commit
        plan: list[tuple[int | None, tuple | None]] = []  # (shared block, tokens)
        parent: int | None = None
        chain_broken = False
        for j in range(n_logical):
            block_toks = None
            shared: int | None = None
            if self.prefix_sharing and j < n_full:
                block_toks = tuple(int(t) for t in tokens[j * bs : (j + 1) * bs])
                if not chain_broken:
                    shared = self._prefix_to_block.get((parent, block_toks))
                    if shared is None:
                        chain_broken = True  # a dead chain can't extend
                    else:
                        parent = shared
            plan.append((shared, block_toks))
        n_new = sum(1 for shared, _ in plan if shared is None)
        if n_new > self.free_blocks:
            return None

        table: list[int] = []
        shared_mask: list[bool] = []
        new_blocks: list[int] = []
        parent = None
        for shared, block_toks in plan:
            if shared is not None:
                self._ref[shared] += 1
                table.append(shared)
                shared_mask.append(True)
                parent = shared
                continue
            b = self._take_block()
            assert b is not None  # capacity checked above
            if block_toks is not None:
                # register even past the first miss — keyed by the ACTUAL
                # parent, so a later identical prompt can share this block
                key = (parent, block_toks)
                self._prefix_to_block[key] = b
                self._block_prefix[b] = key
                parent = b
            else:
                parent = None
            table.append(b)
            shared_mask.append(False)
            new_blocks.append(b)
        handle = self._next_handle
        self._next_handle += 1
        self._tables[handle] = table
        self._lengths[handle] = n_tokens
        return AllocResult(handle, list(table), shared_mask, new_blocks)

    def fork(self, handle: int) -> int:
        """Share every block of ``handle`` with a new sequence (zero-copy)."""
        table = self._tables[handle]
        for b in table:
            self._ref[b] += 1
        new = self._next_handle
        self._next_handle += 1
        self._tables[new] = list(table)
        self._lengths[new] = self._lengths[handle]
        return new

    def append_cost(self, handle: int) -> int:
        """Pool blocks the next ``append(handle)`` will consume (0 or 1:
        crossing a block boundary or copy-on-write takes one) — lets a
        scheduler budget a batch of appends against ``free_blocks``."""
        pos = self._lengths[handle]
        logical = pos // self.block_size
        if logical >= len(self._tables[handle]):
            return 1  # new block
        if self._ref[self._tables[handle][logical]] > 1:
            return 1  # copy-on-write
        return 0

    def can_append(self, handle: int) -> bool:
        """Whether ``append(handle)`` would succeed right now."""
        return self.append_cost(handle) <= self.free_blocks

    def append(self, handle: int) -> AppendResult | None:
        """Extend ``handle`` by one position; the caller then writes the
        token at ``(block, offset)``.  Allocates a block at block boundaries
        and copies-on-write when the target block is shared; returns ``None``
        (no state change) if the pool is exhausted."""
        table = self._tables[handle]
        pos = self._lengths[handle]
        logical, offset = divmod(pos, self.block_size)
        cow = None
        if logical >= len(table):
            b = self._take_block()
            if b is None:
                return None
            table.append(b)
            new_block = True
        else:
            b = table[logical]
            new_block = False
            if self._ref[b] > 1:
                # copy-on-write: never mutate a block another sequence reads
                dst = self._take_block()
                if dst is None:
                    return None
                self._ref[b] -= 1  # still > 0: the other holders keep it
                table[logical] = dst
                cow = (b, dst)
                b = dst
        self._lengths[handle] = pos + 1
        return AppendResult(b, offset, new_block, cow)

    def free(self, handle: int) -> None:
        """Retire a sequence; blocks with no remaining references return to
        the free list.  Freeing an unknown/already-freed handle raises."""
        table = self._tables.pop(handle, None)
        if table is None:
            raise ValueError(f"sequence handle {handle} not live (double free?)")
        del self._lengths[handle]
        for b in table:
            self._release_block(b)

    # -- introspection for tests --------------------------------------------
    def live_handles(self) -> list[int]:
        return list(self._tables)

    def refcounts(self) -> list[int]:
        return list(self._ref)
