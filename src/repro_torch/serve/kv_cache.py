"""Paged KV-cache memory (a copy of the reference's ``serve/kv_cache.py``): fixed-size blocks, a free-list allocator with
generation-tagged handles, and block-table views for the paged decode path.

This is the request-pool design of ``core/abi.py`` applied to KV memory
instead of request slots:

* KV memory is one preallocated slab of **fixed-size blocks** per layer
  (``(L, num_blocks, block_size, kv_heads, head_dim)``); a sequence owns a
  list of blocks, so fragmentation is impossible by construction — any free
  block serves any sequence (vLLM's PagedAttention layout).
* ``alloc()`` pops the free list (O(1)); ``free()`` pushes the block back
  and **bumps the block's generation**, so every handle the old owner held
  is stale *forever* — a use-after-free reads as a clean
  :class:`StaleBlockError`, never as silently reading another request's KV
  (the exact aliasing bug the request pool's generation scheme kills).
* handles pack the physical block id in the low bits and the generation
  above (``gen << _GEN_SHIFT | block_id``); Python ints are unbounded, so
  generations never wrap.
* **block 0 is the reserved null block**: never allocated, the padding
  target of every block-table view, and the write target of inactive decode
  slots — garbage writes land there by construction and no live sequence
  ever reads it.
* exhaustion raises :class:`KVCacheOOM` with the full accounting (blocks
  in use / free / requested), so the scheduler's admission gate can reason
  about capacity and a genuine overcommit fails loudly, not with a corrupt
  cache.

The allocator is pure host-side bookkeeping — device memory is the slab in
:func:`repro_torch.models.transformer.init_paged_cache`; the allocator only
decides which physical block a logical page maps to, and
:func:`block_table_view` renders an owner's handle list as the padded int32
table the paged attention kernels index through.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class KVCacheOOM(RuntimeError):
    """The block pool is exhausted (clean OOM — nothing was corrupted)."""


class StaleBlockError(RuntimeError):
    """A handle from a previous allocation of the block was used after
    ``free`` (generation mismatch — the paged analogue of
    ``PAX_ERR_REQUEST`` on a retired request handle)."""


class DoubleFreeError(RuntimeError):
    """``free`` of a handle whose block is already on the free list."""


_GEN_SHIFT = 32
_ID_MASK = (1 << _GEN_SHIFT) - 1

#: physical id of the reserved null block (padding / inactive-slot target)
NULL_BLOCK = 0


@dataclasses.dataclass
class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size KV blocks.

    Block 0 is reserved as the null block and never handed out; the usable
    pool is ``num_blocks - 1`` blocks of ``block_size`` token positions
    each.
    """

    num_blocks: int
    block_size: int

    def __post_init__(self) -> None:
        if self.num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the reserved "
                             f"null block), got {self.num_blocks}")
        # LIFO free list over physical ids 1..num_blocks-1 (0 is reserved).
        # Popping from the end hands out high ids first — deterministic, and
        # reuse-heavy workloads churn a small hot set of blocks.
        self._free: list[int] = list(range(1, self.num_blocks))
        self._gen: list[int] = [0] * self.num_blocks
        self._live: int = 0

    # -- capacity ----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return self._live

    def blocks_for(self, positions: int) -> int:
        """Blocks needed to hold ``positions`` token positions."""
        return -(-max(positions, 0) // self.block_size)

    # -- alloc / free ------------------------------------------------------
    def alloc(self) -> int:
        """Allocate one block; returns its generation-tagged handle."""
        if not self._free:
            raise KVCacheOOM(
                f"KV cache out of blocks: {self._live} live / "
                f"{self.num_blocks - 1} usable ({self.block_size} positions "
                "per block); free completed requests or grow num_blocks")
        bid = self._free.pop()
        self._live += 1
        return (self._gen[bid] << _GEN_SHIFT) | bid

    def alloc_many(self, n: int) -> list[int]:
        """Allocate ``n`` blocks atomically — all or none (a partial grab
        under OOM would strand blocks on a request that cannot run)."""
        if n > len(self._free):
            raise KVCacheOOM(
                f"KV cache cannot serve {n} blocks: {len(self._free)} free "
                f"of {self.num_blocks - 1} usable ({self._live} live)")
        return [self.alloc() for _ in range(n)]

    def block_id(self, handle: int) -> int:
        """The physical block id behind a handle, checked for staleness."""
        bid = handle & _ID_MASK
        gen = handle >> _GEN_SHIFT
        if bid <= 0 or bid >= self.num_blocks:
            raise StaleBlockError(f"not a block handle: {handle:#x}")
        if self._gen[bid] != gen:
            raise StaleBlockError(
                f"stale KV block handle {handle:#x}: block {bid} is at "
                f"generation {self._gen[bid]}, handle carries {gen} "
                "(the owner freed it; this handle is dead forever)")
        return bid

    def free(self, handle: int) -> None:
        """Return a block to the pool; the handle (and every copy of it)
        is stale forever after (generation bump)."""
        bid = self.block_id(handle)  # staleness check first
        if not self._gen[bid] == handle >> _GEN_SHIFT:  # pragma: no cover
            raise StaleBlockError(f"stale handle {handle:#x}")
        # a live handle whose block already sits on the free list cannot
        # exist (free bumps the generation), but guard the invariant anyway
        if bid in self._free:  # pragma: no cover - defensive
            raise DoubleFreeError(f"block {bid} already free")
        self._gen[bid] += 1
        self._free.append(bid)
        self._live -= 1

    def free_many(self, handles) -> None:
        for h in handles:
            self.free(h)


def block_table_view(alloc: BlockAllocator, handles, width: int) -> np.ndarray:
    """Render a request's block-handle list as the padded physical-id row
    the paged attention path indexes through.

    Logical page ``j`` of the sequence lives in physical block
    ``table[j]``; entries past ``len(handles)`` point at the reserved null
    block (reads there are masked out by the length mask, writes only
    happen from inactive slots).  Every handle is staleness-checked — a
    table can never be built over freed memory.
    """
    if len(handles) > width:
        raise ValueError(f"block table width {width} cannot hold "
                         f"{len(handles)} blocks")
    row = np.full((width,), NULL_BLOCK, np.int32)
    for j, h in enumerate(handles):
        row[j] = alloc.block_id(h)
    return row
