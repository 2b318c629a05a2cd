"""Continuous-batching scheduler (a copy of the reference's
``serve/scheduler.py``): slot/admission bookkeeping over the
paged KV pool.

The engine owns the model steps; this module owns the *policy*:

* ``max_batch`` decode **slots**; submitted requests wait in a FIFO queue
  and are admitted as slots free (continuous batching at step
  granularity — a finishing request's slot turns over next step, it never
  waits for its batch-mates).
* admission is **fully funded**: a request is admitted only when the pool
  can hand it every block it may ever touch (padded prefill span and all
  ``max_new_tokens`` decode positions, ``alloc_many`` all-or-none).  A
  running request can therefore never hit :class:`~.kv_cache.KVCacheOOM`
  mid-decode — overload shows up as queueing delay, not as a corrupted or
  aborted sequence (the same loud-at-the-edge stance as the allocator).
* prefill is **chunked and interleaved**: each engine step runs at most
  ONE prefill chunk (for the earliest-admitted still-prefilling slot)
  alongside the decode step for every decoding slot, so a long prompt
  costs its neighbours one chunk of latency per step, never a full-prompt
  stall.
* ``finish`` frees the sequence's blocks (generation-bumped — every
  handle the slot held is stale forever) and clears the slot.

The scheduler is pure host-side bookkeeping (deques, lists, int32 block
tables); everything device-shaped stays in the engine.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np

from .kv_cache import BlockAllocator, KVCacheOOM, block_table_view

#: sequence states (a slot holds a PREFILL or DECODE sequence; WAITING
#: sequences live in the queue, not in a slot)
WAITING = "waiting"
PREFILL = "prefill"
DECODE = "decode"


@dataclasses.dataclass
class Sequence:
    """A request bound to a slot: its KV blocks, block-table row, and
    prefill progress.  ``fed`` counts prompt *positions written to KV*
    (chunk-padded, so it can overshoot the prompt; the pad-tail garbage is
    overwritten by decode before any mask exposes it)."""

    req: object                  # serve.engine.Request
    handles: list                # generation-tagged block handles (owned)
    table: np.ndarray            # (table_width,) int32 physical block ids
    admit_seq: int               # admission order (prefill priority)
    state: str = PREFILL
    fed: int = 0

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt)

    @property
    def prefill_done(self) -> bool:
        return self.fed >= self.prompt_len


class Scheduler:
    """Admit/evict policy over ``max_batch`` slots and a block pool."""

    def __init__(self, alloc: BlockAllocator, *, max_batch: int,
                 prefill_chunk: int, table_width: int) -> None:
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.alloc = alloc
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.table_width = table_width
        self.waiting: collections.deque = collections.deque()
        self.slots: list[Optional[Sequence]] = [None] * max_batch
        self._admitted = 0

    # -- capacity ----------------------------------------------------------
    def positions_needed(self, req) -> int:
        """Every KV position the request may ever write: the chunk-padded
        prefill span or prompt+decode tail, whichever reaches further."""
        s = len(req.prompt)
        c = self.prefill_chunk
        padded = -(-s // c) * c
        return max(padded, s + req.max_new_tokens)

    def blocks_needed(self, req) -> int:
        return self.alloc.blocks_for(self.positions_needed(req))

    def check_admissible(self, req) -> None:
        """Reject (loudly, at submit time) a request that could *never* be
        admitted — larger than the table or the whole pool."""
        need = self.blocks_needed(req)
        if need > self.table_width:
            raise ValueError(
                f"request {req.rid}: needs {need} KV blocks but the block "
                f"table holds {self.table_width} (raise max_seq or shrink "
                f"prompt+max_new_tokens)")
        if need > self.alloc.num_blocks - 1:
            raise ValueError(
                f"request {req.rid}: needs {need} KV blocks but the pool "
                f"has {self.alloc.num_blocks - 1} (raise num_blocks)")

    # -- queue / admission -------------------------------------------------
    def submit(self, req) -> None:
        self.check_admissible(req)
        self.waiting.append(req)

    def requeue(self, reqs) -> None:
        """Re-queue evicted requests at the FRONT of the waiting queue, in
        the given order (recovery replay: re-admission order must equal the
        original submission order).  Bypasses ``check_admissible`` — these
        requests were admissible once and graceful degradation means an
        unfundable request *waits* on the shrunk world rather than fails."""
        for req in reversed(list(reqs)):
            self.waiting.appendleft(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def admit(self) -> list[int]:
        """Fill free slots FIFO while the pool can fully fund the head of
        the queue; returns the newly-filled slot indices.  Head-of-line
        blocking is deliberate: admission order == submission order, which
        the token-identity oracle test relies on."""
        filled = []
        for i in range(self.max_batch):
            if self.slots[i] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            try:
                handles = self.alloc.alloc_many(self.blocks_needed(req))
            except KVCacheOOM:
                break                      # pool full: wait for an evict
            self.waiting.popleft()
            self.slots[i] = Sequence(
                req=req, handles=handles,
                table=block_table_view(self.alloc, handles, self.table_width),
                admit_seq=self._admitted)
            self._admitted += 1
            filled.append(i)
        return filled

    # -- per-step work selection ------------------------------------------
    def prefill_slot(self) -> Optional[int]:
        """The ONE slot that prefills this step: earliest-admitted sequence
        still working through its prompt (None when all slots decode)."""
        best, best_seq = None, None
        for i, s in enumerate(self.slots):
            if s is not None and s.state == PREFILL:
                if best is None or s.admit_seq < best_seq:
                    best, best_seq = i, s.admit_seq
        return best

    def decode_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.state == DECODE]

    # -- deadlines ---------------------------------------------------------
    @staticmethod
    def _past_deadline(req, now_step: int) -> bool:
        deadline = getattr(req, "deadline_steps", None)
        start = getattr(req, "submit_step", None)
        return (deadline is not None and start is not None
                and now_step - start >= deadline)

    def expire(self, now_step: int) -> list:
        """Abandon every waiting or running request whose deadline has
        passed (``deadline_steps`` engine steps since submission): running
        ones are evicted (blocks freed, slot opened), waiting ones leave
        the queue; each is marked ``expired`` and ``done``.  Returns the
        expired requests — partial output stays on the request, truncated,
        never corrupted."""
        out = []
        for i, s in enumerate(self.slots):
            if s is not None and self._past_deadline(s.req, now_step):
                out.append(self.evict(i))
        if self.waiting:
            keep = collections.deque()
            for req in self.waiting:
                (out if self._past_deadline(req, now_step)
                 else keep).append(req)
            self.waiting = keep
        for req in out:
            req.expired = True
            req.done = True
        return out

    # -- eviction ----------------------------------------------------------
    def evict(self, i: int):
        """Free slot ``i`` and return its request *unchanged* (recovery
        replay / deadline expiry — the caller decides the request's fate;
        :meth:`finish` is the normal completion path)."""
        seq = self.slots[i]
        if seq is None:
            raise ValueError(f"slot {i} is already empty")
        req = seq.req
        self.finish(i)
        return req

    def finish(self, i: int) -> None:
        """Evict slot ``i``: free its blocks (handles go stale forever) and
        open the slot for the next admit."""
        seq = self.slots[i]
        if seq is None:
            raise ValueError(f"slot {i} is already empty")
        self.alloc.free_many(seq.handles)
        seq.handles = []
        self.slots[i] = None
