"""The port's paged KV allocator and continuous-batching scheduler against
the reference's: each test runs once per package with the same call
sequence and asserts the same handles, tables, admissions and errors, and
the trace tests hold both packages' recorded results equal, call for call."""
import types

import numpy as np
import pytest

import repro.serve.engine as j_engine
import repro.serve.kv_cache as j_kv
import repro.serve.scheduler as j_sched
import repro_torch.serve.engine as t_engine
import repro_torch.serve.kv_cache as t_kv
import repro_torch.serve.scheduler as t_sched

PACKAGES = {
    "repro": types.SimpleNamespace(kv=j_kv, sched=j_sched, Request=j_engine.Request),
    "repro_torch": types.SimpleNamespace(kv=t_kv, sched=t_sched, Request=t_engine.Request),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# ---------------------------------------------------------------------------
# paged KV allocator
# ---------------------------------------------------------------------------
def test_alloc_free_roundtrip(pkg):
    a = pkg.kv.BlockAllocator(num_blocks=5, block_size=4)
    assert a.free_blocks == 4          # block 0 reserved
    hs = a.alloc_many(3)
    assert a.live_blocks == 3 and a.free_blocks == 1
    ids = {a.block_id(h) for h in hs}
    assert len(ids) == 3 and pkg.kv.NULL_BLOCK not in ids
    a.free_many(hs)
    assert a.live_blocks == 0 and a.free_blocks == 4


def test_stale_handle_after_free(pkg):
    a = pkg.kv.BlockAllocator(num_blocks=3, block_size=2)
    h = a.alloc()
    a.free(h)
    with pytest.raises(pkg.kv.StaleBlockError):
        a.block_id(h)
    with pytest.raises((pkg.kv.StaleBlockError, pkg.kv.DoubleFreeError)):
        a.free(h)
    h2 = a.alloc()
    assert h2 != h and a.block_id(h2) == (h & ((1 << 32) - 1))
    with pytest.raises(pkg.kv.StaleBlockError):
        a.block_id(h)


def test_oom_is_clean_and_all_or_none(pkg):
    a = pkg.kv.BlockAllocator(num_blocks=4, block_size=2)
    a.alloc_many(2)
    with pytest.raises(pkg.kv.KVCacheOOM):
        a.alloc_many(2)
    assert a.free_blocks == 1
    a.alloc()
    with pytest.raises(pkg.kv.KVCacheOOM):
        a.alloc()


def test_blocks_for_and_table_view(pkg):
    a = pkg.kv.BlockAllocator(num_blocks=6, block_size=4)
    assert [a.blocks_for(n) for n in (0, 1, 4, 5)] == [0, 1, 1, 2]
    hs = a.alloc_many(2)
    row = pkg.kv.block_table_view(a, hs, width=4)
    assert row.dtype == np.int32 and row.shape == (4,)
    assert list(row[:2]) == [a.block_id(h) for h in hs]
    assert list(row[2:]) == [pkg.kv.NULL_BLOCK, pkg.kv.NULL_BLOCK]
    with pytest.raises(ValueError):
        pkg.kv.block_table_view(a, hs, width=1)
    a.free(hs[0])
    with pytest.raises(pkg.kv.StaleBlockError):
        pkg.kv.block_table_view(a, hs, width=4)


def test_allocator_rejects_a_pool_without_room(pkg):
    with pytest.raises(ValueError):
        pkg.kv.BlockAllocator(num_blocks=1, block_size=4)


def _alloc_trace(pkg, seed: int) -> list:
    """A seeded sequence of alloc, alloc_many, free and table views (stale
    handles included); every result or error class is recorded."""
    rng = np.random.default_rng(seed)
    a = pkg.kv.BlockAllocator(num_blocks=9, block_size=4)
    held, dead, out = [], [], []
    for _ in range(200):
        op = int(rng.integers(0, 5))
        try:
            if op == 0:
                h = a.alloc()
                held.append(h)
                out.append(("alloc", h))
            elif op == 1:
                hs = a.alloc_many(int(rng.integers(0, 4)))
                held.extend(hs)
                out.append(("alloc_many", tuple(hs)))
            elif op == 2 and held:
                h = held.pop(int(rng.integers(0, len(held))))
                a.free(h)
                dead.append(h)
                out.append(("free", h))
            elif op == 3 and dead:
                h = dead[int(rng.integers(0, len(dead)))]
                out.append(("stale", a.block_id(h)))
            else:
                out.append(("view", tuple(pkg.kv.block_table_view(a, held[:8], 8))))
        except (pkg.kv.KVCacheOOM, pkg.kv.StaleBlockError, pkg.kv.DoubleFreeError,
                ValueError) as e:
            out.append(("error", type(e).__name__))
        out.append((a.live_blocks, a.free_blocks))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_trace_equals_reference(seed):
    assert _alloc_trace(PACKAGES["repro_torch"], seed) == _alloc_trace(PACKAGES["repro"], seed)


# ---------------------------------------------------------------------------
# scheduler (pure host-side, no model)
# ---------------------------------------------------------------------------
def _req(pkg, rid, n, max_new=4):
    return pkg.Request(rid, np.arange(1, n + 1, dtype=np.int32), max_new_tokens=max_new)


def test_scheduler_fifo_admission_and_funding(pkg):
    a = pkg.kv.BlockAllocator(num_blocks=5, block_size=4)
    s = pkg.sched.Scheduler(a, max_batch=2, prefill_chunk=4, table_width=4)
    for r in (_req(pkg, 0, 6), _req(pkg, 1, 3, 3), _req(pkg, 2, 3, 3)):
        s.submit(r)
    assert s.admit() == [0]            # r1 cannot be funded; r2 must not jump it
    assert s.slots[0].req.rid == 0 and s.slots[1] is None
    assert [r.rid for r in s.waiting] == [1, 2]
    s.finish(0)
    assert s.admit() == [0, 1]
    assert [s.slots[i].req.rid for i in (0, 1)] == [1, 2]


def test_scheduler_prefill_priority_and_states(pkg):
    a = pkg.kv.BlockAllocator(num_blocks=9, block_size=4)
    s = pkg.sched.Scheduler(a, max_batch=2, prefill_chunk=4, table_width=4)
    s.submit(_req(pkg, 0, 5))
    s.submit(_req(pkg, 1, 5))
    s.admit()
    assert s.prefill_slot() == 0
    s.slots[0].state = pkg.sched.DECODE
    assert s.prefill_slot() == 1
    s.slots[1].state = pkg.sched.DECODE
    assert s.prefill_slot() is None
    assert s.decode_slots() == [0, 1]


def test_scheduler_finish_frees_blocks(pkg):
    a = pkg.kv.BlockAllocator(num_blocks=5, block_size=4)
    s = pkg.sched.Scheduler(a, max_batch=1, prefill_chunk=4, table_width=4)
    s.submit(_req(pkg, 0, 6))
    s.admit()
    assert a.live_blocks > 0
    s.finish(0)
    assert a.live_blocks == 0 and s.slots[0] is None
    with pytest.raises(ValueError):
        s.finish(0)


def test_scheduler_rejects_impossible_requests(pkg):
    a = pkg.kv.BlockAllocator(num_blocks=4, block_size=4)
    s = pkg.sched.Scheduler(a, max_batch=1, prefill_chunk=4, table_width=3)
    with pytest.raises(ValueError):    # wider than the block table
        s.submit(_req(pkg, 0, 10, max_new=8))
    s2 = pkg.sched.Scheduler(a, max_batch=1, prefill_chunk=4, table_width=8)
    with pytest.raises(ValueError):    # larger than the whole pool
        s2.submit(_req(pkg, 0, 10, max_new=8))


def test_scheduler_evict_requeue_and_expire(pkg):
    a = pkg.kv.BlockAllocator(num_blocks=9, block_size=4)
    s = pkg.sched.Scheduler(a, max_batch=2, prefill_chunk=4, table_width=4)
    reqs = [_req(pkg, i, 5) for i in range(3)]
    for r in reqs:
        r.submit_step = 0
        s.submit(r)
    assert s.admit() == [0, 1]
    evicted = [s.evict(0), s.evict(1)]
    assert [r.rid for r in evicted] == [0, 1] and a.live_blocks == 0
    s.requeue(evicted)                 # replay order = submission order
    assert [r.rid for r in s.waiting] == [0, 1, 2]
    reqs[1].deadline_steps = 2
    assert s.admit() == [0, 1]
    assert s.expire(1) == []
    gone = s.expire(2)
    assert [r.rid for r in gone] == [1] and gone[0].expired and gone[0].done
    assert s.slots[1] is None and s.active == 1
    with pytest.raises(ValueError):
        s.evict(1)


def _sched_trace(pkg, seed: int) -> list:
    """A seeded run of submits, admissions, state changes, finishes,
    evictions with requeue and expiry; slots, tables and queues recorded."""
    rng = np.random.default_rng(seed)
    a = pkg.kv.BlockAllocator(num_blocks=12, block_size=4)
    s = pkg.sched.Scheduler(a, max_batch=3, prefill_chunk=4, table_width=6)
    out, rid = [], 0
    for step in range(120):
        op = int(rng.integers(0, 6))
        try:
            if op == 0:
                r = _req(pkg, rid, int(rng.integers(1, 14)), int(rng.integers(1, 9)))
                r.submit_step = step
                if rng.random() < 0.3:
                    r.deadline_steps = int(rng.integers(0, 20))
                rid += 1
                s.submit(r)
                out.append(("submit", r.rid))
            elif op == 1:
                out.append(("admit", tuple(s.admit())))
            elif op == 2:
                i = s.prefill_slot()
                if i is not None:
                    s.slots[i].state = pkg.sched.DECODE
                out.append(("prefill", i, tuple(s.decode_slots())))
            elif op == 3:
                i = int(rng.integers(0, 3))
                s.finish(i)
                out.append(("finish", i))
            elif op == 4:
                i = int(rng.integers(0, 3))
                r = s.evict(i)
                s.requeue([r])
                out.append(("evict", i, r.rid))
            else:
                out.append(("expire", tuple(r.rid for r in s.expire(step))))
        except ValueError as e:
            out.append(("error", str(e).split(":")[0]))
        out.append((tuple(None if q is None else (q.req.rid, tuple(q.table), q.admit_seq)
                          for q in s.slots),
                    tuple(r.rid for r in s.waiting), a.live_blocks))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_trace_equals_reference(seed):
    assert _sched_trace(PACKAGES["repro_torch"], seed) == _sched_trace(PACKAGES["repro"], seed)
