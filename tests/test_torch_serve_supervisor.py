"""The port's serving supervisor against the reference, on the CPU: the twin
of ``tests/test_serve_supervisor.py`` plus the multidev battery's sections
16 and 18 (serving half) on gloo worlds of two.

* the heartbeat monitor's miss-threshold/suspicion edges (confirmed after
  exactly ``miss_threshold + suspicion_ticks - 1`` silent ticks), its
  ``local_failed`` funnel, validation;
* the recovery walk's order, the replay ledger, backoff and retry bounds,
  an unattributed failure — over the same fake transport and real
  scheduler as the reference's tests, both packages side by side;
* tp=2 with a silent killer (only the monitor can name the corpse): rank 1
  dies mid-decode with three requests in flight, rank 0 walks revoke → ack
  → agree → shrink, rebuilds the ``decode-tp`` group on the survivor
  communicator and replays; and a dropped decode broadcast, timed out,
  retried once and escalated through the heartbeat; on ``paxi``,
  ``minimal`` and ``ompix``, every stream equal to an unfailed engine's
  token for token.
"""
import numpy as np
import pytest
import torch

from repro.serve import supervisor as r_sup
from repro.serve.engine import Request as RRequest
from repro.serve.kv_cache import BlockAllocator as RAlloc
from repro.serve.scheduler import Scheduler as RScheduler

import repro_torch.core as C
from repro_torch.core.errors import PAX_ERR_PROC_FAILED, PaxError
from repro_torch.runtime.dist import make_dist
from repro_torch.runtime.liveness import HeartbeatMonitor
from repro_torch.serve import supervisor as t_sup
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.kv_cache import BlockAllocator as TAlloc
from repro_torch.serve.scheduler import DECODE
from repro_torch.serve.scheduler import Scheduler as TScheduler

import _torch_fault_ranks as FR
import _torch_ranks


@pytest.fixture(scope="module")
def tp_world():
    with make_dist(device="cpu") as d:
        yield d, C.pax_init(d.mesh, impl="paxi")


def _monitor(abi, miss=3, susp=2):
    comm = abi.comm_from_axes(("model",), f"tp-m{miss}s{susp}")
    return HeartbeatMonitor(abi, comm, miss_threshold=miss, suspicion_ticks=susp)


@pytest.mark.parametrize("miss,susp", [(3, 2), (1, 1), (2, 3)])
def test_confirmation_edge_is_exact(tp_world, miss, susp):
    _, abi = tp_world
    mon = _monitor(abi, miss, susp)
    mon.inject_silence(0)
    for tick in range(1, miss + susp - 1):
        mon.beat()
        assert 0 not in mon.confirmed, tick
    mon.beat()
    assert 0 in mon.confirmed and mon.failed(mon.comm) == (0,)


def test_answering_clears_suspicion(tp_world):
    _, abi = tp_world
    mon = _monitor(abi, miss=2, susp=2)
    mon.inject_silence(0)
    mon.beat()
    mon.beat()
    assert mon.suspected and 0 not in mon.confirmed
    mon.clear_silence(0)
    mon.beat()
    assert not mon.suspected and 0 not in mon.confirmed
    mon.inject_silence(0)
    for _ in range(2):
        mon.beat()
        assert 0 not in mon.confirmed
    mon.beat()
    assert 0 in mon.confirmed


def test_monitor_feeds_the_fault_tier(tp_world):
    _, abi = tp_world
    mon = _monitor(abi, miss=1, susp=1)
    comm = mon.comm
    mon.install()
    try:
        assert tuple(abi.comm_get_failed(comm)) == ()
        mon.inject_silence(0)
        mon.beat()
        assert tuple(abi.comm_get_failed(comm)) == (0,)
        with pytest.raises(PaxError) as ei:
            abi.comm_agree(1, comm)
        assert ei.value.code == PAX_ERR_PROC_FAILED
    finally:
        mon.uninstall()
    assert tuple(abi.comm_get_failed(comm)) == ()


def test_monitor_validates_thresholds(tp_world):
    _, abi = tp_world
    with pytest.raises(ValueError):
        _monitor(abi, miss=0, susp=1)
    with pytest.raises(ValueError):
        _monitor(abi, miss=1, susp=0)


# ---------------------------------------------------------------------------
# the supervisor over a fake transport, both packages side by side
# ---------------------------------------------------------------------------
class _FakeAbi:
    def __init__(self, failed=(2,)):
        self.reported = tuple(failed)
        self.walk = []

    def comm_rank(self, comm):
        return 0

    def comm_get_failed(self, comm):
        self.walk.append("get_failed")
        return self.reported

    def comm_revoke(self, comm):
        self.walk.append("revoke")

    def comm_failure_ack(self, comm):
        self.walk.append("ack")

    def comm_agree(self, v, comm):
        self.walk.append("agree")
        return v

    def comm_shrink(self, comm):
        self.walk.append("shrink")
        return ("survivor", comm)

    def comm_size(self, comm):
        return 3


class _FakeSync:
    def __init__(self, abi, comm="tp", mesh="mesh", wait_timeout_s=None):
        self.abi, self.comm, self.mesh = abi, comm, mesh
        self.wait_timeout_s = wait_timeout_s

    def free(self):
        pass

    def reset(self):
        pass


class _FakeEngine:
    """A real scheduler and real requests over a fake transport (the
    reference's fixture, for either package)."""

    def __init__(self, abi, pkg, max_batch=3):
        alloc = (RAlloc if pkg == "ref" else TAlloc)(num_blocks=16, block_size=4)
        self.decode_sync = _FakeSync(abi)
        self.scheduler = (RScheduler if pkg == "ref" else TScheduler)(
            alloc, max_batch=max_batch, prefill_chunk=4, table_width=4)
        self.stats = {"steps": 0}
        self.last_expired = []
        self.fail_next = False
        self.rebuilt = []

    def submit(self, req):
        if req.submit_step is None:
            req.submit_step = self.stats["steps"]
        self.scheduler.submit(req)

    @property
    def has_work(self):
        return self.scheduler.has_work

    def rebuild_decode_sync(self, abi, comm, mesh=None, wait_timeout_s=None):
        self.rebuilt.append(comm)
        self.decode_sync = _FakeSync(abi, comm, mesh, wait_timeout_s)

    def step(self):
        self.stats["steps"] += 1
        self.last_expired = self.scheduler.expire(self.stats["steps"])
        self.scheduler.admit()
        if self.fail_next:
            self.fail_next = False
            raise self.error(PAX_ERR_PROC_FAILED, "injected")
        for i, s in enumerate(self.scheduler.slots):
            if s is None:
                continue
            s.state = DECODE
            s.req.out_tokens.append(100 + len(s.req.out_tokens))
            if len(s.req.out_tokens) >= s.req.max_new_tokens:
                s.req.done = True
                self.scheduler.finish(i)


def _world(pkg, failed=(2,), **kw):
    from repro.core.errors import PaxError as RPaxError

    abi = _FakeAbi(failed)
    eng = _FakeEngine(abi, pkg)
    eng.error = RPaxError if pkg == "ref" else PaxError
    sup = (r_sup if pkg == "ref" else t_sup).ServeSupervisor(eng, **kw)
    req = RRequest if pkg == "ref" else TRequest
    reqs = [req(i, np.arange(1, 4, dtype=np.int32), max_new_tokens=6) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    return abi, eng, sup, reqs


def _ledger(rep):
    return (rep.failures, rep.replays, rep.tokens_replayed, rep.requeued, rep.dropped,
            rep.backoff_s_total, list(rep.failed_ranks), dict(rep.retries),
            rep.transport_retries, rep.transport_escalations)


def test_recovery_walk_and_replay_ledger_match_the_reference():
    seen = []
    for pkg in ("ref", "port"):
        abi, eng, sup, reqs = _world(pkg)
        sup.step()
        sup.step()
        mid = [len(r.out_tokens) for r in reqs]
        eng.fail_next = True
        sup.step()
        walk = [w for w in abi.walk if w != "get_failed"]
        queued = [r.rid for r in eng.scheduler.waiting]
        led = _ledger(sup.report)
        sup.report.assert_consistent()
        sup.drain()
        seen.append((mid, walk, eng.rebuilt, queued, led,
                     [(r.out_tokens, r.done, r.retries) for r in reqs]))
    assert seen[0] == seen[1]
    mid, walk, rebuilt, queued, led, final = seen[1]
    assert walk[:1] == ["agree"] and walk[-4:] == ["revoke", "ack", "agree", "shrink"]
    assert rebuilt == [("survivor", "tp")] and queued == [0, 1, 2]
    assert led[0] == 1 and led[2] == sum(mid) == 6


def test_backoff_doubles_and_failures_are_bounded():
    delays = []
    abi, eng, sup, reqs = _world("port", max_failures=3, backoff_s=0.5, sleep=delays.append)
    for _ in range(3):
        eng.fail_next = True
        sup.step()
    assert delays == [0.5, 1.0, 2.0] and sup.report.backoff_s_total == 3.5
    eng.fail_next = True
    with pytest.raises(RuntimeError, match="exceeded 3"):
        sup.step()


def test_retries_are_bounded_per_request_as_the_reference():
    seen = []
    for pkg in ("ref", "port"):
        abi, eng, sup, reqs = _world(pkg, max_retries=2, max_failures=5)
        for _ in range(3):
            sup.step()
            eng.fail_next = True
            sup.step()
        sup.report.assert_consistent()
        seen.append((_ledger(sup.report), [(r.failed, r.done) for r in reqs], eng.has_work))
    assert seen[0] == seen[1] and seen[1][0][4] == 3


def test_unattributed_failure_is_loud():
    abi, eng, sup, _ = _world("port", failed=())
    eng.fail_next = True
    with pytest.raises(RuntimeError, match="no failure detector"):
        sup.step()
    assert "revoke" not in abi.walk


def test_supervisor_requires_decode_sync():
    abi, eng, _, _ = _world("port")
    eng.decode_sync = None
    with pytest.raises(ValueError, match="DecodeSync"):
        t_sup.ServeSupervisor(eng)


def test_ledger_invariants():
    rep = t_sup.ServeRecoveryReport()
    rep.assert_consistent()
    rep.failures, rep.replays, rep.requeued, rep.dropped = 2, 1, 2, 1
    rep.retries = {0: 1, 1: 2}
    rep.failed_ranks = [(2,), (5,)]
    rep.tokens_replayed = 7
    rep.assert_consistent()
    rep.requeued = 5
    with pytest.raises(AssertionError):
        rep.assert_consistent()


# ---------------------------------------------------------------------------
# tp=2 on gloo: a mid-decode death and a dropped decode broadcast
# ---------------------------------------------------------------------------
_RUNS: dict = {}


def _run(impl, mode, tmp_path_factory):
    key = (impl, mode)
    if key not in _RUNS:
        _RUNS[key] = _torch_ranks.run_ranks(
            FR.serve_rank, 2, tmp_path_factory.mktemp(f"serve-{impl}-{mode}"), impl, mode,
            timeout=120)
    return _RUNS[key]


@pytest.mark.parametrize("impl", ["paxi", "minimal", "ompix"])
def test_mid_decode_death_replays_token_identically(tmp_path_factory, impl):
    r0, r1 = _run(impl, "die", tmp_path_factory)
    assert all(m > 0 for m in r0["mid"])  # genuinely mid-decode
    assert not r0["left"] and r0["failures"] == 1 and r0["tokens_replayed"] == r0["mid"].sum()
    assert list(r0["excludes"]) == [1] and list(r0["confirmed"]) == [1]  # observed
    for i in range(3):
        np.testing.assert_array_equal(r0[f"got{i}"], r0[f"want{i}"])
    assert r1["left"] and r1["failures"] == 1


@pytest.mark.parametrize("impl", ["paxi", "minimal", "ompix"])
def test_dropped_decode_bcast_times_out_escalates_and_replays(tmp_path_factory, impl):
    r0, r1 = _run(impl, "drop", tmp_path_factory)
    assert not r0["left"]
    assert (int(r0["transport_retries"]), int(r0["escalations"]), int(r0["failures"])) == (
        1, 1, 1)
    assert list(r0["excludes"]) == [1] and list(r0["confirmed"]) == [1]
    for i in range(3):
        np.testing.assert_array_equal(r0[f"got{i}"], r0[f"want{i}"])
    assert r1["left"]
