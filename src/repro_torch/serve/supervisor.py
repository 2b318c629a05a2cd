"""Serving fault supervisor: observe the death, shrink the tp comm, replay
in-flight requests token-identically (the port of
``repro.serve.supervisor``).

* **notification** — before each engine step the supervisor beats the
  :class:`~repro_torch.runtime.liveness.HeartbeatMonitor` (on its cadence)
  and runs the ULFM notification idiom, a ``comm_agree(1, tp_comm)`` probe
  that raises ``PAX_ERR_PROC_FAILED`` while the failure detector reports an
  unacknowledged death.  A failure may also surface from the ``decode-tp``
  group start itself; both land in the same handler.
* **recovery** — revoke → failure_ack → get_failed → agree(1) → shrink on
  the tp communicator; the dead ``DecodeSync`` group is retired and a fresh
  one is built on the survivor communicator (whose process group holds the
  survivors only); the monitor rebinds onto it.
* **replay** — every in-flight request is evicted, its generated tokens
  counted and discarded, and re-queued at the front of the waiting queue in
  admission order; sampling keys depend on (seed, rid, step), so replaying
  from the prompt regenerates the same stream.
* **transport faults** — ``wait_timeout_s`` bounds the decode sync's waits,
  so a dropped broadcast raises ``PAX_ERR_TIMEOUT``; a corrupted one
  (integrity on) raises ``PAX_ERR_DATA_CORRUPTION`` where the tokens are
  read.  Either aborts the group (``DecodeSync.reset``) and re-runs THE SAME
  engine step; after ``transport_retries`` failed re-runs the fault
  escalates into the recovery above.

On a world of processes every rank runs its own supervisor over its own
engine; the dead rank walks the recovery with the others (every rank sees
the same injected failure) and then holds no member of the survivor
communicator — its caller retires it (``ServeRecoveryReport.left``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

from ..core.errors import PAX_ERR_PROC_FAILED, PaxError
from ..runtime.fault import TRANSPORT_ERRORS

log = logging.getLogger("repro_torch.serve.supervisor")


@dataclasses.dataclass
class ServeRecoveryReport:
    """The supervisor's ledger.  Invariants (``assert_consistent``): each
    replay re-queues or drops every then-in-flight request exactly once, so
    ``sum(retries) == requeued + dropped``; replays never exceed failures."""

    failures: int = 0                 # PROC_FAILED events handled
    replays: int = 0                  # recovery passes that evicted slots
    tokens_replayed: int = 0          # generated tokens discarded for replay
    requeued: int = 0                 # eviction -> front-of-queue re-admissions
    dropped: int = 0                  # requests past max_retries (failed flag)
    expired: int = 0                  # deadline expiries observed
    backoff_s_total: float = 0.0
    failed_ranks: list = dataclasses.field(default_factory=list)
    retries: dict = dataclasses.field(default_factory=dict)  # rid -> count
    transport_retries: int = 0
    transport_escalations: int = 0
    #: this rank is not a member of the survivor communicator: it left
    left: bool = False

    def assert_consistent(self) -> None:
        assert self.replays <= self.failures, (self.replays, self.failures)
        assert sum(self.retries.values()) == self.requeued + self.dropped, \
            (self.retries, self.requeued, self.dropped)
        assert self.tokens_replayed >= 0
        assert len(self.failed_ranks) == self.failures, (self.failed_ranks, self.failures)


class ServeSupervisor:
    """Drive a :class:`~.engine.ServeEngine` with fault supervision.

    ``monitor`` is beaten every ``heartbeat_every`` supervisor steps;
    ``max_failures`` bounds recoveries; ``backoff_s`` doubles per failure;
    ``max_retries`` bounds how often one request is replayed before it is
    dropped; ``wait_timeout_s`` and ``transport_retries`` as above."""

    def __init__(self, engine, *, monitor=None, heartbeat_every: int = 1,
                 max_failures: int = 3, backoff_s: float = 0.0,
                 max_retries: int = 3, sleep=time.sleep,
                 wait_timeout_s: Optional[float] = None,
                 transport_retries: int = 2) -> None:
        if engine.decode_sync is None:
            raise ValueError("ServeSupervisor needs an engine with a "
                             "DecodeSync (the tp comm is what it recovers)")
        self.engine = engine
        self.monitor = monitor
        self.heartbeat_every = max(1, heartbeat_every)
        self.max_failures = max_failures
        self.backoff_s = backoff_s
        self.max_retries = max_retries
        self.wait_timeout_s = wait_timeout_s
        self.transport_retries = transport_retries
        if wait_timeout_s is not None:
            engine.decode_sync.wait_timeout_s = wait_timeout_s
        self.report = ServeRecoveryReport()
        self._sleep = sleep
        self._steps = 0

    # -- the supervised step ------------------------------------------------
    def step(self) -> None:
        eng = self.engine
        self._steps += 1
        if self.monitor is not None and self._steps % self.heartbeat_every == 0:
            self.monitor.beat()
        ds = eng.decode_sync
        try:
            ds.abi.comm_agree(1, ds.comm)
            eng.step()
            self.report.expired += len(eng.last_expired)
        except PaxError as e:
            if e.code == PAX_ERR_PROC_FAILED:
                self._recover(e)
            elif e.code in TRANSPORT_ERRORS:
                self._transport_fault(e)
            else:
                raise

    def drain(self) -> None:
        while self.engine.has_work and not self.report.left:
            self.step()

    def run(self, requests) -> ServeRecoveryReport:
        for r in requests:
            self.engine.submit(r)
        self.drain()
        self.report.assert_consistent()
        return self.report

    # -- transport faults ---------------------------------------------------
    def _transport_fault(self, cause: PaxError) -> None:
        """Retry-with-backoff for a corrupted or timed-out decode sync: abort
        the wedged group, back off, re-run the SAME engine step (no token
        was appended before the sync, so the re-run re-reads the same KV
        positions); exhausted retries escalate into :meth:`_recover`."""
        eng, rep = self.engine, self.report
        err = cause
        tries = 0
        while True:
            eng.decode_sync.reset()
            tries += 1
            if tries > self.transport_retries:
                rep.transport_escalations += 1
                log.error("transport fault persists after %d retries (%s); "
                          "escalating to rank-death recovery", self.transport_retries, err)
                self._recover(err)
                return
            rep.transport_retries += 1
            log.warning("transport fault (%s); retrying step in place %d/%d",
                        err, tries, self.transport_retries)
            if self.backoff_s:
                delay = self.backoff_s * (2 ** (tries - 1))
                rep.backoff_s_total += delay
                self._sleep(delay)
            try:
                eng.step()
                rep.expired += len(eng.last_expired)
                return
            except PaxError as e:
                if e.code == PAX_ERR_PROC_FAILED:
                    self._recover(e)
                    return
                if e.code not in TRANSPORT_ERRORS:
                    raise
                err = e

    # -- recovery -----------------------------------------------------------
    def _recover(self, cause: PaxError) -> tuple:
        rep = self.report
        rep.failures += 1
        if rep.failures > self.max_failures:
            raise RuntimeError(f"exceeded {self.max_failures} serving recoveries") from cause
        if self.backoff_s:
            delay = self.backoff_s * (2 ** (rep.failures - 1))
            rep.backoff_s_total += delay
            self._sleep(delay)

        eng = self.engine
        ds = eng.decode_sync
        abi, comm = ds.abi, ds.comm
        me = abi.comm_rank(comm)

        # the tripwire can raise before the monitor confirms the corpse:
        # beat (on the heartbeat's own comm) until the detector names one,
        # bounded by the monitor's confirmation horizon
        if self.monitor is not None and not abi.comm_get_failed(comm):
            budget = self.monitor.miss_threshold + self.monitor.suspicion_ticks + 1
            while budget > 0 and not abi.comm_get_failed(comm):
                self.monitor.beat()
                budget -= 1
        failed = tuple(abi.comm_get_failed(comm))
        if not failed:
            raise RuntimeError(
                "PROC_FAILED raised but no failure detector names a corpse "
                "(liveness monitor not installed?)") from cause

        abi.comm_revoke(comm)          # poisons the comm, resets its plans
        abi.comm_failure_ack(comm)
        failed = tuple(abi.comm_get_failed(comm))
        abi.comm_agree(1, comm)
        survivor = abi.comm_shrink(comm)
        rep.failed_ranks.append(failed)
        ds.free()
        if me in failed:
            # this process is the corpse: it holds no survivor group
            rep.left = True
            eng.decode_sync = None
            log.warning("serving recovery: this rank failed on the tp comm and leaves")
            return failed
        log.warning("serving recovery: ranks %s failed on the tp comm, %d survivors",
                    list(failed), abi.comm_size(survivor))
        eng.rebuild_decode_sync(abi, survivor, getattr(ds, "device", None),
                                wait_timeout_s=getattr(ds, "wait_timeout_s",
                                                       self.wait_timeout_s))
        if self.monitor is not None:
            self.monitor.rebind(survivor)
        self._replay_inflight()
        return failed

    def _replay_inflight(self) -> None:
        """Evict every occupied slot and re-queue (or drop) its request for
        a from-the-prompt replay, front of the queue in admission order."""
        eng, rep = self.engine, self.report
        sched = eng.scheduler
        occupied = sorted((i for i, s in enumerate(sched.slots) if s is not None),
                          key=lambda i: sched.slots[i].admit_seq)
        if not occupied:
            return
        rep.replays += 1
        requeue = []
        for i in occupied:
            req = sched.evict(i)
            rep.tokens_replayed += len(req.out_tokens)
            req.out_tokens = []
            req.done = False
            req.retries += 1
            rep.retries[req.rid] = req.retries
            if req.retries > self.max_retries:
                req.failed = True
                req.done = True
                rep.dropped += 1
                log.warning("request %d dropped after %d replays", req.rid, req.retries)
                continue
            requeue.append(req)
        sched.requeue(requeue)
        rep.requeued += len(requeue)
