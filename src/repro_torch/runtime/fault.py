"""Fault tolerance: supervised training with checkpoint/restart, a step-time
watchdog, transport retries and ULFM-style elastic recovery (the port of
``repro.runtime.fault``).

* :class:`StepWatchdog` — step latencies, stragglers (> k × rolling
  median), and the ride-it-out-or-restart decision;
* :class:`RetryPolicy` — same-step retries of transport faults
  (``PAX_ERR_DATA_CORRUPTION``, ``PAX_ERR_TIMEOUT``), escalating to the
  rank-death funnel when they persist;
* :class:`RecoveryPolicy` — how to come back from ``PAX_ERR_PROC_FAILED``:
  revoke → ack → get_failed → agree → shrink on the data-parallel
  communicator, then ``rebuild`` the training world for the survivors;
* :func:`run_supervised` — the step loop with periodic async checkpoints,
  restart on failure from the latest checkpoint, up to ``max_restarts``.

One process is one rank: every rank runs this loop, reaches the same
decisions on the same calls and walks the recovery together — the rank
that died too, since every rank sees the same injected failure.  A rank
that is not in the rebuilt world (the dead one, or one the rebuild trims
away) leaves the loop with ``SupervisorReport.left_world`` set; its
caller then shuts its context down as a failed one.

The port's train step updates its parameter module in place, so a restart
with no checkpoint to restore from cannot return to the initial state:
:func:`run_supervised` raises instead (the reference restarts from
``init_state``, which its functional step never changed).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Callable, Iterable, Optional

from ..core.errors import (
    PAX_ERR_DATA_CORRUPTION,
    PAX_ERR_PROC_FAILED,
    PAX_ERR_TIMEOUT,
    PaxError,
)

log = logging.getLogger("repro_torch.fault")


class StepWatchdog:
    def __init__(self, window: int = 32, straggler_factor: float = 3.0,
                 on_straggler: Optional[Callable[[int, float], str]] = None) -> None:
        self.times: deque[float] = deque(maxlen=window)
        self.factor = straggler_factor
        self.stragglers: list[tuple[int, float]] = []
        self._decide = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        """Whether this step was a straggler."""
        is_straggler = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.factor * med:
                is_straggler = True
                self.stragglers.append((step, dt))
                log.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt, med)
        self.times.append(dt)
        return is_straggler

    def on_straggler(self, step: int, dt: float) -> str:
        """``"continue"`` to ride a flagged straggler out, ``"restart"`` to
        checkpoint now and restart the step loop; the policy is the
        constructor's ``on_straggler`` (default: continue)."""
        if self._decide is None:
            return "continue"
        decision = self._decide(step, dt)
        if decision not in ("continue", "restart"):
            raise ValueError(f"on_straggler policy returned {decision!r} "
                             "(expected 'continue' or 'restart')")
        return decision


#: the transport error classes a retry can cure: a one-shot corruption
#: re-runs cleanly, a transient drop re-runs; a link that stays down keeps
#: timing out, which is what escalation is for
TRANSPORT_ERRORS = (PAX_ERR_DATA_CORRUPTION, PAX_ERR_TIMEOUT)


@dataclasses.dataclass
class RetryPolicy:
    """Retry-with-backoff for transport faults, escalating to rank death.

    ``run(attempt)`` returns ``attempt()``'s result.  A :class:`PaxError`
    whose code is in ``retryable`` triggers ``reset()`` (abort timed-out
    plan and group slots), a backoff sleep and a re-run; ``verify`` is a
    verdict on the result (``abi.verify_clean`` on the step's metrics).
    After ``max_retries`` failed re-runs ``escalate(cause)`` runs and the
    error propagates.  Every other error class propagates untouched."""

    max_retries: int = 2
    backoff_s: float = 0.0
    verify: Optional[Callable] = None
    reset: Optional[Callable] = None
    escalate: Optional[Callable] = None
    retryable: tuple = TRANSPORT_ERRORS
    retries: int = 0
    escalations: int = 0

    def run(self, attempt: Callable, *, what: str = ""):
        tries = 0
        while True:
            try:
                out = attempt()
                if self.verify is not None:
                    self.verify(out)
                return out
            except PaxError as e:
                if e.code not in self.retryable:
                    raise
                if self.reset is not None:
                    self.reset()
                tries += 1
                if tries > self.max_retries:
                    self.escalations += 1
                    log.error("%s: transport fault persists after %d retries (%s); "
                              "escalating", what or "attempt", self.max_retries, e)
                    if self.escalate is not None:
                        self.escalate(e)
                    raise
                self.retries += 1
                log.warning("%s: transport fault (%s); retry %d/%d",
                            what or "attempt", e, tries, self.max_retries)
                if self.backoff_s:
                    time.sleep(self.backoff_s * (2 ** (tries - 1)))


def escalate_to_failure(monitor, max_ticks: int = 32) -> Callable:
    """A :class:`RetryPolicy` ``escalate`` hook: beat ``monitor`` until it
    confirms a death, then raise ``PAX_ERR_PROC_FAILED`` so the rank-death
    recovery takes over; if ``max_ticks`` beats confirm nobody, return and
    the transport error propagates as it is."""

    def escalate(cause: BaseException) -> None:
        for _ in range(max_ticks):
            failed = monitor.beat()
            if failed:
                raise PaxError(
                    PAX_ERR_PROC_FAILED,
                    f"transport fault escalated: ranks {list(failed)} "
                    f"confirmed silent after {cause}") from cause

    return escalate


@dataclasses.dataclass
class RecoveryTarget:
    """What ``RecoveryPolicy.rebuild`` returns: the training closure for the
    survivor world, the restore skeleton, and the survivor ``dist`` the
    checkpointer follows.  ``step_fn=None``: this rank is not in the
    rebuilt world and leaves."""

    step_fn: Optional[Callable]
    state_like: object
    dist: Optional[object] = None


@dataclasses.dataclass
class RecoveryPolicy:
    """Elastic data-parallel recovery from ``PAX_ERR_PROC_FAILED``: ``dist``
    is the live context whose data-parallel communicator the failure
    poisoned; ``rebuild(survivors, failed)`` runs after the shrink and
    returns a :class:`RecoveryTarget` (and may update ``dist``)."""

    dist: object
    rebuild: Callable[[int, tuple], RecoveryTarget]


def _execute_recovery(policy: RecoveryPolicy, monitor=None) -> RecoveryTarget:
    """revoke → ack → get_failed → agree(resume) → shrink on the failed
    data-parallel communicator, retire the plans bound to the dead world,
    rebind the monitor, rebuild for the survivors.  The old context keeps
    no peer it can meet at its teardown (``DistContext.degraded``)."""
    dist = policy.dist
    abi, comm = dist.abi, dist.dp_comm
    abi.comm_revoke(comm)
    abi.comm_failure_ack(comm)
    failed = tuple(abi.comm_get_failed(comm))
    abi.comm_agree(1, comm)
    survivor = abi.comm_shrink(comm)
    survivors = abi.comm_size(survivor)
    log.warning("recovered comm: %d survivors after failure of ranks %s",
                survivors, list(failed))
    dist.drop_zero1_plans()
    dist.degraded = True
    if monitor is not None:
        monitor.rebind(survivor)
    return policy.rebuild(survivors, failed)


@dataclasses.dataclass
class SupervisorReport:
    steps_completed: int
    restarts: int
    stragglers: int
    final_state: object
    losses: list
    #: the first step of this run (nonzero when resuming a checkpoint)
    resumed_from: int = 0
    transport_retries: int = 0
    transport_escalations: int = 0
    #: each corrupt or torn checkpoint that forced a fallback
    checkpoint_fallbacks: list = dataclasses.field(default_factory=list)
    #: this rank left: it is not in the world an elastic recovery rebuilt
    left_world: bool = False

    def __post_init__(self) -> None:
        # one loss per completed step (the replay-truncation invariant);
        # a rank that left stops counting where it left
        assert self.left_world or not self.losses or (
            len(self.losses) == self.steps_completed - self.resumed_from
        ), (len(self.losses), self.steps_completed, self.resumed_from)


def run_supervised(
    step_fn: Callable,
    init_state,
    batches: Iterable,
    *,
    checkpointer=None,
    total_steps: int,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    backoff_s: float = 0.0,
    state_like=None,
    watchdog: Optional[StepWatchdog] = None,
    recover: Optional[RecoveryPolicy] = None,
    retry: Optional[RetryPolicy] = None,
    monitor=None,
) -> SupervisorReport:
    """Run ``total_steps`` of ``state, metrics = step_fn(state, batch)`` with
    checkpoint/restart fault tolerance, the reference's loop.

    ``batches`` is a callable ``batches(step) -> batch`` or an indexable, so
    a replayed step reads the batch it read before.  ``retry`` re-runs THE
    SAME step on a transport error (no restore, no replay); ``recover``
    arms elastic recovery from ``PAX_ERR_PROC_FAILED`` (and from a
    transport error whose retries exhausted once a death is confirmed);
    ``watchdog``'s ``"restart"`` decision saves synchronously and restarts
    (zero replay); ``monitor`` is installed at entry and beaten between
    steps.  ``checkpointer=None`` saves nothing and restarts from nothing:
    a failure then propagates once ``max_restarts`` allows no restart."""
    get_batch = batches if callable(batches) else (lambda i: batches[i])
    if watchdog is None:
        watchdog = StepWatchdog()
    if monitor is not None:
        monitor.install()
    restarts = 0
    losses: list[float] = []

    def _backoff(cause: Optional[BaseException], at_step: int, why: str) -> None:
        nonlocal restarts
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(f"exceeded {max_restarts} restarts at step {at_step}") from cause
        log.warning("step %d %s; restart %d/%d", at_step, why, restarts, max_restarts)
        if backoff_s:
            time.sleep(backoff_s * (2 ** (restarts - 1)))

    def _restore() -> tuple:
        """Latest checkpoint → (state, step), the loss record truncated to
        the restored step."""
        latest = None
        if checkpointer is not None:
            checkpointer.wait()
            latest = checkpointer.latest_step()
        if latest is None:
            if recovered or not _functional:
                raise RuntimeError("a restart needs a checkpoint to restore from, and none "
                                   "was written")
            losses.clear()
            return init_state, 0
        state, step = checkpointer.restore(state_like or init_state)
        del losses[max(0, step - resumed_from):]
        return state, step

    def _report(state, step, left=False) -> SupervisorReport:
        if checkpointer is not None and not left:
            checkpointer.wait()
        return SupervisorReport(
            step, restarts, len(watchdog.stragglers), state, losses, resumed_from,
            transport_retries=retry.retries if retry is not None else 0,
            transport_escalations=retry.escalations if retry is not None else 0,
            checkpoint_fallbacks=list(getattr(checkpointer, "integrity_events", ())),
            left_world=left)

    # a state with a parameter module is changed in place by the step
    _functional = not hasattr(getattr(init_state, "params", None), "parameters")
    recovered = False
    state = init_state
    step = 0
    resumed_from = 0
    if checkpointer is not None and checkpointer.latest_step() is not None:
        state, step = checkpointer.restore(state_like or init_state)
        resumed_from = step
        log.info("resuming from checkpoint step %d", step)

    while step < total_steps:
        try:
            t0 = time.time()
            if retry is not None:
                _s, _b = state, get_batch(step)
                state, metrics = retry.run(lambda: step_fn(_s, _b), what=f"step {step}")
            else:
                state, metrics = step_fn(state, get_batch(step))
            loss = getattr(metrics, "loss", None)
            if loss is not None:
                losses.append(float(loss))
            if monitor is not None:
                monitor.beat()
            dt = time.time() - t0
            straggler = watchdog.observe(step, dt)
            step += 1
            if checkpointer is not None and (step % checkpoint_every == 0
                                             or step == total_steps):
                checkpointer.save_async(step, state)
            if straggler and step < total_steps and \
                    watchdog.on_straggler(step - 1, dt) == "restart":
                _backoff(None, step - 1, f"straggled ({dt:.3f}s)")
                if checkpointer is not None:
                    checkpointer.save(step, state)  # sync: the restart replays nothing
                state, step = _restore()
        except KeyboardInterrupt:  # pragma: no cover
            raise
        except Exception as e:
            _backoff(e, step, f"failed ({e})")
            needs_recovery = (recover is not None and isinstance(e, PaxError)
                              and e.code == PAX_ERR_PROC_FAILED)
            if (not needs_recovery and recover is not None and isinstance(e, PaxError)
                    and e.code in TRANSPORT_ERRORS):
                needs_recovery = bool(recover.dist.abi.comm_get_failed(recover.dist.dp_comm))
            if needs_recovery:
                target = _execute_recovery(recover, monitor)
                recovered = True
                if target.step_fn is None:
                    log.warning("rank leaves the run: not in the rebuilt world")
                    return _report(state, step, left=True)
                step_fn = target.step_fn
                if target.state_like is not None:
                    state_like = target.state_like
                if target.dist is not None and checkpointer is not None:
                    checkpointer.dist = target.dist
            state, step = _restore()

    return _report(state, step)
