"""Fault injection below the ABI: a backend wrapper that kills a rank.

The port of ``repro.core.backends.faulty``.  A :class:`FaultyBackend` wraps
any abi-convention backend (``paxi``, ``minimal``, ``ring*``) and a
:class:`FaultyLib` wraps a foreign ompix-convention library; both count
collective calls and, at a configured call count, inject the scheduled
fault.  From a death on, every collective on a communicator that still
*contains* the dead rank raises ``PAX_ERR_PROC_FAILED`` — until the caller
walks the ULFM sequence (revoke → ack → agree → shrink) and continues on a
survivor communicator, which excludes the corpse and is therefore absolved.

The wrapper sits **below the ABI**: negotiation resolves the function table
against it, so injected failures surface through the dispatch path real
failures take — native entries trip in the wrapped method, emulated recipes
trip in their ground primitives, Mukautuva translates the foreign
``OMPIX_ERR_PROC_FAILED`` rc through its ``ErrorTranslator``.

Deliberately NOT registered in the backend registry's factory table: a
sweep over :func:`~repro_torch.core.registry.available_backends` never meets
a booby-trapped backend.  Selection is by the explicit ``faulty:<inner>``
prefix or by constructing the wrapper; the schedule comes from
``PAX_FAULT_SCHEDULE`` (``rank=R,at=N[,mode=die|corrupt|drop|delay][,delay=S]``)
or from :meth:`FaultSchedule.arm`.

Transport modes, the wire misbehaving short of a death:

* ``corrupt`` — XOR of the top bit of every element of the scheduled
  collective's result, applied **once** and only in the process whose
  communicator rank is the scheduled rank, so the ranks really disagree and
  the ABI's integrity mode can see it;
* ``drop`` — from the scheduled call on, collectives on communicators that
  contain the rank never complete: the wrapper returns an
  :class:`~repro_torch.core.errors.IncompleteValue` sentinel instead of
  issuing the collective, and only the ``wait`` family's ``timeout_s`` ever
  observes it.  ``barrier`` and ``sendrecv`` cannot carry the sentinel and
  raise ``PAX_ERR_PROC_FAILED`` instead, which the heartbeat exchange
  absorbs as a missed beat.  ``local_failed`` stays silent for drops;
* ``delay`` — ``delay_s`` of host sleep on every scheduled call from the
  armed one on (a straggler, for ``StepWatchdog``).

**One schedule per process.**  The reference counts calls once for the
whole mesh under one controller; here every rank is a process that parses
the same schedule and, SPMD, makes the same calls in the same order, so
every rank's counter reaches the same value on the same call and every rank
takes the same decision: all raise on a death (the "dead" rank too, as every
shard does in the reference), none issues a dropped collective, all issue a
corrupted one and only the scheduled rank flips its result.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

import torch

from .. import abi_spec
from ..communicator import comm_rank
from ..errors import PAX_ERR_PROC_FAILED, IncompleteValue, PaxError
from . import _dist
from . import ompix as ox
from .base import Backend

ENV_VAR = "PAX_FAULT_SCHEDULE"

#: fault modes the schedule grammar accepts (``die`` is the rank death)
_MODES = ("die", "corrupt", "drop", "delay")

#: entries whose results cannot carry the drop sentinel (no payload, or a
#: status convention); a drop there degrades to PROC_FAILED
_UNDROPPABLE = ("barrier", "sendrecv")

_BIT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _flip_sign_bit(x: torch.Tensor) -> torch.Tensor:
    """The deterministic corruption: XOR the top bit of every element's
    representation through an integer view (the sign for floats and
    signed ints); dtype and shape unchanged, a fresh tensor."""
    if x.dtype == torch.bool:
        return torch.logical_not(x)
    view = _BIT_VIEW[x.element_size()]
    bits = x.contiguous().view(view)
    top = 0x80 if view is torch.uint8 else torch.iinfo(view).min
    return (bits ^ top).view(x.dtype)


def _corrupt_member(value, my_rank: int, kill_rank: int):
    """Flip ``value`` (a tensor or a member list of tensors) when this
    process is communicator rank ``kill_rank``; other ranks keep theirs."""
    if my_rank != kill_rank:
        return value
    if isinstance(value, torch.Tensor):
        return _flip_sign_bit(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_corrupt_member(v, my_rank, kill_rank) for v in value)
    return value


@dataclasses.dataclass
class FaultSchedule:
    """When which rank misbehaves *how*, plus the call counter deciding it.

    ``kill_rank`` is a linearized rank; ``at_call`` the collective call
    count after which the fault arms (-1 disarms).  ``die`` is sticky (the
    rank is dead from then on), ``corrupt`` fires once (a retry of the same
    collective is then bitwise an unfailed run's), ``drop`` is sticky (a
    downed link), ``delay`` repeats.
    """

    kill_rank: int = -1
    at_call: int = -1
    calls: int = 0
    dead: bool = False
    mode: str = "die"
    delay_s: float = 0.05
    dropping: bool = False   # drop armed and past at_call (sticky)
    corrupted: bool = False  # the one-shot corruption has been spent

    @classmethod
    def from_env(cls, text: Optional[str] = None) -> "FaultSchedule":
        """Parse ``"rank=R,at=N[,mode=M][,delay=S]"``; empty → disarmed."""
        if text is None:
            text = os.environ.get(ENV_VAR, "")
        sched = cls()
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key == "rank":
                sched.kill_rank = int(val)
            elif key == "at":
                sched.at_call = int(val)
            elif key == "mode":
                val = val.strip()
                if val not in _MODES:
                    raise ValueError(f"bad {ENV_VAR} mode {val!r} (one of {_MODES})")
                sched.mode = val
            elif key == "delay":
                sched.delay_s = float(val)
            else:
                raise ValueError(f"bad {ENV_VAR} field {part!r} "
                                 "(expected rank=R,at=N[,mode=M][,delay=S])")
        return sched

    @property
    def armed(self) -> bool:
        return self.kill_rank >= 0 and (self.at_call >= 0 or self.dead)

    def arm(self, kill_rank: int, after: int = 0, mode: Optional[str] = None) -> None:
        """Fault ``kill_rank`` after ``after`` more collective calls."""
        self.kill_rank = kill_rank
        self.at_call = self.calls + after
        if mode is not None:
            if mode not in _MODES:
                raise ValueError(f"bad fault mode {mode!r} (one of {_MODES})")
            self.mode = mode

    def fault_now(self) -> Optional[str]:
        """Count one collective call; the fault to inject on THIS call
        (``None`` when the wire is clean)."""
        self.calls += 1
        if self.dead:
            return "die"
        if self.kill_rank < 0 or self.at_call < 0 or self.calls <= self.at_call:
            return None
        if self.mode == "die":
            self.dead = True
            return "die"
        if self.mode == "corrupt":
            return None if self.corrupted else "corrupt"
        if self.mode == "drop":
            self.dropping = True
            return "drop"
        return "delay"

    def on_call(self) -> bool:
        """Count one call; whether the rank is now dead."""
        return self.fault_now() == "die"


def _comm_arg(entry: abi_spec.AbiEntry):
    for i, a in enumerate(entry.args):
        if a.kind == abi_spec.COMM:
            return i, a.name
    return None, None


class FaultyBackend(Backend):
    """Registry-composable fault-injection wrapper for abi-convention
    backends.  Shares the inner backend's tables; REQUIRED queries delegate
    untouched, OPTIONAL collectives are wrapped with the tripwire, FAULT
    entries are rebound onto this wrapper so the inner backend's native
    ULFM hooks read this wrapper's ``local_failed``."""

    convention = "abi"
    #: drops are injectable: the ABI compiles the sentinel guard into its
    #: plan and group waits (``PaxABI._can_drop``)
    can_lose_messages = True

    def __init__(self, inner: Backend, schedule: Optional[FaultSchedule] = None,
                 *, declare_failures: bool = True) -> None:
        super().__init__(inner.mesh)
        self.inner = inner
        self.schedule = schedule if schedule is not None else FaultSchedule.from_env()
        # False: a *silent* killer — collectives trip and heartbeats go
        # quiet, but local_failed never names the corpse; only an installed
        # HeartbeatMonitor can
        self.declare_failures = declare_failures
        self.name = f"faulty:{inner.name}"
        self.comms = inner.comms
        self.ops = inner.ops
        self.datatypes = inner.datatypes
        for entry in abi_spec.ABI_TABLE:
            if not inner.supports(entry):
                continue  # emulated above: recipes trip in their ground entries
            method = entry.backend_method
            if entry.tier == abi_spec.FAULT:
                setattr(self, method, getattr(type(inner), method).__get__(self))
            elif entry.tier == abi_spec.REQUIRED:
                setattr(self, method, getattr(inner, method))
            else:
                setattr(self, method, self._tripwire(entry, getattr(inner, method)))

    # -- capability negotiation: exactly as capable as the inner backend ---
    def supports(self, entry: abi_spec.AbiEntry) -> bool:
        return self.inner.supports(entry)

    def capability(self, entry: abi_spec.AbiEntry) -> dict:
        info = self.inner.capability(entry)
        info["fault_injection"] = True
        return info

    def supports_persistent(self, entry: abi_spec.AbiEntry) -> bool:
        # no plan hooks: plans freeze arguments around the wrapped methods,
        # so a plan start hits the tripwire exactly like a plain call
        return False

    def supports_persistent_group(self, entry: abi_spec.AbiEntry) -> bool:
        return False

    # -- handle domain ------------------------------------------------------
    def comm_group(self, comm: Any):
        return self.inner.comm_group(comm)

    def op_fn(self, op: Any) -> Callable:
        return self.inner.op_fn(op)

    def op_is_native(self, op: Any) -> bool:
        return self.inner.op_is_native(op)

    def wire_pad_multiple(self) -> int:
        return self.inner.wire_pad_multiple()

    def release(self) -> None:
        self.inner.release()

    # -- the failure detector ----------------------------------------------
    def local_failed(self, comm: Any) -> tuple:
        # a drop is not a declared death: it surfaces only as timeouts
        # plus heartbeat silence
        if not self.declare_failures or not self.schedule.dead:
            return ()
        return self._faulty_member(comm)

    def heartbeat_silent(self, comm: Any) -> tuple:
        """A dead rank stops answering heartbeats, and so does a dropping
        one, whether or not the death is declared."""
        if not (self.schedule.dead or self.schedule.dropping):
            return ()
        return self._faulty_member(comm)

    def _faulty_member(self, comm: Any) -> tuple:
        try:
            info = self.comms.info(comm, allow_revoked=True)
        except PaxError:
            return ()
        k = self.schedule.kill_rank
        if not info.axes or k in info.excludes or k >= info.full_size:
            return ()
        return (k,)

    # -- the tripwire -------------------------------------------------------
    def _tripwire(self, entry: abi_spec.AbiEntry, inner_fn: Callable) -> Callable:
        schedule = self.schedule
        comms = self.comms
        idx, cname = _comm_arg(entry)
        undroppable = entry.name in _UNDROPPABLE

        def wrapped(*args, **kwargs):
            for a in args:
                if a.__class__ is IncompleteValue:
                    return a  # an upstream drop: this leg never hits the wire
            fault = schedule.fault_now()
            if fault is not None:
                comm = (args[idx] if idx is not None and idx < len(args)
                        else kwargs.get(cname))
                # a revoked comm raises PAX_ERR_REVOKED in the inner backend:
                # REVOKED outranks PROC_FAILED (ULFM)
                if comm is not None and not comms.is_revoked(comm):
                    info = comms.info(comm)
                    k = schedule.kill_rank
                    if info.axes and k not in info.excludes and k < info.full_size:
                        where = info.name or "comm"
                        if fault == "die":
                            raise PaxError(
                                PAX_ERR_PROC_FAILED,
                                f"rank {k} died (injected, call {schedule.calls}) on {where}")
                        if fault == "delay":
                            time.sleep(schedule.delay_s)
                        elif fault == "drop":
                            if undroppable:
                                raise PaxError(
                                    PAX_ERR_PROC_FAILED,
                                    f"message from rank {k} lost (injected drop, call "
                                    f"{schedule.calls}) on {where}")
                            return IncompleteValue(
                                f"{entry.name} dropped at rank {k} (injected, call "
                                f"{schedule.calls}) on {where}")
                        elif fault == "corrupt":
                            out = _dist.complete(inner_fn(*args, **kwargs))
                            schedule.corrupted = True
                            return _corrupt_member(out, comm_rank(info), k)
            return inner_fn(*args, **kwargs)

        wrapped.__name__ = entry.backend_method
        wrapped.__qualname__ = f"faulty.{entry.backend_method}"
        return wrapped


class FaultyLib:
    """Fault injection for the foreign convention: wraps an ompix-style
    library, returning ``OMPIX_ERR_PROC_FAILED`` rcs from collectives once
    the scheduled rank is dead, so the failure crosses Mukautuva through
    its generated wrappers and ``ErrorTranslator``.  The fault symbols stay
    absent (the ABI's recipes supply revoke/agree/shrink).  Communicators
    registered after the death or during a drop are survivor communicators
    and are absolved from injection."""

    _COLLECTIVES = (
        "Allreduce", "Bcast", "Reduce_scatter", "Allgather", "Alltoall",
        "Alltoallv", "Alltoallw", "Scan", "Exscan", "Sendrecv", "Barrier",
        "Scatter",
    )

    can_lose_messages = True

    #: per-symbol failure return, matching each symbol's rc convention
    _FAIL_RC = {
        "Barrier": ox.OMPIX_ERR_PROC_FAILED,
        "Sendrecv": (ox.OMPIX_ERR_PROC_FAILED, None, None),
    }

    def __init__(self, lib, schedule: Optional[FaultSchedule] = None,
                 *, declare_failures: bool = True) -> None:
        self._lib = lib
        self.schedule = schedule if schedule is not None else FaultSchedule.from_env()
        self.declare_failures = declare_failures
        self._absolved: set = set()  # comms registered post-mortem (identity)
        for sym in self._COLLECTIVES:
            if hasattr(lib, sym):
                setattr(self, sym, self._wrap(sym))

    def __getattr__(self, attr):
        return getattr(self._lib, attr)

    def Comm_from_axes(self, axes):
        code, comm = self._lib.Comm_from_axes(axes)
        if code == 0 and (self.schedule.dead or self.schedule.dropping):
            self._absolved.add(comm)
        return code, comm

    def local_failed(self, comm) -> tuple:
        """The failure detector surfaced to Mukautuva (membership filtering
        happens in the shared ``comm_failure_view``); drops stay silent."""
        if not self.declare_failures:
            return ()
        return (self.schedule.kill_rank,) if self.schedule.dead else ()

    def heartbeat_silent(self, comm) -> tuple:
        sched = self.schedule
        return (sched.kill_rank,) if (sched.dead or sched.dropping) else ()

    def _wrap(self, sym: str) -> Callable:
        inner = getattr(self._lib, sym)
        schedule = self.schedule
        absolved = self._absolved
        fail_rc = self._FAIL_RC.get(sym, (ox.OMPIX_ERR_PROC_FAILED, None))
        # a dropped payload crosses Mukautuva as a success rc whose value is
        # the sentinel; rc-only and status conventions degrade to PROC_FAILED
        undroppable = sym in ("Barrier", "Sendrecv")

        def wrapped(*args, **kwargs):
            for a in args:
                if a.__class__ is IncompleteValue:
                    return (0, a)  # an upstream drop propagating through a chain
            fault = schedule.fault_now()
            if fault is not None:
                comm = next((a for a in args if isinstance(a, ox.OmpixComm)), None)
                if comm is not None and comm not in absolved and comm.axes:
                    if fault == "die":
                        return fail_rc
                    if fault == "delay":
                        time.sleep(schedule.delay_s)
                    elif fault == "drop":
                        if undroppable:
                            return fail_rc
                        return (0, IncompleteValue(
                            f"{sym} dropped at rank {schedule.kill_rank} "
                            f"(injected, call {schedule.calls})"))
                    elif fault == "corrupt":
                        ret = inner(*args, **kwargs)
                        if not isinstance(ret, tuple) or ret[0] != 0:
                            return ret
                        schedule.corrupted = True
                        value = _corrupt_member(ret[1], _dist.rank(comm.group),
                                                schedule.kill_rank)
                        return (ret[0], value) + ret[2:]
            return inner(*args, **kwargs)

        wrapped.__name__ = sym
        wrapped.__qualname__ = f"FaultyLib.{sym}"
        return wrapped


def fault_schedule_of(backend) -> Optional[FaultSchedule]:
    """The schedule driving ``backend``, however it is wrapped: a
    :class:`FaultyBackend` directly, or a Mukautuva adapter over a
    :class:`FaultyLib`; ``None`` when no injection layer is present."""
    sched = getattr(backend, "schedule", None)
    if isinstance(sched, FaultSchedule):
        return sched
    lib = getattr(backend, "lib", None)
    sched = getattr(lib, "schedule", None)
    return sched if isinstance(sched, FaultSchedule) else None
