"""Heartbeat liveness: an *observed* failure detector built from the ABI
(the port of ``repro.runtime.liveness``).

:class:`HeartbeatMonitor` runs a periodic tick exchange over the ABI's own
``sendrecv`` on a **duplicated communicator** (``comm_dup``), so heartbeat
traffic never shares the workload's plans and is never poisoned by a
workload-comm revoke.  Each :meth:`~HeartbeatMonitor.beat`:

* runs one ring ``sendrecv`` of the current tick over the heartbeat comm
  (one process per rank: the call itself, where the reference wraps it in
  an eager ``shard_map``);
* attributes non-responders through the transport's
  ``Backend.heartbeat_silent`` hook plus any test-injected silence;
* advances a miss-threshold → suspicion → confirmation state machine: a
  rank silent for ``miss_threshold`` consecutive ticks is *suspected*,
  silent for ``suspicion_ticks`` more it is *confirmed*; answering while
  suspected clears the suspicion.

:meth:`~HeartbeatMonitor.install` chains the monitor's confirmed view onto
the backend's ``local_failed`` instance attribute, the one funnel the
native fault hooks and the emulation recipes read, so a confirmed death
surfaces through ``comm_get_failed``/``comm_agree`` like a declared one.
:meth:`~HeartbeatMonitor.rebind` moves the heartbeat onto the survivor
communicator after a shrink.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.errors import PAX_ERR_PROC_FAILED, PaxError


class HeartbeatMonitor:
    """Miss-threshold failure detector over a duplicated heartbeat comm.

    A rank is confirmed after exactly ``miss_threshold + suspicion_ticks -
    1`` consecutive silent ticks.  ``mesh`` is kept for the reference's
    signature (the exchange runs on this process directly)."""

    def __init__(self, abi, comm, mesh=None, *, miss_threshold: int = 3,
                 suspicion_ticks: int = 2) -> None:
        if miss_threshold < 1:
            raise ValueError(f"miss_threshold must be >= 1, got {miss_threshold}")
        if suspicion_ticks < 1:
            raise ValueError(f"suspicion_ticks must be >= 1, got {suspicion_ticks}")
        self.abi = abi
        self.comm = comm
        self.mesh = mesh
        self.miss_threshold = miss_threshold
        self.suspicion_ticks = suspicion_ticks
        self.tick = 0
        self.last_seen: dict[int, int] = {}
        self.suspected: dict[int, int] = {}   # rank -> tick suspicion began
        self.confirmed: set[int] = set()
        self._injected: set[int] = set()
        self._installed: Optional[tuple] = None
        self.hb_comm = abi.comm_dup(comm)
        self._build_exchange()

    # -- membership ---------------------------------------------------------
    def members(self) -> list[int]:
        info = self.abi.comms.info(self.comm, allow_revoked=True)
        return [r for r in range(info.full_size) if r not in info.excludes]

    def _build_exchange(self) -> None:
        abi, hb = self.abi, self.hb_comm
        members = self.members()
        # a ring over the members in the comm's rank space: one silent rank
        # starves exactly its neighbour's receive
        perm = [(members[i], members[(i + 1) % len(members)]) for i in range(len(members))]
        mesh = abi.mesh
        device = mesh.device if mesh is not None else torch.device("cpu")

        def exchange(tick: int):
            return abi.sendrecv(torch.full((1,), tick, dtype=torch.int32, device=device),
                                perm, hb)

        self._exchange = exchange

    # -- test hooks ---------------------------------------------------------
    def inject_silence(self, rank: int) -> None:
        """Make ``rank`` stop answering (a test hook; the ``faulty:``
        wrapper injects the same way through ``heartbeat_silent``)."""
        self._injected.add(rank)

    def clear_silence(self, rank: int) -> None:
        self._injected.discard(rank)

    def _silent_now(self) -> set[int]:
        silent = set(self._injected)
        fn = getattr(self.abi.backend, "heartbeat_silent", None)
        if fn is not None:
            silent.update(fn(self.hb_comm))
        return silent

    # -- the beat -----------------------------------------------------------
    def beat(self) -> tuple:
        """One heartbeat round; returns the currently-confirmed failures.
        The exchange's ``PAX_ERR_PROC_FAILED`` is an observation, absorbed
        here; every other error propagates."""
        self.tick += 1
        exchanged = True
        try:
            self._exchange(self.tick)
        except PaxError as e:
            if e.code != PAX_ERR_PROC_FAILED:
                raise
            exchanged = False
        silent = self._silent_now()
        members = self.members()
        if exchanged or silent:
            responders = {r for r in members if r not in silent}
        else:
            # the exchange died with no attribution: trust nobody this tick
            responders = set()
        for r in members:
            if r in responders:
                self.last_seen[r] = self.tick
                self.suspected.pop(r, None)
                continue
            if r in self.confirmed:
                continue
            misses = self.tick - self.last_seen.get(r, 0)
            if r not in self.suspected and misses >= self.miss_threshold:
                self.suspected[r] = self.tick
            began = self.suspected.get(r)
            if began is not None and self.tick - began + 1 >= self.suspicion_ticks:
                self.suspected.pop(r)
                self.confirmed.add(r)
        return self.failed(self.comm)

    # -- the detector view --------------------------------------------------
    def failed(self, comm) -> tuple:
        """Confirmed failures that are members of ``comm`` (the shape of
        ``Backend.local_failed``)."""
        try:
            info = self.abi.comms.info(comm, allow_revoked=True)
        except PaxError:
            return ()
        if not info.axes:
            return ()
        return tuple(r for r in sorted(self.confirmed)
                     if r not in info.excludes and r < info.full_size)

    def install(self) -> "HeartbeatMonitor":
        """Chain the monitor onto the backend's ``local_failed`` funnel (an
        instance attribute, read by the native hooks, the recipes and the
        Mukautuva adapter alike)."""
        if self._installed is not None:
            return self
        backend = self.abi.backend
        inner = backend.local_failed
        monitor = self

        def local_failed(comm):
            seen = tuple(inner(comm))
            return seen + tuple(r for r in monitor.failed(comm) if r not in seen)

        backend.local_failed = local_failed
        self._installed = (backend, inner)
        return self

    def uninstall(self) -> None:
        if self._installed is None:
            return
        backend, inner = self._installed
        backend.local_failed = inner
        self._installed = None

    # -- recovery -----------------------------------------------------------
    def rebind(self, survivor_comm) -> None:
        """Move the heartbeat onto the post-shrink survivor communicator;
        confirmed corpses stay confirmed (non-members there), suspicion and
        miss counters reset."""
        self.comm = survivor_comm
        self.hb_comm = self.abi.comm_dup(survivor_comm)
        self._build_exchange()
        self.suspected.clear()
        for r in self.members():
            self.last_seen[r] = self.tick
