"""The implementation-side (IMPL) interface every backend provides.

This is what the paper calls "the implementation": the paxi backend speaks
the ABI handle convention natively; foreign backends speak their own
convention and are adapted by the Mukautuva layer (:mod:`repro_torch.core.mukautuva`).

The methods take *backend-domain* handles.  For paxi those ARE the ABI ints;
for ompix they are its own objects.  The ABI layer never calls a foreign
backend directly.

The per-entry-point surface is **generated from the declarative function
table** (:mod:`repro_torch.core.abi_spec`): every entry gets an
unsupported-operation placeholder here, and backends override the entries
they implement.  :meth:`Backend.supports` reports exactly which entries are
overridden — the capability answer ``PaxABI.__init__`` negotiates against
(the ``dlsym`` analogue).  Negotiation is *tiered*: a backend missing a
REQUIRED entry fails at init with ``PAX_ERR_UNSUPPORTED_OPERATION``, while
missing OPTIONAL entries are emulated from their spec recipes (or deferred
to a call-time error when no recipe chain grounds out) — partial backends
are first-class.  A deliberately-partial backend declares its surface with
``ABI_SUBSET`` (only these entries count as native) or ``ABI_DROPPED``
(everything overridden except these), and :meth:`Backend.capability` is the
per-entry report the ABI layer folds into ``PaxABI.capabilities()``.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, Optional

from ..abi_spec import ABI_TABLE, AbiEntry
from ..errors import PAX_ERR_UNSUPPORTED_OPERATION, PaxError

_ENTRY_NAMES = frozenset(e.name for e in ABI_TABLE)


class Backend(abc.ABC):
    """Abstract collective backend."""

    #: "abi" if the backend's handle convention IS the standard ABI
    #: (no translation layer needed), "foreign" otherwise.
    convention: str = "abi"
    name: str = "base"

    def __init__(self, mesh=None) -> None:
        self.mesh = mesh
        # A typo in a declared partial surface must fail loudly here, not
        # degrade into call-time unsupported errors far from the mistake.
        for attr in ("ABI_SUBSET", "ABI_DROPPED"):
            names = getattr(self, attr) or frozenset()
            unknown = set(names) - _ENTRY_NAMES
            if unknown:
                raise ValueError(
                    f"{type(self).__name__}.{attr} names unknown function-"
                    f"table entries {sorted(unknown)}"
                )

    # -- handle domain ----------------------------------------------------
    @abc.abstractmethod
    def comm_group(self, comm: Any):
        """The process group of a backend-domain communicator (None for a
        group of one)."""

    @abc.abstractmethod
    def op_fn(self, op: Any) -> Callable:
        """Binary reduction fn of a backend-domain op handle."""

    def op_is_native(self, op: Any) -> bool:
        return False

    # -- capability negotiation (the dlsym answer) -------------------------

    #: restrict the native surface to exactly these entry names (a
    #: deliberately-partial backend); None means "whatever is overridden"
    ABI_SUBSET: Optional[frozenset] = None
    #: entry names a subclass disclaims even though an implementation is
    #: inherited (e.g. ring dropping its hand-written derived allreduce so
    #: the spec recipe composes its native reduce-scatter/all-gather)
    ABI_DROPPED: frozenset = frozenset()

    def supports(self, entry: AbiEntry) -> bool:
        """Whether this backend natively implements a function-table entry.

        Tier-aware surface declaration: ``ABI_SUBSET``/``ABI_DROPPED`` gate
        the answer before the override check, so a backend can be partial on
        purpose and let negotiation emulate (optional tier) or reject
        (required tier) the rest.  Default otherwise: the entry's method was
        overridden somewhere below :class:`Backend` (the generated
        placeholders carry a marker).  Foreign adapters override this to ask
        their library instead.
        """
        if self.ABI_SUBSET is not None and entry.name not in self.ABI_SUBSET:
            return False
        if entry.name in self.ABI_DROPPED:
            return False
        impl = getattr(type(self), entry.backend_method, None)
        return impl is not None and not getattr(impl, "_pax_unsupported", False)

    def capability(self, entry: AbiEntry) -> dict:
        """This backend's view of one entry, folded into the per-context
        report ``PaxABI.capabilities()``.  Adapters (Mukautuva) override to
        translate the foreign library's symbol table across the layer.
        Persistent entries additionally report ``group_hook`` — whether the
        backend declares a native plan-group fusion for the entry."""
        info = {"backend": self.name, "native": self.supports(entry)}
        if entry.persistent:
            info["group_hook"] = self.supports_persistent_group(entry)
        return info

    def release(self) -> None:
        """Drop whatever this backend caches beside the communicator table
        (process groups, schedules) at the context's teardown."""

    def wire_pad_multiple(self) -> int:
        """The padding granule emulation recipes round invented padding up
        to, so padded legs stay on this backend's fast wire (the ring's hop
        kernels need WIRE_BLOCK-divisible chunks).  1: no preference."""
        return 1

    # -- fault model (ULFM tier) -------------------------------------------
    def local_failed(self, comm: Any) -> tuple:
        """Ranks this backend knows to be dead on ``comm``.

        The failure-detector hook of the fault tier: the default backend
        never observes failures (an empty report keeps every fault entry a
        cheap no-op), while fault-injecting wrappers
        (:mod:`repro_torch.core.backends.faulty`) report the killed rank here.
        Both the native paxi fault hooks and the emulation recipes read
        failures exclusively through this method.
        """
        return ()

    def heartbeat_silent(self, comm: Any) -> tuple:
        """Ranks whose transport stopped carrying heartbeats on ``comm``:
        an observation about traffic, not a declaration of death
        (:class:`repro_torch.runtime.liveness.HeartbeatMonitor` still runs
        its miss-threshold state machine).  The default wire never goes
        quiet; fault-injecting wrappers report the scheduled corpse."""
        return ()

    # -- nonblocking starts (i<name>) --------------------------------------
    # A backend declares *native nonblocking support* for an entry by
    # defining ``i<backend_method>(self, <entry args>)`` that issues the
    # collective asynchronously and returns a ``_dist.Pending`` (the
    # ``torch.distributed`` Work plus its output buffer).  The ABI's ``wait``
    # completes it.  Entries without a hook run blocking inside ``i<name>``
    # and hand back an already-complete value.

    def supports_nonblocking(self, entry: AbiEntry) -> bool:
        """Whether this backend declares an asynchronous start for ``entry``."""
        return (self.supports(entry)
                and getattr(type(self), f"i{entry.backend_method}", None)
                is not None)

    # -- persistent plans (MPI-4 <name>_init) ------------------------------
    # A backend declares *native persistent support* for an entry by
    # defining ``plan_<backend_method>(self, <entry args>)`` returning a run
    # closure over the payload argument(s): everything derivable from the
    # non-payload arguments and the payload's shape/dtype (comm→axes, op
    # branch, schedule selection, foreign-handle conversion) must be frozen
    # in the closure.  The payload is bound abstractly (shape/dtype only) —
    # hooks must not read values.  Backends without a hook inherit the
    # generic plan compiler in the ABI layer (argument freezing around the
    # resolved entry), which already hoists all ABI-layer per-call work;
    # the hook additionally hoists the backend's own dispatch.  paxi
    # declares hooks for the traffic-bearing entries; their run closures
    # start the collective asynchronously and the plan's wait completes it.

    def supports_persistent(self, entry: AbiEntry) -> bool:
        """Whether this backend declares a native plan hook for ``entry``."""
        return (self.supports(entry)
                and getattr(type(self), f"plan_{entry.backend_method}", None)
                is not None)

    # -- plan groups (MPI Startall) ----------------------------------------
    # A backend declares *native group fusion* for an entry by defining
    # ``plan_group_<backend_method>(self, bounds)`` where ``bounds`` is a
    # list of bound-argument tuples, one per group member, guaranteed by the
    # ABI layer to share every non-payload argument (same comm, same op,
    # same axis...).  The hook returns a run closure mapping the member
    # payload list to the member output list — typically ONE stacked
    # collective over the concatenated buffers — or ``None`` to decline
    # (e.g. mixed payload shapes), in which case the group falls back to
    # per-member plan runs.  Payloads are bound abstractly; hooks must not
    # read values.

    def supports_persistent_group(self, entry: AbiEntry) -> bool:
        """Whether this backend declares a native plan-group hook for
        ``entry`` (reported as ``group_hook`` in :meth:`capability`)."""
        return (self.supports(entry)
                and getattr(type(self),
                            f"plan_group_{entry.backend_method}", None)
                is not None)


def _make_placeholder(entry: AbiEntry):
    def placeholder(self, *args, **kwargs):
        raise PaxError(
            PAX_ERR_UNSUPPORTED_OPERATION,
            f"backend {self.name!r} does not implement {entry.name!r}",
        )

    placeholder.__name__ = entry.backend_method
    placeholder.__qualname__ = f"Backend.{entry.backend_method}"
    placeholder.__doc__ = (
        f"Function-table entry {entry.name!r}: not implemented by this backend."
    )
    placeholder._pax_unsupported = True
    return placeholder


# One placeholder per function-table row — the single source of what a
# backend *may* implement.  Collective semantics live in the subclasses.
for _entry in ABI_TABLE:
    if _entry.backend_method not in Backend.__dict__:
        setattr(Backend, _entry.backend_method, _make_placeholder(_entry))
del _entry
