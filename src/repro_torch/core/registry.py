"""Backend discovery and context initialization — the ``dlopen``/``dlsym``
analogue (paper §6.2: "the first shared library determines which
implementation will be used, and activates it via dlopen and dlsym").

Selection order: explicit ``impl=`` argument, else ``PAX_ABI_IMPL``
environment variable, else the native default ``paxi``.  ``pax_init`` is
the ``dlopen`` half; ``PaxABI.__init__`` negotiates the function table
against the resolved backend (the ``dlsym`` half).

Names (the reference's set):

* ``paxi``       — native ABI implementation (zero-overhead path, §6.3);
* ``ring``       — second native implementation, explicit ring schedules;
* ``ring-int8`` / ``ring-bf16`` — ring with wire compression;
* ``ompix``      — foreign implementation, wrapped in the Mukautuva
  translation layer (§6.2);
* ``muk:paxi``   — the translation layer around a library named ``paxi``
  that speaks the foreign protocol: the full conversion path with the
  native library's results (the "+ Mukautuva" rows of Table 1);
* ``minimal``    — deliberately-partial native implementation (handle
  queries + sendrecv/reduce_scatter/allgather); every other entry point is
  synthesized by tiered negotiation from the spec's emulation recipes.

Any other name raises ``ValueError`` listing what exists.

``faulty:<inner>`` wraps any of them in the fault-injection layer
(:mod:`repro_torch.core.backends.faulty`, armed from ``PAX_FAULT_SCHEDULE``):
any inner backend in a ``FaultyBackend``, except ``ompix``, whose library
is wrapped as a ``FaultyLib`` under Mukautuva, so the failure crosses the
translation layer as a foreign rc.  The prefix is never among
:func:`available_backends`: a sweep over them meets no injected faults.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

from .abi import PaxABI
from .backends.base import Backend
from .backends.minimal import MinimalBackend
from .backends.ompix import OmpixLib
from .backends.paxi import PaxiBackend
from .backends.ring import RingBackend
from .communicator import Mesh
from .mukautuva import MukBackend

ENV_VAR = "PAX_ABI_IMPL"
DEFAULT_IMPL = "paxi"

_FACTORIES: dict[str, Callable[[Optional[Mesh]], Backend]] = {}


def register_backend(name: str, factory: Callable) -> None:
    _FACTORIES[name] = factory


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_FACTORIES))


class _PaxiAsForeign(OmpixLib):
    """The foreign protocol under the name ``paxi``: Mukautuva over a
    native library, so the full conversion path runs (``muk:paxi``)."""

    name = "paxi"


register_backend("paxi", lambda mesh: PaxiBackend(mesh))
register_backend("ring", lambda mesh: RingBackend(mesh))
register_backend("ring-int8", lambda mesh: RingBackend(mesh, compress="int8"))
register_backend("ring-bf16", lambda mesh: RingBackend(mesh, compress="bf16"))
register_backend("ompix", lambda mesh: MukBackend(OmpixLib(mesh), mesh))
register_backend("muk:paxi", lambda mesh: MukBackend(_PaxiAsForeign(mesh), mesh))
register_backend("minimal", lambda mesh: MinimalBackend(mesh))


def get_backend(name: str, mesh: Optional[Mesh] = None) -> Backend:
    if name.startswith("faulty:"):
        from .backends.faulty import FaultyBackend, FaultyLib

        inner = name[len("faulty:"):]
        if inner == "ompix":
            return MukBackend(FaultyLib(OmpixLib(mesh)), mesh)
        return FaultyBackend(get_backend(inner, mesh))
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise ValueError(
            f"unknown PAX ABI implementation {name!r}; available: {available_backends()}"
        ) from None
    return factory(mesh)


def pax_init(
    mesh: Optional[Mesh] = None,
    impl=None,
    tools: Sequence = (),
    req_slot_bits: Optional[int] = None,
    integrity: Optional[bool] = None,
) -> PaxABI:
    """``MPI_Init`` analogue: resolve the implementation, build the context.

    ``mesh`` is the process grid (``communicator.Mesh``) over an initialized
    ``torch.distributed`` world; ``None`` gives a context with only
    ``PAX_COMM_SELF``/``PAX_COMM_WORLD`` as groups of one.  ``impl`` may be
    a backend name or a prebuilt :class:`Backend` instance.  ``integrity``
    opts into the checksummed wire (default: ``PAX_WIRE_INTEGRITY``).
    """
    if not isinstance(impl, Backend):
        impl = get_backend(impl or os.environ.get(ENV_VAR, DEFAULT_IMPL), mesh)
    return PaxABI(impl, mesh=mesh, tools=tools, req_slot_bits=req_slot_bits,
                  integrity=integrity)
