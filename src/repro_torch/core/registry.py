"""Backend discovery and context initialization — the ``dlopen``/``dlsym``
analogue (paper §6.2: "the first shared library determines which
implementation will be used, and activates it via dlopen and dlsym").

Selection order: explicit ``impl=`` argument, else ``PAX_ABI_IMPL``
environment variable, else the native default ``paxi``.  ``pax_init`` is
the ``dlopen`` half; ``PaxABI.__init__`` negotiates the function table
against the resolved backend (the ``dlsym`` half).

Names in this slice: ``paxi`` only.  Any other name raises ``ValueError``
listing what exists.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

from .abi import PaxABI
from .backends.base import Backend
from .backends.paxi import PaxiBackend
from .communicator import Mesh

ENV_VAR = "PAX_ABI_IMPL"
DEFAULT_IMPL = "paxi"

_FACTORIES: dict[str, Callable[[Optional[Mesh]], Backend]] = {}


def register_backend(name: str, factory: Callable) -> None:
    _FACTORIES[name] = factory


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_FACTORIES))


register_backend("paxi", lambda mesh: PaxiBackend(mesh))


def get_backend(name: str, mesh: Optional[Mesh] = None) -> Backend:
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
) -> PaxABI:
    """``MPI_Init`` analogue: resolve the implementation, build the context.

    ``mesh`` is the process grid (``communicator.Mesh``) over an initialized
    ``torch.distributed`` world; ``None`` gives a context with only
    ``PAX_COMM_SELF``/``PAX_COMM_WORLD`` as groups of one.  ``impl`` may be
    a backend name or a prebuilt :class:`Backend` instance.
    """
    if isinstance(impl, Backend):
        return PaxABI(impl, mesh=mesh, tools=tools, req_slot_bits=req_slot_bits)
    name = impl or os.environ.get(ENV_VAR, DEFAULT_IMPL)
    backend = get_backend(name, mesh)
    return PaxABI(backend, mesh=mesh, tools=tools, req_slot_bits=req_slot_bits)
