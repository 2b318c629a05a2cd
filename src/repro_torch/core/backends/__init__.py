"""Collective backends — the "MPI implementations" behind the PAX ABI.

* :mod:`paxi` — native implementation of the standard ABI (MPICH-with-
  ``--enable-mpi-abi`` analogue): ABI handles are its internal handles,
  conversions are the identity, every collective is one
  ``torch.distributed`` call on the communicator's process group.

* :mod:`ring` — a second native implementation: explicit ring schedules
  of point-to-point hops, with the optional compressed wire (``ring-bf16``,
  ``ring-int8``) on the ring-wire hop kernels.

* :mod:`minimal` — a deliberately-partial native implementation (handle
  queries + sendrecv/reduce_scatter/allgather); negotiation emulates the
  rest from the spec's recipes.

* :mod:`ompix` — a *foreign-convention* library (the Open MPI analogue):
  object handles, its own error codes and status layout, ``(code,
  result)`` returns.  The ABI never calls it directly; the Mukautuva layer
  (:mod:`repro_torch.core.mukautuva`) adapts it.
"""
from . import minimal, ompix, paxi, ring  # noqa: F401
from .base import Backend  # noqa: F401
