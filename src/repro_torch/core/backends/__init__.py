"""Collective backends — the "MPI implementations" behind the PAX ABI.

* :mod:`paxi` — native implementation of the standard ABI (MPICH-with-
  ``--enable-mpi-abi`` analogue): ABI handles are its internal handles,
  conversions are the identity, every collective is one
  ``torch.distributed`` call on the communicator's process group.

* :mod:`ring` — a second native implementation: explicit ring schedules
  of point-to-point hops, with the optional compressed wire (``ring-bf16``,
  ``ring-int8``) on the ring-wire hop kernels.

The reference's ``minimal`` and foreign ``ompix`` backends come with later
port slices (see ``src/repro_torch/README.md``).
"""
from . import paxi, ring  # noqa: F401
from .base import Backend  # noqa: F401
