"""Collective backends — the "MPI implementations" behind the PAX ABI.

* :mod:`paxi` — native implementation of the standard ABI (MPICH-with-
  ``--enable-mpi-abi`` analogue): ABI handles are its internal handles,
  conversions are the identity, every collective is one
  ``torch.distributed`` call on the communicator's process group.

The reference's ``ring``, ``minimal`` and foreign ``ompix`` backends come
with later port slices (see ``src/repro_torch/README.md``).
"""
from . import paxi  # noqa: F401
from .base import Backend  # noqa: F401
