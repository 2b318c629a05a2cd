"""repro_torch.core — the PAX ABI on ``torch.distributed``.

The same standard function table, handle values, error codes and status
layout as ``repro.core`` (the reference), implemented for one process per
rank::

    from repro_torch.core import pax_init, PAX_SUM, PAX_COMM_WORLD, ...

    abi = pax_init(mesh, impl="paxi")          # mesh: communicator.Mesh
    dp  = abi.comm_from_axes(("data",))        # derived communicator
    y   = abi.allreduce(g, PAX_SUM, dp)        # one torch.distributed call
"""
from .abi import PaxABI, Plan, PlanGroup, Request, TensorSpec  # noqa: F401
from .communicator import CommInfo, CommTable, Mesh  # noqa: F401
from .constants import *  # noqa: F401,F403
from .datatypes import DatatypeRegistry, TypeDescriptor, N_PREDEFINED  # noqa: F401
from .errors import PAX_SUCCESS, PaxError, error_string  # noqa: F401
from .handles import *  # noqa: F401,F403
from .handles import HandleKind, describe, handle_kind, is_null, is_predefined  # noqa: F401
from .interpose import ByteCounter, CallCounter, SequenceStamper, Tool, WallClockTracer  # noqa: F401
from .ops import OpRegistry  # noqa: F401
from .registry import available_backends, get_backend, pax_init, register_backend  # noqa: F401
from .status import STATUS_BYTES, Status, status_array, traced_status  # noqa: F401
