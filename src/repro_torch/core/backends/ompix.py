"""ompix — a foreign-convention collective implementation (Open MPI analogue).

The port of ``repro.core.backends.ompix``.  Everything about it deliberately
mismatches the standard ABI, the way Open MPI's convention mismatches
MPICH's (paper §3):

* handles are **objects** (the incomplete-struct-pointer design of §3.3):
  identity-compared, not integers, not compile-time constants;
* predefined handles are module-level globals (``ompix_mpi_float``,
  ``ompix_op_sum`` — cf. ``OMPI_PREDEFINED_GLOBAL``);
* datatype size is found by dereferencing a descriptor
  (:func:`opal_datatype_type_size`), never from handle bits;
* the status convention is Open MPI's §3.2.3 layout:
  ``{MPI_SOURCE, MPI_TAG, MPI_ERROR, _cancelled, _ucount}``;
* error codes use ompix's own numbering (``OMPIX_ERR_*``, 71–80; success
  is 0 — the one value every convention shares);
* it exports **no** ``Reduce``, ``Gather`` or ULFM symbol, so those entries
  are emulated above the translation layer.

Every function follows the C-ish convention ``(code, result)`` and reports
handle and argument errors as codes.  The SPMD contract's own ``ValueError``
(non-uniform ``Alltoallv`` counts, an indivisible ``Alltoall`` split) passes
through, as in the reference, so every backend refuses the same calls the
same way.  Only :mod:`repro_torch.core.mukautuva` calls this module.

Each collective is one ``torch.distributed`` call through the shared
lowering (``_dist``) on the communicator's process group, completed before
the function returns: a foreign library hands back finished results, and
the ABI wraps them in requests.  ``torch.distributed`` creates a process
group collectively, so the library never creates one: the adapter binds
the ABI context's group lookup (:meth:`OmpixLib.bind_groups`), and a
communicator over the same axes gets the group that context already holds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import torch

from .. import handles as H
from ..ops import PREDEFINED_OP_FNS  # semantics only; handle domains differ
from . import _dist

# ---------------------------------------------------------------------------
# ompix error codes (its own numbering)
# ---------------------------------------------------------------------------
OMPIX_SUCCESS = 0
OMPIX_ERR_ARG = 71
OMPIX_ERR_COMM = 72
OMPIX_ERR_TYPE = 73
OMPIX_ERR_OP = 74
OMPIX_ERR_UNSUPPORTED = 75
OMPIX_ERR_COUNT = 76
OMPIX_ERR_RANK = 77
OMPIX_ERR_INTERN = 78
# ULFM-shaped fault codes.  ompix itself never returns them (it has no fault
# symbols, the way most MPI implementations shipped without ULFM); they exist
# so a fault-injecting wrapper library can return them through the ompix rc
# convention and Mukautuva can carry them across as PAX_ERR_PROC_FAILED /
# PAX_ERR_REVOKED.
OMPIX_ERR_PROC_FAILED = 79
OMPIX_ERR_REVOKED = 80


# ---------------------------------------------------------------------------
# ompix handle objects ("incomplete struct pointers": opaque, identity-based)
# ---------------------------------------------------------------------------
class OmpixComm:
    """A communicator: its mesh axes, the process group it runs on (None:
    a group of one) and the member ranks in communicator-rank order."""

    __slots__ = ("axes", "group", "ranks", "_name")

    def __init__(self, axes: tuple, name: str, group: Any = None,
                 ranks: tuple = ()) -> None:
        self.axes = axes
        self.group = group
        self.ranks = ranks
        self._name = name

    def __repr__(self) -> str:  # pragma: no cover
        return f"<ompix_communicator_t* {self._name}>"


@dataclasses.dataclass(eq=False)
class OmpixDatatype:
    """The descriptor an OMPI-style impl chases a pointer into (§3.3)."""

    dname: str
    size: int
    torch_dtype: Optional[torch.dtype]
    # padding fields modelling the large internal struct (never read)
    _align: int = 8
    _flags: int = 0
    _id: int = 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"<ompix_datatype_t* {self.dname}>"


class OmpixOp:
    __slots__ = ("fn", "commute", "oname", "is_native")

    def __init__(self, fn: Callable, commute: bool, oname: str, is_native: bool) -> None:
        self.fn = fn
        self.commute = commute
        self.oname = oname
        self.is_native = is_native

    def __repr__(self) -> str:  # pragma: no cover
        return f"<ompix_op_t* {self.oname}>"


# predefined globals (OMPI_PREDEFINED_GLOBAL analogue) ----------------------
ompix_comm_null = OmpixComm((), "OMPIX_COMM_NULL")
# world/self are bound per instance (mesh-dependent): OmpixLib holds them.

_OMPIX_DTYPE_GLOBALS: dict[str, OmpixDatatype] = {}


def _dt(dname: str, size: int, dtype: Optional[torch.dtype]) -> OmpixDatatype:
    d = OmpixDatatype(dname, size, dtype)
    _OMPIX_DTYPE_GLOBALS[dname] = d
    return d


ompix_datatype_null = _dt("OMPIX_DATATYPE_NULL", 0, None)
ompix_mpi_int8 = _dt("OMPIX_INT8", 1, torch.int8)
ompix_mpi_uint8 = _dt("OMPIX_UINT8", 1, torch.uint8)
ompix_mpi_int16 = _dt("OMPIX_INT16", 2, torch.int16)
ompix_mpi_uint16 = _dt("OMPIX_UINT16", 2, torch.uint16)
ompix_mpi_int32 = _dt("OMPIX_INT32", 4, torch.int32)
ompix_mpi_uint32 = _dt("OMPIX_UINT32", 4, torch.uint32)
ompix_mpi_int64 = _dt("OMPIX_INT64", 8, torch.int64)
ompix_mpi_uint64 = _dt("OMPIX_UINT64", 8, torch.uint64)
ompix_mpi_float16 = _dt("OMPIX_FLOAT16", 2, torch.float16)
ompix_mpi_float = _dt("OMPIX_FLOAT", 4, torch.float32)
ompix_mpi_double = _dt("OMPIX_DOUBLE", 8, torch.float64)
ompix_mpi_complex64 = _dt("OMPIX_COMPLEX64", 8, torch.complex64)
ompix_mpi_complex128 = _dt("OMPIX_COMPLEX128", 16, torch.complex128)
ompix_mpi_byte = _dt("OMPIX_BYTE", 1, torch.uint8)
ompix_mpi_bfloat16 = _dt("OMPIX_BFLOAT16", 2, torch.bfloat16)

_OMPIX_OP_GLOBALS: dict[str, OmpixOp] = {}


def _op(oname: str, abi_handle: int, native: bool) -> OmpixOp:
    o = OmpixOp(PREDEFINED_OP_FNS[abi_handle], True, oname, native)
    _OMPIX_OP_GLOBALS[oname] = o
    return o


ompix_op_sum = _op("OMPIX_SUM", H.PAX_SUM, True)
ompix_op_min = _op("OMPIX_MIN", H.PAX_MIN, True)
ompix_op_max = _op("OMPIX_MAX", H.PAX_MAX, True)
ompix_op_prod = _op("OMPIX_PROD", H.PAX_PROD, False)
ompix_op_band = _op("OMPIX_BAND", H.PAX_BAND, False)
ompix_op_bor = _op("OMPIX_BOR", H.PAX_BOR, False)
ompix_op_bxor = _op("OMPIX_BXOR", H.PAX_BXOR, False)
ompix_op_land = _op("OMPIX_LAND", H.PAX_LAND, False)
ompix_op_lor = _op("OMPIX_LOR", H.PAX_LOR, False)
ompix_op_lxor = _op("OMPIX_LXOR", H.PAX_LXOR, False)
ompix_op_minloc = _op("OMPIX_MINLOC", H.PAX_MINLOC, False)
ompix_op_maxloc = _op("OMPIX_MAXLOC", H.PAX_MAXLOC, False)
ompix_op_replace = _op("OMPIX_REPLACE", H.PAX_REPLACE, False)
ompix_op_no_op = _op("OMPIX_NO_OP", H.PAX_NO_OP, False)

#: the reductions the wire runs natively, by op name
_WIRE_OPS = {"OMPIX_SUM": "sum", "OMPIX_MIN": "min", "OMPIX_MAX": "max"}


def opal_datatype_type_size(dtype: OmpixDatatype) -> tuple[int, int]:
    """The §3.3 lookup: ``*size = pData->size; return 0;``"""
    return OMPIX_SUCCESS, dtype.size


class OmpixLib:
    """The foreign implementation library ("libompix.so")."""

    name = "ompix"

    def __init__(self, mesh=None) -> None:
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device("cpu")
        axes = tuple(mesh.axis_names) if mesh is not None else ()
        self.comm_world = OmpixComm(axes, "OMPIX_COMM_WORLD")
        self.comm_self = OmpixComm((), "OMPIX_COMM_SELF")
        self.comm_null = ompix_comm_null
        self.dtype_globals = dict(_OMPIX_DTYPE_GLOBALS)
        self.op_globals = dict(_OMPIX_OP_GLOBALS)
        self._groups: Optional[Callable] = None

    # -- process groups ------------------------------------------------------
    def bind_groups(self, lookup: Callable) -> None:
        """Take the running world's groups: ``lookup(axes)`` returns the
        (group, member ranks) of this rank's group over ``axes`` without
        creating one that exists.  World's group is bound here."""
        self._groups = lookup
        if self.mesh is not None:
            self.comm_world.group, self.comm_world.ranks = lookup(self.comm_world.axes)

    def release(self) -> None:
        """Drop every process-group reference (the context's teardown)."""
        self._groups = None
        self.comm_world.group = None

    # -- object constructors --------------------------------------------
    def Comm_from_axes(self, axes: Sequence[str]) -> tuple[int, Optional[OmpixComm]]:
        if self.mesh is None or self._groups is None:
            return OMPIX_ERR_COMM, None
        axes = tuple(axes)
        names = self.mesh.axis_names
        if any(a not in names for a in axes):
            return OMPIX_ERR_ARG, None
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            return OMPIX_ERR_ARG, None
        group, ranks = self._groups(axes)
        return OMPIX_SUCCESS, OmpixComm(axes, f"ompix_comm{axes}", group, ranks)

    def Op_create(self, fn: Callable, commute: bool) -> tuple[int, Optional[OmpixOp]]:
        if not callable(fn):
            return OMPIX_ERR_OP, None
        return OMPIX_SUCCESS, OmpixOp(fn, commute, "ompix_user_op", False)

    def Type_contiguous(
        self, count: int, base: OmpixDatatype
    ) -> tuple[int, Optional[OmpixDatatype]]:
        if not isinstance(base, OmpixDatatype):
            return OMPIX_ERR_TYPE, None
        return OMPIX_SUCCESS, OmpixDatatype(
            f"contig({count},{base.dname})", base.size * count, base.torch_dtype
        )

    # -- queries ----------------------------------------------------------
    def Comm_size(self, comm: OmpixComm) -> tuple[int, int]:
        if not isinstance(comm, OmpixComm) or comm is ompix_comm_null:
            return OMPIX_ERR_COMM, -1
        if self.mesh is None or not comm.axes:
            return OMPIX_SUCCESS, 1
        return OMPIX_SUCCESS, math.prod(self.mesh.shape[a] for a in comm.axes)

    def Comm_rank(self, comm: OmpixComm) -> tuple[int, Any]:
        if not isinstance(comm, OmpixComm) or comm is ompix_comm_null:
            return OMPIX_ERR_COMM, -1
        return OMPIX_SUCCESS, _dist.rank(comm.group)

    def Type_size(self, dtype: OmpixDatatype) -> tuple[int, int]:
        if not isinstance(dtype, OmpixDatatype):
            return OMPIX_ERR_TYPE, -1
        return opal_datatype_type_size(dtype)

    # -- collectives -------------------------------------------------------
    def _check(self, comm, op=None) -> int:
        if not isinstance(comm, OmpixComm) or comm is ompix_comm_null:
            return OMPIX_ERR_COMM
        if op is not None and not isinstance(op, OmpixOp):
            return OMPIX_ERR_OP
        return OMPIX_SUCCESS

    def Allreduce(self, x, op: OmpixOp, comm: OmpixComm):
        rc = self._check(comm, op)
        if rc:
            return rc, None
        wire = _WIRE_OPS.get(op.oname)
        if wire is not None:
            return OMPIX_SUCCESS, _dist.allreduce(x, wire, comm.group).result()
        return OMPIX_SUCCESS, _dist.allreduce_generic(x, op.fn, comm.group).result()

    # NB: no ``Reduce`` and no ``Gather`` — this library deliberately does
    # not export the derived collectives.  The ABI layer's tiered
    # negotiation emulates them from the entries the library *does* export,
    # which is how a partial foreign implementation is admitted behind the
    # standard function table (paper §6; Mukautuva reports the symbol as
    # absent and the recipe fills the hole above the translation layer).

    def Bcast(self, x, root: int, comm: OmpixComm):
        rc = self._check(comm)
        if rc:
            return rc, None
        return OMPIX_SUCCESS, _dist.bcast(x, root, comm.group, comm.ranks).result()

    def Reduce_scatter(self, x, op: OmpixOp, comm: OmpixComm, axis: int = 0):
        rc = self._check(comm, op)
        if rc:
            return rc, None
        if op.oname == "OMPIX_SUM":
            return OMPIX_SUCCESS, _dist.reduce_scatter_sum(x, comm.group, axis=axis).result()
        return OMPIX_SUCCESS, _dist.reduce_scatter_generic(
            x, op.fn, comm.group, axis=axis).result()

    def Allgather(self, x, comm: OmpixComm, axis: int = 0):
        rc = self._check(comm)
        if rc:
            return rc, None
        return OMPIX_SUCCESS, _dist.allgather(x, comm.group, axis=axis).result()

    def Alltoall(self, x, comm: OmpixComm, split_axis: int = 0, concat_axis: int = 0):
        rc = self._check(comm)
        if rc:
            return rc, None
        return OMPIX_SUCCESS, _dist.alltoall(x, comm.group, split_axis, concat_axis).result()

    def Alltoallw(self, blocks, sendtypes, recvtypes, comm: OmpixComm):
        """Per-peer-typed alltoall over the leading axis (one block per
        peer).  The cast to each peer's recv type is the per-element
        conversion work whose bookkeeping gives Mukautuva its worst case
        (§6.2)."""
        rc = self._check(comm)
        if rc:
            return rc, None
        if any(not isinstance(t, OmpixDatatype) for t in list(sendtypes) + list(recvtypes)):
            return OMPIX_ERR_TYPE, None
        out = _dist.alltoall(blocks, comm.group, 0, 0).result()
        parts = [
            out[i] if recvtypes[i].torch_dtype is None else out[i].to(recvtypes[i].torch_dtype)
            for i in range(out.shape[0])
        ]
        return OMPIX_SUCCESS, parts

    def Scan(self, x, op: OmpixOp, comm: OmpixComm):
        rc = self._check(comm, op)
        if rc:
            return rc, None
        return OMPIX_SUCCESS, _dist.scan_fold(x, op.fn, comm.group, True).result()

    def Exscan(self, x, op: OmpixOp, comm: OmpixComm):
        rc = self._check(comm, op)
        if rc:
            return rc, None
        return OMPIX_SUCCESS, _dist.scan_fold(x, op.fn, comm.group, False).result()

    def Alltoallv(self, x, sendcounts, recvcounts, comm: OmpixComm):
        rc = self._check(comm)
        if rc:
            return rc, None
        if len(sendcounts) != len(recvcounts):
            return OMPIX_ERR_COUNT, None
        return OMPIX_SUCCESS, _dist.alltoallv(x, sendcounts, recvcounts, comm.group).result()

    def Sendrecv(self, x, perm, comm: OmpixComm):
        rc = self._check(comm)
        if rc:
            return rc, None, None
        y = _dist.ppermute(x, perm, comm.group, comm.ranks).result()
        # ompix status convention (§3.2.3 layout)
        status = {
            "MPI_SOURCE": -1,
            "MPI_TAG": 0,
            "MPI_ERROR": OMPIX_SUCCESS,
            "_cancelled": 0,
            "_ucount": int(x.numel()) if hasattr(x, "numel") else 0,
        }
        return OMPIX_SUCCESS, y, status

    def Barrier(self, comm: OmpixComm):
        rc = self._check(comm)
        if rc:
            return rc
        _dist.barrier(comm.group, self.device).result()
        return OMPIX_SUCCESS

    def Scatter(self, x, root: int, comm: OmpixComm, axis: int = 0):
        rc = self._check(comm)
        if rc:
            return rc, None
        return OMPIX_SUCCESS, _dist.scatter_from_root(
            x, root, comm.group, comm.ranks, axis=axis).result()
