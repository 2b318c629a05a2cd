"""paxi — the native implementation of the PAX ABI.

The analogue of MPICH built with ``--enable-mpi-abi`` (paper §6.3): its
internal handles ARE the standard ABI handles, so the "conversions" are the
identity and a call through the ABI issues exactly the ``torch.distributed``
call the raw program would.

Every collective exists in three forms, the reference's plus the one its
dataflow model did not need:

* blocking (``allreduce``) — issue, complete, return the result;
* nonblocking (``iallreduce``) — issue and return the ``_dist.Pending``;
  the ABI's ``wait`` completes it;
* persistent (``plan_allreduce``/``plan_group_allreduce``) — comm→group
  lookup and the op branch taken once at plan time; the run closure issues
  the collective asynchronously and the plan's wait completes it.

Handle metadata queries use the bit-encoded fast path
(``handles.datatype_encoded_size``), the MPICH-heritage design of §3.3.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .. import handles as H
from ..communicator import CommTable, comm_rank
from ..datatypes import DatatypeRegistry
from ..emulation import agree_value, comm_failure_view
from ..ops import NATIVE_COLLECTIVE_OPS, OpRegistry
from . import _dist
from .base import Backend

_NATIVE_NAMES = {H.PAX_SUM: "sum", H.PAX_MIN: "min", H.PAX_MAX: "max"}


def uniform_payload(bounds, min_ndim: int = 0):
    """The stackability test shared by the plan-group hooks: every member's
    bound payload must be a single tensor signature of the same shape and
    dtype with at least ``min_ndim`` dims.  Returns (shape, dtype) or
    ``None`` (the hook declines; the group runs per-member plans)."""
    x0 = bounds[0][0]
    if not (hasattr(x0, "shape") and hasattr(x0, "dtype")):
        return None
    shape, dtype = tuple(x0.shape), x0.dtype
    if len(shape) < min_ndim:
        return None
    for b in bounds[1:]:
        x = b[0]
        if (not hasattr(x, "shape") or tuple(x.shape) != shape
                or getattr(x, "dtype", None) != dtype):
            return None
    return shape, dtype


def _stack(xs):
    # one member: a view, no copy (the unbucketed zero1 leg)
    return xs[0].unsqueeze(0) if len(xs) == 1 else torch.stack(xs)


def _unstack(p: _dist.Pending, n: int) -> _dist.Pending:
    """Split a stacked collective's result into the member list."""
    inner = p.post

    def post(v):
        v = inner(v) if inner is not None else v
        return [v[i] for i in range(n)]

    return _dist.Pending(p.work, p.value, post, p.keep)


class PaxiBackend(Backend):
    convention = "abi"
    name = "paxi"

    def __init__(
        self,
        mesh=None,
        *,
        comms: Optional[CommTable] = None,
        ops: Optional[OpRegistry] = None,
        datatypes: Optional[DatatypeRegistry] = None,
    ) -> None:
        super().__init__(mesh)
        # Native backend shares the ABI-context tables (it IS the ABI).
        self.comms = comms if comms is not None else CommTable(mesh)
        self.ops = ops if ops is not None else OpRegistry()
        self.datatypes = datatypes if datatypes is not None else DatatypeRegistry()
        self.device = mesh.device if mesh is not None else torch.device("cpu")

    # -- handle domain ------------------------------------------------------
    def _info(self, comm: int):
        # hot path: the registration-time flat map; miss -> the checked
        # metadata query, which raises the proper PAX_ERR_COMM/REVOKED
        info = self.comms.info_by_handle.get(comm)
        return info if info is not None else self.comms.info(comm)

    def comm_group(self, comm: int):
        return self._info(comm).group

    def op_fn(self, op: int) -> Callable:
        return self.ops.fn(op)

    def op_is_native(self, op: int) -> bool:
        return op in NATIVE_COLLECTIVE_OPS

    # -- queries --------------------------------------------------------
    def size(self, comm: int) -> int:
        return self.comms.info(comm).size

    def rank(self, comm: int) -> int:
        return comm_rank(self._info(comm))

    def type_size(self, datatype: int) -> int:
        return self.datatypes.type_size_encoded(datatype)

    # -- nonblocking starts (the primitives; blocking forms complete them) --
    def iallreduce(self, x, op: int, comm: int):
        group = self._info(comm).group
        name = _NATIVE_NAMES.get(op)
        if name is not None:
            return _dist.allreduce(x, name, group)
        return _dist.allreduce_generic(x, self.op_fn(op), group)

    def ireduce(self, x, op: int, root: int, comm: int):
        # SPMD: result computed everywhere; defined at root per MPI contract.
        return self.iallreduce(x, op, comm)

    def ibcast(self, x, root: int, comm: int):
        info = self._info(comm)
        return _dist.bcast(x, root, info.group, info.ranks)

    def ireduce_scatter(self, x, op: int, comm: int, axis: int = 0):
        group = self._info(comm).group
        if op == H.PAX_SUM:
            return _dist.reduce_scatter_sum(x, group, axis=axis)
        return _dist.reduce_scatter_generic(x, self.op_fn(op), group, axis=axis)

    def iallgather(self, x, comm: int, axis: int = 0):
        return _dist.allgather(x, self._info(comm).group, axis=axis)

    def ialltoall(self, x, comm: int, split_axis: int = 0, concat_axis: int = 0):
        return _dist.alltoall(x, self._info(comm).group, split_axis, concat_axis)

    def ialltoallv(self, x, sendcounts: Sequence[int], recvcounts: Sequence[int],
                   comm: int):
        return _dist.alltoallv(x, sendcounts, recvcounts, self._info(comm).group)

    def ialltoallw(self, blocks, sendtypes, recvtypes, comm: int):
        """Native path: handle vectors need no conversion (they ARE the ABI);
        per-peer recv-type casts are applied on completion."""
        p = _dist.alltoall(blocks, self._info(comm).group, 0, 0)
        inner = p.post
        to = self.datatypes.to_dtype

        def post(v):
            out = inner(v) if inner is not None else v
            return [out[i].to(to(recvtypes[i])) for i in range(out.shape[0])]

        return _dist.Pending(p.work, p.value, post, p.keep)

    def isendrecv(self, x, perm: Sequence[tuple[int, int]], comm: int):
        info = self._info(comm)
        return _dist.ppermute(x, perm, info.group, info.ranks)

    def ibarrier(self, comm: int):
        return _dist.barrier(self._info(comm).group, self.device)

    def iscatter(self, x, root: int, comm: int, axis: int = 0):
        info = self._info(comm)
        return _dist.scatter_from_root(x, root, info.group, info.ranks, axis=axis)

    def igather(self, x, root: int, comm: int, axis: int = 0):
        # SPMD gather == allgather (defined at root, replicated elsewhere).
        return self.iallgather(x, comm, axis)

    def iscan(self, x, op: int, comm: int):
        return _dist.scan_fold(x, self.op_fn(op), self._info(comm).group, True)

    def iexscan(self, x, op: int, comm: int):
        return _dist.scan_fold(x, self.op_fn(op), self._info(comm).group, False)

    # -- blocking collectives ---------------------------------------------
    def allreduce(self, x, op: int, comm: int):
        return self.iallreduce(x, op, comm).result()

    def reduce(self, x, op: int, root: int, comm: int):
        return self.iallreduce(x, op, comm).result()

    def bcast(self, x, root: int, comm: int):
        return self.ibcast(x, root, comm).result()

    def reduce_scatter(self, x, op: int, comm: int, axis: int = 0):
        return self.ireduce_scatter(x, op, comm, axis).result()

    def allgather(self, x, comm: int, axis: int = 0):
        return self.iallgather(x, comm, axis).result()

    def alltoall(self, x, comm: int, split_axis: int = 0, concat_axis: int = 0):
        return self.ialltoall(x, comm, split_axis, concat_axis).result()

    def alltoallv(self, x, sendcounts: Sequence[int], recvcounts: Sequence[int],
                  comm: int):
        return self.ialltoallv(x, sendcounts, recvcounts, comm).result()

    def alltoallw(self, blocks, sendtypes, recvtypes, comm: int):
        return self.ialltoallw(blocks, sendtypes, recvtypes, comm).result()

    def sendrecv(self, x, perm: Sequence[tuple[int, int]], comm: int):
        return self.isendrecv(x, perm, comm).result()

    def barrier(self, comm: int):
        return self.ibarrier(comm).result()

    def scatter(self, x, root: int, comm: int, axis: int = 0):
        return self.iscatter(x, root, comm, axis).result()

    def gather(self, x, root: int, comm: int, axis: int = 0):
        return self.iallgather(x, comm, axis).result()

    def scan(self, x, op: int, comm: int):
        return self.iscan(x, op, comm).result()

    def exscan(self, x, op: int, comm: int):
        return self.iexscan(x, op, comm).result()

    # -- fault tier (ULFM analogues, native hooks) --------------------------
    # The failure detector is `local_failed` (the base default reports
    # nothing); agree/shrink use the shared kernels from core.emulation so
    # native and recipe-emulated backends cannot diverge.
    def comm_revoke(self, comm: int):
        self.comms.revoke(comm)
        return None

    def comm_failure_ack(self, comm: int):
        _, failed, acked = comm_failure_view(self.comms, self.local_failed, comm)
        self.comms.acked[comm] = acked | failed
        return None

    def comm_get_failed(self, comm: int) -> tuple[int, ...]:
        _, failed, _ = comm_failure_view(self.comms, self.local_failed, comm)
        return tuple(sorted(failed))

    def comm_agree(self, flag, comm: int):
        return agree_value(self.comms, self.local_failed, flag, comm)

    def comm_shrink(self, comm: int) -> int:
        info, failed, acked = comm_failure_view(self.comms, self.local_failed, comm)
        self.comms.acked[comm] = acked | failed
        mask = 0
        for r in failed:
            mask |= 1 << r
        agreed = self.comm_agree(mask, comm)
        excludes = [r for r in range(info.full_size) if (agreed >> r) & 1]
        return self.comms.register_shrunk(comm, excludes)

    # -- persistent plans (MPI-4 <name>_init) ------------------------------
    # The comm→group lookup and the op branch are taken once at plan time;
    # a plan start() issues the frozen primitive asynchronously.
    def plan_allreduce(self, x, op: int, comm: int):
        group = self.comm_group(comm)
        name = _NATIVE_NAMES.get(op)
        if name is not None:
            return lambda x: _dist.allreduce(x, name, group)
        fn = self.op_fn(op)
        return lambda x: _dist.allreduce_generic(x, fn, group)

    def plan_reduce_scatter(self, x, op: int, comm: int, axis: int = 0):
        group = self.comm_group(comm)
        if op == H.PAX_SUM:
            return lambda x: _dist.reduce_scatter_sum(x, group, axis=axis)
        fn = self.op_fn(op)
        return lambda x: _dist.reduce_scatter_generic(x, fn, group, axis=axis)

    def plan_allgather(self, x, comm: int, axis: int = 0):
        group = self.comm_group(comm)
        return lambda x: _dist.allgather(x, group, axis=axis)

    def plan_bcast(self, x, root: int, comm: int):
        info = self._info(comm)
        group, ranks = info.group, info.ranks
        return lambda x: _dist.bcast(x, root, group, ranks)

    # -- plan-group hooks (MPI Startall): stack same-comm, same-op members
    # into ONE collective.  Members are stacked on a fresh leading axis and
    # the collective runs over axis 1 (reduce_scatter/allgather) or
    # elementwise (allreduce/bcast), so N member plans cost one collective
    # instead of N.  Mixed shapes decline (None) and the ABI layer falls
    # back to per-member plan runs.
    def plan_group_allreduce(self, bounds):
        _, op, comm = bounds[0]
        if uniform_payload(bounds) is None:
            return None
        name = _NATIVE_NAMES.get(op)
        if name is None:
            return None  # generic-op fold: per-member fallback
        group = self.comm_group(comm)
        n = len(bounds)
        return lambda xs: _unstack(_dist.allreduce(_stack(xs), name, group), n)

    def plan_group_reduce_scatter(self, bounds):
        _, op, comm, axis = bounds[0]
        u = uniform_payload(bounds, min_ndim=1)
        if u is None or axis != 0 or op != H.PAX_SUM:
            return None
        if u[0][0] % self.comms.info(comm).size:
            return None
        group = self.comm_group(comm)
        n = len(bounds)
        return lambda xs: _unstack(
            _dist.reduce_scatter_sum(_stack(xs), group, axis=1), n)

    def plan_group_allgather(self, bounds):
        _, comm, axis = bounds[0]
        if uniform_payload(bounds, min_ndim=1) is None or axis != 0:
            return None
        group = self.comm_group(comm)
        n = len(bounds)
        return lambda xs: _unstack(_dist.allgather(_stack(xs), group, axis=1), n)

    def plan_group_bcast(self, bounds):
        _, root, comm = bounds[0]
        if uniform_payload(bounds) is None:
            return None
        info = self._info(comm)
        group, ranks = info.group, info.ranks
        n = len(bounds)
        return lambda xs: _unstack(_dist.bcast(_stack(xs), root, group, ranks), n)
