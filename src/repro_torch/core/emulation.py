"""Emulation recipe builders — synthesizing missing entry points from present ones.

The counterpart of the reference's ``repro.core.emulation``: every builder
here compiles one missing function-table entry out of entries the backend
*does* resolve, so a partial implementation (``minimal``, or a foreign
library behind Mukautuva that exports no ``Reduce``/``Gather``/ULFM symbol)
is admitted behind the same standard table.  Each ``build_*`` function
receives an :class:`EmulationContext` and returns a closure with the entry's
backend-method signature; the closure captures the **resolved** dependency
callables (native methods or earlier emulations, in ``EMULATION_ORDER``), so
recipes chain: on ``minimal``, ``scatter`` resolves as ``scatter -> bcast
-> allreduce -> (reduce_scatter, allgather)``.

The persistent builders (``plan_*``) take the plan's bound arguments with
payloads as :class:`~repro_torch.core.abi.TensorSpec` and return a run
closure; every chain decision (padding geometry, slice bounds, dependency
plans, this rank's index) is taken once at plan time.  A run closure may
return a ``_dist.Pending`` (its collective still in flight) where it does
no work after the last leg; the plan's ``wait`` completes it.  The
plan-group builders (``plan_group_*``) fuse a whole stage of members.

One process is one rank, so a rank query is a plain int: the reference's
``jnp.where(rank == root, ...)`` and ``lax.dynamic_slice_in_dim`` at a
traced rank become a Python branch and ``narrow``.  Wire-semantics notes
(the reference's):

* ``allreduce`` pads the leading axis to a multiple of the communicator
  width and composes reduce-scatter with all-gather; padding rows are
  reduced and sliced off, which is right for any reduction op;
* ``barrier`` is an all-reduce of a one-element buffer;
* ``scan``/``exscan`` gather every rank's contribution in rank order and
  fold locally (:func:`prefix_fold`, the convention shared with the native
  lowering: rank 0 keeps its input under exscan);
* ``alltoallv`` keeps the SPMD-uniform contract (non-uniform counts raise
  ``ValueError``);
* the fault tier (ULFM) recipes act on the communicator table directly,
  since every plain entry raises ``PAX_ERR_REVOKED`` on a revoked
  communicator by design.

A dropped dependency (the transport tier's ``drop`` mode) yields the
:class:`~repro_torch.core.errors.IncompleteValue` sentinel instead of a
tensor; every later stage of a chain hands it on untouched
(:func:`_incomplete_passthrough` on each dependency, and the guards where a
recipe reads a dependency's result), so it reaches the wait that times it
out.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from . import handles as H
from .errors import PAX_ERR_PROC_FAILED, IncompleteValue, PaxError


def _incomplete_passthrough(fn: Callable) -> Callable:
    """Propagate the drop sentinel through recipe composition: a call that
    receives one returns it and never reaches the wire."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        for a in args:
            if a.__class__ is IncompleteValue:
                return a
        return fn(*args, **kwargs)

    return run


class EmulationContext:
    """What a recipe may close over: resolved entries + backend queries."""

    def __init__(self, abi) -> None:
        self._abi = abi

    def dep(self, name: str) -> Callable:
        return _incomplete_passthrough(self._abi._ensure_built(name))

    def op_fn(self, op: int) -> Callable:
        return self._abi.backend.op_fn(op)

    def lowering_width(self, comm: int) -> int:
        """The width a recipe splits ``comm``'s payloads by: the members of
        its process group (a survivor communicator's own group holds the
        survivors only)."""
        return self._abi.comms.info(comm).size

    @property
    def datatypes(self):
        return self._abi.datatypes

    @property
    def device(self) -> torch.device:
        """The device recipe-made buffers (a barrier's one element) live on."""
        mesh = self._abi.mesh
        return mesh.device if mesh is not None else torch.device("cpu")

    # -- fault-tier accessors (ULFM recipes): the one recipe family that
    # reaches past the entry table into the shared CommTable, because the
    # fault entries must act on *revoked* communicators
    @property
    def comms(self):
        return self._abi.comms

    def local_failed(self, comm: int) -> tuple:
        """Ranks the backend knows dead on ``comm`` (fault injection hook)."""
        return tuple(self._abi.backend.local_failed(comm))

    def register_shrunk(self, parent: int, excludes, name: str = "") -> int:
        """Register the shrink survivor comm; mirror it into foreign libs."""
        new = self._abi.comms.register_shrunk(parent, excludes, name)
        reg = getattr(self._abi.backend, "register_comm", None)
        if reg is not None:  # foreign convention: keep the impl table in sync
            reg(new, self._abi.comms.info(new).axes)
        return new


class PlanContext(EmulationContext):
    """What a recipe *plan* builder may close over."""

    def plan_dep(self, name: str, *bound) -> Callable:
        return _incomplete_passthrough(self._abi._plan_run(name, bound))

    def plan_group_dep(self, name: str, bounds) -> Callable:
        return self._abi._plan_group_run(name, bounds)

    def wire_block(self) -> int:
        """The backend's padding granule (``Backend.wire_pad_multiple``):
        plans that invent padding round it up to a multiple of this, so the
        padded legs stay on the backend's fast wire.  The extra zeros are
        reduced and sliced off like any padding."""
        return max(1, int(self._abi.backend.wire_pad_multiple()))


def prefix_fold(g, r: int, fn: Callable, x, inclusive: bool):
    """The shared scan/exscan kernel: fold gathered contributions ``g``
    (leading axis = linearized communicator rank) into rank ``r``'s prefix.
    The exscan convention — rank 0 keeps its input ``x`` unchanged (MPI:
    undefined) — is the reference's.  One process is one rank, so ``r`` is
    a plain int and the fold stops at this rank's prefix."""
    if g.__class__ is IncompleteValue:  # a dropped gather stays incomplete
        return g
    acc = g[0]
    if r == 0:
        return acc if inclusive else x
    for j in range(1, r + 1):
        prev = acc
        acc = fn(prev, g[j])
    return acc if inclusive else prev


def masked_agree_fold(contribs, alive):
    """Bitwise-AND fold over per-rank contributions, masked by ``alive``
    (dead ranks contribute the AND identity, i.e. are skipped)."""
    acc = None
    for c, a in zip(contribs, alive):
        if not a:
            continue
        acc = c if acc is None else acc & c
    if acc is None:
        raise PaxError(PAX_ERR_PROC_FAILED, "agree with no surviving ranks")
    return acc


def comm_failure_view(comms, local_failed, comm: int):
    """The comm's info (revocation allowed), the known-failed *member* set,
    and the acknowledged subset — one failure model for native hooks and
    recipes alike."""
    info = comms.info(comm, allow_revoked=True)
    failed = frozenset(local_failed(comm)) - frozenset(info.excludes)
    return info, failed, comms.acked.get(comm, frozenset())


def agree_value(comms, local_failed, flag, comm: int):
    """ULFM agree semantics: raise PAX_ERR_PROC_FAILED while unacknowledged
    failures exist, else fold the masked AND over surviving contributions
    (every survivor passes the same ``flag`` under SPMD)."""
    info, failed, acked = comm_failure_view(comms, local_failed, comm)
    pending = failed - acked
    if pending:
        raise PaxError(
            PAX_ERR_PROC_FAILED,
            f"comm_agree with unacknowledged failed ranks {sorted(pending)} "
            f"on {info.name or hex(comm)}",
        )
    full = info.full_size
    return masked_agree_fold([flag] * full,
                             [r not in failed for r in range(full)])


def _tag(fn: Callable, name: str, deps: tuple) -> Callable:
    fn.__name__ = name
    fn.__qualname__ = f"emulated.{name}"
    fn.__emulated__ = True
    fn.__emulated_deps__ = tuple(deps)
    return fn


def _pad_rows(x, pad: int):
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _then(value, fn: Callable):
    """``fn`` of a run's result: at once for a completed value, at the
    plan's wait for a collective still in flight."""
    from .backends._dist import Pending

    if value.__class__ is Pending:
        return Pending(None, value, lambda p: fn(p.result()))
    if value.__class__ is IncompleteValue:
        return value
    return fn(value)


# ---------------------------------------------------------------------------
# Fault tier (ULFM) recipes: one failure model with paxi's native hooks
# (comm_failure_view, agree_value, masked_agree_fold).
# ---------------------------------------------------------------------------
def build_comm_revoke(ctx: EmulationContext) -> Callable:
    comms = ctx.comms

    def comm_revoke(comm):
        comms.revoke(comm)
        return None

    return _tag(comm_revoke, "comm_revoke", ())


def build_comm_failure_ack(ctx: EmulationContext) -> Callable:
    comms, local_failed = ctx.comms, ctx.local_failed

    def comm_failure_ack(comm):
        _, failed, acked = comm_failure_view(comms, local_failed, comm)
        comms.acked[comm] = acked | failed
        return None

    return _tag(comm_failure_ack, "comm_failure_ack", ())


def build_comm_get_failed(ctx: EmulationContext) -> Callable:
    comms, local_failed = ctx.comms, ctx.local_failed

    def comm_get_failed(comm):
        _, failed, _ = comm_failure_view(comms, local_failed, comm)
        return tuple(sorted(failed))

    return _tag(comm_get_failed, "comm_get_failed", ())


def build_comm_agree(ctx: EmulationContext) -> Callable:
    comms, local_failed = ctx.comms, ctx.local_failed

    def comm_agree(flag, comm):
        return agree_value(comms, local_failed, flag, comm)

    return _tag(comm_agree, "comm_agree", ())


def build_comm_shrink(ctx: EmulationContext) -> Callable:
    agree, get_failed = ctx.dep("comm_agree"), ctx.dep("comm_get_failed")
    comms, local_failed = ctx.comms, ctx.local_failed

    def comm_shrink(comm):
        # ULFM shrink = implicit ack of the known failures, agreement on the
        # failure set (a rank bitmask through agree's AND fold), then the
        # survivor communicator's registration
        _, failed, acked = comm_failure_view(comms, local_failed, comm)
        comms.acked[comm] = acked | failed
        mask = 0
        for r in failed:
            mask |= 1 << r
        agreed = agree(mask, comm)
        info = comms.info(comm, allow_revoked=True)
        excludes = [r for r in range(info.full_size) if (agreed >> r) & 1]
        assert sorted(excludes) == sorted(get_failed(comm))
        return ctx.register_shrunk(comm, excludes)

    return _tag(comm_shrink, "comm_shrink", ("comm_agree", "comm_get_failed"))


# ---------------------------------------------------------------------------
# Blocking recipes
# ---------------------------------------------------------------------------
def build_allreduce(ctx: EmulationContext) -> Callable:
    """allreduce = allgather(reduce_scatter(x)), the leading axis padded to
    a multiple of the communicator width and sliced back."""
    rs, ag = ctx.dep("reduce_scatter"), ctx.dep("allgather")
    width = ctx.lowering_width

    def allreduce(x, op, comm):
        S = width(comm)
        if S <= 1:
            return x
        scalar = x.ndim == 0
        if scalar:
            x = x.reshape(1)
        n = x.shape[0]
        out = ag(rs(_pad_rows(x, (-n) % S), op, comm), comm)[:n]
        return out[0] if scalar else out

    return _tag(allreduce, "allreduce", ("reduce_scatter", "allgather", "comm_size"))


def build_reduce(ctx: EmulationContext) -> Callable:
    ar = ctx.dep("allreduce")

    def reduce(x, op, root, comm):
        # SPMD: computed everywhere, defined at root (the MPI contract)
        return ar(x, op, comm)

    return _tag(reduce, "reduce", ("allreduce",))


def build_bcast(ctx: EmulationContext) -> Callable:
    ar, rank = ctx.dep("allreduce"), ctx.dep("comm_rank")

    def bcast(x, root, comm):
        return ar(x if rank(comm) == root else torch.zeros_like(x), H.PAX_SUM, comm)

    return _tag(bcast, "bcast", ("allreduce", "comm_rank"))


def build_barrier(ctx: EmulationContext) -> Callable:
    ar, device = ctx.dep("allreduce"), ctx.device

    def barrier(comm):
        ar(torch.zeros((1,), dtype=torch.float32, device=device), H.PAX_SUM, comm)
        return None

    return _tag(barrier, "barrier", ("allreduce",))


def _build_scan(ctx: EmulationContext, inclusive: bool, name: str) -> Callable:
    ag, rank, size = ctx.dep("allgather"), ctx.dep("comm_rank"), ctx.dep("comm_size")
    op_fn = ctx.op_fn

    def scan(x, op, comm):
        if size(comm) <= 1:
            return x
        g = ag(x.unsqueeze(0), comm)  # (S, *x.shape), rank order
        return prefix_fold(g, rank(comm), op_fn(op), x, inclusive)

    return _tag(scan, name, ("allgather", "comm_rank", "comm_size"))


def build_scan(ctx: EmulationContext) -> Callable:
    return _build_scan(ctx, inclusive=True, name="scan")


def build_exscan(ctx: EmulationContext) -> Callable:
    return _build_scan(ctx, inclusive=False, name="exscan")


def build_alltoall(ctx: EmulationContext) -> Callable:
    ag, rank, size = ctx.dep("allgather"), ctx.dep("comm_rank"), ctx.dep("comm_size")

    def alltoall(x, comm, split_axis=0, concat_axis=0):
        S = size(comm)
        if S <= 1:
            return x
        if x.shape[split_axis] % S:
            raise ValueError(
                f"alltoall split axis {split_axis} (length "
                f"{x.shape[split_axis]}) not divisible by comm size {S}")
        blk = x.shape[split_axis] // S
        g = ag(x.unsqueeze(0), comm)  # (S, *x.shape)
        if g.__class__ is IncompleteValue:
            return g
        mine = g.narrow(split_axis + 1, rank(comm) * blk, blk)
        return torch.cat([mine[j] for j in range(S)], dim=concat_axis)

    return _tag(alltoall, "alltoall", ("allgather", "comm_rank", "comm_size"))


def build_alltoallv(ctx: EmulationContext) -> Callable:
    a2a, size = ctx.dep("alltoall"), ctx.dep("comm_size")

    def alltoallv(x, sendcounts, recvcounts, comm):
        sendcounts = tuple(int(c) for c in sendcounts)
        recvcounts = tuple(int(c) for c in recvcounts)
        if len(sendcounts) != len(recvcounts):
            raise ValueError("sendcounts and recvcounts must have equal length")
        if len(set(sendcounts) | set(recvcounts)) != 1:
            raise ValueError(
                "SPMD alltoallv requires uniform counts (one static trace "
                "cannot express per-rank-varying counts); got "
                f"sendcounts={sendcounts}, recvcounts={recvcounts}")
        c = sendcounts[0]
        P = len(sendcounts)
        if x.shape[0] != P * c:
            raise ValueError(f"payload has {x.shape[0]} rows, counts promise {P}x{c}")
        S = size(comm)
        if S <= 1:
            if P != 1:
                raise ValueError("group-of-one alltoallv takes exactly one count")
            return x
        if P != S:
            raise ValueError(f"{P} counts for a size-{S} communicator")
        if c == 0:
            return x[:0]
        out = a2a(x.reshape((P, c) + tuple(x.shape[1:])), comm, 0, 0)
        if out.__class__ is IncompleteValue:
            return out
        return out.reshape((P * c,) + tuple(x.shape[1:]))

    return _tag(alltoallv, "alltoallv", ("alltoall", "comm_size"))


def build_alltoallw(ctx: EmulationContext) -> Callable:
    a2a = ctx.dep("alltoall")
    to_dtype = ctx.datatypes.to_dtype

    def alltoallw(blocks, sendtypes, recvtypes, comm):
        out = a2a(blocks, comm, 0, 0)
        if out.__class__ is IncompleteValue:
            return out
        return [out[i].to(to_dtype(recvtypes[i])) for i in range(out.shape[0])]

    return _tag(alltoallw, "alltoallw", ("alltoall",))


def build_gather(ctx: EmulationContext) -> Callable:
    ag = ctx.dep("allgather")

    def gather(x, root, comm, axis=0):
        # SPMD gather == allgather (defined at root, replicated elsewhere)
        return ag(x, comm, axis)

    return _tag(gather, "gather", ("allgather",))


def build_scatter(ctx: EmulationContext) -> Callable:
    bc, rank, size = ctx.dep("bcast"), ctx.dep("comm_rank"), ctx.dep("comm_size")

    def scatter(x, root, comm, axis=0):
        y = bc(x, root, comm)
        S = size(comm)
        if S <= 1 or y.__class__ is IncompleteValue:
            return y
        chunk = y.shape[axis] // S
        return y.narrow(axis, rank(comm) * chunk, chunk)

    return _tag(scatter, "scatter", ("bcast", "comm_rank", "comm_size"))


# ---------------------------------------------------------------------------
# Persistent-plan recipes (MPI-4 ``<name>_init``)
# ---------------------------------------------------------------------------
def plan_allreduce(ctx: PlanContext, x, op, comm) -> Callable:
    """The persistent recipe: the padding geometry and both legs' plans are
    fixed here; the padding rounds up to ``S * wire_block`` so the
    reduce-scatter leg's hop chunks stay kernel-eligible."""
    from .abi import TensorSpec
    from .backends._dist import complete

    S = ctx.lowering_width(comm)
    if S <= 1:
        return lambda x: x
    scalar = len(x.shape) == 0
    shape = (1,) if scalar else tuple(x.shape)
    n, rest, dtype = shape[0], shape[1:], x.dtype
    pad = (-n) % (S * ctx.wire_block())
    rs = ctx.plan_dep("reduce_scatter", TensorSpec((n + pad,) + rest, dtype), op, comm, 0)
    ag = ctx.plan_dep("allgather", TensorSpec(((n + pad) // S,) + rest, dtype), comm, 0)
    if not pad and not scalar:
        return lambda x: ag(complete(rs(x)))

    def run(x):
        if scalar:
            x = x.reshape(1)
        out = complete(ag(complete(rs(_pad_rows(x, pad)))))[:n]
        return out[0] if scalar else out

    return run


def plan_reduce(ctx: PlanContext, x, op, root, comm) -> Callable:
    # SPMD: computed everywhere, defined at root (the MPI contract)
    return ctx.plan_dep("allreduce", x, op, comm)


def plan_bcast(ctx: PlanContext, x, root, comm) -> Callable:
    ar = ctx.plan_dep("allreduce", x, H.PAX_SUM, comm)
    if ctx.dep("comm_rank")(comm) == root:
        return ar
    return lambda x: ar(torch.zeros_like(x))


def plan_barrier(ctx: PlanContext, comm) -> Callable:
    from .abi import TensorSpec

    ar = ctx.plan_dep("allreduce", TensorSpec((1,), torch.float32), H.PAX_SUM, comm)
    device = ctx.device

    def run():
        return _then(ar(torch.zeros((1,), dtype=torch.float32, device=device)),
                     lambda _: None)

    return run


def _plan_scan(ctx: PlanContext, x, op, comm, inclusive: bool) -> Callable:
    from .abi import TensorSpec

    if ctx.dep("comm_size")(comm) <= 1:
        return lambda x: x
    ag = ctx.plan_dep("allgather", TensorSpec((1,) + tuple(x.shape), x.dtype), comm, 0)
    r, fn = ctx.dep("comm_rank")(comm), ctx.op_fn(op)

    def run(x):
        return _then(ag(x.unsqueeze(0)), lambda g: prefix_fold(g, r, fn, x, inclusive))

    return run


def plan_scan(ctx: PlanContext, x, op, comm) -> Callable:
    return _plan_scan(ctx, x, op, comm, inclusive=True)


def plan_exscan(ctx: PlanContext, x, op, comm) -> Callable:
    return _plan_scan(ctx, x, op, comm, inclusive=False)


def plan_gather(ctx: PlanContext, x, root, comm, axis=0) -> Callable:
    # SPMD gather == allgather (defined at root, replicated elsewhere)
    return ctx.plan_dep("allgather", x, comm, axis)


# ---------------------------------------------------------------------------
# Plan-group recipes (MPI ``Startall``): fused per stage
# ---------------------------------------------------------------------------
def plan_group_allreduce(ctx: PlanContext, bounds) -> Callable:
    """The group recipe, fused per stage: every member's reduce-scatter leg
    runs as one group stage before one all-gather stage, each through the
    backend's own group hook where it has one."""
    from .abi import TensorSpec
    from .backends._dist import complete

    op, comm = bounds[0][1], bounds[0][2]
    S = ctx.lowering_width(comm)
    if S <= 1:
        return lambda xs: list(xs)
    blk = ctx.wire_block()
    members, rs_bounds, ag_bounds = [], [], []
    for x, _, _ in bounds:
        if not hasattr(x, "shape") or not hasattr(x, "dtype"):
            return None  # structured payloads: per-member plans
        scalar = len(tuple(x.shape)) == 0
        shape = (1,) if scalar else tuple(x.shape)
        n, rest = shape[0], shape[1:]
        pad = (-n) % (S * blk)
        members.append((scalar, n, pad))
        rs_bounds.append((TensorSpec((n + pad,) + rest, x.dtype), op, comm, 0))
        ag_bounds.append((TensorSpec(((n + pad) // S,) + rest, x.dtype), comm, 0))
    rs_run = ctx.plan_group_dep("reduce_scatter", rs_bounds)
    ag_run = ctx.plan_group_dep("allgather", ag_bounds)

    def run(xs):
        mids = [_pad_rows(x.reshape(1) if scalar else x, pad)
                for (scalar, _, pad), x in zip(members, xs)]
        outs = complete(ag_run(complete(rs_run(mids))))  # all rs, then all ag
        final = []
        for (scalar, n, pad), o in zip(members, outs):
            if pad or scalar:
                o = o[:n]
            final.append(o[0] if scalar else o)
        return final

    return run


def plan_group_reduce(ctx: PlanContext, bounds) -> Callable:
    # SPMD: computed everywhere, defined at root (the MPI contract)
    return ctx.plan_group_dep(
        "allreduce", [(x, op, comm) for x, op, root, comm in bounds])
