"""Emulation recipes — what ``abi_spec.py`` and the native backend import.

The reference (``repro.core.emulation``) compiles every OPTIONAL entry a
partial backend lacks out of entries it does export.  This module carries:

* the recipe *declarations* the function table names (``build_*``,
  ``plan_*``, ``plan_group_*``), so the port's ``ABI_TABLE`` equals the
  reference row for row.  The ``allreduce`` recipes have their bodies —
  the ring backend drops its native ``allreduce`` and negotiation composes
  it from the ring reduce-scatter and all-gather, with the padding rounded
  up to the backend's wire granule (:meth:`PlanContext.wire_block`).  The
  other bodies raise ``PAX_ERR_UNSUPPORTED_OPERATION`` until the partial
  (``minimal``) backend arrives, because ``paxi`` and ``ring`` resolve every
  other entry natively;
* the shared kernels that native and emulated paths must not diverge on:
  :func:`prefix_fold` (scan/exscan), :func:`masked_agree_fold`,
  :func:`comm_failure_view` and :func:`agree_value` (the ULFM tier).
"""
from __future__ import annotations

from typing import Callable

import torch

from .errors import PAX_ERR_PROC_FAILED, PAX_ERR_UNSUPPORTED_OPERATION, PaxError


class EmulationContext:
    """What a recipe may close over: resolved entries + backend queries."""

    def __init__(self, abi) -> None:
        self._abi = abi

    def dep(self, name: str) -> Callable:
        return self._abi._ensure_built(name)

    def op_fn(self, op: int) -> Callable:
        return self._abi.backend.op_fn(op)

    def lowering_width(self, comm: int) -> int:
        """The width a recipe splits ``comm``'s payloads by: the full rank
        space of its axes (a shrunk communicator keeps its parent's group,
        so a split by the membership count would not match the wire)."""
        return self._abi.comms.info(comm).full_size

    @property
    def datatypes(self):
        return self._abi.datatypes

    @property
    def comms(self):
        return self._abi.comms


class PlanContext(EmulationContext):
    """What a recipe *plan* builder may close over."""

    def plan_dep(self, name: str, *bound) -> Callable:
        return self._abi._plan_run(name, bound)

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


def _deferred(kind: str, name: str) -> Callable:
    """A recipe declaration whose body arrives with the partial backend."""

    def recipe(ctx, *args, **kwargs):
        raise PaxError(
            PAX_ERR_UNSUPPORTED_OPERATION,
            f"emulation {kind} for {name!r} is not ported yet (it arrives "
            "with the minimal backend)",
        )

    recipe.__name__ = f"{kind}_{name}"
    recipe.__qualname__ = f"{kind}_{name}"
    return recipe


for _name in ("reduce", "bcast", "barrier", "scan", "exscan",
              "alltoall", "alltoallv", "alltoallw", "gather", "scatter",
              "comm_revoke", "comm_failure_ack", "comm_get_failed",
              "comm_agree", "comm_shrink"):
    globals()[f"build_{_name}"] = _deferred("build", _name)
for _name in ("reduce", "bcast", "barrier", "scan", "exscan", "gather"):
    globals()[f"plan_{_name}"] = _deferred("plan", _name)
for _name in ("reduce",):
    globals()[f"plan_group_{_name}"] = _deferred("plan_group", _name)
del _name
