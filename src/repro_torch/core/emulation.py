"""Emulation recipes — what ``abi_spec.py`` and the native backend import.

The reference (``repro.core.emulation``) compiles every OPTIONAL entry a
partial backend lacks out of entries it does export.  This module carries:

* the recipe *declarations* the function table names (``build_*``,
  ``plan_*``, ``plan_group_*``), so the port's ``ABI_TABLE`` equals the
  reference row for row — their bodies raise
  ``PAX_ERR_UNSUPPORTED_OPERATION`` until the partial (``minimal``)
  backend arrives, because ``paxi`` resolves every entry natively and never
  builds a recipe;
* the shared kernels that native and emulated paths must not diverge on:
  :func:`prefix_fold` (scan/exscan), :func:`masked_agree_fold`,
  :func:`comm_failure_view` and :func:`agree_value` (the ULFM tier).
"""
from __future__ import annotations

from typing import Callable

from .errors import PAX_ERR_PROC_FAILED, PAX_ERR_UNSUPPORTED_OPERATION, PaxError


class EmulationContext:
    """What a recipe may close over: resolved entries + backend queries."""

    def __init__(self, abi) -> None:
        self._abi = abi

    def dep(self, name: str) -> Callable:
        return self._abi._ensure_built(name)

    def op_fn(self, op: int) -> Callable:
        return self._abi.backend.op_fn(op)

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


for _name in ("allreduce", "reduce", "bcast", "barrier", "scan", "exscan",
              "alltoall", "alltoallv", "alltoallw", "gather", "scatter",
              "comm_revoke", "comm_failure_ack", "comm_get_failed",
              "comm_agree", "comm_shrink"):
    globals()[f"build_{_name}"] = _deferred("build", _name)
for _name in ("allreduce", "reduce", "bcast", "barrier", "scan", "exscan",
              "gather"):
    globals()[f"plan_{_name}"] = _deferred("plan", _name)
for _name in ("allreduce", "reduce"):
    globals()[f"plan_group_{_name}"] = _deferred("plan_group", _name)
del _name
