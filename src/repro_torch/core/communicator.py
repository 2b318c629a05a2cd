"""Communicators over ``torch.distributed`` process groups.

An MPI communicator names an ordered process group.  In the reference a
communicator resolves to mesh axes that collectives lower over inside one
controller's ``shard_map``; here one process is one rank, so a communicator
resolves to a ``torch.distributed`` group (NCCL on the card, gloo on the
CPU) built once, when the handle is registered.

* ``PAX_COMM_WORLD`` → every axis of the mesh: the default (world) group;
* ``PAX_COMM_SELF``  → the empty axis tuple: no group, a group of one;
* derived communicators (``comm_from_axes``, the ``MPI_Comm_split``-shaped
  constructor) name axis subsets, e.g. the data-parallel group
  ``("data",)``.  Every process registers the same handles in the same
  order (SPMD), so each one creates every sibling group — the collective
  ``new_group`` contract — and keeps the one it belongs to.

Ranks are linearized row-major over the mesh axes, the reference's
convention, so a communicator rank here equals ``comm_rank_traced`` there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from . import handles as H
from .errors import PAX_ERR_COMM, PAX_ERR_REVOKED, PaxError


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process grid: named axes over the world's ranks (row-major), and
    the device every rank computes on (the counterpart of the devices a JAX
    mesh holds)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: int) -> tuple[int, ...]:
        out = []
        for s in reversed(self.sizes):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))


@dataclasses.dataclass(frozen=True, eq=False)
class CommInfo:
    handle: int
    axes: tuple[str, ...]  # ordered mesh axes; () == SELF
    mesh_axis_sizes: tuple[int, ...]
    name: str = ""
    #: ranks excluded from the group (ULFM shrink survivors-only comms)
    excludes: tuple[int, ...] = ()
    #: the process group collectives run on (None: a group of one)
    group: Any = None
    #: global ranks of the members, in communicator-rank order
    ranks: tuple[int, ...] = ()

    @property
    def full_size(self) -> int:
        """Group size before exclusions (the parent's extent)."""
        return math.prod(self.mesh_axis_sizes) if self.mesh_axis_sizes else 1

    @property
    def size(self) -> int:
        return self.full_size - len(self.excludes)


class CommTable:
    """Per-ABI-context communicator table."""

    def __init__(self, mesh: Optional[Mesh]) -> None:
        self._mesh = mesh
        self._table: dict[int, CommInfo] = {}
        self._next_index = 0
        #: process groups by member ranks: a comm_dup or a second comm over
        #: the same axes reuses the group instead of creating another
        self._groups: dict[tuple[int, ...], Any] = {}
        self.rank = dist.get_rank() if mesh is not None else 0
        # registration-time flat lookup (handle -> CommInfo) for the hot path
        self.info_by_handle: dict[int, CommInfo] = {}
        self.revoked: set[int] = set()
        #: per-comm acknowledged failures (comm_failure_ack)
        self.acked: dict[int, frozenset] = {}
        axes = tuple(mesh.axis_names) if mesh is not None else ()
        self._register(H.PAX_COMM_WORLD, axes, "PAX_COMM_WORLD")
        self._register(H.PAX_COMM_SELF, (), "PAX_COMM_SELF")

    @property
    def mesh(self) -> Optional[Mesh]:
        return self._mesh

    def _group(self, ranks: tuple[int, ...]):
        if len(ranks) == dist.get_world_size():
            return dist.group.WORLD
        g = self._groups.get(ranks)
        if g is None:
            g = self._groups[ranks] = dist.new_group(list(ranks))
        return g

    def _group_for(self, axes: tuple[str, ...]):
        """(group, member ranks) of this rank's group over ``axes``; every
        sibling group is created too (``new_group`` is collective)."""
        if not axes:
            return None, (self.rank,)
        names = self._mesh.axis_names
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise PaxError(
                PAX_ERR_COMM,
                f"communicator axes {axes} must follow mesh order {names} "
                "(communicator rank = sorted process-group rank)")
        siblings: dict[tuple, list[int]] = {}
        for r in range(self._mesh.size):
            c = self._mesh.coords(r)
            key = tuple(v for i, v in enumerate(c) if i not in idx)
            siblings.setdefault(key, []).append(r)
        mine = None
        for key in sorted(siblings):
            ranks = tuple(siblings[key])
            g = self._group(ranks)
            if self.rank in ranks:
                mine = (g, ranks)
        return mine

    def _register(self, handle: int, axes: tuple[str, ...], name: str) -> CommInfo:
        group, ranks = self._group_for(axes)
        sizes = tuple(self._mesh.shape[a] for a in axes)
        info = CommInfo(handle, axes, sizes, name, group=group, ranks=ranks)
        self._table[handle] = info
        self.info_by_handle[handle] = info
        return info

    def info(self, handle: int, *, allow_revoked: bool = False) -> CommInfo:
        H.check_handle(handle, H.HandleKind.COMM)
        if handle == H.PAX_COMM_NULL:
            raise PaxError(PAX_ERR_COMM, "PAX_COMM_NULL")
        try:
            info = self._table[handle]
        except KeyError:
            raise PaxError(PAX_ERR_COMM, H.describe(handle)) from None
        if self.revoked and handle in self.revoked and not allow_revoked:
            raise PaxError(PAX_ERR_REVOKED, info.name or H.describe(handle))
        return info

    def comm_from_axes(self, axes: Sequence[str], name: str = "") -> int:
        """Create a communicator over a subset of mesh axes (split analogue)."""
        if self._mesh is None:
            raise PaxError(PAX_ERR_COMM, "no mesh bound to this context")
        axes = tuple(axes)
        for a in axes:
            if a not in self._mesh.axis_names:
                raise PaxError(PAX_ERR_COMM, f"axis {a!r} not in mesh {self._mesh.axis_names}")
        handle = H.make_user_handle(H.HandleKind.COMM, self._next_index)
        self._next_index += 1
        self._register(handle, axes, name or f"axes{axes}")
        return handle

    def comm_dup(self, handle: int) -> int:
        info = self.info(handle)
        new = H.make_user_handle(H.HandleKind.COMM, self._next_index)
        self._next_index += 1
        dup = dataclasses.replace(info, handle=new, name=info.name + "+dup")
        self._table[new] = dup
        self.info_by_handle[new] = dup
        return new

    def comm_free(self, handle: int) -> None:
        if H.is_predefined(handle):
            raise PaxError(PAX_ERR_COMM, "cannot free a predefined communicator")
        self._table.pop(handle, None)
        self.info_by_handle.pop(handle, None)
        self.revoked.discard(handle)
        self.acked.pop(handle, None)

    # -- fault tier (ULFM) --------------------------------------------------
    def revoke(self, handle: int) -> None:
        """Mark ``handle`` revoked.  Idempotent.  The handle leaves the hot
        lookup, so every collective on it lands in :meth:`info`, which
        raises ``PAX_ERR_REVOKED``."""
        self.info(handle, allow_revoked=True)
        self.revoked.add(handle)
        self.info_by_handle.pop(handle, None)

    def register_shrunk(self, parent: int, excludes, name: str = "") -> int:
        """Register the survivor communicator of an ULFM shrink (the parent's
        group and axes, ``excludes`` recorded)."""
        info = self.info(parent, allow_revoked=True)
        handle = H.make_user_handle(H.HandleKind.COMM, self._next_index)
        self._next_index += 1
        child = dataclasses.replace(
            info, handle=handle, name=name or (info.name + "+shrink"),
            excludes=tuple(sorted(set(info.excludes) | set(excludes))))
        self._table[handle] = child
        self.info_by_handle[handle] = child
        return handle


def comm_rank(info: CommInfo) -> int:
    """This process's rank within the communicator (row-major over its
    axes — the reference's ``comm_rank_traced``)."""
    if info.group is None:
        return 0
    return dist.get_rank(info.group)
