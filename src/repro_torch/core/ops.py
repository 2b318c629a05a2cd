"""Reduction operations: predefined op handles + user-defined ops.

User-defined ops are the ABI's *callback* surface (paper §3 item 4): the
user registers a function against the ABI; backends only ever see the op
*handle*.  Ops act on tensors; SUM/MIN/MAX map onto the native
``torch.distributed`` reductions, every other op folds gathered
contributions locally with the binary function below.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import handles as H
from .errors import PAX_ERR_OP, PaxError


def _logical(fn: Callable) -> Callable:
    return lambda a, b: fn(a.bool(), b.bool()).to(a.dtype)


# Semantics of the predefined ops as binary tensor functions (the portable
# definition; backends use the native collectives for SUM/MIN/MAX).
PREDEFINED_OP_FNS: dict[int, Callable] = {
    H.PAX_SUM: lambda a, b: a + b,
    H.PAX_PROD: lambda a, b: a * b,
    H.PAX_MIN: torch.minimum,
    H.PAX_MAX: torch.maximum,
    H.PAX_BAND: lambda a, b: a & b,
    H.PAX_BOR: lambda a, b: a | b,
    H.PAX_BXOR: lambda a, b: a ^ b,
    H.PAX_LAND: _logical(torch.logical_and),
    H.PAX_LOR: _logical(torch.logical_or),
    H.PAX_LXOR: _logical(torch.logical_xor),
    H.PAX_REPLACE: lambda a, b: b,
    H.PAX_NO_OP: lambda a, b: a,
}


def _minloc(a, b):
    """MINLOC over (value, index) pairs stacked on the last axis."""
    av, ai = a[..., 0], a[..., 1]
    bv, bi = b[..., 0], b[..., 1]
    take_a = (av < bv) | ((av == bv) & (ai <= bi))
    return torch.stack([torch.where(take_a, av, bv),
                        torch.where(take_a, ai, bi)], dim=-1)


def _maxloc(a, b):
    av, ai = a[..., 0], a[..., 1]
    bv, bi = b[..., 0], b[..., 1]
    take_a = (av > bv) | ((av == bv) & (ai <= bi))
    return torch.stack([torch.where(take_a, av, bv),
                        torch.where(take_a, ai, bi)], dim=-1)


PREDEFINED_OP_FNS[H.PAX_MINLOC] = _minloc
PREDEFINED_OP_FNS[H.PAX_MAXLOC] = _maxloc

# Ops whose reduction the collective library runs natively on the wire.
NATIVE_COLLECTIVE_OPS = frozenset({H.PAX_SUM, H.PAX_MIN, H.PAX_MAX})

# All predefined ops are commutative per MPI semantics.
COMMUTATIVE_PREDEFINED = frozenset(PREDEFINED_OP_FNS)


@dataclasses.dataclass(frozen=True)
class OpDescriptor:
    handle: int
    fn: Callable
    commutative: bool
    name: str


class OpRegistry:
    """Per-context table of user-defined reduction ops (``MPI_Op_create``)."""

    def __init__(self) -> None:
        self._user: dict[int, OpDescriptor] = {}
        self._next_index = 0

    def op_create(self, fn: Callable, *, commutative: bool = True, name: str = "") -> int:
        handle = H.make_user_handle(H.HandleKind.OP, self._next_index)
        self._next_index += 1
        self._user[handle] = OpDescriptor(
            handle, fn, commutative, name or getattr(fn, "__name__", "user_op")
        )
        return handle

    def op_free(self, handle: int) -> None:
        self._user.pop(handle, None)

    def descriptor(self, handle: int) -> OpDescriptor:
        if handle in self._user:
            return self._user[handle]
        if handle in PREDEFINED_OP_FNS:
            return OpDescriptor(
                handle,
                PREDEFINED_OP_FNS[handle],
                True,
                H.PREDEFINED_NAMES.get(handle, "?"),
            )
        raise PaxError(PAX_ERR_OP, H.describe(handle))

    def fn(self, handle: int) -> Callable:
        return self.descriptor(handle).fn

    def is_user(self, handle: int) -> bool:
        return handle in self._user
