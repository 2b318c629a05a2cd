"""Datatype registry: ABI datatype handles <-> torch dtypes, and the two
``type_size`` strategies the paper benchmarks (§6.1).

* :func:`type_size_encoded` — MPICH-style: extract the size from the handle
  bits (fixed-size types only; falls back to the table for variable-size).
* :func:`type_size_lookup` — Open-MPI-style: always go through an object
  table (the 352-byte-struct pointer chase of §3.3, modelled as a dict of
  descriptor objects).

The handle values, names and sizes are the reference's (``repro.core``);
only the array dtype each descriptor carries is a ``torch.dtype`` here.
Variable-size C types keep the A64O64 LP64 model (§5.1): int=4, long=8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import handles as H
from .errors import PAX_ERR_TYPE, PaxError


@dataclasses.dataclass(frozen=True)
class TypeDescriptor:
    """The IMPL-side object an Open-MPI-style backend would point to."""

    handle: int
    name: str
    size: int  # bytes; element size * count for derived types
    dtype: Optional[torch.dtype]
    count: int = 1  # elements (for contiguous/vector derived types)
    base: Optional[int] = None  # base type handle for derived types


_PREDEFINED: dict[int, TypeDescriptor] = {}


def _register(handle: int, name: str, size: int, dtype: Optional[torch.dtype]) -> None:
    _PREDEFINED[handle] = TypeDescriptor(handle, name, size, dtype)


_register(H.PAX_DATATYPE_NULL, "PAX_DATATYPE_NULL", 0, None)
# variable-size C types (size from table, never from bits)
_register(H.PAX_AINT, "PAX_AINT", 8, torch.int64)
_register(H.PAX_COUNT, "PAX_COUNT", 8, torch.int64)
_register(H.PAX_OFFSET, "PAX_OFFSET", 8, torch.int64)
_register(H.PAX_PACKED, "PAX_PACKED", 1, torch.uint8)
_register(H.PAX_SHORT, "PAX_SHORT", 2, torch.int16)
_register(H.PAX_INT, "PAX_INT", 4, torch.int32)
_register(H.PAX_LONG, "PAX_LONG", 8, torch.int64)
_register(H.PAX_LONG_LONG, "PAX_LONG_LONG", 8, torch.int64)
_register(H.PAX_UNSIGNED_SHORT, "PAX_UNSIGNED_SHORT", 2, torch.uint16)
_register(H.PAX_UNSIGNED_INT, "PAX_UNSIGNED_INT", 4, torch.uint32)
_register(H.PAX_UNSIGNED_LONG, "PAX_UNSIGNED_LONG", 8, torch.uint64)
_register(H.PAX_UNSIGNED_LONG_LONG, "PAX_UNSIGNED_LONG_LONG", 8, torch.uint64)
_register(H.PAX_FLOAT, "PAX_FLOAT", 4, torch.float32)
_register(H.PAX_DOUBLE, "PAX_DOUBLE", 8, torch.float64)
_register(H.PAX_LONG_DOUBLE, "PAX_LONG_DOUBLE", 8, torch.float64)
_register(H.PAX_C_BOOL, "PAX_C_BOOL", 1, torch.bool)
# fixed-size types (size ALSO encoded in bits 3..5; table must agree)
_register(H.PAX_INT8_T, "PAX_INT8_T", 1, torch.int8)
_register(H.PAX_UINT8_T, "PAX_UINT8_T", 1, torch.uint8)
_register(H.PAX_CHAR, "PAX_CHAR", 1, torch.int8)
_register(H.PAX_SIGNED_CHAR, "PAX_SIGNED_CHAR", 1, torch.int8)
_register(H.PAX_UNSIGNED_CHAR, "PAX_UNSIGNED_CHAR", 1, torch.uint8)
_register(H.PAX_BYTE, "PAX_BYTE", 1, torch.uint8)
_register(H.PAX_INT16_T, "PAX_INT16_T", 2, torch.int16)
_register(H.PAX_UINT16_T, "PAX_UINT16_T", 2, torch.uint16)
_register(H.PAX_FLOAT16, "PAX_FLOAT16", 2, torch.float16)
_register(H.PAX_INT32_T, "PAX_INT32_T", 4, torch.int32)
_register(H.PAX_UINT32_T, "PAX_UINT32_T", 4, torch.uint32)
_register(H.PAX_FLOAT32, "PAX_FLOAT32", 4, torch.float32)
_register(H.PAX_INT64_T, "PAX_INT64_T", 8, torch.int64)
_register(H.PAX_UINT64_T, "PAX_UINT64_T", 8, torch.uint64)
_register(H.PAX_FLOAT64, "PAX_FLOAT64", 8, torch.float64)
_register(H.PAX_COMPLEX64, "PAX_COMPLEX64", 8, torch.complex64)
_register(H.PAX_COMPLEX128, "PAX_COMPLEX128", 16, torch.complex128)
# accelerator extension dtypes, allocated in reserved fixed-size slots
_register(H.PAX_BFLOAT16, "PAX_BFLOAT16", 2, torch.bfloat16)
_register(H.PAX_FLOAT8_E4M3, "PAX_FLOAT8_E4M3", 1, torch.float8_e4m3fn)
_register(H.PAX_FLOAT8_E5M2, "PAX_FLOAT8_E5M2", 1, torch.float8_e5m2)

N_PREDEFINED = len(_PREDEFINED)

# dtype -> canonical handle: fixed-size handles win over the C aliases
_DTYPE_TO_HANDLE: dict[torch.dtype, int] = {}
for _h, _d in sorted(_PREDEFINED.items()):
    if _d.dtype is not None and _d.dtype not in _DTYPE_TO_HANDLE:
        _DTYPE_TO_HANDLE[_d.dtype] = _h
for _h in (
    H.PAX_INT8_T,
    H.PAX_UINT8_T,
    H.PAX_INT16_T,
    H.PAX_UINT16_T,
    H.PAX_INT32_T,
    H.PAX_UINT32_T,
    H.PAX_INT64_T,
    H.PAX_UINT64_T,
    H.PAX_FLOAT16,
    H.PAX_FLOAT32,
    H.PAX_FLOAT64,
    H.PAX_COMPLEX64,
    H.PAX_COMPLEX128,
    H.PAX_BFLOAT16,
):
    _DTYPE_TO_HANDLE[_PREDEFINED[_h].dtype] = _h


class DatatypeRegistry:
    """Predefined + derived datatype registry.

    One instance per ABI context; derived types allocate user handles above
    the zero page (``handles.make_user_handle``).
    """

    def __init__(self) -> None:
        self._derived: dict[int, TypeDescriptor] = {}
        self._next_index = 0

    # -- queries ------------------------------------------------------------

    def descriptor(self, handle: int) -> TypeDescriptor:
        desc = _PREDEFINED.get(handle)
        if desc is None:
            desc = self._derived.get(handle)
        if desc is None:
            raise PaxError(PAX_ERR_TYPE, H.describe(handle))
        return desc

    def type_size_encoded(self, handle: int) -> int:
        """MPICH-style: bit extraction for fixed-size types (§3.3/§6.1)."""
        if H.datatype_is_fixed_size(handle):
            return H.datatype_encoded_size(handle)
        return self.descriptor(handle).size

    def type_size_lookup(self, handle: int) -> int:
        """Open-MPI-style: always dereference the descriptor (§3.3/§6.1)."""
        return self.descriptor(handle).size

    type_size = type_size_encoded  # ABI default

    def to_dtype(self, handle: int) -> torch.dtype:
        d = self.descriptor(handle)
        if d.dtype is None:
            raise PaxError(PAX_ERR_TYPE, f"{d.name} has no tensor dtype")
        return d.dtype

    def from_array(self, array) -> int:
        """Infer the canonical ABI datatype handle from a tensor's dtype."""
        try:
            return _DTYPE_TO_HANDLE[array.dtype]
        except KeyError:
            raise PaxError(PAX_ERR_TYPE, f"no ABI datatype for dtype {array.dtype}") from None

    # -- derived types --------------------------------------------------------

    def type_contiguous(self, count: int, base: int) -> int:
        H.check_handle(base, H.HandleKind.DATATYPE)
        bdesc = self.descriptor(base)
        handle = H.make_user_handle(H.HandleKind.DATATYPE, self._next_index)
        self._next_index += 1
        self._derived[handle] = TypeDescriptor(
            handle,
            f"contig({count},{bdesc.name})",
            bdesc.size * count,
            bdesc.dtype,
            count=count * bdesc.count,
            base=base,
        )
        return handle

    def type_vector(self, count: int, blocklength: int, stride: int, base: int) -> int:
        H.check_handle(base, H.HandleKind.DATATYPE)
        bdesc = self.descriptor(base)
        handle = H.make_user_handle(H.HandleKind.DATATYPE, self._next_index)
        self._next_index += 1
        self._derived[handle] = TypeDescriptor(
            handle,
            f"vector({count},{blocklength},{stride},{bdesc.name})",
            bdesc.size * count * blocklength,
            bdesc.dtype,
            count=count * blocklength * bdesc.count,
            base=base,
        )
        return handle

    def type_free(self, handle: int) -> None:
        self._derived.pop(handle, None)


def predefined_descriptors() -> dict[int, TypeDescriptor]:
    return dict(_PREDEFINED)
