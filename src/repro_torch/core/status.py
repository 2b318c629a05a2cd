"""The standard status object (paper §5.2).

::

    typedef struct MPI_Status {
        int MPI_SOURCE;
        int MPI_TAG;
        int MPI_ERROR;
        int mpi_reserved[5];
    } MPI_Status;

32 bytes — "good alignment when arrays of statuses are used, and includes at
least two extra fields more than current implementations".  The reserved
slack is the feature §4.8 gives to tools: interposition layers can hide
state there (``core/interpose.py`` uses reserved[0..1] for a tool id and a
per-call sequence number).

Two concrete representations share the layout:

* :class:`Status` — a NumPy-backed view (host side);
* :func:`traced_status` — an ``(8,) int32`` tensor for device-side code.
"""
from __future__ import annotations

import numpy as np
import torch

STATUS_WORDS = 8
STATUS_BYTES = STATUS_WORDS * 4
N_RESERVED = 5
_IDX_SOURCE, _IDX_TAG, _IDX_ERROR = 0, 1, 2


class Status:
    """A 32-byte status backed by an ``int32[8]`` NumPy buffer."""

    __slots__ = ("_buf",)

    def __init__(self, buf: np.ndarray | None = None) -> None:
        if buf is None:
            buf = np.zeros(STATUS_WORDS, dtype=np.int32)
        if buf.dtype != np.int32 or buf.shape != (STATUS_WORDS,):
            raise ValueError("status buffer must be int32[8]")
        self._buf = buf

    # public fields -----------------------------------------------------
    @property
    def SOURCE(self) -> int:
        return int(self._buf[_IDX_SOURCE])

    @SOURCE.setter
    def SOURCE(self, v: int) -> None:
        self._buf[_IDX_SOURCE] = v

    @property
    def TAG(self) -> int:
        return int(self._buf[_IDX_TAG])

    @TAG.setter
    def TAG(self, v: int) -> None:
        self._buf[_IDX_TAG] = v

    @property
    def ERROR(self) -> int:
        return int(self._buf[_IDX_ERROR])

    @ERROR.setter
    def ERROR(self, v: int) -> None:
        self._buf[_IDX_ERROR] = v

    # reserved slack (tool-visible, §4.8) --------------------------------
    def get_reserved(self, i: int) -> int:
        if not 0 <= i < N_RESERVED:
            raise IndexError(i)
        return int(self._buf[3 + i])

    def set_reserved(self, i: int, v: int) -> None:
        if not 0 <= i < N_RESERVED:
            raise IndexError(i)
        self._buf[3 + i] = v

    # layout ------------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return int(self._buf.nbytes)

    def raw(self) -> np.ndarray:
        return self._buf

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Status(SOURCE={self.SOURCE}, TAG={self.TAG}, ERROR={self.ERROR}, "
            f"reserved={[self.get_reserved(i) for i in range(N_RESERVED)]})"
        )


def status_array(n: int) -> np.ndarray:
    """A contiguous array of n statuses: shape (n, 8) int32 — 32n bytes, the
    alignment property §5.2 calls out for arrays of statuses."""
    return np.zeros((n, STATUS_WORDS), dtype=np.int32)


def status_view(arr: np.ndarray, i: int) -> Status:
    return Status(arr[i])


def traced_status(source: int = -1, tag: int = -1, error: int = 0,
                  device=None) -> torch.Tensor:
    """Status as an ``(8,) int32`` tensor (device-resident statuses)."""
    base = torch.zeros((STATUS_WORDS,), dtype=torch.int32, device=device)
    base[_IDX_SOURCE] = source
    base[_IDX_TAG] = tag
    base[_IDX_ERROR] = error
    return base
