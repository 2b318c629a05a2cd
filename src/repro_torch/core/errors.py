"""Error codes and error classes of the PAX ABI.

``PAX_SUCCESS`` is 0 (the MPI requirement the paper leans on for the
translation fast path: *"success is the common case, so static inline it"*
— §6.2 Mukautuva listing, ``RETURN_CODE_IMPL_TO_MUK``).

Error *classes* are small positive ints below ``PAX_INT_CONSTANT_MAX``.
Foreign backends (``backends/ompix.py``) use their own numbering; the
Mukautuva layer translates through :func:`ErrorTranslator.to_abi` with the
same shape as the paper's listing: a ``static inline`` zero check followed by
an out-of-line table lookup.
"""
from __future__ import annotations

from typing import Mapping

PAX_SUCCESS = 0
PAX_ERR_BUFFER = 1
PAX_ERR_COUNT = 2
PAX_ERR_TYPE = 3
PAX_ERR_TAG = 4
PAX_ERR_COMM = 5
PAX_ERR_RANK = 6
PAX_ERR_REQUEST = 7
PAX_ERR_ROOT = 8
PAX_ERR_GROUP = 9
PAX_ERR_OP = 10
PAX_ERR_TOPOLOGY = 11
PAX_ERR_DIMS = 12
PAX_ERR_ARG = 13
PAX_ERR_UNKNOWN = 14
PAX_ERR_TRUNCATE = 15
PAX_ERR_OTHER = 16
PAX_ERR_INTERN = 17
PAX_ERR_PENDING = 18
PAX_ERR_IN_STATUS = 19
PAX_ERR_KEYVAL = 20
PAX_ERR_NO_MEM = 21
PAX_ERR_INFO = 22
PAX_ERR_UNSUPPORTED_OPERATION = 23
# Fault tier (ULFM-style, "The Case for ABI Interoperability in a Fault
# Tolerant MPI"): a peer process is known dead / the communicator has been
# revoked.  Below PAX_ERR_LASTCODE like every other class; backends that
# lack the fault symbols never return these (the ABI's recipes raise them).
PAX_ERR_PROC_FAILED = 24
PAX_ERR_REVOKED = 25
# Transport-integrity tier: the wire itself misbehaving, short of a
# rank death.  DATA_CORRUPTION is raised when the opt-in end-to-end integrity
# mode (checksummed plan/group closures, ``PaxABI(integrity=True)``) detects
# a payload that does not agree across the communicator; TIMEOUT is raised by
# the ``wait`` family when a ``timeout_s`` deadline passes before a dropped
# operation completes — the only way a *drop* (a hang, not an error) ever
# surfaces.  Both are below PAX_ERR_LASTCODE like every other class.
PAX_ERR_DATA_CORRUPTION = 26
PAX_ERR_TIMEOUT = 27
PAX_ERR_LASTCODE = 64

_ERROR_NAMES = {
    value: name
    for name, value in list(globals().items())
    if name.startswith("PAX_ERR_") or name == "PAX_SUCCESS"
}


def error_string(code: int) -> str:
    """``MPI_Error_string`` analogue."""
    return _ERROR_NAMES.get(code, f"PAX_ERR_UNKNOWN({code})")


class PaxError(RuntimeError):
    """Raised where C MPI would return a nonzero error code.

    The ABI surface (``core/abi.py``) converts backend error codes into this
    exception when the installed error handler is ``PAX_ERRORS_ARE_FATAL``
    (the default, as in MPI on PAX_COMM_WORLD-equivalents), and returns codes
    when it is ``PAX_ERRORS_RETURN``.
    """

    def __init__(self, code: int, detail: str = "") -> None:
        self.code = code
        msg = error_string(code)
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)


class IncompleteValue:
    """Sentinel standing in for the result of an operation that will never
    complete: a *dropped* message (``FaultSchedule`` mode ``drop``).

    A drop is a hang, not an error — no backend return code carries it, so
    the injection layer plants this sentinel as the operation's value and the
    ``wait`` family is the only place it is ever observed: ``wait`` with a
    ``timeout_s`` sleeps out the deadline and raises
    :data:`PAX_ERR_TIMEOUT`; ``wait`` without one blocks forever (the
    faithful semantics).  The request stays *active* across the timeout so
    ``Plan.reset``/``PlanGroup.reset`` can abort and re-arm the slot.
    """

    __slots__ = ("detail",)

    def __init__(self, detail: str = "") -> None:
        self.detail = detail

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"IncompleteValue({self.detail!r})"

    def __getitem__(self, _key):
        # Recipe post-processing slices dependency outputs (drop the invented
        # padding, unwrap a scalar); an incomplete result stays incomplete
        # through any such slice so composed emulation chains propagate the
        # sentinel to the wait that will time it out.
        return self


class ErrorTranslator:
    """IMPL→ABI error-code translation (paper §6.2 listing).

    The zero fast path is inlined at every call site by construction (a
    Python ``if`` — the analogue of the paper's ``static inline`` wrapper);
    the table lookup happens only on errors.
    """

    def __init__(self, impl_to_abi: Mapping[int, int]) -> None:
        if any(k == 0 for k in impl_to_abi):
            raise ValueError("0 is PAX_SUCCESS in every convention")
        self._table = dict(impl_to_abi)

    def to_abi(self, impl_code: int) -> int:
        if impl_code == 0:  # success fast path
            return PAX_SUCCESS
        return self._table.get(impl_code, PAX_ERR_UNKNOWN)
