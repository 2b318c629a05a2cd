"""Integer constants of the PAX ABI (paper §5.4).

The paper prescribes, for the standard MPI ABI:

* integer constants that must have *special* values are unique negative
  numbers, so an implementation can tell the user exactly which constant was
  passed when one is misused (e.g. ``MPI_ANY_TAG`` passed as a rank);
* constants combinable with XOR are powers of two;
* string-length constants take the largest value used by existing
  implementations (8192 for the library-version string; "no issues with this
  value (used by MPICH) have ever been reported");
* for maximum portability no integer constant exceeds 32767 (the smallest
  maximum of ``int`` the C standard guarantees);
* buffer address constants (``MPI_BOTTOM``, ``MPI_IN_PLACE``) must be
  distinguishable from user buffers — here they are unique sentinel objects;
* predefined attribute callbacks are ``0x0`` for the null copy/delete
  functions and ``0xD`` for the dup function.

Everything here is a compile-time constant in the C sense: plain ints known
before any tensor exists, so they bake into the compiled closures exactly like
C constants bake into object code.
"""
from __future__ import annotations

# --------------------------------------------------------------------------
# Unique negative integer constants (each value used exactly once across the
# whole ABI so errors are precisely attributable — paper §5.4).
# --------------------------------------------------------------------------
PAX_ANY_SOURCE = -1
PAX_ANY_TAG = -2
PAX_PROC_NULL = -3
PAX_ROOT = -4
PAX_UNDEFINED = -5
PAX_KEYVAL_INVALID = -6

# --------------------------------------------------------------------------
# XOR-combinable constants: powers of two (paper §5.4, e.g. MPI_MODE_*).
# --------------------------------------------------------------------------
PAX_MODE_NOCHECK = 1
PAX_MODE_NOSTORE = 2
PAX_MODE_NOPUT = 4
PAX_MODE_NOPRECEDE = 8
PAX_MODE_NOSUCCEED = 16

# --------------------------------------------------------------------------
# String length constants (array-declaration suitable; paper §5.4).
# --------------------------------------------------------------------------
PAX_MAX_PROCESSOR_NAME = 256
PAX_MAX_ERROR_STRING = 512
PAX_MAX_OBJECT_NAME = 128
PAX_MAX_LIBRARY_VERSION_STRING = 8192  # the MPICH value the paper keeps

# Largest guaranteed-portable int constant; assert discipline in tests.
PAX_INT_CONSTANT_MAX = 32767

# --------------------------------------------------------------------------
# Buffer address constants. In C these are magic pointers; here they are
# unique sentinel singletons that can never alias a user array.
# --------------------------------------------------------------------------
class _BufferSentinel:
    __slots__ = ("_name",)

    def __init__(self, name: str) -> None:
        self._name = name

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return self._name


PAX_BOTTOM = _BufferSentinel("PAX_BOTTOM")
PAX_IN_PLACE = _BufferSentinel("PAX_IN_PLACE")
PAX_STATUS_IGNORE = _BufferSentinel("PAX_STATUS_IGNORE")
PAX_STATUSES_IGNORE = _BufferSentinel("PAX_STATUSES_IGNORE")

# --------------------------------------------------------------------------
# Predefined attribute callbacks (paper §5.4: "predefined attribute callbacks
# were set to 0x0 for MPI_XXX_NULL_COPY_FN and MPI_XXX_NULL_DELETE_FN, and
# 0xD for MPI_XXX_DUP_FN").
# --------------------------------------------------------------------------
PAX_NULL_COPY_FN = 0x0
PAX_NULL_DELETE_FN = 0x0
PAX_DUP_FN = 0xD

# --------------------------------------------------------------------------
# Threading levels (ordinary small ints; MPI requires them ordered).
# --------------------------------------------------------------------------
PAX_THREAD_SINGLE = 0
PAX_THREAD_FUNNELED = 1
PAX_THREAD_SERIALIZED = 2
PAX_THREAD_MULTIPLE = 3

# The integer-size "ABI string" of §5.1: A{bits-of-Aint}O{bits-of-Offset}.
# JAX arrays index with 64-bit sizes; offsets are 64-bit. One ABI, as the
# paper recommends for all 64-bit platforms.
PAX_ABI_INTEGER_MODEL = "A64O64"
PAX_AINT_BYTES = 8
PAX_OFFSET_BYTES = 8
PAX_COUNT_BYTES = 8  # max(Aint, Offset) per §5.1

PAX_VERSION = (4, 0)  # MPI standard level the ABI surface models
PAX_ABI_VERSION = (1, 0)


def unique_negative_constants() -> dict[str, int]:
    """All special-value integer constants, for uniqueness property tests."""
    return {
        name: value
        for name, value in globals().items()
        if name.startswith("PAX_") and isinstance(value, int) and value < 0
    }


def xor_constants() -> dict[str, int]:
    return {
        name: value
        for name, value in globals().items()
        if name.startswith("PAX_MODE_") and isinstance(value, int)
    }
