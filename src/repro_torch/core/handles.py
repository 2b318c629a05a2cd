"""The 10-bit Huffman handle code of the PAX ABI (paper §5.4 + Appendix A).

Bit-for-bit mirror of the paper's proposal:

* Handles are small scalar tokens. ``0`` is **always invalid**, so
  uninitialized handles are detectable errors rather than legal nulls.
* All predefined constants fit in 10 bits — the "zero page" — so
  implementations that heap-allocate user handles never collide with them.
* *Null* handles are the non-zero bits of the handle kind followed by zeros.
* Handle kind is decodable from the bit pattern alone with a bitmask
  ("the modified Huffman encoding enables fast error checking by
  implementations, simply by applying a bitmask").
* Half the code space (prefix ``0b10``) is reserved for datatypes.
  Fixed-size datatypes (prefix ``0b1001``) encode ``log2(size)`` in bits
  3..5; variable-size C types (prefix ``0b1000``) do not, so their constant
  values are not a function of the platform ABI.
* Intentional gaps ("reserved") leave room for future extensions without
  breaking changes.  This module allocates three such slots for accelerator dtypes
  (bfloat16, float8_e4m3, float8_e5m2) inside reserved ranges — exactly the
  extension mechanism the paper designed for.

User (non-predefined) handles live strictly above the zero page and also
encode their kind, MPICH-style, so conversions and error checks stay O(1).

**Zero-page kind table.**  Because the entire predefined constant space is
10 bits, every per-call classification query over it can be answered by one
index into a precomputed 1024-entry table instead of re-running the mask
chain (and, for the ``0b01`` object page, a linear range scan) on every
call.  :data:`ZERO_PAGE_KINDS` and :data:`ZERO_PAGE_IS_NULL` are those
tables, materialized once at import from the same bit rules the paper
specifies — the bitmask logic stays the *definition* (kept in
``_classify_zero_page`` and verified against the table by the test suite);
the table is the *dispatch* representation.  ``handle_kind``,
``check_handle`` and ``is_null`` are therefore one list index for any
predefined handle; user handles still decode by bitmask.  Init-time
specialized layers (``PaxABI._specialize``, Mukautuva's predefined-handle
pages) index these tables directly.
"""
from __future__ import annotations

import enum
from typing import Iterator

ZERO_PAGE_BITS = 10
ZERO_PAGE_SIZE = 1 << ZERO_PAGE_BITS  # 1024

# ---------------------------------------------------------------------------
# Handle kinds
# ---------------------------------------------------------------------------


class HandleKind(enum.IntEnum):
    INVALID = 0
    OP = 1
    COMM = 2
    GROUP = 3
    WIN = 4
    FILE = 5
    SESSION = 6
    MESSAGE = 7
    ERRHANDLER = 8
    REQUEST = 9
    DATATYPE = 10
    INFO = 11


# ---------------------------------------------------------------------------
# Appendix A.1 — operations: prefix 0b00001 (values 32..63)
# ---------------------------------------------------------------------------
PAX_OP_NULL = 0b0000100000  # 32
# arithmetic ops
PAX_SUM = 0b0000100001  # 33
PAX_MIN = 0b0000100010  # 34
PAX_MAX = 0b0000100011  # 35
PAX_PROD = 0b0000100100  # 36
# 0b00001001xx reserved arithmetic (37..39)
# binary ops
PAX_BAND = 0b0000101000  # 40
PAX_BOR = 0b0000101001  # 41
PAX_BXOR = 0b0000101010  # 42
# 0b000010xxxx reserved bit ops (43..47)
# logical ops
PAX_LAND = 0b0000110000  # 48
PAX_LOR = 0b0000110001  # 49
PAX_LXOR = 0b0000110010  # 50
# 0b000011xxxx reserved logical ops (51..55)
PAX_MINLOC = 0b0000111000  # 56
PAX_MAXLOC = 0b0000111001  # 57
# 0b00001110xx reserved other op (58..59)
PAX_REPLACE = 0b0000111100  # 60
PAX_NO_OP = 0b0000111101  # 61
# 0b000011111x reserved other op (62..63)

_OP_MASK = 0b1111100000
_OP_PREFIX = 0b0000100000

# ---------------------------------------------------------------------------
# Appendix A.2 — other opaque handles: prefix 0b01 (values 256..511)
# ---------------------------------------------------------------------------
# communicator
PAX_COMM_NULL = 0b0100000000  # 256
PAX_COMM_WORLD = 0b0100000001  # 257
PAX_COMM_SELF = 0b0100000010  # 258
# 0b0100000011 reserved comm (259)
# group
PAX_GROUP_NULL = 0b0100000100  # 260
PAX_GROUP_EMPTY = 0b0100000101  # 261
# 0b01000001xx reserved group (262..263)
# windows
PAX_WIN_NULL = 0b0100001000  # 264
# 0b01000010xx reserved win (265..267)
# file
PAX_FILE_NULL = 0b0100001100  # 268
# 0b01000011xx reserved file (269..271)
# session
PAX_SESSION_NULL = 0b0100010000  # 272
# message
PAX_MESSAGE_NULL = 0b0100010100  # 276
PAX_MESSAGE_NO_PROC = 0b0100010101  # 277
# 0b01000101xx reserved message (278..279)
# error handler
PAX_ERRHANDLER_NULL = 0b0100011000  # 280
PAX_ERRORS_ARE_FATAL = 0b0100011001  # 281
PAX_ERRORS_RETURN = 0b0100011010  # 282
PAX_ERRORS_ABORT = 0b0100011011  # 283
# 0b01000111xx reserved handle (284..287)
# requests
PAX_REQUEST_NULL = 0b0100100000  # 288
# 0b01001000xx reserved request (289..291)
# info (extension in the 0b01xxxxxxxx reserved space, range 296..299)
PAX_INFO_NULL = 0b0100101000  # 296
PAX_INFO_ENV = 0b0100101001  # 297

# sub-range masks for the 0b01 page (kind = bits 2..5 within the page)
_OBJ_PAGE_MASK = 0b1100000000
_OBJ_PAGE_PREFIX = 0b0100000000

_OBJ_KIND_RANGES: list[tuple[int, int, HandleKind]] = [
    (0b0100000000, 0b0100000100, HandleKind.COMM),
    (0b0100000100, 0b0100001000, HandleKind.GROUP),
    (0b0100001000, 0b0100001100, HandleKind.WIN),
    (0b0100001100, 0b0100010000, HandleKind.FILE),
    (0b0100010000, 0b0100010100, HandleKind.SESSION),
    (0b0100010100, 0b0100011000, HandleKind.MESSAGE),
    (0b0100011000, 0b0100100000, HandleKind.ERRHANDLER),
    (0b0100100000, 0b0100101000, HandleKind.REQUEST),
    (0b0100101000, 0b0100110000, HandleKind.INFO),
]

# ---------------------------------------------------------------------------
# Appendix A.3 — datatypes: prefix 0b10 (values 512..1023)
# ---------------------------------------------------------------------------
PAX_DATATYPE_NULL = 0b1000000000  # 512

# variable-size C types: prefix 0b1000 — size NOT encoded (platform-dependent)
PAX_AINT = 0b1000000001  # 513
PAX_COUNT = 0b1000000010  # 514
PAX_OFFSET = 0b1000000011  # 515
# 0b100000010x reserved (516..517), 518 reserved
PAX_PACKED = 0b1000000111  # 519
PAX_SHORT = 0b1000001000  # 520
PAX_INT = 0b1000001001  # 521
PAX_LONG = 0b1000001010  # 522
PAX_LONG_LONG = 0b1000001011  # 523
PAX_UNSIGNED_SHORT = 0b1000001100  # 524
PAX_UNSIGNED_INT = 0b1000001101  # 525
PAX_UNSIGNED_LONG = 0b1000001110  # 526
PAX_UNSIGNED_LONG_LONG = 0b1000001111  # 527
PAX_FLOAT = 0b1000010000  # 528
PAX_DOUBLE = 0b1000010001  # 529 (next in sequence after the paper's excerpt)
PAX_LONG_DOUBLE = 0b1000010010  # 530
PAX_C_BOOL = 0b1000010011  # 531

# fixed-size types: prefix 0b1001, log2(size) in bits 3..5
PAX_INT8_T = 0b1001000000  # 576
PAX_UINT8_T = 0b1001000001  # 577
PAX_FLOAT8_E5M2 = 0b1001000010  # 578  (paper's "<float 8b>" slot)
PAX_CHAR = 0b1001000011  # 579
PAX_SIGNED_CHAR = 0b1001000100  # 580
PAX_UNSIGNED_CHAR = 0b1001000101  # 581
PAX_FLOAT8_E4M3 = 0b1001000110  # 582  (reserved slot -> accelerator extension)
PAX_BYTE = 0b1001000111  # 583
PAX_INT16_T = 0b1001001000  # 584
PAX_UINT16_T = 0b1001001001  # 585
PAX_FLOAT16 = 0b1001001010  # 586  (paper's "<float 16b>")
PAX_C_COMPLEX_2X8 = 0b1001001011  # 587
PAX_BFLOAT16 = 0b1001001100  # 588  (reserved 0b10010011xx slot -> accelerator extension)
PAX_CXX_COMPLEX_2X8 = 0b1001001111  # 591
PAX_INT32_T = 0b1001010000  # 592
PAX_UINT32_T = 0b1001010001  # 593
PAX_FLOAT32 = 0b1001010010  # 594  (paper's "<C float 32b>")
PAX_C_COMPLEX_2X16 = 0b1001010011  # 595
PAX_INT64_T = 0b1001011000  # 600
PAX_UINT64_T = 0b1001011001  # 601
PAX_FLOAT64 = 0b1001011010  # 602  (paper's "<C float64>")
PAX_COMPLEX64 = 0b1001011011  # 603  (paper's "<C complex 2x32b>")
PAX_COMPLEX128 = 0b1001100011  # 611  (2x64b, same offset pattern, size group 16)

_DTYPE_PAGE_MASK = 0b1100000000
_DTYPE_PAGE_PREFIX = 0b1000000000
_DTYPE_FIXED_MASK = 0b1111000000
_DTYPE_FIXED_PREFIX = 0b1001000000
_DTYPE_VARIABLE_PREFIX = 0b1000000000

# ---------------------------------------------------------------------------
# Null handles: kind prefix followed by zeros (paper §5.4)
# ---------------------------------------------------------------------------
NULL_HANDLES: dict[HandleKind, int] = {
    HandleKind.OP: PAX_OP_NULL,
    HandleKind.COMM: PAX_COMM_NULL,
    HandleKind.GROUP: PAX_GROUP_NULL,
    HandleKind.WIN: PAX_WIN_NULL,
    HandleKind.FILE: PAX_FILE_NULL,
    HandleKind.SESSION: PAX_SESSION_NULL,
    HandleKind.MESSAGE: PAX_MESSAGE_NULL,
    HandleKind.ERRHANDLER: PAX_ERRHANDLER_NULL,
    HandleKind.REQUEST: PAX_REQUEST_NULL,
    HandleKind.DATATYPE: PAX_DATATYPE_NULL,
    HandleKind.INFO: PAX_INFO_NULL,
}

# ---------------------------------------------------------------------------
# User handles (above the zero page, kind-encoded, MPICH-style)
# ---------------------------------------------------------------------------
_USER_BIT = 1 << 30
_USER_KIND_SHIFT = 24
_USER_INDEX_MASK = (1 << _USER_KIND_SHIFT) - 1


def make_user_handle(kind: HandleKind, index: int) -> int:
    """Allocate-encode a non-predefined handle.

    Encodes the kind in the upper bits (so ``handle_kind`` stays a bitmask
    check) and an allocation index in the lower 24 bits.  Values are far
    above the zero page, so they can never collide with predefined constants
    — the property the paper's 10-bit code was designed to guarantee.
    """
    if not 0 <= index <= _USER_INDEX_MASK:
        raise ValueError(f"user handle index out of range: {index}")
    if kind in (HandleKind.INVALID,):
        raise ValueError("cannot allocate INVALID handles")
    return _USER_BIT | (int(kind) << _USER_KIND_SHIFT) | index


def is_user_handle(handle: int) -> bool:
    return bool(handle & _USER_BIT)


def user_handle_index(handle: int) -> int:
    if not is_user_handle(handle):
        raise ValueError(f"not a user handle: {handle:#x}")
    return handle & _USER_INDEX_MASK


def is_predefined(handle: int) -> bool:
    return 0 <= handle < ZERO_PAGE_SIZE


# ---------------------------------------------------------------------------
# Classification.  The bitmask logic below is the *definition* (pure bit
# rules, as the paper requires); the zero-page tables materialize it once at
# import so the per-call query is a single list index.
# ---------------------------------------------------------------------------


def _classify_zero_page(handle: int) -> HandleKind:
    """The paper's bitmask classification of a zero-page value (0..1023)."""
    if handle <= 0:
        return HandleKind.INVALID
    if (handle & _OP_MASK) == _OP_PREFIX:
        return HandleKind.OP
    if (handle & _DTYPE_PAGE_MASK) == _DTYPE_PAGE_PREFIX:
        return HandleKind.DATATYPE
    if (handle & _OBJ_PAGE_MASK) == _OBJ_PAGE_PREFIX:
        for lo, hi, kind in _OBJ_KIND_RANGES:
            if lo <= handle < hi:
                return kind
        return HandleKind.INVALID  # reserved object range
    return HandleKind.INVALID  # reserved 0b00... space


#: kind of every zero-page value, one list index per query (import-time
#: materialization of the mask chain above)
ZERO_PAGE_KINDS: tuple[HandleKind, ...] = tuple(
    _classify_zero_page(h) for h in range(ZERO_PAGE_SIZE)
)

_NULL_SET = frozenset(NULL_HANDLES.values())

#: null-ness of every zero-page value (all null handles are predefined)
ZERO_PAGE_IS_NULL: tuple[bool, ...] = tuple(
    h in _NULL_SET for h in range(ZERO_PAGE_SIZE)
)


def handle_kind(handle: int) -> HandleKind:
    """Decode the kind of a handle from its bit pattern alone.

    Zero-page (predefined) handles resolve through the precomputed kind
    table; user handles decode their kind field by bitmask.
    """
    if 0 <= handle < ZERO_PAGE_SIZE:
        return ZERO_PAGE_KINDS[handle]
    if handle > 0 and handle & _USER_BIT:
        kind_bits = (handle >> _USER_KIND_SHIFT) & 0xF
        try:
            return HandleKind(kind_bits)
        except ValueError:
            return HandleKind.INVALID
    return HandleKind.INVALID


def is_null(handle: int) -> bool:
    """Null handles are kind-prefix || zeros (plus MESSAGE_NO_PROC is not null)."""
    return 0 <= handle < ZERO_PAGE_SIZE and ZERO_PAGE_IS_NULL[handle]


def check_handle(handle: int, expected: HandleKind) -> None:
    """The fast error check the Huffman code enables (table index + compare)."""
    if handle_kind(handle) is not expected:
        from .errors import PAX_ERR_ARG, PaxError

        raise PaxError(
            PAX_ERR_ARG,
            f"expected {expected.name} handle, got {describe(handle)}",
        )


# ---------------------------------------------------------------------------
# Datatype bit queries (paper §5.4 / A.3)
# ---------------------------------------------------------------------------


def datatype_is_fixed_size(handle: int) -> bool:
    return (handle & _DTYPE_FIXED_MASK) == _DTYPE_FIXED_PREFIX


def datatype_is_variable_size(handle: int) -> bool:
    return (
        (handle & _DTYPE_PAGE_MASK) == _DTYPE_PAGE_PREFIX
        and not datatype_is_fixed_size(handle)
        and handle != PAX_DATATYPE_NULL
    )


def datatype_log2_size(handle: int) -> int:
    """log2(size in bytes), encoded in bits 3..5 of fixed-size handles.

    The MPICH-heritage trick (§3.3 ``MPIR_Datatype_get_basic_size``) carried
    into the standard ABI: a pure bit extraction, no memory access.
    """
    if not datatype_is_fixed_size(handle):
        raise ValueError(f"size not encoded in handle {handle:#b}")
    return (handle >> 3) & 0b111


def datatype_encoded_size(handle: int) -> int:
    """Size in bytes of a fixed-size datatype, from the handle bits alone."""
    return 1 << datatype_log2_size(handle)


# ---------------------------------------------------------------------------
# Names / introspection
# ---------------------------------------------------------------------------

PREDEFINED_NAMES: dict[int, str] = {
    value: name
    for name, value in list(globals().items())
    if name.startswith("PAX_") and isinstance(value, int) and 0 < value < ZERO_PAGE_SIZE
}


def describe(handle: int) -> str:
    """Human-readable description — 'tell the user by name what constant they
    passed' (paper §5.4)."""
    if handle in PREDEFINED_NAMES:
        return PREDEFINED_NAMES[handle]
    if handle == 0:
        return "INVALID(0, uninitialized)"
    if is_user_handle(handle):
        kind = handle_kind(handle)
        return f"user-{kind.name.lower()}-handle#{user_handle_index(handle)}"
    return f"invalid-handle({handle:#x})"


def iter_predefined(kind: HandleKind) -> Iterator[int]:
    for value in sorted(PREDEFINED_NAMES):
        if handle_kind(value) == kind:
            yield value


PREDEFINED_OPS = tuple(
    h for h in sorted(PREDEFINED_NAMES) if handle_kind(h) == HandleKind.OP
)
PREDEFINED_DATATYPES = tuple(
    h for h in sorted(PREDEFINED_NAMES) if handle_kind(h) == HandleKind.DATATYPE
)
