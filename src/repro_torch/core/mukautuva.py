"""Mukautuva — the external ABI translation layer (paper §6.2).

The port of ``repro.core.mukautuva``.  "Adaptable" in Finnish: a standalone
layer that makes a *foreign-convention* implementation (here
:mod:`repro_torch.core.backends.ompix`, the Open-MPI analogue) speak the
standard ABI without any change to the implementation itself.

The layer is produced *mechanically*, one wrapper per entry point of the
standard function table: **every WRAP_* method, every persistent ``plan_*``
hook and every ``plan_group_*`` hook is generated from the declarative spec**
(:mod:`repro_torch.core.abi_spec`) — the entry's argument domains decide the
CONVERT_* calls, its ``muk_ret`` decides the return-code protocol, and its
``temps`` flag decides whether converted handle vectors are stashed for the
request map.  Nothing per collective is written by hand.

Faithful to the paper's structure:

* ``CONVERT_*`` handle conversion with fast paths for the predefined
  handles — comms keep the WORLD/SELF/NULL ``if`` chain of the §6.2 listing;
  ops and datatypes index **zero-page flat arrays** built once at init — and
  a dict table for user (heap) handles only;
* an **O(1) reverse map** (impl datatype → ABI handle) kept at registration
  time; the first registration wins for aliased predefined handles
  (``PAX_CHAR`` and ``PAX_INT8_T`` both map to the impl's int8);
* return-code translation with an inlined success fast path, through an
  :class:`~repro_torch.core.errors.ErrorTranslator` from ``OMPIX_ERR_*`` to
  ``PAX_ERR_*``;
* **callback trampolines**: a user reduction op registered against the ABI
  is handed to the foreign implementation as a wrapper that converts
  impl-domain handles back to ABI handles before calling user code;
* a **request map**: the converted datatype vectors of ``alltoallw`` ride
  the request (``Request.temp_state``) until ``wait`` drops them;
* status-layout conversion (ompix's OMPI-style status → the standard
  32-byte status);
* capability answers for negotiation: :meth:`MukBackend.supports` reports
  whether the foreign library exports an entry's symbol, so ``reduce``,
  ``gather`` and the fault tier (which ``libompix`` lacks) are emulated
  above the layer.

Communicators: the foreign library's communicator objects carry the process
group of the ABI context's own table (``CommTable.group_for``, bound at
construction), so the layer adds no ``torch.distributed`` group.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Optional, Sequence

from . import abi_spec
from . import handles as H
from .backends import ompix as ox
from .backends.base import Backend
from .communicator import CommTable
from .datatypes import DatatypeRegistry
from .errors import (
    PAX_ERR_ARG,
    PAX_ERR_COMM,
    PAX_ERR_COUNT,
    PAX_ERR_INTERN,
    PAX_ERR_OP,
    PAX_ERR_PROC_FAILED,
    PAX_ERR_RANK,
    PAX_ERR_REVOKED,
    PAX_ERR_TYPE,
    PAX_ERR_UNSUPPORTED_OPERATION,
    ErrorTranslator,
    PaxError,
)
from .ops import OpRegistry
from .status import Status

#: the foreign library's error codes -> the standard classes
OMPIX_TO_PAX = {
    ox.OMPIX_ERR_ARG: PAX_ERR_ARG,
    ox.OMPIX_ERR_COMM: PAX_ERR_COMM,
    ox.OMPIX_ERR_TYPE: PAX_ERR_TYPE,
    ox.OMPIX_ERR_OP: PAX_ERR_OP,
    ox.OMPIX_ERR_UNSUPPORTED: PAX_ERR_UNSUPPORTED_OPERATION,
    ox.OMPIX_ERR_COUNT: PAX_ERR_COUNT,
    ox.OMPIX_ERR_RANK: PAX_ERR_RANK,
    ox.OMPIX_ERR_INTERN: PAX_ERR_INTERN,
    # fault-tier rc translation: a fault-injecting foreign lib reports dead
    # peers / revoked comms in its own numbering
    ox.OMPIX_ERR_PROC_FAILED: PAX_ERR_PROC_FAILED,
    ox.OMPIX_ERR_REVOKED: PAX_ERR_REVOKED,
}


class MukBackend(Backend):
    """The ABI-side adapter: Backend interface in ABI handle domain,
    delegating to a foreign library through conversions."""

    convention = "foreign"
    name = "mukautuva"

    def __init__(self, lib: ox.OmpixLib, mesh=None) -> None:
        super().__init__(mesh if mesh is not None else lib.mesh)
        self.lib = lib
        self.name = f"muk:{lib.name}"
        # loss capability crosses the layer with the library (a wrapped
        # FaultyLib can drop): it decides the ABI's drop-sentinel guard
        self.can_lose_messages = bool(getattr(lib, "can_lose_messages", False))
        # ABI-domain tables owned by the context; Mukautuva keeps its own so
        # it can translate without asking the implementation anything.
        self.comms = CommTable(self.mesh)
        self.ops = OpRegistry()
        self.datatypes = DatatypeRegistry()
        lib.bind_groups(self.comms.group_for)
        # user-handle conversion tables (ABI handle -> impl object)
        self._comm_table: dict[int, ox.OmpixComm] = {}
        self._op_table: dict[int, ox.OmpixOp] = {}
        self._dtype_table: dict[int, ox.OmpixDatatype] = {}
        self._predef_ops = self._build_predef_op_map()
        self._predef_dtypes = self._build_predef_dtype_map()
        # the §6.2 "compile-time knowledge of both ABIs", materialized:
        # zero-page-indexed flat arrays built once, so a predefined handle
        # converts with one list index (no hashing, no if-chain)
        self._predef_op_page: list = [None] * H.ZERO_PAGE_SIZE
        for _h, _obj in self._predef_ops.items():
            self._predef_op_page[_h] = _obj
        self._predef_dtype_page: list = [None] * H.ZERO_PAGE_SIZE
        for _h, _obj in self._predef_dtypes.items():
            self._predef_dtype_page[_h] = _obj
        # O(1) reverse conversion (impl dtype object -> ABI handle); first
        # registration wins for aliased predefined handles
        self._dtype_rev: dict[ox.OmpixDatatype, int] = {}
        for abi_h, obj in self._predef_dtypes.items():
            self._dtype_rev.setdefault(obj, abi_h)
        self.errors = ErrorTranslator(OMPIX_TO_PAX)
        self.last_alltoallw_temps: Any = None
        self.last_status: Optional[Status] = None

    # ------------------------------------------------------------------
    # capability negotiation: does the foreign library export the symbol?
    # ------------------------------------------------------------------
    def supports(self, entry: abi_spec.AbiEntry) -> bool:
        return hasattr(self.lib, entry.impl_name)

    def capability(self, entry: abi_spec.AbiEntry) -> dict:
        """Capability info across the layer: the report names the foreign
        symbol that was (or was not) resolved, so ``PaxABI.capabilities()``
        tells "``libompix`` exports ``Allreduce``" from "the ABI layer
        emulated ``reduce`` because there is no ``Reduce`` symbol"."""
        info = {
            "backend": self.name,
            "native": self.supports(entry),
            "impl": self.lib.name,
            "impl_symbol": entry.impl_name,
        }
        if entry.persistent:
            info["group_hook"] = self.supports_persistent_group(entry)
        return info

    def release(self) -> None:
        self._comm_table.clear()
        self.lib.release()

    # -- fault model: the failure detector lives in the foreign library (a
    # fault-injecting one reports its killed rank); a quiet library reports
    # nothing and the fault tier stays a set of cheap no-ops
    def local_failed(self, comm: int) -> tuple:
        fn = getattr(self.lib, "local_failed", None)
        return tuple(fn(comm)) if fn is not None else ()

    def heartbeat_silent(self, comm: int) -> tuple:
        fn = getattr(self.lib, "heartbeat_silent", None)
        return tuple(fn(comm)) if fn is not None else ()

    # ------------------------------------------------------------------
    # predefined-handle maps (the compile-time knowledge of both ABIs)
    # ------------------------------------------------------------------
    def _build_predef_op_map(self) -> dict[int, ox.OmpixOp]:
        g = self.lib.op_globals
        return {
            H.PAX_SUM: g["OMPIX_SUM"],
            H.PAX_MIN: g["OMPIX_MIN"],
            H.PAX_MAX: g["OMPIX_MAX"],
            H.PAX_PROD: g["OMPIX_PROD"],
            H.PAX_BAND: g["OMPIX_BAND"],
            H.PAX_BOR: g["OMPIX_BOR"],
            H.PAX_BXOR: g["OMPIX_BXOR"],
            H.PAX_LAND: g["OMPIX_LAND"],
            H.PAX_LOR: g["OMPIX_LOR"],
            H.PAX_LXOR: g["OMPIX_LXOR"],
            H.PAX_MINLOC: g["OMPIX_MINLOC"],
            H.PAX_MAXLOC: g["OMPIX_MAXLOC"],
            H.PAX_REPLACE: g["OMPIX_REPLACE"],
            H.PAX_NO_OP: g["OMPIX_NO_OP"],
        }

    def _build_predef_dtype_map(self) -> dict[int, ox.OmpixDatatype]:
        g = self.lib.dtype_globals
        m = {
            H.PAX_DATATYPE_NULL: g["OMPIX_DATATYPE_NULL"],
            H.PAX_INT8_T: g["OMPIX_INT8"],
            H.PAX_UINT8_T: g["OMPIX_UINT8"],
            H.PAX_CHAR: g["OMPIX_INT8"],
            H.PAX_SIGNED_CHAR: g["OMPIX_INT8"],
            H.PAX_UNSIGNED_CHAR: g["OMPIX_UINT8"],
            H.PAX_BYTE: g["OMPIX_BYTE"],
            H.PAX_INT16_T: g["OMPIX_INT16"],
            H.PAX_UINT16_T: g["OMPIX_UINT16"],
            H.PAX_FLOAT16: g["OMPIX_FLOAT16"],
            H.PAX_INT32_T: g["OMPIX_INT32"],
            H.PAX_UINT32_T: g["OMPIX_UINT32"],
            H.PAX_FLOAT32: g["OMPIX_FLOAT"],
            H.PAX_FLOAT: g["OMPIX_FLOAT"],
            H.PAX_INT64_T: g["OMPIX_INT64"],
            H.PAX_UINT64_T: g["OMPIX_UINT64"],
            H.PAX_FLOAT64: g["OMPIX_DOUBLE"],
            H.PAX_DOUBLE: g["OMPIX_DOUBLE"],
            H.PAX_INT: g["OMPIX_INT32"],
            H.PAX_LONG: g["OMPIX_INT64"],
            H.PAX_LONG_LONG: g["OMPIX_INT64"],
            H.PAX_SHORT: g["OMPIX_INT16"],
            H.PAX_UNSIGNED_SHORT: g["OMPIX_UINT16"],
            H.PAX_UNSIGNED_INT: g["OMPIX_UINT32"],
            H.PAX_UNSIGNED_LONG: g["OMPIX_UINT64"],
            H.PAX_UNSIGNED_LONG_LONG: g["OMPIX_UINT64"],
            H.PAX_AINT: g["OMPIX_INT64"],
            H.PAX_COUNT: g["OMPIX_INT64"],
            H.PAX_OFFSET: g["OMPIX_INT64"],
            H.PAX_COMPLEX64: g["OMPIX_COMPLEX64"],
            H.PAX_COMPLEX128: g["OMPIX_COMPLEX128"],
        }
        if "OMPIX_BFLOAT16" in g:
            m[H.PAX_BFLOAT16] = g["OMPIX_BFLOAT16"]
        return m

    # ------------------------------------------------------------------
    # CONVERT_* (paper §6.2 listing shape: predefined fast path, then table)
    # ------------------------------------------------------------------
    def _convert_comm(self, comm: int) -> ox.OmpixComm:
        # revoked-comm gate first: Mukautuva's comm table mirrors the ABI
        # CommTable, so revocation state lives there (one empty-set membership
        # test — the conversion below already hashes, this adds no lookup
        # class the path didn't have).  Fault-tier entries never convert
        # comms through here; they act on the ABI-side table directly.
        if comm in self.comms.revoked:
            raise PaxError(PAX_ERR_REVOKED, H.describe(comm))
        if comm == H.PAX_COMM_WORLD:
            return self.lib.comm_world
        if comm == H.PAX_COMM_SELF:
            return self.lib.comm_self
        if comm == H.PAX_COMM_NULL:
            return self.lib.comm_null
        try:
            return self._comm_table[comm]
        except KeyError:
            raise PaxError(PAX_ERR_COMM, H.describe(comm)) from None

    def _convert_op(self, op: int) -> ox.OmpixOp:
        if 0 <= op < H.ZERO_PAGE_SIZE:
            impl = self._predef_op_page[op]
            if impl is not None:
                return impl
            raise PaxError(PAX_ERR_OP, H.describe(op))  # reserved/null slot
        try:
            return self._op_table[op]
        except KeyError:
            raise PaxError(PAX_ERR_OP, H.describe(op)) from None

    def _convert_dtype(self, dt: int) -> ox.OmpixDatatype:
        if 0 <= dt < H.ZERO_PAGE_SIZE:
            impl = self._predef_dtype_page[dt]
            if impl is not None:
                return impl
            raise PaxError(PAX_ERR_TYPE, H.describe(dt))  # reserved slot
        try:
            return self._dtype_table[dt]
        except KeyError:
            raise PaxError(PAX_ERR_TYPE, H.describe(dt)) from None

    def _dtype_to_abi(self, impl_dt: ox.OmpixDatatype) -> int:
        """Reverse conversion, needed inside callback trampolines.  O(1):
        the reverse dict is maintained at registration time."""
        return self._dtype_rev.get(impl_dt, H.PAX_DATATYPE_NULL)

    def _rc(self, code: int) -> None:
        if code == 0:  # success fast path (inline)
            return
        raise PaxError(self.errors.to_abi(code), f"{self.lib.name} rc={code}")

    def _store_status(self, impl_status) -> None:
        """Status layout conversion (ompix §3.2.3 layout -> standard §5.2);
        the converted status is attached for the ABI layer / tools."""
        self.last_status = None
        if impl_status is not None:
            s = Status()
            s.SOURCE = impl_status["MPI_SOURCE"]
            s.TAG = impl_status["MPI_TAG"]
            s.ERROR = self.errors.to_abi(impl_status["MPI_ERROR"])
            s.set_reserved(0, impl_status["_cancelled"])
            s.set_reserved(1, impl_status["_ucount"] & 0x7FFFFFFF)
            self.last_status = s

    # ------------------------------------------------------------------
    # registration of ABI user handles with the foreign implementation
    # ------------------------------------------------------------------
    def register_comm(self, abi_handle: int, axes: Sequence[str]) -> None:
        code, impl = self.lib.Comm_from_axes(tuple(axes))
        self._rc(code)
        info = self.comms.info(abi_handle, allow_revoked=True)
        if info.excludes:
            # an ULFM survivor communicator: the foreign library knows only
            # axes, so it runs on the survivors' group the ABI table made
            impl.group, impl.ranks = info.group, info.ranks
        self._comm_table[abi_handle] = impl

    def register_op(self, abi_handle: int) -> None:
        desc = self.ops.descriptor(abi_handle)
        user_fn = desc.fn
        wants_dtype = len(inspect.signature(user_fn).parameters) >= 3

        # The callback trampoline (§6.2): the implementation invokes this with
        # ITS handles; we convert back to ABI handles before calling user code.
        def trampoline(a, b, impl_dtype=None):
            if wants_dtype:
                return user_fn(a, b, self._dtype_to_abi(impl_dtype))
            return user_fn(a, b)

        code, impl = self.lib.Op_create(trampoline, desc.commutative)
        self._rc(code)
        self._op_table[abi_handle] = impl

    def register_datatype(self, abi_handle: int, count: int, base: int) -> None:
        code, impl = self.lib.Type_contiguous(count, self._convert_dtype(base))
        self._rc(code)
        self._dtype_table[abi_handle] = impl
        self._dtype_rev.setdefault(impl, abi_handle)

    # ------------------------------------------------------------------
    # non-table handle queries used by the recipes and the ABI layer
    # ------------------------------------------------------------------
    def comm_group(self, comm: int):
        return self._convert_comm(comm).group

    def op_fn(self, op: int) -> Callable:
        return self._convert_op(op).fn

    def op_is_native(self, op: int) -> bool:
        return self._convert_op(op).is_native


# ---------------------------------------------------------------------------
# WRAP_* generation — one translation wrapper per function-table entry.
#
# Each argument's declared domain picks its CONVERT_*; the entry's return
# protocol picks the rc handling; ``temps`` entries stash their converted
# vectors for the request map (freed by ``PaxABI.wait``).
# ---------------------------------------------------------------------------
_CONVERT_EXPR = {
    abi_spec.OP: "self._convert_op({a})",
    abi_spec.COMM: "self._convert_comm({a})",
    abi_spec.DATATYPE: "self._convert_dtype({a})",
}


def _wrap_src(entry: abi_spec.AbiEntry) -> str:
    params = abi_spec.signature_src(entry)
    lines = [f"def {entry.backend_method}(self, {params}):"]
    impl_args = []
    vec_names = []
    for a in entry.args:
        if a.kind == abi_spec.DATATYPE_VEC:
            cname = f"_c_{a.name}"
            lines.append(
                f"    {cname} = tuple(self._convert_dtype(_t) for _t in {a.name})"
            )
            impl_args.append(cname)
            vec_names.append(cname)
        elif a.kind in _CONVERT_EXPR:
            impl_args.append(_CONVERT_EXPR[a.kind].format(a=a.name))
        else:
            impl_args.append(a.name)
    if entry.temps:
        # §6.2: converted handle vectors must stay alive until completion
        lines.append(f"    self.{entry.temps_attr} = ({', '.join(vec_names)},)")
    call = f"self.lib.{entry.impl_name}({', '.join(impl_args)})"
    if entry.muk_ret == "rc_only":
        lines.append(f"    _code = {call}")
        lines.append("    if _code:")
        lines.append("        self._rc(_code)")
        lines.append("    return None")
    elif entry.muk_ret == "status":
        lines.append(f"    _code, _v, _s = {call}")
        lines.append("    if _code:")
        lines.append("        self._rc(_code)")
        lines.append("    self._store_status(_s)")
        lines.append("    return _v")
    else:
        lines.append(f"    _code, _v = {call}")
        lines.append("    if _code:")
        lines.append("        self._rc(_code)")
        lines.append("    return _v")
    return "\n".join(lines) + "\n"


def _plan_src(entry: abi_spec.AbiEntry) -> str:
    """Generated persistent-plan hook: the WRAP_* wrapper with every
    conversion hoisted to plan time.

    Handle conversion (comm/op/dtype, including vectors) runs once when the
    plan is built; the returned run closure calls the foreign symbol with the
    cached IMPL-domain handles and only translates the return code per start.
    This is the Mukautuva half of the persistent-operations claim: the
    translation layer's per-call cost collapses to rc translation because
    its actual work — conversion — is plan-time."""
    params = abi_spec.signature_src(entry)
    payload_names = [a.name for a in entry.args if a.kind == abi_spec.PAYLOAD]
    lines = [f"def plan_{entry.backend_method}(self, {params}):"]
    impl_args = []
    vec_names = []
    for a in entry.args:
        if a.kind == abi_spec.DATATYPE_VEC:
            cname = f"_c_{a.name}"
            lines.append(
                f"    {cname} = tuple(self._convert_dtype(_t) for _t in {a.name})"
            )
            impl_args.append(cname)
            vec_names.append(cname)
        elif a.kind in _CONVERT_EXPR:
            cname = f"_c_{a.name}"
            lines.append(
                f"    {cname} = " + _CONVERT_EXPR[a.kind].format(a=a.name))
            impl_args.append(cname)
        else:
            impl_args.append(a.name)
    if entry.temps:
        # converted handle vectors stay alive for the plan's lifetime (the
        # ABI layer rides them in the plan's pooled request)
        lines.append(f"    self.{entry.temps_attr} = ({', '.join(vec_names)},)")
    lines.append(f"    _lib_fn = self.lib.{entry.impl_name}")
    lines.append("    _rc = self._rc")
    call = f"_lib_fn({', '.join(impl_args)})"
    lines.append(f"    def _run({', '.join(payload_names)}):")
    if entry.muk_ret == "rc_only":
        lines.append(f"        _code = {call}")
        lines.append("        if _code:")
        lines.append("            _rc(_code)")
        lines.append("        return None")
    elif entry.muk_ret == "status":
        lines.append(f"        _code, _v, _s = {call}")
        lines.append("        if _code:")
        lines.append("            _rc(_code)")
        lines.append("        self._store_status(_s)")
        lines.append("        return _v")
    else:
        lines.append(f"        _code, _v = {call}")
        lines.append("        if _code:")
        lines.append("            _rc(_code)")
        lines.append("        return _v")
    lines.append("    return _run")
    return "\n".join(lines) + "\n"


def _plan_group_src(entry: abi_spec.AbiEntry) -> str:
    """Generated plan-group hook (the ``Startall`` analogue of the WRAP_*
    layer): every member's handle conversion runs once at group-build time,
    and the fused run is one tight loop over the foreign symbol with the
    cached IMPL-domain argument tuples — per start, the translation layer
    pays N rc translations and nothing else.  Generated only for
    single-payload value-returning entries; the rest fall back to the ABI
    layer's per-member composition of the (also conversion-cached)
    ``plan_*`` hooks."""
    names = [a.name for a in entry.args]
    frozen_exprs = []
    for a in entry.args:
        if a.kind == abi_spec.PAYLOAD:
            continue
        if a.kind == abi_spec.DATATYPE_VEC:
            frozen_exprs.append(
                f"tuple(self._convert_dtype(_t) for _t in {a.name})")
        elif a.kind in _CONVERT_EXPR:
            frozen_exprs.append(_CONVERT_EXPR[a.kind].format(a=a.name))
        else:
            frozen_exprs.append(a.name)
    lines = [
        f"def plan_group_{entry.backend_method}(self, bounds):",
        f"    _lib_fn = self.lib.{entry.impl_name}",
        "    _rc = self._rc",
        "    _frozen = []",
        "    for _b in bounds:",
        f"        ({', '.join(names)},) = _b",
        f"        _frozen.append(({', '.join(frozen_exprs)},))",
        "    def _run(_payloads):",
        "        _out = []",
        "        _append = _out.append",
        "        for _x, _f in zip(_payloads, _frozen):",
        "            _code, _v = _lib_fn(_x, *_f)",
        "            if _code:",
        "                _rc(_code)",
        "            _append(_v)",
        "        return _out",
        "    return _run",
    ]
    return "\n".join(lines) + "\n"


def _install_generated_wraps() -> None:
    for entry in abi_spec.ABI_TABLE:
        fn = abi_spec.compile_method(_wrap_src(entry), {}, entry.backend_method)
        fn.__qualname__ = f"MukBackend.{entry.backend_method}"
        fn.__doc__ = f"Generated WRAP_{entry.impl_name} (paper §6.2)."
        setattr(MukBackend, entry.backend_method, fn)
        if entry.persistent:
            pfn = abi_spec.compile_method(
                _plan_src(entry), {}, f"plan_{entry.backend_method}")
            pfn.__qualname__ = f"MukBackend.plan_{entry.backend_method}"
            pfn.__doc__ = (
                f"Generated persistent WRAP_{entry.impl_name}: foreign-handle "
                "conversion cached at plan time (paper §6.2, MPI-4 _init)."
            )
            setattr(MukBackend, f"plan_{entry.backend_method}", pfn)
            if (entry.payload_args == (0,) and not entry.temps
                    and entry.muk_ret == "value"):
                gfn = abi_spec.compile_method(
                    _plan_group_src(entry), {},
                    f"plan_group_{entry.backend_method}")
                gfn.__qualname__ = (
                    f"MukBackend.plan_group_{entry.backend_method}")
                gfn.__doc__ = (
                    f"Generated group WRAP_{entry.impl_name}: every member's "
                    "foreign-handle conversion cached at group-build time; "
                    "the fused run is one loop of foreign calls plus rc "
                    "translation (MPI Startall)."
                )
                setattr(MukBackend, f"plan_group_{entry.backend_method}", gfn)


_install_generated_wraps()


# Fault-tier exception to the generated table (installed after it, on
# purpose): a shrunk survivor communicator is an ABI-side construct — the
# foreign implementation has no ULFM and sees only the parent axes, so its
# Comm_size answers the *full* extent.  Group-membership queries for comms
# with exclusions are therefore answered from Mukautuva's mirrored ABI
# table; comms without exclusions keep the generated foreign path.
_generated_comm_size = MukBackend.size  # comm_size's backend_method


def _comm_size_excludes_aware(self, comm):
    info = self.comms.info(comm)
    if info.excludes:
        return info.size
    return _generated_comm_size(self, comm)


_comm_size_excludes_aware.__name__ = "size"
_comm_size_excludes_aware.__qualname__ = "MukBackend.size"
# the override *wraps* the generated foreign path; keep its provenance
_comm_size_excludes_aware.__generated_src__ = \
    _generated_comm_size.__generated_src__
MukBackend.size = _comm_size_excludes_aware
