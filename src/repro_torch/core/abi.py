"""The PAX ABI surface — what applications and the framework link against.

The design mirrors the paper's runtime structure (§6.2) and the reference
package (``repro.core.abi``) entry for entry: at ``pax_init`` the context
resolves a backend (``registry.py``, the ``dlopen`` analogue), **negotiates
the standard function table against it** (the ``dlsym`` analogue: every
entry of :data:`repro_torch.core.abi_spec.ABI_TABLE` is resolved once),
stacks the interposition tools (PMPI/QMPI, §4.8) around the resolved
entries, and exposes the standard functions.

* **Tiered negotiation.**  A missing REQUIRED entry raises
  ``PAX_ERR_UNSUPPORTED_OPERATION`` at init; a missing OPTIONAL entry whose
  recipe chain grounds out is marked emulated (built lazily on first use),
  otherwise it resolves to a raiser that fires at call time.
* **Generated, specialized entry points.**  The blocking methods, their
  ``i*`` twins and the ``<name>_init`` plan constructors are generated from
  the spec; :meth:`PaxABI._specialize` compiles one entry point per context
  that closes over the resolved backend callable and the tool tuple, so the
  zero-tool path is the handle checks plus the direct backend call.
* **Nonblocking operations are real.**  The reference's ``i*`` values are
  produced eagerly in dataflow terms; here an ``i*`` start issues an
  asynchronous ``torch.distributed`` collective (the backend's ``i<method>``
  hook) and the request holds its ``_dist.Pending`` — ``wait`` completes it.
* **Persistent plans and plan groups (MPI-4 ``<name>_init``, ``Startall``).**
  Plan time takes every per-call decision once (handle checks, payload
  abstraction to shape/dtype, comm→group lookup, op branch, tool
  decision); ``start`` is an inactive-check plus a bare closure call that
  issues the collective; ``wait`` completes it.  Plan groups fuse members
  sharing (entry, non-payload arguments) into one stacked collective.
  ``<name>_init`` is idempotent per layout through a weak plan cache.
* **Free-list request pool.**  Slots carry a generation above the handle
  classification bits, so use-after-wait is an exactly detected
  ``PAX_ERR_REQUEST`` forever and the handle space never exhausts.

The reference's integrity envelope, wait timeouts and the plan reset on
``comm_revoke`` belong to the fault and transport tiers, which a later port
slice brings.  ``shard_region`` has no counterpart: one process is one rank,
so the code a ``shard_map`` region holds in the reference simply runs.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from . import abi_spec
from . import emulation
from . import handles as H
from .backends._dist import Pending
from .backends._dist import complete as _complete
from .communicator import CommTable
from .constants import PAX_ANY_SOURCE, PAX_ANY_TAG
from .datatypes import DatatypeRegistry
from .errors import (
    PAX_ERR_REQUEST,
    PAX_ERR_UNSUPPORTED_OPERATION,
    PAX_SUCCESS,
    PaxError,
)
from .ops import OpRegistry
from .status import Status


class TensorSpec(NamedTuple):
    """A payload bound abstractly at plan time: shape and dtype only (the
    counterpart of ``jax.ShapeDtypeStruct``).  A plan is specific to the
    payload's geometry, never its values, and must not pin a buffer."""

    shape: tuple
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


@dataclasses.dataclass(eq=False, slots=True)
class Request:
    """An ABI request handle plus its completion payload.

    ``eq=False``: requests are identity objects (the pool recycles them in
    place).  ``value`` holds the backend's ``Pending`` (or a completed
    value) until ``wait``.
    """

    handle: int
    value: Any = None
    kind: str = ""
    done: bool = False
    temp_state: Any = None
    on_complete: Optional[Callable[["Request"], Any]] = None
    #: persistent (plan-owned) requests are *restartable* pool slots: wait
    #: deactivates (done=True) without retiring, start reactivates, and the
    #: slot's generation only advances when the owning plan is freed.
    persistent: bool = False


REQUEST_NULL = Request(H.PAX_REQUEST_NULL, done=True)


class Plan:
    """A persistent-operation plan (the MPI-4 ``<name>_init`` analogue).

    Built by the generated ``<name>_init`` constructors.  ``start(payload)``
    reactivates the plan's pooled request and issues the frozen collective;
    ``wait()`` (or the ABI-level ``wait``/``waitall``/``testall``) completes
    and deactivates it.  The request slot is allocated once and its
    generation never advances across start/wait cycles; ``free()`` retires
    it.  Plans are layout-cached: ``<name>_init`` with a signature already
    planned returns the same live, inactive plan.
    """

    __slots__ = ("abi", "entry", "bound", "request", "freed", "_cache_key",
                 "start", "wait", "_finalizer", "__weakref__")

    def __init__(self, abi, entry, bound) -> None:
        self.abi = abi
        self.entry = entry
        self.bound = bound        # table-order args, payloads abstracted
        self.request = None       # the restartable pooled Request
        self.freed = False
        self._cache_key = None
        self._finalizer = None
        # start/wait are compiled closures installed by _compile_plan

    def reset(self) -> None:
        """Force the plan inactive (escape hatch for an aborted start)."""
        req = self.request
        if req is not None and not self.freed:
            req.done = True
            req.value = None

    def free(self) -> None:
        """Retire the plan's request slot (``MPI_Request_free``).  The plan
        must be inactive; every handle it returned is then stale forever."""
        if self.freed:
            return
        req = self.request
        if req is not None and not req.done:
            raise PaxError(
                PAX_ERR_REQUEST,
                f"freeing an active persistent {self.entry.name!r} plan "
                "(wait the started request first)",
            )
        self.freed = True
        abi = self.abi
        if self._finalizer is not None:
            self._finalizer.detach()
        if req is not None:
            _reclaim_plan_slot(abi, req, req.handle)
        abi._plans.discard(self)
        if self._cache_key is not None:
            if abi._plan_cache.get(self._cache_key) is self:
                del abi._plan_cache[self._cache_key]
        self.start = self.wait = _dead(f"persistent {self.entry.name!r} plan was freed")


class PlanGroup:
    """A fused group of persistent plans (the MPI ``Startall`` analogue).

    Members are clustered at group-build time by (entry, non-payload
    arguments); each cluster compiles to one fused run — the backend's
    group hook (one stacked collective), the recipe's group stage, or a
    per-member loop.  The group owns ONE restartable request:
    ``start(payloads)`` is one inactive-check plus the fused closure, and
    ``wait()`` returns the member results in member order.  ``free()``
    retires the group's slot only, never the members'.
    """

    __slots__ = ("abi", "name", "plans", "request", "freed",
                 "start", "wait", "_finalizer", "__weakref__")

    def __init__(self, abi, plans, name: str) -> None:
        self.abi = abi
        self.name = name
        self.plans = tuple(plans)
        self.request = None
        self.freed = False
        self._finalizer = None

    def __len__(self) -> int:
        return len(self.plans)

    def reset(self) -> None:
        req = self.request
        if req is not None and not self.freed:
            req.done = True
            req.value = None

    def free(self) -> None:
        if self.freed:
            return
        req = self.request
        if req is not None and not req.done:
            raise PaxError(
                PAX_ERR_REQUEST,
                f"freeing an active plan group {self.name!r} "
                "(wait the started request first)",
            )
        self.freed = True
        abi = self.abi
        if self._finalizer is not None:
            self._finalizer.detach()
        if req is not None:
            _reclaim_plan_slot(abi, req, req.handle)
        abi._plan_groups.discard(self)
        self.start = self.wait = _dead(f"plan group {self.name!r} was freed")


def _make_wait(req: Request) -> Callable:
    """A plan's or group's wait: on an inactive request it returns at once
    (MPI semantics); otherwise it completes the started collective and
    deactivates the slot without retiring it."""

    def wait(_req=req):
        if _req.done:
            return None
        _req.done = True
        v = _req.value
        _req.value = None
        return _complete(v)

    return wait


def _dead(detail: str) -> Callable:
    def dead(*args, **kwargs):
        raise PaxError(PAX_ERR_REQUEST, detail)

    return dead


# ---------------------------------------------------------------------------
# Request-pool handle layout: the slot index lives in the 24-bit user index
# field (``req_slot_bits`` caps the pool, default 14 = 16384 slots); the
# generation lives ABOVE the classification bits and never wraps, so a
# retired handle can never alias a later reuse of its slot.
# ---------------------------------------------------------------------------
_REQ_SLOT_BITS = 14
_REQ_GEN_SHIFT = 31                      # first bit above _USER_BIT (bit 30)
_REQ_HANDLE_BASE = H.make_user_handle(H.HandleKind.REQUEST, 0)
_USER_INDEX_MASK = H._USER_INDEX_MASK
_UKS = H._USER_KIND_SHIFT


def _unavailable_entry(entry: abi_spec.AbiEntry, backend_name: str, reason: str):
    """Table slot for an optional entry that resolved neither way: calling it
    (not initializing the context) raises PAX_ERR_UNSUPPORTED_OPERATION."""

    def unavailable(*args, **kwargs):
        raise PaxError(
            PAX_ERR_UNSUPPORTED_OPERATION,
            f"{entry.name!r} is unavailable on backend {backend_name!r}: "
            f"{reason}",
        )

    unavailable.__name__ = entry.backend_method
    unavailable.__qualname__ = f"unavailable.{entry.name}"
    return unavailable


def _reclaim_plan_slot(abi: "PaxABI", req: Request, handle: int) -> None:
    """Return a plan's slot to the pool (``free`` and the GC fallback).
    No-op when already retired (``persistent`` cleared or handle moved on)."""
    if not req.persistent or req.handle != handle:
        return
    slot = handle & _USER_INDEX_MASK
    abi._req_gen[slot] += 1
    abi._req_free.append(slot)
    req.persistent = False
    req.done = True
    req.value = req.temp_state = req.on_complete = None


def _lazy_entry(abi: "PaxABI", entry: abi_spec.AbiEntry):
    """Table slot for an emulated entry whose recipe is built on first use;
    dispatch goes through a mutable cell that the build overwrites, so
    callables hoisted before the first call heal in place."""
    state = {"impl": None}
    cell = [None]

    def _build_and_call(*args, **kwargs):
        return abi._build_recipe(entry.name)(*args, **kwargs)

    cell[0] = _build_and_call

    def lazy(*args, _cell=cell, **kwargs):
        return _cell[0](*args, **kwargs)

    lazy.__lazy_recipe__ = state
    lazy.__lazy_cell__ = cell
    lazy.__name__ = entry.backend_method
    lazy.__qualname__ = f"lazy-emulated.{entry.name}"
    return lazy


class PaxABI:
    """One initialized ABI context (``MPI_Init`` .. ``MPI_Finalize``)."""

    def __init__(self, backend, mesh=None, tools: Sequence = (),
                 req_slot_bits: Optional[int] = None) -> None:
        self.backend = backend
        self.mesh = mesh if mesh is not None else backend.mesh
        self.comms: CommTable = getattr(backend, "comms", None) or CommTable(self.mesh)
        self.ops: OpRegistry = getattr(backend, "ops", None) or OpRegistry()
        self.datatypes: DatatypeRegistry = getattr(backend, "datatypes", None) or DatatypeRegistry()
        # Tiered dlsym-style negotiation: resolve every entry now.
        self._table: dict[str, Callable] = {}
        self._source: dict[str, str] = {}   # name -> native|emulated|unavailable
        self._unavailable_reasons: dict[str, str] = {}
        self._entry_envs: dict[str, dict] = {}
        missing_required = []
        for entry in abi_spec.ABI_TABLE:
            if backend.supports(entry):
                self._table[entry.name] = getattr(backend, entry.backend_method)
                self._source[entry.name] = "native"
            elif entry.tier == abi_spec.REQUIRED:
                missing_required.append(entry.name)
        if missing_required:
            raise PaxError(
                PAX_ERR_UNSUPPORTED_OPERATION,
                f"backend {backend.name!r} is missing required function-table "
                f"entry point(s) {missing_required} (init-time negotiation, "
                "paper §6.2)",
            )
        for name in abi_spec.EMULATION_ORDER:
            if name in self._table:
                continue
            entry = abi_spec.ENTRY_BY_NAME[name]
            recipe = entry.recipe
            if recipe is not None and all(
                self._source.get(d) in ("native", "emulated") for d in recipe.deps
            ):
                self._table[name] = _lazy_entry(self, entry)
                self._source[name] = "emulated"
            else:
                if recipe is None:
                    reason = "no native implementation and no emulation recipe"
                else:
                    unmet = [d for d in recipe.deps
                             if self._source.get(d) not in ("native", "emulated")]
                    reason = (f"emulation recipe dependency chain does not "
                              f"ground out (unresolved: {unmet})")
                self._table[name] = _unavailable_entry(entry, backend.name, reason)
                self._source[name] = "unavailable"
                self._unavailable_reasons[name] = reason
        bits = _REQ_SLOT_BITS if req_slot_bits is None else int(req_slot_bits)
        if not 1 <= bits <= H._USER_KIND_SHIFT:
            raise ValueError(
                f"req_slot_bits must be in 1..{H._USER_KIND_SHIFT}, got {bits}"
            )
        self.tools = list(tools)
        for t in self.tools:
            t.attach(self)
        self._req_slot_bits = bits
        self._req_max_slots = 1 << bits
        self._req_pool: list[Request] = []
        self._req_gen: list[int] = []
        self._req_free: list[int] = []
        self._req_live = 0
        self.requests_issued = 0  # lifetime stat; NOT part of any handle
        self.finalized = False
        self._plans: weakref.WeakSet[Plan] = weakref.WeakSet()
        self._plan_groups: weakref.WeakSet[PlanGroup] = weakref.WeakSet()
        self._plan_cache: "weakref.WeakValueDictionary[tuple, Plan]" = (
            weakref.WeakValueDictionary())
        self._specialize()

    # ------------------------------------------------------------------
    # init-time specialization
    # ------------------------------------------------------------------
    def _specialize(self) -> None:
        """(Re)compile per-context entry points, and recompile live plans
        and groups (they carry the tool decision baked in)."""
        tools = tuple(self.tools)
        rtools = tuple(reversed(tools))
        for entry in abi_spec.ABI_TABLE:
            self._specialize_entry(entry, tools, rtools)
        for plan in list(self._plans):
            self._compile_plan(plan)
        for group in list(self._plan_groups):
            self._compile_plan_group(group)

    def _istart(self, entry: abi_spec.AbiEntry) -> Callable:
        """The callable an ``i<name>`` start issues: the backend's async
        hook for native entries that have one, else the resolved entry
        (whose value is complete when it returns)."""
        if (self._source[entry.name] == "native"
                and self.backend.supports_nonblocking(entry)):
            return getattr(self.backend, f"i{entry.backend_method}")
        return self._table[entry.name]

    def _specialize_entry(self, entry: abi_spec.AbiEntry,
                          tools: Optional[tuple] = None,
                          rtools: Optional[tuple] = None) -> None:
        """Compile one entry's per-instance blocking + ``i*`` entry points."""
        if tools is None:
            tools = tuple(self.tools)
            rtools = tuple(reversed(tools))
        tooled = bool(tools)
        env = dict(_GEN_ENV)
        env["_impl"] = self._table[entry.name]
        env["_abi"] = self
        env["_tools"] = tools
        env["_rtools"] = rtools
        fn = _compile_cached(
            _SPEC_BLOCKING_SRC, (entry.name, tooled),
            lambda: _spec_src(entry, tooled, nonblocking=False), entry.name, env,
        )
        self._entry_envs[entry.name] = env
        object.__setattr__(self, entry.name, fn)
        if entry.nonblocking:
            ienv = dict(env)
            ienv["_impl"] = self._istart(entry)
            ienv["_new_request"] = self._new_request
            ifn = _compile_cached(
                _SPEC_NONBLOCKING_SRC, (entry.name, tooled),
                lambda: _spec_src(entry, tooled, nonblocking=True),
                f"i{entry.name}", ienv,
            )
            object.__setattr__(self, f"i{entry.name}", ifn)

    def attach_tool(self, tool) -> None:
        """Attach an interposition tool and respecialize the dispatch path."""
        tool.attach(self)
        self.tools.append(tool)
        self._specialize()

    def detach_tool(self, tool) -> None:
        """Detach a tool; the zero-tool fast path returns when none remain."""
        self.tools.remove(tool)
        self._specialize()

    # ------------------------------------------------------------------
    # lazy emulation-recipe resolution
    # ------------------------------------------------------------------
    def _ensure_built(self, name: str) -> Callable:
        fn = self._table[name]
        if getattr(fn, "__lazy_recipe__", None) is not None:
            return self._build_recipe(name)
        return fn

    def _build_recipe(self, name: str) -> Callable:
        """Compile a deferred recipe: swap the built closure into the table,
        patch the shim's cell and the compiled entry's globals, and
        respecialize the entry."""
        fn = self._table[name]
        state = getattr(fn, "__lazy_recipe__", None)
        if state is None:
            return fn
        impl = state["impl"]
        if impl is None:
            entry = abi_spec.ENTRY_BY_NAME[name]
            impl = entry.recipe.build(emulation.EmulationContext(self))
            state["impl"] = impl
            self._table[name] = impl
            fn.__lazy_cell__[0] = impl
            env = self._entry_envs.get(name)
            if env is not None:
                env["_impl"] = impl
            self._specialize_entry(entry)
        return impl

    # ------------------------------------------------------------------
    # persistent plans (MPI-4 <name>_init): hoist per-call work to plan time
    # ------------------------------------------------------------------
    def _make_plan(self, name: str, call_args: tuple) -> Plan:
        """Build (or fetch from the layout cache) a persistent plan for entry
        ``name`` bound to ``call_args``.  Only an *inactive* cached plan is
        handed out again; an in-flight one gets an independent twin."""
        entry = abi_spec.ENTRY_BY_NAME[name]
        args = []
        for a, v in zip(entry.args, call_args):
            if a.kind == abi_spec.DATATYPE_VEC:
                v = tuple(v)
                for t in v:
                    H.check_handle(t, a.check_kind)
            elif a.check_kind is not None:
                H.check_handle(v, a.check_kind)
            elif a.kind in (abi_spec.PERM, abi_spec.COUNTS):
                v = tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                          for p in v)
            elif a.kind == abi_spec.PAYLOAD:
                v = _abstract_payload(v)
            args.append(v)
        key = _plan_cache_key(entry, args)
        if key is not None:
            cached = self._plan_cache.get(key)
            if (cached is not None and not cached.freed
                    and cached.request.done):
                return cached
        plan = Plan(self, entry, tuple(args))
        plan._cache_key = key
        plan.request = self._new_persistent_request(f"p{name}")
        plan._finalizer = weakref.finalize(
            plan, _reclaim_plan_slot, self, plan.request, plan.request.handle)
        self._compile_plan(plan)
        self._plans.add(plan)
        if key is not None:
            self._plan_cache[key] = plan
        return plan

    def _plan_run(self, name: str, bound: tuple) -> Callable:
        """Compile the untooled run closure for entry ``name``: the backend's
        ``plan_<method>`` hook, the recipe's plan builder, or generic
        argument freezing around the resolved callable."""
        entry = abi_spec.ENTRY_BY_NAME[name]
        source = self._source[name]
        if source == "native":
            hook = getattr(self.backend, f"plan_{entry.backend_method}", None)
            if hook is not None:
                return hook(*bound)
            impl = self._table[name]
        elif source == "emulated":
            if entry.recipe.plan is not None:
                return entry.recipe.plan(emulation.PlanContext(self), *bound)
            impl = self._ensure_built(name)
        else:
            raise PaxError(
                PAX_ERR_UNSUPPORTED_OPERATION,
                f"cannot plan {name!r} on backend {self.backend.name!r}: "
                f"{self._unavailable_reasons[name]}",
            )
        return _freeze_run(entry, impl, bound)

    def _compile_plan(self, plan: Plan) -> None:
        """(Re)compile a plan's start/wait closures (at creation, and again
        when the tool chain changes)."""
        entry = plan.entry
        run = self._plan_run(entry.name, plan.bound)
        if self.tools:
            tools = tuple(self.tools)
            rtools = tuple(reversed(tools))
            if entry.bytes_arg:
                idx = {a.name: i for i, a in enumerate(entry.args)}
                bytes_val = _nbytes(plan.bound[idx[entry.bytes_arg]], self)
                comm_h = next(plan.bound[i] for i, a in enumerate(entry.args)
                              if a.kind == abi_spec.COMM)
            else:
                bytes_val = comm_h = None
            splice = _payload_splicer(entry, plan.bound)
            fname = entry.name
            base_run = run

            def run(*payload):
                targs = splice(payload)
                info = ({} if bytes_val is None
                        else {"bytes": bytes_val, "comm_handle": comm_h})
                for t in tools:
                    t.before(fname, targs, info)
                res = base_run(*payload)
                for t in rtools:
                    res = t.after(fname, targs, info, res)
                return res

        if entry.temps:
            plan.request.temp_state = getattr(self.backend, entry.temps_attr, None)

        req = plan.request
        ename = entry.name

        def _active():
            raise PaxError(
                PAX_ERR_REQUEST,
                f"persistent {ename!r} started while already active "
                "(wait the previous start first)",
            )

        if len(entry.payload_args) == 1:
            def start(x, _req=req, _run=run):
                if not _req.done:
                    _active()
                _req.done = False
                _req.value = _run(x)
                return _req
        else:  # no current entry has more than one payload argument
            def start(*payload, _req=req, _run=run):
                if not _req.done:
                    _active()
                _req.done = False
                _req.value = _run(*payload)
                return _req

        plan.start = start
        plan.wait = _make_wait(req)

    def _new_persistent_request(self, kind: str) -> Request:
        """Allocate the restartable pool slot backing one plan or group:
        same free list as nonblocking requests, not counted live while
        inactive, generation advanced only by ``free``."""
        if self._req_free:
            slot = self._req_free.pop()
            req = self._req_pool[slot]
            req.handle = (self._req_gen[slot] << _REQ_GEN_SHIFT) | _REQ_HANDLE_BASE | slot
            req.value = None
            req.kind = kind
            req.done = True  # inactive
            req.temp_state = None
            req.on_complete = None
        else:
            slot = len(self._req_pool)
            if slot >= self._req_max_slots:
                raise PaxError(
                    PAX_ERR_REQUEST,
                    f"request pool exhausted: {self._req_max_slots} slots "
                    "(free some plans or wait outstanding requests)",
                )
            req = Request(_REQ_HANDLE_BASE | slot, None, kind, True, None, None)
            self._req_pool.append(req)
            self._req_gen.append(0)
        req.persistent = True
        self.requests_issued += 1
        return req

    # ------------------------------------------------------------------
    # plan groups (MPI Startall): fuse N plans into one start + one wait
    # ------------------------------------------------------------------
    def plan_group(self, plans: Sequence[Plan], name: str = "") -> PlanGroup:
        """Compile a :class:`PlanGroup` from live plans of this context."""
        plans = tuple(plans)
        if not plans:
            raise PaxError(PAX_ERR_REQUEST, "plan_group of zero plans")
        for p in plans:
            if not isinstance(p, Plan) or p.abi is not self:
                raise PaxError(
                    PAX_ERR_REQUEST,
                    f"plan group {name!r} member is not a plan of this "
                    "context",
                )
            if p.freed:
                raise PaxError(
                    PAX_ERR_REQUEST,
                    f"plan group {name!r} member ({p.entry.name!r} plan) "
                    "was already freed",
                )
        group = PlanGroup(self, plans, name or f"group[{len(plans)}]")
        group.request = self._new_persistent_request(f"g{group.name}")
        group._finalizer = weakref.finalize(
            group, _reclaim_plan_slot, self, group.request,
            group.request.handle)
        self._compile_plan_group(group)
        self._plan_groups.add(group)
        return group

    def _plan_group_run(self, name: str, bounds: Sequence[tuple]) -> Callable:
        """One fused run closure for same-entry, same-non-payload members:
        backend group hook, recipe group stage, else per-member runs."""
        entry = abi_spec.ENTRY_BY_NAME[name]
        bounds = list(bounds)
        if len(bounds) > 1:
            source = self._source[name]
            if source == "native":
                hook = getattr(self.backend,
                               f"plan_group_{entry.backend_method}", None)
                if hook is not None:
                    run = hook(bounds)
                    if run is not None:
                        return run
            elif source == "emulated" and entry.recipe.plan_group is not None:
                run = entry.recipe.plan_group(
                    emulation.PlanContext(self), bounds)
                if run is not None:
                    return run
        runs = [self._plan_run(name, tuple(b)) for b in bounds]
        if entry.payload_args:
            return lambda xs: [r(x) for r, x in zip(runs, xs)]
        return lambda xs: [r() for r in runs]

    def _compile_plan_group(self, group: PlanGroup) -> None:
        """(Re)compile a group's fused start/wait closures."""
        plans = group.plans
        n = len(plans)
        clusters: dict[tuple, list[int]] = {}
        for i, p in enumerate(plans):
            pay = set(p.entry.payload_args)
            key = (p.entry.name, tuple(
                v for j, v in enumerate(p.bound) if j not in pay))
            clusters.setdefault(key, []).append(i)
        segments = []
        for (ename, _), idxs in clusters.items():
            bnds = [plans[i].bound for i in idxs]
            segments.append((tuple(idxs), self._plan_group_run(ename, bnds)))

        if len(segments) == 1 and segments[0][0] == tuple(range(n)):
            run = segments[0][1]  # homogeneous group: no reassembly layer
        else:
            seg_t = tuple(segments)

            def assemble(started, _n=n):
                outs = [None] * _n
                for idxs, out in started:
                    for i, o in zip(idxs, _complete(out)):
                        outs[i] = o
                return outs

            def run(payloads, _segs=seg_t):
                # every segment is issued now; completion and reassembly in
                # member order happen at wait
                return Pending(None, [(idxs, seg([payloads[i] for i in idxs]))
                                      for idxs, seg in _segs], assemble)

        if self.tools:
            tools = tuple(self.tools)
            rtools = tuple(reversed(tools))
            total = 0
            comms = set()
            for p in plans:
                entry = p.entry
                if entry.bytes_arg:
                    idx = {a.name: i for i, a in enumerate(entry.args)}
                    total += _nbytes(p.bound[idx[entry.bytes_arg]], self)
                for i, a in enumerate(entry.args):
                    if a.kind == abi_spec.COMM:
                        comms.add(p.bound[i])
            comm_h = comms.pop() if len(comms) == 1 else None
            fname = group.name
            gsize = n
            base_run = run

            def run(payloads):
                targs = tuple(payloads)
                info = {"bytes": total, "comm_handle": comm_h,
                        "group": fname, "members": gsize}
                for t in tools:
                    t.before(fname, targs, info)
                res = base_run(payloads)
                for t in rtools:
                    res = t.after(fname, targs, info, res)
                return res

        req = group.request
        gname = group.name

        def start(payloads, _req=req, _run=run, _n=n):
            if len(payloads) != _n:
                raise PaxError(
                    PAX_ERR_REQUEST,
                    f"plan group {gname!r} started with {len(payloads)} "
                    f"payloads for {_n} members (one per member; items for "
                    "payload-less members are ignored)",
                )
            if not _req.done:
                raise PaxError(
                    PAX_ERR_REQUEST,
                    f"plan group {gname!r} started while already active "
                    "(wait the previous start first)",
                )
            _req.done = False
            _req.value = _run(payloads)
            return _req

        group.start = start
        group.wait = _make_wait(req)

    # ------------------------------------------------------------------
    # capability report (what tiered negotiation resolved, per entry)
    # ------------------------------------------------------------------
    def capabilities(self) -> dict[str, dict]:
        """Per-entry resolution report: ``{"tier", "source", ...}`` with
        ``"deps"`` for emulated entries, ``"reason"`` for unavailable ones,
        and how a plan / plan-group cluster of a persistent entry compiles."""
        report: dict[str, dict] = {}
        for entry in abi_spec.ABI_TABLE:
            source = self._source[entry.name]
            info: dict = {"tier": entry.tier, "source": source}
            if source == "emulated":
                info["deps"] = entry.recipe.deps
            elif source == "unavailable":
                info["reason"] = self._unavailable_reasons[entry.name]
            if entry.persistent:
                if source == "unavailable":
                    info["plan"] = "unavailable"
                elif source == "native" and self.backend.supports_persistent(entry):
                    info["plan"] = "backend-hook"
                elif source == "emulated" and entry.recipe.plan is not None:
                    info["plan"] = "recipe-plan"
                else:
                    info["plan"] = "generic"
                if source == "unavailable":
                    info["plan_group"] = "unavailable"
                elif (source == "native"
                        and self.backend.supports_persistent_group(entry)):
                    info["plan_group"] = "backend-hook"
                elif (source == "emulated"
                        and entry.recipe.plan_group is not None):
                    info["plan_group"] = "recipe-stage"
                else:
                    info["plan_group"] = "generic"
            info.update(self.backend.capability(entry))
            report[entry.name] = info
        return report

    def _dispatch_tools(self, fname: str, impl: Callable, args: tuple, info: dict):
        for t in self.tools:
            t.before(fname, args, info)
        result = impl(*args)
        for t in reversed(self.tools):
            result = t.after(fname, args, info, result)
        return result

    # -- init/finalize ----------------------------------------------------
    def finalize(self) -> None:
        live = self.outstanding_requests
        if live:
            raise PaxError(PAX_ERR_REQUEST, f"{live} outstanding requests")
        self.finalized = True

    # -- identity / registration (not per-collective dispatch) -------------
    def comm_from_axes(self, axes: Sequence[str], name: str = "") -> int:
        return self.comms.comm_from_axes(axes, name)

    def comm_dup(self, comm: int) -> int:
        return self.comms.comm_dup(comm)

    def comm_free(self, comm: int) -> None:
        self.comms.comm_free(comm)

    # -- datatypes ----------------------------------------------------------
    def type_contiguous(self, count: int, base: int) -> int:
        return self.datatypes.type_contiguous(count, base)

    def type_from_array(self, x) -> int:
        return self.datatypes.from_array(x)

    # -- user ops (callback registration) -----------------------------------
    def op_create(self, fn: Callable, *, commutative: bool = True, name: str = "") -> int:
        return self.ops.op_create(fn, commutative=commutative, name=name)

    def op_free(self, op: int) -> None:
        self.ops.op_free(op)

    # -- nonblocking request plumbing ---------------------------------------
    def _new_request(self, value, kind: str, temp_state=None, on_complete=None) -> Request:
        if self._req_free:
            slot = self._req_free.pop()
            req = self._req_pool[slot]
            req.handle = (self._req_gen[slot] << _REQ_GEN_SHIFT) | _REQ_HANDLE_BASE | slot
            req.value = value
            req.kind = kind
            req.done = False
            req.temp_state = temp_state
            req.on_complete = on_complete
        else:
            slot = len(self._req_pool)
            if slot >= self._req_max_slots:
                raise PaxError(
                    PAX_ERR_REQUEST,
                    f"request pool exhausted: {self._req_max_slots} outstanding "
                    "nonblocking requests (wait/test some before issuing more)",
                )
            req = Request(_REQ_HANDLE_BASE | slot, value, kind, False,
                          temp_state, on_complete)
            self._req_pool.append(req)
            self._req_gen.append(0)
        self._req_live += 1
        self.requests_issued += 1
        return req

    def _request_is_live(self, handle: int) -> bool:
        """O(1) liveness: slot index + generation compare, no hashing."""
        if not handle & H._USER_BIT:
            return False
        slot = handle & _USER_INDEX_MASK
        return slot < len(self._req_gen) and self._req_gen[slot] == handle >> _REQ_GEN_SHIFT

    def _retire(self, handle: int) -> None:
        """Free the handle's slot; bump generation so the handle goes stale."""
        slot = handle & _USER_INDEX_MASK
        self._req_gen[slot] += 1
        self._req_free.append(slot)
        self._req_live -= 1
        pooled = self._req_pool[slot]
        if pooled.handle == handle and not pooled.done:
            pooled.done = True
            pooled.value = pooled.temp_state = pooled.on_complete = None

    # -- completion -----------------------------------------------------------
    def wait(self, request: Request, status: Optional[Status] = None):
        if request.handle == H.PAX_REQUEST_NULL:
            return None
        if not request.done:
            if request.persistent:
                slot = request.handle & _USER_INDEX_MASK
                gens = self._req_gen
                if slot >= len(gens) or gens[slot] != request.handle >> _REQ_GEN_SHIFT:
                    raise PaxError(
                        PAX_ERR_REQUEST,
                        "stale persistent request (its plan was freed)",
                    )
                request.done = True
                value = _complete(request.value)
                request.value = None
                if status is not None:
                    status.ERROR = PAX_SUCCESS
                return value
            if not self._request_is_live(request.handle):
                raise PaxError(
                    PAX_ERR_REQUEST,
                    "stale, unknown or already-completed request "
                    "(use-after-wait is detected by the generation check)",
                )
            value = _complete(request.value)
            request.done = True  # mark first: _retire must see the twin live
            self._retire(request.handle)
            request.value = value
            if request.on_complete is not None:
                request.value = request.on_complete(request)
            request.temp_state = None
        if status is not None:
            status.ERROR = PAX_SUCCESS
        return request.value

    def test(self, request: Request, status: Optional[Status] = None):
        """Completion check.  Reports flag=True and completes the request
        (the reference's contract); the liveness check is a slot index."""
        if not request.done and not self._request_is_live(request.handle):
            raise PaxError(PAX_ERR_REQUEST, "unknown request")
        return True, self.wait(request, status)

    def waitall(self, requests: Sequence[Request], statuses=None):
        return [self.wait(r, None if statuses is None else statuses[i])
                for i, r in enumerate(requests)]

    def _scan_ready(self, requests: Sequence[Request]) -> bool:
        gens = self._req_gen
        for r in requests:
            if r.done:
                continue
            h = r.handle
            slot = h & _USER_INDEX_MASK
            if (not h & H._USER_BIT or slot >= len(gens)
                    or gens[slot] != h >> _REQ_GEN_SHIFT):
                return False
        return True

    def testall(self, requests: Sequence[Request], statuses=None):
        if not self._scan_ready(requests):
            return False, None
        return True, self.waitall(requests, statuses)

    @property
    def outstanding_requests(self) -> int:
        """Live nonblocking requests plus *active* persistent plans/groups."""
        live = self._req_live
        for p in self._plans:
            r = p.request
            if r is not None and not r.done:
                live += 1
        for g in self._plan_groups:
            r = g.request
            if r is not None and not r.done:
                live += 1
        return live


def _leaves(x):
    if isinstance(x, (list, tuple)) and not isinstance(x, TensorSpec):
        for e in x:
            yield from _leaves(e)
    else:
        yield x


def _nbytes(x, abi: PaxABI, datatype: Optional[int] = None) -> int:
    """Payload size for tool accounting (tensors, specs, lists of either)."""
    total = 0
    for leaf in _leaves(x):
        if isinstance(leaf, TensorSpec):
            n, item = leaf.numel(), leaf.dtype.itemsize
        elif isinstance(leaf, torch.Tensor):
            n, item = leaf.numel(), leaf.element_size()
        else:
            continue
        total += n * (abi.datatypes.type_size_encoded(datatype)
                      if datatype is not None else item)
    return int(total)


def _abstract_payload(x):
    """Plan-time payload binding: keep only shape/dtype per tensor."""
    if isinstance(x, torch.Tensor):
        return TensorSpec(tuple(x.shape), x.dtype)
    if isinstance(x, TensorSpec):
        return x
    if isinstance(x, (list, tuple)):
        return type(x)(_abstract_payload(e) for e in x)
    return x


def _plan_cache_key(entry: abi_spec.AbiEntry, args: Sequence) -> Optional[tuple]:
    """The layout key of one normalized plan-argument list (``None`` when
    any component does not hash — the plan is then simply not cached)."""
    try:
        key = (entry.name,) + tuple(args)
        hash(key)
        return key
    except TypeError:
        return None


def _payload_splicer(entry: abi_spec.AbiEntry, bound: tuple) -> Callable:
    """``payload_tuple -> full_arg_tuple`` from the plan's bound template."""
    payload_idx = entry.payload_args
    if not payload_idx:
        frozen = tuple(bound)
        return lambda payload: frozen
    rest = tuple(bound[1:])
    return lambda payload: payload + rest


def _freeze_run(entry: abi_spec.AbiEntry, impl: Callable, bound: tuple) -> Callable:
    """Generic plan compiler: freeze every non-payload argument around the
    resolved callable (every current entry's payload is argument 0)."""
    if not entry.payload_args:
        frozen = tuple(bound)
        return lambda _impl=impl, _a=frozen: _impl(*_a)
    rest = tuple(bound[1:])
    return lambda x, _impl=impl, _rest=rest: _impl(x, *_rest)


# ---------------------------------------------------------------------------
# Method generation from the declarative function table: class-level generic
# methods (installed at import) and per-instance specialized entry points
# (compiled by ``_specialize`` with the resolved callable as a global).
# ---------------------------------------------------------------------------
_GEN_ENV = {
    "_nbytes": _nbytes,
    "PAX_ANY_SOURCE": PAX_ANY_SOURCE,
    "PAX_ANY_TAG": PAX_ANY_TAG,
    "PAX_SUCCESS": PAX_SUCCESS,
    "_check": H.check_handle,
    "_ZPK": H.ZERO_PAGE_KINDS,
}
_GEN_ENV.update({f"_HK_{k.name}": k for k in H.HandleKind})
_GEN_ENV.update({
    f"_UK_{k.name}": (H._USER_BIT >> H._USER_KIND_SHIFT) | int(k)
    for k in H.HandleKind
})


def _check_lines(entry: abi_spec.AbiEntry, indent: str = "    ",
                 inline: bool = False) -> list[str]:
    """Handle checks / coercions from the declared argument domains; with
    ``inline`` a well-formed handle costs two integer compares."""
    lines = []
    for a in entry.args:
        if a.kind == abi_spec.DATATYPE_VEC:
            lines.append(f"{indent}{a.name} = tuple({a.name})")
            lines.append(f"{indent}for _t in {a.name}:")
            lines.append(f"{indent}    _check(_t, _HK_{a.check_kind.name})")
        elif a.check_kind is not None:
            k = a.check_kind.name
            if inline:
                lines.append(
                    f"{indent}if {a.name} >> {_UKS} != _UK_{k} and ("
                    f"{a.name} < 0 or {a.name} > 1023 "
                    f"or _ZPK[{a.name}] is not _HK_{k}):"
                )
                lines.append(f"{indent}    _check({a.name}, _HK_{k})")
            else:
                lines.append(f"{indent}_check({a.name}, _HK_{k})")
        elif a.kind in (abi_spec.PERM, abi_spec.COUNTS):
            lines.append(f"{indent}{a.name} = tuple({a.name})")
    return lines


def _bytes_info(entry: abi_spec.AbiEntry, abi_name: str, with_datatype: bool) -> str:
    if not entry.bytes_arg:
        return "{}"
    dt = ", datatype" if with_datatype and entry.dtype_size_kwarg else ""
    comm_arg = next(a.name for a in entry.args if a.kind == abi_spec.COMM)
    return (f"{{'bytes': _nbytes({entry.bytes_arg}, {abi_name}{dt}), "
            f"'comm_handle': {comm_arg}}}")


def _status_lines(entry: abi_spec.AbiEntry) -> list[str]:
    if not entry.fills_status:
        return []
    return ["    if status is not None:",
            "        status.SOURCE = PAX_ANY_SOURCE",
            "        status.TAG = PAX_ANY_TAG",
            "        status.ERROR = PAX_SUCCESS"]


def _blocking_src(entry: abi_spec.AbiEntry) -> str:
    params = abi_spec.signature_src(entry, extra_kwargs=True)
    call_args = abi_spec.call_args_src(entry)
    lines = [f"def {entry.name}(self, {params}):"]
    lines += _check_lines(entry)
    lines.append(f"    _impl = self._table[{entry.name!r}]")
    lines.append("    if not self.tools:")
    lines.append(f"        _res = _impl({call_args})")
    lines.append("    else:")
    lines.append(f"        _info = {_bytes_info(entry, 'self', True)}")
    lines.append(
        f"        _res = self._dispatch_tools({entry.name!r}, _impl, "
        f"({call_args},), _info)"
    )
    lines += _status_lines(entry)
    lines.append("    return _res")
    return "\n".join(lines) + "\n"


def _nonblocking_src(entry: abi_spec.AbiEntry) -> str:
    params = abi_spec.signature_src(entry)
    call_args = abi_spec.call_args_src(entry)
    return (
        f"def i{entry.name}(self, {params}):\n"
        f"    return self._new_request(self.{entry.name}({call_args}), "
        f"'i{entry.name}')\n"
    )


def _spec_src(entry: abi_spec.AbiEntry, tooled: bool, nonblocking: bool) -> str:
    """Specialized entry-point source (no ``self``: ``_impl``, the tool
    tuples and the context are globals bound at specialization).  The
    nonblocking twin calls the backend's async start and pools a request."""
    params = abi_spec.signature_src(entry, extra_kwargs=not nonblocking)
    call_args = abi_spec.call_args_src(entry)
    fname = f"i{entry.name}" if nonblocking else entry.name
    lines = [f"def {fname}({params}):"]
    lines += _check_lines(entry, inline=True)
    if not tooled:
        lines.append(f"    _res = _impl({call_args})")
    else:
        lines.append(f"    _info = {_bytes_info(entry, '_abi', not nonblocking)}")
        lines.append(f"    _args = ({call_args},)")
        lines.append("    for _t in _tools:")
        lines.append(f"        _t.before({entry.name!r}, _args, _info)")
        lines.append(f"    _res = _impl({call_args})")
        lines.append("    for _t in _rtools:")
        lines.append(f"        _res = _t.after({entry.name!r}, _args, _info, _res)")
    if nonblocking:
        lines.append(f"    return _new_request(_res, 'i{entry.name}')")
    else:
        lines += _status_lines(entry)
        lines.append("    return _res")
    return "\n".join(lines) + "\n"


# code-object caches: source depends only on (entry, tooled?), so each shape
# compiles once per process and every context exec's it with its own globals
_SPEC_BLOCKING_SRC: dict = {}
_SPEC_NONBLOCKING_SRC: dict = {}


def _compile_cached(cache: dict, key, src_fn, name: str, env: dict):
    entry = cache.get(key)
    if entry is None:
        src = src_fn()
        entry = (compile(src, f"<abi_spec:{name}:specialized>", "exec"), src)
        cache[key] = entry
    code, src = entry
    ns: dict = {}
    exec(code, env, ns)
    fn = ns[name]
    fn.__generated_src__ = src
    fn.__qualname__ = f"PaxABI.{name} [specialized]"
    return fn


def _plan_init_src(entry: abi_spec.AbiEntry) -> str:
    params = abi_spec.signature_src(entry)
    call_args = abi_spec.call_args_src(entry)
    return (
        f"def {entry.name}_init(self, {params}):\n"
        f"    return self._make_plan({entry.name!r}, ({call_args},))\n"
    )


def _install_generated_methods() -> None:
    for entry in abi_spec.ABI_TABLE:
        fn = abi_spec.compile_method(_blocking_src(entry), _GEN_ENV, entry.name)
        fn.__qualname__ = f"PaxABI.{entry.name}"
        setattr(PaxABI, entry.name, fn)
        if entry.nonblocking:
            ifn = abi_spec.compile_method(
                _nonblocking_src(entry), _GEN_ENV, f"i{entry.name}"
            )
            ifn.__qualname__ = f"PaxABI.i{entry.name}"
            setattr(PaxABI, f"i{entry.name}", ifn)
        if entry.persistent:
            pfn = abi_spec.compile_method(
                _plan_init_src(entry), _GEN_ENV, f"{entry.name}_init"
            )
            pfn.__qualname__ = f"PaxABI.{entry.name}_init"
            pfn.__doc__ = (
                f"Persistent-plan constructor for {entry.name!r} (MPI-4 "
                f"{entry.impl_name}_init): binds arguments and hoists all "
                "per-call dispatch work to plan time; returns a Plan whose "
                "start() issues the collective and wait() completes it."
            )
            setattr(PaxABI, f"{entry.name}_init", pfn)


_install_generated_methods()
