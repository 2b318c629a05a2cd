"""The declarative ABI function table — one spec driving the whole stack.

The paper's core artifact is a *standard function table*: a fixed set of
symbols with fixed handle semantics that any implementation can be resolved
against at init (the ``dlopen``/``dlsym`` protocol of §6.2), and that a
translation layer (Mukautuva) can be generated against mechanically, one
wrapper per entry point.

This module is that table, as data.  Every ABI entry point is one
:class:`AbiEntry` row declaring:

* its name and argument list, with each argument's *domain*
  (:class:`Arg` kind) — which drives handle checking in the ABI layer and
  handle conversion in Mukautuva;
* its byte-accounting rule (``bytes_arg`` — which argument is the payload
  the interposition tools should account);
* whether a nonblocking ``i*`` variant exists (``nonblocking``);
* the Mukautuva conversion signature: the foreign-library symbol
  (``impl_name``), the return protocol (``muk_ret``), and whether converted
  handle vectors must be kept alive in the request map until completion
  (``temps`` — the §6.2 ``alltoallw`` worst case);
* its negotiation **tier** (``REQUIRED`` entries must resolve natively at
  ``pax_init`` or init fails; ``OPTIONAL`` entries admit partial backends)
  and, for optional entries, an **emulation recipe** (:class:`Recipe`) — a
  declarative expression of the entry in terms of *other entries*, which
  negotiation compiles into a closure when the backend does not export the
  symbol but the recipe's dependency chain grounds out in entries it does.

Consumers generate their layer from the table instead of hand-writing each
entry point four times:

* :mod:`repro_torch.core.abi` generates ``PaxABI``'s blocking and nonblocking
  methods (with a precompiled zero-tool fast path);
* :mod:`repro_torch.core.backends.base` generates unsupported-operation
  placeholders, so ``supports()`` can report a backend's capabilities;
* :mod:`repro_torch.core.mukautuva` generates the WRAP_* translation
  wrappers;
* ``PaxABI.__init__`` performs dlsym-style *negotiation*: every entry is
  resolved against the backend once at init, so a missing entry point is a
  clean ``PAX_ERR_UNSUPPORTED_OPERATION`` at init time, never mid-step.

Adding an entry point is one row here plus the per-backend implementation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from . import emulation as em
from . import handles as H

# ---------------------------------------------------------------------------
# Negotiation tiers.  A REQUIRED entry must be natively resolvable at init
# (it is either a pure handle query or the ground every recipe stands on);
# an OPTIONAL entry may be emulated via its recipe, or left unresolved —
# in which case *calling* it raises PAX_ERR_UNSUPPORTED_OPERATION, init
# does not.
# ---------------------------------------------------------------------------
REQUIRED = "required"
OPTIONAL = "optional"
#: ULFM-style fault-tolerance extension entries (comm_revoke / comm_shrink /
#: comm_agree / comm_failure_ack / comm_get_failed).  Negotiates exactly like
#: OPTIONAL — native when the backend exports the symbol, recipe-emulated
#: otherwise — but is reported as its own tier by ``capabilities()`` so a
#: caller can ask "does this stack have a fault model?" as one question.
FAULT = "fault"


@dataclasses.dataclass(frozen=True)
class Recipe:
    """A declarative emulation of one entry in terms of other entries.

    ``deps`` names the function-table entries the emulation calls; ``build``
    is the compiler (see :mod:`repro_torch.core.emulation`): it receives an
    ``EmulationContext`` whose ``dep(name)`` returns the *resolved* callable
    for each dependency — native backend method or previously-built
    emulation — and returns a closure with the entry's backend signature.
    ``validate_table`` guarantees the dependency graph is acyclic and
    computes the topological build order.

    ``plan`` is the optional *persistent-plan* compiler: given a
    ``PlanContext`` and the plan-time bound arguments (payloads as abstract
    shapes), it returns a bare run closure with every chain decision —
    padding, slicing, dependency resolution — already taken, so a plan
    ``start()`` on an emulated entry costs the same as on a native one.
    Entries without one still get a generic plan (argument freezing around
    the built emulation closure).

    ``plan_group`` is the optional *plan-group* compiler (the MPI
    ``Startall`` analogue): given a ``PlanContext`` and a list of
    bound-argument tuples — one per group member, all sharing the same
    non-payload arguments — it returns one fused run closure executing the
    recipe **per stage across members** (e.g. every member's
    reduce-scatter leg before any all-gather leg, each stage itself fused
    through ``PlanContext.plan_group_dep`` when the backend has a group
    hook).  Returning ``None`` declines the fusion and the group falls
    back to per-member plan runs.
    """

    deps: Tuple[str, ...]
    build: Callable
    plan: Optional[Callable] = None
    plan_group: Optional[Callable] = None

# ---------------------------------------------------------------------------
# Argument domains.  The domain decides (a) the ABI-layer handle check and
# (b) the Mukautuva conversion applied before the foreign library sees it.
# ---------------------------------------------------------------------------
PAYLOAD = "payload"        # array / pytree payload — passed through
OP = "op"                  # op handle      -> check OP,       muk _convert_op
COMM = "comm"              # comm handle    -> check COMM,     muk _convert_comm
DATATYPE = "datatype"      # dtype handle   -> check DATATYPE, muk _convert_dtype
DATATYPE_VEC = "datatype_vec"  # vector of dtype handles -> per-element both
ROOT = "root"              # rank integer — passed through
AXIS = "axis"              # array-axis integer — passed through
COUNTS = "counts"          # per-peer count vector — coerced to tuple
PERM = "perm"              # (src, dst) permutation — coerced to tuple

_CHECK_KIND = {
    OP: H.HandleKind.OP,
    COMM: H.HandleKind.COMM,
    DATATYPE: H.HandleKind.DATATYPE,
    DATATYPE_VEC: H.HandleKind.DATATYPE,
}

class _NoDefault:
    def __repr__(self) -> str:  # pragma: no cover
        return "<required>"


_NO_DEFAULT = _NoDefault()


@dataclasses.dataclass(frozen=True)
class Arg:
    name: str
    kind: str
    default: object = _NO_DEFAULT

    @property
    def has_default(self) -> bool:
        return self.default is not _NO_DEFAULT

    @property
    def check_kind(self) -> Optional[H.HandleKind]:
        return _CHECK_KIND.get(self.kind)


@dataclasses.dataclass(frozen=True)
class AbiEntry:
    """One row of the standard function table."""

    name: str                      # ABI function name ("allreduce")
    impl_name: str                 # foreign-library symbol ("Allreduce")
    args: Tuple[Arg, ...]
    backend_method: str = ""       # Backend method name; defaults to `name`
    nonblocking: bool = False      # generate the i<name> variant
    bytes_arg: Optional[str] = None  # payload arg for tool byte accounting
    dtype_size_kwarg: bool = False   # extra `datatype=None` kwarg for bytes
    fills_status: bool = False       # ABI-level `status=None` out-param
    muk_ret: str = "value"           # "value" | "rc_only" | "status"
    temps: bool = False              # stash converted vectors for the request map
    tier: str = OPTIONAL             # REQUIRED | OPTIONAL | FAULT (negotiation tier)
    recipe: Optional[Recipe] = None  # emulation of this entry, if not REQUIRED
    #: generate the MPI-4 persistent variant (``<name>_init`` plan
    #: constructor).  ``None`` (default) derives from ``nonblocking`` — every
    #: entry with an ``i*`` twin gets a plan constructor, the way MPI-4 gave
    #: every nonblocking collective a persistent ``_init`` twin.
    persistent: Optional[bool] = None
    #: end-to-end integrity rule for the opt-in checksummed-wire mode
    #: (the transport tier).  ``"replicated"`` — the entry's result is identical on every
    #: member (allreduce/bcast/allgather), so a fused cross-member checksum
    #: *agreement* detects a corrupted payload; ``"conserved"`` — under
    #: ``PAX_SUM`` the entry conserves the payload total
    #: (reduce_scatter), so an input-vs-output checksum *conservation* check
    #: does.  ``None`` — no plan-time checksum envelope for this entry.
    integrity: Optional[str] = None

    def __post_init__(self):
        if not self.backend_method:
            object.__setattr__(self, "backend_method", self.name)
        if self.persistent is None:
            object.__setattr__(self, "persistent", self.nonblocking)

    @property
    def payload_args(self) -> Tuple[int, ...]:
        """Indices of the PAYLOAD arguments (the plan ``start`` signature)."""
        return tuple(i for i, a in enumerate(self.args) if a.kind == PAYLOAD)

    @property
    def temps_attr(self) -> str:
        """Backend attribute holding per-call temporaries (§6.2 request map)."""
        return f"last_{self.name}_temps"


def _e(name, impl_name, args, **kw) -> AbiEntry:
    return AbiEntry(name=name, impl_name=impl_name, args=tuple(args), **kw)


# ---------------------------------------------------------------------------
# The standard function table.
# ---------------------------------------------------------------------------
ABI_TABLE: Tuple[AbiEntry, ...] = (
    # -- queries (REQUIRED: pure handle queries every implementation can
    #    answer; also the ground most recipes stand on) --------------------
    _e("comm_size", "Comm_size", [Arg("comm", COMM)], backend_method="size",
       tier=REQUIRED),
    _e("comm_rank", "Comm_rank", [Arg("comm", COMM)], backend_method="rank",
       tier=REQUIRED),
    _e("type_size", "Type_size", [Arg("datatype", DATATYPE)], tier=REQUIRED),
    # -- collectives (OPTIONAL; recipes express the derived ones) ----------
    _e("allreduce", "Allreduce",
       [Arg("x", PAYLOAD), Arg("op", OP), Arg("comm", COMM)],
       nonblocking=True, bytes_arg="x", dtype_size_kwarg=True,
       integrity="replicated",
       recipe=Recipe(("reduce_scatter", "allgather", "comm_size"),
                     em.build_allreduce, em.plan_allreduce,
                     em.plan_group_allreduce)),
    _e("reduce", "Reduce",
       [Arg("x", PAYLOAD), Arg("op", OP), Arg("root", ROOT), Arg("comm", COMM)],
       nonblocking=True, bytes_arg="x",
       recipe=Recipe(("allreduce",), em.build_reduce, em.plan_reduce,
                     em.plan_group_reduce)),
    _e("bcast", "Bcast",
       [Arg("x", PAYLOAD), Arg("root", ROOT), Arg("comm", COMM)],
       nonblocking=True, bytes_arg="x", integrity="replicated",
       recipe=Recipe(("allreduce", "comm_rank"), em.build_bcast,
                     em.plan_bcast)),
    _e("reduce_scatter", "Reduce_scatter",
       [Arg("x", PAYLOAD), Arg("op", OP), Arg("comm", COMM), Arg("axis", AXIS, 0)],
       nonblocking=True, bytes_arg="x", integrity="conserved"),
    _e("allgather", "Allgather",
       [Arg("x", PAYLOAD), Arg("comm", COMM), Arg("axis", AXIS, 0)],
       nonblocking=True, bytes_arg="x", integrity="replicated"),
    _e("alltoall", "Alltoall",
       [Arg("x", PAYLOAD), Arg("comm", COMM),
        Arg("split_axis", AXIS, 0), Arg("concat_axis", AXIS, 0)],
       nonblocking=True, bytes_arg="x",
       recipe=Recipe(("allgather", "comm_rank", "comm_size"),
                     em.build_alltoall)),
    _e("alltoallv", "Alltoallv",
       [Arg("x", PAYLOAD), Arg("sendcounts", COUNTS), Arg("recvcounts", COUNTS),
        Arg("comm", COMM)],
       nonblocking=True, bytes_arg="x",
       recipe=Recipe(("alltoall", "comm_size"), em.build_alltoallv)),
    _e("alltoallw", "Alltoallw",
       [Arg("blocks", PAYLOAD), Arg("sendtypes", DATATYPE_VEC),
        Arg("recvtypes", DATATYPE_VEC), Arg("comm", COMM)],
       nonblocking=True, bytes_arg="blocks", temps=True,
       recipe=Recipe(("alltoall",), em.build_alltoallw)),
    _e("scan", "Scan",
       [Arg("x", PAYLOAD), Arg("op", OP), Arg("comm", COMM)],
       nonblocking=True, bytes_arg="x",
       recipe=Recipe(("allgather", "comm_rank", "comm_size"), em.build_scan,
                     em.plan_scan)),
    _e("exscan", "Exscan",
       [Arg("x", PAYLOAD), Arg("op", OP), Arg("comm", COMM)],
       nonblocking=True, bytes_arg="x",
       recipe=Recipe(("allgather", "comm_rank", "comm_size"), em.build_exscan,
                     em.plan_exscan)),
    _e("sendrecv", "Sendrecv",
       [Arg("x", PAYLOAD), Arg("perm", PERM), Arg("comm", COMM)],
       nonblocking=True, bytes_arg="x", fills_status=True, muk_ret="status"),
    _e("barrier", "Barrier", [Arg("comm", COMM)],
       nonblocking=True, muk_ret="rc_only",
       recipe=Recipe(("allreduce",), em.build_barrier, em.plan_barrier)),
    _e("scatter", "Scatter",
       [Arg("x", PAYLOAD), Arg("root", ROOT), Arg("comm", COMM), Arg("axis", AXIS, 0)],
       nonblocking=True, bytes_arg="x",
       recipe=Recipe(("bcast", "comm_rank", "comm_size"), em.build_scatter)),
    _e("gather", "Gather",
       [Arg("x", PAYLOAD), Arg("root", ROOT), Arg("comm", COMM), Arg("axis", AXIS, 0)],
       nonblocking=True, bytes_arg="x",
       recipe=Recipe(("allgather",), em.build_gather, em.plan_gather)),
    # -- fault tier (ULFM-style extension entries; "The Case for ABI
    #    Interoperability in a Fault Tolerant MPI").  Blocking-only — the
    #    recovery path is control plane, not hot path.  Every entry carries a
    #    recipe grounding in REQUIRED queries, so even `minimal` negotiates a
    #    complete fault model; backends that lack the symbols (ompix) fall
    #    back to the same recipes through Mukautuva, whose generated wrappers
    #    translate foreign PROC_FAILED/REVOKED rcs when the symbols do exist.
    _e("comm_revoke", "Comm_revoke", [Arg("comm", COMM)],
       muk_ret="rc_only", tier=FAULT,
       recipe=Recipe((), em.build_comm_revoke)),
    _e("comm_failure_ack", "Comm_failure_ack", [Arg("comm", COMM)],
       muk_ret="rc_only", tier=FAULT,
       recipe=Recipe((), em.build_comm_failure_ack)),
    _e("comm_get_failed", "Comm_get_failed", [Arg("comm", COMM)],
       tier=FAULT,
       recipe=Recipe((), em.build_comm_get_failed)),
    _e("comm_agree", "Comm_agree",
       [Arg("flag", PAYLOAD), Arg("comm", COMM)],
       tier=FAULT,
       recipe=Recipe((), em.build_comm_agree)),
    _e("comm_shrink", "Comm_shrink", [Arg("comm", COMM)],
       tier=FAULT,
       recipe=Recipe(("comm_agree", "comm_get_failed"),
                     em.build_comm_shrink)),
)


# ---------------------------------------------------------------------------
# Spec-load validation + the emulation build order.
# ---------------------------------------------------------------------------
def validate_table(table: Tuple[AbiEntry, ...]) -> Tuple[str, ...]:
    """Validate tiers/recipes and return the topological resolution order.

    Raises ``ValueError`` at spec-load time (never at ``pax_init``) when:

    * two rows share a name;
    * a recipe depends on an entry the table does not define;
    * a REQUIRED entry carries a recipe (required means *natively* required —
      an emulable entry is by definition optional);
    * the recipe dependency graph has a cycle (no resolution order exists).

    The returned order lists every entry name with all recipe dependencies
    before their dependents, so negotiation can build emulation closures in
    one forward pass.
    """
    by_name: dict = {}
    for entry in table:
        if entry.name in by_name:
            raise ValueError(f"duplicate function-table entry {entry.name!r}")
        by_name[entry.name] = entry
    for entry in table:
        if entry.recipe is None:
            continue
        if entry.tier == REQUIRED:
            raise ValueError(
                f"required entry {entry.name!r} carries an emulation recipe"
            )
        for dep in entry.recipe.deps:
            if dep not in by_name:
                raise ValueError(
                    f"recipe for {entry.name!r} depends on unknown entry {dep!r}"
                )
    # DFS topo sort over recipe edges; entries without recipes are leaves.
    order: list = []
    state: dict = {}  # name -> 1 (on stack) | 2 (done)

    def visit(name: str, chain: tuple) -> None:
        if state.get(name) == 2:
            return
        if state.get(name) == 1:
            cycle = chain[chain.index(name):] + (name,)
            raise ValueError(
                "recipe dependency cycle: " + " -> ".join(cycle)
            )
        state[name] = 1
        recipe = by_name[name].recipe
        if recipe is not None:
            for dep in recipe.deps:
                visit(dep, chain + (name,))
        state[name] = 2
        order.append(name)

    for entry in table:
        visit(entry.name, ())
    return tuple(order)


#: entries by name (negotiation + capability reporting index)
ENTRY_BY_NAME: dict = {e.name: e for e in ABI_TABLE}

#: topological resolution order — recipe deps always precede dependents
EMULATION_ORDER: Tuple[str, ...] = validate_table(ABI_TABLE)

# ---------------------------------------------------------------------------
# Codegen helpers shared by the generating layers.
# ---------------------------------------------------------------------------
def signature_src(entry: AbiEntry, *, extra_kwargs: bool = False) -> str:
    """``x, op, comm, axis=0`` source text for an entry's parameter list.

    With ``extra_kwargs`` the ABI-level-only trailing kwargs are included
    (``datatype=`` for byte accounting, ``status=`` for the out-param).
    """
    parts = []
    for a in entry.args:
        parts.append(f"{a.name}={a.default!r}" if a.has_default else a.name)
    if extra_kwargs and entry.dtype_size_kwarg:
        parts.append("datatype=None")
    if extra_kwargs and entry.fills_status:
        parts.append("status=None")
    return ", ".join(parts)


def call_args_src(entry: AbiEntry) -> str:
    """``x, op, comm, axis`` — forwarding text in table order."""
    return ", ".join(a.name for a in entry.args)


def compile_method(src: str, env: dict, name: str):
    """Compile generated method source; tag it for introspection."""
    ns: dict = {}
    code = compile(src, f"<abi_spec:{name}>", "exec")
    exec(code, env, ns)
    fn = ns[name]
    fn.__generated_src__ = src
    return fn
