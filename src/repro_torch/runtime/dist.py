"""DistContext: the distributed-runtime handle threaded through the stack.

Bundles the ABI context, the process mesh, the axis rules
(``runtime/sharding.py``'s ``production_rules`` for the mesh) and the
standard communicators (data-parallel group, tensor-parallel group, and
the pipeline's stage group once ``runtime.pipeline.make_pp_dist`` adds
it).  The mesh is ``(data, model)`` by default; any leading axis name may
replace ``data`` (``("pod", "model")`` for a pipeline over the ``pod``
axis), and every axis but the model axis is data-parallel, as in the
reference.  Model and training code
receive this object and never touch backend internals.  After an elastic
recovery, :func:`survivor_mesh` and ``make_dist(mesh=...)`` build the
context over the surviving ranks (their groups created by the survivors
alone, ``use_local_synchronization``), the counterpart of the reference's
``survivor_mesh``.  With a compressed
gradient wire it also carries a second context on ``ring-<compression>``,
whose handles are allocated in the same order (:func:`dp_comm_of`).

One process is one rank.  :func:`init_world` starts ``torch.distributed``
(NCCL on the card, gloo on the CPU) from an explicit address — a world of
one still gets a real process group, through a ``file://`` store in a
fresh temporary directory (removed when the process exits), so every ABI
call on the training path is a real collective call.

:meth:`DistContext.shutdown` is the one teardown of every rank program, the
launcher and ``chip_smoke.py`` (directly, or as the exit of a ``with``
block): it completes and frees every request and plan, meets the other
ranks at a barrier, drops the contexts' process-group references and
destroys the world it started.  Left to the interpreter's exit, gloo
process groups still referenced from the ABI's reference cycles were
destroyed during finalization, where one rank of two now and then died of
``terminate called without an active exception``.
"""
from __future__ import annotations

import atexit
import dataclasses
import gc
import math
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ..core import PAX_COMM_WORLD, Mesh, PaxABI, pax_init
from .device import resolve_device
from .sharding import AxisRules, production_rules


@dataclasses.dataclass
class DistContext:
    abi: PaxABI
    mesh: Mesh
    dp_axes: tuple[str, ...]
    tp_axis: str
    dp_comm: int
    tp_comm: int
    world: int = PAX_COMM_WORLD
    # persistent zero1 collective plans + their Startall groups
    # (grad_sync.Zero1Plans), built once by train_loop.init_state
    zero1_plans: Optional[object] = None
    #: the ring-<compression> context of a compressed gradient wire
    abi_compressed: Optional[PaxABI] = None
    #: whether building this context started the process group
    owns_world: bool = False
    #: further ABI contexts built on this world, torn down with it
    extra_contexts: list = dataclasses.field(default_factory=list)
    #: an elastic recovery shrank past this context: a member is gone, so
    #: its teardown meets nobody (see :meth:`shutdown`)
    degraded: bool = False
    #: the deadline of the ZeRO-1 step's waits (None: a dropped collective
    #: hangs, faithfully; a bound raises ``PAX_ERR_TIMEOUT`` instead)
    wait_timeout_s: Optional[float] = None
    #: the logical-axis rules of this mesh (``production_rules``)
    rules: Optional[AxisRules] = None
    #: the pipeline's stage communicator (``runtime.pipeline.make_pp_dist``)
    pp_comm: Optional[int] = None

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis]

    @property
    def tp_group(self):
        """The ``torch.distributed`` process group of ``tp_comm`` (the dense
        family's tensor-parallel collectives run on it directly, beside the
        ABI, ``models/tensor_parallel.py``)."""
        return self.abi.comms.info(self.tp_comm).group

    @property
    def dp_group(self):
        """The ``torch.distributed`` process group of ``dp_comm`` (the
        ``gspmd`` step's collectives run on it directly, beside the ABI)."""
        return self.abi.comms.info(self.dp_comm).group

    def drop_zero1_plans(self) -> None:
        """Retire the zero1 plans' and groups' request slots."""
        if self.zero1_plans is not None:
            self.zero1_plans.free()
            self.zero1_plans = None

    def shutdown(self, failed: bool = False) -> None:
        """Tear the context down in an order every rank shares:

        1. complete every live request and active plan or group of both ABI
           contexts and of ``extra_contexts`` and free their plans
           (``outstanding_requests == 0``);
        2. barrier on the world, so no rank leaves while another still
           talks to it;
        3. drop the contexts' process-group references and, when this
           context started the world, ``destroy_process_group`` — the
           groups are destroyed here, not at interpreter exit.

        A rank leaving on an error (``failed``), or a context an elastic
        recovery left behind (``degraded``: a member is gone), skips steps 1
        and 2 — the other ranks may be blocked in a collective it will never
        join — and only drops and destroys its groups.  The context answers
        no further collective."""
        contexts = [a for a in (self.abi, self.abi_compressed, *self.extra_contexts)
                    if a is not None]
        if failed or self.degraded:
            self.zero1_plans = None
        else:
            self.drop_zero1_plans()
            for abi in contexts:
                abi.quiesce()
            world = self.abi.comms.info_by_handle.get(PAX_COMM_WORLD)
            if dist.is_initialized() and world is not None and world.group is not None:
                dist.barrier(group=world.group)
        for abi in contexts:
            abi.release(abandon=failed)
        self.extra_contexts.clear()
        gc.collect()
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self) -> "DistContext":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """``with make_dist(...) as d:`` ends in :meth:`shutdown`, a failed
        one when the block raised."""
        self.shutdown(failed=exc_type is not None)


def init_world(device: torch.device, world_size: int = 1, rank: int = 0,
               init_method: Optional[str] = None) -> bool:
    """Start the default process group unless one is running; True when
    this call started it.

    ``init_method`` is the rendezvous (``tcp://localhost:<port>`` or
    ``file://<path>``); a world of one may omit it.  A running group must
    have the requested size.
    """
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of size {dist.get_world_size()} is already "
                f"running; asked for {world_size}")
        return False
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs init_method")
        store_dir = tempfile.mkdtemp(prefix="pax-world-")
        atexit.register(shutil.rmtree, store_dir, ignore_errors=True)
        init_method = f"file://{Path(store_dir) / 'store'}"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


def make_dist(
    *,
    model_axis: int = 1,
    impl=None,
    tools=(),
    compression: Optional[str] = None,
    device=None,
    world_size: int = 1,
    rank: int = 0,
    init_method: Optional[str] = None,
    integrity: Optional[bool] = None,
    mesh: Optional[Mesh] = None,
    axis_names: tuple = ("data", "model"),
) -> DistContext:
    """Build the distributed context: start the world (see
    :func:`init_world`), lay it out as an ``axis_names`` mesh (default
    ``(data, model)``) with ``model_axis`` ranks on the last axis and the
    rest on the first, register the data-parallel (every axis but the
    model axis) and tensor-parallel communicators, and build the mesh's
    axis rules.  ``compression`` (``"bf16"`` or
    ``"int8"``) adds the ``ring-<compression>`` context of the compressed
    gradient wire.  ``device`` defaults to the card.  ``impl`` is a backend
    name or a prebuilt backend (a ``faulty:`` wrapper with its schedule);
    ``integrity`` opts into the checksummed wire (default:
    ``PAX_WIRE_INTEGRITY``).  ``mesh`` (a :func:`survivor_mesh` of the
    running world) builds the context over those ranks only."""
    if compression not in (None, "bf16", "int8"):
        raise ValueError(f"unknown gradient compression {compression!r}")
    if mesh is not None:
        started = False
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if world_size % model_axis:
            raise ValueError(f"world size {world_size} is not a multiple of "
                             f"model_axis={model_axis}")
        if len(axis_names) != 2:
            raise ValueError(f"a mesh has two axes here (leading, model), got {axis_names}")
        started = init_world(dev, world_size, rank, init_method)
        mesh = Mesh(tuple(axis_names), (world_size // model_axis, model_axis), dev)
    abi = pax_init(mesh, impl=impl, tools=tools, integrity=integrity)
    names = tuple(mesh.axis_names)
    tp_axis = "model" if "model" in names else names[-1]
    dp_axes = tuple(a for a in names if a != tp_axis)
    dp_comm = abi.comm_from_axes(dp_axes, "dp")
    tp_comm = abi.comm_from_axes((tp_axis,), "tp")
    abi_c = None
    if compression is not None:
        abi_c = pax_init(mesh, impl=f"ring-{compression}", tools=tools)
        abi_c.comm_from_axes(dp_axes, "dp")  # mirror the handle allocation order
    rules = production_rules(pod="pod" in names, tp_axis=tp_axis,
                             data_axes=tuple(a for a in dp_axes if a != "pod"),
                             axis_sizes=dict(mesh.shape), mesh=mesh)
    return DistContext(abi, mesh, dp_axes, tp_axis, dp_comm, tp_comm,
                       abi_compressed=abi_c, owns_world=started, rules=rules)


def survivor_mesh(mesh: Mesh, failed_ranks, keep: Optional[int] = None) -> Mesh:
    """The mesh over the ranks that survive ``failed_ranks`` (positions of
    ``mesh``, the ABI's rank convention): the data axis shrinks by the
    casualties, the model axis keeps its extent, so the failure set must be
    whole model-parallel groups.  ``keep`` trims the data axis to its first
    ``keep`` rows (the elastic policy's power-of-two trim)."""
    failed = frozenset(failed_ranks)
    names = tuple(mesh.axis_names)
    tail = math.prod(mesh.sizes[1:])
    world = mesh.world_ranks
    ranks = tuple(world[r] for r in range(mesh.size) if r not in failed)
    if not ranks or len(ranks) % tail:
        raise ValueError(
            f"cannot shrink mesh {mesh.shape} by ranks {sorted(failed)}: "
            f"{len(ranks)} survivors do not fill the non-data axes {list(mesh.sizes[1:])}")
    rows = len(ranks) // tail if keep is None else keep
    if not 1 <= rows <= len(ranks) // tail:
        raise ValueError(f"cannot keep {rows} data rows of {len(ranks) // tail}")
    return Mesh(names, (rows,) + tuple(mesh.sizes[1:]), mesh.device,
                ranks=ranks[:rows * tail])


def dp_comm_of(dist_ctx: DistContext, compressed: bool) -> tuple[PaxABI, int]:
    """The (abi, comm) pair gradient traffic uses: the ``ring-<compression>``
    context when ``compressed`` and one exists (its handles are allocated in
    the same order, so ``dp_comm`` names the same group there)."""
    if compressed and dist_ctx.abi_compressed is not None:
        return dist_ctx.abi_compressed, dist_ctx.dp_comm
    return dist_ctx.abi, dist_ctx.dp_comm
