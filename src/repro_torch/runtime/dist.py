"""DistContext: the distributed-runtime handle threaded through the stack.

Bundles the ABI context, the process mesh and the standard communicators
(data-parallel group, tensor-parallel group).  Model and training code
receive this object and never touch backend internals.

One process is one rank.  :func:`init_world` starts ``torch.distributed``
(NCCL on the card, gloo on the CPU) from an explicit address — a world of
one still gets a real process group, through a ``file://`` store in a
fresh temporary directory (removed when the process exits), so every ABI
call on the training path is a real collective call.
"""
from __future__ import annotations

import atexit
import dataclasses
import math
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ..core import PAX_COMM_WORLD, Mesh, PaxABI, pax_init
from ..core.errors import PAX_ERR_UNSUPPORTED_OPERATION, PaxError
from .device import resolve_device


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

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis]

    def drop_zero1_plans(self) -> None:
        """Retire the zero1 plans' and groups' request slots."""
        if self.zero1_plans is not None:
            self.zero1_plans.free()
            self.zero1_plans = None


def init_world(device: torch.device, world_size: int = 1, rank: int = 0,
               init_method: Optional[str] = None) -> None:
    """Start the default process group unless one is running.

    ``init_method`` is the rendezvous (``tcp://localhost:<port>`` or
    ``file://<path>``); a world of one may omit it.  A running group must
    have the requested size.
    """
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of size {dist.get_world_size()} is already "
                f"running; asked for {world_size}")
        return
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


def make_dist(
    *,
    model_axis: int = 1,
    impl: Optional[str] = None,
    tools=(),
    compression: Optional[str] = None,
    device=None,
    world_size: int = 1,
    rank: int = 0,
    init_method: Optional[str] = None,
) -> DistContext:
    """Build the distributed context: start the world (see
    :func:`init_world`), lay it out as a ``(data, model)`` mesh with
    ``model_axis`` ranks on the model axis, and register the data- and
    tensor-parallel communicators.  ``device`` defaults to the card."""
    if compression is not None:
        raise PaxError(
            PAX_ERR_UNSUPPORTED_OPERATION,
            f"wire compression {compression!r} needs the ring backend, which "
            "is not ported yet")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if world_size % model_axis:
        raise ValueError(f"world size {world_size} is not a multiple of "
                         f"model_axis={model_axis}")
    init_world(dev, world_size, rank, init_method)
    mesh = Mesh(("data", "model"), (world_size // model_axis, model_axis), dev)
    abi = pax_init(mesh, impl=impl, tools=tools)
    tp_axis = "model"
    dp_axes = ("data",)
    dp_comm = abi.comm_from_axes(dp_axes, "dp")
    tp_comm = abi.comm_from_axes((tp_axis,), "tp")
    return DistContext(abi, mesh, dp_axes, tp_axis, dp_comm, tp_comm)
