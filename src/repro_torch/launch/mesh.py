"""Production mesh construction over the ``torch.distributed`` world.

Functions, not module-level constants, so importing this module starts and
reads nothing: the dry run (``launch/dryrun.py``) starts a fake world of 256
or 512 ranks first, a launcher a real one.  One process is one rank, and a
mesh is the port's :class:`~repro_torch.core.Mesh`: named axes over the
world's ranks, row-major, and the device this rank computes on.
"""
from __future__ import annotations

import torch.distributed as tdist

from ..core import Mesh
from ..runtime.device import resolve_device

#: (shape, axis names) of the production meshes (the reference's 256 and
#: 512 TPU v5e chips; here as many ranks)
POD1 = ((16, 16), ("data", "model"))
POD2 = ((2, 16, 16), ("pod", "data", "model"))


def _world() -> int:
    if not tdist.is_initialized():
        raise RuntimeError("start torch.distributed first: the mesh lays out its world")
    return tdist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """(16, 16) data x model for one pod; (2, 16, 16) pod x data x model
    for two.  The running world must have 256 or 512 ranks to match."""
    shape, axes = POD2 if multi_pod else POD1
    size = 1
    for n in shape:
        size *= n
    world = _world()
    if world != size:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh needs a world of "
                         f"{size} ranks, this one has {world}")
    return Mesh(axes, shape, resolve_device(device))


def make_host_mesh(model_axis: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over the running world (one rank when none is
    running), ``model_axis`` ranks on the model axis."""
    n = tdist.get_world_size() if tdist.is_initialized() else 1
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide the world of {n}")
    return Mesh(("data", "model"), (n // model_axis, model_axis), resolve_device(device))
