"""Logical-axis sharding rules (MaxText-style) — the reference's
``repro.runtime.sharding`` on plain tuples.

Model code names the *logical* axes of a tensor (``"batch"``, ``"seq"``,
``"heads"``, ``"experts"``...) and the active :class:`AxisRules` maps them
to mesh axes.  The production mapping (:func:`production_rules`):

    batch   -> ("pod", "data")     (data parallel, incl. the pod axis)
    seq     -> "model" IF sequence_parallel else None
    heads   -> "model"             (tensor parallel)
    ffn     -> "model"
    vocab   -> "model"
    embed   -> None                (replicated; FSDP shards the *params*)
    experts -> "model"             (expert parallel)
    kv      -> "model"             (decode-time KV-head sharding)

A spec is a tuple with one entry per dimension: ``None``, a mesh-axis
name, or a tuple of names — the reference's ``PartitionSpec`` read as a
tuple.  :meth:`AxisRules.placements` turns a spec into
``torch.distributed.tensor`` placements (``Shard(dim)`` or
``Replicate()``, one per mesh axis), the form a ``DeviceMesh`` takes.

One process is one rank, so every tensor a rank holds is already its own
part: :func:`shard` is the identity here (the reference's is a GSPMD
constraint, advisory where no mesh is active).  Which parameters a rank
holds only a part of is written down by the models' ``spec_*`` functions
(``ModelApi.param_specs``); a rank holds its block of the leaves the port
splits — the moe family's experts under expert parallelism, the dense
family's heads, FFN and vocabulary over the model axis and, under
``gspmd``, its FSDP block (``models.tensor_parallel.held_layout``,
``models/tensor_parallel.py``) — and every other leaf whole.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence, Union

Axis = Union[None, str, tuple]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    rules: dict
    enabled: bool = True
    #: the mesh the rules were built for (the port's ``Mesh``), if any
    mesh: object = None
    #: mesh axis sizes; when known, a rule that would shard a dimension
    #: unevenly is dropped (an even split is what a production config wants)
    axis_sizes: dict = dataclasses.field(default_factory=dict)

    def to_spec(self, *logical: Optional[str]) -> tuple:
        return tuple(self.rules.get(name) if name else None for name in logical)

    def _axes_size(self, axes: Axis) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            return self.axis_sizes.get(axes, 1)
        out = 1
        for a in axes:
            out *= self.axis_sizes.get(a, 1)
        return out

    def to_spec_for(self, shape: Sequence[int], *logical: Optional[str]) -> tuple:
        """The spec of a tensor of ``shape``: a rule is dropped where the
        axes' size does not divide the dimension, and a mesh axis appears
        at most once (with sequence parallelism ``seq`` and ``heads`` both
        map to the model axis: the earlier dimension wins)."""
        parts = []
        used: set = set()
        for dim, name in zip(shape, logical):
            axes = self.rules.get(name) if name else None
            if axes is not None and self.axis_sizes:
                size = self._axes_size(axes)
                if size <= 1 or dim % size != 0:
                    axes = None
            if axes is not None:
                flat = (axes,) if isinstance(axes, str) else tuple(axes)
                if any(a in used for a in flat):
                    axes = None
                else:
                    used.update(flat)
            parts.append(axes)
        return tuple(parts)

    def placements(self, shape: Sequence[int], mesh, *logical: Optional[str]) -> tuple:
        """``to_spec_for``'s spec as ``torch.distributed.tensor`` placements
        over ``mesh`` (a ``DeviceMesh`` with ``mesh_dim_names``, or the
        port's ``Mesh``): one per mesh axis, in the mesh's order,
        ``Shard(d)`` where dimension ``d`` names the axis and
        ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard

        spec = self.to_spec_for(shape, *logical)
        out = []
        for axis in getattr(mesh, "mesh_dim_names", None) or mesh.axis_names:
            dims = [d for d, part in enumerate(spec)
                    if part == axis or (isinstance(part, tuple) and axis in part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def production_rules(
    *,
    pod: bool = True,
    sequence_parallel: bool = False,
    tp_axis: str = "model",
    data_axes: tuple = ("data",),
    axis_sizes: Optional[dict] = None,
    mesh=None,
) -> AxisRules:
    batch = (("pod",) + tuple(data_axes)) if pod else tuple(data_axes)
    return AxisRules(
        mesh=mesh,
        rules={
            "batch": batch,
            "seq": tp_axis if sequence_parallel else None,
            "kv_seq": None,
            "heads": tp_axis,
            "kv_heads": tp_axis,
            "ffn": tp_axis,
            "vocab": tp_axis,
            "embed": None,
            "experts": tp_axis,
            "state": None,
        },
        axis_sizes=dict(axis_sizes or {}),
    )


_current: contextvars.ContextVar[Optional[AxisRules]] = contextvars.ContextVar(
    "axis_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    token = _current.set(rules)
    try:
        yield
    finally:
        _current.reset(token)


def current_rules() -> Optional[AxisRules]:
    return _current.get()


def _strip_axes(spec: Sequence[Axis], drop: frozenset) -> tuple:
    """``spec`` without the mesh axes in ``drop`` (a tuple entry left with
    one axis becomes that axis, with none ``None``)."""
    parts = []
    for p in tuple(spec):
        if p is None:
            parts.append(None)
        elif isinstance(p, tuple):
            kept = tuple(a for a in p if a not in drop)
            parts.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            parts.append(None if p in drop else p)
    return tuple(parts)


def shard(x, *logical: Optional[str]):
    """The reference's sharding constraint.  One process is one rank, so a
    rank's tensor is already its part: the identity."""
    return x


def fsdp_spec(*dims: Optional[str], fsdp: Axis, tp: str) -> tuple:
    """Helper for param specs: map 'fsdp'/'tp' placeholders to mesh axes."""
    out = []
    for d in dims:
        if d == "fsdp":
            out.append(fsdp)
        elif d == "tp":
            out.append(tp)
        else:
            out.append(d)
    return tuple(out)
