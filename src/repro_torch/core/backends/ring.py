"""ring — a second native implementation of the PAX ABI: explicit ring
schedules (the port of ``repro.core.backends.ring``).

Same handle convention as :mod:`paxi`.  SUM reduce-scatter, all-gather,
scan and exscan run as explicit rings of point-to-point hops instead of one
``torch.distributed`` collective: each hop is :func:`_dist.ring_shift`,
the counterpart of the reference's ``lax.ppermute`` to the next rank.

* ring reduce-scatter + ring all-gather is the bandwidth-optimal
  all-reduce.  ``allreduce`` is deliberately not exported
  (``ABI_DROPPED``): negotiation composes it from the spec's emulation
  recipe over these two, as in the reference;
* optional wire compression (``compress="bf16"|"int8"``): the travelling
  contribution is quantized per hop and accumulated in the payload dtype.
  Blocking and nonblocking calls use the reference's global-scale
  composition (:func:`ring_reduce_scatter`: plain tensor arithmetic, as
  the reference's is plain lax — no kernel runs there in either package).  Persistent plans and plan
  groups decide at plan time, per axis, whether the fused hop kernels of
  :mod:`repro_torch.kernels.ring_wire` carry the wire
  (:func:`ring_reduce_scatter_fused`: per-128-block int8 scales, the
  payload stays quantized between hops); the kernel registry's variant
  for the context's device names which (``capabilities()`` reports it as
  ``wire_kernel``: ``cuda`` on the card, ``torch`` — the plain versions —
  on the CPU, ``none`` where no wire kernel runs);
* multi-axis communicators reduce hierarchically, axis by axis (the
  classic 2D-torus schedule), on per-axis process groups
  (``CommTable.axis_group``); the SUM scans use the hierarchical
  :func:`ring_scan_sum_multi`.

A ring of one returns its input: a data-parallel world of one runs no hop
and no hop kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ... import kernels
from .. import handles as H
from ..communicator import comm_rank
from . import _dist
from ._dist import Ring, ring_shift
from .paxi import PaxiBackend, uniform_payload


def _quantize(x: torch.Tensor, compress: Optional[str]):
    """The reference's global-scale wire: ``(q, scale)``; the int8 scale is
    ``max(absmax, 1e-30) / 127`` (a divide, unlike the kernels' multiply
    by f32(1/127))."""
    if compress is None:
        return x, None
    if compress == "bf16":
        return x.to(torch.bfloat16), None
    if compress == "int8":
        amax = x.abs().amax() if x.numel() else x.new_zeros(())
        scale = torch.clamp_min(amax, 1e-30) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale.reshape(1)
    raise ValueError(f"unknown compression {compress!r}")


def _dequantize(q: torch.Tensor, scale, dtype: torch.dtype, compress: Optional[str]):
    if compress is None:
        return q
    if compress == "bf16":
        return q.to(dtype)
    return q.to(dtype) * scale


def _hop(q: torch.Tensor, scale, ring: Ring):
    """Send the quantized contribution (and its scale) one step round."""
    if scale is None:
        (q,) = ring_shift([q], ring)
        return q, None
    q, scale = ring_shift([q, scale], ring)
    return q, scale


def ring_reduce_scatter(x: torch.Tensor, ring: Ring, compress: Optional[str] = None):
    """This rank's fully reduced chunk (chunk index == ring position);
    ``x``'s leading dim must divide by the ring size.  S-1 hops."""
    S, i = ring.size, ring.index
    if S == 1:
        return x
    n = x.shape[0]
    if n % S:
        raise ValueError(f"ring reduce_scatter needs {S} | {n}")
    c = n // S

    def chunk_at(idx):
        return x[idx * c:(idx + 1) * c]

    travel = chunk_at((i - 1) % S)
    for t in range(S - 1):
        q, scale = _hop(*_quantize(travel, compress), ring)
        travel = _dequantize(q, scale, x.dtype, compress) + chunk_at((i - 2 - t) % S)
    return travel


def ring_reduce_scatter_fused(x: torch.Tensor, ring: Ring, compress: str):
    """:func:`ring_reduce_scatter` on the hop kernels: the travelling block
    stays quantized between hops, and each hop's dequantize + accumulate +
    re-quantize is one kernel pass (:func:`wire_ops.hop_add_quant`), the
    last one a dequantize + accumulate into f32 (:func:`wire_ops.hop_accum`).
    The bf16 wire is bitwise the composed schedule; int8 upgrades the global
    scale to per-128-block scales.  Only plan closures call this, after the
    plan-time eligibility check (``RingBackend._wire_kernel_axes``)."""
    from ...kernels.ring_wire import ops as wire_ops

    S, i = ring.size, ring.index
    if S == 1:
        return x
    c = x.shape[0] // S

    def chunk_at(idx):
        return x[idx * c:(idx + 1) * c]

    q, scales = wire_ops.quant(chunk_at((i - 1) % S), compress)
    for t in range(S - 1):
        q, scales = _hop(q, scales, ring)
        local = chunk_at((i - 2 - t) % S)
        if t < S - 2:
            q, scales = wire_ops.hop_add_quant(q, scales, local, compress)
        else:
            return wire_ops.hop_accum(q, scales, local, compress)


def ring_allgather(x: torch.Tensor, ring: Ring):
    """Inverse of :func:`ring_reduce_scatter`: every rank's chunk, in ring
    order.  S-1 hops."""
    S, i = ring.size, ring.index
    if S == 1:
        return x
    c = x.shape[0]
    out = x.new_zeros((S * c,) + tuple(x.shape[1:]))
    out[i * c:(i + 1) * c] = x
    travel = x
    for t in range(S - 1):
        (travel,) = ring_shift([travel], ring)
        src = (i - 1 - t) % S  # who produced the chunk just received
        out[src * c:(src + 1) * c] = travel
    return out


def ring_scan_sum(x: torch.Tensor, ring: Ring, inclusive: bool = True,
                  compress: Optional[str] = None):
    """SUM prefix over ring positions via S-1 hops: each hop forwards the
    neighbour's contribution one step and rank i adds the terms from
    positions below i.  The exclusive scan leaves position 0's input
    unchanged (the ABI-wide exscan convention).  The wire is quantized per
    hop like :func:`ring_reduce_scatter`'s; the masked adds add zeros where
    the reference's ``where`` does, so the sums round identically."""
    S, i = ring.size, ring.index
    if S == 1:
        return x
    acc = x if inclusive or i == 0 else torch.zeros_like(x)
    travel = x
    for t in range(S - 1):
        q, scale = _hop(*_quantize(travel, compress), ring)
        travel = _dequantize(q, scale, x.dtype, compress)
        # after hop t, position i holds position (i-1-t)'s contribution
        acc = acc + (travel if i >= t + 1 else torch.zeros_like(travel))
    return acc


def ring_allreduce_sum(x: torch.Tensor, ring: Ring, compress: Optional[str] = None):
    """Divisibility-free SUM all-reduce: S-1 broadcast-add hops (every
    contribution travels the whole ring).  The row totals of the
    hierarchical scan."""
    S = ring.size
    if S == 1:
        return x
    acc = x
    travel = x
    for _ in range(S - 1):
        q, scale = _hop(*_quantize(travel, compress), ring)
        travel = _dequantize(q, scale, x.dtype, compress)
        acc = acc + travel
    return acc


def ring_scan_sum_multi(x: torch.Tensor, rings: Sequence[Ring], rank: int,
                        inclusive: bool = True, compress: Optional[str] = None):
    """Hierarchical SUM prefix over a multi-axis communicator (``rings``:
    one per axis, major first; ``rank``: the linearized communicator
    rank):

        scan(x)[iA, iB] = scan_minor(x within row iA) + sum of full rows jA < iA,

    with the row totals on :func:`ring_allreduce_sum` and the major-axis
    prefix a :func:`ring_scan_sum` of the totals.  The exclusive variant
    keeps the ABI convention (linearized rank 0 returns its input)."""
    rings = tuple(rings)
    if len(rings) == 1:
        return ring_scan_sum(x, rings[0], inclusive, compress)
    tail = rings[1:]
    row_total = x
    for ring in reversed(tail):
        row_total = ring_allreduce_sum(row_total, ring, compress)
    # true-exclusive prefix of the row totals over the major axis
    major_excl = ring_scan_sum(row_total, rings[0], True, compress) - row_total
    inner_incl = ring_scan_sum_multi(x, tail, rank, True, compress)
    if inclusive:
        return inner_incl + major_excl
    return x if rank == 0 else inner_incl - x + major_excl


class RingBackend(PaxiBackend):
    """ABI-native backend with explicit ring schedules for SUM collectives.

    Non-SUM ops, non-leading axes and payloads that do not split over the
    communicator take the paxi lowering (an implementation may mix
    algorithms per op, as MPI implementations do).  ``allreduce`` is
    composed by negotiation from the ring reduce-scatter and all-gather.
    """

    name = "ring"

    ABI_DROPPED = frozenset({"allreduce"})

    def __init__(self, mesh=None, *, compress: Optional[str] = None, **kwargs) -> None:
        if compress not in (None, "bf16", "int8"):
            raise ValueError(f"unknown compression {compress!r}")
        super().__init__(mesh, **kwargs)
        self.compress = compress
        self._rings_by_comm: dict[int, tuple] = {}

    def _rings(self, comm: int) -> tuple:
        """One :class:`Ring` per communicator axis, major first (a ring of
        one for a size-1 axis, as the reference's size-1 mesh axes)."""
        info = self._info(comm)
        rings = self._rings_by_comm.get(comm)
        if rings is None:
            me = self.comms.rank
            built = []
            for axis, size in zip(info.axes, info.mesh_axis_sizes):
                if size == 1:
                    built.append(Ring(1, None, (me,), 0))
                    continue
                group, ranks = self.comms.axis_group(axis)
                built.append(Ring(size, group, tuple(ranks), ranks.index(me)))
            rings = self._rings_by_comm[comm] = tuple(built)
        return rings

    def release(self) -> None:
        self._rings_by_comm.clear()

    def _splits(self, comm: int, rows: int) -> bool:
        info = self._info(comm)
        return bool(info.axes) and rows % math.prod(info.mesh_axis_sizes) == 0

    # -- fused-wire kernel selection (plan time only) -----------------------
    def _wire_kernel_mode(self) -> str:
        """The kernel registry's variant for this context's device when the
        hop kernels can carry the compressed wire (``cuda`` or ``torch``);
        ``none`` for the uncompressed ring."""
        if self.compress is None:
            return "none"
        return kernels.variant_for(self.device)

    def _wire_kernel_axes(self, shape, dtype, sizes) -> list[bool]:
        """Per-axis hop-kernel eligibility for a reduce-scatter bound to
        ``shape``/``dtype``: the hop chunk along each axis (after the earlier
        axes shrank the leading dim) must pass ``wire_eligible``."""
        if self._wire_kernel_mode() == "none":
            return [False] * len(sizes)
        from ...kernels.ring_wire import ops as wire_ops

        trailing = math.prod(shape[1:]) if len(shape) > 1 else 1
        rows = shape[0]
        flags = []
        for S in sizes:
            flags.append(S > 1 and wire_ops.wire_eligible(
                ((rows // S) * trailing,), dtype, self.compress))
            rows //= max(S, 1)
        return flags

    def capability(self, entry):
        """The per-entry report plus ``wire_kernel``: what a plan bound to an
        eligible payload runs.  The hop kernels exist only for the
        reduce-scatter hop loop; the other wire-bearing entries report
        ``none``."""
        info = super().capability(entry)
        if entry.name in ("reduce_scatter", "allgather", "scan", "exscan"):
            info["wire_kernel"] = (self._wire_kernel_mode()
                                   if entry.name == "reduce_scatter" else "none")
        return info

    def wire_pad_multiple(self) -> int:
        """Padding granule for emulation recipes: with the hop kernels on,
        padding rounded up to WIRE_BLOCK keeps the composed all-reduce's
        reduce-scatter leg kernel-eligible."""
        if self._wire_kernel_mode() == "none":
            return 1
        from ...kernels.ring_wire import ops as wire_ops

        return wire_ops.WIRE_BLOCK

    # -- blocking and nonblocking (a ring schedule completes on return) ----
    def ireduce_scatter(self, x, op: int, comm: int, axis: int = 0):
        if op != H.PAX_SUM or axis != 0 or not self._splits(comm, x.shape[0]):
            return super().ireduce_scatter(x, op, comm, axis)
        for ring in self._rings(comm):  # forward order: chunk == linear rank
            x = ring_reduce_scatter(x, ring, self.compress)
        return _dist.done(x)

    def iallgather(self, x, comm: int, axis: int = 0):
        if axis != 0 or not self._info(comm).axes:
            return super().iallgather(x, comm, axis)
        for ring in reversed(self._rings(comm)):  # inverse of reduce_scatter
            x = ring_allgather(x, ring)
        return _dist.done(x)

    def _iscan(self, x, op: int, comm: int, inclusive: bool):
        info = self._info(comm)
        if op != H.PAX_SUM or not info.axes:
            fold = super().iscan if inclusive else super().iexscan
            return fold(x, op, comm)
        return _dist.done(ring_scan_sum_multi(x, self._rings(comm), comm_rank(info),
                                              inclusive, self.compress))

    def iscan(self, x, op: int, comm: int):
        return self._iscan(x, op, comm, True)

    def iexscan(self, x, op: int, comm: int):
        return self._iscan(x, op, comm, False)

    # -- persistent plans: ring-vs-paxi and kernel-vs-composed decided once -
    def plan_reduce_scatter(self, x, op: int, comm: int, axis: int = 0):
        if op != H.PAX_SUM or axis != 0 or not self._splits(comm, x.shape[0]):
            return super().plan_reduce_scatter(x, op, comm, axis)
        rings, compress = self._rings(comm), self.compress
        fused = self._wire_kernel_axes(tuple(x.shape), x.dtype,
                                       self._info(comm).mesh_axis_sizes)

        def run(x):
            for ring, k in zip(rings, fused):  # forward order: chunk == rank
                x = (ring_reduce_scatter_fused(x, ring, compress) if k
                     else ring_reduce_scatter(x, ring, compress))
            return x

        return run

    def plan_allgather(self, x, comm: int, axis: int = 0):
        if axis != 0 or not self._info(comm).axes:
            return super().plan_allgather(x, comm, axis)
        rings = tuple(reversed(self._rings(comm)))

        def run(x):
            for ring in rings:
                x = ring_allgather(x, ring)
            return x

        return run

    # -- plan-group hooks: the members ride ONE ring schedule, stacked on a
    # trailing member axis (the leading axis keeps the rank-chunk layout the
    # hops slice), so one set of S-1 hops carries every bucket.  On the
    # compressed wire the int8 blocks, and so their scales, span members —
    # exactly as the reference's ``jnp.stack(xs, axis=1)``.
    def plan_group_reduce_scatter(self, bounds):
        _, op, comm, axis = bounds[0]
        u = uniform_payload(bounds, min_ndim=1)
        if (u is None or op != H.PAX_SUM or axis != 0
                or not self._splits(comm, u[0][0])):
            return super().plan_group_reduce_scatter(bounds)
        rings, compress, n = self._rings(comm), self.compress, len(bounds)
        stacked = (u[0][0], n) + tuple(u[0][1:])
        fused = self._wire_kernel_axes(stacked, u[1], self._info(comm).mesh_axis_sizes)

        def run(xs):
            x = torch.stack(xs, dim=1)  # (rows, members, ...): one wire
            for ring, k in zip(rings, fused):
                x = (ring_reduce_scatter_fused(x, ring, compress) if k
                     else ring_reduce_scatter(x, ring, compress))
            return [x[:, i] for i in range(n)]

        return run

    def plan_group_allgather(self, bounds):
        _, comm, axis = bounds[0]
        if (uniform_payload(bounds, min_ndim=1) is None or axis != 0
                or not self._info(comm).axes):
            return super().plan_group_allgather(bounds)
        rings, n = tuple(reversed(self._rings(comm))), len(bounds)

        def run(xs):
            x = torch.stack(xs, dim=1)
            for ring in rings:
                x = ring_allgather(x, ring)
            return [x[:, i] for i in range(n)]

        return run
