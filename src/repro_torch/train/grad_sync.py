"""Data-parallel gradient synchronization through the PAX ABI (ZeRO-1).

The flat gradient vector is **reduce-scattered** over the data-parallel
communicator (each rank keeps 1/dp), the optimizer updates its shard, and
the updated shard is **all-gathered** back.  With ``buckets > 1`` the
vector travels as N buckets in the *transposed* split (bucket b carries
every rank's b-th sub-slice), so each rank's concatenated bucket results
are its contiguous slice of the full vector.

Persistent plans (:class:`Zero1Plans`, built once by ``init_state``) carry
every bucket of one leg in ONE plan-group start/wait pair.  The bucket
layout is always built by the wire-layout kernels, with or without plans:
``pack`` (flat gradient -> bucket-major wire parts: the ``pack_transposed``
kernel, or ``pack_transposed_ef`` when the bf16 wire folds an error-feedback
residual) runs on every step, ``unpack`` (gathered buckets -> flat vector,
the ``unpack_transposed`` kernel) on every step with ``buckets >= 2``.  The
kernel registry picks the variant by the tensor's device;
``Zero1Plans.wire_kernel`` records it for the plans' device (``cuda`` on
the card, ``torch`` — the plain version — on the CPU), and the plans
refuse a tensor on any other device.

The compressed wire, as in the reference:

* ``"bf16"``: the reduce-scatter leg carries bf16 on the primary context;
  with the per-rank residual ``ef`` the pack folds it in and returns the
  refreshed one (``g + ef = f32(wire) + ef'``), so no quantization error
  is lost across steps;
* ``"int8"``: the reduce-scatter leg rides the ``ring-int8`` context
  (:func:`dp_comm_of`).  At dp > 1 the flat vector is padded to whole
  wire blocks per rank (:func:`zero1_granule`; likewise when the primary
  context is itself a compressed ring), so every hop chunk of the plans
  is hop-kernel eligible and each ring hop runs the hop kernels (the
  reference pads to ``dp * buckets`` only, and its plans fall back to the
  global-scale composition at such widths); :func:`build_zero1_plans`
  refuses a layout whose chunks the kernels cannot carry.  At dp=1 the
  ring is the identity and runs no hop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import kernels
from ..core import PAX_SUM, TensorSpec
from ..kernels.ring_wire import ops as wire_ops
from ..runtime.dist import DistContext, dp_comm_of


def pad_to(vec: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-vec.shape[0]) % multiple
    if pad:
        vec = torch.cat([vec, vec.new_zeros((pad,))])
    return vec


def zero1_wire_dtype(compression: Optional[str]) -> torch.dtype:
    """The dtype the reduce-scatter leg puts on the wire: bf16 for the bf16
    wire, float32 otherwise (the int8 ring quantizes inside the backend)."""
    return torch.bfloat16 if compression == "bf16" else torch.float32


def zero1_granule(dist: DistContext, compression: Optional[str]) -> int:
    """The padding granule of the zero1 flat vector beyond ``dp * buckets``:
    at dp > 1, the wire granule of the context the reduce-scatter rides
    (``Backend.wire_pad_multiple``: a compressed ring's wire block, so that
    each rank's slice of each bucket, and with it every hop chunk, is whole
    wire blocks and the hop kernels carry it); 1 at dp=1 and on the other
    backends (the reference's layout)."""
    if dist.dp_size == 1:
        return 1
    abi, _ = dp_comm_of(dist, compression == "int8")
    return abi.backend.wire_pad_multiple()


def _pack(flat_g: torch.Tensor, ef: Optional[torch.Tensor], dp: int, buckets: int,
          compression: Optional[str]) -> tuple:
    """-> (wire parts, new residual).  A residual of the gradient's length
    is folded in: fused with the bf16 cast (``pack_parts_ef``), or added
    before the f32 pack; otherwise ``ef`` is handed back unchanged."""
    fold = ef is not None and ef.shape[0] == flat_g.shape[0]
    if compression == "bf16" and fold:
        return wire_ops.pack_parts_ef(flat_g, ef, dp, buckets)
    if fold:
        flat_g = flat_g + ef
    return wire_ops.pack_parts(flat_g, dp, buckets, zero1_wire_dtype(compression)), ef


@dataclasses.dataclass(frozen=True)
class Zero1Plans:
    """Per-bucket persistent plans + their Startall groups for one zero1
    layout (padded length, dp, bucket count, wire dtype and compression —
    the compression also picks the reduce-scatter's context, which the
    dtype alone cannot tell: ``None`` and ``"int8"`` both ship f32), and the
    variant of the wire-layout kernels that runs for the plans' device."""

    dp: int
    buckets: int
    padded: int
    wire_dtype: torch.dtype
    compression: Optional[str]
    rs: tuple          # bucket -> reduce_scatter Plan (the wire's context)
    ag: tuple          # bucket -> allgather Plan (the primary context)
    rs_group: object   # PlanGroup fusing all rs buckets (one start/wait)
    ag_group: object   # PlanGroup fusing all ag buckets
    wire_kernel: str   # "cuda" | "torch": kernels.variant_for(device)

    def matches(self, n: int, dp: int, buckets: int, wire_dtype,
                compression: Optional[str] = None) -> bool:
        return (self.padded == n and self.dp == dp
                and self.buckets == max(buckets, 1)
                and self.wire_dtype == wire_dtype
                and self.compression == compression)

    def _check_variant(self, x: torch.Tensor) -> None:
        if kernels.variant_for(x.device) != self.wire_kernel:
            raise ValueError(f"zero1 plans run the {self.wire_kernel!r} wire kernels; "
                             f"got a tensor on {x.device}")

    def pack(self, flat_g: torch.Tensor, ef: Optional[torch.Tensor] = None) -> tuple:
        """Flat (padded,) f32 gradient (and residual) -> (the buckets' wire
        parts, the new residual)."""
        self._check_variant(flat_g)
        return _pack(flat_g, ef, self.dp, self.buckets, self.compression)

    def unpack(self, outs) -> torch.Tensor:
        """The buckets' all-gather outputs -> one (padded,) f32 vector."""
        self._check_variant(outs[0])
        return wire_ops.unpack_gathers(outs, self.dp)

    def free(self) -> None:
        """Retire the groups' and every distinct plan's request slot."""
        self.rs_group.free()
        self.ag_group.free()
        for p in {id(p): p for p in self.rs + self.ag}.values():
            p.free()


def build_zero1_plans(dist: DistContext, padded: int, buckets: int = 1,
                      compression: Optional[str] = None) -> Zero1Plans:
    """Build the per-bucket persistent plans + groups for a (padded,
    buckets, compression) layout, and record the wire-kernel variant for
    the device.  The reduce-scatter plans live on the wire's context (the
    ``ring-int8`` one for int8), the all-gather plans on the primary one.
    ``padded`` must divide by ``dp * buckets * zero1_granule``: on a
    compressed ring that keeps the plans on the hop kernels."""
    dp = dist.dp_size
    b = max(buckets, 1)
    g = zero1_granule(dist, compression)
    if not wire_ops.pack_eligible(padded, dp, b * g):
        raise ValueError(f"padded length {padded} does not split over "
                         f"dp={dp} x buckets={b} x granule={g}")
    wire_dtype = zero1_wire_dtype(compression)
    abi_w, comm = dp_comm_of(dist, compression == "int8")
    blen = padded // b
    ex_rs = TensorSpec((blen,), wire_dtype)
    ex_ag = TensorSpec((blen // dp,), torch.float32)
    rs = tuple(abi_w.reduce_scatter_init(ex_rs, PAX_SUM, comm) for _ in range(b))
    ag = tuple(dist.abi.allgather_init(ex_ag, dist.dp_comm) for _ in range(b))
    rs_group = abi_w.plan_group(rs, name="zero1-rs")
    ag_group = dist.abi.plan_group(ag, name="zero1-ag")
    return Zero1Plans(dp, b, padded, wire_dtype, compression, rs, ag, rs_group,
                      ag_group, kernels.variant_for(dist.device))


@dataclasses.dataclass
class PendingShard:
    """An in-flight reduce-scatter leg: issued by
    :func:`reduce_scatter_grads_start`, completed by
    :func:`reduce_scatter_grads_finish`.  The collective runs between the
    two, so the caller can put independent work there."""

    abi: object
    mode: str       # "group" | "pooled"
    pending: object  # group Request | list[Request]
    dp: int
    #: the wait's deadline (``DistContext.wait_timeout_s``; None: no bound)
    timeout_s: Optional[float] = None


def reduce_scatter_grads_start(dist: DistContext, flat_g: torch.Tensor, *,
                               compression: Optional[str] = None,
                               buckets: int = 1,
                               ef: Optional[torch.Tensor] = None,
                               plans: Optional[Zero1Plans] = None) -> tuple:
    """Issue the reduce-scatter of ``flat_g`` ((padded_n,) f32, padded_n %
    dp_size == 0); returns ``(PendingShard, new_ef)``.  ``ef`` is this
    rank's error-feedback residual (folded in when it has the gradient's
    length).  With ``plans`` matching the layout, all buckets ride ONE
    ``rs_group.start()``; otherwise one ``ireduce_scatter`` per bucket."""
    dp = dist.dp_size
    n = flat_g.shape[0]
    if n % dp:
        raise ValueError(f"flat gradient of {n} does not split over dp={dp}")
    abi, comm = dp_comm_of(dist, compression == "int8")
    if plans is not None and plans.matches(n, dp, buckets, zero1_wire_dtype(compression),
                                           compression):
        parts, new_ef = plans.pack(flat_g, ef)
        return (PendingShard(abi, "group", plans.rs_group.start(parts), dp,
                             dist.wait_timeout_s), new_ef)
    b = max(buckets, 1)
    if n % (dp * b):
        raise ValueError("bucket count must divide the shard")
    parts, new_ef = _pack(flat_g, ef, dp, b, compression)
    return (PendingShard(abi, "pooled",
                         [abi.ireduce_scatter(p, PAX_SUM, comm) for p in parts], dp,
                         dist.wait_timeout_s),
            new_ef)


def reduce_scatter_grads_finish(pending: PendingShard) -> torch.Tensor:
    """Complete an in-flight reduce-scatter leg; returns the dp-mean
    (padded_n/dp,) f32 shard."""
    if pending.mode == "group":
        outs = pending.abi.wait(pending.pending, timeout_s=pending.timeout_s)
    else:
        outs = pending.abi.waitall(pending.pending, timeout_s=pending.timeout_s)
    shard = outs[0] if len(outs) == 1 else torch.cat(outs)
    return shard.float() / pending.dp


def allgather_params(dist: DistContext, shard: torch.Tensor, *, buckets: int = 1,
                     plans: Optional[Zero1Plans] = None) -> torch.Tensor:
    """Inverse of the scatter: collect every rank's updated shard into the
    full (padded,) f32 vector.  With matching ``plans`` every bucket rides
    ONE ``ag_group`` start/wait; otherwise one ``iallgather`` per bucket."""
    abi = dist.abi
    b = max(buckets, 1)
    if shard.ndim != 1 or shard.shape[0] % b:
        raise ValueError("the shard must be 1-D and split into the buckets")
    parts = list(torch.split(shard.float(), shard.shape[0] // b))
    use_plans = (plans is not None and plans.dp == dist.dp_size
                 and plans.padded == shard.shape[0] * plans.dp
                 and plans.buckets == b)
    if use_plans:
        outs = abi.wait(plans.ag_group.start(parts), timeout_s=dist.wait_timeout_s)
    else:
        outs = abi.waitall([abi.iallgather(p, dist.dp_comm) for p in parts],
                           timeout_s=dist.wait_timeout_s)
    if b == 1:
        return outs[0].float()
    if use_plans:
        return plans.unpack(outs)
    return wire_ops.unpack_gathers(outs, dist.dp_size)
