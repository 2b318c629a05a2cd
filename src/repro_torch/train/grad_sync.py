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
``pack`` (flat gradient -> bucket-major wire parts, the ``pack_transposed``
kernel) runs on every step, ``unpack`` (gathered buckets -> flat vector,
the ``unpack_transposed`` kernel) on every step with ``buckets >= 2``.
The kernel registry picks the variant by the tensor's device;
``Zero1Plans.wire_kernel`` records it for the plans' device (``cuda`` on
the card, ``torch`` — the plain version — on the CPU), and the plans
refuse a tensor on any other device.

The compressed wire (bf16 cast with error feedback, the int8 ring) waits
for the ring slice; asking for it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import kernels
from ..core import PAX_SUM, TensorSpec
from ..core.errors import PAX_ERR_UNSUPPORTED_OPERATION, PaxError
from ..kernels.ring_wire import ops as wire_ops
from ..runtime.dist import DistContext


def pad_to(vec: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-vec.shape[0]) % multiple
    if pad:
        vec = torch.cat([vec, vec.new_zeros((pad,))])
    return vec


def zero1_wire_dtype(compression: Optional[str]) -> torch.dtype:
    """The dtype the reduce-scatter leg puts on the wire: float32 (the only
    wire this slice carries)."""
    if compression is not None:
        raise PaxError(
            PAX_ERR_UNSUPPORTED_OPERATION,
            f"gradient compression {compression!r} is not ported yet")
    return torch.float32


@dataclasses.dataclass(frozen=True)
class Zero1Plans:
    """Per-bucket persistent plans + their Startall groups for one zero1
    layout (padded length, dp, bucket count, wire dtype), and the variant
    of the wire-layout kernels that runs for the plans' device."""

    dp: int
    buckets: int
    padded: int
    wire_dtype: torch.dtype
    rs: tuple          # bucket -> reduce_scatter Plan
    ag: tuple          # bucket -> allgather Plan
    rs_group: object   # PlanGroup fusing all rs buckets (one start/wait)
    ag_group: object   # PlanGroup fusing all ag buckets
    wire_kernel: str   # "cuda" | "torch": kernels.variant_for(device)

    def matches(self, n: int, dp: int, buckets: int, wire_dtype) -> bool:
        return (self.padded == n and self.dp == dp
                and self.buckets == max(buckets, 1)
                and self.wire_dtype == wire_dtype)

    def _check_variant(self, x: torch.Tensor) -> None:
        if kernels.variant_for(x.device) != self.wire_kernel:
            raise ValueError(f"zero1 plans run the {self.wire_kernel!r} wire kernels; "
                             f"got a tensor on {x.device}")

    def pack(self, flat_g: torch.Tensor) -> list:
        """Flat (padded,) f32 gradient -> the buckets' wire parts."""
        self._check_variant(flat_g)
        return wire_ops.pack_parts(flat_g, self.dp, self.buckets, self.wire_dtype)

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
    buckets) layout, and record the wire-kernel variant for the device."""
    dp = dist.dp_size
    b = max(buckets, 1)
    if not wire_ops.pack_eligible(padded, dp, b):
        raise ValueError(f"padded length {padded} does not split over "
                         f"dp={dp} x buckets={b}")
    wire_dtype = zero1_wire_dtype(compression)
    abi, comm = dist.abi, dist.dp_comm
    blen = padded // b
    ex_rs = TensorSpec((blen,), wire_dtype)
    ex_ag = TensorSpec((blen // dp,), torch.float32)
    rs = tuple(abi.reduce_scatter_init(ex_rs, PAX_SUM, comm) for _ in range(b))
    ag = tuple(abi.allgather_init(ex_ag, comm) for _ in range(b))
    rs_group = abi.plan_group(rs, name="zero1-rs")
    ag_group = abi.plan_group(ag, name="zero1-ag")
    return Zero1Plans(dp, b, padded, wire_dtype, rs, ag, rs_group, ag_group,
                      kernels.variant_for(dist.device))


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


def reduce_scatter_grads_start(dist: DistContext, flat_g: torch.Tensor, *,
                               compression: Optional[str] = None,
                               buckets: int = 1,
                               plans: Optional[Zero1Plans] = None) -> PendingShard:
    """Issue the reduce-scatter of ``flat_g`` ((padded_n,) f32, padded_n %
    dp_size == 0).  With ``plans`` matching the layout, all buckets ride ONE
    ``rs_group.start()``; otherwise one ``ireduce_scatter`` per bucket."""
    dp = dist.dp_size
    n = flat_g.shape[0]
    if n % dp:
        raise ValueError(f"flat gradient of {n} does not split over dp={dp}")
    abi, comm = dist.abi, dist.dp_comm
    wire_dtype = zero1_wire_dtype(compression)
    if plans is not None and plans.matches(n, dp, buckets, wire_dtype):
        return PendingShard(abi, "group", plans.rs_group.start(plans.pack(flat_g)), dp)
    b = max(buckets, 1)
    if n % (dp * b):
        raise ValueError("bucket count must divide the shard")
    parts = wire_ops.pack_parts(flat_g, dp, b, wire_dtype)
    return PendingShard(abi, "pooled",
                        [abi.ireduce_scatter(p, PAX_SUM, comm) for p in parts], dp)


def reduce_scatter_grads_finish(pending: PendingShard) -> torch.Tensor:
    """Complete an in-flight reduce-scatter leg; returns the dp-mean
    (padded_n/dp,) f32 shard."""
    if pending.mode == "group":
        outs = pending.abi.wait(pending.pending)
    else:
        outs = pending.abi.waitall(pending.pending)
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
        outs = abi.wait(plans.ag_group.start(parts))
    else:
        outs = abi.waitall([abi.iallgather(p, dist.dp_comm) for p in parts])
    if b == 1:
        return outs[0].float()
    if use_plans:
        return plans.unpack(outs)
    return wire_ops.unpack_gathers(outs, dist.dp_size)
