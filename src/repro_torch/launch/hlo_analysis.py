"""Collective-traffic counting and roofline terms — the counterpart of the
reference's ``repro.launch.hlo_analysis`` for a program with no HLO.

The reference parses the compiled HLO; here the port's step runs (on fake
tensors, ``launch/dryrun.py``) and :class:`StepCounter`, a
``TorchDispatchMode``, sees every operation it issues:

* the collectives — the ``c10d`` ops ``torch.distributed`` dispatches and
  the ``_c10d_functional`` ones — with the reference's convention:
  bytes(op) = max(sum of input bytes, sum of output bytes), the unsharded
  side of the transfer, once per op and per device; an asynchronous form
  and its ``wait_tensor`` count once (the wait moves nothing);
* the memory traffic — every other non-view op's input and output bytes,
  the unfused counterpart of XLA's ``bytes accessed``;

``FlopCounterMode`` counts the FLOPs (``launch/dryrun.py``).

Which side of the count it keeps: every ABI call that moves bytes reaches
``torch.distributed`` and is counted there, once, under the collective it
lowers to.  The ABI's own ``ByteCounter`` (``core/interpose.py``) tallies
the same calls by ABI function in its own convention (the payload it was
handed); :meth:`StepCounter.stats` keeps that ledger beside the counts as
``abi_bytes`` and never adds it in.

The H100 constants are NVIDIA's datasheet figures for one H100 SXM5 card,
not measurements.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM5 datasheet constants (per card; dense, no sparsity)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s
HBM_BW = 3.35e12              # B/s
# NVLink 4 per direction.  A 16-wide model axis spans two 8-card nodes,
# whose link is InfiniBand (about 50 GB/s a card at 400 Gb/s), so
# collective_s on the production meshes is a lower bound.
NVLINK_BW = 450e9             # B/s

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e4m3b11fnuz": 1,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: ``c10d`` / ``_c10d_functional`` op name -> the reference's collective name
_C10D_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
}


#: aten ops that allocate without reading or writing (their outputs are
#: counted where the next op touches them)
_NO_TRAFFIC = ("empty", "new_empty", "empty_like", "empty_strided")


def shape_bytes(shape_str: str) -> int:
    """Bytes of 'f32[16,128]' or a tuple '(f32[2], bf16[4,4])' (the
    reference's HLO shape notation, kept for parity)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    count_by_op: dict
    # per-op HBM traffic: input bytes + output bytes (both sides touch HBM),
    # vs ``bytes_by_op``'s max(in, out) wire convention
    hbm_by_op: dict = dataclasses.field(default_factory=dict)
    #: the ABI's ``ByteCounter`` ledger by ABI function (its convention: the
    #: payload handed to the call), kept beside the counts, never added
    abi_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    @property
    def total_hbm_bytes(self) -> int:
        return sum(self.hbm_by_op.values())


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


class StepCounter(TorchDispatchMode):
    """Counts what a region issues (see the module docstring): the
    collectives by the reference's op names, and the memory traffic of
    every other op that is not a view.  Enter it inside the
    ``FakeTensorMode`` the region runs under."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes_by_op: dict = defaultdict(int)
        self.count_by_op: dict = defaultdict(int)
        self.hbm_by_op: dict = defaultdict(int)
        self.hbm_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional"):
            op = _C10D_OPS.get(func.__name__.split(".")[0])
            if op is not None:
                n_in, n_out = self._sides(func, args, kwargs, out)
                self.bytes_by_op[op] += max(n_in, n_out)
                self.count_by_op[op] += 1
                self.hbm_by_op[op] += n_in + n_out
        elif ns == "aten" and not func.is_view and not func.__name__.startswith(_NO_TRAFFIC):
            self.hbm_bytes += _tensor_bytes(list(args)) + _tensor_bytes(
                list(kwargs.values())) + _tensor_bytes(out)
        return out

    @staticmethod
    def _sides(func, args, kwargs, out) -> tuple:
        """(input bytes, output bytes) of one collective.  The ``c10d`` ops
        of ``torch.distributed`` take (outputs, inputs, ...) for the
        gathers, scatters and all-to-alls and one list (in place) for the
        all-reduce, broadcast and point-to-point ops; the functional ops
        take their input and return their output."""
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional":
            return _tensor_bytes(args[0]), _tensor_bytes(out)
        if name in ("allreduce_", "allreduce_coalesced_", "broadcast_", "send", "recv_",
                    "recv_any_source_"):
            n = _tensor_bytes(args[0])
            return n, n
        return _tensor_bytes(args[1]), _tensor_bytes(args[0])

    def stats(self, byte_counter=None) -> CollectiveStats:
        """The collectives counted, with the ABI's ``ByteCounter`` ledger
        (``core.interpose.ByteCounter``, when attached) beside them."""
        abi = dict(byte_counter.bytes) if byte_counter is not None else {}
        return CollectiveStats(dict(self.bytes_by_op), dict(self.count_by_op),
                               dict(self.hbm_by_op), abi)


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    model_flops_global: float = 0.0  # 6*N*D

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming perfect overlap: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): remat/redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline-level MFU: useful FLOPs / (chips * peak * step_time)."""
        denom = self.chips * PEAK_FLOPS_BF16 * self.step_time_s
        return self.model_flops_global / denom if denom else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "model_flops_global": self.model_flops_global,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
        }


def roofline_from_counts(flops: float, counter: StepCounter, chips: int,
                         model_flops_global: float,
                         stats: Optional[CollectiveStats] = None) -> Roofline:
    """The roofline of one device's counted region: ``flops`` (from
    ``FlopCounterMode``), the counter's memory traffic and collective bytes."""
    stats = stats or counter.stats()
    return Roofline(float(flops), float(counter.hbm_bytes), float(stats.total_bytes), chips,
                    model_flops_global)
