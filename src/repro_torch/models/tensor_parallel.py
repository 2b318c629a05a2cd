"""Tensor parallelism and FSDP of the transformer (the dense and moe
families): what a rank holds of each parameter, and Megatron-LM's
collectives as autograd Functions.

**What a rank holds** (:class:`Part`, :func:`held_spec`).  The reference
writes the layout down as parameter specs (``spec_attention``,
``spec_mlp``, ``spec_moe``, ``spec_embedding``) and GSPMD executes it.  Here one process
is one rank, and a rank's module holds its block of every leaf whose spec
names the model axis (``"tp"``) or, under ``grad_sync="gspmd"``, the fsdp
axes (``"fsdp"``): each such dimension divided by that axis's size, where
the size divides it (the reference's dry run replicates an uneven
dimension the same way).

**How the layers compute** (:class:`TensorParallel`).  Each split region
is Megatron's column-then-row pair: the replicated activation enters
through :func:`copy_to` (identity forward, all-reduce of the gradient
backward), each rank computes its heads or its slice of the FFN (the moe
layer's shared experts, and under ``parallelism="tp"`` its block of every
expert's ``d_ff``), and the partial output leaves through
:func:`reduce_from` (all-reduce forward, identity backward).  Under expert
parallelism the moe block takes the residual that attention's reduction
left identical on every rank (``models/moe.py``).  Under sequence parallelism (nemotron-4-340b) the residual
stream holds this rank's slice of the sequence: a region is entered by an
all-gather along the sequence (:func:`gather`, reduce-scatter backward)
and left by a reduce-scatter (:func:`scatter`, all-gather backward).  The
embedding looks up this rank's rows of the vocabulary and sums the
partial embeddings the same way; the loss is the vocabulary-parallel
cross entropy (:func:`vocab_parallel_cross_entropy`), which reduces the
max, the sum and the target logit over the model axis and gathers no
logits.

A leaf a rank holds whole but computes with only partly — the K/V
projections where the query heads split and the K/V heads do not, the moe
router where each rank runs its block of the experts' ``d_ff``, the shared
experts' gate where it scales this rank's partial output, and under
sequence parallelism every whole leaf, read on this rank's slice of the
sequence — passes through :func:`copy_to` too, so its gradient is the sum
over the model axis, as GSPMD's transpose of a replicated operand gives
it.  Under FSDP a layer's leaves are all-gathered along their fsdp
dimension just before the layer runs (inside the remat body, so the
recompute gathers again and the full weights are not kept), and the
gradient is reduce-scattered back: the shard's gradient is the sum over
the data-parallel ranks.

The collectives run on ``torch.distributed`` on the tensor-parallel and
the data-parallel process groups, beside the ABI, as XLA inserts its
collectives beside PAX in the reference's ``gspmd`` mode.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as tdist

from ..core.backends import _dist

#: the placeholder names of a held spec's split dimensions
TP, FSDP = "tp", "fsdp"


@dataclasses.dataclass(frozen=True)
class Part:
    """Which block of the model a rank holds: its (rank, size) on the
    model axis and on the fsdp axes.  ``Part()`` is the whole model."""

    tp_rank: int = 0
    tp_size: int = 1
    fsdp_rank: int = 0
    fsdp_size: int = 1

    def __post_init__(self) -> None:
        if not (0 <= self.tp_rank < self.tp_size and 0 <= self.fsdp_rank < self.fsdp_size):
            raise ValueError(f"{self} names a rank outside its axis")

    def _of(self, entry) -> tuple:
        if entry == TP:
            return self.tp_rank, self.tp_size
        if entry == FSDP:
            return self.fsdp_rank, self.fsdp_size
        return 0, 1

    def shape(self, full: tuple, spec: tuple) -> tuple:
        """The held block's shape of a leaf of shape ``full``."""
        spec = tuple(spec) + (None,) * (len(full) - len(spec))
        return tuple(n // self._of(e)[1] for n, e in zip(full, spec))

    def index(self, full: tuple, spec: tuple) -> tuple:
        """The held block of a leaf of shape ``full``, as slices."""
        spec = tuple(spec) + (None,) * (len(full) - len(spec))
        out = []
        for n, e in zip(full, spec):
            r, s = self._of(e)
            out.append(slice(r * (n // s), (r + 1) * (n // s)))
        return tuple(out)


def held_spec(spec: tuple, full: tuple, part: Part) -> tuple:
    """``spec`` (entries ``"tp"``, ``"fsdp"`` or None, one per leading
    dimension of ``full``) with each entry dropped where its axis has one
    rank or does not divide the dimension."""
    out = []
    for n, e in zip(full, spec):
        size = part._of(e)[1]
        out.append(e if size > 1 and n % size == 0 else None)
    return tuple(out)


def is_split(spec: tuple) -> bool:
    """Does a held spec split its leaf over the model axis."""
    return TP in tuple(spec or ())


# ---------------------------------------------------------------------------
# the collectives, each with its transpose as the backward
# ---------------------------------------------------------------------------
def _all_reduce(x: torch.Tensor, group, op=tdist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    tdist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _dist.allgather(x, group, dim).result()


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _dist.reduce_scatter_sum(x, group, dim).result()


def _local(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = x.shape[dim] // tdist.get_world_size(group)
    return x.narrow(dim, tdist.get_rank(group) * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return _local(g, ctx.group, ctx.dim).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward; the gradient passed through."""
    return _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, group, dim: int, partial: bool = True) -> torch.Tensor:
    """All-gather along ``dim`` forward.  Backward: the gradient
    reduce-scattered (``partial``: each rank's consumer saw a part of the
    result's gradient), or this rank's slice of it (every rank's consumer
    computed the same gradient)."""
    return _Gather.apply(x, group, dim, partial)


def scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Reduce-scatter (sum) along ``dim`` forward; the gradient all-gathered."""
    return _Scatter.apply(x, group, dim)


# ---------------------------------------------------------------------------
# the transformer's layout in one call
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TensorParallel:
    """One call's tensor-parallel and FSDP layout of a transformer that
    holds a :class:`Part` of the dense or the moe family (:meth:`of`)."""

    part: Part
    held: dict            # leaf name -> held spec
    tp_group: object
    fsdp_group: object
    sp: bool              # the residual stream holds this rank's slice of the sequence
    q_split: bool
    #: the dense MLP, or the moe layer's shared experts, split by ``d_ff``
    ffn_split: bool
    vocab_split: bool
    #: the moe layer's routed experts: ``"ep"`` (this rank's experts),
    #: ``"ffn"`` (this rank's block of every expert's ``d_ff``), ``"whole"``
    #: (every expert whole) or None (the dense family)
    experts: Optional[str]
    #: the K/V heads this rank's query heads read, where the query heads
    #: split and the K/V heads do not (None: the usual grouping)
    kv_heads: Optional[list]
    #: leaves whose gradient is summed over the model axis (:func:`copy_to`)
    grad_sum: frozenset
    #: the data-parallel group of a full-sequence call of a ``gspmd``
    #: model at dp > 1, whose reference routes one global batch (the moe
    #: aux loss's load is averaged over it and the dispatch takes the
    #: global batch's capacity, ``moe._global_slots``); None for a cached
    #: call (each data rank serves its own requests)
    batch_group: object = None

    @classmethod
    def of(cls, model, cfg, dist, seq: int = 0) -> Optional["TensorParallel"]:
        """The layout of ``model`` (its ``part`` and ``held`` specs) on
        ``dist``'s groups for a call over ``seq`` positions (0: a cached
        call, which runs without sequence parallelism); None for a whole
        model."""
        part = getattr(model, "part", Part())
        if part == Part():
            return None
        if dist is None:
            raise ValueError(f"a model holding {part} computes on its dist's groups: "
                             f"pass the dist")
        if (part.tp_size > 1 and part.tp_size != dist.tp_size) or (
                part.fsdp_size > 1 and part.fsdp_size != dist.dp_size):
            raise ValueError(f"the model holds {part}; the dist's mesh is {dist.mesh.shape}")
        held = model.held
        R = part.tp_size
        q_split = is_split(held["layers.attn.wq"])
        kv_split = is_split(held["layers.attn.wk"])
        experts = None
        if cfg.moe is None:
            ffn_split = is_split(held["layers.mlp.wi"])
        else:
            ffn_split = is_split(held.get("layers.moe.shared.wi"))
            if not is_split(held["layers.moe.experts.wi"]):
                experts = "whole"
            else:
                experts = "ep" if cfg.moe.parallelism == "ep" else "ffn"
        vocab_split = is_split(held["embed.tok"])
        sp = bool(cfg.parallelism.sequence_parallel and R > 1 and seq and seq % R == 0)
        if sp and not vocab_split:
            raise ValueError(f"sequence parallelism needs the vocabulary ({cfg.vocab_size}) "
                             f"split over the model axis ({R})")
        kv_heads = None
        if q_split and not kv_split:
            G = cfg.num_heads // cfg.num_kv_heads
            hq = cfg.num_heads // R
            a = part.tp_rank * hq
            need = [(a + i) // G for i in range(hq)]
            uniq = sorted(set(need))
            g = hq // len(uniq)
            uniform = hq % len(uniq) == 0 and need == [uniq[0] + i // g for i in range(hq)]
            kv_heads = uniq if uniform else need
        whole = {n for n, s in held.items() if not is_split(s)}
        if sp:
            grad_sum = whole
        else:
            grad_sum = set()
            if q_split and not kv_split:
                grad_sum |= {n for n in whole if n.split(".")[-1] in ("wk", "wv", "bk", "bv")
                             and n.startswith("layers.attn.")}
            if experts == "ffn":
                grad_sum.add("layers.moe.router")
            if ffn_split and cfg.moe is not None:
                grad_sum.add("layers.moe.shared_gate")
        return cls(part, held, dist.tp_group if R > 1 else None,
                   dist.dp_group if part.fsdp_size > 1 else None, sp, q_split, ffn_split,
                   vocab_split, experts, kv_heads, frozenset(grad_sum),
                   dist.dp_group if (seq and cfg.moe is not None and dist.dp_size > 1
                                     and cfg.parallelism.grad_sync == "gspmd") else None)

    # -- parameters ----------------------------------------------------------
    def params(self, node: dict, prefix: str, stacked: bool = False) -> dict:
        """A node of the parameter tree (``ParamBlock.layer``'s dict, one
        layer's slices when ``stacked``) ready to compute with: each leaf
        sharded over the fsdp axes all-gathered, each leaf of
        ``grad_sum`` behind :func:`copy_to`."""
        out = {}
        for k, v in node.items():
            name = prefix + k
            if isinstance(v, dict):
                out[k] = self.params(v, name + ".", stacked)
                continue
            spec = tuple(self.held.get(name, ()))[1 if stacked else 0:]
            if FSDP in spec:
                v = gather(v, self.fsdp_group, spec.index(FSDP))
            if name in self.grad_sum:
                v = copy_to(v, self.tp_group)
            out[k] = v
        return out

    # -- activations ---------------------------------------------------------
    def enter(self, h: torch.Tensor, split: bool) -> torch.Tensor:
        """The input of a region whose weights split (``split``) or not."""
        if self.sp:
            return gather(h, self.tp_group, 1)
        return copy_to(h, self.tp_group) if split else h

    def leave(self, out: torch.Tensor, split: bool) -> torch.Tensor:
        """A region's output back to the residual stream's layout."""
        if split:
            return scatter(out, self.tp_group, 1) if self.sp else reduce_from(out,
                                                                              self.tp_group)
        return _local(out, self.tp_group, 1) if self.sp else out

    def vocab_range(self, vocab: int) -> tuple:
        n = vocab // self.part.tp_size
        return self.part.tp_rank * n, n

    def embed(self, tok: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """The embedding of ``tokens`` from this rank's rows of ``tok``, in
        the residual stream's layout."""
        if not self.vocab_split:
            return self.leave(torch.nn.functional.embedding(tokens, tok.to(dtype)), False)
        lo, n = self.vocab_range(tok.shape[0] * self.part.tp_size)
        t = tokens.long() - lo
        inside = (t >= 0) & (t < n)
        e = torch.nn.functional.embedding(t.clamp(0, n - 1), tok.to(dtype))
        return self.leave(e * inside[..., None].to(dtype), True)

    def full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's vocabulary columns gathered into the whole vocabulary."""
        return gather(logits, self.tp_group, -1, partial=False) if self.vocab_split else logits


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, lo: int,
                                 group, ignore_id: int = -1,
                                 z_loss: float = 1e-4) -> torch.Tensor:
    """``common.softmax_cross_entropy`` over logits split by the vocabulary:
    ``logits`` are this rank's columns ``[lo, lo + V/R)``.  The max (no
    gradient: the log-sum-exp does not depend on it), the sum of
    exponentials and the target's logit are reduced over ``group``; no
    logits are gathered.  The loss is the same on every rank."""
    logits = logits.float()
    n = logits.shape[-1]
    mask = (targets != ignore_id).float()
    m = _all_reduce(logits.detach().amax(dim=-1), group, tdist.ReduceOp.MAX)
    se = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), group)
    lse = torch.log(se) + m
    t = targets.clamp_min(0).long() - lo
    inside = ((t >= 0) & (t < n)).float()
    ll = torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0] * inside
    ll = reduce_from(ll, group)
    nll = (lse - ll) * mask
    zl = z_loss * torch.square(lse) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    return (nll.sum() + zl.sum()) / denom
