"""Tensor parallelism and FSDP of every family of the port — dense, moe,
ssm (rwkv6), hybrid (Mamba2 with a shared attention block), encdec
(whisper) and vlm (phi-3-vision): what a rank holds of each parameter,
and Megatron-LM's collectives as autograd Functions.

**What a rank holds** (:class:`Part`, :func:`held_layout`,
:func:`take_block`).  The reference writes the layout down as parameter
specs (each family's ``spec_lm``) and GSPMD executes it.  Here one
process is one rank, and a rank's module holds its block of every leaf
whose spec names the model axis (``"tp"``) or, under
``grad_sync="gspmd"``, the fsdp axes (``"fsdp"``): each such dimension
divided by that axis's size, where the size divides it (the reference's
dry run replicates an uneven dimension the same way), and a unit of
leaves that computes together (a family's ``split_units``: attention's
query or K/V heads, rwkv's time mix or channel mix, a Mamba2 layer, the
hybrid's shared projections) split only where all of its heads or
segments divide the axis.  The block is contiguous, except along a
dimension that concatenates segments (a family's ``segments``: Mamba2's
``in_proj`` columns ``[z, x, B, C, dt]`` and its conv's channels
``[x, B, C]``), where a rank holds its block of each segment.

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

The ssm and hybrid families add three forms.  rwkv6's channel mix
multiplies the gate of ``cm_wr``'s columns (split by output) by the
Megatron pair ``cm_wk``/``cm_wv``'s partial output: that output is
reduce-scattered along the features (:func:`scatter`), multiplied on the
rank's columns and all-gathered back (:func:`gather` with
``partial=False``: every rank's consumer computes the same gradient).
Mamba2's ``out_norm`` is an RMSNorm over the whole ``d_inner``: the rank's
sum of squares is all-reduced forward and backward (:func:`sum_over`; each
rank's statistic feeds only its own columns, so the gradient of the sum
is the sum of the ranks' gradients), and the B and C the rank's conv
channels give are all-gathered for every head (the backward sums the
ranks' partial gradients).  The hybrid's shared ``in_proj`` and
``out_proj`` split by output and gather their output back to the whole
``d``.

A leaf a rank holds whole but computes with only partly — the K/V
projections where the query heads split and the K/V heads do not, the moe
router where each rank runs its block of the experts' ``d_ff``, the shared
experts' gate where it scales this rank's partial output, rwkv6's token
shift mixes and adapters (the whole, replicated input is mixed, then read
by the rank's heads only), its decay base ``w0``, bonus ``u`` and per-head
``ln_x``, Mamba2's ``A_log``, ``D``, ``dt_bias`` and ``out_norm`` scale
(the rank's heads' or columns' slice), and under sequence parallelism
every whole leaf, read on this rank's slice of the sequence — passes
through :func:`copy_to` too, so its gradient is the sum over the model
axis, as GSPMD's transpose of a replicated operand gives it
(the family's ``read_partly``).  Under FSDP a layer's leaves are all-gathered along their fsdp
dimension just before the layer runs (inside the remat body, so the
recompute gathers again and the full weights are not kept), and the
gradient is reduce-scattered back: the shard's gradient is the sum over
the data-parallel ranks.

The encoder-decoder runs Megatron's pair in three attentions (the
encoder's, the decoder's causal self-attention and its cross-attention,
whose K/V heads come from the rank's ``wk``/``wv`` columns applied to the
whole encoder output: that output enters through :func:`copy_to`, since
each rank's heads add to its gradient).  The vlm's projector keeps ``w1``
whole and splits ``w2`` by output columns; the rank's image-token columns
are gathered back (:func:`gather` with ``partial=False``) before the
transformer's layers.

The collectives run on ``torch.distributed`` on the tensor-parallel and
the data-parallel process groups, beside the ABI, as XLA inserts its
collectives beside PAX in the reference's ``gspmd`` mode.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as tdist

from ..core.backends import _dist
from .common import widened

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

    def index(self, full: tuple, spec: tuple, segments: tuple = ()) -> tuple:
        """The held block of a leaf of shape ``full``, as slices; with
        ``segments`` (the sizes the model-axis dimension concatenates) that
        dimension's index is a list: this rank's block of each segment."""
        spec = tuple(spec) + (None,) * (len(full) - len(spec))
        out = []
        for n, e in zip(full, spec):
            r, s = self._of(e)
            if segments and e == TP and s > 1:
                if sum(segments) != n or any(m % s for m in segments):
                    raise ValueError(f"segments {segments} do not split {n} over {s} ranks")
                starts = [sum(segments[:i]) for i in range(len(segments))]
                out.append([a + r * (m // s) + j for a, m in zip(starts, segments)
                            for j in range(m // s)])
            else:
                out.append(slice(r * (n // s), (r + 1) * (n // s)))
        return tuple(out)


#: the prefixes of the stacked leaves (a leading layer axis, drawn a layer
#: at a time): the layers of every family, the encoder's and the decoder's
STACKS = ("layers.", "enc_layers.", "dec_layers.")


@functools.lru_cache(maxsize=None)
def held_layout(cfg, part: Part) -> dict:
    """Leaf name -> what a rank of ``part`` holds of it: the family's
    reference spec (``spec_lm(fsdp="fsdp", tp="tp")``, the fsdp entries
    only with more than one fsdp rank), each entry kept where its axis
    divides the dimension (:func:`held_spec`), and each of the family's
    ``split_units`` (leaves that compute together) split over the model
    axis only where its heads or segments divide it."""
    from .model import _family

    fam = _family(cfg)[0]
    specs = fam.spec_lm(cfg, fsdp=FSDP if part.fsdp_size > 1 else None, tp=TP)
    full = fam.full_shapes(cfg)
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = held_spec(v, full[prefix + k], part)

    walk(specs, "")
    for names, divides in fam.split_units(cfg, part.tp_size):
        if not divides:
            for name in names:
                if name in out:
                    out[name] = tuple(None if e == TP else e for e in out[name])
    return out


def take_block(model, name: str, leaf):
    """This rank's block (``model.part``) of ``name``'s whole leaf (a
    tensor or a numpy array): the leaf itself where ``model`` holds it
    whole."""
    spec = getattr(model, "held", {}).get(name)
    if not spec or not any(spec):
        return leaf
    return leaf[model.part.index(tuple(leaf.shape), spec, model.segments.get(name, ()))]


def put_block(model, name: str, whole, block) -> None:
    """:func:`take_block`'s inverse: write ``block`` (this rank's, as
    ``model`` holds it) into ``whole`` in place."""
    spec = getattr(model, "held", {}).get(name)
    if not spec or not any(spec):
        whole[...] = block
        return
    whole[model.part.index(tuple(whole.shape), spec, model.segments.get(name, ()))] = block


def hold(module, cfg, blocks: dict, device, part: Part) -> None:
    """Give ``module`` the parameters of ``blocks`` (a node's dotted path
    -> its leaves' whole (shape, dtype), parents before children; the path
    ``""``: leaves of ``module`` itself) as :class:`~.common.ParamBlock` s
    holding ``part``'s block of each leaf (:func:`held_layout`; a parent
    that holds no leaf of its own is an empty block), and set ``part``,
    ``full_shapes`` (leaf name -> whole shape), ``held`` (leaf name -> held
    spec, empty for the whole model) and ``segments`` (the family's)."""
    from torch import nn

    from .common import ParamBlock
    from .model import _family

    def leaf_name(block: str, k: str) -> str:
        return f"{block}.{k}" if block else k

    module.part = part
    module.full_shapes = {leaf_name(b, k): shape for b, shapes in blocks.items()
                          for k, (shape, _) in shapes.items()}
    module.held = held_layout(cfg, part) if part != Part() else {}
    module.segments = _family(cfg)[0].segments(cfg) if module.held else {}
    for name, shapes in blocks.items():
        held = {k: (part.shape(shape, module.held.get(leaf_name(name, k), ())), dt)
                for k, (shape, dt) in shapes.items()}
        if not name:
            for k, (shape, dt) in held.items():
                module.register_parameter(k, nn.Parameter(torch.empty(shape, dtype=dt,
                                                                      device=device)))
            continue
        *path, leaf = name.split(".")
        parent = module
        for step in path:
            if not hasattr(parent, step):
                parent.add_module(step, ParamBlock({}, device))
            parent = getattr(parent, step)
        parent.add_module(leaf, ParamBlock(held, device))


def draw_block(model, name: str) -> dict:
    """The ``full``/``index`` keywords of ``common.normal_init_`` that make
    ``model``'s block of ``name`` that block of the whole leaf's draw (a
    stacked leaf's per layer slice); none for a leaf held whole."""
    spec = getattr(model, "held", {}).get(name)
    if not spec or not any(spec):
        return {}
    full = model.full_shapes[name]
    index = model.part.index(full, spec, model.segments.get(name, ()))
    if name.startswith(STACKS):  # per layer slice: drop the layer axis
        full, index = full[1:], index[1:]
    return {"full": full, "index": index}


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


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


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


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward and backward: the sum of a statistic that
    each rank computes from its part and uses on its own part only."""
    return _SumOver.apply(x, group)


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
# a model's layout in one call
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TensorParallel:
    """One call's tensor-parallel and FSDP layout of a model that holds a
    :class:`Part` (:meth:`of`), of any family."""

    part: Part
    held: dict            # leaf name -> held spec
    tp_group: object
    fsdp_group: object
    sp: bool              # the residual stream holds this rank's slice of the sequence
    #: the attentions' query heads split (the family's ``ATTENTIONS``, which
    #: all have the config's heads: the dense and moe layers', the hybrid's
    #: shared block's, the encoder-decoder's three, the vlm's)
    q_split: bool
    #: the family's MLPs (``FFNS``) or the moe layer's shared experts split
    #: by ``d_ff``
    ffn_split: bool
    vocab_split: bool
    #: the moe layer's routed experts: ``"ep"`` (this rank's experts),
    #: ``"ffn"`` (this rank's block of every expert's ``d_ff``), ``"whole"``
    #: (every expert whole) or None (no moe layer)
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
        part = model.part
        if part == Part():
            return None
        R = part.tp_size
        from .model import _family

        fam = _family(cfg)[0]
        if not fam.SEQUENCE_PARALLEL and cfg.parallelism.sequence_parallel and R > 1:
            raise NotImplementedError(f"sequence parallelism splits the dense and moe "
                                      f"families' residual stream, not the {cfg.family} "
                                      f"family's (no config asks for it)")
        if dist is None:
            raise ValueError(f"a model holding {part} computes on its dist's groups: "
                             f"pass the dist")
        if (part.tp_size > 1 and part.tp_size != dist.tp_size) or (
                part.fsdp_size > 1 and part.fsdp_size != dist.dp_size):
            raise ValueError(f"the model holds {part}; the dist's mesh is {dist.mesh.shape}")
        held = model.held
        attns = fam.ATTENTIONS
        q_split = any(is_split(held.get(a + "wq")) for a in attns)
        kv_split = any(is_split(held.get(a + "wk")) for a in attns)
        experts = None
        if cfg.moe is None:
            ffn_split = any(is_split(held.get(n)) for n in fam.FFNS)
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
                             and n.startswith(attns)}
            if experts == "ffn":
                grad_sum.add("layers.moe.router")
            if ffn_split and cfg.moe is not None:
                grad_sum.add("layers.moe.shared_gate")
            for unit, leaves in fam.read_partly(cfg).items():
                if is_split(held.get(unit)):
                    grad_sum |= {n for n in leaves if n in whole}
        return cls(part, held, dist.tp_group if R > 1 else None,
                   dist.dp_group if part.fsdp_size > 1 else None, sp, q_split, ffn_split,
                   vocab_split, experts, kv_heads, frozenset(grad_sum),
                   dist.dp_group if (seq and cfg.moe is not None and dist.dp_size > 1
                                     and cfg.parallelism.grad_sync == "gspmd") else None)

    def splits(self, name: str) -> bool:
        """Does this rank hold a block of ``name`` over the model axis."""
        return is_split(self.held.get(name))

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
    logits = widened(logits)
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
