"""Mixture-of-Experts block with two parallelism modes — the reference's
``repro/models/moe.py`` on tensors.

* ``ep`` (expert parallelism, qwen2-moe): each rank of the model axis takes
  its slice of the sequence, routes it, and dispatches it into a
  capacity-padded ``(E_pad, C, d)`` buffer by a stable sort on the expert
  id (MegaBlocks-style); an **ABI alltoall** on the tensor-parallel
  communicator sends each expert's rows to the rank that holds it, the
  rank runs its ``E_pad / R`` experts, a second alltoall returns the rows,
  and an ABI allgather along the sequence rebuilds the full output (the
  all-gather GSPMD inserts after the reference's ``shard_map``).  The
  router's aux loss is averaged through ``abi.allreduce``.
* ``tp`` (grok-1), and ``ep`` without a dist, with one rank on the model
  axis, or with a sequence the axis does not divide (decode): dispatch,
  experts and combine run locally (:func:`_moe_local`).

On the model axis (a model built for a ``tensor_parallel.Part``, computing
through ``tensor_parallel.TensorParallel``, :func:`_moe_split`) the block
runs in Megatron's layout: the shared experts column-split, then
row-split, their gate ``sigmoid(h @ shared_gate)`` taken on the whole
``h`` and scaling this rank's partial output before the reduction (the
product is linear); under ``tp`` every rank routes and dispatches the same
whole sequence (the capacity is of the whole ``T = B * S``; under sequence
parallelism the sequence is gathered first and scattered after), runs its
``d_ff`` block of every expert and the partial outputs are summed over the
model axis; under ``ep`` :func:`_moe_ep` takes the residual that
attention's reduction left identical on every rank, and where the axis
does not divide the sequence (decode) every rank dispatches the same
tokens, runs its experts' slots of the buffer, combines only those slots,
and the partial outputs are summed (:func:`_moe_local` given the rank's
expert range: the reference's ``_moe_local`` on GSPMD-split experts, up to
the order of the sum; under autograd the gradient is summed as under
``tp``).  EP under sequence parallelism, which no config asks for, raises.
Under a ``gspmd`` step at dp > 1 the reference routes the global batch:
a data-parallel rank (``batch_group``) averages the aux loss's load over
the group and takes its tokens' places in the global batch's dispatch
(:func:`_global_slots`), so the same tokens drop.

Tokens beyond an expert's capacity are dropped (GShard/Switch semantics);
the stable sort decides which, so ties route as in the reference.  The
padding experts (qwen: 60 -> 64, for EP divisibility) have no router
column, so they receive no token.

The dispatch is an index copy and the combine an un-permutation to
``(T, k, d)`` summed over k in ascending-expert order, the order in which
the reference's scatter-add visits a token's rows: neither uses float
atomics, so the card's result is deterministic.  The expert FFNs are
batched matrix products over the expert axis (the reference's ``vmap``).
One process is one rank.  At ``model_axis = R > 1`` a model built for
training (``init``/``from_jax_params`` given the model rank) holds only
experts ``[r E_pad/R, (r+1) E_pad/R)`` of each layer, as ``spec_moe``
places them (``tensor_parallel.held_layout``); a model built whole (serving,
the EP-against-local checks) slices its own out.  EP has the gradient of the
reference's ``shard_map`` (``jax.grad`` through it, ``check_vma=False``):
each exchange is a ``torch.autograd.Function`` whose backward goes through
``dist.abi`` on the tensor-parallel communicator —

* the sequence slice: the slices' gradients all-gathered, so every rank
  gets the full ``dx`` (its producer is replicated);
* each alltoall: the inverse alltoall (split and concat axes swapped);
* the closing allgather: this rank's slice of the cotangent, no traffic
  (its consumer is replicated, so a reduce-scatter would scale by R);
* the router, replicated but read on this rank's tokens only: its
  gradient summed over the ranks by ``abi.allreduce``.

The experts' gradients are complete on their own rank.  The aux loss's
value is the ranks' mean; its gradient is the reference's, 1/R of the
mean's (its ``shard_map`` gives each rank 1/R of a replicated output's
cotangent).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from ..core import PAX_SUM
from .common import is_glu
from .mlp import mlp, mlp_shapes, spec_mlp
from .tensor_parallel import _all_gather, copy_to


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def moe_shapes(cfg, dtype, lead: tuple = ()) -> tuple:
    """The block's whole parameter shapes stacked on ``lead``: (its own
    leaves, {child name: the child's leaves}).  The router stays float32
    whatever the model's dtype."""
    m = cfg.moe
    E = m.padded_experts or m.num_experts
    d, f = cfg.d_model, m.expert_d_ff
    own = {"router": ((*lead, d, m.num_experts), torch.float32)}
    children = {"experts": mlp_shapes(d, f, cfg.activation, dtype, (*lead, E))}
    if m.num_shared_experts:
        own["shared_gate"] = ((*lead, d, 1), dtype)
        children["shared"] = mlp_shapes(d, m.num_shared_experts * f, cfg.activation, dtype,
                                        lead)
    return own, children


def spec_moe(cfg, fsdp, tp) -> dict:
    """The block's parameter specs (the reference's): under ``ep`` the
    expert axis over ``tp`` and the expert weights' ``d_model`` over
    ``fsdp``; under ``tp`` each expert's ``d_ff`` over ``tp``."""
    m = cfg.moe
    if m.parallelism == "ep":
        ew = {"wi": (tp, fsdp, None), "wo": (tp, None, fsdp)}
        if is_glu(cfg.activation):
            ew["wg"] = (tp, fsdp, None)
    else:
        ew = {"wi": (None, fsdp, tp), "wo": (None, tp, fsdp)}
        if is_glu(cfg.activation):
            ew["wg"] = (None, fsdp, tp)
    p = {"router": (None, None), "experts": ew}
    if m.num_shared_experts:
        p["shared"] = spec_mlp(cfg.activation, fsdp, tp)
        p["shared_gate"] = (None, None)
    return p


# ---------------------------------------------------------------------------
# routing, dispatch and combine
# ---------------------------------------------------------------------------
def _route(router: torch.Tensor, xf: torch.Tensor, m, batch_group=None) -> tuple:
    """xf (T, d) -> (gates (T, k) float32, experts (T, k) int64, aux loss):
    softmax over the real experts in float32, top-k, gates renormalised,
    and the Switch/GShard load-balance loss of the primary assignment.
    With ``batch_group`` (the data-parallel ranks of a ``gspmd`` step,
    whose reference routes one global batch) the load is its mean over
    the group's ranks (each holds as many tokens), so the ranks' mean of
    the aux is the global batch's aux, value and gradient."""
    logits = xf.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    E = m.num_experts
    load = F.one_hot(experts[:, 0], E).float().mean(0)
    if batch_group is not None:
        tdist.all_reduce(load, group=batch_group)
        load = load / tdist.get_world_size(batch_group)
    importance = probs.mean(0)
    aux = E * torch.sum(load * importance) * m.aux_loss_weight
    return gates, experts, aux


def _capacity(T: int, k: int, E: int, factor: float) -> int:
    return max(int(math.ceil(T * k / E * factor)), 4)


def _global_slots(T: int, experts: torch.Tensor, m, E_pad: int, batch_group=None) -> tuple:
    """(capacity, offset) of a dispatch of ``T`` tokens routed to
    ``experts`` (T, k).  With ``batch_group`` (the data-parallel ranks of a
    ``gspmd`` step, each holding ``T`` tokens of the global batch in rank
    order) the capacity is the global batch's and ``offset`` (E_pad,) counts
    each expert's assignments on the group's lower ranks, which come first
    in the global batch's stable sort; else the capacity of ``T`` and no
    offset."""
    if batch_group is None:
        return _capacity(T, m.top_k, m.num_experts, m.capacity_factor), None
    flat = experts.reshape(-1)
    counts = torch.zeros(E_pad, dtype=flat.dtype, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    every = _all_gather(counts[None], batch_group, 0)
    n = tdist.get_world_size(batch_group)
    return (_capacity(n * T, m.top_k, m.num_experts, m.capacity_factor),
            every[:tdist.get_rank(batch_group)].sum(0))


def _dispatch_sort(x: torch.Tensor, experts: torch.Tensor, gates: torch.Tensor,
                   E_pad: int, C: int, offset=None) -> tuple:
    """Sort-based dispatch of (T, d) tokens into an (E_pad, C, d) buffer.

    The T*k assignments are sorted stably by expert; an assignment's slot is
    its position in its expert's group (after ``offset``'s assignments of
    other ranks, :func:`_global_slots`), and positions from C on are
    dropped.  Kept slots are unique, so the buffer is an index copy (an
    empty slot is zero); dropped rows land on a spare row that is cut off.
    Returns the buffer and what :func:`_combine_sort` needs."""
    T, d = x.shape
    k = experts.shape[1]
    n = T * k
    flat_e = experts.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    sg = gates.reshape(-1)[order]
    st = order // k                     # the token of each sorted assignment
    pos_total = torch.arange(n, device=x.device)
    seg_start = torch.searchsorted(se, torch.arange(E_pad, device=x.device), side="left")
    pos_in_e = pos_total - seg_start[se]
    if offset is not None:
        pos_in_e = pos_in_e + offset[se]
    keep = pos_in_e < C
    slot = se * C + torch.where(keep, pos_in_e, 0)
    dest = torch.where(keep, slot, E_pad * C)
    buffer = x.new_zeros((E_pad * C + 1, d)).index_put((dest,), x[st])
    # the rank of each assignment among its token's k experts (ascending id)
    rank = (experts[:, None, :] < experts[:, :, None]).sum(-1).reshape(-1)[order]
    return buffer[:E_pad * C].view(E_pad, C, d), (st, sg, slot, keep, rank)


def _combine_sort(expert_out: torch.Tensor, combine: tuple, T: int, d: int) -> torch.Tensor:
    """Each token's k gated expert rows (a dropped one weighs 0), summed in
    ascending-expert order -> (T, d)."""
    st, sg, slot, keep, rank = combine
    k = st.shape[0] // T
    flat = expert_out.reshape(-1, d)
    vals = flat[slot] * torch.where(keep, sg, 0.0)[:, None].to(flat.dtype)
    per = vals.new_zeros((T * k, d)).index_put((st * k + rank,), vals).view(T, k, d)
    out = per[:, 0]
    for j in range(1, k):
        out = out + per[:, j]
    return out


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def moe_block(p: dict, x: torch.Tensor, cfg, dist=None, par=None) -> tuple:
    """x (B, S, d) -> (y (B, S, d), aux loss).  ``p``: one layer's
    ``moe`` node.  With ``par`` (a ``TensorParallel``: the model holds a
    block of the model axis) the block runs in its layout
    (:func:`_moe_split`), ``x`` and ``y`` in the residual stream's.  Else
    EP applies when the config asks for it, a dist is given, its model axis
    is wider than one rank and divides S; otherwise the block runs
    locally."""
    if par is not None:
        return _moe_split(p, x, cfg, dist, par)
    m = cfg.moe
    S = x.shape[1]
    use_ep = (m.parallelism == "ep" and dist is not None and dist.tp_size > 1
              and S % dist.tp_size == 0)
    held = p["experts"]["wo"].shape[0]
    if not use_ep and held != (m.padded_experts or m.num_experts):
        raise ValueError(f"this model holds {held} experts of a layer (one rank's part): "
                         f"it runs expert-parallel only, with a dist whose model axis "
                         f"divides the sequence ({S})")
    y_shared = _shared_path(p, x, cfg)
    y, aux = _moe_ep(p, x, cfg, dist) if use_ep else _moe_local(p, x, cfg)
    if y_shared is not None:
        y = y + y_shared
    return y, aux


def _shared_path(p: dict, x: torch.Tensor, cfg):
    if not cfg.moe.num_shared_experts:
        return None
    g = torch.sigmoid(x @ p["shared_gate"].to(x.dtype))
    return mlp(p["shared"], x, cfg.activation) * g


def _moe_split(p: dict, h: torch.Tensor, cfg, dist, par) -> tuple:
    """The block on a model holding a ``Part`` of the model axis, in the
    layout ``par`` gives it; ``h`` and the output in the residual stream's
    layout (under sequence parallelism this rank's slice of the sequence)."""
    m = cfg.moe
    R = par.part.tp_size
    if par.experts == "ep" and par.sp:
        raise NotImplementedError("expert parallelism under sequence parallelism is not "
                                  "ported (no config asks for it): the EP block takes the "
                                  "whole sequence, identical on every model-axis rank")
    y_shared = None
    if m.num_shared_experts:
        # column- then row-split; the gate, on the whole h, scales this
        # rank's partial output (its gradient is summed: grad_sum)
        hs = par.enter(h, par.ffn_split)
        g = torch.sigmoid(hs @ p["shared_gate"].to(hs.dtype))
        y_shared = par.leave(mlp(p["shared"], hs, cfg.activation) * g, par.ffn_split)
    if par.experts == "ep" and dist is None:
        raise ValueError("a model holding its part of the experts runs them on its "
                         "dist's model axis: pass the dist")
    if par.experts == "ep" and h.shape[1] % R == 0:
        y, aux = _moe_ep(p, h, cfg, dist, par.batch_group)
    else:
        # every rank routes and dispatches the same whole sequence: under
        # "ffn" it runs its d_ff block of every expert, under "ep" (the axis
        # does not divide S, as at decode) its experts' slots of the buffer
        slots = par.experts == "ep"
        split = slots or par.experts == "ffn"
        if slots:
            # the router, whole, is read for this rank's slots only (under
            # "ffn" its gradient is summed through grad_sum)
            p = {**p, "router": copy_to(p["router"], par.tp_group)}
        y, aux = _moe_local(p, par.enter(h, split), cfg, par.batch_group,
                            par.part.tp_rank if slots else None)
        y = par.leave(y, split)
        if split or par.sp:
            # every rank computed the same aux from the whole sequence and
            # its gradient is summed over the model axis (the router's, and
            # h's in the region's entry): each rank's weighs 1/R
            aux = aux / R + (aux - aux / R).detach()
    if y_shared is not None:
        y = y + y_shared
    return y, aux


def _moe_local(p: dict, x: torch.Tensor, cfg, batch_group=None,
               expert_rank=None) -> tuple:
    """Route, dispatch, the experts and combine on this rank.  With
    ``expert_rank`` r the model holds experts ``[r El, (r+1) El)`` of a
    layer (El of them): the buffer's other experts' slots are neither run
    nor combined, and the output is this rank's partial sum."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    gates, experts, aux = _route(p["router"], xf, m, batch_group)
    E_pad = m.padded_experts or m.num_experts
    C, offset = _global_slots(T, experts, m, E_pad, batch_group)
    buf, combine = _dispatch_sort(xf, experts, gates, E_pad, C, offset)
    if expert_rank is not None:
        El = p["experts"]["wo"].shape[0]
        lo, hi = expert_rank * El * C, (expert_rank + 1) * El * C
        buf = buf[expert_rank * El:(expert_rank + 1) * El]
        st, sg, slot, keep, rank = combine
        mine = keep & (slot >= lo) & (slot < hi)
        combine = (st, sg, torch.where(mine, slot - lo, 0), mine, rank)
    y = _combine_sort(mlp(p["experts"], buf, cfg.activation), combine, T, d)
    return y.reshape(B, S, d), aux


class _SeqSlice(torch.autograd.Function):
    """(B, S, d), the same on every rank -> this rank's (B, S/R, d);
    backward: the slices' gradients all-gathered along the sequence."""

    @staticmethod
    def forward(ctx, x, abi, comm, r, R):
        ctx.abi, ctx.comm = abi, comm
        Sl = x.shape[1] // R
        return x[:, r * Sl:(r + 1) * Sl].clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return ctx.abi.allgather(g.contiguous(), ctx.comm, axis=1), None, None, None, None


class _AllToAll(torch.autograd.Function):
    """``abi.alltoall``; backward: the inverse alltoall (the split and
    concat axes swapped)."""

    @staticmethod
    def forward(ctx, x, abi, comm, split_axis, concat_axis):
        ctx.abi, ctx.comm, ctx.axes = abi, comm, (split_axis, concat_axis)
        return abi.alltoall(x, comm, split_axis=split_axis, concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, g):
        split, concat = ctx.axes
        return (ctx.abi.alltoall(g.contiguous(), ctx.comm, split_axis=concat,
                                 concat_axis=split), None, None, None, None)


class _AllGatherSeq(torch.autograd.Function):
    """``abi.allgather`` of the (B, S/R, d) slices along the sequence;
    backward: this rank's slice of the cotangent (the consumer is the same
    on every rank, so each holds the whole cotangent already)."""

    @staticmethod
    def forward(ctx, y, abi, comm, r, R):
        ctx.r, ctx.R = r, R
        return abi.allgather(y, comm, axis=1)

    @staticmethod
    def backward(ctx, g):
        Sl = g.shape[1] // ctx.R
        return g[:, ctx.r * Sl:(ctx.r + 1) * Sl].contiguous(), None, None, None, None


class _SumGrad(torch.autograd.Function):
    """The identity on a tensor the same on every rank that each rank reads
    for its own part of the work; backward: the gradients summed over the
    ranks by ``abi.allreduce``."""

    @staticmethod
    def forward(ctx, w, abi, comm):
        ctx.abi, ctx.comm = abi, comm
        return w.clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.abi.allreduce(g.contiguous(), PAX_SUM, ctx.comm), None, None


def _moe_ep(p: dict, x: torch.Tensor, cfg, dist, batch_group=None) -> tuple:
    """This rank's sequence slice, routed with the capacity of its own
    ``B * S / R`` tokens (under ``batch_group`` of the global batch's,
    :func:`_global_slots`); ``(E_pad, C, d)`` -> alltoall -> ``(E_pad / R,
    R * C, d)`` through this rank's experts -> alltoall back -> combine;
    then the slices are all-gathered along the sequence."""
    m = cfg.moe
    abi, comm = dist.abi, dist.tp_comm
    R = dist.tp_size
    r = abi.comm_rank(comm)
    B, S, d = x.shape
    E_pad = m.padded_experts or m.num_experts
    if E_pad % R:
        raise ValueError(f"EP needs the model axis ({R}) to divide {E_pad} experts")
    E_local = E_pad // R
    S_local = S // R
    T_local = B * S_local
    xf = _SeqSlice.apply(x, abi, comm, r, R).reshape(T_local, d)
    gates, experts, aux = _route(_SumGrad.apply(p["router"], abi, comm), xf, m, batch_group)
    C, offset = _global_slots(T_local, experts, m, E_pad, batch_group)
    buf, combine = _dispatch_sort(xf, experts, gates, E_pad, C, offset)
    recv = _AllToAll.apply(buf, abi, comm, 0, 1)
    # a model built for training holds its own experts only
    mine = {name: w if w.shape[0] == E_local else w[r * E_local:(r + 1) * E_local]
            for name, w in p["experts"].items()}
    out = mlp(mine, recv, cfg.activation)
    back = _AllToAll.apply(out, abi, comm, 1, 0)
    y = _combine_sort(back, combine, T_local, d).reshape(B, S_local, d)
    # the value is the mean over the ranks.  The reference splits value and
    # gradient so that each rank's term weighs 1/R, and its shard_map
    # (check_vma=False) hands each rank 1/R of the replicated output's
    # cotangent: jax.grad gives each rank's term the weight 1/R**2, 1/R of
    # the mean's gradient, and so does this
    sg = aux.detach()
    aux = aux / R**2 + (abi.allreduce(sg, PAX_SUM, comm) / R - sg / R**2)
    return _AllGatherSeq.apply(y, abi, comm, r, R), aux

