"""Pipeline parallelism: the GPipe microbatch schedule over ABI ``sendrecv``
hops — the reference's ``repro.runtime.pipeline`` with one process a stage.

Layers are split into S contiguous stages over the stage axis of the mesh
(``pod`` by default; ``make_dist(axis_names=("pod", "model"))`` builds
it) and each rank holds its stage's layers only.  The schedule is GPipe's
loop of ``M + S - 1`` ticks:

    tick t: every stage runs its layers on its current microbatch, then
            activations hop stage i -> i+1 through ONE
            ``dist.abi.sendrecv(y, [(i, i+1), ...], dist.pp_comm)``

Stage 0 ingests microbatch ``t`` while ``t < M``; the last stage emits
microbatch ``t - (S - 1)``.  A rank that no pair sends to (stage 0)
receives zeros, as from the reference's ``ppermute``.  As in the
reference, a stage also runs its layers on a bubble tick (outside its
``M`` real microbatches), on whatever it holds: a bubble's value never
reaches an emitted output and its cotangent is zero.  The hops keep the
ticks in lockstep, so a tick lasts as long as one stage's layers whether
the bubbles compute or not.  Bubble fraction = (S-1)/(M+S-1).

The gradient: each hop is a ``torch.autograd.Function`` whose backward is
the reverse permutation's ``sendrecv`` through the ABI, so a step makes
``M + S - 1`` hops forward and ``M + S - 1`` backward.  Every stage builds
the same chain of ticks — each tick's layers read the stage's parameters,
the ingest selects with ``torch.where``, the final carry is an output with
zero cotangent, as the reference's ``fori_loop`` carry is — so every hop
lies between the loss and the stage's parameters on every stage, and
every stage runs its hops' backwards in the same order, tick
``M + S - 2`` down to 0: each pair of neighbours meets on every hop.  :func:`pipelined_loss` is the differentiation-safe
loss (the masked last-stage loss plus a stop-gradient all-reduce);
``broadcast_out=True`` replicates the outputs through ``abi.bcast`` and
raises under autograd (its transpose would scale gradients by S).  A
parameter that ``embed_fn`` or ``head_fn`` of :func:`pipelined_loss_fn`
reads gets its gradient on the stage that uses it (stage 0, the last
stage); :func:`replicated_grad_sum` sums those over the stages, the psum
the reference's ``shard_map`` transpose inserts.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import PAX_SUM


class _SendRecv(torch.autograd.Function):
    """One hop, ``abi.sendrecv(y, perm, comm)``; backward: the reverse
    permutation's ``sendrecv`` of the received tensor's gradient."""

    @staticmethod
    def forward(ctx, y, abi, perm, comm):
        ctx.abi, ctx.comm = abi, comm
        ctx.back = [(dst, src) for src, dst in perm]
        return abi.sendrecv(y, perm, comm)

    @staticmethod
    def backward(ctx, g):
        return ctx.abi.sendrecv(g.contiguous(), ctx.back, ctx.comm), None, None, None


class _Carry(torch.autograd.Function):
    """``outs`` unchanged; the loop's final carry joins the graph with a
    zero cotangent, so its hop is transposed like every other."""

    @staticmethod
    def forward(ctx, outs, carry):
        ctx.carry = (carry.shape, carry.dtype, carry.device)
        return outs.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.carry
        return g, torch.zeros(shape, dtype=dtype, device=device)


def pipeline_forward(layer_stack_fn: Callable, stage_params, x_microbatches: torch.Tensor,
                     *, dist, stage_axis: str = "pod", broadcast_out: bool = True):
    """(M, mb, ...) outputs of the LAST stage: replicated to every stage by
    ``abi.bcast`` with ``broadcast_out``, else valid on the last stage only
    (zeros elsewhere: the training path).  ``layer_stack_fn(stage_params,
    x)`` runs this stage's layers and keeps ``x``'s shape;
    ``x_microbatches`` is the same on every stage (stage 0 reads it)."""
    S = dist.mesh.shape[stage_axis]
    M = x_microbatches.shape[0]
    abi, comm = dist.abi, dist.pp_comm
    stage = abi.comm_rank(comm)
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    buf = torch.zeros_like(x_microbatches[0])
    outs = [torch.zeros_like(buf) for _ in range(M)]
    for t in range(M + S - 1):
        ingest = torch.tensor(stage == 0 and t < M, device=buf.device)
        buf = torch.where(ingest, x_microbatches[min(t, M - 1)], buf)
        y = layer_stack_fn(stage_params, buf)
        m = t - (S - 1)
        if stage == S - 1 and 0 <= m < M:
            outs[m] = y
        buf = _SendRecv.apply(y, abi, fwd_perm, comm)
    out = _Carry.apply(torch.stack(outs), buf)
    if broadcast_out:
        if torch.is_grad_enabled() and out.requires_grad:
            raise RuntimeError("broadcast_out=True does not differentiate: bcast's "
                               "transpose sums over the stages and scales gradients by S; "
                               "train through pipelined_loss")
        out = abi.bcast(out, S - 1, comm)
    return out


def make_pp_dist(dist, stage_axis: str = "pod"):
    """Attach the pipeline's stage communicator (``pp_comm``) to ``dist``."""
    if dist.pp_comm is None:
        dist.pp_comm = dist.abi.comm_from_axes((stage_axis,), "pp")
    return dist


def pipelined_loss(layer_stack_fn: Callable, stage_params, x_microbatches: torch.Tensor,
                   loss_of_out: Callable, *, dist, stage_axis: str = "pod") -> torch.Tensor:
    """The differentiation-safe pipelined loss: ``loss_of_out`` on the last
    stage's outputs, masked to that stage, its value all-reduced over the
    stages (a stop-gradient term), so the value is the same on every stage
    and the gradient flows through the last stage's term only."""
    S = dist.mesh.shape[stage_axis]
    stage = dist.abi.comm_rank(dist.pp_comm)
    ym = pipeline_forward(layer_stack_fn, stage_params, x_microbatches, dist=dist,
                          stage_axis=stage_axis, broadcast_out=False)
    local = loss_of_out(ym)
    masked = torch.where(torch.tensor(stage == S - 1, device=local.device), local,
                         torch.zeros_like(local))
    sg = masked.detach()
    total = dist.abi.allreduce(sg, PAX_SUM, dist.pp_comm)
    return masked + (total - sg)


def pipelined_loss_fn(embed_fn: Callable, layer_stack_fn: Callable, head_fn: Callable,
                      stage_params, batch: dict, *, dist, n_microbatches: int,
                      stage_axis: str = "pod") -> torch.Tensor:
    """embed -> the pipelined stages -> head and loss.  ``embed_fn(batch)``
    and ``head_fn(y, batch)`` run on every stage (cheap); the layer stacks
    are the pipelined part."""
    x = embed_fn(batch)
    B = x.shape[0]
    M = n_microbatches
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    xm = x.reshape((M, B // M) + tuple(x.shape[1:]))
    return pipelined_loss(layer_stack_fn, stage_params, xm,
                          lambda ym: head_fn(ym.reshape(x.shape), batch),
                          dist=dist, stage_axis=stage_axis)


def replicated_grad_sum(grads: list, dist) -> list:
    """Gradients of parameters every stage holds (those ``embed_fn`` and
    ``head_fn`` read), summed over the stages through ``abi.allreduce``:
    each stage holds the part of the stages that use them."""
    return [dist.abi.allreduce(g, PAX_SUM, dist.pp_comm) for g in grads]
