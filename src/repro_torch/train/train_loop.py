"""Training step builders (the reference's ``abi`` mode).

Two gradient-sync layouts, as in the reference:

* **ZeRO-1 flat** (``parallelism.zero1``): the flat gradient is
  reduce-scattered through one plan-group start, the AdamW update runs on
  this rank's shard only (optimizer memory 1/dp), and the updated shard is
  all-gathered back through one plan-group start/wait.  The reduce-scatter
  is in flight while the parameters are flattened and this rank's slice is
  cut.
* **per-leaf DDP** (``zero1=False``): one nonblocking ``iallreduce`` per
  gradient leaf, issued together and awaited together, moments per leaf.

Microbatches accumulate gradients in f32 (the reference's scan).  The
ZeRO-1 step's four phases are ``record_function`` spans (``zero1.grads``,
``zero1.reduce_scatter``, ``zero1.adamw``, ``zero1.all_gather``), which
``launch/profile_step.py`` reads; with no profiler running they cost a few
microseconds a step.  One
process is one rank, so the code that the reference runs inside a
``shard_map`` region runs directly; the batch a step receives is this
rank's rows.  The step updates the parameter module in place (the
reference returns new arrays) — that keeps one copy of the weights.  The
reference's ``gspmd`` step and its elastic-recovery policies wait for
later slices.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..core import PAX_SUM
from ..models.model import ModelApi, param_leaves
from ..optim import adamw
from ..optim.adamw import AdamState, AdamWConfig, FlatAdamState
from ..runtime.dist import DistContext
from .grad_sync import (allgather_params, build_zero1_plans, pad_to,
                        reduce_scatter_grads_finish, reduce_scatter_grads_start,
                        zero1_wire_dtype)


class TrainState(NamedTuple):
    params: Any            # the parameter module (updated in place)
    opt: Any               # FlatAdamState | AdamState
    step: torch.Tensor


class Metrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor


def init_state(api: ModelApi, seed: int, dist: DistContext, model=None) -> TrainState:
    """Build the initial train state on ``dist``'s device: random weights
    from ``seed`` (or the given ``model``), and the optimizer state — the
    ZeRO-1 flat shard with its persistent plans when ``parallelism.zero1``
    is set, per-leaf moments otherwise.  Re-init with an unchanged layout
    keeps the live plans; a layout change retires them and re-plans."""
    if model is None:
        model = api.init(seed, dist.device)
    params = [p for _, p in param_leaves(model)]
    par = api.cfg.parallelism
    if par.grad_sync != "abi":
        raise NotImplementedError(f"grad_sync={par.grad_sync!r} is not ported yet")
    if par.zero1:
        buckets = max(par.zero1_buckets, 1)
        wire = zero1_wire_dtype(par.grad_compression)
        opt = adamw.init_flat_global(params, dist.dp_size, buckets=buckets)
        padded = opt.m.shape[0] * dist.dp_size
        old = dist.zero1_plans
        if old is None or not old.matches(padded, dist.dp_size, buckets, wire):
            dist.drop_zero1_plans()
            dist.zero1_plans = build_zero1_plans(dist, padded, buckets)
    else:
        opt = adamw.init_tree(params)
    return TrainState(model, opt, torch.zeros((), dtype=torch.int32, device=dist.device))


def _microbatched_grads(loss_fn: Callable, model, params: list, batch: dict,
                        n_micro: int):
    """Gradient accumulation; returns (mean loss, grads).  With one
    microbatch the grads keep the parameter dtype (as ``value_and_grad``
    gives them); with several they accumulate in f32."""
    if n_micro <= 1:
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), list(grads)
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    mbs = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:]) for k, v in batch.items()}
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    loss_acc = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for i in range(n_micro):
        loss = loss_fn(model, {k: v[i] for k, v in mbs.items()})
        grads = torch.autograd.grad(loss, params)
        loss_acc = loss_acc + loss.detach()
        for a, g in zip(g_acc, grads):
            a.add_(g.float())
        del grads
    inv = 1.0 / n_micro
    return loss_acc * inv, [g * inv for g in g_acc]


@torch.no_grad()
def _assign(params: list, values: list) -> None:
    for p, v in zip(params, values):
        p.copy_(v)


def make_train_step_abi(api: ModelApi, dist: DistContext, opt_cfg: AdamWConfig, *,
                        schedule: Optional[Callable] = None):
    cfg = api.cfg
    par = cfg.parallelism
    n_micro = max(par.microbatch, 1)
    buckets = max(par.zero1_buckets, 1)
    loss_fn = lambda m, b: api.loss_fn(m, b, dist)  # noqa: E731

    def lr_at(step):
        if schedule is not None:
            return schedule(step)
        return torch.ones((), dtype=torch.float32, device=step.device)

    def body(state: TrainState, batch: dict):
        """Per-leaf DDP: one nonblocking all-reduce per gradient leaf."""
        dp = dist.dp_size
        params = [p for _, p in param_leaves(state.params)]
        loss, grads = _microbatched_grads(loss_fn, state.params, params, batch, n_micro)
        abi, comm = dist.abi, dist.dp_comm
        summed = abi.waitall([abi.iallreduce(g, PAX_SUM, comm) for g in grads])
        grads = [s.float() / dp for s in summed]
        with torch.no_grad():
            new_p, new_opt, gnorm = adamw.update_tree(
                opt_cfg, grads, state.opt, params, lr_at(state.step))
        _assign(params, new_p)
        loss = abi.allreduce(loss, PAX_SUM, comm) / dp
        return TrainState(state.params, new_opt, state.step + 1), Metrics(loss, gnorm)

    def body_zero1(state: TrainState, batch: dict):
        """Explicit ZeRO-1 round trip: one reduce-scatter group start ->
        (param flatten + rank slice, overlapped) -> wait -> shard-local
        AdamW -> one all-gather group start/wait."""
        dp = dist.dp_size
        plans = dist.zero1_plans
        params = [p for _, p in param_leaves(state.params)]
        with record_function("zero1.grads"):
            loss, grads = _microbatched_grads(loss_fn, state.params, params, batch,
                                              n_micro)
        n_flat = sum(p.numel() for p in params)
        with torch.no_grad(), record_function("zero1.reduce_scatter"):
            flat_g = pad_to(adamw.flatten(grads), dp * buckets)
            del grads
            pending = reduce_scatter_grads_start(dist, flat_g, buckets=buckets,
                                                 plans=plans)
            # overlapped with the in-flight reduce-scatter: this rank's
            # contiguous param slice (the layout of g_shard and the moments)
            flat_p = pad_to(adamw.flatten(params), dp * buckets)
            shard_len = flat_p.shape[0] // dp
            r = dist.abi.comm_rank(dist.dp_comm)
            p_shard = flat_p[r * shard_len:(r + 1) * shard_len]
            g_shard = reduce_scatter_grads_finish(pending)
            del flat_g
        with torch.no_grad(), record_function("zero1.adamw"):
            # ||mean grad||²: each element lives on exactly one rank's shard
            gnorm = torch.sqrt(dist.abi.allreduce(
                torch.sum(torch.square(g_shard)), PAX_SUM, dist.dp_comm))
            new_p_shard, new_opt = adamw.update_flat_shard(
                opt_cfg, g_shard, state.opt, p_shard, gnorm, lr_at(state.step))
            del flat_p, p_shard, g_shard
        with torch.no_grad(), record_function("zero1.all_gather"):
            p_full = allgather_params(dist, new_p_shard, buckets=buckets, plans=plans)
            _assign(params, adamw.unflatten_like(p_full[:n_flat], params))
            loss = dist.abi.allreduce(loss, PAX_SUM, dist.dp_comm) / dp
        return TrainState(state.params, new_opt, state.step + 1), Metrics(loss, gnorm)

    def step_fn(state: TrainState, batch: dict):
        if isinstance(state.opt, FlatAdamState):
            return body_zero1(state, batch)
        if isinstance(state.opt, AdamState):
            return body(state, batch)
        raise TypeError(f"unknown optimizer state {type(state.opt).__name__}")

    return step_fn


def make_train_step(api: ModelApi, dist: DistContext, opt_cfg: AdamWConfig, **kw):
    if api.cfg.parallelism.grad_sync == "abi":
        return make_train_step_abi(api, dist, opt_cfg, **kw)
    raise NotImplementedError(
        f"grad_sync={api.cfg.parallelism.grad_sync!r} is not ported yet")
