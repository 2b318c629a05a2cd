"""The training steps: the reference's two modes, chosen by
``parallelism.grad_sync`` (:func:`make_train_step`).

``abi`` has two gradient-sync layouts, as in the reference:

* **ZeRO-1 flat** (``parallelism.zero1``): the flat gradient is
  reduce-scattered through one plan-group start, the AdamW update runs on
  this rank's shard only (optimizer memory 1/dp), and the updated shard is
  all-gathered back through one plan-group start/wait.  The reduce-scatter
  is in flight while the parameters are flattened and this rank's slice is
  cut.
* **per-leaf DDP** (``zero1=False``): one nonblocking ``iallreduce`` per
  gradient leaf, issued together and awaited together, moments per leaf.

``parallelism.grad_compression`` picks the gradient wire as in the
reference: ``"bf16"`` casts the wire to bf16 (ZeRO-1 folds the per-rank
error-feedback residual ``opt.ef`` into each step's gradient and refreshes
it), ``"int8"`` sends the gradient through the ``ring-int8`` context.

Microbatches accumulate gradients in f32 (the reference's scan).  The
ZeRO-1 step's four phases are ``record_function`` spans (``zero1.grads``,
``zero1.reduce_scatter``, ``zero1.adamw``, ``zero1.all_gather``), which
``launch/profile_step.py`` reads; with no profiler running they cost a few
microseconds a step.  One
process is one rank, so the code that the reference runs inside a
``shard_map`` region runs directly; the batch a step receives is this
rank's rows.  The step updates the parameter module in place (the
reference returns new arrays) — that keeps one copy of the weights.

At ``model_axis = R > 1`` every family trains tensor-parallel: each rank
holds its block of every leaf the model axis splits (``tensor_parallel.held_layout``; ``init_state`` builds it so) and
the layers compute in Megatron's layout (``models/tensor_parallel.py``),
their collectives on ``torch.distributed`` beside the ABI.  Under expert
parallelism each rank holds its ``E_pad / R`` experts of each layer and the
EP block's exchanges carry the gradient through ``dist.abi``
(``models/moe.py``).  A rank's ZeRO-1 flat
vector is its *own* leaves, reduce-scattered over ``dp_comm`` (its column
of the mesh); the per-leaf layout all-reduces its own leaves.  The grad
norm AdamW clips by counts each leaf once: the split leaves' squares
(``models.model.leaf_splits``, from what the model holds) are summed over
``tp_comm`` first.  Every rank of a column sees the same replicated
gradients, so the replicated leaves stay bitwise equal on the model axis.
The ABI step's
one in-place write (the parameters, from the all-gathered vector) comes
after every collective of the step; with the transport tier's integrity
mode on, the step first verifies those collectives' results
(``verify_clean``, one host sync), so a corrupted step raises
``PAX_ERR_DATA_CORRUPTION`` with the state untouched and a retry from the
same state is bitwise the unfailed step.  The elastic recovery policy
(:func:`elastic_recovery_policy`) rebuilds the step on the survivors.

``gspmd`` (:func:`make_train_step_gspmd`, the 300B-class configs' mode):
microbatched gradients, the per-leaf AdamW update, under
``use_rules(dist.rules)``.  In the reference XLA inserts its collectives
beside PAX; here, at dp > 1, the gradients' and the loss's mean over the
data axes runs through ``torch.distributed`` on the dp group directly, not
through the ABI (that split is the mode's point).  A model that
``init_state`` builds at dp > 1 is sharded over
``parallelism.fsdp_axes`` (FSDP): each rank holds its block of every leaf whose spec names the fsdp
axes, and so do its AdamW moments; each layer's leaves are all-gathered
just before the layer runs and its gradient reduce-scattered back
(``models/tensor_parallel.py``), so the step only scales those shards and
all-reduces the rest.  A model passed in whole trains replicated over the
data axis.  :func:`state_specs` writes down the reference's layout of
either mode's state.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as tdist
from torch.profiler import record_function

from ..core import PAX_SUM
from ..models.model import ModelApi, leaf_splits, param_leaves
from ..models.tensor_parallel import Part
from ..optim import adamw
from ..optim.adamw import AdamState, AdamWConfig, FlatAdamState
from ..runtime.dist import DistContext, dp_comm_of
from ..runtime.sharding import use_rules
from .grad_sync import (allgather_params, build_zero1_plans, pad_to,
                        reduce_scatter_grads_finish, reduce_scatter_grads_start,
                        zero1_granule, zero1_wire_dtype)


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
    is set (with the error-feedback residual on the bf16 wire, and padded
    to whole wire blocks per rank on a compressed ring), per-leaf
    moments otherwise (and always under ``grad_sync="gspmd"``).  Re-init
    with an unchanged layout — padded length,
    dp, buckets, wire dtype and compression — keeps the live plans; a
    layout change retires them and re-plans.  The weights are the block
    of the seed's draw this rank holds (:func:`model_part`): its
    tensor-parallel and FSDP block."""
    if model is None:
        model = api.init(seed, dist.device, **model_part(api, dist))
    _check_part(api, dist, model)
    params = [p for _, p in param_leaves(model)]
    par = api.cfg.parallelism
    if par.grad_sync not in ("abi", "gspmd"):
        raise ValueError(f"unknown grad_sync {par.grad_sync!r}")
    if par.grad_sync == "abi" and par.zero1:
        buckets = max(par.zero1_buckets, 1)
        compression = par.grad_compression
        wire = zero1_wire_dtype(compression)
        opt = adamw.init_flat_global(params, dist.dp_size, buckets=buckets,
                                     with_ef=compression == "bf16",
                                     granule=zero1_granule(dist, compression))
        padded = opt.m.shape[0] * dist.dp_size
        old = dist.zero1_plans
        if old is None or not old.matches(padded, dist.dp_size, buckets, wire, compression):
            dist.drop_zero1_plans()
            dist.zero1_plans = build_zero1_plans(dist, padded, buckets, compression)
    else:
        opt = adamw.init_tree(param_leaves(model))
    return TrainState(model, opt, torch.zeros((), dtype=torch.int32, device=dist.device))


def _part(dist: DistContext, grad_sync: str) -> Part:
    """The block of a model a rank of ``dist`` holds: its heads, FFN
    columns, experts (or each expert's ``d_ff`` block), Mamba2 channels and
    vocabulary rows at ``model_axis > 1``, and under ``grad_sync="gspmd"``
    at dp > 1 its block over the fsdp axes (the dp axes of the mesh)."""
    tp = (dist.abi.comm_rank(dist.tp_comm), dist.tp_size) if dist.tp_size > 1 else (0, 1)
    fsdp = ((dist.abi.comm_rank(dist.dp_comm), dist.dp_size)
            if grad_sync == "gspmd" and dist.dp_size > 1 else (0, 1))
    return Part(*tp, *fsdp)


def model_part(api: ModelApi, dist: DistContext) -> dict:
    """The ``api.init``/``from_jax_params`` keywords of what a rank of
    ``dist`` holds (:func:`_part`)."""
    p = _part(dist, api.cfg.parallelism.grad_sync)
    return {"model_rank": p.tp_rank, "model_axis": p.tp_size, "fsdp_rank": p.fsdp_rank,
            "fsdp_size": p.fsdp_size}


def _check_part(api: ModelApi, dist: DistContext, model) -> None:
    """The model holds the block ``dist`` gives it, or the whole model
    (trained replicated) — except a moe model under expert parallelism at
    ``model_axis > 1``, which must hold its block."""
    held = model.part
    want = _part(dist, api.cfg.parallelism.grad_sync)
    m = api.cfg.moe
    whole_ok = not (m is not None and m.parallelism == "ep" and dist.tp_size > 1)
    if held != want and not (whole_ok and held == Part()):
        raise ValueError(f"the model holds {held}; a rank of {dist.mesh.shape} under "
                         f"grad_sync={api.cfg.parallelism.grad_sync!r} holds {want}"
                         f"{' or the whole model' if whole_ok else ''}: build it with "
                         f"init_state or api.init(**train_loop.model_part(api, dist))")


def grad_norm(dist: Optional[DistContext], grads: list, split: list,
              fsdp_split: Optional[list] = None) -> torch.Tensor:
    """The global norm of ``grads`` (this rank's leaves, each already the
    data-parallel mean): a leaf split over the model axis (``split``)
    contributes every rank's part, summed over ``tp_comm``; a leaf split
    over the fsdp axes (``fsdp_split``) every data-parallel rank's shard,
    summed over the dp group; a replicated leaf counts once."""
    fsdp_split = fsdp_split or [False] * len(grads)
    if not any(split) and not any(fsdp_split):
        return adamw.global_norm(grads)
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)

    def total(tp: bool, fs: bool):
        return sum((s for s, a, b in zip(sq, split, fsdp_split) if (a, b) == (tp, fs)), zero)

    def dp_sum(x):
        x = x.clone()
        tdist.all_reduce(x, group=dist.dp_group)
        return x

    out = total(False, False)
    if any(fsdp_split):
        out = out + dp_sum(total(False, True))
    if any(split):
        part = total(True, False)
        if any(a and b for a, b in zip(split, fsdp_split)):
            part = part + dp_sum(total(True, True))
        out = out + dist.abi.allreduce(part, PAX_SUM, dist.tp_comm)
    return torch.sqrt(out)


def _shard_ranges(sizes: list, split: list, lo: int, hi: int) -> tuple:
    """The flat vector's slice ``[lo, hi)`` as (replicated ranges, split
    ranges), each in the slice's coordinates, adjacent ranges merged; the
    padding past the leaves is left out (it is zero)."""
    out: tuple = ([], [])
    off = 0
    for n, k in zip(sizes, split):
        a, b = max(off, lo) - lo, min(off + n, hi) - lo
        if a < b:
            ranges = out[1 if k else 0]
            if ranges and ranges[-1][1] == a:
                ranges[-1] = (ranges[-1][0], b)
            else:
                ranges.append((a, b))
        off += n
    return out


def _sq_sum(v: torch.Tensor, ranges: list) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    return sum((torch.sum(torch.square(v[a:b])) for a, b in ranges), zero)


def _grads(loss: torch.Tensor, params: list) -> list:
    """d loss / d params, zeros for a parameter the loss does not read (the
    hybrid's per-layer ``norm``, which the reference defines and never
    applies), as ``jax.grad`` gives them."""
    return list(torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True))


def _microbatched_grads(loss_fn: Callable, model, params: list, batch: dict,
                        n_micro: int):
    """Gradient accumulation; returns (mean loss, grads).  With one
    microbatch the grads keep the parameter dtype (as ``value_and_grad``
    gives them); with several they accumulate in f32."""
    if n_micro <= 1:
        loss = loss_fn(model, batch)
        return loss.detach(), _grads(loss, params)
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    mbs = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:]) for k, v in batch.items()}
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    loss_acc = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for i in range(n_micro):
        loss = loss_fn(model, {k: v[i] for k, v in mbs.items()})
        grads = _grads(loss, params)
        loss_acc = loss_acc + loss.detach()
        for a, g in zip(g_acc, grads):
            a.add_(g.float())
        del grads
    inv = 1.0 / n_micro
    for a in g_acc:  # in place: one f32 copy of the gradient, not two
        a.mul_(inv)
    return loss_acc * inv, g_acc


def sync_grads_abi(dist: DistContext, grads: list, compression: Optional[str]) -> list:
    """Per-leaf nonblocking all-reduce over the dp communicator (each leaf
    is a bucket; the requests are issued together and awaited together):
    bf16 leaves on the bf16 wire, the ``ring-int8`` context for int8 (its
    nonblocking all-reduce is the recipe over the ring's nonblocking
    reduce-scatter: the global-scale wire, as in the reference, where no
    hop kernel runs either).  Returns the dp-mean f32 gradients."""
    abi, comm = dp_comm_of(dist, compression == "int8")
    wires = [g.to(torch.bfloat16) if compression == "bf16" else g for g in grads]
    summed = abi.waitall([abi.iallreduce(w, PAX_SUM, comm) for w in wires])
    # each sum is the collective's own output: scaled in place
    return [s.float().div_(dist.dp_size) for s in summed]


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
    compression = par.grad_compression
    pad_multiple = dist.dp_size * buckets * zero1_granule(dist, compression)
    loss_fn = lambda m, b: api.loss_fn(m, b, dist)  # noqa: E731

    def lr_at(step):
        if schedule is not None:
            return schedule(step)
        return torch.ones((), dtype=torch.float32, device=step.device)

    def body(state: TrainState, batch: dict, split: list):
        """Per-leaf DDP: one nonblocking all-reduce per gradient leaf; the
        norm over the leaves as the model holds them (``split``)."""
        dp = dist.dp_size
        params = [p for _, p in param_leaves(state.params)]
        loss, grads = _microbatched_grads(loss_fn, state.params, params, batch, n_micro)
        grads = sync_grads_abi(dist, grads, compression)
        with torch.no_grad():
            gnorm = grad_norm(dist, grads, split)
            new_p, new_opt = adamw.update_tree(opt_cfg, grads, state.opt, params, gnorm,
                                               lr_at(state.step))
            loss = dist.abi.allreduce(loss, PAX_SUM, dist.dp_comm) / dp
            dist.abi.verify_clean((grads, loss), "ddp step")
        _assign(params, new_p)
        return TrainState(state.params, new_opt, state.step + 1), Metrics(loss, gnorm)

    def body_zero1(state: TrainState, batch: dict, split: list):
        """Explicit ZeRO-1 round trip: one reduce-scatter group start ->
        (param flatten + rank slice, overlapped) -> wait -> shard-local
        AdamW -> one all-gather group start/wait.  On the bf16 wire the
        per-rank residual ``opt.ef`` is folded into the gradient and
        refreshed from this step's rounding error."""
        dp = dist.dp_size
        plans = dist.zero1_plans
        params = [p for _, p in param_leaves(state.params)]
        with record_function("zero1.grads"):
            loss, grads = _microbatched_grads(loss_fn, state.params, params, batch,
                                              n_micro)
        n_flat = sum(p.numel() for p in params)
        with torch.no_grad(), record_function("zero1.reduce_scatter"):
            flat_g = pad_to(adamw.flatten(grads), pad_multiple)
            del grads
            # error feedback: opt.ef is this rank's full-length residual
            # exactly when the bf16 wire is on (a (1,) dummy otherwise)
            ef = state.opt.ef if state.opt.ef.shape[0] == flat_g.shape[0] else None
            pending, new_ef = reduce_scatter_grads_start(
                dist, flat_g, compression=compression, buckets=buckets, ef=ef,
                plans=plans)
            # overlapped with the in-flight reduce-scatter: this rank's
            # contiguous param slice (the layout of g_shard and the moments)
            flat_p = pad_to(adamw.flatten(params), pad_multiple)
            shard_len = flat_p.shape[0] // dp
            r = dist.abi.comm_rank(dist.dp_comm)
            p_shard = flat_p[r * shard_len:(r + 1) * shard_len]
            g_shard = reduce_scatter_grads_finish(pending)
            del flat_g
        with torch.no_grad(), record_function("zero1.adamw"):
            # ||mean grad||²: each element lives on exactly one rank's
            # shard of its column; a split leaf's part on one column each
            if any(split):
                rep, part = _shard_ranges([p.numel() for p in params], split,
                                          r * shard_len, (r + 1) * shard_len)
                sq = _sq_sum(g_shard, rep) + dist.abi.allreduce(
                    _sq_sum(g_shard, part), PAX_SUM, dist.tp_comm)
            else:
                sq = torch.sum(torch.square(g_shard))
            gnorm = torch.sqrt(dist.abi.allreduce(sq, PAX_SUM, dist.dp_comm))
            new_p_shard, new_opt = adamw.update_flat_shard(
                opt_cfg, g_shard, state.opt, p_shard, gnorm, lr_at(state.step))
            if ef is not None and new_ef is not None:
                new_opt = new_opt._replace(ef=new_ef)
            del flat_p, p_shard, g_shard, ef
        with torch.no_grad(), record_function("zero1.all_gather"):
            p_full = allgather_params(dist, new_p_shard, buckets=buckets, plans=plans)
            loss = dist.abi.allreduce(loss, PAX_SUM, dist.dp_comm) / dp
            # every collective of the step is in: verify before the one
            # in-place write (a no-op with integrity off)
            dist.abi.verify_clean((gnorm, p_full, loss), "zero1 step")
            _assign(params, adamw.unflatten_like(p_full[:n_flat], params))
        return TrainState(state.params, new_opt, state.step + 1), Metrics(loss, gnorm)

    def step_fn(state: TrainState, batch: dict):
        _check_part(api, dist, state.params)
        # per leaf: split over the model axis, as the model holds it
        split, fsdp_split = leaf_splits(state.params)
        if any(fsdp_split):
            raise ValueError("the abi step syncs whole data-parallel replicas; a model "
                             "sharded over the fsdp axes trains under grad_sync='gspmd'")
        if isinstance(state.opt, FlatAdamState):
            return body_zero1(state, batch, split)
        if isinstance(state.opt, AdamState):
            return body(state, batch, split)
        raise TypeError(f"unknown optimizer state {type(state.opt).__name__}")

    return step_fn


def make_train_step_gspmd(api: ModelApi, dist: Optional[DistContext], opt_cfg: AdamWConfig,
                          *, schedule: Optional[Callable] = None):
    """The reference's ``gspmd`` step: microbatched gradients and the
    per-leaf AdamW update under ``use_rules(dist.rules)``.  At dp > 1 the
    gradients' and the loss's mean over the data axes is one
    ``torch.distributed.all_reduce`` each on the dp group (the collectives
    XLA inserts in the reference), not an ABI call.  ``dist`` may be None
    (one process, no rules)."""
    n_micro = max(api.cfg.parallelism.microbatch, 1)
    rules = dist.rules if dist is not None else None
    loss_fn = lambda m, b: api.loss_fn(m, b, dist)  # noqa: E731

    def step_fn(state: TrainState, batch: dict):
        if not isinstance(state.opt, AdamState):
            raise TypeError(f"the gspmd step updates per-leaf moments, got "
                            f"{type(state.opt).__name__}")
        if dist is not None:
            _check_part(api, dist, state.params)
        split, fsdp_split = leaf_splits(state.params)
        params = [p for _, p in param_leaves(state.params)]
        with use_rules(rules):
            loss, grads = _microbatched_grads(loss_fn, state.params, params, batch, n_micro)
            with torch.no_grad():
                if dist is not None and dist.dp_size > 1:
                    grads, loss = _dp_mean(dist, grads, loss, fsdp_split)
                gnorm = grad_norm(dist, grads, split, fsdp_split)
                lr = (schedule(state.step) if schedule is not None
                      else torch.ones((), dtype=torch.float32, device=state.step.device))
                new_p, new_opt = adamw.update_tree(opt_cfg, grads, state.opt, params, gnorm, lr)
        _assign(params, new_p)
        return TrainState(state.params, new_opt, state.step + 1), Metrics(loss, gnorm)

    return step_fn


def _dp_mean(dist: DistContext, grads: list, loss: torch.Tensor, fsdp_split: list) -> tuple:
    """The gradients' and the loss's mean over the data axes, through
    ``torch.distributed`` on the dp group: the replicated gradients as one
    flat f32 buffer, then the loss.  A leaf sharded over the fsdp axes
    already holds the sum over the data axes (its gather's backward
    reduce-scattered it) and is only scaled."""
    group = dist.dp_group
    dp = dist.dp_size
    rep = [g for g, s in zip(grads, fsdp_split) if not s]
    means = iter([])
    if rep:
        flat = adamw.flatten(rep)
        torch.distributed.all_reduce(flat, group=group)
        means = iter(adamw.unflatten_like(flat / dp, rep))
    loss = loss.detach().float().clone()
    torch.distributed.all_reduce(loss, group=group)
    return [g.float() / dp if s else next(means).float() for g, s in zip(grads, fsdp_split)], \
        loss / dp


def make_train_step(api: ModelApi, dist: Optional[DistContext], opt_cfg: AdamWConfig,
                    **kw):
    """The ``abi`` step when ``parallelism.grad_sync`` asks for it and a
    dist is given, else the ``gspmd`` step (the reference's dispatch)."""
    if api.cfg.parallelism.grad_sync == "abi" and dist is not None:
        return make_train_step_abi(api, dist, opt_cfg, **kw)
    return make_train_step_gspmd(api, dist, opt_cfg, **kw)


def state_specs(api: ModelApi, mode: str, fsdp="data", tp="model", dp_axes=None) -> TrainState:
    """The reference's spec tree of a ``TrainState`` (checkpoint and
    placement layouts): ``abi`` mode — parameters split over ``tp`` only
    (replicated over the data axes), moments likewise in the per-leaf
    layout, or with ``dp_axes`` the ZeRO-1 flat layout's vectors over the
    dp axes (step replicated); ``gspmd`` mode — parameters and moments
    split over ``fsdp`` and ``tp``."""
    pspecs = api.param_specs(fsdp=fsdp if mode == "gspmd" else None, tp=tp)
    if mode == "abi" and dp_axes is not None:
        # a PartitionSpec reads one axis in a tuple as the axis itself
        axes = tuple(dp_axes)
        dp = ((axes[0] if len(axes) == 1 else axes),) if axes else ()
        return TrainState(pspecs, FlatAdamState((), dp, dp, dp), ())
    return TrainState(pspecs, AdamState((), pspecs, pspecs), ())


# ---------------------------------------------------------------------------
# the fault tier's consumers: the retry hooks and elastic recovery
# ---------------------------------------------------------------------------
def step_verifier(dist: DistContext) -> Callable:
    """A ``RetryPolicy.verify`` hook: the integrity verdict on a step's
    metrics (the step itself verifies its collectives before it writes)."""
    return lambda out: dist.abi.verify_clean(tuple(out[1]), "train step")


def plan_resetter(dist: DistContext) -> Callable:
    """A ``RetryPolicy.reset`` hook: abort the ZeRO-1 plan groups and
    plans a timed-out wait left active."""

    def reset() -> None:
        plans = dist.zero1_plans
        if plans is not None:
            for p in (plans.rs_group, plans.ag_group, *plans.rs, *plans.ag):
                p.reset()

    return reset


def rebalance_batch(batch: dict, dp: int) -> dict:
    """Trim a global batch's leading dim to the largest multiple of ``dp``
    (the tail rows go; the identity when ``dp`` divides it)."""
    def trim(x):
        b = (x.shape[0] // dp) * dp
        if b == 0:
            raise ValueError(f"batch dim {x.shape[0]} < dp={dp}: nothing to shard")
        return x if b == x.shape[0] else x[:b]

    return {k: trim(v) for k, v in batch.items()}


def local_batch(batch: dict, dist: DistContext) -> dict:
    """This rank's rows of a global (numpy or tensor) batch, on its device:
    the rank-local half of the reference's ``P(dp_axes)`` batch spec."""
    dp, r = dist.dp_size, dist.abi.comm_rank(dist.dp_comm)
    rows = next(iter(batch.values())).shape[0] // dp
    return {k: torch.as_tensor(v[r * rows:(r + 1) * rows]).to(dist.device)
            for k, v in batch.items()}


def global_batch_step(dist: DistContext, step_fn: Callable, *,
                      uneven: bool = False) -> Callable:
    """``step_fn`` fed the global batch: first the ULFM notification idiom
    (the reference's ``with_failure_probe``: an agreement on the
    data-parallel communicator, which raises ``PAX_ERR_PROC_FAILED`` while
    the failure detector reports an unacknowledged death), then (with
    ``uneven``) the trim to a dp multiple, then this rank's rows."""

    def step(state, batch):
        dist.abi.comm_agree(1, dist.dp_comm)
        b = rebalance_batch(batch, dist.dp_size) if uneven else batch
        return step_fn(state, local_batch(b, dist))

    return step


def elastic_recovery_policy(api: ModelApi, opt_cfg: AdamWConfig, dist: DistContext,
                            seed: int = 0, *, impl=None, schedule=None, tools=(),
                            uneven_shards: bool = False, integrity: Optional[bool] = None):
    """The canonical ``RecoveryPolicy`` for elastic data-parallel training
    (the reference's ``elastic_recovery_policy``).  After the shrink,
    ``rebuild`` makes a :func:`~repro_torch.runtime.dist.survivor_mesh` over
    the survivors, trimmed to the largest power-of-two data extent (8 − 1
    dead → 4), or kept whole with ``uneven_shards`` (the global batch then
    trimmed to a dp multiple each step, on the per-leaf layout); a fresh
    ``DistContext`` over it on ``impl`` (the plain backend under the
    injection wrapper), whose groups only the kept ranks create;
    ``init_state`` there; and the global-batch step
    (:func:`global_batch_step`).  A rank outside the rebuilt world (the
    dead one, or one the trim left out) gets ``step_fn=None`` and leaves.
    ``policy.dist`` becomes the rebuilt context; ``integrity`` carries the
    checksummed wire into it (default: the original context's)."""
    from ..runtime.dist import make_dist, survivor_mesh
    from ..runtime.fault import RecoveryPolicy, RecoveryTarget

    def rebuild(survivors: int, failed: tuple):
        old = policy.dist
        mesh = survivor_mesh(old.mesh, failed)
        rows = mesh.sizes[0]
        if not uneven_shards:
            mesh = survivor_mesh(old.mesh, failed, keep=1 << (rows.bit_length() - 1))
        if torch.distributed.get_rank() not in mesh.world_ranks:
            return RecoveryTarget(None, None)
        keep = old.abi.integrity if integrity is None else integrity
        new = make_dist(mesh=mesh, impl=impl, tools=tools, integrity=keep,
                        compression=api.cfg.parallelism.grad_compression)
        state_like = init_state(api, seed, new)
        step = make_train_step(api, new, opt_cfg, schedule=schedule)
        policy.dist = new
        return RecoveryTarget(global_batch_step(new, step, uneven=uneven_shards),
                              state_like, dist=new)

    policy = RecoveryPolicy(dist=dist, rebuild=rebuild)
    return policy
