"""Rank programs for the port's multi-process tests (one process per rank).

The tests start these with the ``spawn`` method, one process per rank,
meeting through a ``file://`` rendezvous in the test's ``tmp_path``; each
rank writes its results to ``<out>/rank<r>.npz``.  Only torch and
``repro_torch`` are imported here, so a rank starts in a few seconds.
Every rank program runs inside ``with make_dist(...) as dist:``, which ends
in ``DistContext.shutdown`` (the launcher's own run does so inside
``train.main``): a rank leaves only after every rank has finished
communicating, with its process groups already destroyed; a rank that
raises still destroys its groups before it exits.
"""
from __future__ import annotations

import multiprocessing
from pathlib import Path

import numpy as np


def run_ranks(target, world: int, tmp_path: Path, *args, timeout: float = 120.0) -> list:
    """Run ``target(rank, world, init_method, out_dir, *args)`` in ``world``
    spawned processes; return each rank's saved arrays.  Fails if a rank
    fails or does not finish within ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    init_method = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=target, args=(r, world, init_method, str(tmp_path)) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    assert not alive, f"{len(alive)} rank(s) did not finish within {timeout}s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    out = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


def train_rank(rank, world, init_method, out_dir, cfg, np_params, batch, steps):
    """ZeRO-1 training on this rank's rows of the global batch."""
    import torch

    from repro_torch.models import build_model, from_jax_params, param_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop

    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method) as dist:
        api = build_model(cfg)
        model = from_jax_params(np_params, cfg, device="cpu")
        state = train_loop.init_state(api, 0, dist, model=model)
        step = train_loop.make_train_step(api, dist, AdamWConfig())
        rows = batch["tokens"].shape[0] // dist.dp_size
        r = dist.abi.comm_rank(dist.dp_comm)
        local = {k: torch.from_numpy(v[r * rows:(r + 1) * rows]) for k, v in batch.items()}
        losses = []
        for _ in range(steps):
            state, met = step(state, local)
            losses.append(float(met.loss))
        out = {f"param:{n}": p.detach().numpy() for n, p in param_leaves(state.params)}
        out["m"] = state.opt.m.numpy()
        out["v"] = state.opt.v.numpy()
        out["losses"] = np.array(losses)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


def launch_rank(rank, world, init_method, out_dir, argv):
    """``repro_torch.launch.train.main`` as one rank of the world, through
    its own ``--world-size``/``--rank``/``--init-method`` flags (it shuts
    its world down itself)."""
    from repro_torch.launch import train

    rep = train.main(list(argv) + ["--world-size", str(world), "--rank", str(rank),
                                   "--init-method", init_method])
    np.savez(Path(out_dir) / f"rank{rank}.npz", losses=np.array(rep.losses),
             grad_norms=np.array(rep.grad_norms))


def collectives_rank(rank, world, init_method, out_dir):
    """Every collective of the ABI on a real multi-rank group, blocking,
    nonblocking and persistent, on inputs that depend on the rank."""
    import torch

    import repro_torch.core as C
    from repro_torch.runtime.dist import make_dist

    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method) as dist:
        abi, comm = dist.abi, dist.dp_comm
        x = torch.arange(4 * world, dtype=torch.float32) + 100 * rank
        out = {
            "rank": np.array(abi.comm_rank(comm)),
            "size": np.array(abi.comm_size(comm)),
            "allreduce_sum": abi.allreduce(x, C.PAX_SUM, comm),
            "allreduce_max": abi.allreduce(x, C.PAX_MAX, comm),
            "allreduce_prod": abi.allreduce(x[:3] + 1, C.PAX_PROD, comm),
            "reduce_scatter": abi.reduce_scatter(x, C.PAX_SUM, comm),
            "reduce_scatter_ax1": abi.reduce_scatter(x.view(2, -1), C.PAX_SUM, comm, 1),
            "allgather": abi.allgather(x[:3], comm),
            "allgather_ax1": abi.allgather(x.view(2, -1), comm, 1),
            "bcast": abi.bcast(x, world - 1, comm),
            "alltoall": abi.alltoall(x.view(world, -1), comm, 0, 1),
            "scan": abi.scan(x, C.PAX_SUM, comm),
            "exscan": abi.exscan(x, C.PAX_SUM, comm),
            "sendrecv": abi.sendrecv(x, [(i, (i + 1) % world) for i in range(world)], comm),
            "scatter": abi.scatter(x, 0, comm),
            "alltoallv": abi.alltoallv(x, [4] * world, [4] * world, comm),
        }
        abi.barrier(comm)
        # nonblocking: issued together, completed by one waitall
        reqs = [abi.iallreduce(x, C.PAX_SUM, comm), abi.iallgather(x, comm),
                abi.ireduce_scatter(x, C.PAX_SUM, comm)]
        out["i_allreduce"], out["i_allgather"], out["i_reduce_scatter"] = abi.waitall(reqs)
        # persistent plans and a Startall group of two reduce-scatter buckets
        p = abi.allreduce_init(x, C.PAX_SUM, comm)
        out["plan_allreduce"] = abi.wait(p.start(x))
        out["plan_allreduce_again"] = abi.wait(p.start(2 * x))
        rs = [abi.reduce_scatter_init(x, C.PAX_SUM, comm) for _ in range(2)]
        g = abi.plan_group(rs, name="rs2")
        a, b = abi.wait(g.start([x, 3 * x]))
        out["group_rs_0"], out["group_rs_1"] = a, b
        ag = abi.plan_group([abi.allgather_init(x[:2], comm)] * 2, name="ag2")
        out["group_ag_0"], out["group_ag_1"] = abi.wait(ag.start([x[:2], x[2:4]]))
        mixed = abi.plan_group([abi.allreduce_init(x, C.PAX_MAX, comm),
                                abi.allgather_init(x[:2], comm)], name="mixed")
        out["mixed_max"], out["mixed_ag"] = abi.wait(mixed.start([x, x[:2]]))
        np.savez(Path(out_dir) / f"rank{rank}.npz",
                 **{k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()})


# ---------------------------------------------------------------------------
# the ring backends on a real multi-rank group
# ---------------------------------------------------------------------------
RING_IMPLS = ("ring", "ring-bf16", "ring-int8")
#: all-reduce length: not a multiple of the world, so every recipe pads
N_AR = 1000


def ring_inputs(world: int) -> dict:
    """Per-rank inputs of :func:`ring_rank`, seeded: ``x`` (normal, for
    the bitwise checks) and ``pos`` (positive, for the relative error
    bounds against the exact sum), each ``world * 256`` long."""
    n = world * 256
    out = {}
    for r in range(world):
        rng = np.random.default_rng(100 + r)
        out[r] = {"x": (3.0 * rng.standard_normal(n)).astype(np.float32),
                  # the battery's section 6 layout: rank r holds values in
                  # [8r + 1, 8r + 9), here with fractional parts
                  "pos": (8 * r + 1 + np.arange(n) % 8 + rng.uniform(0, 1, n)).astype(np.float32)}
    return out


def ring_rank(rank, world, init_method, out_dir):
    """Every ring collective of the three ring backends, blocking,
    nonblocking, persistent and in plan groups, over the data-parallel
    communicator."""
    import torch

    import repro_torch.core as C
    from repro_torch.runtime.dist import make_dist

    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method) as dist:
        inp = ring_inputs(world)[rank]
        x, pos = torch.from_numpy(inp["x"]), torch.from_numpy(inp["pos"])
        y = 2.5 * x + 1.0
        S, SUM = world, C.PAX_SUM
        out = {}
        for impl in RING_IMPLS:
            abi = C.pax_init(dist.mesh, impl=impl)
            dist.extra_contexts.append(abi)  # shut down with the world
            comm = abi.comm_from_axes(("data",), "dp")
            got = {
                "rs": abi.reduce_scatter(x, SUM, comm),
                "irs": abi.wait(abi.ireduce_scatter(x, SUM, comm)),
                "ag": abi.allgather(x[:5], comm),
                "scan": abi.scan(x, SUM, comm),
                "exscan": abi.exscan(x, SUM, comm),
                "iscan": abi.wait(abi.iscan(x, SUM, comm)),
                "allreduce": abi.allreduce(x[:N_AR], SUM, comm),
                "iallreduce": abi.wait(abi.iallreduce(x[:N_AR], SUM, comm)),
                "allreduce_pos": abi.allreduce(pos[:N_AR], SUM, comm),
                "scan_pos": abi.scan(pos, SUM, comm),
                "exscan_pos": abi.exscan(pos, SUM, comm),
            }
            p = abi.reduce_scatter_init(x, SUM, comm)
            got["plan_rs"] = abi.wait(p.start(x))
            got["plan_rs_again"] = abi.wait(p.start(y))
            small = abi.reduce_scatter_init(x[:10 * S], SUM, comm)
            got["plan_rs_small"] = abi.wait(small.start(x[:10 * S]))
            pg = abi.allgather_init(x[:6], comm)  # a plan lives as long as it is held
            got["plan_ag"] = abi.wait(pg.start(x[:6]))
            pa = abi.allreduce_init(x[:N_AR], SUM, comm)
            got["plan_allreduce"] = abi.wait(pa.start(x[:N_AR]))
            got["plan_allreduce_pos"] = abi.wait(pa.start(pos[:N_AR]))
            rs2 = abi.plan_group([abi.reduce_scatter_init(x, SUM, comm) for _ in range(2)],
                                 name="rs2")
            got["group_rs_0"], got["group_rs_1"] = abi.wait(rs2.start([x, y]))
            ag2 = abi.plan_group([abi.allgather_init(x[:6], comm) for _ in range(2)], name="ag2")
            got["group_ag_0"], got["group_ag_1"] = abi.wait(ag2.start([x[:6], y[:6]]))
            ar2 = abi.plan_group([abi.allreduce_init(x[:N_AR], SUM, comm) for _ in range(2)],
                                 name="ar2")
            got["group_ar_0"], got["group_ar_1"] = abi.wait(ar2.start([x[:N_AR], y[:N_AR]]))
            caps = abi.capabilities()
            got["wire_kernel"] = np.array(caps["reduce_scatter"]["wire_kernel"])
            got["allreduce_source"] = np.array(caps["allreduce"]["source"])
            for k, v in got.items():
                out[f"{impl}:{k}"] = v.numpy() if isinstance(v, torch.Tensor) else v
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


#: length of the error-feedback probe vector (divides by dp=2 x 2 buckets)
NV = 64


def ef_rank(rank, world, init_method, out_dir):
    """Two ZeRO-1 reduce-scatter legs on the bf16 wire with error feedback
    (``vfine`` on every rank, inexact in bf16), pooled and through the
    persistent plans."""
    import torch

    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import grad_sync as gs

    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   compression="bf16") as dist:
        vfine = torch.from_numpy(np.linspace(0.1, 1.7, NV, dtype=np.float32))
        plans = gs.build_zero1_plans(dist, NV, 2, "bf16")
        out = {}
        for mode, p in (("pooled", None), ("plans", plans)):
            ef = torch.zeros(NV)
            for step in (1, 2):
                pending, ef = gs.reduce_scatter_grads_start(dist, vfine, compression="bf16",
                                                            buckets=2, ef=ef, plans=p)
                out[f"{mode}:g{step}"] = gs.reduce_scatter_grads_finish(pending).numpy()
                out[f"{mode}:ef{step}"] = ef.numpy()
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


def ring_grid_rank(rank, world, init_method, out_dir):
    """The ring backends on a (data, model) = (2, 2) grid: collectives on
    ``PAX_COMM_WORLD``, whose two axes run the hierarchical schedules on
    per-axis process groups."""
    import torch

    import repro_torch.core as C
    from repro_torch.runtime.dist import make_dist

    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   model_axis=2) as dist:
        x = torch.from_numpy(ring_inputs(world)[rank]["x"])
        SUM, comm = C.PAX_SUM, C.PAX_COMM_WORLD
        out = {}
        for impl in RING_IMPLS:
            abi = C.pax_init(dist.mesh, impl=impl)
            dist.extra_contexts.append(abi)  # shut down with the world
            p = abi.reduce_scatter_init(x, SUM, comm)
            got = {"rs": abi.reduce_scatter(x, SUM, comm), "ag": abi.allgather(x[:5], comm),
                   "scan": abi.scan(x, SUM, comm), "exscan": abi.exscan(x, SUM, comm),
                   "allreduce": abi.allreduce(x[:N_AR], SUM, comm),
                   "plan_rs": abi.wait(p.start(x))}
            for k, v in got.items():
                out[f"{impl}:{k}"] = v.numpy()
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


#: flat length of the ZeRO-1 ring probe: no dp * buckets * 128 divides it
NZ = 1000
ZR_BUCKETS = 2


def zero1_ring_inputs(world: int) -> dict:
    """Per-rank flat gradients of :func:`zero1_ring_rank`, seeded."""
    return {r: (2.0 * np.random.default_rng(200 + r).standard_normal(NZ)).astype(np.float32)
            for r in range(world)}


def zero1_ring_rank(rank, world, init_method, out_dir, impl, compression):
    """A ZeRO-1 reduce-scatter leg on a compressed ring at dp = world with
    two buckets, through the persistent plans: the int8 wire
    (``compression="int8"``: the ``ring-int8`` context) or a primary
    ``ring-bf16`` context carrying the f32 wire.  The flat vector is padded
    as ``init_state`` pads it, one plan-group start runs, the fused hop
    schedule is counted; then the reference's ``dp * buckets`` padding,
    which the plans must refuse."""
    import torch

    from repro_torch.core.backends import ring
    from repro_torch.optim.adamw import zero1_padded_size
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import grad_sync as gs

    fused = []
    inner = ring.ring_reduce_scatter_fused

    def counted(*args):
        fused.append(args[0].shape)
        return inner(*args)

    ring.ring_reduce_scatter_fused = counted
    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   impl=impl, compression=compression) as dist:
        granule = gs.zero1_granule(dist, compression)
        padded = zero1_padded_size(NZ, world, ZR_BUCKETS, granule)
        flat = gs.pad_to(torch.from_numpy(zero1_ring_inputs(world)[rank]), padded)
        plans = gs.build_zero1_plans(dist, padded, ZR_BUCKETS, compression)
        pending, _ = gs.reduce_scatter_grads_start(dist, flat, compression=compression,
                                                   buckets=ZR_BUCKETS, plans=plans)
        shard = gs.reduce_scatter_grads_finish(pending)
        try:
            gs.build_zero1_plans(dist, zero1_padded_size(NZ, world, ZR_BUCKETS),
                                 ZR_BUCKETS, compression)
            refused = False
        except ValueError:
            refused = True
        np.savez(Path(out_dir) / f"rank{rank}.npz", shard=shard.numpy(),
                 granule=np.array(granule), padded=np.array(padded),
                 fused=np.array(fused), refused=np.array(refused))


# ---------------------------------------------------------------------------
# the moe block's expert parallelism, and the moe train step's refusal
# ---------------------------------------------------------------------------
def _tensor_tree(node):
    import torch

    if isinstance(node, dict):
        return {k: _tensor_tree(v) for k, v in node.items()}
    return torch.from_numpy(np.asarray(node))


def moe_ep_rank(rank, world, init_method, out_dir, cfg, np_params, x):
    """``moe_block`` on the model axis (``model_axis=world``): this rank's
    sequence slice through the ABI alltoall and the closing allgather."""
    import torch

    from repro_torch.models.moe import moe_block
    from repro_torch.runtime.dist import make_dist

    torch.set_num_threads(1)
    with make_dist(device="cpu", model_axis=world, world_size=world, rank=rank,
                   init_method=init_method) as dist, torch.no_grad():
        y, aux = moe_block(_tensor_tree(np_params), torch.from_numpy(x), cfg, dist)
        np.savez(Path(out_dir) / f"rank{rank}.npz", y=y.numpy(), aux=aux.numpy(),
                 tp_size=np.array(dist.tp_size))


# ---------------------------------------------------------------------------
# the model axis's gradients: expert-parallel training and the pipeline
# ---------------------------------------------------------------------------
def _named_np(model) -> dict:
    from repro_torch.models import param_leaves

    return {n: p.detach().numpy() for n, p in param_leaves(model)}


def ep_train_rank(rank, world, init_method, out_dir, cfg, np_params, batch, aux_weights,
                  steps):
    """Expert parallelism at ``model_axis=world``: (1) per aux weight, the
    loss and every gradient leaf of ``loss_fn`` on a model holding this
    rank's experts, and the ABI calls of its forward and of its backward;
    (2) the ZeRO-1 and the per-leaf step, ``steps`` times each: losses,
    grad norms and the parameters after them."""
    import dataclasses

    import torch

    from repro_torch.core import CallCounter
    from repro_torch.models import build_model, from_jax_params, param_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop

    torch.set_num_threads(1)
    out = {}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with make_dist(device="cpu", model_axis=world, world_size=world, rank=rank,
                   init_method=init_method) as dist:
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        r = dist.abi.comm_rank(dist.tp_comm)
        for aux in aux_weights:
            c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, aux_loss_weight=aux))
            api = build_model(c)
            model = from_jax_params(np_params, c, device="cpu", model_rank=r, model_axis=world)
            named = param_leaves(model)
            cc.reset()
            loss = api.loss_fn(model, tb, dist)
            fwd = dict(cc.counts)
            grads = torch.autograd.grad(loss, [p for _, p in named])
            bwd = {k: v - fwd.get(k, 0) for k, v in cc.counts.items()}
            out[f"{aux}:loss"] = loss.detach().numpy()
            out[f"{aux}:fwd"] = np.array([fwd.get(k, 0) for k in COLLECTIVES])
            out[f"{aux}:bwd"] = np.array([bwd.get(k, 0) for k in COLLECTIVES])
            for (n, _), g in zip(named, grads):
                out[f"{aux}:grad:{n}"] = g.numpy()
        for layout, zero1 in (("zero1", True), ("leaf", False)):
            c = dataclasses.replace(cfg, parallelism=dataclasses.replace(cfg.parallelism,
                                                                         zero1=zero1))
            api = build_model(c)
            model = from_jax_params(np_params, c, device="cpu", model_rank=r,
                                    model_axis=world)
            state = train_loop.init_state(api, 0, dist, model=model)
            step = train_loop.make_train_step(api, dist, AdamWConfig())
            losses, norms = [], []
            for _ in range(steps):
                state, met = step(state, tb)
                losses.append(float(met.loss))
                norms.append(float(met.grad_norm))
            out[f"{layout}:losses"] = np.array(losses)
            out[f"{layout}:grad_norms"] = np.array(norms)
            for n, v in _named_np(state.params).items():
                out[f"{layout}:param:{n}"] = v
            if zero1:
                out["held_experts"] = np.array(state.params.layers.moe.experts.wi.shape[1])
                out["flat_shard"] = np.array(state.opt.m.shape[0])
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


#: the ABI calls the EP block's forward and backward make, in this order
COLLECTIVES = ("alltoall", "allgather", "allreduce", "sendrecv", "bcast")


def pipeline_rank(rank, world, init_method, out_dir, W, x, l_per):
    """The GPipe schedule on a ``(pod, model)`` mesh of ``world`` stages:
    the forward (``broadcast_out``), ``pipelined_loss``'s gradient of this
    stage's weights for ``sum(y * y)``, the ABI calls of each, what stage 0
    receives from nobody, and whether ``broadcast_out`` under autograd
    raises."""
    import torch

    from repro_torch.core import CallCounter
    from repro_torch.runtime.dist import make_dist
    from repro_torch.runtime.pipeline import make_pp_dist, pipeline_forward, pipelined_loss

    torch.set_num_threads(1)

    def layer_stack_fn(w_stage, v):
        for w in w_stage:
            v = torch.tanh(v @ w)
        return v

    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   axis_names=("pod", "model")) as dist:
        dist = make_pp_dist(dist, "pod")
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        s = dist.abi.comm_rank(dist.pp_comm)
        w = torch.from_numpy(W[s * l_per:(s + 1) * l_per].copy()).requires_grad_()
        xm = torch.from_numpy(x)
        with torch.no_grad():
            out = pipeline_forward(layer_stack_fn, w, xm, dist=dist, stage_axis="pod")
        fwd_calls = dict(cc.counts)
        cc.reset()
        loss = pipelined_loss(layer_stack_fn, w, xm, lambda y: torch.sum(y * y), dist=dist,
                              stage_axis="pod")
        loss_fwd = dict(cc.counts)
        (g,) = torch.autograd.grad(loss, [w])
        loss_bwd = {k: v - loss_fwd.get(k, 0) for k, v in cc.counts.items()}
        try:
            pipeline_forward(layer_stack_fn, w, xm, dist=dist, stage_axis="pod")
            msg = ""
        except RuntimeError as e:
            msg = str(e)
        # the forward hop: stage 0 is sent nothing
        recv = dist.abi.sendrecv(xm[0] + 1.0, [(i, i + 1) for i in range(world - 1)],
                                 dist.pp_comm)
        np.savez(Path(out_dir) / f"rank{rank}.npz", out=out.numpy(), grad=g.numpy(),
                 loss=loss.detach().numpy(), stage=np.array(s), raise_msg=np.array(msg),
                 recv=recv.numpy(),
                 fwd=np.array([fwd_calls.get(k, 0) for k in COLLECTIVES]),
                 loss_fwd=np.array([loss_fwd.get(k, 0) for k in COLLECTIVES]),
                 loss_bwd=np.array([loss_bwd.get(k, 0) for k in COLLECTIVES]))


def gspmd_rank(rank, world, init_method, out_dir, cfg, np_params, batch, steps):
    """The ``gspmd`` step at dp=``world``: this rank's rows, the gradients'
    mean through ``torch.distributed`` on the dp group."""
    import torch

    from repro_torch.core import CallCounter
    from repro_torch.models import build_model, from_jax_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop

    torch.set_num_threads(1)
    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method) as dist:
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        api = build_model(cfg)
        state = train_loop.init_state(api, 0, dist,
                                      model=from_jax_params(np_params, cfg, device="cpu"))
        step = train_loop.make_train_step(api, dist, AdamWConfig())
        local = train_loop.local_batch(batch, dist)
        losses, norms = [], []
        for _ in range(steps):
            state, met = step(state, local)
            losses.append(float(met.loss))
            norms.append(float(met.grad_norm))
        out = {f"param:{n}": v for n, v in _named_np(state.params).items()}
        np.savez(Path(out_dir) / f"rank{rank}.npz", losses=np.array(losses),
                 grad_norms=np.array(norms), abi_calls=np.array(sorted(cc.counts)),
                 **out)


def placements_rank(rank, world, init_method, out_dir):
    """``AxisRules.placements`` on a ``DeviceMesh`` of this CPU world
    (``(data, model)`` = (1, world)), and a tensor distributed with them."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.runtime.dist import make_dist

    with make_dist(device="cpu", model_axis=world, world_size=world, rank=rank,
                   init_method=init_method) as dist:
        mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
        rules = dist.rules
        cases = {"experts": ((8, 6, 4), ("experts", "embed", None)),
                 "batch": ((4, 6), ("batch", "embed")),
                 "ffn": ((6, 8), ("embed", "ffn")),
                 "uneven": ((6, 5), ("embed", "ffn"))}
        out = {}
        for name, (shape, logical) in cases.items():
            pl = rules.placements(shape, mesh, *logical)
            out[f"{name}:placements"] = np.array([repr(p) for p in pl])
            out[f"{name}:same_as_port_mesh"] = np.array(
                pl == rules.placements(shape, dist.mesh, *logical))
            full = torch.arange(float(np.prod(shape))).reshape(shape)
            out[f"{name}:local"] = distribute_tensor(full, mesh, pl).to_local().numpy()
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


def pipeline_lm_rank(rank, world, init_method, out_dir, cfg, np_params, batch, n_micro):
    """The dense LM in ``world`` pipeline stages (``transformer.stage_model``):
    ``pipelined_loss_fn`` over ``n_micro`` microbatches, its gradient, the
    embedding's and final norm's summed over the stages."""
    import torch

    from repro_torch.models import from_jax_params, param_leaves, transformer
    from repro_torch.runtime.dist import make_dist
    from repro_torch.runtime.pipeline import (make_pp_dist, pipelined_loss_fn,
                                              replicated_grad_sum)

    torch.set_num_threads(1)
    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   axis_names=("pod", "model")) as dist:
        dist = make_pp_dist(dist, "pod")
        s = dist.abi.comm_rank(dist.pp_comm)
        whole = from_jax_params(np_params, cfg, device="cpu")
        scfg, part = transformer.stage_model(whole, cfg, s, world, "cpu")
        embed_fn, layer_stack_fn, head_fn = transformer.pipeline_fns(part, scfg)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss = pipelined_loss_fn(embed_fn, layer_stack_fn, head_fn, part, tb, dist=dist,
                                 n_microbatches=n_micro, stage_axis="pod")
        named = param_leaves(part)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        shared = [not n.startswith("layers.") for n, _ in named]
        summed = iter(replicated_grad_sum([g for g, k in zip(grads, shared) if k], dist))
        out = {f"grad:{n}": (next(summed) if k else g).numpy()
               for (n, _), g, k in zip(named, grads, shared)}
        np.savez(Path(out_dir) / f"rank{rank}.npz", loss=loss.detach().numpy(),
                 stage=np.array(s), layers=np.array(scfg.num_layers), **out)
