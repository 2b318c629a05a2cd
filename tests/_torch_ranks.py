"""Rank programs for the port's multi-process tests (one process per rank).

The tests start these with the ``spawn`` method, one process per rank,
meeting through a ``file://`` rendezvous in the test's ``tmp_path``; each
rank writes its results to ``<out>/rank<r>.npz``.  Only torch and
``repro_torch`` are imported here, so a rank starts in a few seconds.
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

    dist = make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method)
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
    torch.distributed.destroy_process_group()


def launch_rank(rank, world, init_method, out_dir, argv):
    """``repro_torch.launch.train.main`` as one rank of the world, through
    its own ``--world-size``/``--rank``/``--init-method`` flags."""
    import torch

    from repro_torch.launch import train

    rep = train.main(list(argv) + ["--world-size", str(world), "--rank", str(rank),
                                   "--init-method", init_method])
    np.savez(Path(out_dir) / f"rank{rank}.npz", losses=np.array(rep.losses),
             grad_norms=np.array(rep.grad_norms))
    torch.distributed.destroy_process_group()


def collectives_rank(rank, world, init_method, out_dir):
    """Every collective of the ABI on a real multi-rank group, blocking,
    nonblocking and persistent, on inputs that depend on the rank."""
    import torch

    import repro_torch.core as C
    from repro_torch.runtime.dist import make_dist

    dist = make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method)
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
    torch.distributed.destroy_process_group()
