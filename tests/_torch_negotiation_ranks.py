"""Rank programs for the port's negotiation tests across ranks (one process
per rank, started by ``_torch_ranks.run_ranks``; torch and ``repro_torch``
only).  They are the gloo twins of the multidev battery's sections 5
(Mukautuva across ranks), 8 (the minimal backend's emulation chains) and
11 (multi-axis alltoallv on the world communicator).  Rank ``r`` holds row
``r`` of :data:`XG`; each program saves what it got to ``<out>/rank<r>.npz``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

#: rank-major chunks: rank r holds XG[r] (the battery's layout, 8 per row)
XG = np.arange(64.0, dtype=np.float32).reshape(8, 8) + 1.0
#: the zero1 probe length (divides by dp=2 x 2 buckets)
NV = 16
#: rows of the padded emulated allreduce plan (not a multiple of the world)
N_PAD = 11


def _save(out_dir, rank, out: dict) -> None:
    import torch

    np.savez(Path(out_dir) / f"rank{rank}.npz",
             **{k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in out.items()})


def world2_rank(rank, world, init_method, out_dir):
    """Sections 5 and 8 at a world of two (mesh (data=2, model=1))."""
    import torch

    import repro_torch.core as C
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import grad_sync as gs

    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   impl="minimal") as dist:
        out = {}
        x = torch.from_numpy(XG[rank].copy())
        W, SUM = C.PAX_COMM_WORLD, C.PAX_SUM
        # -- section 5: Mukautuva across ranks -----------------------------
        ox = C.pax_init(dist.mesh, impl="ompix")
        dist.extra_contexts.append(ox)
        dp = ox.comm_from_axes(("data",), "dp")
        send_t = [C.PAX_FLOAT32] * 2
        recv_t = [C.PAX_FLOAT64, C.PAX_FLOAT32]
        parts = ox.alltoallw(x.reshape(2, 4), send_t, recv_t, dp)
        out["a2aw_dtypes"] = np.array([str(p.dtype) for p in parts])
        for j, p in enumerate(parts):
            out[f"a2aw_{j}"] = p
        req = ox.ialltoallw(x.reshape(2, 4), send_t, recv_t, dp)
        out["a2aw_temps_held"] = req.temp_state is ox.backend.last_alltoallw_temps
        ox.wait(req)
        out["a2aw_temps_dropped"] = req.temp_state is None
        calls = []

        def spy(a, b):
            calls.append(1)
            return a + b

        op = ox.op_create(spy, name="sumspy")
        out["userop_sum"] = ox.allreduce(x, op, W)
        out["userop_calls"] = len(calls)
        out["userop_max"] = ox.allreduce(x, C.PAX_MAX, dp)
        # -- section 8: the minimal backend --------------------------------
        abi = dist.abi
        caps = abi.capabilities()
        out["caps"] = np.array([caps[n]["source"] for n in
                                ("allreduce", "scatter", "reduce_scatter", "bcast")])
        out["scatter_deps"] = np.array(caps["scatter"]["deps"])
        out["unavailable"] = sum(i["source"] == "unavailable" for i in caps.values())
        # zero1 round trip, pooled and on the persistent plans: shard
        # update s -> 2s, the all-gather returns mean(v) * 2 everywhere
        vin = np.arange(2 * NV, dtype=np.float32)
        v = torch.from_numpy(vin[rank * NV:(rank + 1) * NV].copy())
        plans = gs.build_zero1_plans(dist, NV, 2)
        for mode, p in (("pooled", None), ("plans", plans)):
            pending, _ = gs.reduce_scatter_grads_start(dist, v, buckets=2, plans=p)
            shard = gs.reduce_scatter_grads_finish(pending)
            out[f"zero1_{mode}"] = gs.allgather_params(dist, shard * 2.0, buckets=2, plans=p)
        out["zero1_outstanding"] = abi.outstanding_requests
        # the same round trip through Mukautuva: the generated plan-group
        # wrappers of ompix carry both legs at dp=2
        dx = make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                       impl="ompix")
        dist.extra_contexts.append(dx.abi)
        xplans = gs.build_zero1_plans(dx, NV, 2)
        for mode, p in (("pooled", None), ("plans", xplans)):
            pending, _ = gs.reduce_scatter_grads_start(dx, v, buckets=2, plans=p)
            shard = gs.reduce_scatter_grads_finish(pending)
            out[f"zero1_ompix_{mode}"] = gs.allgather_params(dx, shard * 2.0, buckets=2,
                                                             plans=p)
        out["zero1_ompix_caps"] = np.array([dx.abi.capabilities()[n]["plan_group"]
                                            for n in ("reduce_scatter", "allgather")])
        # the chains, depth 1-3, and the other recipes, on the world comm
        b = abi.bcast(x, 1, W)
        out.update(
            ar=abi.allreduce(x, SUM, W),                       # depth 1
            bcast=b,                                           # depth 2
            scatter=abi.scatter(b, 0, W),                      # depth 3
            reduce=abi.reduce(x, SUM, 0, W),
            a2a=abi.alltoall(x.reshape(2, 4), W, 0, 0),
            a2a_ax=abi.alltoall(x.reshape(2, 4), W, 1, 0),
            scan=abi.scan(x, SUM, W), exscan=abi.exscan(x, SUM, W),
            gather=abi.gather(x[:3], 0, W),
            a2av=abi.alltoallv(x, [4, 4], [4, 4], W),
            ar_prod=abi.allreduce(x[:3] / 8, C.PAX_PROD, W),
            i_ar=abi.wait(abi.iallreduce(x, SUM, W)),
            i_bcast=abi.wait(abi.ibcast(x, 0, W)),
        )
        abi.barrier(W)
        abi.wait(abi.ibarrier(W))
        # recipe plans: padding fixed at plan time, ranks frozen, groups fused
        pa = abi.allreduce_init(x[:N_PAD], SUM, W)
        out["plan_ar"] = abi.wait(pa.start(x[:N_PAD]))
        out["plan_ar_again"] = abi.wait(pa.start(2 * x[:N_PAD]))
        pb = abi.bcast_init(x, 1, W)
        out["plan_bcast"] = abi.wait(pb.start(x))
        ps = abi.scan_init(x, SUM, W)
        out["plan_scan"] = abi.wait(ps.start(x))
        pe = abi.exscan_init(x, SUM, W)
        out["plan_exscan"] = abi.wait(pe.start(x))
        pg = abi.gather_init(x[:3], 0, W)
        out["plan_gather"] = abi.wait(pg.start(x[:3]))
        pr = abi.reduce_init(x, SUM, 0, W)
        out["plan_reduce"] = abi.wait(pr.start(x))
        pbar = abi.barrier_init(W)
        out["plan_barrier"] = abi.wait(pbar.start()) is None
        grp = abi.plan_group([abi.reduce_init(x, SUM, 0, W), abi.reduce_init(x, SUM, 0, W)],
                             name="reduce2")
        out["group_reduce_0"], out["group_reduce_1"] = abi.wait(grp.start([x, 3 * x]))
        ar3 = abi.plan_group([abi.allreduce_init(x[:N_PAD], SUM, W) for _ in range(3)],
                             name="ar3")
        out["group_ar"] = torch.stack(abi.wait(ar3.start([x[:N_PAD], 2 * x[:N_PAD],
                                                           3 * x[:N_PAD]])))
        out["outstanding"] = abi.outstanding_requests
        # the native backend on the same inputs, for the bitwise comparison
        px = C.pax_init(dist.mesh, impl="paxi")
        dist.extra_contexts.append(px)
        out.update(paxi_ar=px.allreduce(x, SUM, W), paxi_scan=px.scan(x, SUM, W),
                   paxi_exscan=px.exscan(x, SUM, W),
                   paxi_a2a=px.alltoall(x.reshape(2, 4), W, 0, 0),
                   paxi_a2a_ax=px.alltoall(x.reshape(2, 4), W, 1, 0),
                   paxi_scatter=px.scatter(px.bcast(x, 1, W), 0, W),
                   paxi_ar_prod=px.allreduce(x[:3] / 8, C.PAX_PROD, W))
        _save(out_dir, rank, out)


A2AV_IMPLS = ("paxi", "ring", "minimal", "ompix")


def world4_rank(rank, world, init_method, out_dir):
    """At a world of four as a (data=2, model=2) mesh: section 11,
    alltoallv over ``PAX_COMM_WORLD`` on ``A2AV_IMPLS``, one and two rows
    per peer; and section 1, every registered backend's collectives on the
    world, data and model communicators."""
    import torch

    import repro_torch.core as C
    from repro_torch.runtime.dist import make_dist

    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   model_axis=2) as dist:
        x1 = torch.from_numpy(XG[rank, :world].copy())
        x2 = torch.from_numpy(np.arange(world * 2 * world, dtype=np.float32)
                              .reshape(world, 2 * world)[rank].copy())
        x = torch.from_numpy(XG[rank].copy())
        W = C.PAX_COMM_WORLD
        out = {}
        for impl in C.available_backends():
            abi = C.pax_init(dist.mesh, impl=impl)
            dist.extra_contexts.append(abi)
            dp = abi.comm_from_axes(("data",), "dp")
            mp = abi.comm_from_axes(("model",), "mp")
            if impl in A2AV_IMPLS:
                out[f"{impl}:c1"] = abi.alltoallv(x1, (1,) * world, (1,) * world, W)
                out[f"{impl}:c2"] = abi.alltoallv(x2, (2,) * world, (2,) * world, W)
                out[f"{impl}:source"] = abi.capabilities()["alltoallv"]["source"]
            out.update({
                f"{impl}:sum": abi.allreduce(x, C.PAX_SUM, W),
                f"{impl}:max": abi.allreduce(x, C.PAX_MAX, W),
                f"{impl}:min": abi.allreduce(x, C.PAX_MIN, W),
                f"{impl}:prod": abi.allreduce(x / 8, C.PAX_PROD, W),
                f"{impl}:ag_dp": abi.allgather(x, dp),
                f"{impl}:rs": abi.reduce_scatter(x, C.PAX_SUM, W),
                f"{impl}:scan": abi.scan(x, C.PAX_SUM, W),
                f"{impl}:exscan": abi.exscan(x, C.PAX_SUM, W),
                f"{impl}:a2av_mp": abi.alltoallv(x, (4, 4), (4, 4), mp),
                f"{impl}:a2a_mp": abi.alltoall(x.reshape(2, 4), mp, 0, 0).reshape(-1),
            })
        _save(out_dir, rank, out)
