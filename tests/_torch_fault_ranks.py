"""Rank programs for the port's fault-tier tests (one process per rank).

Started by ``_torch_ranks.run_ranks`` (``spawn``, a ``file://``
rendezvous in the test's ``tmp_path``); each rank saves its results to
``<out>/rank<r>.npz``.  Only torch, numpy and ``repro_torch`` are imported.
The scenarios are the port's twins of the multidev battery's sections 14,
16, 17 and 18:

* :func:`elastic_rank` — ZeRO-1 at dp=4 under ``faulty:<impl>``; rank 3 is
  declared dead before step ``KILL_AT``; every rank walks revoke → ack →
  agree → shrink; the survivors rebuild a dp=2 world (the power-of-two
  trim of 3), resume from the last checkpoint and finish; an oracle over
  the same two ranks restores the same checkpoint and runs the same steps;
  ranks 2 (trimmed) and 3 (dead) leave;
* :func:`uneven_rank` — the same on the per-leaf layout with every
  survivor kept (dp=4 → 3), the global batch trimmed to a dp multiple;
* :func:`serve_rank` — a tp=2 serving world: rank 1 dies silently
  mid-decode (only the heartbeat monitor can name it), or its link drops
  the decode broadcast (timeout → retry → escalation); rank 0 recovers and
  replays, rank 1 leaves;
* :func:`corrupt_rank` — dp=2 ZeRO-1 with integrity on: a one-shot
  corruption of each collective of one step in turn, retried in place.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

TOTAL, EVERY, KILL_AT, KILL_RANK = 8, 4, 6, 3
SEQ, GLOBAL_BATCH = 16, 8


def _cfg(zero1: bool = True, buckets: int = 1):
    import repro_torch.configs as cfgs

    cfg = cfgs.smoke_config("qwen2-0.5b")
    return dataclasses.replace(cfg, parallelism=dataclasses.replace(
        cfg.parallelism, zero1=zero1, zero1_buckets=buckets))


def batch_at(step: int, vocab: int = 512) -> dict:
    """The global batch of ``step`` (numpy, seeded by the step)."""
    tok = np.random.default_rng(1000 + step).integers(
        0, vocab, size=(GLOBAL_BATCH, SEQ)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def _state_arrays(state, prefix: str) -> dict:
    from repro_torch.models import param_leaves
    from repro_torch.optim.adamw import tree_leaves

    out = {f"{prefix}param:{n}": p.detach().numpy().copy()
           for n, p in param_leaves(state.params)}
    opt = state.opt
    if hasattr(opt, "ef"):
        out[f"{prefix}m"], out[f"{prefix}v"] = opt.m.numpy(), opt.v.numpy()
    else:
        for i, (m, v) in enumerate(zip(tree_leaves(opt.m), tree_leaves(opt.v))):
            out[f"{prefix}m{i}"], out[f"{prefix}v{i}"] = m.numpy(), v.numpy()
    out[f"{prefix}step"] = np.array(int(state.step))
    return out


def _elastic(rank, world, init_method, out_dir, impl, zero1, uneven, kill_rank=KILL_RANK):
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.backends.faulty import fault_schedule_of
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.runtime.fault import run_supervised
    from repro_torch.train import train_loop as tl

    torch.set_num_threads(1)  # ranks share the host's cores
    cfg = _cfg(zero1=zero1)
    api = build_model(cfg)
    opt = AdamWConfig(lr=5e-3)
    ckdir = Path(out_dir) / "ckpt"
    out = {}
    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   impl=f"faulty:{impl}") as dist:
        sched = fault_schedule_of(dist.abi.backend)
        state = tl.init_state(api, 0, dist)
        step = tl.global_batch_step(dist, tl.make_train_step(api, dist, opt), uneven=uneven)
        policy = tl.elastic_recovery_policy(api, opt, dist, 0, impl=impl,
                                            uneven_shards=uneven)
        killed = []

        def get_batch(i):
            if i == KILL_AT and not killed:
                killed.append(i)
                sched.kill_rank = kill_rank
                sched.dead = True  # the detector now reports the rank dead
            return batch_at(i)

        ck = Checkpointer(ckdir, keep=5, dist=dist)
        rep = run_supervised(step, state, get_batch, checkpointer=ck, total_steps=TOTAL,
                             checkpoint_every=EVERY, max_restarts=2, recover=policy)
        out.update(left=np.array(rep.left_world), restarts=np.array(rep.restarts),
                   steps=np.array(rep.steps_completed), n_losses=np.array(len(rep.losses)),
                   degraded=np.array(dist.degraded),
                   failed=np.array(dist.abi.comm_get_failed(dist.dp_comm)))
        if not rep.left_world:
            new = policy.dist
            out.update(dp=np.array(new.dp_size), world_ranks=np.array(new.mesh.world_ranks),
                       fallbacks=np.array(len(rep.checkpoint_fallbacks)))
            out.update(_state_arrays(rep.final_state, "got:"))
            # the oracle: an uninterrupted run of the survivor world from
            # the SAME checkpoint, on the plain backend
            with make_dist(mesh=new.mesh, impl=impl) as oracle:
                like = tl.init_state(api, 0, oracle)
                st, at = Checkpointer(ckdir, dist=oracle).restore(like, step=EVERY)
                ostep = tl.global_batch_step(oracle, tl.make_train_step(api, oracle, opt),
                                             uneven=uneven)
                for s in range(at, TOTAL):
                    st, _ = ostep(st, batch_at(s))
                out.update(_state_arrays(st, "want:"))
                out["oracle_from"] = np.array(at)
            new.shutdown()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


def elastic_rank(rank, world, init_method, out_dir, impl, kill_rank=KILL_RANK):
    """Battery section 14's twin: dp=4 → kill rank 3 → dp=2, bitwise (and
    dp=8 → kill rank 5 → dp=4 in ``tests/torch_fault_battery.py``)."""
    _elastic(rank, world, init_method, out_dir, impl, zero1=True, uneven=False,
             kill_rank=kill_rank)


def uneven_rank(rank, world, init_method, out_dir):
    """Battery section 17's twin: dp=4 → dp=3, every survivor kept."""
    _elastic(rank, world, init_method, out_dir, "paxi", zero1=False, uneven=True)


def serve_rank(rank, world, init_method, out_dir, impl, mode, kill=1):
    """Battery sections 16 and 18 (serving half) at tp=2: rank ``kill``
    dies silently (``die``) or drops the decode broadcast (``drop``) once
    every slot is decoding; the streams must equal an unfailed engine's."""
    import torch

    from repro_torch.core import get_backend, pax_init
    from repro_torch.core.backends.faulty import FaultSchedule, FaultyBackend, FaultyLib
    from repro_torch.core.backends.ompix import OmpixLib
    from repro_torch.core.mukautuva import MukBackend
    from repro_torch.models import build_model
    from repro_torch.runtime.dist import make_dist
    from repro_torch.runtime.liveness import HeartbeatMonitor
    from repro_torch.serve.engine import DecodeSync, Request, ServeEngine
    from repro_torch.serve.supervisor import ServeSupervisor

    import repro_torch.configs as cfgs

    torch.set_num_threads(1)
    api = build_model(cfgs.smoke_config("qwen2-0.5b"))  # float32
    model = api.init(0, "cpu")

    def reqs():
        return [Request(i, np.arange(1, 6 + i, dtype=np.int32), max_new_tokens=16,
                        temperature=0.8 if i == 1 else 0.0) for i in range(3)]

    eng = ServeEngine(api, model, max_batch=3, max_seq=64, block_size=4,
                      prefill_chunk=4, seed=0)
    oracle = reqs()
    eng.run(oracle)
    want = [r.out_tokens for r in oracle]
    out = {}
    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   model_axis=world) as dist:
        sched = FaultSchedule()
        if impl == "ompix":
            backend = MukBackend(FaultyLib(OmpixLib(dist.mesh), sched,
                                           declare_failures=False), dist.mesh)
        else:
            backend = FaultyBackend(get_backend(impl, dist.mesh), sched,
                                    declare_failures=False)
        abi = pax_init(dist.mesh, impl=backend)
        dist.extra_contexts.append(abi)
        tp = abi.comm_from_axes(("model",), "tp")
        eng.decode_sync = DecodeSync(abi, tp, 3, "cpu")
        mon = HeartbeatMonitor(abi, tp, miss_threshold=2, suspicion_ticks=1).install()
        kw = dict(wait_timeout_s=0.15, transport_retries=1) if mode == "drop" else {}
        sup = ServeSupervisor(eng, monitor=mon, heartbeat_every=1, **kw)
        for r in reqs():
            eng.submit(r)
        live = list(eng.scheduler.waiting)
        while not all(s is not None and s.state == "decode" for s in eng.scheduler.slots):
            sup.step()
        mid = [len(r.out_tokens) for r in live]
        sched.arm(kill, after=0, mode=mode)
        sup.drain()
        rep = sup.report
        out.update(left=np.array(rep.left), failures=np.array(rep.failures),
                   transport_retries=np.array(rep.transport_retries),
                   escalations=np.array(rep.transport_escalations),
                   tokens_replayed=np.array(rep.tokens_replayed), mid=np.array(mid),
                   confirmed=np.array(sorted(mon.confirmed)))
        if not rep.left:
            rep.assert_consistent()
            for i, r in enumerate(live):
                out[f"got{i}"] = np.array(r.out_tokens)
                out[f"want{i}"] = np.array(want[i])
            out["excludes"] = np.array(abi.comms.info(eng.decode_sync.comm).excludes)
            eng.decode_sync.free()
        mon.uninstall()
        dist.degraded = rep.failures > 0  # a member left: the teardown meets nobody
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


CORRUPT_IMPLS = ("paxi", "minimal", "ompix")
CORRUPT_STEP = 1          # the 0-based step whose collectives are corrupted
CORRUPT_STEPS = 3


def corrupt_rank(rank, world, init_method, out_dir):
    """Battery section 18's training half at dp=2: for each backend and each
    collective call of step ``CORRUPT_STEP``, a one-shot corruption on rank
    0 with integrity on; the retried run must equal the unfailed run
    bitwise (losses, grad norms, parameters, moments)."""
    import torch

    from repro_torch.core.backends.faulty import fault_schedule_of
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.runtime.fault import RetryPolicy, run_supervised
    from repro_torch.train import train_loop as tl

    torch.set_num_threads(1)
    api = build_model(_cfg(zero1=True, buckets=2))
    opt = AdamWConfig(lr=5e-3)
    out = {}
    with make_dist(device="cpu", world_size=world, rank=rank,
                   init_method=init_method) as base:
        for impl in CORRUPT_IMPLS:
            d = make_dist(mesh=base.mesh, impl=f"faulty:{impl}", integrity=True)
            base.extra_contexts.append(d.abi)
            sched = fault_schedule_of(d.abi.backend)
            step = tl.global_batch_step(d, tl.make_train_step(api, d, opt))
            runs = {}
            for at in [None] + list(range(64)):
                sched.kill_rank, sched.at_call, sched.corrupted = -1, -1, False
                state = tl.init_state(api, 0, d)
                calls = []

                def get_batch(i, _s=sched, _at=at, _c=calls):
                    if i in (CORRUPT_STEP, CORRUPT_STEP + 1):
                        _c.append(_s.calls)
                    if i == CORRUPT_STEP and _at is not None:
                        _s.arm(0, after=_at, mode="corrupt")
                    return batch_at(i)

                retry = RetryPolicy(max_retries=2, verify=tl.step_verifier(d),
                                    reset=tl.plan_resetter(d))
                rep = run_supervised(step, state, get_batch, total_steps=CORRUPT_STEPS,
                                     max_restarts=0, retry=retry)
                runs[at] = (rep, _state_arrays(rep.final_state, ""), sched.corrupted)
                if at is None:
                    out[f"{impl}:calls_per_step"] = np.array(calls[1] - calls[0])
                elif at + 1 >= out[f"{impl}:calls_per_step"]:
                    break
            d.drop_zero1_plans()
            clean, want, _ = runs.pop(None)
            for at, (rep, got, fired) in runs.items():
                tag = f"{impl}:{at}"
                out[f"{tag}:fired"] = np.array(fired)
                out[f"{tag}:retries"] = np.array(rep.transport_retries)
                out[f"{tag}:same_losses"] = np.array(
                    (rep.losses, [float(x) for x in rep.losses]) == (clean.losses, clean.losses))
                out[f"{tag}:same_state"] = np.array(
                    all(np.array_equal(got[k], want[k]) for k in want))
            out[f"{impl}:clean_losses"] = np.array(clean.losses)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
