"""The port's fault tier against the reference, on the CPU: the twin of
``tests/test_fault_tier.py`` plus the multidev battery's sections 13, 14
and 17 on gloo worlds.

* the shared ULFM kernels, the communicator table's revocation and shrink
  bookkeeping, and the schedule grammar: the same inputs through both
  packages give the same answers;
* negotiation sources, revocation precedence and the plan reset on
  ``comm_revoke`` in a world of one;
* the ``faulty:`` prefix, the tripwire, ``heartbeat_silent`` attribution
  and the foreign rc path through Mukautuva (same error codes as the
  reference);
* where a scheduled fault lands in a ZeRO-1 step: the collective calls of
  one step, each with the schedule count before and after it, equal the
  reference's (so ``at=N`` hits the same entry in both packages);
* the supervised loop's restarts, loss realignment, straggler restarts and
  report invariant, on the same step functions as the reference's tests;
* elastic data parallelism on four gloo ranks: rank 3 dies at step 6 of 8,
  the survivors shrink to dp=2 (the power-of-two trim) and resume from the
  step-4 checkpoint bitwise equal to a dp=2 oracle restored from the same
  checkpoint, on ``paxi``, ``minimal`` and ``ompix``; and the uneven leg
  (dp=4 → 3, every survivor kept, per-leaf moments).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as R
from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.core import emulation as r_em
from repro.core.backends.faulty import FaultSchedule as RSchedule
from repro.core.backends.faulty import FaultyBackend as RFaulty
from repro.core.communicator import CommTable as RTable
from repro.runtime import fault as r_fault

import repro_torch.core as C
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import emulation as em
from repro_torch.core.backends.faulty import (FaultSchedule, FaultyBackend, FaultyLib,
                                              fault_schedule_of)
from repro_torch.core.backends.ompix import OmpixLib
from repro_torch.core.communicator import CommTable, Mesh
from repro_torch.core.errors import PAX_ERR_PROC_FAILED, PAX_ERR_REVOKED, PaxError
from repro_torch.core.mukautuva import MukBackend
from repro_torch.runtime import fault as t_fault
from repro_torch.runtime.dist import make_dist

import _torch_fault_ranks as FR
import _torch_ranks

FAULT_ENTRIES = ("comm_revoke", "comm_failure_ack", "comm_get_failed",
                 "comm_agree", "comm_shrink")


@pytest.fixture(scope="module")
def world():
    with make_dist(device="cpu") as d:
        yield d


class _FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 8, "model": 1}


class _FakeTable(CommTable):
    """An 8-rank table in a world of one: groups are markers, never built."""

    def _group(self, ranks, local=False):
        return ("group", ranks)


def _tables(world):
    return (RTable(_FakeMesh()),
            _FakeTable(Mesh(("data", "model"), (8, 1), torch.device("cpu"))))


# ---------------------------------------------------------------------------
# shared kernels and the table, both packages on the same inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alive", [[True] * 4, [True, True, True, False],
                                   [True, False, True, True]])
def test_masked_agree_fold_matches_the_reference(alive):
    contribs = [0b111, 0b101, 0b110, 0b011]
    assert em.masked_agree_fold(contribs, alive) == r_em.masked_agree_fold(contribs, alive)


def test_masked_agree_fold_no_survivors_raises():
    with pytest.raises(PaxError) as ei:
        em.masked_agree_fold([1, 1], [False, False])
    assert ei.value.code == PAX_ERR_PROC_FAILED


def test_comm_failure_view_and_agree_match_the_reference(world):
    detector = lambda comm: (3, 5)  # noqa: E731
    got = []
    for t in _tables(world):
        w = C.PAX_COMM_WORLD
        info, failed, acked = (r_em if isinstance(t, RTable) else em).comm_failure_view(
            t, detector, w)
        child = t.register_shrunk(w, (5,))
        _, failed_c, _ = (r_em if isinstance(t, RTable) else em).comm_failure_view(
            t, detector, child)
        mod = r_em if isinstance(t, RTable) else em
        with pytest.raises(Exception) as ei:
            mod.agree_value(t, lambda c: (2,), 1, w)
        t.acked[w] = frozenset({2})
        got.append((failed, acked, failed_c, t.info(child).excludes, ei.value.code,
                    mod.agree_value(t, lambda c: (2,), 0b1010, w)))
    assert got[0] == got[1]
    assert got[1][2] == frozenset({3}) and got[1][4] == PAX_ERR_PROC_FAILED


def test_revoke_poisons_info_exactly(world):
    _, t = _tables(world)
    dp = t.comm_from_axes(("data",), "dp")
    t.revoke(dp)
    assert t.is_revoked(dp) and dp not in t.info_by_handle
    with pytest.raises(PaxError) as ei:
        t.info(dp)
    assert ei.value.code == PAX_ERR_REVOKED
    assert t.info(dp, allow_revoked=True).full_size == 8
    assert t.info(C.PAX_COMM_WORLD).full_size == 8


def test_register_shrunk_accumulates_excludes_as_the_reference(world):
    got = []
    for t in _tables(world):
        w = C.PAX_COMM_WORLD
        child = t.register_shrunk(w, (5,), "survivors")
        grand = t.register_shrunk(child, (1,))
        again = t.register_shrunk(child, (5, 1))
        got.append([(t.info(h).excludes, t.info(h).size, t.info(h).full_size)
                    for h in (child, grand, again)])
    assert got[0] == got[1] == [((5,), 7, 8), ((1, 5), 6, 8), ((1, 5), 6, 8)]


def test_a_survivor_comm_gets_the_survivors_group(world):
    _, t = _tables(world)
    child = t.register_shrunk(C.PAX_COMM_WORLD, (5,))
    info = t.info(child)
    assert info.group == ("group", (0, 1, 2, 3, 4, 6, 7))
    assert info.ranks == tuple(range(8))  # the parent's rank space


# ---------------------------------------------------------------------------
# the ABI in a world of one
# ---------------------------------------------------------------------------
def test_fault_tier_negotiation_sources(world):
    for impl, want in (("paxi", "native"), ("minimal", "emulated"), ("ompix", "emulated")):
        caps = C.pax_init(world.mesh, impl=impl).capabilities()
        for e in FAULT_ENTRIES:
            assert caps[e]["tier"] == "fault" and caps[e]["source"] == want, (impl, e)
        assert not [n for n, i in caps.items() if i["source"] == "unavailable"]


@pytest.mark.parametrize("impl", ["paxi", "minimal", "ompix"])
def test_revoke_then_collective_raises_revoked_exactly(world, impl):
    abi = C.pax_init(world.mesh, impl=impl)
    w = C.PAX_COMM_WORLD
    abi.comm_revoke(w)
    with pytest.raises(PaxError) as ei:
        abi.allreduce(torch.ones(4), C.PAX_SUM, w)
    assert ei.value.code == PAX_ERR_REVOKED
    abi.comm_failure_ack(w)
    assert tuple(abi.comm_get_failed(w)) == ()
    assert abi.comm_agree(1, w) == 1
    survivor = abi.comm_shrink(w)
    assert survivor != w and abi.comm_size(survivor) == 1


def test_revoke_resets_plans_and_groups_on_that_comm(world):
    abi = C.pax_init(world.mesh, impl="paxi")
    w = C.PAX_COMM_WORLD
    dp = abi.comm_from_axes(("data",), "dp")
    x = torch.zeros(4)
    p_world = abi.allreduce_init(x, C.PAX_SUM, w)
    p_dp = abi.allreduce_init(x, C.PAX_SUM, dp)
    group = abi.plan_group([p_world], "g")
    for obj in (p_world, p_dp, group):
        obj.request.done = False  # started, never waited
    abi.comm_revoke(w)
    assert p_world.request.done and group.request.done
    assert not p_dp.request.done
    p_dp.reset()


# ---------------------------------------------------------------------------
# the schedule, the tripwire, the prefix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text", ["rank=5,at=12", "", "rank=2,at=0,mode=drop",
                                  "rank=0,at=3,mode=delay,delay=0.25"])
def test_schedule_grammar_matches_the_reference(text):
    a, b = FaultSchedule.from_env(text), RSchedule.from_env(text)
    assert (a.kill_rank, a.at_call, a.mode, a.delay_s, a.armed) == (
        b.kill_rank, b.at_call, b.mode, b.delay_s, b.armed)


@pytest.mark.parametrize("text", ["bogus=1", "rank=1,at=0,mode=bogus"])
def test_schedule_grammar_errors(text):
    with pytest.raises(ValueError):
        FaultSchedule.from_env(text)
    with pytest.raises(ValueError):
        RSchedule.from_env(text)


def test_schedule_from_the_environment(monkeypatch):
    monkeypatch.setenv("PAX_FAULT_SCHEDULE", "rank=5,at=12")
    s = FaultSchedule.from_env()
    assert (s.kill_rank, s.at_call) == (5, 12) and s.armed and not s.dead


@pytest.mark.parametrize("mode", ["die", "corrupt", "drop", "delay"])
def test_fault_now_sequence_matches_the_reference(mode):
    seqs = []
    for cls in (FaultSchedule, RSchedule):
        s = cls()
        s.arm(0, after=2, mode=mode)
        seq = []
        for i in range(6):
            f = s.fault_now()
            seq.append(f)
            if f == "corrupt":
                s.corrupted = True
        seqs.append((seq, s.dead, s.dropping, s.calls))
    assert seqs[0] == seqs[1]


def test_faulty_backend_tripwire_and_revoked_precedence(world):
    sched = FaultSchedule()
    backend = FaultyBackend(C.get_backend("paxi", world.mesh), sched)
    abi = C.pax_init(world.mesh, impl=backend)
    w = C.PAX_COMM_WORLD
    caps = abi.capabilities()
    assert caps["allreduce"]["fault_injection"] is True
    for e in FAULT_ENTRIES:
        assert caps[e]["source"] == "native"
    x = torch.ones(4)
    assert torch.equal(abi.allreduce(x, C.PAX_SUM, w), x)
    sched.arm(0, after=0)
    with pytest.raises(PaxError) as ei:
        abi.allreduce(x, C.PAX_SUM, w)
    assert ei.value.code == PAX_ERR_PROC_FAILED
    assert tuple(abi.comm_get_failed(w)) == (0,)
    abi.comm_revoke(w)
    with pytest.raises(PaxError) as ei:  # REVOKED outranks PROC_FAILED
        abi.allreduce(x, C.PAX_SUM, w)
    assert ei.value.code == PAX_ERR_REVOKED


def test_registry_faulty_prefix_and_instance_init(world):
    b = C.get_backend("faulty:minimal", world.mesh)
    assert b.name == "faulty:minimal" and isinstance(b, FaultyBackend)
    assert fault_schedule_of(b) is b.schedule
    assert C.pax_init(world.mesh, impl=b).backend is b
    f = C.get_backend("faulty:ompix", world.mesh)
    assert isinstance(f, MukBackend) and isinstance(f.lib, FaultyLib)
    assert fault_schedule_of(f) is f.lib.schedule
    assert fault_schedule_of(C.get_backend("paxi", world.mesh)) is None
    assert not any(n.startswith("faulty") for n in C.available_backends())


@pytest.mark.parametrize("entry", ["allreduce", "barrier"])
def test_foreign_rc_crosses_mukautuva_as_the_reference(world, mesh1, entry):
    """A dead rank behind the foreign library: ``OMPIX_ERR_PROC_FAILED``
    rcs become ``PAX_ERR_PROC_FAILED`` in both packages, and a revoke
    still outranks it."""
    from repro.core.backends.faulty import FaultyLib as RLib
    from repro.core.backends.ompix import OmpixLib as ROmpix
    from repro.core.mukautuva import MukBackend as RMuk
    from repro.core.compat import shard_map
    from jax.sharding import PartitionSpec as P

    codes = []
    for pkg in ("ref", "port"):
        sched = RSchedule() if pkg == "ref" else FaultSchedule()
        if pkg == "ref":
            abi = R.pax_init(mesh1, impl=RMuk(RLib(ROmpix(mesh1), sched), mesh1))
            dp = abi.comm_from_axes(("data",), "dp")
            x = jnp.ones(4)
            call = (lambda: shard_map(lambda v: abi.allreduce(v, R.PAX_SUM, dp), mesh=mesh1,
                                      in_specs=P(), out_specs=P())(x)) if entry == "allreduce" \
                else (lambda: shard_map(lambda v: (abi.barrier(dp), v)[1], mesh=mesh1,
                                        in_specs=P(), out_specs=P())(x))
        else:
            abi = C.pax_init(world.mesh, impl=MukBackend(FaultyLib(OmpixLib(world.mesh), sched),
                                                         world.mesh))
            dp = abi.comm_from_axes(("data",), "dp")
            call = (lambda: abi.allreduce(torch.ones(4), C.PAX_SUM, dp)) \
                if entry == "allreduce" else (lambda: abi.barrier(dp))
        call()
        sched.arm(0, after=0)
        got = []
        for _ in range(2):
            with pytest.raises(Exception) as ei:
                call()
            got.append(ei.value.code)
            abi.comm_revoke(dp)
        codes.append((got, tuple(abi.comm_get_failed(dp))))
    assert codes[0] == codes[1] == ([PAX_ERR_PROC_FAILED, PAX_ERR_REVOKED], (0,))


def test_heartbeat_silent_is_transport_not_declaration(world):
    plain = C.get_backend("paxi", world.mesh)
    assert plain.heartbeat_silent(C.PAX_COMM_WORLD) == ()
    sched = FaultSchedule()
    backend = FaultyBackend(C.get_backend("paxi", world.mesh), sched, declare_failures=False)
    abi = C.pax_init(world.mesh, impl=backend)
    w = C.PAX_COMM_WORLD
    assert backend.heartbeat_silent(w) == ()
    sched.arm(0, after=0)
    sched.on_call()
    assert backend.local_failed(w) == () and backend.heartbeat_silent(w) == (0,)
    abi.comm_revoke(w)
    assert backend.heartbeat_silent(w) == (0,)


def test_heartbeat_silent_respects_membership(world):
    sched = FaultSchedule()
    backend = FaultyBackend(C.get_backend("paxi", world.mesh), sched)
    sched.arm(5, after=0)  # rank 5 does not exist in a world of one
    sched.on_call()
    assert sched.dead
    assert backend.local_failed(C.PAX_COMM_WORLD) == ()
    assert backend.heartbeat_silent(C.PAX_COMM_WORLD) == ()


def test_heartbeat_silent_crosses_mukautuva(world):
    bare = MukBackend(OmpixLib(world.mesh), world.mesh)
    assert bare.heartbeat_silent(C.PAX_COMM_WORLD) == ()
    sched = FaultSchedule()
    mb = MukBackend(FaultyLib(OmpixLib(world.mesh), sched, declare_failures=False),
                    world.mesh)
    C.pax_init(world.mesh, impl=mb)
    w = C.PAX_COMM_WORLD
    assert mb.heartbeat_silent(w) == ()
    sched.arm(0, after=0)
    sched.on_call()
    assert mb.local_failed(w) == () and mb.heartbeat_silent(w) == (0,)


def test_monitor_tripwire_race_revoked_outranks_proc_failed(world):
    from repro_torch.runtime.liveness import HeartbeatMonitor

    sched = FaultSchedule()
    backend = FaultyBackend(C.get_backend("paxi", world.mesh), sched, declare_failures=False)
    abi = C.pax_init(world.mesh, impl=backend)
    w = C.PAX_COMM_WORLD
    mon = HeartbeatMonitor(abi, w, miss_threshold=2, suspicion_ticks=1).install()
    try:
        assert tuple(abi.comm_get_failed(w)) == ()
        sched.arm(0, after=0)
        sched.on_call()
        mon.beat()
        assert tuple(abi.comm_get_failed(w)) == ()
        mon.beat()
        assert 0 in mon.confirmed and tuple(abi.comm_get_failed(w)) == (0,)
        with pytest.raises(PaxError) as ei:
            abi.allreduce(torch.ones(4), C.PAX_SUM, w)
        assert ei.value.code == PAX_ERR_PROC_FAILED
        abi.comm_revoke(w)
        with pytest.raises(PaxError) as ei:
            abi.allreduce(torch.ones(4), C.PAX_SUM, w)
        assert ei.value.code == PAX_ERR_REVOKED
        mon.beat()
        assert mon.failed(w) == (0,)
    finally:
        mon.uninstall()


# ---------------------------------------------------------------------------
# where a scheduled fault lands in a ZeRO-1 step
# ---------------------------------------------------------------------------
class _Ledger:
    """Records each ABI call (plan groups as one) with the schedule's call
    count before and after it."""

    def __init__(self, sched):
        self.sched, self.rows = sched, []

    def attach(self, abi):
        pass

    def before(self, fname, args, info):
        if fname.startswith("comm_"):  # queries (the port asks its rank by call)
            self.rows.append(None)
            return
        self.rows.append([fname, self.sched.calls])

    def after(self, fname, args, info, res):
        if self.rows[-1] is None:
            self.rows.pop()
        else:
            self.rows[-1].append(self.sched.calls)
        return res


@pytest.mark.parametrize("impl", ["paxi", "minimal"])
def test_fault_lands_on_the_same_entry_as_the_reference(world, mesh1, impl):
    import dataclasses

    import repro.configs as r_cfgs
    from repro.models import build_model as r_build
    from repro.optim.adamw import AdamWConfig as RAdam
    from repro.runtime.dist import make_dist as r_make_dist
    from repro.train import train_loop as r_tl

    import repro_torch.configs as t_cfgs
    from repro_torch.models import build_model as t_build
    from repro_torch.optim.adamw import AdamWConfig as TAdam
    from repro_torch.train import train_loop as t_tl

    def cfg(mod):
        c = mod.smoke_config("qwen2-0.5b")
        return dataclasses.replace(c, parallelism=dataclasses.replace(
            c.parallelism, zero1=True, zero1_buckets=2))

    batch = FR.batch_at(0)
    rs = RSchedule()
    rled = _Ledger(rs)
    rdist = r_make_dist(mesh1, impl=RFaulty(R.get_backend(impl, mesh1), rs), tools=(rled,))
    rapi = r_build(cfg(r_cfgs))
    rstate = r_tl.init_state(rapi, jax.random.PRNGKey(0), rdist)
    rled.rows.clear()
    jax.jit(r_tl.make_train_step(rapi, rdist, RAdam()))(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()})

    ts = FaultSchedule()
    tled = _Ledger(ts)
    with make_dist(mesh=world.mesh, impl=FaultyBackend(C.get_backend(impl, world.mesh), ts),
                   tools=(tled,)) as tdist:
        tapi = t_build(cfg(t_cfgs))
        tstate = t_tl.init_state(tapi, 0, tdist)
        tled.rows.clear()
        step = t_tl.make_train_step(tapi, tdist, TAdam())
        step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert tled.rows == rled.rows
        per_step = tled.rows[-1][2]
        # and the port raises on that entry: a death at every call of step 2
        reset = t_tl.plan_resetter(tdist)
        for at in range(per_step):
            ts.dead, ts.kill_rank = False, -1
            reset()  # a death inside a group start leaves it active
            tled.rows.clear()
            ts.arm(0, after=at)
            with pytest.raises(PaxError) as ei:
                step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
            assert ei.value.code == PAX_ERR_PROC_FAILED
            hit = next(r[0] for r in rled.rows if r[1] <= at < r[2])
            assert tled.rows[-1][0] == hit, (at, tled.rows, rled.rows)
        ts.dead, ts.kill_rank = False, -1
        reset()
        tdist.drop_zero1_plans()


# ---------------------------------------------------------------------------
# the supervised loop, on the reference's own step functions
# ---------------------------------------------------------------------------
class _Loss:
    def __init__(self, v):
        self.loss = v


def _acc_step(fail_at, attempts, np_mod):
    def step_fn(state, batch):
        step = int(state["step"])
        if step in fail_at and attempts[step] == 0:
            attempts[step] += 1
            raise RuntimeError(f"injected at {step}")
        new = {"step": state["step"] + 1, "acc": state["acc"] + batch["x"]}
        return new, _Loss(float(new["acc"]))
    return step_fn


def _init(pkg):
    if pkg == "ref":
        return {"step": jnp.int32(0), "acc": jnp.float32(0.0)}
    return {"step": torch.zeros((), dtype=torch.int32), "acc": torch.zeros(())}


def _supervised(pkg, tmp_path, **kw):
    run = r_fault.run_supervised if pkg == "ref" else t_fault.run_supervised
    ck = (RCheckpointer if pkg == "ref" else Checkpointer)(tmp_path / pkg, keep=3)
    return run(checkpointer=ck, **kw)


def test_supervised_restart_and_loss_realignment_match_the_reference(tmp_path):
    reps = []
    for pkg in ("ref", "port"):
        attempts = {7: 0, 12: 0}
        reps.append(_supervised(pkg, tmp_path, step_fn=_acc_step({7, 12}, attempts, pkg),
                                init_state=_init(pkg), batches=lambda i: {"x": float(i)},
                                total_steps=20, checkpoint_every=5, max_restarts=5))
    r, t = reps
    assert (t.steps_completed, t.restarts, t.losses) == (r.steps_completed, r.restarts, r.losses)
    assert len(t.losses) == 20 and float(t.final_state["acc"]) == sum(range(20))


@pytest.mark.parametrize("decision,want", [("restart", 1), ("continue", 0)])
def test_on_straggler_restart_path_matches_the_reference(tmp_path, decision, want):
    got = []
    for pkg, mod in (("ref", r_fault), ("port", t_fault)):
        class Forced(mod.StepWatchdog):
            def __init__(self, at):
                super().__init__(on_straggler=lambda s, dt: decision)
                self.at = at

            def observe(self, step, dt):
                if step == self.at and not self.stragglers:
                    self.stragglers.append((step, dt))
                    return True
                return False

        rep = _supervised(pkg, tmp_path, step_fn=_acc_step(set(), {}, pkg),
                          init_state=_init(pkg), batches=lambda i: {"x": float(i)},
                          total_steps=12, checkpoint_every=4, max_restarts=3,
                          watchdog=Forced(6))
        got.append((rep.restarts, rep.stragglers, rep.steps_completed, rep.losses,
                    float(rep.final_state["acc"])))
    assert got[0] == got[1] and got[1][0] == want and len(got[1][3]) == 12


def test_on_straggler_rejects_bad_decision():
    wd = t_fault.StepWatchdog(on_straggler=lambda s, dt: "panic")
    with pytest.raises(ValueError):
        wd.on_straggler(3, 1.0)
    assert t_fault.StepWatchdog().on_straggler(3, 1.0) == "continue"


def test_watchdog_flags_the_reference_stragglers():
    got = []
    for mod in (r_fault, t_fault):
        wd = mod.StepWatchdog(window=16, straggler_factor=2.0)
        flags = [wd.observe(i, 0.1) for i in range(10)] + [wd.observe(10, 0.5)]
        got.append((flags, wd.stragglers))
    assert got[0] == got[1] and got[1][0][-1]


def test_supervisor_gives_up(tmp_path):
    def bad_step(state, batch):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        t_fault.run_supervised(bad_step, {"step": torch.zeros(())}, lambda i: {},
                               checkpointer=Checkpointer(tmp_path), total_steps=3,
                               max_restarts=2)


def test_supervisor_report_invariant():
    t_fault.SupervisorReport(20, 0, 0, None, [])
    t_fault.SupervisorReport(20, 0, 0, None, [0.0] * 20)
    t_fault.SupervisorReport(25, 0, 0, None, [0.0] * 5, resumed_from=20)
    t_fault.SupervisorReport(6, 1, 0, None, [0.0] * 6, left_world=True)
    with pytest.raises(AssertionError):
        t_fault.SupervisorReport(20, 0, 0, None, [0.0] * 21)


def test_a_restart_without_a_checkpoint_refuses_an_in_place_state(world):
    """The port's step writes its parameters in place: with nothing saved,
    a restart cannot return to the initial state and says so."""
    class S:
        params = torch.nn.Linear(1, 1)

    def bad(state, batch):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="needs a checkpoint"):
        t_fault.run_supervised(bad, S(), lambda i: {}, total_steps=2, max_restarts=1)


# ---------------------------------------------------------------------------
# elastic data parallelism on gloo (battery sections 14 and 17)
# ---------------------------------------------------------------------------
_ELASTIC: dict = {}


def _elastic(key, tmp_path_factory):
    if key not in _ELASTIC:
        d = tmp_path_factory.mktemp(f"elastic-{key}")
        if key == "uneven":
            _ELASTIC[key] = _torch_ranks.run_ranks(FR.uneven_rank, 4, d, timeout=120)
        else:
            _ELASTIC[key] = _torch_ranks.run_ranks(FR.elastic_rank, 4, d, key, timeout=120)
    return _ELASTIC[key]


def _split(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


@pytest.mark.parametrize("impl", ["paxi", "minimal", "ompix"])
def test_elastic_shrink_resumes_bitwise_against_the_survivor_oracle(tmp_path_factory, impl):
    ranks = _elastic(impl, tmp_path_factory)
    for r in (0, 1):
        out = ranks[r]
        assert not out["left"] and out["restarts"] == 1 and out["steps"] == FR.TOTAL
        assert out["n_losses"] == FR.TOTAL and out["dp"] == 2
        assert list(out["world_ranks"]) == [0, 1] and out["oracle_from"] == FR.EVERY
        got, want = _split(out, "got:"), _split(out, "want:")
        assert got.keys() == want.keys() and len(got) > 3
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("impl", ["paxi", "minimal", "ompix"])
def test_elastic_dead_and_trimmed_ranks_leave(tmp_path_factory, impl):
    ranks = _elastic(impl, tmp_path_factory)
    for r in (2, 3):  # 3 died; 2 survived the shrink, the trim to dp=2 left it out
        assert ranks[r]["left"] and ranks[r]["steps"] == FR.KILL_AT
    for out in ranks:
        assert list(out["failed"]) == [FR.KILL_RANK] and out["degraded"]


def test_uneven_recovery_keeps_every_survivor_bitwise(tmp_path_factory):
    ranks = _elastic("uneven", tmp_path_factory)
    assert ranks[3]["left"]
    for out in ranks[:3]:
        assert not out["left"] and out["dp"] == 3 and list(out["world_ranks"]) == [0, 1, 2]
        got, want = _split(out, "got:"), _split(out, "want:")
        assert len(got) == len(want) > 3
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
