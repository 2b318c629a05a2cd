"""The port's transport tier against the reference, on the CPU: the twin of
``tests/test_transport_integrity.py`` plus the training half of the
multidev battery's section 18 on a gloo world of two.

* the checksums (``_bits_checksum``, ``_value_checksum``) equal the
  reference's on the same payloads; the poison fill and ``verify_clean``;
* the conserved rule catches a corrupted reduce-scatter in a world of one
  and the retry is bitwise the clean run; with integrity off the corrupted
  value flows through, as in the reference;
* wait timeouts: a dropped plan's wait raises ``PAX_ERR_TIMEOUT`` after the
  deadline and leaves the request active until ``reset``; the pooled wait
  and waitall time out too; only a loss-capable backend's waits carry the
  sentinel guard;
* the off path: with integrity off a plan runs the closure a context
  without the tier compiles, and one ZeRO-1 step issues the same
  ``torch.distributed`` collectives as the parent tree's step (four at two
  buckets); integrity on adds its checks;
* ``RetryPolicy`` ordering, exhaustion and escalation, and checkpoint
  content integrity, as in the reference;
* dp=2, integrity on, ``faulty:paxi``/``minimal``/``ompix``: a one-shot
  corruption on each collective call of one ZeRO-1 step is detected and
  retried in place, and the run equals the unfailed run bitwise.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import abi as r_abi
from repro.runtime import fault as r_fault

import repro_torch.core as C
from repro_torch.checkpoint import CheckpointCorrupt, Checkpointer
from repro_torch.core import abi as t_abi
from repro_torch.core.backends.faulty import FaultSchedule, FaultyBackend, fault_schedule_of
from repro_torch.core.errors import (PAX_ERR_DATA_CORRUPTION, PAX_ERR_PROC_FAILED,
                                     PAX_ERR_REQUEST, PAX_ERR_TIMEOUT, IncompleteValue,
                                     PaxError, error_string)
from repro_torch.runtime.dist import make_dist
from repro_torch.runtime.fault import TRANSPORT_ERRORS, RetryPolicy, escalate_to_failure

import _torch_fault_ranks as FR
import _torch_ranks


@pytest.fixture(scope="module")
def world():
    with make_dist(device="cpu") as d:
        yield d


def _faulty(world, integrity=None, impl="paxi"):
    sched = FaultSchedule()
    abi = C.pax_init(world.mesh, impl=FaultyBackend(C.get_backend(impl, world.mesh), sched),
                     integrity=integrity)
    return sched, abi


# ---------------------------------------------------------------------------
# checksums, poison, verify
# ---------------------------------------------------------------------------
_RNG = np.random.default_rng(0)
PAYLOADS = {
    "f32": _RNG.standard_normal(1001).astype(np.float32),
    "f32_neg_zero_nan": np.array([0.0, -0.0, np.nan, -np.inf, 3.5], np.float32),
    "i32": _RNG.integers(-2 ** 31, 2 ** 31 - 1, 777, dtype=np.int64).astype(np.int32),
    "i8": _RNG.integers(-128, 127, 300).astype(np.int8),
    "u8": _RNG.integers(0, 255, 300).astype(np.uint8),
    "bool": _RNG.integers(0, 2, 50).astype(bool),
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_bits_checksum_equals_the_reference(name):
    a = PAYLOADS[name]
    want = float(r_abi._bits_checksum(jnp.asarray(a)))
    assert float(t_abi._bits_checksum(torch.from_numpy(a.copy()))) == want


def test_bits_checksum_of_bf16_and_member_lists_equals_the_reference():
    a = _RNG.standard_normal(513).astype(np.float32)
    ref = r_abi._bits_checksum([jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(a)])
    got = t_abi._bits_checksum([torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(a)])
    assert float(got) == float(ref)
    flipped = torch.from_numpy(a).neg()
    assert float(t_abi._bits_checksum(flipped)) != float(
        t_abi._bits_checksum(torch.from_numpy(a)))


def test_value_checksum_equals_the_reference():
    a = (np.arange(64, dtype=np.float32) - 20.0) / 8
    assert float(t_abi._value_checksum([torch.from_numpy(a), torch.from_numpy(a[:5])])) == \
        float(r_abi._value_checksum([jnp.asarray(a), jnp.asarray(a[:5])]))


def test_poison_fill_and_pass_through():
    f = torch.tensor([1.0, -0.0, 2.5])
    i = torch.tensor([3, -4], dtype=torch.int32)
    b = torch.tensor([True, False])
    clean = t_abi._poison_where(torch.tensor(False), [f, i, b])
    assert torch.equal(clean[0].view(torch.int32), f.view(torch.int32))  # bitwise, -0 kept
    assert torch.equal(clean[1], i) and torch.equal(clean[2], b)
    bad = t_abi._poison_where(torch.tensor(True), [f, i, b])
    assert torch.isnan(bad[0]).all()
    assert (bad[1] == torch.iinfo(torch.int32).min).all() and torch.equal(bad[2], b)


def test_verify_clean_raises_on_the_poison_fill_only(world):
    abi = C.pax_init(world.mesh, impl="paxi", integrity=True)
    abi.verify_clean((torch.tensor([1.0, float("nan")]), np.array([1, 2])))
    for poisoned in (torch.full((3,), float("nan")),
                     np.full(2, np.iinfo(np.int32).min, np.int32),
                     [torch.ones(2), torch.tensor(float("nan"))]):
        with pytest.raises(PaxError) as ei:
            abi.verify_clean(poisoned, "unit")
        assert ei.value.code == PAX_ERR_DATA_CORRUPTION
    C.pax_init(world.mesh, impl="paxi", integrity=False).verify_clean(
        torch.full((3,), float("nan")))


def test_integrity_flag_from_the_environment(world, monkeypatch):
    monkeypatch.setenv("PAX_WIRE_INTEGRITY", "1")
    assert C.pax_init(world.mesh, impl="paxi").integrity
    monkeypatch.setenv("PAX_WIRE_INTEGRITY", "")
    assert not C.pax_init(world.mesh, impl="paxi").integrity


def test_error_strings_for_transport_codes():
    assert error_string(PAX_ERR_DATA_CORRUPTION) == "PAX_ERR_DATA_CORRUPTION"
    assert error_string(PAX_ERR_TIMEOUT) == "PAX_ERR_TIMEOUT"
    assert TRANSPORT_ERRORS == r_fault.TRANSPORT_ERRORS == (
        PAX_ERR_DATA_CORRUPTION, PAX_ERR_TIMEOUT)


# ---------------------------------------------------------------------------
# detection in a world of one (the conserved rule)
# ---------------------------------------------------------------------------
def test_conserved_rule_detects_corruption_and_retry_is_clean(world):
    sched, abi = _faulty(world, integrity=True)
    comm = abi.comm_from_axes(("data",), "dp")
    x = torch.arange(8, dtype=torch.float32) + 1.0
    plan = abi.reduce_scatter_init(x, C.PAX_SUM, comm)
    clean = abi.wait(plan.start(x))
    abi.verify_clean(clean, "clean reduce_scatter")
    sched.arm(0, after=0, mode="corrupt")
    bad = abi.wait(plan.start(x))
    with pytest.raises(PaxError) as ei:
        abi.verify_clean(bad, "corrupted reduce_scatter")
    assert ei.value.code == PAX_ERR_DATA_CORRUPTION and sched.corrupted
    again = abi.wait(plan.start(x))
    abi.verify_clean(again, "retried reduce_scatter")
    assert torch.equal(again, clean)


def test_integrity_off_lets_corruption_through(world):
    sched, abi = _faulty(world, integrity=False)
    comm = abi.comm_from_axes(("data",), "dp")
    x = torch.arange(8, dtype=torch.float32) + 1.0
    plan = abi.reduce_scatter_init(x, C.PAX_SUM, comm)
    sched.arm(0, after=0, mode="corrupt")
    silent = abi.wait(plan.start(x))
    abi.verify_clean(silent, "off")
    assert torch.equal(silent, -x)  # sign-flipped, as the reference's


# ---------------------------------------------------------------------------
# drop -> wait timeout -> reset
# ---------------------------------------------------------------------------
def test_plan_wait_timeout_exactness_and_reset(world):
    sched, abi = _faulty(world)
    comm = abi.comm_from_axes(("data",), "dp")
    x = torch.ones(4)
    plan = abi.allreduce_init(x, C.PAX_SUM, comm)
    assert torch.equal(abi.wait(plan.start(x), timeout_s=0.15), x)
    sched.arm(0, after=0, mode="drop")
    t0 = time.perf_counter()
    with pytest.raises(PaxError) as ei:
        abi.wait(plan.start(x), timeout_s=0.15)
    dt = time.perf_counter() - t0
    assert ei.value.code == PAX_ERR_TIMEOUT and 0.15 <= dt < 1.5
    with pytest.raises(PaxError) as ei2:  # still active: a restart is refused
        plan.start(x)
    assert ei2.value.code == PAX_ERR_REQUEST
    with pytest.raises(PaxError) as ei3:
        plan.wait(timeout_s=0.01)
    assert ei3.value.code == PAX_ERR_TIMEOUT
    plan.reset()
    sched.kill_rank, sched.dropping = -1, False  # the link healed
    assert torch.equal(abi.wait(plan.start(x), timeout_s=0.15), x)


def test_group_wait_timeout_and_reset_rearm(world):
    sched, abi = _faulty(world)
    comm = abi.comm_from_axes(("data",), "dp")
    x = torch.arange(4, dtype=torch.float32)
    group = abi.plan_group([abi.reduce_scatter_init(x, C.PAX_SUM, comm) for _ in range(2)],
                           "rs")
    want = abi.wait(group.start([x, x]))
    sched.arm(0, after=0, mode="drop")
    t0 = time.perf_counter()
    group.start([x, x])
    with pytest.raises(PaxError) as ei:
        group.wait(timeout_s=0.2)
    assert ei.value.code == PAX_ERR_TIMEOUT and time.perf_counter() - t0 >= 0.2
    assert not group.request.done
    group.reset()
    sched.kill_rank, sched.dropping = -1, False
    got = abi.wait(group.start([x, x]))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pooled_wait_and_waitall_timeout(world):
    sched, abi = _faulty(world)
    comm = abi.comm_from_axes(("data",), "dp")
    x = torch.ones(4)
    assert torch.equal(abi.wait(abi.iallreduce(x, C.PAX_SUM, comm), timeout_s=0.02), x)
    sched.arm(0, after=0, mode="drop")
    with pytest.raises(PaxError) as ei:
        abi.wait(abi.iallreduce(x, C.PAX_SUM, comm), timeout_s=0.02)
    assert ei.value.code == PAX_ERR_TIMEOUT
    with pytest.raises(PaxError) as ei2:
        abi.waitall([abi.iallreduce(x, C.PAX_SUM, comm)], timeout_s=0.02)
    assert ei2.value.code == PAX_ERR_TIMEOUT


def test_drop_guard_compiled_only_for_loss_capable_backends(world):
    x = torch.zeros(4)
    plain = C.pax_init(world.mesh, impl="paxi")
    assert not plain._can_drop
    p = plain.allreduce_init(x, C.PAX_SUM, C.PAX_COMM_SELF)
    assert not any(d is t_abi._first_incomplete for d in p.wait.__defaults__)
    _, faulty = _faulty(world)
    assert faulty._can_drop
    f = faulty.allreduce_init(x, C.PAX_SUM, C.PAX_COMM_SELF)
    assert any(d is t_abi._first_incomplete for d in f.wait.__defaults__)
    gp = plain.plan_group([plain.allreduce_init(x, C.PAX_SUM, C.PAX_COMM_SELF)])
    gf = faulty.plan_group([faulty.allreduce_init(x, C.PAX_SUM, C.PAX_COMM_SELF)])
    assert len(gp.wait.__defaults__) < len(gf.wait.__defaults__)
    assert C.get_backend("faulty:ompix", world.mesh).can_lose_messages


def test_incomplete_value_sentinel_passes_through_recipes(world):
    sched, abi = _faulty(world, impl="minimal")
    dp = abi.comm_from_axes(("data",), "dp")
    iv = IncompleteValue("dropped upstream")
    for name, args in (("scatter", (iv, 0, dp)), ("alltoall", (iv, dp)),
                       ("gather", (iv, 0, dp))):
        assert abi._ensure_built(name)(*args) is iv
    assert "dropped upstream" in repr(iv)


# ---------------------------------------------------------------------------
# the off path: the parent's closures and collectives
# ---------------------------------------------------------------------------
def test_integrity_off_plans_run_the_backend_hook_closure(world):
    x = torch.zeros(8)
    for integrity in (None, False):
        abi = C.pax_init(world.mesh, impl="paxi", integrity=integrity)
        comm = abi.comm_from_axes(("data",), "dp")
        plan = abi.reduce_scatter_init(x, C.PAX_SUM, comm)
        run = plan.start.__defaults__[1]
        assert "plan_reduce_scatter" in run.__qualname__
        assert abi._table["allreduce"].__func__ is type(abi.backend).allreduce
    on = C.pax_init(world.mesh, impl="paxi", integrity=True)
    comm = on.comm_from_axes(("data",), "dp")
    run = on.reduce_scatter_init(x, C.PAX_SUM, comm).start.__defaults__[1]
    assert "checked" in run.__qualname__


_COLLECTIVES = ("all_reduce", "broadcast", "barrier", "all_gather", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all_single", "batch_isend_irecv",
                "all_gather_single", "reduce_scatter_single")


def _count_collectives(world, integrity, monkeypatch):
    import torch.distributed as tdist

    from repro_torch.core.backends import _dist
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import train_loop as tl

    calls = []
    for name in _COLLECTIVES:
        fn = getattr(tdist, name, None)
        if fn is not None:
            monkeypatch.setattr(tdist, name, (lambda _f, _n: (lambda *a, **k: (
                calls.append(_n), _f(*a, **k))[1]))(fn, name))
    for attr in ("_reduce_scatter", "_all_gather"):
        fn = getattr(_dist, attr)
        monkeypatch.setattr(_dist, attr, (lambda _f, _n: (lambda *a, **k: (
            calls.append(_n), _f(*a, **k))[1]))(fn, attr))
    api = build_model(FR._cfg(zero1=True, buckets=2))
    with make_dist(mesh=world.mesh, impl="paxi", integrity=integrity) as d:
        state = tl.init_state(api, 0, d)
        step = tl.make_train_step(api, d, AdamWConfig())
        batch = {k: torch.from_numpy(v[:2]) for k, v in FR.batch_at(0).items()}
        del calls[:]
        step(state, batch)
        n = list(calls)
    monkeypatch.undo()
    return n


def test_one_zero1_step_issues_the_parents_collectives(world, monkeypatch):
    """Integrity off (the default): the reduce-scatter group, the grad-norm
    all-reduce, the all-gather group and the loss all-reduce — the four
    collectives the parent tree's step issues at two buckets; integrity on
    adds its checks and nothing else changes."""
    off = _count_collectives(world, None, monkeypatch)
    assert off == ["_reduce_scatter", "all_reduce", "_all_gather", "all_reduce"]
    on = _count_collectives(world, True, monkeypatch)
    assert len(on) > len(off)
    assert [c for c in on if c != "all_reduce"] == ["_reduce_scatter", "_all_gather"]


# ---------------------------------------------------------------------------
# RetryPolicy, escalation
# ---------------------------------------------------------------------------
def _policy_trace(mod, error, first_fails):
    events, n = [], {"calls": 0}

    def attempt():
        n["calls"] += 1
        events.append(f"attempt{n['calls']}")
        if n["calls"] <= first_fails:
            raise error(PAX_ERR_TIMEOUT, "transient drop")
        return "ok"

    pol = mod.RetryPolicy(max_retries=2, reset=lambda: events.append("reset"),
                          verify=lambda out: events.append("verify"))
    try:
        out = pol.run(attempt, what="unit")
    except Exception as e:
        out = type(e).__name__ + str(e.code)
    return events, out, pol.retries, pol.escalations


@pytest.mark.parametrize("first_fails", [0, 1, 2, 3])
def test_retry_policy_matches_the_reference(first_fails):
    from repro.core.errors import PaxError as RPaxError
    from repro_torch.runtime import fault as t_fault

    assert _policy_trace(t_fault, PaxError, first_fails) == _policy_trace(
        r_fault, RPaxError, first_fails)


def test_retry_policy_verify_failure_is_retried():
    n = {"calls": 0}

    def attempt():
        n["calls"] += 1
        return n["calls"]

    def verify(out):
        if out == 1:
            raise PaxError(PAX_ERR_DATA_CORRUPTION, "poisoned payload")

    pol = RetryPolicy(max_retries=2, verify=verify)
    assert pol.run(attempt) == 2 and pol.retries == 1


def test_retry_policy_exhaustion_escalates_then_raises():
    events, escalated = [], []

    def attempt():
        events.append("attempt")
        raise PaxError(PAX_ERR_DATA_CORRUPTION, "persistently bad wire")

    pol = RetryPolicy(max_retries=2, reset=lambda: events.append("reset"),
                      escalate=escalated.append)
    with pytest.raises(PaxError) as ei:
        pol.run(attempt, what="unit")
    assert ei.value.code == PAX_ERR_DATA_CORRUPTION
    assert events == ["attempt", "reset"] * 3 and escalated == [ei.value]
    assert pol.retries == 2 and pol.escalations == 1


def test_retry_policy_rank_death_is_not_a_flaky_link():
    def attempt():
        raise PaxError(PAX_ERR_PROC_FAILED, "a corpse, not a drop")

    pol = RetryPolicy(reset=lambda: pytest.fail("reset on non-retryable"))
    with pytest.raises(PaxError) as ei:
        pol.run(attempt)
    assert ei.value.code == PAX_ERR_PROC_FAILED and pol.retries == 0


class _Monitor:
    def __init__(self, confirm_after):
        self.ticks, self.confirm_after = 0, confirm_after

    def beat(self):
        self.ticks += 1
        return (3,) if self.ticks >= self.confirm_after else ()


def test_escalate_to_failure_confirms_then_raises_proc_failed():
    cause = PaxError(PAX_ERR_TIMEOUT, "dropped bcast")
    with pytest.raises(PaxError) as ei:
        escalate_to_failure(_Monitor(confirm_after=3))(cause)
    assert ei.value.code == PAX_ERR_PROC_FAILED and ei.value.__cause__ is cause
    assert escalate_to_failure(_Monitor(10 ** 9), max_ticks=4)(cause) is None


def test_fault_schedule_of_surfaces_shared_schedule(world):
    sched, abi = _faulty(world)
    assert fault_schedule_of(abi.backend) is sched


# ---------------------------------------------------------------------------
# checkpoint content integrity
# ---------------------------------------------------------------------------
def _state(v):
    return {"w": torch.full((4,), v), "step": torch.tensor(int(v), dtype=torch.int32)}


def _shard(d, step):
    return d / f"step_{step:010d}" / "shard_0.npz"


def test_checkpoint_bitflip_falls_back_loudly(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    for s in (2, 4, 6):
        ck.save(s, _state(float(s)))
    blob = bytearray(_shard(tmp_path, 6).read_bytes())
    blob[len(blob) // 2] ^= 0x40
    _shard(tmp_path, 6).write_bytes(bytes(blob))
    restored, step = ck.restore(_state(0.0))
    assert step == 4 and torch.equal(restored["w"], torch.full((4,), 4.0))
    [event] = ck.integrity_events
    assert event["step"] == 6 and event["fell_back_to"] == 4
    assert "CRC mismatch" in event["reason"]


def test_checkpoint_truncation_falls_back(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    for s in (1, 3):
        ck.save(s, _state(float(s)))
    blob = _shard(tmp_path, 3).read_bytes()
    _shard(tmp_path, 3).write_bytes(blob[: len(blob) // 2])
    _, step = ck.restore(_state(0.0))
    assert step == 1 and ck.integrity_events[0]["fell_back_to"] == 1


def test_checkpoint_all_corrupt_raises_never_restores_garbage(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    for s in (1, 2):
        ck.save(s, _state(float(s)))
        blob = bytearray(_shard(tmp_path, s).read_bytes())
        blob[4] ^= 0xFF
        _shard(tmp_path, s).write_bytes(bytes(blob))
    with pytest.raises(CheckpointCorrupt):
        ck.restore(_state(0.0))
    assert [e["step"] for e in ck.integrity_events] == [2, 1]
    assert all(e["fell_back_to"] is None for e in ck.integrity_events)


def test_checkpoint_missing_shard_is_a_reason(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    for s in (1, 2):
        ck.save(s, _state(float(s)))
    _shard(tmp_path, 2).unlink()
    _, step = ck.restore(_state(0.0))
    assert step == 1 and "missing shard" in ck.integrity_events[0]["reason"]


# ---------------------------------------------------------------------------
# dp=2: a corrupted collective of a ZeRO-1 step, retried bitwise
# ---------------------------------------------------------------------------
_CALLS = {"paxi": 6, "minimal": 8, "ompix": 6}
_SWEEP: list = []


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    if not _SWEEP:
        _SWEEP.extend(_torch_ranks.run_ranks(FR.corrupt_rank, 2,
                                             tmp_path_factory.mktemp("corrupt"), timeout=150))
    return _SWEEP


def test_calls_per_zero1_step(sweep):
    """paxi and ompix: 2 reduce-scatter members, the grad-norm all-reduce,
    2 all-gather members, the loss all-reduce; minimal composes each
    all-reduce from a reduce-scatter and an all-gather (2 calls)."""
    for out in sweep:
        assert {impl: int(out[f"{impl}:calls_per_step"]) for impl in _CALLS} == _CALLS


@pytest.mark.parametrize("impl,at", [(i, a) for i, n in _CALLS.items() for a in range(n)])
def test_corrupted_collective_is_retried_bitwise(sweep, impl, at):
    for out in sweep:
        tag = f"{impl}:{at}"
        assert out[f"{tag}:fired"] and out[f"{tag}:retries"] == 1
        assert out[f"{tag}:same_losses"] and out[f"{tag}:same_state"]
