"""The port's ABI core: negotiation, generated entry points, nonblocking
requests on real async collectives, the request pool, persistent plans and
plan groups — at a world of one in this process (gloo) and at a world of
two in spawned processes, against the reference's semantics.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro_torch.core as C
from repro_torch.core import errors as E
from repro_torch.core.backends import _dist
from repro_torch.runtime.dist import make_dist

import _torch_ranks


@pytest.fixture(scope="module")
def tdist():
    return make_dist(device="cpu")


def _x(n=8):
    return torch.arange(n, dtype=torch.float32)


def test_world_of_one_still_runs_a_real_process_group(tdist):
    info = tdist.abi.comms.info(tdist.dp_comm)
    assert info.group is not None and info.ranks == (0,)
    assert tdist.abi.comm_size(tdist.dp_comm) == 1
    assert tdist.abi.comm_rank(tdist.dp_comm) == 0
    assert tdist.abi.comms.info(C.PAX_COMM_SELF).group is None


def test_nonblocking_start_holds_a_pending_collective(tdist):
    abi, comm = tdist.abi, tdist.dp_comm
    req = abi.iallreduce(_x(), C.PAX_SUM, comm)
    assert isinstance(req, C.Request) and not req.done
    assert isinstance(req.value, _dist.Pending) and req.value.work is not None
    np.testing.assert_array_equal(abi.wait(req).numpy(), _x().numpy())
    # use-after-wait is detected by the generation check
    with pytest.raises(C.PaxError, match="stale"):
        abi.wait(C.Request(req.handle))


def test_request_pool_recycles_slots_with_new_generations(tdist):
    abi, comm = tdist.abi, tdist.dp_comm
    r1 = abi.iallgather(_x(), comm)
    h1 = r1.handle
    abi.wait(r1)
    r2 = abi.iallgather(_x(), comm)
    assert r2.handle & 0xFFFFFF == h1 & 0xFFFFFF          # same slot
    assert r2.handle >> 31 == (h1 >> 31) + 1               # next generation
    assert C.handle_kind(r2.handle & ((1 << 31) - 1)) == C.HandleKind.REQUEST
    assert abi.testall([r2])[0]
    assert abi.outstanding_requests == 0


def test_generated_entry_points_check_handles_like_the_reference(tdist):
    abi = tdist.abi
    with pytest.raises(C.PaxError, match="expected OP handle") as e:
        abi.allreduce(_x(), tdist.dp_comm, C.PAX_SUM)  # swapped handles
    with pytest.raises(R.PaxError) as e_ref:
        R.pax_init(None).allreduce(jnp.zeros(2), R.PAX_COMM_SELF, R.PAX_SUM)
    assert e.value.code == e_ref.value.code == E.PAX_ERR_ARG
    assert abi.allreduce.__generated_src__.startswith("def allreduce(x, op, comm")


def test_persistent_plan_restarts_one_slot_and_is_layout_cached(tdist):
    abi, comm = tdist.abi, tdist.dp_comm
    p = abi.reduce_scatter_init(_x(), C.PAX_SUM, comm)
    assert abi.reduce_scatter_init(C.TensorSpec((8,), torch.float32), C.PAX_SUM, comm) is p
    h = p.request.handle
    for k in (1.0, 2.0):
        req = p.start(k * _x())
        with pytest.raises(C.PaxError, match="already active"):
            p.start(_x())
        np.testing.assert_array_equal(p.wait().numpy(), (k * _x()).numpy())
    assert p.request.handle == h
    with pytest.raises(C.PaxError):
        p.start(_x())
        p.free()                      # active: refused
    p.wait()
    p.free()
    with pytest.raises(C.PaxError, match="freed"):
        p.start(_x())
    assert req.done and not abi._request_is_live(h)   # the slot moved on


def test_plan_group_fuses_members_and_keeps_member_order(tdist):
    abi, comm = tdist.abi, tdist.dp_comm
    rs = [abi.reduce_scatter_init(_x(), C.PAX_SUM, comm) for _ in range(3)]
    g = abi.plan_group(rs, name="rs3")
    outs = abi.wait(g.start([_x(), 2 * _x(), 3 * _x()]))
    for k, o in enumerate(outs, 1):
        np.testing.assert_array_equal(o.numpy(), (k * _x()).numpy())
    mixed = abi.plan_group([abi.allreduce_init(_x(), C.PAX_MAX, comm),
                            abi.allgather_init(_x(2), comm),
                            abi.allreduce_init(_x(), C.PAX_MAX, comm)])
    a, b, c = abi.wait(mixed.start([_x(), _x(2), 5 * _x()]))
    assert b.shape == (2,) and torch.equal(c, 5 * _x()) and torch.equal(a, _x())
    with pytest.raises(C.PaxError, match="payloads"):
        g.start([_x()])
    g.free()
    with pytest.raises(C.PaxError, match="freed"):
        g.start([_x()] * 3)


def test_tools_see_the_reference_byte_accounting(tdist, mesh1):
    """ByteCounter/CallCounter record the same bytes and calls for the same
    payload shapes in both packages, per call and per plan group (on
    PAX_COMM_SELF: the reference runs real axes only inside shard_map)."""
    t_bytes, t_calls = C.ByteCounter(), C.CallCounter()
    r_bytes, r_calls = R.ByteCounter(), R.CallCounter()
    tabi = C.pax_init(tdist.mesh, tools=[t_bytes, t_calls])
    rabi = R.pax_init(mesh1, tools=[r_bytes, r_calls])
    tcomm, rcomm = C.PAX_COMM_SELF, R.PAX_COMM_SELF
    x, xr = torch.zeros(6), jnp.zeros(6)
    tabi.allreduce(x, C.PAX_SUM, tcomm, datatype=C.PAX_FLOAT64)
    rabi.allreduce(xr, R.PAX_SUM, rcomm, datatype=R.PAX_FLOAT64)
    tabi.wait(tabi.ibcast(x, 0, tcomm))
    rabi.wait(rabi.ibcast(xr, 0, rcomm))
    tg = tabi.plan_group([tabi.allgather_init(x, tcomm)] * 2, name="g")
    rg = rabi.plan_group([rabi.allgather_init(xr, rcomm)] * 2, name="g")
    tabi.wait(tg.start([x, x]))
    rabi.wait(rg.start([xr, xr]))
    assert dict(t_bytes.bytes) == dict(r_bytes.bytes)
    assert dict(t_calls.counts) == dict(r_calls.counts)
    tabi.detach_tool(t_bytes)
    assert "_tools" in tabi.allreduce.__globals__


def test_comm_registration_and_errors(tdist):
    abi = tdist.abi
    dup = abi.comm_dup(tdist.dp_comm)
    assert abi.comms.info(dup).group is abi.comms.info(tdist.dp_comm).group
    abi.comm_free(dup)
    with pytest.raises(C.PaxError) as e:
        abi.allreduce(_x(), C.PAX_SUM, dup)
    assert e.value.code == E.PAX_ERR_COMM
    with pytest.raises(C.PaxError):
        abi.comm_from_axes(("pod",))
    with pytest.raises(C.PaxError):
        abi.comm_free(C.PAX_COMM_WORLD)


def test_entry_points_refuse_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.models import build_model
    from repro_torch.configs import smoke_config

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_dist()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(smoke_config("qwen2-0.5b")).init(0)


def test_compression_waits_for_the_ring_backend():
    with pytest.raises(C.PaxError) as e:
        make_dist(device="cpu", compression="bf16")
    assert e.value.code == E.PAX_ERR_UNSUPPORTED_OPERATION


# ---------------------------------------------------------------------------
# a world of two: real collective semantics, rank by rank
# ---------------------------------------------------------------------------
WORLD = 2


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _torch_ranks.run_ranks(_torch_ranks.collectives_rank, WORLD,
                                  tmp_path_factory.mktemp("abi2"), timeout=120)


def _inputs():
    return [np.arange(4 * WORLD, dtype=np.float32) + 100 * r for r in range(WORLD)]


def _expected(r):
    xs = _inputs()
    S, x = WORLD, xs[r]
    n = x.shape[0]
    total = sum(xs)
    c = n // S
    ax1 = [v.reshape(2, -1) for v in xs]
    c1 = ax1[0].shape[1] // S
    return {
        "rank": r, "size": S,
        "allreduce_sum": total,
        "allreduce_max": np.maximum.reduce(xs),
        "allreduce_prod": np.prod([v[:3] + 1 for v in xs], axis=0),
        "reduce_scatter": total[r * c:(r + 1) * c],
        "reduce_scatter_ax1": sum(ax1)[:, r * c1:(r + 1) * c1],
        "allgather": np.concatenate([v[:3] for v in xs]),
        "allgather_ax1": np.concatenate(ax1, axis=1),
        "bcast": xs[S - 1],
        # chunk r of every source along axis 0, joined along axis 1
        "alltoall": np.concatenate([v.reshape(S, -1)[r:r + 1] for v in xs], axis=1),
        "scan": sum(xs[:r + 1]),
        "exscan": x if r == 0 else sum(xs[:r]),
        "sendrecv": xs[(r - 1) % S],
        "scatter": xs[0][r * c:(r + 1) * c],
        "alltoallv": np.concatenate([v[r * 4:(r + 1) * 4] for v in xs]),
        "i_allreduce": total,
        "i_allgather": np.concatenate(xs),
        "i_reduce_scatter": total[r * c:(r + 1) * c],
        "plan_allreduce": total,
        "plan_allreduce_again": 2 * total,
        "group_rs_0": total[r * c:(r + 1) * c],
        "group_rs_1": 3 * total[r * c:(r + 1) * c],
        "group_ag_0": np.concatenate([v[:2] for v in xs]),
        "group_ag_1": np.concatenate([v[2:4] for v in xs]),
        "mixed_max": np.maximum.reduce(xs),
        "mixed_ag": np.concatenate([v[:2] for v in xs]),
    }


@pytest.mark.parametrize("key", sorted(_expected(0)))
def test_two_rank_collective_semantics(two_ranks, key):
    for r, got in enumerate(two_ranks):
        np.testing.assert_array_equal(got[key], _expected(r)[key], err_msg=f"rank {r}")


def test_two_rank_alltoall_matches_the_reference_convention():
    """The reference's tiled all_to_all (split axis 0, concat axis 1) at two
    devices, simulated by its documented chunk rule, gives what the port's
    rank program expects — the convention is one definition."""
    xs = _inputs()
    for r in range(WORLD):
        blocks = [v.reshape(WORLD, -1)[r] for v in xs]
        want = np.concatenate([b[None] for b in blocks], axis=1)
        np.testing.assert_array_equal(want, _expected(r)["alltoall"])
