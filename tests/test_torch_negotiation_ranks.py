"""Negotiation breadth across ranks: gloo twins of the multidev battery's
sections 5, 8 and 11, one process per rank (``file://`` rendezvous).

* section 5 (world 2): ``alltoallw`` through Mukautuva with per-peer
  receive types (and the request map across ranks), and a user op through
  the callback trampoline on ``ompix``;
* section 8 (world 2): the ZeRO-1 round trip on ``minimal`` (pooled and on
  the persistent plans; on ``ompix`` too, through the generated plan-group
  wrappers, section 10's Mukautuva leg), and the emulation chains of depth
  1-3 and every other recipe, blocking, nonblocking and persistent, against
  numpy oracles (and bitwise against ``paxi`` on the same inputs);
* section 11 (world 4 as a 2x2 mesh): ``alltoallv`` over the world
  communicator equals the transpose oracle on ``paxi``, ``ring``,
  ``minimal`` and ``ompix``; and section 1 on the same world: every
  registered backend's collectives against numpy oracles.

Oracles: sums of two float32 rows are exact here (small integers), so the
comparisons are exact except the product, held at 1e-6 relative.
"""
import numpy as np
import pytest

import _torch_negotiation_ranks as NR
import _torch_ranks

XG = NR.XG
_RUNS: dict = {}


def _world(n, tmp_path_factory):
    if n not in _RUNS:
        target = {2: NR.world2_rank, 4: NR.world4_rank}[n]
        _RUNS[n] = _torch_ranks.run_ranks(target, n, tmp_path_factory.mktemp(f"w{n}"))
    return _RUNS[n]


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    return _world(2, tmp_path_factory)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    return _world(4, tmp_path_factory)


# -- section 5: Mukautuva across ranks ---------------------------------------
def test_alltoallw_casts_each_peer_block_to_its_receive_type(w2):
    for r, got in enumerate(w2):
        assert list(got["a2aw_dtypes"]) == ["torch.float64", "torch.float32"]
        for j in range(2):  # block r of peer j
            np.testing.assert_array_equal(got[f"a2aw_{j}"], XG[j][4 * r:4 * r + 4])


def test_alltoallw_request_keeps_converted_vectors_until_wait(w2):
    for got in w2:
        assert got["a2aw_temps_held"] and got["a2aw_temps_dropped"]


def test_user_op_reduces_through_the_foreign_library(w2):
    for got in w2:
        np.testing.assert_array_equal(got["userop_sum"], XG[0] + XG[1])
        assert got["userop_calls"] == 1  # one fold step at two ranks
        np.testing.assert_array_equal(got["userop_max"], np.maximum(XG[0], XG[1]))


# -- section 8: the minimal backend ------------------------------------------
def test_minimal_negotiates_the_deepest_chain(w2):
    for got in w2:
        assert list(got["caps"]) == ["emulated", "emulated", "native", "emulated"]
        assert tuple(got["scatter_deps"]) == ("bcast", "comm_rank", "comm_size")
        assert got["unavailable"] == 0


@pytest.mark.parametrize("impl", ("minimal", "ompix"))
@pytest.mark.parametrize("mode", ("pooled", "plans"))
def test_zero1_round_trip(w2, mode, impl):
    """minimal: native rs/ag under paxi's group hooks; ompix: the
    generated Mukautuva plan-group wrappers (battery section 10's
    Mukautuva leg)."""
    vin = np.arange(2 * NR.NV, dtype=np.float32)
    want = (vin[:NR.NV] + vin[NR.NV:]) / 2.0 * 2.0
    key = f"zero1_{mode}" if impl == "minimal" else f"zero1_ompix_{mode}"
    for got in w2:
        np.testing.assert_allclose(got[key], want, rtol=1e-6)
        assert got["zero1_outstanding"] == 0
        assert list(got["zero1_ompix_caps"]) == ["backend-hook", "backend-hook"]


def _oracles(r):
    scan = np.cumsum(XG[:2], axis=0)
    return {
        "ar": XG[0] + XG[1], "bcast": XG[1], "scatter": XG[1][4 * r:4 * r + 4],
        "reduce": XG[0] + XG[1],
        "a2a": np.concatenate([XG[0][4 * r:4 * r + 4], XG[1][4 * r:4 * r + 4]]),
        "scan": scan[r], "exscan": XG[0] if r == 0 else scan[0],
        "gather": np.concatenate([XG[0][:3], XG[1][:3]]),
        "a2av": np.concatenate([XG[0][4 * r:4 * r + 4], XG[1][4 * r:4 * r + 4]]),
        "i_ar": XG[0] + XG[1], "i_bcast": XG[0],
        "plan_ar": (XG[0] + XG[1])[:NR.N_PAD], "plan_ar_again": 2 * (XG[0] + XG[1])[:NR.N_PAD],
        "plan_bcast": XG[1], "plan_scan": scan[r], "plan_exscan": XG[0] if r == 0 else scan[0],
        "plan_gather": np.concatenate([XG[0][:3], XG[1][:3]]),
        "plan_reduce": XG[0] + XG[1],
        "group_reduce_0": XG[0] + XG[1], "group_reduce_1": 3 * (XG[0] + XG[1]),
        "group_ar": np.stack([k * (XG[0] + XG[1])[:NR.N_PAD] for k in (1, 2, 3)]),
    }


@pytest.mark.parametrize("name", list(_oracles(0)))
def test_emulated_recipe_matches_its_numpy_oracle(w2, name):
    for r, got in enumerate(w2):
        np.testing.assert_array_equal(got[name].reshape(-1), _oracles(r)[name].reshape(-1),
                                      err_msg=f"rank {r}")


def test_emulated_recipes_equal_the_native_backend_bitwise(w2):
    for got in w2:
        for name in ("ar", "scan", "exscan", "a2a", "a2a_ax", "scatter"):
            np.testing.assert_array_equal(got[name], got[f"paxi_{name}"], err_msg=name)
        np.testing.assert_allclose(got["ar_prod"], got["paxi_ar_prod"], rtol=1e-6)
        np.testing.assert_allclose(got["ar_prod"], XG[0][:3] / 8 * (XG[1][:3] / 8), rtol=1e-6)
        assert got["plan_barrier"] and got["outstanding"] == 0


# -- section 11: alltoallv over the world communicator -----------------------
@pytest.mark.parametrize("impl", NR.A2AV_IMPLS)
def test_world_alltoallv_is_the_transpose(w4, impl):
    X1 = XG[:4, :4]
    X2 = np.arange(32, dtype=np.float32).reshape(4, 8)
    for r, got in enumerate(w4):
        np.testing.assert_array_equal(got[f"{impl}:c1"], X1.T[r], err_msg=impl)
        np.testing.assert_array_equal(got[f"{impl}:c2"], X2[:, 2 * r:2 * r + 2].reshape(-1),
                                      err_msg=impl)
    want = "emulated" if impl == "minimal" else "native"
    assert all(str(got[f"{impl}:source"]) == want for got in w4)


# -- section 1: every backend against numpy oracles (world 4, 2x2 mesh) ------
def _section1_oracles(r):
    X = XG[:4]
    d, m = divmod(r, 2)
    scan = np.cumsum(X, axis=0)
    a2a = np.concatenate([X[2 * d + j][4 * m:4 * m + 4] for j in range(2)])
    return {"sum": X.sum(0), "max": X.max(0), "min": X.min(0), "prod": (X / 8).prod(0),
            "ag_dp": np.concatenate([X[m], X[2 + m]]), "rs": X.sum(0)[2 * r:2 * r + 2],
            "scan": scan[r], "exscan": X[0] if r == 0 else scan[r - 1],
            "a2av_mp": a2a, "a2a_mp": a2a}


@pytest.mark.parametrize("impl", ("paxi", "ring", "ring-bf16", "ring-int8", "minimal",
                                  "ompix", "muk:paxi"))
def test_every_backend_matches_the_numpy_oracles(w4, impl):
    """The battery's section 1 at four ranks: the compressed rings within
    its bounds (int8 3%, bf16 1%), the rest exact but for the product."""
    tol = 0.03 if "int8" in impl else (0.01 if "bf16" in impl else 0)
    for r, got in enumerate(w4):
        for name, want in _section1_oracles(r).items():
            rtol = 1e-5 if name == "prod" else (tol if name in ("sum", "rs", "scan", "exscan")
                                                else 0)
            np.testing.assert_allclose(got[f"{impl}:{name}"], want, rtol=rtol,
                                       err_msg=f"{impl} {name} rank {r}")
