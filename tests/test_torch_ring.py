"""The port's ring backends (``ring``, ``ring-bf16``, ``ring-int8``)
against the reference, in gloo worlds of two and three processes, and on
a (data, model) = (2, 2) grid of four, whose world communicator runs the
hierarchical multi-axis schedules on per-axis process groups.

Each rank runs :func:`_torch_ranks.ring_rank` (blocking, nonblocking,
persistent and plan-group forms over the data-parallel communicator); a
world of three is the only one with a middle hop, so only it reaches
``hop_add_quant``.  The oracles compose the reference's own pieces in the
reference's hop order (``repro/core/backends/ring.py``), for every rank:

* blocking and nonblocking calls, plans on chunks the hop kernels cannot
  carry, scans: the global-scale wire (``ring._quantize``/``_dequantize``);
* plans and plan groups on eligible chunks: the fused schedule composed of
  the ``repro.kernels.ring_wire.ref`` block oracles (quantize at the first
  send, dequantize-add-requantize at middle hops, dequantize-add at the
  last), a plan group's members stacked on a trailing axis first, so the
  int8 blocks and their scales span members;
* the ``allreduce`` recipe: padding (to the width, or to width x 128 for a
  plan on a compressed wire), reduce-scatter, all-gather, slice.

The port must equal these bitwise.  Against the exact sum the compressed
wires stay inside the battery's section 6 bounds (bf16 0.02, int8 0.05
relative), and negotiation reports what the reference reports.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
from repro.core.backends import ring as R_ring
from repro.core.compat import make_mesh
from repro.kernels.ring_wire import ref as R_wire
import repro_torch.core as T

import _torch_ranks
from _torch_ranks import N_AR, RING_IMPLS, ring_inputs

COMPRESS = {"ring": None, "ring-bf16": "bf16", "ring-int8": "int8"}
WORLDS = (2, 3)


# ---------------------------------------------------------------------------
# the reference's ring schedules, simulated rank by rank
# ---------------------------------------------------------------------------
def _chunk(x, idx, c):
    return x[idx * c:(idx + 1) * c]


def sim_rs(xs, compress):
    """``ring_reduce_scatter`` (global-scale wire) on every rank."""
    S = len(xs)
    c = xs[0].shape[0] // S
    xs = [jnp.asarray(x) for x in xs]
    travel = [_chunk(xs[i], (i - 1) % S, c) for i in range(S)]
    for t in range(S - 1):
        sent = [R_ring._quantize(tr, compress) for tr in travel]
        travel = [R_ring._dequantize(*sent[(i - 1) % S], jnp.float32, compress)
                  + _chunk(xs[i], (i - 2 - t) % S, c) for i in range(S)]
    return [np.asarray(t) for t in travel]


def _quant(x, compress):
    if compress == "bf16":
        return x.astype(jnp.bfloat16), None
    return R_wire.quant_i8_block(x)


def _hop_add(q, s, a, compress):
    if compress == "bf16":
        return (q.astype(jnp.float32) + a).astype(jnp.bfloat16), None
    return R_wire.hop_add_quant_i8_block(q, s, a)


def _hop_accum(q, s, a, compress):
    if compress == "bf16":
        return q.astype(jnp.float32) + a
    return R_wire.hop_accum_i8_block(q, s, a)


def sim_rs_fused(xs, compress):
    """``ring_reduce_scatter_fused`` on every rank, from the block oracles."""
    S = len(xs)
    c = xs[0].shape[0] // S
    xs = [jnp.asarray(x) for x in xs]
    wire = [_quant(_chunk(xs[i], (i - 1) % S, c), compress) for i in range(S)]
    for t in range(S - 1):
        recv = [wire[(i - 1) % S] for i in range(S)]
        local = [_chunk(xs[i], (i - 2 - t) % S, c) for i in range(S)]
        if t < S - 2:
            wire = [_hop_add(q, s, a, compress) for (q, s), a in zip(recv, local)]
        else:
            return [np.asarray(_hop_accum(q, s, a, compress)) for (q, s), a in zip(recv, local)]


def sim_ag(chunks):
    full = np.concatenate([np.asarray(c) for c in chunks])
    return [full] * len(chunks)


def sim_scan(xs, compress, inclusive):
    S = len(xs)
    xs = [jnp.asarray(x) for x in xs]
    acc = [x if inclusive or i == 0 else jnp.zeros_like(x) for i, x in enumerate(xs)]
    travel = list(xs)
    for t in range(S - 1):
        sent = [R_ring._quantize(tr, compress) for tr in travel]
        travel = [R_ring._dequantize(*sent[(i - 1) % S], jnp.float32, compress)
                  for i in range(S)]
        acc = [a + (tr if i >= t + 1 else jnp.zeros_like(tr))
               for i, (a, tr) in enumerate(zip(acc, travel))]
    return [np.asarray(a) for a in acc]


def _eligible(compress, chunk_elems):
    return compress is not None and chunk_elems % 128 == 0


def sim_plan_rs(xs, compress):
    S = len(xs)
    fused = _eligible(compress, xs[0].size // S)
    return sim_rs_fused(xs, compress) if fused else sim_rs(xs, compress)


def sim_allreduce(xs, compress, plan):
    """The ``allreduce`` recipe: blocking pads to the width, a plan to the
    width times the backend's wire granule."""
    S, n = len(xs), xs[0].shape[0]
    blk = 128 if (plan and compress is not None) else 1
    pad = (-n) % (S * blk)
    padded = [np.concatenate([x, np.zeros(pad, np.float32)]) for x in xs]
    mids = sim_plan_rs(padded, compress) if plan else sim_rs(padded, compress)
    return [o[:n] for o in sim_ag(mids)]


def sim_group_rs(members, compress):
    """Plan group: the members stacked on a trailing axis ride one wire."""
    S = len(members[0])
    stacked = [np.stack([m[i] for m in members], axis=1) for i in range(S)]
    outs = sim_plan_rs(stacked, compress)
    return [[o[:, j] for o in outs] for j in range(len(members))]


def sim_group_allreduce(members, compress):
    S, n = len(members[0]), members[0][0].shape[0]
    blk = 128 if compress is not None else 1
    pad = (-n) % (S * blk)
    padded = [[np.concatenate([x, np.zeros(pad, np.float32)]) for x in m] for m in members]
    mids = sim_group_rs(padded, compress)
    return [[o[:n] for o in sim_ag(mid)] for mid in mids]


_ORACLES: dict = {}


def oracles(world: int) -> dict:
    """Per impl, per key: the list of per-rank expected outputs."""
    if world in _ORACLES:
        return _ORACLES[world]
    inp = ring_inputs(world)
    xs = [inp[r]["x"] for r in range(world)]
    ys = [(np.float32(2.5) * x + np.float32(1.0)).astype(np.float32) for x in xs]
    S = world
    out = {}
    for impl in RING_IMPLS:
        c = COMPRESS[impl]
        e = {
            "rs": sim_rs(xs, c), "irs": sim_rs(xs, c),
            "ag": sim_ag([x[:5] for x in xs]),
            "scan": sim_scan(xs, c, True), "exscan": sim_scan(xs, c, False),
            "iscan": sim_scan(xs, c, True),
            "allreduce": sim_allreduce([x[:N_AR] for x in xs], c, plan=False),
            "iallreduce": sim_allreduce([x[:N_AR] for x in xs], c, plan=False),
            "plan_rs": sim_plan_rs(xs, c), "plan_rs_again": sim_plan_rs(ys, c),
            "plan_rs_small": sim_plan_rs([x[:10 * S] for x in xs], c),
            "plan_ag": sim_ag([x[:6] for x in xs]),
            "plan_allreduce": sim_allreduce([x[:N_AR] for x in xs], c, plan=True),
        }
        e["group_rs_0"], e["group_rs_1"] = sim_group_rs([xs, ys], c)
        e["group_ag_0"], e["group_ag_1"] = sim_ag([x[:6] for x in xs]), sim_ag([y[:6] for y in ys])
        e["group_ar_0"], e["group_ar_1"] = sim_group_allreduce(
            [[x[:N_AR] for x in xs], [y[:N_AR] for y in ys]], c)
        out[impl] = e
    _ORACLES[world] = out
    return out


KEYS = ("rs", "irs", "ag", "scan", "exscan", "iscan", "allreduce", "iallreduce",
        "plan_rs", "plan_rs_again", "plan_rs_small", "plan_ag", "plan_allreduce",
        "group_rs_0", "group_rs_1", "group_ag_0", "group_ag_1", "group_ar_0", "group_ar_1")


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ring_world(request, tmp_path_factory):
    world = request.param
    ranks = _torch_ranks.run_ranks(_torch_ranks.ring_rank, world,
                                   tmp_path_factory.mktemp(f"ring{world}"), timeout=180)
    return world, ranks


@pytest.mark.parametrize("impl", RING_IMPLS)
@pytest.mark.parametrize("key", KEYS)
def test_ring_equals_the_reference_hop_composition(ring_world, impl, key):
    world, ranks = ring_world
    want = oracles(world)[impl][key]
    for r, got in enumerate(ranks):
        g = got[f"{impl}:{key}"]
        assert g.dtype == np.float32, (key, g.dtype)
        np.testing.assert_array_equal(g, want[r], err_msg=f"{impl} {key} rank {r}")


BOUNDS = {"ring-bf16": 0.02, "ring-int8": 0.05}


@pytest.mark.parametrize("impl", sorted(BOUNDS))
@pytest.mark.parametrize("key", ["allreduce_pos", "plan_allreduce_pos", "scan_pos",
                                 "exscan_pos"])
def test_compressed_wire_within_the_battery_bounds(ring_world, impl, key):
    """Battery section 6: relative error against the exact f64 sum."""
    world, ranks = ring_world
    worst = 0.0
    for r, got in enumerate(ranks):
        rel = np.abs(got[f"{impl}:{key}"] - _exact(world, key, r)) / np.abs(_exact(world, key, r))
        assert rel.max() < BOUNDS[impl], (impl, key, r, rel.max())
        worst = max(worst, rel.max())
    assert worst > 0  # the wire is lossy, so the bound is not vacuous


def _exact(world, key, r):
    pos = [ring_inputs(world)[i]["pos"].astype(np.float64) for i in range(world)]
    if key.endswith("allreduce_pos"):
        return sum(p[:N_AR] for p in pos)
    if key == "scan_pos":
        return sum(pos[:r + 1])
    return pos[0] if r == 0 else sum(pos[:r])


def test_per_block_int8_wire_is_no_worse_than_the_global_scale(ring_world):
    """Battery section 12: on the same data, the hop kernels' per-128-block
    scales (a plan) err no more than the global scale (a blocking call)."""
    world, ranks = ring_world
    xs = [ring_inputs(world)[r]["x"].astype(np.float64) for r in range(world)]
    c = xs[0].shape[0] // world
    for r, got in enumerate(ranks):
        exact = sum(xs)[r * c:(r + 1) * c]
        block = np.abs(got["ring-int8:plan_rs"] - exact).max()
        whole = np.abs(got["ring-int8:rs"] - exact).max()
        assert 0 < block <= whole, (r, block, whole)


@pytest.mark.parametrize("key", ["allreduce_pos", "plan_allreduce_pos", "scan_pos",
                                 "exscan_pos"])
def test_uncompressed_ring_is_f32_exact(ring_world, key):
    """The plain ring only reassociates the f32 sum."""
    world, ranks = ring_world
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"ring:{key}"], _exact(world, key, r), rtol=1e-6)


@pytest.mark.parametrize("impl", RING_IMPLS)
def test_negotiation_on_the_ring(ring_world, impl):
    _, ranks = ring_world
    for got in ranks:
        assert str(got[f"{impl}:allreduce_source"]) == "emulated"
        assert str(got[f"{impl}:wire_kernel"]) == ("none" if impl == "ring" else "torch")


# ---------------------------------------------------------------------------
# negotiation against the reference (a context with no process group)
# ---------------------------------------------------------------------------
#: the reference names its wire variants by platform, the port by device
WIRE_NAME = {"lax": "none", "pallas": "torch"}


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("impl", RING_IMPLS)
def test_negotiated_capabilities_equal_the_reference(mesh1, impl):
    """Same table, same ring backend: every entry resolves the same way —
    ``allreduce`` composed from its recipe, the ring's plan and group
    hooks — and the ``wire_kernel`` tags map one to one."""
    ref = R.pax_init(mesh1, impl=impl).capabilities()
    port = T.pax_init(None, impl=impl).capabilities()
    keys = ("tier", "source", "plan", "plan_group", "native", "group_hook", "backend",
            "deps")
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert {k: port[name].get(k) for k in keys} == {k: ref[name].get(k) for k in keys}, name
        assert ("wire_kernel" in port[name]) == ("wire_kernel" in ref[name]), name
        if "wire_kernel" in ref[name]:
            assert port[name]["wire_kernel"] == WIRE_NAME[ref[name]["wire_kernel"]], name


def test_ring_of_one_is_the_identity_and_pads_to_the_wire_block():
    """World of one: every ring schedule returns its input (no hop, no hop
    kernel); the compressed context pads recipe plans to the wire block."""
    from repro_torch.kernels.ring_wire import ops as wire_ops
    from repro_torch.runtime.dist import make_dist

    d = make_dist(device="cpu", compression="int8")
    abi, comm = d.abi_compressed, d.dp_comm
    x = torch.arange(300, dtype=torch.float32)
    before = [k.launches for k in wire_ops.KERNELS]
    p = abi.allreduce_init(x, T.PAX_SUM, comm)
    for got in (abi.reduce_scatter(x, T.PAX_SUM, comm), abi.allreduce(x, T.PAX_SUM, comm),
                abi.wait(p.start(x)), abi.scan(x, T.PAX_SUM, comm)):
        assert torch.equal(got, x)
    assert [k.launches for k in wire_ops.KERNELS] == before
    built = abi._table["allreduce"]  # the recipe, built at first use
    assert built.__emulated__ and built.__emulated_deps__ == (
        "reduce_scatter", "allgather", "comm_size")
    assert abi.backend.wire_pad_multiple() == 128
    assert d.abi.backend.wire_pad_multiple() == 1
    p.free()


# ---------------------------------------------------------------------------
# a (data, model) = (2, 2) grid: the hierarchical multi-axis schedules
# ---------------------------------------------------------------------------
GRID_WORLD = 4


def _along(axis):
    """The rings of one grid axis, as lists of linear ranks (row-major)."""
    if axis == 0:
        return [[a * 2 + b for a in range(2)] for b in range(2)]
    return [[a * 2 + b for b in range(2)] for a in range(2)]


def _per_ring(vals, axis, f):
    out = [None] * GRID_WORLD
    for ring in _along(axis):
        for r, v in zip(ring, f([vals[r] for r in ring])):
            out[r] = v
    return out


def sim_allreduce_sum(xs, compress):
    """``ring_allreduce_sum``: broadcast-add hops, global-scale wire."""
    S = len(xs)
    acc = [jnp.asarray(x) for x in xs]
    travel = list(acc)
    for _ in range(S - 1):
        sent = [R_ring._quantize(tr, compress) for tr in travel]
        travel = [R_ring._dequantize(*sent[(i - 1) % S], jnp.float32, compress)
                  for i in range(S)]
        acc = [a + t for a, t in zip(acc, travel)]
    return [np.asarray(a) for a in acc]


def grid_oracles():
    if "grid" in _ORACLES:
        return _ORACLES["grid"]
    xs = [ring_inputs(GRID_WORLD)[r]["x"] for r in range(GRID_WORLD)]
    out = _ORACLES["grid"] = {}
    for impl in RING_IMPLS:
        c = COMPRESS[impl]

        def rs(vals, f):
            return _per_ring(_per_ring(vals, 0, f), 1, f)  # forward axis order

        row_total = _per_ring(xs, 1, lambda v: sim_allreduce_sum(v, c))
        major = _per_ring(row_total, 0, lambda v: sim_scan(v, c, True))
        major_excl = [m - t for m, t in zip(major, row_total)]
        inner = _per_ring(xs, 1, lambda v: sim_scan(v, c, True))
        pad = (-N_AR) % GRID_WORLD
        padded = [np.concatenate([x[:N_AR], np.zeros(pad, np.float32)]) for x in xs]
        ar = _per_ring(_per_ring(rs(padded, lambda v: sim_rs(v, c)), 1, sim_ag), 0, sim_ag)
        out[impl] = {
            "rs": rs(xs, lambda v: sim_rs(v, c)),
            "plan_rs": rs(xs, lambda v: sim_plan_rs(v, c)),
            "ag": _per_ring(_per_ring([x[:5] for x in xs], 1, sim_ag), 0, sim_ag),
            "scan": [np.asarray(i + m) for i, m in zip(inner, major_excl)],
            "exscan": [xs[0]] + [np.asarray(i - x + m) for i, x, m in
                                 zip(inner[1:], xs[1:], major_excl[1:])],
            "allreduce": [a[:N_AR] for a in ar],
        }
    return out


@pytest.fixture(scope="module")
def ring_grid(tmp_path_factory):
    return _torch_ranks.run_ranks(_torch_ranks.ring_grid_rank, GRID_WORLD,
                                  tmp_path_factory.mktemp("grid"), timeout=180)


@pytest.mark.parametrize("impl", RING_IMPLS)
@pytest.mark.parametrize("key", ["rs", "plan_rs", "ag", "scan", "exscan", "allreduce"])
def test_grid_ring_equals_the_hierarchical_reference_schedule(ring_grid, impl, key):
    want = grid_oracles()[impl][key]
    for r, got in enumerate(ring_grid):
        np.testing.assert_array_equal(got[f"{impl}:{key}"], want[r],
                                      err_msg=f"{impl} {key} rank {r}")


# ---------------------------------------------------------------------------
# the ZeRO-1 legs on a compressed ring: padded so that the plans run the hops
# ---------------------------------------------------------------------------
#: qwen2-0.5b's flat parameter count, the main path's full width
QWEN2_05B_PARAMS = 494_032_768


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("buckets", [1, 2, 4])
def test_zero1_int8_padding_keeps_full_width_hops_on_the_kernels(dp, buckets):
    """At full width the reference's ``dp * buckets`` padding leaves hop
    chunks that are not whole wire blocks (its plans fall back to the
    global-scale composition); the port pads to ``dp * buckets * 128``, so
    every hop chunk of the plan group (this rank's slice of each bucket,
    the buckets stacked) is kernel eligible."""
    from repro.optim.adamw import zero1_padded_size as r_padded
    from repro_torch.kernels.ring_wire import ops as wire_ops
    from repro_torch.optim.adamw import zero1_padded_size

    n = QWEN2_05B_PARAMS
    chunk = lambda padded: (padded // buckets // dp) * buckets  # noqa: E731
    assert r_padded(n, dp, buckets) == zero1_padded_size(n, dp, buckets)
    assert not wire_ops.wire_eligible((chunk(r_padded(n, dp, buckets)),), torch.float32, "int8")
    padded = zero1_padded_size(n, dp, buckets, wire_ops.WIRE_BLOCK)
    assert 0 <= padded - n < dp * buckets * wire_ops.WIRE_BLOCK
    assert wire_ops.wire_eligible((chunk(padded),), torch.float32, "int8")


#: the ZeRO-1 legs on a compressed ring: (primary impl, grad compression)
#: -> the wire the hops carry
ZERO1_RING_LEGS = {("paxi", "int8"): "int8", ("ring-bf16", None): "bf16"}


@pytest.mark.parametrize("leg", ZERO1_RING_LEGS, ids=lambda leg: f"{leg[0]}-{leg[1]}")
@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"world{w}")
def test_zero1_compressed_ring_leg_runs_the_fused_hops(world, leg, tmp_path):
    """A ZeRO-1 reduce-scatter leg on a compressed ring at dp = world (the
    int8 wire, or a primary ``ring-bf16`` context): ``zero1_granule`` pads
    to whole wire blocks, the plan group runs ``ring_reduce_scatter_fused``
    once per start, and each rank's shard equals, bitwise, the reference's
    fused hop composition (``repro.kernels.ring_wire.ref`` oracles) over
    the transposed bucket split with the buckets stacked on a trailing
    axis, divided by dp.  The reference's own padding is refused."""
    ranks = _torch_ranks.run_ranks(_torch_ranks.zero1_ring_rank, world, tmp_path, *leg,
                                   timeout=120)
    b, nb = _torch_ranks.ZR_BUCKETS, _torch_ranks.NZ
    padded = -(-nb // (world * b * 128)) * (world * b * 128)
    flats = [np.concatenate([x, np.zeros(padded - nb, np.float32)])
             for x in _torch_ranks.zero1_ring_inputs(world).values()]
    seg = padded // (world * b)
    members = [[f.reshape(world, b, seg)[:, j].reshape(-1) for f in flats] for j in range(b)]
    outs = sim_group_rs(members, ZERO1_RING_LEGS[leg])
    for r, got in enumerate(ranks):
        assert int(got["granule"]) == 128 and int(got["padded"]) == padded
        assert got["fused"].tolist() == [[padded // b, b]]  # one stacked wire
        assert bool(got["refused"])
        want = np.concatenate([outs[j][r] for j in range(b)]) / np.float32(world)
        np.testing.assert_array_equal(got["shard"], want, err_msg=f"rank {r}")
