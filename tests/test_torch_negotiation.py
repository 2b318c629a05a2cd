"""Tiered negotiation on the port, twin of ``tests/test_negotiation.py``.

Every test of the reference's file runs here against both packages (the
``pkg`` fixture: the reference on its mesh of one, the port on a gloo world
of one): partial backends are admitted at ``pax_init``, missing optional
entries are synthesized from the spec's recipes in topological order,
missing *required* entries fail at init, dependency cycles are rejected at
spec-load time, and ``PAX_ERR_UNSUPPORTED_OPERATION`` fires at call time
exactly when no recipe chain grounds out.  Beyond the twins: the port's
``capabilities()`` equals the reference's key for key on ``paxi``,
``minimal``, ``ompix`` and ``muk:paxi``; ``available_backends()`` is the
reference's set; no recipe is left without a body; and the reference's
generated ``docs/abi_reference.md`` renders byte for byte from the port's
function table.
"""
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
from repro.core import abi_spec as r_spec
from repro.core import emulation as r_em
from repro.core.abi import PaxABI as RPaxABI
from repro.core.backends.minimal import MinimalBackend as RMinimal
from repro.core.backends.paxi import PaxiBackend as RPaxi

import repro_torch.core as C
from repro_torch.core import abi_spec as t_spec
from repro_torch.core import emulation as t_em
from repro_torch.core import errors as t_errors
from repro_torch.core.abi import PaxABI as TPaxABI
from repro_torch.core.backends.minimal import MinimalBackend as TMinimal
from repro_torch.core.backends.paxi import PaxiBackend as TPaxi
from repro_torch.runtime.dist import make_dist

_DOCS = os.path.join(os.path.dirname(__file__), "..", "docs")


@pytest.fixture(scope="module")
def tdist():
    return make_dist(device="cpu")


@pytest.fixture(params=["reference", "port"])
def pkg(request, mesh1, tdist):
    """One package's negotiation surface and a mesh of one rank."""
    if request.param == "reference":
        return types.SimpleNamespace(
            C=R, abi_spec=r_spec, em=r_em, PaxABI=RPaxABI, Minimal=RMinimal,
            Paxi=RPaxi, mesh=mesh1, arange=lambda n: jnp.arange(float(n)),
            ones=lambda n: jnp.ones((n,), jnp.float32))
    return types.SimpleNamespace(
        C=C, abi_spec=t_spec, em=t_em, PaxABI=TPaxABI, Minimal=TMinimal,
        Paxi=TPaxi, mesh=tdist.mesh,
        arange=lambda n: torch.arange(float(n)),
        ones=lambda n: torch.ones((n,), dtype=torch.float32))


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# spec-load validation
# ---------------------------------------------------------------------------
def test_table_validates_and_orders_topologically(pkg):
    spec = pkg.abi_spec
    order = spec.validate_table(spec.ABI_TABLE)
    assert set(order) == {e.name for e in spec.ABI_TABLE}
    pos = {n: i for i, n in enumerate(order)}
    for entry in spec.ABI_TABLE:
        if entry.recipe is not None:
            for dep in entry.recipe.deps:
                assert pos[dep] < pos[entry.name], (dep, entry.name)


def _mini_entry(spec, name, recipe=None, tier=None):
    return spec.AbiEntry(
        name=name, impl_name=name.capitalize(),
        args=(spec.Arg("comm", spec.COMM),),
        tier=spec.OPTIONAL if tier is None else tier, recipe=recipe,
    )


def test_recipe_cycle_rejected_at_spec_load(pkg):
    spec, em = pkg.abi_spec, pkg.em
    table = (
        _mini_entry(spec, "a", spec.Recipe(("b",), em.build_barrier)),
        _mini_entry(spec, "b", spec.Recipe(("c",), em.build_barrier)),
        _mini_entry(spec, "c", spec.Recipe(("a",), em.build_barrier)),
    )
    with pytest.raises(ValueError) as e:
        spec.validate_table(table)
    assert "cycle" in str(e.value)


def test_recipe_self_cycle_rejected(pkg):
    spec = pkg.abi_spec
    table = (_mini_entry(spec, "a", spec.Recipe(("a",), pkg.em.build_barrier)),)
    with pytest.raises(ValueError, match="cycle"):
        spec.validate_table(table)


def test_recipe_unknown_dep_rejected(pkg):
    spec = pkg.abi_spec
    table = (_mini_entry(spec, "a", spec.Recipe(("ghost",), pkg.em.build_barrier)),)
    with pytest.raises(ValueError, match="unknown entry"):
        spec.validate_table(table)


def test_required_entry_with_recipe_rejected(pkg):
    spec = pkg.abi_spec
    table = (
        _mini_entry(spec, "a"),
        _mini_entry(spec, "b", spec.Recipe(("a",), pkg.em.build_barrier),
                    tier=spec.REQUIRED),
    )
    with pytest.raises(ValueError, match="required"):
        spec.validate_table(table)


def test_required_tier_is_the_query_floor(pkg):
    spec = pkg.abi_spec
    required = {e.name for e in spec.ABI_TABLE if e.tier == spec.REQUIRED}
    assert required == {"comm_size", "comm_rank", "type_size"}


# ---------------------------------------------------------------------------
# init-time negotiation outcomes
# ---------------------------------------------------------------------------
def test_missing_required_entry_fails_at_init(pkg):
    class _NoRankBackend(pkg.Paxi):
        name = "norank"
        rank = None  # comm_rank is REQUIRED -> init must fail

    with pytest.raises(pkg.C.PaxError) as e:
        pkg.PaxABI(_NoRankBackend(pkg.mesh))
    assert e.value.code == t_errors.PAX_ERR_UNSUPPORTED_OPERATION
    assert "comm_rank" in str(e.value)


def test_partial_surface_typo_rejected(pkg):
    class _Typo(pkg.Paxi):
        name = "typo"
        ABI_SUBSET = frozenset({"comm_size", "comm_rank", "type_size",
                                "reduce-scatter"})  # typo: dash, not underscore

    with pytest.raises(ValueError, match="unknown"):
        _Typo(pkg.mesh)


def test_unsupported_fires_only_when_no_chain_grounds_out(pkg):
    class _GroundlessBackend(pkg.Paxi):
        """No reduce_scatter and no allgather: the allreduce recipe (and
        every chain through it or through allgather) cannot ground out."""

        name = "groundless"
        ABI_SUBSET = frozenset({"comm_size", "comm_rank", "type_size", "sendrecv",
                                "alltoall"})

    C_ = pkg.C
    abi = pkg.PaxABI(_GroundlessBackend(pkg.mesh))  # init admits it
    caps = abi.capabilities()
    assert caps["sendrecv"]["source"] == "native"
    assert caps["alltoallv"]["source"] == "emulated"   # <- native alltoall
    assert caps["alltoallw"]["source"] == "emulated"
    for name in ("allreduce", "gather", "scan", "bcast", "scatter", "barrier"):
        assert caps[name]["source"] == "unavailable", name
    assert "reduce_scatter" in caps["allreduce"]["reason"]
    assert "allreduce" in caps["barrier"]["reason"]  # transitively unmet
    x = pkg.arange(4)
    with pytest.raises(C_.PaxError) as e:
        abi.allreduce(x, C_.PAX_SUM, C_.PAX_COMM_SELF)
    assert e.value.code == t_errors.PAX_ERR_UNSUPPORTED_OPERATION
    with pytest.raises(C_.PaxError):
        abi.ibarrier(C_.PAX_COMM_SELF)  # i* twin of an unavailable entry
    assert np.allclose(_np(abi.alltoallv(x, [4], [4], C_.PAX_COMM_SELF)), _np(x))


# ---------------------------------------------------------------------------
# the minimal backend: emulation end-to-end on one rank
# ---------------------------------------------------------------------------
def test_minimal_backend_emulates_whole_surface(pkg):
    C_ = pkg.C
    abi = C_.pax_init(pkg.mesh, impl="minimal")
    caps = abi.capabilities()
    assert {n for n, i in caps.items() if i["source"] == "native"} == set(
        pkg.Minimal.ABI_SUBSET)
    assert not [n for n, i in caps.items() if i["source"] == "unavailable"]
    emulated = {n for n, i in caps.items() if i["source"] == "emulated"}
    assert {"allreduce", "bcast", "barrier", "scatter", "alltoallw"} <= emulated
    # deepest chain in the table: scatter -> bcast -> allreduce -> rs+ag
    assert caps["scatter"]["deps"] == ("bcast", "comm_rank", "comm_size")
    assert caps["bcast"]["deps"] == ("allreduce", "comm_rank")
    assert caps["allreduce"]["deps"] == ("reduce_scatter", "allgather", "comm_size")
    x = pkg.arange(6)
    self_ = C_.PAX_COMM_SELF
    for got in (abi.allreduce(x, C_.PAX_SUM, self_), abi.scan(x, C_.PAX_SUM, self_),
                abi.exscan(x, C_.PAX_SUM, self_), abi.bcast(x, 0, self_),
                abi.gather(x, 0, self_)):
        assert np.allclose(_np(got), _np(x))
    assert abi.barrier(self_) is None
    with pytest.raises(ValueError):  # recipe keeps the SPMD-uniform contract
        abi.alltoallv(x, [6], [4], self_)


def test_emulated_entries_are_specialized_and_tooled(pkg):
    """Emulated entries go through the same specialization and tool
    interposition as native ones: one before/after pair per top-level
    call, the spec's byte accounting, respecialization on attach."""
    C_ = pkg.C
    cc, bc = C_.CallCounter(), C_.ByteCounter()
    abi = C_.pax_init(pkg.mesh, impl="minimal", tools=[cc, bc])
    x = pkg.ones(8)
    abi.allreduce(x, C_.PAX_SUM, C_.PAX_COMM_SELF)
    abi.bcast(x, 0, C_.PAX_COMM_SELF)
    # the emulated bcast calls allreduce internally; tools see the top level
    assert cc.counts["allreduce"] == 1
    assert cc.counts["bcast"] == 1
    assert bc.bytes["allreduce"] == 8 * 4
    assert "allreduce" in abi.__dict__ and "iallreduce" in abi.__dict__
    assert getattr(abi.__dict__["allreduce"], "__generated_src__", None)
    assert getattr(abi._table["allreduce"], "__emulated__", False)
    assert abi._table["allreduce"].__emulated_deps__ == (
        "reduce_scatter", "allgather", "comm_size")


def test_emulated_nonblocking_twins_complete(pkg):
    C_ = pkg.C
    abi = C_.pax_init(pkg.mesh, impl="minimal")
    x = pkg.ones(4)
    self_ = C_.PAX_COMM_SELF
    reqs = [
        abi.iallreduce(x, C_.PAX_SUM, self_),
        abi.ibarrier(self_),   # ibarrier == iallreduce recipe
        abi.iscan(x, C_.PAX_SUM, self_),
        abi.ibcast(x, 0, self_),
        abi.igather(x, 0, self_),
    ]
    assert abi.outstanding_requests == len(reqs)
    flag, vals = abi.testall(reqs)
    assert flag and len(vals) == len(reqs)
    assert abi.outstanding_requests == 0


def test_capabilities_report_translates_across_mukautuva(pkg):
    """ompix exports no Reduce/Gather symbols; the report names the missing
    foreign symbol and the ABI-layer recipe that filled it."""
    C_ = pkg.C
    abi = C_.pax_init(pkg.mesh, impl="ompix")
    caps = abi.capabilities()
    assert caps["allreduce"]["source"] == "native"
    assert caps["allreduce"]["impl_symbol"] == "Allreduce"
    for name in ("reduce", "gather"):
        assert caps[name]["source"] == "emulated", name
        assert caps[name]["native"] is False
        assert caps[name]["impl"] == "ompix"
    x = pkg.arange(4)
    assert np.allclose(_np(abi.reduce(x, C_.PAX_SUM, 0, C_.PAX_COMM_SELF)), _np(x))
    assert np.allclose(_np(abi.gather(x, 0, C_.PAX_COMM_SELF)), _np(x))


def test_full_backends_stay_fully_native(pkg):
    C_, spec = pkg.C, pkg.abi_spec
    caps = C_.pax_init(pkg.mesh, impl="paxi").capabilities()
    assert all(i["source"] == "native" for i in caps.values())
    # muk:paxi fronts ompix's partial symbol table: its two emulated holes
    # plus the fault tier, native everywhere else
    caps = C_.pax_init(pkg.mesh, impl="muk:paxi").capabilities()
    fault_rows = {e.name for e in spec.ABI_TABLE if e.tier == spec.FAULT}
    assert {n for n, i in caps.items() if i["source"] != "native"} == {
        "reduce", "gather"} | fault_rows


def test_recipes_resolve_lazily(pkg):
    """Negotiation *decides* emulated at init; the closure is compiled on
    first call (or first plan), and capabilities() forces nothing."""
    C_ = pkg.C
    abi = C_.pax_init(pkg.mesh, impl="minimal")
    shim = abi._table["scan"]
    assert shim.__lazy_recipe__["impl"] is None  # deferred at init
    caps = abi.capabilities()
    assert caps["scan"]["source"] == "emulated"
    assert caps["scan"]["deps"] == ("allgather", "comm_rank", "comm_size")
    assert shim.__lazy_recipe__["impl"] is None  # the report forced nothing
    x = pkg.arange(4)
    assert np.allclose(_np(abi.scan(x, C_.PAX_SUM, C_.PAX_COMM_SELF)), _np(x))
    built = abi._table["scan"]
    assert built is not shim and getattr(built, "__emulated__", False)
    assert shim.__lazy_recipe__["impl"] is built  # hoisted shims stay valid
    # deps force transitively: building scatter builds bcast and allreduce
    abi2 = C_.pax_init(pkg.mesh, impl="minimal")
    assert abi2._table["bcast"].__lazy_recipe__["impl"] is None
    abi2.scatter(x, 0, C_.PAX_COMM_SELF)
    for name in ("scatter", "bcast", "allreduce"):
        assert getattr(abi2._table[name], "__emulated__", False), name
    abi3 = C_.pax_init(pkg.mesh, impl="minimal")
    assert abi3._table["scatter"].__lazy_recipe__["impl"] is None


def test_lazy_build_failure_is_isolated(pkg):
    """An unused broken recipe costs nothing; its entry fails on first use,
    not at init."""
    C_, spec = pkg.C, pkg.abi_spec
    calls = {"n": 0}

    def exploding_build(ctx):
        calls["n"] += 1
        raise RuntimeError("recipe build exploded")

    entry = spec.ENTRY_BY_NAME["scan"]
    orig = entry.recipe
    object.__setattr__(entry, "recipe", spec.Recipe(orig.deps, exploding_build))
    try:
        abi = C_.pax_init(pkg.mesh, impl="minimal")  # init does not build
        assert calls["n"] == 0
        with pytest.raises(RuntimeError, match="exploded"):
            abi.scan(pkg.arange(4), C_.PAX_SUM, C_.PAX_COMM_SELF)
        assert calls["n"] == 1
        assert np.allclose(
            _np(abi.allreduce(pkg.arange(4), C_.PAX_SUM, C_.PAX_COMM_SELF)),
            np.arange(4.0))
    finally:
        object.__setattr__(entry, "recipe", orig)


def test_ring_allreduce_is_recipe_composed(pkg):
    C_ = pkg.C
    abi = C_.pax_init(pkg.mesh, impl="ring")
    caps = abi.capabilities()
    assert caps["allreduce"]["source"] == "emulated"
    assert caps["reduce_scatter"]["source"] == "native"
    assert caps["allgather"]["source"] == "native"
    x = pkg.arange(8)
    assert np.allclose(_np(abi.allreduce(x, C_.PAX_SUM, C_.PAX_COMM_SELF)), _np(x))


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
def test_available_backends_are_the_references():
    assert C.available_backends() == R.available_backends()


@pytest.mark.parametrize("impl", ("paxi", "minimal", "ompix", "muk:paxi"))
def test_capabilities_equal_the_references_key_for_key(impl, mesh1, tdist):
    want = R.pax_init(mesh1, impl=impl).capabilities()
    got = C.pax_init(tdist.mesh, impl=impl).capabilities()
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


def test_every_recipe_has_a_body(tdist):
    """No recipe the table names is a placeholder: on minimal every entry
    resolves, and every recipe builds or plans without raising."""
    caps = C.pax_init(tdist.mesh, impl="minimal").capabilities()
    assert not [n for n, i in caps.items() if i["source"] == "unavailable"]
    assert not hasattr(t_em, "_deferred")
    for entry in t_spec.ABI_TABLE:
        recipe = entry.recipe
        if recipe is None:
            continue
        for fn in (recipe.build, recipe.plan, recipe.plan_group):
            if fn is not None:
                ref_fn = getattr(r_em, fn.__name__)
                assert fn.__name__ == ref_fn.__name__
                assert fn.__code__.co_varnames[:fn.__code__.co_argcount] == \
                    ref_fn.__code__.co_varnames[:ref_fn.__code__.co_argcount], fn.__name__


def test_abi_reference_renders_from_the_port_table():
    """``docs/generate_abi_reference.py`` with its spec and error table
    pointed at the port's modules renders the committed file byte for byte."""
    spec = importlib.util.spec_from_file_location(
        "generate_abi_reference_port", os.path.join(_DOCS, "generate_abi_reference.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.abi_spec, gen._errors = t_spec, t_errors
    with open(os.path.join(_DOCS, "abi_reference.md")) as f:
        assert gen.generate() == f.read()


# ---------------------------------------------------------------------------
# the fault tier through the recipes (minimal, and above Mukautuva on ompix)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ("minimal", "ompix"))
def test_fault_recipes_run_the_ulfm_contract(pkg, impl):
    C_ = pkg.C
    abi = C_.pax_init(pkg.mesh, impl=impl)
    caps = abi.capabilities()
    fault = [e.name for e in pkg.abi_spec.ABI_TABLE if e.tier == pkg.abi_spec.FAULT]
    assert all(caps[n]["source"] == "emulated" for n in fault)
    dp = abi.comm_from_axes(("data",))
    assert tuple(abi.comm_get_failed(dp)) == ()
    assert abi.comm_failure_ack(dp) is None
    assert abi.comm_agree(5, dp) == 5
    child = abi.comm_shrink(dp)  # no failure: the survivors are everyone
    assert child != dp and abi.comm_size(child) == 1
    assert abi.comm_revoke(dp) is None
    with pytest.raises(C_.PaxError) as e:
        abi.allreduce(pkg.arange(3), C_.PAX_SUM, dp)
    assert e.value.code == t_errors.PAX_ERR_REVOKED
    assert tuple(abi.comm_get_failed(dp)) == ()  # fault entries act on revoked comms


def test_fault_recipes_report_a_dead_rank_as_the_reference(pkg):
    class _DeadRank(pkg.Minimal):
        name = "deadrank"

        def local_failed(self, comm):
            return (0,)

    abi = pkg.PaxABI(_DeadRank(pkg.mesh))
    dp = abi.comm_from_axes(("data",))
    assert tuple(abi.comm_get_failed(dp)) == (0,)
    for step in ("pending", "acked"):  # unacknowledged, then no survivor
        with pytest.raises(pkg.C.PaxError) as e:
            abi.comm_agree(1, dp)
        assert e.value.code == t_errors.PAX_ERR_PROC_FAILED, step
        abi.comm_failure_ack(dp)
