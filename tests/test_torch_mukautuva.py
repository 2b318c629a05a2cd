"""The port's Mukautuva layer and foreign library against the reference, on
one rank (a gloo world of one; the reference on its mesh of one).

* the ``OMPIX_ERR_*`` → ``PAX_ERR_*`` map is the reference's, code for code;
* predefined datatype and op handles convert to the same foreign
  descriptors, and the O(1) reverse map gives the same ABI handle back
  (first registration wins for aliases: ``PAX_CHAR`` → ``PAX_INT8_T``);
* a user op crosses the layer through the callback trampoline, with the
  foreign datatype converted back to the reference's ABI handle;
* ``sendrecv``'s ompix status converts to the standard layout as the
  reference converts it;
* the request map: ``ialltoallw`` keeps the backend's converted datatype
  vectors in its request until ``wait`` and drops them there (on ompix, and
  on a native backend that stashes temps, through both the specialized and
  the generic entry points);
* every ``WRAP_*``, ``plan_*`` and ``plan_group_*`` method of
  ``MukBackend`` is generated from the spec (``__generated_src__``), with
  the reference's source text, and none is written by hand.
"""
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
from repro.core import mukautuva as r_muk
from repro.core.backends import ompix as r_ox

import repro_torch.core as C
from repro_torch.core import abi_spec
from repro_torch.core import mukautuva as t_muk
from repro_torch.core.abi import PaxABI
from repro_torch.core.backends import ompix as t_ox
from repro_torch.core.backends.paxi import PaxiBackend
from repro_torch.runtime.dist import make_dist

OMPIX_CODES = tuple(range(71, 81))


@pytest.fixture(scope="module")
def tdist():
    return make_dist(device="cpu")


@pytest.fixture(scope="module")
def ref_ompix(mesh1):
    return R.pax_init(mesh1, impl="ompix")


@pytest.fixture(scope="module")
def port_ompix(tdist):
    return C.pax_init(tdist.mesh, impl="ompix")


def _ref_dtype_handles():
    return sorted(r_muk.MukBackend(r_ox.OmpixLib(None))._predef_dtypes)


def _ref_op_handles():
    return sorted(r_muk.MukBackend(r_ox.OmpixLib(None))._predef_ops)


# ---------------------------------------------------------------------------
# error codes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("code", OMPIX_CODES)
def test_error_code_map_is_the_references(code, ref_ompix, port_ompix):
    names = [n for n in dir(r_ox) if n.startswith("OMPIX_ERR_") and getattr(r_ox, n) == code]
    assert names and all(getattr(t_ox, n) == code for n in names)
    assert port_ompix.backend.errors.to_abi(code) == ref_ompix.backend.errors.to_abi(code)
    with pytest.raises(C.PaxError) as e:
        port_ompix.backend._rc(code)
    assert e.value.code == ref_ompix.backend.errors.to_abi(code)


def test_success_and_unknown_codes_translate_as_the_reference(ref_ompix, port_ompix):
    for code in (0, 99, -3):
        assert port_ompix.backend.errors.to_abi(code) == ref_ompix.backend.errors.to_abi(code)
    assert port_ompix.backend._rc(0) is None


# ---------------------------------------------------------------------------
# handle conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("handle", _ref_dtype_handles())
def test_predefined_datatype_converts_as_the_reference(handle, ref_ompix, port_ompix):
    rb, tb = ref_ompix.backend, port_ompix.backend
    r_impl, t_impl = rb._convert_dtype(handle), tb._convert_dtype(handle)
    assert t_impl.dname == r_impl.dname and t_impl.size == r_impl.size
    assert t_impl is tb._predef_dtype_page[handle]  # the zero-page flat array
    ok, size = tb.lib.Type_size(t_impl)
    assert ok == 0 and size == rb.lib.Type_size(r_impl)[1]
    # O(1) reverse conversion: the reference's answer (first one wins)
    assert tb._dtype_to_abi(t_impl) == rb._dtype_to_abi(r_impl)
    if r_impl.numpy_dtype is not None:
        assert str(t_impl.torch_dtype).removeprefix("torch.") == str(r_impl.numpy_dtype)


def test_aliases_reverse_to_the_first_registration(port_ompix):
    b = port_ompix.backend
    assert b._dtype_to_abi(b._convert_dtype(C.PAX_CHAR)) == C.PAX_INT8_T
    assert b._dtype_to_abi(b._convert_dtype(C.PAX_FLOAT)) == C.PAX_FLOAT32
    assert b._dtype_to_abi(t_ox.OmpixDatatype("stranger", 4, torch.float32)) == \
        C.PAX_DATATYPE_NULL
    h = port_ompix.type_contiguous(3, C.PAX_FLOAT32)   # registered with the lib
    impl = b._convert_dtype(h)
    assert impl.size == 12 and b._dtype_to_abi(impl) == h


@pytest.mark.parametrize("handle", _ref_op_handles())
def test_predefined_op_converts_as_the_reference(handle, ref_ompix, port_ompix):
    r_impl = ref_ompix.backend._convert_op(handle)
    t_impl = port_ompix.backend._convert_op(handle)
    assert (t_impl.oname, t_impl.is_native, t_impl.commute) == \
        (r_impl.oname, r_impl.is_native, r_impl.commute)
    assert port_ompix.backend.op_is_native(handle) == ref_ompix.backend.op_is_native(handle)


def test_bad_handles_raise_the_references_classes(ref_ompix, port_ompix):
    rb, tb = ref_ompix.backend, port_ompix.backend
    for conv, bad in (("_convert_dtype", 1023), ("_convert_op", 1023),
                      ("_convert_comm", C.PAX_DATATYPE_NULL + (1 << 30) + 77)):
        with pytest.raises(R.PaxError) as want:
            getattr(rb, conv)(bad)
        with pytest.raises(C.PaxError) as got:
            getattr(tb, conv)(bad)
        assert got.value.code == want.value.code, conv
    assert tb._convert_comm(C.PAX_COMM_WORLD) is tb.lib.comm_world
    assert tb._convert_comm(C.PAX_COMM_SELF) is tb.lib.comm_self
    assert tb._convert_comm(C.PAX_COMM_NULL) is t_ox.ompix_comm_null


def test_foreign_communicators_share_the_contexts_groups(tdist):
    """ompix's communicators carry the group the ABI's own table holds for
    the same axes: the layer creates no process group."""
    abi = C.pax_init(tdist.mesh, impl="ompix")
    dp = abi.comm_from_axes(("data",), "dp")
    dup = abi.comm_dup(dp)
    impl, twin = abi.backend._convert_comm(dp), abi.backend._convert_comm(dup)
    info = abi.comms.info(dp)
    assert impl.group is info.group and twin.group is info.group
    assert impl.ranks == info.ranks == (0,)
    assert abi.backend.lib.comm_world.group is abi.comms.info(C.PAX_COMM_WORLD).group
    assert abi.comm_size(dp) == 1 and abi.comm_rank(dp) == 0
    abi.release()
    assert abi.backend.lib.comm_world.group is None and not abi.backend._comm_table


# ---------------------------------------------------------------------------
# callback trampoline, status conversion
# ---------------------------------------------------------------------------
def test_user_op_crosses_the_layer_through_the_trampoline(mesh1, port_ompix):
    seen = {}

    def sum_op(a, b):
        return a + b

    def typed_op(a, b, dtype):
        seen.setdefault("port", []).append(dtype)
        return a * b

    h = port_ompix.op_create(sum_op, name="sumspy")
    impl = port_ompix.backend._convert_op(h)
    assert impl.oname == "ompix_user_op" and not impl.is_native
    a, b = torch.arange(4.0), torch.ones(4)
    assert torch.equal(impl.fn(a, b), a + b)
    ht = port_ompix.op_create(typed_op, commutative=False)
    impl_t = port_ompix.backend._convert_op(ht)
    assert not impl_t.commute
    impl_t.fn(a, b, port_ompix.backend._convert_dtype(C.PAX_FLOAT))
    # the reference's trampoline hands the user op the same ABI handle
    ref = R.pax_init(mesh1, impl="ompix")

    def ref_typed(a, b, dtype):
        seen.setdefault("ref", []).append(dtype)
        return a * b

    rt = ref.op_create(ref_typed)
    ref.backend._convert_op(rt).fn(1.0, 2.0, ref.backend._convert_dtype(R.PAX_FLOAT))
    assert seen["port"] == seen["ref"] == [C.PAX_FLOAT32]
    # and the op reduces through the foreign Allreduce on a group of one
    x = torch.arange(5.0)
    assert torch.equal(port_ompix.allreduce(x, h, C.PAX_COMM_SELF), x)


def test_sendrecv_status_converts_as_the_reference(ref_ompix, port_ompix):
    x = torch.arange(6.0)
    st = C.Status()
    y = port_ompix.sendrecv(x, [(0, 0)], C.PAX_COMM_SELF, status=st)
    assert torch.equal(y, x)
    assert (st.SOURCE, st.TAG, st.ERROR) == (C.PAX_ANY_SOURCE, C.PAX_ANY_TAG, 0)
    ref_ompix.sendrecv(jnp.arange(6.0), [(0, 0)], R.PAX_COMM_SELF)
    got, want = port_ompix.backend.last_status, ref_ompix.backend.last_status
    assert (got.SOURCE, got.TAG, got.ERROR) == (want.SOURCE, want.TAG, want.ERROR) == (-1, 0, 0)
    assert [got.get_reserved(i) for i in (0, 1)] == [want.get_reserved(i) for i in (0, 1)] \
        == [0, 6]


# ---------------------------------------------------------------------------
# the request map (§6.2): temps ride the request until completion
# ---------------------------------------------------------------------------
SEND_T = [C.PAX_FLOAT32]
RECV_T = [C.PAX_FLOAT64]


def test_ialltoallw_holds_its_converted_vectors_until_wait(port_ompix):
    abi = port_ompix
    blocks = torch.arange(6.0).reshape(1, 6)
    req = abi.ialltoallw(blocks, SEND_T, RECV_T, C.PAX_COMM_SELF)
    temps = req.temp_state
    assert temps is abi.backend.last_alltoallw_temps
    (send_c, recv_c) = temps
    assert send_c == (t_ox.ompix_mpi_float,) and recv_c == (t_ox.ompix_mpi_double,)
    (part,) = abi.wait(req)
    assert part.dtype == torch.float64 and torch.equal(part, blocks[0].double())
    assert req.temp_state is None  # dropped at completion
    # the generic (class-level) entry point keeps them the same way
    req2 = PaxABI.ialltoallw(abi, blocks, SEND_T, RECV_T, C.PAX_COMM_SELF)
    assert req2.temp_state is abi.backend.last_alltoallw_temps
    abi.wait(req2)
    assert req2.temp_state is None and abi.outstanding_requests == 0


class _TempsBackend(PaxiBackend):
    """A native backend whose alltoallw stashes per-call temporaries the way
    Mukautuva's converted vectors are stashed."""

    name = "temps"

    def ialltoallw(self, blocks, sendtypes, recvtypes, comm):
        # the asynchronous start (the blocking form completes this one)
        self.last_alltoallw_temps = (tuple(sendtypes), tuple(recvtypes))
        return super().ialltoallw(blocks, sendtypes, recvtypes, comm)


@pytest.mark.parametrize("path", ("specialized", "generic"))
def test_nonblocking_request_keeps_a_backends_temps(path, tdist):
    abi = PaxABI(_TempsBackend(tdist.mesh))
    blocks = torch.ones(1, 3)
    start = abi.ialltoallw if path == "specialized" else (
        lambda *a: PaxABI.ialltoallw(abi, *a))
    req = start(blocks, SEND_T, RECV_T, C.PAX_COMM_SELF)
    assert req.temp_state == ((C.PAX_FLOAT32,), (C.PAX_FLOAT64,))
    abi.wait(req)
    assert req.temp_state is None


def test_persistent_alltoallw_keeps_temps_for_the_plans_life(port_ompix):
    plan = port_ompix.alltoallw_init(torch.zeros(1, 4), SEND_T, RECV_T, C.PAX_COMM_SELF)
    assert plan.request.temp_state is port_ompix.backend.last_alltoallw_temps
    (part,) = port_ompix.wait(plan.start(torch.ones(1, 4)))
    assert part.dtype == torch.float64
    plan.free()
    assert plan.request.temp_state is None


# ---------------------------------------------------------------------------
# generated wrappers
# ---------------------------------------------------------------------------
def _generated_names():
    names = []
    for e in abi_spec.ABI_TABLE:
        names.append((e.name, e.backend_method))
        if e.persistent:
            names.append((e.name, f"plan_{e.backend_method}"))
            if e.payload_args == (0,) and not e.temps and e.muk_ret == "value":
                names.append((e.name, f"plan_group_{e.backend_method}"))
    return names


@pytest.mark.parametrize("entry,method", _generated_names())
def test_wrapper_is_generated_with_the_references_source(entry, method):
    fn = t_muk.MukBackend.__dict__[method]
    ref = r_muk.MukBackend.__dict__[method]
    assert fn.__generated_src__ == ref.__generated_src__
    if method != "size":  # the excludes-aware override wraps the generated one
        assert fn.__code__.co_filename == f"<abi_spec:{method}>"


def test_no_table_method_is_written_by_hand():
    generated = {m for _, m in _generated_names()}
    table = {e.backend_method for e in abi_spec.ABI_TABLE}
    for name, fn in vars(t_muk.MukBackend).items():
        base = name.removeprefix("plan_group_").removeprefix("plan_")
        if base in table and callable(fn):
            assert name in generated and getattr(fn, "__generated_src__", None), name
    # the generated set is exactly the reference's
    ref = {n for n, f in vars(r_muk.MukBackend).items()
           if getattr(f, "__generated_src__", None)}
    got = {n for n, f in vars(t_muk.MukBackend).items()
           if getattr(f, "__generated_src__", None)}
    assert got == ref == generated


def test_shrunk_comm_size_answers_from_the_mirrored_table(port_ompix):
    """The fault tier's exception to the generated table: a shrunk comm's
    size comes from the ABI-side table (the foreign library sees only the
    parent's extent)."""
    b = port_ompix.backend
    dp = port_ompix.comm_from_axes(("data",))
    assert b.size(dp) == 1
    child = b.comms.register_shrunk(dp, [0])
    assert b.size(child) == 0
