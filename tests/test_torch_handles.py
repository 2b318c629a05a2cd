"""The port's handle layer and function table equal the reference's.

The paper's claim is that an application does not change when the
implementation under a standard ABI changes; two packages implementing
one function table are that claim taken literally.  So every ``PAX_*``
value, error code, handle classification and table row of
``repro_torch.core`` must equal ``repro.core``'s.
"""
import pytest

import repro.core as R
import repro.core.abi_spec as R_spec
import repro.core.constants as R_const
import repro.core.datatypes as R_dt
import repro.core.errors as R_err
import repro.core.handles as R_h
import repro.core.status as R_status
import repro_torch.core as T
import repro_torch.core.abi_spec as T_spec
import repro_torch.core.constants as T_const
import repro_torch.core.datatypes as T_dt
import repro_torch.core.errors as T_err
import repro_torch.core.handles as T_h
import repro_torch.core.status as T_status


def _pax_ints(mod):
    return {k: v for k, v in vars(mod).items()
            if k.startswith("PAX_") and isinstance(v, int)}


@pytest.mark.parametrize("ref,port", [(R_const, T_const), (R_h, T_h), (R_err, T_err)],
                         ids=["constants", "handles", "errors"])
def test_every_pax_integer_equal(ref, port):
    assert _pax_ints(port) == _pax_ints(ref)


def test_constant_tables_and_sentinels():
    assert T_const.unique_negative_constants() == R_const.unique_negative_constants()
    assert T_const.xor_constants() == R_const.xor_constants()
    for name in ("PAX_BOTTOM", "PAX_IN_PLACE", "PAX_STATUS_IGNORE", "PAX_STATUSES_IGNORE"):
        assert repr(getattr(T_const, name)) == repr(getattr(R_const, name))
    for name in ("PAX_ABI_INTEGER_MODEL", "PAX_VERSION", "PAX_ABI_VERSION"):
        assert getattr(T_const, name) == getattr(R_const, name)


def test_zero_page_tables_equal():
    assert [k.name for k in T_h.ZERO_PAGE_KINDS] == [k.name for k in R_h.ZERO_PAGE_KINDS]
    assert T_h.ZERO_PAGE_IS_NULL == R_h.ZERO_PAGE_IS_NULL
    assert {k.name: int(k) for k in T_h.HandleKind} == {k.name: int(k) for k in R_h.HandleKind}
    assert T_h.PREDEFINED_NAMES == R_h.PREDEFINED_NAMES
    assert T_h.PREDEFINED_OPS == R_h.PREDEFINED_OPS
    assert T_h.PREDEFINED_DATATYPES == R_h.PREDEFINED_DATATYPES


def _sample_handles():
    hs = list(range(-4, T_h.ZERO_PAGE_SIZE + 4))
    for kind in T_h.HandleKind:
        if kind is T_h.HandleKind.INVALID:
            continue
        for idx in (0, 1, 77, T_h._USER_INDEX_MASK):
            hs.append(T_h.make_user_handle(kind, idx))
    hs += [1 << 30, (1 << 30) | (15 << 24), (1 << 40) | 5]
    return hs


@pytest.mark.parametrize("query", ["describe", "handle_kind", "is_null",
                                   "is_predefined", "is_user_handle"])
def test_handle_queries_equal_over_handle_space(query):
    tq, rq = getattr(T_h, query), getattr(R_h, query)
    for h in _sample_handles():
        a, b = tq(h), rq(h)
        if query == "handle_kind":
            a, b = a.name, b.name
        assert a == b, (query, h)


def test_user_handle_encoding_equal():
    for kind in T_h.HandleKind:
        if kind is T_h.HandleKind.INVALID:
            continue
        rk = R_h.HandleKind[kind.name]
        assert T_h.make_user_handle(kind, 12345) == R_h.make_user_handle(rk, 12345)


def test_datatype_bit_queries_equal():
    for h in range(512, 1024):
        assert T_h.datatype_is_fixed_size(h) == R_h.datatype_is_fixed_size(h)
        assert T_h.datatype_is_variable_size(h) == R_h.datatype_is_variable_size(h)
        if T_h.datatype_is_fixed_size(h):
            assert T_h.datatype_encoded_size(h) == R_h.datatype_encoded_size(h)


def test_error_strings_equal():
    for code in range(-3, T_err.PAX_ERR_LASTCODE + 3):
        assert T_err.error_string(code) == R_err.error_string(code)
    assert str(T_err.PaxError(T_err.PAX_ERR_COMM, "x")) == str(R_err.PaxError(R_err.PAX_ERR_COMM, "x"))
    tr = T_err.ErrorTranslator({7: T_err.PAX_ERR_TAG})
    rr = R_err.ErrorTranslator({7: R_err.PAX_ERR_TAG})
    for code in (0, 7, 8):
        assert tr.to_abi(code) == rr.to_abi(code)


def test_predefined_datatypes_equal():
    assert T_dt.N_PREDEFINED == R_dt.N_PREDEFINED
    tp, rp = T_dt.predefined_descriptors(), R_dt.predefined_descriptors()
    assert sorted(tp) == sorted(rp)
    treg, rreg = T_dt.DatatypeRegistry(), R_dt.DatatypeRegistry()
    for h in tp:
        assert (tp[h].name, tp[h].size) == (rp[h].name, rp[h].size)
        assert treg.type_size_encoded(h) == rreg.type_size_encoded(h)
        assert treg.type_size_lookup(h) == rreg.type_size_lookup(h)
    # derived types allocate the same user handles with the same sizes
    for reg_fn in ("type_contiguous",):
        a = getattr(treg, reg_fn)(3, T_h.PAX_FLOAT32)
        b = getattr(rreg, reg_fn)(3, R_h.PAX_FLOAT32)
        assert a == b and treg.type_size(a) == rreg.type_size(b) == 12
    assert treg.type_vector(2, 3, 4, T_h.PAX_INT16_T) == rreg.type_vector(2, 3, 4, R_h.PAX_INT16_T)


def test_tensor_dtypes_map_to_the_reference_handles():
    import jax.numpy as jnp
    import numpy as np
    import torch

    treg, rreg = T_dt.DatatypeRegistry(), R_dt.DatatypeRegistry()
    pairs = [(torch.float32, np.float32), (torch.float64, np.float64),
             (torch.int8, np.int8), (torch.int32, np.int32), (torch.int64, np.int64),
             (torch.uint8, np.uint8), (torch.float16, np.float16),
             (torch.bfloat16, jnp.bfloat16), (torch.complex64, np.complex64)]
    for td, nd in pairs:
        assert treg.from_array(torch.zeros(1, dtype=td)) == rreg.from_array(np.zeros(1, nd))


def test_status_layout_equal():
    assert T_status.STATUS_BYTES == R_status.STATUS_BYTES
    assert T_status.N_RESERVED == R_status.N_RESERVED
    s = T.Status()
    s.SOURCE, s.TAG, s.ERROR = 3, 4, 5
    s.set_reserved(2, 9)
    r = R.Status()
    r.SOURCE, r.TAG, r.ERROR = 3, 4, 5
    r.set_reserved(2, 9)
    assert s.raw().tolist() == r.raw().tolist()
    assert T_status.traced_status(1, 2, 3).tolist() == R_status.traced_status(1, 2, 3).tolist()


def _row(entry):
    recipe = entry.recipe
    return (entry.name, entry.impl_name,
            tuple((a.name, a.kind, a.has_default, a.default if a.has_default else None)
                  for a in entry.args),
            entry.backend_method, entry.nonblocking, entry.bytes_arg,
            entry.dtype_size_kwarg, entry.fills_status, entry.muk_ret, entry.temps,
            entry.tier, entry.persistent, entry.integrity,
            None if recipe is None else (recipe.deps, recipe.plan is not None,
                                         recipe.plan_group is not None),
            entry.payload_args, entry.temps_attr)


@pytest.mark.parametrize("i", range(len(R_spec.ABI_TABLE)),
                         ids=[e.name for e in R_spec.ABI_TABLE])
def test_abi_table_row_equal(i):
    assert len(T_spec.ABI_TABLE) == len(R_spec.ABI_TABLE)
    assert _row(T_spec.ABI_TABLE[i]) == _row(R_spec.ABI_TABLE[i])


def test_emulation_order_and_codegen_equal():
    assert T_spec.EMULATION_ORDER == R_spec.EMULATION_ORDER
    for te, re_ in zip(T_spec.ABI_TABLE, R_spec.ABI_TABLE):
        assert T_spec.signature_src(te, extra_kwargs=True) == R_spec.signature_src(re_, extra_kwargs=True)
        assert T_spec.call_args_src(te) == R_spec.call_args_src(re_)


def test_negotiated_capabilities_equal_on_paxi(mesh1):
    """Same table, same native backend: negotiation resolves every entry the
    same way (source, plan and plan-group compilation, group hooks)."""
    ref = R.pax_init(mesh1, impl="paxi").capabilities()
    port = T.pax_init(None, impl="paxi").capabilities()
    keys = ("tier", "source", "plan", "plan_group", "native", "group_hook", "backend")
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert {k: port[name].get(k) for k in keys} == {k: ref[name].get(k) for k in keys}, name


def test_unknown_backend_names_what_exists():
    with pytest.raises(ValueError, match="paxi"):
        T.pax_init(None, impl="ring")
    assert T.available_backends() == ("paxi",)
