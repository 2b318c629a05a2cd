"""The compressed ring-hop kernels and the error-feedback pack of the port
against the reference, on the CPU.

On the CPU the wrappers run their plain versions (``ring_wire/ref.py``).
Those are held against the reference package's Pallas kernels in interpret
mode and its ``ring_wire/ref.py`` oracles, on the same numpy inputs:

* ``quant_i8``, both bf16 hops and ``pack_parts_ef``: bitwise, including
  exact rounding ties of both parities (int8 ``rint`` and bf16 nearest
  even), an all-zero block (the 1e-30 floor) and values at the +-127 clip;
* ``hop_add_quant_i8``: bitwise against ``ref.hop_add_quant_i8_block``
  (multiply, then add: two roundings) and within one quantum of the
  interpret kernel, whose body contracts ``q*s + a`` to an FMA;
* ``hop_accum_i8``: bitwise against ``ref.hop_accum_i8_block`` and within
  ``max(s)`` of the interpret kernel (the reference's own bound).

The CUDA kernels are held bitwise against the plain versions on the card by
the ``cuda``-marked twins here (they skip on the CPU) and by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ring_wire import kernel as R_k
from repro.kernels.ring_wire import ops as R_ops
from repro.kernels.ring_wire import ref as R_ref
from repro_torch import kernels as T_kernels
from repro_torch.kernels.ring_wire import ops as T_ops
from repro_torch.kernels.ring_wire import ref as T_ref

B = 128
NB = 16


def _vec(n, seed, scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _special_blocks():
    """Blocks whose codes or casts sit on the edges: with absmax 127 the
    int8 scale is exactly 1.0, so k + 0.5 are exact rint ties of both
    parities; an all-zero block; both clip ends; bf16 ties."""
    ties = np.zeros(B, np.float32)
    ties[0] = 127.0
    ties[1:21] = np.arange(-10, 10) + 0.5
    clip = np.linspace(-127.0, 127.0, B).astype(np.float32)
    clip[:2] = (-127.0, 127.0)
    # normal numbers only: XLA's CPU flushes f32 subnormals to zero
    bf_base = np.array([1.0, 1.0078125, -3.0, 65504.0, 1e-30, 3e38, 2.5, -0.75], np.float32)
    bf_ties = (bf_base.view(np.uint32) | 0x8000).view(np.float32)
    bf = np.resize(np.concatenate([bf_base, bf_ties]), B).astype(np.float32)
    return np.stack([ties, np.zeros(B, np.float32), clip, bf])


def _blocks(seed=0):
    """(NB + 4, 128) f32: random blocks plus the edge blocks."""
    rnd = _vec(NB * B, seed).reshape(NB, B)
    return np.concatenate([rnd, _special_blocks()]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _np(x):
    """numpy view of a jax or torch array; bf16 as raw int16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16).astype(np.int16) if a.dtype.itemsize == 2 and a.dtype != np.int16 else a


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def test_quant_i8_bitwise_vs_reference_kernel_and_oracle():
    x = _blocks()
    q, s = T_ops.quant_i8(_t(x))
    qk, sk = R_k.quant_i8(jnp.asarray(x), interpret=True)
    qr, sr = R_ref.quant_i8_block(jnp.asarray(x.reshape(-1)))
    assert q.dtype == torch.int8 and s.shape == (x.shape[0], 1)
    for a, b in ((q, qk), (s, sk), (q.reshape(-1), qr), (s, sr)):
        _eq(a, b)
    # the edges really are edges: ties of both parities, the floor, the clip
    np.testing.assert_array_equal(q[NB, 1:21].numpy(), np.round(np.arange(-10, 10) + 0.5))
    assert float(s[NB + 1]) == np.float32(np.float32(1e-30) * T_ref.INV127)
    assert q[NB + 2].min() == -127 and q[NB + 2].max() == 127


def test_hop_add_quant_i8_bitwise_vs_oracle_one_quantum_vs_kernel():
    x, a = _blocks(1), _blocks(2)
    q, s = R_k.quant_i8(jnp.asarray(x), interpret=True)
    q2, s2 = T_ops.hop_add_quant_i8(_t(np.asarray(q)), _t(np.asarray(s)), _t(a))
    qr, sr = R_ref.hop_add_quant_i8_block(q.reshape(-1), s, jnp.asarray(a.reshape(-1)))
    _eq(q2.reshape(-1), qr)
    _eq(s2, sr)
    qk, sk = R_k.hop_add_quant_i8(q, s, jnp.asarray(a), interpret=True)
    np.testing.assert_allclose(s2.numpy(), np.asarray(sk), rtol=1e-6)
    diff = np.abs(q2.numpy().astype(np.int32) - np.asarray(qk, np.int32))
    assert diff.max() <= 1, f"{diff.max()} quanta from the reference kernel"


def test_hop_accum_i8_bitwise_vs_oracle_within_scale_of_kernel():
    x, a = _blocks(3), _blocks(4)
    q, s = R_k.quant_i8(jnp.asarray(x), interpret=True)
    o = T_ops.hop_accum_i8(_t(np.asarray(q)), _t(np.asarray(s)), _t(a))
    assert o.dtype == torch.float32
    _eq(o.reshape(-1), R_ref.hop_accum_i8_block(q.reshape(-1), s, jnp.asarray(a.reshape(-1))))
    ok = R_k.hop_accum_i8(q, s, jnp.asarray(a), interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ok), rtol=0, atol=float(np.max(s)))


def test_bf16_hops_bitwise_vs_reference_kernels():
    x, a = _blocks(5), _blocks(6)
    w = jnp.asarray(x).astype(jnp.bfloat16)
    tw = _t(x).to(torch.bfloat16)
    _eq(tw, w)
    _eq(T_ops.hop_add_quant_bf16(tw, _t(a)),
        R_k.hop_add_quant_bf16(w, jnp.asarray(a), interpret=True))
    _eq(T_ops.hop_accum_bf16(tw, _t(a)), R_k.hop_accum_bf16(w, jnp.asarray(a), interpret=True))
    # bf16 ties of both parities land on the sum too: f32(w) + 0 is exact,
    # so the middle hop re-rounds the tie pattern of the edge block
    ties = _special_blocks()[3:4]
    _eq(T_ops.hop_add_quant_bf16(_t(ties).to(torch.bfloat16), torch.zeros(1, B)),
        jnp.asarray(ties).astype(jnp.bfloat16))


@pytest.mark.parametrize("dp,buckets", [(1, 1), (1, 2), (2, 2), (4, 2), (8, 4)])
def test_pack_parts_ef_bitwise_vs_reference(dp, buckets):
    seg = 160
    flat = np.concatenate([_vec(dp * buckets * seg - B, 7), _special_blocks()[3]])
    ef = _vec(flat.shape[0], 8, scale=1e-3)
    parts, new_ef = T_ops.pack_parts_ef(_t(flat), _t(ef), dp, buckets)
    r_parts, r_ef = R_ops.pack_parts_ef(jnp.asarray(flat), jnp.asarray(ef), dp, buckets,
                                        interpret=True)
    assert len(parts) == buckets and all(p.dtype == torch.bfloat16 for p in parts)
    for p, r in zip(parts, r_parts):
        _eq(p, r)
    _eq(new_ef, r_ef)
    # nothing is lost: g + ef == f32(wire) + ef' exactly, element by element
    wire = T_ops.unpack_gathers([p.float() for p in parts], dp)
    np.testing.assert_array_equal((_t(flat) + _t(ef)).numpy(), (wire + new_ef).numpy())


def test_shape_polymorphic_forms_match_the_reference_ops():
    """``quant``/``hop_add_quant``/``hop_accum`` on a stacked (rows,
    members) chunk view it as (nb, 128) blocks that span members, exactly
    like the reference's ``ops``."""
    x, a = _vec(64 * 2 * 4, 9).reshape(256, 2), _vec(64 * 2 * 4, 10).reshape(256, 2)
    for compress in ("bf16", "int8"):
        q, s = T_ops.quant(_t(x), compress)
        rq, rs = R_ops.quant(jnp.asarray(x), compress, interpret=True)
        assert tuple(q.shape) == x.shape
        _eq(q, rq)
        if compress == "int8":
            _eq(s, rs)
            q2, _ = T_ops.hop_add_quant(q, s, _t(a), compress)
            rq2, _ = R_ops.hop_add_quant(rq, rs, jnp.asarray(a), compress, interpret=True)
            assert np.abs(q2.numpy().astype(np.int32) - np.asarray(rq2, np.int32)).max() <= 1
            o = T_ops.hop_accum(q, s, _t(a), compress)
            ro = R_ops.hop_accum(rq, rs, jnp.asarray(a), compress, interpret=True)
            np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=float(np.max(rs)))
        else:
            assert s is None and rs is None
            _eq(T_ops.hop_add_quant(q, None, _t(a), compress)[0],
                R_ops.hop_add_quant(rq, None, jnp.asarray(a), compress, interpret=True)[0])
            _eq(T_ops.hop_accum(q, None, _t(a), compress),
                R_ops.hop_accum(rq, None, jnp.asarray(a), compress, interpret=True))


WIRE_TABLE = [
    ((256,), torch.float32, jnp.float32, "int8"),
    ((256,), torch.float32, jnp.float32, "bf16"),
    ((256,), torch.float32, jnp.float32, None),
    ((200,), torch.float32, jnp.float32, "int8"),
    ((0,), torch.float32, jnp.float32, "bf16"),
    ((128,), torch.bfloat16, jnp.bfloat16, "int8"),
    ((64, 4), torch.float32, jnp.float32, "int8"),
    ((3, 5), torch.float32, jnp.float32, "bf16"),
]


@pytest.mark.parametrize("shape,tdt,rdt,compress", WIRE_TABLE)
def test_wire_eligible_truth_table_equals_the_reference_on_cpu(shape, tdt, rdt, compress):
    assert T_ops.wire_eligible(shape, tdt, compress) == R_ops.wire_eligible(
        shape, rdt, compress, platform="cpu")


def test_wire_eligible_drops_the_size_cap():
    # a hop chunk of 2^28 elements: the reference's accelerator rule refuses
    # it (VMEM-resident no-grid kernel), the Hopper kernels take it; both
    # agree at the cap
    n = 1 << 28
    for platform in ("gpu", "tpu"):
        assert not R_ops.wire_eligible((n,), jnp.float32, "int8", platform=platform)
        assert R_ops.wire_eligible((R_ops.MAX_WIRE_ELEMS,), jnp.float32, "int8",
                                   platform=platform)
    assert T_ops.wire_eligible((n,), torch.float32, "int8")
    assert T_ops.wire_eligible((R_ops.MAX_WIRE_ELEMS,), torch.float32, "int8")


def test_cpu_tensors_run_the_plain_hops_and_count_no_launch():
    before = [k.launches for k in T_ops.KERNELS]
    x = _t(_blocks())
    q, s = T_ops.quant_i8(x)
    T_ops.hop_add_quant_i8(q, s, x)
    T_ops.hop_accum_i8(q, s, x)
    w = x.to(torch.bfloat16)
    T_ops.hop_add_quant_bf16(w, x)
    T_ops.hop_accum_bf16(w, x)
    T_ops.pack_parts_ef(x.reshape(-1), x.reshape(-1), 4, 2)
    assert [k.launches for k in T_ops.KERNELS] == before


def test_hop_wrappers_check_what_the_kernel_takes():
    x = torch.zeros(4, B)
    q = torch.zeros(4, B, dtype=torch.int8)
    s = torch.ones(4, 1)
    with pytest.raises(ValueError, match="quant_i8"):
        T_ops.quant_i8(torch.zeros(4, 64))
    with pytest.raises(ValueError):
        T_ops.quant_i8(x.double())
    with pytest.raises(ValueError):
        T_ops.hop_add_quant_i8(q, torch.ones(3, 1), x)
    with pytest.raises(ValueError):
        T_ops.hop_accum_i8(q, s, torch.zeros(2, B))
    with pytest.raises(ValueError):
        T_ops.hop_accum_bf16(x, x)  # the wire must be bf16
    with pytest.raises(ValueError):
        T_ops.pack_transposed_ef(torch.zeros(8, 4), torch.zeros(8, 5), 4, 2)
    # a device with no kernel and no plain version raises, never substitutes
    with pytest.raises(ValueError, match="CUDA or CPU"):
        T_ops.quant_i8(torch.zeros(4, B, device="meta"))


@pytest.mark.parametrize("name", ["pack_transposed_ef", "quant_i8", "hop_add_quant_i8",
                                  "hop_accum_i8", "hop_add_quant_bf16", "hop_accum_bf16"])
def test_registry_holds_each_new_kernel_by_device(name):
    assert T_kernels.resolve(f"ring_wire.{name}", "cpu") == ("torch", getattr(T_ref, name))
    assert T_kernels.resolve(f"ring_wire.{name}", "cuda") == (
        "cuda", getattr(T_ops, f"launch_{name}"))
    # the CUDA launch refuses a CPU tensor rather than passing a host pointer
    launch = getattr(T_ops, f"launch_{name}")
    args = {"pack_transposed_ef": (torch.zeros(8, 4), torch.zeros(8, 4), 4, 2),
            "quant_i8": (torch.zeros(2, B),),
            "hop_add_quant_i8": (torch.zeros(2, B, dtype=torch.int8), torch.ones(2, 1),
                                 torch.zeros(2, B)),
            "hop_accum_i8": (torch.zeros(2, B, dtype=torch.int8), torch.ones(2, 1),
                             torch.zeros(2, B)),
            "hop_add_quant_bf16": (torch.zeros(2, B, dtype=torch.bfloat16), torch.zeros(2, B)),
            "hop_accum_bf16": (torch.zeros(2, B, dtype=torch.bfloat16), torch.zeros(2, B))}
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch(*args[name])


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions (skip here)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py "
                    "or pytest -m cuda tests/test_torch_ring_wire_hops.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_hop_kernels_bitwise_vs_plain(cuda_device, offset):
    """offset 1: buffers 4 bytes off 16-byte alignment (the scalar path)."""
    def dev(a):
        buf = torch.zeros(a.size + offset, dtype=torch.float32, device=cuda_device)
        buf[offset:] = _t(a.reshape(-1)).to(cuda_device)
        return buf[offset:].view(a.shape)

    x, a = dev(_blocks(11)), dev(_blocks(12))
    before = [k.launches for k in T_ops.KERNELS]
    q, s = T_ops.quant_i8(x)
    qr, sr = T_ref.quant_i8(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    q2, s2 = T_ops.hop_add_quant_i8(q, s, a)
    q2r, s2r = T_ref.hop_add_quant_i8(q, s, a)
    assert torch.equal(q2, q2r) and torch.equal(s2, s2r)
    assert torch.equal(T_ops.hop_accum_i8(q, s, a), T_ref.hop_accum_i8(q, s, a))
    w = x.to(torch.bfloat16)
    assert torch.equal(T_ops.hop_add_quant_bf16(w, a), T_ref.hop_add_quant_bf16(w, a))
    assert torch.equal(T_ops.hop_accum_bf16(w, a), T_ref.hop_accum_bf16(w, a))
    assert [k.launches for k in T_ops.KERNELS][3:] == [b + 1 for b in before[3:]]


@pytest.mark.cuda
@pytest.mark.parametrize("dp,buckets", [(1, 1), (1, 2), (4, 2), (8, 4)])
def test_cuda_pack_ef_bitwise_vs_plain(cuda_device, dp, buckets):
    for seg in (12, 1001):
        g = _t(_vec(dp * buckets * seg, 13)).to(cuda_device).view(dp * buckets, seg)
        e = _t(_vec(dp * buckets * seg, 14, 1e-3)).to(cuda_device).view(dp * buckets, seg)
        w, ef = T_ops.pack_transposed_ef(g, e, dp, buckets)
        wr, efr = T_ref.pack_transposed_ef(g, e, dp, buckets)
        assert torch.equal(w, wr) and torch.equal(ef, efr)
