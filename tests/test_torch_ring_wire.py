"""The zero1 wire-layout kernels of the port against the reference.

On the CPU the wrappers run their plain versions (the tensors lie on the
CPU); those must be bitwise equal to the reference's Pallas kernels in
interpret mode and to its ``grad_sync`` layout helpers, over the
``(dp, buckets, wire)`` cases of ``tests/test_wire_kernels.py``.  The CUDA
kernels themselves are held bitwise against the plain versions on the card
(the ``cuda``-marked tests here, and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ring_wire import ops as R_ops
from repro.train import grad_sync as R_gs
from repro_torch import kernels as T_kernels
from repro_torch.kernels.ring_wire import ops as T_ops
from repro_torch.kernels.ring_wire import ref as T_ref
from repro_torch.train import grad_sync as T_gs

CASES = [(2, 1, "float32"), (2, 2, "float32"), (4, 2, "bfloat16"), (8, 4, "bfloat16")]
#: plus the reference's own unpack case (``test_unpack_gathers_inverts_pack``)
UNPACK_CASES = CASES + [(4, 4, "float32")]
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
R_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _vec(n, seed=7, scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _bits(x):
    """Raw bits of a jax/numpy or torch array (bitwise comparison for bf16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(x)
    return a.view(np.uint16).astype(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dp,buckets,wire", CASES)
def test_pack_parts_matches_reference(dp, buckets, wire):
    padded = dp * buckets * 12
    flat = _vec(padded)
    ref_kernel = R_ops.pack_parts(jnp.asarray(flat), dp, buckets, R_DT[wire], interpret=True)
    ref_helper = R_gs._transposed_bucket_parts(jnp.asarray(flat).astype(R_DT[wire]), dp, buckets)
    port = T_ops.pack_parts(torch.from_numpy(flat), dp, buckets, T_DT[wire])
    assert len(port) == buckets
    for p, rk, rh in zip(port, ref_kernel, ref_helper):
        assert p.dtype == T_DT[wire]
        np.testing.assert_array_equal(_bits(p), _bits(rk))
        np.testing.assert_array_equal(_bits(p), _bits(rh))


@pytest.mark.parametrize("dp,buckets,wire", UNPACK_CASES)
def test_unpack_gathers_matches_reference(dp, buckets, wire):
    padded = dp * buckets * 16
    flat = _vec(padded, seed=11)
    ref_parts = R_ops.pack_parts(jnp.asarray(flat), dp, buckets, R_DT[wire], interpret=True)
    ref_back = R_ops.unpack_gathers(ref_parts, dp, interpret=True)
    ref_helper = R_gs._interleave_bucket_gathers(ref_parts, dp)
    parts = T_ops.pack_parts(torch.from_numpy(flat), dp, buckets, T_DT[wire])
    back = T_ops.unpack_gathers(parts, dp)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref_back))
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref_helper, np.float32))
    if wire == "float32":  # lossless wire: the round trip is the identity
        np.testing.assert_array_equal(back.numpy(), flat)


@pytest.mark.parametrize("dp,buckets", [(1, 1), (2, 3), (4, 2)])
def test_port_layout_helpers_match_reference(dp, buckets):
    """The port builds the zero1 bucket layout only through the kernel
    wrappers: they equal the reference's ``grad_sync`` layout helpers."""
    flat = _vec(dp * buckets * 10, seed=3)
    rp = R_gs._transposed_bucket_parts(jnp.asarray(flat), dp, buckets)
    tp = T_ops.pack_parts(torch.from_numpy(flat), dp, buckets, torch.float32)
    for a, b in zip(tp, rp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        T_ops.unpack_gathers(tp, dp).numpy(),
        np.asarray(R_gs._interleave_bucket_gathers(rp, dp)))


@pytest.mark.parametrize("use_plans", [True, False])
def test_zero1_legs_build_buckets_through_the_wrappers(monkeypatch, use_plans):
    """With or without persistent plans, the reduce-scatter leg packs and
    the all-gather leg unpacks through the kernel wrappers (world of one,
    gloo: both legs return their input)."""
    from repro_torch.runtime.dist import make_dist

    dist = make_dist(device="cpu")
    calls = []
    for name in ("pack_parts", "unpack_gathers"):
        real = getattr(T_ops, name)
        monkeypatch.setattr(T_ops, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    plans = T_gs.build_zero1_plans(dist, 48, buckets=2) if use_plans else None
    flat = torch.from_numpy(_vec(48, seed=9))
    try:
        pending, ef = T_gs.reduce_scatter_grads_start(dist, flat, buckets=2, plans=plans)
        assert pending.mode == ("group" if use_plans else "pooled") and ef is None
        shard = T_gs.reduce_scatter_grads_finish(pending)
        back = T_gs.allgather_params(dist, shard, buckets=2, plans=plans)
    finally:
        if plans is not None:
            plans.free()
    assert calls == ["pack_parts", "unpack_gathers"]
    assert torch.equal(shard, flat) and torch.equal(back, flat)


def test_zero1_plans_record_the_variant_and_refuse_other_devices():
    from repro_torch.runtime.dist import make_dist

    plans = T_gs.build_zero1_plans(make_dist(device="cpu"), 48, buckets=2)
    try:
        assert plans.wire_kernel == "torch"
        with pytest.raises(ValueError):
            plans.pack(torch.zeros(48, device="meta"))
        with pytest.raises(ValueError, match="does not split"):
            T_gs.build_zero1_plans(make_dist(device="cpu"), 50, buckets=4)
    finally:
        plans.free()


def test_bf16_wire_rounds_to_nearest_even_like_the_reference():
    # exact ties between two bf16 values, both parities, plus specials
    base = np.array([1.0, 1.0078125, -3.0, 65504.0, 1e-38, 3e38], np.float32)
    ties = (base.view(np.uint32) | 0x8000).view(np.float32)
    x = np.concatenate([base, ties, _vec(116, seed=5)]).astype(np.float32)
    port = T_ref.pack_transposed(torch.from_numpy(x).view(1, -1), 1, 1, torch.bfloat16)
    ref = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(port.reshape(-1)), _bits(ref))


def test_pack_eligible_keeps_divisibility_and_drops_the_size_cap():
    assert T_ops.pack_eligible(24, 4, 2)
    assert not T_ops.pack_eligible(25, 4, 2)
    assert not T_ops.pack_eligible(0, 1, 1)
    assert not T_ops.pack_eligible(24, 0, 1)
    # full-width qwen2-0.5b flat gradient: the reference's accelerator rule
    # refuses it (VMEM-resident no-grid kernel), the Hopper kernel takes it
    padded = 494_032_768
    assert not R_ops.pack_eligible(padded, 1, 1, platform="gpu")
    assert T_ops.pack_eligible(padded, 1, 1)
    for p, dp, b in [(24, 4, 2), (25, 4, 2), (96, 8, 4), (4 * 2**20 + 8, 8, 1)]:
        assert T_ops.pack_eligible(p, dp, b) == R_ops.pack_eligible(p, dp, b, platform="cpu")


def test_wrappers_check_what_the_kernel_takes():
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="float32"):
        T_ops.pack_transposed(x.double(), 4, 2, torch.float32)
    with pytest.raises(ValueError):
        T_ops.pack_transposed(x, 3, 2, torch.float32)
    with pytest.raises(ValueError, match="wire dtype"):
        T_ops.pack_transposed(x, 4, 2, torch.float16)
    with pytest.raises(ValueError):
        T_ops.unpack_transposed(torch.zeros(2, 3, 4, dtype=torch.int32))
    # a device with no kernel and no plain version raises, never substitutes
    with pytest.raises(ValueError, match="CUDA or CPU"):
        T_ops.pack_transposed(torch.zeros(8, 4, device="meta"), 4, 2, torch.float32)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    before = (T_ops.pack_transposed.launches, T_ops.unpack_transposed.launches)
    parts = T_ops.pack_parts(torch.from_numpy(_vec(48)), 4, 2, torch.float32)
    T_ops.unpack_gathers(parts, 4)
    assert (T_ops.pack_transposed.launches, T_ops.unpack_transposed.launches) == before


def test_registry_picks_the_variant_by_device():
    assert T_kernels.variant_for("cpu") == "torch"
    assert T_kernels.variant_for("cuda") == "cuda"
    assert T_kernels.variant_for(torch.device("cuda", 1)) == "cuda"
    # one layer chooses: the plain version for CPU tensors, the launch for CUDA
    for name, plain, launch in (
            ("ring_wire.pack_transposed", T_ref.pack_transposed, T_ops.launch_pack_transposed),
            ("ring_wire.unpack_transposed", T_ref.unpack_transposed,
             T_ops.launch_unpack_transposed)):
        assert T_kernels.resolve(name, "cpu") == ("torch", plain)
        assert T_kernels.resolve(name, "cuda") == ("cuda", launch)
    with pytest.raises(LookupError):  # a name with no registered variant
        T_kernels.resolve("no_such_kernel", "cpu")
    with pytest.raises(ValueError):
        T_kernels.variant_for("meta")
    with pytest.raises(ValueError):
        T_kernels.register("x", "pallas", "mod:attr")
    # the CUDA launch refuses a CPU tensor rather than passing it a host pointer
    with pytest.raises(ValueError, match="CUDA tensors"):
        T_ops.launch_pack_transposed(torch.zeros(8, 4), 4, 2, torch.float32)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions (skip here)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py "
                    "or pytest -m cuda tests/test_torch_ring_wire.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dp,buckets,wire", CASES)
@pytest.mark.parametrize("seg", [12, 1001])
def test_cuda_kernels_bitwise_vs_plain(cuda_device, dp, buckets, wire, seg):
    x = torch.from_numpy(_vec(dp * buckets * seg)).to(cuda_device).view(dp * buckets, seg)
    before = T_ops.pack_transposed.launches
    k = T_ops.pack_transposed(x, dp, buckets, T_DT[wire])
    assert T_ops.pack_transposed.launches == before + 1
    assert torch.equal(k, T_ref.pack_transposed(x, dp, buckets, T_DT[wire]))
    assert torch.equal(T_ops.unpack_transposed(k), T_ref.unpack_transposed(k))
