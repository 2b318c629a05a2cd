"""The port's Mamba2 SSD scan against the reference, on the CPU.

Same inputs (numpy, seeded) through both packages.  The reference's
``ssd_apply`` runs its Pallas kernel in interpret mode, as its own tests
run it; the port's runs its plain version (``ref.ssd``, the chunked form
from a zero state), which is what a CPU tensor resolves to.  The CUDA
kernel is held to that plain version by the ``cuda``-marked tests at the
end (skipped without a card) and by ``chip_smoke.py`` on the card.

Tolerances (atol = rtol): the reference's (``tests/test_kernels.py``),
5e-4 against the sequential oracle ``ssd_ref`` and against the Pallas
kernel, 3e-4 against the chunked form; the port's twins of the
reference's own functions (its oracle, ``ssd_chunked`` with a state,
``ssd_step``) at 2e-5: the same float32 arithmetic summed in another
order.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.mamba2_ssd.ops import ssd_apply as r_ssd_apply
from repro.kernels.mamba2_ssd.ref import ssd_ref as r_ssd_ref
from repro.models.mamba import ssd_chunked as r_ssd_chunked
from repro.models.mamba import ssd_step as r_ssd_step

from repro_torch import kernels as T_kernels
from repro_torch.kernels import _build as T_build
from repro_torch.kernels.mamba2_ssd import ops as T_ops
from repro_torch.kernels.mamba2_ssd import ref as T_ref
from repro_torch.models import mamba as t_mamba

from _hyp import given, settings, st
from _torch_tf32 import _tf32, _tf32_product

# the reference's sweep (tests/test_kernels.py:SSD_SWEEP)
SSD_SWEEP = [
    # B, T, H, P, N, chunk
    (2, 64, 3, 4, 8, 16),
    (1, 128, 2, 16, 16, 32),
    (2, 128, 1, 32, 64, 64),
    (1, 64, 4, 64, 16, 16),
]


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _inputs(B, T, H, P, N, dist="sweep", seed=0):
    """x, B, C N(0, 1).  The sweep's distribution: dt = softplus(N(0, 1)),
    A = -exp(linspace(0, 1, H)), D = 0.5.  The models' at init:
    dt = softplus(N(0, 0.5) + log(e - 1)) (softplus of dt_bias is 1),
    A = -linspace(1, 16, H), D = 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    z = rng.standard_normal((B, T, H))
    Bm, Cm = (rng.standard_normal((B, T, N)).astype(np.float32) for _ in range(2))
    if dist == "sweep":
        dt, A, D = _softplus(z), -np.exp(np.linspace(0.0, 1.0, H)), np.full(H, 0.5)
    else:
        dt, A, D = _softplus(0.5 * z + math.log(math.e - 1)), -np.linspace(1.0, 16.0, H), np.ones(H)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return x, f32(dt), f32(A), Bm, Cm, f32(D)


def _oracle(x, dt, A, Bm, Cm, D, fn):
    """A sequential oracle (the reference's or the port's) in model layout,
    B and C broadcast to every head as the reference's wrapper does."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    flat = (x.transpose(0, 2, 1, 3).reshape(B * H, T, P), dt.transpose(0, 2, 1).reshape(B * H, T),
            np.broadcast_to(Bm[:, None], (B, H, T, N)).reshape(B * H, T, N),
            np.broadcast_to(Cm[:, None], (B, H, T, N)).reshape(B * H, T, N),
            np.tile(A, B), np.tile(D, B))
    if fn is r_ssd_ref:
        out = np.asarray(r_ssd_ref(*map(jnp.asarray, flat)))
    else:
        out = T_ref.ssd_ref(*(torch.from_numpy(np.array(a)) for a in flat)).numpy()
    return out.reshape(B, H, T, P).transpose(0, 2, 1, 3)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("B,T,H,P,N,chunk", SSD_SWEEP)
def test_ssd_apply_matches_reference_sweep(B, T, H, P, N, chunk):
    """The port's wrapper (plain version on the CPU) against the reference's
    Pallas kernel and its oracle; the port's oracle against the reference's."""
    args = _inputs(B, T, H, P, N)
    before = T_ops.ssd_apply.launches
    got = T_ops.ssd_apply(*_t(*args), chunk=chunk)
    assert T_ops.ssd_apply.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, H, P)
    pallas = np.asarray(r_ssd_apply(*map(jnp.asarray, args), chunk=chunk, interpret=True))
    oracle = _oracle(*args, r_ssd_ref)
    np.testing.assert_allclose(got.numpy(), pallas, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(_oracle(*args, T_ref.ssd_ref), oracle, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,T,H,P,N,chunk", SSD_SWEEP)
def test_ssd_plain_matches_oracle_on_the_models_decays(B, T, H, P, N, chunk):
    args = _inputs(B, T, H, P, N, dist="model", seed=1)
    got = T_ref.ssd(*_t(*args), chunk=chunk).numpy()
    np.testing.assert_allclose(got, _oracle(*args, r_ssd_ref), atol=5e-4, rtol=5e-4)


def test_ssd_matches_model_chunked():
    """Kernel function == the reference model's chunked form from a zero
    state (the reference's shape and tolerance)."""
    B, T, H, P, N, chunk = 2, 64, 2, 8, 16, 16
    args = _inputs(B, T, H, P, N, seed=2)
    want, _ = r_ssd_chunked(*map(jnp.asarray, args), jnp.zeros((B, H, P, N)), chunk)
    np.testing.assert_allclose(T_ops.ssd_apply(*_t(*args), chunk=chunk).numpy(),
                               np.asarray(want), atol=3e-4, rtol=3e-4)


def test_chunked_and_step_twins_carry_a_state_as_the_reference():
    """``ssd_chunked`` from a nonzero state (y and the final state) and
    ``ssd_step`` equal the reference's; stepping T times equals the chunked
    form."""
    B, T, H, P, N, chunk = 2, 32, 2, 4, 8, 8
    x, dt, A, Bm, Cm, D = _inputs(B, T, H, P, N, seed=3)
    s0 = np.random.default_rng(4).standard_normal((B, H, P, N)).astype(np.float32)
    y_r, s_r = r_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm, D, s0)), chunk)
    y_t, s_t = t_mamba.ssd_chunked(*_t(x, dt, A, Bm, Cm, D, s0), chunk)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), atol=2e-5, rtol=2e-5)
    state, ys = torch.from_numpy(s0), []
    for t in range(T):
        y1, state = t_mamba.ssd_step(*_t(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D), state)
        ys.append(y1)
    want1, _ = r_ssd_step(*map(jnp.asarray, (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D, s0)))
    np.testing.assert_allclose(ys[0].numpy(), np.asarray(want1), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_t.numpy(), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(state.numpy(), s_t.numpy(), atol=3e-4, rtol=3e-4)


def test_registry_resolves_ssd_by_device():
    assert T_kernels.resolve("mamba2_ssd", "cpu") == ("torch", T_ref.ssd)
    assert T_kernels.resolve("mamba2_ssd", "cuda") == ("cuda", T_ops.launch_ssd)
    with pytest.raises(ValueError):
        T_kernels.resolve("mamba2_ssd", "meta")
    # the CUDA launch refuses a CPU tensor rather than passing it a host pointer
    with pytest.raises(ValueError, match="CUDA tensors"):
        T_ops.launch_ssd(*_t(*_inputs(1, 16, 2, 4, 8)), chunk=16)


@pytest.mark.parametrize("T,H,P,N,chunk,bc_rows,dtype,what", [
    (48, 2, 4, 8, 32, 1, torch.float32, "multiple of chunk"),     # T % chunk
    (64, 2, 80, 8, 16, 1, torch.float32, r"\[1, 64\]"),           # P past smem
    (64, 2, 4, 72, 16, 1, torch.float32, r"\[1, 64\]"),           # N past smem
    (128, 2, 4, 8, 128, 1, torch.float32, r"\[1, 64\]"),          # chunk past smem
    (64, 2, 4, 8, 16, 2, torch.float32, r"B and C \(Bb, T, N\)"),  # B/C of another batch
    (64, 2, 4, 8, 16, 1, torch.int32, "floating"),
])
def test_ssd_refuses_what_the_kernel_does_not_take(T, H, P, N, chunk, bc_rows, dtype, what):
    x = torch.zeros((1, T, H, P), dtype=dtype)
    dt, a = torch.zeros((1, T, H), dtype=dtype), torch.zeros(H, dtype=dtype)
    bc = torch.zeros((bc_rows, T, N), dtype=dtype)
    with pytest.raises(ValueError, match=what):
        T_ops.ssd_apply(x, dt, a, bc, bc, a, chunk=chunk)


def _jax_grads(args, cot, chunk):
    """``jax.grad`` of the reference's ``ssd_chunked`` from a zero state
    under the cotangent ``cot``, for x, dt, A, B, C and D."""
    Bb, _, H, P = args[0].shape

    def f(x, dt, A, Bm, Cm, D):
        S0 = jnp.zeros((Bb, H, P, Bm.shape[-1]), jnp.float32)
        y, _ = r_ssd_chunked(x, dt, A, Bm, Cm, D, S0, chunk)
        return jnp.sum(y * cot)

    return [np.asarray(g) for g in jax.grad(f, argnums=tuple(range(6)))(*args)]


def _port_grads(args, cot, chunk, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in args]
    y = T_ops.ssd_apply(*ts, chunk=chunk)
    return ts, torch.autograd.grad(y, ts, torch.from_numpy(cot))


def _rel_close(got, want, rel=1e-4):
    """Within ``rel`` of the reference, relative to its largest entry."""
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


def test_backward_through_ssd_raises():
    """The name is the earlier slice's, when the backward raised.  Now the
    backward recomputes the plain chunked form: a gradient reaches bf16
    inputs in their dtype (the cast is outside the autograd function) and
    equals the gradient of the same inputs in float32."""
    args = _inputs(1, 32, 2, 4, 8)
    cot = np.random.default_rng(1).standard_normal((1, 32, 2, 4)).astype(np.float32)
    half, gh = _port_grads(args, cot, 16, torch.bfloat16)
    assert all(t.dtype == g.dtype == torch.bfloat16 for t, g in zip(half, gh))
    _, gf = _port_grads([t.detach().float().numpy() for t in half], cot, 16)
    for a, b in zip(gh, gf):
        torch.testing.assert_close(a, b.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("B,T,H,P,N,chunk", SSD_SWEEP)
def test_ssd_gradient_matches_jax_grad_of_the_reference(B, T, H, P, N, chunk):
    """The autograd function's backward (the plain form's gradient, on the
    CPU under the plain forward) against ``jax.grad`` of the reference's
    ``ssd_chunked``, a random cotangent, every input, 1e-4 relative."""
    args = _inputs(B, T, H, P, N, dist="model")
    cot = np.random.default_rng(2).standard_normal((B, T, H, P)).astype(np.float32)
    want = _jax_grads(args, cot, chunk)
    _, got = _port_grads(args, cot, chunk)
    for name, g, w in zip("x dt A B C D".split(), got, want):
        assert g.shape == w.shape, name
        _rel_close(g.numpy(), w)


# ---------------------------------------------------------------------------
# the non-finite rule of the kernel's pass after the scan
# ---------------------------------------------------------------------------
NAN_DIMS = (2, 48, 3, 4, 5, 16)   # Bb, T, H, P, N, chunk: three chunks
_NAN_SHAPES = {"x": (2, 48, 3, 4), "dt": (2, 48, 3), "B": (2, 48, 5), "C": (2, 48, 5)}


@given(st.lists(st.tuples(st.sampled_from(sorted(_NAN_SHAPES)), st.integers(0, 10**6),
                          st.sampled_from([float("nan"), float("inf"), -float("inf")])),
                min_size=1, max_size=3))
@settings(max_examples=60, deadline=None)
def test_ssd_nonfinite_mask_is_where_the_plain_form_is_not_finite(hits):
    """``ref.ssd_nonfinite_mask`` (the rule the kernel's pass applies) is
    exactly ``~isfinite(ref.ssd(...))`` with NaNs and infs drawn into x,
    dt, B and C at any positions."""
    *dims, chunk = NAN_DIMS
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a.copy()) for a in _inputs(*dims, dist="model"))
    named = {"x": x, "dt": dt, "B": Bm, "C": Cm}
    for name, at, value in hits:
        t = named[name]
        t.view(-1)[at % t.numel()] = value
    got = T_ref.ssd_nonfinite_mask(x, dt, Bm, Cm, chunk)
    want = ~torch.isfinite(T_ref.ssd(x, dt, A, Bm, Cm, D, chunk=chunk))
    assert got.shape == want.shape and bool(want.any())
    assert torch.equal(got, want), int((got ^ want).sum())


# ---------------------------------------------------------------------------
# the tensor-core kernel's arithmetic, checked on the CPU
# ---------------------------------------------------------------------------
def test_ssd_sources_are_the_tensor_core_kernel():
    """The wrapper builds one source, the 3xTF32 wgmma kernel, and launches
    the entry point it defines; its wgmma forms are in the header it
    includes."""
    assert [p.name for p in T_ops.SOURCES] == ["ssd_wgmma.cu"]
    src = T_ops.SOURCES[0].read_text()
    assert f'extern "C" int {T_ops.ENTRY}(' in src
    assert '#include "tf32_wgmma.cuh"' in src
    header = (T_build.INCLUDE_DIR / "tf32_wgmma.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in header
    assert not (T_ops.SOURCES[0].parent / "ssd.cu").exists()


def test_tf32_rounding_is_nearest_with_ties_away():
    bits = torch.tensor([0x3F800000, 0x3F800FFF, 0x3F801000, 0x3F801001, 0x3F803000,
                         0xBF801000 - (1 << 32), 0x3FFFF000, 0x00001000, 0x00000FFF, 0],
                        dtype=torch.int64).to(torch.int32)
    want = torch.tensor([0x3F800000, 0x3F800000, 0x3F802000, 0x3F802000, 0x3F804000,
                         0xBF802000 - (1 << 32), 0x40000000, 0x00002000, 0, 0],
                        dtype=torch.int64).to(torch.int32)
    got = _tf32(bits.view(torch.float32)).view(torch.int32)
    assert got.tolist() == want.tolist()
    # the low 13 bits are clear, and one rounding moves a value by at most 2^-11 of it
    a = torch.from_numpy(np.random.default_rng(5).standard_normal(4096).astype(np.float32))
    r = _tf32(a)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert float(((r - a).abs() / a.abs()).max()) <= 2.0 ** -11


def _ssd_tf32_emulation(x, dt, A, B, C, D, *, chunk: int, terms: int):
    """The kernel's arithmetic in plain torch: the chunked form from a zero
    state with each of the four products on TF32 operands; C S^T scaled by
    exp(la_t) after its product, d on M's diagonal, the state's update in
    f32 around a fresh product."""
    Bb, T, H, Pd = x.shape
    S = torch.zeros((Bb, H, Pd, B.shape[-1]))
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    d_diag = torch.eye(chunk)[..., None] * D                            # (c, c, H)
    ys = []
    for c0 in range(0, T, chunk):
        xc, dtc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]             # (Bb, c, H, P), (Bb, c, H)
        Bc, Cc = B[:, c0:c0 + chunk], C[:, c0:c0 + chunk]               # (Bb, c, N)
        la = torch.cumsum(dtc * A, dim=1)                               # (Bb, c, H)
        G = _tf32_product("btn,bsn->bts", Cc, Bc, terms)
        decay = torch.exp(torch.where(tri[..., None], la[:, :, None] - la[:, None], -torch.inf))
        M = G[..., None] * decay * dtc[:, None] + d_diag                  # (Bb, t, s, H)
        y = (torch.exp(la)[..., None] * _tf32_product("btn,bhpn->bthp", Cc, S, terms)
             + _tf32_product("btsh,bshp->bthp", M, xc, terms))
        ys.append(y)
        kf = torch.exp(la[:, -1:] - la) * dtc                           # (Bb, c, H)
        S = (torch.exp(la[:, -1])[..., None, None] * S
             + _tf32_product("bthp,bthn->bhpn", xc, Bc[:, :, None] * kf[..., None], terms))
    return torch.cat(ys, dim=1)


@pytest.mark.parametrize("terms,inside", [(3, True), (1, False)])
@pytest.mark.parametrize("dist", ["sweep", "model"])
def test_kernel_needs_three_tf32_products(dist, terms, inside):
    """3xTF32 stays inside the card's gate (allclose at 3e-4) around the
    plain chunked form; one TF32 rounding of the operands leaves it."""
    args = _t(*_inputs(1, 256, 4, 64, 64, dist, seed=6))
    want = T_ref.ssd(*args, chunk=64)
    got = _ssd_tf32_emulation(*args, chunk=64, terms=terms)
    excess = float(((got - want).abs() - 3e-4 - 3e-4 * want.abs()).max())
    assert (excess <= 0) == inside, (terms, dist, excess, float((got - want).abs().max()))


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version (skip here)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py "
                    "or pytest -m cuda tests/test_torch_ssd.py)")
    return torch.device("cuda")


# the tensor-core kernel's edges: P, N and chunk not multiples of 8 (N=3: rows
# of 12 bytes), chunk 1, a single chunk
SSD_EDGES = [(2, 24, 3, 7, 13, 8), (1, 60, 2, 5, 3, 12), (1, 16, 2, 8, 8, 1),
             (2, 64, 2, 64, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["sweep", "model"])
@pytest.mark.parametrize("B,T,H,P,N,chunk", SSD_SWEEP + SSD_EDGES + [(1, 256, 4, 64, 64, 64)])
def test_cuda_ssd_kernel_vs_plain(cuda_device, B, T, H, P, N, chunk, dist):
    args = _inputs(B, T, H, P, N, dist)
    dev = tuple(a.to(cuda_device) for a in _t(*args))
    before = T_ops.ssd_apply.launches
    got = T_ops.ssd_apply(*dev, chunk=chunk)
    assert T_ops.ssd_apply.launches == before + 1
    want = T_ref.ssd(*dev, chunk=chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(got.cpu().numpy(), _oracle(*args, T_ref.ssd_ref),
                               atol=5e-4, rtol=5e-4)


@pytest.mark.cuda
def test_cuda_ssd_kernel_takes_misaligned_views(cuda_device):
    """Views 4 bytes past a 16-byte boundary: the kernel reads 4-byte words."""
    args = _inputs(2, 128, 3, 64, 64, "model")
    dev = tuple(a.to(cuda_device) for a in _t(*args))
    shifted = []
    for t in dev:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        buf[1:] = t.flatten()
        shifted.append(buf[1:].view(t.shape))
    assert shifted[0].data_ptr() % 16
    got = T_ops.ssd_apply(*shifted, chunk=64)
    want = T_ref.ssd(*dev, chunk=64)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=3e-4, rtol=3e-4)
