"""The port's WKV6 scan against the reference, on the CPU.

Same inputs (numpy, seeded) through both packages.  The reference's
``wkv6_apply`` runs its Pallas kernel in interpret mode, as its own tests
run it; the port's runs its plain version (``ref.wkv6``, the chunked form
from a zero state), which is what a CPU tensor resolves to.  The CUDA
kernel is held to that plain version by the ``cuda``-marked tests at the
end (skipped without a card) and by ``chip_smoke.py`` on the card.

Tolerances (atol = rtol): the reference's (``tests/test_kernels.py``),
5e-4 against the sequential oracle ``wkv6_ref`` and against the Pallas
kernel, 3e-4 against the chunked form; the port's twins of the
reference's own functions (its oracle, ``wkv6_chunked`` with a state,
``wkv6_step``) at 2e-5: the same float32 arithmetic summed in another
order.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.rwkv6_scan.ops import wkv6_apply as r_wkv6_apply
from repro.kernels.rwkv6_scan.ref import wkv6_ref as r_wkv6_ref
from repro.models.rwkv import wkv6_chunked as r_wkv6_chunked
from repro.models.rwkv import wkv6_step as r_wkv6_step

from repro_torch import kernels as T_kernels
from repro_torch.kernels import _build as T_build
from repro_torch.kernels.mamba2_ssd import ops as T_ssd_ops
from repro_torch.kernels.rwkv6_scan import ops as T_ops
from repro_torch.kernels.rwkv6_scan import ref as T_ref
from repro_torch.models import rwkv as t_rwkv

from _torch_tf32 import TF32_TOP, _tf32, _tf32_product

# the reference's sweep (tests/test_kernels.py:WKV_SWEEP)
WKV_SWEEP = [
    # B, T, H, N, chunk
    (2, 64, 3, 8, 16),
    (1, 128, 2, 16, 32),
    (2, 96, 1, 32, 32),
    (1, 64, 4, 64, 16),
]


def _inputs(B, T, H, N, dist="sweep", seed=0):
    """r, k, v (B, T, H, N) N(0, 1); wlog on the sweep's distribution
    (-exp(N(0, 0.5)) clamped to [-5, -1e-4]) or on the models' at init
    (w0 = -2 plus a small adapter term: -exp(-2 + N(0, 0.1))); u N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32) for _ in range(3))
    z = rng.standard_normal((B, T, H, N))
    wlog = -np.exp(0.5 * z) if dist == "sweep" else -np.exp(-2.0 + 0.1 * z)
    wlog = np.clip(wlog, -5.0, -1e-4).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32)
    return r, k, v, wlog, u


def _flat(x: np.ndarray) -> np.ndarray:
    """(B, T, H, N) -> (B*H, T, N), the reference kernel's layout."""
    B, T, H, N = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, T, N)


def _oracle(r, k, v, wlog, u, fn):
    """A sequential oracle (the reference's or the port's) in model layout."""
    B, T, H, N = r.shape
    uf = np.tile(u[None], (B, 1, 1)).reshape(B * H, N)
    if fn is r_wkv6_ref:
        out = np.asarray(r_wkv6_ref(*(jnp.asarray(_flat(a)) for a in (r, k, v, wlog)),
                                    jnp.asarray(uf)))
    else:
        out = T_ref.wkv6_ref(*(torch.from_numpy(_flat(a)) for a in (r, k, v, wlog)),
                             torch.from_numpy(uf)).numpy()
    return out.reshape(B, H, T, N).transpose(0, 2, 1, 3)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("B,T,H,N,chunk", WKV_SWEEP)
def test_wkv6_apply_matches_reference_sweep(B, T, H, N, chunk):
    """The port's wrapper (plain version on the CPU) against the reference's
    Pallas kernel and its oracle; the port's oracle against the reference's."""
    args = _inputs(B, T, H, N)
    before = T_ops.wkv6_apply.launches
    got = T_ops.wkv6_apply(*_t(*args), chunk=chunk)
    assert T_ops.wkv6_apply.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, H, N)
    pallas = np.asarray(r_wkv6_apply(*map(jnp.asarray, args), chunk=chunk, interpret=True))
    oracle = _oracle(*args, r_wkv6_ref)
    np.testing.assert_allclose(got.numpy(), pallas, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(_oracle(*args, T_ref.wkv6_ref), oracle, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,T,H,N,chunk", WKV_SWEEP)
def test_wkv6_plain_matches_oracle_on_the_models_decays(B, T, H, N, chunk):
    args = _inputs(B, T, H, N, dist="model", seed=1)
    got = T_ref.wkv6(*_t(*args), chunk=chunk).numpy()
    np.testing.assert_allclose(got, _oracle(*args, r_wkv6_ref), atol=5e-4, rtol=5e-4)


def test_wkv6_matches_model_chunked():
    """Kernel function == the reference model's chunked form from a zero
    state (the reference's shape and tolerance)."""
    B, T, H, N, chunk = 2, 64, 2, 16, 16
    args = _inputs(B, T, H, N, seed=2)
    want, _ = r_wkv6_chunked(*map(jnp.asarray, args), jnp.zeros((B, H, N, N)), chunk)
    np.testing.assert_allclose(T_ops.wkv6_apply(*_t(*args), chunk=chunk).numpy(),
                               np.asarray(want), atol=3e-4, rtol=3e-4)


def test_chunked_and_step_twins_carry_a_state_as_the_reference():
    """``wkv6_chunked`` from a nonzero state (y and the final state) and
    ``wkv6_step`` equal the reference's; stepping T times equals the
    chunked form."""
    B, T, H, N, chunk = 2, 32, 2, 8, 8
    r, k, v, wlog, u = _inputs(B, T, H, N, seed=3)
    s0 = np.random.default_rng(4).standard_normal((B, H, N, N)).astype(np.float32)
    y_r, s_r = r_wkv6_chunked(*map(jnp.asarray, (r, k, v, wlog, u, s0)), chunk)
    y_t, s_t = t_rwkv.wkv6_chunked(*_t(r, k, v, wlog, u, s0), chunk)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), atol=2e-5, rtol=2e-5)
    state, ys = torch.from_numpy(s0), []
    for t in range(T):
        y1, state = t_rwkv.wkv6_step(*(torch.from_numpy(a[:, t]) for a in (r, k, v, wlog)),
                                     torch.from_numpy(u), state)
        ys.append(y1)
    want1, _ = r_wkv6_step(*(jnp.asarray(a[:, 0]) for a in (r, k, v, wlog)), jnp.asarray(u),
                           jnp.asarray(s0))
    np.testing.assert_allclose(ys[0].numpy(), np.asarray(want1), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_t.numpy(), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(state.numpy(), s_t.numpy(), atol=3e-4, rtol=3e-4)


def test_registry_resolves_wkv6_by_device():
    assert T_kernels.resolve("rwkv6_scan", "cpu") == ("torch", T_ref.wkv6)
    assert T_kernels.resolve("rwkv6_scan", "cuda") == ("cuda", T_ops.launch_wkv6)
    with pytest.raises(ValueError):
        T_kernels.resolve("rwkv6_scan", "meta")
    # the CUDA launch refuses a CPU tensor rather than passing it a host pointer
    r, k, v, wlog, u = _t(*_inputs(1, 16, 1, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        T_ops.launch_wkv6(r, k, v, wlog, u, chunk=16)


@pytest.mark.parametrize("shape,u_shape,chunk,dtype,what", [
    ((1, 48, 2, 8), (2, 8), 32, torch.float32, "multiple of chunk"),    # T % chunk
    ((1, 64, 1, 72), (1, 72), 16, torch.float32, r"\[1, 64\]"),          # N past smem
    ((1, 128, 1, 8), (1, 8), 128, torch.float32, r"\[1, 64\]"),         # chunk past smem
    ((1, 64, 2, 8), (1, 8), 16, torch.float32, r"u \(H, N\)"),           # u per head
    ((1, 64, 2, 8), (2, 8), 16, torch.int32, "floating"),
])
def test_wkv6_refuses_what_the_kernel_does_not_take(shape, u_shape, chunk, dtype, what):
    r = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=what):
        T_ops.wkv6_apply(r, r, r, r, torch.zeros(u_shape, dtype=dtype), chunk=chunk)


def _jax_grads(args, cot, chunk):
    """``jax.grad`` of the reference's ``wkv6_chunked`` from a zero state
    under the cotangent ``cot``, for r, k, v, wlog and u."""
    B, _, H, N = args[0].shape

    def f(*a):
        y, _ = r_wkv6_chunked(*a, jnp.zeros((B, H, N, N), jnp.float32), chunk)
        return jnp.sum(y * cot)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2, 3, 4))(*args)]


def _port_grads(args, cot, chunk, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in args]
    y = T_ops.wkv6_apply(*ts, chunk=chunk)
    return ts, torch.autograd.grad(y, ts, torch.from_numpy(cot))


def _rel_close(got, want, rel=1e-4):
    """Within ``rel`` of the reference, relative to its largest entry."""
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


def test_backward_through_wkv6_raises():
    """The name is the earlier slice's, when the backward raised.  Now the
    backward recomputes the plain chunked form: a gradient reaches bf16
    inputs in their dtype (the cast is outside the autograd function) and
    equals the gradient of the same inputs in float32."""
    args = _inputs(1, 32, 2, 8)
    cot = np.random.default_rng(1).standard_normal((1, 32, 2, 8)).astype(np.float32)
    half, gh = _port_grads(args, cot, 16, torch.bfloat16)
    assert all(t.dtype == g.dtype == torch.bfloat16 for t, g in zip(half, gh))
    _, gf = _port_grads([t.detach().float().numpy() for t in half], cot, 16)
    for a, b in zip(gh, gf):
        torch.testing.assert_close(a, b.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("B,T,H,N,chunk", WKV_SWEEP)
def test_wkv6_gradient_matches_jax_grad_of_the_reference(B, T, H, N, chunk):
    """The autograd function's backward (the plain form's gradient, on the
    CPU under the plain forward) against ``jax.grad`` of the reference's
    ``wkv6_chunked``, a random cotangent, every input, 1e-4 relative."""
    args = _inputs(B, T, H, N, dist="model")
    cot = np.random.default_rng(2).standard_normal((B, T, H, N)).astype(np.float32)
    want = _jax_grads(args, cot, chunk)
    _, got = _port_grads(args, cot, chunk)
    for name, g, w in zip("r k v wlog u".split(), got, want):
        assert g.shape == w.shape, name
        _rel_close(g.numpy(), w)


# ---------------------------------------------------------------------------
# the tensor-core kernel's sources and arithmetic, checked on the CPU
# ---------------------------------------------------------------------------
def test_wkv6_sources_are_the_tensor_core_kernel():
    """The wrapper builds one source, the 3xTF32 wgmma kernel, and launches
    the entry point it defines; the CUDA-core ``wkv6.cu`` is gone."""
    assert [p.name for p in T_ops.SOURCES] == ["wkv6_wgmma.cu"]
    src = T_ops.SOURCES[0].read_text()
    assert f'extern "C" int {T_ops.ENTRY}(' in src
    assert '#include "tf32_wgmma.cuh"' in src
    header = (T_build.INCLUDE_DIR / "tf32_wgmma.cuh").read_text()
    for shape in ("m64n32k8", "m64n64k8"):
        assert f"wgmma.mma_async.sync.aligned.{shape}.f32.tf32.tf32" in header
    assert not (T_ops.SOURCES[0].parent / "wkv6.cu").exists()


def test_build_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """Both scan kernels include the shared header, and an edited header
    names another library, so a stale build is never loaded."""
    for ops in (T_ops, T_ssd_ops):
        assert '#include "tf32_wgmma.cuh"' in ops.SOURCES[0].read_text()
    assert T_build.INCLUDE_DIR / "tf32_wgmma.cuh" in T_build.headers()
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(T_build, "INCLUDE_DIR", tmp_path)
    before = T_build.library_path("k", [src])
    assert T_build.library_path("k", [src]) == before
    header.write_text("// two\n")
    assert T_build.library_path("k", [src]) != before


def test_tf32_split_keeps_non_finite_values():
    """The split's hi term, which the emulations round with: the card's NaN
    (0x7fffffff, which rounding to nearest in integers would carry into the
    sign bit as -0) stays NaN, infinities stay infinite, and the top of the
    finite range is truncated instead of rounded to infinity; the header's
    threshold is the emulation's.  A NaN that the wkv6 kernel's products
    make, 0 * inf or inf - inf where the factorised form overflows, so stays
    non-finite through the split of A for the last product."""
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7FC00000, 0x7F800000, 0xFF800000 - (1 << 32),
                         0x7F7FFFFF, 0x7F7FF000, 0x7F7FEFFF, 0x3F801000],
                        dtype=torch.int64).to(torch.int32)
    want = torch.tensor([0x7FFFE000, 0xFFFFE000 - (1 << 32), 0x7FC00000, 0x7F800000,
                         0xFF800000 - (1 << 32), 0x7F7FE000, 0x7F7FE000, 0x7F7FE000, 0x3F802000],
                        dtype=torch.int64).to(torch.int32)
    got = _tf32(bits.view(torch.float32))
    assert got.view(torch.int32).tolist() == want.tolist()
    assert torch.isnan(got[:3]).all() and torch.isinf(got[3:5]).all()
    assert torch.isfinite(got[5:]).all()
    header = (T_build.INCLUDE_DIR / "tf32_wgmma.cuh").read_text()
    top = re.search(r"constexpr float kTf32Top = (\S+)f;", header)
    assert top and float.fromhex(top.group(1)) == TF32_TOP
    assert "fabsf(a) < kTf32Top ? tf32_rna(a) : __float_as_uint(a) & 0xffffe000u" in header
    # the wkv6 kernel keeps the screen (the default) at every split
    src = T_ops.SOURCES[0].read_text()
    assert "split" in src and "false>" not in src


def _wkv6_tf32_emulation(r, k, v, wlog, u, *, chunk: int, terms: int):
    """The kernel's arithmetic in plain torch: the chunked form from a zero
    state with each of the four products on TF32 operands; q~'s exponent
    the step before's la; the bonus d on the diagonal of the masked
    q~ k~^T, S q~ and M v summed into one output, the state's update in f32
    around a fresh product."""
    B, T, H, N = r.shape
    S = torch.zeros((B, H, N, N))
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril(-1)
    eye = torch.eye(chunk, dtype=torch.bool)
    ys = []
    for c0 in range(0, T, chunk):
        rc, kc, vc, wc = (x[:, c0:c0 + chunk].transpose(1, 2) for x in (r, k, v, wlog))
        la = torch.cumsum(wc, dim=2)                                     # (B, H, c, N)
        la_prev = torch.cat([torch.zeros_like(la[:, :, :1]), la[:, :, :-1]], dim=2)
        q_t, k_t = rc * torch.exp(la_prev), kc * torch.exp(-la)
        A = _tf32_product("bhti,bhsi->bhts", q_t, k_t, terms)
        d = (rc * (u[None, :, None, :] * kc)).sum(-1)                    # (B, H, c)
        M = torch.where(tri, A, torch.where(eye, d[..., None], 0.0))
        y = _tf32_product("bhti,bhij->bhtj", q_t, S, terms) + _tf32_product(
            "bhts,bhsj->bhtj", M, vc, terms)
        ys.append(y.transpose(1, 2))
        kk = kc * torch.exp(la[:, :, -1:] - la)
        S = torch.exp(la[:, :, -1])[..., None] * S + _tf32_product("bhti,bhtj->bhij", kk, vc,
                                                                     terms)
    return torch.cat(ys, dim=1)


@pytest.mark.parametrize("terms,inside", [(3, True), (1, False)])
@pytest.mark.parametrize("dist", ["sweep", "model"])
def test_kernel_needs_three_tf32_products(dist, terms, inside):
    """3xTF32 stays inside the card's gate (allclose at 3e-4) around the
    plain chunked form; one TF32 rounding of the operands leaves it."""
    args = _t(*_inputs(1, 256, 4, 64, dist, seed=6))
    want = T_ref.wkv6(*args, chunk=32)
    got = _wkv6_tf32_emulation(*args, chunk=32, terms=terms)
    excess = float(((got - want).abs() - 3e-4 - 3e-4 * want.abs()).max())
    assert (excess <= 0) == inside, (terms, dist, excess, float((got - want).abs().max()))


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version (skip here)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py "
                    "or pytest -m cuda tests/test_torch_wkv6.py)")
    return torch.device("cuda")


# the tensor-core kernel's edges: N and chunk not multiples of 8 (N=3: rows of
# 12 bytes), chunk 1, a single chunk (of 32 steps at N=64, of 40 at N=16),
# chunk 64 at N=64
WKV_EDGES = [(2, 48, 3, 13, 12), (1, 60, 2, 3, 5), (1, 16, 2, 8, 1), (2, 32, 3, 64, 32),
             (1, 40, 2, 16, 40), (1, 256, 2, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["sweep", "model"])
@pytest.mark.parametrize("B,T,H,N,chunk", WKV_SWEEP + WKV_EDGES + [(1, 256, 4, 64, 32)])
def test_cuda_wkv6_kernel_vs_plain(cuda_device, B, T, H, N, chunk, dist):
    args = _inputs(B, T, H, N, dist)
    dev = tuple(a.to(cuda_device) for a in _t(*args))
    before = T_ops.wkv6_apply.launches
    got = T_ops.wkv6_apply(*dev, chunk=chunk)
    assert T_ops.wkv6_apply.launches == before + 1
    want = T_ref.wkv6(*dev, chunk=chunk)
    torch.cuda.synchronize()
    # where the factorised form overflows (ROADMAP queue 3) the plain form is
    # not finite, and the kernel, which computes the same function, must not
    # be either; both gates hold at every other output
    got, want = got.cpu().numpy(), want.cpu().numpy()
    ok = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    np.testing.assert_allclose(got[ok], want[ok], atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(got[ok], _oracle(*args, T_ref.wkv6_ref)[ok], atol=5e-4, rtol=5e-4)


@pytest.mark.cuda
def test_cuda_wkv6_kernel_takes_misaligned_views(cuda_device):
    """Views 4 bytes past a 16-byte boundary: the kernel reads them 4 bytes
    at a time (its 16-byte copies need aligned rows)."""
    args = _inputs(2, 128, 3, 64, "model")
    dev = tuple(a.to(cuda_device) for a in _t(*args))
    shifted = []
    for t in dev:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        buf[1:] = t.flatten()
        shifted.append(buf[1:].view(t.shape))
    assert shifted[0].data_ptr() % 16
    got = T_ops.wkv6_apply(*shifted, chunk=32)
    want = T_ref.wkv6(*dev, chunk=32)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=3e-4, rtol=3e-4)
