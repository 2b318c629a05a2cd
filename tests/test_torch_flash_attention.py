"""The port's flash attention against the reference, on the CPU.

Same inputs (numpy, seeded) through both packages.  The reference's
``flash_mha`` runs its Pallas kernel in interpret mode, as its own tests
run it; the port's runs its plain version (``ref.attention_ref``), which
is what a CPU tensor resolves to.  The CUDA kernel is held to that plain
version by the ``cuda``-marked tests at the end (skipped without a card)
and by ``chip_smoke.py`` on the card.

Tolerances: the ``FA_SWEEP`` ones of ``tests/test_kernels.py`` (2e-5 for
float32, 2e-2 for bfloat16, where one bf16 rounding of an output near 2
is 1.6e-2) and 3e-5 for the model-level comparisons, as there.  The
whole-slice forward compares logits at 2e-5: two layers of float32
matmuls and norms summed in another order by XLA and PyTorch.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as R_Config
from repro.kernels.flash_attention.ops import flash_mha as r_flash_mha
from repro.kernels.flash_attention.ref import attention_ref as r_attention_ref
from repro.models import build_model as r_build
from repro.models import transformer as r_transformer
from repro.models.attention import attention as r_attention
from repro.models.attention import init_attention as r_init_attention

from repro_torch import kernels as T_kernels
from repro_torch.configs.base import ModelConfig as T_Config
from repro_torch.kernels.flash_attention import ops as T_ops
from repro_torch.kernels.flash_attention import ref as T_ref
from repro_torch.models import build_model as t_build
from repro_torch.models import from_jax_params
from repro_torch.models.attention import _sdpa as t_sdpa
from repro_torch.models.attention import attention as t_attention

# the reference's sweep (tests/test_kernels.py:FA_SWEEP)
FA_SWEEP = [
    # B, S, H, Hkv, D, bq, bk, causal, dtype, tol
    (2, 256, 4, 2, 64, 128, 128, True, "float32", 2e-5),
    (1, 128, 2, 2, 32, 64, 64, False, "float32", 2e-5),
    (2, 256, 8, 2, 64, 128, 64, True, "float32", 2e-5),
    (1, 256, 4, 1, 128, 64, 128, True, "float32", 2e-5),  # MQA
    (2, 192, 4, 4, 64, 64, 64, True, "float32", 2e-5),    # S%128 != 0
    (2, 256, 4, 2, 64, 128, 128, True, "bfloat16", 2e-2),
]

J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(B, S, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _kernel_layout(x: np.ndarray) -> np.ndarray:
    """(B, S, H, D) -> (B*H, S, D), the kernel's layout."""
    B, S, H, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, D)


@pytest.mark.parametrize("B,S,H,Hkv,D,bq,bk,causal,dtype,tol", FA_SWEEP)
def test_flash_mha_matches_reference_sweep(B, S, H, Hkv, D, bq, bk, causal, dtype, tol):
    q, k, v = _qkv(B, S, H, Hkv, D)
    want = r_flash_mha(*(jnp.asarray(a, J_DT[dtype]) for a in (q, k, v)), causal=causal,
                       block_q=bq, block_k=bk, interpret=True)
    got = T_ops.flash_mha(*(torch.from_numpy(a).to(T_DT[dtype]) for a in (q, k, v)),
                          causal=causal)
    assert got.dtype == T_DT[dtype] and tuple(got.shape) == (B, S, H, D)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_flash_matches_model_attention():
    """Kernel semantics == the port's own plain attention path."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 128, 4, 2, 64))
    np.testing.assert_allclose(_f32(T_ops.flash_mha(q, k, v, causal=True)),
                               _f32(t_sdpa(q, k, v, causal=True)), atol=3e-5, rtol=3e-5)


def _attention_cfgs(impl: str):
    kw = dict(name="t", family="dense", num_layers=2, d_model=128, d_ff=256, vocab_size=64,
              num_heads=4, num_kv_heads=2, param_dtype="float32", compute_dtype="float32",
              attention_impl=impl)
    return R_Config(**kw), T_Config(**kw)


def _attention_pair(impl: str, B: int, S: int):
    """One attention layer's output from both packages on the same weights."""
    rcfg, tcfg = _attention_cfgs(impl)
    params = r_init_attention(jax.random.PRNGKey(0), rcfg)
    x = np.random.default_rng(1).standard_normal((B, S, 128)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, _ = r_attention(params, jnp.asarray(x), rcfg, positions=jnp.asarray(positions))
    got = t_attention({n: torch.from_numpy(np.array(a)) for n, a in params.items()},
                      torch.from_numpy(x), tcfg, positions=torch.from_numpy(positions.copy()))
    return _f32(got), _f32(want)


def test_attention_flash_matches_xla():
    """The port's attention under "flash" against the reference's under
    "flash" (its Pallas kernel in interpret mode)."""
    got, want = _attention_pair("flash", 2, 128)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


def test_attention_blockwise_matches_reference():
    """S=1024 is two blocks of BLOCKWISE_Q=512, so the block path runs."""
    got, want = _attention_pair("blockwise", 1, 1024)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


def test_attention_rejects_an_unknown_impl():
    _, tcfg = _attention_cfgs("pallas")
    with pytest.raises(ValueError, match="attention_impl"):
        t_attention({}, torch.zeros(1, 8, 128), tcfg, positions=torch.zeros(1, 8))


@pytest.mark.parametrize("last_only", [False, True])
def test_flash_forward_slice_matches_reference(last_only):
    """Two dense layers (d 128, 4/2 heads, f32) under attention_impl="flash":
    the reference's weights through ``from_jax_params``, the same tokens,
    logits from both forwards."""
    rcfg, tcfg = _attention_cfgs("flash")
    params = r_build(rcfg).init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(2).integers(0, 64, size=(2, 128)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: r_transformer.forward(p, t, rcfg, last_only=last_only))(
        params, jnp.asarray(tokens))
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    before = T_ops.flash_attention.launches
    with torch.no_grad():
        got = t_build(tcfg).forward(model, {"tokens": torch.from_numpy(tokens)},
                                    last_only=last_only)
    assert tuple(got.shape) == (2, 1 if last_only else 128, 64)
    assert T_ops.flash_attention.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_last_only_is_the_last_row_of_the_full_forward():
    _, tcfg = _attention_cfgs("flash")
    api = t_build(tcfg)
    model = api.init(0, device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(3).integers(0, 64, size=(2, 96)).astype(np.int64))}
    with torch.no_grad():
        full = api.forward(model, batch)
        last = api.forward(model, batch, last_only=True)
    np.testing.assert_allclose(_f32(last), _f32(full[:, -1:]), atol=1e-6, rtol=1e-6)


def test_backward_through_flash_raises_as_in_the_reference():
    q, k, v = _qkv(1, 64, 2, 1, 32)
    with pytest.raises(AssertionError):
        jax.grad(lambda a: r_flash_mha(a, jnp.asarray(k), jnp.asarray(v),
                                       interpret=True).sum())(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    out = T_ops.flash_mha(tq, torch.from_numpy(k), torch.from_numpy(v))
    with pytest.raises(RuntimeError, match="defines no gradient"):
        out.sum().backward()
    # the model path under "flash" cannot train either; "xla" can
    _, tcfg = _attention_cfgs("flash")
    api = t_build(tcfg)
    model = api.init(0, device="cpu")
    tok = torch.zeros(1, 16, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="defines no gradient"):
        api.loss_fn(model, {"tokens": tok, "targets": tok}).backward()
    t_build(dataclasses.replace(tcfg, attention_impl="xla")).loss_fn(
        model, {"tokens": tok, "targets": tok}).backward()


def test_noncausal_ragged_s_keeps_padding_out_of_the_softmax():
    """A deliberate difference (ROADMAP queue 3): the reference's flash_mha
    pads S=192 to 256 with zero keys, which a non-causal softmax then
    weighs; the port masks keys past S and computes attention_ref's
    function.  Causal calls agree (the mask hides the padding)."""
    B, S, H, Hkv, D = 1, 192, 2, 1, 64
    q, k, v = _qkv(B, S, H, Hkv, D)
    oracle = _f32(r_attention_ref(*(jnp.asarray(_kernel_layout(a)) for a in (q, k, v)),
                                  causal=False))
    oracle = oracle.reshape(B, H, S, D).transpose(0, 2, 1, 3)
    ref_kernel = _f32(r_flash_mha(q, k, v, causal=False, interpret=True))
    port = _f32(T_ops.flash_mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=False))
    assert np.abs(ref_kernel - oracle).max() > 0.05   # the reference's padding shows
    np.testing.assert_allclose(port, oracle, atol=2e-5, rtol=2e-5)
    causal_ref = _f32(r_flash_mha(q, k, v, causal=True, interpret=True))
    causal_port = _f32(T_ops.flash_mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=True))
    np.testing.assert_allclose(causal_port, causal_ref, atol=2e-5, rtol=2e-5)


def test_registry_resolves_flash_by_device():
    assert T_kernels.resolve("flash_attention", "cpu") == ("torch", T_ref.attention_ref)
    assert T_kernels.resolve("flash_attention", "cuda") == ("cuda",
                                                            T_ops.launch_flash_attention)
    with pytest.raises(ValueError):
        T_kernels.resolve("flash_attention", "meta")
    # the CUDA launch refuses a CPU tensor rather than passing it a host pointer
    q = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        T_ops.launch_flash_attention(q, q[:1], q[:1])


@pytest.mark.parametrize("shapes,dtypes,what", [
    (((4, 64, 12), (2, 64, 12), (2, 64, 12)), None, "multiple of 8"),      # D % 8
    (((4, 64, 264), (2, 64, 264), (2, 64, 264)), None, "multiple of 8"),   # D > 256
    (((3, 64, 64), (2, 64, 64), (2, 64, 64)), None, "BH % BKV"),           # group
    (((4, 64, 64), (2, 32, 64), (2, 32, 64)), None, "BH % BKV"),           # S differs
    (((4, 64, 64), (2, 64, 64), (2, 64, 64)),
     (torch.float32, torch.bfloat16, torch.float32), "float32"),             # mixed dtypes
    (((4, 64, 64), (2, 64, 64), (2, 64, 64)), (torch.float16,) * 3, "float32"),
])
def test_flash_attention_refuses_what_the_kernel_does_not_take(shapes, dtypes, what):
    dtypes = dtypes or (torch.float32,) * 3
    q, k, v = (torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes))
    with pytest.raises(ValueError, match=what):
        T_ops.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# the tensor-core kernel's design, checked on the CPU
# ---------------------------------------------------------------------------
#: chip_smoke.py's gate for the full-width bf16 rows (BF16_ROUNDINGS): the
#: kernel and the plain version each round once, at the output
BF16_ROUNDINGS = (1e-5, 2.0 ** -6)


def _bf16_pv_emulation(q, k, v, *, split: bool, causal: bool = True) -> torch.Tensor:
    """The bf16 kernel's rounding in plain torch: f32 scores and p, P.V with
    p rounded to bf16 (``split``: plus the bf16 rounding of what that left
    out, both products summed in f32), the output rounded once to bf16."""
    BH, S, D = q.shape
    group = BH // k.shape[0]
    kx = k.repeat_interleave(group, dim=0).float()
    vx = v.repeat_interleave(group, dim=0).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), kx) / np.sqrt(D)
    if causal:
        s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s, T_ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p_hi = p.bfloat16().float()
    acc = p_hi @ vx
    if split:
        acc = acc + (p - p_hi).bfloat16().float() @ vx
    return (acc / p.sum(-1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("B,S,H,Hkv,D", [(1, 256, 4, 2, 64), (1, 256, 4, 4, 80)])
def test_bf16_kernel_carries_p_as_two_bf16_terms(B, S, H, Hkv, D):
    """P as bf16(p) + bf16(p - bf16(p)) stays inside the card's bf16 gate
    around the reference's attention_ref; one bf16(p) does not (its error
    scales with sum |p v|, not with the output, so outputs near zero fail)."""
    q, k, v = (_kernel_layout(a) for a in _qkv(B, S, H, Hkv, D, seed=2))
    want = _f32(r_attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    atol, rtol = BF16_ROUNDINGS
    np.testing.assert_allclose(_f32(T_ref.attention_ref(tq, tk, tv)), want, atol=atol, rtol=rtol)
    for split, passes in ((True, True), (False, False)):
        got = _f32(_bf16_pv_emulation(tq, tk, tv, split=split))
        excess = np.abs(got - want) - atol - rtol * np.abs(want)
        assert (excess.max() <= 0) == passes, (split, excess.max(), (excess > 0).sum())


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "pax_flash_attention_wgmma"),
                                         (torch.float32, "pax_flash_attention")])
def test_route_by_dtype_at_every_head_dim(dtype, entry):
    """bf16 goes to the tensor-core kernel, f32 to the CUDA-core kernel,
    whatever the head dim: the wrapper takes every multiple of 8 up to
    MAX_HEAD_DIM in both dtypes and refuses the rest; what neither kernel
    takes raises."""
    assert T_ops.route(dtype) == entry
    for D in range(8, T_ops.MAX_HEAD_DIM + 1, 8):
        q = torch.zeros(2, 1, D, dtype=dtype)
        assert T_ops.flash_attention(q, q[:1], q[:1]).shape == q.shape
    for D in (4, 12, T_ops.MAX_HEAD_DIM + 8):
        q = torch.zeros(2, 1, D, dtype=dtype)
        with pytest.raises(ValueError, match="multiple of 8"):
            T_ops.flash_attention(q, q[:1], q[:1])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        T_ops.route(torch.float16)
    assert set(T_ops.flash_attention.by_entry) == {e for e, _ in T_ops.ROUTES.values()}


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version (skip here)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py "
                    "or pytest -m cuda tests/test_torch_flash_attention.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,bq,bk,causal,dtype,tol", FA_SWEEP + [
    (1, 2000, 14, 2, 64, 128, 128, True, "bfloat16", 2e-2),   # ragged S
    (1, 192, 2, 1, 64, 128, 128, False, "float32", 2e-5),     # ragged, non-causal
    (1, 128, 2, 1, 256, 128, 128, True, "float32", 2e-5),     # the widest head
    (1, 100, 3, 1, 8, 128, 128, False, "float32", 2e-5),      # the narrowest head
])
def test_cuda_flash_kernel_vs_plain(cuda_device, B, S, H, Hkv, D, bq, bk, causal, dtype, tol):
    q, k, v = (torch.from_numpy(_kernel_layout(a)).to(cuda_device, T_DT[dtype])
               for a in _qkv(B, S, H, Hkv, D))
    before = T_ops.flash_attention.launches
    got = T_ops.flash_attention(q, k, v, causal=causal)
    assert T_ops.flash_attention.launches == before + 1
    want = T_ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_model_flash_path_launches_the_kernel(cuda_device):
    _, tcfg = _attention_cfgs("flash")
    api = t_build(tcfg)
    model = api.init(0, device=cuda_device)
    tok = torch.zeros(2, 128, dtype=torch.int64, device=cuda_device)
    before = T_ops.flash_attention.launches
    with torch.no_grad():
        flash = api.forward(model, {"tokens": tok})
        xla = t_build(dataclasses.replace(tcfg, attention_impl="xla")).forward(
            model, {"tokens": tok})
    assert T_ops.flash_attention.launches == before + tcfg.num_layers
    np.testing.assert_allclose(_f32(flash.cpu()), _f32(xla.cpu()), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal", [
    (2, 256, 4, 2, 32, True),      # D=32
    (1, 384, 4, 2, 256, True),     # D=256, one consumer warpgroup
    (2, 300, 4, 2, 40, True),      # D=40, padded to 48 by TMA's zero fill
    (1, 200, 4, 1, 72, False),     # D=72, non-causal, ragged S
    (1, 100, 3, 1, 8, False),      # D=8
    (2, 1, 4, 2, 64, True),        # S=1
    (2, 65, 4, 2, 64, True),       # S=65: one key past a tile
    (1, 333, 7, 7, 64, False),     # group 1, non-causal, ragged S
    (1, 333, 14, 2, 80, False),    # group 7, non-causal, ragged S
])
def test_cuda_wgmma_kernel_edges_vs_plain(cuda_device, B, S, H, Hkv, D, causal):
    q, k, v = (torch.from_numpy(_kernel_layout(a)).to(cuda_device, torch.bfloat16)
               for a in _qkv(B, S, H, Hkv, D))
    before = T_ops.flash_attention.by_entry["pax_flash_attention_wgmma"]
    got = T_ops.flash_attention(q, k, v, causal=causal)
    assert T_ops.flash_attention.by_entry["pax_flash_attention_wgmma"] == before + 1
    want = T_ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    atol, rtol = BF16_ROUNDINGS
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_wgmma_kernel_takes_misaligned_views(cuda_device):
    """TMA needs 16-byte aligned bases: views 2 bytes past one are copied."""
    q, k, v = (torch.from_numpy(_kernel_layout(a)).to(cuda_device, torch.bfloat16)
               for a in _qkv(1, 130, 4, 2, 64))
    shifted = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        buf[1:] = t.flatten()
        shifted.append(buf[1:].view(t.shape))
    assert shifted[0].data_ptr() % 16
    got = T_ops.flash_attention(*shifted)
    want = T_ref.attention_ref(q, k, v)
    torch.cuda.synchronize()
    atol, rtol = BF16_ROUNDINGS
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), atol=atol, rtol=rtol)
