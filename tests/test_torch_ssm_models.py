"""The port's ssm (rwkv6) and hybrid (Mamba2 + shared attention) families
against the reference, on the CPU.

The reference's weights go through ``from_jax_params`` into the port; the
same tokens (numpy, seeded) go through both forwards.  On the CPU the
port's time-mix and Mamba2 block run the plain versions of the WKV6 and SSD
kernels (the kernel registry's ``torch`` variant), the reference its lax
chunked forms, and under ``attention_impl="flash"`` the reference's
Pallas flash kernel runs in interpret mode.  Before the comparisons the
constant-initialised leaves (token-shift mixes, norms, ``w0``, ``u``,
``A_log``, ``D``, ``dt_bias``, biases) are perturbed, so that every term
of the forward carries weight.

Tolerances: the blocks (``time_mix``, ``mamba_block``) at 2e-5 and the
logits of the two smoke configs' full forwards at 2e-5 (atol = rtol):
float32 matrix products, norms and the chunked scans summed in another
order by XLA and PyTorch (measured below 1e-5 on logits of magnitude
about 4).
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as R_cfgs
from repro.models import build_model as r_build
from repro.models import hybrid as r_hybrid
from repro.models import mamba as r_mamba
from repro.models import rwkv as r_rwkv
from repro.models.model import analytic_param_count as r_param_count

import repro_torch.configs as T_cfgs
from repro_torch.kernels.flash_attention import ops as T_fa_ops
from repro_torch.kernels.mamba2_ssd import ops as T_ssd_ops
from repro_torch.kernels.rwkv6_scan import ops as T_wkv_ops
from repro_torch.models import analytic_param_count as t_param_count
from repro_torch.models import build_model as t_build
from repro_torch.models import from_jax_params, param_leaves
from repro_torch.models import mamba as t_mamba
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models.model import _family

ARCHS = ("rwkv6-7b", "zamba2-2.7b")
R_FORWARD = {"rwkv6-7b": r_rwkv.forward, "zamba2-2.7b": r_hybrid.forward}
#: leaves that the reference initialises to constants
CONSTANT_LEAVES = {"scale", "bias", "mu_base", "mu", "cm_mu_k", "cm_mu_r", "w0", "u",
                   "A_log", "D", "dt_bias", "conv_b"}
TOL = 2e-5
#: gradients relative to each leaf's largest entry: the loss's reassociation
#: error carried back through the backward's products
GRAD_TOL = 1e-4


def _perturbed(params, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if path[-1].key in CONSTANT_LEAVES:
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def _reference_init(arch):
    """The reference's smoke-config weights from key 0, as numpy."""
    params = jax.jit(r_build(R_cfgs.smoke_config(arch)).init)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _reference(arch, impl="xla"):
    """(reference config, port config, perturbed reference weights as numpy)."""
    rcfg = dataclasses.replace(R_cfgs.smoke_config(arch), attention_impl=impl)
    tcfg = dataclasses.replace(T_cfgs.smoke_config(arch), attention_impl=impl)
    return rcfg, tcfg, _perturbed(_reference_init(arch))


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_the_reference(arch):
    """Full and smoke configs field for field (the port's fields), and the
    analytic parameter counts (rwkv6-7b 7,558,135,808; zamba2-2.7b
    2,440,478,720)."""
    for get in ("get_config", "smoke_config"):
        rcfg, tcfg = getattr(R_cfgs, get)(arch), getattr(T_cfgs, get)(arch)
        want = _fields(rcfg)
        for key, value in _fields(tcfg).items():
            if isinstance(value, dict):
                assert value == {k: want[key][k] for k in value}, key
            else:
                assert value == want[key], key
        assert t_param_count(tcfg) == r_param_count(rcfg)
    assert t_param_count(T_cfgs.get_config(arch)) == {
        "rwkv6-7b": 7_558_135_808, "zamba2-2.7b": 2_440_478_720}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_matches_the_reference_at_full_width(arch):
    """Names, shapes and dtypes of every leaf, at the published widths (the
    port's module on the meta device, the reference's ``eval_shape``)."""
    rcfg, tcfg = R_cfgs.get_config(arch), T_cfgs.get_config(arch)
    want = jax.eval_shape(r_build(rcfg).init, jax.random.PRNGKey(0))
    flat = {".".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    model = _family(tcfg)[1](tcfg, "meta")
    got = {name: p for name, p in model.named_parameters()}
    assert sorted(got) == sorted(flat)
    for name, p in got.items():
        assert tuple(p.shape) == flat[name].shape, name
        assert str(p.dtype).removeprefix("torch.") == str(flat[name].dtype), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_distributions(arch):
    """Constant leaves equal the reference's; random leaves have its
    standard deviation (the two RNGs differ: within 5% plus four standard
    errors of the two estimates, 4 / sqrt(2n) for n draws)."""
    flat = {".".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(_reference_init(arch))[0]}
    model = t_build(T_cfgs.smoke_config(arch)).init(0, device="cpu")
    for name, p in model.named_parameters():
        want, got = flat[name], p.detach().float().numpy()
        if name.rsplit(".", 1)[-1] in CONSTANT_LEAVES - {"u"}:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6, err_msg=name)
        else:
            bound = 0.05 + 4 / math.sqrt(2 * got.size)
            assert abs(got.std() / want.std() - 1) < bound, (name, got.std(), want.std())


def test_time_mix_matches_the_reference():
    rcfg, tcfg, params = _reference("rwkv6-7b")
    p_ref = jax.tree.map(lambda a: a[0], params["layers"])
    p_port = from_jax_params(params, tcfg, device="cpu").layers.layer(0)
    x = np.random.default_rng(1).standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, a: r_rwkv.time_mix(p, a, r_rwkv._shift(a), rcfg,
                                                chunk=rcfg.ssm.chunk_size)[0])(p_ref, x)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = t_rwkv.time_mix(p_port, xt, t_rwkv._shift(xt), tcfg, chunk=tcfg.ssm.chunk_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_mamba_block_matches_the_reference():
    rcfg, tcfg, params = _reference("zamba2-2.7b")
    p_ref = jax.tree.map(lambda a: a[0], params["layers"])
    p_port = from_jax_params(params, tcfg, device="cpu").layers.layer(0)
    x = np.random.default_rng(2).standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, a: r_mamba.mamba_block(p, a, rcfg)[0])(p_ref, x)
    with torch.no_grad():
        got = t_mamba.mamba_block(p_port, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def _launches():
    return (T_wkv_ops.wkv6_apply.launches, T_ssd_ops.ssd_apply.launches,
            T_fa_ops.flash_attention.launches)


@pytest.mark.parametrize("arch,impl,last_only", [
    ("rwkv6-7b", "xla", False), ("rwkv6-7b", "xla", True),
    ("zamba2-2.7b", "xla", False), ("zamba2-2.7b", "xla", True),
    ("zamba2-2.7b", "flash", False),
])
def test_forward_matches_the_reference(arch, impl, last_only):
    """The smoke configs' full forwards (rwkv6: 2 layers; zamba2: 4 layers,
    the shared block after layers 2 and 4), the reference's weights through
    ``from_jax_params``, the same tokens."""
    rcfg, tcfg, params = _reference(arch, impl)
    tokens = np.random.default_rng(3).integers(0, 512, size=(2, 32)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: R_FORWARD[arch](p, t, rcfg, last_only=last_only))(
        params, jnp.asarray(tokens))
    model = from_jax_params(params, tcfg, device="cpu")
    before = _launches()
    with torch.no_grad():
        got = t_build(tcfg).forward(model, {"tokens": torch.from_numpy(tokens)},
                                    last_only=last_only)
    assert _launches() == before  # CPU tensors: the plain versions
    assert tuple(got.shape) == (2, 1 if last_only else 32, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_last_only_is_the_last_row_of_the_full_forward(arch):
    cfg = T_cfgs.smoke_config(arch)
    api = t_build(cfg)
    model = api.init(0, device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(4).integers(0, 512, size=(2, 48)).astype(np.int64))}
    with torch.no_grad():
        full = api.forward(model, batch)
        last = api.forward(model, batch, last_only=True)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(), atol=1e-6, rtol=1e-6)


def test_hybrid_flash_equals_xla_on_the_cpu():
    cfg = T_cfgs.smoke_config("zamba2-2.7b")
    model = t_build(cfg).init(0, device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(5).integers(0, 512, size=(2, 64)).astype(np.int64))}
    with torch.no_grad():
        out = {impl: t_build(dataclasses.replace(cfg, attention_impl=impl)).forward(model, batch)
               for impl in ("xla", "flash")}
    np.testing.assert_allclose(out["flash"].numpy(), out["xla"].numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference_and_backward_raises(arch):
    """The name is the earlier slice's, when a backward through the scans
    raised.  ``loss_fn`` is the reference's number, and its gradient (the
    scans' plain chunked form differentiated in the backward) is
    ``jax.grad`` of the reference's loss, every leaf, within ``GRAD_TOL``
    of the leaf's largest entry."""
    rcfg, tcfg, params = _reference(arch)
    tokens = np.random.default_rng(6).integers(0, 512, size=(2, 16)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, wgrads = jax.jit(jax.value_and_grad(r_build(rcfg).loss_fn))(params, rbatch)
    model = from_jax_params(params, tcfg, device="cpu")
    loss = t_build(tcfg).loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(want), atol=TOL, rtol=TOL)
    names, leaves = zip(*param_leaves(model))
    got = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    flat = {".".join(k.key for k in path): g
            for path, g in jax.tree_util.tree_flatten_with_path(wgrads)[0]}
    for name, g in zip(names, got):
        w = np.asarray(flat[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_run_on_the_card_unless_asked(arch, monkeypatch):
    """``build_model(get_config(arch)).init()`` resolves to ``cuda``: with no
    card it raises before allocating anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build(T_cfgs.get_config(arch)).init(0)


# ---------------------------------------------------------------------------
# on the card: the smoke forwards launch the kernels (skip here)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py "
                    "or pytest -m cuda tests/test_torch_ssm_models.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_forward_launches_the_scan_kernels(cuda_device, arch):
    cfg = dataclasses.replace(T_cfgs.smoke_config(arch), attention_impl="flash")
    api = t_build(cfg)
    model = api.init(0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(7).integers(0, 512, size=(2, 64)))
    with torch.no_grad():
        cpu = api.forward(model, {"tokens": tok})
        model = model.to(cuda_device)
        before = _launches()
        gpu = api.forward(model, {"tokens": tok.to(cuda_device)})
        torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(_launches(), before))
    L = cfg.num_layers
    assert got == ((L, 0, 0) if arch == "rwkv6-7b" else (0, L, L // cfg.hybrid.shared_attn_every))
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), atol=1e-4, rtol=1e-4)
