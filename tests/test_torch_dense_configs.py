"""The chatglm3-6b, gemma-7b and nemotron-4-340b configs on the port
against the reference, on the CPU.

The configs are the reference's, registered in ``repro_torch.configs``;
their smoke reductions build the same small models in both packages.  From
the reference's weights (key 0, through ``from_jax_params``) and the same
tokens (numpy, seeded), the port's forward logits and loss equal the
reference's in float32 within 2e-5 (atol = rtol: matrix products and norms
summed in another order).  What each config exercises: chatglm3-6b rotary on
half the head dims, grouped KV (2 heads) and QKV bias; gemma-7b GeGLU,
head_dim 256 at full width (16 at smoke size) and tied embeddings;
nemotron-4-340b layernorm, squared ReLU and 96 / 8 heads (its full-width
tree is checked on the ``meta`` device only: nothing is allocated).  The
analytic counts (``analytic_param_count``, ``active_only``,
``model_flops_per_token``) equal the reference's for all ten archs, and the
dense layer body runs the config's remat, bitwise equal to none.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as R_cfgs
from repro.models import build_model as r_build
from repro.models.model import analytic_param_count as r_param_count
from repro.models.model import model_flops_per_token as r_flops_per_token

import repro_torch.configs as T_cfgs
from repro_torch.models import analytic_param_count as t_param_count
from repro_torch.models import build_model as t_build
from repro_torch.models import from_jax_params
from repro_torch.models.model import _family
from repro_torch.models.model import model_flops_per_token as t_flops_per_token
from repro_torch.models import transformer

import _torch_mm as mm

ARCHS = ("chatglm3-6b", "gemma-7b", "nemotron-4-340b")
TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _reference_init(arch):
    params = jax.jit(r_build(R_cfgs.smoke_config(arch)).init)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _tokens():
    tok = np.random.default_rng(3).integers(0, 512, size=(2, 32)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def test_both_configs_are_registered():
    for arch in ARCHS:
        assert arch in T_cfgs.ARCH_NAMES
        assert T_cfgs.get_config(arch).family == "dense"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("get", ("get_config", "smoke_config"))
def test_config_and_param_count_match_the_reference(arch, get):
    rcfg, tcfg = getattr(R_cfgs, get)(arch), getattr(T_cfgs, get)(arch)
    want = dataclasses.asdict(rcfg)
    for key, value in dataclasses.asdict(tcfg).items():
        if isinstance(value, dict):
            assert value == {k: want[key][k] for k in value}, key
        else:
            assert value == want[key], key
    assert t_param_count(tcfg) == r_param_count(rcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_matches_the_reference_at_full_width(arch):
    """Names, shapes and dtypes of every leaf at the published widths (the
    port's module on the meta device, the reference's ``eval_shape``)."""
    rcfg, tcfg = R_cfgs.get_config(arch), T_cfgs.get_config(arch)
    want = jax.eval_shape(r_build(rcfg).init, jax.random.PRNGKey(0))
    flat = {".".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    model = _family(tcfg)[1](tcfg, "meta")
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(flat)
    for name, p in got.items():
        assert tuple(p.shape) == flat[name].shape, name
        assert str(p.dtype).removeprefix("torch.") == str(flat[name].dtype), name


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_the_reference(arch):
    rcfg, tcfg = R_cfgs.smoke_config(arch), T_cfgs.smoke_config(arch)
    params = _reference_init(arch)
    batch = _tokens()
    want = jax.jit(lambda p, b: r_build(rcfg).forward(p, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = want[0] if isinstance(want, tuple) else want
    model = from_jax_params(params, tcfg, device="cpu")
    with torch.no_grad():
        got = t_build(tcfg).forward(model, {"tokens": torch.from_numpy(batch["tokens"])})
    assert tuple(got.shape) == (2, 32, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference(arch):
    rcfg, tcfg = R_cfgs.smoke_config(arch), T_cfgs.smoke_config(arch)
    params = _reference_init(arch)
    batch = _tokens()
    want = jax.jit(lambda p, b: r_build(rcfg).loss_fn(p, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = from_jax_params(params, tcfg, device="cpu")
    with torch.no_grad():
        got = t_build(tcfg).loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", R_cfgs.ARCH_NAMES)
def test_analytic_counts_match_the_reference_for_every_arch(arch):
    rcfg, tcfg = R_cfgs.get_config(arch), T_cfgs.get_config(arch)
    for active in (False, True):
        assert t_param_count(tcfg, active_only=active) == r_param_count(rcfg, active_only=active)
    assert tcfg.active_param_count() == rcfg.active_param_count()
    assert t_flops_per_token(tcfg) == r_flops_per_token(rcfg)


def test_nemotron_counts_341_billion_parameters():
    cfg = T_cfgs.get_config("nemotron-4-340b")
    assert t_param_count(cfg) == cfg.param_count() == 341_022_081_024
    assert t_flops_per_token(cfg) == 6 * 341_022_081_024


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "gemma-7b"))
def test_remat_full_and_none_are_bitwise_equal(arch, monkeypatch):
    """The dense layer body runs the config's remat (``"full"``: each layer
    a non-reentrant checkpoint), and the loss and every gradient equal
    ``"none"``'s bitwise."""
    seen, real = [], transformer.maybe_remat
    monkeypatch.setattr(transformer, "maybe_remat",
                        lambda fn, name: seen.append(name) or real(fn, name))
    mm.check_remat(arch)
    assert seen == ["none", "full"]
