"""The port's vlm family (phi-3-vision-4.2b's smoke config, float32)
against the reference, on the CPU, on the reference's own weights
(``from_jax_params``) and numpy-seeded batches:

* the projector (tanh GELU) and the forward over the image prefix and the
  text: the text positions' logits, ``last_only`` and the loss within
  ``TOL``; every gradient leaf within ``GRAD_TOL`` of its largest
  magnitude of ``jax.grad``'s;
* ``prefill_multimodal`` + ``decode_step`` against the reference's after
  every token, and the twin of
  ``test_models_smoke.py::test_decode_matches_forward``;
* the static engine (text only, as the reference serves the family):
  greedy and sampled streams and stats equal to the JAX engine's;
* ``param_specs``; the full config's counts (3,833,462,784 analytic, and
  3,833,662,464 in a meta-device build: the analytic count leaves out the
  norm scales);
* under ``attention_impl="flash"`` (on the CPU the kernel's plain
  version) the forward within ``TOL_PART`` of ``"xla"``;
* three ABI ZeRO-1 steps (two microbatches, remat "full") at one rank,
  and the ``gspmd`` step within 1e-5 of them; remat "full" and "none"
  bitwise alike; the ZeRO-1 and the per-leaf checkpoint both ways; the training launcher
  refuses the family (the reference's fails there: its token stream has no
  patches).

Tolerances as ``test_torch_encdec.py``'s: float32 summed in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as r_build
from repro.models import vlm as r_vlm
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as RServeEngine

import repro_torch.configs as T_cfgs
from repro_torch.models import build_model as t_build
from repro_torch.models import make_batch
from repro_torch.models import vlm as t_vlm
from repro_torch.serve import Request, ServeEngine

import _torch_mm as mm

ARCH = "phi-3-vision-4.2b"
TOL = 2e-5
TOL_PART = 1e-5
GRAD_TOL = 1e-4
#: decode against the reference: bfloat16 caches in both packages round
#: apart by one ulp where the f32 K or V sits at a midpoint (see
#: ``test_torch_encdec.TOL_DECODE``)
TOL_DECODE = 1e-4


def _params():
    return jax.tree.map(jnp.asarray, mm.reference_params(ARCH))


def test_smoke_config_and_batch_shapes():
    cfg = T_cfgs.smoke_config(ARCH)
    assert (cfg.vlm.num_patches, cfg.vlm.patch_embed_dim) == (8, 32)
    b = make_batch(0, cfg, 2, 32, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == {
        "tokens": ((2, 32), torch.int32), "targets": ((2, 32), torch.int32),
        "patches": ((2, 8, 32), torch.bfloat16)}


def test_projector_matches_the_reference():
    rcfg, tcfg = mm.cfgs(ARCH)
    patches = mm.batch(ARCH)["patches"]
    want = jax.jit(lambda p, x: r_vlm.project_patches(p, x, rcfg))(_params(), patches)
    with torch.no_grad():
        got = t_vlm.project_patches(mm.port_model(ARCH), torch.from_numpy(patches), tcfg)
    np.testing.assert_allclose(mm.np32(got), np.asarray(want), atol=TOL_PART, rtol=TOL_PART)


def test_forward_loss_and_gradient_match_the_reference():
    mm.check_forward_loss_and_grads(ARCH, TOL, GRAD_TOL)


def test_flash_forward_matches_xla():
    """The kernel registry's CPU variant (``ref.attention_ref``) over the
    ``Np + S`` positions of every layer, against ``"xla"``."""
    _, tcfg = mm.cfgs(ARCH, attention_impl="flash")
    _, xcfg = mm.cfgs(ARCH)
    model = mm.port_model(ARCH, tcfg)
    b = mm.tb(mm.batch(ARCH))
    with torch.no_grad():
        flash = t_build(tcfg).forward(model, b)
        xla = t_build(xcfg).forward(model, b)
    np.testing.assert_allclose(flash.numpy(), xla.numpy(), atol=TOL_PART, rtol=TOL_PART)


NEW = 5


def test_prefill_multimodal_and_decode_match_the_reference():
    rcfg, tcfg = mm.cfgs(ARCH)
    params = _params()
    b = mm.batch(ARCH, S=11)
    lj, rcache, idx = jax.jit(lambda p, t, x: r_vlm.prefill_multimodal(
        p, t, x, rcfg, max_seq=32))(params, b["tokens"], b["patches"])
    model = mm.port_model(ARCH)
    api = t_build(tcfg)
    with torch.no_grad():
        lt, cache, n = t_vlm.prefill_multimodal(model, torch.from_numpy(b["tokens"]),
                                                torch.from_numpy(b["patches"]), tcfg,
                                                max_seq=32)
    assert n == int(idx) == tcfg.vlm.num_patches + 11
    assert cache.k.dtype == torch.bfloat16
    np.testing.assert_allclose(mm.np32(lt), np.asarray(lj), atol=TOL, rtol=TOL)
    rstep = jax.jit(lambda p, t, c, i: r_vlm.decode_step(p, t, c, i, rcfg))
    tok = np.argmax(mm.np32(lt), axis=-1).astype(np.int32)[:, None]
    for step in range(NEW):
        lj, rcache = rstep(params, jnp.asarray(tok), rcache, jnp.int32(n + step))
        with torch.no_grad():
            lt, cache = api.decode_step(model, torch.from_numpy(tok), cache, n + step)
        np.testing.assert_allclose(mm.np32(lt), np.asarray(lj), atol=TOL_DECODE,
                                   rtol=TOL_DECODE, err_msg=f"decode step {step}")
        tok = np.argmax(mm.np32(lt), axis=-1).astype(np.int32)[:, None]


def test_decode_matches_forward():
    """The twin of ``test_models_smoke.py::test_decode_matches_forward``:
    the image prefix and all but the last token prefilled, the last one
    decoded; within 2e-2 of the forward's last row (bfloat16 caches)."""
    _, tcfg = mm.cfgs(ARCH)
    b = mm.tb(mm.batch(ARCH, S=8))
    api = t_build(tcfg)
    model = mm.port_model(ARCH)
    with torch.no_grad():
        full = api.forward(model, b)
        _, cache, n = t_vlm.prefill_multimodal(model, b["tokens"][:, :-1], b["patches"],
                                               tcfg, max_seq=32)
        step, _ = api.decode_step(model, b["tokens"][:, -1:], cache, n)
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(), atol=2e-2, rtol=2e-2)


PROMPTS = (5, 11, 8)      # ragged


def _requests(cls, sampled: bool):
    rng = np.random.default_rng(4)
    return [cls(i, rng.integers(1, 512, n).astype(np.int32), max_new_tokens=4 + i,
                **(dict(temperature=0.8, top_k=20) if sampled and i != 1 else {}))
            for i, n in enumerate(PROMPTS)]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_static_engine_streams_equal_the_jax_engine(sampled):
    """Text only, left-padded, one position a step: every request's tokens
    and the engine's stats equal the JAX engine's ``_run_static``."""
    rcfg, tcfg = mm.cfgs(ARCH)
    want = _requests(RRequest, sampled)
    reng = RServeEngine(r_build(rcfg), _params(), max_batch=4, max_seq=32, seed=3)
    reng.run(want)
    got = _requests(Request, sampled)
    eng = ServeEngine(t_build(tcfg), mm.port_model(ARCH), max_batch=4, max_seq=32, seed=3)
    assert not eng.paged
    eng.run(got)
    for g, w in zip(got, want):
        assert g.done and len(g.out_tokens) == g.max_new_tokens
        assert g.out_tokens == [int(t) for t in w.out_tokens], g.rid
    assert eng.stats == reng.stats


def test_param_specs_match_the_reference():
    mm.check_specs(ARCH)


def test_full_size_config_shapes_and_counts():
    mm.check_full_size(ARCH, 3_833_462_784, 3_833_662_464)


def test_zero1_steps_match_the_reference():
    mm.check_zero1_steps(ARCH, TOL)


def test_gspmd_step_matches_the_abi_step():
    mm.check_gspmd_matches_abi(ARCH)


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "per_leaf"])
def test_checkpoints_cross_both_ways(tmp_path, zero1):
    names = mm.check_checkpoint_crossing(ARCH, tmp_path, zero1)
    assert ".params['projector']['w1']" in names


def test_launchers():
    """``launch.train`` refuses the family (no patches in the token
    stream); ``launch.serve`` serves it statically, text only."""
    from repro_torch.launch import serve, train

    with pytest.raises(ValueError, match="patches"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1", "--device", "cpu"])
    reqs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "6", "--new-tokens", "3"])
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)


def test_remat_full_and_none_are_bitwise_equal():
    mm.check_remat(ARCH)
