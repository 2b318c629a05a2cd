"""The port's ZeRO-1 training slice against the reference, on the CPU.

Same config (``smoke_config("qwen2-0.5b")``, float32), same weights (the
reference's ``init_state`` params through ``from_jax_params``), same batch
(numpy, seeded): two ZeRO-1 steps on the reference (``mesh1``, ``paxi``,
jitted) and on the port (``device="cpu"``, gloo world of one), with one
bucket and with two buckets plus two microbatches (the f32 accumulation
path and the unpack kernel's plain version).

Tolerances, float32 throughout:

* loss and grad-norm: ``rtol=1e-5`` — XLA and PyTorch sum the matmuls and
  reductions in different orders, which moves the last bits only;
* moments ``m``/``v``: ``rtol=1e-4`` on top of a floor of 1e-6 of the
  largest moment — they are linear in the gradients, which carry the same
  reassociation error, and entries near zero have no relative precision;
* parameters: ``atol=2e-5`` — after two Adam steps a parameter moves by
  ``lr * mhat / (sqrt(vhat) + eps)``, about ``3e-4`` per step; the ratio
  amplifies gradient rounding where a gradient is near zero, bounded by the
  step size times the relative gradient error.

A world-of-two leg (two processes, gloo, ``file://`` rendezvous) trains the
same global batch split over two ranks and must give the same parameters
as the world of one; a second one starts each rank through the launcher's
own flags and must give the world of one's losses and grad norms.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as R_cfgs
from repro.core.compat import make_mesh
from repro.models import build_model as r_build
from repro.optim.adamw import AdamWConfig as R_Adam
from repro.runtime.dist import make_dist as r_make_dist
from repro.train import train_loop as r_tl

import repro_torch.configs as T_cfgs
from repro_torch.core.errors import PAX_ERR_UNSUPPORTED_OPERATION, PaxError
from repro_torch.launch import train as t_train
from repro_torch.models import build_model as t_build
from repro_torch.models import from_jax_params, param_leaves
from repro_torch.optim.adamw import AdamWConfig as T_Adam
from repro_torch.runtime.dist import make_dist as t_make_dist
from repro_torch.train import train_loop as t_tl

import _torch_ranks

STEPS = 2
CASES = {"b1": dict(zero1_buckets=1, microbatch=0),
         "b2_micro2": dict(zero1_buckets=2, microbatch=2)}


def _cfg(mod, **par):
    cfg = mod.smoke_config("qwen2-0.5b")
    return dataclasses.replace(cfg, parallelism=dataclasses.replace(
        cfg.parallelism, zero1=True, **par))


def _batch():
    tok = np.random.default_rng(0).integers(0, 512, size=(4, 16)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


_RUNS: dict = {}


def _run(case: str):
    """Both packages, two steps each (computed once per case)."""
    if case in _RUNS:
        return _RUNS[case]
    par = CASES[case]
    batch = _batch()
    rcfg = _cfg(R_cfgs, **par)
    rapi = r_build(rcfg)
    rdist = r_make_dist(make_mesh((1, 1), ("data", "model")), impl="paxi")
    rstate = r_tl.init_state(rapi, jax.random.PRNGKey(0), dist=rdist)
    np_params = jax.tree.map(np.asarray, rstate.params)
    rstep = jax.jit(r_tl.make_train_step(rapi, rdist, R_Adam()))
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = {"loss": [], "gnorm": []}
    for _ in range(STEPS):
        rstate, met = rstep(rstate, rb)
        ref["loss"].append(float(met.loss))
        ref["gnorm"].append(float(met.grad_norm))
    ref["m"], ref["v"] = np.asarray(rstate.opt.m), np.asarray(rstate.opt.v)
    ref["params"] = [np.asarray(l) for l in jax.tree.leaves(rstate.params)]

    tcfg = _cfg(T_cfgs, **par)
    tapi = t_build(tcfg)
    tdist = t_make_dist(device="cpu")
    tstate = t_tl.init_state(tapi, 0, tdist,
                             model=from_jax_params(np_params, tcfg, device="cpu"))
    tstep = t_tl.make_train_step(tapi, tdist, T_Adam())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    port = {"loss": [], "gnorm": [], "wire_kernel": tdist.zero1_plans.wire_kernel}
    for _ in range(STEPS):
        tstate, met = tstep(tstate, tb)
        port["loss"].append(float(met.loss))
        port["gnorm"].append(float(met.grad_norm))
    port["m"], port["v"] = tstate.opt.m.numpy(), tstate.opt.v.numpy()
    port["names"] = [n for n, _ in param_leaves(tstate.params)]
    port["params"] = [p.detach().numpy() for _, p in param_leaves(tstate.params)]
    _RUNS[case] = (ref, port, np_params, tcfg, batch)
    return _RUNS[case]


@pytest.mark.parametrize("case", CASES)
def test_losses_match_reference(case):
    ref, port, *_ = _run(case)
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_grad_norms_match_reference(case):
    ref, port, *_ = _run(case)
    np.testing.assert_allclose(port["gnorm"], ref["gnorm"], rtol=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("moment", ["m", "v"])
def test_flat_moments_match_reference_element_for_element(case, moment):
    ref, port, *_ = _run(case)
    assert port[moment].shape == ref[moment].shape
    floor = 1e-6 * float(np.abs(ref[moment]).max())
    np.testing.assert_allclose(port[moment], ref[moment], rtol=1e-4, atol=floor)


@pytest.mark.parametrize("case", CASES)
def test_params_match_reference(case):
    ref, port, *_ = _run(case)
    assert len(port["params"]) == len(ref["params"])
    for name, p, r in zip(port["names"], port["params"], ref["params"]):
        assert p.shape == r.shape, name
        np.testing.assert_allclose(p, r, rtol=0, atol=2e-5, err_msg=name)


def test_cpu_run_used_the_plain_kernel_versions():
    _, port, *_ = _run("b2_micro2")
    assert port["wire_kernel"] == "torch"


def test_world_of_two_gives_the_world_of_one_params(tmp_path):
    """Two ranks, each training on its half of the same global batch,
    reduce-scatter and all-gather through the ABI over gloo; the result
    equals the single-rank run to float32 reassociation (the dp mean of two
    half-batch gradients vs one full-batch gradient)."""
    ref, port, np_params, tcfg, batch = _run("b2_micro2")
    ranks = _torch_ranks.run_ranks(_torch_ranks.train_rank, 2, tmp_path,
                                   tcfg, np_params, batch, STEPS, timeout=180)
    names = port["names"]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], port["loss"], rtol=1e-5)
        for name, p in zip(names, port["params"]):
            np.testing.assert_allclose(rank[f"param:{name}"], p, rtol=0, atol=2e-5,
                                       err_msg=name)
    # each rank holds its contiguous half of the world-of-one moments
    half = port["m"].shape[0] // 2
    for r, rank in enumerate(ranks):
        floor = 1e-6 * float(np.abs(port["m"]).max())
        np.testing.assert_allclose(rank["m"], port["m"][r * half:(r + 1) * half],
                                   rtol=1e-4, atol=floor)


LAUNCH_ARGV = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "2", "--global-batch", "4",
               "--seq-len", "16", "--zero1-buckets", "2", "--device", "cpu"]


def test_launcher_world_of_two_matches_world_of_one(tmp_path):
    """``launch.train`` started as two ranks (``--world-size 2 --rank r
    --init-method file://...``) trains the same seeded weights on the same
    global batch as the world of one, to the dp-mean's float32
    reassociation (as above)."""
    one = t_train.main(LAUNCH_ARGV)
    assert one.wire_kernel == "torch" and len(one.losses) == 2
    ranks = _torch_ranks.run_ranks(_torch_ranks.launch_rank, 2, tmp_path, LAUNCH_ARGV,
                                   timeout=180)
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], one.losses, rtol=1e-5)
        np.testing.assert_allclose(rank["grad_norms"], one.grad_norms, rtol=1e-5)


@pytest.mark.parametrize("flag", [["--ckpt-dir", "ckpt"], ["--ckpt-every", "10"]])
def test_launcher_refuses_checkpoint_flags(flag):
    with pytest.raises(PaxError) as e:
        t_train.main(LAUNCH_ARGV + flag)
    assert e.value.code == PAX_ERR_UNSUPPORTED_OPERATION
