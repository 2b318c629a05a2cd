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
  largest moment (1e-5 for rwkv6's, see ``CASES``) — they are linear in
  the gradients, which carry the same reassociation error, and entries
  near zero have no relative precision;
* parameters: ``atol=2e-5`` — after two Adam steps a parameter moves by
  ``lr * mhat / (sqrt(vhat) + eps)``, about ``3e-4`` per step; the ratio
  amplifies gradient rounding where a gradient is near zero, bounded by the
  step size times the relative gradient error.

A world-of-two leg (two processes, gloo, ``file://`` rendezvous) trains the
same global batch split over two ranks and must give the same parameters
as the world of one; a second one starts each rank through the launcher's
own flags and must give the world of one's losses and grad norms.

The moe case (qwen2-moe's smoke config) trains two steps under
``remat="full"`` with two microbatches, its loss cross-entropy plus the
router's aux loss in both packages.

The ssm (rwkv6) and hybrid (zamba2) cases train three steps as their full
configs do, under ``remat="full"`` with two microbatches, in both
packages: the port's scans run their plain versions forward and the plain
chunked form's gradient backward, the reference its lax forms under XLA's
autodiff.
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
from repro_torch.launch import train as t_train
from repro_torch.models import build_model as t_build
from repro_torch.models import from_jax_params, param_leaves
from repro_torch.optim.adamw import AdamWConfig as T_Adam
from repro_torch.runtime.dist import make_dist as t_make_dist
from repro_torch.train import train_loop as t_tl

import _torch_ranks

STEPS = 2
CASES = {"b1": dict(zero1_buckets=1, microbatch=0),
         "b2_micro2": dict(zero1_buckets=2, microbatch=2),
         "bf16_b1": dict(zero1_buckets=1, microbatch=0, grad_compression="bf16"),
         "bf16_b2": dict(zero1_buckets=2, microbatch=2, grad_compression="bf16"),
         "int8_b2": dict(zero1_buckets=2, microbatch=2, grad_compression="int8"),
         # the ssm and hybrid families, as their full configs train: remat
         # "full" and microbatches, three steps (the scans' plain gradient).
         # rwkv6's tied embedding sums the lookup's and the unembedding's
         # gradients, reassociated: after three steps its moments differ by
         # up to 1e-5 of the largest moment (measured 1.6e-7 on 1.6e-2)
         "rwkv6_b1_micro2": dict(arch="rwkv6-7b", zero1_buckets=1, microbatch=2,
                                 remat="full", steps=3, moment_floor=1e-5),
         "zamba2_b2_micro2": dict(arch="zamba2-2.7b", zero1_buckets=2, microbatch=2,
                                  remat="full", steps=3),
         # the moe family as its full config trains (remat "full",
         # microbatches): the loss carries the router's aux loss
         "moe_b1_micro2": dict(arch="qwen2-moe-a2.7b", zero1_buckets=1, microbatch=2,
                               remat="full")}


def _cfg(mod, arch="qwen2-0.5b", steps=STEPS, moment_floor=None, **par):
    cfg = mod.smoke_config(arch)
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
    compression = par.get("grad_compression")
    rdist = r_make_dist(make_mesh((1, 1), ("data", "model")), impl="paxi",
                        compression=compression)
    rstate = r_tl.init_state(rapi, jax.random.PRNGKey(0), dist=rdist)
    np_params = jax.tree.map(np.asarray, rstate.params)
    rstep = jax.jit(r_tl.make_train_step(rapi, rdist, R_Adam()))
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = {"loss": [], "gnorm": []}
    for _ in range(par.get("steps", STEPS)):
        rstate, met = rstep(rstate, rb)
        ref["loss"].append(float(met.loss))
        ref["gnorm"].append(float(met.grad_norm))
    ref["m"], ref["v"] = np.asarray(rstate.opt.m), np.asarray(rstate.opt.v)
    ref["ef"] = np.asarray(rstate.opt.ef)
    ref["params"] = [np.asarray(l) for l in jax.tree.leaves(rstate.params)]

    tcfg = _cfg(T_cfgs, **par)
    tapi = t_build(tcfg)
    tdist = t_make_dist(device="cpu", compression=compression)
    tstate = t_tl.init_state(tapi, 0, tdist,
                             model=from_jax_params(np_params, tcfg, device="cpu"))
    tstep = t_tl.make_train_step(tapi, tdist, T_Adam())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    port = {"loss": [], "gnorm": [], "wire_kernel": tdist.zero1_plans.wire_kernel}
    for _ in range(par.get("steps", STEPS)):
        tstate, met = tstep(tstate, tb)
        port["loss"].append(float(met.loss))
        port["gnorm"].append(float(met.grad_norm))
    port["m"], port["v"] = tstate.opt.m.numpy(), tstate.opt.v.numpy()
    port["ef"] = tstate.opt.ef.numpy()
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


#: share of elements where the two packages' bf16 wires may differ by one
#: bf16 ulp: the f32 gradients differ by reassociation, and where they
#: straddle a bf16 rounding midpoint they round apart (measured: at most
#: 0.09% of the 107,072 elements of the smoke config)
BF16_FLIP_SHARE = 2e-3


def _bf16_flips(port, ref, rtol, atol, flip_atol):
    """Elements outside (rtol, atol) are rounding flips: at most
    BF16_FLIP_SHARE of them, each within ``flip_atol``."""
    bad = ~np.isclose(port, ref, rtol=rtol, atol=atol)
    assert bad.mean() <= BF16_FLIP_SHARE, bad.mean()
    np.testing.assert_allclose(port[bad], ref[bad], rtol=0, atol=flip_atol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("moment", ["m", "v"])
def test_flat_moments_match_reference_element_for_element(case, moment):
    """On the bf16 wire the moments take one bf16 rounding of the
    gradient: where the two wires differ by one bf16 ulp (2^-8 of the
    element), m and v differ by at most 2^-8 of the largest moment."""
    ref, port, *_ = _run(case)
    assert port[moment].shape == ref[moment].shape
    floor = CASES[case].get("moment_floor", 1e-6) * float(np.abs(ref[moment]).max())
    if CASES[case].get("grad_compression") == "bf16":
        _bf16_flips(port[moment], ref[moment], 1e-4, floor,
                    2**-8 * float(np.abs(ref[moment]).max()))
        return
    np.testing.assert_allclose(port[moment], ref[moment], rtol=1e-4, atol=floor)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c].get("grad_compression") == "bf16"])
def test_error_feedback_residual_matches_reference(case):
    """The bf16 wire's residual ``(g + ef) - f32(bf16(g + ef))``, this
    rank's full (padded,) vector in both packages.  Where the wires agree
    the residuals differ by the gradient's reassociation error (below 1e-3
    of the largest residual); where they round apart, by one bf16 ulp of
    the element, at most twice the largest residual."""
    ref, port, *_ = _run(case)
    assert port["ef"].shape == ref["ef"].shape == port["m"].shape
    top = float(np.abs(ref["ef"]).max())
    assert top > 0
    _bf16_flips(port["ef"], ref["ef"], 0, 1e-3 * top, 2 * top)


def test_compressed_runs_used_their_wires():
    """int8 keeps an f32 wire on ring-int8 (a ring of one: no hop); bf16
    keeps the residual; both run the plain kernel versions on the CPU."""
    for case in ("bf16_b1", "bf16_b2", "int8_b2"):
        _, port, *_ = _run(case)
        assert port["wire_kernel"] == "torch"
    assert _run("int8_b2")[1]["ef"].shape == (1,)


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
def test_launcher_refuses_checkpoint_flags(flag, tmp_path):
    """Checkpointing is ported (the name is the earlier slice's, when both
    flags were refused): ``--ckpt-dir`` saves, and a second run on the
    directory resumes bitwise where an uninterrupted run would be; only
    ``--ckpt-every`` without a directory is refused."""
    if flag[0] == "--ckpt-every":
        with pytest.raises(ValueError, match="--ckpt-dir"):
            t_train.main(LAUNCH_ARGV + flag)
        return
    d = str(tmp_path / flag[1])
    first = t_train.main(LAUNCH_ARGV + ["--ckpt-dir", d, "--ckpt-every", "1"])
    assert first.ckpt_save["step"] == 2 and first.resumed_from == 0
    more = t_train.main(LAUNCH_ARGV[:4] + ["3"] + LAUNCH_ARGV[5:] + ["--ckpt-dir", d])
    whole = t_train.main(LAUNCH_ARGV[:4] + ["3"] + LAUNCH_ARGV[5:])
    assert more.resumed_from == 2 and more.ckpt_restore["step"] == 2
    assert (more.losses, more.grad_norms) == (whole.losses[2:], whole.grad_norms[2:])


def test_world_of_two_bf16_error_feedback_identity(tmp_path):
    """Battery section 9d at dp=2 over gloo: with the same gradient ``v``
    on both ranks, step 1 delivers the dp-mean of the bf16 wires and
    keeps ``e1 = v - f32(bf16(v))`` exactly; two steps deliver
    ``g1 + g2 = 2v - e2`` — the first step's rounding error is recovered,
    not dropped.  Pooled requests and persistent plans alike."""
    ranks = _torch_ranks.run_ranks(_torch_ranks.ef_rank, 2, tmp_path, timeout=120)
    v = np.linspace(0.1, 1.7, _torch_ranks.NV, dtype=np.float32)
    w1 = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    e1 = v - w1
    assert np.abs(e1).max() > 0
    half = _torch_ranks.NV // 2
    for r, got in enumerate(ranks):
        for mode in ("pooled", "plans"):
            np.testing.assert_array_equal(got[f"{mode}:ef1"], e1)
            mine = slice(r * half, (r + 1) * half)
            np.testing.assert_allclose(got[f"{mode}:g1"], w1[mine], rtol=0, atol=1e-7)
            np.testing.assert_allclose(got[f"{mode}:g1"] + got[f"{mode}:g2"],
                                       (2 * v - got[f"{mode}:ef2"])[mine], rtol=0, atol=1e-6)


@pytest.mark.parametrize("compression", [None, "bf16", "int8"])
def test_per_leaf_sync_takes_the_gradient_wire(compression):
    """The per-leaf DDP step's ``sync_grads_abi``, as the reference's: bf16
    leaves on the bf16 wire, the ring-int8 context for int8 (a ring of one
    at world one: the identity), the dp-mean in f32."""
    g = torch.from_numpy(np.linspace(0.1, 1.7, 64, dtype=np.float32))
    d = t_make_dist(device="cpu", compression=compression)
    (out,) = t_tl.sync_grads_abi(d, [g], compression)
    want = g.to(torch.bfloat16).float() if compression == "bf16" else g
    assert out.dtype == torch.float32 and torch.equal(out, want)
