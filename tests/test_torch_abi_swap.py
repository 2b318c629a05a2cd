"""The paper's backend swap on the port against the reference's
``examples/abi_swap.py``, on the CPU.

The example trains ``smoke_config("chatglm3-6b")`` for 3 ZeRO-1 steps
(batch 2, sequence 16, one batch, key 0) on every implementation and holds
each backend's loss to ``paxi``'s.  Here the same loop runs in the
reference (mesh of one, jitted), and ``repro_torch.launch.abi_swap`` runs
the port from the reference's weights (``from_jax_params``) on the same
batch: per backend, every step's loss equals the reference's within the
example's tolerance (1e-5 relative, 5e-3 on the bf16 wire), and the port's
backends agree among themselves as the example requires.
"""
import numpy as np
import pytest

import jax

import repro.configs as R_cfgs
from repro.core.compat import make_mesh
from repro.models import build_model as r_build
from repro.models import make_batch
from repro.optim.adamw import AdamWConfig as R_Adam
from repro.runtime.dist import make_dist as r_make_dist
from repro.train import train_loop as r_tl

import repro_torch.configs as T_cfgs
from repro_torch.launch import abi_swap
from repro_torch.models import from_jax_params

ARCH = "chatglm3-6b"
STEPS = 3

_CACHE: dict = {}


def _runs():
    """(reference losses per backend, the port's SwapRuns), computed once."""
    if _CACHE:
        return _CACHE["ref"], _CACHE["port"]
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = R_cfgs.smoke_config(ARCH)
    api = r_build(cfg)
    key = jax.random.PRNGKey(0)
    batch = make_batch(key, cfg, 2, 16)
    ref, params = {}, None
    for impl in abi_swap.IMPLS:
        dist = r_make_dist(mesh, impl=impl)
        state = r_tl.init_state(api, key)
        if params is None:
            params = jax.tree.map(np.asarray, state.params)
        step = jax.jit(r_tl.make_train_step(api, dist, R_Adam()))
        ref[impl] = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            ref[impl].append(float(m.loss))
    tcfg = T_cfgs.smoke_config(ARCH)
    port = abi_swap.swap(
        tcfg, abi_swap.IMPLS, STEPS, device="cpu",
        batch={k: np.asarray(v) for k, v in batch.items()},
        model_fn=lambda dev: from_jax_params(params, tcfg, device=dev))
    _CACHE.update(ref=ref, port=port)
    return ref, port


@pytest.mark.parametrize("impl", abi_swap.IMPLS)
def test_losses_match_the_reference_example(impl):
    ref, port = _runs()
    tol = abi_swap.tolerance(impl)
    np.testing.assert_allclose(port[impl].losses, ref[impl], rtol=tol)


@pytest.mark.parametrize("impl", abi_swap.IMPLS)
def test_backend_agrees_with_paxi_and_leaves_nothing_in_flight(impl):
    _, port = _runs()
    run = port[impl]
    assert len(run.losses) == STEPS and all(np.isfinite(run.losses + run.grad_norms))
    abi_swap.check({"paxi": port["paxi"], impl: run})
    # at one rank every collective of the step is an identity
    assert run.losses == port["paxi"].losses and run.grad_norms == port["paxi"].grad_norms
    assert run.outstanding == 0
    assert run.wire_kernel == "torch"  # CPU tensors: the plain kernel versions


def test_capability_sources_differ_as_the_backends_do():
    _, port = _runs()
    src = {impl: run.sources for impl, run in port.items()}
    assert src["paxi"] == dict.fromkeys(abi_swap.CAP_ROWS, "native")
    assert src["minimal"] == dict.fromkeys(abi_swap.CAP_ROWS, "emulated")
    for impl in ("ompix", "muk:paxi"):
        assert src[impl] == {"allreduce": "native", "reduce": "emulated",
                             "gather": "emulated", "comm_agree": "emulated"}
    assert src["ring"]["allreduce"] == "emulated"


def test_command_line_runs_every_backend():
    runs = abi_swap.main(["--device", "cpu", "--smoke", "--arch", ARCH, "--steps", "2"])
    assert tuple(runs) == abi_swap.IMPLS
    for run in runs.values():
        assert len(run.losses) == 2 and run.losses == runs["paxi"].losses
