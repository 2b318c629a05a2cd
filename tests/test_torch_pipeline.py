"""The port's GPipe pipeline (``repro_torch.runtime.pipeline``) against the
reference's sequential run, the twin of ``tests/test_pipeline.py``: four
gloo ranks, one stage each on a ``(pod, model)`` mesh, S=4 stages of
L_PER=2 tanh layers of width D=16, M=4 microbatches of 2, the same ``W``
and ``x`` (numpy, from a seed).

* the forward (``broadcast_out``) within 1e-5 of the layers run in order
  (computed by the reference's JAX);
* ``pipelined_loss``'s gradient of every stage's weights within 1e-4 of
  ``jax.grad`` of the sequential loss, and its value on every stage;
* every hop through the ABI: ``M + S - 1`` ``sendrecv`` calls forward and
  as many backward; stage 0, which no pair sends to, receives zeros;
* ``broadcast_out=True`` under autograd raises;
* the dense LM (smoke qwen2-0.5b at four layers) in four stages of one
  through ``pipelined_loss_fn``: the loss and every gradient leaf (a
  stage's layers as its slice; the embedding and final norm summed over
  the stages) against ``jax.value_and_grad`` of the reference's
  un-pipelined ``loss_fn`` (1e-5 and 1e-4 of each leaf's scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as R_cfgs
from repro.models.model import build_model as r_build
from repro_torch import configs as T_cfgs

import _torch_ranks

S_STAGES, L_PER, D = 4, 2, 16
M, MB = 4, 2
SENDRECV = _torch_ranks.COLLECTIVES.index("sendrecv")


def _layer_stack(w_stage, x):
    def body(x, w):
        return jnp.tanh(x @ w), None

    x, _ = jax.lax.scan(body, x, w_stage)
    return x


def _sequential(w, xm):
    y = xm
    for s in range(S_STAGES):
        y = jax.vmap(lambda v: _layer_stack(w[s * L_PER:(s + 1) * L_PER], v))(y)
    return y


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((S_STAGES * L_PER, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    out = _torch_ranks.run_ranks(_torch_ranks.pipeline_rank, S_STAGES,
                                 tmp_path_factory.mktemp("pipeline"), W, x, L_PER)
    return W, x, out


def test_forward_matches_the_sequential_run(ranks):
    W, x, out = ranks
    ref = np.asarray(_sequential(jnp.asarray(W), jnp.asarray(x)))
    for r in out:
        np.testing.assert_allclose(r["out"], ref, atol=1e-5, rtol=1e-5)


def test_pipelined_loss_gradient_matches_jax_grad(ranks):
    W, x, out = ranks
    loss_ref = lambda w: jnp.sum(_sequential(w, jnp.asarray(x)) ** 2)  # noqa: E731
    want = np.asarray(jax.grad(loss_ref)(jnp.asarray(W)))
    assert [int(r["stage"]) for r in out] == list(range(S_STAGES))
    got = np.concatenate([r["grad"] for r in out])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for r in out:
        np.testing.assert_allclose(float(r["loss"]), float(loss_ref(jnp.asarray(W))),
                                   rtol=1e-5)


def test_every_hop_and_its_gradient_go_through_the_abi(ranks):
    _, x, out = ranks
    for r in out:
        # forward: M + S - 1 hops and the closing bcast
        assert r["fwd"][SENDRECV] == M + S_STAGES - 1
        assert r["fwd"][_torch_ranks.COLLECTIVES.index("bcast")] == 1
        assert r["loss_fwd"][SENDRECV] == M + S_STAGES - 1
        assert r["loss_bwd"][SENDRECV] == M + S_STAGES - 1
        assert r["loss_bwd"].sum() == M + S_STAGES - 1
    # a rank that receives from nobody gets zeros, as from ppermute
    assert not out[0]["recv"].any()
    for s in range(1, S_STAGES):
        np.testing.assert_array_equal(out[s]["recv"], x[0] + 1.0)


def test_broadcast_out_raises_under_autograd(ranks):
    for r in ranks[2]:
        assert "broadcast_out=True does not differentiate" in str(r["raise_msg"])


def test_pipelined_lm_matches_the_reference_loss_and_gradient(tmp_path):
    rcfg = dataclasses.replace(R_cfgs.smoke_config("qwen2-0.5b"), num_layers=S_STAGES)
    tcfg = dataclasses.replace(T_cfgs.smoke_config("qwen2-0.5b"), num_layers=S_STAGES)
    api = r_build(rcfg)
    params = api.init(jax.random.PRNGKey(0))
    tok = np.random.default_rng(2).integers(0, 512, size=(4, 16)).astype(np.int32)
    batch = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    loss, grads = jax.value_and_grad(api.loss_fn)(params, {k: jnp.asarray(v)
                                                           for k, v in batch.items()})
    names = [".".join(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(grads)[0]]
    want = dict(zip(names, (np.asarray(g) for g in jax.tree.leaves(grads))))
    out = _torch_ranks.run_ranks(_torch_ranks.pipeline_lm_rank, S_STAGES, tmp_path, tcfg,
                                 jax.tree.map(np.asarray, params), batch, 2)
    for r in out:
        s, n = int(r["stage"]), int(r["layers"])
        np.testing.assert_allclose(float(r["loss"]), float(loss), rtol=1e-5)
        got = {k.split(":", 1)[1]: v for k, v in r.items() if k.startswith("grad:")}
        assert sorted(got) == sorted(want)
        for name, g in got.items():
            w = want[name][s * n:(s + 1) * n] if name.startswith("layers.") else want[name]
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
