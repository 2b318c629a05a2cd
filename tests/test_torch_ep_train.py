"""Expert-parallel training of the moe family at ``model_axis=2`` against
the reference, on the CPU at the smoke size (four experts, top-2, one
shared expert), float32.

The reference runs once in a subprocess with two fake CPU devices
(``(data, model) = (1, 2)``): ``jax.value_and_grad`` of ``loss_fn`` through
its ``shard_map`` with the aux-loss weight at 0.01 (the config's) and at 0,
and its ABI ZeRO-1 step for two steps.  The port runs on two gloo ranks,
each holding its block of the model axis (``from_jax_params`` with the
model rank): its two experts of each layer, and where the model axis
divides them (``transformer.held_layout``; the smoke config's four heads
do not divide its production axis of 16) the shared experts' FFN and the
vocabulary:

* the loss and every gradient leaf within 1e-5 (a split leaf against its
  rank's block) at both aux weights — with 0.01 the aux loss is the mean of
  the ranks' per-slice terms, another function than local mode's;
* the ABI calls of the EP block's backward: per layer the inverse alltoall
  pair, the sequence slice's allgather and the router's allreduce;
* the ZeRO-1 step's losses and grad norms within 1e-5 and its parameters
  within 1e-5 after two steps, each rank's flat shard its own leaves, and
  the per-leaf step's likewise;
* every replicated leaf bitwise equal on the two ranks, every split leaf
  different.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch.configs as T_cfgs
from repro_torch.models.transformer import TransformerLM

import _torch_ranks

ARCH = "qwen2-moe-a2.7b"
SRC = Path(__file__).resolve().parent.parent / "src"
AUX = (0.01, 0.0)
STEPS = 2
TOL = 1e-5
_SCRIPT = """
import sys
import numpy as np
import jax
import repro.configs as R
from repro.core.compat import make_mesh
from repro.models.model import build_model
from repro.optim.adamw import AdamWConfig
from repro.runtime.dist import make_dist
from repro.runtime.sharding import use_rules
from repro.train import train_loop
import dataclasses

d, steps = sys.argv[1], int(sys.argv[2])
aux_weights = [float(a) for a in sys.argv[3].split(",")]
with np.load(d + "/in.npz") as f:
    batch = {k: jax.numpy.asarray(f[k]) for k in f.files}
base = R.smoke_config("qwen2-moe-a2.7b")
dist = make_dist(make_mesh((1, 2), ("data", "model")))
assert dist.tp_size == 2
names = lambda tree: [".".join(k.key for k in p) for p, _ in
                      jax.tree_util.tree_flatten_with_path(tree)[0]]
out = {}
for aux in aux_weights:
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, aux_loss_weight=aux))
    api = build_model(cfg)
    params = api.init(jax.random.PRNGKey(0))
    def lf(p):
        with use_rules(dist.rules):
            return api.loss_fn(p, batch, dist)
    loss, g = jax.jit(jax.value_and_grad(lf))(params)
    out[f"{aux}:loss"] = np.asarray(loss)
    for n, leaf in zip(names(g), jax.tree.leaves(g)):
        out[f"{aux}:grad:{n}"] = np.asarray(leaf)
api = build_model(base)
state = train_loop.init_state(api, jax.random.PRNGKey(0), dist=dist)
for n, leaf in zip(names(state.params), jax.tree.leaves(state.params)):
    out[f"init:{n}"] = np.asarray(leaf)
step = jax.jit(train_loop.make_train_step(api, dist, AdamWConfig()))
losses, norms = [], []
for _ in range(steps):
    state, met = step(state, batch)
    losses.append(float(met.loss))
    norms.append(float(met.grad_norm))
out["losses"], out["grad_norms"] = np.array(losses), np.array(norms)
for n, leaf in zip(names(state.params), jax.tree.leaves(state.params)):
    out[f"param:{n}"] = np.asarray(leaf)
np.savez(d + "/out.npz", **out)
"""


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _rank_model(r: int, R: int = 2) -> TransformerLM:
    """The (meta) model rank ``r`` of the model axis builds: its held layout."""
    return TransformerLM(T_cfgs.smoke_config(ARCH), "meta", r, R)


def _is_split(name: str) -> bool:
    return "tp" in _rank_model(0).held[name]


def _mine(name: str, full: np.ndarray, r: int) -> np.ndarray:
    """A leaf's block on rank ``r`` (each layer's experts, the shared
    experts' FFN columns or rows, the vocabulary's rows), a whole leaf
    whole."""
    m = _rank_model(r)
    return full[m.part.index(full.shape, m.held[name])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_train_ref")
    tok = np.random.default_rng(3).integers(0, 512, size=(4, 16)).astype(np.int32)
    batch = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    np.savez(d / "in.npz", **batch)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(d), str(STEPS),
                           ",".join(map(str, AUX))], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "out.npz") as f:
        ref = {k: f[k] for k in f.files}
    init = _nest({k.split(":", 1)[1]: v for k, v in ref.items() if k.startswith("init:")})
    cfg = T_cfgs.smoke_config(ARCH)
    ranks = _torch_ranks.run_ranks(_torch_ranks.ep_train_rank, 2,
                                   tmp_path_factory.mktemp("ep_train"), cfg, init, batch,
                                   AUX, STEPS)
    return ref, ranks


@pytest.mark.parametrize("aux", AUX)
def test_ep_loss_and_every_gradient_leaf_match_jax_grad(runs, aux):
    ref, ranks = runs
    names = [k.split(":", 2)[2] for k in ref if k.startswith(f"{aux}:grad:")]
    assert len(names) == 20
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(float(rank[f"{aux}:loss"]), float(ref[f"{aux}:loss"]),
                                   rtol=TOL)
        for n in names:
            want = _mine(n, ref[f"{aux}:grad:{n}"], r)
            got = rank[f"{aux}:grad:{n}"]
            assert got.shape == want.shape, n
            np.testing.assert_allclose(got, want, rtol=TOL,
                                       atol=TOL * max(np.abs(want).max(), 1e-30), err_msg=n)


def test_aux_weight_moves_the_router_gradient(runs):
    """The aux loss reaches the router through the EP split of its value
    and gradient: the two weights give other router gradients."""
    ref, ranks = runs
    key = "grad:layers.moe.router"
    assert np.abs(ref[f"0.01:{key}"] - ref[f"0.0:{key}"]).max() > 1e-4
    np.testing.assert_array_equal(ranks[0][f"0.01:{key}"], ranks[1][f"0.01:{key}"])


@pytest.mark.parametrize("aux", AUX)
def test_ep_backward_collectives_go_through_the_abi(runs, aux):
    _, ranks = runs
    layers = T_cfgs.smoke_config(ARCH).num_layers
    col = {k: i for i, k in enumerate(_torch_ranks.COLLECTIVES)}
    for rank in ranks:
        fwd, bwd = rank[f"{aux}:fwd"], rank[f"{aux}:bwd"]
        # forward a layer: two alltoalls, the closing allgather, the aux mean
        assert (fwd[col["alltoall"]], fwd[col["allgather"]], fwd[col["allreduce"]]) == (
            2 * layers, layers, layers)
        # backward a layer: the inverse alltoalls, the slice's allgather,
        # the router's sum; the closing allgather's backward sends nothing
        assert (bwd[col["alltoall"]], bwd[col["allgather"]], bwd[col["allreduce"]]) == (
            2 * layers, layers, layers)


@pytest.mark.parametrize("layout", ["zero1", "leaf"])
def test_ep_step_matches_the_reference_abi_step(runs, layout):
    """The ZeRO-1 step (each rank's flat shard its own leaves) and the
    per-leaf step against the reference's ZeRO-1 step."""
    ref, ranks = runs
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank[f"{layout}:losses"], ref["losses"], rtol=TOL)
        np.testing.assert_allclose(rank[f"{layout}:grad_norms"], ref["grad_norms"], rtol=TOL)
        assert int(rank["held_experts"]) == 2
        names = [k.split(":", 1)[1] for k in ref if k.startswith("param:")]
        assert len(names) == 20
        for n in names:
            np.testing.assert_allclose(rank[f"{layout}:param:{n}"],
                                       _mine(n, ref[f"param:{n}"], r), rtol=TOL, atol=TOL,
                                       err_msg=n)
    assert ranks[0][f"{layout}:losses"][-1] < ranks[0][f"{layout}:losses"][0]


@pytest.mark.parametrize("layout", ["zero1", "leaf"])
def test_replicated_leaves_stay_bitwise_equal_on_the_model_axis(runs, layout):
    _, (a, b) = runs
    names = [k for k in a if k.startswith(f"{layout}:param:")]
    assert len(names) == 20
    assert int(a["flat_shard"]) == int(b["flat_shard"])
    assert _is_split("layers.moe.experts.wi") and not _is_split("layers.moe.router")
    for k in names:
        if _is_split(k.split(":", 2)[2]):
            assert not np.array_equal(a[k], b[k]), k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
