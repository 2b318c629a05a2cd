"""The port's sharding rules, parameter specs and ``gspmd`` step
(``repro_torch.runtime.sharding``, ``ModelApi.param_specs``,
``train_loop.make_train_step_gspmd``) against the reference, on the CPU.

* the twins of ``tests/test_sharding_rules.py`` (divisibility guard,
  mesh-axis dedup, the batch axis tuple, manual-axis stripping);
* every port config's ``param_specs(fsdp, tp)`` equal to the reference's
  read as tuples, for ``fsdp`` None and ``"data"``, with the parameters'
  keys; ``state_specs`` likewise;
* ``AxisRules.placements`` on a ``DeviceMesh`` of a two-rank CPU world,
  and tensors distributed with them;
* the ``gspmd`` step against the reference's at one rank (smoke
  chatglm3-6b, 3 steps, rtol 1e-4), the twin of ``test_train_modes_agree``,
  and the step at dp=2 on two gloo ranks against the reference on two
  fake devices.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as R_cfgs
from repro.core.compat import make_mesh
from repro.models.model import build_model as r_build
from repro.optim.adamw import AdamWConfig as R_Adam
from repro.runtime.dist import make_dist as r_make_dist
from repro.train import train_loop as r_tl
from repro_torch import configs as T_cfgs
from repro_torch.models import build_model as t_build
from repro_torch.models import from_jax_params, param_leaves
from repro_torch.models.model import _family, leaf_splits
from repro_torch.models.transformer import held_layout
from repro_torch.optim.adamw import AdamWConfig as T_Adam
from repro_torch.runtime.dist import make_dist as t_make_dist
from repro_torch.runtime.sharding import AxisRules, _strip_axes, production_rules
from repro_torch.train import train_loop as t_tl

import _torch_ranks

SRC = Path(__file__).resolve().parent.parent / "src"
GSPMD_ARCH = "chatglm3-6b"
GSPMD_STEPS = 3
#: the key bias's exact gradient is zero (a softmax ignores a shift shared
#: by a query's scores), so each package's is rounding noise, which Adam's
#: normalised step turns into moves of up to ``lr`` a step either way
NOISE_LEAVES = ("layers.attn.bk",)


def _params_close(name, got, want, steps):
    """A parameter after ``steps`` Adam steps from the same weights: within
    2e-5 (``lr * mhat / sqrt(vhat)`` amplifies gradient rounding where a
    gradient is near zero, as in test_torch_train_slice), or, for a leaf
    whose gradient is pure rounding, within twice Adam's step bound."""
    atol = 2 * T_Adam().lr * steps if name in NOISE_LEAVES else 2e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the rules: twins of tests/test_sharding_rules.py
# ---------------------------------------------------------------------------
@pytest.fixture()
def rules():
    return production_rules(pod=True, sequence_parallel=True,
                            axis_sizes={"pod": 2, "data": 16, "model": 16})


def test_divisibility_guard(rules):
    # heads=14 does not divide model=16 -> constraint dropped
    assert rules.to_spec_for((4, 4096, 14, 64), "batch", "seq", "heads", None)[2] is None
    spec = rules.to_spec_for((4, 4096, 32, 64), "batch", "seq", "heads", None)
    assert spec[2] == "model" or spec[2] is None  # seq wins the model axis
    r2 = production_rules(pod=True, sequence_parallel=False,
                          axis_sizes={"pod": 2, "data": 16, "model": 16})
    assert r2.to_spec_for((4, 4096, 32, 64), "batch", "seq", "heads", None)[2] == "model"


def test_mesh_axis_dedup(rules):
    """seq and heads both map to model; the earlier dim wins, no duplicate."""
    spec = rules.to_spec_for((4, 4096, 32, 64), "batch", "seq", "heads", None)
    flat = []
    for part in spec:
        if isinstance(part, tuple):
            flat.extend(part)
        elif part is not None:
            flat.append(part)
    assert len(flat) == len(set(flat)), spec
    assert spec[1] == "model"


def test_batch_axis_tuple(rules):
    assert rules.to_spec_for((64, 128), "batch", None)[0] == ("pod", "data")
    assert rules.to_spec_for((3, 128), "batch", None)[0] is None


def test_strip_manual_axes():
    assert _strip_axes((("pod", "data"), "model", None),
                       frozenset({"pod", "data"})) == (None, "model", None)
    assert _strip_axes((("pod", "data"),), frozenset({"pod"})) == ("data",)


def test_rules_match_the_reference_for_every_logical_axis():
    from repro.runtime.sharding import production_rules as r_rules

    sizes = {"pod": 2, "data": 4, "model": 8}
    for seqpar in (False, True):
        t = production_rules(pod=True, sequence_parallel=seqpar, axis_sizes=sizes)
        r = r_rules(pod=True, sequence_parallel=seqpar, axis_sizes=sizes)
        assert t.rules == r.rules
        for logical in (("batch", "seq", "heads", None), ("batch", "kv_seq", "kv_heads"),
                        ("experts", "embed", "ffn"), ("vocab", "state")):
            shape = (16,) * len(logical)
            assert t.to_spec_for(shape, *logical) == tuple(r.to_spec_for(shape, *logical))
            assert t.to_spec(*logical) == tuple(r.to_spec(*logical))


def test_use_rules_shard_and_fsdp_spec_match_the_reference():
    from repro.runtime import sharding as r_sh
    from repro_torch.runtime import sharding as t_sh

    rules = production_rules(axis_sizes={"data": 2, "model": 2})
    assert t_sh.current_rules() is None
    with t_sh.use_rules(rules):
        assert t_sh.current_rules() is rules
        x = torch.ones(4, 8)
        assert t_sh.shard(x, "batch", "embed") is x   # a rank's tensor is its part
    assert t_sh.current_rules() is None
    for dims in (("fsdp", "tp"), ("tp", None, "fsdp"), (None,)):
        for fsdp in (None, "data", ("pod", "data")):
            assert t_sh.fsdp_spec(*dims, fsdp=fsdp, tp="model") == tuple(
                r_sh.fsdp_spec(*dims, fsdp=fsdp, tp="model"))


def test_dist_builds_the_meshs_rules():
    with t_make_dist(device="cpu") as d:
        assert d.rules.rules == production_rules(pod=False, data_axes=("data",)).rules
        assert d.rules.axis_sizes == {"data": 1, "model": 1}


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    assert isinstance(tree, P), tree
    return tuple(tree)


def _keys(tree, path=""):
    out = []
    for k, v in tree.items():
        out += _keys(v, f"{path}{k}.") if isinstance(v, dict) else [f"{path}{k}"]
    return sorted(out)


@pytest.mark.parametrize("fsdp", [None, "data"])
@pytest.mark.parametrize("arch", T_cfgs.ARCH_NAMES)
def test_param_specs_match_the_reference(arch, fsdp):
    want = _as_tuples(r_build(R_cfgs.get_config(arch)).param_specs(fsdp=fsdp, tp="model"))
    tcfg = T_cfgs.get_config(arch)
    got = t_build(tcfg).param_specs(fsdp=fsdp, tp="model")
    assert got == want
    model = _family(tcfg)[1](tcfg, "meta")
    names = [n for n, _ in param_leaves(model)]
    assert _keys(got) == sorted(names)
    for n, p in param_leaves(model):
        node = got
        for part in n.split("."):
            node = node[part]
        assert len(node) <= p.ndim, n


@pytest.mark.parametrize("mode,dp_axes", [("abi", ("data",)), ("abi", None), ("gspmd", None)])
def test_state_specs_match_the_reference(mode, dp_axes):
    arch = "qwen2-moe-a2.7b"
    want = r_tl.state_specs(r_build(R_cfgs.get_config(arch)), mode, dp_axes=dp_axes)
    got = t_tl.state_specs(t_build(T_cfgs.get_config(arch)), mode, dp_axes=dp_axes)
    assert got.params == _as_tuples(want.params)
    assert got.step == tuple(want.step)
    for name in got.opt._fields:
        g, w = getattr(got.opt, name), getattr(want.opt, name)
        assert g == (_as_tuples(w) if isinstance(w, dict) else tuple(w)), name


def test_held_specs_split_only_the_experts_under_ep():
    """What a qwen2-moe rank at ``model_axis=2`` holds is the reference's
    layout (``param_specs(fsdp=None)``, each axis kept where it divides):
    its experts, the shared experts' FFN and the vocabulary split over the
    model axis, the attention whole (the smoke config's four heads do not
    divide its production axis of 16), the router, the shared gate and the
    norms whole; each split block is the whole draw's block."""
    cfg = T_cfgs.smoke_config("qwen2-moe-a2.7b")
    api = t_build(cfg)
    whole = api.init(0, "cpu")
    part = api.init(0, "cpu", model_rank=1, model_axis=2)
    names = [n for n, _ in param_leaves(part)]
    assert not any(leaf_splits(whole)[0])
    split = leaf_splits(part)[0]
    held = {n: tuple("model" if e == "tp" else e for e in spec)
            for n, spec in held_layout(cfg, part.part).items()}
    want = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                want[prefix + k] = v

    walk(_as_tuples(r_build(R_cfgs.smoke_config("qwen2-moe-a2.7b")).param_specs(fsdp=None)), "")
    assert held == want
    assert [n for n, k in zip(names, split) if k] == [
        "embed.tok", "embed.unembed", "layers.moe.experts.wg", "layers.moe.experts.wi",
        "layers.moe.experts.wo", "layers.moe.shared.wg", "layers.moe.shared.wi",
        "layers.moe.shared.wo"]
    # rank 1's block is the whole draw's: the second half of every layer's
    # experts, and of the vocabulary's rows
    for n in ("wi", "wg", "wo"):
        w = getattr(whole.layers.moe.experts, n)
        np.testing.assert_array_equal(getattr(part.layers.moe.experts, n).detach().numpy(),
                                      w[:, 2:].detach().numpy())
    np.testing.assert_array_equal(part.embed.tok.detach().numpy(),
                                  whole.embed.tok[256:].detach().numpy())
    np.testing.assert_array_equal(part.layers.moe.router.detach().numpy(),
                                  whole.layers.moe.router.detach().numpy())


def test_placements_on_a_device_mesh(tmp_path):
    from torch.distributed.tensor import Replicate, Shard

    ranks = _torch_ranks.run_ranks(_torch_ranks.placements_rank, 2, tmp_path)
    want = {"experts": (Replicate(), Shard(0)), "batch": (Replicate(), Replicate()),
            "ffn": (Replicate(), Shard(1)), "uneven": (Replicate(), Replicate())}
    for r, rank in enumerate(ranks):
        for name, pl in want.items():
            assert list(rank[f"{name}:placements"]) == [repr(p) for p in pl], name
            assert bool(rank[f"{name}:same_as_port_mesh"]), name
        full = np.arange(8 * 6 * 4, dtype=np.float32).reshape(8, 6, 4)
        np.testing.assert_array_equal(rank["experts:local"], full[4 * r:4 * (r + 1)])
        full = np.arange(6 * 8, dtype=np.float32).reshape(6, 8)
        np.testing.assert_array_equal(rank["ffn:local"], full[:, 4 * r:4 * (r + 1)])
        assert rank["uneven:local"].shape == (6, 5)


# ---------------------------------------------------------------------------
# the gspmd step
# ---------------------------------------------------------------------------
def _gspmd_cfg(mod, mode="gspmd", **par):
    cfg = mod.smoke_config(GSPMD_ARCH)
    return dataclasses.replace(cfg, parallelism=dataclasses.replace(
        cfg.parallelism, grad_sync=mode, **par))


def _batch(B=2, S=16, seed=1):
    tok = np.random.default_rng(seed).integers(0, 512, size=(B, S)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


@pytest.fixture(scope="module")
def gspmd_reference():
    """The reference's gspmd step at one device: losses, grad norms and
    the parameters after ``GSPMD_STEPS`` steps, from its own init."""
    cfg = _gspmd_cfg(R_cfgs)
    api = r_build(cfg)
    dist = r_make_dist(make_mesh((1, 1), ("data", "model")), impl="paxi")
    state = r_tl.init_state(api, jax.random.PRNGKey(1))
    init = jax.tree.map(np.asarray, state.params)
    step = jax.jit(r_tl.make_train_step(api, dist, R_Adam()))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    losses, norms = [], []
    for _ in range(GSPMD_STEPS):
        state, met = step(state, batch)
        losses.append(float(met.loss))
        norms.append(float(met.grad_norm))
    return init, losses, norms, [np.asarray(l) for l in jax.tree.leaves(state.params)]


def _port_run(init, mode, steps=GSPMD_STEPS, **par):
    cfg = _gspmd_cfg(T_cfgs, mode, **par)
    api = t_build(cfg)
    with t_make_dist(device="cpu") as dist:
        state = t_tl.init_state(api, 0, dist, model=from_jax_params(init, cfg, device="cpu"))
        step = t_tl.make_train_step(api, dist, T_Adam())
        batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
        losses, norms = [], []
        for _ in range(steps):
            state, met = step(state, batch)
            losses.append(float(met.loss))
            norms.append(float(met.grad_norm))
    return losses, norms, [p.detach().numpy() for _, p in param_leaves(state.params)], state


def test_gspmd_step_matches_the_reference_at_one_rank(gspmd_reference):
    init, losses, norms, params = gspmd_reference
    t_losses, t_norms, t_params, state = _port_run(init, "gspmd")
    assert isinstance(state.opt, t_tl.AdamState)
    np.testing.assert_allclose(t_losses, losses, rtol=1e-4)
    np.testing.assert_allclose(t_norms, norms, rtol=1e-4)
    names = [n for n, _ in param_leaves(state.params)]
    assert len(t_params) == len(params)
    for name, got, want in zip(names, t_params, params):
        _params_close(name, got, want, GSPMD_STEPS)


def test_train_modes_agree(gspmd_reference):
    """abi-mode (per-leaf DDP) and gspmd-mode steps give the same loss
    trajectory at one rank, where the gradient sync is the identity."""
    init = gspmd_reference[0]
    abi = _port_run(init, "abi", zero1=False)[0]
    gspmd = _port_run(init, "gspmd")[0]
    np.testing.assert_allclose(abi, gspmd, rtol=1e-4)


_DP2_SCRIPT = """
import sys
import numpy as np
import jax
import repro.configs as R
from repro.core.compat import make_mesh
from repro.models.model import build_model
from repro.optim.adamw import AdamWConfig
from repro.runtime.dist import make_dist
from repro.train import train_loop
import dataclasses

d, steps = sys.argv[1], int(sys.argv[2])
with np.load(d + "/in.npz") as f:
    batch = {k: jax.numpy.asarray(f[k]) for k in f.files}
cfg = R.smoke_config(sys.argv[3])
cfg = dataclasses.replace(cfg, parallelism=dataclasses.replace(cfg.parallelism,
                                                               grad_sync="gspmd"))
dist = make_dist(make_mesh((2, 1), ("data", "model")))
assert dist.dp_size == 2
api = build_model(cfg)
state = train_loop.init_state(api, jax.random.PRNGKey(1))
names = lambda tree: [".".join(k.key for k in p) for p, _ in
                      jax.tree_util.tree_flatten_with_path(tree)[0]]
out = {f"init:{n}": np.asarray(l) for n, l in zip(names(state.params),
                                                    jax.tree.leaves(state.params))}
step = jax.jit(train_loop.make_train_step(api, dist, AdamWConfig()))
losses, norms = [], []
for _ in range(steps):
    state, met = step(state, batch)
    losses.append(float(met.loss))
    norms.append(float(met.grad_norm))
out["losses"], out["grad_norms"] = np.array(losses), np.array(norms)
for n, l in zip(names(state.params), jax.tree.leaves(state.params)):
    out[f"param:{n}"] = np.asarray(l)
np.savez(d + "/out.npz", **out)
"""


def test_gspmd_step_at_dp_two_matches_the_reference(tmp_path):
    """Two gloo ranks, each with its half of the batch, the gradients'
    mean through ``torch.distributed`` on the dp group (no ABI call in
    the step), against the reference's gspmd step on two fake devices."""
    batch = _batch(B=4)
    np.savez(tmp_path / "in.npz", **batch)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _DP2_SCRIPT, str(tmp_path), "2", GSPMD_ARCH],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp_path / "out.npz") as f:
        ref = {k: f[k] for k in f.files}
    init = {}
    for k, v in ref.items():
        if k.startswith("init:"):
            *path, leaf = k.split(":", 1)[1].split(".")
            node = init
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
    cfg = _gspmd_cfg(T_cfgs)
    (rank_dir := tmp_path / "ranks").mkdir()
    ranks = _torch_ranks.run_ranks(_torch_ranks.gspmd_rank, 2, rank_dir, cfg, init, batch, 2)
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=1e-4)
        np.testing.assert_allclose(rank["grad_norms"], ref["grad_norms"], rtol=1e-4)
        # no collective through the ABI (the step only asks its dp rank)
        assert set(rank["abi_calls"]) <= {"comm_rank"}, rank["abi_calls"]
        for k in ref:
            if k.startswith("param:"):
                _params_close(k.split(":", 1)[1], rank[k], ref[k], 2)
    for k in ranks[0]:
        if k.startswith("param:"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
