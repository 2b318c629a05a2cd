"""The port's checkpointer against the reference, on the CPU: the twin of
the checkpoint tests of ``tests/test_substrate.py``, and the bridge — a
checkpoint is the state's binary interface, so a step saved by either
package restores in the other.

* round trip, retention, async save and atomic publish;
* a JAX ``Checkpointer`` save of a smoke qwen2-0.5b ZeRO-1 state (bfloat16
  parameters, one step taken, on the f32 and the bf16 wire) restores into
  the port equal to ``from_jax_params`` plus the same moments, residual and
  step; the port's save of that state restores in the JAX ``Checkpointer``
  with the same names, leaf bytes and dtype descriptors (``|V2`` for
  bfloat16), the same manifest keys and the same ``treedef`` string;
* the deliberate difference: the reference hands a bfloat16 leaf back as
  ``|V2``, the port restores it as bfloat16 (the skeleton's dtype);
* a skeleton whose names or shapes differ raises ``ValueError`` naming
  both, and nothing is reshaped.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as r_cfgs
from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.core.compat import make_mesh
from repro.models import build_model as r_build
from repro.optim.adamw import AdamWConfig as RAdam
from repro.runtime.dist import make_dist as r_make_dist
from repro.train import train_loop as r_tl

import repro_torch.configs as t_cfgs
from repro_torch.checkpoint import Checkpointer
from repro_torch.models import build_model as t_build
from repro_torch.models import from_jax_params, param_leaves
from repro_torch.optim import adamw
from repro_torch.runtime.dist import make_dist
from repro_torch.train import train_loop as t_tl


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    state = {"w": torch.arange(6.0).reshape(2, 3), "n": torch.tensor(7, dtype=torch.int32)}
    for step in (1, 2, 3):
        ck.save(step, {k: v * step for k, v in state.items()})
    assert ck.latest_step() == 3
    restored, step = ck.restore(state)
    assert step == 3 and torch.equal(restored["w"], torch.arange(6.0).reshape(2, 3) * 3)
    assert restored["n"].dtype == torch.int32 and int(restored["n"]) == 21
    assert len(list(tmp_path.glob("step_*"))) == 2


def test_checkpoint_async_and_atomicity(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save_async(5, {"w": torch.ones(128, 128)})
    ck.wait()
    assert ck.latest_step() == 5 and not list(tmp_path.glob(".tmp_*"))
    assert ck.last_save["bytes"] > 128 * 128 * 4 and ck.last_save["crc_ms"] >= 0


def test_checkpoint_keeps_structure_and_devices(tmp_path):
    ck = Checkpointer(tmp_path)
    state = {"b": [torch.ones(2), (torch.zeros(1, dtype=torch.int64),)], "a": None}
    ck.save(1, state)
    restored, _ = ck.restore(state)
    assert restored["a"] is None and isinstance(restored["b"][1], tuple)
    assert restored["b"][1][0].dtype == torch.int64 and list(restored) == ["b", "a"]


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------
def _cfg(mod, compression, zero1=True):
    cfg = mod.smoke_config("qwen2-0.5b")
    return dataclasses.replace(cfg, param_dtype="bfloat16", parallelism=dataclasses.replace(
        cfg.parallelism, zero1=zero1, zero1_buckets=2, grad_compression=compression))


_REF: dict = {}


def _reference(compression, tmp_path_factory, zero1=True):
    """A JAX state after one step (ZeRO-1, or per-leaf moments with
    ``zero1=False``), saved by the JAX Checkpointer."""
    if (compression, zero1) not in _REF:
        cfg = _cfg(r_cfgs, compression, zero1)
        api = r_build(cfg)
        dist = r_make_dist(make_mesh((1, 1), ("data", "model")), impl="paxi",
                           compression=compression)
        state = r_tl.init_state(api, jax.random.PRNGKey(0), dist=dist)
        tok = np.random.default_rng(0).integers(0, 512, size=(4, 16)).astype(np.int32)
        batch = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(np.roll(tok, -1, 1))}
        state, _ = jax.jit(r_tl.make_train_step(api, dist, RAdam()))(state, batch)
        d = tmp_path_factory.mktemp(f"jax-{compression}-{zero1}")
        RCheckpointer(d).save(1, state)
        _REF[compression, zero1] = (state, d)
    return _REF[compression, zero1]


def _port_skeleton(compression, dist, zero1=True):
    return t_tl.init_state(t_build(_cfg(t_cfgs, compression, zero1)), 0, dist)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.fixture(scope="module")
def world():
    with make_dist(device="cpu") as d:
        yield d


@pytest.mark.parametrize("compression", [None, "bf16"])
def test_a_jax_checkpoint_restores_into_the_port(world, tmp_path_factory, compression):
    rstate, d = _reference(compression, tmp_path_factory)
    like = _port_skeleton(compression, world)
    state, step = Checkpointer(d, dist=world).restore(like)
    assert step == 1 and state.params is like.params
    want = from_jax_params(jax.tree.map(np.asarray, rstate.params), _cfg(t_cfgs, compression),
                           device="cpu")
    dtypes = set()
    for (n, p), (_, q) in zip(param_leaves(state.params), param_leaves(want)):
        assert p.dtype == q.dtype, n
        dtypes.add(p.dtype)
        view = torch.int16 if p.element_size() == 2 else torch.int32
        assert torch.equal(p.view(view), q.view(view)), n
    assert torch.bfloat16 in dtypes
    for f in ("m", "v", "ef"):
        np.testing.assert_array_equal(getattr(state.opt, f).numpy(),
                                      np.asarray(getattr(rstate.opt, f)), err_msg=f)
    assert int(state.opt.step) == int(rstate.opt.step) and int(state.step) == 1
    world.drop_zero1_plans()


@pytest.mark.parametrize("compression", [None, "bf16"])
def test_a_port_checkpoint_restores_in_the_jax_checkpointer(world, tmp_path_factory,
                                                            compression):
    rstate, rdir = _reference(compression, tmp_path_factory)
    like = _port_skeleton(compression, world)
    state, _ = Checkpointer(rdir, dist=world).restore(like)
    out = tmp_path_factory.mktemp(f"port-{compression}")
    Checkpointer(out, dist=world).save(1, state)
    world.drop_zero1_plans()
    rman = json.loads((rdir / "step_0000000001" / "manifest.json").read_text())
    tman = json.loads((out / "step_0000000001" / "manifest.json").read_text())
    assert set(tman) == set(rman)
    assert tman["names"] == rman["names"] and tman["n_leaves"] == rman["n_leaves"]
    assert tman["treedef"] == rman["treedef"]
    restored, step = RCheckpointer(out).restore(rstate)
    assert step == 1
    want = jax.tree.leaves(rstate)
    got = jax.tree.leaves(restored)
    with np.load(rdir / "step_0000000001" / "shard_0.npz") as rz, \
            np.load(out / "step_0000000001" / "shard_0.npz") as tz:
        for i in range(rman["n_leaves"]):
            a, b = rz[f"leaf_{i}"], tz[f"leaf_{i}"]
            assert a.dtype.str == b.dtype.str and a.shape == b.shape, rman["names"][i]
            assert a.tobytes() == b.tobytes(), rman["names"][i]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_bf16_leaves_restore_as_v2_in_the_reference_and_bf16_in_the_port(tmp_path):
    """The reference's ``np.savez`` writes bfloat16 as ``|V2`` and hands it
    back as ``|V2``; the port restores by the skeleton's dtype."""
    w = np.arange(4, dtype=np.float32) / 3
    RCheckpointer(tmp_path).save(1, {"w": jnp.asarray(w).astype(jnp.bfloat16),
                                     "m": jnp.zeros(3, jnp.float32)})
    ref, _ = RCheckpointer(tmp_path).restore({"w": 0, "m": 0})
    assert ref["w"].dtype.str == "|V2" and ref["m"].dtype == np.float32
    port, _ = Checkpointer(tmp_path).restore({"w": torch.zeros(4, dtype=torch.bfloat16),
                                              "m": torch.zeros(3)})
    assert port["w"].dtype == torch.bfloat16
    assert torch.equal(port["w"], torch.from_numpy(w).to(torch.bfloat16))
    np.testing.assert_array_equal(port["w"].view(torch.int16).numpy(),
                                  ref["w"].view(np.int16))


def test_a_mismatched_skeleton_raises_naming_both(world, tmp_path_factory):
    _, d = _reference(None, tmp_path_factory)
    with pytest.raises(ValueError, match=r"\.params\['embed'\].*\['other'\]"):
        Checkpointer(d).restore({"params": {"other": torch.zeros(1)}})
    like = _port_skeleton(None, world)
    world.drop_zero1_plans()
    short = like._replace(opt=like.opt._replace(m=torch.zeros(like.opt.m.shape[0] - 2)))
    with pytest.raises(ValueError, match=r"\.opt\.m: checkpoint shape \(\d+,\) does not "
                                         r"match the state's \(\d+,\)"):
        Checkpointer(d).restore(short)


# ---------------------------------------------------------------------------
# the per-leaf layout (zero1=False): moments nested like the parameters
# ---------------------------------------------------------------------------
def test_a_jax_per_leaf_checkpoint_restores_into_the_port(world, tmp_path_factory):
    """The reference's per-leaf moments are trees shaped like its params, so
    its file names them ``.opt.m['embed']['tok']``; the port's skeleton has
    the same names and takes every moment bitwise."""
    rstate, d = _reference(None, tmp_path_factory, zero1=False)
    like = _port_skeleton(None, world, zero1=False)
    assert world.zero1_plans is None
    state, step = Checkpointer(d, dist=world).restore(like)
    assert step == 1 and int(state.opt.step) == int(rstate.opt.step) == 1
    names = [n for n, _ in param_leaves(state.params)]
    for f in ("m", "v"):
        got = adamw.tree_leaves(getattr(state.opt, f))
        want = jax.tree.leaves(getattr(rstate.opt, f))
        assert len(got) == len(want) == len(names)
        assert any(float(np.abs(np.asarray(w)).max()) > 0 for w in want)
        for n, g, w in zip(names, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{f} {n}")


def test_a_port_per_leaf_checkpoint_restores_in_the_jax_checkpointer(world, tmp_path_factory):
    """The port's per-leaf save has the reference's manifest: the same
    names (``.opt.m['layers']['attn']['wq']``, ...), ``n_leaves`` and
    ``treedef`` string, and the same leaf bytes, and the reference restores
    it into its own state."""
    rstate, rdir = _reference(None, tmp_path_factory, zero1=False)
    like = _port_skeleton(None, world, zero1=False)
    state, _ = Checkpointer(rdir, dist=world).restore(like)
    out = tmp_path_factory.mktemp("port-per-leaf")
    Checkpointer(out, dist=world).save(1, state)
    rman = json.loads((rdir / "step_0000000001" / "manifest.json").read_text())
    tman = json.loads((out / "step_0000000001" / "manifest.json").read_text())
    assert set(tman) == set(rman)
    assert tman["names"] == rman["names"] and tman["n_leaves"] == rman["n_leaves"]
    assert tman["treedef"] == rman["treedef"]
    assert ".opt.m['embed']['tok']" in tman["names"]
    with np.load(rdir / "step_0000000001" / "shard_0.npz") as rz, \
            np.load(out / "step_0000000001" / "shard_0.npz") as tz:
        for i in range(rman["n_leaves"]):
            a, b = rz[f"leaf_{i}"], tz[f"leaf_{i}"]
            assert a.dtype.str == b.dtype.str and a.shape == b.shape, rman["names"][i]
            assert a.tobytes() == b.tobytes(), rman["names"][i]
    restored, step = RCheckpointer(out).restore(rstate)
    assert step == 1
    for g, w in zip(jax.tree.leaves(restored), jax.tree.leaves(rstate)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
