"""Shared checks of the port's encdec (whisper-tiny) and vlm
(phi-3-vision-4.2b) families against the reference, on the CPU at the
smoke size in float32: the reference's weights (key 0) through
``from_jax_params`` and numpy-seeded batches.  Used by
``test_torch_encdec.py`` and ``test_torch_vlm.py``."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as R_cfgs
from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.core.compat import make_mesh
from repro.models import build_model as r_build
from repro.models.model import analytic_param_count as r_param_count
from repro.optim.adamw import AdamWConfig as R_Adam
from repro.runtime.dist import make_dist as r_make_dist
from repro.train import train_loop as r_tl

import repro_torch.configs as T_cfgs
from repro_torch.checkpoint import Checkpointer
from repro_torch.models import analytic_param_count as t_param_count
from repro_torch.models import build_model as t_build
from repro_torch.models import from_jax_params, param_leaves
from repro_torch.models.model import _family
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig as T_Adam
from repro_torch.runtime.dist import make_dist
from repro_torch.train import train_loop as t_tl

F32 = dict(param_dtype="float32", compute_dtype="float32")
#: the config's training shape, as the full configs train: remat "full",
#: two microbatches (frames and patches split along the batch like tokens)
TRAIN = dict(microbatch=2, remat="full", zero1=True)
STEPS = 3


def cfgs(arch: str, **change) -> tuple:
    """(reference config, port config): the smoke config in float32."""
    return tuple(dataclasses.replace(m.smoke_config(arch), **F32, **change)
                 for m in (R_cfgs, T_cfgs))


@functools.lru_cache(maxsize=None)
def reference_params(arch: str) -> dict:
    params = jax.jit(r_build(cfgs(arch)[0]).init)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def port_model(arch: str, tcfg=None):
    return from_jax_params(reference_params(arch), tcfg or cfgs(arch)[1], device="cpu")


def batch(arch: str, B: int = 2, S: int = 32, seed: int = 3) -> dict:
    """numpy: tokens, targets (the tokens shifted left by one) and the
    family's frontend input, N(0, 1) in float32."""
    rcfg = cfgs(arch)[0]
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, rcfg.vocab_size, size=(B, S)).astype(np.int32)
    out = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    if rcfg.encdec is not None:
        out["frames"] = rng.standard_normal(
            (B, rcfg.encdec.encoder_frames, rcfg.d_model)).astype(np.float32)
    if rcfg.vlm is not None:
        out["patches"] = rng.standard_normal(
            (B, rcfg.vlm.num_patches, rcfg.vlm.patch_embed_dim)).astype(np.float32)
    return out


def jb(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def np32(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t,
                                                                                     np.float32)


def flat(tree) -> dict:
    return {".".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# forward, loss, gradient
# ---------------------------------------------------------------------------
def check_forward_loss_and_grads(arch: str, tol: float, grad_tol: float) -> None:
    """Logits, ``last_only``, loss and every gradient leaf (within
    ``grad_tol`` of the leaf's largest magnitude) against the reference."""
    rcfg, tcfg = cfgs(arch)
    rapi, tapi = r_build(rcfg), t_build(tcfg)
    params = jax.tree.map(jnp.asarray, reference_params(arch))
    b = batch(arch)
    want, _ = jax.jit(rapi.forward)(params, jb(b))
    loss, grads = jax.jit(jax.value_and_grad(rapi.loss_fn))(params, jb(b))
    model = port_model(arch)
    with torch.no_grad():
        got = tapi.forward(model, tb(b))
        last = tapi.forward(model, tb(b), last_only=True)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(np32(got), np.asarray(want), atol=tol, rtol=tol)
    assert tuple(last.shape) == (b["tokens"].shape[0], 1, rcfg.vocab_size)
    np.testing.assert_allclose(np32(last), np32(got)[:, -1:], atol=tol, rtol=tol)
    tloss = tapi.loss_fn(model, tb(b))
    np.testing.assert_allclose(tloss.item(), float(loss), atol=tol, rtol=tol)
    leaves = param_leaves(model)
    tgrads = torch.autograd.grad(tloss, [p for _, p in leaves])
    ref = flat(grads)
    # the ZeRO-1 flat vector's order: the reference's jax.tree.leaves order
    assert list(ref) == [n for n, _ in leaves]
    for (name, _), g in zip(leaves, tgrads):
        r = np.asarray(ref[name])
        scale = float(np.abs(r).max())
        assert scale > 0, name
        err = float(np.abs(np32(g) - r).max())
        assert err <= grad_tol * scale, (name, err, scale)


def check_remat(arch: str) -> None:
    """The loss and every gradient bitwise under ``remat="full"`` (each
    layer body a non-reentrant checkpoint, recomputed in the backward) and
    ``"none"``."""
    out = []
    for remat in ("none", "full"):
        tcfg = cfgs(arch)[1]
        tcfg = dataclasses.replace(tcfg, parallelism=dataclasses.replace(tcfg.parallelism,
                                                                          remat=remat))
        model = port_model(arch, tcfg)
        loss = t_build(tcfg).loss_fn(model, tb(batch(arch)))
        out.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ---------------------------------------------------------------------------
# specs and counts
# ---------------------------------------------------------------------------
def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _keys(tree, path=""):
    out = []
    for k, v in tree.items():
        out += _keys(v, f"{path}{k}.") if isinstance(v, dict) else [f"{path}{k}"]
    return sorted(out)


def check_specs(arch: str) -> None:
    """``param_specs`` equal to the reference's ``spec_lm`` read as tuples,
    with the parameters' tree, no spec longer than its leaf's rank."""
    rcfg, tcfg = R_cfgs.get_config(arch), T_cfgs.get_config(arch)
    for fsdp in (None, "data"):
        want = _as_tuples(r_build(rcfg).param_specs(fsdp=fsdp, tp="model"))
        got = t_build(tcfg).param_specs(fsdp=fsdp, tp="model")
        assert got == want
    model = _family(tcfg)[1](tcfg, "meta")
    assert _keys(got) == [n for n, _ in param_leaves(model)]
    for n, p in param_leaves(model):
        node = got
        for part in n.split("."):
            node = node[part]
        assert len(node) <= p.ndim, n


def check_full_size(arch: str, analytic: int, actual: int) -> None:
    """The config equal to the reference's; ``analytic_param_count`` equal
    to the reference's and to ``analytic``; a meta-device build with the
    reference's names, shapes and dtypes (``jax.eval_shape``) and
    ``actual`` parameters; nothing allocated."""
    rcfg, tcfg = R_cfgs.get_config(arch), T_cfgs.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    assert t_param_count(tcfg) == r_param_count(rcfg) == analytic
    want = flat(jax.eval_shape(r_build(rcfg).init, jax.random.PRNGKey(0)))
    model = _family(tcfg)[1](tcfg, "meta")
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert p.is_meta
        assert tuple(p.shape) == want[name].shape, name
        assert str(p.dtype).removeprefix("torch.") == str(want[name].dtype), name
    assert sum(p.numel() for p in got.values()) == actual


# ---------------------------------------------------------------------------
# the ABI ZeRO-1 step
# ---------------------------------------------------------------------------
def _train_cfgs(arch: str, zero1: bool = True) -> tuple:
    return tuple(dataclasses.replace(c, parallelism=dataclasses.replace(
        c.parallelism, **dict(TRAIN, zero1=zero1))) for c in cfgs(arch))


@functools.lru_cache(maxsize=None)
def zero1_run(arch: str) -> tuple:
    """Three ZeRO-1 steps of the reference (``mesh1``, ``paxi``, jitted)
    and of the port (a gloo world of one) from the same weights (key 0,
    the reference's ``init_state``) on the same batch of four rows:
    (the reference's losses and grad norms, the port's, the reference's
    final state)."""
    rcfg, tcfg = _train_cfgs(arch)
    b = batch(arch, B=4, S=16, seed=5)
    rapi = r_build(rcfg)
    rdist = r_make_dist(make_mesh((1, 1), ("data", "model")), impl="paxi")
    rstate = r_tl.init_state(rapi, jax.random.PRNGKey(0), dist=rdist)
    rstep = jax.jit(r_tl.make_train_step(rapi, rdist, R_Adam()))
    ref = []
    for _ in range(STEPS):
        rstate, met = rstep(rstate, jb(b))
        ref.append((float(met.loss), float(met.grad_norm)))
    tapi = t_build(tcfg)
    port = []
    with make_dist(device="cpu") as dist:
        state = t_tl.init_state(tapi, 0, dist, model=port_model(arch, tcfg))
        assert isinstance(state.opt, adamw.FlatAdamState)
        step = t_tl.make_train_step(tapi, dist, T_Adam())
        for _ in range(STEPS):
            state, met = step(state, tb(b))
            port.append((float(met.loss), float(met.grad_norm)))
    return ref, port, rstate


def check_zero1_steps(arch: str, tol: float) -> None:
    ref, port, _ = zero1_run(arch)
    assert all(np.isfinite(port).ravel())
    np.testing.assert_allclose(np.array(port)[:, 0], np.array(ref)[:, 0], atol=tol, rtol=tol)
    np.testing.assert_allclose(np.array(port)[:, 1], np.array(ref)[:, 1], rtol=1e-4)


def check_gspmd_matches_abi(arch: str) -> None:
    """The ``gspmd`` step (per-leaf AdamW, one process) from the same
    weights on the same batch: losses and grad norms within 1e-5 of the
    ABI ZeRO-1 step's (the twin of the reference's
    ``test_train_modes_agree``)."""
    _, tcfg = _train_cfgs(arch)
    tcfg = dataclasses.replace(tcfg, parallelism=dataclasses.replace(tcfg.parallelism,
                                                                      grad_sync="gspmd"))
    tapi = t_build(tcfg)
    b = batch(arch, B=4, S=16, seed=5)
    got = []
    with make_dist(device="cpu") as dist:
        state = t_tl.init_state(tapi, 0, dist, model=port_model(arch, tcfg))
        assert isinstance(state.opt, adamw.AdamState)
        step = t_tl.make_train_step(tapi, dist, T_Adam())
        for _ in range(STEPS):
            state, met = step(state, tb(b))
            got.append((float(met.loss), float(met.grad_norm)))
    np.testing.assert_allclose(got, zero1_run(arch)[1], rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints: the reference's format both ways
# ---------------------------------------------------------------------------
def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def check_checkpoint_crossing(arch: str, tmp_path, zero1: bool) -> list:
    """A reference state (the ZeRO-1 run's after its steps, or a per-leaf
    one as ``init_state`` builds it) saved by the JAX ``Checkpointer``
    restores into the port's skeleton leaf for leaf; the port's save of it
    has the reference's manifest (names, ``n_leaves``, ``treedef``) and leaf
    bytes, and restores in the JAX ``Checkpointer``.  Returns the names."""
    rcfg, tcfg = _train_cfgs(arch, zero1)
    if zero1:
        rstate = zero1_run(arch)[2]
    else:
        rdist = r_make_dist(make_mesh((1, 1), ("data", "model")), impl="paxi")
        rstate = r_tl.init_state(r_build(rcfg), jax.random.PRNGKey(0), dist=rdist)
    rdir, tdir = tmp_path / "jax", tmp_path / "port"
    RCheckpointer(rdir).save(1, rstate)
    with make_dist(device="cpu") as dist:
        like = t_tl.init_state(t_build(tcfg), 0, dist)
        state, step = Checkpointer(rdir, dist=dist).restore(like)
        assert step == 1
        want = jax.tree.leaves(rstate.params)
        got = [p for _, p in param_leaves(state.params)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
        if zero1:
            for f in ("m", "v"):
                np.testing.assert_array_equal(getattr(state.opt, f).numpy(),
                                              np.asarray(getattr(rstate.opt, f)))
        else:
            for f in ("m", "v"):
                for g, w in zip(adamw.tree_leaves(getattr(state.opt, f)),
                                jax.tree.leaves(getattr(rstate.opt, f))):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        Checkpointer(tdir, dist=dist).save(1, state)
        dist.drop_zero1_plans()
    rman = json.loads((rdir / "step_0000000001" / "manifest.json").read_text())
    tman = json.loads((tdir / "step_0000000001" / "manifest.json").read_text())
    assert set(tman) == set(rman)
    for key in ("names", "n_leaves", "treedef"):
        assert tman[key] == rman[key], key
    with np.load(rdir / "step_0000000001" / "shard_0.npz") as rz, \
            np.load(tdir / "step_0000000001" / "shard_0.npz") as tz:
        for i in range(rman["n_leaves"]):
            a, b = rz[f"leaf_{i}"], tz[f"leaf_{i}"]
            assert a.dtype.str == b.dtype.str and a.shape == b.shape, rman["names"][i]
            assert a.tobytes() == b.tobytes(), rman["names"][i]
    restored, step = RCheckpointer(tdir).restore(rstate)
    assert step == 1
    for g, w in zip(jax.tree.leaves(restored), jax.tree.leaves(rstate)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    return tman["names"]
