"""The port's MoE block (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``), on the CPU at a small size, float32, the same numpy
inputs and the reference's own weights (``init_moe``).

* ``_route``: experts equal, gates within 1e-6, the aux loss within 1e-6;
* dispatch and combine where the capacity binds: ``slot`` and ``keep``
  bitwise (the stable sort decides the drops), buffer and output within
  1e-6;
* the padding experts receive no token;
* ``moe_block`` in local mode within 1e-5, its gradient with respect to x
  and every leaf within 1e-4 of ``jax.grad`` (XLA and torch sum the
  products in other orders);
* expert parallelism at ``model_axis=2``: two gloo ranks against the
  reference's EP output, computed once in a subprocess with two fake CPU
  devices (in process the tests see one), at a capacity where EP and local
  mode differ, so the test tells them apart.
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

import repro.configs as R_cfgs
from repro.models import moe as r_moe
from repro_torch import configs as T_cfgs
from repro_torch.models import moe as t_moe

import _torch_ranks

ARCH = "qwen2-moe-a2.7b"
SRC = Path(__file__).resolve().parent.parent / "src"


def _cfgs(**moe):
    """Both packages' smoke config with the MoE fields changed: six real
    experts padded to eight, top-2, one shared expert."""
    change = dict(num_experts=6, padded_experts=8, top_k=2, **moe)
    out = []
    for mod in (R_cfgs, T_cfgs):
        cfg = mod.smoke_config(ARCH)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **change)))
    return out


def _params(rcfg, seed=0):
    """The reference's block weights, as numpy and as the port's tensors."""
    p = jax.tree.map(np.asarray, r_moe.init_moe(jax.random.PRNGKey(seed), rcfg, jnp.float32))
    return p, jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)


def _x(B, S, d=64, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_route_matches_the_reference():
    rcfg, tcfg = _cfgs()
    p, tp = _params(rcfg)
    xf = _x(1, 96)[0]
    g, e, aux = r_moe._route(p, jnp.asarray(xf), rcfg.moe)
    tg, te, taux = t_moe._route(tp["router"], torch.from_numpy(xf), tcfg.moe)
    np.testing.assert_array_equal(_np(te), np.asarray(e))
    np.testing.assert_allclose(_np(tg), np.asarray(g), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(aux), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("factor,T", [(0.5, 64), (1.25, 96)])
def test_dispatch_and_combine_drop_as_the_reference(factor, T):
    """Both dispatches take the reference's routing of the same tokens."""
    rcfg, tcfg = _cfgs(capacity_factor=factor)
    p, _ = _params(rcfg)
    xf = _x(1, T)[0]
    m = rcfg.moe
    g, e, _ = r_moe._route(p, jnp.asarray(xf), m)
    C = r_moe._capacity(T, m.top_k, m.num_experts, factor)
    assert C == t_moe._capacity(T, m.top_k, m.num_experts, factor)
    buf, comb = r_moe._dispatch_sort(jnp.asarray(xf), e, g, m.padded_experts, C)
    tbuf, tcomb = t_moe._dispatch_sort(torch.from_numpy(xf), torch.from_numpy(np.array(e)),
                                       torch.from_numpy(np.array(g)), m.padded_experts, C)
    st, sg, slot, keep = (np.asarray(a) for a in comb)
    assert not keep.all(), "the capacity must bind in this case"
    np.testing.assert_array_equal(_np(tcomb[2]), slot)
    np.testing.assert_array_equal(_np(tcomb[3]), keep)
    np.testing.assert_array_equal(_np(tcomb[0]), st)
    np.testing.assert_array_equal(_np(tcomb[1]), sg)
    np.testing.assert_allclose(_np(tbuf), np.asarray(buf), atol=1e-6, rtol=1e-6)
    # combine the same expert outputs (the buffer scaled, so every slot differs)
    out = np.asarray(buf) * np.linspace(0.5, 1.5, buf.shape[1], dtype=np.float32)[None, :, None]
    want = r_moe._combine_sort(jnp.asarray(out), comb, T, xf.shape[1])
    got = t_moe._combine_sort(torch.from_numpy(out), tcomb, T, xf.shape[1])
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_padding_experts_receive_no_token():
    _, tcfg = _cfgs(capacity_factor=4.0)
    rcfg, _ = _cfgs(capacity_factor=4.0)
    _, tp = _params(rcfg)
    m = tcfg.moe
    xf = torch.from_numpy(_x(1, 256, seed=5)[0]) * 10.0
    g, e, _ = t_moe._route(tp["router"], xf, m)
    assert int(e.max()) < m.num_experts
    C = t_moe._capacity(256, m.top_k, m.num_experts, m.capacity_factor)
    buf, _ = t_moe._dispatch_sort(xf, e, g, m.padded_experts, C)
    assert buf.shape[0] == m.padded_experts
    assert not buf[m.num_experts:].any()
    assert buf[:m.num_experts].any(-1).sum() == 256 * m.top_k


def _block_loss(y, aux, w):
    return (y * w).sum() + aux


@pytest.mark.parametrize("factor", [0.5, 4.0])
def test_moe_block_local_and_its_gradient_match_the_reference(factor):
    rcfg, tcfg = _cfgs(capacity_factor=factor)
    p, _ = _params(rcfg)
    x = _x(2, 24)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def r_loss(params, xx):
        y, aux = r_moe.moe_block(params, xx, rcfg)
        return _block_loss(y, aux, jnp.asarray(w)), (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(r_loss, argnums=(0, 1),
                                                         has_aux=True))(p, jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = t_moe.moe_block(tp, tx, tcfg)
    np.testing.assert_allclose(_np(ty), np.asarray(y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(taux.item(), float(aux), atol=1e-6, rtol=1e-6)
    leaves, tdef = jax.tree.flatten(tp)
    grads = torch.autograd.grad(_block_loss(ty, taux, torch.from_numpy(w)), [tx, *leaves])
    np.testing.assert_allclose(_np(grads[0]), np.asarray(gx), atol=1e-4, rtol=1e-4)
    want = jax.tree.leaves(gp)
    assert len(want) == len(leaves)
    for got_g, want_g, (path, _) in zip(grads[1:], want,
                                        jax.tree_util.tree_flatten_with_path(gp)[0]):
        np.testing.assert_allclose(_np(got_g), np.asarray(want_g), atol=1e-4, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# expert parallelism at model_axis=2
# ---------------------------------------------------------------------------
EP_FACTOR = 1.0
EP_SHAPE = (2, 16)
_EP_SCRIPT = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
import repro.configs as R
from repro.core.compat import make_mesh
from repro.models import moe
from repro.runtime.dist import make_dist
cfg = R.smoke_config("qwen2-moe-a2.7b")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, num_experts=6, padded_experts=8, top_k=2, capacity_factor=float(sys.argv[2])))
with np.load(sys.argv[1] + "/in.npz") as f:
    x = jnp.asarray(f["x"])
p = moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
dist = make_dist(make_mesh((1, 2), ("data", "model")))
assert dist.tp_size == 2
y, aux = jax.jit(lambda p, x: moe.moe_block(p, x, cfg, dist))(p, x)
yl, auxl = jax.jit(lambda p, x: moe.moe_block(p, x, cfg))(p, x)
np.savez(sys.argv[1] + "/out.npz", y=np.asarray(y), aux=np.asarray(aux),
         y_local=np.asarray(yl), aux_local=np.asarray(auxl))
"""


@pytest.fixture(scope="module")
def ep_reference(tmp_path_factory):
    """The reference's EP and local outputs on two fake CPU devices."""
    d = tmp_path_factory.mktemp("moe_ep_ref")
    x = _x(*EP_SHAPE, seed=7)
    np.savez(d / "in.npz", x=x)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _EP_SCRIPT, str(d), str(EP_FACTOR)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(d / "out.npz") as f:
        return x, {k: f[k] for k in f.files}


def test_expert_parallel_matches_the_reference_on_two_ranks(ep_reference, tmp_path):
    x, ref = ep_reference
    # EP routes each rank's half with its own capacity, so it is another
    # function than local mode here: the test tells the two apart
    assert np.abs(ref["y"] - ref["y_local"]).max() > 1e-2
    rcfg, tcfg = _cfgs(capacity_factor=EP_FACTOR)
    p, _ = _params(rcfg)
    ranks = _torch_ranks.run_ranks(_torch_ranks.moe_ep_rank, 2, tmp_path, tcfg, p, x)
    for r in ranks:
        assert int(r["tp_size"]) == 2
        np.testing.assert_allclose(r["y"], ref["y"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(r["aux"]), float(ref["aux"]), atol=1e-6, rtol=1e-6)
    # and the port's local mode is the reference's local mode
    with torch.no_grad():
        yl, auxl = t_moe.moe_block(_params(rcfg)[1], torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(yl), ref["y_local"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(auxl), float(ref["aux_local"]), atol=1e-6, rtol=1e-6)
