"""Expert-parallel training on a 2 x 2 (data x model) world: the port's
ZeRO-1 step for qwen2-moe-a2.7b's smoke config on four gloo ranks against
the reference's ABI step on four fake CPU devices, ``(data, model) = (2, 2)``.

    PYTHONPATH=src python tests/torch_ep_battery.py   # prints "TORCH EP BATTERY PASSED"

Each rank holds its model rank's block (``transformer.held_layout``: its
two experts of each layer, the shared experts' FFN and the vocabulary rows)
and trains on its data rows; its flat ZeRO-1 vector (its own leaves) is
reduce-scattered over its column of the mesh.  Checks, over two steps:
losses and grad norms within 1e-5 of the reference's, every parameter
within 1e-5 (a split leaf against its block), every replicated leaf
bitwise equal on the four ranks, and each split leaf bitwise equal on the
two data rows.  Not collected by pytest
(it takes longer than the CPU suite's budget for one leg).
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
sys.path.insert(0, str(SRC))
sys.path.insert(0, str(HERE))

import _torch_ranks  # noqa: E402

STEPS = 2
TOL = 1e-5
DP, TP = 2, 2
_SCRIPT = """
import sys
import numpy as np
import jax
import repro.configs as R
from repro.core.compat import make_mesh
from repro.models.model import build_model
from repro.optim.adamw import AdamWConfig
from repro.runtime.dist import make_dist
from repro.train import train_loop

d, steps = sys.argv[1], int(sys.argv[2])
with np.load(d + "/in.npz") as f:
    batch = {k: jax.numpy.asarray(f[k]) for k in f.files}
cfg = R.smoke_config("qwen2-moe-a2.7b")
dist = make_dist(make_mesh((2, 2), ("data", "model")))
assert (dist.dp_size, dist.tp_size) == (2, 2)
names = lambda tree: [".".join(k.key for k in p) for p, _ in
                      jax.tree_util.tree_flatten_with_path(tree)[0]]
api = build_model(cfg)
state = train_loop.init_state(api, jax.random.PRNGKey(0), dist=dist)
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


def ep_grid_rank(rank, world, init_method, out_dir, cfg, np_params, batch, steps):
    """The config's ZeRO-1 step on a (data, model) = (world / TP, TP) mesh,
    on this rank's data rows, from its model rank's part of the weights."""
    import torch

    from repro_torch.models import build_model, from_jax_params, param_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop

    torch.set_num_threads(1)
    with make_dist(device="cpu", model_axis=TP, world_size=world, rank=rank,
                   init_method=init_method) as dist:
        r = dist.abi.comm_rank(dist.tp_comm)
        api = build_model(cfg)
        model = from_jax_params(np_params, cfg, device="cpu", model_rank=r, model_axis=TP)
        state = train_loop.init_state(api, 0, dist, model=model)
        step = train_loop.make_train_step(api, dist, AdamWConfig())
        local = train_loop.local_batch(batch, dist)
        losses, norms = [], []
        for _ in range(steps):
            state, met = step(state, local)
            losses.append(float(met.loss))
            norms.append(float(met.grad_norm))
        out = {f"param:{n}": p.detach().numpy() for n, p in param_leaves(state.params)}
        np.savez(Path(out_dir) / f"rank{rank}.npz", losses=np.array(losses),
                 grad_norms=np.array(norms), model_rank=np.array(r),
                 data_rank=np.array(dist.abi.comm_rank(dist.dp_comm)), **out)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def main() -> int:
    import repro_torch.configs as T_cfgs

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        tok = np.random.default_rng(3).integers(0, 512, size=(4, 16)).astype(np.int32)
        batch = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
        np.savez(d / "in.npz", **batch)
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={DP * TP}",
                   JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
        proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(d), str(STEPS)], env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:])
            return 1
        with np.load(d / "out.npz") as f:
            ref = {k: f[k] for k in f.files}
        init = _nest({k.split(":", 1)[1]: v for k, v in ref.items() if k.startswith("init:")})
        (d / "ranks").mkdir()
        ranks = _torch_ranks.run_ranks(ep_grid_rank, DP * TP, d / "ranks",
                                       T_cfgs.smoke_config("qwen2-moe-a2.7b"), init, batch,
                                       STEPS, timeout=300)
    from repro_torch.models.transformer import TransformerLM

    cfg = T_cfgs.smoke_config("qwen2-moe-a2.7b")
    held = {r: TransformerLM(cfg, "meta", r, TP) for r in range(TP)}
    print(f"reference losses {ref['losses']} grad norms {ref['grad_norms']}")
    names = [k for k in ref if k.startswith("param:")]
    for i, rank in enumerate(ranks):
        r = int(rank["model_rank"])
        print(f"rank {i} (data {int(rank['data_rank'])}, model {r}): losses {rank['losses']} "
              f"grad norms {rank['grad_norms']}")
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=TOL)
        np.testing.assert_allclose(rank["grad_norms"], ref["grad_norms"], rtol=TOL)
        for k in names:
            m = held[r]
            want = ref[k][m.part.index(ref[k].shape, m.held[k[len("param:"):]])]
            np.testing.assert_allclose(rank[k], want, rtol=TOL, atol=TOL, err_msg=k)
    for k in names:
        if "tp" in held[0].held[k[len("param:"):]]:
            for r in range(TP):
                same = [x[k] for x in ranks if int(x["model_rank"]) == r]
                assert all(np.array_equal(same[0], y) for y in same[1:]), k
        else:
            assert all(np.array_equal(ranks[0][k], x[k]) for x in ranks[1:]), k
    print("TORCH EP BATTERY PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
