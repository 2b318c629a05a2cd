"""Rank programs of ``test_torch_ssm_tp.py``: the ssm (rwkv6) and hybrid
(zamba2) families on the model axis (tensor parallelism, FSDP under
``gspmd``) on gloo worlds of two and four CPU ranks.  One world runs every
case it is given and saves, per case, what the test holds against the
reference: the rank's block, the full logits, the split decode's logits
and state, the losses and grad norms of each step, and this rank's block
of every parameter after the steps."""
from pathlib import Path

import numpy as np


def state_block(cfg, tp_rank: int, tp_size: int, state: dict) -> dict:
    """This rank's block of a whole decode state given as numpy leaves by
    name (``shift_tm``, ``shift_cm``, ``wkv``; ``conv``, ``ssm``, ``k``,
    ``v``), as ``init_state(..., model_axis=tp_size)`` holds it: the heads
    over the model axis, the Mamba2 conv window's channels per segment
    (its x, B and C channels' blocks)."""
    from repro_torch.models.tensor_parallel import Part, TP, held_layout, is_split

    part = Part(tp_rank, tp_size)
    held = held_layout(cfg, part)
    out = dict(state)
    if cfg.family == "ssm":
        if is_split(held["layers.wr"]):
            w = state["wkv"]
            out["wkv"] = w[part.index(w.shape, (None, None, TP))]
        return out
    if is_split(held["layers.in_proj"]):
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        conv = state["conv"]
        out["conv"] = conv[part.index(conv.shape, (None, None, None, TP),
                                      (d_inner, s.state_size, s.state_size))]
        out["ssm"] = state["ssm"][part.index(state["ssm"].shape, (None, None, TP))]
    if is_split(held["shared.attn.wk"]):
        for k in ("k", "v"):
            out[k] = state[k][part.index(state[k].shape, (None, None, None, TP))]
    return out


def _state(cfg, tree) -> dict:
    """A port decode state as numpy leaves by name."""
    if cfg.family == "ssm":
        return {k: getattr(tree, k).float().numpy() for k in ("shift_tm", "shift_cm", "wkv")}
    return {"conv": tree.mamba.conv.float().numpy(), "ssm": tree.mamba.ssm.numpy(),
            "k": tree.attn_kv.k.float().numpy(), "v": tree.attn_kv.v.float().numpy()}


def _load_state(cfg, api, tree, block: dict) -> None:
    """Write ``block`` (numpy leaves by name) into the port state ``tree``."""
    import torch

    if cfg.family == "ssm":
        leaves = {k: getattr(tree, k) for k in ("shift_tm", "shift_cm", "wkv")}
    else:
        leaves = {"conv": tree.mamba.conv, "ssm": tree.mamba.ssm, "k": tree.attn_kv.k,
                  "v": tree.attn_kv.v}
    for k, t in leaves.items():
        t.copy_(torch.from_numpy(block[k]).to(t.dtype))


def ssm_tp_rank(rank, world, init_method, out_dir, model_axis, cases, steps):
    """``cases``: (name, port config, reference weights as numpy, global
    batch as numpy, decode: None or (the prefix length P, the reference's
    state after P tokens as numpy leaves by name, or None: the gradient
    and the forward's logits only, no step)).  With a decode the
    logits of the full forward, ``last_only`` and of a decode step at each
    position after P (on this rank's block of the reference's state) come
    first, with the state after them and the gradient of the whole batch's
    loss at the initial weights; then ``steps`` steps of the config's
    ``grad_sync`` on the rank's rows (mesh (world / model_axis,
    model_axis))."""
    import torch

    from repro_torch.models import build_model, from_jax_params, param_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop

    torch.set_num_threads(1)
    out = {}
    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   model_axis=model_axis) as dist:
        for name, cfg, np_params, batch, decode in cases:
            api = build_model(cfg)
            model = from_jax_params(np_params, cfg, device="cpu",
                                    **train_loop.model_part(api, dist))
            part = model.part
            out[f"{name}:part"] = np.array([part.tp_rank, part.tp_size, part.fsdp_rank,
                                            part.fsdp_size])
            out[f"{name}:split"] = np.array(sorted(n for n, s in model.held.items()
                                                   if "tp" in s))
            out[f"{name}:fsdp"] = np.array(sorted(n for n, s in model.held.items()
                                                  if "fsdp" in s))
            for leaf, p in param_leaves(model):
                out[f"{name}:held:{leaf}"] = p.detach().numpy().copy()
            if decode is not None:
                # the gradient of the whole batch's loss at the initial weights
                leaves = param_leaves(model)
                loss = api.loss_fn(model, {k: torch.from_numpy(batch[k])
                                           for k in ("tokens", "targets")}, dist)
                for (leaf, _), g in zip(leaves, torch.autograd.grad(
                        loss, [p for _, p in leaves], materialize_grads=True)):
                    out[f"{name}:grad:{leaf}"] = g.numpy()
                P, ref_state = decode
                tokens = torch.from_numpy(batch["tokens"])
                if ref_state is None:  # the forward and the gradient only
                    with torch.no_grad():
                        out[f"{name}:logits"] = api.forward(model, {"tokens": tokens},
                                                            dist).numpy()
                    continue
                B, S = tokens.shape
                with torch.no_grad():
                    out[f"{name}:logits"] = api.forward(model, {"tokens": tokens},
                                                        dist).numpy()
                    out[f"{name}:last"] = api.forward(model, {"tokens": tokens}, dist,
                                                      last_only=True).numpy()
                    state = api.decode_init(B, S, device="cpu", model_axis=part.tp_size)
                    _load_state(cfg, api, state,
                                state_block(cfg, part.tp_rank, part.tp_size, ref_state))
                    steps_out = []
                    for i in range(P, S):
                        logits, state = api.decode_step(model, tokens[:, i:i + 1], state, i,
                                                        dist)
                        steps_out.append(logits.numpy())
                out[f"{name}:decode"] = np.stack(steps_out)
                for k, v in _state(cfg, state).items():
                    out[f"{name}:state:{k}"] = v
            if not steps:
                continue
            state = train_loop.init_state(api, 0, dist, model=model)
            step = train_loop.make_train_step(api, dist, AdamWConfig())
            local = train_loop.local_batch({k: batch[k] for k in ("tokens", "targets")}, dist)
            losses, norms = [], []
            for _ in range(steps):
                state, met = step(state, local)
                losses.append(float(met.loss))
                norms.append(float(met.grad_norm))
            out[f"{name}:losses"] = np.array(losses)
            out[f"{name}:grad_norms"] = np.array(norms)
            for leaf, p in param_leaves(state.params):
                out[f"{name}:param:{leaf}"] = p.detach().numpy().copy()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
