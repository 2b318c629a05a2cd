"""Rank programs of ``test_torch_moe_tp.py``: the moe family on the model
axis (tensor parallelism beside expert parallelism, FSDP under ``gspmd``)
on gloo worlds of two and four CPU ranks.  One world runs every case it is
given and saves, per case, what the test holds against the reference: the
rank's block, the full logits, the prefill's cache and the split decode's
logits, the losses and grad norms of each step, and this rank's block of
every parameter after the steps."""
from pathlib import Path

import numpy as np


def moe_tp_rank(rank, world, init_method, out_dir, model_axis, cases, steps):
    """``cases``: (name, port config, reference weights as numpy, global
    batch as numpy, forward: bool).  With ``forward`` the logits,
    ``last_only``, the prefill's cache of all but the last token and the
    logits of a decode step on this rank's K/V heads of the reference's
    cache (float32 ``cache_k``/``cache_v`` in the batch) come first; then
    ``steps`` steps of the config's ``grad_sync`` on the rank's rows
    (mesh (world / model_axis, model_axis)), with their alltoalls and the
    smallest share of a dispatch's assignments kept."""
    import torch

    from repro_torch.core import CallCounter
    from repro_torch.models import build_model, from_jax_params, moe, param_leaves
    from repro_torch.models.transformer import prefill
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop

    torch.set_num_threads(1)
    out = {}
    kept = []
    dispatch = moe._dispatch_sort

    def counted(*args):
        buf, combine = dispatch(*args)
        kept.append(float(combine[3].float().mean()))
        return buf, combine

    moe._dispatch_sort = counted
    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   model_axis=model_axis) as dist:
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        for name, cfg, np_params, batch, forward in cases:
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
            if forward:
                tokens = torch.from_numpy(batch["tokens"])
                with torch.no_grad():
                    cc.reset()
                    out[f"{name}:logits"] = api.forward(model, {"tokens": tokens},
                                                        dist).numpy()
                    out[f"{name}:alltoalls"] = np.array(cc.counts.get("alltoall", 0))
                    out[f"{name}:last"] = api.forward(model, {"tokens": tokens}, dist,
                                                      last_only=True).numpy()
                    S = tokens.shape[1]
                    _, cache, _ = prefill(model, tokens[:, :S - 1], cfg, dist, max_seq=S)
                    kv = cache.k.shape[3]
                    out[f"{name}:cache_heads"] = np.array(kv)
                    out[f"{name}:cache_k"] = cache.k.float().numpy()
                    out[f"{name}:cache_v"] = cache.v.float().numpy()
                    r = part.tp_rank if kv < cfg.num_kv_heads else 0
                    ref = type(cache)(*(torch.from_numpy(
                        batch[k][..., r * kv:(r + 1) * kv, :]).to(torch.bfloat16)
                        for k in ("cache_k", "cache_v")))
                    logits, _ = api.decode_step(model, tokens[:, S - 1:], ref, S - 1, dist)
                    out[f"{name}:decode"] = logits.numpy()
            if name.endswith("@odd"):
                # the gradient of the whole batch's loss at the initial weights
                leaves = param_leaves(model)
                loss = api.loss_fn(model, {k: torch.from_numpy(batch[k])
                                           for k in ("tokens", "targets")}, dist)
                for (leaf, _), g in zip(leaves, torch.autograd.grad(
                        loss, [p for _, p in leaves])):
                    out[f"{name}:grad:{leaf}"] = g.numpy()
            if not steps:
                continue
            state = train_loop.init_state(api, 0, dist, model=model)
            step = train_loop.make_train_step(api, dist, AdamWConfig())
            local = train_loop.local_batch({k: batch[k] for k in ("tokens", "targets")}, dist)
            losses, norms = [], []
            cc.reset()
            kept.clear()
            for _ in range(steps):
                state, met = step(state, local)
                losses.append(float(met.loss))
                norms.append(float(met.grad_norm))
            out[f"{name}:step_alltoalls"] = np.array(cc.counts.get("alltoall", 0))
            out[f"{name}:kept"] = np.array(min(kept))
            out[f"{name}:losses"] = np.array(losses)
            out[f"{name}:grad_norms"] = np.array(norms)
            for leaf, p in param_leaves(state.params):
                out[f"{name}:param:{leaf}"] = p.detach().numpy()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
