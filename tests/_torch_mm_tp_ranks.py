"""Rank programs of ``test_torch_mm_tp.py``: the encdec (whisper) and vlm
(phi-3-vision) families on the model axis (tensor parallelism, FSDP under
``gspmd``) on gloo worlds of two and four CPU ranks.  One world runs every
case it is given and saves, per case, what the test holds against the
reference: the rank's blocks (through ``from_jax_params`` and through
``api.init``'s draw), the full logits, the gradient, the cache the split
decode fills and its steps' logits, the losses and grad norms of each
step, and this rank's block of every parameter after the steps."""
import time
from pathlib import Path

import numpy as np

#: the split decode: steps after the cache is filled, the vlm's prompt
DECODE_STEPS = 4
VLM_PROMPT = 8


def decode_cache_names(family: str) -> tuple:
    """The decode cache's tensors, in the reference's ``tree.leaves`` order
    of its cache (whisper's ``EncDecCache``, the vlm's ``KVCache``)."""
    return ("k", "v", "cross_k", "cross_v") if family == "encdec" else ("k", "v")


def cache_block(cfg, tp_rank: int, tp_size: int, key: str, full):
    """Rank ``tp_rank``'s block of a whole cache tensor (L, B, S, H, D)
    named ``key`` (:func:`decode_cache_names`): its K/V heads where the
    attention that fills it splits them."""
    from repro_torch.models.tensor_parallel import TP, Part, held_layout, is_split

    part = Part(tp_rank, tp_size)
    if cfg.family == "encdec":
        attn = "dec_layers.cross." if key.startswith("cross") else "dec_layers.attn."
    else:
        attn = "layers.attn."
    if not is_split(held_layout(cfg, part)[attn + "wk"]):
        return full
    return full[part.index(full.shape, (None, None, None, TP))]


def _cache_leaves(cache) -> list:
    if hasattr(cache, "self_kv"):
        return [cache.self_kv.k, cache.self_kv.v, cache.cross_k, cache.cross_v]
    return [cache.k, cache.v]


def _reference_cache(path: Path, timeout: float = 240.0) -> dict:
    """The reference's filled cache (index -> whole tensor), which its
    subprocess writes while this world runs."""
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference cache at {path}")
        time.sleep(0.2)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _decode(api, model, cfg, batch: dict, dist, ref_path: Path) -> tuple:
    """Fill the cache (whisper: ``encdec.init_cache`` on the frames; the vlm:
    ``prefill_multimodal`` of the patches and the first ``VLM_PROMPT``
    tokens), then, on this rank's block of the reference's filled cache,
    ``DECODE_STEPS`` steps on the next tokens: (each step's logits, the
    cache as this rank filled it)."""
    import torch

    from repro_torch.models import encdec, vlm

    tokens = torch.from_numpy(batch["tokens"])
    B = tokens.shape[0]
    max_seq = VLM_PROMPT + cfg.vlm.num_patches + DECODE_STEPS if cfg.vlm else DECODE_STEPS
    if cfg.family == "encdec":
        cache = encdec.init_cache(model, torch.from_numpy(batch["frames"]), cfg, B, max_seq, dist)
        index, first = 0, 0
    else:
        _, cache, index = vlm.prefill_multimodal(model, tokens[:, :VLM_PROMPT],
                                                 torch.from_numpy(batch["patches"]), cfg,
                                                 dist, max_seq=max_seq)
        first = VLM_PROMPT
    leaves = _cache_leaves(cache)
    filled = [t.float().numpy().copy() for t in leaves]
    ref = _reference_cache(ref_path)
    for i, (key, t) in enumerate(zip(decode_cache_names(cfg.family), leaves)):
        block = cache_block(cfg, model.part.tp_rank, model.part.tp_size, key, ref[str(i)])
        t.copy_(torch.from_numpy(np.ascontiguousarray(block)).to(t.dtype))
    out = []
    for i in range(DECODE_STEPS):
        logits, cache = api.decode_step(model, tokens[:, first + i:first + i + 1], cache,
                                        index + i, dist)
        out.append(logits.numpy())
    return np.stack(out), filled


def mm_tp_rank(rank, world, init_method, out_dir, model_axis, cases, steps):
    """``cases``: (name, port config, the whole weights as a nested numpy
    tree, global batch as numpy, held: hold the forward, the gradient and
    the decode at dp = 1, train: run ``steps`` steps of the config's
    ``grad_sync`` on the rank's rows (mesh (world / model_axis,
    model_axis))).  The decode reads the reference's filled cache from
    ``<out_dir>/../<name>.cache.npz``."""
    import torch

    from repro_torch.models import build_model, from_jax_params, param_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop

    torch.set_num_threads(1)
    out = {}
    with make_dist(device="cpu", world_size=world, rank=rank, init_method=init_method,
                   model_axis=model_axis) as dist:
        for name, cfg, np_params, batch, held, train in cases:
            api = build_model(cfg)
            kw = train_loop.model_part(api, dist)
            model = from_jax_params(np_params, cfg, device="cpu", **kw)
            part = model.part
            out[f"{name}:part"] = np.array([part.tp_rank, part.tp_size, part.fsdp_rank,
                                            part.fsdp_size])
            out[f"{name}:split"] = np.array(sorted(n for n, s in model.held.items()
                                                   if "tp" in s))
            out[f"{name}:fsdp"] = np.array(sorted(n for n, s in model.held.items()
                                                  if "fsdp" in s))
            drawn = dict(param_leaves(api.init(0, "cpu", **kw)))
            for leaf, p in param_leaves(model):
                out[f"{name}:held:{leaf}"] = p.detach().numpy().copy()
                out[f"{name}:drawn:{leaf}"] = drawn[leaf].detach().numpy()
            if held:
                tb = {k: torch.from_numpy(v) for k, v in batch.items()}
                leaves = param_leaves(model)
                loss = api.loss_fn(model, tb, dist)
                for (leaf, _), g in zip(leaves, torch.autograd.grad(
                        loss, [p for _, p in leaves], materialize_grads=True)):
                    out[f"{name}:grad:{leaf}"] = g.numpy()
                with torch.no_grad():
                    out[f"{name}:logits"] = api.forward(model, tb, dist).numpy()
                    out[f"{name}:last"] = api.forward(model, tb, dist, last_only=True).numpy()
                    out[f"{name}:decode"], filled = _decode(
                        api, model, cfg, batch, dist, Path(out_dir).parent / f"{name}.cache.npz")
                for k, v in zip(decode_cache_names(cfg.family), filled):
                    out[f"{name}:cache:{k}"] = v
            if not train:
                continue
            state = train_loop.init_state(api, 0, dist, model=model)
            step = train_loop.make_train_step(api, dist, AdamWConfig())
            local = train_loop.local_batch(batch, dist)
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
