"""Serving launcher — the port of ``repro.launch.serve``: batched generation
with :class:`~repro_torch.serve.engine.ServeEngine`, continuously batched on
the paged KV cache (the dense and moe families), statically batched over
the recurrent state (``--arch rwkv6-7b``, ``zamba2-2.7b``) or, text only,
over the contiguous cache (``--arch phi-3-vision-4.2b``).  ``--arch
whisper-tiny`` is refused by the engine (``ValueError``: the encdec cache
needs the encoder's frames), where the reference's fails too.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
        --batch 4 --prompt-len 16 --new-tokens 16

Runs on the card unless ``--device cpu``.  The flags are the reference's,
plus ``--device`` and ``--seed`` (the weights' seed and the engine's
sampling seed).  Prints tokens/s, the engine's stats, the KV pool (paged
path) and the first tokens of two requests; the run ends with
``DistContext.shutdown``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import configs as cfgs
from ..models import build_model
from ..runtime.dist import make_dist
from ..serve.engine import Request, ServeEngine
from .train import _reference_numerics


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=cfgs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--impl", default=None, help="PAX ABI backend")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV page size in token positions")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt positions fed per engine step")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    _reference_numerics()
    cfg = cfgs.smoke_config(args.arch) if args.smoke else cfgs.get_config(args.arch)
    api = build_model(cfg)
    with make_dist(impl=args.impl, device=args.device) as dist:
        model = api.init(args.seed, device=dist.device)
        eng = ServeEngine(api, model, max_batch=args.batch,
                          max_seq=args.prompt_len + args.new_tokens + 8, dist=dist,
                          block_size=args.block_size, prefill_chunk=args.prefill_chunk,
                          seed=args.seed)
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(1, cfg.vocab_size, args.prompt_len).astype(np.int32),
                        max_new_tokens=args.new_tokens, temperature=args.temperature)
                for i in range(args.batch)]
        t0 = time.perf_counter()
        eng.run(reqs)
        dt = time.perf_counter() - t0
        total_new = sum(len(r.out_tokens) for r in reqs)
        print(f"arch={cfg.name} impl={dist.abi.backend.name} device={dist.device}: "
              f"{args.batch} requests, {total_new} tokens in {dt:.2f}s "
              f"({total_new / dt:.1f} tok/s)")
        print(f"  stats: {eng.stats}")
        if eng.paged:
            print(f"  kv pool: {eng.alloc.live_blocks} live / "
                  f"{eng.alloc.num_blocks - 1} blocks of {eng.block_size}")
        for r in reqs[:2]:
            print(f"  req{r.rid}: {r.out_tokens[:12]}")
    return reqs


if __name__ == "__main__":
    main()
