"""The paper's backend swap: one training program on every implementation.

The port's twin of ``examples/abi_swap.py``.  From the same seeded weights
and the same batch, N ZeRO-1 steps of ``train_loop``'s step (the step
``launch/train.py`` runs) go through each ABI implementation in turn —
native (``paxi``), algorithmic (``ring``), compressed wire (``ring-bf16``),
foreign through Mukautuva (``ompix``, ``muk:paxi``) and partial with
emulation (``minimal``) — with no change to the program::

    PYTHONPATH=src python -m repro_torch.launch.abi_swap --device cpu --smoke --arch chatglm3-6b

Every backend's losses must agree with ``paxi``'s: within 1e-5 relative, or
5e-3 on a bf16 wire (the reference's tolerances).  Runs on the card unless
``--device cpu``.  One world serves every backend: each gets its own ABI
context (and communicators) on it, shut down before the next one starts.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from .. import configs as cfgs
from ..data.pipeline import DataPipeline, SyntheticSource
from ..models import build_model
from ..optim.adamw import AdamWConfig
from ..runtime.device import resolve_device
from ..runtime.dist import init_world, make_dist
from ..train import train_loop

IMPLS = ("paxi", "ring", "ring-bf16", "ompix", "muk:paxi", "minimal")
#: capability rows each run records (their resolution differs by backend)
CAP_ROWS = ("allreduce", "reduce", "gather", "comm_agree")


def tolerance(impl: str) -> float:
    """Relative loss tolerance against ``paxi``: the reference's."""
    return 5e-3 if "bf16" in impl else 1e-5


@dataclasses.dataclass
class SwapRun:
    impl: str
    losses: list
    grad_norms: list
    step_ms: list
    #: the zero1 wire kernels' variant ("cuda" on the card, "torch" on the CPU)
    wire_kernel: str
    #: capabilities()[row]["source"] for the rows of CAP_ROWS
    sources: dict
    #: live requests and active plans after the last step, before shutdown
    outstanding: int


def first_batch(cfg, global_batch: int, seq_len: int) -> dict:
    """The data pipeline's first batch (numpy), used for every step."""
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0),
                        global_batch=global_batch, seq_len=seq_len)
    try:
        return next(pipe)
    finally:
        pipe.close()


def run_one(cfg, impl: str, batch: dict, steps: int, device, *,
            model_fn: Optional[Callable] = None) -> SwapRun:
    """``steps`` ZeRO-1 steps of ``cfg`` on ``impl`` from seed 0's weights
    (or ``model_fn(device)``'s), the same ``batch`` every step."""
    api = build_model(cfg)
    with make_dist(impl=impl, device=device,
                   compression=cfg.parallelism.grad_compression) as dist:
        dev = dist.device
        model = model_fn(dev) if model_fn is not None else None
        state = train_loop.init_state(api, 0, dist, model=model)
        step = train_loop.make_train_step(api, dist, AdamWConfig())
        rows = batch["tokens"].shape[0] // dist.dp_size
        r = dist.abi.comm_rank(dist.dp_comm)
        local = {k: torch.from_numpy(np.array(v[r * rows:(r + 1) * rows])).to(dev)
                 for k, v in batch.items()}
        run = SwapRun(impl, [], [], [], dist.zero1_plans.wire_kernel
                      if dist.zero1_plans is not None else "none",
                      {row: dist.abi.capabilities()[row]["source"] for row in CAP_ROWS}, -1)
        for _ in range(steps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, met = step(state, local)
            run.losses.append(float(met.loss))
            run.grad_norms.append(float(met.grad_norm))
            run.step_ms.append((time.perf_counter() - t0) * 1e3)
        run.outstanding = dist.abi.outstanding_requests
        del state, step, model
    return run


def swap(cfg, impls: Sequence[str] = IMPLS, steps: int = 3, *, device=None,
         batch: Optional[dict] = None, model_fn: Optional[Callable] = None) -> dict:
    """Run every implementation of ``impls`` in turn; -> impl -> SwapRun.
    ``batch`` defaults to the pipeline's first batch of 2 x 16 tokens (the
    reference example's shape).  One world serves them all (started here
    unless one is running)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if batch is None:
        batch = first_batch(cfg, 2, 16)
    started = init_world(dev)
    try:
        return {impl: run_one(cfg, impl, batch, steps, dev, model_fn=model_fn)
                for impl in impls}
    finally:
        if started and tdist.is_initialized():
            tdist.destroy_process_group()


def check(runs: dict, base: str = "paxi") -> None:
    """Every backend's losses within its tolerance of ``base``'s."""
    ref = runs[base].losses
    for impl, run in runs.items():
        tol = tolerance(impl)
        for got, want in zip(run.losses, ref):
            if abs(got - want) > tol * max(abs(want), 1.0):
                raise AssertionError(f"{impl} loss {got} vs {base} {want} (tolerance {tol})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="chatglm3-6b", choices=cfgs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfgs.smoke_config(args.arch) if args.smoke else cfgs.get_config(args.arch)
    runs = swap(cfg, IMPLS, args.steps, device=args.device)
    for impl, run in runs.items():
        print(f"{impl:10s} losses {run.losses} grad norms {run.grad_norms} "
              f"wire_kernel={run.wire_kernel} sources={run.sources}")
    check(runs)
    print("all implementations agree: the ABI is the contract, the backend a "
          "deployment choice")
    return runs


if __name__ == "__main__":
    main()
