"""Training launcher — the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 5 --global-batch 8 --seq-len 128

Runs on the card unless ``--device cpu``.  ``--smoke`` selects the reduced
config.  The flags are the reference's; ``--zero1-buckets`` overrides the
config's bucket count, ``--grad-compression {bf16,int8}`` sets the config's
gradient wire (``parallelism.grad_compression``), and
``--world-size``/``--rank``/``--init-method``
place this process in a multi-rank world (one process per rank, each given
the same rendezvous, e.g. ``tcp://localhost:<port>``; a world of one needs
none of them).  The step loop runs directly: the reference's fault
supervisor and checkpointer arrive with the fault slice, so
``--ckpt-dir``/``--ckpt-every`` raise ``PAX_ERR_UNSUPPORTED_OPERATION``.
The run ends with ``DistContext.shutdown``, whether or not a step raised.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import configs as cfgs
from ..core.errors import PAX_ERR_UNSUPPORTED_OPERATION, PaxError
from ..data.pipeline import DataPipeline, SyntheticSource
from ..models import build_model
from ..optim.adamw import AdamWConfig, warmup_cosine
from ..runtime.dist import dp_comm_of, make_dist
from ..train import train_loop


@dataclasses.dataclass
class TrainReport:
    steps_completed: int
    losses: list
    grad_norms: list
    step_ms: list
    wire_kernel: str
    #: the gradient wire's backend, the process-group backend under it, and
    #: how that context resolved ``allreduce`` (native or emulated)
    wire_impl: str = ""
    dist_backend: str = ""
    allreduce_source: str = ""


def _reference_numerics() -> None:
    # full float32 matrix products and convolutions, as the reference runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv=None) -> TrainReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=cfgs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--impl", default=None, help="PAX ABI backend")
    ap.add_argument("--ckpt-dir", default=None, help="not ported yet: raises")
    ap.add_argument("--ckpt-every", type=int, default=None, help="not ported yet: raises")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--zero1-buckets", type=int, default=None)
    ap.add_argument("--grad-compression", choices=("bf16", "int8"), default=None,
                    help="compressed gradient wire (default: the config's)")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--init-method", default=None)
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None or args.ckpt_every is not None:
        raise PaxError(PAX_ERR_UNSUPPORTED_OPERATION,
                       "checkpointing (--ckpt-dir, --ckpt-every) is not ported yet")

    _reference_numerics()
    cfg = cfgs.smoke_config(args.arch) if args.smoke else cfgs.get_config(args.arch)
    if args.zero1_buckets is not None:
        cfg = dataclasses.replace(cfg, parallelism=dataclasses.replace(
            cfg.parallelism, zero1_buckets=args.zero1_buckets))
    if args.grad_compression is not None:
        cfg = dataclasses.replace(cfg, parallelism=dataclasses.replace(
            cfg.parallelism, grad_compression=args.grad_compression))
    api = build_model(cfg)
    dist = make_dist(model_axis=args.model_axis, impl=args.impl, device=args.device,
                     compression=cfg.parallelism.grad_compression,
                     world_size=args.world_size, rank=args.rank,
                     init_method=args.init_method)
    with dist:  # shutdown on the way out, a failed one if a step raised
        report = _train(args, cfg, api, dist)
    print(f"done: {report.steps_completed} steps; "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}")
    return report


def _train(args, cfg, api, dist) -> TrainReport:
    dev = dist.device
    # the context the reduce-scatter leg rides: ring-int8 for int8, the
    # primary one otherwise (the bf16 wire is a cast)
    compression = cfg.parallelism.grad_compression
    wire_abi, _ = dp_comm_of(dist, compression == "int8")
    wire_impl = (f"ring-{compression}" if wire_abi is dist.abi_compressed
                 else wire_abi.backend.name)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"mesh={dist.mesh.shape} impl={dist.abi.backend.name} "
          f"mode={cfg.parallelism.grad_sync} device={dev} "
          f"grad_compression={compression} wire_impl={wire_impl}")

    state = train_loop.init_state(api, args.seed, dist)
    n_params = sum(p.numel() for p in state.params.parameters())
    plans = dist.zero1_plans
    wire_kernel = plans.wire_kernel if plans is not None else "none"
    print(f"actual params: {n_params/1e6:.2f}M wire_kernel={wire_kernel}")

    schedule = lambda step: warmup_cosine(step, warmup=args.warmup, total=args.steps)  # noqa: E731
    step_fn = train_loop.make_train_step(api, dist, AdamWConfig(lr=args.lr),
                                         schedule=schedule)

    # every rank reads the same global batch and keeps its data-parallel rows
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0),
                        global_batch=args.global_batch, seq_len=args.seq_len)
    dp, r = dist.dp_size, dist.abi.comm_rank(dist.dp_comm)
    rows = args.global_batch // dp
    report = TrainReport(0, [], [], [], wire_kernel, wire_impl,
                         torch.distributed.get_backend(),
                         wire_abi.capabilities()["allreduce"]["source"])
    try:
        for _ in range(args.steps):
            b = next(pipe)
            batch = {k: torch.from_numpy(v[r * rows:(r + 1) * rows]).to(dev)
                     for k, v in b.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss, gnorm = float(metrics.loss), float(metrics.grad_norm)
            dt = time.perf_counter() - t0
            s = int(state.step)
            report.steps_completed = s
            report.losses.append(loss)
            report.grad_norms.append(gnorm)
            report.step_ms.append(dt * 1e3)
            if s % args.log_every == 0:
                toks = args.global_batch * args.seq_len / max(dt, 1e-9)
                print(f"step {s:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                      f"{dt*1e3:.1f} ms/step ({toks:,.0f} tok/s)")
    finally:
        pipe.close()
    return report


if __name__ == "__main__":
    main()
