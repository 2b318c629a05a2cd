"""Training launcher — the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 5 --global-batch 8 --seq-len 128

Runs on the card unless ``--device cpu``.  ``--smoke`` selects the reduced
config.  The flags are the reference's; ``--num-layers`` cuts the config's
depth (its widths stay), ``--zero1-buckets`` overrides the config's bucket
count, ``--grad-compression {bf16,int8}`` sets the config's gradient wire
(``parallelism.grad_compression``), and ``--world-size``/``--rank``/
``--init-method`` place this process in a multi-rank world (one process per rank, each given
the same rendezvous, e.g. ``tcp://localhost:<port>``; a world of one needs
none of them).  ``--model-axis R`` lays the world out as
``(world / R, R)``: a dense or moe config then trains tensor-parallel,
each rank holding its heads, FFN columns and vocabulary rows, and under
expert parallelism its ``E_pad / R`` experts (``train_loop.init_state``).
``--production-mesh`` lays it out as the reference's 16 x 16 (data, model)
mesh, which needs a world of 256 ranks.

The loop runs under ``runtime.fault.run_supervised``, as the reference's
does: ``--ckpt-dir D --ckpt-every N`` saves every N steps (async) in the
reference's format, and a second run on the same directory resumes from
its latest checkpoint; the batch of step ``i`` is the ``i``-th of the
synthetic stream (earlier batches are drawn and kept), so a resumed or
replayed step reads the batch the uninterrupted run read.  Without
``--ckpt-dir`` nothing is saved and a failure propagates (the step writes
its parameters in place, so there is no state to restart from).
The encdec and vlm archs are refused: their batches also carry frames or
patches, which the synthetic token stream does not (the reference's
launcher fails on them).  ``--impl faulty:<inner>`` injects the
``PAX_FAULT_SCHEDULE`` fault, ``PAX_WIRE_INTEGRITY=1`` checksums the wire,
and ``--retries N`` retries a corrupted or timed-out step in place.  The
run ends with ``DistContext.shutdown``, whether or not a step raised.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import configs as cfgs
from ..checkpoint.checkpointer import Checkpointer
from ..data.pipeline import DataPipeline, SyntheticSource
from ..launch.mesh import make_production_mesh
from ..models import batch_shapes, build_model, param_leaves
from ..optim.adamw import AdamWConfig, warmup_cosine
from ..runtime.device import resolve_device
from ..runtime.dist import dp_comm_of, init_world, make_dist
from ..runtime.fault import RetryPolicy, run_supervised
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
    #: the supervisor's accounting: restarts from a checkpoint, in-place
    #: retries of a transport fault, the step this run resumed from
    restarts: int = 0
    transport_retries: int = 0
    resumed_from: int = 0
    #: the checkpointer's last save and restore (bytes, ms by phase), and
    #: each corrupt checkpoint a restore fell back from
    ckpt_save: dict = dataclasses.field(default_factory=dict)
    ckpt_restore: dict = dataclasses.field(default_factory=dict)
    checkpoint_fallbacks: list = dataclasses.field(default_factory=list)
    #: SHA-256 of the final parameters' bytes in ``param_leaves`` order
    #: (``--digest``), for bitwise comparisons across runs
    params_sha256: str = ""


def _reference_numerics() -> None:
    # full float32 matrix products and convolutions, as the reference runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv=None) -> TrainReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=cfgs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the config's depth (its widths stay)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--impl", default=None, help="PAX ABI backend")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint directory (none: no saves)")
    ap.add_argument("--ckpt-every", type=int, default=None, help="steps between saves (50)")
    ap.add_argument("--ckpt-keep", type=int, default=3, help="checkpoints retained")
    ap.add_argument("--retries", type=int, default=0,
                    help="in-place retries of a corrupted or timed-out step")
    ap.add_argument("--digest", action="store_true",
                    help="report the final parameters' SHA-256")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 mesh (requires a world of 256 ranks)")
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
    if args.ckpt_every is not None and args.ckpt_dir is None:
        raise ValueError("--ckpt-every needs --ckpt-dir (where the checkpoints go)")

    _reference_numerics()
    cfg = cfgs.smoke_config(args.arch) if args.smoke else cfgs.get_config(args.arch)
    frontend = sorted(set(batch_shapes(cfg, 1, 1)) - {"tokens", "targets"})
    if frontend:
        raise ValueError(f"--arch {cfg.name}: the {cfg.family} family also reads "
                         f"{', '.join(frontend)}, which the synthetic token stream does not "
                         f"carry (the reference's launcher fails there too); train it "
                         f"through train_loop.make_train_step with models.make_batch")
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    if args.zero1_buckets is not None:
        cfg = dataclasses.replace(cfg, parallelism=dataclasses.replace(
            cfg.parallelism, zero1_buckets=args.zero1_buckets))
    if args.grad_compression is not None:
        cfg = dataclasses.replace(cfg, parallelism=dataclasses.replace(
            cfg.parallelism, grad_compression=args.grad_compression))
    api = build_model(cfg)
    mesh, started = None, False
    if args.production_mesh:
        dev = resolve_device(args.device)
        started = init_world(dev, args.world_size, args.rank, args.init_method)
        try:
            mesh = make_production_mesh(device=dev)
        except ValueError:
            if started:
                torch.distributed.destroy_process_group()
            raise
    dist = make_dist(model_axis=args.model_axis, impl=args.impl, device=args.device,
                     compression=cfg.parallelism.grad_compression,
                     world_size=args.world_size, rank=args.rank,
                     init_method=args.init_method, mesh=mesh)
    dist.owns_world = dist.owns_world or started
    with dist:  # shutdown on the way out, a failed one if a step raised
        report = _train(args, cfg, api, dist)
    if report.losses:
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
    report = TrainReport(0, [], [], [], wire_kernel, wire_impl,
                         torch.distributed.get_backend(),
                         wire_abi.capabilities()["allreduce"]["source"])
    drawn: list = []

    def get_batch(i: int) -> dict:
        # the i-th batch of the stream, whatever ran before: a resumed or
        # replayed step reads what the uninterrupted run read
        while len(drawn) <= i:
            drawn.append(next(pipe))
        return train_loop.local_batch(drawn[i], dist)

    def logged_step(state, batch):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss, gnorm = float(metrics.loss), float(metrics.grad_norm)
        dt = time.perf_counter() - t0
        s = int(state.step)
        record[s] = (loss, gnorm, dt * 1e3)  # a replayed step overwrites its record
        if s % args.log_every == 0:
            toks = args.global_batch * args.seq_len / max(dt, 1e-9)
            print(f"step {s:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"{dt*1e3:.1f} ms/step ({toks:,.0f} tok/s)")
        return state, metrics

    record: dict = {}
    ckpt = (Checkpointer(args.ckpt_dir, keep=args.ckpt_keep, dist=dist)
            if args.ckpt_dir is not None else None)
    retry = None
    if args.retries:
        retry = RetryPolicy(max_retries=args.retries,
                            verify=train_loop.step_verifier(dist),
                            reset=train_loop.plan_resetter(dist))
    try:
        sup = run_supervised(
            logged_step, state, get_batch, checkpointer=ckpt, total_steps=args.steps,
            checkpoint_every=args.ckpt_every or 50, state_like=state,
            max_restarts=3 if ckpt is not None else 0, retry=retry)
    finally:
        pipe.close()
    report.steps_completed = sup.steps_completed
    report.restarts, report.resumed_from = sup.restarts, sup.resumed_from
    for s in range(sup.resumed_from + 1, sup.steps_completed + 1):
        loss, gnorm, ms = record[s]
        report.losses.append(loss)
        report.grad_norms.append(gnorm)
        report.step_ms.append(ms)
    report.transport_retries = sup.transport_retries
    report.checkpoint_fallbacks = sup.checkpoint_fallbacks
    if ckpt is not None:
        report.ckpt_save, report.ckpt_restore = ckpt.last_save, ckpt.last_restore
    if args.digest:
        report.params_sha256 = params_sha256(sup.final_state.params)
    return report


def params_sha256(model) -> str:
    """SHA-256 of a parameter module's bytes, leaf by leaf in
    ``param_leaves`` order (bfloat16 as its raw bits)."""
    import hashlib

    h = hashlib.sha256()
    for _, p in param_leaves(model):
        t = p.detach()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


if __name__ == "__main__":
    main()
