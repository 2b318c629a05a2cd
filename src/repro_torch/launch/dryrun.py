"""Multi-pod dry run of the port: run every (architecture x input shape x
mesh) cell's step on one rank of the production mesh, on fake tensors and a
fake process group, and record its memory, FLOPs, collectives and H100
roofline.  No device is touched and nothing is allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh pod1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell, subprocess each
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

The reference lowers and compiles each cell for 512 placeholder TPU
devices; here rank 0 of a world of 256 (``pod1``, 16 x 16 data x model) or
512 (``pod2``, 2 x 16 x 16 pod x data x model) runs the port's own code:

* a train cell: the step ``launch.train`` builds (``train_loop.init_state``
  and ``make_train_step`` for the config's ``grad_sync``: the ABI ZeRO-1
  step, or ``gspmd`` with FSDP), on this rank's rows of the global batch;
* a prefill cell: ``forward`` with ``last_only``;
* a decode cell: ``decode_step`` on its cache.

The process group is ``torch.testing``'s fake backend (its collectives
complete at once and move nothing) and every tensor a ``FakeTensor`` on the
CPU device, so the kernels take their shape-only variant
(``kernels.variant_for``).  What is read: ``MemTracker`` for the argument
bytes (the state's leaves as this rank holds them) and the peak, temp =
peak - argument; ``FlopCounterMode`` for the FLOPs; ``hlo_analysis``'s
``StepCounter`` for the collectives and the memory traffic; the roofline on
``model_flops_per_token``.  Every family runs its tensor-parallel and
FSDP layout (the moe family's experts split by expert under ``ep``, by
each expert's ``d_ff`` under ``tp``; the Mamba2 layers' per segment; the
encoder-decoder's three attentions and the vlm's projector), in every
cell, and a decode cell holds the rank's block of the decode state
(``cache_specs``; the encoder-decoder's self-attention cache and cross
K/V at the rank's heads).  The record says ``"tp": "split"`` where some
leaf splits over the model axis (whisper-tiny's 6 heads and vocabulary of
51,865 stay whole on a 16-wide axis; its MLPs split).

The cells, the ``PAX_OVERRIDE_*`` knobs and the accounting are the
reference's: ``run_cell`` takes the memory from the deployable run (full
depth, every microbatch) and the roofline from runs of one accumulation
iteration (microbatch 1 over the per-iteration batch, floored at the dp
size), at full depth where ``L <= 8 * period`` and else extrapolated
linearly from ``L1 = 2 * period`` and ``L2 = 4 * period`` layers.  Records
are JSON under ``build/dryrun/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from .. import configs as cfgs
from ..configs.base import ShapeConfig
from ..core import ByteCounter, Mesh
from ..models import batch_shapes, build_model
from ..models.model import _family, model_flops_per_token
from ..models.tensor_parallel import is_split
from ..optim.adamw import AdamWConfig
from ..runtime.dist import make_dist
from ..train import train_loop
from .hlo_analysis import Roofline, StepCounter, roofline_from_counts
from .mesh import make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

ALL_MESHES = ("pod1", "pod2")


def _apply_env_overrides(cfg):
    """The reference's hillclimb knobs: each re-runs a cell under
    ``PAX_OVERRIDE_*`` without touching the config.

      PAX_OVERRIDE_ATTENTION=blockwise|xla|flash
      PAX_OVERRIDE_MICROBATCH=<int>
      PAX_OVERRIDE_REMAT=none|dots|full   (dots raises where a layer runs, as maybe_remat does)
      PAX_OVERRIDE_CAPACITY=<float>        (MoE capacity factor)
      PAX_OVERRIDE_COMPRESSION=bf16|int8   (dp grad sync wire)
      PAX_OVERRIDE_SEQPAR=0|1
    """
    par = cfg.parallelism
    if os.environ.get("PAX_OVERRIDE_ATTENTION"):
        cfg = dataclasses.replace(cfg, attention_impl=os.environ["PAX_OVERRIDE_ATTENTION"])
    if os.environ.get("PAX_OVERRIDE_MICROBATCH"):
        par = dataclasses.replace(par, microbatch=int(os.environ["PAX_OVERRIDE_MICROBATCH"]))
    if os.environ.get("PAX_OVERRIDE_REMAT"):
        par = dataclasses.replace(par, remat=os.environ["PAX_OVERRIDE_REMAT"])
    if os.environ.get("PAX_OVERRIDE_COMPRESSION"):
        par = dataclasses.replace(par, grad_compression=os.environ["PAX_OVERRIDE_COMPRESSION"])
    if os.environ.get("PAX_OVERRIDE_SEQPAR"):
        par = dataclasses.replace(par, sequence_parallel=bool(int(os.environ["PAX_OVERRIDE_SEQPAR"])))
    if par is not cfg.parallelism:
        cfg = dataclasses.replace(cfg, parallelism=par)
    if os.environ.get("PAX_OVERRIDE_CAPACITY") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(os.environ["PAX_OVERRIDE_CAPACITY"])))
    return cfg


def fake_world(world: int) -> None:
    """Start the fake process group of ``world`` ranks as rank 0 (once a
    process; a running one must have that size)."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if tdist.is_initialized():
        if tdist.get_world_size() != world:
            raise RuntimeError(f"a world of {tdist.get_world_size()} is running; the cell "
                               f"needs {world}")
        return
    tdist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    return 0


def state_bytes(state) -> int:
    """The bytes of a train state's tensors: the parameters this rank
    holds, the optimizer's state (moments, residual, step) and the step."""
    return (sum(_bytes(p) for p in state.params.parameters()) + _bytes(tuple(state.opt))
            + _bytes(state.step))


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _peak(mt) -> int:
    snap = mt.get_tracker_snapshot("peak")
    return int(sum(v.get("Total", 0) for v in snap.values()))


# ---------------------------------------------------------------------------
# one lowering
# ---------------------------------------------------------------------------
def lower(cfg, shape: ShapeConfig, mesh: Mesh, impl: str = "paxi") -> dict:
    """Run one cell's step as rank 0 of ``mesh`` (whose world must be
    running, e.g. :func:`fake_world`) under ``FakeTensorMode``; returns
    the record's memory, FLOPs, collectives and roofline."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    chips = mesh.size
    api = build_model(cfg)
    bc = ByteCounter()
    dist = make_dist(mesh=mesh, impl=impl, tools=(bc,),
                     compression=cfg.parallelism.grad_compression)
    dp = dist.dp_size
    B, S = shape.global_batch, shape.seq_len
    rows = B // dp if B % dp == 0 and B >= dp else B
    dev = torch.device("cpu")
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            # every cell holds what init_state gives the rank
            model = _family(cfg)[1](cfg, dev, **train_loop.model_part(api, dist))
            mt = MemTracker()
            t0 = time.time()
            if shape.kind == "train":
                state = train_loop.init_state(api, 0, dist, model=model)
                args = state_bytes(state)
                batch = {k: torch.zeros(s, dtype=d)
                         for k, (s, d) in batch_shapes(cfg, rows, S).items()}
                step = train_loop.make_train_step(api, dist, AdamWConfig())
                mt.track_external(model, *_tensors(tuple(state.opt)), state.step)
                with mt, FlopCounterMode(display=False) as fc, StepCounter() as sc:
                    out = step(state, batch)
                out_bytes = _bytes(tuple(out[1]))
                tokens = B * S
            elif shape.kind == "prefill":
                args = _bytes(list(model.parameters()))
                batch = {k: torch.zeros(s, dtype=d)
                         for k, (s, d) in batch_shapes(cfg, rows, S).items()}
                mt.track_external(model)
                with torch.no_grad(), mt, FlopCounterMode(display=False) as fc, \
                        StepCounter() as sc:
                    logits = api.forward(model, batch, dist, last_only=True)
                out_bytes = _bytes(logits)
                tokens = B * S
            else:  # decode
                cache = _decode_cache(api, model, cfg, rows, S, dist)
                args = _bytes(list(model.parameters())) + _bytes(tuple(cache))
                token = torch.zeros((rows, 1), dtype=torch.int32)
                mt.track_external(model, *_tensors(tuple(cache)))
                with torch.no_grad(), mt, FlopCounterMode(display=False) as fc, \
                        StepCounter() as sc:
                    logits, _ = api.decode_step(model, token, cache, S - 1, dist)
                out_bytes = _bytes(logits)
                tokens = B
            t_run = time.time() - t0
            peak = _peak(mt)
    finally:
        dist.shutdown()
    fpt = model_flops_per_token(cfg)
    if shape.kind != "train":
        fpt //= 3  # forward only (no backward): 2*N*D
    stats = sc.stats(bc)
    roof = roofline_from_counts(fc.get_total_flops(), sc, chips, float(fpt) * tokens, stats)
    held = model.part
    return {
        "chips": chips,
        "mode": cfg.parallelism.grad_sync,
        "impl": impl,
        "tp": "split" if any(is_split(s) for s in model.held.values()) else "replicated",
        "fsdp": "split" if held.fsdp_size > 1 else "replicated",
        "experts": ("split" if is_split(model.held.get("layers.moe.experts.wi"))
                    else "replicated"),
        "params_held": sum(p.numel() for p in model.parameters()),
        "run_s": round(t_run, 2),
        "tokens_per_step": tokens,
        "memory": {
            "argument_bytes": args,
            "output_bytes": out_bytes,
            "temp_bytes": peak - args,
            "peak_estimate_bytes": peak,
        },
        "collectives": {"bytes": stats.bytes_by_op, "count": stats.count_by_op,
                        "abi_bytes": stats.abi_bytes},
        "roofline": roof.as_dict(),
    }


def _decode_cache(api, model, cfg, rows: int, S: int, dist):
    """The decode state of ``rows`` sequences of ``S`` positions, as this
    rank holds it."""
    if cfg.family == "encdec":
        from ..models import encdec

        frames = torch.zeros((rows, cfg.encdec.encoder_frames, cfg.d_model),
                             dtype=torch.bfloat16)
        return encdec.init_cache(model, frames, cfg, rows, S, dist)
    return api.decode_init(rows, S, device="cpu", model_axis=model.part.tp_size)


def state_shapes(arch: str, multi_pod: bool) -> dict:
    """The per-device shape of every leaf of ``arch``'s train state as rank
    0 of the production mesh holds it (``init_state`` on fake tensors, the
    config's mode): ``params.<leaf>``, ``opt.<field>`` or
    ``opt.<field>.<leaf>``, ``step``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import param_leaves

    cfg = _apply_env_overrides(cfgs.get_config(arch))
    fake_world(512 if multi_pod else 256)
    api = build_model(cfg)
    dist = make_dist(mesh=make_production_mesh(multi_pod=multi_pod, device="cpu"))
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            model = _family(cfg)[1](cfg, torch.device("cpu"),
                                    **train_loop.model_part(api, dist))
            state = train_loop.init_state(api, 0, dist, model=model)
    finally:
        dist.shutdown()
    out = {f"params.{n}": tuple(p.shape) for n, p in param_leaves(model)}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = tuple(v.shape)

    for field, v in zip(state.opt._fields, state.opt):
        if isinstance(v, dict):
            walk(v, f"opt.{field}.")
        else:
            out[f"opt.{field}"] = tuple(v.shape)
    out["step"] = tuple(state.step.shape)
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool, impl: str = "paxi",
               unroll: bool = False, layer_override: int = 0) -> dict:
    """One run of one cell.  ``unroll=False``: the deployable step (every
    layer, every microbatch) for the memory; ``unroll=True``: one
    accumulation iteration (microbatch 1 over ``global_batch / n_micro``,
    floored at the dp size), at ``layer_override`` layers if given, for the
    roofline (the reference's accounting graph)."""
    cfg = _apply_env_overrides(cfgs.get_config(arch))
    shape = cfgs.SHAPES_BY_NAME[shape_name]
    n_micro = max(cfg.parallelism.microbatch, 1)
    if unroll:
        cfg = dataclasses.replace(cfg, parallelism=dataclasses.replace(
            cfg.parallelism, scan_layers=False, microbatch=1))
        if layer_override:
            cfg = dataclasses.replace(cfg, num_layers=layer_override)
        if shape.kind == "train" and n_micro > 1:
            dp = 32 if multi_pod else 16
            shape = dataclasses.replace(
                shape, global_batch=max(shape.global_batch // n_micro, dp))
    if shape.kind == "decode" and shape_name == "long_500k" and not cfg.supports_long_context:
        return {"status": "skipped",
                "reason": "full-attention arch; long_500k needs sub-quadratic attention"}
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec = lower(cfg, shape, mesh, impl)
    return {"status": "ok", "arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16", "family": cfg.family,
            "unrolled": unroll, "accum_steps": n_micro, **rec}


def _layer_period(cfg) -> int:
    return cfg.hybrid.shared_attn_every if cfg.hybrid is not None else 1


def run_cell(arch: str, shape_name: str, multi_pod: bool, impl: str = "paxi") -> dict:
    """The deployable run for the memory, with the roofline of one
    accumulation iteration: at full depth where ``L <= 8 * period``, else
    extrapolated linearly from ``L1 = 2 * period`` and ``L2 = 4 * period``
    layers (the stacks are homogeneous, periodic for the hybrid)."""
    deploy = lower_cell(arch, shape_name, multi_pod, impl, unroll=False)
    if deploy.get("status") != "ok":
        return deploy
    cfg = cfgs.get_config(arch)
    L = cfg.num_layers
    period = _layer_period(cfg)
    if L <= 8 * period:
        acct = lower_cell(arch, shape_name, multi_pod, impl, unroll=True)
        deploy["roofline"] = acct["roofline"]
        deploy["collectives"] = acct["collectives"]
        deploy["accounting"] = {"method": "full-unroll", "run_s": acct["run_s"],
                                "tokens": acct["tokens_per_step"]}
        return deploy

    L1, L2 = 2 * period, 4 * period
    acct1 = lower_cell(arch, shape_name, multi_pod, impl, unroll=True, layer_override=L1)
    acct2 = lower_cell(arch, shape_name, multi_pod, impl, unroll=True, layer_override=L2)

    def extrapolate(key):
        m1, m2 = acct1["roofline"][key], acct2["roofline"][key]
        per = (m2 - m1) / (L2 - L1)
        return max(m1 - per * L1 + per * L, 0.0)

    # MODEL_FLOPS must use the FULL-depth config (the accounting runs are shallow)
    fpt = model_flops_per_token(cfg)
    if cfgs.SHAPES_BY_NAME[shape_name].kind != "train":
        fpt //= 3
    roof = Roofline(
        flops_per_device=extrapolate("flops_per_device"),
        hbm_bytes_per_device=extrapolate("hbm_bytes_per_device"),
        collective_bytes_per_device=extrapolate("collective_bytes_per_device"),
        chips=acct1["roofline"]["chips"],
        model_flops_global=float(fpt) * acct1["tokens_per_step"],
    )
    coll = {}
    for op in set(acct1["collectives"]["bytes"]) | set(acct2["collectives"]["bytes"]):
        b1 = acct1["collectives"]["bytes"].get(op, 0)
        b2 = acct2["collectives"]["bytes"].get(op, 0)
        per = (b2 - b1) / (L2 - L1)
        coll[op] = int(max(b1 - per * L1 + per * L, 0))
    deploy["roofline"] = roof.as_dict()
    deploy["collectives"] = {"bytes": coll, "count": acct2["collectives"]["count"]}
    deploy["accounting"] = {
        "method": f"layer-extrapolation L1={L1} L2={L2} -> L={L}",
        "run_s": acct1["run_s"] + acct2["run_s"],
        "tokens": acct1["tokens_per_step"],
    }
    return deploy


def iter_cells():
    for arch in cfgs.ARCH_NAMES:
        cfg = cfgs.get_config(arch)
        for shape in cfgs.shapes_for(cfg):
            yield arch, shape.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=list(ALL_MESHES), default="pod1")
    ap.add_argument("--impl", default=os.environ.get("PAX_ABI_IMPL", "paxi"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape in iter_cells():
            for m in ALL_MESHES:
                print(f"{arch} {shape} {m}")
        return 0

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    if args.all:
        failures = 0
        for arch, shape in iter_cells():
            for m in ALL_MESHES:
                out = RESULTS_DIR / f"{arch}__{shape}__{m}.json"
                if out.exists() and json.loads(out.read_text()).get("status") in ("ok", "skipped"):
                    print(f"[cached] {arch} {shape} {m}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", m, "--impl", args.impl]
                print(f"[run] {arch} {shape} {m}", flush=True)
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True,
                                          timeout=args.timeout)
                    if proc.returncode != 0:
                        failures += 1
                        out.write_text(json.dumps({
                            "status": "failed", "arch": arch, "shape": shape,
                            "mesh": m, "stderr": proc.stderr[-2000:]}))
                        last = proc.stderr.strip().splitlines()[-1] if proc.stderr else "?"
                        print(f"  FAILED: {last}")
                except subprocess.TimeoutExpired:
                    failures += 1
                    out.write_text(json.dumps({
                        "status": "timeout", "arch": arch, "shape": shape, "mesh": m}))
                    print("  TIMEOUT")
        print(f"done; {failures} failures")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all, or --list")
    t0 = time.time()
    try:
        result = run_cell(args.arch, args.shape, args.mesh == "pod2", args.impl)
    except Exception:
        result = {"status": "error", "arch": args.arch, "shape": args.shape,
                  "mesh": args.mesh, "traceback": traceback.format_exc()[-4000:]}
    result["wall_s"] = round(time.time() - t0, 2)
    variant = os.environ.get("PAX_VARIANT", "")
    suffix = f"__{variant}" if variant else ""
    out = RESULTS_DIR / f"{args.arch}__{args.shape}__{args.mesh}{suffix}.json"
    out.write_text(json.dumps(result, indent=2, default=str))
    if result["status"] == "ok":
        mm = result["memory"]
        rf = result["roofline"]
        print(f"== {args.arch} {args.shape} {args.mesh} [{result['mode']}, tp {result['tp']}, "
              f"fsdp {result['fsdp']}] run {result['run_s']}s")
        print(f"   memory/device: args {mm['argument_bytes']/2**30:.2f} GiB, "
              f"temp {mm['temp_bytes']/2**30:.2f} GiB, "
              f"peak~{mm['peak_estimate_bytes']/2**30:.2f} GiB")
        print(f"   roofline (H100 datasheet): compute {rf['compute_s']*1e3:.2f} ms, "
              f"memory {rf['memory_s']*1e3:.2f} ms, "
              f"collective {rf['collective_s']*1e3:.2f} ms -> {rf['bottleneck']}"
              f"  (useful-flops {rf['useful_flops_fraction']:.2f}, "
              f"MFU-bound {rf['mfu_bound']:.2f})")
        print(json.dumps(result, default=str))
        return 0
    if result["status"] == "skipped":
        print(f"== {args.arch} {args.shape} {args.mesh}: SKIPPED ({result['reason']})")
        return 0
    print(result.get("traceback", result))
    return 1


if __name__ == "__main__":
    sys.exit(main())
