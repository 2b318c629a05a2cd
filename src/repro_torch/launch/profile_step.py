"""Where one ZeRO-1 training step spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_step --arch qwen2-0.5b \\
        --global-batch 8 --seq-len 128 --zero1-buckets 1

Builds the same state as :mod:`repro_torch.launch.train` (world of one,
``paxi``), runs ``--warm`` steps, times ``--steps`` steps with no profiler
(host clock, device synced), then runs ``--steps`` more under
``torch.profiler`` with CPU and CUDA activity.  The device numbers are read
from the exported trace, and only from the device's work: events of the
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` kinds.  The GPU-track ranges
that ``record_function`` and c10d emit (``gpu_user_annotation``) are not
work and are left out.  Prints the unprofiled ms/step, the device's busy
share (the union of the work's intervals over all streams, per step, over
the unprofiled wall time), host and device time of each ``zero1.*`` phase
span of the step (device time: the work launched from inside the span),
work time by class and the top kernels, the top host operations by self
time, and the peak device memory.  The full tables go to
``<out-dir>/profile_step.txt`` and the trace to
``<out-dir>/profile_step.json.gz``.

Needs a CUDA device: a measurement that finds no card fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import configs as cfgs
from ..data.pipeline import DataPipeline, SyntheticSource
from ..models import build_model
from ..optim.adamw import AdamWConfig
from ..runtime.device import resolve_device
from ..runtime.dist import make_dist
from ..train import train_loop

#: the step's phase spans (``train_loop.body_zero1``)
SPAN_PREFIX = "zero1."

#: trace categories of the device's work (kernels and copies)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace categories of the host calls that launch it
LAUNCH_CALLS = ("cuda_runtime", "cuda_driver")

#: kernel classes by name fragment, first match wins
KERNEL_CLASSES = (
    ("wire pack/unpack (this repo)", ("permute_rows",)),
    ("nccl", ("nccl",)),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("copy / memset", ("Memcpy", "Memset", "copy_", "CatArrayBatched")),
    ("reduction", ("reduce_kernel", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_class(name: str) -> str:
    for label, frags in KERNEL_CLASSES:
        if any(f in name for f in frags):
            return label
    return "other"


def _union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def trace_summary(events: list, n_steps: int) -> dict:
    """Device work of a chrome trace's ``traceEvents``, per step.

    -> ``{"work": {name: [ms, launches]}, "busy_ms": union of the work's
    intervals, "spans": {span: [host ms, device ms]}}``.  A span's device
    time is the work whose launch call lies inside the span's time on any
    thread: the backward pass launches from autograd's device thread while
    the step's thread waits inside ``zero1.grads``.
    """
    work = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_WORK]
    per = 1e3 * n_steps
    kern: dict = {}
    for e in work:
        k = kern.setdefault(e["name"], [0.0, 0])
        k[0] += e["dur"] / per
        k[1] += 1
    busy_ms = _union_us((e["ts"], e["ts"] + e["dur"]) for e in work) / per
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(SPAN_PREFIX)]
    by_span = {e["name"]: [0.0, 0.0] for e in spans}
    for e in spans:
        by_span[e["name"]][0] += e["dur"] / per
    span_of: dict = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CALLS and corr is not None:
            for sp in spans:
                if sp["ts"] <= e["ts"] <= sp["ts"] + sp["dur"]:
                    span_of[corr] = sp["name"]
                    break
    for e in work:
        name = span_of.get(e.get("args", {}).get("correlation"))
        if name is not None:
            by_span[name][1] += e["dur"] / per
    return {"work": kern, "busy_ms": busy_ms, "spans": by_span}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=cfgs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--zero1-buckets", type=int, default=1)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out-dir", default="chiprun_out")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfgs.smoke_config(args.arch) if args.smoke else cfgs.get_config(args.arch)
    cfg = dataclasses.replace(cfg, parallelism=dataclasses.replace(
        cfg.parallelism, zero1_buckets=args.zero1_buckets))
    api = build_model(cfg)
    dist = make_dist(device=dev)
    state = train_loop.init_state(api, 0, dist)
    step_fn = train_loop.make_train_step(api, dist, AdamWConfig())
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0),
                        global_batch=args.global_batch, seq_len=args.seq_len)
    n = args.steps
    batches = [{k: torch.from_numpy(v).to(dist.device) for k, v in next(pipe).items()}
               for _ in range(args.warm + 2 * n)]
    pipe.close()

    def run(bs):
        nonlocal state
        for b in bs:
            state, met = step_fn(state, b)
            float(met.loss)
        torch.cuda.synchronize(dist.device)

    run(batches[:args.warm])
    t0 = time.perf_counter()
    run(batches[args.warm:args.warm + n])
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.reset_peak_memory_stats(dist.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(batches[args.warm + n:])
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n
    peak_gb = torch.cuda.max_memory_allocated(dist.device) / 1e9

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / "profile_step.json.gz"
    prof.export_chrome_trace(str(trace_path))
    with gzip.open(trace_path, "rt") as f:
        summary = trace_summary(json.load(f)["traceEvents"], n)
    kern, spans, busy_ms = summary["work"], summary["spans"], summary["busy_ms"]
    kernel_ms = sum(ms for ms, _ in kern.values())
    by_class: dict = {}
    for name, (ms, cnt) in kern.items():
        c = by_class.setdefault(kernel_class(name), [0.0, 0])
        c[0] += ms
        c[1] += cnt
    events = prof.key_averages()
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / n, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])

    lines = [f"[profile] {cfg.name} global batch {args.global_batch} seq {args.seq_len} "
             f"buckets {args.zero1_buckets} on {torch.cuda.get_device_name(dist.device)}",
             f"[profile] {n} steps: wall {wall_ms:.1f} ms/step unprofiled, "
             f"{prof_wall_ms:.1f} profiled; device work {kernel_ms:.1f} ms/step summed, "
             f"{busy_ms:.1f} ms/step as the union over streams; device busy "
             f"{busy_ms / wall_ms:.3f}; peak allocated {peak_gb:.2f} GB"]
    if kernel_ms == 0:
        lines.append("[profile] the profiler recorded no device time: device "
                     "numbers not measured")
    for name, (host_ms, dev_ms) in spans.items():
        lines.append(f"[span] {name:22s} host {host_ms:8.2f} ms/step  "
                     f"device {dev_ms:8.2f} ms/step")
    for label, (ms, cnt) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"[class] {label:30s} {ms:9.2f} ms/step  {cnt // n:6d} launches/step")
    for name, (ms, cnt) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:args.top]:
        lines.append(f"[kernel] {ms:9.2f} ms/step {cnt // n:6d}x  {name[:110]}")
    for name, ms, cnt in host[:args.top]:
        lines.append(f"[host] {ms:9.2f} ms/step {cnt // n:6d}x  {name[:110]}")
    for line in lines:
        print(line, flush=True)

    (out / "profile_step.txt").write_text(
        "\n".join(lines) + "\n\n"
        + events.table(sort_by="self_cuda_time_total", row_limit=60) + "\n\n"
        + events.table(sort_by="self_cpu_time_total", row_limit=60) + "\n")
    torch.distributed.destroy_process_group()
    return {"wall_ms_per_step": wall_ms, "kernel_ms_per_step": kernel_ms,
            "busy_ms_per_step": busy_ms, "busy": busy_ms / wall_ms,
            "peak_gb": peak_gb, "spans": spans, "classes": by_class}


if __name__ == "__main__":
    main()
