#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels of the training path from ``src/repro_torch``;
2. hold each kernel bitwise against its plain PyTorch version at
   (dp, buckets) in {(1,1), (1,2), (4,2), (8,4)}, f32 and bf16 wire, at the
   full qwen2-0.5b flat-gradient size and at a small ragged row length
   (plus one misaligned buffer for the scalar path);
3. time each kernel, its plain version and one PyTorch call computing the
   same function, with CUDA events, beside the least time the card's
   memory bandwidth allows;
4. check the training path end to end at a small size: the reduced
   qwen2-0.5b config in float32 trains 3 steps on the card and on the CPU
   (a subprocess, the plain kernel versions) and the losses agree;
5. drive the main path: ``repro_torch.launch.train.main`` for qwen2-0.5b at
   full width (bf16, microbatch 4) for 5 ZeRO-1 steps, global batch 8,
   sequence 128, one bucket — every step must launch ``pack_transposed`` —
   then 2 steps with two buckets, which must launch ``unpack_transposed``;
   launch counts are zeroed just before and read just after;
6. print the kernels' record as one JSON line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Needs one CUDA device and the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12

CASES = ((1, 1), (1, 2), (4, 2), (8, 4))
SMALL_SEG = 1001          # ragged: not a multiple of the 4-wide vectors
TIMING_ITERS = 20
ARCH = "qwen2-0.5b"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flat_param_count(cfg) -> int:
    """Parameters of the model (no allocation: meta device)."""
    from repro_torch.models.transformer import TransformerLM

    return sum(p.numel() for p in TransformerLM(cfg, "meta").parameters())


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.ring_wire import ops

    t0 = time.perf_counter()
    ops._lib()
    lib = _build.library_path("ring_wire", ops.SOURCES)
    log(f"[build] {lib.relative_to(HERE)} in {time.perf_counter() - t0:.1f} s")
    log_file = lib.with_suffix(".log")
    if log_file.exists():
        for line in log_file.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def phase_check(n_full: int) -> dict:
    """Bitwise kernel vs plain version; returns the worst difference per
    kernel (0.0 when bitwise)."""
    import torch
    from repro_torch.kernels.ring_wire import ops, ref
    from repro_torch.optim.adamw import zero1_padded_size

    worst = {"pack_transposed": 0.0, "unpack_transposed": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dp, b in CASES:
        for label, padded in (("full", zero1_padded_size(n_full, dp, b)),
                              ("ragged", dp * b * SMALL_SEG)):
            x = torch.randn(padded, generator=gen, device="cuda")
            seg = padded // (dp * b)
            for wire in (torch.float32, torch.bfloat16):
                k = ops.pack_transposed(x.view(dp * b, seg), dp, b, wire)
                r = ref.pack_transposed(x.view(dp * b, seg), dp, b, wire)
                torch.cuda.synchronize()
                e_pack = _max_err(k, r)
                same_pack = torch.equal(k, r)
                ku = ops.unpack_transposed(k)
                ru = ref.unpack_transposed(k)
                torch.cuda.synchronize()
                e_unpack = _max_err(ku, ru)
                same_unpack = torch.equal(ku, ru)
                worst["pack_transposed"] = max(worst["pack_transposed"], e_pack)
                worst["unpack_transposed"] = max(worst["unpack_transposed"], e_unpack)
                wname = "f32" if wire == torch.float32 else "bf16"
                log(f"[check] dp={dp} buckets={b} {label:6s} seg={seg} {wname}: "
                    f"pack {'bitwise' if same_pack else 'DIFFERS'} "
                    f"unpack {'bitwise' if same_unpack else 'DIFFERS'}")
                if not (same_pack and same_unpack):
                    raise AssertionError(
                        f"kernel disagrees with its plain version at dp={dp} "
                        f"buckets={b} seg={seg} {wname}: pack {e_pack} unpack {e_unpack}")
                del k, r, ku, ru
            del x
    # misaligned buffer (4-byte offset): the kernels' scalar path
    base = torch.randn(4 * 2 * 256 + 1, generator=gen, device="cuda")
    x = base[1:].view(8, 256)
    k = ops.pack_transposed(x, 4, 2, torch.bfloat16)
    if not torch.equal(k, ref.pack_transposed(x, 4, 2, torch.bfloat16)):
        raise AssertionError("pack_transposed disagrees on a misaligned buffer")
    log("[check] misaligned buffer: pack bitwise")
    return worst


def _time_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_time(n_full: int) -> dict:
    """Kernel, plain version and one library call at the main path's
    shapes: pack at one bucket (every step), unpack at two buckets."""
    import torch
    from repro_torch.kernels.ring_wire import ops, ref
    from repro_torch.optim.adamw import zero1_padded_size

    out = {}
    dp = 1
    b1 = 1
    padded = zero1_padded_size(n_full, dp, b1)
    x = torch.randn(padded, device="cuda").view(dp * b1, -1)
    seg = x.shape[1]
    f32 = torch.float32
    nbytes = padded * 4 + padded * 4
    out["pack_transposed"] = dict(
        shape=f"({dp}*{b1}, {seg}) f32 -> ({b1}, {dp}, {seg}) f32",
        ms=_time_ms(lambda: ops.pack_transposed(x, dp, b1, f32)),
        plain_ms=_time_ms(lambda: ref.pack_transposed(x, dp, b1, f32)),
        library_ms=_time_ms(
            lambda: x.view(dp, b1, seg).transpose(0, 1).contiguous().to(f32)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    del x
    b2 = 2
    padded = zero1_padded_size(n_full, dp, b2)
    seg = padded // (dp * b2)
    y = torch.randn(padded, device="cuda").view(b2, dp, seg)
    out["unpack_transposed"] = dict(
        shape=f"({b2}, {dp}, {seg}) f32 -> ({dp}*{b2}, {seg}) f32",
        ms=_time_ms(lambda: ops.unpack_transposed(y)),
        plain_ms=_time_ms(lambda: ref.unpack_transposed(y)),
        library_ms=_time_ms(
            lambda: y.transpose(0, 1).contiguous().view(dp * b2, seg).to(f32)),
        bound_ms=(padded * 4 * 2) / HBM_BYTES_PER_S * 1e3)
    del y
    for name, t in out.items():
        log(f"[time] {name} {t['shape']}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, "
            f"bound {t['bound_ms']:.3f} ms (bytes)")
    # informational: a layout that really permutes (dp=8, four buckets,
    # bf16 wire) — at dp=1 the permutation is the identity and the plain
    # versions return views
    dp, b, bf16 = 8, 4, torch.bfloat16
    padded = zero1_padded_size(n_full, dp, b)
    seg = padded // (dp * b)
    x = torch.randn(padded, device="cuda").view(dp * b, seg)
    w = ops.pack_transposed(x, dp, b, bf16)
    rows = {
        "pack_transposed": (padded * 4 + padded * 2,
                            lambda: ops.pack_transposed(x, dp, b, bf16),
                            lambda: ref.pack_transposed(x, dp, b, bf16),
                            lambda: x.view(dp, b, seg).transpose(0, 1).contiguous().to(bf16)),
        "unpack_transposed": (padded * 2 + padded * 4,
                              lambda: ops.unpack_transposed(w),
                              lambda: ref.unpack_transposed(w),
                              lambda: w.transpose(0, 1).contiguous().view(dp * b, seg).to(f32)),
    }
    for name, (nb, k, p, lib) in rows.items():
        log(f"[time] {name} dp={dp} buckets={b} bf16 wire, {padded} elements: "
            f"kernel {_time_ms(k):.3f} ms, plain {_time_ms(p):.3f} ms, library "
            f"{_time_ms(lib):.3f} ms, bound {nb / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes)")
    del x, w
    return out


SMALL_ARGS = ["--arch", ARCH, "--smoke", "--steps", "3", "--global-batch", "8",
              "--seq-len", "32", "--log-every", "1", "--zero1-buckets", "2"]


def phase_small_reference():
    """The reduced config on the card vs on the CPU (plain kernel
    versions), same seed and data: losses must agree to float32 matmul
    reassociation (2e-4 relative)."""
    from repro_torch.launch import train

    gpu = train.main(SMALL_ARGS)
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.launch import train; "
            f"r = train.main({SMALL_ARGS + ['--device', 'cpu']!r}); "
            "print('LOSSES ' + json.dumps(r.losses))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code, str(SRC)], capture_output=True,
                          text=True, timeout=300, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"CPU reference run failed:\n{proc.stderr[-4000:]}")
    cpu = json.loads(proc.stdout.split("LOSSES ", 1)[1].splitlines()[0])
    log(f"[reference] small config losses: card {gpu.losses} cpu {cpu}")
    for a, c in zip(gpu.losses, cpu):
        if not math.isclose(a, c, rel_tol=2e-4):
            raise AssertionError(f"card loss {a} vs CPU loss {c}")


def phase_main_path() -> dict:
    from repro_torch.kernels.ring_wire import ops
    from repro_torch.launch import train

    common = ["--arch", ARCH, "--global-batch", "8", "--seq-len", "128",
              "--log-every", "1"]
    ops.pack_transposed.launches = 0
    ops.unpack_transposed.launches = 0
    rep = train.main(common + ["--steps", "5", "--zero1-buckets", "1"])
    pack1, unpack1 = ops.pack_transposed.launches, ops.unpack_transposed.launches
    log(f"[main] buckets=1: losses {rep.losses} grad norms {rep.grad_norms} "
        f"ms/step {[round(t, 1) for t in rep.step_ms]} wire_kernel={rep.wire_kernel} "
        f"launches pack={pack1} unpack={unpack1}")
    if rep.wire_kernel != "cuda":
        raise AssertionError(f"wire kernel {rep.wire_kernel!r}, expected 'cuda'")
    if len(rep.losses) != 5 or not all(math.isfinite(v) for v in rep.losses + rep.grad_norms):
        raise AssertionError(f"non-finite or missing losses: {rep.losses}")
    if pack1 != 5:
        raise AssertionError(f"pack_transposed launched {pack1} times in 5 steps")
    rep2 = train.main(common + ["--steps", "2", "--zero1-buckets", "2"])
    pack2 = ops.pack_transposed.launches - pack1
    unpack2 = ops.unpack_transposed.launches - unpack1
    log(f"[main] buckets=2: losses {rep2.losses} grad norms {rep2.grad_norms} "
        f"ms/step {[round(t, 1) for t in rep2.step_ms]} launches pack={pack2} "
        f"unpack={unpack2}")
    if not all(math.isfinite(v) for v in rep2.losses + rep2.grad_norms):
        raise AssertionError(f"non-finite losses at two buckets: {rep2.losses}")
    if pack2 != 2 or unpack2 != 2:
        raise AssertionError(f"two-bucket steps launched pack {pack2}, unpack {unpack2}")
    return {"pack_transposed": ops.pack_transposed.launches,
            "unpack_transposed": ops.unpack_transposed.launches}


KERNELS = {
    "pack_transposed": "src/repro/kernels/ring_wire/kernel.py:152",
    "unpack_transposed": "src/repro/kernels/ring_wire/kernel.py:195",
}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    try:
        from repro_torch import configs

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kind = torch.cuda.get_device_name(0)
        card = card_line()
        log(f"[device] {kind} x{torch.cuda.device_count()} ({card}); "
            f"torch {torch.__version__} cuda {torch.version.cuda}")
        n_full = flat_param_count(configs.get_config(ARCH))
        log(f"[model] {ARCH} full width: {n_full} parameters")
        phase_build()
        worst = phase_check(n_full)
        timing = phase_time(n_full)
        torch.cuda.empty_cache()
        phase_small_reference()
        launches = phase_main_path()
        record = {"kernels": [
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/ring_wire/csrc/ring_wire.cu",
             "replaces": KERNELS[name], "launches": launches[name],
             "max_abs_err": worst[name], "ms": timing[name]["ms"],
             "plain_ms": timing[name]["plain_ms"],
             "bound_ms": timing[name]["bound_ms"], "bound_by": "bytes",
             "library_ms": timing[name]["library_ms"]}
            for name in KERNELS]}
    except Exception:
        traceback.print_exc()
        print("chip_smoke.py: FAILED", file=sys.stderr)
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(record), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
