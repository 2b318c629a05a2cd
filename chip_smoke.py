#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # every phase, one card
    python3 chip_smoke.py --only check  # build + [check] only (a first run)
    python3 chip_smoke.py --only ring4  # build + [ring4] only, four cards
    python3 chip_smoke.py --only serve  # [serve] only (no kernel to build)
    python3 chip_smoke.py --only fault  # build + [fault] only
    python3 chip_smoke.py --only fault4 # build + [fault4] only, four cards
    python3 chip_smoke.py --only ssm    # build + [train-ssm], [train-hybrid], [serve-ssm], [serve-hybrid]
    python3 chip_smoke.py --only moe    # build + [train-moe], [forward-moe], [serve-moe]
    python3 chip_smoke.py --only mm     # build + flash's [check] + the encdec and vlm phases
    python3 chip_smoke.py --only moe4   # build + [moe4] only, four cards
    python3 chip_smoke.py --only ep4    # build + [ep4] only, four cards
    python3 chip_smoke.py --only pp4    # [pp4] only, four cards (no kernel to build)
    python3 chip_smoke.py --only tp4    # build + [tp4] only, four cards
    python3 chip_smoke.py --only moetp4 # build + [moetp4] only, four cards
    python3 chip_smoke.py --only ssmtp4 # build + [ssmtp4] only, four cards
    python3 chip_smoke.py --only mmtp4  # build + [mmtp4] only, four cards
    python3 chip_smoke.py --baseline wkv6=build/wkv6_parent.cu  # [time] also an earlier wkv6

``--baseline NAME=PATH`` (repeatable; NAME ``wkv6`` or ``ssd``) builds an
earlier source of that scan, with the entry point ``pax_NAME`` and the
current kernel's arguments less its scratch buffer (for example the
CUDA-core kernels of commit 5fb2621:
``git show 5fb2621:src/repro_torch/kernels/rwkv6_scan/csrc/wkv6.cu >
build/wkv6_parent.cu``, and of commit f584f51:
``git show f584f51:src/repro_torch/kernels/mamba2_ssd/csrc/ssd.cu``), and
times it in turns with the current kernel in [time], since times move
between calls.

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels of the port's paths from ``src/repro_torch``:
   one ``nvcc`` per source (``ring_wire.cu``, ``ring_hops.cu``,
   ``flash_attention.cu`` (f32), ``flash_attention_wgmma.cu`` (bf16),
   ``wkv6_wgmma.cu``, ``ssd_wgmma.cu``), started together; the tensor-core
   libraries' SASS holds HGMMA instructions (``cuobjdump``), and the
   ``wkv6`` and ``ssd`` kernels' resident blocks per SM are logged;
2. [check] hold each kernel against its plain PyTorch version: bitwise
   for the wire kernels — the zero1 pack/unpack and the error-feedback
   pack at (dp, buckets) in {(1,1), (1,2), (4,2), (8,4)} at the full
   qwen2-0.5b flat-gradient size and at a small ragged row length, and the
   five ring-hop kernels at the hop shapes of the full-width ZeRO-1 int8
   leg at dp 2, 4 and 8 with one and two buckets (the flat vector padded to
   dp * buckets * 128, as ``train_loop.init_state`` pads it on the int8
   ring); plus rounding ties (int8 rint, bf16 nearest even), an all-zero
   block, the +-127 clip and a misaligned buffer; the flash-attention
   kernel against ``ref.attention_ref`` at every ``FA_SWEEP`` shape
   (allclose at atol = rtol = 2e-5 in f32, 2e-2 in bf16: the reference's
   tolerances), at the full-width qwen2-0.5b shape (B=4, S=2048, 14/2
   heads, D=64) in bf16 and f32 and at a ragged S=2000 in bf16 (f32 at
   2e-5; bf16 within two bf16 roundings, 2^-6 of |want|, plus 1e-5), and
   non-causally at S=256 and at a ragged S=192, and the tensor-core
   kernel's bf16 edges (D = 8, 32, 40, 72, 128, 256, S = 1 and 65, groups
   1 and 7 non-causal at a ragged S, views at a misaligned base) and the
   other forwards' shapes (D=80, 256, 128; phi-3-vision's D=96 at 2048 and
   at a ragged 776 positions; whisper-tiny's decoder at 448) within
   two bf16 roundings, each row logging the entry point it launched (bf16:
   the tensor-core kernel, f32: the CUDA-core kernel); the ``wkv6`` and ``ssd``
   scans against their plain chunked versions (3e-4) and the sequential
   oracles (5e-4) at every ``WKV_SWEEP``/``SSD_SWEEP`` shape on the
   sweep's and the models' input distributions, and at the full-width
   shapes of rwkv6-7b and zamba2-2.7b (the oracle's error there a record,
   and also the kernel's and the plain form's error against the plain form
   run in float64: a record for ``ssd``, and ``wkv6``'s kernel no farther
   from it than twice the plain form), plus both kernels' edges (N, P and
   chunk not multiples of 8, chunk 1, a single chunk, N=3, chunk 64, and
   views at a misaligned base), each row logging the entry point it
   launched; where the plain form is finite, so is the kernel; and
   ``ssd`` with one NaN in x, dt, B or C, at full width and at P = N = 16,
   not finite at exactly the plain form's non-finite outputs (its TF32
   split is unscreened, since a screen spills its registers, which the
   build refuses for ``ssd``; the non-finite pass after the scan restores
   them);
3. [time] time each kernel, its plain version and, where one exists, one
   PyTorch call computing the same function, with CUDA events, beside the
   least time the card allows: bytes over its memory bandwidth for the
   ring-wire kernels and the scans (whose operations over the TF32 rate
   are less; the scans' own 3xTF32 floor logged beside), the causal FLOPs
   over the peak for the inputs' type for
   flash attention (library call: ``scaled_dot_product_attention``), at
   the main path's shape in bf16 and f32 and at the other forwards' shapes
   (D=80, 256, 128, phi-3-vision's D=96 at 2048 and 776 positions,
   whisper-tiny's decoder), with the achieved TFLOP/s;
4. check the training path end to end at a small size: the reduced
   qwen2-0.5b config in float32 trains 3 steps on the card and on the CPU
   (a subprocess, the plain kernel versions) and the losses agree;
5. [main] the main path: ``repro_torch.launch.train.main`` for qwen2-0.5b
   at full width (bf16, microbatch 4) for 5 ZeRO-1 steps, global batch 8,
   sequence 128, one bucket — every step must launch ``pack_transposed`` —
   then 2 steps with two buckets, which must launch ``unpack_transposed``;
6. [main-bf16] the same at ``--grad-compression bf16``: 5 steps at one
   bucket, 2 at two; ``pack_transposed_ef`` launches once per step and
   ``pack_transposed`` never;
7. [main-int8] 2 steps at ``--grad-compression int8``: the wire rides
   ``ring-int8`` on NCCL with ``allreduce`` composed from its recipe; at one
   rank the ring is the identity, so no hop kernel launches and both
   steps' losses and grad norms equal the uncompressed run's bitwise (same
   seed, one bucket);
7a. [train-gspmd] the [main] cell through ``make_train_step`` under
   ``grad_sync="gspmd"`` and ``"abi"``, 2 + 3 steps each: ``pack_transposed`` 0 and 5
   times, the losses within 1e-4, ms/step of each; then the cell in
   float32 for 3 steps each way, losses and grad norms within 1e-4;
7b. [abi-swap] the backend swap (see :func:`phase_abi_swap`), then [fault]
   (:func:`phase_fault`): full-width qwen2-0.5b at two buckets resumed from
   a checkpoint and from a torn one bitwise, a corrupted reduce-scatter
   retried bitwise on ``faulty:paxi``, ``faulty:minimal`` and
   ``faulty:ompix`` with integrity on, a dropped one timed out and reset, a
   delayed step restarted bitwise by the watchdog, and the [serve] engine's
   tokens under a ``ServeSupervisor``;
8. [forward] the dense transformer's full-sequence forward under
   ``attention_impl="flash"``: full-width qwen2-0.5b (bf16, random weights
   from seed 0), batch 4, sequence 2048, through ``build_model(cfg).forward``
   — 24 flash launches a forward — then on the same weights under
   ``"xla"``, under ``"blockwise"`` and with ``last_only=True``; ms per
   forward for the three; the bf16 logits' max difference from ``"xla"`` and
   top-1 agreement; at ``compute_dtype="float32"`` the flash and blockwise
   forwards' logits within 1e-3 of xla's; the ``last_only`` row equal to the
   last row of the full logits within one bf16 rounding (2^-7 relative, plus
   1e-5);
9. [forward-ssm] rwkv6-7b at full width and 16 of 32 layers (bf16, random
   weights from seed 0 drawn on the CPU, the time ``init`` took
   reported), batch 4, sequence 2048: 16 ``wkv6`` launches a forward and no
   other kernel,
   finite logits, ``last_only`` against the last row; ms per forward and
   the host's time to enqueue one;
10. [forward-hybrid] zamba2-2.7b the same way under ``"flash"`` (54 ``ssd``
   and 9 ``flash_attention`` launches) and ``"xla"`` (54 and 0) on the same
   weights: ms per forward for both and the host's time to enqueue one, the
   bf16 logits' max difference and top-1 agreement, ``last_only``;
10b. [train-ssm] and [train-hybrid] (before the forwards, :func:`phase_train_recurrent`):
   rwkv6-7b and zamba2-2.7b at full width and 2 and 12 layers, each
   config's own ZeRO-1 step (f32 wire, microbatch 4, remat "full"), global
   batch 8 of 1024 tokens, 2 + 5 steps: the scan launches 2 x layers x 4
   times every step (the forward and the checkpoint's recompute), flash
   never; finite losses, ms/step and peak memory; the step's gradients at
   2 and 6 layers in f32 on the card and the CPU: the loss within 1e-3,
   each leaf no farther from the CPU's than the card's own plain path is,
   plus 1e-3 (rwkv6's gradient is ill-conditioned in float32).  [serve-ssm]
   and [serve-hybrid] (after each forward, on its model,
   :func:`phase_serve_recurrent`): the forward's model (rwkv6-7b at 16 layers) behind
   ``ServeEngine(max_batch=8, max_seq=320)``'s static path, 6 greedy and 2
   sampled requests (prompts 32-256, 32 new tokens), no kernel launched,
   ms per prefill and decode step, tokens/s, a decode step's launches,
   the state's bytes, and a 2- or 6-layer f32 engine pair with equal
   tokens on the card and the CPU;
10c. [train-moe], [forward-moe] and [serve-moe] (after [forward-gemma]):
   qwen2-moe-a2.7b's ZeRO-1 step at full width and 1 of 24 layers (the
   config's step: microbatch 4, remat "full", the f32 wire; batch 8 x
   1024, 2 + 5 steps; ``pack_transposed`` once a step and nothing else;
   finite losses, the aux loss above 0, ms/step, peak memory; the step's
   gradient at 1 layer in f32 on the card and the CPU: loss, grad norm and
   every leaf within 1e-3); the full-width, full-depth forward (bf16, seed
   0, B=4, S=2048) under ``"flash"``: 24 flash launches at D=128, the last
   call held to ``attention_ref``, ms per forward, the dropped share of the
   expert assignments per layer at capacity 1.25; then the paged engine on
   those weights, set up as [serve]'s (8 greedy + 2 sampled requests, 32
   new tokens): no launch, no live block, one ``decode-tp`` call a decode
   step, ms per decode step and prefill chunk, tokens/s, a decode step's
   launches, and a 1-layer f32 engine pair with equal tokens on the card
   and the CPU (where they differ, the step must show a router near-tie,
   top-k margin below 1e-5, and the first decode logits agree within
   1e-3);
10d. the encdec and vlm families (after [serve-moe], :func:`phase_mm`):
   [forward-encdec] whisper-tiny at full width and depth (4 + 4 layers,
   d=384, bf16, seed 0), B=4, 1500 frames, 448 decoder positions, under
   ``"flash"`` (4 flash launches a forward: the decoder's causal
   self-attention only; the last call held to ``attention_ref``) and
   ``"xla"`` (none) on the same weights: ms per forward of both, the bf16
   logits' max difference and top-1 agreement, ``last_only``;
   [decode-encdec] ``encdec.init_cache`` on those frames and 64 greedy
   ``decode_step`` calls (no launch), ms per step, and a 2-layer f32 pair
   with equal tokens on the card and the CPU; [train-encdec] the config's
   ZeRO-1 step (microbatch 4, remat "full", the f32 wire, ``"xla"``) at
   full depth, batch 8 x 448 with (8, 1500, 384) frames, 2 + 5 steps:
   ``pack_transposed`` once a step and nothing else, finite losses, ms/step,
   peak memory, and the step's gradient at 2 layers in f32 on the card and
   the CPU (loss, grad norm and every leaf within 1e-3 of its scale);
   [forward-vlm] phi-3-vision-4.2b at full width and depth (32 layers,
   32/32 heads at D=96), B=4, 576 patches and 1472 text tokens, the same
   way (32 flash launches a forward over 2048 positions); [serve-vlm] on
   those weights ``prefill_multimodal`` and 64 greedy tokens at B=4, then
   the static engine on text-only requests, no launch, and a 2-layer f32
   pair card vs CPU; [train-vlm] the config's step at 8 of 32 layers on the
   forward's first layers, batch 8 x 1024 text tokens with 576 patches,
   as [train-encdec];
11. [card-vs-cpu] the ssm, hybrid, encdec and vlm families at full width
   and reduced depth (rwkv6 2 layers, zamba2 6 so that the shared block
   fires once, whisper-tiny 2 decoder layers, phi-3-vision 2), float32,
   B=1, S=256, the same CPU-drawn weights: the card runs the kernels, the
   CPU their plain versions, and the logits agree within 1e-3;
12. [serve] full-width qwen2-0.5b (bf16, seed 0) behind
   ``ServeEngine(max_batch=8, block_size=16, prefill_chunk=32, max_seq=640)``
   with a ``decode-tp`` plan group on NCCL: 16 greedy and 2 sampled requests
   (prompts 64-512 from ``default_rng(0)``, 64 new tokens) served
   continuously, then 4 greedy and both sampled ones one at a time with the
   same tokens; one ``decode-tp`` call per decode step, no live KV block at
   the end and no kernel launched (serving runs none); ms per decode step
   and per prefill chunk (stream time between CUDA events, host enqueue,
   wall on a drained card), a ``torch.profiler`` breakdown of both, the
   logits copy, tokens/s, ``launch.bench_serve``'s open-loop p50/p99 (32
   requests, gap 2 steps, and again at 0.8 of the admission capacity),
   and the engine on the card against the engine on the CPU at 2 layers in
   f32 (logits within 1e-3, greedy tokens equal up to the first CPU top-2
   margin below 1e-3);
13. print the kernels' record as one JSON line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Each main path zeroes the launch counts just before it and reads them just
after.  Needs one CUDA device and the repository's ``src/`` beside this
file.

``--only fault4`` (four cards, :func:`phase_fault4`) kills rank 3 of a
dp=4 run of full-width qwen2-0.5b on ``faulty:paxi`` before step 3 of 4;
the survivors shrink, rebuild a dp=2 world (their groups created by them
alone) and resume from the step-2 checkpoint, bitwise equal to a dp=2
oracle restored from the same checkpoint.

``--only mm`` builds, checks flash (every [check] row of it, D=96 among
them), then runs the encdec and vlm phases (10d) alone.

``--only ssm`` builds, then runs [train-ssm], [train-hybrid],
[serve-ssm] and [serve-hybrid] alone (each serving phase draws its own
weights at [forward-*]'s depth).  ``--only moe`` builds, then runs [train-moe],
[forward-moe] and [serve-moe] alone.

``--only moe4`` (four cards, :func:`phase_moe4`) runs qwen2-moe-a2.7b at
full width and 2 layers on ``model_axis=4`` over NCCL, 16 experts a card,
in float32 where nothing drops: layer 0's MoE block through expert
parallelism (each rank's sequence slice, two ABI alltoalls and one
allgather) within 1e-3 of local mode on every token routed alike, a
token routed otherwise only at a router tie (top-k margin below 1e-5);
the whole forward's first position off local, if any, a tie too; one
prefill chunk within 1e-3; then µs per ``alltoall`` of the bf16 dispatch
buffer at capacity 1.25 and ms per EP and local forward.

``--only ep4`` (four cards, :func:`phase_ep4`) trains qwen2-moe-a2.7b at
full width and 2 layers on ``model_axis=4``, 16 experts a card: the
config's ZeRO-1 step (``pack_transposed`` once a step on every card, the
replicated leaves' digests equal after 7 steps), and in float32 one
microbatch's gradient through EP within 1e-3 of each leaf's scale of local
mode's on the whole model (the first of up to 3 microbatches in which no
token routes otherwise; any token that does must be a router tie).  ``--only pp4`` (four cards, :func:`phase_pp4`)
runs full-width qwen2-0.5b in float32 as 4 GPipe stages of 6 layers over
ABI ``sendrecv``, M = 4: the loss within 1e-5 and every gradient leaf
within 1e-4 of its scale of the un-pipelined step on each card, 7 hops
each way.

[dryrun] (after [train-gspmd]; its CPU subprocesses start after the
build and run beside the card's phases): ``python -m
repro_torch.launch.dryrun`` on qwen2-0.5b's ``train_4k`` cell at ``pod1``
(rank 0 of a fake world of 256, fake tensors), its record printed, and the
module's lowering of [main]'s own cell beside that cell on the card: the
predicted argument bytes must equal the live train state's; the predicted
peak over ``max_memory_allocated`` and the roofline's step over the
measured ms/step are printed.  ``--only tp4`` (four cards,
:func:`phase_tp4`) runs gemma-7b at full width, each card holding a
quarter of the weights: float32 steps at 2 layers under the ABI step at
(1, 4) and ``gspmd`` with FSDP at (2, 2) against one card's unsharded step
(losses within 1e-5, grad norms within 1e-4, ``pack_transposed`` once a
step per rank under abi), the full-depth bf16 steps in both modes (ms/step,
peak GB, the collectives a step, the dry run's prediction beside them), and
the TP forward under flash (7 launches at 4 local heads, the logits within
``TP4_LOGIT_TOL`` of one card's); it prints a ``kernels`` line with the
``tp4`` launches.  ``--only moetp4`` (four cards, :func:`phase_moetp4`)
runs the moe family on the model axis: qwen2-moe-a2.7b at full width, each
card holding its 16 experts and a quarter of the heads, shared experts and
vocabulary (float32 steps at 2 layers under both modes against one card's
unsharded step, bf16 steps at 12 of 24 layers with the dry run's
collectives as a gate, the 24-layer forward under flash at 4/4 heads, a
2-layer float32 forward and the split decode against one card), and
grok-1-314b at 1 of 64 layers, each card holding its ``d_ff`` block of
every expert (a float32 step at (1, 4) and (2, 2) against one card's
unsharded gradient, the forward under flash at 12/2 heads, bf16 ``gspmd``
steps with FSDP); it prints a ``kernels`` line with the ``moetp4``
launches.  ``--only ssmtp4`` (four cards, :func:`phase_ssmtp4`) runs the
ssm and hybrid families on the model axis: rwkv6-7b and zamba2-2.7b at
full width, each card holding a quarter of the heads, Mamba2 channels
(per segment), ``d_ff`` and vocabulary: the bf16 forward at full depth
(``wkv6`` at 16 of 64 heads, ``ssd`` at 20 of 80, flash at 8/8 heads of
D=80 under zamba2's ``"flash"``; the last call of each held to its plain
version), a float32 forward, split decode and two steps under the ABI
ZeRO-1 step at (1, 4) and ``gspmd`` with FSDP at (2, 2) against one card's
whole model (rwkv6-7b at 8 of 32 layers, the depth whose unsharded f32
step one card holds; zamba2-2.7b at its 54), rwkv6-7b's split forward and
gradient in float64 against one card's (its float32 gradient is
ill-conditioned), and bf16 steps at full depth in both modes; it prints a
``kernels`` line with the ``ssmtp4`` launches.  ``--only mmtp4`` (four
cards, :func:`phase_mmtp4`) runs the encdec and vlm families on the model
axis, each card holding its block of one card's draw: the bf16 forward at
full depth under flash (phi-3-vision-4.2b at 8/8 heads of D=96 over 576 +
2048 positions, 32 launches a card; whisper-tiny's decoder at 6/6 heads at
(1, 4), where its heads stay whole and its MLPs split, and at 3/3 at (2,
2), 4 launches a card; the last call held to ``attention_ref``, the logits
against one card's a record, ms per forward beside one card's whole model),
phi-3-vision's float32 forward at full depth against one card's, float32
steps of both under the ABI ZeRO-1 step at (1, 4) and ``gspmd`` with FSDP
at (2, 2) against one card's unsharded step (whisper at its full 4 + 4
layers, phi-3-vision at 2), the split decode in float32 (phi-3-vision's
``prefill_multimodal`` and 8 steps at (1, 4); whisper's ``init_cache`` and
8 steps at (2, 2), its self and cross K/V at 3 heads a card) against one
card's, phi-3-vision-4.2b's bf16 steps at full depth (the ABI ZeRO-1 step
at (1, 4), ``gspmd`` with FSDP at (2, 2): ms/step, peak GB, a card's
weight bytes) and flash alone at a rank's heads; it prints a ``kernels``
line with the ``mmtp4`` launches.

``--only ring4`` runs the one path a single card cannot: [ring4] starts
``launch.train`` as four ranks, one per card, on NCCL, for 2 ZeRO-1 steps
of full-width qwen2-0.5b (global batch 32) on the f32 wire and then on the
int8 ring (dp=4).  On the ring every rank must launch ``quant_i8`` and
``hop_accum_i8`` once a step and ``hop_add_quant_i8`` twice (S - 2 middle
hops); the step-1 loss must equal the f32 run's bitwise (no update yet),
and the int8 run's grad norms stay within the battery's int8 bound (0.05
relative) of the f32 run's.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
import math
import multiprocessing
import os
import re
import socket
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense peaks (NVIDIA data sheet), FLOP per second: bf16 on the
#: tensor cores, float32 outside them
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

CASES = ((1, 1), (1, 2), (4, 2), (8, 4))
SMALL_SEG = 1001          # ragged: not a multiple of the 4-wide vectors
RINGS = (2, 4, 8)         # ring sizes whose hop shapes [check] covers
HOP_BUCKETS = (1, 2)      # zero1 bucket counts whose hop shapes [check] covers
TIME_RING = 4             # the hop shapes [time] measures (dp=4, one bucket)
WIRE_BLOCK = 128
TIMING_ITERS = 20
ARCH = "qwen2-0.5b"
HOPS = ("quant_i8", "hop_add_quant_i8", "hop_accum_i8", "hop_add_quant_bf16",
        "hop_accum_bf16")


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
    """One nvcc per source, all started together, then load; logs each
    library's compile time and its kernels' registers, shared memory and
    spills (``-Xptxas -v``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.ring_wire import ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

    libs = (("ring_wire", ops.SOURCES), ("ring_hops", ops.HOP_SOURCES),
            ("flash_attention", fa_ops.SOURCES),
            ("flash_attention_wgmma", fa_ops.WGMMA_SOURCES), ("wkv6", wkv_ops.SOURCES),
            ("ssd", ssd_ops.SOURCES))

    def build(lib):
        t = time.perf_counter()
        path = _build.build(*lib)
        return path, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(build, libs))
    for load in (ops._lib, ops._hop_lib, fa_ops._lib, fa_ops._wgmma_lib, wkv_ops._lib,
                 ssd_ops._lib):
        load()
    log(f"[build] {len(libs)} libraries in parallel in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{p.relative_to(HERE)} ({dt:.1f} s)" for p, dt in built))
    spills = []
    for (name, _), (path, _) in zip(libs, built):
        log_file = path.with_suffix(".log")
        if log_file.exists():
            for line in log_file.read_text().splitlines():
                if ("registers" in line and "GMMA" not in line) or "spill" in line \
                        or "Compiling entry" in line:
                    log(f"[build]   {line.strip()}")
                # ssd keeps its state in registers: a spill is a regression
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if name == "ssd" and spill and spill.groups() != ("0", "0"):
                    spills.append(line.strip())
    if spills:
        raise AssertionError(f"[build] ssd spills registers: {spills}")
    for (name, _), (path, _) in zip(libs, built):
        if name in TENSOR_CORE_LIBS:
            hgmma = _hgmma(path)
            log(f"[build] {path.name}: {len(hgmma)} HGMMA instructions in its SASS, e.g. "
                f"{hgmma[0] if hgmma else None}")
            if not any(TENSOR_CORE_LIBS[name] in line for line in hgmma):
                raise AssertionError(f"{path.name} has no {TENSOR_CORE_LIBS[name]} HGMMA")
    log(f"[build] ssd kernel (P = N = chunk = 64): {ssd_ops.blocks_per_sm()} resident blocks "
        "per SM")
    log(f"[build] wkv6 kernel (N = 64, chunk 32): {wkv_ops.blocks_per_sm()} resident blocks "
        "per SM")


#: the libraries whose kernels run on the tensor cores, and their operand type
TENSOR_CORE_LIBS = {"flash_attention_wgmma": "BF16", "ssd": "TF32", "wkv6": "TF32"}


def _hgmma(lib: Path) -> list:
    """The HGMMA (wgmma) instructions in a built library's SASS."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    return [line.split("*/", 1)[1].split(";")[0].strip() for line in out.splitlines()
            if "HGMMA" in line and "*/" in line]


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


def _same(name: str, case: str, k, r, worst: dict) -> None:
    """Bitwise or fail; record the worst difference."""
    ks, rs = (k, r) if isinstance(k, tuple) else ((k,), (r,))
    torch_sync()
    err = max(_max_err(a, b) for a, b in zip(ks, rs))
    worst[name] = max(worst.get(name, 0.0), err)
    if not all(a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())
               for a, b in zip(ks, rs)):
        raise AssertionError(f"{name} disagrees with its plain version ({case}): "
                             f"max abs err {err}")


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def hop_chunk(n_full: int, S: int, buckets: int = 1) -> int:
    """Elements per hop of the full-width ZeRO-1 int8 leg on a ring of S:
    the flat vector padded to S * buckets * WIRE_BLOCK (``zero1_granule``),
    the buckets stacked on one wire, this rank's slice of each."""
    from repro_torch.optim.adamw import zero1_padded_size

    return zero1_padded_size(n_full, S, buckets, WIRE_BLOCK) // S


def _edge_blocks(device):
    """Blocks on the rounding edges (see tests/test_torch_ring_wire_hops.py):
    exact int8 rint ties of both parities (absmax 127 gives scale 1.0), an
    all-zero block, both clip ends, bf16 ties of both parities."""
    import torch

    ties = torch.zeros(WIRE_BLOCK)
    ties[0] = 127.0
    ties[1:21] = torch.arange(-10, 10) + 0.5
    clip = torch.linspace(-127.0, 127.0, WIRE_BLOCK)
    base = torch.tensor([1.0, 1.0078125, -3.0, 65504.0, 1e-30, 3e38, 2.5, -0.75])
    bf_ties = (base.view(torch.int32) | 0x8000).view(torch.float32)
    bf = torch.cat([base, bf_ties]).repeat(WIRE_BLOCK // 16)
    return torch.stack([ties, torch.zeros(WIRE_BLOCK), clip, bf]).to(device)


def _check_hops(x, a, label: str, worst: dict) -> None:
    """The five hop kernels on one (nb, 128) chunk ``x`` and addend ``a``."""
    import torch
    from repro_torch.kernels.ring_wire import ops, ref

    q, s = ops.quant_i8(x)
    _same("quant_i8", label, (q, s), ref.quant_i8(x), worst)
    _same("hop_add_quant_i8", label, ops.hop_add_quant_i8(q, s, a),
          ref.hop_add_quant_i8(q, s, a), worst)
    _same("hop_accum_i8", label, ops.hop_accum_i8(q, s, a), ref.hop_accum_i8(q, s, a), worst)
    w = x.to(torch.bfloat16)
    _same("hop_add_quant_bf16", label, ops.hop_add_quant_bf16(w, a),
          ref.hop_add_quant_bf16(w, a), worst)
    _same("hop_accum_bf16", label, ops.hop_accum_bf16(w, a), ref.hop_accum_bf16(w, a), worst)


def phase_check_ring(n_full: int) -> dict:
    """The six kernels of the compressed wire, bitwise against their plain
    versions; returns the worst difference per kernel (0.0 when bitwise)."""
    import torch
    from repro_torch.kernels.ring_wire import ops, ref
    from repro_torch.optim.adamw import zero1_padded_size

    worst: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    seen = set()
    for S in RINGS:
        for b in HOP_BUCKETS:
            c = hop_chunk(n_full, S, b)
            if c in seen:
                log(f"[check] zero1 int8 dp={S} buckets={b}: hop chunk {c} elements, "
                    "checked above")
                continue
            seen.add(c)
            x = (3 * torch.randn(c, generator=gen, device="cuda")).view(-1, WIRE_BLOCK)
            a = (3 * torch.randn(c, generator=gen, device="cuda")).view(-1, WIRE_BLOCK)
            _check_hops(x, a, f"dp={S} buckets={b}, {c} elements per hop", worst)
            log(f"[check] zero1 int8 dp={S} buckets={b}: hop chunk {c} elements "
                f"({c // WIRE_BLOCK} wire blocks): {', '.join(HOPS)} bitwise")
            del x, a
            torch.cuda.empty_cache()
    edge = _edge_blocks("cuda")
    _check_hops(edge, edge.flip(0).contiguous(), "edge blocks", worst)
    q, s = ops.quant_i8(edge)
    torch_sync()
    if not (q[0, 1:21].cpu().tolist() == torch.round(torch.arange(-10, 10) + 0.5).tolist()
            and q[2].min() == -127 and q[2].max() == 127 and bool((q[1] == 0).all())):
        raise AssertionError("the edge blocks did not hit ties, the clip and the floor")
    log("[check] rint ties of both parities, an all-zero block (1e-30 floor), the +-127 "
        "clip and bf16 ties: bitwise")
    # misaligned: 4 bytes off 16-byte alignment, the scalar path
    buf = torch.randn(2 * 64 * WIRE_BLOCK + 1, generator=gen, device="cuda")
    xm, am = buf[1:1 + 64 * WIRE_BLOCK].view(-1, WIRE_BLOCK), buf[1 + 64 * WIRE_BLOCK:].view(
        -1, WIRE_BLOCK)
    _check_hops(xm, am, "misaligned", worst)
    for dp, b in CASES:
        padded = zero1_padded_size(n_full, dp, b)
        seg = padded // (dp * b)
        for label, rows_seg in (("full", seg), ("ragged", SMALL_SEG)):
            g = torch.randn(dp * b * rows_seg, generator=gen, device="cuda").view(dp * b, -1)
            e = 1e-3 * torch.randn(dp * b * rows_seg, generator=gen, device="cuda").view(
                dp * b, -1)
            _same("pack_transposed_ef", f"dp={dp} buckets={b} {label}",
                  ops.pack_transposed_ef(g, e, dp, b), ref.pack_transposed_ef(g, e, dp, b),
                  worst)
            log(f"[check] pack_transposed_ef dp={dp} buckets={b} {label:6s} seg={rows_seg}: "
                "bitwise")
            del g, e
    gm = buf[1:1 + 8 * 256].view(8, 256)
    _same("pack_transposed_ef", "misaligned", ops.pack_transposed_ef(gm, gm, 4, 2),
          ref.pack_transposed_ef(gm, gm, 4, 2), worst)
    log("[check] misaligned buffer: the hop kernels and pack_transposed_ef bitwise")
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


def phase_time_ring(n_full: int) -> dict:
    """The six compressed-wire kernels at the shapes they meet: the hop
    kernels at the hop chunk of the full-width ZeRO-1 int8 leg at
    dp=TIME_RING with one bucket, ``pack_transposed_ef`` at the main path's
    dp=1 with one bucket.  Bytes bound: each input read once, each output
    written once."""
    import torch
    from repro_torch.kernels.ring_wire import ops, ref
    from repro_torch.optim.adamw import zero1_padded_size

    out = {}
    c = hop_chunk(n_full, TIME_RING)
    nb = c // WIRE_BLOCK
    x = (3 * torch.randn(c, device="cuda")).view(nb, WIRE_BLOCK)
    a = (3 * torch.randn(c, device="cuda")).view(nb, WIRE_BLOCK)
    q, s = ops.quant_i8(x)
    w = x.to(torch.bfloat16)
    w_out = torch.empty_like(w)
    scales = 4 * nb
    rows = {
        # name: (bytes, kernel, plain, one library call or None)
        "quant_i8": (4 * c + c + scales, lambda: ops.quant_i8(x), lambda: ref.quant_i8(x),
                     None),
        "hop_add_quant_i8": (c + scales + 4 * c + c + scales,
                             lambda: ops.hop_add_quant_i8(q, s, a),
                             lambda: ref.hop_add_quant_i8(q, s, a), None),
        "hop_accum_i8": (c + scales + 4 * c + 4 * c, lambda: ops.hop_accum_i8(q, s, a),
                         lambda: ref.hop_accum_i8(q, s, a), lambda: torch.addcmul(a, q, s)),
        # bf16(f32(w) + a): the add runs in the common dtype, f32, and
        # rounds once into the bf16 output
        "hop_add_quant_bf16": (2 * c + 4 * c + 2 * c, lambda: ops.hop_add_quant_bf16(w, a),
                               lambda: ref.hop_add_quant_bf16(w, a),
                               lambda: torch.add(w, a, out=w_out)),
        "hop_accum_bf16": (2 * c + 4 * c + 4 * c, lambda: ops.hop_accum_bf16(w, a),
                           lambda: ref.hop_accum_bf16(w, a), lambda: torch.add(a, w)),
    }
    for name, (nbytes, k, p, lib) in rows.items():
        out[name] = dict(shape=f"zero1 int8 dp={TIME_RING}: ({nb}, {WIRE_BLOCK}) per hop",
                         ms=_time_ms(k), plain_ms=_time_ms(p),
                         library_ms=_time_ms(lib) if lib is not None else None,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    del x, a, q, s, w, w_out
    torch.cuda.empty_cache()
    padded = zero1_padded_size(n_full, 1, 1)
    g = torch.randn(padded, device="cuda").view(1, padded)
    e = 1e-3 * torch.randn(padded, device="cuda").view(1, padded)
    out["pack_transposed_ef"] = dict(
        shape=f"(1*1, {padded}) f32 x2 -> bf16 wire + f32 residual",
        ms=_time_ms(lambda: ops.pack_transposed_ef(g, e, 1, 1)),
        plain_ms=_time_ms(lambda: ref.pack_transposed_ef(g, e, 1, 1)), library_ms=None,
        bound_ms=(4 * padded * 2 + 2 * padded + 4 * padded) / HBM_BYTES_PER_S * 1e3)
    del g, e
    torch.cuda.empty_cache()
    for name, t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.3f} ms"
        log(f"[time] {name} {t['shape']}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library {lib}, bound {t['bound_ms']:.3f} ms (bytes)")
    return out


#: the full-width bf16 checks' bound: kernel and plain version both do f32
#: math and round once to bf16, so they differ by at most one bf16 ulp of the
#: larger result (<= 2^-7 of it), which is within 2^-6 of |want|, plus the
#: f32 reassociation (about 1e-6 at this shape)
BF16_ROUNDINGS = (1e-5, 2.0 ** -6)
# B, S, H, Hkv, D, causal, dtype, (atol, rtol): the reference's FA_SWEEP
# (tests/test_kernels.py) at its tolerances, then the main path's shapes
FA_CHECKS = (
    (2, 256, 4, 2, 64, True, "float32", (2e-5, 2e-5)),
    (1, 128, 2, 2, 32, False, "float32", (2e-5, 2e-5)),
    (2, 256, 8, 2, 64, True, "float32", (2e-5, 2e-5)),
    (1, 256, 4, 1, 128, True, "float32", (2e-5, 2e-5)),
    (2, 192, 4, 4, 64, True, "float32", (2e-5, 2e-5)),
    (2, 256, 4, 2, 64, True, "bfloat16", (2e-2, 2e-2)),
    (4, 2048, 14, 2, 64, True, "bfloat16", BF16_ROUNDINGS),   # FULL_ATTN, the main path's
    (4, 2048, 14, 2, 64, True, "float32", (2e-5, 2e-5)),      # FULL_ATTN
    (4, 2000, 14, 2, 64, True, "bfloat16", BF16_ROUNDINGS),   # ragged S
    (4, 2048, 32, 32, 80, True, "bfloat16", BF16_ROUNDINGS),  # HYBRID_ATTN, [forward-hybrid]'s
    (4, 2048, 32, 32, 80, True, "float32", (2e-5, 2e-5)),     # HYBRID_ATTN
    (4, 2048, 8, 8, 80, True, "bfloat16", BF16_ROUNDINGS),    # HYBRID_TP_ATTN, [ssmtp4]'s
    (2, 256, 4, 2, 64, False, "float32", (2e-5, 2e-5)),       # non-causal
    (1, 192, 2, 1, 64, False, "float32", (2e-5, 2e-5)),       # non-causal, ragged S
    # the tensor-core kernel's edges (bf16): head dims of each template width
    # and one per consumer-warpgroup count, D not a multiple of 16 (padded by
    # TMA's zero fill), one key, one key past a tile, groups 1 and 7
    (2, 256, 4, 2, 32, True, "bfloat16", BF16_ROUNDINGS),     # D=32
    (1, 512, 4, 4, 128, True, "bfloat16", BF16_ROUNDINGS),    # D=128, two warpgroups
    (1, 384, 4, 2, 256, True, "bfloat16", BF16_ROUNDINGS),    # D=256, one warpgroup
    (2, 300, 4, 2, 40, True, "bfloat16", BF16_ROUNDINGS),     # D=40, padded to 48
    (1, 200, 4, 1, 72, False, "bfloat16", BF16_ROUNDINGS),    # D=72, non-causal, ragged S
    (1, 100, 3, 1, 8, False, "bfloat16", BF16_ROUNDINGS),     # D=8, the narrowest head
    (2, 1, 4, 2, 64, True, "bfloat16", BF16_ROUNDINGS),       # S=1
    (2, 65, 4, 2, 64, True, "bfloat16", BF16_ROUNDINGS),      # S=65
    (1, 333, 7, 7, 64, False, "bfloat16", BF16_ROUNDINGS),    # group 1, non-causal, ragged S
    (1, 333, 14, 2, 80, False, "bfloat16", BF16_ROUNDINGS),   # group 7, non-causal, ragged S
    (4, 2048, 16, 16, 256, True, "bfloat16", BF16_ROUNDINGS),  # GEMMA_ATTN, [forward-gemma]'s
    (4, 2048, 16, 16, 128, True, "bfloat16", BF16_ROUNDINGS),  # MOE_ATTN, [forward-moe]'s
    (4, 2048, 32, 32, 96, True, "bfloat16", BF16_ROUNDINGS),   # VLM_ATTN, [forward-vlm]'s
    (4, 776, 32, 32, 96, True, "bfloat16", BF16_ROUNDINGS),    # VLM_RAGGED: 576 + 200
    (4, 448, 6, 6, 64, True, "bfloat16", BF16_ROUNDINGS),      # WHISPER_ATTN, [forward-encdec]'s
)
FWD_BATCH, FWD_SEQ = 4, 2048                        # [forward]'s batch and sequence
FULL_ATTN = (FWD_BATCH, FWD_SEQ, 14, 2, 64)         # qwen2-0.5b's heads at that batch
HYBRID_ATTN = (FWD_BATCH, FWD_SEQ, 32, 32, 80)      # zamba2-2.7b's shared block
HYBRID_TP_ATTN = (FWD_BATCH, FWD_SEQ, 8, 8, 80)     # its heads on a rank of four ([ssmtp4])
GEMMA_ATTN = (FWD_BATCH, FWD_SEQ, 16, 16, 256)      # gemma-7b's heads (D=256)
MOE_ATTN = (FWD_BATCH, FWD_SEQ, 16, 16, 128)        # qwen2-moe-a2.7b's heads (D=128)
VLM_ATTN = (FWD_BATCH, FWD_SEQ, 32, 32, 96)         # phi-3-vision: 576 patches + 1472 text
VLM_RAGGED = (FWD_BATCH, 776, 32, 32, 96)           # phi-3-vision at 576 + 200 positions
WHISPER_ATTN = (FWD_BATCH, 448, 6, 6, 64)           # whisper-tiny's decoder self-attention


def _qkv(B, S, H, Hkv, D, dtype, gen):
    """q (B*H, S, D), k and v (B*Hkv, S, D) on the card, N(0, 1)."""
    import torch

    dt = getattr(torch, dtype)
    return tuple(torch.randn((B * h, S, D), generator=gen, device="cuda").to(dt)
                 for h in (H, Hkv, Hkv))


def phase_check_flash() -> dict:
    """The flash-attention kernel against ``ref.attention_ref``; returns the
    worst difference at the full-width bf16 shape (the main path's)."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for B, S, H, Hkv, D, causal, dtype, (atol, rtol) in FA_CHECKS:
        q, k, v = _qkv(B, S, H, Hkv, D, dtype, gen)
        before = dict(ops.flash_attention.by_entry)
        got = ops.flash_attention(q, k, v, causal=causal)
        entry = [e for e, n in ops.flash_attention.by_entry.items() if n != before[e]]
        want = ref.attention_ref(q, k, v, causal=causal)
        torch_sync()
        err = _max_err(got, want)
        excess = float(((got.float() - want.float()).abs()
                        - atol - rtol * want.float().abs()).max())
        log(f"[check] flash_attention B={B} S={S} H={H}/{Hkv} D={D} "
            f"{'causal' if causal else 'non-causal'} {dtype} via {'+'.join(entry)}: "
            f"max abs err {err:.3e} (atol {atol}, rtol {rtol})")
        if entry != [ops.route(q.dtype)]:
            raise AssertionError(f"flash_attention {dtype} D={D} launched {entry}, expected "
                                 f"{ops.route(q.dtype)}")
        if got.dtype != want.dtype or got.shape != want.shape or excess > 0:
            raise AssertionError(f"flash_attention disagrees with attention_ref at B={B} "
                                 f"S={S} H={H}/{Hkv} D={D} causal={causal} {dtype}: {err}")
        if (B, S, H, Hkv, D) == FULL_ATTN and dtype == "bfloat16":
            worst = err
        del q, k, v, got, want
    # bf16 views 2 bytes past an aligned base: TMA needs 16-byte aligned
    # bases, so the wrapper hands the kernel an aligned copy
    q, k, v = (torch.randn(n * 130 * 64 + 1, generator=gen, device="cuda").to(torch.bfloat16)
               [1:].view(n, 130, 64) for n in (4, 2, 2))
    got = ops.flash_attention(q, k, v)
    want = ref.attention_ref(q, k, v)
    torch_sync()
    atol, rtol = BF16_ROUNDINGS
    excess = float(((got.float() - want.float()).abs() - atol - rtol * want.float().abs()).max())
    log(f"[check] flash_attention misaligned bf16 views (4/2 heads, S=130, D=64): max abs err "
        f"{_max_err(got, want):.3e} (atol {atol}, rtol {rtol})")
    if excess > 0:
        raise AssertionError(f"flash_attention disagrees on misaligned views: {excess}")
    return {"flash_attention": worst}


def _time_flash(tag: str, shape: tuple, dtype: str, rate: float, gen,
                main: bool = False) -> dict:
    """Kernel, plain version and ``scaled_dot_product_attention`` at one
    causal shape (B, S, H, Hkv, D) on the current card (CUDA events): their
    ms, the bound (the causal FLOPs over ``rate`` or the bytes over the
    memory bandwidth, whichever is longer) and the kernel's TFLOP/s."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    B, S, H, Hkv, D = shape
    flops = 4 * B * H * D * S * (S + 1) / 2
    q, k, v = _qkv(B, S, H, Hkv, D, dtype, gen)
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    q4, k4, v4 = q.view(B, H, S, D), k.view(B, Hkv, S, D), v.view(B, Hkv, S, D)
    t = dict(ms=_time_ms(lambda: ops.flash_attention(q, k, v)),
             plain_ms=_time_ms(lambda: ref.attention_ref(q, k, v)),
             library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                 q4, k4, v4, is_causal=True, enable_gqa=H != Hkv)),
             bound_ms=max(flops / rate, nbytes / HBM_BYTES_PER_S) * 1e3,
             bound_by="operations" if flops / rate > nbytes / HBM_BYTES_PER_S else "bytes",
             entry=ops.route(q.dtype))
    t["tflops"] = flops / t["ms"] / 1e9
    log(f"[{tag}] flash_attention B={B} S={S} H={H}/{Hkv} D={D} causal {dtype} "
        f"({t['entry']}{'' if main else ', a record'}): kernel "
        f"{t['ms']:.3f} ms ({t['tflops']:.1f} TFLOP/s), plain {t['plain_ms']:.3f} ms, "
        f"library (sdpa) {t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}: {flops:.3e} FLOP at {rate / 1e12:.0f} TFLOP/s, "
        f"{nbytes / 1e6:.1f} MB)")
    return t


def phase_time_flash() -> dict:
    """Kernel, plain version and ``scaled_dot_product_attention`` at the
    main path's shape, in bf16 (the tensor-core kernel, the record) and f32
    (the CUDA-core kernel), and the bf16 kernel and library at
    [forward-hybrid]'s shape (D=80, and its 8/8 heads on a rank of
    [ssmtp4]), [forward-gemma]'s (D=256),
    [forward-moe]'s (D=128), [forward-vlm]'s (D=96 over 2048 positions, and
    a ragged 776) and [forward-encdec]'s (D=64, 6/6 heads over 448).
    Bound: the causal FLOPs (QK^T and PV over
    the S(S+1)/2 pairs) over the peak for the inputs' type, or q, k, v read
    and o written once over the memory bandwidth, whichever is longer;
    achieved TFLOP/s: those FLOPs over the kernel's time (:func:`_time_flash`)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for name, shape, dtype, rate in (
            ("float32", FULL_ATTN, "float32", F32_FLOP_PER_S),
            ("bfloat16", FULL_ATTN, "bfloat16", BF16_FLOP_PER_S),
            ("hybrid", HYBRID_ATTN, "bfloat16", BF16_FLOP_PER_S),
            ("hybrid_tp", HYBRID_TP_ATTN, "bfloat16", BF16_FLOP_PER_S),
            ("gemma", GEMMA_ATTN, "bfloat16", BF16_FLOP_PER_S),
            ("moe", MOE_ATTN, "bfloat16", BF16_FLOP_PER_S),
            ("vlm", VLM_ATTN, "bfloat16", BF16_FLOP_PER_S),
            ("vlm776", VLM_RAGGED, "bfloat16", BF16_FLOP_PER_S),
            ("whisper", WHISPER_ATTN, "bfloat16", BF16_FLOP_PER_S)):
        out[name] = _time_flash("time", shape, dtype, rate, gen, name == "bfloat16")
    record = dict(out["bfloat16"])
    record.update({f"{name}_{key}": out[name][key]
                   for name in ("float32", "hybrid", "hybrid_tp", "gemma", "moe", "vlm", "vlm776",
                                "whisper")
                   for key in ("ms", "library_ms", "bound_ms", "tflops")})
    return {"flash_attention": record}


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


COMMON = ["--arch", ARCH, "--global-batch", "8", "--seq-len", "128", "--log-every", "1"]


def _kernel_wrappers() -> dict:
    """Record name -> the wrapper whose ``launches`` counts that kernel."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.ring_wire import ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

    out = {k.__name__: k for k in (*ops.KERNELS, fa_ops.flash_attention)}
    out.update(wkv6=wkv_ops.wkv6_apply, ssd=ssd_ops.ssd_apply)
    return out


def _zero_counts() -> None:
    for k in _kernel_wrappers().values():
        k.launches = 0


def _counts() -> dict:
    return {name: k.launches for name, k in _kernel_wrappers().items()}


def _check_run(rep, steps: int, tag: str) -> None:
    log(f"[{tag}] losses {rep.losses} grad norms {rep.grad_norms} "
        f"ms/step {[round(t, 1) for t in rep.step_ms]} wire_kernel={rep.wire_kernel} "
        f"wire={rep.wire_impl} on {rep.dist_backend}")
    if rep.wire_kernel != "cuda":
        raise AssertionError(f"wire kernel {rep.wire_kernel!r}, expected 'cuda'")
    if len(rep.losses) != steps or not all(math.isfinite(v)
                                           for v in rep.losses + rep.grad_norms):
        raise AssertionError(f"non-finite or missing losses: {rep.losses}")


def phase_main_path() -> tuple:
    """The uncompressed main path; returns (its launch counts, the report
    of its one-bucket run)."""
    from repro_torch.launch import train

    _zero_counts()
    rep = train.main(COMMON + ["--steps", "5", "--zero1-buckets", "1"])
    c1 = _counts()
    _check_run(rep, 5, "main")
    log(f"[main] buckets=1 launches pack={c1['pack_transposed']} "
        f"unpack={c1['unpack_transposed']}")
    if c1["pack_transposed"] != 5:
        raise AssertionError(f"pack_transposed launched {c1['pack_transposed']} times in 5 steps")
    rep2 = train.main(COMMON + ["--steps", "2", "--zero1-buckets", "2"])
    c2 = _counts()
    pack2 = c2["pack_transposed"] - c1["pack_transposed"]
    unpack2 = c2["unpack_transposed"] - c1["unpack_transposed"]
    _check_run(rep2, 2, "main")
    log(f"[main] buckets=2 launches pack={pack2} unpack={unpack2}")
    if pack2 != 2 or unpack2 != 2:
        raise AssertionError(f"two-bucket steps launched pack {pack2}, unpack {unpack2}")
    return c2, rep


def phase_main_bf16() -> dict:
    """The bf16 wire: the error-feedback pack on every step, never the
    plain pack."""
    from repro_torch.launch import train

    _zero_counts()
    rep = train.main(COMMON + ["--steps", "5", "--zero1-buckets", "1",
                               "--grad-compression", "bf16"])
    c1 = _counts()
    _check_run(rep, 5, "main-bf16")
    rep2 = train.main(COMMON + ["--steps", "2", "--zero1-buckets", "2",
                                "--grad-compression", "bf16"])
    c2 = _counts()
    _check_run(rep2, 2, "main-bf16")
    ef1, ef2 = c1["pack_transposed_ef"], c2["pack_transposed_ef"] - c1["pack_transposed_ef"]
    log(f"[main-bf16] launches: pack_transposed_ef {ef1} in 5 steps at buckets=1, {ef2} in "
        f"2 steps at buckets=2; pack_transposed {c2['pack_transposed']}; unpack_transposed "
        f"{c2['unpack_transposed']}")
    if ef1 != 5 or ef2 != 2 or c2["pack_transposed"] != 0:
        raise AssertionError("pack_transposed_ef must launch once per step and "
                             f"pack_transposed never: {c2}")
    if c2["unpack_transposed"] != 2:
        raise AssertionError(f"two-bucket bf16 steps launched unpack {c2['unpack_transposed']}")
    return c2


def phase_main_int8(uncompressed) -> dict:
    """The int8 ring: ring-int8 on NCCL, allreduce from its recipe; at one
    rank the ring is the identity, so no hop kernel launches and the run
    is the uncompressed one, bitwise, step for step."""
    from repro_torch.launch import train

    _zero_counts()
    rep = train.main(COMMON + ["--steps", "2", "--zero1-buckets", "1",
                               "--grad-compression", "int8"])
    c = _counts()
    _check_run(rep, 2, "main-int8")
    if (rep.wire_impl, rep.dist_backend, rep.allreduce_source) != ("ring-int8", "nccl",
                                                                   "emulated"):
        raise AssertionError(f"int8 wire on {rep.wire_impl}/{rep.dist_backend}, allreduce "
                             f"{rep.allreduce_source}")
    log(f"[main-int8] ring-int8 negotiated on {rep.dist_backend}; allreduce "
        f"{rep.allreduce_source} from the reduce_scatter + allgather recipe")
    want = (uncompressed.losses[:2], uncompressed.grad_norms[:2])
    same = (rep.losses, rep.grad_norms) == want
    log(f"[main-int8] losses {rep.losses} grad norms {rep.grad_norms} vs uncompressed "
        f"{want[0]} {want[1]}: {'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("the int8 run at one rank differs from the uncompressed run")
    hops = {k: c[k] for k in HOPS}
    log(f"[main-int8] a ring of one rank is the identity: hop kernel launches {hops}; "
        f"pack_transposed {c['pack_transposed']} (the f32 wire)")
    if any(hops.values()) or c["pack_transposed"] != 2:
        raise AssertionError(f"int8 launches at dp=1: {c}")
    return c


GSPMD_WARM, GSPMD_TIMED = 2, 3
#: the gspmd and abi steps agree to the reference's own bound
#: (tests/test_substrate.py::test_train_modes_agree, on losses)
GSPMD_RTOL = 1e-4
#: steps of the float32 copy of the cell, as many as the reference's test
GSPMD_F32_STEPS = 3


def _gspmd_cell(mode: str, steps: int, f32: bool = False) -> tuple:
    """The [main] cell (``ARCH`` at full width, batch 8 x 128, the config's
    microbatch 4, seed 0, ``launch.train``'s batches, AdamW and schedule)
    for ``steps`` steps through ``make_train_step`` with the config's
    ``grad_sync`` replaced by ``mode``; ``f32``: float32 weights and
    activations.  Returns ((loss, grad norm) per step, ms per step, kernel
    launches of the run)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, warmup_cosine
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = configs.get_config(ARCH)
    cfg = dataclasses.replace(base, parallelism=dataclasses.replace(base.parallelism,
                                                                    grad_sync=mode))
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg)
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), global_batch=8, seq_len=128)
    rows, ms = [], []
    with make_dist(device="cuda") as dist:
        state = tl.init_state(api, 0, dist)
        step = tl.make_train_step(api, dist, AdamWConfig(), schedule=lambda t: warmup_cosine(
            t, warmup=20, total=steps))
        _zero_counts()
        for _ in range(steps):
            batch = tl.local_batch(next(pipe), dist)
            (state, met), t = _timed(lambda: step(state, batch), True, dist.device)
            rows.append((float(met.loss), float(met.grad_norm)))
            ms.append(t)
        launches = _counts()
        del state
    pipe.close()
    torch.cuda.empty_cache()
    return rows, ms, launches


def phase_train_gspmd() -> int:
    """[train-gspmd]: the [main] cell (full-width qwen2-0.5b, bf16, batch 8
    x 128, microbatch 4) for 2 + 3 steps through ``make_train_step`` with
    ``grad_sync="gspmd"`` (the per-leaf AdamW step under the mesh's axis
    rules), then with ``"abi"`` (the ZeRO-1 step) from the same seed
    (:func:`_gspmd_cell`): ``pack_transposed`` launched 0 times under gspmd
    and once a step under abi, the losses within ``GSPMD_RTOL`` of each
    other, ms/step of each, and the grad norms' largest relative
    difference (a record: the two steps sum the norm in other orders, and
    where one f32 ulp of the norm changes the clip scale, the bf16 weights
    round apart, since an early step's update is below a bf16 ulp of most
    weights); then the same cell in float32 for ``GSPMD_F32_STEPS`` steps:
    losses and grad norms within ``GSPMD_RTOL``.  Returns the abi run's
    ``pack_transposed`` launches."""
    t_phase = time.perf_counter()
    steps = GSPMD_WARM + GSPMD_TIMED
    runs = {mode: _gspmd_cell(mode, steps) for mode in ("gspmd", "abi")}
    for mode, (rows, _, _) in runs.items():
        if not all(math.isfinite(v) for row in rows for v in row):
            raise AssertionError(f"[train-gspmd] {mode}: (loss, grad norm) {rows}")
    (g, g_ms, g_n), (a, a_ms, a_n) = runs["gspmd"], runs["abi"]
    rel = lambda xs, ys: max(abs(x - y) / abs(y) for x, y in zip(xs, ys))  # noqa: E731
    rel_loss = rel([r[0] for r in g], [r[0] for r in a])
    rel_norm = rel([r[1] for r in g], [r[1] for r in a])
    log(f"[train-gspmd] {ARCH} full width, bf16, batch 8x128, microbatch 4: (loss, grad norm) "
        f"gspmd {g}; abi (ZeRO-1) {a}; largest relative difference of the losses "
        f"{rel_loss:.3e} (bound {GSPMD_RTOL}), of the grad norms {rel_norm:.3e}")
    log(f"[train-gspmd] ms/step gspmd {[round(t, 1) for t in g_ms]} (median of the "
        f"{GSPMD_TIMED} after {GSPMD_WARM} warm {statistics.median(g_ms[GSPMD_WARM:]):.1f}), "
        f"abi {[round(t, 1) for t in a_ms]} (median {statistics.median(a_ms[GSPMD_WARM:]):.1f}); "
        f"pack_transposed launches gspmd {g_n['pack_transposed']}, abi {a_n['pack_transposed']}")
    others = {m: {k: v for k, v in c.items() if v and k != "pack_transposed"}
              for m, c in (("gspmd", g_n), ("abi", a_n))}
    if (rel_loss > GSPMD_RTOL or g_n["pack_transposed"] != 0
            or a_n["pack_transposed"] != steps or any(others.values())):
        raise AssertionError(f"[train-gspmd] losses' relative difference {rel_loss}, "
                             f"launches gspmd {g_n}, abi {a_n}")
    f32 = {mode: _gspmd_cell(mode, GSPMD_F32_STEPS, f32=True)[0] for mode in ("gspmd", "abi")}
    flat = {m: [v for row in rows for v in row] for m, rows in f32.items()}
    rel32 = rel(flat["gspmd"], flat["abi"])
    log(f"[train-gspmd] float32 copy of the cell, {GSPMD_F32_STEPS} steps: (loss, grad norm) "
        f"gspmd {f32['gspmd']}, abi {f32['abi']}; largest relative difference {rel32:.3e} "
        f"(bound {GSPMD_RTOL}); phase wall {time.perf_counter() - t_phase:.1f} s")
    if rel32 > GSPMD_RTOL or not all(math.isfinite(v) for v in flat["gspmd"]):
        raise AssertionError(f"[train-gspmd] float32: relative difference {rel32}")
    return a_n["pack_transposed"]


SWAP_IMPLS = ("paxi", "minimal", "ompix", "muk:paxi")
SWAP_STEPS, SWAP_BUCKETS = 3, 2
#: [abi-swap]'s depth: 2 of qwen2-0.5b's 24 layers since PR 27 (the script's
#: time limit), full width
SWAP_DEPTH = 2
#: the layer's cost: blocking allreduce calls of one float32 per round
MSG_CALLS, MSG_WARMUP, MSG_ROUNDS = 2000, 200, 5


def _us_per_call(calls: dict, comm: int, dev) -> dict:
    """impl -> µs per blocking ``allreduce`` of one float32 on ``comm``,
    one per round: ``MSG_ROUNDS`` rounds of ``MSG_CALLS`` calls after
    ``MSG_WARMUP`` warm-up calls, each round ended by a sync, the backends
    in turns."""
    import torch
    from repro_torch.core import PAX_SUM

    x = torch.ones(1, device=dev)
    for fn in calls.values():
        for _ in range(MSG_WARMUP):
            fn(x, PAX_SUM, comm)
    torch.cuda.synchronize(dev)
    us = {impl: [] for impl in calls}
    for _ in range(MSG_ROUNDS):
        for impl, fn in calls.items():
            t0 = time.perf_counter()
            for _ in range(MSG_CALLS):
                fn(x, PAX_SUM, comm)
            torch.cuda.synchronize(dev)
            us[impl].append((time.perf_counter() - t0) / MSG_CALLS * 1e6)
    return us


def phase_abi_swap(card: str) -> dict:
    """The paper's backend swap on the card: full-width qwen2-0.5b at
    ``SWAP_DEPTH`` layers (the [main] phase's batch 8 and sequence 128, one
    batch, seed 0), 3 ZeRO-1
    steps at two buckets under each of ``SWAP_IMPLS`` on NCCL, in turns
    (the order, then the reverse order), through ``launch.abi_swap``.  Each
    run must launch the wire kernels (``pack_transposed`` and
    ``unpack_transposed`` 3 times each, counts zeroed just before it), give
    finite losses and grad norms bitwise equal to the first ``paxi`` run's
    (at one rank every collective of the step is an identity), and leave no
    request in flight.  Then the layer's cost, the paper's Table 1 on the
    card, a record with no gate: µs per blocking ``allreduce`` of one
    float32 (``_us_per_call``) on ``PAX_COMM_WORLD`` (an NCCL group of one)
    and on ``PAX_COMM_SELF`` (no group: the dispatch and translation
    alone)."""
    import dataclasses

    import torch
    import torch.distributed as tdist
    from repro_torch import configs
    from repro_torch.core import PAX_COMM_SELF, PAX_COMM_WORLD
    from repro_torch.launch import abi_swap
    from repro_torch.runtime.dist import init_world, make_dist

    cfg = configs.get_config(ARCH)
    cfg = dataclasses.replace(cfg, num_layers=SWAP_DEPTH, parallelism=dataclasses.replace(
        cfg.parallelism, zero1_buckets=SWAP_BUCKETS))
    batch = abi_swap.first_batch(cfg, 8, 128)
    dev = torch.device("cuda", torch.cuda.current_device())
    started = init_world(dev)
    try:
        ref, step_ms = None, {impl: [] for impl in SWAP_IMPLS}
        for impl in SWAP_IMPLS + SWAP_IMPLS[::-1]:
            _zero_counts()
            run = abi_swap.run_one(cfg, impl, batch, SWAP_STEPS, dev)
            counts = _counts()
            torch.cuda.empty_cache()
            ref = ref or run
            step_ms[impl].extend(run.step_ms[1:])
            log(f"[abi-swap] {impl}: losses {run.losses} grad norms {run.grad_norms} "
                f"wire_kernel={run.wire_kernel} pack_transposed {counts['pack_transposed']} "
                f"unpack_transposed {counts['unpack_transposed']} outstanding before shutdown "
                f"{run.outstanding}; sources {run.sources}; ms/step (steps 2-3) "
                f"{', '.join(f'{t:.1f}' for t in run.step_ms[1:])} on {card}")
            if run.wire_kernel != "cuda":
                raise AssertionError(f"[abi-swap] {impl} wire kernel {run.wire_kernel!r}")
            if (counts["pack_transposed"], counts["unpack_transposed"]) != (SWAP_STEPS,
                                                                           SWAP_STEPS):
                raise AssertionError(f"[abi-swap] {impl} launched {counts}")
            if not all(math.isfinite(v) for v in run.losses + run.grad_norms):
                raise AssertionError(f"[abi-swap] {impl} non-finite: {run.losses}")
            if run.outstanding:
                raise AssertionError(f"[abi-swap] {impl} left {run.outstanding} requests")
            if (run.losses, run.grad_norms) != (ref.losses, ref.grad_norms):
                raise AssertionError(f"[abi-swap] {impl} differs from {ref.impl}: "
                                     f"{run.losses} {run.grad_norms}")
        log(f"[abi-swap] {', '.join(SWAP_IMPLS)}, twice in turns: losses and grad norms "
            f"bitwise equal over {SWAP_STEPS} steps; median ms/step (steps 2-3 of both turns) "
            + "; ".join(f"{impl} {statistics.median(t):.1f}" for impl, t in step_ms.items()))
        dists = {impl: make_dist(impl=impl, device=dev) for impl in SWAP_IMPLS}
        try:
            calls = {impl: d.abi.allreduce for impl, d in dists.items()}
            us = {name: _us_per_call(calls, comm, dev) for name, comm in
                  (("PAX_COMM_WORLD", PAX_COMM_WORLD), ("PAX_COMM_SELF", PAX_COMM_SELF))}
        finally:
            for d in dists.values():
                d.shutdown()
        med = {}
        for name, rows in us.items():
            med[name] = m = {impl: statistics.median(t) for impl, t in rows.items()}
            log(f"[abi-swap] blocking allreduce of one float32 on {name}, us per call (median "
                f"of {MSG_ROUNDS} rounds of {MSG_CALLS} after {MSG_WARMUP} warm-up calls, "
                f"backends in turns) on {card}: "
                + "; ".join(f"{impl} {m[impl]:.2f} (rounds "
                            f"{', '.join(f'{t:.2f}' for t in rows[impl])})" for impl in rows))
            log(f"[abi-swap] {name} ratios to paxi: "
                + ", ".join(f"{impl} {m[impl] / m['paxi']:.3f}" for impl in SWAP_IMPLS[1:]))
    finally:
        if started and tdist.is_initialized():
            tdist.destroy_process_group()
    return {"step_ms": step_ms, "us_per_call": med}

FWD_ITERS = 3
F32_LOGIT_TOL = 1e-3
#: last_only against the full forward's last row: one bf16 rounding (2^-7
#: relative) on top of the f32 reassociation of the unembed's dot product
#: (d = 896 to 4096)
LAST_ONLY_ATOL = 1e-5


def _enqueue_ms(fn, iters: int = FWD_ITERS) -> float:
    """Median host time to enqueue one call (until it returns, before any
    sync), each started on a drained card: near the call's CUDA-event time
    when the host, not the card, sets the pace."""
    import torch

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


class _FlashSpy:
    """Within ``with``, keeps the q, k, v and output of the last
    ``flash_mha`` call the models' attention makes (the wrapper runs as
    it is, so the launch counts are the forward's own); ``check`` then
    holds that output to ``attention_ref`` on the same activations."""

    def __enter__(self):
        from repro_torch.models import attention

        self.seen, self._real = {}, attention.flash_mha

        def spy(q, k, v, *, causal=True):
            out = self._real(q, k, v, causal=causal)
            self.seen = dict(q=q, k=k, v=v, out=out, causal=causal)
            return out

        attention.flash_mha = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention

        attention.flash_mha = self._real

    def check(self, tag: str) -> None:
        from repro_torch.kernels.flash_attention import ref

        q, k, v, out = (self.seen[n] for n in ("q", "k", "v", "out"))
        B, S, H, D = q.shape

        def flat(t):  # flash_mha's (B, S, heads, D) -> the kernel's (B * heads, S, D)
            return t.transpose(1, 2).reshape(-1, S, D)

        want = ref.attention_ref(flat(q), flat(k), flat(v), causal=self.seen["causal"]).float()
        got = flat(out).float()
        torch_sync()
        atol, rtol = BF16_ROUNDINGS
        excess = float(((got - want).abs() - atol - rtol * want.abs()).max())
        log(f"[{tag}] the last flash call's output on the layer's own bf16 activations "
            f"(B={B} S={S} H={H}/{k.shape[2]} D={D}, |q| <= {float(q.float().abs().max()):.2f}, "
            f"|v| <= {float(v.float().abs().max()):.2f}) against attention_ref: max abs err "
            f"{_max_err(got, want):.3e} (atol {atol}, rtol {rtol})")
        if out.dtype != q.dtype or excess > 0:
            raise AssertionError(f"[{tag}] flash output on the model's activations differs "
                                 f"from attention_ref by {_max_err(got, want)}")
        self.seen = {}


def phase_forward(card: str) -> int:
    """The full-sequence forward under ``attention_impl="flash"`` at full
    width; returns the flash launches of one forward (counts zeroed just
    before it, read just after)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import build_model

    cfg = configs.get_config(ARCH)
    impls = ("flash", "xla", "blockwise")
    apis = {impl: build_model(dataclasses.replace(cfg, attention_impl=impl)) for impl in impls}
    model = apis["flash"].init(0, device="cuda")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (FWD_BATCH, FWD_SEQ),
                                     generator=gen).cuda()}
    shape = (FWD_BATCH, FWD_SEQ, cfg.vocab_size)
    with torch.no_grad():
        with _FlashSpy() as spy:
            _zero_counts()
            flash = apis["flash"].forward(model, batch)
            torch_sync()
            counts = _counts()
        launches = counts.pop("flash_attention")
        log(f"[forward] {ARCH} full width, B={FWD_BATCH} S={FWD_SEQ} bf16, flash: "
            f"flash_attention launched {launches} times in one forward "
            f"({cfg.num_layers} layers); other kernels {counts}")
        if launches != cfg.num_layers or any(counts.values()):
            raise AssertionError(f"one flash forward launched flash_attention {launches} "
                                 f"times (want {cfg.num_layers}) and {counts}")
        spy.check("forward")
        xla = apis["xla"].forward(model, batch)
        blockwise = apis["blockwise"].forward(model, batch)
        last = apis["flash"].forward(model, batch, last_only=True)
        torch_sync()
        for name, t in (("flash", flash), ("xla", xla), ("blockwise", blockwise)):
            if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"[forward] {name} logits {tuple(t.shape)}, finite "
                                     f"{bool(torch.isfinite(t).all())}")
        for name, t in (("flash", flash), ("blockwise", blockwise)):
            diff = _max_err(t, xla)
            top1 = float((t.argmax(-1) == xla.argmax(-1)).float().mean())
            log(f"[forward] bf16 logits {name} vs xla: max abs diff {diff:.4e} (logits' max "
                f"abs {float(xla.float().abs().max()):.3f}), top-1 agreement {top1:.4f}")
        del blockwise
        # the last_only forward shares every layer's numbers; only the final
        # norm and the unembed run on one row (another GEMM shape, so another
        # f32 summation order), which may move a logit by one bf16 rounding
        tail = flash[:, -1:]
        gap = float(((last.float() - tail.float()).abs() - LAST_ONLY_ATOL
                     - 2.0 ** -7 * torch.maximum(last.float().abs(), tail.float().abs())).max())
        log(f"[forward] last_only {tuple(last.shape)}: "
            f"{'bitwise equal to' if torch.equal(last, tail) else 'within one bf16 rounding of'}"
            f" the full forward's last row (max abs diff {_max_err(last, tail):.3e})")
        if tuple(last.shape) != (FWD_BATCH, 1, cfg.vocab_size) or gap > 0:
            raise AssertionError(f"[forward] last_only row differs from the full forward's "
                                 f"last row by {_max_err(last, tail)}")
        del last, tail
        ms = {}
        turns = (impls + impls[::-1]) * 2
        for impl in turns:
            ms.setdefault(impl, []).append(
                _time_ms(lambda: apis[impl].forward(model, batch), FWD_ITERS))
        log(f"[forward] ms per forward (median of {FWD_ITERS}, in turns {', '.join(turns)}, "
            f"after 3 warm-ups each), B={FWD_BATCH} S={FWD_SEQ} bf16 on {card}: "
            + "; ".join(f"{impl} {', '.join(f'{t:.2f}' for t in ms[impl])} (median "
                        f"{statistics.median(ms[impl]):.2f})" for impl in impls))
        enqueue = {impl: _enqueue_ms(lambda: apis[impl].forward(model, batch)) for impl in impls}
        log("[forward] host ms to enqueue one forward (median of "
            f"{FWD_ITERS}, each on a drained card): "
            + "; ".join(f"{impl} {t:.2f}" for impl, t in enqueue.items()))
        del flash, xla
        torch.cuda.empty_cache()
        out32 = {}
        for impl in impls:
            api = build_model(dataclasses.replace(cfg, attention_impl=impl,
                                                  compute_dtype="float32"))
            out32[impl] = api.forward(model, batch)
        torch_sync()
        if not all(bool(torch.isfinite(t).all()) for t in out32.values()):
            raise AssertionError("[forward] float32 logits are not all finite")
        for impl in ("flash", "blockwise"):
            diff32 = _max_err(out32[impl], out32["xla"])
            top1_32 = float((out32[impl].argmax(-1) == out32["xla"].argmax(-1)).float().mean())
            log(f"[forward] float32 compute: logits {impl} vs xla max abs diff {diff32:.4e} "
                f"(bound {F32_LOGIT_TOL}), top-1 agreement {top1_32:.4f}")
            if diff32 > F32_LOGIT_TOL:
                raise AssertionError(f"[forward] float32 {impl} and xla logits differ by "
                                     f"{diff32}")
        del out32
    del model
    torch.cuda.empty_cache()
    return launches


GEMMA_ARCH = "gemma-7b"
#: [forward-gemma]'s depth: 7 of 28 layers since PR 22 (the script's time
#: limit; the kernel's D=256 time is [time]'s), full width
GEMMA_DEPTH = 7


def phase_forward_gemma(card: str) -> int:
    """gemma-7b at full width and ``GEMMA_DEPTH`` of 28 layers (d=3072, 16/16 heads at D=256,
    vocabulary 256,000, bf16, seed 0), B=4, S=2048, under
    ``attention_impl="flash"``: the wgmma kernel's D=256 path (one consumer
    warpgroup) on a model's main path, one launch per layer, the last
    call's output held to ``attention_ref`` on its own activations.
    Returns the flash launches of one forward."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import build_model

    cfg = dataclasses.replace(configs.get_config(GEMMA_ARCH), attention_impl="flash",
                              num_layers=GEMMA_DEPTH)
    api = build_model(cfg)
    model = _init_timed(api, "forward-gemma")
    batch = _tokens(cfg)
    with torch.no_grad():
        with _FlashSpy() as spy:
            logits, counts = _forward_check(api, model, batch, cfg, "forward-gemma",
                                            {"flash_attention": cfg.num_layers})
        spy.check("forward-gemma")
        del logits
        ms = _time_ms(lambda: api.forward(model, batch), FWD_ITERS)
    log(f"[forward-gemma] {GEMMA_ARCH} full width ({cfg.num_layers} of "
        f"{configs.get_config(GEMMA_ARCH).num_layers} layers, D="
        f"{cfg.head_dim}), B={FWD_BATCH} S={FWD_SEQ} bf16 on {card}: flash_attention "
        f"{counts['flash_attention']} of {cfg.num_layers} layers; {ms:.2f} ms per forward "
        f"(median of {FWD_ITERS} after 3 warm-ups)")
    del model
    torch.cuda.empty_cache()
    return counts["flash_attention"]


# ---------------------------------------------------------------------------
# the scan kernels (wkv6, ssd) and the ssm and hybrid forwards
# ---------------------------------------------------------------------------
#: H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet): the scans' inputs
#: are float32, so their operations bound is taken at this rate
TF32_FLOP_PER_S = 495e12
SSM_ARCH, HYBRID_ARCH = "rwkv6-7b", "zamba2-2.7b"
ENCDEC_ARCH, VLM_ARCH = "whisper-tiny", "phi-3-vision-4.2b"
# B, T, H, N, chunk: the reference's WKV_SWEEP (tests/test_kernels.py), then
# the main path's shape (rwkv6-7b at [forward-ssm]'s batch and sequence), then
# the tensor-core kernel's edges (N and chunk not multiples of 8; N=3, rows of
# 12 bytes; chunk 1; a single chunk at the main path's N and chunk and at a
# chunk of 64-step tiles; chunk 64 at N=64), checked after every ssd row so
# that ssd's inputs stay those of earlier runs
WKV_SHAPES = ((2, 64, 3, 8, 16), (1, 128, 2, 16, 32), (2, 96, 1, 32, 32), (1, 64, 4, 64, 16))
WKV_FULL = (FWD_BATCH, FWD_SEQ, 64, 64, 32)
WKV_TP = (FWD_BATCH, FWD_SEQ, 16, 64, 32)       # its 16 heads on a rank of four ([ssmtp4])
WKV_EDGES = ((2, 48, 3, 13, 12), (1, 60, 2, 3, 5), (1, 16, 2, 8, 1), (2, 32, 3, 64, 32),
             (1, 40, 2, 16, 40), (1, 256, 2, 64, 64))
# B, T, H, P, N, chunk: the reference's SSD_SWEEP, then the tensor-core kernel's
# edges (P, N and chunk not multiples of 8; N=3, rows of 12 bytes; chunk 1; a
# single chunk), then zamba2-2.7b's shape
SSD_SHAPES = ((2, 64, 3, 4, 8, 16), (1, 128, 2, 16, 16, 32), (2, 128, 1, 32, 64, 64),
              (1, 64, 4, 64, 16, 16),
              (2, 24, 3, 7, 13, 8), (1, 60, 2, 5, 3, 12), (1, 16, 2, 8, 8, 1),
              (2, 64, 2, 64, 64, 64))
SSD_FULL = (FWD_BATCH, FWD_SEQ, 80, 64, 64, 64)
SSD_TP = (FWD_BATCH, FWD_SEQ, 20, 64, 64, 64)    # its 20 heads on a rank of four ([ssmtp4])
#: the reference's tolerances (atol = rtol): against the chunked form, and
#: against the sequential oracle
CHUNKED_TOL, ORACLE_TOL = 3e-4, 5e-4


def _excess(got, want, tol: float) -> float:
    """> 0 where ``got`` leaves ``allclose(atol=rtol=tol)`` of ``want``."""
    return float(((got - want).abs() - tol - tol * want.abs()).max())


def _wkv_inputs(B, T, H, N, dist: str, gen):
    """r, k, v N(0, 1) and u N(0, 0.1) on the card; wlog on the reference
    sweep's distribution (-exp(N(0, 0.5))) or the models' at init
    (-exp(-2 + N(0, 0.1)): w0 = -2 plus a small adapter term), clamped to
    [-5, -1e-4] as the model clamps."""
    import torch

    r, k, v, z = (torch.randn((B, T, H, N), generator=gen, device="cuda") for _ in range(4))
    wlog = -torch.exp(0.5 * z) if dist == "sweep" else -torch.exp(-2.0 + 0.1 * z)
    u = 0.1 * torch.randn((H, N), generator=gen, device="cuda")
    return r, k, v, wlog.clamp(-5.0, -1e-4), u


def _ssd_inputs(B, T, H, P, N, dist: str, gen):
    """x, B, C N(0, 1) on the card.  The sweep's distribution: dt =
    softplus(N(0, 1)), A = -exp(linspace(0, 1, H)), D = 0.5; the models' at
    init: dt = softplus(N(0, 0.5) + log(e - 1)), A = -linspace(1, 16, H),
    D = 1."""
    import torch
    import torch.nn.functional as F

    x = torch.randn((B, T, H, P), generator=gen, device="cuda")
    z = torch.randn((B, T, H), generator=gen, device="cuda")
    Bm, Cm = (torch.randn((B, T, N), generator=gen, device="cuda") for _ in range(2))
    if dist == "sweep":
        dt = F.softplus(z)
        A = -torch.exp(torch.linspace(0.0, 1.0, H, device="cuda"))
        D = torch.full((H,), 0.5, device="cuda")
    else:
        dt = F.softplus(0.5 * z + math.log(math.e - 1))
        A = -torch.linspace(1.0, 16.0, H, device="cuda")
        D = torch.ones(H, device="cuda")
    return x, dt, A, Bm, Cm, D


def _wkv_oracle(r, k, v, wlog, u):
    """The sequential oracle in model layout (it takes (B*H, T, N))."""
    from repro_torch.kernels.rwkv6_scan import ref

    B, T, H, N = r.shape
    flat = [a.permute(0, 2, 1, 3).reshape(B * H, T, N) for a in (r, k, v, wlog)]
    out = ref.wkv6_ref(*flat, u.repeat(B, 1))
    return out.reshape(B, H, T, N).permute(0, 2, 1, 3)


def _ssd_oracle(x, dt, A, Bm, Cm, D):
    """The sequential oracle in model layout, B and C broadcast to every
    head as the reference's wrapper broadcasts them."""
    from repro_torch.kernels.mamba2_ssd import ref

    B, T, H, P = x.shape
    N = Bm.shape[-1]
    bc = [a[:, None].expand(B, H, T, N).reshape(B * H, T, N) for a in (Bm, Cm)]
    out = ref.ssd_ref(x.permute(0, 2, 1, 3).reshape(B * H, T, P),
                      dt.permute(0, 2, 1).reshape(B * H, T), *bc, A.repeat(B), D.repeat(B))
    return out.reshape(B, H, T, P).permute(0, 2, 1, 3)


def _misaligned(t):
    """A copy of ``t`` as a contiguous view 4 bytes past an aligned base."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


def phase_check_scans() -> dict:
    """Both scan kernels against their plain chunked versions (gate 3e-4)
    and the sequential oracles (gate 5e-4) at every reference sweep shape
    and the kernels' edges, on the sweep's and the models' input
    distributions, and at the main path's full-width shapes, where the
    oracle's error is a record: T=2048 is 16x longer than any shape the
    reference holds to it; there each kernel and its plain form are also
    held to the plain form run in float64 (``ssd``: a record; ``wkv6``: the
    kernel within twice the plain form's distance; a record at ``wkv6``'s
    chunk of 64).  Every row must launch the kernel's entry point, and the
    kernel must be not finite exactly where the plain form is not.  Returns
    the worst kernel-vs-plain difference at the full-width shapes (the
    models' heads, and their heads on a rank of [ssmtp4]: ``WKV_TP``,
    ``SSD_TP``)."""
    import torch
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"wkv6": 0.0, "ssd": 0.0}
    scans = {"wkv6": (wkv_ops.wkv6_apply, wkv_ref.wkv6, _wkv_inputs, _wkv_oracle,
                      (WKV_FULL, WKV_TP)),
             "ssd": (ssd_ops.ssd_apply, ssd_ref.ssd, _ssd_inputs, _ssd_oracle,
                     (SSD_FULL, SSD_TP))}
    entries = {"wkv6": wkv_ops.ENTRY, "ssd": ssd_ops.ENTRY}
    dists = ("sweep", "model")
    cases = ([("wkv6", shape, dist) for shape in (*WKV_SHAPES, WKV_FULL, WKV_TP)
              for dist in dists]
             + [("ssd", shape, dist) for shape in (*SSD_SHAPES, SSD_FULL, SSD_TP)
                for dist in dists]
             + [("ssd", (2, 128, 3, 64, 64, 64), "misaligned")]
             + [("wkv6", shape, dist) for shape in WKV_EDGES for dist in dists]
             + [("wkv6", (2, 128, 3, 64, 32), "misaligned")])
    for name, shape, dist in cases:
        ops, ref, make, oracle_fn, full_shapes = scans[name]
        if dist == "misaligned":
            _check_misaligned(name, shape, ops, ref, make, oracle_fn, entries[name], gen)
            continue
        *dims, chunk = shape
        args = make(*dims, dist, gen)
        before = ops.launches
        got = ops(*args, chunk=chunk)
        via = f" via {entries[name]}" if ops.launches == before + 1 else ""
        plain = ref(*args, chunk=chunk)
        oracle = oracle_fn(*args)
        full = shape in full_shapes
        torch_sync()
        # wkv6's factorised form (the reference's) overflows exp(-la) once a
        # chunk's log decay passes about -88 (ROADMAP queue 3): the kernel
        # computes the same function, so it must be not finite exactly where
        # the plain form is not, and both gates hold at every other output
        ok = torch.isfinite(plain)
        hazard = int((~ok).sum())
        same = bool(torch.equal(torch.isfinite(got), ok))
        pick = (lambda t: t[ok]) if hazard else (lambda t: t)
        g, p, o = pick(got), pick(plain), pick(oracle)
        err, err_o = _max_err(g, p), _max_err(g, o)
        over, over_o = _excess(g, p, CHUNKED_TOL), _excess(g, o, ORACLE_TOL)
        log(f"[check] {name} {shape} {dist}{via}: max abs err vs "
            f"plain {err:.3e} (gate {CHUNKED_TOL}), vs oracle {err_o:.3e} "
            f"({'record' if full else 'gate'} {ORACLE_TOL}"
            f"{', inside' if over_o <= 0 else ', OUTSIDE'}); |y| max "
            f"{float(oracle.abs().max()):.3e}"
            + (f"; the plain form overflows at {hazard} of {plain.numel()} outputs, the kernel "
               f"{'at the same' if same else 'NOT at the same'}, both gates held at the rest"
               if hazard else ""))
        del g, p, o
        if not same or got.shape != plain.shape or over > 0 or (over_o > 0 and not full) \
                or not via:
            raise AssertionError(f"{name} disagrees at {shape} {dist}: the plain form's "
                                 f"non-finite outputs {same}, vs plain {err}, vs oracle {err_o}, "
                                 f"launched {via or 'none'}")
        # the float64 run: at full width (a gate for wkv6, a record for ssd),
        # and as a record at wkv6's 64-step tiles, which lack the split
        # accumulators of its 32-step ones
        if full or (name == "wkv6" and chunk > 32):
            if full:
                worst[name] = max(worst[name], err)
            del oracle
            f64 = pick(ref(*(a.double() for a in args), chunk=chunk))
            e_k, e_p = _max_err(pick(got), f64), _max_err(pick(plain), f64)
            gated = full and name == "wkv6"
            log(f"[check] {name} {shape} {dist} against the plain form in float64 "
                f"({'gate: the kernel within twice the plain f32 form' if gated else 'a record'})"
                f": kernel {e_k:.3e}, plain form in f32 {e_p:.3e}"
                + (f" (at the {plain.numel() - hazard} outputs where the f32 plain form is "
                   "finite)"
                   if hazard else ""))
            if gated and e_k > 2 * e_p:
                raise AssertionError(f"{name} at {shape} {dist} is {e_k} from the float64 run, "
                                     f"more than twice the plain f32 form's {e_p}")
            del f64
        del args, got, plain
    _check_ssd_nan(gen)
    torch.cuda.empty_cache()
    return worst


#: (input, index) of the one NaN each [check] NaN row puts into ``ssd``'s
#: full-width inputs (x, dt, B, C at (Bb, T, H, P), (Bb, T, H), (Bb, T, N)),
#: and the same at a shape off the P = N = chunk = 64 path
SSD_NAN = (("x", 0, (0, 1027, 5, 7)), ("dt", 1, (1, 683, 11)), ("B", 3, (2, 100, 9)),
           ("C", 4, (3, 1500, 20)))
SSD_NAN_EDGE = ((1, 128, 2, 16, 16, 32), (("x", 0, (0, 40, 1, 3)), ("dt", 1, (0, 70, 0)),
                                          ("B", 3, (0, 33, 2)), ("C", 4, (0, 127, 15))))


def _check_ssd_nan(gen) -> None:
    """``ssd`` with one NaN in x, dt, B or C, at full width and at a shape
    off the P = N = chunk = 64 path: the scan's TF32 split is unscreened
    (a screen spills its registers), so the kernel's non-finite pass must
    make its output not finite at exactly the plain form's non-finite
    outputs (``ref.ssd_nonfinite_mask``'s rule), and equal to the plain
    form within the gate everywhere else."""
    import torch
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.mamba2_ssd import ref as ssd_ref

    for shape, rows in ((SSD_FULL, SSD_NAN), SSD_NAN_EDGE):
        *dims, chunk = shape
        base = _ssd_inputs(*dims, "model", gen)
        for name, i, at in rows:
            args = list(base)
            args[i] = args[i].clone()
            args[i][at] = float("nan")
            before = ssd_ops.ssd_apply.launches
            got = ssd_ops.ssd_apply(*args, chunk=chunk)
            plain = ssd_ref.ssd(*args, chunk=chunk)
            torch_sync()
            ok = torch.isfinite(plain)
            differ = int((ok ^ torch.isfinite(got)).sum())
            over = _excess(got[ok], plain[ok], CHUNKED_TOL)
            rule = torch.equal(~ok, ssd_ref.ssd_nonfinite_mask(args[0], args[1], args[3],
                                                                args[4], chunk))
            log(f"[check] ssd {shape} one NaN in {name} at {at}: the plain form is not finite "
                f"at {int((~ok).sum())} of {plain.numel()} outputs, the kernel at "
                f"{int((~torch.isfinite(got)).sum())}; they differ at {differ}; max abs err vs "
                f"plain where finite {_max_err(got[ok], plain[ok]):.3e} (gate {CHUNKED_TOL}); "
                f"the mask rule holds: {rule}")
            if differ or over > 0 or not rule or ssd_ops.ssd_apply.launches != before + 1:
                raise AssertionError(f"ssd with a NaN in {name} at {shape}: not finite at "
                                     f"{differ} outputs where the plain form differs, "
                                     f"{over} past the gate, rule {rule}")
            del args, got, plain, ok


def _check_misaligned(name, shape, ops, ref, make, oracle_fn, entry, gen) -> None:
    """Inputs at a misaligned base: the kernels read 4-byte words (wkv6 at
    N=64 and chunk 32 leaves its 16-byte copies for them), so views 4 bytes
    past a 16-byte boundary go through as they are."""
    import torch

    *dims, chunk = shape
    args = make(*dims, "model", gen)
    shifted = tuple(_misaligned(a) for a in args)
    before = ops.launches
    got = ops(*shifted, chunk=chunk)
    plain, oracle = ref(*args, chunk=chunk), oracle_fn(*args)
    torch_sync()
    log(f"[check] {name} misaligned views ({shape}, base % 16 = "
        f"{shifted[0].data_ptr() % 16}) via {entry}: max abs err vs plain "
        f"{_max_err(got, plain):.3e} (gate {CHUNKED_TOL}), vs oracle "
        f"{_max_err(got, oracle):.3e} (gate {ORACLE_TOL})")
    if (ops.launches != before + 1 or not bool(torch.isfinite(got).all())
            or _excess(got, plain, CHUNKED_TOL) > 0 or _excess(got, oracle, ORACLE_TOL) > 0):
        raise AssertionError(f"{name} disagrees on misaligned views: {_max_err(got, plain)}")


def _scan_work(name: str, args, chunk: int) -> tuple:
    """(bytes, FLOP) of one launch on these inputs: each input read once and
    the output written once (float32); the four products of every chunk at
    full size, as the reference's kernel computes them."""
    x = args[0]
    nbytes = 4 * (sum(a.numel() for a in args) + x.numel())
    if name == "wkv6":
        B, T, H, N = x.shape
        flops = (T // chunk) * B * H * (2 * chunk * chunk * N * 2 + 2 * chunk * N * N * 2)
    else:
        B, T, H, P = x.shape
        N = args[3].shape[-1]
        flops = (T // chunk) * B * H * 2 * chunk * (chunk * N + chunk * P + 2 * N * P)
    return nbytes, flops


#: the dims an earlier scan source's entry point ``pax_<name>`` takes after
#: the inputs' and the output's pointers, then chunk and the stream: those of
#: the first input, and for ssd its state width N (the last dim of B)
BASELINE_DIMS = {"wkv6": lambda a: a[0].shape, "ssd": lambda a: (*a[0].shape, a[3].shape[-1])}


def _baseline(name: str, path: Path):
    """``launch(*inputs, chunk) -> y`` of an earlier ``name`` source built
    from ``path`` (the current kernel's arguments less a scratch buffer)."""
    import torch
    from repro_torch.kernels import _build

    entry = f"pax_{name}"
    fn = getattr(ctypes.CDLL(str(_build.build(f"{name}_baseline", [path]))), entry)
    fn.restype = ctypes.c_int

    def launch(*inputs, chunk):
        y = torch.empty_like(inputs[0])
        rc = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (*inputs, y)),
                *map(ctypes.c_longlong, (*BASELINE_DIMS[name](inputs), chunk)),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"{path} {entry} launch failed: CUDA error {rc}")
        return y

    return launch


def phase_time_scans(card: str, baselines: dict) -> dict:
    """Kernel and plain version at the main paths' shapes (the models'
    input distribution), and at their heads on a rank of [ssmtp4] (a
    record: ``tp_ms``, ``tp_plain_ms``, ``tp_bound_ms``); no single PyTorch
    call computes either scan, so
    there is no library time.  Each also logs its 3xTF32 tensor-core floor
    (three times its FLOPs at the TF32 rate) and its resident blocks per
    SM and, where ``baselines`` names one (``{"wkv6": path, "ssd": path}``),
    an earlier source timed in turns with it.  ``ssd`` is also timed in
    turns without and with its non-finite pass (``ops.scan`` against
    ``ops.launch_ssd``), the pass's cost a record."""
    import torch
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for name, shape, make, ops, kernel, plain in (
            ("wkv6", WKV_FULL, _wkv_inputs, wkv_ops, wkv_ops.wkv6_apply, wkv_ref.wkv6),
            ("ssd", SSD_FULL, _ssd_inputs, ssd_ops, ssd_ops.ssd_apply, ssd_ref.ssd),
            ("wkv6_tp", WKV_TP, _wkv_inputs, wkv_ops, wkv_ops.wkv6_apply, wkv_ref.wkv6),
            ("ssd_tp", SSD_TP, _ssd_inputs, ssd_ops, ssd_ops.ssd_apply, ssd_ref.ssd)):
        tp = name.endswith("_tp")
        name = name.removesuffix("_tp")
        *dims, chunk = shape
        args = make(*dims, "model", gen)
        nbytes, flops = _scan_work(name, args, chunk)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / TF32_FLOP_PER_S
        t = dict(ms=_time_ms(lambda: kernel(*args, chunk=chunk)),
                 plain_ms=_time_ms(lambda: plain(*args, chunk=chunk)), library_ms=None,
                 bound_ms=max(t_bytes, t_ops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"[time] {name} {shape} f32 on {card}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library none, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
            f"{flops:.3e} FLOP at {TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s TF32 = {t_ops * 1e3:.4f}"
            f" ms, at the {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s CUDA-core f32 rate "
            f"{flops / F32_FLOP_PER_S * 1e3:.3f} ms)")
        log(f"[time] {name} as 3xTF32: {3 * flops:.3e} FLOP on the tensor cores, the kernel's "
            f"own floor {3 * flops / TF32_FLOP_PER_S * 1e3:.4f} ms; "
            f"{ops.blocks_per_sm()} resident blocks per SM")
        if tp:  # the rank's heads of [ssmtp4]: a record beside the full-head row
            out[name].update({f"tp_{k}": t[k] for k in ("ms", "plain_ms", "bound_ms")})
            del args
            continue
        if name == "ssd":
            turns = ("scan", "scan + pass", "scan + pass", "scan")
            ms = {}
            for who in turns:
                fn = ops.scan if who == "scan" else ops.launch_ssd
                ms.setdefault(who, []).append(_time_ms(lambda: fn(*args, chunk=chunk)))
            extra = statistics.mean(ms["scan + pass"]) - statistics.mean(ms["scan"])
            t["nan_pass_ms"] = extra
            log(f"[time] ssd {shape} f32 on {card}, in turns {', '.join(turns)}: the scan alone "
                f"{', '.join(f'{v:.3f}' for v in ms['scan'])} ms, with the non-finite pass "
                f"{', '.join(f'{v:.3f}' for v in ms['scan + pass'])} ms: the pass costs "
                f"{extra:.3f} ms a launch, {54 * extra:.2f} ms of a zamba2-2.7b forward's 54 "
                "launches")
        if baselines.get(name) is not None:
            path = baselines[name]
            old = _baseline(name, path)
            err = _max_err(old(*args, chunk=chunk), kernel(*args, chunk=chunk))
            turns = ("baseline", "kernel", "kernel", "baseline")
            ms = {}
            for who in turns:
                fn = old if who == "baseline" else kernel
                ms.setdefault(who, []).append(_time_ms(lambda: fn(*args, chunk=chunk)))
            log(f"[time] {name} {shape} f32 on {card}, in turns {', '.join(turns)}: "
                f"{path.name} (pax_{name}) {', '.join(f'{v:.3f}' for v in ms['baseline'])} "
                f"ms, {ops.ENTRY} {', '.join(f'{v:.3f}' for v in ms['kernel'])} ms; the two "
                f"outputs differ by {err:.3e}")
        out[name] = t
        del args
    torch.cuda.empty_cache()
    return out


def _forward_check(api, model, batch, cfg, tag: str, want: dict, shape=None):
    """One full-width forward with the counts zeroed just before it and read
    just after; fails unless the launches are ``want`` (every other kernel
    0) and the logits are finite, of ``shape`` (default (B, S, vocab) at
    [forward]'s batch and sequence).  Returns the logits and the counts."""
    import torch

    _zero_counts()
    logits = api.forward(model, batch)
    torch_sync()
    counts = _counts()
    expected = {name: want.get(name, 0) for name in counts}
    log(f"[{tag}] launches in one forward: "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v or k in want))
    if counts != expected:
        raise AssertionError(f"[{tag}] launched {counts}, expected {expected}")
    shape = shape or (FWD_BATCH, FWD_SEQ, cfg.vocab_size)
    if tuple(logits.shape) != shape or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[{tag}] logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    return logits, counts


def _last_only_check(api, model, batch, full, tag: str) -> None:
    import torch

    last = api.forward(model, batch, last_only=True)
    tail = full[:, -1:]
    gap = float(((last.float() - tail.float()).abs() - LAST_ONLY_ATOL
                 - 2.0 ** -7 * torch.maximum(last.float().abs(), tail.float().abs())).max())
    log(f"[{tag}] last_only {tuple(last.shape)}: "
        f"{'bitwise equal to' if torch.equal(last, tail) else 'within one bf16 rounding of'}"
        f" the full forward's last row (max abs diff {_max_err(last, tail):.3e})")
    if gap > 0:
        raise AssertionError(f"[{tag}] last_only row differs from the full forward's last "
                             f"row by {_max_err(last, tail)}")


def _init_timed(api, tag: str):
    import torch

    t0 = time.perf_counter()
    model = api.init(0, device="cuda")
    torch_sync()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[{tag}] init: {n} parameters ({nbytes / 1e9:.2f} GB) drawn on the CPU (seed 0, "
        f"{os.cpu_count()} threads) in {time.perf_counter() - t0:.1f} s "
        f"({n / (time.perf_counter() - t0) / 1e6:.0f} M parameters a second)")
    return model


def _tokens(cfg):
    import torch

    gen = torch.Generator().manual_seed(1)
    return {"tokens": torch.randint(0, cfg.vocab_size, (FWD_BATCH, FWD_SEQ),
                                    generator=gen).cuda()}


#: [forward-ssm] and [serve-ssm]'s rwkv6-7b depth: 16 of 32 layers since PR
#: 22 (the script's time limit), full width
SSM_FWD_DEPTH = 16


def _serving_config(arch: str):
    """The config [forward-ssm]/[serve-ssm] and [forward-hybrid]/
    [serve-hybrid] run: full width, rwkv6-7b cut to ``SSM_FWD_DEPTH``."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(arch)
    return dataclasses.replace(cfg, num_layers=SSM_FWD_DEPTH) if arch == SSM_ARCH else cfg


def phase_forward_ssm(card: str) -> tuple:
    """rwkv6-7b at full width (bf16, random weights from seed 0), B=4,
    S=2048, through ``build_model(cfg).forward``: one ``wkv6`` launch per
    layer and nothing else.  Returns the ``wkv6`` launches counted in one
    forward and the model ([serve-ssm] serves it)."""
    import torch
    from repro_torch.models import build_model

    cfg = _serving_config(SSM_ARCH)
    api = build_model(cfg)
    model = _init_timed(api, "forward-ssm")
    batch = _tokens(cfg)
    with torch.no_grad():
        logits, counts = _forward_check(api, model, batch, cfg, "forward-ssm",
                                        {"wkv6": cfg.num_layers})
        _last_only_check(api, model, batch, logits, "forward-ssm")
        del logits
        ms = [_time_ms(lambda: api.forward(model, batch), FWD_ITERS) for _ in range(2)]
        enqueue = _enqueue_ms(lambda: api.forward(model, batch))
    log(f"[forward-ssm] {SSM_ARCH} full width ({cfg.num_layers} of 32 layers), B={FWD_BATCH} "
        f"S={FWD_SEQ} bf16 on {card}: {ms[0]:.2f}, {ms[1]:.2f} ms per forward (median of "
        f"{FWD_ITERS} after 3 warm-ups, twice)")
    log(f"[forward-ssm] host ms to enqueue one forward (median of {FWD_ITERS}, each on a "
        f"drained card): {enqueue:.2f}")
    return counts["wkv6"], model


def phase_forward_hybrid(card: str) -> tuple:
    """zamba2-2.7b at full width (bf16, seed 0), B=4, S=2048, under
    ``attention_impl="flash"`` (one ``ssd`` launch per layer, one flash
    launch per firing of the shared block) and then ``"xla"`` on the same
    weights (the ``ssd`` launches alone).  Returns the flash run's counts
    and the model ([serve-hybrid] serves it)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import build_model

    cfg = configs.get_config(HYBRID_ARCH)
    apis = {impl: build_model(dataclasses.replace(cfg, attention_impl=impl))
            for impl in ("flash", "xla")}
    model = _init_timed(apis["flash"], "forward-hybrid")
    batch = _tokens(cfg)
    firings = cfg.num_layers // cfg.hybrid.shared_attn_every
    with torch.no_grad():
        with _FlashSpy() as spy:
            flash, counts = _forward_check(apis["flash"], model, batch, cfg, "forward-hybrid",
                                           {"ssd": cfg.num_layers, "flash_attention": firings})
        spy.check("forward-hybrid")
        xla, _ = _forward_check(apis["xla"], model, batch, cfg, "forward-hybrid",
                                {"ssd": cfg.num_layers})
        top1 = float((flash.argmax(-1) == xla.argmax(-1)).float().mean())
        log(f"[forward-hybrid] bf16 logits flash vs xla: max abs diff "
            f"{_max_err(flash, xla):.4e} (logits' max abs {float(xla.float().abs().max()):.3f}), "
            f"top-1 agreement {top1:.4f}")
        del xla
        _last_only_check(apis["flash"], model, batch, flash, "forward-hybrid")
        del flash
        turns = ("flash", "xla", "xla", "flash")
        ms = {}
        for impl in turns:
            ms.setdefault(impl, []).append(
                _time_ms(lambda: apis[impl].forward(model, batch), FWD_ITERS))
        enqueue = {impl: _enqueue_ms(lambda: apis[impl].forward(model, batch))
                   for impl in ("flash", "xla")}
    log(f"[forward-hybrid] {HYBRID_ARCH} full width ({cfg.num_layers} layers, {firings} "
        f"shared-block firings), B={FWD_BATCH} S={FWD_SEQ} bf16 on {card}, ms per forward "
        f"(median of {FWD_ITERS}, in turns {', '.join(turns)}): "
        + "; ".join(f"{impl} {t[0]:.2f}, {t[1]:.2f}" for impl, t in ms.items()))
    log(f"[forward-hybrid] host ms to enqueue one forward (median of {FWD_ITERS}, each on a "
        "drained card): " + "; ".join(f"{impl} {t:.2f}" for impl, t in enqueue.items()))
    return counts, model


#: [card-vs-cpu]: the ssm, hybrid, encdec and vlm families at full width and
#: reduced depth (the hybrid's shared block fires once; whisper's encoder
#: keeps its 4 layers), float32, B=1, S=256 (text positions)
CPU_DEPTH = {SSM_ARCH: 2, HYBRID_ARCH: 6, ENCDEC_ARCH: 2, VLM_ARCH: 2}
CPU_SEQ = 256


def phase_card_vs_cpu() -> None:
    """The same CPU-drawn weights forward on the CPU (the kernels' plain
    versions) and on the card (the kernels): f32 logits within 1e-3."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import build_model, make_batch

    for arch, depth in CPU_DEPTH.items():
        cfg = dataclasses.replace(configs.get_config(arch), num_layers=depth,
                                  param_dtype="float32", compute_dtype="float32",
                                  attention_impl="flash")
        api = build_model(cfg)
        model = api.init(0, device="cpu")
        if arch in (SSM_ARCH, HYBRID_ARCH):
            gen = torch.Generator().manual_seed(2)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, CPU_SEQ), generator=gen)}
        else:  # with the frames or the patches
            batch = make_batch(2, cfg, 1, CPU_SEQ, "cpu")
        with torch.no_grad():
            t0 = time.perf_counter()
            cpu = api.forward(model, batch)
            cpu_s = time.perf_counter() - t0
            model = model.to("cuda")
            before = _counts()
            card = api.forward(model, {k: v.cuda() for k, v in batch.items()}).cpu()
        launched = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
        want = ({"wkv6": depth} if arch == SSM_ARCH else
                {"flash_attention": depth // cfg.hybrid.shared_attn_every, "ssd": depth}
                if arch == HYBRID_ARCH else {"flash_attention": depth})
        diff = _max_err(card, cpu)
        log(f"[card-vs-cpu] {arch} full width, {depth} layers, f32, B=1 S={CPU_SEQ}: card "
            f"(kernels {launched}) vs CPU (plain versions, {cpu_s:.1f} s) logits max abs diff "
            f"{diff:.3e} (bound {F32_LOGIT_TOL}; logits' max abs {float(cpu.abs().max()):.3f})")
        if diff > F32_LOGIT_TOL or launched != want or not bool(torch.isfinite(card).all()):
            raise AssertionError(f"[card-vs-cpu] {arch}: card and CPU logits differ by {diff}, "
                                 f"kernels launched {launched}")
        del model, cpu, card
        torch.cuda.empty_cache()


#: [serve]: full-width qwen2-0.5b behind the continuous-batching engine with
#: the reference launcher's pages and chunks
SERVE_ENGINE = dict(max_batch=8, block_size=16, prefill_chunk=32, max_seq=640)
SERVE_GREEDY, SERVE_NEW = 16, 64
SERVE_PROMPTS = (64, 512)                 # prompt lengths, drawn inclusive
SERVE_ORACLE = (0, 5, 10, 15)             # greedy requests replayed one at a time
SERVE_SAMPLED = dict(temperature=0.8, top_k=50)
SERVE_BENCH = dict(requests=32, mean_gap_steps=2.0, prompt_range=(64, 513), new_tokens=64)
SERVE_BELOW = 0.8                         # the second load's share of admission capacity
#: [serve] card vs CPU: depth, requests (prompt length, new tokens), and the
#: top-2 margin of the CPU logits below which a greedy token may flip
SERVE_CPU_DEPTH = 2
#: [serve]'s depth: 8 of qwen2-0.5b's 24 layers since PR 27 (the script's
#: time limit), full width
SERVE_DEPTH = 8
SERVE_CPU_REQS = ((100, 16), (40, 16))
MARGIN = 1e-3


class _StepTimer:
    """The engine's ``step_hook``: records, for each model step by kind,
    the host's enqueue time (until the call returns) and the stream time
    between CUDA events around it.  On a host-bound stream that span is the
    enqueue time again, not the device's busy time (the trace gives that).
    With ``drain`` each call starts on a drained card and the host wall time
    until the card is drained again is recorded too; without it the engine
    runs as it would untimed."""

    def __init__(self, drain: bool) -> None:
        self.drain = drain
        self.rec = {k: {"enqueue": [], "wall": [], "events": []} for k in ("prefill", "decode")}

    def __call__(self, kind: str, fn, *args):
        import torch

        rec = self.rec[kind]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if self.drain:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        out = fn(*args)
        b.record()
        rec["enqueue"].append((time.perf_counter() - t0) * 1e3)
        if self.drain:
            torch.cuda.synchronize()
            rec["wall"].append((time.perf_counter() - t0) * 1e3)
        rec["events"].append((a, b))
        return out

    def medians(self, kind: str) -> dict:
        import torch

        torch.cuda.synchronize()
        rec = self.rec[kind]
        span = [a.elapsed_time(b) for a, b in rec["events"]]
        out = {"n": len(span), "event_span_ms": statistics.median(span),
               "enqueue_ms": statistics.median(rec["enqueue"])}
        if self.drain:
            out["wall_ms"] = statistics.median(rec["wall"])
        return out


def _serve_requests(cfg):
    """16 greedy requests and 2 sampled ones, prompts from ``default_rng(0)``."""
    import numpy as np
    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, SERVE_GREEDY + 2)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]
    return [Request(i, p, max_new_tokens=SERVE_NEW,
                    **(SERVE_SAMPLED if i >= SERVE_GREEDY else {}))
            for i, p in enumerate(prompts)]


def _drain_timed(eng, reqs) -> tuple:
    """Submit ``reqs`` and step the engine until it is empty; returns (wall
    seconds, each step's host wall ms).  Every step ends in a copy to the
    host, so its wall time holds its device time."""
    for r in reqs:
        eng.submit(r)
    steps = []
    t0 = time.perf_counter()
    while eng.has_work:
        t = time.perf_counter()
        eng.step()
        steps.append((time.perf_counter() - t) * 1e3)
    return time.perf_counter() - t0, steps


def _logits_copy_ms(cfg) -> float:
    """Median time of the decode step's one copy to the host: the (8, vocab)
    bf16 logits block, then its float32 view on the host."""
    import torch

    x = torch.randn(SERVE_ENGINE["max_batch"], cfg.vocab_size, device="cuda",
                    dtype=torch.bfloat16)
    times = []
    for _ in range(3 + TIMING_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x.cpu().float().numpy()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[3:])


def _profile_model_step(fn, n: int = 5) -> dict:
    """``n`` calls of one model step under ``torch.profiler`` (after one
    warm call): per call, the device's work launches (kernels, copies,
    memsets), its busy time (the union of their intervals) and its time by
    kernel class, read from the exported trace as ``launch.profile_step``
    reads a training step's."""
    import tempfile
    from collections import Counter

    import torch
    from repro_torch.launch.profile_step import kernel_class, trace_summary
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    summary = trace_summary(events, n)
    classes = Counter()
    for name, (ms, _) in summary["work"].items():
        classes[kernel_class(name)] += ms
    return {"launches": sum(c for _, c in summary["work"].values()) / n,
            "busy_ms": summary["busy_ms"],
            "by_class_ms": {k: round(v, 4) for k, v in classes.most_common()}}


def phase_serve(card: str) -> dict:
    """[serve]: full-width qwen2-0.5b at ``SERVE_DEPTH`` layers (bf16,
    random weights from seed 0) behind ``ServeEngine`` with a ``decode-tp`` plan group on NCCL.

    * 16 greedy requests and 2 sampled ones served continuously; 4 of the
      greedy ones and both sampled ones then served one at a time on the
      same engine must give the same tokens;
    * one ``decode-tp`` call counted per decode step, no KV block live at
      the end, no kernel launched (serving runs none of the port's kernels);
    * ms per decode step at B=8 and per prefill chunk (stream time between
      CUDA events, host wall around a drained step, host enqueue),
      generated tokens/s, and ``launch.bench_serve``'s open-loop p50/p99
      at the set load and at ``SERVE_BELOW`` of the admission capacity;
    * the engine on the card against the engine on the CPU at 2 layers in
      float32 (:func:`_serve_card_vs_cpu`).

    Returns the numbers it logs."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core import CallCounter
    from repro_torch.launch import bench_serve
    from repro_torch.models import build_model
    from repro_torch.runtime.dist import make_dist
    from repro_torch.serve import DecodeSync, Request, ServeEngine

    _zero_counts()
    cfg = dataclasses.replace(configs.get_config(ARCH), num_layers=SERVE_DEPTH)
    api = build_model(cfg)
    model = _init_timed(api, "serve")
    out = {}
    with make_dist(device="cuda") as dist:
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        eng = ServeEngine(api, model, dist=dist, seed=0, **SERVE_ENGINE)
        pool = sum(t.numel() * t.element_size() for t in eng._pages)
        log(f"[serve] {ARCH} full width ({cfg.num_layers} of "
            f"{configs.get_config(ARCH).num_layers} layers, d={cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads at D={cfg.resolved_head_dim}, vocab "
            f"{cfg.vocab_size}) bf16 on {card}, {dist.abi.backend.name} on "
            f"{torch.distributed.get_backend()}: engine {SERVE_ENGINE}, KV pool "
            f"{eng.alloc.num_blocks} blocks ({pool / 1e6:.1f} MB)")
        eng.run([Request(1000, np.arange(1, 41, dtype=np.int32), max_new_tokens=4)])  # warm-up
        cc.reset()
        base = dict(eng.stats)

        reqs = _serve_requests(cfg)
        eng.step_hook = timer = _StepTimer(drain=False)
        wall, step_ms = _drain_timed(eng, reqs)
        out["run_decode"], out["run_prefill"] = timer.medians("decode"), timer.medians("prefill")
        n_tok = sum(len(r.out_tokens) for r in reqs)
        st = {k: eng.stats[k] - base[k] for k in ("steps", "decode_steps", "prefill_chunks")}
        out["tokens_per_s"] = n_tok / wall
        out["engine_step_ms"] = statistics.median(step_ms)
        log(f"[serve] continuous: {len(reqs)} requests ({SERVE_GREEDY} greedy, 2 sampled at "
            f"{SERVE_SAMPLED}; prompts {SERVE_PROMPTS[0]}-{SERVE_PROMPTS[1]}, {SERVE_NEW} new "
            f"tokens each): {n_tok} tokens in {wall:.3f} s = {out['tokens_per_s']:.1f} "
            f"tokens/s; {st['steps']} engine steps (median {out['engine_step_ms']:.2f} ms, "
            f"host wall), {st['decode_steps']} decode steps, {st['prefill_chunks']} prefill "
            f"chunks")
        log(f"[serve] in that run, per model step (medians; stream time between CUDA events, "
            f"host enqueue): decode (B=8) {out['run_decode']['event_span_ms']:.3f} ms, "
            f"{out['run_decode']['enqueue_ms']:.3f} ms (n={out['run_decode']['n']}); prefill "
            f"chunk (1x32) {out['run_prefill']['event_span_ms']:.3f} ms, "
            f"{out['run_prefill']['enqueue_ms']:.3f} ms (n={out['run_prefill']['n']})")
        if n_tok != len(reqs) * SERVE_NEW or not all(r.done for r in reqs):
            raise AssertionError(f"[serve] {n_tok} tokens for {len(reqs)} requests")

        # one at a time on the same engine, each model step on a drained card
        eng.step_hook = timer = _StepTimer(drain=True)
        replay = [reqs[i] for i in SERVE_ORACLE] + reqs[SERVE_GREEDY:]
        for r in replay:
            solo = Request(r.rid, r.prompt, r.max_new_tokens, r.temperature, r.top_k)
            eng.run([solo])
            if solo.out_tokens != r.out_tokens:
                raise AssertionError(f"[serve] request {r.rid}: one at a time "
                                     f"{solo.out_tokens[:8]}... vs continuous "
                                     f"{r.out_tokens[:8]}...")
        log(f"[serve] token identity: requests {[r.rid for r in replay]} served one at a time "
            f"give the continuous run's {SERVE_NEW} tokens each (sampled ones included)")
        out["decode"], out["prefill"] = timer.medians("decode"), timer.medians("prefill")
        eng.step_hook = None
        # the two model steps traced at their fixed shapes; every row on the
        # null block, which no live request reads (the engine is empty now)
        width = eng.scheduler.table_width
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device="cuda")  # noqa: E731
        B, C = SERVE_ENGINE["max_batch"], SERVE_ENGINE["prefill_chunk"]
        with torch.no_grad():
            out["decode_trace"] = _profile_model_step(
                lambda: eng.model_step("decode", z(B, 1), z(B, width), z(B)))
            out["prefill_trace"] = _profile_model_step(
                lambda: eng.model_step("prefill", z(1, C), z(1, width), 0))
        out["logits_copy_ms"] = _logits_copy_ms(cfg)
        for name, m in (("decode step (B=8)", out["decode"]),
                        ("prefill chunk (1x32)", out["prefill"])):
            log(f"[serve] {name} on {card}: {m['event_span_ms']:.3f} ms between CUDA events, "
                f"host wall around a drained step {m['wall_ms']:.3f} ms, host enqueue "
                f"{m['enqueue_ms']:.3f} ms (medians of {m['n']})")
        for name, key in (("decode step (B=8)", "decode"), ("prefill chunk (1x32)", "prefill")):
            tr, m = out[f"{key}_trace"], out[key]
            log(f"[serve] {name} traced (torch.profiler, 5 calls): {tr['launches']:.0f} "
                f"launches a call, the device busy {tr['busy_ms']:.3f} ms of the "
                f"{m['wall_ms']:.3f} ms drained wall (idle share "
                f"{1 - tr['busy_ms'] / m['wall_ms']:.3f}); busy ms by class {tr['by_class_ms']}")
        log(f"[serve] the decode step's copy of the ({SERVE_ENGINE['max_batch']}, "
            f"{cfg.vocab_size}) bf16 logits to the host: {out['logits_copy_ms']:.3f} ms "
            f"(median of {TIMING_ITERS})")

        # the smoke load twice: as set (above the engine's admission
        # capacity: p50/p99 mostly measure queue position) and at
        # SERVE_BELOW of that capacity (p50/p99 measure serving)
        cap = bench_serve.capacity_gap(eng, prompt_range=SERVE_BENCH["prompt_range"],
                                       new_tokens=SERVE_BENCH["new_tokens"])
        out["capacity_gap_steps"] = cap
        for key, gap in (("bench", SERVE_BENCH["mean_gap_steps"]),
                         ("bench_below", cap / SERVE_BELOW)):
            records = bench_serve.run(eng, **dict(SERVE_BENCH, mean_gap_steps=gap))
            out[key] = {name: value for name, value, _, _ in records}
            log(f"[serve] launch.bench_serve on {card}, offered {cap / gap:.3f} of the "
                f"admission capacity (one request per {cap:.3f} steps): {records[0][3]}: "
                f"{out[key]['serve_tokens_per_s']:.1f} tokens/s, p50 "
                f"{out[key]['serve_p50_ms']:.1f} ms, p99 {out[key]['serve_p99_ms']:.1f} ms")

        steps = eng.stats["decode_steps"] - base["decode_steps"]
        calls = cc.counts.get(DecodeSync.NAME, 0)
        launched = _counts()
        log(f"[serve] bookkeeping: {calls} {DecodeSync.NAME} calls for {steps} decode steps; "
            f"{eng.alloc.live_blocks} KV blocks live; kernel launches {launched}")
        if calls != steps or steps == 0 or "bcast" in cc.counts:
            raise AssertionError(f"[serve] {calls} decode-tp calls for {steps} decode steps "
                                 f"({dict(cc.counts)})")
        if eng.alloc.live_blocks != 0:
            raise AssertionError(f"[serve] {eng.alloc.live_blocks} KV blocks still live")
        if any(launched.values()):
            raise AssertionError(f"[serve] serving launched kernels: {launched}")
    del eng, model
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = _serve_card_vs_cpu()
    log("[serve] record " + json.dumps(out))
    return out


def _serve_card_vs_cpu() -> dict:
    """The same CPU-drawn weights (full width, 2 layers, float32) behind an
    engine on the CPU and one on the card, serving the same two greedy
    requests: every prefill chunk's logits and every decode step's logits
    of the live rows within 1e-3, the same greedy tokens, in the order the
    engine ran them, up to the first token whose CPU top-2 margin is below
    ``MARGIN`` (logged; the comparison stops there)."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(configs.get_config(ARCH), num_layers=SERVE_CPU_DEPTH,
                              param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg)
    cpu_model = api.init(0, device="cpu")
    models = {"cpu": cpu_model, "card": copy.deepcopy(cpu_model).to("cuda")}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n, _ in SERVE_CPU_REQS]
    runs = {}
    for where, model in models.items():
        eng = ServeEngine(api, model, seed=0, **SERVE_ENGINE)
        events = []

        def record(kind, fn, *args, _ev=events):
            # args[2]: a prefill chunk's start, a decode step's lengths
            lg = fn(*args)
            arg = args[2] if kind == "prefill" else args[2].cpu()
            _ev.append((kind, arg, lg.float().cpu()))
            return lg

        eng.step_hook = record
        reqs = [Request(i, p, max_new_tokens=n) for i, (p, (_, n)) in
                enumerate(zip(prompts, SERVE_CPU_REQS))]
        t0 = time.perf_counter()
        eng.run(reqs)
        runs[where] = (events, reqs, time.perf_counter() - t0)
    ev_cpu, reqs_cpu, cpu_s = runs["cpu"]
    ev_card, reqs_card, card_s = runs["card"]
    if [e[:1] for e in ev_cpu] != [e[:1] for e in ev_card]:
        raise AssertionError("[serve] card vs CPU: the engines ran different step sequences")

    def margin(row) -> float:
        top = torch.topk(row, 2).values
        return float(top[0] - top[1])

    C = SERVE_ENGINE["prefill_chunk"]
    worst, compared, stop, first_chunk = 0.0, 0, None, None
    owner = -1                                   # the request a prefill chunk belongs to
    for n, ((kind, arg, lc), (_, _, lg)) in enumerate(zip(ev_cpu, ev_card)):
        if kind == "prefill":
            owner += arg == 0
            diff = _max_err(lg, lc)
            first_chunk = diff if first_chunk is None else first_chunk
            plen = len(prompts[owner])
            last = (plen - 1) - arg if arg <= plen - 1 < arg + C else None
            picks = [] if last is None else [(lc[0, last], lg[0, last])]
        else:
            rows = [int(i) for i in torch.nonzero(arg > 0).flatten()]
            diff = max(_max_err(lg[i], lc[i]) for i in rows)
            picks = [(lc[i], lg[i]) for i in rows]
        worst = max(worst, diff)
        compared += 1
        if diff > F32_LOGIT_TOL:
            raise AssertionError(f"[serve] card vs CPU: step {n} ({kind}) logits differ by "
                                 f"{diff:.3e} (bound {F32_LOGIT_TOL})")
        small = [margin(c) for c, _ in picks if margin(c) < MARGIN]
        if small:
            stop = (n, kind, min(small))
            break
        if any(int(torch.argmax(c)) != int(torch.argmax(g)) for c, g in picks):
            raise AssertionError(f"[serve] card vs CPU: step {n} ({kind}) greedy tokens differ")
    if stop is None and [r.out_tokens for r in reqs_card] != [r.out_tokens for r in reqs_cpu]:
        raise AssertionError("[serve] card vs CPU: the token streams differ")
    scale = max(float(e[2].abs().max()) for e in ev_cpu)
    log(f"[serve] card vs CPU: {ARCH} full width, {SERVE_CPU_DEPTH} layers, f32, requests "
        f"{list(SERVE_CPU_REQS)} (prompt, new tokens): {compared} of {len(ev_cpu)} model steps "
        f"compared, first prefill chunk's logits max abs diff {first_chunk:.3e}, worst "
        f"{worst:.3e} (bound {F32_LOGIT_TOL}; logits' max abs {scale:.3f}); greedy tokens equal "
        + ("throughout" if stop is None else
           f"until step {stop[0]} ({stop[1]}), where a CPU top-2 margin of {stop[2]:.2e} "
           f"is below {MARGIN} and the comparison stops")
        + f"; CPU {cpu_s:.1f} s, card {card_s:.1f} s")
    return {"worst": worst, "first_chunk": first_chunk, "compared": compared,
            "stopped_at": None if stop is None else stop[0]}


# ---------------------------------------------------------------------------
# [fault]: the fault and transport tiers with the checkpointer
# ---------------------------------------------------------------------------
#: [fault]'s depth: 2 of qwen2-0.5b's 24 layers since PR 27 (the script's
#: time limit), full width
FAULT_DEPTH = 2
FAULT_ARGS = COMMON + ["--zero1-buckets", "2", "--num-layers", str(FAULT_DEPTH)]
#: ABI collective calls one ZeRO-1 step makes at dp=1 and two buckets (the
#: fault schedule's count): the two reduce-scatter members, the grad-norm
#: all-reduce, the two all-gather members, the loss all-reduce; `minimal`'s
#: all-reduce recipe is the identity at width 1 (no call)
FAULT_CALLS = {"faulty:paxi": 6, "faulty:minimal": 4, "faulty:ompix": 6}
FAULT_TIMEOUT_S = 0.2
FAULT_DELAY_S = 0.5
#: the watchdog flags a straggler from its ninth observed step on
FAULT_STEPS = 10
FAULT_SERVE = dict(requests=4, prompt=64, new_tokens=16)
FAULT_PROBE_CALLS = 1000
FAULT_DEVICE = "cuda"


class _FaultTrainer:
    """The launcher's ZeRO-1 world (``launch.train``'s config, schedule,
    optimizer, seed and batch stream) built from the port's API, for the
    scenarios the launcher has no flag for: a wait deadline, a watchdog."""

    def __init__(self, impl: str, *, integrity: bool = False):
        import dataclasses

        from repro_torch import configs
        from repro_torch.core.backends.faulty import fault_schedule_of
        from repro_torch.data.pipeline import DataPipeline, SyntheticSource
        from repro_torch.models import build_model
        from repro_torch.optim.adamw import AdamWConfig, warmup_cosine
        from repro_torch.runtime.dist import make_dist
        from repro_torch.train import train_loop

        cfg = configs.get_config(ARCH)
        cfg = dataclasses.replace(cfg, num_layers=FAULT_DEPTH, parallelism=dataclasses.replace(
            cfg.parallelism, zero1_buckets=2))
        api = build_model(cfg)
        self.tl = train_loop
        self.dist = make_dist(impl=impl, device=FAULT_DEVICE, integrity=integrity)
        self.sched = fault_schedule_of(self.dist.abi.backend)
        self.state = train_loop.init_state(api, 0, self.dist)
        # the launcher's schedule: warmup 20 steps, so these runs never reach
        # the part that depends on the run's length
        self.step_fn = train_loop.make_train_step(
            api, self.dist, AdamWConfig(lr=3e-4),
            schedule=lambda s: warmup_cosine(s, warmup=20, total=FAULT_STEPS))
        self.pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), global_batch=8,
                                 seq_len=128)
        self.drawn: list = []
        self.grad_norms: dict = {}

    def batch(self, i: int) -> dict:
        while len(self.drawn) <= i:
            self.drawn.append(next(self.pipe))
        return self.tl.local_batch(self.drawn[i], self.dist)

    def step(self, state, batch):
        state, metrics = self.step_fn(state, batch)
        self.grad_norms[int(state.step)] = float(metrics.grad_norm)
        return state, metrics

    def close(self):
        self.pipe.close()
        self.dist.shutdown()


def _fault_check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"[fault] {what}")


def _flip_byte(path: Path) -> None:
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x40
    path.write_bytes(bytes(blob))


def phase_fault(card: str) -> dict:
    """[fault]: full-width qwen2-0.5b at ``FAULT_DEPTH`` layers (bf16, seed
    0), batch 8, sequence 128, two buckets, one card, through the port's fault and transport tiers:

    * resume: ``launch.train --ckpt-dir D --ckpt-every 2 --steps 4``, then
      ``--steps 6`` on D resumes from step 4; its steps 5-6 and final
      parameters (SHA-256) equal an uninterrupted 6-step run's, bitwise;
      the checkpoint's bytes, the save's and the restore's ms by phase;
    * torn checkpoint: one byte of the newest shard flipped; the restore
      falls back to step 4 (one integrity event) and the replay ends bitwise;
    * corrupt → retry: ``faulty:paxi``, ``faulty:minimal`` and ``faulty:ompix``
      with integrity on, step 3's reduce-scatter corrupted once on rank 0:
      one retry, losses, grad norms and parameters equal to the disarmed run
      with integrity on; the wire kernels' launches; ms/step with integrity
      off and on (a record);
    * drop → timeout: a dropped reduce-scatter's group wait raises
      ``PAX_ERR_TIMEOUT`` after at least 0.2 s with the request active, the
      reset re-arms the group and the next step is bitwise the unfailed
      one; a sticky drop under ``RetryPolicy(max_retries=2)`` exhausts and
      propagates ``PAX_ERR_TIMEOUT`` (a record);
    * delay → restart: a ``delay`` schedule on step 9 flags a straggler,
      the watchdog answers ``restart``, the supervisor saves, restores and
      ends bitwise equal to the unfailed 10-step run;
    * serving: a ``ServeSupervisor`` (integrity on, a 5 s wait deadline)
      over the [serve] engine gives the engine's own greedy tokens; the µs
      of its two additions per step, the ``comm_agree`` probe and
      ``verify_clean``.

    Returns the numbers it logs."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.errors import PAX_ERR_TIMEOUT, PaxError, error_string
    from repro_torch.launch import train
    from repro_torch.launch.train import params_sha256
    from repro_torch.runtime.fault import RetryPolicy, StepWatchdog, run_supervised

    out = {}
    root = HERE / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="fault-", dir=root))
    try:
        # -- resume, bitwise ----------------------------------------------------
        ck = tmp / "ckpt"
        ck_args = ["--ckpt-dir", str(ck), "--ckpt-every", "2", "--ckpt-keep", "2", "--digest"]
        first = train.main(FAULT_ARGS + ["--steps", "4"] + ck_args)
        torch.cuda.empty_cache()
        resumed = train.main(FAULT_ARGS + ["--steps", "6"] + ck_args)
        torch.cuda.empty_cache()
        whole = train.main(FAULT_ARGS + ["--steps", "6", "--digest"])
        torch.cuda.empty_cache()
        same = ((resumed.losses, resumed.grad_norms, resumed.params_sha256)
                == (whole.losses[4:], whole.grad_norms[4:], whole.params_sha256))
        log(f"[fault] resume: run 1 steps 1-4 losses {first.losses}; run 2 resumed from step "
            f"{resumed.resumed_from}: steps 5-6 losses {resumed.losses} grad norms "
            f"{resumed.grad_norms}; uninterrupted {whole.losses[4:]} {whole.grad_norms[4:]}; "
            f"parameters sha256 {resumed.params_sha256[:16]} vs {whole.params_sha256[:16]}: "
            f"{'bitwise equal' if same else 'DIFFER'} on {card}")
        _fault_check(resumed.resumed_from == 4 and same, "resume differs from the "
                     "uninterrupted run")
        s, r = resumed.ckpt_save, resumed.ckpt_restore
        out["ckpt"] = {"bytes": s["bytes"], "save": s, "restore": r}
        log(f"[fault] checkpoint (f32 wire, bf16 parameters): {s['bytes']} bytes "
            f"({s['bytes'] / 1e9:.2f} GB); save of step {s['step']}: host copy "
            f"{s['host_copy_ms']:.0f} ms, write {s['write_ms']:.0f} ms, CRC32 {s['crc_ms']:.0f} "
            f"ms; restore of step {r['step']}: CRC32 {r['crc_ms']:.0f} ms, load "
            f"{r['load_ms']:.0f} ms, copy to the card {r['copy_ms']:.0f} ms on {card}")

        # -- a torn checkpoint falls back --------------------------------------
        _flip_byte(ck / "step_0000000006" / "shard_0.npz")
        torn = train.main(FAULT_ARGS + ["--steps", "6"] + ck_args)
        torch.cuda.empty_cache()
        same = ((torn.losses, torn.grad_norms, torn.params_sha256)
                == (whole.losses[4:], whole.grad_norms[4:], whole.params_sha256))
        log(f"[fault] torn: one byte of step 6's shard flipped; integrity events "
            f"{torn.checkpoint_fallbacks}; resumed from step {torn.resumed_from}, steps 5-6 "
            f"losses {torn.losses}: {'bitwise equal' if same else 'DIFFER'} on {card}")
        _fault_check(len(torn.checkpoint_fallbacks) == 1 and torn.resumed_from == 4
                     and torn.checkpoint_fallbacks[0]["fell_back_to"] == 4 and same,
                     "the torn checkpoint did not fall back to step 4 bitwise")

        # -- corrupt -> retry, on three backends -----------------------------
        runs = {}
        for impl, calls in FAULT_CALLS.items():
            args = FAULT_ARGS + ["--steps", "4", "--impl", impl, "--retries", "2", "--digest"]
            got = {}
            os.environ["PAX_WIRE_INTEGRITY"] = "1"
            for armed in (True, False):
                os.environ["PAX_FAULT_SCHEDULE"] = (
                    f"rank=0,at={2 * calls},mode=corrupt" if armed else "")
                _zero_counts()
                rep = train.main(args)
                got[armed] = (rep, dict(_counts()))
                torch.cuda.empty_cache()
            os.environ.pop("PAX_FAULT_SCHEDULE", None)
            os.environ.pop("PAX_WIRE_INTEGRITY", None)
            (f, cf), (c, cc) = got[True], got[False]
            same = ((f.losses, f.grad_norms, f.params_sha256)
                    == (c.losses, c.grad_norms, c.params_sha256))
            log(f"[fault] {impl} integrity on, step 3's reduce-scatter corrupted on rank 0 "
                f"(at={2 * calls}): transport retries {f.transport_retries}, losses "
                f"{f.losses}, grad norms {f.grad_norms} vs disarmed {c.losses} "
                f"{c.grad_norms}: {'bitwise equal' if same else 'DIFFER'}; launches armed "
                f"pack {cf['pack_transposed']} unpack {cf['unpack_transposed']}, disarmed "
                f"pack {cc['pack_transposed']} unpack {cc['unpack_transposed']} on {card}")
            _fault_check(f.transport_retries == 1 and c.transport_retries == 0 and same,
                         f"{impl}: the corrupted step was not retried bitwise")
            _fault_check((cc["pack_transposed"], cc["unpack_transposed"]) == (4, 4)
                         and (cf["pack_transposed"], cf["unpack_transposed"]) == (5, 5),
                         f"{impl}: wire kernel launches {cf} {cc}")
            _fault_check(c.losses == whole.losses[:4], f"{impl}: integrity on changed the "
                         "losses")
            runs[impl] = c
        os.environ["PAX_FAULT_SCHEDULE"] = ""
        off = train.main(FAULT_ARGS + ["--steps", "4", "--impl", "faulty:paxi"])
        os.environ.pop("PAX_FAULT_SCHEDULE", None)
        torch.cuda.empty_cache()
        on_ms = statistics.median(runs["faulty:paxi"].step_ms[1:])
        off_ms = statistics.median(off.step_ms[1:])
        out["integrity_ms"] = {"off": off_ms, "on": on_ms}
        log(f"[fault] faulty:paxi ms/step (steps 2-4, median): integrity off {off_ms:.1f} "
            f"({', '.join(f'{t:.1f}' for t in off.step_ms[1:])}), on {on_ms:.1f} "
            f"({', '.join(f'{t:.1f}' for t in runs['faulty:paxi'].step_ms[1:])}), "
            f"ratio {on_ms / off_ms:.3f} on {card}")

        # -- the unfailed 10-step oracle (integrity off) -----------------------
        t = _FaultTrainer("faulty:paxi")
        try:
            rep = run_supervised(t.step, t.state, t.batch, total_steps=FAULT_STEPS,
                                 max_restarts=0)
            oracle = (rep.losses, [t.grad_norms[i] for i in range(1, FAULT_STEPS + 1)],
                      params_sha256(rep.final_state.params))
        finally:
            t.close()
        torch.cuda.empty_cache()
        _fault_check(oracle[0][:6] == whole.losses and oracle[1][:6] == whole.grad_norms,
                     "the API-built world differs from the launcher's")

        # -- drop -> timeout -> reset; a sticky drop exhausts its retries ------
        t = _FaultTrainer("faulty:paxi")
        try:
            state, m1 = t.step(t.state, t.batch(0))
            t.dist.wait_timeout_s = FAULT_TIMEOUT_S
            t.sched.arm(0, after=0, mode="drop")
            t0 = time.perf_counter()
            try:
                t.step(state, t.batch(1))
                raise AssertionError("[fault] the dropped reduce-scatter did not time out")
            except PaxError as e:
                waited = time.perf_counter() - t0
                code = e.code
            active = not t.dist.zero1_plans.rs_group.request.done
            t.tl.plan_resetter(t.dist)()
            t.sched.kill_rank, t.sched.dropping = -1, False   # the link heals
            state, m2 = t.step(state, t.batch(1))
            clean = [float(m1.loss), float(m2.loss)] == oracle[0][:2]
            log(f"[fault] drop: the zero1-rs group wait raised {error_string(code)} "
                f"after {waited:.3f} s (deadline {FAULT_TIMEOUT_S} s), request active "
                f"{active}; after reset() the next step's loss {float(m2.loss)!r} "
                f"{'bitwise equal to' if clean else 'DIFFERS from'} the unfailed "
                f"{oracle[0][1]!r} on {card}")
            _fault_check(code == PAX_ERR_TIMEOUT and waited >= FAULT_TIMEOUT_S and active
                         and clean, "drop/timeout/reset")
            t.sched.arm(0, after=0, mode="drop")
            pol = RetryPolicy(max_retries=2, reset=t.tl.plan_resetter(t.dist))
            t0 = time.perf_counter()
            try:
                pol.run(lambda: t.step(state, t.batch(2)), what="sticky drop")
                raise AssertionError("[fault] a sticky drop completed")
            except PaxError as e:
                log(f"[fault] sticky drop under RetryPolicy(max_retries=2): "
                    f"{error_string(e.code)} propagated after {pol.retries} retries and {pol.escalations} "
                    f"escalation in {time.perf_counter() - t0:.3f} s (the reference's "
                    f"contract with no survivor to escalate to; a record) on {card}")
                _fault_check(e.code == PAX_ERR_TIMEOUT and pol.retries == 2, "sticky drop")
            t.tl.plan_resetter(t.dist)()
            t.sched.kill_rank, t.sched.dropping = -1, False
        finally:
            t.close()
        torch.cuda.empty_cache()

        # -- delay -> straggler -> restart, bitwise ----------------------------
        t = _FaultTrainer("faulty:paxi")
        try:
            wd = StepWatchdog(on_straggler=lambda s, dt: "restart")
            ck2 = Checkpointer(tmp / "ckpt-delay", keep=2, dist=t.dist)

            def batch(i, _t=t):
                if i == FAULT_STEPS - 2 and _t.sched.kill_rank < 0:
                    _t.sched.delay_s = FAULT_DELAY_S
                    _t.sched.arm(0, after=0, mode="delay")
                return _t.batch(i)

            rep = run_supervised(t.step, t.state, batch, checkpointer=ck2,
                                 total_steps=FAULT_STEPS, checkpoint_every=10 ** 6,
                                 max_restarts=2, watchdog=wd, state_like=t.state)
            got = (rep.losses, [t.grad_norms[i] for i in range(1, FAULT_STEPS + 1)],
                   params_sha256(rep.final_state.params))
            log(f"[fault] delay ({FAULT_DELAY_S} s a call from step 9): stragglers "
                f"{[(s, round(d, 3)) for s, d in wd.stragglers]}, restarts {rep.restarts}; "
                f"sync save {ck2.last_save.get('write_ms', 0):.0f} ms write, restore "
                f"{ck2.last_restore.get('crc_ms', 0) + ck2.last_restore.get('load_ms', 0):.0f} "
                f"ms; losses {'bitwise equal to' if got == oracle else 'DIFFER from'} the "
                f"unfailed run's on {card}")
            _fault_check(rep.restarts == 1 and wd.stragglers and got == oracle,
                         "the delay restart differs from the unfailed run")
        finally:
            t.sched.kill_rank = -1
            t.close()
        torch.cuda.empty_cache()
        out.update(phase_fault_serve(card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_fault_serve(card: str) -> dict:
    """[fault] serving: the [serve] engine (at ``FAULT_DEPTH`` layers) on an
    integrity-on context, its greedy tokens alone and under a
    ``ServeSupervisor(wait_timeout_s=5.0)``; µs per supervisor step above
    the engine step, and of its two additions: the ``comm_agree`` probe and
    ``verify_clean``."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.runtime.dist import make_dist
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.supervisor import ServeSupervisor

    cfg = dataclasses.replace(configs.get_config(ARCH), num_layers=FAULT_DEPTH)
    api = build_model(cfg)
    model = _init_timed(api, "fault")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, FAULT_SERVE["prompt"]).astype(np.int32)
               for _ in range(FAULT_SERVE["requests"])]

    def reqs():
        return [Request(i, p, max_new_tokens=FAULT_SERVE["new_tokens"])
                for i, p in enumerate(prompts)]

    with make_dist(device=FAULT_DEVICE, integrity=True) as dist:
        eng = ServeEngine(api, model, dist=dist, seed=0, **SERVE_ENGINE)
        alone = reqs()
        _, eng_ms = _drain_timed(eng, alone)
        sup = ServeSupervisor(eng, wait_timeout_s=5.0)
        supervised = reqs()
        for r in supervised:
            eng.submit(r)
        sup_ms = []
        while eng.has_work:
            t0 = time.perf_counter()
            sup.step()
            sup_ms.append((time.perf_counter() - t0) * 1e3)
        same = [r.out_tokens for r in supervised] == [r.out_tokens for r in alone]
        ds = eng.decode_sync
        tok = np.zeros(SERVE_ENGINE["max_batch"], np.int32)
        t0 = time.perf_counter()
        for _ in range(FAULT_PROBE_CALLS):
            ds.abi.comm_agree(1, ds.comm)
        agree_us = (time.perf_counter() - t0) / FAULT_PROBE_CALLS * 1e6
        t0 = time.perf_counter()
        for _ in range(FAULT_PROBE_CALLS):
            ds.abi.verify_clean((tok, tok), "probe")
        verify_us = (time.perf_counter() - t0) / FAULT_PROBE_CALLS * 1e6
        rep = sup.report
        log(f"[fault] serving, integrity on, wait deadline 5.0 s: {len(alone)} greedy "
            f"requests ({FAULT_SERVE['prompt']}-token prompts, {FAULT_SERVE['new_tokens']} "
            f"new tokens) under the supervisor {'equal' if same else 'DIFFER from'} the "
            f"engine's own tokens; failures {rep.failures}, transport retries "
            f"{rep.transport_retries}; median ms per step: engine {statistics.median(eng_ms):.3f}, "
            f"supervisor {statistics.median(sup_ms):.3f}; comm_agree probe {agree_us:.2f} us, "
            f"verify_clean {verify_us:.2f} us per call (mean of {FAULT_PROBE_CALLS}) on {card}")
        _fault_check(same and rep.failures == 0 and rep.transport_retries == 0,
                     "the supervised engine's tokens differ")
        rep.assert_consistent()
    del model
    torch.cuda.empty_cache()
    return {"serve_step_ms": {"engine": statistics.median(eng_ms),
                              "supervisor": statistics.median(sup_ms)},
            "agree_us": agree_us, "verify_us": verify_us}


FAULT4 = 4
FAULT4_TOTAL, FAULT4_EVERY, FAULT4_KILL_AT, FAULT4_KILL_RANK = 4, 2, 2, 3


def _fault4_rank(rank: int, world: int, init_method: str, out_dir: str,
                 device: str = "cuda") -> None:
    """One rank of [fault4]: ZeRO-1 at dp=4 on ``faulty:paxi``, rank 3
    declared dead before step 3; the survivors resume at dp=2 and an oracle
    over the same two cards restores the same checkpoint.  ``device="cpu"``
    rehearses it on gloo at the smoke size."""
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.backends.faulty import fault_schedule_of
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.launch.train import params_sha256
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, warmup_cosine
    from repro_torch.runtime.dist import make_dist
    from repro_torch.runtime.fault import run_supervised
    from repro_torch.train import train_loop as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device != "cpu"
    if not on_card:
        torch.set_num_threads(1)
    cfg = configs.get_config(ARCH) if on_card else configs.smoke_config(ARCH)
    cfg = dataclasses.replace(cfg, parallelism=dataclasses.replace(
        cfg.parallelism, zero1_buckets=2))
    api = build_model(cfg)
    opt = AdamWConfig(lr=3e-4)
    sched_fn = lambda s: warmup_cosine(s, warmup=20, total=FAULT4_TOTAL)  # noqa: E731
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), global_batch=32, seq_len=128)
    drawn = [next(pipe) for _ in range(FAULT4_TOTAL)]
    pipe.close()
    ckdir = Path(out_dir) / "ckpt"
    rec = {}
    with make_dist(device=f"cuda:{rank}" if on_card else "cpu", world_size=world, rank=rank,
                   init_method=init_method, impl="faulty:paxi") as dist:
        sched = fault_schedule_of(dist.abi.backend)
        state = tl.init_state(api, 0, dist)
        step = tl.global_batch_step(dist, tl.make_train_step(api, dist, opt, schedule=sched_fn))
        policy = tl.elastic_recovery_policy(api, opt, dist, 0, impl="paxi", schedule=sched_fn)

        def batch(i):
            if i == FAULT4_KILL_AT and sched.kill_rank < 0:
                sched.kill_rank, sched.dead = FAULT4_KILL_RANK, True
            return drawn[i]

        t0 = time.perf_counter()
        rep = run_supervised(step, state, batch, checkpointer=Checkpointer(ckdir, keep=2,
                                                                          dist=dist),
                             total_steps=FAULT4_TOTAL, checkpoint_every=FAULT4_EVERY,
                             max_restarts=2, recover=policy)
        rec.update(left=rep.left_world, restarts=rep.restarts, steps=rep.steps_completed,
                   losses=rep.losses, seconds=time.perf_counter() - t0,
                   failed=list(dist.abi.comm_get_failed(dist.dp_comm)))
        if not rep.left_world:
            new = policy.dist
            st = rep.final_state
            rec.update(dp=new.dp_size, ranks=list(new.mesh.world_ranks),
                       got=[params_sha256(st.params), _sha(st.opt.m), _sha(st.opt.v)])
            with make_dist(mesh=new.mesh, impl="paxi") as oracle:
                like = tl.init_state(api, 0, oracle)
                ost, at = Checkpointer(ckdir, dist=oracle).restore(like, step=FAULT4_EVERY)
                ostep = tl.global_batch_step(oracle, tl.make_train_step(
                    api, oracle, opt, schedule=sched_fn))
                for s in range(at, FAULT4_TOTAL):
                    ost, _ = ostep(ost, drawn[s])
                rec.update(want=[params_sha256(ost.params), _sha(ost.opt.m), _sha(ost.opt.v)],
                           oracle_from=at)
            new.shutdown()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))


def _sha(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def phase_fault4(card: str, out_dir: Path = HERE / "build" / "fault4",
                 device: str = "cuda") -> None:
    """[fault4] (four cards): dp=4 full-width qwen2-0.5b on ``faulty:paxi``
    over NCCL, rank 3 dead before step 3 of 4; revoke → ack → agree →
    shrink on every rank, the survivors' dp=2 world (its groups created by
    them alone) resumes from the step-2 checkpoint, bitwise equal to a dp=2
    oracle restored from the same checkpoint; ranks 2 (the power-of-two
    trim) and 3 leave."""
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_fault4_rank, args=(r, FAULT4, f"tcp://localhost:{port}",
                                                   str(out_dir), device))
             for r in range(FAULT4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 600
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    try:
        if codes != [0] * FAULT4:
            raise RuntimeError(f"[fault4] rank exit codes {codes}")
        recs = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(FAULT4)]
        for r, rec in enumerate(recs):
            log(f"[fault4] rank {r}: left {rec['left']}, restarts {rec['restarts']}, steps "
                f"{rec['steps']}, losses {rec['losses']}, failed {rec['failed']}, "
                f"{rec['seconds']:.1f} s"
                + (f", dp {rec['dp']} over ranks {rec['ranks']}, oracle from step "
                   f"{rec['oracle_from']}: params/m/v sha256 "
                   f"{'bitwise equal' if rec['got'] == rec['want'] else 'DIFFER'}"
                   if not rec["left"] else "") + f" on {card}")
        for r in (0, 1):
            rec = recs[r]
            if rec["left"] or rec["dp"] != 2 or rec["got"] != rec["want"] \
                    or rec["restarts"] != 1 or rec["steps"] != FAULT4_TOTAL:
                raise AssertionError(f"[fault4] survivor {r} did not resume bitwise: {rec}")
        for r in (2, 3):
            if not recs[r]["left"] or recs[r]["failed"] != [FAULT4_KILL_RANK]:
                raise AssertionError(f"[fault4] rank {r} did not leave: {recs[r]}")
    finally:
        shutil.rmtree(out_dir / "ckpt", ignore_errors=True)


RING4 = 4
RING4_ARGS = ["--arch", ARCH, "--global-batch", "32", "--seq-len", "128", "--log-every", "1",
              "--steps", "2", "--zero1-buckets", "1"]
INT8_BOUND = 0.05         # the battery's section 6 bound for the int8 wire


def _ring4_rank(rank: int, world: int, init_method: str, device: str, argv: list,
                out_dir: str) -> None:
    """One rank of [ring4]: ``launch.train`` on its own card (or the CPU)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import train

    _zero_counts()
    dev = "cpu" if device == "cpu" else f"cuda:{rank}"
    rep = train.main(argv + ["--device", dev, "--world-size", str(world), "--rank", str(rank),
                             "--init-method", init_method])
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(dict(
        losses=rep.losses, grad_norms=rep.grad_norms, step_ms=rep.step_ms,
        wire=rep.wire_impl, backend=rep.dist_backend, counts=_counts())))


def run_world(argv: list, world: int, device: str, out_dir: Path, timeout: float = 300) -> list:
    """``launch.train`` as ``world`` spawned ranks meeting at a free local
    TCP port; returns each rank's record.  Every rank is joined or killed."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_ring4_rank, args=(r, world, f"tcp://localhost:{port}",
                                                   device, argv, str(out_dir)))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    for proc in procs:
        proc.join(max(deadline - time.monotonic(), 1))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    codes = [proc.exitcode for proc in procs]
    if codes != [0] * world:
        raise RuntimeError(f"[ring4] rank exit codes {codes}")
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]


def phase_ring4(device: str = "cuda", argv=RING4_ARGS, out_dir: Path = HERE / "build") -> dict:
    """The ZeRO-1 int8 leg on a ring of four ranks; returns rank 0's launch
    counts.  On the CPU (gloo, the plain kernel versions) it counts none."""
    f32 = run_world(argv, RING4, device, out_dir / "ring4-f32")
    i8 = run_world(argv + ["--grad-compression", "int8"], RING4, device, out_dir / "ring4-int8")
    steps = len(f32[0]["losses"])
    for tag, ranks in (("f32", f32), ("int8", i8)):
        log(f"[ring4] {tag}: losses {ranks[0]['losses']} grad norms {ranks[0]['grad_norms']} "
            f"ms/step (rank 0) {[round(t, 1) for t in ranks[0]['step_ms']]} "
            f"wire={ranks[0]['wire']} on {ranks[0]['backend']}")
        if any((r["losses"], r["grad_norms"]) != (ranks[0]["losses"], ranks[0]["grad_norms"])
               for r in ranks):
            raise AssertionError(f"[ring4] {tag}: the ranks disagree")
    want_backend = "gloo" if device == "cpu" else "nccl"
    if (i8[0]["wire"], i8[0]["backend"]) != ("ring-int8", want_backend):
        raise AssertionError(f"[ring4] int8 wire on {i8[0]['wire']}/{i8[0]['backend']}")
    if i8[0]["losses"][0] != f32[0]["losses"][0]:
        raise AssertionError("[ring4] the int8 run's step-1 loss differs from the f32 run's")
    rel = [abs(a - b) / abs(b) for a, b in zip(i8[0]["grad_norms"], f32[0]["grad_norms"])]
    log(f"[ring4] step-1 loss bitwise equal; int8 grad norms within {max(rel):.2e} relative "
        f"of f32 (bound {INT8_BOUND}); step-2 loss {i8[0]['losses'][1]!r} vs "
        f"{f32[0]['losses'][1]!r}")
    if max(rel) >= INT8_BOUND or not all(math.isfinite(v) for v in i8[0]["losses"]):
        raise AssertionError(f"[ring4] int8 grad norms off by {rel}")
    on_card = device != "cpu"
    want = {"quant_i8": steps, "hop_add_quant_i8": steps * (RING4 - 2), "hop_accum_i8": steps,
            "hop_add_quant_bf16": 0, "hop_accum_bf16": 0, "pack_transposed": steps,
            "pack_transposed_ef": 0, "unpack_transposed": 0}
    for r, rank in enumerate(i8):
        got = {k: rank["counts"][k] for k in want}
        log(f"[ring4] int8 rank {r} launches {got}")
        if got != (want if on_card else dict.fromkeys(want, 0)):
            raise AssertionError(f"[ring4] rank {r} launched {got}, expected {want}")
    return i8[0]["counts"]


#: [train-ssm], [train-hybrid]: full width, reduced depth, the configs'
#: own step (ZeRO-1 on the f32 wire, microbatch 4, remat "full")
TRAIN_DEPTH = {SSM_ARCH: 2, HYBRID_ARCH: 12}
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_WARM, TRAIN_TIMED = 2, 5
#: the card-vs-CPU gradient check: float32, the hybrid deep enough for one
#: firing of the shared block, a short batch (the CPU computes it too)
TRAIN_CPU_DEPTH = {SSM_ARCH: 2, HYBRID_ARCH: 6}
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 4, 128
SCAN_OF = {SSM_ARCH: "wkv6", HYBRID_ARCH: "ssd"}


def _scan_launches_per_step(cfg) -> int:
    """The scan launches of one training step, derived from the code: each
    of ``microbatch`` forwards launches one per layer, and under
    ``remat="full"`` the non-reentrant checkpoint's recompute in the
    backward runs each layer's forward again, scan included (the layer's
    last saved tensors come after its scan, so the recompute reaches it);
    the backward itself runs the plain chunked form, no kernel."""
    par = cfg.parallelism
    return cfg.num_layers * max(par.microbatch, 1) * (2 if par.remat == "full" else 1)


def _leaf_dist(g, h) -> list:
    """Per leaf, max |g - h| over the largest |h|."""
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(g, h)]


def _train_grads_card_vs_cpu(arch: str) -> None:
    """The step's gradient (``train_loop._microbatched_grads``, four
    microbatches under remat) of the same CPU-drawn float32 weights and
    batch three ways: on the CPU (the scans' plain versions), on the card
    through the kernels (the kernel forward, the plain chunked form's
    gradient backward), and on the card with the registry's ``cuda``
    variant set to the plain version for the comparison (the card's own
    float32 arithmetic).  The loss within 1e-3; the kernel path's grad norm
    and every leaf's gradient (relative to the leaf's largest entry) no
    farther from the CPU's than the card's plain path is, plus 1e-3.  The
    plain path's own distance is the floor because the rwkv6 gradient is
    ill-conditioned in float32: where a head's first-token WKV output
    nearly cancels, its group norm (eps 1e-6) multiplies the rounding of
    any two float32 evaluations: on this batch the card's plain path and
    the CPU's differ by 2.2% of a leaf's scale (``PERF.md`` §6)."""
    import dataclasses

    import torch
    from repro_torch import configs, kernels
    from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
    from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
    from repro_torch.models import build_model, param_leaves
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import train_loop as tl

    tag = "train-" + ("ssm" if arch == SSM_ARCH else "hybrid")
    depth = TRAIN_CPU_DEPTH[arch]
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=depth,
                              param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg)
    model = api.init(0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (TRAIN_CPU_BATCH, TRAIN_CPU_SEQ), generator=gen)
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
    names = [n for n, _ in param_leaves(model)]
    micro = cfg.parallelism.microbatch

    def grads(batch):
        params = [p for _, p in param_leaves(model)]
        loss, g = tl._microbatched_grads(lambda m, b: api.loss_fn(m, b), model, params, batch,
                                         micro)
        return float(loss), [x.detach().cpu() for x in g]

    t0 = time.perf_counter()
    loss_c, g_c = grads(batch)
    cpu_s = time.perf_counter() - t0
    model = model.to("cuda")
    on_card = {k: v.cuda() for k, v in batch.items()}
    _zero_counts()
    loss_k, g_k = grads(on_card)
    torch_sync()
    launched = _counts()[SCAN_OF[arch]]
    name = "rwkv6_scan" if arch == SSM_ARCH else "mamba2_ssd"
    kernel = kernels.get(name, "cuda")
    kernels.register(name, "cuda", wkv_ref.wkv6 if arch == SSM_ARCH else ssd_ref.ssd)
    try:
        loss_p, g_p = grads(on_card)
    finally:
        kernels.register(name, "cuda", kernel)
    n_c, n_k, n_p = (float(global_norm(g)) for g in (g_c, g_k, g_p))
    e_k, e_p, e_kp = _leaf_dist(g_k, g_c), _leaf_dist(g_p, g_c), _leaf_dist(g_k, g_p)
    over = [(names[i], e_k[i], e_p[i]) for i in range(len(names)) if e_k[i] > e_p[i] + 1e-3]
    top = lambda e: max(zip(e, names))  # noqa: E731
    log(f"[{tag}] card vs CPU, {arch} full width, {depth} layers, f32, batch "
        f"{TRAIN_CPU_BATCH}x{TRAIN_CPU_SEQ}, {micro} microbatches, remat "
        f"{cfg.parallelism.remat}: loss kernel {loss_k:.6f}, card plain {loss_p:.6f}, CPU "
        f"{loss_c:.6f}; grad norm {n_k:.6f}, {n_p:.6f}, {n_c:.6f}; worst leaf (of its largest "
        f"entry) kernel vs CPU {top(e_k)[1]} {top(e_k)[0]:.3e}, card plain vs CPU "
        f"{top(e_p)[1]} {top(e_p)[0]:.3e}, kernel vs card plain {top(e_kp)[1]} "
        f"{top(e_kp)[0]:.3e}; {launched} {SCAN_OF[arch]} launches on the card; CPU "
        f"{cpu_s:.1f} s")
    want = _scan_launches_per_step(cfg)
    if (abs(loss_k - loss_c) > 1e-3 or abs(n_k - n_c) > abs(n_p - n_c) + 1e-3 * n_c or over
            or launched != want):
        raise AssertionError(f"[{tag}] the kernel path's gradients are farther from the CPU's "
                             f"than the card's plain path plus 1e-3: loss {loss_k} vs {loss_c}, "
                             f"norm {n_k} ({n_p}) vs {n_c}, leaves {over[:4]}; or {launched} "
                             f"launches, expected {want}")
    del model, g_c, g_k, g_p
    torch.cuda.empty_cache()


def phase_train_recurrent(card: str, arch: str) -> int:
    """[train-ssm] / [train-hybrid]: the config's own training step at full
    width and reduced depth (``TRAIN_DEPTH``), bf16 weights from seed 0,
    ZeRO-1 on the f32 wire, global batch 8 of 1024 tokens in 4
    microbatches, remat "full": 2 + 5 steps, each with the counts zeroed
    just before it and read just after — the scan kernel launches
    ``_scan_launches_per_step`` times a step, flash never — finite losses
    and grad norms, ms/step of the 5 (host clock around a synced step) and
    the peak memory; then the card-vs-CPU gradient check
    (:func:`_train_grads_card_vs_cpu`).  Returns the
    scan's launches over the 7 steps."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop as tl

    t_phase = time.perf_counter()
    tag = "train-" + ("ssm" if arch == SSM_ARCH else "hybrid")
    scan = SCAN_OF[arch]
    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, num_layers=TRAIN_DEPTH[arch])
    par = cfg.parallelism
    if (par.remat, par.microbatch, par.zero1, par.grad_compression,
            cfg.attention_impl) != ("full", 4, True, None, "xla"):
        raise AssertionError(f"[{tag}] the config's step changed: {par}, {cfg.attention_impl}")
    api = build_model(cfg)
    per_step = _scan_launches_per_step(cfg)
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), global_batch=TRAIN_BATCH,
                        seq_len=TRAIN_SEQ)
    drawn = [next(pipe) for _ in range(TRAIN_WARM + TRAIN_TIMED)]
    pipe.close()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms, total = [], [], [], 0
    with make_dist(device="cuda") as dist:
        t0 = time.perf_counter()
        state = tl.init_state(api, 0, dist)
        torch_sync()
        n = sum(p.numel() for p in state.params.parameters())
        log(f"[{tag}] {arch} full width, {cfg.num_layers} of {full.num_layers} layers: {n} "
            f"parameters (bf16) drawn on the CPU (seed 0) in "
            f"{time.perf_counter() - t0:.1f} s; the step launches {scan} {per_step} times "
            f"({cfg.num_layers} layers x {par.microbatch} microbatches x 2: the forward and "
            "remat's recompute)")
        step = tl.make_train_step(api, dist, AdamWConfig())
        for i, b in enumerate(drawn):
            batch = tl.local_batch(b, dist)
            torch_sync()
            _zero_counts()
            t = time.perf_counter()
            state, met = step(state, batch)
            loss, norm = float(met.loss), float(met.grad_norm)
            torch_sync()
            ms.append((time.perf_counter() - t) * 1e3)
            c = _counts()
            losses.append(loss)
            norms.append(norm)
            total += c[scan]
            others = {k: v for k, v in c.items() if v and k not in (scan, "pack_transposed")}
            if c[scan] != per_step or others:
                raise AssertionError(f"[{tag}] step {i + 1} launched {scan} {c[scan]} times "
                                     f"(expected {per_step}) and {others}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state
    torch.cuda.empty_cache()
    free = torch.cuda.get_device_properties(0).total_memory / 1e9 - peak
    timed = ms[TRAIN_WARM:]
    log(f"[{tag}] losses {[round(v, 4) for v in losses]} grad norms "
        f"{[round(v, 4) for v in norms]}; {scan} {per_step} launches on every step")
    log(f"[{tag}] {arch} full width, {cfg.num_layers} layers, batch {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"on {card}: ms/step {[round(v, 1) for v in ms]} (median of the {TRAIN_TIMED} after "
        f"{TRAIN_WARM} warm {statistics.median(timed):.1f}); peak {peak:.2f} GB "
        f"({free:.1f} GB of the card left)")
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"[{tag}] non-finite losses {losses} or grad norms {norms}")
    _train_grads_card_vs_cpu(arch)
    log(f"[{tag}] phase wall {time.perf_counter() - t_phase:.1f} s")
    return total


#: [serve-ssm], [serve-hybrid]: full width, [forward-*]'s depth (bf16, seed 0) behind
#: the static path of ServeEngine; a smoke load, not user traffic
SERVE_R_ENGINE = dict(max_batch=8, max_seq=320)
SERVE_R_GREEDY, SERVE_R_NEW = 6, 32
SERVE_R_PROMPTS = (32, 256)          # prompt lengths, drawn inclusive
SERVE_R_CPU_REQS = ((12, 6), (7, 6))  # the card-vs-CPU pair: (prompt, new tokens)


def _serve_r_requests(cfg):
    """6 greedy and 2 sampled requests, prompts from ``default_rng(0)``."""
    import numpy as np
    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_R_PROMPTS[0], SERVE_R_PROMPTS[1] + 1, SERVE_R_GREEDY + 2)
    return [Request(i, rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=SERVE_R_NEW,
                    **(SERVE_SAMPLED if i >= SERVE_R_GREEDY else {}))
            for i, n in enumerate(lens)]


def _serve_r_card_vs_cpu(arch: str) -> None:
    """The same CPU-drawn float32 weights (full width, ``CPU_DEPTH``
    layers) behind two engines, on the CPU and on the card: equal tokens,
    and the first decode step's logits within 1e-3."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    tag = "serve-" + ("ssm" if arch == SSM_ARCH else "hybrid")
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=CPU_DEPTH[arch],
                              param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg)
    model = api.init(0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        model = model.to(dev)
        rng = np.random.default_rng(1)
        reqs = [Request(i, rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                        max_new_tokens=new) for i, (n, new) in enumerate(SERVE_R_CPU_REQS)]
        first = []

        def hook(kind, fn, *args):
            logits = fn(*args)
            if kind == "decode" and not first:
                first.append(logits.float().cpu())
            return logits

        eng = ServeEngine(api, model, seed=0, **SERVE_R_ENGINE)
        eng.step_hook = hook
        eng.run(reqs)
        out[dev] = ([r.out_tokens for r in reqs], first[0])
    diff = _max_err(out["cuda"][1], out["cpu"][1])
    same = out["cuda"][0] == out["cpu"][0]
    log(f"[{tag}] card vs CPU engines, {arch} full width, {CPU_DEPTH[arch]} layers, f32: "
        f"tokens equal {same}; first decode step's logits max abs diff {diff:.3e} (bound "
        f"{F32_LOGIT_TOL})")
    if not same or diff > F32_LOGIT_TOL:
        raise AssertionError(f"[{tag}] card and CPU engines differ: {out['cuda'][0]} vs "
                             f"{out['cpu'][0]}, logits {diff}")
    del model
    torch.cuda.empty_cache()


def phase_serve_recurrent(card: str, arch: str, model=None) -> None:
    """[serve-ssm] / [serve-hybrid]: the model at full width and [forward-*]'s depth
    (bf16, seed 0; ``model`` when a forward phase drew it already) behind
    ``ServeEngine(max_batch=8, max_seq=320)``: 6 greedy and 2 sampled
    requests (prompts 32-256, 32 new tokens) through ``run()``'s static
    path, the counts zeroed just before and read just after (serving runs
    no kernel: its decode is the one-token recurrence); every request done
    with 32 tokens; ms per prefill step (one position of the 8 sequences)
    and per decode step (stream span and host enqueue, medians), generated
    tokens/s, a ``torch.profiler`` count of one decode step's launches and
    its device busy time, and the decode state's bytes; then the card-vs-CPU
    engine pair."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    tag = "serve-" + ("ssm" if arch == SSM_ARCH else "hybrid")
    cfg = _serving_config(arch)
    api = build_model(cfg)
    if model is None:
        model = _init_timed(api, tag)
    reqs = _serve_r_requests(cfg)
    eng = ServeEngine(api, model, seed=0, **SERVE_R_ENGINE)
    timer = _StepTimer(drain=False)
    eng.step_hook = timer
    _zero_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch_sync()
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in _counts().items() if v}
    new = sum(len(r.out_tokens) for r in reqs)
    pre, dec = timer.medians("prefill"), timer.medians("decode")
    B = len(reqs)
    log(f"[{tag}] {arch} full width ({cfg.num_layers} layers) bf16 on {card}: {B} requests "
        f"(prompts {sorted(len(r.prompt) for r in reqs)}, 2 sampled), {new} tokens in "
        f"{wall:.2f} s ({new / wall:.1f} generated tok/s); stats {eng.stats}; kernels "
        f"launched {launched or 'none'}")
    log(f"[{tag}] per prefill step (one position of {B} sequences, n={pre['n']}): stream span "
        f"{pre['event_span_ms']:.2f} ms ({pre['event_span_ms'] / B:.2f} ms a token), host "
        f"enqueue {pre['enqueue_ms']:.2f} ms; per decode step (n={dec['n']}): stream span "
        f"{dec['event_span_ms']:.2f} ms, host enqueue {dec['enqueue_ms']:.2f} ms")
    if launched or any(len(r.out_tokens) != SERVE_R_NEW or not r.done for r in reqs):
        raise AssertionError(f"[{tag}] requests unfinished "
                             f"{[len(r.out_tokens) for r in reqs]} or kernels {launched}")
    state = api.decode_init(B, SERVE_R_ENGINE["max_seq"], device="cuda")
    tok = torch.zeros((B, 1), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        prof = _profile_model_step(lambda: api.decode_step(model, tok, state, 100))
    leaves = [t for f in state for t in (f if isinstance(f, tuple) else (f,))]
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"[{tag}] one decode step at B={B} under torch.profiler: {prof['launches']:.0f} "
        f"launches, device busy {prof['busy_ms']:.3f} ms, by class {prof['by_class_ms']}; "
        f"decode state {nbytes / 1e6:.1f} MB ({', '.join(str(tuple(t.shape)) for t in leaves)})")
    del model, eng, state
    torch.cuda.empty_cache()
    _serve_r_card_vs_cpu(arch)
    log(f"[{tag}] phase wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the moe family: [forward-moe], [serve-moe], [train-moe], [moe4]
# ---------------------------------------------------------------------------
MOE_ARCH = "qwen2-moe-a2.7b"
#: [train-moe]: full width, one of 24 layers (about 50 bytes a parameter:
#: 1.23B parameters, about 61 GB; two layers would need about 92 GB)
MOE_TRAIN_DEPTH = 1
#: the card-vs-CPU checks' depth (float32 on the CPU too)
MOE_CPU_DEPTH = 1
#: [serve-moe]: the [serve] engine, a smaller load (8 greedy + 2 sampled)
MOE_SERVE_GREEDY, MOE_SERVE_NEW = 8, 32
MOE_SERVE_CPU_REQS = ((40, 8), (24, 8))
#: below this top-k margin of the router's probabilities the card's and the
#: CPU's float32 routing may choose differently (a near-tie)
ROUTER_TIE = 1e-5


class _MoeSpy:
    """Within ``with``, records on the device, per ``moe_block`` call, the
    share of expert assignments the capacity dropped and each token's top-k
    margin of the router's probabilities (the gap between the k-th and the
    (k+1)-th expert); nothing syncs until :meth:`read`."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe

        self.drop, self.margin = [], []
        self._dispatch, self._route = moe._dispatch_sort, moe._route

        def dispatch(x, experts, gates, E_pad, C, offset=None):
            buf, comb = self._dispatch(x, experts, gates, E_pad, C, offset)
            self.drop.append(1.0 - comb[3].float().mean())
            return buf, comb

        def route(router, xf, m, batch_group=None):
            out = self._route(router, xf, m, batch_group)
            with torch.no_grad():
                top = torch.topk(torch.softmax(xf.float() @ router, -1), m.top_k + 1, -1).values
                self.margin.append(top[:, m.top_k - 1] - top[:, m.top_k])
            return out

        moe._dispatch_sort, moe._route = dispatch, route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._dispatch_sort, moe._route = self._dispatch, self._route

    def read(self) -> tuple:
        """(drop shares, smallest router margins), one per call, as floats."""
        out = [float(t) for t in self.drop], [float(t.min()) for t in self.margin]
        self.drop, self.margin = [], []
        return out


def phase_forward_moe(card: str) -> tuple:
    """[forward-moe]: qwen2-moe-a2.7b at full width and depth (24 layers,
    d=2048, 16/16 heads at D=128, 60 routed experts padded to 64, top-4,
    4 shared experts, bf16, seed 0), B=4, S=2048, under
    ``attention_impl="flash"``: one flash launch per layer, the last call's
    output held to ``attention_ref`` on its own activations; ms per
    forward, the host's time to enqueue one, and the share of expert
    assignments each layer's capacity (1.25) dropped.  Returns the flash
    launches of one forward and the model ([serve-moe] serves it)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models.moe import _capacity

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config(MOE_ARCH), attention_impl="flash")
    m = cfg.moe
    api = build_model(cfg)
    model = _init_timed(api, "forward-moe")
    batch = _tokens(cfg)
    T = FWD_BATCH * FWD_SEQ
    with torch.no_grad():
        with _FlashSpy() as spy, _MoeSpy() as moe_spy:
            logits, counts = _forward_check(api, model, batch, cfg, "forward-moe",
                                            {"flash_attention": cfg.num_layers})
            drops, margins = moe_spy.read()
        spy.check("forward-moe")
        del logits
        ms = [_time_ms(lambda: api.forward(model, batch), FWD_ITERS) for _ in range(2)]
        enqueue = _enqueue_ms(lambda: api.forward(model, batch))
    log(f"[forward-moe] {MOE_ARCH} full width ({cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads at D={cfg.resolved_head_dim}, "
        f"{m.num_experts} experts padded to {m.padded_experts}, top-{m.top_k}, "
        f"{m.num_shared_experts} shared), B={FWD_BATCH} S={FWD_SEQ} bf16 on {card}: "
        f"flash_attention {counts['flash_attention']} of {cfg.num_layers} layers; "
        f"{', '.join(f'{t:.2f}' for t in ms)} ms per forward (medians of {FWD_ITERS} after 3 "
        f"warm-ups), host enqueue {enqueue:.2f} ms")
    C = _capacity(T, m.top_k, m.num_experts, m.capacity_factor)
    log(f"[forward-moe] capacity {m.capacity_factor}: C = {C} at T = {T}; dropped share of the "
        f"{T * m.top_k} assignments per layer {[round(d, 5) for d in drops]} (mean "
        f"{statistics.mean(drops):.5f}); smallest router "
        f"top-{m.top_k} margin {min(margins):.3e}")
    if len(drops) != cfg.num_layers:
        raise AssertionError(f"[forward-moe] {len(drops)} local moe blocks, expected "
                             f"{cfg.num_layers}")
    log(f"[forward-moe] phase wall {time.perf_counter() - t_phase:.1f} s")
    return counts["flash_attention"], model


def _moe_serve_card_vs_cpu() -> None:
    """The same CPU-drawn float32 weights (full width, ``MOE_CPU_DEPTH``
    layers) behind the paged engine on the CPU and on the card: equal
    greedy tokens.  Where they differ, the router's smallest top-k margin
    in the step that diverged must show a near-tie (below ``ROUTER_TIE``),
    and then the first decode step's logits must agree within 1e-3."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(configs.get_config(MOE_ARCH), num_layers=MOE_CPU_DEPTH,
                              param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg)
    t0 = time.perf_counter()
    model = api.init(0, device="cpu")
    init_s = time.perf_counter() - t0
    out = {}
    for dev in ("cpu", "cuda"):
        model = model.to(dev)
        rng = np.random.default_rng(1)
        reqs = [Request(i, rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                        max_new_tokens=new) for i, (n, new) in enumerate(MOE_SERVE_CPU_REQS)]
        steps = []
        with _MoeSpy() as spy:
            def hook(kind, fn, *args):
                logits = fn(*args)
                steps.append((kind, logits.float().cpu(), min(spy.read()[1])))
                return logits

            eng = ServeEngine(api, model, seed=0, **SERVE_ENGINE)
            eng.step_hook = hook
            t0 = time.perf_counter()
            eng.run(reqs)
        out[dev] = ([r.out_tokens for r in reqs], steps, time.perf_counter() - t0)
    same = out["cuda"][0] == out["cpu"][0]
    first = [i for i, s in enumerate(out["cpu"][1]) if s[0] == "decode"][0]
    diff = _max_err(out["cuda"][1][first][1], out["cpu"][1][first][1])
    tie = min(s[2] for s in out["cpu"][1])
    log(f"[serve-moe] card vs CPU engines, {MOE_ARCH} full width, {MOE_CPU_DEPTH} layer(s), "
        f"f32, requests {list(MOE_SERVE_CPU_REQS)} (prompt, new tokens): tokens equal {same}; "
        f"first decode step's logits max abs diff {diff:.3e}; smallest router top-k margin "
        f"{tie:.3e}; init {init_s:.1f} s, CPU {out['cpu'][2]:.1f} s, card {out['cuda'][2]:.1f} s")
    if not same:
        n = next(i for i, (a, b) in enumerate(zip(out["cpu"][1], out["cuda"][1]))
                 if int(a[1].argmax()) != int(b[1].argmax()) or _max_err(a[1], b[1]) > 1e-3)
        margin = min(out["cpu"][1][n][2], out["cuda"][1][n][2])
        log(f"[serve-moe] the engines diverge at model step {n} ({out['cpu'][1][n][0]}), "
            f"where the router's smallest top-k margin is {margin:.3e} (tie below {ROUTER_TIE})")
        if margin >= ROUTER_TIE or diff > F32_LOGIT_TOL:
            raise AssertionError(f"[serve-moe] card and CPU engines differ without a router "
                                 f"near-tie: {out['cuda'][0]} vs {out['cpu'][0]}")
    elif diff > F32_LOGIT_TOL:
        raise AssertionError(f"[serve-moe] first decode logits differ by {diff}")
    del model
    torch.cuda.empty_cache()


def phase_serve_moe(card: str, model=None) -> None:
    """[serve-moe]: the [forward-moe] weights behind the paged engine set up
    as [serve]'s (8 slots, blocks of 16, chunks of 32, 640 positions) with a
    ``decode-tp`` plan group on NCCL: 8 greedy and 2 sampled requests
    (prompts 64-512, 32 new tokens) served continuously, the counts zeroed
    just before and read just after (serving launches no kernel); ms per
    decode step and per prefill chunk (stream span and host enqueue,
    medians), generated tokens/s, a ``torch.profiler`` count of one decode
    step's launches; gates: no launch, no live KV block, one ``decode-tp``
    call a decode step, every request done; then the card-vs-CPU engine
    pair (:func:`_moe_serve_card_vs_cpu`)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core import CallCounter
    from repro_torch.models import build_model
    from repro_torch.runtime.dist import make_dist
    from repro_torch.serve import DecodeSync, Request, ServeEngine

    t_phase = time.perf_counter()
    cfg = configs.get_config(MOE_ARCH)
    api = build_model(cfg)
    if model is None:
        model = _init_timed(api, "serve-moe")
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, MOE_SERVE_GREEDY + 2)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=MOE_SERVE_NEW,
                    **(SERVE_SAMPLED if i >= MOE_SERVE_GREEDY else {}))
            for i, n in enumerate(lens)]
    with make_dist(device="cuda") as dist:
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        eng = ServeEngine(api, model, dist=dist, seed=0, **SERVE_ENGINE)
        eng.run([Request(1000, np.arange(1, 41, dtype=np.int32), max_new_tokens=4)])  # warm-up
        cc.reset()
        base = dict(eng.stats)
        eng.step_hook = timer = _StepTimer(drain=False)
        _zero_counts()
        wall, step_ms = _drain_timed(eng, reqs)
        torch_sync()
        launched = {k: v for k, v in _counts().items() if v}
        eng.step_hook = None
        new = sum(len(r.out_tokens) for r in reqs)
        st = {k: eng.stats[k] - base[k] for k in ("steps", "decode_steps", "prefill_chunks")}
        dec, pre = timer.medians("decode"), timer.medians("prefill")
        calls = cc.counts.get(DecodeSync.NAME, 0)
        width = eng.scheduler.table_width
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device="cuda")  # noqa: E731
        B = SERVE_ENGINE["max_batch"]
        with torch.no_grad():
            prof = _profile_model_step(
                lambda: eng.model_step("decode", z(B, 1), z(B, width), z(B)))
        live = eng.alloc.live_blocks
    log(f"[serve-moe] {MOE_ARCH} full width ({cfg.num_layers} layers) bf16 on {card}, engine "
        f"{SERVE_ENGINE}: {len(reqs)} requests ({MOE_SERVE_GREEDY} greedy, 2 sampled; prompts "
        f"{SERVE_PROMPTS[0]}-{SERVE_PROMPTS[1]}, {MOE_SERVE_NEW} new tokens), {new} tokens in "
        f"{wall:.3f} s = {new / wall:.1f} generated tokens/s; {st['steps']} engine steps "
        f"(median {statistics.median(step_ms):.2f} ms), {st['decode_steps']} decode steps, "
        f"{st['prefill_chunks']} prefill chunks; kernels launched {launched or 'none'}")
    log(f"[serve-moe] per model step (medians; stream span between CUDA events, host "
        f"enqueue): decode (B={B}) {dec['event_span_ms']:.3f} ms, {dec['enqueue_ms']:.3f} ms "
        f"(n={dec['n']}); prefill chunk (1x{SERVE_ENGINE['prefill_chunk']}) "
        f"{pre['event_span_ms']:.3f} ms, {pre['enqueue_ms']:.3f} ms (n={pre['n']})")
    log(f"[serve-moe] decode step (B={B}) traced (torch.profiler, 5 calls): "
        f"{prof['launches']:.0f} launches a call, the device busy {prof['busy_ms']:.3f} ms; "
        f"busy ms by class {prof['by_class_ms']}; {calls} {DecodeSync.NAME} calls for "
        f"{st['decode_steps']} decode steps; {live} KV blocks live")
    if launched or live or calls != st["decode_steps"] or not all(
            r.done and len(r.out_tokens) == MOE_SERVE_NEW for r in reqs):
        raise AssertionError(f"[serve-moe] kernels {launched}, {live} live blocks, {calls} "
                             f"decode-tp calls for {st['decode_steps']} steps, or unfinished "
                             f"requests {[len(r.out_tokens) for r in reqs]}")
    del eng, model
    torch.cuda.empty_cache()
    _moe_serve_card_vs_cpu()
    log(f"[serve-moe] phase wall {time.perf_counter() - t_phase:.1f} s")


def _moe_train_grads_card_vs_cpu() -> None:
    """The step's gradient (``train_loop._microbatched_grads``, four
    microbatches under remat "full") of the same CPU-drawn float32 weights
    (full width, ``MOE_CPU_DEPTH`` layers) and batch on the CPU and on the
    card: the loss within 1e-3, the grad norm within 1e-3 of the CPU's and
    every leaf within 1e-3 of its largest CPU entry."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import build_model, param_leaves
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import train_loop as tl

    cfg = dataclasses.replace(configs.get_config(MOE_ARCH), num_layers=MOE_CPU_DEPTH,
                              param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg)
    model = api.init(0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (TRAIN_CPU_BATCH, TRAIN_CPU_SEQ), generator=gen)
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
    names = [n for n, _ in param_leaves(model)]
    micro = cfg.parallelism.microbatch

    def grads(batch):
        params = [p for _, p in param_leaves(model)]
        loss, g = tl._microbatched_grads(lambda m, b: api.loss_fn(m, b), model, params, batch,
                                         micro)
        return float(loss), [x.detach().cpu() for x in g]

    t0 = time.perf_counter()
    with _MoeSpy() as spy:
        loss_c, g_c = grads(batch)
        tie_c = min(spy.read()[1])
        cpu_s = time.perf_counter() - t0
        model = model.to("cuda")
        loss_k, g_k = grads({k: v.cuda() for k, v in batch.items()})
        tie_k = min(spy.read()[1])
    n_c, n_k = float(global_norm(g_c)), float(global_norm(g_k))
    e = _leaf_dist(g_k, g_c)
    worst = max(zip(e, names))
    log(f"[train-moe] card vs CPU, {MOE_ARCH} full width, {MOE_CPU_DEPTH} layer(s), f32, batch "
        f"{TRAIN_CPU_BATCH}x{TRAIN_CPU_SEQ}, {micro} microbatches, remat "
        f"{cfg.parallelism.remat}: loss {loss_k:.6f} vs {loss_c:.6f}, grad norm {n_k:.6f} vs "
        f"{n_c:.6f}; worst leaf (of its largest entry) {worst[1]} {worst[0]:.3e}; smallest "
        f"router top-k margin {tie_c:.3e} (CPU), {tie_k:.3e} (card); CPU {cpu_s:.1f} s")
    if abs(loss_k - loss_c) > 1e-3 or abs(n_k - n_c) > 1e-3 * n_c or worst[0] > 1e-3:
        raise AssertionError(f"[train-moe] card and CPU gradients differ: loss {loss_k} vs "
                             f"{loss_c}, norm {n_k} vs {n_c}, worst leaf {worst}")
    del model, g_c, g_k
    torch.cuda.empty_cache()


def phase_train_moe(card: str) -> int:
    """[train-moe]: the config's own ZeRO-1 step (microbatch 4, remat
    "full", the f32 wire, ``attention_impl="xla"``) at full width and
    ``MOE_TRAIN_DEPTH`` of 24 layers, bf16 weights from seed 0, batch 8 of
    1024 tokens, 2 + 5 steps, the counts zeroed just before each step and
    read just after: ``pack_transposed`` once a step and nothing else;
    finite losses, an aux loss above 0, ms/step and the peak memory; then
    the card-vs-CPU gradient check.  Returns ``pack_transposed``'s
    launches over the 7 steps."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.models import build_model, transformer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop as tl

    t_phase = time.perf_counter()
    full = configs.get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_TRAIN_DEPTH)
    par = cfg.parallelism
    if (par.remat, par.microbatch, par.zero1, par.grad_compression,
            cfg.attention_impl) != ("full", 4, True, None, "xla"):
        raise AssertionError(f"[train-moe] the config's step changed: {par}, "
                             f"{cfg.attention_impl}")
    api = build_model(cfg)
    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), global_batch=TRAIN_BATCH,
                        seq_len=TRAIN_SEQ)
    drawn = [next(pipe) for _ in range(TRAIN_WARM + TRAIN_TIMED)]
    pipe.close()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms, total = [], [], [], 0
    with make_dist(device="cuda") as dist:
        t0 = time.perf_counter()
        state = tl.init_state(api, 0, dist)
        torch_sync()
        n = sum(p.numel() for p in state.params.parameters())
        log(f"[train-moe] {MOE_ARCH} full width, {cfg.num_layers} of {full.num_layers} layers: "
            f"{n} parameters (bf16) drawn on the CPU (seed 0) in "
            f"{time.perf_counter() - t0:.1f} s")
        step = tl.make_train_step(api, dist, AdamWConfig())
        for i, b in enumerate(drawn):
            batch = tl.local_batch(b, dist)
            torch_sync()
            _zero_counts()
            t = time.perf_counter()
            state, met = step(state, batch)
            loss, norm = float(met.loss), float(met.grad_norm)
            torch_sync()
            ms.append((time.perf_counter() - t) * 1e3)
            c = _counts()
            losses.append(loss)
            norms.append(norm)
            total += c["pack_transposed"]
            others = {k: v for k, v in c.items() if v and k != "pack_transposed"}
            if c["pack_transposed"] != 1 or others:
                raise AssertionError(f"[train-moe] step {i + 1} launched pack_transposed "
                                     f"{c['pack_transposed']} times (expected 1) and {others}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        with torch.no_grad():
            _, aux = transformer.forward_aux(state.params, batch["tokens"][:2], cfg)
        aux = float(aux)
        del state
    torch.cuda.empty_cache()
    free = torch.cuda.get_device_properties(0).total_memory / 1e9 - peak
    timed = ms[TRAIN_WARM:]
    log(f"[train-moe] losses {[round(v, 4) for v in losses]} grad norms "
        f"{[round(v, 4) for v in norms]}; aux loss after the steps {aux:.6f}; pack_transposed "
        f"once on every step")
    log(f"[train-moe] {MOE_ARCH} full width, {cfg.num_layers} layer(s), batch "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} on {card}: ms/step {[round(v, 1) for v in ms]} (median of "
        f"the {TRAIN_TIMED} after {TRAIN_WARM} warm {statistics.median(timed):.1f}); peak "
        f"{peak:.2f} GB ({free:.1f} GB of the card left)")
    if not all(math.isfinite(v) for v in losses + norms) or not aux > 0:
        raise AssertionError(f"[train-moe] losses {losses}, grad norms {norms}, aux {aux}")
    _moe_train_grads_card_vs_cpu()
    log(f"[train-moe] phase wall {time.perf_counter() - t_phase:.1f} s")
    return total


#: [moe4]: four cards, one rank each, model_axis=4 (16 experts a card)
MOE4 = 4
MOE4_DEPTH = 2
#: a capacity at which nothing drops (C >= the tokens routed: E / k = 15)
MOE4_NO_DROP = 16.0
MOE4_GATE = (1, 2048)     # the EP-vs-local forward's batch and sequence (float32)
MOE4_CHUNK = 32


def _moe4_rank(rank: int, world: int, init_method: str, out_dir: str,
               device: str = "cuda") -> None:
    """One rank of [moe4]: the model at full width and ``MOE4_DEPTH``
    layers (``device="cpu"``: the smoke config on gloo) on ``model_axis=4``.
    (1) float32 at a capacity where nothing drops: layer 0's MoE block on
    one random input, a forward and one prefill chunk through EP, each
    against the same model run locally (the ``model_axis=1`` function),
    with the routing's ties found per token; (2)
    bf16 at the config's capacity 1.25: µs per ``alltoall`` of the dispatch
    buffer and its bytes, and ms per EP and per local forward."""
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.core import CallCounter
    from repro_torch.models import build_model, transformer
    from repro_torch.models.moe import _capacity, moe_block
    from repro_torch.runtime.dist import make_dist
    from repro_torch.serve import BlockAllocator, block_table_view

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device != "cpu"
    if not on_card:
        torch.set_num_threads(1)
    base = configs.get_config(MOE_ARCH) if on_card else configs.smoke_config(MOE_ARCH)
    base = dataclasses.replace(base, num_layers=MOE4_DEPTH)
    rec = {}
    with make_dist(device=f"cuda:{rank}" if on_card else "cpu", model_axis=world,
                   world_size=world, rank=rank, init_method=init_method) as dist:
        dev = dist.device
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        # (1) EP against local, float32, nothing drops
        cfg = dataclasses.replace(base, param_dtype="float32", compute_dtype="float32",
                                  moe=dataclasses.replace(base.moe,
                                                          capacity_factor=MOE4_NO_DROP))
        api = build_model(cfg)
        model = api.init(0, device=dev)
        m = cfg.moe
        B, S = MOE4_GATE if on_card else (1, 64)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
        h = torch.randn((B, S, cfg.d_model), generator=gen).to(dev)
        with torch.no_grad():
            # the block on one input: each token's rows against local mode,
            # where EP's routing (each rank's rows, another GEMM shape) chose
            # the same experts; a token whose choice differs must be a tie
            p0 = model.layers.moe.layer(0)
            cc.reset()
            y_ep, _ = moe_block(p0, h, cfg, dist)
            calls = dict(cc.counts)
            y_loc, _ = moe_block(p0, h, cfg)
            T, Sl = B * S, S // world
            router = p0["router"]
            full = torch.softmax(h.reshape(T, -1) @ router, -1)
            part = torch.cat([torch.softmax(h[:, r * Sl:(r + 1) * Sl].reshape(B * Sl, -1) @ router,
                                            -1).view(B, Sl, -1) for r in range(world)], 1)
            pick = lambda pr: torch.topk(pr, m.top_k).indices.sort(-1).values  # noqa: E731
            flipped = (pick(full) != pick(part.reshape(T, -1))).any(-1)
            top = torch.topk(full, m.top_k + 1).values
            margin = top[:, m.top_k - 1] - top[:, m.top_k]
            per_token = (y_ep - y_loc).abs().reshape(T, -1).amax(-1)
            rec.update(block_diff=float(per_token[~flipped].max()),
                       flipped=int(flipped.sum()),
                       flipped_margin=float(margin[flipped].max()) if flipped.any() else 0.0,
                       block_scale=float(y_loc.abs().max()), min_margin=float(margin.min()))
            # the whole forward and one prefill chunk
            with _MoeSpy() as spy:
                ep = api.forward(model, {"tokens": tokens}, dist=dist)
                spy.read()
                local = api.forward(model, {"tokens": tokens})
                token_margin = torch.stack(spy.margin).amin(0)   # each position's, over layers
                spy.read()
            alloc = BlockAllocator(8, 16)
            table = torch.from_numpy(block_table_view(alloc, alloc.alloc_many(2), 2)[None]).to(dev)
            chunk = tokens[:1, :MOE4_CHUNK]
            pages = transformer.init_paged_cache(cfg, 8, 16, dtype=torch.float32, device=dev)
            p_ep = transformer.prefill_chunk_paged(model, chunk, pages, table, 0, cfg, dist)[0]
            pages.k.zero_(), pages.v.zero_()
            p_local = transformer.prefill_chunk_paged(model, chunk, pages, table, 0, cfg)[0]
        pos = (ep - local).abs().amax(-1).reshape(-1)
        off = torch.nonzero(pos > F32_LOGIT_TOL).flatten().tolist()
        # a routing tie changes its own token first: the first position off
        # must be one whose router margin is a tie
        rec.update(calls=calls, forward_diff=float(pos.max()), forward_off=len(off),
                   forward_first_off=off[0] if off else -1,
                   forward_margin=float(token_margin[off[0]]) if off else 0.0,
                   prefill_diff=float((p_ep - p_local).abs().max()),
                   finite=bool(torch.isfinite(ep).all()), shape=list(ep.shape),
                   logit_scale=float(local.abs().max()))
        del model, ep, local, p_ep, p_local, pages, y_ep, y_loc, full, part
        # (2) bf16 at the config's capacity: the alltoall and the forwards
        cfg = base
        api = build_model(cfg)
        model = api.init(0, device=dev)
        B, S = (FWD_BATCH, FWD_SEQ) if on_card else (2, 64)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
        m = cfg.moe
        E_pad = m.padded_experts or m.num_experts
        C = _capacity(B * S // world, m.top_k, m.num_experts, m.capacity_factor)
        buf = torch.randn((E_pad, C, cfg.d_model), generator=gen).to(dev, torch.bfloat16)
        times = []
        for i in range(3 + TIMING_ITERS):
            dist.abi.barrier(dist.tp_comm)
            if on_card:   # NCCL's barrier orders the stream: wait for it on the host
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            dist.abi.alltoall(buf, dist.tp_comm, split_axis=0, concat_axis=1)
            if on_card:
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e6)
        rec.update(alltoall_us=statistics.median(times[3:]), alltoall_bytes=buf.numel() * 2,
                   capacity=C, T_local=B * S // world, capacity_factor=m.capacity_factor)
        with torch.no_grad():
            fwd = {}
            for name, d in (("ep", dist), ("local", None), ("ep", dist), ("local", None)):
                for _ in range(2):
                    api.forward(model, {"tokens": tokens}, dist=d)
                dist.abi.barrier(dist.tp_comm)
                if on_card:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(FWD_ITERS):
                    api.forward(model, {"tokens": tokens}, dist=d)
                if on_card:
                    torch.cuda.synchronize(dev)
                fwd.setdefault(name, []).append((time.perf_counter() - t0) * 1e3 / FWD_ITERS)
        rec.update(forward_ms=fwd, B=B, S=S)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))


def phase_moe4(card: str, device: str = "cuda", out_dir: Path = HERE / "build" / "moe4") -> dict:
    """[moe4] (four cards, NCCL): :func:`_moe4_rank` on four spawned
    ranks.  Gates (float32, nothing dropped): the EP block within 1e-3 of
    local on every token whose experts both modes chose alike, and every
    other token a router tie (top-k margin below ``ROUTER_TIE``: EP routes
    each rank's rows, another GEMM shape, which may break a tie the other
    way); the whole forward within 1e-3 or its first position off a tie;
    the prefill chunk within 1e-3; finite logits; 2 ``alltoall`` calls and
    1 ``allgather`` in the block.  Records µs per ``alltoall`` at capacity
    1.25 and its bytes, and ms per forward."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_moe4_rank, args=(r, MOE4, f"tcp://localhost:{port}",
                                                  str(out_dir), device))
             for r in range(MOE4)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + 600
    for proc in procs:
        proc.join(max(deadline - time.monotonic(), 1))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    codes = [proc.exitcode for proc in procs]
    if codes != [0] * MOE4:
        raise RuntimeError(f"[moe4] rank exit codes {codes}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(MOE4)]
    r0 = ranks[0]
    log(f"[moe4] {MOE_ARCH} {'full width' if device != 'cpu' else 'smoke'}, {MOE4_DEPTH} "
        f"layers, model_axis={MOE4} on {card if device != 'cpu' else 'gloo'}, f32, capacity "
        f"{MOE4_NO_DROP} (nothing drops): layer 0's MoE block on one input, EP vs local, max abs "
        f"diff per rank {[f'{r['block_diff']:.3e}' for r in ranks]} over the tokens routed alike "
        f"(bound {F32_LOGIT_TOL}; outputs' max abs {r0['block_scale']:.3f}); {r0['flipped']} of "
        f"{MOE4_GATE[0] * MOE4_GATE[1] if device != 'cpu' else 64} tokens routed otherwise (their "
        f"largest top-k margin {r0['flipped_margin']:.3e}, a tie below {ROUTER_TIE}; smallest "
        f"margin {r0['min_margin']:.3e}); ABI calls in the EP block {r0['calls']}")
    log(f"[moe4] whole forward {r0['shape']}: logits max abs diff {r0['forward_diff']:.3e} "
        f"(logits' max abs {r0['logit_scale']:.3f}), {r0['forward_off']} positions beyond "
        f"{F32_LOGIT_TOL} (the first at {r0['forward_first_off']}, its smallest router margin "
        f"over the layers {r0['forward_margin']:.3e}); one prefill chunk (1x{MOE4_CHUNK}) logits max abs diff "
        f"{[f'{r['prefill_diff']:.3e}' for r in ranks]}")
    log(f"[moe4] alltoall of the ({r0['capacity']}-slot) dispatch buffer at capacity "
        f"{r0['capacity_factor']} "
        f"(T = {r0['T_local']} tokens a rank), {r0['alltoall_bytes'] / 1e6:.2f} MB bf16 a "
        f"rank: {[round(r['alltoall_us'], 1) for r in ranks]} µs (median of {TIMING_ITERS}, "
        f"host clock around a synced call); ms per bf16 forward at B={r0['B']} S={r0['S']} "
        f"(rank 0, in turns): EP {[round(t, 2) for t in r0['forward_ms']['ep']]}, local "
        f"{[round(t, 2) for t in r0['forward_ms']['local']]}; phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    want = {"alltoall": 2, "allgather": 1, "allreduce": 1}
    for r, rec in enumerate(ranks):
        got = {k: rec["calls"].get(k, 0) for k in want}
        tie_only = rec["flipped"] == 0 or rec["flipped_margin"] < ROUTER_TIE
        fwd_ok = rec["forward_diff"] <= F32_LOGIT_TOL or rec["forward_margin"] < ROUTER_TIE
        if (rec["block_diff"] > F32_LOGIT_TOL or not tie_only or not fwd_ok
                or rec["prefill_diff"] > F32_LOGIT_TOL or not rec["finite"] or got != want):
            raise AssertionError(f"[moe4] rank {r}: EP block differs from local by "
                                 f"{rec['block_diff']} ({rec['flipped']} tokens routed "
                                 f"otherwise, margin {rec['flipped_margin']}), forward "
                                 f"{rec['forward_diff']} (router margin {rec['forward_margin']}), "
                                 f"prefill {rec['prefill_diff']}, finite {rec['finite']}, calls "
                                 f"{got} (want {want})")
    return r0


def _spawn_ranks(name: str, target, world: int, out_dir: Path, device: str,
                 timeout: float = 900) -> list:
    """``target(rank, world, init_method, out_dir, device)`` on ``world``
    spawned ranks meeting at a free localhost port; each writes
    ``rank<r>.json``, returned in rank order.  Fails if a rank fails (the
    others, which may wait on it in a collective, are killed at once) or
    the ranks outlive ``timeout``."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, f"tcp://localhost:{port}",
                                              str(out_dir), device))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    while (any(proc.is_alive() for proc in procs) and time.monotonic() < deadline
           and not any(proc.exitcode for proc in procs)):
        time.sleep(0.5)
    for proc in procs:
        if proc.is_alive():
            proc.kill()
        proc.join(10)
    codes = [proc.exitcode for proc in procs]
    if codes != [0] * world:
        raise RuntimeError(f"[{name}] rank exit codes {codes}")
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]


class _RouteSpy:
    """Within ``with``, records each ``moe._route`` call's experts (sorted
    per token) and top-k margins (the k-th minus the (k+1)-th router
    probability); :meth:`take` returns and clears them."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe

        self.calls = []
        self._route = moe._route

        def route(router, xf, m, batch_group=None):
            out = self._route(router, xf, m, batch_group)
            with torch.no_grad():
                probs = torch.softmax(xf.float() @ router, -1)
                top = torch.topk(probs, m.top_k + 1, -1)
                self.calls.append((top.indices[:, :m.top_k].sort(-1).values,
                                   top.values[:, m.top_k - 1] - top.values[:, m.top_k]))
            return out

        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self._route

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def _digest(tensors) -> str:
    """SHA-256 of tensors' bytes in order (bfloat16 as its raw bits)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _timed(fn, on_card: bool, dev) -> tuple:
    """(fn's result, its wall ms around a synced call)."""
    import torch

    if on_card:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


#: [ep4]: four cards, model_axis=4 (16 experts a card), the config's step
EP4 = 4
EP4_DEPTH = 2
#: gradient gate: each leaf within this share of its scale of local mode
EP4_GRAD_TOL = 1e-3
#: microbatches the gradient gate may try for one where no token routes
#: otherwise under EP than locally
EP4_GRAD_TRIES = 3


def _ep4_rank(rank: int, world: int, init_method: str, out_dir: str,
              device: str = "cuda") -> None:
    """One rank of [ep4]: qwen2-moe-a2.7b at full width and ``EP4_DEPTH``
    layers (``device="cpu"``: the smoke config on gloo) on
    ``model_axis=4``, each rank holding its block (``transformer.held_layout``:
    its 16 experts, 4 of 16 heads, a quarter of the shared experts and of
    the vocabulary).  (1) float32, aux
    weight 0, a capacity at which nothing drops: one microbatch's gradient
    through EP against local mode's on the whole model (this card), each
    expert leaf against its slice, with each token's routing in both; where
    a token on any rank routes otherwise, again on the next microbatch, up
    to ``EP4_GRAD_TRIES``; (2)
    the config's bf16 ZeRO-1 step, 2 + 5 steps of batch 8 x 1024: losses,
    grad norms, ms/step, ``pack_transposed`` launches and ABI alltoalls a
    step, peak memory, the replicated and the expert leaves' digests; (3)
    µs per alltoall of the step's dispatch buffer, and one microbatch's
    forward and backward ms."""
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.core import PAX_SUM, CallCounter
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.models import build_model, param_leaves
    from repro_torch.models.model import leaf_splits
    from repro_torch.models.moe import _capacity
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device != "cpu"
    if not on_card:
        torch.set_num_threads(1)
    full = configs.get_config(MOE_ARCH) if on_card else configs.smoke_config(MOE_ARCH)
    base = dataclasses.replace(full, num_layers=EP4_DEPTH)
    if on_card:
        base = dataclasses.replace(base, parallelism=full.parallelism)
    B, S = (TRAIN_BATCH, TRAIN_SEQ) if on_card else (8, 32)
    n_micro = max(base.parallelism.microbatch, 1)
    rec: dict = {}
    with make_dist(device=f"cuda:{rank}" if on_card else "cpu", model_axis=world,
                   world_size=world, rank=rank, init_method=init_method) as dist:
        dev = dist.device
        r = dist.abi.comm_rank(dist.tp_comm)
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        pipe = DataPipeline(SyntheticSource(base.vocab_size, seed=0), global_batch=B, seq_len=S)
        drawn = [next(pipe) for _ in range(TRAIN_WARM + TRAIN_TIMED)]
        pipe.close()
        micro = [{k: torch.as_tensor(v[:B // n_micro]).to(dev) for k, v in d.items()}
                 for d in drawn[:EP4_GRAD_TRIES]]
        mb = micro[0]
        # (1) the gradient, EP against local, float32, nothing dropped, on
        # the first microbatch in which every token routes alike on every
        # rank (a token routed otherwise moves every leaf's gradient)
        cfg = dataclasses.replace(base, param_dtype="float32", compute_dtype="float32",
                                  moe=dataclasses.replace(base.moe, aux_loss_weight=0.0,
                                                          capacity_factor=MOE4_NO_DROP))
        api = build_model(cfg)
        models = {"ep": api.init(0, dev, model_rank=r, model_axis=world),
                  "local": api.init(0, dev)}
        spy = _RouteSpy()
        Sl = S // world
        tries = []
        for batch in micro:
            runs = {}
            for mode, model in models.items():
                named = param_leaves(model)
                with spy:
                    loss = api.loss_fn(model, batch, dist if mode == "ep" else None)
                    routes = spy.take()[:EP4_DEPTH]       # the forward's, not remat's
                    grads = torch.autograd.grad(loss, [p for _, p in named])
                runs[mode] = (float(loss.detach()), {n: g for (n, _), g in zip(named, grads)},
                              routes)
                del named, grads, loss
            (l_ep, g_ep, r_ep), (l_loc, g_loc, r_loc) = runs["ep"], runs["local"]
            worst, worst_leaf = 0.0, ""
            ep = models["ep"]
            for name, g in g_ep.items():
                # a split leaf (experts, heads, shared FFN, vocabulary): this rank's block
                want = g_loc[name][ep.part.index(tuple(g_loc[name].shape), ep.held[name])]
                err = float((g - want).abs().max() / want.abs().max().clamp_min(1e-30))
                if err > worst:
                    worst, worst_leaf = err, name
            flipped, flip_margin, min_margin = 0, 0.0, float("inf")
            for (e_ep, _), (e_loc, m_loc) in zip(r_ep, r_loc):
                k = e_loc.shape[-1]
                mine = e_loc.view(B // n_micro, S, k)[:, r * Sl:(r + 1) * Sl].reshape(-1, k)
                m_mine = m_loc.view(B // n_micro, S)[:, r * Sl:(r + 1) * Sl].reshape(-1)
                off = (mine != e_ep).any(-1)
                flipped += int(off.sum())
                if off.any():
                    flip_margin = max(flip_margin, float(m_mine[off].max()))
                min_margin = min(min_margin, float(m_mine.min()))
            held = int(g_ep["layers.moe.experts.wi"].shape[1])
            del runs, g_ep, g_loc
            anywhere = dist.abi.allreduce(torch.tensor(float(flipped), device=dev), PAX_SUM,
                                          dist.tp_comm)
            tries.append(dict(loss_ep=l_ep, loss_local=l_loc, grad_err=worst,
                              grad_worst=worst_leaf, flipped=flipped, flipped_margin=flip_margin,
                              min_margin=min_margin, flipped_anywhere=int(anywhere)))
            if not tries[-1]["flipped_anywhere"]:
                break
        del models, model, g, want
        rec.update(tries=tries, held_experts=held,
                   experts=base.moe.padded_experts or base.moe.num_experts, batch=[B, S],
                   dtype=base.param_dtype)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        # (2) the config's ZeRO-1 step, bf16
        api = build_model(base)
        t0 = time.perf_counter()
        state = tl.init_state(api, 0, dist)
        rec["init_s"] = time.perf_counter() - t0
        rec["params"] = sum(p.numel() for p in state.params.parameters())
        step = tl.make_train_step(api, dist, AdamWConfig())
        losses, norms, ms, packs, a2a, launched = [], [], [], [], [], {}
        for b in drawn:
            batch = tl.local_batch(b, dist)
            dist.abi.barrier(dist.tp_comm)
            _zero_counts()
            cc.reset()
            (state, met), t = _timed(lambda: step(state, batch), on_card, dev)
            losses.append(float(met.loss))
            norms.append(float(met.grad_norm))
            ms.append(t)
            c = _counts()
            packs.append(c["pack_transposed"])
            a2a.append(cc.counts.get("alltoall", 0))
            for name, v in c.items():
                if v and name != "pack_transposed":
                    launched[name] = launched.get(name, 0) + v
        named = param_leaves(state.params)
        split = leaf_splits(state.params)[0]
        rec.update(losses=losses, grad_norms=norms, ms=ms, packs=packs, alltoalls=a2a,
                   other_launches=launched,
                   replicated_sha=_digest(p for (_, p), e in zip(named, split) if not e),
                   expert_sha=_digest(p for (_, p), e in zip(named, split) if e),
                   peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0))
        # (3) one microbatch's forward and backward, and the alltoall alone
        params = [p for _, p in named]
        fb = {"forward": [], "backward": []}
        for _ in range(3):
            dist.abi.barrier(dist.tp_comm)
            loss, t = _timed(lambda: api.loss_fn(state.params, mb, dist), on_card, dev)
            fb["forward"].append(t)
            _, t = _timed(lambda: torch.autograd.grad(loss, params), on_card, dev)
            fb["backward"].append(t)
        del loss
        m = base.moe
        E_pad = m.padded_experts or m.num_experts
        T_local = (B // n_micro) * S // world
        C = _capacity(T_local, m.top_k, m.num_experts, m.capacity_factor)
        buf = torch.randn((E_pad, C, base.d_model), generator=torch.Generator().manual_seed(1))
        buf = buf.to(dev, torch.bfloat16 if on_card else torch.float32)
        times = []
        for _ in range(3 + TIMING_ITERS):
            dist.abi.barrier(dist.tp_comm)
            _, t = _timed(lambda: dist.abi.alltoall(buf, dist.tp_comm, split_axis=0,
                                                    concat_axis=1), on_card, dev)
            times.append(t * 1e3)
        rec.update(fwd_bwd_ms=fb, alltoall_us=statistics.median(times[3:]),
                   alltoall_bytes=buf.numel() * buf.element_size(), capacity=C,
                   T_local=T_local)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))


def phase_ep4(card: str, device: str = "cuda", out_dir: Path = HERE / "build" / "ep4") -> dict:
    """[ep4] (four cards, NCCL through ``paxi``): :func:`_ep4_rank` on four
    spawned ranks.  Gates: each rank holds E_pad/4 experts; finite losses,
    the same on every rank; ``pack_transposed`` once a step on every rank
    (on the CPU, where the plain version runs, never) and no other kernel;
    after the last step the replicated leaves' digest equal on the four
    ranks; in float32 with the aux weight 0 and nothing dropped, every
    token routed otherwise a router tie (top-k margin below
    ``ROUTER_TIE``), and on the microbatch where no token on any rank
    routes otherwise, every gradient leaf within ``EP4_GRAD_TOL`` of its
    scale of local mode's (a microbatch with such a token is not gated on
    its gradient: the token moves every leaf's)."""
    t0 = time.perf_counter()
    ranks = _spawn_ranks("ep4", _ep4_rank, EP4, out_dir, device)
    r0 = ranks[0]
    where = card if device != "cpu" else "gloo"
    steps = TRAIN_WARM + TRAIN_TIMED
    log(f"[ep4] {MOE_ARCH} {'full width' if device != 'cpu' else 'smoke'}, {EP4_DEPTH} layers, "
        f"model_axis={EP4} on {where}: {r0['held_experts']} of {r0['experts']} experts a rank, "
        f"{r0['params']} parameters a rank ({r0['dtype']}) drawn in {r0['init_s']:.1f} s")
    for i, first in enumerate(r0["tries"]):
        tr = [r["tries"][i] for r in ranks]
        log(f"[ep4] f32 gradient of microbatch {i}, aux 0, capacity {MOE4_NO_DROP} (nothing "
            f"drops): EP loss {first['loss_ep']:.6f} vs local {first['loss_local']:.6f}; worst "
            f"leaf per rank {[(t['grad_worst'], f'{t['grad_err']:.3e}') for t in tr]} of its "
            f"scale (bound {EP4_GRAD_TOL}); tokens routed otherwise {[t['flipped'] for t in tr]} "
            f"(largest margin {max(t['flipped_margin'] for t in tr):.3e}, smallest "
            f"{min(t['min_margin'] for t in tr):.3e})")
    log(f"[ep4] the config's ZeRO-1 step, batch {r0['batch'][0]}x{r0['batch'][1]}: losses "
        f"{[round(v, 4) for v in r0['losses']]} grad norms "
        f"{[round(v, 4) for v in r0['grad_norms']]}; ms/step per rank "
        f"{[[round(t, 1) for t in r['ms']] for r in ranks]} (rank 0's median of the "
        f"{TRAIN_TIMED} after {TRAIN_WARM} warm {statistics.median(r0['ms'][TRAIN_WARM:]):.1f}); "
        f"peak GB per card {[round(r['peak_gb'], 2) for r in ranks]}; pack_transposed a step "
        f"{[r['packs'] for r in ranks]}; ABI alltoalls a step {r0['alltoalls']}")
    log(f"[ep4] replicated leaves' SHA-256 per rank {[r['replicated_sha'][:16] for r in ranks]}; "
        f"split leaves' {[r['expert_sha'][:16] for r in ranks]}; one microbatch's forward ms "
        f"{[round(t, 1) for t in r0['fwd_bwd_ms']['forward']]} and backward ms "
        f"{[round(t, 1) for t in r0['fwd_bwd_ms']['backward']]} (rank 0); alltoall of the "
        f"step's ({r0['capacity']}-slot, T = {r0['T_local']}) dispatch buffer, "
        f"{r0['alltoall_bytes'] / 1e6:.2f} MB: {[round(r['alltoall_us'], 1) for r in ranks]} µs "
        f"(median of {TIMING_ITERS}); phase wall {time.perf_counter() - t0:.1f} s")
    want_pack = [1] * steps if device != "cpu" else [0] * steps
    for r, rec in enumerate(ranks):
        last = rec["tries"][-1]
        ties = all(t["flipped_margin"] < ROUTER_TIE for t in rec["tries"])
        grad_ok = ties and last["flipped_anywhere"] == 0 and last["grad_err"] <= EP4_GRAD_TOL
        if (rec["held_experts"] != rec["experts"] // EP4 or rec["losses"] != r0["losses"]
                or not all(math.isfinite(v) for v in rec["losses"] + rec["grad_norms"])
                or rec["packs"] != want_pack or rec["other_launches"]
                or rec["replicated_sha"] != r0["replicated_sha"] or not grad_ok):
            raise AssertionError(
                f"[ep4] rank {r}: experts {rec['held_experts']}, losses {rec['losses']} (rank 0 "
                f"{r0['losses']}), pack_transposed {rec['packs']}, other launches "
                f"{rec['other_launches']}, replicated digest {rec['replicated_sha'][:16]} (rank "
                f"0 {r0['replicated_sha'][:16]}), gradient per microbatch tried "
                f"{[(t['grad_err'], t['grad_worst']) for t in rec['tries']]}, tokens routed "
                f"otherwise {[(t['flipped'], t['flipped_margin']) for t in rec['tries']]} (on "
                f"any rank {[t['flipped_anywhere'] for t in rec['tries']]})")
    if len({r["expert_sha"] for r in ranks}) != EP4:
        raise AssertionError("[ep4] two ranks hold the same block")
    return r0


#: [pp4]: four cards, one pipeline stage each, M microbatches
PP4 = 4
PP4_M = 4
PP4_BATCH, PP4_SEQ = 8, 128
PP4_LOSS_RTOL = 1e-5
PP4_GRAD_TOL = 1e-4
PP4_WARM, PP4_TIMED = 2, 3


def _pp4_rank(rank: int, world: int, init_method: str, out_dir: str,
              device: str = "cuda") -> None:
    """One rank of [pp4]: qwen2-0.5b at full width in float32 (the CPU:
    the smoke config at 4 layers), 24 layers in 4 stages of 6 on a
    ``(pod, model)`` mesh, this rank's stage built from the whole model's
    seed-0 draw; ``pipelined_loss_fn`` over ``PP4_M`` microbatches of a
    batch 8 x 128, its gradient, and the embedding's and final norm's
    summed over the stages; the ABI calls of the forward and the backward;
    against ``loss_fn`` of the whole model on this card: the loss, every
    gradient leaf (the stage's layers as its slice); ms per pipelined step
    and per one-card step."""
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.core import CallCounter
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.models import build_model, param_leaves, transformer
    from repro_torch.runtime.dist import make_dist
    from repro_torch.runtime.pipeline import (make_pp_dist, pipelined_loss_fn,
                                              replicated_grad_sum)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device != "cpu"
    if not on_card:
        torch.set_num_threads(1)
    base = (configs.get_config(ARCH) if on_card
            else dataclasses.replace(configs.smoke_config(ARCH), num_layers=4))
    cfg = dataclasses.replace(base, param_dtype="float32", compute_dtype="float32")
    B, S = (PP4_BATCH, PP4_SEQ) if on_card else (8, 16)
    rec: dict = {}
    with make_dist(device=f"cuda:{rank}" if on_card else "cpu", world_size=world, rank=rank,
                   init_method=init_method, axis_names=("pod", "model")) as dist:
        dist = make_pp_dist(dist, "pod")
        dev = dist.device
        s = dist.abi.comm_rank(dist.pp_comm)
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        api = build_model(cfg)
        whole = api.init(0, "cpu")
        scfg, part = transformer.stage_model(whole, cfg, s, world, dev)
        embed_fn, layer_stack_fn, head_fn = transformer.pipeline_fns(part, scfg)
        pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), global_batch=B, seq_len=S)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in next(pipe).items()}
        pipe.close()
        named = param_leaves(part)
        params = [p for _, p in named]
        shared = [not n.startswith("layers.") for n, _ in named]

        def pp_step():
            loss = pipelined_loss_fn(embed_fn, layer_stack_fn, head_fn, part, batch, dist=dist,
                                     n_microbatches=PP4_M, stage_axis="pod")
            fwd = dict(cc.counts)
            grads = list(torch.autograd.grad(loss, params))
            summed = iter(replicated_grad_sum([g for g, k in zip(grads, shared) if k], dist))
            grads = [next(summed) if k else g for g, k in zip(grads, shared)]
            return loss, grads, fwd

        cc.reset()
        loss, grads, fwd = pp_step()
        bwd = {k: v - fwd.get(k, 0) for k, v in cc.counts.items()}
        pp_ms = []
        for _ in range(PP4_WARM + PP4_TIMED):
            dist.abi.barrier(dist.pp_comm)
            _, t = _timed(pp_step, on_card, dev)
            pp_ms.append(t)
        # the whole model on this card, un-pipelined
        ref = whole.to(dev)
        ref_named = dict(param_leaves(ref))

        def one_step():
            l = api.loss_fn(ref, batch)
            return l, torch.autograd.grad(l, list(ref_named.values()))

        ref_loss, ref_grads = one_step()
        ref_grads = dict(zip(ref_named, ref_grads))
        one_ms = []
        for _ in range(PP4_WARM + PP4_TIMED):
            _, t = _timed(one_step, on_card, dev)
            one_ms.append(t)
        n = scfg.num_layers
        worst, worst_leaf = 0.0, ""
        for (name, _), g in zip(named, grads):
            want = ref_grads[name]
            if name.startswith("layers."):
                want = want[s * n:(s + 1) * n]
            err = float((g - want).abs().max() / want.abs().max().clamp_min(1e-30))
            if err > worst:
                worst, worst_leaf = err, name
        rec.update(stage=s, layers=n, loss=float(loss.detach()),
                   ref_loss=float(ref_loss.detach()), batch=[B, S],
                   grad_err=worst, grad_worst=worst_leaf,
                   fwd_calls={k: v for k, v in fwd.items() if k != "comm_rank"},
                   bwd_calls={k: v for k, v in bwd.items() if k != "comm_rank"},
                   pp_ms=pp_ms, one_ms=one_ms,
                   peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0))
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))


def phase_pp4(card: str, device: str = "cuda", out_dir: Path = HERE / "build" / "pp4") -> dict:
    """[pp4] (four cards, NCCL through ``paxi``): :func:`_pp4_rank` on four
    spawned ranks.  Gates: the pipelined loss within ``PP4_LOSS_RTOL`` of
    the un-pipelined one on every rank; every gradient leaf within
    ``PP4_GRAD_TOL`` of its scale; ``M + S - 1`` ABI ``sendrecv`` calls in
    the forward and as many in the backward.  Records ms per pipelined
    step against the one-card step, and the bubble share (S-1)/(M+S-1)."""
    t0 = time.perf_counter()
    ranks = _spawn_ranks("pp4", _pp4_rank, PP4, out_dir, device)
    r0 = ranks[0]
    hops = PP4_M + PP4 - 1
    med = lambda v: statistics.median(v[PP4_WARM:])  # noqa: E731
    log(f"[pp4] {ARCH} {'full width' if device != 'cpu' else 'smoke'} in f32, "
        f"{PP4 * r0['layers']} layers in {PP4} stages of {r0['layers']} on "
        f"{card if device != 'cpu' else 'gloo'}, M={PP4_M} microbatches of batch "
        f"{r0['batch'][0]}x{r0['batch'][1]}: loss per stage {[r['loss'] for r in ranks]} vs un-pipelined "
        f"{[r['ref_loss'] for r in ranks]}; worst gradient leaf per stage "
        f"{[(r['grad_worst'], f'{r['grad_err']:.3e}') for r in ranks]} of its scale (bound "
        f"{PP4_GRAD_TOL}); ABI calls forward {r0['fwd_calls']}, backward {r0['bwd_calls']}")
    log(f"[pp4] ms per pipelined step per stage {[[round(t, 1) for t in r['pp_ms']] for r in ranks]} "
        f"(rank 0's median {med(r0['pp_ms']):.1f}) vs one card, un-pipelined "
        f"{[round(t, 1) for t in r0['one_ms']]} (median {med(r0['one_ms']):.1f}); bubble share "
        f"(S-1)/(M+S-1) = {PP4 - 1}/{hops} = {(PP4 - 1) / hops:.3f}; peak GB per card "
        f"{[round(r['peak_gb'], 2) for r in ranks]}; phase wall {time.perf_counter() - t0:.1f} s")
    for r, rec in enumerate(ranks):
        if (rec["stage"] != r or not math.isclose(rec["loss"], rec["ref_loss"], rel_tol=PP4_LOSS_RTOL)
                or rec["grad_err"] > PP4_GRAD_TOL
                or rec["fwd_calls"].get("sendrecv") != hops
                or rec["bwd_calls"].get("sendrecv") != hops):
            raise AssertionError(
                f"[pp4] stage {r}: loss {rec['loss']} vs {rec['ref_loss']}, gradient "
                f"{rec['grad_err']} at {rec['grad_worst']}, sendrecv forward "
                f"{rec['fwd_calls'].get('sendrecv')} backward {rec['bwd_calls'].get('sendrecv')} "
                f"(want {hops} each)")
    return r0


# ---------------------------------------------------------------------------
# the encdec and vlm families: [forward-encdec], [decode-encdec],
# [train-encdec], [forward-vlm], [serve-vlm], [train-vlm]
# ---------------------------------------------------------------------------
#: [forward-encdec]: B=4, the decoder's 448 positions (whisper's) over the
#: config's 1500 frames
ENC_BATCH, ENC_SEQ = 4, 448
#: [forward-vlm]: B=4, the config's 576 image tokens before 1472 text tokens:
#: 2048 positions a row
VLM_BATCH, VLM_TEXT = 4, 1472
#: greedy decodes: new tokens; [serve-vlm]'s text prompt after the image
MM_NEW, VLM_PROMPT = 64, 64
#: [train-encdec], [train-vlm]: the configs' steps, global batch 8 of 448
#: (whisper's decoder length) and of 1024 text tokens; phi-3-vision at 8 of
#: 32 layers (1.12 G parameters take 55.86 GB at this batch, PERF.md section
#: 6; all 32 would need about 190 GB)
MM_TRAIN_SEQ = {ENCDEC_ARCH: 448, VLM_ARCH: 1024}
VLM_TRAIN_DEPTH = 8
#: the card-vs-CPU checks: float32, 2 decoder (and encoder) layers; the
#: gradient at batch 4 in the configs' 4 microbatches over 32 text tokens,
#: the decodes at B=2 for 16 tokens
MM_CPU_DEPTH = 2
MM_CPU_BATCH, MM_CPU_SEQ = 4, 32
MM_CPU_NEW = 16


def _mm_config(arch: str, depth=None, **change):
    """The arch's config, with ``depth`` decoder (and encoder) layers."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_config(arch)
    if depth is not None:
        change["num_layers"] = depth
        if cfg.encdec is not None:
            change["encdec"] = dataclasses.replace(cfg.encdec, encoder_layers=depth)
    return dataclasses.replace(cfg, **change)


def _flash_and_xla(tag: str, cfg, model, batch, card: str) -> int:
    """The forward under ``"flash"`` (one launch a causal self-attention,
    every other kernel 0, the last call held to ``attention_ref`` on its
    own activations) and under ``"xla"`` (no launch) on the same weights:
    the bf16 logits' max difference and top-1 agreement, ``last_only``
    against the last row, ms per forward of both in turns (CUDA events)
    and the host's time to enqueue one.  Returns the flash launches of one
    forward."""
    import dataclasses

    import torch
    from repro_torch.models import build_model

    apis = {impl: build_model(dataclasses.replace(cfg, attention_impl=impl))
            for impl in ("flash", "xla")}
    B, S = batch["tokens"].shape
    shape = (B, S, cfg.vocab_size)
    with torch.no_grad():
        with _FlashSpy() as spy:
            flash, counts = _forward_check(apis["flash"], model, batch, cfg, tag,
                                           {"flash_attention": cfg.num_layers}, shape)
        spy.check(tag)
        xla, _ = _forward_check(apis["xla"], model, batch, cfg, tag, {}, shape)
        top1 = float((flash.argmax(-1) == xla.argmax(-1)).float().mean())
        log(f"[{tag}] bf16 logits flash vs xla: max abs diff {_max_err(flash, xla):.4e} "
            f"(logits' max abs {float(xla.float().abs().max()):.3f}), top-1 agreement "
            f"{top1:.4f}")
        del xla
        _last_only_check(apis["flash"], model, batch, flash, tag)
        del flash
        turns = ("flash", "xla", "xla", "flash")
        ms = {}
        for impl in turns:
            ms.setdefault(impl, []).append(
                _time_ms(lambda: apis[impl].forward(model, batch), FWD_ITERS))
        enqueue = {impl: _enqueue_ms(lambda: apis[impl].forward(model, batch))
                   for impl in ("flash", "xla")}
    log(f"[{tag}] {cfg.name} full width ({cfg.num_layers} decoder layers), B={B}, "
        f"{S} text positions, bf16 on {card}: flash_attention {counts['flash_attention']} "
        f"launches a forward; ms per forward (median of {FWD_ITERS}, in turns "
        f"{', '.join(turns)}): " + "; ".join(f"{impl} {t[0]:.2f}, {t[1]:.2f}"
                                             for impl, t in ms.items()))
    log(f"[{tag}] host ms to enqueue one forward (median of {FWD_ITERS}, each on a drained "
        "card): " + "; ".join(f"{impl} {t:.2f}" for impl, t in enqueue.items()))
    return counts["flash_attention"]


def phase_forward_encdec(card: str) -> tuple:
    """[forward-encdec]: whisper-tiny at full width and depth (4 encoder and
    4 decoder layers, d=384, 6/6 heads at D=64, vocabulary 51,865; bf16,
    seed 0), B=4, 1500 frames, 448 decoder positions: under ``"flash"`` one
    flash launch a decoder layer (4 a forward; the encoder's bidirectional
    attention and cross-attention take ``_sdpa``), under ``"xla"`` none
    (:func:`_flash_and_xla`).  Returns (the flash launches of one forward,
    the model, the batch)."""
    from repro_torch.models import build_model, make_batch

    cfg = _mm_config(ENCDEC_ARCH)
    model = _init_timed(build_model(cfg), "forward-encdec")
    batch = make_batch(1, cfg, ENC_BATCH, ENC_SEQ, "cuda")
    return _flash_and_xla("forward-encdec", cfg, model, batch, card), model, batch


def _greedy(api, model, tok, state, index: int, n: int) -> tuple:
    """``n`` greedy decode steps from ``tok`` (B, 1) at position ``index``:
    (the tokens (B, n) on the host, each step's ms on the host clock; a step
    ends in its token's copy to the host, so it holds the step's device
    time)."""
    import torch

    out, ms = [], []
    for i in range(n):
        t = time.perf_counter()
        logits, state = api.decode_step(model, tok, state, index + i)
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok.cpu())
        ms.append((time.perf_counter() - t) * 1e3)
    return torch.cat(out, 1), ms


def _decode_card_vs_cpu(arch: str, tag: str) -> None:
    """The same CPU-drawn float32 weights (full width, ``MM_CPU_DEPTH``
    layers) decode greedily on the CPU and on the card from the same
    inputs, B=2: encdec through ``init_cache`` and ``decode_step`` from one
    token, vlm through ``prefill_multimodal`` (576 image tokens, 8 text)
    and ``decode_step``; equal tokens, and the first step's logits within
    1e-3."""
    import torch
    from repro_torch.models import build_model, encdec, make_batch, vlm

    cfg = _mm_config(arch, MM_CPU_DEPTH, param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg)
    model = api.init(0, device="cpu")
    batch = make_batch(3, cfg, 2, 8, "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        model = model.to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            if arch == ENCDEC_ARCH:
                state = encdec.init_cache(model, b["frames"], cfg, 2, MM_CPU_NEW)
                first, state = api.decode_step(model, b["tokens"][:, :1], state, 0)
                index = 1
            else:
                first, state, index = vlm.prefill_multimodal(
                    model, b["tokens"], b["patches"], cfg, max_seq=cfg.vlm.num_patches + 8
                    + MM_CPU_NEW)
            toks, _ = _greedy(api, model, first.argmax(-1, keepdim=True), state, index,
                              MM_CPU_NEW - 1)
        out[dev] = (torch.cat([first.argmax(-1, keepdim=True).cpu(), toks], 1),
                    first.float().cpu())
    diff = _max_err(out["cuda"][1], out["cpu"][1])
    same = torch.equal(out["cuda"][0], out["cpu"][0])
    log(f"[{tag}] card vs CPU, {arch} full width, {MM_CPU_DEPTH} layers, f32, B=2: "
        f"{MM_CPU_NEW} greedy tokens equal {same}; the first step's logits max abs diff "
        f"{diff:.3e} (bound {F32_LOGIT_TOL})")
    if not same or diff > F32_LOGIT_TOL:
        raise AssertionError(f"[{tag}] card and CPU decodes differ: "
                             f"{out['cuda'][0].tolist()} vs {out['cpu'][0].tolist()}, "
                             f"logits {diff}")
    del model
    torch.cuda.empty_cache()


def phase_decode_encdec(card: str, model, batch) -> None:
    """[decode-encdec]: on [forward-encdec]'s weights and frames, B=4:
    ``encdec.init_cache`` (the encoder once, every decoder layer's cross K/V
    in bf16), then ``MM_NEW`` greedy ``decode_step`` calls, the counts
    zeroed just before and read just after (no kernel: cached attention);
    ms for the cache, per decode step (host clock, median) and one step's
    launches under ``torch.profiler``; then the card-vs-CPU pair."""
    import torch
    from repro_torch.models import build_model, encdec

    tag = "decode-encdec"
    cfg = _mm_config(ENCDEC_ARCH)
    api = build_model(cfg)
    B = batch["tokens"].shape[0]
    with torch.no_grad():
        torch_sync()
        _zero_counts()
        t0 = time.perf_counter()
        cache = encdec.init_cache(model, batch["frames"], cfg, B, MM_NEW)
        torch_sync()
        cache_ms = (time.perf_counter() - t0) * 1e3
        toks, ms = _greedy(api, model, batch["tokens"][:, :1], cache, 0, MM_NEW)
        launched = {k: v for k, v in _counts().items() if v}
        tok = toks[:, -1:].cuda()
        prof = _profile_model_step(lambda: api.decode_step(model, tok, cache, MM_NEW - 1))
    log(f"[{tag}] {cfg.name} full width bf16 on {card}, B={B}: init_cache {cache_ms:.2f} ms "
        f"(cross K/V {tuple(cache.cross_k.shape)} {cache.cross_k.dtype}); {MM_NEW} greedy "
        f"steps, ms per step median {statistics.median(ms):.2f} (first {ms[0]:.2f}), "
        f"{B * MM_NEW / (sum(ms) / 1e3):.1f} tokens/s; kernels launched {launched or 'none'}; "
        f"one step under torch.profiler: {prof['launches']:.0f} launches, device busy "
        f"{prof['busy_ms']:.3f} ms")
    if launched or tuple(toks.shape) != (B, MM_NEW):
        raise AssertionError(f"[{tag}] tokens {tuple(toks.shape)}, kernels {launched}")
    del cache
    _decode_card_vs_cpu(ENCDEC_ARCH, tag)


def _mm_grads_card_vs_cpu(arch: str, tag: str) -> None:
    """The step's gradient (``train_loop._microbatched_grads``: the config's
    4 microbatches under remat "full") of the same CPU-drawn float32
    weights (full width, ``MM_CPU_DEPTH`` layers) and batch on the CPU and
    on the card: the loss within 1e-3, the grad norm within 1e-3 of the
    CPU's and every leaf within 1e-3 of its largest CPU entry; no kernel on
    the card (``"xla"`` attention, no optimizer)."""
    import torch
    from repro_torch.models import build_model, make_batch, param_leaves
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import train_loop as tl

    cfg = _mm_config(arch, MM_CPU_DEPTH, param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg)
    model = api.init(0, device="cpu")
    batch = make_batch(4, cfg, MM_CPU_BATCH, MM_CPU_SEQ, "cpu")
    names = [n for n, _ in param_leaves(model)]
    micro = cfg.parallelism.microbatch

    def grads(batch):
        params = [p for _, p in param_leaves(model)]
        loss, g = tl._microbatched_grads(lambda m, b: api.loss_fn(m, b), model, params, batch,
                                         micro)
        return float(loss), [x.detach().cpu() for x in g]

    t0 = time.perf_counter()
    loss_c, g_c = grads(batch)
    cpu_s = time.perf_counter() - t0
    model = model.to("cuda")
    _zero_counts()
    loss_k, g_k = grads({k: v.cuda() for k, v in batch.items()})
    torch_sync()
    launched = {k: v for k, v in _counts().items() if v}
    n_c, n_k = float(global_norm(g_c)), float(global_norm(g_k))
    worst = max(zip(_leaf_dist(g_k, g_c), names))
    log(f"[{tag}] card vs CPU, {arch} full width, {MM_CPU_DEPTH} layers, f32, batch "
        f"{MM_CPU_BATCH}x{MM_CPU_SEQ}, {micro} microbatches, remat {cfg.parallelism.remat}: "
        f"loss {loss_k:.6f} vs {loss_c:.6f}, grad norm {n_k:.6f} vs {n_c:.6f}; worst leaf (of "
        f"its largest entry) {worst[1]} {worst[0]:.3e}; kernels {launched or 'none'}; CPU "
        f"{cpu_s:.1f} s")
    if (abs(loss_k - loss_c) > 1e-3 or abs(n_k - n_c) > 1e-3 * n_c or worst[0] > 1e-3
            or launched):
        raise AssertionError(f"[{tag}] card and CPU gradients differ: loss {loss_k} vs "
                             f"{loss_c}, norm {n_k} vs {n_c}, worst leaf {worst}, kernels "
                             f"{launched}")
    del model, g_c, g_k
    torch.cuda.empty_cache()


def phase_train_mm(card: str, arch: str, model=None) -> int:
    """[train-encdec] / [train-vlm]: the config's own ZeRO-1 step
    (microbatch 4, remat "full", the f32 wire, ``attention_impl="xla"``)
    at full width, whisper-tiny at full depth and phi-3-vision at
    ``VLM_TRAIN_DEPTH`` of 32 layers (``model``: [forward-vlm]'s first
    layers, so its weights are drawn once), global batch 8 of
    ``MM_TRAIN_SEQ`` tokens with its frames or patches (``make_batch``),
    2 + 5 steps, the counts zeroed just before each step and read just
    after: ``pack_transposed`` once a step and nothing else (flash has no
    backward and the configs train under ``"xla"``); finite losses,
    ms/step and the peak memory; then the card-vs-CPU gradient check.
    Returns ``pack_transposed``'s launches over the 7 steps."""
    import torch
    from repro_torch.models import build_model, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop as tl

    t_phase = time.perf_counter()
    tag = "train-" + ("encdec" if arch == ENCDEC_ARCH else "vlm")
    cfg = _mm_config(arch, VLM_TRAIN_DEPTH if arch == VLM_ARCH else None)
    par = cfg.parallelism
    if (par.remat, par.microbatch, par.zero1, par.grad_compression,
            cfg.attention_impl) != ("full", 4, True, None, "xla"):
        raise AssertionError(f"[{tag}] the config's step changed: {par}, {cfg.attention_impl}")
    api = build_model(cfg)
    seq = MM_TRAIN_SEQ[arch]
    drawn = [make_batch(10 + i, cfg, TRAIN_BATCH, seq, "cpu")
             for i in range(TRAIN_WARM + TRAIN_TIMED)]
    gc.collect()  # an earlier phase's model may wait in a reference cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    losses, norms, ms, total = [], [], [], 0
    with make_dist(device="cuda") as dist:
        t0 = time.perf_counter()
        state = tl.init_state(api, 0, dist, model=model)
        del model
        torch_sync()
        n = sum(p.numel() for p in state.params.parameters())
        log(f"[{tag}] {arch} full width, {cfg.num_layers} of "
            f"{_mm_config(arch).num_layers} decoder layers: {n} parameters (bf16), state "
            f"built in {time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH}x{seq} with "
            + ", ".join(f"{k} {tuple(v.shape)}" for k, v in drawn[0].items()
                        if k not in ("tokens", "targets")))
        step = tl.make_train_step(api, dist, AdamWConfig())
        for i, b in enumerate(drawn):
            batch = tl.local_batch(b, dist)
            torch_sync()
            _zero_counts()
            t = time.perf_counter()
            state, met = step(state, batch)
            loss, norm = float(met.loss), float(met.grad_norm)
            torch_sync()
            ms.append((time.perf_counter() - t) * 1e3)
            c = _counts()
            losses.append(loss)
            norms.append(norm)
            total += c["pack_transposed"]
            others = {k: v for k, v in c.items() if v and k != "pack_transposed"}
            if c["pack_transposed"] != 1 or others:
                raise AssertionError(f"[{tag}] step {i + 1} launched pack_transposed "
                                     f"{c['pack_transposed']} times (expected 1) and {others}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state
    torch.cuda.empty_cache()
    free = torch.cuda.get_device_properties(0).total_memory / 1e9 - peak
    log(f"[{tag}] losses {[round(v, 4) for v in losses]} grad norms "
        f"{[round(v, 4) for v in norms]}; pack_transposed once on every step")
    log(f"[{tag}] {arch} full width, {cfg.num_layers} decoder layers, batch "
        f"{TRAIN_BATCH}x{seq} on {card}: ms/step {[round(v, 1) for v in ms]} (median of the "
        f"{TRAIN_TIMED} after {TRAIN_WARM} warm {statistics.median(ms[TRAIN_WARM:]):.1f}); "
        f"peak {peak:.2f} GB ({resident:.2f} GB resident before the state; {free:.1f} GB of "
        f"the card left)")
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"[{tag}] non-finite losses {losses} or grad norms {norms}")
    _mm_grads_card_vs_cpu(arch, tag)
    log(f"[{tag}] phase wall {time.perf_counter() - t_phase:.1f} s")
    return total


def phase_forward_vlm(card: str) -> tuple:
    """[forward-vlm]: phi-3-vision-4.2b at full width and depth (32 layers,
    d=3072, 32/32 heads at D=96, vocabulary 32,064, the projector from
    1024-wide patches; bf16, seed 0), B=4, 576 patches and 1472 text
    tokens: under ``"flash"`` 32 launches a forward over 2048 positions,
    under ``"xla"`` none (:func:`_flash_and_xla`).  Returns (the flash
    launches of one forward, the model)."""
    from repro_torch.models import build_model, make_batch

    cfg = _mm_config(VLM_ARCH)
    model = _init_timed(build_model(cfg), "forward-vlm")
    batch = make_batch(1, cfg, VLM_BATCH, VLM_TEXT, "cuda")
    return _flash_and_xla("forward-vlm", cfg, model, batch, card), model


def phase_serve_vlm(card: str, model) -> None:
    """[serve-vlm]: on [forward-vlm]'s weights, B=4: ``prefill_multimodal``
    (576 image tokens and a 64-token prompt into a fresh cache) and
    ``MM_NEW`` greedy tokens through ``decode_step``; then the static engine
    on text-only requests (``ServeEngine(max_batch=8, max_seq=320)``, 6
    greedy and 2 sampled, prompts 32-256, 32 new tokens), as the reference
    serves the family; the counts zeroed just before each and read just
    after (no kernel: cached attention); ms per prefill and decode step,
    tokens/s; then the card-vs-CPU pair."""
    import torch
    from repro_torch.models import build_model, make_batch, vlm
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    tag = "serve-vlm"
    cfg = _mm_config(VLM_ARCH)
    api = build_model(cfg)
    b = make_batch(2, cfg, VLM_BATCH, VLM_PROMPT, "cuda")
    n = cfg.vlm.num_patches + VLM_PROMPT
    with torch.no_grad():
        torch_sync()
        _zero_counts()
        t0 = time.perf_counter()
        logits, cache, index = vlm.prefill_multimodal(model, b["tokens"], b["patches"], cfg,
                                                      max_seq=n + MM_NEW)
        tok = logits.argmax(-1, keepdim=True)
        torch_sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks, ms = _greedy(api, model, tok, cache, index, MM_NEW - 1)
        launched = {k: v for k, v in _counts().items() if v}
    del cache
    wall = (prefill_ms + sum(ms)) / 1e3
    log(f"[{tag}] {cfg.name} full width ({cfg.num_layers} layers) bf16 on {card}, B="
        f"{VLM_BATCH}: prefill_multimodal of {n} positions {prefill_ms:.1f} ms, then "
        f"{MM_NEW - 1} greedy steps at ms per step median {statistics.median(ms):.2f}; "
        f"{VLM_BATCH * MM_NEW / wall:.1f} generated tokens/s; kernels launched "
        f"{launched or 'none'}")
    if launched or index != n or tuple(toks.shape) != (VLM_BATCH, MM_NEW - 1):
        raise AssertionError(f"[{tag}] index {index} (want {n}), tokens {tuple(toks.shape)}, "
                             f"kernels {launched}")
    reqs = _serve_r_requests(cfg)
    eng = ServeEngine(api, model, seed=0, **SERVE_R_ENGINE)
    timer = _StepTimer(drain=False)
    eng.step_hook = timer
    _zero_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch_sync()
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in _counts().items() if v}
    new = sum(len(r.out_tokens) for r in reqs)
    pre, dec = timer.medians("prefill"), timer.medians("decode")
    log(f"[{tag}] static engine, text only: {len(reqs)} requests (prompts "
        f"{sorted(len(r.prompt) for r in reqs)}, 2 sampled), {new} tokens in {wall:.2f} s "
        f"({new / wall:.1f} generated tok/s); stats {eng.stats}; per prefill step (one "
        f"position of {len(reqs)} sequences) stream span {pre['event_span_ms']:.2f} ms, "
        f"enqueue {pre['enqueue_ms']:.2f} ms; per decode step {dec['event_span_ms']:.2f} ms, "
        f"enqueue {dec['enqueue_ms']:.2f} ms; kernels launched {launched or 'none'}")
    if launched or any(len(r.out_tokens) != SERVE_R_NEW or not r.done for r in reqs):
        raise AssertionError(f"[{tag}] requests unfinished "
                             f"{[len(r.out_tokens) for r in reqs]} or kernels {launched}")
    del eng
    _decode_card_vs_cpu(VLM_ARCH, tag)
    log(f"[{tag}] phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_mm(card: str) -> dict:
    """Both families' phases in turn: [forward-encdec], [decode-encdec],
    [train-encdec], [forward-vlm], [serve-vlm], then [train-vlm] on the
    forward's first layers (the whole model freed first).  Returns each
    kernel's launches by phase."""
    import torch
    from repro_torch.models import transformer

    flash, model, batch = phase_forward_encdec(card)
    phase_decode_encdec(card, model, batch)
    del model, batch
    torch.cuda.empty_cache()
    by_phase = {"flash_attention": {"forward-encdec": flash},
                "pack_transposed": {"train-encdec": phase_train_mm(card, ENCDEC_ARCH)}}
    by_phase["flash_attention"]["forward-vlm"], model = phase_forward_vlm(card)
    phase_serve_vlm(card, model)
    cfg = _mm_config(VLM_ARCH)
    # [train-vlm]'s weights: the forward's first layers, not a second draw
    _, part = transformer.stage_model(model, cfg, 0, cfg.num_layers // VLM_TRAIN_DEPTH, "cuda")
    del model
    torch.cuda.empty_cache()
    by_phase["pack_transposed"]["train-vlm"] = phase_train_mm(card, VLM_ARCH, part)
    return by_phase


# ---------------------------------------------------------------------------
# [dryrun]: the dry run's production cell, and its prediction of [main]'s
# cell beside the card
# ---------------------------------------------------------------------------
#: the production cell the full script lowers (arch, shape, mesh)
DRYRUN_CELL = (ARCH, "train_4k", "pod1")
#: seconds the dry run's subprocesses may take
DRYRUN_TIMEOUT = 150
#: [main]'s cell on the card: 1 warm step, then the timed ones
DRYRUN_WARM, DRYRUN_TIMED = 1, 2

_LOWER_SCRIPT = r"""
import dataclasses, json, sys
import torch
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import Mesh
from repro_torch.launch import dryrun

world, cells = int(sys.argv[1]), json.loads(sys.argv[2])
dryrun.fake_world(world)
out = []
for c in cells:
    cfg = configs.smoke_config(c["arch"]) if c.get("smoke") else configs.get_config(c["arch"])
    cfg = dataclasses.replace(cfg, **c.get("cfg", {}), parallelism=dataclasses.replace(
        cfg.parallelism, **c.get("par", {})))
    mesh = Mesh(("data", "model"), tuple(c["mesh"]), torch.device("cpu"))
    out.append(dryrun.lower(cfg, ShapeConfig("cell", c["seq"], c["batch"], "train"), mesh))
print(json.dumps(out))
"""


def _json_tail(text: str):
    """The last line of ``text`` that parses as JSON."""
    for line in reversed(text.splitlines()):
        if line.startswith(("{", "[")):
            return json.loads(line)
    raise ValueError(f"no JSON line in {text[-2000:]!r}")


def _lower_cells(world: int, cells: list, timeout: float = DRYRUN_TIMEOUT):
    """``launch.dryrun.lower`` of each cell (a dict: ``arch``, ``mesh``
    (data, model), ``seq``, ``batch`` and the config's ``cfg``/``par``
    changes, ``smoke``) as rank 0 of a fake world of ``world`` ranks, in a
    subprocess (a process holds one default process group).  Returns a
    ``subprocess.Popen``; :func:`_lowered` reads its records."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen([sys.executable, "-c", _LOWER_SCRIPT, str(world), json.dumps(cells)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _lowered(proc, timeout: float = DRYRUN_TIMEOUT):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"dry run exited {proc.returncode}: {err[-3000:]}")
    return _json_tail(out)


def _gb(n: float) -> str:
    return f"{n / 1e9:.3f} GB"


def _main_cell_on_card() -> dict:
    """[main]'s cell (``ARCH`` at full width, batch 8 x 128, the config's
    microbatch 4, the f32 wire, seed 0) on the card: the live train state's
    bytes (``dryrun.state_bytes``), then ``DRYRUN_WARM`` + ``DRYRUN_TIMED``
    steps with the peak memory of the timed ones."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop as tl

    api = build_model(configs.get_config(ARCH))
    pipe = DataPipeline(SyntheticSource(api.cfg.vocab_size, seed=0), global_batch=8,
                        seq_len=128)
    ms = []
    with make_dist(device="cuda") as dist:
        state = tl.init_state(api, 0, dist)
        live = dryrun.state_bytes(state)
        step = tl.make_train_step(api, dist, AdamWConfig())
        for i in range(DRYRUN_WARM + DRYRUN_TIMED):
            batch = tl.local_batch(next(pipe), dist)
            if i == DRYRUN_WARM:
                torch.cuda.reset_peak_memory_stats()
            (state, met), t = _timed(lambda: step(state, batch), True, dist.device)
            if not math.isfinite(float(met.loss)):
                raise AssertionError(f"[dryrun] non-finite loss {float(met.loss)}")
            ms.append(t)
        peak = torch.cuda.max_memory_allocated()
        del state
    pipe.close()
    torch.cuda.empty_cache()
    return {"live_bytes": live, "peak_bytes": peak, "ms": ms}


def _dryrun_start() -> tuple:
    """Start [dryrun]'s two CPU subprocesses (:func:`phase_dryrun` reads
    them): ``python -m repro_torch.launch.dryrun`` on ``DRYRUN_CELL``, and
    the module's lowering of [main]'s own cell on a 1 x 1 mesh."""
    arch, shape, mesh = DRYRUN_CELL
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cell = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                             "--shape", shape, "--mesh", mesh], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return cell, _lower_cells(1, [dict(arch=ARCH, mesh=[1, 1], seq=128, batch=8)])


def phase_dryrun(card: str, started: tuple) -> None:
    """[dryrun]: the record of ``python -m repro_torch.launch.dryrun`` on
    the production cell ``DRYRUN_CELL`` (rank 0 of a fake world of 256 on
    the CPU; started with :func:`_dryrun_start` after the build, so it runs
    beside the card's phases), printed; and the module's lowering of
    [main]'s own cell beside that cell run on the card.  Gate: the
    predicted argument bytes equal the live train state's bytes.  Printed,
    not gated: the predicted peak over ``max_memory_allocated``, and the
    roofline's ``step_time_s`` (H100 datasheet constants) over the measured
    ms/step."""
    t0 = time.perf_counter()
    cell, main_cell = started
    arch, shape, mesh = DRYRUN_CELL
    try:
        card_run = _main_cell_on_card()
        pred = _lowered(main_cell)[0]
        rec = _lowered(cell)
    finally:
        for proc in (cell, main_cell):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rec.get("status") != "ok":
        raise AssertionError(f"[dryrun] {arch} {shape} {mesh}: {rec}")
    mm, rf = rec["memory"], rec["roofline"]
    log(f"[dryrun] {arch} {shape} {mesh} (rank 0 of {rec['chips']}, fake tensors, "
        f"{rec['mode']}, tp {rec['tp']}, fsdp {rec['fsdp']}): argument {_gb(mm['argument_bytes'])}, "
        f"temp {_gb(mm['temp_bytes'])}, peak {_gb(mm['peak_estimate_bytes'])}; roofline on the "
        f"H100 datasheet: compute {rf['compute_s'] * 1e3:.2f} ms, memory "
        f"{rf['memory_s'] * 1e3:.2f} ms, collective {rf['collective_s'] * 1e3:.2f} ms -> "
        f"{rf['bottleneck']} (useful FLOPs {rf['useful_flops_fraction']:.3f}, MFU bound "
        f"{rf['mfu_bound']:.4f}); collectives {rec['collectives']['bytes']} bytes, "
        f"{rec['collectives']['count']} calls; {rec['accounting']['method']}; "
        f"run {rec['run_s']} s, wall {rec['wall_s']} s")
    log(f"[dryrun] record: {json.dumps(rec)}")
    live, peak = card_run["live_bytes"], card_run["peak_bytes"]
    ms = statistics.median(card_run["ms"][DRYRUN_WARM:])
    step_s = pred["roofline"]["step_time_s"]
    log(f"[dryrun] [main]'s cell ({ARCH}, 1 x 1, batch 8 x 128, microbatch 4, f32 wire) "
        f"predicted: argument {pred['memory']['argument_bytes']} B, peak "
        f"{_gb(pred['memory']['peak_estimate_bytes'])}, roofline step {step_s * 1e3:.3f} ms "
        f"({pred['roofline']['bottleneck']}); on {card}: live state {live} B, "
        f"max_memory_allocated {_gb(peak)}, {[round(t, 1) for t in card_run['ms']]} ms/step "
        f"(median of the {DRYRUN_TIMED} after {DRYRUN_WARM} warm {ms:.1f}); predicted peak "
        f"over measured {pred['memory']['peak_estimate_bytes'] / peak:.3f}; roofline step "
        f"over measured step {step_s * 1e3 / ms:.4f}; phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    if pred["memory"]["argument_bytes"] != live:
        raise AssertionError(f"[dryrun] predicted argument bytes "
                             f"{pred['memory']['argument_bytes']} != the live state's {live}")


# ---------------------------------------------------------------------------
# [tp4]: the dense family's tensor parallelism and FSDP on four cards
# ---------------------------------------------------------------------------
TP4 = 4
#: leg (a): float32, 2 of 28 layers, batch 8 x 256, the config's microbatch 4
TP4_F32_DEPTH, TP4_F32_BATCH, TP4_F32_SEQ, TP4_F32_STEPS = 2, 8, 256, 3
TP4_LOSS_RTOL, TP4_NORM_RTOL = 1e-5, 1e-4
#: leg (b): bf16, full depth, batch 8 x 1024, 2 warm + 3 timed steps
TP4_WARM, TP4_TIMED = 2, 3
#: leg (c): the TP forward under flash, 7 layers, B=4, S=2048
TP4_FWD_DEPTH = 7
#: leg (c)'s bf16 tolerance, stated before the first run: every logit of the
#: TP forward within this share of the one-card forward's largest logit (the
#: row-parallel products reach the residual through a bf16 all-reduce of
#: four partial sums, one more rounding per block than one card's)
TP4_LOGIT_TOL = 0.05
#: seconds the four ranks may take
TP4_TIMEOUT = 420


def _tp4_cfg(device: str, depth: int, grad_sync: str, f32: bool = False, zero1: bool = True,
             **change):
    """gemma-7b at full width (the smoke config with ``tp_size=4`` on the
    CPU, so its four heads split), ``depth`` layers, ``grad_sync``, the
    ABI step's ZeRO-1 (``zero1``) or per-leaf layout."""
    import dataclasses

    from repro_torch import configs

    on_card = device != "cpu"
    cfg = configs.get_config(GEMMA_ARCH) if on_card else configs.smoke_config(GEMMA_ARCH)
    par = dict(grad_sync=grad_sync, zero1=zero1)
    if not on_card:
        par.update(tp_size=TP4, microbatch=4, remat="full")
    cfg = dataclasses.replace(cfg, num_layers=depth, **change, parallelism=dataclasses.replace(
        cfg.parallelism, **par))
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    return cfg


def _tp4_batches(cfg, B: int, S: int, n: int) -> list:
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource

    pipe = DataPipeline(SyntheticSource(cfg.vocab_size, seed=0), global_batch=B, seq_len=S)
    out = [next(pipe) for _ in range(n)]
    pipe.close()
    return out


def _tp4_steps(api, dist, batches, on_card: bool, dev, counted: bool = False,
               model=None) -> dict:
    """``init_state`` (this rank's block, drawn from seed 0, or ``model``
    as it stands) and a step per batch: losses, grad norms, ms,
    ``pack_transposed`` launches a step (with ``model``, every kernel's),
    the peak memory after the first ``TP4_WARM`` steps, the model's bytes
    on the card (its block, read around the draw), the bytes its held
    specs give (each leaf's whole bytes over the ranks of each axis that
    splits it) and, with ``counted``,
    the collectives of one more step by op (``hlo_analysis.StepCounter``)."""
    import dataclasses

    import torch
    from repro_torch.launch.hlo_analysis import StepCounter
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import train_loop as tl

    given = model is not None
    before = torch.cuda.memory_allocated(dev) if on_card else 0
    if not given:
        model = api.init(0, dev, **tl.model_part(api, dist))
    drawn = 0 if given else (torch.cuda.memory_allocated(dev) if on_card else 0) - before
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    whole = sum(math.prod(model.full_shapes[n]) * p.element_size()
                for n, p in model.named_parameters())
    held_specs = getattr(model, "held", {})
    expect = sum(math.prod(model.full_shapes[n]) * p.element_size()
                 // (model.part.tp_size if "tp" in held_specs.get(n, ()) else 1)
                 // (model.part.fsdp_size if "fsdp" in held_specs.get(n, ()) else 1)
                 for n, p in model.named_parameters())
    state = tl.init_state(api, 0, dist, model=model)
    step = tl.make_train_step(api, dist, AdamWConfig())
    rec = dict(losses=[], grad_norms=[], ms=[], packs=[], held_bytes=held, drawn_bytes=drawn,
               whole_bytes=whole, expect_bytes=expect,
               part=list(dataclasses.astuple(model.part)))
    for i, b in enumerate(batches):
        batch = tl.local_batch(b, dist)
        if i == TP4_WARM and on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        (state, met), t = _timed(lambda: step(state, batch), on_card, dev)
        rec["losses"].append(float(met.loss))
        rec["grad_norms"].append(float(met.grad_norm))
        rec["ms"].append(t)
        rec["packs"].append(_counts()["pack_transposed"])
        if given:
            rec.setdefault("launches", []).append(_counts())
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0
    if counted:
        with StepCounter() as sc:
            state, _ = step(state, tl.local_batch(batches[-1], dist))
        rec["collectives"] = {"bytes": dict(sc.bytes_by_op), "count": dict(sc.count_by_op)}
    del state, model, step
    if on_card:
        torch.cuda.empty_cache()
    return rec


def _tp4_rank(rank: int, world: int, init_method: str, out_dir: str,
              device: str = "cuda") -> None:
    """One rank of [tp4]: gemma-7b at full width (``device="cpu"``: the
    smoke config on gloo), each rank holding its block (4 of 16 heads, a
    quarter of the FFN and of the vocabulary; under FSDP half of that
    again).  One world; mesh (1, 4): (c) the TP forward under ``"flash"`` at
    ``TP4_FWD_DEPTH`` layers, B=4, S=2048 (the logits gathered; flash's
    launches; the last call held to ``attention_ref``); (a) the ABI ZeRO-1
    step in float32 at ``TP4_F32_DEPTH`` layers, ``TP4_F32_STEPS`` steps;
    (b) the ABI step at full depth in bf16, batch 8 x 1024, the config's
    microbatch 4 and remat ``"full"``.  Mesh (2, 2) on the same world
    (``make_dist(mesh=...)``): (a) and (b) under ``gspmd`` with FSDP.  Each
    leg's records are saved as it ends.  Rank 0 then runs the one-card references on its
    card with no process group: (a)'s unsharded per-leaf step on the whole
    model, and (c)'s whole-model forward, held to the TP logits."""
    # the full-depth bf16 steps come within a few GB of the card: no
    # fragmentation of the caching allocator's segments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch import configs
    from repro_torch.core import Mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device != "cpu"
    # four ranks share the host: one thread a torch op (the weight draw
    # still runs its chunks on a thread pool)
    torch.set_num_threads(1)
    dev = torch.device(f"cuda:{rank}") if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
    B, S = (TRAIN_BATCH, TRAIN_SEQ) if on_card else (8, 32)
    B32, S32 = (TP4_F32_BATCH, TP4_F32_SEQ) if on_card else (8, 32)
    FB, FS = (FWD_BATCH, FWD_SEQ) if on_card else (4, 32)
    full_depth = configs.get_config(GEMMA_ARCH).num_layers if on_card else 2
    f32_batches = _tp4_batches(_tp4_cfg(device, 1, "abi"), B32, S32, TP4_F32_STEPS)
    bf_batches = _tp4_batches(_tp4_cfg(device, 1, "abi"), B, S, TP4_WARM + TP4_TIMED)
    gen = torch.Generator().manual_seed(1)
    fwd_cfg = _tp4_cfg(device, TP4_FWD_DEPTH, "abi", attention_impl="flash")
    tokens = torch.randint(0, fwd_cfg.vocab_size, (FB, FS), generator=gen)
    rec: dict = {}
    t0 = time.perf_counter()

    def done(leg: str) -> None:
        """Save what is measured so far and say so (a leg that hangs or
        fails leaves the earlier legs' records behind)."""
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
        log(f"[tp4] rank {rank}: {leg} done at {time.perf_counter() - t0:.1f} s")

    # one world: mesh (1, 4), and the (2, 2) mesh's context built on it
    with make_dist(device=str(dev), model_axis=TP4, world_size=world, rank=rank,
                   init_method=f"file://{Path(out_dir) / 'world'}") as dist4:
        # (c) the TP forward under flash
        api = build_model(fwd_cfg)
        model = api.init(0, dev, **tl.model_part(api, dist4))
        with torch.no_grad(), _FlashSpy() as spy:
            _zero_counts()
            logits = api.forward(model, {"tokens": tokens.to(dev)}, dist4)
            if on_card:
                torch_sync()
            rec["fwd_flash"] = _counts()["flash_attention"]
            if on_card:
                spy.check("tp4")
            rec["fwd_heads"] = [int(fwd_cfg.num_heads // TP4), int(fwd_cfg.num_kv_heads // TP4)]
            ms = []
            for _ in range(3):
                _, t = _timed(lambda: api.forward(model, {"tokens": tokens.to(dev)}, dist4),
                              on_card, dev)
                ms.append(t)
        rec["fwd_ms"] = ms
        if rank == 0:
            tp_logits = logits.cpu()
        del model, logits
        if on_card:
            torch.cuda.empty_cache()
        done("(c) the TP forward")
        mesh22 = Mesh(("data", "model"), (2, 2), dist4.device)
        for mode in ("abi", "gspmd"):
            ctx = dist4 if mode == "abi" else make_dist(mesh=mesh22)
            try:
                # (a) float32, shallow
                api = build_model(_tp4_cfg(device, TP4_F32_DEPTH, mode, f32=True))
                rec[f"f32_{mode}"] = _tp4_steps(api, ctx, f32_batches, on_card, dev)
                done(f"(a) {mode}")
                # (b) bf16, full depth; the ABI step in its per-leaf layout (its
                # ZeRO-1 layout at dp=1 keeps f32 flat copies of the parameters,
                # the gradient and AdamW's update: at 28 layers more than a card
                # holds)
                api = build_model(_tp4_cfg(device, full_depth, mode, zero1=mode != "abi"))
                rec[f"bf16_{mode}"] = _tp4_steps(api, ctx, bf_batches, on_card, dev,
                                                 counted=True)
                done(f"(b) {mode}")
            finally:
                if ctx is not dist4:
                    ctx.shutdown()
    if rank == 0:
        # the one-card references, no process group
        api = build_model(_tp4_cfg(device, TP4_F32_DEPTH, "gspmd", f32=True))
        model = api.init(0, dev)
        state = tl.TrainState(model, adamw.init_tree(tl.param_leaves(model)),
                              torch.zeros((), dtype=torch.int32, device=dev))
        step = tl.make_train_step(api, None, AdamWConfig())
        ref = dict(losses=[], grad_norms=[])
        for b in f32_batches:
            state, met = step(state, {k: torch.as_tensor(v).to(dev) for k, v in b.items()})
            ref["losses"].append(float(met.loss))
            ref["grad_norms"].append(float(met.grad_norm))
        rec["f32_one_card"] = ref
        del state, model, step
        if on_card:
            torch.cuda.empty_cache()
        api = build_model(fwd_cfg)
        model = api.init(0, dev)
        with torch.no_grad():
            want = api.forward(model, {"tokens": tokens.to(dev)})
            got = tp_logits.to(dev)
            diff = (got.float() - want.float()).abs()
            rec["fwd_vs_one_card"] = dict(max_abs=float(diff.max()),
                                          # a strided sample: a median of 2e9 elements
                                          median_abs=float(diff.flatten()[::101].median()),
                                          scale=float(want.float().abs().max()),
                                          argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                                             .float().mean()),
                                          finite=bool(torch.isfinite(got).all()))
        del model, want, got, diff
    done("the one-card references" if rank == 0 else "all legs")


def _tp4_predictions(device: str):
    """The dry run's lowering of [tp4]'s leg (b) cells on a fake world of
    four: the ABI step at (1, 4) and ``gspmd`` with FSDP at (2, 2)."""
    on_card = device != "cpu"
    cells = []
    for mode, mesh in (("abi", [1, TP4]), ("gspmd", [2, 2])):
        par = dict(grad_sync=mode, zero1=mode != "abi")
        c = dict(arch=GEMMA_ARCH, mesh=mesh, seq=TRAIN_SEQ if on_card else 32,
                 batch=TRAIN_BATCH if on_card else 8, par=par)
        if not on_card:
            c.update(smoke=True, par=dict(par, tp_size=TP4, microbatch=4, remat="full"))
        cells.append(c)
    # the ABI step's ZeRO-1 layout at full depth, which no card holds (a record)
    cells.append(dict(cells[0], par=dict(cells[0]["par"], zero1=True)))
    return _lower_cells(TP4, cells)


def phase_tp4(card: str, device: str = "cuda", out_dir: Path = HERE / "build" / "tp4") -> dict:
    """[tp4] (four cards, NCCL; ``device="cpu"``: the smoke config on gloo,
    a rehearsal): :func:`_tp4_rank` on four spawned ranks, with the dry
    run's prediction of leg (b) computed meanwhile.  Gates: (a) each mode's
    losses within ``TP4_LOSS_RTOL`` and grad norms within ``TP4_NORM_RTOL``
    (relative) of one card's unsharded step on the same weights, on every
    rank, and ``pack_transposed`` once a step per rank under the ABI step
    (0 under ``gspmd``; 0 on the CPU); (b) finite losses, equal on every
    rank; (c) ``TP4_FWD_DEPTH`` flash launches at 4 local heads per rank
    (0 on the CPU), the last call held to ``attention_ref``, and every
    logit within ``TP4_LOGIT_TOL`` of the one-card forward's largest; (d)
    each rank's model on the card is its block: the bytes the draw left
    on the card are the held parameters' (within the allocator's rounding),
    a quarter of the whole model's at both meshes (the norms, held whole,
    within 1%).  Returns the launches by kernel on rank 0."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    on_card = device != "cpu"
    preds = _tp4_predictions(device)
    try:
        try:
            ranks = _spawn_ranks("tp4", _tp4_rank, TP4, out_dir, device, timeout=TP4_TIMEOUT)
        except RuntimeError:
            for r in range(TP4):
                part = out_dir / f"rank{r}.json"
                log(f"[tp4] rank {r}'s records so far: "
                    f"{part.read_text() if part.exists() else 'none'}")
            raise
        pred = dict(zip(("abi", "gspmd", "abi-zero1"), _lowered(preds)))
    finally:
        if preds.poll() is None:
            preds.kill()
            preds.wait()
    r0 = ranks[0]
    where = card if on_card else "gloo"
    ref = r0["f32_one_card"]
    log(f"[tp4] {GEMMA_ARCH} {'full width' if on_card else 'smoke'} on four ranks of {where}: "
        f"(c) TP forward under flash, {TP4_FWD_DEPTH} layers, {r0['fwd_heads'][0]}/"
        f"{r0['fwd_heads'][1]} heads a rank: flash launches per rank "
        f"{[r['fwd_flash'] for r in ranks]}, ms per forward (rank 0) "
        f"{[round(t, 1) for t in r0['fwd_ms']]}; against one card's forward: "
        f"{json.dumps(r0['fwd_vs_one_card'])} (tolerance {TP4_LOGIT_TOL} of the largest logit)")
    log(f"[tp4] (a) f32, {TP4_F32_DEPTH} layers, one card's unsharded step: losses "
        f"{ref['losses']} grad norms {ref['grad_norms']}")
    rel = lambda xs, ys: max(abs(x - y) / abs(y) for x, y in zip(xs, ys))  # noqa: E731
    bad = []
    for mode in ("abi", "gspmd"):
        a = [r[f"f32_{mode}"] for r in ranks]
        lrel = max(rel(x["losses"], ref["losses"]) for x in a)
        nrel = max(rel(x["grad_norms"], ref["grad_norms"]) for x in a)
        log(f"[tp4] (a) {mode} at {'(1, 4)' if mode == 'abi' else '(2, 2), FSDP'}: losses "
            f"{a[0]['losses']} grad norms {a[0]['grad_norms']}; largest relative difference "
            f"to one card: losses {lrel:.3e} (bound {TP4_LOSS_RTOL}), grad norms {nrel:.3e} "
            f"(bound {TP4_NORM_RTOL}); pack_transposed a step per rank "
            f"{[x['packs'] for x in a]}; parts {[x['part'] for x in a]}")
        want_pack = [1 if (on_card and mode == "abi") else 0] * TP4_F32_STEPS
        if lrel > TP4_LOSS_RTOL or nrel > TP4_NORM_RTOL or any(x["packs"] != want_pack
                                                              for x in a):
            bad.append(f"(a) {mode}: losses {lrel}, grad norms {nrel}, packs "
                       f"{[x['packs'] for x in a]}")
        b = [r[f"bf16_{mode}"] for r in ranks]
        p = pred[mode]
        ms = statistics.median(b[0]["ms"][TP4_WARM:])
        log(f"[tp4] (b) {mode}{' (per-leaf layout)' if mode == 'abi' else ''} bf16 full depth, "
            f"batch {TRAIN_BATCH if on_card else 8}x"
            f"{TRAIN_SEQ if on_card else 32}: losses {[round(v, 4) for v in b[0]['losses']]} "
            f"grad norms {[round(v, 4) for v in b[0]['grad_norms']]}; ms/step per rank "
            f"{[[round(t, 1) for t in x['ms']] for x in b]} (rank 0's median of the "
            f"{TP4_TIMED} after {TP4_WARM} warm {ms:.1f}); peak GB per card "
            f"{[round(x['peak_gb'], 2) for x in b]}; pack_transposed a step "
            f"{[x['packs'] for x in b]}; collectives a step (rank 0) "
            f"{b[0]['collectives']}")
        log(f"[tp4] (b) {mode} predicted by the dry run (fake world of 4): argument "
            f"{_gb(p['memory']['argument_bytes'])}, peak {_gb(p['memory']['peak_estimate_bytes'])},"
            f" collectives {p['collectives']['bytes']} bytes, {p['collectives']['count']} calls; "
            f"roofline step {p['roofline']['step_time_s'] * 1e3:.2f} ms "
            f"({p['roofline']['bottleneck']}); measured peak "
            f"{b[0]['peak_gb']:.2f} GB, {ms:.1f} ms/step")
        if mode == "abi":
            z = pred["abi-zero1"]["memory"]
            log(f"[tp4] (b) abi's ZeRO-1 layout at (1, 4), not run (its f32 flat copies exceed a "
                f"card): the dry run predicts argument {_gb(z['argument_bytes'])}, peak "
                f"{_gb(z['peak_estimate_bytes'])}")
        log(f"[tp4] (d) {mode}: the model's bytes on each card {[x['drawn_bytes'] for x in b]}, "
            f"its held parameters' {[x['held_bytes'] for x in b]}, the whole model's "
            f"{b[0]['whole_bytes']}")
        if any(x["losses"] != b[0]["losses"] or not all(math.isfinite(v) for v in x["losses"])
               for x in b):
            bad.append(f"(b) {mode}: losses {[x['losses'] for x in b]}")
        for x in b:
            quarter = x["held_bytes"] <= x["whole_bytes"] / TP4 * 1.01
            on_dev = not on_card or x["held_bytes"] <= x["drawn_bytes"] <= x["held_bytes"] * 1.01
            if not (quarter and on_dev):
                bad.append(f"(d) {mode}: {x['drawn_bytes']} bytes on the card for "
                           f"{x['held_bytes']} held of {x['whole_bytes']}")
    fwd = r0["fwd_vs_one_card"]
    want_flash = TP4_FWD_DEPTH if on_card else 0
    if (any(r["fwd_flash"] != want_flash for r in ranks) or not fwd["finite"]
            or fwd["max_abs"] > TP4_LOGIT_TOL * fwd["scale"]):
        bad.append(f"(c) flash launches {[r['fwd_flash'] for r in ranks]}, logits {fwd}")
    log(f"[tp4] phase wall {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("[tp4] " + "; ".join(bad))
    return {"flash_attention": r0["fwd_flash"],
            "pack_transposed": sum(sum(r0[f"{k}_abi"]["packs"]) for k in ("f32", "bf16"))}


# ---------------------------------------------------------------------------
# [moetp4]: the moe family on the model axis, four cards
# ---------------------------------------------------------------------------
MOETP4 = 4
GROK_ARCH = "grok-1-314b"
#: (a) float32 parity: depth, batch, sequence, steps (qwen2-moe-a2.7b)
MOETP4_F32_DEPTH, MOETP4_F32_BATCH, MOETP4_F32_SEQ, MOETP4_F32_STEPS = 2, 8, 256, 3
#: (b) bf16 at the deepest depth a card holds: about 27 bytes a held
#: parameter ([tp4]'s 57.82 GB for 2.13 B), 0.151 B a layer and 0.156 B of
#: vocabulary a card: 12 layers about 53 GB, 24 about 102 GB
MOETP4_DEPTH = 12
#: (c) the forward under flash: the config's 24 layers
MOETP4_FWD_DEPTH = 24
#: (c) and (d): the float32 forward's batch and sequence, and the split
#: decode's prompt, batch and steps, at 2 layers
MOETP4_F32_FWD = (1, 2048)
MOETP4_DECODE = (2, 64, 8)
#: (e) grok-1-314b at 1 of 64 layers: the float32 step's batch and sequence
#: (one microbatch), the bf16 step's microbatch (its config's 16 exceeds a
#: data-parallel rank's 4 rows), the flash forward's batch
GROK_DEPTH = 1
GROK_F32_BATCH, GROK_F32_SEQ = 2, 256
GROK_BF16_MICRO = 4
GROK_FWD_BATCH = 2
#: capacity factors at which nothing drops (C >= every token: E / k)
NO_DROP = {MOE_ARCH: 16.0, GROK_ARCH: 4.0}
MOETP4_TIMEOUT = 780


def _moetp4_cfg(arch: str, device: str, depth: int, grad_sync: str, f32: bool = False,
                zero1: bool = True, parity: bool = False, **par):
    """``arch`` at full width (the smoke config with ``tp_size=4`` on the
    CPU, so its heads split), ``depth`` layers, ``grad_sync``; ``parity``:
    float32 at a capacity where nothing drops, and qwen2-moe's aux weight 0
    (EP's aux loss is the mean of its ranks' slices', another function
    than one card's)."""
    import dataclasses

    from repro_torch import configs

    on_card = device != "cpu"
    cfg = configs.get_config(arch) if on_card else configs.smoke_config(arch)
    p = dict(grad_sync=grad_sync, zero1=zero1, **par)
    if not on_card:
        p = dict(dict(tp_size=MOETP4, remat="full",
                      sequence_parallel=cfg.parallelism.sequence_parallel
                      or arch == GROK_ARCH), **p)
        p.setdefault("microbatch", 4)
    cfg = dataclasses.replace(cfg, num_layers=depth, parallelism=dataclasses.replace(
        cfg.parallelism, **p))
    if f32 or parity:
        cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    if parity:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=NO_DROP[arch],
            aux_loss_weight=0.0 if arch == MOE_ARCH else cfg.moe.aux_loss_weight))
    return cfg


def _moetp4_forward(api, model, tokens, dist, on_card: bool, dev, tag: str) -> dict:
    """The forward under flash on this rank's heads: flash's launches, the
    last call held to ``attention_ref``, ms per forward (3 after the
    first)."""
    import torch

    with torch.no_grad(), _FlashSpy() as spy:
        _zero_counts()
        _, t0 = _timed(lambda: api.forward(model, {"tokens": tokens}, dist), on_card, dev)
        launches = _counts()["flash_attention"]
        if on_card:
            spy.check(tag)
        ms = [_timed(lambda: api.forward(model, {"tokens": tokens}, dist), on_card, dev)[1]
              for _ in range(3)]
    return dict(flash=launches, first_ms=t0, ms=ms)


def _moetp4_decode(api, model, tokens, P: int, cfg, dist) -> list:
    """A prefill of ``tokens[:, :P]`` and a decode step for each later
    position, each fed the given token: the logits of each decode step.
    The cache is float32 (``transformer.prefill``'s own is bfloat16, whose
    rounding of a K/V entry summed in another order moves the logits by
    up to 1e-3 at full width): ``prefill``'s body on a float32 cache."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.tensor_parallel import TensorParallel

    B, S = tokens.shape
    with torch.no_grad():
        par = TensorParallel.of(model, cfg, dist)
        cache = T.init_cache(cfg, B, S, dtype=torch.float32, device=tokens.device,
                             model_axis=model.part.tp_size)
        T._run_cached(model, T._embed(model, tokens[:, :P], cfg, par), cache, 0,
                      T._positions(0, P, B, tokens.device), cfg, dist, par)
        idx = P
        out = []
        for i in range(tokens.shape[1] - P):
            logits, cache = api.decode_step(model, tokens[:, P + i:P + i + 1], cache, idx + i,
                                            dist)
            out.append(logits.float())
    return out


def _moetp4_rank(rank: int, world: int, init_method: str, out_dir: str,
                 device: str = "cuda") -> None:
    """One rank of [moetp4] (``device="cpu"``: the smoke configs on gloo).
    One world; mesh (1, 4), and (2, 2) built on it.  qwen2-moe-a2.7b, each
    rank holding its 16 experts and a quarter of the attention heads, the
    shared experts and the vocabulary: (c) the bf16 forward under flash at
    full depth (B=4, S=2048) and a 2-layer float32 forward (logits kept for
    rank 0); (d) the split decode, float32, 2 layers; (a) float32 parity
    steps (the ABI ZeRO-1 step at (1, 4), ``gspmd`` with FSDP at (2, 2));
    (b) bf16 at ``MOETP4_DEPTH`` layers, batch 8 x 1024, 2 + 3 steps in
    both modes (the ABI step in its per-leaf layout).  grok-1-314b at 1 of
    64 layers, each rank holding its ``d_ff`` block of every expert: (e)
    one float32 step at (1, 4) and at (2, 2) under its ``gspmd`` step, the
    bf16 forward under flash at (1, 4) (12/2 heads a rank), and bf16 steps
    at (2, 2) with FSDP.  Rank 0 then runs the one-card references on its
    card with no process group.  Each leg's records are saved as it ends."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch
    from repro_torch.core import Mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device != "cpu"
    torch.set_num_threads(1)
    dev = torch.device(f"cuda:{rank}") if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
    B, S = (TRAIN_BATCH, TRAIN_SEQ) if on_card else (8, 32)
    B32, S32 = (MOETP4_F32_BATCH, MOETP4_F32_SEQ) if on_card else (8, 32)
    FB, FS = (FWD_BATCH, FWD_SEQ) if on_card else (4, 32)
    F32B, F32S = MOETP4_F32_FWD if on_card else (1, 64)
    DB, DP, DN = MOETP4_DECODE if on_card else (2, 16, 4)
    GB, GS = (GROK_F32_BATCH, GROK_F32_SEQ) if on_card else (2, 32)
    full_depth = MOETP4_FWD_DEPTH if on_card else 2
    depth = MOETP4_DEPTH if on_card else 2
    f32_batches = _tp4_batches(_moetp4_cfg(MOE_ARCH, device, 1, "abi"), B32, S32,
                               MOETP4_F32_STEPS)
    bf_batches = _tp4_batches(_moetp4_cfg(MOE_ARCH, device, 1, "abi"), B, S,
                              TP4_WARM + TP4_TIMED)
    grok_batch = _tp4_batches(_moetp4_cfg(GROK_ARCH, device, 1, "gspmd"), GB, GS, 1)
    grok_bf = _tp4_batches(_moetp4_cfg(GROK_ARCH, device, 1, "gspmd"), B, S,
                           TP4_WARM + TP4_TIMED)
    gen = torch.Generator().manual_seed(1)
    fwd_cfg = _moetp4_cfg(MOE_ARCH, device, full_depth, "abi")
    fwd_cfg = dataclasses.replace(fwd_cfg, attention_impl="flash")
    tokens = torch.randint(0, fwd_cfg.vocab_size, (FB, FS), generator=gen)
    f32_tokens = torch.randint(0, fwd_cfg.vocab_size, (F32B, F32S), generator=gen)
    dec_tokens = torch.randint(0, fwd_cfg.vocab_size, (DB, DP + DN), generator=gen)
    rec: dict = {}
    t0 = time.perf_counter()

    def done(leg: str) -> None:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
        log(f"[moetp4] rank {rank}: {leg} done at {time.perf_counter() - t0:.1f} s")

    def free() -> None:
        if on_card:
            torch.cuda.empty_cache()

    keep: dict = {}
    with make_dist(device=str(dev), model_axis=MOETP4, world_size=world, rank=rank,
                   init_method=f"file://{Path(out_dir) / 'world'}") as dist4:
        # (c) the forward under flash, full depth, bf16
        api = build_model(fwd_cfg)
        model = api.init(0, dev, **tl.model_part(api, dist4))
        rec["fwd"] = _moetp4_forward(api, model, tokens.to(dev), dist4, on_card, dev,
                                     "moetp4")
        rec["fwd_heads"] = [int(model.layers.attn.wq.shape[-1] // fwd_cfg.resolved_head_dim),
                            int(model.layers.attn.wk.shape[-1] // fwd_cfg.resolved_head_dim)]
        rec["fwd_experts"] = int(model.layers.moe.experts.wi.shape[1])
        del model
        free()
        done("(c) the flash forward")
        # (c) the float32 forward and (d) the split decode, 2 layers
        cfg = _moetp4_cfg(MOE_ARCH, device, MOETP4_F32_DEPTH, "abi", parity=True)
        api = build_model(cfg)
        model = api.init(0, dev, **tl.model_part(api, dist4))
        with torch.no_grad():
            logits = api.forward(model, {"tokens": f32_tokens.to(dev)}, dist4)
        steps = _moetp4_decode(api, model, dec_tokens.to(dev), DP, cfg, dist4)
        if rank == 0:
            keep["f32_logits"] = logits.cpu()
            keep["decode"] = [s.cpu() for s in steps]
        rec["decode_heads"] = int(model.layers.attn.wk.shape[-1] // cfg.resolved_head_dim)
        del model, logits, steps
        free()
        done("(c, d) the float32 forward and the split decode")
        mesh22 = Mesh(("data", "model"), (2, 2), dist4.device)
        dist22 = make_dist(mesh=mesh22)
        try:
            for mode, ctx in (("abi", dist4), ("gspmd", dist22)):
                # (a) float32 parity, 2 layers
                api = build_model(_moetp4_cfg(MOE_ARCH, device, MOETP4_F32_DEPTH, mode,
                                              parity=True))
                rec[f"f32_{mode}"] = _tp4_steps(api, ctx, f32_batches, on_card, dev)
                free()
                done(f"(a) {mode}")
                # (b) bf16, the deepest depth a card holds; the ABI step per leaf
                api = build_model(_moetp4_cfg(MOE_ARCH, device, depth, mode,
                                              zero1=mode != "abi"))
                rec[f"bf16_{mode}"] = _tp4_steps(api, ctx, bf_batches, on_card, dev,
                                                 counted=True)
                free()
                done(f"(b) {mode}")
            # (e) grok-1-314b: one float32 step at both meshes
            for mesh, ctx in (("14", dist4), ("22", dist22)):
                api = build_model(_moetp4_cfg(GROK_ARCH, device, GROK_DEPTH, "gspmd",
                                              parity=True, microbatch=1))
                rec[f"grok_f32_{mesh}"] = _tp4_steps(api, ctx, grok_batch, on_card, dev)
                free()
                done(f"(e) grok float32 at {mesh}")
            # (e) the bf16 forward under flash at (1, 4)
            gcfg = dataclasses.replace(_moetp4_cfg(GROK_ARCH, device, GROK_DEPTH, "gspmd"),
                                       attention_impl="flash")
            api = build_model(gcfg)
            model = api.init(0, dev, **tl.model_part(api, dist4))
            rec["grok_fwd"] = _moetp4_forward(api, model, tokens[:GROK_FWD_BATCH].to(dev),
                                              dist4, on_card, dev, "moetp4 grok")
            rec["grok_heads"] = [int(model.layers.attn.wq.shape[-1] // gcfg.resolved_head_dim),
                                 len(_kv_heads_read(model, gcfg, dist4))]
            del model
            free()
            # (e) bf16 steps with FSDP at (2, 2)
            api = build_model(_moetp4_cfg(GROK_ARCH, device, GROK_DEPTH, "gspmd",
                                          microbatch=GROK_BF16_MICRO))
            rec["grok_bf16"] = _tp4_steps(api, dist22, grok_bf, on_card, dev, counted=True)
            free()
            done("(e) grok bf16")
        finally:
            dist22.shutdown()
    if rank == 0:
        # the one-card references, no process group
        cfg = _moetp4_cfg(MOE_ARCH, device, MOETP4_F32_DEPTH, "gspmd", parity=True)
        api = build_model(cfg)
        model = api.init(0, dev)
        state = tl.TrainState(model, adamw.init_tree(tl.param_leaves(model)),
                              torch.zeros((), dtype=torch.int32, device=dev))
        step = tl.make_train_step(api, None, AdamWConfig())
        ref = dict(losses=[], grad_norms=[])
        for b in f32_batches:
            state, met = step(state, {k: torch.as_tensor(v).to(dev) for k, v in b.items()})
            ref["losses"].append(float(met.loss))
            ref["grad_norms"].append(float(met.grad_norm))
        rec["f32_one_card"] = ref
        del state, step
        model = api.init(0, dev)
        with torch.no_grad(), _MoeSpy() as spy:
            want = api.forward(model, {"tokens": f32_tokens.to(dev)})
            margin = torch.stack(spy.margin).amin(0)
            spy.read()
        rec["f32_fwd_vs_one_card"] = _moetp4_vs(keep["f32_logits"].to(dev), want, margin)
        with _MoeSpy() as spy:
            want = _moetp4_decode(api, model, dec_tokens.to(dev), DP, cfg, None)
            # the decode steps' margins (the prefill's first)
            margins = [m for m in spy.margin[cfg.num_layers:]]
            spy.read()
        rec["decode_vs_one_card"] = [
            _moetp4_vs(g.to(dev), w, torch.stack(margins[i * cfg.num_layers:
                                                         (i + 1) * cfg.num_layers]).amin(0))
            for i, (g, w) in enumerate(zip(keep["decode"], want))]
        del model, want
        free()
        # grok-1-314b's unsharded gradient on one card (no optimizer)
        api = build_model(_moetp4_cfg(GROK_ARCH, device, GROK_DEPTH, "gspmd", parity=True,
                                      microbatch=1))
        model = api.init(0, dev)
        params = [p for _, p in tl.param_leaves(model)]
        b = {k: torch.as_tensor(v).to(dev) for k, v in grok_batch[0].items()}
        loss = api.loss_fn(model, b)
        grads = torch.autograd.grad(loss, params)
        rec["grok_one_card"] = dict(loss=float(loss.detach()),
                                    grad_norm=float(adamw.global_norm(list(grads))))
        del model, params, grads, loss
        free()
    done("the one-card references" if rank == 0 else "all legs")


def _kv_heads_read(model, cfg, dist) -> list:
    """The K/V heads a rank's query heads read (all of its own where the
    K/V heads split)."""
    from repro_torch.models.tensor_parallel import TensorParallel

    par = TensorParallel.of(model, cfg, dist)
    return par.kv_heads or list(range(model.layers.attn.wk.shape[-1]
                                      // cfg.resolved_head_dim))


def _moetp4_vs(got, want, margin) -> dict:
    """Logits (…, S, vocab) against one card's: the largest difference per
    position, the positions over ``F32_LOGIT_TOL`` and the first one's
    router margin (a routing tie there lets a token route otherwise)."""
    import torch

    pos = (got.float() - want.float()).abs().amax(-1).reshape(-1)
    off = torch.nonzero(pos > F32_LOGIT_TOL).flatten().tolist()
    m = margin.reshape(-1)
    return dict(max_abs=float(pos.max()), off=len(off), first_off=off[0] if off else -1,
                first_margin=float(m[off[0] % m.numel()]) if off else 0.0,
                scale=float(want.float().abs().max()),
                finite=bool(torch.isfinite(got).all()))


def _moetp4_predictions(device: str):
    """The dry run's lowering of leg (b)'s cells (qwen2-moe at (1, 4) and
    (2, 2)) and leg (e)'s bf16 cell (grok-1 at (2, 2)) on a fake world of
    four."""
    on_card = device != "cpu"
    cells = []
    for arch, mode, mesh, depth, par in (
            (MOE_ARCH, "abi", [1, MOETP4], MOETP4_DEPTH, dict(zero1=False)),
            (MOE_ARCH, "gspmd", [2, 2], MOETP4_DEPTH, dict(zero1=True)),
            (GROK_ARCH, "gspmd", [2, 2], GROK_DEPTH, dict(microbatch=GROK_BF16_MICRO))):
        p = dict(par, grad_sync=mode)
        c = dict(arch=arch, mesh=mesh, seq=TRAIN_SEQ if on_card else 32,
                 batch=TRAIN_BATCH if on_card else 8, par=p,
                 cfg=dict(num_layers=depth if on_card or arch == GROK_ARCH else 2))
        if not on_card:
            c.update(smoke=True, par=dict(p, tp_size=MOETP4, remat="full",
                                          sequence_parallel=arch == GROK_ARCH,
                                          microbatch=p.get("microbatch", 4)))
        cells.append(c)
    return _lower_cells(MOETP4, cells, timeout=MOETP4_TIMEOUT)


def phase_moetp4(card: str, device: str = "cuda",
                 out_dir: Path = HERE / "build" / "moetp4") -> dict:
    """[moetp4] (four cards, NCCL; ``device="cpu"``: the smoke configs on
    gloo, a rehearsal): the dry run's prediction of legs (b) and (e), then
    :func:`_moetp4_rank` on four spawned ranks.  Gates:
    (a) each mode's float32 losses within ``TP4_LOSS_RTOL`` and grad norms
    within ``TP4_NORM_RTOL`` (relative) of one card's unsharded step, on
    every rank, at every step (a token routed otherwise fails it), and
    ``pack_transposed`` once a step per rank under the ABI ZeRO-1 step (0
    under ``gspmd``; 0 on the CPU); (b) finite losses, equal on every rank,
    and the collectives a step equal to the dry run's op for op; (c) 24
    flash launches a rank at 4/4 heads (0 on the CPU), the last call held
    to ``attention_ref``, and the float32 forward within
    ``F32_LOGIT_TOL`` of one card's or its first position off a router
    tie; (d) each decode step likewise; (e) grok-1's float32 loss within
    ``TP4_LOSS_RTOL`` and grad norm within ``TP4_NORM_RTOL`` of one card's
    unsharded gradient at (1, 4) and (2, 2), one flash launch a rank at
    12/2 heads (the last call held to ``attention_ref``), finite bf16
    losses equal on every rank and its collectives equal to the dry run's;
    each rank holds its block (16 of 64 experts, grok-1's 8192 of each
    expert's 32768 ``d_ff``).  Returns the launches by kernel on rank 0."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    on_card = device != "cpu"
    # the dry run first, so that no timed leg shares the host's cores with it
    pred = dict(zip(("abi", "gspmd", "grok"),
                    _lowered(_moetp4_predictions(device), MOETP4_TIMEOUT)))
    log(f"[moetp4] the dry run's three cells lowered in {time.perf_counter() - t0:.1f} s, "
        f"before the ranks start")
    try:
        ranks = _spawn_ranks("moetp4", _moetp4_rank, MOETP4, out_dir, device,
                             timeout=MOETP4_TIMEOUT)
    except RuntimeError:
        for r in range(MOETP4):
            part = out_dir / f"rank{r}.json"
            log(f"[moetp4] rank {r}'s records so far: "
                f"{part.read_text() if part.exists() else 'none'}")
        raise
    r0 = ranks[0]
    where = card if on_card else "gloo"
    width = "full width" if on_card else "smoke"
    rel = lambda x, y: abs(x - y) / abs(y)  # noqa: E731
    bad = []
    fwd = r0["fwd"]
    want_flash = (MOETP4_FWD_DEPTH if on_card else 0, GROK_DEPTH if on_card else 0)
    log(f"[moetp4] {MOE_ARCH} {width} on four ranks of {where}: (c) forward under flash, "
        f"{MOETP4_FWD_DEPTH if on_card else 2} layers, B={FWD_BATCH if on_card else 4} "
        f"S={FWD_SEQ if on_card else 32}, {r0['fwd_heads'][0]}/{r0['fwd_heads'][1]} heads and "
        f"{r0['fwd_experts']} experts a rank: flash launches per rank "
        f"{[r['fwd']['flash'] for r in ranks]}; ms per forward (rank 0) "
        f"{[round(t, 1) for t in fwd['ms']]} after a first {fwd['first_ms']:.1f} "
        f"([forward-moe] on one card: 156.4-158.4 ms, PERF.md)")
    if any(r["fwd"]["flash"] != want_flash[0] for r in ranks):
        bad.append(f"(c) flash launches {[r['fwd']['flash'] for r in ranks]}")
    f32 = r0["f32_fwd_vs_one_card"]
    log(f"[moetp4] (c) float32 forward, {MOETP4_F32_DEPTH} layers, no drops, against one card: "
        f"{json.dumps(f32)} (bound {F32_LOGIT_TOL}; a position off must follow a router tie, "
        f"margin below {ROUTER_TIE})")
    if not f32["finite"] or (f32["off"] and f32["first_margin"] >= ROUTER_TIE):
        bad.append(f"(c) float32 forward {f32}")
    dec = r0["decode_vs_one_card"]
    log(f"[moetp4] (d) the split decode at model_axis={MOETP4} ({r0['decode_heads']} K/V heads "
        f"a rank's cache), float32, {MOETP4_F32_DEPTH} layers: per step against one card's "
        f"decode_step: max abs {[f'{d['max_abs']:.3e}' for d in dec]}, positions off "
        f"{[d['off'] for d in dec]}")
    for i, d in enumerate(dec):
        if not d["finite"] or (d["off"] and d["first_margin"] >= ROUTER_TIE):
            bad.append(f"(d) decode step {i}: {d}")
    ref = r0["f32_one_card"]
    log(f"[moetp4] (a) float32, {MOETP4_F32_DEPTH} layers, one card's unsharded step: losses "
        f"{ref['losses']} grad norms {ref['grad_norms']}")
    for mode in ("abi", "gspmd"):
        a = [r[f"f32_{mode}"] for r in ranks]
        lrel = max(rel(x, y) for r in a for x, y in zip(r["losses"], ref["losses"]))
        nrel = max(rel(x, y) for r in a for x, y in zip(r["grad_norms"], ref["grad_norms"]))
        log(f"[moetp4] (a) {mode} at {'(1, 4)' if mode == 'abi' else '(2, 2), FSDP'}: losses "
            f"{a[0]['losses']} grad norms {a[0]['grad_norms']}; largest relative difference "
            f"to one card: losses {lrel:.3e} (bound {TP4_LOSS_RTOL}), grad norms {nrel:.3e} "
            f"(bound {TP4_NORM_RTOL}); pack_transposed a step per rank "
            f"{[x['packs'] for x in a]}; parts {[x['part'] for x in a]}")
        want_pack = [1 if (on_card and mode == "abi") else 0] * MOETP4_F32_STEPS
        if lrel > TP4_LOSS_RTOL or nrel > TP4_NORM_RTOL or any(x["packs"] != want_pack
                                                              for x in a):
            bad.append(f"(a) {mode}: losses {lrel}, grad norms {nrel}, packs "
                       f"{[x['packs'] for x in a]}")
        _moetp4_bf16(f"(b) {mode}", [r[f"bf16_{mode}"] for r in ranks], pred[mode],
                     MOETP4_DEPTH if on_card else 2, bad)
    gref = r0["grok_one_card"]
    for mesh in ("14", "22"):
        g = [r[f"grok_f32_{mesh}"] for r in ranks]
        lrel = max(rel(x["losses"][0], gref["loss"]) for x in g)
        nrel = max(rel(x["grad_norms"][0], gref["grad_norm"]) for x in g)
        log(f"[moetp4] (e) {GROK_ARCH} {width}, {GROK_DEPTH} layer, float32, the gspmd step at "
            f"({mesh[0]}, {mesh[1]}): loss {g[0]['losses'][0]:.7f} grad norm "
            f"{g[0]['grad_norms'][0]:.6f}; one card's unsharded gradient: loss "
            f"{gref['loss']:.7f} grad norm {gref['grad_norm']:.6f}; relative differences "
            f"{lrel:.3e} (bound {TP4_LOSS_RTOL}), {nrel:.3e} (bound {TP4_NORM_RTOL}); parts "
            f"{[x['part'] for x in g]}; bytes of weights per card {[x['held_bytes'] for x in g]}"
            f" of {g[0]['whole_bytes']}")
        if lrel > TP4_LOSS_RTOL or nrel > TP4_NORM_RTOL:
            bad.append(f"(e) grok float32 at {mesh}: loss {lrel}, grad norm {nrel}")
    gf = r0["grok_fwd"]
    log(f"[moetp4] (e) {GROK_ARCH} bf16 forward under flash at (1, 4), B={GROK_FWD_BATCH if on_card else 2}: "
        f"{r0['grok_heads'][0]}/{r0['grok_heads'][1]} heads a rank, flash launches per rank "
        f"{[r['grok_fwd']['flash'] for r in ranks]}, ms {[round(t, 1) for t in gf['ms']]}")
    if any(r["grok_fwd"]["flash"] != want_flash[1] for r in ranks):
        bad.append(f"(e) grok flash launches {[r['grok_fwd']['flash'] for r in ranks]}")
    _moetp4_bf16(f"(e) {GROK_ARCH} gspmd", [r["grok_bf16"] for r in ranks], pred["grok"],
                 GROK_DEPTH, bad)
    experts = [r["fwd_experts"] for r in ranks]
    if on_card and (experts != [16] * MOETP4 or r0["fwd_heads"] != [4, 4]
                    or r0["grok_heads"] != [12, 2]):
        bad.append(f"blocks: experts {experts}, heads {r0['fwd_heads']}, {r0['grok_heads']}")
    log(f"[moetp4] phase wall {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("[moetp4] " + "; ".join(bad))
    return {"flash_attention": fwd["flash"] + gf["flash"],
            "pack_transposed": sum(sum(r0[f"{k}_abi"]["packs"]) for k in ("f32", "bf16"))}


def _moetp4_bf16(tag: str, b: list, p: dict, depth: int, bad: list) -> None:
    """Log a bf16 leg beside the dry run's prediction; gate its losses and
    its collectives a step (op for op, the count and the bytes)."""
    ms = statistics.median(b[0]["ms"][TP4_WARM:])
    col = b[0]["collectives"]
    log(f"[moetp4] {tag} bf16, {depth} layers: losses {[round(v, 4) for v in b[0]['losses']]} "
        f"grad norms {[round(v, 4) for v in b[0]['grad_norms']]}; ms/step per rank "
        f"{[[round(t, 1) for t in x['ms']] for x in b]} (rank 0's median of the {TP4_TIMED} "
        f"after {TP4_WARM} warm {ms:.1f}); peak GB per card "
        f"{[round(x['peak_gb'], 2) for x in b]}; pack_transposed a step "
        f"{[x['packs'] for x in b]}; collectives a step (rank 0) {col}; bytes of weights per "
        f"card {[x['held_bytes'] for x in b]} of {b[0]['whole_bytes']}")
    log(f"[moetp4] {tag} predicted by the dry run (fake world of 4): argument "
        f"{_gb(p['memory']['argument_bytes'])}, peak {_gb(p['memory']['peak_estimate_bytes'])}, "
        f"collectives {p['collectives']['bytes']} bytes, {p['collectives']['count']} calls; "
        f"roofline step {p['roofline']['step_time_s'] * 1e3:.2f} ms "
        f"({p['roofline']['bottleneck']}); measured peak {b[0]['peak_gb']:.2f} GB, "
        f"{ms:.1f} ms/step")
    if any(x["losses"] != b[0]["losses"] or not all(math.isfinite(v) for v in x["losses"])
           for x in b):
        bad.append(f"{tag}: losses {[x['losses'] for x in b]}")
    if (col["count"] != p["collectives"]["count"]
            or col["bytes"] != p["collectives"]["bytes"]):
        bad.append(f"{tag}: collectives {col} against the dry run's {p['collectives']}")


# ---------------------------------------------------------------------------
# [ssmtp4]: the ssm and hybrid families on the model axis, four cards
# ---------------------------------------------------------------------------
SSMTP4 = 4
SSMTP4_ARCHS = (SSM_ARCH, HYBRID_ARCH)
#: (a), (c') and (d): float32 against one card's whole model, which must
#: hold the unsharded step: 16 bytes a parameter (the f32 weight, its
#: gradient and AdamW's two moments) and the update's temporaries.
#: zamba2-2.7b's 54 layers are 2.45 B parameters (39 GB); rwkv6-7b's 32 are
#: 7.6 B (121 GB), and its step at 12 layers (3.15 B) ran out of an NVIDIA
#: H100's 80 GB, so 8 of them (2.28 B)
SSMTP4_F32_DEPTH = {SSM_ARCH: 8, HYBRID_ARCH: 54}
#: (e) the float64 witness of rwkv6-7b: the split model and one card's
#: whole model in float64 (the plain chunked scan in place of the float32
#: kernel, ``_PlainWkv6``) agree within this share of the logits' largest
#: magnitude, of the loss, of the grad norm and of each leaf's gradient
#: (its norm, its projection on a seeded probe, rank 0's block element by
#: element).  The split changes the summation order only.  rwkv6-7b's
#: float32 gradient amplifies that order's rounding about 10^4 times (a
#: head's first output, which ``ln_x`` normalises over its 64 channels, is
#: rank one, and its scale may sit near ``sqrt(eps)`` = 1e-3), which
#: float32 cannot tell from a wrong gradient; float64's rounding times that
#: stays near 1e-12
SSMTP4_F64_TOL = 1e-8
SSMTP4_F32_BATCH, SSMTP4_F32_SEQ, SSMTP4_F32_STEPS = 8, 256, 2
#: (c') the float32 forward's batch and sequence; (d) the split decode's
#: batch and steps from the zero state
SSMTP4_F32_FWD = (1, 512)
SSMTP4_DECODE = (2, 8)
#: (d) zamba2-2.7b's decode reads a bfloat16 K/V cache (one card's and the
#: split model's alike): a K/V element that the two summation orders put on
#: either side of a rounding boundary is stored one bfloat16 step (2^-8
#: relative) apart, so its logits are held within that share of their
#: largest magnitude (rwkv6-7b's float32 state within ``F32_LOGIT_TOL``)
SSMTP4_BF16_CACHE_TOL = 2.0 ** -8
#: (b) one warm step, then the timed ones, a mode
SSMTP4_WARM, SSMTP4_TIMED = 1, 2
SSMTP4_TIMEOUT = 900
#: NCCL's wait for a collective in [ssmtp4]'s ranks
SSMTP4_NCCL_TIMEOUT_S = 240


def _ssmtp4_cfg(arch: str, device: str, depth, grad_sync: str, dtype: str | None = None,
                zero1: bool = True, **change):
    """``arch`` at full width (the smoke config with ``tp_size=4`` on the
    CPU, so every unit splits), ``depth`` layers (None: the config's),
    ``grad_sync``, the ABI step's ZeRO-1 (``zero1``) or per-leaf layout,
    the weights and the compute in ``dtype`` (None: the config's)."""
    import dataclasses

    from repro_torch import configs

    on_card = device != "cpu"
    cfg = configs.get_config(arch) if on_card else configs.smoke_config(arch)
    par = dict(grad_sync=grad_sync, zero1=zero1)
    if not on_card:
        par.update(tp_size=SSMTP4, microbatch=4, remat="full")
    cfg = dataclasses.replace(cfg, num_layers=depth or cfg.num_layers, **change,
                              parallelism=dataclasses.replace(cfg.parallelism, **par))
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    return cfg


class _ScanSpy:
    """Within ``with``, keeps copies of the inputs and output of the last
    ``wkv6`` and ``ssd`` call the models make (the wrappers run as they
    are, so the launch counts are the run's own); ``check`` holds each to its plain
    version on the same inputs (``CHUNKED_TOL``)."""

    def __enter__(self):
        from repro_torch.models import mamba, rwkv

        self.seen, self._real = {}, (rwkv.wkv6_apply, mamba.ssd_apply)

        def spy(name, fn):
            def call(*args, chunk):
                out = fn(*args, chunk=chunk)
                # copies: an argument may view a parameter the step updates
                self.seen[name] = (tuple(a.detach().clone() for a in args), chunk,
                                   out.detach().clone())
                return out
            return call

        rwkv.wkv6_apply, mamba.ssd_apply = spy("wkv6", self._real[0]), spy("ssd", self._real[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mamba, rwkv

        rwkv.wkv6_apply, mamba.ssd_apply = self._real

    def check(self, tag: str) -> dict:
        """name -> the call's heads, its max abs difference to the plain
        version, and its gate (``ok``): every output within ``CHUNKED_TOL``
        (abs and rel) of the plain version, or else within ``CHUNKED_TOL``
        of the outputs' largest magnitude (the models' activations reach
        larger outputs than [check]'s inputs, and an output near zero then
        carries the float32 sums' cancellation); the distances of both to
        the plain form run in float64 are a record.  Records, never
        raises: a rank that left the world here would hang the others in
        their next collective."""
        from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
        from repro_torch.kernels.rwkv6_scan import ref as wkv_ref

        import torch

        out = {}
        for name, (args, chunk, got) in self.seen.items():
            plain = {"wkv6": wkv_ref.wkv6, "ssd": ssd_ref.ssd}[name]
            args, got = [a.detach() for a in args], got.detach()
            with torch.no_grad():
                want = plain(*args, chunk=chunk)
            torch_sync()
            err = _max_err(got, want)
            rec = dict(heads=int(args[0].shape[2]), max_abs=err,
                       y_max=float(want.float().abs().max()),
                       ok=_excess(got.float(), want.float(), CHUNKED_TOL) <= 0)
            if not rec["ok"]:
                with torch.no_grad():
                    f64 = plain(*(a.double() for a in args), chunk=chunk)
                rec.update(kernel_f64=_max_err(got, f64), plain_f64=_max_err(want, f64))
                rec["ok"] = err <= CHUNKED_TOL * rec["y_max"]
                del f64
            log(f"[{tag}] the last {name} call (shape {tuple(args[0].shape)}, chunk {chunk}) "
                f"on the layer's own activations against its plain version: {json.dumps(rec)} "
                f"(gate {CHUNKED_TOL} abs and rel, or {CHUNKED_TOL} of the largest output)")
            out[name] = rec
        self.seen = {}
        return out


def _ssmtp4_decode(api, model, tokens, dist, dev) -> list:
    """The logits of each step of a decode that feeds ``tokens`` (B, n) one
    position at a time from the zero state (this rank's block of the state
    where the model splits)."""
    import torch

    B, n = tokens.shape
    tp = getattr(model, "part", None)
    with torch.no_grad():
        kw = {"model_axis": tp.tp_size} if tp is not None and tp.tp_size > 1 else {}
        state = api.decode_init(B, n, device=dev, **kw)
        out = []
        for i in range(n):
            logits, state = api.decode_step(model, tokens[:, i:i + 1], state, i, dist)
            out.append(logits.float())
    return out


def _ssmtp4_vs(got, want) -> dict:
    """Logits against one card's: the largest difference (in float64), the
    scale."""
    import torch

    d = (got.double() - want.double()).abs()
    return dict(max_abs=float(d.max()), scale=float(want.double().abs().max()),
                finite=bool(torch.isfinite(got).all()))


class _PlainWkv6:
    """Within ``with``, the rwkv6 model's scan runs its plain chunked form
    (``ref.wkv6``, differentiated as plain torch) in the inputs' own type:
    (e)'s float64 witness, which the float32 kernel does not take."""

    def __enter__(self):
        from repro_torch.kernels.rwkv6_scan import ref
        from repro_torch.models import rwkv

        self._real = rwkv.wkv6_apply
        rwkv.wkv6_apply = lambda r, k, v, w, u, *, chunk: ref.wkv6(r, k, v, w, u, chunk=chunk)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import rwkv

        rwkv.wkv6_apply = self._real


class _LnxSpy:
    """Within ``with``, each rwkv6 ``ln_x`` call (the per-head group norm
    of the scan's output, (B, T, H, N)) records its input's smallest
    per-head standard deviation at the first position and at the others:
    at the first the state is zero and a head's output is rank one, and
    where its scale nears ``sqrt(eps)`` the norm amplifies its rounding."""

    def __enter__(self):
        from repro_torch.models import rwkv

        self.rows, self._real = [], rwkv.norm

        def spy(p, x, kind):
            if x.ndim == 4 and x.shape[1] > 1:
                sd = x.float().std(dim=-1, unbiased=False)
                self.rows.append([float(sd[:, 0].min()), float(sd[:, 1:].min())])
            return self._real(p, x, kind)

        rwkv.norm = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import rwkv

        rwkv.norm = self._real


def _ssmtp4_f64(api, model, tokens, batch, dist, dev, against=None) -> tuple:
    """(e): ``model``'s float64 forward of ``tokens`` and the gradient of
    ``batch``'s loss under :class:`_PlainWkv6`.  Returns the logits (the
    whole vocabulary, on the CPU), a record (the loss, the grad norm and,
    per leaf, the gradient's squared norm and its dot product with a
    seeded N(0, 1) probe of the whole leaf, each summed over the model
    axis where the leaf splits, and the probe's squared norm) and this
    rank's gradient blocks on the CPU; with ``against`` (leaf -> (take,
    block): another model's block and the function that takes it from a
    whole leaf) each leaf's largest difference to it and the leaf's
    largest magnitude instead of the blocks."""
    import torch
    from repro_torch.models import param_leaves
    from repro_torch.models.tensor_parallel import TP, take_block

    with torch.no_grad(), _PlainWkv6():
        logits = api.forward(model, {"tokens": tokens}, dist).cpu()
    with _PlainWkv6():
        leaves = param_leaves(model)
        loss = api.loss_fn(model, batch, dist)
        grads = torch.autograd.grad(loss, [p for _, p in leaves], materialize_grads=True)
    held = getattr(model, "held", {})
    rec, out = {"loss": float(loss.detach()), "leaves": {}}, {}
    for i, ((name, _), g) in enumerate(zip(leaves, grads)):
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        probe = torch.randn(model.full_shapes[name], generator=gen, device=dev,
                            dtype=g.dtype)
        pb = take_block(model, name, probe)
        v = torch.stack([(g * g).sum(), (g * pb).sum()])
        if TP in held.get(name, ()):
            torch.distributed.all_reduce(v, group=dist.tp_group)
        leaf = dict(sq=float(v[0]), dot=float(v[1]), probe_sq=float((probe * probe).sum()))
        if against is None:
            out[name] = g.cpu()
        else:
            take, block = against[name]
            leaf.update(block_max_abs=float((take(name, g) - block.to(dev)).abs().max()),
                        g_max=float(g.abs().max()))
        rec["leaves"][name] = leaf
        del probe, pb
    rec["grad_norm"] = math.sqrt(sum(x["sq"] for x in rec["leaves"].values()))
    del grads, loss
    return logits, rec, out


def _ssmtp4_rank(rank: int, world: int, init_method: str, out_dir: str,
                 device: str = "cuda") -> None:
    """One rank of [ssmtp4] (``device="cpu"``: the smoke configs on gloo).
    One world; mesh (1, 4), and (2, 2) built on it.  For rwkv6-7b, then
    zamba2-2.7b, each rank holding its block (a quarter of the heads,
    channels, ``d_ff`` and vocabulary): (c) the bf16 forward at full depth
    (zamba2-2.7b under flash), B=4, S=2048, its kernels' launches and the
    last call of each held to its plain version; (c') the float32 forward
    and (d) the split decode at ``SSMTP4_F32_DEPTH``; (a) float32 steps at
    that depth, the ABI ZeRO-1 step at (1, 4) and ``gspmd`` with FSDP at
    (2, 2), the last scan call of (c') and of each mode's steps held to its
    plain version; (e) rwkv6-7b's float64 witness at (1, 4): the forward of
    (c')'s tokens and the gradient of (a)'s first batch at the initial
    weights.  Then (b) bf16 steps at full depth in both modes (the ABI step
    in its per-leaf layout), batch 8 x 1024, on the forward's model at
    (1, 4).  Rank 0 then runs the one-card references on its card with no
    process group: the whole model's float32 forward (``_LnxSpy`` on
    rwkv6-7b's), decode and unsharded steps, and rwkv6-7b's float64
    forward and gradient.  Each leg's records are saved as it ends."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch
    from repro_torch.core import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.model import _family
    from repro_torch.models.tensor_parallel import take_block
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device != "cpu"
    torch.set_num_threads(1)
    dev = torch.device(f"cuda:{rank}") if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
    B, S = (TRAIN_BATCH, TRAIN_SEQ) if on_card else (8, 32)
    B32, S32 = (SSMTP4_F32_BATCH, SSMTP4_F32_SEQ) if on_card else (8, 32)
    FB, FS = (FWD_BATCH, FWD_SEQ) if on_card else (4, 32)
    F32B, F32S = SSMTP4_F32_FWD if on_card else (1, 16)
    DB, DN = SSMTP4_DECODE
    depth32 = {a: SSMTP4_F32_DEPTH[a] if on_card else None for a in SSMTP4_ARCHS}
    if on_card:
        # a rank that fails between collectives ends the others within
        # minutes, not NCCL's default ten (make_dist joins this world)
        import datetime

        torch.distributed.init_process_group(
            "nccl", init_method=f"file://{Path(out_dir) / 'world'}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=SSMTP4_NCCL_TIMEOUT_S))
    gen = torch.Generator().manual_seed(1)
    data = {}
    for arch in SSMTP4_ARCHS:
        c = _ssmtp4_cfg(arch, device, None, "abi")
        data[arch] = dict(
            f32=_tp4_batches(c, B32, S32, SSMTP4_F32_STEPS),
            bf16=_tp4_batches(c, B, S, SSMTP4_WARM + SSMTP4_TIMED),
            fwd=torch.randint(0, c.vocab_size, (FB, FS), generator=gen),
            f32_fwd=torch.randint(0, c.vocab_size, (F32B, F32S), generator=gen),
            decode=torch.randint(0, c.vocab_size, (DB, DN), generator=gen))
    rec: dict = {}
    keep: dict = {}
    t0 = time.perf_counter()

    def done(leg: str) -> None:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
        log(f"[ssmtp4] rank {rank}: {leg} done at {time.perf_counter() - t0:.1f} s")

    def free() -> None:
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def first_batch(arch: str) -> dict:
        return {k: torch.as_tensor(data[arch]["f32"][0][k]).to(dev)
                for k in ("tokens", "targets")}

    with make_dist(device=str(dev), model_axis=SSMTP4, world_size=world, rank=rank,
                   init_method=f"file://{Path(out_dir) / 'world'}") as dist4:
        dist22 = make_dist(mesh=Mesh(("data", "model"), (2, 2), dist4.device))
        try:
            bf16_models = {}
            for arch in SSMTP4_ARCHS:
                r = rec.setdefault(arch, {})
                d = data[arch]
                # (c) the bf16 forward at full depth; zamba2's shared block under flash
                fcfg = _ssmtp4_cfg(arch, device, None, "abi", zero1=False,
                                   attention_impl="flash" if arch == HYBRID_ARCH else "xla")
                api = build_model(fcfg)
                t = time.perf_counter()
                model = api.init(0, dev, **tl.model_part(api, dist4))
                r["draw_s"] = time.perf_counter() - t
                r["part"] = list(dataclasses.astuple(model.part))
                r["split"] = sorted(n for n, spec in model.held.items() if "tp" in spec)
                tokens = d["fwd"].to(dev)
                with torch.no_grad(), _FlashSpy() as fspy, _ScanSpy() as sspy:
                    _zero_counts()
                    _, t1 = _timed(lambda: api.forward(model, {"tokens": tokens}, dist4),
                                   on_card, dev)
                    r["fwd_launches"] = _counts()
                    if on_card:
                        r["fwd_last"] = sspy.check(f"ssmtp4 {arch}")
                        if arch == HYBRID_ARCH:
                            try:  # recorded, not raised: the world goes on
                                fspy.check(f"ssmtp4 {arch}")
                                r["fwd_last"]["flash"] = dict(ok=True)
                            except AssertionError as e:
                                r["fwd_last"]["flash"] = dict(ok=False, error=str(e))
                with torch.no_grad():
                    r["fwd_ms"] = [_timed(lambda: api.forward(model, {"tokens": tokens}, dist4),
                                          on_card, dev)[1] for _ in range(3)]
                r["fwd_first_ms"] = t1
                if arch == HYBRID_ARCH:
                    a = model.shared.attn
                    hd = fcfg.resolved_head_dim
                    r["fwd_heads"] = [int(a.wq.shape[-1] // hd), int(a.wk.shape[-1] // hd), hd]
                bf16_models[arch] = model
                del model
                free()
                done(f"(c) {arch} the bf16 forward")
                # (c') the float32 forward and (d) the split decode, then (a) the
                # ABI ZeRO-1 steps on the same weights; the last scan call of
                # each held to its plain version
                cfg = _ssmtp4_cfg(arch, device, depth32[arch], "abi", "float32")
                api = build_model(cfg)
                model = api.init(0, dev, **tl.model_part(api, dist4))
                with torch.no_grad(), _ScanSpy() as sspy:
                    logits = api.forward(model, {"tokens": d["f32_fwd"].to(dev)}, dist4)
                    if on_card:
                        r["f32_fwd_last"] = sspy.check(f"ssmtp4 {arch} float32 forward")
                steps = _ssmtp4_decode(api, model, d["decode"].to(dev), dist4, dev)
                if rank == 0:
                    keep[arch] = dict(logits=logits.cpu(), decode=[x.cpu() for x in steps])
                del logits, steps
                with _ScanSpy() as sspy:
                    r["f32_abi"] = _tp4_steps(api, dist4, d["f32"], on_card, dev, model=model)
                    if on_card:
                        r["f32_abi_last"] = sspy.check(f"ssmtp4 {arch} float32 abi step")
                del model
                free()
                done(f"(c', d, a) {arch} float32 at (1, 4)")
                api = build_model(_ssmtp4_cfg(arch, device, depth32[arch], "gspmd", "float32"))
                with _ScanSpy() as sspy:
                    r["f32_gspmd"] = _tp4_steps(api, dist22, d["f32"], on_card, dev)
                    if on_card:
                        r["f32_gspmd_last"] = sspy.check(f"ssmtp4 {arch} float32 gspmd step")
                free()
                done(f"(a) {arch} float32 gspmd at (2, 2)")
                if arch == SSM_ARCH:
                    # (e) the float64 witness at (1, 4)
                    api = build_model(_ssmtp4_cfg(arch, device, depth32[arch], "abi",
                                                  "float64"))
                    model = api.init(0, dev, **tl.model_part(api, dist4))
                    logits, r["f64"], blocks = _ssmtp4_f64(
                        api, model, d["f32_fwd"].to(dev), first_batch(arch), dist4, dev)
                    if rank == 0:
                        keep[arch].update(f64_logits=logits, f64_blocks=blocks,
                                          f64_part=dataclasses.astuple(model.part))
                    del model, logits, blocks
                    free()
                    done(f"(e) {arch} float64 at (1, 4)")
            for arch in SSMTP4_ARCHS:
                # (b) bf16 at full depth: the ABI step per leaf at (1, 4) on the
                # forward's model, then gspmd with FSDP at (2, 2)
                r, d = rec[arch], data[arch]
                api = build_model(_ssmtp4_cfg(arch, device, None, "abi", zero1=False))
                model = bf16_models.pop(arch)
                r["bf16_abi"] = _tp4_steps(api, dist4, d["bf16"], on_card, dev, model=model)
                del model
                free()
                done(f"(b) {arch} bf16 abi")
                api = build_model(_ssmtp4_cfg(arch, device, None, "gspmd"))
                r["bf16_gspmd"] = _tp4_steps(api, dist22, d["bf16"], on_card, dev)
                free()
                done(f"(b) {arch} bf16 gspmd")
        finally:
            dist22.shutdown()
    if rank == 0:
        # the one-card references, no process group
        for arch in SSMTP4_ARCHS:
            d = data[arch]
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            cfg = _ssmtp4_cfg(arch, device, depth32[arch], "gspmd", "float32")
            api = build_model(cfg)
            model = api.init(0, dev)
            with torch.no_grad(), _LnxSpy() as lnx:
                want = api.forward(model, {"tokens": d["f32_fwd"].to(dev)})
            rec[arch]["lnx_std_min"] = lnx.rows
            rec[arch]["f32_fwd_vs_one_card"] = _ssmtp4_vs(keep[arch]["logits"].to(dev), want)
            keep[arch]["one_f32_logits"] = want.cpu()
            want = _ssmtp4_decode(api, model, d["decode"].to(dev), None, dev)
            rec[arch]["decode_vs_one_card"] = [_ssmtp4_vs(g.to(dev), w)
                                               for g, w in zip(keep[arch]["decode"], want)]
            del want
            state = tl.TrainState(model, adamw.init_tree(tl.param_leaves(model)),
                                  torch.zeros((), dtype=torch.int32, device=dev))
            step = tl.make_train_step(api, None, AdamWConfig())
            ref = dict(losses=[], grad_norms=[])
            for b in d["f32"]:
                state, met = step(state, {k: torch.as_tensor(v).to(dev) for k, v in b.items()})
                ref["losses"].append(float(met.loss))
                ref["grad_norms"].append(float(met.grad_norm))
            rec[arch]["f32_one_card"] = ref
            rec[arch]["one_card_peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                                             if on_card else 0.0)
            del state, model, step
            free()
            if arch == SSM_ARCH:
                # (e) one card's float64 model against rank 0's block
                api = build_model(_ssmtp4_cfg(arch, device, depth32[arch], "abi", "float64"))
                model = api.init(0, dev)
                k = keep[arch]
                meta = _family(api.cfg)[1](api.cfg, "meta", *k["f64_part"])
                logits, one, _ = _ssmtp4_f64(
                    api, model, d["f32_fwd"].to(dev), first_batch(arch), None, dev,
                    against={n: (lambda name, g: take_block(meta, name, g), b)
                             for n, b in k["f64_blocks"].items()})
                rec[arch]["f64_one_card"] = one
                rec[arch]["f64_logits"] = dict(
                    split=_ssmtp4_vs(k["f64_logits"], logits),
                    f32_split=_ssmtp4_vs(k["logits"].double(), logits),
                    f32_one_card=_ssmtp4_vs(k["one_f32_logits"].double(), logits))
                del model, logits
                free()
            done(f"the one-card references of {arch}")
    done("the one-card references" if rank == 0 else "all legs")


def phase_ssmtp4(card: str, device: str = "cuda",
                 out_dir: Path = HERE / "build" / "ssmtp4") -> dict:
    """[ssmtp4] (four cards, NCCL; ``device="cpu"``: the smoke configs on
    gloo, a rehearsal): :func:`_ssmtp4_rank` on four spawned ranks.  Gates,
    for rwkv6-7b and zamba2-2.7b: (c) at full depth each rank launches
    ``wkv6`` once a layer at 16 of 64 heads (``ssd`` at 20 of 80 heads, and
    flash once a firing at 8/8 heads of D=80), the last call of each held to
    its plain version (``_ScanSpy.check``, ``_FlashSpy.check``; 0 launches
    on the CPU), and so the last scan call of (c') and of each mode's (a)
    steps; (c') zamba2-2.7b's float32 forward within ``F32_LOGIT_TOL`` of
    one card's whole model (rwkv6-7b's is a record: (e) holds it); (d) each
    split decode step within ``F32_LOGIT_TOL`` of one card's (zamba2-2.7b,
    on its bfloat16 K/V cache, within ``SSMTP4_BF16_CACHE_TOL`` of the
    logits' largest magnitude); (a) each mode's float32 step-1 loss within
    ``TP4_LOSS_RTOL`` of one card's unsharded step, zamba2-2.7b's step-1
    grad norm within ``TP4_NORM_RTOL`` (rwkv6-7b's float32 gradient is
    ill-conditioned: (e) holds it), every value finite, step 2 a record
    (step 1's AdamW update moves every weight by the learning rate, and
    step 2 reads the model it blew up), ``pack_transposed`` once a step per
    rank under the ABI ZeRO-1 step (0 under ``gspmd``; 0 on the CPU);
    (e) rwkv6-7b's float64 split forward and gradient within
    ``SSMTP4_F64_TOL`` of one card's; (b) finite bf16 losses equal on every
    rank, each step's scan launches twice a layer and microbatch (forward
    and remat's recompute) and a card's weights exactly the bytes its held
    specs give.  The ranks' records stay in ``out_dir``.  Returns the
    launches by kernel on rank 0."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    on_card = device != "cpu"
    try:
        ranks = _spawn_ranks("ssmtp4", _ssmtp4_rank, SSMTP4, out_dir, device,
                             timeout=SSMTP4_TIMEOUT)
    except RuntimeError:
        for r in range(SSMTP4):
            part = out_dir / f"rank{r}.json"
            log(f"[ssmtp4] rank {r}'s records so far: "
                f"{part.read_text() if part.exists() else 'none'}")
        raise
    where = card if on_card else "gloo"
    width = "full width" if on_card else "smoke"
    bad = []
    launches = {"wkv6": 0, "ssd": 0, "flash_attention": 0, "pack_transposed": 0}
    scan = {SSM_ARCH: "wkv6", HYBRID_ARCH: "ssd"}
    for arch in SSMTP4_ARCHS:
        r0 = ranks[0][arch]
        cfg = _ssmtp4_cfg(arch, device, None, "abi")
        L = cfg.num_layers
        firings = L // cfg.hybrid.shared_attn_every if arch == HYBRID_ARCH else 0
        name = scan[arch]
        fl = [r[arch]["fwd_launches"] for r in ranks]
        want = {name: L if on_card else 0,
                "flash_attention": firings if on_card else 0}
        log(f"[ssmtp4] {arch} {width} on four ranks of {where}: parts "
            f"{[r[arch]['part'] for r in ranks]}; split leaves (rank 0) {r0['split']}; the "
            f"weight draw {r0['draw_s']:.1f} s")
        log(f"[ssmtp4] (c) {arch} bf16 forward, {L} layers, B={FWD_BATCH if on_card else 4} "
            f"S={FWD_SEQ if on_card else 32}"
            f"{', shared attention under flash' if arch == HYBRID_ARCH else ''}: launches per "
            f"rank {[{k: x[k] for k in want} for x in fl]}; the last calls against their plain "
            f"versions (rank 0) {json.dumps(r0.get('fwd_last'))}"
            + (f"; shared attention {r0['fwd_heads'][0]}/{r0['fwd_heads'][1]} heads of D="
               f"{r0['fwd_heads'][2]} a rank" if arch == HYBRID_ARCH else "")
            + f"; ms per forward (rank 0) {[round(t, 1) for t in r0['fwd_ms']]} after a first "
            f"{r0['fwd_first_ms']:.1f}")
        if any(x[k] != v for x in fl for k, v in want.items()):
            bad.append(f"(c) {arch} launches {fl}")
        if on_card:
            heads = (cfg.d_model // cfg.ssm.head_dim if arch == SSM_ARCH
                     else cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim) // SSMTP4
            last = [r[arch]["fwd_last"][name]["heads"] for r in ranks]
            if last != [heads] * SSMTP4 or (arch == HYBRID_ARCH and r0["fwd_heads"][:2] != [
                    cfg.num_heads // SSMTP4, cfg.num_kv_heads // SSMTP4]):
                bad.append(f"(c) {arch} heads a rank {last}, {r0.get('fwd_heads')}")
            if not all(c["ok"] for r in ranks for c in r[arch]["fwd_last"].values()):
                bad.append(f"(c) {arch} the last calls {[r[arch]['fwd_last'] for r in ranks]}")
        f32 = r0["f32_fwd_vs_one_card"]
        dec = r0["decode_vs_one_card"]
        depth = SSMTP4_F32_DEPTH[arch] if on_card else cfg.num_layers
        dec_tol = ([F32_LOGIT_TOL] * len(dec) if arch == SSM_ARCH
                   else [SSMTP4_BF16_CACHE_TOL * x["scale"] for x in dec])
        log(f"[ssmtp4] (c') {arch} float32 forward, {depth} layers, against one card's whole "
            f"model: {json.dumps(f32)} ("
            + (f"bound {F32_LOGIT_TOL}" if arch == HYBRID_ARCH else "a record: (e) holds it")
            + f"); (d) the split decode, {SSMTP4_DECODE[1]} steps from the zero state: max "
            f"abs per step {[f'{x['max_abs']:.3e}' for x in dec]} (bounds "
            f"{[f'{t:.2e}' for t in dec_tol]})")
        if arch == SSM_ARCH:
            log(f"[ssmtp4] (c') {arch} one card's ln_x inputs, smallest per-head std per "
                f"layer at the first position and at the others: "
                f"{[[f'{v:.3e}' for v in row] for row in r0['lnx_std_min']]}")
        checks = [(f"(d) step {i}", x, t) for i, (x, t) in enumerate(zip(dec, dec_tol))]
        if arch == HYBRID_ARCH:
            checks.append(("(c')", f32, F32_LOGIT_TOL))
        for what, x, tol in checks:
            if not x["finite"] or x["max_abs"] > tol:
                bad.append(f"{what} {arch}: {x}")
        if not f32["finite"]:
            bad.append(f"(c') {arch}: {f32}")
        ref = r0["f32_one_card"]
        log(f"[ssmtp4] (a) {arch} float32, {depth} layers, batch "
            f"{SSMTP4_F32_BATCH if on_card else 8}x{SSMTP4_F32_SEQ if on_card else 32}, one "
            f"card's unsharded step (peak {r0['one_card_peak_gb']:.2f} GB): losses "
            f"{ref['losses']} grad norms {ref['grad_norms']}")
        for mode in ("abi", "gspmd"):
            a = [r[arch][f"f32_{mode}"] for r in ranks]
            diff = {key: [max(abs(x[key][i] - ref[key][i]) / abs(ref[key][i]) for x in a)
                          for i in range(SSMTP4_F32_STEPS)] for key in ("losses", "grad_norms")}
            log(f"[ssmtp4] (a) {arch} {mode} at "
                f"{'(1, 4), ZeRO-1' if mode == 'abi' else '(2, 2), FSDP'}: losses "
                f"{a[0]['losses']} grad norms {a[0]['grad_norms']}; largest relative "
                f"difference to one card per step: losses "
                f"{[f'{v:.3e}' for v in diff['losses']]} (step 1's bound {TP4_LOSS_RTOL}), "
                f"grad norms {[f'{v:.3e}' for v in diff['grad_norms']]} ("
                + (f"step 1's bound {TP4_NORM_RTOL}" if arch == HYBRID_ARCH
                   else "a record: (e) holds the gradient")
                + f"); pack_transposed a step per rank {[x['packs'] for x in a]}; peak GB "
                f"{[round(x['peak_gb'], 2) for x in a]}")
            want_pack = [1 if (on_card and mode == "abi") else 0] * SSMTP4_F32_STEPS
            over = diff["losses"][0] > TP4_LOSS_RTOL or (
                arch == HYBRID_ARCH and diff["grad_norms"][0] > TP4_NORM_RTOL)
            finite = all(math.isfinite(v) for x in a for k in ("losses", "grad_norms")
                         for v in x[k])
            if over or not finite or any(x["packs"] != want_pack for x in a):
                bad.append(f"(a) {arch} {mode}: {diff}, packs {[x['packs'] for x in a]}")
        if on_card:
            for key in ("f32_fwd_last", "f32_abi_last", "f32_gspmd_last"):
                calls = [r[arch][key] for r in ranks]
                log(f"[ssmtp4] (c', a) {arch} {key}: the last {name} call against its plain "
                    f"version per rank {json.dumps(calls)}")
                if not all(c.get(name, {}).get("ok") for c in calls):
                    bad.append(f"(c', a) {arch} {key} {calls}")
        if arch == SSM_ARCH:
            split, one = r0["f64"], r0["f64_one_card"]
            lg = r0["f64_logits"]
            tol = SSMTP4_F64_TOL
            leaves = []
            for n, o in one["leaves"].items():
                x = split["leaves"][n]
                norm = math.sqrt(o["sq"])
                errs = dict(norm=abs(math.sqrt(x["sq"]) - norm) / max(norm, 1e-300),
                            dot=abs(x["dot"] - o["dot"]) / max(norm * math.sqrt(o["probe_sq"]),
                                                               1e-300),
                            block=o["block_max_abs"] / max(o["g_max"], 1e-300))
                leaves.append((max(errs.values()), n, errs))
            worst = max(leaves)
            g_rel = abs(split["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
            l_rel = abs(split["loss"] - one["loss"]) / abs(one["loss"])
            log(f"[ssmtp4] (e) {arch} float64, {depth} layers, the plain scan: split (1, 4) "
                f"against one card's whole model: logits {lg['split']['max_abs']:.3e} of "
                f"{lg['split']['scale']:.3f}; loss {split['loss']!r} vs {one['loss']!r} "
                f"({l_rel:.3e}); grad norm {split['grad_norm']!r} vs {one['grad_norm']!r} "
                f"({g_rel:.3e}); worst leaf {worst[1]} {json.dumps(worst[2])} (bound {tol}); "
                f"the float32 logits against one card's float64: split "
                f"{lg['f32_split']['max_abs']:.3e}, one card {lg['f32_one_card']['max_abs']:.3e}")
            if (lg["split"]["max_abs"] > tol * lg["split"]["scale"] or l_rel > tol
                    or g_rel > tol or worst[0] > tol or not lg["split"]["finite"]):
                bad.append(f"(e) {arch}: logits {lg['split']}, loss {l_rel}, grad norm {g_rel}, "
                           f"worst leaf {worst}")
        for mode in ("abi", "gspmd"):
            b = [r[arch][f"bf16_{mode}"] for r in ranks]
            ms = statistics.median(b[0]["ms"][SSMTP4_WARM:])
            micro = cfg.parallelism.microbatch
            per_step = 2 * L * micro if on_card else 0
            got = [x.get("launches", [{}] * len(x["ms"])) for x in b]
            log(f"[ssmtp4] (b) {arch} {mode} at "
                f"{'(1, 4), per-leaf' if mode == 'abi' else '(2, 2), FSDP'} bf16, {L} layers, "
                f"batch {TRAIN_BATCH if on_card else 8}x{TRAIN_SEQ if on_card else 32}: losses "
                f"{[round(v, 4) for v in b[0]['losses']]} grad norms "
                f"{[round(v, 4) for v in b[0]['grad_norms']]}; ms/step per rank "
                f"{[[round(t, 1) for t in x['ms']] for x in b]} (rank 0's median of the "
                f"{SSMTP4_TIMED} after {SSMTP4_WARM} warm {ms:.1f}); peak GB per card "
                f"{[round(x['peak_gb'], 2) for x in b]}; bytes of weights per card "
                f"{[x['held_bytes'] for x in b]} of {b[0]['whole_bytes']} (the held specs "
                f"give {[x['expect_bytes'] for x in b]})"
                + (f"; {name} launches a step (rank 0) {[c[name] for c in got[0]]}"
                   if mode == "abi" else ""))
            if any(x["losses"] != b[0]["losses"] or not all(math.isfinite(v)
                                                            for v in x["losses"]) for x in b):
                bad.append(f"(b) {arch} {mode}: losses {[x['losses'] for x in b]}")
            if mode == "abi" and any(c[name] != per_step for g in got for c in g):
                bad.append(f"(b) {arch} {name} launches a step {[[c[name] for c in g] for g in got]}"
                           f", expected {per_step}")
            if any(x["held_bytes"] != x["expect_bytes"] for x in b):
                bad.append(f"(b) {arch} {mode}: bytes held {[x['held_bytes'] for x in b]}, "
                           f"by the held specs {[x['expect_bytes'] for x in b]}")
        launches[name] += fl[0][name]
        launches["flash_attention"] += fl[0]["flash_attention"]
        launches["pack_transposed"] += sum(sum(r0[f"f32_{m}"]["packs"]) for m in ("abi",))
    log(f"[ssmtp4] phase wall {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("[ssmtp4] " + "; ".join(bad))
    return launches


# ---------------------------------------------------------------------------
# [mmtp4]: the encdec and vlm families on the model axis, four cards
# ---------------------------------------------------------------------------
MMTP4 = 4
MMTP4_ARCHS = (ENCDEC_ARCH, VLM_ARCH)
#: (a) float32 parity, 3 steps a mode: (depth, batch, sequence) a family;
#: whisper-tiny at its full 4 + 4 layers over the config's 1500 frames,
#: phi-3-vision-4.2b at 2 of 32 layers after its 576 image tokens
MMTP4_F32 = {ENCDEC_ARCH: (None, 8, 448), VLM_ARCH: (2, 8, 256)}
MMTP4_F32_STEPS = 3
#: (b) phi-3-vision-4.2b in bf16 at full depth, batch 8 x 1024 text tokens:
#: one warm step, then the timed ones, a mode
MMTP4_WARM, MMTP4_TIMED = 1, 2
#: (c) the TP forward under flash at full depth, B=4: text positions
#: (phi-3-vision-4.2b's after its 576 image tokens; whisper's decoder)
MMTP4_FWD = {ENCDEC_ARCH: 448, VLM_ARCH: 2048}
#: (c) the split bf16 forward's distance to the float32 forward of the same
#: bf16 weights, at most this many times one card's own
MMTP4_TO_F32_RATIO = 2.0
#: (c') phi-3-vision-4.2b's float32 forward at full depth against one card's:
#: batch, text positions after the 576 image tokens
MMTP4_F32_FWD = (1, 512)
#: (d) the split decode in float32 on a float32 cache: depth, batch, the
#: vlm's prompt after the image, steps
MMTP4_DEC_DEPTH, MMTP4_DEC_BATCH, MMTP4_DEC_PROMPT, MMTP4_DEC_STEPS = 2, 2, 64, 8
#: where each leg runs: (1, 4) or (2, 2); whisper's 6 heads split only at
#: (2, 2), its MLPs at both
MMTP4_FWD_MESHES = {ENCDEC_ARCH: ((1, 4), (2, 2)), VLM_ARCH: ((1, 4),)}
MMTP4_DEC_MESH = {ENCDEC_ARCH: (2, 2), VLM_ARCH: (1, 4)}
MMTP4_TIMEOUT = 900
#: NCCL's wait for a collective in [mmtp4]'s ranks
MMTP4_NCCL_TIMEOUT_S = 240


def _mmtp4_cfg(arch: str, device: str, depth, grad_sync: str, mesh: tuple,
               f32: bool = False, zero1: bool = True, **change):
    """``arch`` at full width (the smoke config on the CPU), ``depth``
    decoder (and encoder) layers (None: the config's), ``grad_sync``, the
    ABI step's ZeRO-1 (``zero1``) or per-leaf layout, ``tp_size`` the
    mesh's model axis (so whisper's 6 heads split at 2, not at 4), float32
    weights and compute with ``f32``."""
    import dataclasses

    from repro_torch import configs

    on_card = device != "cpu"
    cfg = configs.get_config(arch) if on_card else configs.smoke_config(arch)
    par = dict(grad_sync=grad_sync, zero1=zero1, tp_size=mesh[1])
    if not on_card:
        par.update(microbatch=4, remat="full")
    if depth is not None:
        change["num_layers"] = depth
        if cfg.encdec is not None:
            change["encdec"] = dataclasses.replace(cfg.encdec, encoder_layers=depth)
    cfg = dataclasses.replace(cfg, **change, parallelism=dataclasses.replace(
        cfg.parallelism, **par))
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    return cfg


def _mmtp4_heads(model, cfg) -> list:
    """(query heads, K/V heads, head width) of the decoder's self-attention
    as ``model`` holds it."""
    a = model.dec_layers.attn if cfg.family == "encdec" else model.layers.attn
    hd = cfg.resolved_head_dim
    return [int(a.wq.shape[-1] // hd), int(a.wk.shape[-1] // hd), hd]


def _mmtp4_decode(api, model, cfg, b: dict, dist) -> tuple:
    """The split decode on a float32 cache: whisper's ``init_cache`` on the
    frames, the vlm's ``prefill_multimodal`` of the patches and the first
    ``MMTP4_DEC_PROMPT`` tokens, then a ``decode_step`` for each later
    token: (each step's logits, the cache's K/V heads)."""
    import torch
    from repro_torch.models import encdec, vlm

    tok = b["tokens"]
    B, n = tok.shape
    with torch.no_grad():
        if cfg.family == "encdec":
            cache = encdec.init_cache(model, b["frames"], cfg, B, n, dist, dtype=torch.float32)
            first, index, heads = 0, 0, int(cache.cross_k.shape[3])
        else:
            first = MMTP4_DEC_PROMPT
            _, cache, index = vlm.prefill_multimodal(
                model, tok[:, :first], b["patches"], cfg, dist,
                max_seq=cfg.vlm.num_patches + n, dtype=torch.float32)
            heads = int(cache.k.shape[3])
        out = []
        for i in range(n - first):
            logits, cache = api.decode_step(model, tok[:, first + i:first + i + 1], cache,
                                            index + i, dist)
            out.append(logits.float())
    return out, heads


def _mmtp4_rank(rank: int, world: int, init_method: str, out_dir: str,
                device: str = "cuda") -> None:
    """One rank of [mmtp4] (``device="cpu"``: the smoke configs on gloo).
    One world; mesh (1, 4), and (2, 2) built on it.  Each rank holds its
    block of one card's draw from seed 0.  (c) The bf16 TP forward at full
    depth under flash, B=4: phi-3-vision-4.2b at (1, 4) over 576 image and
    2048 text positions, whisper-tiny at (1, 4) (its 6 heads whole, its MLPs
    split) and at (2, 2) (3/3 heads); the flash launches, the last call
    held to ``attention_ref``.  (c') phi-3-vision-4.2b's float32 forward at
    full depth at (1, 4), B=1.  (a) float32 steps of both families
    (``MMTP4_F32``) under the ABI ZeRO-1 step at (1, 4) and ``gspmd`` with
    FSDP at (2, 2).  (d) The split decode in float32 (``_mmtp4_decode``):
    phi-3-vision at (1, 4), whisper at (2, 2).  (b) phi-3-vision-4.2b's bf16
    steps at full depth, batch 8 x 1024: the ABI ZeRO-1 step at (1, 4) on
    (c)'s model, ``gspmd`` with FSDP at (2, 2).  Rank 0 then runs the
    one-card references on its card with no process group: the whole
    models' forwards (timed; and in float32 on the same bf16 weights), the
    float32 forward, unsharded float32 steps and decodes, and flash alone at
    a rank's heads.  Each leg's records are saved as it
    ends."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch
    from repro_torch.core import Mesh
    from repro_torch.models import build_model, make_batch
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.dist import make_dist
    from repro_torch.train import train_loop as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device != "cpu"
    torch.set_num_threads(1)
    dev = torch.device(f"cuda:{rank}") if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
        # a rank that fails between collectives ends the others within
        # minutes, not NCCL's default ten (make_dist joins this world)
        import datetime

        torch.distributed.init_process_group(
            "nccl", init_method=f"file://{Path(out_dir) / 'world'}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=MMTP4_NCCL_TIMEOUT_S))
    B, S = (TRAIN_BATCH, TRAIN_SEQ) if on_card else (8, 32)
    data = {}
    for i, arch in enumerate(MMTP4_ARCHS):
        c = _mmtp4_cfg(arch, device, None, "abi", (1, MMTP4))
        _, b32, s32 = MMTP4_F32[arch]
        b32, s32 = (b32, s32) if on_card else (8, 32)
        data[arch] = dict(
            f32=[make_batch(10 * i + j, c, b32, s32, "cpu") for j in range(MMTP4_F32_STEPS)],
            f32_fwd=make_batch(400 + i, c, *(MMTP4_F32_FWD if on_card else (1, 16)), "cpu"),
            fwd=make_batch(100 + i, c, FWD_BATCH, MMTP4_FWD[arch] if on_card else 32, "cpu"),
            decode=make_batch(200 + i, c, MMTP4_DEC_BATCH,
                              (MMTP4_DEC_PROMPT if arch == VLM_ARCH else 0) + MMTP4_DEC_STEPS,
                              "cpu"))
    bf16 = [make_batch(300 + j, _mmtp4_cfg(VLM_ARCH, device, None, "abi", (1, MMTP4)), B, S,
                       "cpu") for j in range(MMTP4_WARM + MMTP4_TIMED)]
    rec: dict = {a: {} for a in MMTP4_ARCHS}
    keep: dict = {a: {} for a in MMTP4_ARCHS}
    t0 = time.perf_counter()

    def done(leg: str) -> None:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
        log(f"[mmtp4] rank {rank}: {leg} done at {time.perf_counter() - t0:.1f} s")

    def free() -> None:
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def on(b: dict) -> dict:
        return {k: v.to(dev) for k, v in b.items()}

    with make_dist(device=str(dev), model_axis=MMTP4, world_size=world, rank=rank,
                   init_method=f"file://{Path(out_dir) / 'world'}") as dist4:
        dist22 = make_dist(mesh=Mesh(("data", "model"), (2, 2), dist4.device))
        dists = {(1, MMTP4): dist4, (2, 2): dist22}
        try:
            vlm_model = None
            for arch in MMTP4_ARCHS:
                r = rec[arch]
                for mesh in MMTP4_FWD_MESHES[arch]:
                    # (c) the bf16 TP forward at full depth under flash
                    tag = f"fwd_{mesh[0]}{mesh[1]}"
                    cfg = _mmtp4_cfg(arch, device, None, "abi", mesh, attention_impl="flash")
                    api = build_model(cfg)
                    t = time.perf_counter()
                    model = api.init(0, dev, **tl.model_part(api, dists[mesh]))
                    r[f"{tag}_draw_s"] = time.perf_counter() - t
                    r[f"{tag}_part"] = list(dataclasses.astuple(model.part))
                    r[f"{tag}_split"] = sorted(n for n, sp in model.held.items() if "tp" in sp)
                    r[f"{tag}_heads"] = _mmtp4_heads(model, cfg)
                    batch = on(data[arch]["fwd"])
                    with torch.no_grad(), _FlashSpy() as spy:
                        _zero_counts()
                        logits, t1 = _timed(lambda: api.forward(model, batch, dists[mesh]),
                                            on_card, dev)
                        r[f"{tag}_flash"] = _counts()["flash_attention"]
                        if on_card:
                            try:  # recorded, not raised: the world goes on
                                spy.check(f"mmtp4 {arch} {mesh}")
                                r[f"{tag}_last"] = dict(ok=True)
                            except AssertionError as e:
                                r[f"{tag}_last"] = dict(ok=False, error=str(e))
                        r[f"{tag}_ms"] = [_timed(lambda: api.forward(model, batch, dists[mesh]),
                                                 on_card, dev)[1] for _ in range(3)]
                    r[f"{tag}_first_ms"] = t1
                    if rank == 0:
                        keep[arch][tag] = logits.cpu()
                    del logits
                    if arch == VLM_ARCH:
                        vlm_model = model
                    del model
                    free()
                    done(f"(c) {arch} the bf16 forward at {mesh}")
                if arch == VLM_ARCH:
                    # (c') the float32 forward at full depth
                    api = build_model(_mmtp4_cfg(arch, device, None, "abi", (1, MMTP4),
                                                 f32=True))
                    model = api.init(0, dev, **tl.model_part(api, dist4))
                    with torch.no_grad():
                        logits = api.forward(model, on(data[arch]["f32_fwd"]), dist4)
                    if rank == 0:
                        keep[arch]["f32_fwd"] = logits.cpu()
                    del model, logits
                    free()
                    done(f"(c') {arch} the float32 forward at (1, {MMTP4})")
                # (a) float32 steps against one card
                depth = MMTP4_F32[arch][0] if on_card else None
                for mode, mesh in (("abi", (1, MMTP4)), ("gspmd", (2, 2))):
                    api = build_model(_mmtp4_cfg(arch, device, depth, mode, mesh, f32=True))
                    r[f"f32_{mode}"] = _tp4_steps(api, dists[mesh], data[arch]["f32"], on_card,
                                                  dev)
                    free()
                    done(f"(a) {arch} float32 {mode} at {mesh}")
                # (d) the split decode, float32
                mesh = MMTP4_DEC_MESH[arch]
                api = build_model(_mmtp4_cfg(arch, device, MMTP4_DEC_DEPTH, "abi", mesh,
                                             f32=True))
                model = api.init(0, dev, **tl.model_part(api, dists[mesh]))
                steps, r["decode_heads"] = _mmtp4_decode(api, model, api.cfg,
                                                         on(data[arch]["decode"]), dists[mesh])
                if rank == 0:
                    keep[arch]["decode"] = [x.cpu() for x in steps]
                del model, steps
                free()
                done(f"(d) {arch} the split decode at {mesh}")
            # (b) phi-3-vision-4.2b bf16 at full depth: the ABI ZeRO-1 step at
            # (1, 4) on (c)'s model, then gspmd with FSDP at (2, 2)
            r = rec[VLM_ARCH]
            api = build_model(_mmtp4_cfg(VLM_ARCH, device, None, "abi", (1, MMTP4)))
            r["bf16_abi"] = _tp4_steps(api, dist4, bf16, on_card, dev, model=vlm_model)
            del vlm_model
            free()
            done("(b) bf16 abi ZeRO-1 at (1, 4)")
            api = build_model(_mmtp4_cfg(VLM_ARCH, device, None, "gspmd", (2, 2)))
            r["bf16_gspmd"] = _tp4_steps(api, dist22, bf16, on_card, dev)
            free()
            done("(b) bf16 gspmd at (2, 2)")
        finally:
            dist22.shutdown()
    if rank == 0:
        # the one-card references, no process group
        for arch in MMTP4_ARCHS:
            r = rec[arch]
            cfg = _mmtp4_cfg(arch, device, None, "abi", (1, 1), attention_impl="flash")
            api = build_model(cfg)
            model = api.init(0, dev)
            batch = on(data[arch]["fwd"])
            with torch.no_grad():
                want = api.forward(model, batch)
                r["one_fwd_ms"] = [_timed(lambda: api.forward(model, batch), on_card, dev)[1]
                                   for _ in range(3)]
                # the same bf16 weights computed in float32 (xla attention): how
                # far each bf16 forward's rounding carries it
                api32 = build_model(dataclasses.replace(
                    cfg, param_dtype="float32", compute_dtype="float32", attention_impl="xla"))
                exact = api32.forward(model.float(), batch).float()
                r["one_to_f32"] = float((want.float() - exact).abs().max())
                for mesh in MMTP4_FWD_MESHES[arch]:
                    tag = f"fwd_{mesh[0]}{mesh[1]}"
                    got = keep[arch].pop(tag).to(dev)
                    diff = (got.float() - want.float()).abs()
                    r[f"{tag}_vs_one_card"] = dict(
                        max_abs=float(diff.max()), median_abs=float(diff.flatten()[::101].median()),
                        scale=float(want.float().abs().max()),
                        argmax_agree=float((got.argmax(-1) == want.argmax(-1)).float().mean()),
                        to_f32=float((got.float() - exact).abs().max()),
                        finite=bool(torch.isfinite(got).all()))
                    del got, diff
            del model, want, exact
            free()
            if arch == VLM_ARCH:
                api = build_model(_mmtp4_cfg(arch, device, None, "abi", (1, 1), f32=True))
                model = api.init(0, dev)
                with torch.no_grad():
                    want = api.forward(model, on(data[arch]["f32_fwd"]))
                r["f32_fwd_vs_one_card"] = _ssmtp4_vs(keep[arch].pop("f32_fwd").to(dev), want)
                del model, want
                free()
            depth = MMTP4_F32[arch][0] if on_card else None
            api = build_model(_mmtp4_cfg(arch, device, depth, "gspmd", (1, 1), f32=True))
            model = api.init(0, dev)
            state = tl.TrainState(model, adamw.init_tree(tl.param_leaves(model)),
                                  torch.zeros((), dtype=torch.int32, device=dev))
            step = tl.make_train_step(api, None, AdamWConfig())
            ref = dict(losses=[], grad_norms=[])
            for b in data[arch]["f32"]:
                state, met = step(state, on(b))
                ref["losses"].append(float(met.loss))
                ref["grad_norms"].append(float(met.grad_norm))
            r["f32_one_card"] = ref
            del state, model, step
            free()
            api = build_model(_mmtp4_cfg(arch, device, MMTP4_DEC_DEPTH, "abi", (1, 1), f32=True))
            model = api.init(0, dev)
            want, _ = _mmtp4_decode(api, model, api.cfg, on(data[arch]["decode"]), None)
            r["decode_vs_one_card"] = [_ssmtp4_vs(g.to(dev), w)
                                       for g, w in zip(keep[arch]["decode"], want)]
            del model, want
            free()
            done(f"the one-card references of {arch}")
        if on_card:
            # flash alone at a rank's heads: phi-3-vision's 8/8 of D=96 over
            # 576 + 2048 positions, whisper's 3/3 of D=64 over 448
            gen = torch.Generator(device=dev).manual_seed(3)
            for arch, heads in ((VLM_ARCH, 8), (ENCDEC_ARCH, 3)):
                c = _mmtp4_cfg(arch, device, None, "abi", (1, 1))
                S_all = MMTP4_FWD[arch] + (c.vlm.num_patches if c.vlm else 0)
                rec[arch]["flash_time"] = _time_flash(
                    "mmtp4", (FWD_BATCH, S_all, heads, heads, c.resolved_head_dim), "bfloat16",
                    BF16_FLOP_PER_S, gen)
    done("the one-card references" if rank == 0 else "all legs")


def phase_mmtp4(card: str, device: str = "cuda",
                out_dir: Path = HERE / "build" / "mmtp4") -> dict:
    """[mmtp4] (four cards, NCCL; ``device="cpu"``: the smoke configs on
    gloo, a rehearsal): :func:`_mmtp4_rank` on four spawned ranks.  Gates:
    (c) each TP forward launches flash once a decoder layer on every rank
    (phi-3-vision-4.2b 32 at 8/8 heads of D=96, whisper-tiny 4 at 6/6 heads
    at (1, 4) and 3/3 at (2, 2); 0 on the CPU), the last call held to
    ``attention_ref``, the logits finite and their distance to the float32
    forward of the same bf16 weights at most ``MMTP4_TO_F32_RATIO`` times one
    card's on the cards (their distance to one card's bf16 logits a record: at 32 layers
    the bf16 roundings of two summation orders part by more than
    ``TP4_LOGIT_TOL``); (c') phi-3-vision-4.2b's
    float32 forward at full depth within ``F32_LOGIT_TOL`` of one card's;
    (a) each family's float32 step-1 loss within
    ``TP4_LOSS_RTOL`` and grad norm within ``TP4_NORM_RTOL`` of one card's
    unsharded step, in both modes, every value finite (steps 2 and 3 a
    record), ``pack_transposed`` once a step per rank under the ABI ZeRO-1
    step (0 under ``gspmd``; 0 on the CPU); (d) each split decode step
    within ``F32_LOGIT_TOL`` of one card's, whisper's caches at 3 of 6 K/V
    heads a rank; (b) phi-3-vision-4.2b's bf16 losses finite and equal on
    every rank, ``pack_transposed`` once a step under the ABI ZeRO-1 step,
    a card's weight bytes exactly what its held specs give.  The ranks'
    records stay in ``out_dir``.  Returns the launches by kernel on rank
    0."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    on_card = device != "cpu"
    try:
        ranks = _spawn_ranks("mmtp4", _mmtp4_rank, MMTP4, out_dir, device,
                             timeout=MMTP4_TIMEOUT)
    except RuntimeError:
        for r in range(MMTP4):
            part = out_dir / f"rank{r}.json"
            log(f"[mmtp4] rank {r}'s records so far: "
                f"{part.read_text() if part.exists() else 'none'}")
        raise
    where = card if on_card else "gloo"
    width = "full width" if on_card else "smoke"
    bad = []
    launches = {"flash_attention": 0, "pack_transposed": 0}
    rel = lambda x, y: abs(x - y) / abs(y)  # noqa: E731
    for arch in MMTP4_ARCHS:
        r0 = ranks[0][arch]
        cfg = _mmtp4_cfg(arch, device, None, "abi", (1, MMTP4))
        L = cfg.num_layers
        hd = cfg.resolved_head_dim
        for mesh in MMTP4_FWD_MESHES[arch]:
            tag = f"fwd_{mesh[0]}{mesh[1]}"
            fl = [r[arch][f"{tag}_flash"] for r in ranks]
            heads = [r[arch][f"{tag}_heads"] for r in ranks]
            R = mesh[1]
            want_heads = [cfg.num_heads // R if cfg.num_heads % R == 0 else cfg.num_heads,
                          cfg.num_kv_heads // R if cfg.num_kv_heads % R == 0
                          else cfg.num_kv_heads, hd]
            one = r0[f"{tag}_vs_one_card"]
            positions = MMTP4_FWD[arch] + (cfg.vlm.num_patches if cfg.vlm else 0)
            log(f"[mmtp4] (c) {arch} {width} on four ranks of {where} at {mesh}, bf16 forward "
                f"under flash, {L} layers, B={FWD_BATCH}, {positions if on_card else 32} "
                f"positions: parts {[r[arch][f'{tag}_part'] for r in ranks]}; split leaves "
                f"(rank 0) {r0[f'{tag}_split']}; heads a rank {heads[0]}; flash launches per "
                f"rank {fl}; the last call (rank 0) {json.dumps(r0.get(f'{tag}_last'))}; ms "
                f"per forward (rank 0) {[round(t, 2) for t in r0[f'{tag}_ms']]} after a first "
                f"{r0[f'{tag}_first_ms']:.1f}, one card's whole model "
                f"{[round(t, 2) for t in r0['one_fwd_ms']]}; the weight draw "
                f"{r0[f'{tag}_draw_s']:.1f} s; against one card's logits {json.dumps(one)} (a "
                f"record; one card's own bf16 logits are {r0['one_to_f32']:.4f} from the f32 "
                f"forward of the same bf16 weights, the split's {one['to_f32']:.4f}, bound "
                f"{MMTP4_TO_F32_RATIO}x one card's)")
            if any(f != (L if on_card else 0) for f in fl):
                bad.append(f"(c) {arch} {mesh} flash launches {fl}")
            if any(h != want_heads for h in heads):
                bad.append(f"(c) {arch} {mesh} heads a rank {heads}, expected {want_heads}")
            if on_card and not all(r[arch][f"{tag}_last"]["ok"] for r in ranks):
                bad.append(f"(c) {arch} {mesh} the last flash call "
                           f"{[r[arch][f'{tag}_last'] for r in ranks]}")
            # (the CPU rehearsal computes in float32: both distances are rounding)
            if not one["finite"] or (on_card and one["to_f32"]
                                     > MMTP4_TO_F32_RATIO * r0["one_to_f32"]):
                bad.append(f"(c) {arch} {mesh} logits {one}, one card's distance to the f32 "
                           f"forward {r0['one_to_f32']}")
            launches["flash_attention"] += fl[0]
        if arch == VLM_ARCH:
            f32 = r0["f32_fwd_vs_one_card"]
            fb, fs = MMTP4_F32_FWD if on_card else (1, 16)
            log(f"[mmtp4] (c') {arch} float32 forward at (1, {MMTP4}), {L} layers, B={fb}, "
                f"{fs} text positions after the image, against one card's whole model: "
                f"{json.dumps(f32)} (bound {F32_LOGIT_TOL})")
            if not f32["finite"] or f32["max_abs"] > F32_LOGIT_TOL:
                bad.append(f"(c') {arch}: {f32}")
        ref = r0["f32_one_card"]
        depth = MMTP4_F32[arch][0] or L if on_card else L
        _, b32, s32 = MMTP4_F32[arch]
        log(f"[mmtp4] (a) {arch} float32, {depth} layers, batch "
            f"{b32 if on_card else 8}x{s32 if on_card else 32}, one card's unsharded step: "
            f"losses {ref['losses']} grad norms {ref['grad_norms']}")
        for mode, mesh in (("abi", (1, MMTP4)), ("gspmd", (2, 2))):
            a = [r[arch][f"f32_{mode}"] for r in ranks]
            diff = {key: [max(rel(x[key][i], ref[key][i]) for x in a)
                          for i in range(MMTP4_F32_STEPS)] for key in ("losses", "grad_norms")}
            log(f"[mmtp4] (a) {arch} {mode} at {mesh}"
                f"{', ZeRO-1' if mode == 'abi' else ', FSDP'}: losses {a[0]['losses']} grad "
                f"norms {a[0]['grad_norms']}; largest relative difference to one card per "
                f"step: losses {[f'{v:.3e}' for v in diff['losses']]} (step 1's bound "
                f"{TP4_LOSS_RTOL}), grad norms {[f'{v:.3e}' for v in diff['grad_norms']]} "
                f"(step 1's bound {TP4_NORM_RTOL}); pack_transposed a step per rank "
                f"{[x['packs'] for x in a]}; parts {[x['part'] for x in a]}; peak GB "
                f"{[round(x['peak_gb'], 2) for x in a]}")
            want_pack = [1 if (on_card and mode == "abi") else 0] * MMTP4_F32_STEPS
            finite = all(math.isfinite(v) for x in a for k in ("losses", "grad_norms")
                         for v in x[k])
            if (diff["losses"][0] > TP4_LOSS_RTOL or diff["grad_norms"][0] > TP4_NORM_RTOL
                    or not finite or any(x["packs"] != want_pack for x in a)):
                bad.append(f"(a) {arch} {mode}: {diff}, packs {[x['packs'] for x in a]}")
            if mode == "abi":
                launches["pack_transposed"] += sum(a[0]["packs"])
        dec = r0["decode_vs_one_card"]
        mesh = MMTP4_DEC_MESH[arch]
        dec_heads = [r[arch]["decode_heads"] for r in ranks]
        want_h = cfg.num_kv_heads // mesh[1] if cfg.num_kv_heads % mesh[1] == 0 \
            else cfg.num_kv_heads
        log(f"[mmtp4] (d) {arch} the split decode at {mesh}, float32 on a float32 cache, "
            f"{MMTP4_DEC_DEPTH} layers, B={MMTP4_DEC_BATCH}, "
            + (f"{cfg.vlm.num_patches if on_card else 'the'} patches and a "
               f"{MMTP4_DEC_PROMPT}-token prompt, " if arch == VLM_ARCH else "init_cache, ")
            + f"{MMTP4_DEC_STEPS} steps: K/V heads a rank {dec_heads}; against one card: max "
            f"abs per step {[f'{x['max_abs']:.3e}' for x in dec]} of "
            f"{[f'{x['scale']:.3f}' for x in dec]} (bound {F32_LOGIT_TOL})")
        if any(not x["finite"] or x["max_abs"] > F32_LOGIT_TOL for x in dec) or len(dec) != \
                MMTP4_DEC_STEPS:
            bad.append(f"(d) {arch}: {dec}")
        if any(h != want_h for h in dec_heads):
            bad.append(f"(d) {arch} K/V heads a rank {dec_heads}, expected {want_h}")
        if on_card:
            t = r0["flash_time"]
            log(f"[mmtp4] {arch} flash alone at a rank's heads (rank 0's card): "
                f"{json.dumps({k: (round(v, 4) if isinstance(v, float) else v) for k, v in t.items()})}")
    r0 = ranks[0][VLM_ARCH]
    for mode in ("abi", "gspmd"):
        b = [r[VLM_ARCH][f"bf16_{mode}"] for r in ranks]
        ms = statistics.median(b[0]["ms"][MMTP4_WARM:])
        want_pack = [1 if (on_card and mode == "abi") else 0] * len(b[0]["ms"])
        log(f"[mmtp4] (b) {VLM_ARCH} {mode} at "
            f"{'(1, 4), ZeRO-1 flat' if mode == 'abi' else '(2, 2), FSDP, per-leaf'} bf16, "
            f"{_mmtp4_cfg(VLM_ARCH, device, None, mode, (1, MMTP4)).num_layers} layers, batch "
            f"{TRAIN_BATCH if on_card else 8}x{TRAIN_SEQ if on_card else 32}, microbatch 4, "
            f"remat full: losses {[round(v, 4) for v in b[0]['losses']]} grad norms "
            f"{[round(v, 4) for v in b[0]['grad_norms']]}; ms/step per rank "
            f"{[[round(t, 1) for t in x['ms']] for x in b]} (rank 0's median of the "
            f"{MMTP4_TIMED} after {MMTP4_WARM} warm {ms:.1f}); peak GB per card "
            f"{[round(x['peak_gb'], 2) for x in b]}; bytes of weights per card "
            f"{[x['held_bytes'] for x in b]} of {b[0]['whole_bytes']} (the held specs give "
            f"{[x['expect_bytes'] for x in b]}); pack_transposed a step {[x['packs'] for x in b]}")
        if any(x["losses"] != b[0]["losses"] or not all(math.isfinite(v) for v in x["losses"])
               for x in b):
            bad.append(f"(b) {mode}: losses {[x['losses'] for x in b]}")
        if any(x["held_bytes"] != x["expect_bytes"] for x in b):
            bad.append(f"(b) {mode}: bytes held {[x['held_bytes'] for x in b]}, by the held "
                       f"specs {[x['expect_bytes'] for x in b]}")
        if any(x["packs"] != want_pack for x in b):
            bad.append(f"(b) {mode}: pack_transposed {[x['packs'] for x in b]}")
        if mode == "abi":
            launches["pack_transposed"] += sum(b[0]["packs"])
    log(f"[mmtp4] phase wall {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("[mmtp4] " + "; ".join(bad))
    return launches


CU = "src/repro_torch/kernels/ring_wire/csrc/"
TPU = "src/repro/kernels/ring_wire/kernel.py:"
#: name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "pack_transposed": (CU + "ring_wire.cu", TPU + "152"),
    "unpack_transposed": (CU + "ring_wire.cu", TPU + "195"),
    "pack_transposed_ef": (CU + "ring_wire.cu", TPU + "174"),
    "quant_i8": (CU + "ring_hops.cu", TPU + "61"),
    "hop_add_quant_i8": (CU + "ring_hops.cu", TPU + "82"),
    "hop_accum_i8": (CU + "ring_hops.cu", TPU + "97"),
    "hop_add_quant_bf16": (CU + "ring_hops.cu", TPU + "115"),
    "hop_accum_bf16": (CU + "ring_hops.cu", TPU + "128"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
                        "src/repro/kernels/flash_attention/kernel.py:75"),
    "ssd": ("src/repro_torch/kernels/mamba2_ssd/csrc/ssd_wgmma.cu",
            "src/repro/kernels/mamba2_ssd/kernel.py:62"),
    "wkv6": ("src/repro_torch/kernels/rwkv6_scan/csrc/wkv6_wgmma.cu",
             "src/repro/kernels/rwkv6_scan/kernel.py:60"),
}


def _need_cards(name: str, n: int) -> None:
    import torch

    if torch.cuda.device_count() < n:
        raise RuntimeError(f"[{name}] needs {n} cards, found {torch.cuda.device_count()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("check", "ring4", "serve", "swap", "fault", "fault4",
                                       "ssm", "moe", "mm", "moe4", "ep4", "pp4", "tp4",
                                       "moetp4", "ssmtp4", "mmtp4"),
                    default=None,
                    help="check: stop after building and checking the kernels; "
                         "mmtp4: build, then only the four-card model axis of the encdec and "
                         "vlm families (whisper-tiny and phi-3-vision-4.2b); "
                         "ssmtp4: build, then only the four-card model axis of the ssm and "
                         "hybrid families (rwkv6-7b and zamba2-2.7b); "
                         "tp4: build, then only the four-card tensor parallelism and FSDP "
                         "of gemma-7b; "
                         "moetp4: build, then only the four-card model axis of the moe "
                         "family (qwen2-moe-a2.7b and grok-1-314b); "
                         "ep4: build, then only the four-card expert-parallel training; "
                         "pp4: only the four-card pipeline (no build); "
                         "moe: build, then only [train-moe], [forward-moe] and [serve-moe]; "
                         "mm: build, then only flash's [check] and the encdec and vlm "
                         "phases; "
                         "moe4: build, then only the four-card expert parallelism; "
                         "ssm: build, then only [train-ssm], [train-hybrid], [serve-ssm] "
                         "and [serve-hybrid]; "
                         "ring4: build, then only the four-card int8 ring; "
                         "serve: only [serve], which launches no kernel (no build); "
                         "swap: build, then only [abi-swap]; "
                         "fault: build, then only [fault]; "
                         "fault4: build, then only the four-card elastic shrink")
    ap.add_argument("--baseline", action="append", default=[], metavar="NAME=PATH",
                    help="an earlier source of the scan NAME (wkv6 or ssd; entry point "
                         "pax_NAME) to time in turns with the current kernel in [time]")
    args = ap.parse_args()
    baselines = {}
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        if name not in BASELINE_DIMS or not path:
            ap.error(f"--baseline takes NAME=PATH with NAME in {sorted(BASELINE_DIMS)}: {spec}")
        baselines[name] = Path(path)
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

    dry: tuple = ()
    t_start = time.perf_counter()

    def wall(tag: str) -> None:
        log(f"[wall] {tag} done at {time.perf_counter() - t_start:.1f} s")

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
        if args.only == "serve":
            phase_serve(card)
            log("[only] serve: the engine served on the card; no result line")
            return 0
        if args.only == "pp4":
            _need_cards("pp4", PP4)
            phase_pp4(card)
            log("[only] pp4: the pipeline's loss and gradient matched one card; no result line")
            return 0
        phase_build()
        if args.only == "tp4":
            _need_cards("tp4", TP4)
            tp4 = phase_tp4(card)
            print(json.dumps({"kernels": [{"name": name, "launches_by_phase": {"tp4": n}}
                                          for name, n in tp4.items()]}), flush=True)
            log("[only] tp4: tensor parallelism and FSDP on four cards matched one card; no "
                "result line")
            return 0
        if args.only == "moetp4":
            _need_cards("moetp4", MOETP4)
            moetp4 = phase_moetp4(card)
            print(json.dumps({"kernels": [{"name": name, "launches_by_phase": {"moetp4": n}}
                                          for name, n in moetp4.items()]}), flush=True)
            log("[only] moetp4: the moe family on the model axis of four cards matched one "
                "card; no result line")
            return 0
        if args.only == "ssmtp4":
            _need_cards("ssmtp4", SSMTP4)
            ssmtp4 = phase_ssmtp4(card)
            print(json.dumps({"kernels": [{"name": name, "launches_by_phase": {"ssmtp4": n}}
                                          for name, n in ssmtp4.items()]}), flush=True)
            log("[only] ssmtp4: the ssm and hybrid families on the model axis of four cards "
                "matched one card; no result line")
            return 0
        if args.only == "mmtp4":
            _need_cards("mmtp4", MMTP4)
            mmtp4 = phase_mmtp4(card)
            print(json.dumps({"kernels": [{"name": name, "launches_by_phase": {"mmtp4": n}}
                                          for name, n in mmtp4.items()]}), flush=True)
            log("[only] mmtp4: the encdec and vlm families on the model axis of four cards "
                "matched one card; no result line")
            return 0
        if args.only == "ring4":
            if torch.cuda.device_count() < RING4:
                raise RuntimeError(f"[ring4] needs {RING4} cards, found "
                                   f"{torch.cuda.device_count()}")
            phase_ring4()
            log("[only] ring4: the int8 ring launched its hop kernels; no result line")
            return 0
        if args.only == "swap":
            phase_abi_swap(card)
            log("[only] swap: every backend trained bitwise alike; no result line")
            return 0
        if args.only == "fault":
            phase_fault(card)
            log("[only] fault: every fault scenario recovered bitwise; no result line")
            return 0
        if args.only == "ssm":
            for arch in (SSM_ARCH, HYBRID_ARCH):
                phase_train_recurrent(card, arch)
            for arch in (SSM_ARCH, HYBRID_ARCH):
                phase_serve_recurrent(card, arch)
            log("[only] ssm: both families trained and served on the card; no result line")
            return 0
        if args.only == "moe":
            phase_train_moe(card)
            _, model = phase_forward_moe(card)
            phase_serve_moe(card, model)
            log("[only] moe: the moe family trained, ran forward and served on the card; "
                "no result line")
            return 0
        if args.only == "mm":
            phase_check_flash()
            phase_mm(card)
            log("[only] mm: the encdec and vlm families ran forward, trained and decoded on "
                "the card; no result line")
            return 0
        if args.only == "moe4":
            if torch.cuda.device_count() < MOE4:
                raise RuntimeError(f"[moe4] needs {MOE4} cards, found "
                                   f"{torch.cuda.device_count()}")
            phase_moe4(card)
            log("[only] moe4: expert parallelism on four cards matched local mode; no result "
                "line")
            return 0
        if args.only == "ep4":
            _need_cards("ep4", EP4)
            phase_ep4(card)
            log("[only] ep4: expert-parallel training on four cards matched local mode; no "
                "result line")
            return 0
        if args.only == "fault4":
            if torch.cuda.device_count() < FAULT4:
                raise RuntimeError(f"[fault4] needs {FAULT4} cards, found "
                                   f"{torch.cuda.device_count()}")
            phase_fault4(card)
            log("[only] fault4: the survivors resumed bitwise at dp=2; no result line")
            return 0
        if args.only is None:
            # the dry run's CPU work runs beside the card's phases; [dryrun] reads it
            dry = _dryrun_start()
        wall("build")
        worst = phase_check(n_full)
        worst.update(phase_check_ring(n_full))
        worst.update(phase_check_flash())
        worst.update(phase_check_scans())
        wall("check")
        if args.only == "check":
            log("[only] check: the kernels built and agree; no result line")
            return 0
        timing = phase_time(n_full)
        timing.update(phase_time_ring(n_full))
        timing.update(phase_time_flash())
        timing.update(phase_time_scans(card, baselines))
        torch.cuda.empty_cache()
        wall("time")
        phase_small_reference()
        launches, uncompressed = phase_main_path()
        launches["pack_transposed_ef"] = phase_main_bf16()["pack_transposed_ef"]
        int8 = phase_main_int8(uncompressed)
        launches.update({k: int8[k] for k in HOPS})
        wall("main")
        gspmd_pack = phase_train_gspmd()
        phase_dryrun(card, dry)
        wall("train-gspmd, dryrun")
        phase_abi_swap(card)
        wall("abi-swap")
        phase_fault(card)
        wall("fault")
        by_phase = {"flash_attention": {"forward": phase_forward(card)},
                    "pack_transposed": {"main": launches["pack_transposed"],
                                        "train-gspmd": gspmd_pack}}
        phase_forward_gemma(card)
        wall("forward, forward-gemma")
        by_phase["pack_transposed"]["train-moe"] = phase_train_moe(card)
        by_phase["flash_attention"]["forward-moe"], model = phase_forward_moe(card)
        phase_serve_moe(card, model)
        del model
        torch.cuda.empty_cache()
        wall("moe")
        for name, runs in phase_mm(card).items():
            by_phase[name].update(runs)
        wall("encdec, vlm")
        by_phase.update({"wkv6": {"train-ssm": phase_train_recurrent(card, SSM_ARCH)},
                         "ssd": {"train-hybrid": phase_train_recurrent(card, HYBRID_ARCH)}})
        wall("train-ssm, train-hybrid")
        by_phase["wkv6"]["forward-ssm"], model = phase_forward_ssm(card)
        phase_serve_recurrent(card, SSM_ARCH, model)
        del model
        torch.cuda.empty_cache()
        counts, model = phase_forward_hybrid(card)
        by_phase["ssd"]["forward-hybrid"] = counts["ssd"]
        phase_serve_recurrent(card, HYBRID_ARCH, model)
        del model
        torch.cuda.empty_cache()
        wall("forward-ssm, serve-ssm, forward-hybrid, serve-hybrid")
        for name, runs in by_phase.items():
            launches[name] = sum(runs.values())
        phase_card_vs_cpu()
        wall("card-vs-cpu")
        phase_serve(card)
        wall("serve")
        record = {"kernels": [
            {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[name], "max_abs_err": worst[name],
             "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
             "bound_ms": timing[name]["bound_ms"],
             "bound_by": timing[name].get("bound_by", "bytes"),
             "library_ms": timing[name]["library_ms"],
             **({"launches_by_phase": by_phase[name]} if name in by_phase else {})}
            for name, (source, replaces) in KERNELS.items()]}
    except Exception:
        traceback.print_exc()
        print("chip_smoke.py: FAILED", file=sys.stderr)
        return 1
    finally:
        for proc in dry:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
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
