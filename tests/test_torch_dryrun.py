"""The port's dry run (``repro_torch.launch.dryrun``), its collective
counting and its H100 roofline (``launch/hlo_analysis.py``), on the CPU.

* the cells equal the reference's: 10 archs x 4 shapes = 40 assigned, 32
  runnable (``shapes_for`` drops ``long_500k`` for full attention), and
  ``--list`` prints them at both meshes (64 lines);
* every train-state leaf of nemotron-4-340b and grok-1-314b (``gspmd``:
  FSDP and tensor parallelism; grok-1's experts split by ``d_ff``) and
  gemma-7b and qwen2-moe-a2.7b (the ABI ZeRO-1 step, tensor parallelism;
  qwen2-moe's experts split by expert) as rank 0 of ``pod1`` and ``pod2``
  holds it equals the per-device shape of
  the reference's ``state_specs`` under ``NamedSharding(AbstractMesh)``,
  with the reference dry run's rule that an axis not dividing a dimension
  leaves it whole (``repro/launch/dryrun.py:95-116``; that module itself
  sets ``XLA_FLAGS`` at import, so it is not imported here).  The ZeRO-1
  moments are flat: the held leaves' elements padded to the dp size, over
  the dp axes (``state_specs(dp_axes=...)``);
* likewise rwkv6-7b's and zamba2-2.7b's train state (the ABI ZeRO-1
  step, their time mix, channel mix, Mamba2 layers per segment, shared
  block and vocabulary split over the model axis), and whisper-tiny's and
  phi-3-vision-4.2b's (whisper's MLPs split, its 6 heads and vocabulary
  whole; phi-3-vision's heads, ``d_ff``, vocabulary and projector ``w2``
  split); their decode_32k cell and a train cell cut to a few layers and
  256 positions at ``pod1`` say ``"tp": "split"`` and their argument bytes
  are the reference's per-device parameters and decode state
  (``cache_specs``; whisper's from ``encdec.init_cache``) or train state;
* a smoke dense cell (qwen2-0.5b's smoke config, 2 x 32 tokens a rank)
  lowers on the fake backend at ``pod1``: positive roofline terms, and its
  collective bytes by op equal a count by hand from the step's plans;
* ``StepCounter`` counts each collective once (an async functional op and
  its wait once), at max(in, out) bytes;
* the roofline's terms on the H100 datasheet constants.

The fake world of 256 or 512 ranks runs in subprocesses: a process holds
one default process group, and the other tests start their own.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

import repro.configs as R_cfgs
from repro.models import build_model as r_build
from repro.train import train_loop as r_tl

import repro_torch.configs as T_cfgs
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, Roofline,
                                             shape_bytes)

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("nemotron-4-340b", "gemma-7b", "grok-1-314b", "qwen2-moe-a2.7b")
MESHES = {"pod1": ((16, 16), ("data", "model")), "pod2": ((2, 16, 16), ("pod", "data", "model"))}

_SCRIPT = """
import json, sys
import torch
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import StepCounter
from repro_torch.launch.mesh import make_production_mesh

pod2 = sys.argv[1] == "pod2"
out = {"shapes": {a: {k: list(v) for k, v in dryrun.state_shapes(a, pod2).items()}
                  for a in sys.argv[2].split(",")}}
if not pod2:
    out["smoke"] = dryrun.lower(configs.smoke_config("qwen2-0.5b"),
                                ShapeConfig("smoke", 32, 32, "train"),
                                make_production_mesh(device="cpu"))
    import torch.distributed as tdist
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = tdist.new_group(list(range(16)))
    with FakeTensorMode(), StepCounter() as sc:
        x = torch.ones(64)
        tdist.all_reduce(x, group=g)
        tdist.all_gather_into_tensor(torch.empty(16 * 64), x, group=g)
        tdist.reduce_scatter_tensor(torch.empty(4), x, group=g)
        y = torch.ops._c10d_functional.all_reduce(x, "sum", g.group_name)
        torch.ops._c10d_functional.wait_tensor(y)
    out["counter"] = {"bytes": sc.bytes_by_op, "count": sc.count_by_op}
print("RESULT " + json.dumps(out))
"""


#: the ssm and hybrid families (their own subprocesses): the decode cell
#: at full size and a train cell cut to these layers (the hybrid's one
#: firing of its shared block) and 256 positions for the CPU
SSM_ARCHS = ("rwkv6-7b", "zamba2-2.7b")
SSM_TRAIN = {"rwkv6-7b": 2, "zamba2-2.7b": 6}
SSM_TRAIN_SHAPE = (256, 64)     # (sequence, global batch): 4 rows a data rank
#: the encdec and vlm families, in the same subprocesses: whisper-tiny cut to
#: 1 decoder and 1 encoder layer, phi-3-vision-4.2b to 2 of 32
MM_ARCHS = ("whisper-tiny", "phi-3-vision-4.2b")
MM_TRAIN = {"whisper-tiny": 1, "phi-3-vision-4.2b": 2}

_SSM_SCRIPT = """
import dataclasses, json, sys
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

pod2, train = sys.argv[1] == "pod2", json.loads(sys.argv[2])
cut = lambda cfg, layers: dataclasses.replace(cfg, num_layers=layers, **(
    {"encdec": dataclasses.replace(cfg.encdec, encoder_layers=layers)} if cfg.encdec else {}))
seq, batch = json.loads(sys.argv[3])
out = {"shapes": {a: {k: list(v) for k, v in dryrun.state_shapes(a, pod2).items()}
                  for a in train}}
if not pod2:
    mesh = make_production_mesh(device="cpu")
    for a, layers in train.items():
        cfg = configs.get_config(a)
        out.setdefault("decode", {})[a] = dryrun.lower(cfg, configs.SHAPES_BY_NAME["decode_32k"],
                                                       mesh)
        out.setdefault("train", {})[a] = dryrun.lower(
            cut(cfg, layers), ShapeConfig("cut", seq, batch, "train"),
            mesh)
print("RESULT " + json.dumps(out))
"""


def _cut(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers (an encoder-decoder's encoder too),
    as ``_SSM_SCRIPT`` cuts its train cells."""
    import dataclasses

    return dataclasses.replace(cfg, num_layers=layers, **(
        {"encdec": dataclasses.replace(cfg.encdec, encoder_layers=layers)} if cfg.encdec else {}))


def _run(mesh: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, mesh, ",".join(ARCHS)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def runs():
    return {m: _run(m) for m in MESHES}


@pytest.fixture(scope="module")
def ssm_runs():
    """The ssm, hybrid, encdec and vlm archs' state shapes at both meshes
    and their cells at ``pod1``, the two meshes' subprocesses run
    together."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {m: subprocess.Popen([sys.executable, "-c", _SSM_SCRIPT, m,
                                  json.dumps({**SSM_TRAIN, **MM_TRAIN}),
                                  json.dumps(SSM_TRAIN_SHAPE)], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for m in MESHES}
    out = {}
    for m, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-4000:]
        line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")][-1]
        out[m] = json.loads(line[len("RESULT "):])
    return out


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------
def test_cells_equal_the_reference():
    assert len(R_cfgs.ARCH_NAMES) * len(R_cfgs.ALL_SHAPES) == 40
    want = [(a, s.name) for a in R_cfgs.ARCH_NAMES
            for s in R_cfgs.shapes_for(R_cfgs.get_config(a))]
    assert len(want) == 32
    assert list(dryrun.iter_cells()) == want
    assert T_cfgs.ARCH_NAMES == R_cfgs.ARCH_NAMES


def test_list_prints_every_cell_at_both_meshes():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 64
    assert lines == [f"{a} {s} {m}" for a, s in dryrun.iter_cells() for m in ("pod1", "pod2")]


def test_remat_dots_override_raises_where_a_layer_runs(monkeypatch):
    monkeypatch.setenv("PAX_OVERRIDE_REMAT", "dots")
    cfg = dryrun._apply_env_overrides(T_cfgs.get_config("qwen2-0.5b"))
    assert cfg.parallelism.remat == "dots"
    from repro_torch.models.common import maybe_remat
    with pytest.raises(NotImplementedError, match="dots"):
        maybe_remat(lambda x: x, cfg.parallelism.remat)


# ---------------------------------------------------------------------------
# per-device shapes against the reference's specs
# ---------------------------------------------------------------------------
def _sanitize(spec: P, names) -> P:
    parts = []
    for p in tuple(spec):
        if isinstance(p, tuple):
            kept = tuple(a for a in p if a in names)
            parts.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            parts.append(p if p in names else None)
    return P(*parts)


def _shard_shape(shape, spec, sizes, names) -> tuple:
    """The reference dry run's placement (``_tree_sds``): trim, sanitize,
    drop an axis that does not divide its dimension; then the per-device
    shape of ``NamedSharding(AbstractMesh)``."""
    mesh = AbstractMesh(sizes, names)
    spec = _sanitize(P(*tuple(spec)[:len(shape)]), names)
    parts = []
    for dim, p in zip(shape, tuple(spec)):
        if p is not None:
            size = math.prod(mesh.shape[a] for a in (p if isinstance(p, tuple) else (p,)))
            if size <= 1 or dim % size:
                p = None
        parts.append(p)
    return tuple(NamedSharding(mesh, P(*parts)).shard_shape(tuple(shape)))


def _flat(tree, prefix) -> dict:
    return {prefix + ".".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda v: isinstance(v, P))[0]}


def _want_state(cfg, mesh: str) -> dict:
    """The reference's train state of ``cfg`` as rank 0 of ``mesh`` holds
    it: leaf -> (per-device shape, bytes an element)."""
    sizes, names = MESHES[mesh]
    api = r_build(cfg)
    mode = cfg.parallelism.grad_sync
    fsdp = ("pod", "data") if mesh == "pod2" else "data"
    dp_axes = names[:-1]
    shapes = _flat(jax.eval_shape(api.init, jax.random.PRNGKey(0)), "")
    zero1 = mode == "abi" and cfg.parallelism.zero1
    specs = r_tl.state_specs(api, mode, fsdp=fsdp, tp="model",
                             dp_axes=dp_axes if zero1 else None)
    pspecs = _flat(specs.params, "")
    want = {f"params.{n}": (_shard_shape(s.shape, pspecs[n], sizes, names), s.dtype.itemsize)
            for n, s in shapes.items()}
    if zero1:
        # the flat moments: this rank's held elements, padded to dp, over the dp axes
        dp = math.prod(sizes[:-1])
        n_local = sum(math.prod(v) for v, _ in want.values())
        padded = -(-n_local // dp) * dp
        flat = _shard_shape((padded,), specs.opt.m, sizes, names)
        want.update({"opt.m": (flat, 4), "opt.v": (flat, 4), "opt.ef": ((1,), 4),
                     "opt.step": ((), 4)})
    else:
        for field in ("m", "v"):
            fspecs = _flat(getattr(specs.opt, field), "")
            want.update({f"opt.{field}.{n}": (_shard_shape(s.shape, fspecs[n], sizes, names), 4)
                         for n, s in shapes.items()})
        want["opt.step"] = ((), 4)
    want["step"] = ((), 4)
    return want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_leaves_have_the_reference_per_device_shapes(arch, mesh, runs):
    got = {k: tuple(v) for k, v in runs[mesh]["shapes"][arch].items()}
    sizes, names = MESHES[mesh]
    cfg = R_cfgs.get_config(arch)
    mode = cfg.parallelism.grad_sync
    want = {k: shape for k, (shape, _) in _want_state(cfg, mesh).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    # the layout really splits: the FFN (the moe layer's experts) over the
    # model axis everywhere, FSDP under gspmd
    m = cfg.moe
    if m is None:
        wi, split = got["params.layers.mlp.wi"], (2, cfg.d_ff)
    elif m.parallelism == "ep":
        wi, split = got["params.layers.moe.experts.wi"], (1, m.padded_experts or m.num_experts)
    else:
        wi, split = got["params.layers.moe.experts.wi"], (3, m.expert_d_ff)
    assert wi[split[0]] == split[1] // 16
    if mode == "gspmd":
        assert wi[-2] == cfg.d_model // math.prod(sizes[:-1])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_and_hybrid_state_leaves_have_the_reference_per_device_shapes(arch, mesh,
                                                                          ssm_runs):
    """rwkv6-7b's and zamba2-2.7b's train state (the ABI ZeRO-1 step) as
    rank 0 of ``pod1``/``pod2`` holds it is the reference's, leaf by leaf:
    the time mix's heads, the channel mix, each Mamba2 leaf (per segment:
    1/16 of each, as the reference's contiguous spec gives it), the shared
    block and the vocabulary split over the model axis."""
    got = {k: tuple(v) for k, v in ssm_runs[mesh]["shapes"][arch].items()}
    want = {k: shape for k, (shape, _) in _want_state(R_cfgs.get_config(arch), mesh).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    cfg = R_cfgs.get_config(arch)
    if arch == "rwkv6-7b":
        assert got["params.layers.wr"][2] == cfg.d_model // 16
        assert got["params.layers.cm_wv"][1] == cfg.d_ff // 16
    else:
        d_inner = cfg.ssm.expand * cfg.d_model
        cols = 2 * d_inner + 2 * cfg.ssm.state_size + d_inner // cfg.ssm.head_dim
        assert got["params.layers.in_proj"][2] == cols // 16
        assert got["params.shared.in_proj"][1] == cfg.d_model // 16


def _cache_bytes(arch: str, rows: int, seq: int) -> int:
    """The bytes of the reference's decode state of ``rows`` sequences of
    ``seq`` positions as rank 0 of ``pod1`` holds it (``cache_specs``;
    the encoder-decoder's from ``encdec.init_cache`` on its frames)."""
    sizes, names = MESHES["pod1"]
    cfg = R_cfgs.get_config(arch)
    api = r_build(cfg)
    if cfg.family == "encdec":
        import jax.numpy as jnp
        from repro.models import encdec as r_encdec

        frames = jax.ShapeDtypeStruct((rows, cfg.encdec.encoder_frames, cfg.d_model),
                                      jnp.bfloat16)
        shapes = jax.tree.leaves(jax.eval_shape(
            lambda p, f: r_encdec.init_cache(p, f, cfg, rows, seq),
            jax.eval_shape(api.init, jax.random.PRNGKey(0)), frames))
    else:
        shapes = jax.tree.leaves(jax.eval_shape(lambda: api.decode_init(rows, seq)))
    specs = jax.tree.leaves(api.cache_specs(), is_leaf=lambda v: isinstance(v, P))
    return sum(math.prod(_shard_shape(s.shape, spec, sizes, names)) * s.dtype.itemsize
               for s, spec in zip(shapes, specs))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_and_hybrid_cells_hold_the_split_layout_and_its_bytes(arch, ssm_runs):
    """At ``pod1`` the decode_32k cell and a train cell (the config cut to
    ``SSM_TRAIN`` layers and 256 positions) hold the split layout
    (``"tp": "split"``); the decode cell's argument bytes are the
    reference's per-device parameters (``param_specs``) and decode state
    (``cache_specs``: the rank's WKV heads; its conv channels, SSM heads
    and K/V heads), the train cell's its per-device train state."""
    import dataclasses

    dec, train = ssm_runs["pod1"]["decode"][arch], ssm_runs["pod1"]["train"][arch]
    assert dec["tp"] == train["tp"] == "split" and dec["fsdp"] == "replicated"
    cfg = R_cfgs.get_config(arch)
    params = sum(math.prod(shape) * size for k, (shape, size) in
                 _want_state(cfg, "pod1").items() if k.startswith("params."))
    shape = R_cfgs.SHAPES_BY_NAME["decode_32k"]
    assert dec["memory"]["argument_bytes"] == params + _cache_bytes(
        arch, shape.global_batch, shape.seq_len)
    cut = dataclasses.replace(cfg, num_layers=SSM_TRAIN[arch])
    assert train["memory"]["argument_bytes"] == sum(
        math.prod(shape) * size for shape, size in _want_state(cut, "pod1").values())
    assert train["collectives"]["count"]["all-reduce"] > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", MM_ARCHS)
def test_encdec_and_vlm_state_leaves_have_the_reference_per_device_shapes(arch, mesh,
                                                                          ssm_runs):
    """whisper-tiny's and phi-3-vision-4.2b's train state (the ABI ZeRO-1
    step) as rank 0 of ``pod1``/``pod2`` holds it is the reference's, leaf
    by leaf: whisper's MLPs split over the model axis (its 6 heads and
    vocabulary of 51,865 do not divide 16), phi-3-vision's heads, ``d_ff``,
    vocabulary and projector ``w2``."""
    got = {k: tuple(v) for k, v in ssm_runs[mesh]["shapes"][arch].items()}
    cfg = R_cfgs.get_config(arch)
    want = {k: shape for k, (shape, _) in _want_state(cfg, mesh).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    if arch == "whisper-tiny":
        for stack in ("enc_layers", "dec_layers"):
            assert got[f"params.{stack}.mlp.wi"][2] == cfg.d_ff // 16
            assert got[f"params.{stack}.attn.wq"][2] == cfg.d_model
        assert got["params.dec_layers.cross.wk"][2] == cfg.d_model
        assert got["params.embed.tok"][0] == cfg.vocab_size
    else:
        assert got["params.layers.attn.wq"][2] == cfg.d_model // 16
        assert got["params.layers.mlp.wi"][2] == cfg.d_ff // 16
        assert got["params.embed.tok"][0] == cfg.vocab_size // 16
        assert got["params.projector.w2"] == (cfg.d_model, cfg.d_model // 16)


@pytest.mark.parametrize("arch", MM_ARCHS)
def test_encdec_and_vlm_cells_hold_the_split_layout_and_its_bytes(arch, ssm_runs):
    """At ``pod1`` the decode_32k cell and a train cell (``MM_TRAIN``
    layers, whisper's encoder too; 256 positions) hold the split layout
    (``"tp": "split"``); the decode cell's argument bytes are the
    reference's per-device parameters and decode state (whisper: the
    self-attention cache and the cross K/V at all 6 heads; phi-3-vision: 2
    of 32 K/V heads), the train cell's its per-device train state."""
    dec, train = ssm_runs["pod1"]["decode"][arch], ssm_runs["pod1"]["train"][arch]
    assert dec["tp"] == train["tp"] == "split" and dec["fsdp"] == "replicated"
    cfg = R_cfgs.get_config(arch)
    params = sum(math.prod(shape) * size for k, (shape, size) in
                 _want_state(cfg, "pod1").items() if k.startswith("params."))
    shape = R_cfgs.SHAPES_BY_NAME["decode_32k"]
    assert dec["memory"]["argument_bytes"] == params + _cache_bytes(
        arch, shape.global_batch, shape.seq_len)
    cut = _cut(cfg, MM_TRAIN[arch])
    assert train["memory"]["argument_bytes"] == sum(
        math.prod(shape) * size for shape, size in _want_state(cut, "pod1").values())
    assert train["collectives"]["count"]["all-reduce"] > 0


# ---------------------------------------------------------------------------
# a smoke cell on the fake backend, and the counter
# ---------------------------------------------------------------------------
def test_smoke_cell_lowers_with_the_hand_counted_collectives(runs):
    rec = runs["pod1"]["smoke"]
    cfg = T_cfgs.smoke_config("qwen2-0.5b")
    rf = rec["roofline"]
    assert rf["compute_s"] > 0 and rf["memory_s"] > 0 and rf["collective_s"] > 0
    assert rec["tp"] == "split" and rec["mode"] == "abi" and rec["chips"] == 256
    # by hand: 32 rows over dp = 16 -> 2 rows of 32 tokens a rank; the smoke
    # model's 4 heads do not divide the 16-wide model axis (attention whole),
    # its FFN (128) and vocabulary (512) split; remat "none", one microbatch
    rows, S, d, L = 2, 32, cfg.d_model, cfg.num_layers
    act = rows * S * d * 4
    # forward: the embedding's sum, each layer's FFN output, the loss's max,
    # sum of exponentials and target logit; backward: each layer's FFN input
    # and the head's input gradients summed over the model axis
    tp_bytes = act * (1 + L) + 3 * rows * S * 4 + act * (L + 1)
    tp_count = (1 + L + 3) + (L + 1)
    # the ZeRO-1 step: one reduce-scatter and one all-gather of the padded
    # flat vector (the held elements, padded to dp), the grad norm's two
    # scalars (over the model and the data axes) and the loss's mean
    held = (512 // 16 * d + d                       # embedding rows, final norm
            + L * (d * 64 + 2 * d * 32 + 64 * d     # wq, wk, wv, wo (4/2 heads of 16)
                   + 64 + 2 * 32 + 2 * d            # biases, the two norms
                   + 3 * d * 128 // 16))            # wi, wg, wo (FFN split)
    padded = -(-held // 16) * 16
    assert rec["collectives"]["bytes"] == {"all-reduce": tp_bytes + 3 * 4,
                                           "reduce-scatter": padded * 4,
                                           "all-gather": padded * 4}
    assert rec["collectives"]["count"] == {"all-reduce": tp_count + 3, "reduce-scatter": 1,
                                           "all-gather": 1}
    assert rec["params_held"] == held
    assert rec["memory"]["argument_bytes"] == held * 4 + 2 * padded // 16 * 4 + 4 + 4 + 4


def test_step_counter_counts_each_collective_once(runs):
    c = runs["pod1"]["counter"]
    # all-reduce: in place, 64 f32 (twice: the c10d op and the functional one
    # with its wait); all-gather: the gathered side; reduce-scatter: its input
    assert c["count"] == {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1}
    assert c["bytes"] == {"all-reduce": 2 * 256, "all-gather": 16 * 256,
                          "reduce-scatter": 256}


def test_shape_bytes():
    assert shape_bytes("f32[16,128]") == 16 * 128 * 4
    assert shape_bytes("bf16[128,256]{1,0}") == 128 * 256 * 2
    assert shape_bytes("(f32[2], bf16[4,4])") == 8 + 32
    assert shape_bytes("pred[8]") == 8
    assert shape_bytes("token[]") == 0


def test_roofline_terms_and_bottleneck_on_the_h100_datasheet():
    assert (PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)
    r = Roofline(
        flops_per_device=PEAK_FLOPS_BF16 * 0.010,     # 10 ms compute
        hbm_bytes_per_device=HBM_BW * 0.020,          # 20 ms memory
        collective_bytes_per_device=NVLINK_BW * 0.005,  # 5 ms collective
        chips=256,
        model_flops_global=PEAK_FLOPS_BF16 * 0.010 * 256 * 0.5,
    )
    assert r.compute_s == pytest.approx(0.010)
    assert r.memory_s == pytest.approx(0.020)
    assert r.collective_s == pytest.approx(0.005)
    assert r.bottleneck == "memory"
    assert r.step_time_s == pytest.approx(0.020)
    assert r.useful_flops_fraction == pytest.approx(0.5)
    # MFU bound: useful flops / (chips*peak*steptime) = .5*10ms/20ms = 0.25
    assert r.mfu_bound == pytest.approx(0.25)
    assert set(r.as_dict()) >= {"compute_s", "memory_s", "collective_s", "bottleneck",
                                "step_time_s", "useful_flops_fraction", "mfu_bound"}
