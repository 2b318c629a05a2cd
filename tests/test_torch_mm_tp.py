"""The encdec (whisper-tiny) and vlm (phi-3-vision-4.2b) families on the
model axis against the reference, on the CPU at the smoke size in
float32: whisper's three attentions (the encoder's, the decoder's causal
self-attention and its cross-attention on the rank's K/V heads of the
whole encoder output) and MLPs split, phi-3-vision's heads, ``d_ff``,
vocabulary and projector ``w2`` split, and FSDP under ``gspmd``.

Both packages' smoke configs get the same ``dataclasses.replace``:
``tp_size`` set to the test mesh's model axis (2), remat ``"full"`` and two
microbatches.  A third case, whisper with 3 heads and a vocabulary of 513
(neither divides the axis), keeps its attentions and vocabulary whole on
every rank and splits only its MLPs; its forward, gradient and decode
are held to the reference too.  The weights are the port's
unsplit draw from seed 0, saved as numpy: the reference reads them, and
each rank holds its block through ``from_jax_params`` (and ``api.init``'s
own draw must give the same block).  The reference runs once, in one
subprocess on one CPU device (its math does not depend on the mesh):
its forward, gradient, split decode (whisper's ``init_cache`` and 4
``decode_step`` s; phi-3-vision's ``prefill_multimodal`` of the patches and
8 tokens and 4 steps) and two ``gspmd`` steps.  Meanwhile the port runs two
gloo worlds (``_torch_mm_tp_ranks.py``) meeting through ``file://`` in
``tmp_path``: (1, 2), where every check of the forward, the gradient, the
decode and the ABI ZeRO-1 steps is made, and (2, 2), the ``gspmd`` steps
with FSDP.  Held to the reference:

1. each rank's blocks tile every leaf (``take_block``/``put_block``);
2. the forward at (1, 2), logits and ``last_only`` within 2e-5;
3. each leaf block's gradient at (1, 2) within 1e-5 of the leaf's largest
   element;
4. two ABI ZeRO-1 steps at (1, 2) and two ``gspmd`` steps with FSDP at
   (2, 2): losses and grad norms within 1e-5 relative of the reference's,
   and each leaf block within 5e-5 of the leaf's largest magnitude of the
   port's own unsplit step (``test_torch_tp``'s bounds);
5. the split decode: each step's logits within 2e-5 of the reference's,
   each bfloat16 cache block (the rank's K/V heads of the self-attention
   cache and of the cross K/V) within one bfloat16 rounding (2^-7
   relative, plus ``test_torch_tp``'s 1e-4);
6. ``cache_specs`` and the held layout at the production axis equal to the
   reference's;
7. the raises: a split model without its dist, and under sequence
   parallelism (which neither family supports).
"""
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import repro_torch.configs as T_cfgs
from repro_torch.models import build_model
from repro_torch.models.model import _family
from repro_torch.models.tensor_parallel import Part, TP, held_layout, put_block, take_block
from repro_torch.optim.adamw import AdamWConfig as T_Adam

from _torch_mm_tp_ranks import (DECODE_STEPS, VLM_PROMPT, cache_block, decode_cache_names,
                                mm_tp_rank)
from _torch_ranks import run_ranks

ARCHS = ("whisper-tiny", "phi-3-vision-4.2b")
#: whisper with heads and a vocabulary that the axis does not divide: its
#: forward, gradient and decode (not its steps) held to the reference
WHOLE_HEADS = "whisper-whole-heads"
#: case -> (arch, the config's change)
CASES = {"whisper-tiny": ("whisper-tiny", {}),
         "phi-3-vision-4.2b": ("phi-3-vision-4.2b", {}),
         WHOLE_HEADS: ("whisper-tiny", dict(num_heads=3, num_kv_heads=3, vocab_size=513))}
SRC = Path(__file__).resolve().parent.parent / "src"
R = 2
STEPS = 2
TOL = 2e-5
GRAD_TOL = 1e-5
STEP_RTOL = 1e-5
LEAF_TOL = 5e-5
CACHE_TOL = 1e-4
B, S = 4, 16

_SCRIPT = """
import dataclasses, json, os, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.configs as R
from repro.core.compat import make_mesh
from repro.models import build_model, encdec, vlm
from repro.optim import adamw
from repro.optim.adamw import AdamWConfig
from repro.runtime.dist import make_dist
from repro.train import train_loop

d, tp, steps, n_dec, prompt = sys.argv[1], *map(int, sys.argv[2:6])
cases, trained = json.loads(sys.argv[6]), json.loads(sys.argv[7])
path = lambda p: ".".join(str(getattr(k, "key", getattr(k, "name", k))) for k in p)
flat = lambda tree: {path(p): np.asarray(v, np.float32) for p, v in
                     jax.tree_util.tree_flatten_with_path(tree)[0]}


def nest(leaves):
    tree = {}
    for name, v in leaves.items():
        *parts, leaf = name.split(".")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return tree


def setup(name):
    arch, change = cases[name]
    cfg = R.smoke_config(arch)
    cfg = dataclasses.replace(cfg, **change, parallelism=dataclasses.replace(
        cfg.parallelism, tp_size=tp, remat="full", microbatch=2, grad_sync="gspmd"))
    with np.load(f"{d}/{name}.npz") as f:
        params = nest({k[2:]: f[k] for k in f.files if k.startswith("p:")})
        batch = {k[2:]: jnp.asarray(f[k]) for k in f.files if k.startswith("b:")}
    return cfg, build_model(cfg), params, batch


# the filled caches first: the port's ranks wait for them
caches = {}
for name in cases:
    cfg, api, params, batch = setup(name)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    if cfg.family == "encdec":
        cache = jax.jit(lambda p, f: encdec.init_cache(p, f, cfg, B, n_dec))(params,
                                                                           batch["frames"])
        leaves = [cache.self_kv.k, cache.self_kv.v, cache.cross_k, cache.cross_v]
        index, first = 0, 0
    else:
        max_seq = prompt + cfg.vlm.num_patches + n_dec
        _, cache, index = jax.jit(lambda p, t, x: vlm.prefill_multimodal(
            p, t, x, cfg, max_seq=max_seq))(params, tokens[:, :prompt], batch["patches"])
        leaves = [cache.k, cache.v]
        first = prompt
    caches[name] = (cache, int(index), first)
    np.savez(f"{d}/{name}.cache.part.npz", **{str(i): np.asarray(v, np.float32)
                                              for i, v in enumerate(leaves)})
    os.replace(f"{d}/{name}.cache.part.npz", f"{d}/{name}.cache.npz")

# the steps' math does not depend on the mesh: one device compiles fastest
mesh = make_mesh((1, 1), ("data", "model"))
dist = make_dist(mesh)
out = {}
for name in cases:
    cfg, api, params, batch = setup(name)
    logits, grad = jax.jit(lambda p, b: (api.forward(p, b)[0], jax.grad(api.loss_fn)(p, b)))(
        params, batch)
    out[f"{name}:logits"] = np.asarray(logits)
    out.update({f"{name}:grad:{n}": v for n, v in flat(grad).items()})
    cache, index, first = caches[name]
    tokens = batch["tokens"]
    step = jax.jit(lambda p, t, c, i: api.decode_step(p, t, c, i))
    dec = []
    for i in range(n_dec):
        logits, cache = step(params, tokens[:, first + i:first + i + 1], cache,
                             jnp.int32(index + i))
        dec.append(np.asarray(logits))
    out[f"{name}:decode"] = np.stack(dec)
    if name not in trained:
        continue
    # init_state's gspmd state on these weights, placed as the step leaves
    # it (state_specs), so the second step reuses the first one's compile
    shard = jax.tree.map(lambda s: NamedSharding(mesh, s), train_loop.state_specs(api, "gspmd"),
                         is_leaf=lambda s: isinstance(s, P))
    state = jax.device_put(train_loop.TrainState(params, adamw.init_tree(params),
                                                 jnp.zeros((), jnp.int32)), shard)
    tstep = jax.jit(train_loop.make_train_step(api, dist, AdamWConfig()),
                    out_shardings=(shard, None))
    losses, norms = [], []
    for _ in range(steps):
        state, met = tstep(state, batch)
        losses.append(float(met.loss))
        norms.append(float(met.grad_norm))
    out[f"{name}:losses"], out[f"{name}:grad_norms"] = np.array(losses), np.array(norms)
np.savez(d + "/out.npz", **out)
"""


def _cfg(name: str, leg: str = "abi", **par):
    """The port's config of one case and leg (the reference script makes
    its twin)."""
    arch, change = CASES[name]
    cfg = T_cfgs.smoke_config(arch)
    return dataclasses.replace(cfg, **change, parallelism=dataclasses.replace(
        cfg.parallelism, tp_size=R, remat="full", microbatch=2, grad_sync=leg, **par))


def _batch(cfg) -> dict:
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    out = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    if cfg.encdec is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encdec.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.vlm is not None:
        out["patches"] = rng.standard_normal(
            (B, cfg.vlm.num_patches, cfg.vlm.patch_embed_dim)).astype(np.float32)
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _unsplit(whole: dict) -> dict:
    """The port's unsplit ``gspmd`` step (one process) on the same weights
    and batch: arch -> (losses, leaf name -> final)."""
    import torch

    from repro_torch.models import from_jax_params, param_leaves
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop as tl

    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch, "gspmd")
        model = from_jax_params(_nest(whole[arch]), cfg, device="cpu")
        state = tl.TrainState(model, adamw.init_tree(param_leaves(model)),
                              torch.zeros((), dtype=torch.int32))
        step = tl.make_train_step(build_model(cfg), None, T_Adam())
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        losses = []
        for _ in range(STEPS):
            state, met = step(state, batch)
            losses.append(float(met.loss))
        out[arch] = (losses, {n: p.detach().numpy() for n, p in param_leaves(model)})
    return out


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """Everything at once: the reference's subprocess, the (1, 2) and
    (2, 2) worlds, and the port's unsplit steps in this process.  Returns
    {"ref": case -> records, "abi": ranks, "gspmd": ranks, "whole": case ->
    leaf -> the whole weights, "unsplit": arch -> (losses, leaves)}."""
    from repro_torch.models import param_leaves

    d = tmp_path_factory.mktemp("mm_tp")
    whole = {}
    for name in CASES:
        cfg = _cfg(name)
        whole[name] = {n: p.detach().numpy() for n, p in
                       param_leaves(build_model(cfg).init(0, "cpu"))}
        np.savez(d / f"{name}.npz", **{f"p:{k}": v for k, v in whole[name].items()},
                 **{f"b:{k}": v for k, v in _batch(cfg).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-c", _SCRIPT, str(d), str(R), str(STEPS), str(DECODE_STEPS),
         str(VLM_PROMPT), json.dumps(CASES), json.dumps(ARCHS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        abi_cases = [(n, _cfg(n), _nest(whole[n]), _batch(_cfg(n)), True, n in ARCHS)
                     for n in CASES]
        fsdp_cases = [(n, _cfg(n, "gspmd"), _nest(whole[n]), _batch(_cfg(n)), False, True)
                      for n in ARCHS]
        for leg in ("abi", "gspmd"):
            (d / leg).mkdir()
        with ThreadPoolExecutor(2) as pool:
            abi = pool.submit(run_ranks, mm_tp_rank, R, d / "abi", R, abi_cases, STEPS,
                              timeout=240)
            fsdp = pool.submit(run_ranks, mm_tp_rank, 2 * R, d / "gspmd", R, fsdp_cases, STEPS,
                               timeout=240)
            unsplit = _unsplit(whole)
            ranks = {"abi": abi.result(), "gspmd": fsdp.result()}
        _, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stderr[-4000:]
    with np.load(d / "out.npz") as f:
        flat = {k: f[k] for k in f.files}
    ref = {}
    for name in CASES:
        mine = {k.split(":", 1)[1]: v for k, v in flat.items() if k.startswith(name + ":")}
        rec = {k: v for k, v in mine.items() if ":" not in k}
        rec["grad"] = {k[len("grad:"):]: v for k, v in mine.items() if k.startswith("grad:")}
        with np.load(d / f"{name}.cache.npz") as f:
            rec["cache"] = {k: f[k] for k in f.files}
        ref[name] = rec
    return dict(ref=ref, whole=whole, unsplit=unsplit, **ranks)


def _model(name: str, leg: str, part) -> object:
    return _family(_cfg(name))[1](_cfg(name, leg), "meta", *(int(v) for v in part))


# ---------------------------------------------------------------------------
# what a rank holds
# ---------------------------------------------------------------------------
_ATTN = ("wq", "wk", "wv", "wo")
_MLP = {"gelu": ("wi", "wo"), "swiglu": ("wi", "wg", "wo")}
#: the leaves the reference's spec_lm splits over a model axis of 2
SPLIT = {"whisper-tiny": {f"{s}.{k}" for s in ("enc_layers.attn", "dec_layers.attn",
                                               "dec_layers.cross") for k in _ATTN}
         | {f"{s}.mlp.{k}" for s in ("enc_layers", "dec_layers") for k in _MLP["gelu"]}
         | {"embed.tok"},
         "phi-3-vision-4.2b": {f"layers.attn.{k}" for k in _ATTN}
         | {f"layers.mlp.{k}" for k in _MLP["swiglu"]}
         | {"embed.tok", "embed.unembed", "projector.w2"},
         WHOLE_HEADS: {f"{s}.mlp.{k}" for s in ("enc_layers", "dec_layers")
                                 for k in _MLP["gelu"]}}


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_block_and_the_blocks_tile_each_leaf(name, legs):
    """Each rank of both legs holds exactly the leaves ``spec_lm`` splits
    split (under ``gspmd`` its fsdp block too); every held leaf is
    ``take_block`` of the whole one, and so is ``api.init``'s draw of the
    rank's block; ``put_block`` of every rank's block reassembles the whole
    leaf, each element covered as many times as the leaf is replicated."""
    whole = legs["whole"][name]
    for leg, dp in (("abi", 1), ("gspmd", 2)):
        if name not in ARCHS and leg == "gspmd":
            continue
        cover = {n: np.zeros(v.shape, np.int32) for n, v in whole.items()}
        built = {n: np.zeros_like(v) for n, v in whole.items()}
        for r, out in enumerate(legs[leg]):
            part = out[f"{name}:part"]
            assert list(part) == [r % R, R, r // R if dp > 1 else 0, dp]
            assert set(out[f"{name}:split"]) == SPLIT[name], leg
            m = _model(name, leg, part)
            for n, full in whole.items():
                block = out[f"{name}:held:{n}"]
                np.testing.assert_array_equal(block, take_block(m, n, full), err_msg=n)
                np.testing.assert_array_equal(out[f"{name}:drawn:{n}"], block, err_msg=n)
                put_block(m, n, built[n], block)
                ones = np.zeros(full.shape, np.int32)
                put_block(m, n, ones, np.ones(block.shape, np.int32))
                cover[n] += ones
        spec = _model(name, leg, legs[leg][0][f"{name}:part"]).held
        for n, full in whole.items():
            np.testing.assert_array_equal(built[n], full, err_msg=n)
            assert (cover[n] == dp * R // 2 ** sum(e is not None for e in spec[n])).all(), n
        if leg == "gspmd":
            fs = set(legs[leg][0][f"{name}:fsdp"])
            want = ({"enc_layers.attn.wq", "dec_layers.cross.wk", "dec_layers.mlp.wo"}
                    if name == "whisper-tiny" else
                    {"layers.attn.wq", "layers.mlp.wo", "projector.w1", "projector.w2"})
            assert want <= fs and "pos_dec" not in fs and not any("norm" in n or ".ln" in n
                                                                  for n in fs), fs


# ---------------------------------------------------------------------------
# the (1, 2) leg against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_split_forward_matches_the_reference(name, legs):
    want = legs["ref"][name]["logits"]
    for out in legs["abi"]:
        np.testing.assert_allclose(out[f"{name}:logits"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out[f"{name}:last"][:, 0], want[:, -1], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_split_gradient_matches_the_reference(name, legs):
    """Every leaf block's gradient of the whole batch's loss: the split
    leaves' blocks, the leaves held whole whole (the K/V projections and
    the encoder output summed over the model axis where the heads split)."""
    grads = legs["ref"][name]["grad"]
    for out in legs["abi"]:
        m = _model(name, "abi", out[f"{name}:part"])
        assert sorted(grads) == sorted(m.full_shapes)
        for n, full in grads.items():
            np.testing.assert_allclose(out[f"{name}:grad:{n}"], take_block(m, n, full), rtol=0,
                                       atol=GRAD_TOL * float(np.abs(full).max()), err_msg=n)


@pytest.mark.parametrize("name", list(CASES))
def test_split_decode_matches_the_reference(name, legs):
    """whisper: ``init_cache`` (the encoder once, each decoder layer's cross
    K/V from the rank's heads); phi-3-vision: ``prefill_multimodal`` of the
    patches and 8 tokens.  The cache as filled, block for block, within one
    bfloat16 rounding of the reference's; then 4 steps on the rank's block
    of the reference's cache, each step's logits within 2e-5 (a K/V entry
    the split sums in another order may round one bfloat16 step apart,
    which moves the smoke logits by up to 2e-4: ``test_torch_tp``'s
    practice)."""
    ref = legs["ref"][name]
    cfg = _cfg(name)
    keys = decode_cache_names(cfg.family)
    for r, out in enumerate(legs["abi"]):
        np.testing.assert_allclose(out[f"{name}:decode"], ref["decode"], atol=TOL, rtol=TOL)
        for i, key in enumerate(keys):
            want = cache_block(cfg, r, R, key, ref["cache"][str(i)])
            got = out[f"{name}:cache:{key}"]
            assert got.shape == want.shape, key
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=CACHE_TOL, err_msg=key)
        heads = out[f"{name}:cache:k"].shape[3]
        assert heads == (cfg.num_kv_heads // R if cfg.num_kv_heads % R == 0
                         else cfg.num_kv_heads)


def _check_steps(name: str, leg: str, legs) -> None:
    ref = legs["ref"][name]
    losses, whole = legs["unsplit"][name]
    np.testing.assert_allclose(losses, ref["losses"], rtol=STEP_RTOL)
    for out in legs[leg]:
        np.testing.assert_allclose(out[f"{name}:losses"], ref["losses"], rtol=STEP_RTOL)
        np.testing.assert_allclose(out[f"{name}:grad_norms"], ref["grad_norms"],
                                   rtol=STEP_RTOL)
        m = _model(name, leg, out[f"{name}:part"])
        assert sorted(m.full_shapes) == sorted(whole)
        for n, full in whole.items():
            got, want = out[f"{name}:param:{n}"], take_block(m, n, full)
            assert got.shape == want.shape, n
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=LEAF_TOL * float(np.abs(full).max()), err_msg=n)
    assert legs[leg][0][f"{name}:losses"][-1] < legs[leg][0][f"{name}:losses"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_abi_step_at_one_by_two_matches_the_reference(arch, legs):
    _check_steps(arch, "abi", legs)


@pytest.mark.parametrize("arch", ARCHS)
def test_gspmd_step_with_fsdp_at_two_by_two_matches_the_reference(arch, legs):
    _check_steps(arch, "gspmd", legs)


# ---------------------------------------------------------------------------
# the layout's rules and the raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_are_the_references(arch):
    """``ModelApi.cache_specs`` is the reference's: whisper's four cache
    tensors and phi-3-vision's K/V, batch over the data axes and K/V heads
    over the model axis."""
    import jax

    import repro.configs as R_cfgs
    from repro.models import build_model as r_build

    want = r_build(R_cfgs.get_config(arch)).cache_specs()
    got = build_model(T_cfgs.get_config(arch)).cache_specs()
    flat = lambda t: [tuple(s) for s in jax.tree.leaves(  # noqa: E731
        t, is_leaf=lambda v: isinstance(v, tuple) and not hasattr(v, "_fields"))]
    assert flat(got) == flat(want) and len(flat(got)) == len(decode_cache_names(
        T_cfgs.get_config(arch).family))


def _flat_specs(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_held_layout_follows_the_reference_rules_at_the_production_axis(arch):
    """At the configs' 16-wide model axis whisper-tiny splits its MLPs only
    (6 heads and 51,865 tokens do not divide 16), phi-3-vision-4.2b its
    heads, ``d_ff``, vocabulary and projector ``w2``; what a rank of the 16
    x 16 mesh holds, in the reference's axis names, is the reference's
    ``param_specs`` leaf by leaf (with the fsdp axis too)."""
    import repro.configs as R_cfgs
    from repro.models import build_model as r_build
    from repro_torch.models.tensor_parallel import FSDP

    cfg = T_cfgs.get_config(arch)
    split = {n for n, s in held_layout(cfg, Part(0, 16)).items() if TP in s}
    if arch == "whisper-tiny":
        assert split == SPLIT[WHOLE_HEADS]
    else:
        assert split == SPLIT[arch]
    rapi = r_build(R_cfgs.get_config(arch))
    for part, fsdp in ((Part(0, 16), None), (Part(0, 16, 0, 16), "data")):
        names = {TP: "model", FSDP: fsdp}
        got = {n: tuple(names.get(e) for e in spec) for n, spec in held_layout(cfg, part).items()}
        assert got == _flat_specs(rapi.param_specs(fsdp=fsdp)), fsdp


def _tiny_batch(cfg) -> dict:
    import torch

    return {k: torch.from_numpy(v[:1, :8] if k in ("tokens", "targets") else v[:1])
            for k, v in _batch(cfg).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_a_split_model_without_its_dist_raises(arch):
    """No fallback: a model holding a block of the model axis refuses to
    run its forward, its loss or its decode without the dist its layers
    compute on."""
    from repro_torch.models import encdec

    cfg = _cfg(arch)
    api = build_model(cfg)
    model = api.init(0, "cpu", model_rank=0, model_axis=R)
    b = _tiny_batch(cfg)
    with pytest.raises(ValueError, match="pass the dist"):
        api.forward(model, b)
    with pytest.raises(ValueError, match="pass the dist"):
        api.loss_fn(model, b)
    with pytest.raises(ValueError, match="pass the dist"):
        if cfg.family == "encdec":
            encdec.init_cache(model, b["frames"], cfg, 1, 8)
        else:
            api.decode_step(model, b["tokens"][:, :1],
                            api.decode_init(1, 8, device="cpu", model_axis=R), 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallelism_on_a_split_model_raises(arch):
    """Sequence parallelism (no encdec or vlm config asks for it) raises on
    a split model rather than computing another layout."""
    cfg = _cfg(arch, sequence_parallel=True)
    api = build_model(cfg)
    model = api.init(0, "cpu", model_rank=0, model_axis=R)
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        api.forward(model, _tiny_batch(cfg))
