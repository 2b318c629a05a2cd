"""The ssm (rwkv6-7b) and hybrid (zamba2-2.7b) families on the model axis
against the reference on the same mesh, on the CPU at the smoke size in
float32: rwkv6's time mix on a rank's heads and its channel mix split,
the Mamba2 layers split per segment, the hybrid's shared block split by
output, heads and ``d_ff``, the vocabulary split, and FSDP under
``gspmd``.

Both packages' smoke configs (rwkv6: H = 4 heads of N = 16; Mamba2:
d_inner = 128, H = 8, N = 8; the shared block's 4 heads of 16) get the
same ``dataclasses.replace``: ``tp_size`` set to the test mesh's model
axis (2), remat ``"full"`` and two microbatches.  The reference runs in
one subprocess on a (data, model) = (2, 2) mesh of four fake CPU devices:
its forward, its ``decode_step`` over every position of the batch from
the zero state, and two ``gspmd`` steps (FSDP over the data axis, its
layout over the model axis).  GSPMD places the arrays and does not change
the numbers, so that step is the reference of both of the port's steps,
as ``test_torch_tp`` holds the dense ABI step to the reference's
single-device step (the reference's own ABI ZeRO-1 step would compile
once more an arch).  The port runs on gloo ranks (``_torch_ssm_tp_ranks.py``) meeting through
``file://`` in ``tmp_path``, each rank holding its block
(``from_jax_params`` with ``train_loop.model_part``):

1. each rank's blocks tile every leaf (``take_block``; ``put_block``
   reassembles the reference's leaf from them), and the Mamba2
   ``in_proj``/``conv`` blocks are the reference's columns segment by
   segment;
2. the forward at (1, 2): logits and ``last_only`` within 2e-5; the split
   decode from the rank's block of the reference's state after 12 tokens,
   4 steps, each step's logits within 2e-5 of the reference's and the
   state after them within 2e-5 of the rank's block of the reference's
   (the hybrid's bfloat16 K/V cache within one bfloat16 rounding);
3. the gradient of the whole batch's loss at the initial weights at
   (1, 2): each leaf block within 1e-5 of the reference's leaf's largest
   element (``test_torch_moe_tp``'s bound; 2e-5 for rwkv6, whose float32
   gradient is ill-conditioned: the port's unsplit gradient of
   ``embed.tok`` is 8.4e-6 of its largest element from the reference's);
4. two ABI ZeRO-1 steps at (1, 2) and two ``gspmd`` steps with FSDP at
   (2, 2): losses and grad norms within 1e-5 relative of the reference's
   (``test_torch_tp``'s bound), and each leaf block within 5e-5 of the
   whole leaf's largest magnitude (``test_torch_tp``'s bound) of the
   port's own unsplit step on the same weights, which the split changes
   in summation order only — except at most 0.1% of a leaf's elements
   (at least one), each within 2e-4: AdamW's normalised step amplifies
   the rounding of a near-zero gradient (one element of ``shared.in_proj``
   and of ``shared.mlp.wo`` at 6e-5).  A leaf that starts at zero
   (Mamba2's ``conv_b``, rwkv6's token-shift mixes and ``ln_x`` bias)
   holds those steps only, each ``lr * mhat / (sqrt(vhat) + eps)``, which
   a rounding error e of an element's gradient g moves by about
   ``lr * e / |g|``: every element within 2e-3 of its largest magnitude
   (``conv_b`` at 6.1e-4 under FSDP, on elements whose first gradient is
   a tenth of the leaf's largest; ``mu_base`` at 1.1e-4).  The gradients
   themselves are held at 1e-5 above.  The blocks are not held to the reference's
   leaves at that bound: for the same reason, on the port's unsplit step
   the zero-initialised leaves (Mamba2's ``conv_b``, rwkv6's token-shift
   mixes and ``ln_x`` bias) and rwkv6's ``lora_b`` already end 1.4e-4 and
   9.1e-5 of their largest magnitude from the reference
   (``test_torch_train_slice`` holds that step at 2e-5 absolute);
5. the raises: a split model without its dist, and under sequence
   parallelism;
6. the held layout at the production axis, a unit that does not divide
   the axis staying whole, and rwkv6 at its full head width (N = 64,
   chunk 32) split as the unsplit port computes it, in float32 and in
   float64 (where the split changes nothing but the summation order:
   within 1e-12).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch.configs as T_cfgs
from repro_torch.models import build_model
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.model import _family
from repro_torch.models.rwkv import RwkvLM
from repro_torch.models.tensor_parallel import put_block, take_block
from repro_torch.optim.adamw import AdamWConfig as T_Adam

from _torch_ranks import run_ranks
from _torch_ssm_tp_ranks import ssm_tp_rank, state_block

ARCHS = ("rwkv6-7b", "zamba2-2.7b")
CLASSES = {"rwkv6-7b": RwkvLM, "zamba2-2.7b": HybridLM}
SRC = Path(__file__).resolve().parent.parent / "src"
R = 2
STEPS = 2
TOL = 2e-5
STEP_RTOL = 1e-5
LEAF_TOL = 5e-5
#: a leaf's gradient against the reference's, of its largest element
#: (``test_torch_moe_tp``'s bound; rwkv6's float32 gradient is
#: ill-conditioned, and the port's own unsplit gradient of ``embed.tok`` is
#: 8.4e-6 of its largest element from the reference's)
GRAD_TOL = {"rwkv6-7b": 2e-5, "zamba2-2.7b": 1e-5}
#: after the steps: the share of a leaf's elements (at least one) that may
#: lie outside ``LEAF_TOL``, each within ``NOISE_TOL`` of its largest
#: magnitude (AdamW's normalised step amplifies a near-zero gradient's
#: rounding)
NOISE_SHARE, NOISE_TOL = 1e-3, 2e-4
#: a leaf that starts at zero holds AdamW's normalised steps only: every
#: element within this share of its largest magnitude
ZERO_LEAF_TOL = 2e-3
#: the split decode: the prefix the reference's state has seen, then the
#: steps the port decodes from the rank's block of it
PREFIX = 12
SEQ = 16
#: the legs' parallelism beyond the configs' own
LEGS = {"abi": dict(grad_sync="abi"), "gspmd": dict(grad_sync="gspmd")}

_SCRIPT = """
import dataclasses, json, sys
import numpy as np
import jax
import jax.numpy as jnp
import repro.configs as R
from repro.core.compat import make_mesh
from repro.models import build_model
from repro.optim.adamw import AdamWConfig
from repro.runtime.dist import make_dist
from repro.train import train_loop

d, dp, tp, steps, prefix = sys.argv[1], *map(int, sys.argv[2:6])
archs = json.loads(sys.argv[6])
path = lambda p: ".".join(str(getattr(k, "key", getattr(k, "name", k))) for k in p)
flat = lambda tree, dt=None: {path(p): np.asarray(v, dt) for p, v in
                             jax.tree_util.tree_flatten_with_path(tree)[0]}
with np.load(f"{d}/in.npz") as f:
    batch = {k: jnp.asarray(f[k]) for k in f.files}
B, S = batch["tokens"].shape
dist = make_dist(make_mesh((dp, tp), ("data", "model")))
out = {}
for arch in archs:
    cfg = R.smoke_config(arch)
    cfg = dataclasses.replace(cfg, parallelism=dataclasses.replace(
        cfg.parallelism, tp_size=tp, remat="full", microbatch=2, grad_sync="gspmd"))
    api = build_model(cfg)
    params = jax.jit(api.init)(jax.random.PRNGKey(0))
    out.update({f"{arch}:init:{n}": v for n, v in flat(params).items()})
    out[f"{arch}:logits"] = np.asarray(jax.jit(lambda p: api.forward(p, batch)[0])(params))
    grad = jax.jit(jax.grad(lambda p: api.loss_fn(p, batch)))(params)
    out.update({f"{arch}:grad:{n}": v for n, v in flat(grad).items()})
    step = jax.jit(lambda p, t, s, i: api.decode_step(p, t, s, i))
    state = api.decode_init(B, S)
    dec = []
    for i in range(S):
        if i == prefix:
            out.update({f"{arch}:prefix:{n}": v for n, v in flat(state._asdict(), np.float32).items()})
        logits, state = step(params, batch["tokens"][:, i:i + 1], state, jnp.int32(i))
        if i >= prefix:
            dec.append(np.asarray(logits))
    out[f"{arch}:decode"] = np.stack(dec)
    out.update({f"{arch}:state:{n}": v for n, v in flat(state._asdict(), np.float32).items()})
    state = train_loop.init_state(api, jax.random.PRNGKey(0), dist=dist)
    tstep = jax.jit(train_loop.make_train_step(api, dist, AdamWConfig()))
    losses, norms = [], []
    for _ in range(steps):
        state, met = tstep(state, batch)
        losses.append(float(met.loss))
        norms.append(float(met.grad_norm))
    out[f"{arch}:losses"], out[f"{arch}:grad_norms"] = np.array(losses), np.array(norms)
    out.update({f"{arch}:final:{n}": v for n, v in flat(state.params).items()})
np.savez(d + "/out.npz", **out)
"""

#: the reference's state leaves (flattened names) -> the rank program's names
STATE_NAMES = {"rwkv6-7b": {"shift_tm": "shift_tm", "shift_cm": "shift_cm", "wkv": "wkv"},
               "zamba2-2.7b": {"mamba.conv": "conv", "mamba.ssm": "ssm", "attn_kv.k": "k",
                               "attn_kv.v": "v"}}


def _cfg(arch: str, leg: str, **par):
    """The port's config of one leg (the reference script makes its twin)."""
    cfg = T_cfgs.smoke_config(arch)
    return dataclasses.replace(cfg, parallelism=dataclasses.replace(
        cfg.parallelism, tp_size=R, remat="full", microbatch=2, **LEGS[leg], **par))


def _batch() -> dict:
    tok = np.random.default_rng(3).integers(0, 512, size=(4, SEQ)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference at (data, model) = (2, 2), one subprocess: arch ->
    records (the weights, the forward, the decode and the ``gspmd``
    steps)."""
    d = tmp_path_factory.mktemp("ssm_tp_ref")
    np.savez(d / "in.npz", **_batch())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={2 * R}")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d), "2", str(R), str(STEPS), str(PREFIX),
         json.dumps(ARCHS)], env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "out.npz") as f:
        flat = {k: f[k] for k in f.files}
    out: dict = {}
    for arch in ARCHS:
        mine = {k.split(":", 1)[1]: v for k, v in flat.items() if k.startswith(arch + ":")}
        rec = {k: v for k, v in mine.items() if ":" not in k}
        for sect in ("init", "final", "grad", "prefix", "state"):
            rec[sect] = {k[len(sect) + 1:]: v for k, v in mine.items()
                         if k.startswith(sect + ":")}
        for sect in ("prefix", "state"):
            rec[sect] = {STATE_NAMES[arch][k]: v for k, v in rec[sect].items()}
        out[arch] = rec
    return out


def _leg(tmp_path_factory, ref: dict, leg: str, dp: int):
    cases = []
    for arch in ARCHS:
        rec = ref[arch]
        decode = (PREFIX, rec["prefix"]) if leg == "abi" else None
        batch = _batch()
        cases.append((arch, _cfg(arch, leg), _nest(rec["init"]), batch, decode))
    return run_ranks(ssm_tp_rank, dp * R, tmp_path_factory.mktemp(f"ssm_tp_{leg}"), R,
                     cases, STEPS, timeout=300)


@pytest.fixture(scope="module")
def abi_leg(tmp_path_factory, reference):
    """(1, 2): the forward and the split decode, then the ABI ZeRO-1 steps."""
    return reference, _leg(tmp_path_factory, reference, "abi", 1)


@pytest.fixture(scope="module")
def fsdp_leg(tmp_path_factory, reference):
    """(2, 2): the ``gspmd`` steps with FSDP."""
    return reference, _leg(tmp_path_factory, reference, "gspmd", 2)


def _model(arch: str, leg: str, part) -> object:
    return CLASSES[arch](_cfg(arch, leg), "meta", *(int(v) for v in part))


# ---------------------------------------------------------------------------
# what a rank holds
# ---------------------------------------------------------------------------
#: the leaves the reference's spec_lm splits over the model axis
SPLIT = {"rwkv6-7b": {"layers.wr", "layers.wk", "layers.wv", "layers.wg", "layers.wo",
                      "layers.cm_wk", "layers.cm_wv", "layers.cm_wr", "embed.tok",
                      "embed.unembed"},
         "zamba2-2.7b": {"layers.in_proj", "layers.conv_w", "layers.conv_b", "layers.out_proj",
                         "shared.in_proj", "shared.out_proj", "shared.attn.wq",
                         "shared.attn.wk", "shared.attn.wv", "shared.attn.wo",
                         "shared.attn.bq", "shared.attn.bk", "shared.attn.bv",
                         "shared.mlp.wi", "shared.mlp.wg", "shared.mlp.wo", "embed.tok",
                         "embed.unembed"}}


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_block_and_the_blocks_tile_each_leaf(arch, abi_leg, fsdp_leg):
    """Each rank of both legs holds the leaves ``spec_lm`` splits split
    (its part, under ``gspmd`` its fsdp block too), every held leaf is
    ``take_block`` of the reference's, and ``put_block`` of every rank's
    block reassembles the reference's leaf, each element covered as many
    times as the leaf is replicated."""
    for (ref, ranks), leg, dp in ((abi_leg, "abi", 1), (fsdp_leg, "gspmd", 2)):
        init = ref[arch]["init"]
        cover = {n: np.zeros(v.shape, np.int32) for n, v in init.items()}
        whole = {n: np.zeros_like(v) for n, v in init.items()}
        for r, out in enumerate(ranks):
            part = out[f"{arch}:part"]
            assert list(part) == [r % R, R, r // R if dp > 1 else 0, dp]
            assert set(out[f"{arch}:split"]) == SPLIT[arch] & set(init), leg
            m = _model(arch, leg, part)
            for name, full in init.items():
                block = out[f"{arch}:held:{name}"]
                np.testing.assert_array_equal(block, take_block(m, name, full), err_msg=name)
                put_block(m, name, whole[name], block)
                ones = np.zeros(full.shape, np.int32)
                put_block(m, name, ones, np.ones(block.shape, np.int32))
                cover[name] += ones
        for name, full in init.items():
            np.testing.assert_array_equal(whole[name], full, err_msg=name)
            spec = _model(arch, leg, ranks[0][f"{arch}:part"]).held[name]
            assert (cover[name] == dp * R // 2 ** sum(e is not None for e in spec)).all(), name
        if leg == "gspmd":
            fs = set(ranks[0][f"{arch}:fsdp"])
            want = ({"layers.wr", "layers.lora_a", "layers.cm_wv"} if arch == "rwkv6-7b"
                    else {"layers.in_proj", "layers.out_proj", "shared.in_proj"})
            assert want <= fs and not any(".ln" in n or "norm" in n for n in fs), fs


def test_the_mamba2_blocks_are_the_references_columns_segment_by_segment(abi_leg):
    """A rank's ``in_proj`` holds its ``d_inner / 2`` columns of z and of x,
    its ``N / 2`` of B and of C and its ``H / 2`` of dt, in that order; its
    ``conv_w``/``conv_b`` its x, B and C channels' blocks: 1/2 of each leaf,
    not the reference's contiguous half."""
    ref, ranks = abi_leg
    cfg = _cfg("zamba2-2.7b", "abi")
    d_inner, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_size
    H = d_inner // cfg.ssm.head_dim
    init = ref["zamba2-2.7b"]["init"]
    for r, out in enumerate(ranks):
        got = out["zamba2-2.7b:held:layers.in_proj"]
        segs = np.split(init["layers.in_proj"], np.cumsum([d_inner, d_inner, N, N])[:], -1)
        want = [s[..., r * (s.shape[-1] // R):(r + 1) * (s.shape[-1] // R)] for s in segs]
        np.testing.assert_array_equal(got, np.concatenate(want, -1))
        assert got.shape[-1] == (2 * d_inner + 2 * N + H) // R
        for leaf in ("conv_w", "conv_b"):
            full = init[f"layers.{leaf}"]
            segs = np.split(full, np.cumsum([d_inner, N])[:], -1)
            want = [s[..., r * (s.shape[-1] // R):(r + 1) * (s.shape[-1] // R)] for s in segs]
            np.testing.assert_array_equal(out[f"zamba2-2.7b:held:layers.{leaf}"],
                                          np.concatenate(want, -1))
        assert not np.array_equal(
            got, init["layers.in_proj"][..., r * got.shape[-1]:(r + 1) * got.shape[-1]])


# ---------------------------------------------------------------------------
# the legs against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_split_forward_matches_the_reference(arch, abi_leg):
    ref, ranks = abi_leg
    want = ref[arch]["logits"]
    for out in ranks:
        np.testing.assert_allclose(out[f"{arch}:logits"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out[f"{arch}:last"][:, 0], want[:, -1], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_decode_on_the_ranks_block_of_the_state_matches_the_reference(arch, abi_leg):
    """From the rank's block of the reference's state after ``PREFIX``
    tokens: every step's logits, and the state after the last step block
    for block (the rank's WKV heads; its conv channels per segment, SSM
    heads and K/V heads)."""
    ref, ranks = abi_leg
    cfg = _cfg(arch, "abi")
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"{arch}:decode"], ref[arch]["decode"], atol=TOL,
                                   rtol=TOL)
        want = state_block(cfg, r, R, ref[arch]["state"])
        held = {k[len(f"{arch}:state:"):]: v for k, v in out.items()
                if k.startswith(f"{arch}:state:")}
        assert sorted(held) == sorted(want)
        for k, v in want.items():
            assert held[k].shape == v.shape, k
            if k in ("k", "v"):  # bfloat16 caches
                np.testing.assert_allclose(held[k], v, rtol=2.0 ** -7, atol=1e-4, err_msg=k)
            else:
                np.testing.assert_allclose(held[k], v, rtol=TOL, atol=TOL, err_msg=k)
        heads = held["wkv" if arch == "rwkv6-7b" else "ssm"].shape[2]
        inner = cfg.d_model * (1 if arch == "rwkv6-7b" else cfg.ssm.expand)
        assert heads == inner // cfg.ssm.head_dim // R


@pytest.fixture(scope="module")
def unsplit(reference):
    """The port's unsplit ``gspmd`` step (one process) on the reference's
    weights and the same batch: arch -> (losses, leaf name -> final)."""
    import torch

    from repro_torch.models import from_jax_params, param_leaves
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop as tl

    out = {}
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for arch in ARCHS:
        cfg = _cfg(arch, "gspmd")
        model = from_jax_params(_nest(reference[arch]["init"]), cfg, device="cpu")
        state = tl.TrainState(model, adamw.init_tree(param_leaves(model)),
                              torch.zeros((), dtype=torch.int32))
        step = tl.make_train_step(build_model(cfg), None, T_Adam())
        losses = []
        for _ in range(STEPS):
            state, met = step(state, batch)
            losses.append(float(met.loss))
        out[arch] = (losses, {n: p.detach().numpy() for n, p in param_leaves(model)})
    return out


def _check_steps(arch, leg_out, leg, unsplit):
    ref, ranks = leg_out
    ref = ref[arch]
    losses, whole = unsplit[arch]
    np.testing.assert_allclose(losses, ref["losses"], rtol=STEP_RTOL)
    for out in ranks:
        np.testing.assert_allclose(out[f"{arch}:losses"], ref["losses"], rtol=STEP_RTOL)
        np.testing.assert_allclose(out[f"{arch}:grad_norms"], ref["grad_norms"],
                                   rtol=STEP_RTOL)
        m = _model(arch, leg, out[f"{arch}:part"])
        assert sorted(ref["final"]) == sorted(m.full_shapes) == sorted(whole)
        for name, full in whole.items():
            got = out[f"{arch}:param:{name}"]
            want = take_block(m, name, full)
            assert got.shape == want.shape, name
            scale = float(np.abs(full).max())
            if not ref["init"][name].any():
                np.testing.assert_allclose(got, want, rtol=0, atol=ZERO_LEAF_TOL * scale,
                                           err_msg=name)
                continue
            off = np.abs(got - want) > LEAF_TOL * scale
            assert off.sum() <= max(1, NOISE_SHARE * off.size), (name, int(off.sum()))
            np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_TOL * scale, err_msg=name)
    assert ranks[0][f"{arch}:losses"][-1] < ranks[0][f"{arch}:losses"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_split_gradient_at_the_initial_weights_matches_the_reference(arch, abi_leg):
    """Every leaf block's gradient of the whole batch's loss at (1, 2):
    the split leaves' blocks, and the leaves held whole (those read partly
    summed over the model axis) whole."""
    ref, ranks = abi_leg
    grads = ref[arch]["grad"]
    for out in ranks:
        m = _model(arch, "abi", out[f"{arch}:part"])
        assert sorted(grads) == sorted(m.full_shapes)
        for name, full in grads.items():
            np.testing.assert_allclose(out[f"{arch}:grad:{name}"], take_block(m, name, full),
                                       rtol=0,
                                       atol=GRAD_TOL[arch] * float(np.abs(full).max()),
                                       err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_abi_step_at_one_by_two_matches_the_reference(arch, abi_leg, unsplit):
    _check_steps(arch, abi_leg, "abi", unsplit)


@pytest.mark.parametrize("arch", ARCHS)
def test_gspmd_step_with_fsdp_at_two_by_two_matches_the_reference(arch, fsdp_leg, unsplit):
    _check_steps(arch, fsdp_leg, "gspmd", unsplit)


# ---------------------------------------------------------------------------
# the layout's rules and the raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_are_the_references(arch):
    """``ModelApi.cache_specs`` of both families is the reference's
    ``state_specs``."""
    import jax

    import repro.configs as R_cfgs
    from repro.models import build_model as r_build

    want = r_build(R_cfgs.get_config(arch)).cache_specs()
    got = build_model(T_cfgs.get_config(arch)).cache_specs()
    flat = lambda t: [tuple(s) for s in jax.tree.leaves(  # noqa: E731
        t, is_leaf=lambda v: isinstance(v, tuple) and not hasattr(v, "_fields"))]
    assert flat(got) == flat(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_split_model_without_its_dist_raises(arch):
    """No fallback: a model holding a block of the model axis refuses to
    run without the dist its layers compute on."""
    import torch

    cfg = _cfg(arch, "abi")
    api = build_model(cfg)
    model = api.init(0, "cpu", model_rank=0, model_axis=R)
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="pass the dist"):
        api.forward(model, {"tokens": tokens})
    with pytest.raises(ValueError, match="pass the dist"):
        api.decode_step(model, tokens[:, :1], api.decode_init(1, 8, device="cpu",
                                                              model_axis=R), 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallelism_on_a_split_model_raises(arch):
    """Sequence parallelism (no ssm or hybrid config asks for it) raises on
    a split model rather than computing another layout."""
    import torch

    cfg = _cfg(arch, "abi", sequence_parallel=True)
    api = build_model(cfg)
    model = api.init(0, "cpu", model_rank=0, model_axis=R)
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        api.forward(model, {"tokens": torch.zeros((1, 8), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# the held layout at the production axis, and a unit that does not divide
# ---------------------------------------------------------------------------
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
    """At the configs' own 16-wide model axis every unit splits (rwkv6-7b's
    64 heads, its ``d_ff`` and ``d_model``; zamba2-2.7b's 80 Mamba2 heads
    and 64 B/C channels, its ``d_model``, its 32 query and K/V heads and
    ``d_ff``; both vocabularies), the norms and the leaves read partly stay
    whole, and what a rank of the 16 x 16 mesh holds, in the reference's
    axis names, is the reference's ``param_specs`` leaf by leaf (with the
    fsdp axis too)."""
    import repro.configs as R_cfgs
    from repro.models import build_model as r_build
    from repro_torch.models.tensor_parallel import FSDP, TP, Part, held_layout

    cfg = T_cfgs.get_config(arch)
    held = held_layout(cfg, Part(0, 16))
    split = {n for n, spec in held.items() if TP in spec}
    assert split == SPLIT[arch] & set(held), sorted(split ^ SPLIT[arch])
    assert not any(any(held[n]) for names in _family(cfg)[0].read_partly(cfg).values()
                   for n in names)
    rapi = r_build(R_cfgs.get_config(arch))
    for part, fsdp in ((Part(0, 16), None), (Part(0, 16, 0, 16), "data")):
        names = {TP: "model", FSDP: fsdp}
        got = {n: tuple(names.get(e) for e in spec) for n, spec in held_layout(cfg, part).items()}
        assert got == _flat_specs(rapi.param_specs(fsdp=fsdp)), fsdp


#: smoke configs whose unit does not divide a model axis of 2: rwkv6 with
#: one head of 64 (its time mix stays whole, its channel mix splits), the
#: hybrid with 3 B/C channels (its Mamba2 layers stay whole, its shared
#: block splits)
UNEVEN = {"rwkv6-7b": dict(head_dim=64), "zamba2-2.7b": dict(state_size=3)}
#: their gradients against the unsplit model's, of each leaf's largest
#: element: rwkv6's one head of 64 is its worst-conditioned gradient (a
#: perturbation of every weight by 1e-7 of itself, float32's rounding,
#: moves the unsplit gradient of ``u`` by 1.0e-5 of its largest element)
UNEVEN_GRAD_TOL = {"rwkv6-7b": 5e-5, "zamba2-2.7b": 1e-5}


def test_a_unit_that_does_not_divide_the_axis_stays_whole_and_computes_alike(tmp_path):
    """Such a unit stays whole on every rank (``held_layout``), runs
    replicated beside the split ones, and the split model's logits and
    gradient are the unsplit model's on the same weights (2e-5, and
    ``UNEVEN_GRAD_TOL`` of each leaf's largest gradient element)."""
    import torch

    from repro_torch.models import from_jax_params, param_leaves

    cases, want = [], {}
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for arch, ssm in UNEVEN.items():
        base = _cfg(arch, "abi")
        cfg = dataclasses.replace(base, ssm=dataclasses.replace(base.ssm, **ssm))
        api = build_model(cfg)
        model = api.init(0, "cpu")
        leaves = param_leaves(model)
        grads = torch.autograd.grad(api.loss_fn(model, batch), [p for _, p in leaves],
                                    materialize_grads=True)
        with torch.no_grad():
            want[arch] = (api.forward(model, batch).numpy(),
                          {n: g.numpy() for (n, _), g in zip(leaves, grads)})
        tree = _nest({n: p.detach().numpy() for n, p in leaves})
        cases.append((arch, cfg, tree, _batch(), (SEQ, None)))
    ranks = run_ranks(ssm_tp_rank, R, tmp_path, R, cases, 0, timeout=240)
    whole = {"rwkv6-7b": "layers.wr", "zamba2-2.7b": "layers.in_proj"}
    split = {"rwkv6-7b": "layers.cm_wk", "zamba2-2.7b": "shared.in_proj"}
    for arch, (logits, grads) in want.items():
        for out in ranks:
            names = set(out[f"{arch}:split"])
            assert whole[arch] not in names and split[arch] in names, names
            np.testing.assert_allclose(out[f"{arch}:logits"], logits, atol=TOL, rtol=TOL)
            m = CLASSES[arch](cases[ARCHS.index(arch)][1], "meta",
                              *(int(v) for v in out[f"{arch}:part"]))
            for name, g in grads.items():
                np.testing.assert_allclose(out[f"{arch}:grad:{name}"], take_block(m, name, g),
                                           rtol=0,
                                           atol=UNEVEN_GRAD_TOL[arch] * float(np.abs(g).max()),
                                           err_msg=name)


def _full_head_width(tmp_path, dtype: str) -> tuple:
    """rwkv6 at the full config's head width and chunk (N = 64, chunk 32),
    four heads split over two ranks, T = 64, in ``dtype``: (the config,
    the unsplit port's logits and gradient by leaf, the ranks' outputs)."""
    import torch

    from repro_torch.models import param_leaves

    base = _cfg("rwkv6-7b", "abi")
    cfg = dataclasses.replace(base, d_model=256, d_ff=512, param_dtype=dtype,
                              compute_dtype=dtype, ssm=dataclasses.replace(
                                  base.ssm, head_dim=64, chunk_size=32))
    api = build_model(cfg)
    tok = np.random.default_rng(5).integers(0, 512, size=(2, 64)).astype(np.int32)
    batch = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    model = api.init(0, "cpu")
    leaves = param_leaves(model)
    grads = torch.autograd.grad(api.loss_fn(model, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()}),
                                [p for _, p in leaves], materialize_grads=True)
    with torch.no_grad():
        logits = api.forward(model, {"tokens": torch.from_numpy(tok)}).numpy()
    tree = _nest({n: p.detach().numpy() for n, p in leaves})
    ranks = run_ranks(ssm_tp_rank, R, tmp_path, R, [("rwkv6-7b", cfg, tree, batch, (64, None))],
                      0, timeout=240)
    return cfg, logits, {n: g.numpy() for (n, _), g in zip(leaves, grads)}, ranks


def _hold_full_head_width(cfg, logits, grads, ranks, tol: float, grad_tol: float) -> None:
    for out in ranks:
        assert "layers.wr" in set(out["rwkv6-7b:split"])
        np.testing.assert_allclose(out["rwkv6-7b:logits"], logits, atol=tol, rtol=tol)
        m = RwkvLM(cfg, "meta", *(int(v) for v in out["rwkv6-7b:part"]))
        assert m.layers.wr.shape[-1] // 64 == 2
        for name, g in grads.items():
            np.testing.assert_allclose(out[f"rwkv6-7b:grad:{name}"], take_block(m, name, g),
                                       rtol=0, atol=grad_tol * float(np.abs(g).max()),
                                       err_msg=name)


def test_split_rwkv6_at_its_full_head_width_computes_as_unsplit(tmp_path):
    """rwkv6 at the full config's head width and chunk (N = 64, chunk 32),
    four heads split over two ranks, T = 64: the split model's logits and
    gradient are the unsplit port's on the same weights (2e-5; 1e-5 of
    each leaf's largest gradient element), the scan on two heads a rank."""
    _hold_full_head_width(*_full_head_width(tmp_path, "float32"), TOL, 1e-5)


def test_split_rwkv6_in_float64_is_the_unsplit_model_but_for_rounding(tmp_path):
    """The same in float64 (the weights, the norms, the adapters, the scan
    and the loss; the plain scan on the CPU): the split changes the
    summation order and nothing else, so its logits and every leaf's
    gradient are the unsplit port's within 1e-12 (of the logits; of each
    leaf's largest gradient element).  float32 cannot show that at full
    width: there rwkv6's gradient is ill-conditioned (a head whose first
    output ``ln_x`` normalises is rank one, and its scale may sit near
    ``sqrt(eps)``), so a difference in summation order is amplified about
    10^4 times."""
    cfg, logits, grads, ranks = _full_head_width(tmp_path, "float64")
    assert logits.dtype == np.float64 and all(g.dtype == np.float64 for g in grads.values())
    _hold_full_head_width(cfg, logits, grads, ranks, 1e-12, 1e-12)
