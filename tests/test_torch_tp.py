"""Tensor parallelism and FSDP of the dense family against the reference's
single-device step, on the CPU at the smoke size in float32.

Three configs, the same ``dataclasses.replace`` applied to both packages'
smoke configs (whose ``parallelism`` is reset to ``tp_size=16``, under
which their four heads would never split): ``tp_size`` set to the test
mesh's model axis (2), remat ``"full"`` and two microbatches, and

* qwen2-0.5b with one K/V head: the query heads split, the K/V heads kept
  whole (each rank reads the K/V head of its query heads), QKV bias;
* gemma-7b: query and K/V heads split, the tied vocabulary split;
* nemotron-4-340b: ``sequence_parallel`` (the residual stream split along
  the sequence), layernorm, squared ReLU, an untied vocabulary split.

Three multi-rank legs, each one gloo world running the three configs
(rank programs in ``_torch_tp_ranks.py``, meeting through ``file://`` in
``tmp_path``):

1. the TP forward at ``model_axis=2``: logits and ``last_only`` against
   the reference's forward (2e-5, float32 products summed in another
   order, as ``test_torch_dense_configs``); the prefill's bfloat16 cache
   (the rank's K/V heads) against the reference's ``prefill`` within one
   bfloat16 rounding plus 1e-4 (``test_torch_encdec``'s cache bound: a
   K or V entry summed in another order can round one ulp apart), and the
   rank's decode step on its heads of the reference's cache against the
   reference's ``decode_step`` on the same weights (2e-5; on its own cache
   one such ulp moves nemotron's smoke logits by 1.3e-4, on the whole
   port as on the TP ranks);
2. two ABI ZeRO-1 steps at (data, model) = (1, 2);
3. two ``gspmd`` steps with FSDP at (2, 2): parameters and moments split
   over the data axis as well.

Each step is held to the reference's single-device step on the same
weights (``from_jax_params``): losses and grad norms within 1e-5 relative;
each updated leaf block within 5e-5 of the whole leaf's largest magnitude
(the port's own single-device step is 1.3e-5 from the reference on
gemma-7b's ``mlp.wo`` after two steps: Adam's normalised step amplifies
the rounding of near-zero gradients), and the key bias, whose exact
gradient is zero, within Adam's step bound (``test_torch_sharding``'s
``NOISE_LEAVES``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R_cfgs
from repro.core.compat import make_mesh
from repro.models import build_model as r_build
from repro.models import transformer as r_transformer
from repro.optim.adamw import AdamWConfig as R_Adam
from repro.runtime.dist import make_dist as r_make_dist
from repro.train import train_loop as r_tl

import repro_torch.configs as T_cfgs
from repro_torch.models.tensor_parallel import FSDP, TP, Part
from repro_torch.models.transformer import TransformerLM, held_layout
from repro_torch.models import build_model as t_build
from repro_torch.optim.adamw import AdamWConfig as T_Adam

from _torch_ranks import run_ranks
from _torch_tp_ranks import tp_rank

ARCHS = ("qwen2-0.5b", "gemma-7b", "nemotron-4-340b")
R = 2
STEPS = 2
TOL = 2e-5
STEP_RTOL = 1e-5
LEAF_TOL = 5e-5
NOISE_LEAVES = ("layers.attn.bk",)
CACHE_TOL = 1e-4


def _cfgs(arch: str, **par) -> tuple:
    """(reference config, port config) of one leg."""
    out = []
    for m in (R_cfgs, T_cfgs):
        cfg = m.smoke_config(arch)
        kw = {"num_kv_heads": 1} if arch == "qwen2-0.5b" else {}
        sp = arch == "nemotron-4-340b"
        out.append(dataclasses.replace(cfg, **kw, parallelism=dataclasses.replace(
            cfg.parallelism, tp_size=R, remat="full", microbatch=2, sequence_parallel=sp,
            **par)))
    return tuple(out)


def _batch() -> dict:
    tok = np.random.default_rng(3).integers(0, 512, size=(4, 16)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def _flat(tree) -> dict:
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference's weights (key 0), forward logits, the
    logits of a decode step after a prefill of all but the last token, and
    its single-device ``gspmd`` step run for ``STEPS`` steps; the
    prefill's bfloat16 cache as float32 numpy."""
    out = {}
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    for arch in ARCHS:
        rcfg = _cfgs(arch, grad_sync="gspmd")[0]
        api = r_build(rcfg)
        params = jax.jit(api.init)(jax.random.PRNGKey(0))
        logits, _ = jax.jit(api.forward)(params, batch)
        S = batch["tokens"].shape[1]
        _, cache, _ = jax.jit(lambda p, t: r_transformer.prefill(p, t, rcfg, max_seq=S))(
            params, batch["tokens"][:, :S - 1])
        decode, _ = jax.jit(lambda p, t, c: r_transformer.decode_step(
            p, t, c, jnp.int32(S - 1), rcfg))(params, batch["tokens"][:, S - 1:], cache)
        dist = r_make_dist(make_mesh((1, 1), ("data", "model")), impl="paxi")
        state = r_tl.init_state(api, jax.random.PRNGKey(0))._replace(params=params)
        step = jax.jit(r_tl.make_train_step(api, dist, R_Adam()))
        losses, norms = [], []
        for _ in range(STEPS):
            state, met = step(state, batch)
            losses.append(float(met.loss))
            norms.append(float(met.grad_norm))
        out[arch] = {"params": jax.tree.map(np.asarray, params),
                     "logits": np.asarray(logits), "decode": np.asarray(decode),
                     "cache": {"cache_k": np.asarray(cache.k, np.float32),
                               "cache_v": np.asarray(cache.v, np.float32)},
                     "losses": np.array(losses),
                     "grad_norms": np.array(norms), "final": _flat(state.params)}
    return out


def _leg(tmp_path_factory, reference, name, world, mode, **par):
    """The forward leg's batch carries the reference's cache."""
    extra = (lambda arch: reference[arch]["cache"]) if mode == "forward" else (lambda a: {})
    cases = [(arch, _cfgs(arch, **par)[1], reference[arch]["params"],
              dict(_batch(), **extra(arch))) for arch in ARCHS]
    return run_ranks(tp_rank, world, tmp_path_factory.mktemp(name), R, mode, cases, STEPS,
                     timeout=240)


@pytest.fixture(scope="module")
def forward_leg(tmp_path_factory, reference):
    return _leg(tmp_path_factory, reference, "forward", R, "forward")


@pytest.fixture(scope="module")
def abi_leg(tmp_path_factory, reference):
    return _leg(tmp_path_factory, reference, "abi", R, "train", grad_sync="abi")


@pytest.fixture(scope="module")
def fsdp_leg(tmp_path_factory, reference):
    return _leg(tmp_path_factory, reference, "fsdp", 2 * R, "train", grad_sync="gspmd")


# ---------------------------------------------------------------------------
# what a rank holds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,q,kv,vocab", [
    ("qwen2-0.5b", False, False, True),       # 14 / 2 heads: attention whole
    ("gemma-7b", True, True, True),           # 16 / 16 heads
    ("nemotron-4-340b", True, False, True),   # 96 query heads split, 8 K/V whole
])
def test_held_layout_follows_the_reference_rules_at_the_production_axis(arch, q, kv, vocab):
    """At the configs' own 16-wide model axis: heads split only where whole
    heads divide it, the FFN always, the vocabulary where it divides."""
    cfg = T_cfgs.get_config(arch)
    held = held_layout(cfg, Part(0, 16))
    assert ("tp" in held["layers.attn.wq"], "tp" in held["layers.attn.wk"]) == (q, kv)
    assert ("tp" in held["layers.attn.wo"]) == q
    assert "tp" in held["layers.mlp.wi"] and "tp" in held["layers.mlp.wo"]
    assert ("tp" in held["embed.tok"]) == vocab
    assert not any(held["layers.ln1.scale"]) and not any(held["final_norm.scale"])


def _flat_specs(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v)
    return out


@pytest.mark.parametrize("arch", ARCHS + ("qwen2-moe-a2.7b", "grok-1-314b"))
def test_held_specs_are_the_references_specs_at_the_production_axes(arch):
    """What a rank of the 16 x 16 mesh holds (``held_layout``), in the
    reference's axis names, is the reference's ``param_specs`` leaf by
    leaf (every production dimension divides; the moe family's experts by
    expert under ``ep``, by ``d_ff`` under ``tp``); under ``gspmd`` with
    the fsdp axis too; and the transformer's cache specs are the
    reference's."""
    cfg = T_cfgs.get_config(arch)
    rapi, tapi = r_build(R_cfgs.get_config(arch)), t_build(cfg)
    for part, fsdp in ((Part(0, 16), None), (Part(0, 16, 0, 16), "data")):
        names = {TP: "model", FSDP: fsdp}
        held = {n: tuple(names.get(e) for e in spec)
                for n, spec in held_layout(cfg, part).items()}
        assert held == _flat_specs(rapi.param_specs(fsdp=fsdp)), fsdp
    assert tuple(tapi.cache_specs()) == tuple(tuple(s) for s in rapi.cache_specs())


@pytest.mark.parametrize("arch", ARCHS)
def test_each_leg_splits_attention_and_the_vocabulary(arch, forward_leg, fsdp_leg):
    split = set(forward_leg[0][f"{arch}:split"])
    assert "layers.attn.wq" in split and "embed.tok" in split, split
    assert ("layers.attn.wk" in split) == (arch != "qwen2-0.5b")
    for r, out in enumerate(fsdp_leg):  # (data, model) = (2, 2): rank = 2 * data + model
        assert list(out[f"{arch}:part"]) == [r % 2, 2, r // 2, 2]
        assert "layers.ln1.scale" not in set(out[f"{arch}:split"])


def test_the_ranks_blocks_tile_each_leaf():
    """The four (tp, fsdp) ranks' blocks of gemma-7b's smoke leaves cover
    each leaf evenly: once for a leaf split both ways, four times for a
    replicated one."""
    cfg = _cfgs("gemma-7b")[1]
    whole = TransformerLM(cfg, "meta")
    for name, full in whole.full_shapes.items():
        cover = np.zeros(full, dtype=np.int32)
        for t in range(2):
            for f in range(2):
                m = TransformerLM(cfg, "meta", t, 2, f, 2)
                cover[m.part.index(full, m.held.get(name, ()))] += 1
        spec = TransformerLM(cfg, "meta", 0, 2, 0, 2).held[name]
        assert (cover == 4 // (2 ** sum(e is not None for e in spec))).all(), name


# ---------------------------------------------------------------------------
# the legs against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_matches_the_reference(arch, forward_leg, reference):
    want, decode = reference[arch]["logits"], reference[arch]["decode"]
    tcfg = _cfgs(arch)[1]
    kv_heads = tcfg.num_kv_heads // (R if arch != "qwen2-0.5b" else 1)
    for out in forward_leg:
        np.testing.assert_allclose(out[f"{arch}:logits"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out[f"{arch}:last"][:, 0], want[:, -1], atol=TOL, rtol=TOL)
        assert int(out[f"{arch}:cache_heads"]) == kv_heads
        r = int(out[f"{arch}:part"][0]) if kv_heads < tcfg.num_kv_heads else 0
        heads = slice(r * kv_heads, (r + 1) * kv_heads)
        for k in ("cache_k", "cache_v"):
            want_k = reference[arch]["cache"][k][..., heads, :]
            np.testing.assert_allclose(out[f"{arch}:{k}"], want_k, rtol=2.0 ** -7,
                                       atol=CACHE_TOL, err_msg=k)
        np.testing.assert_allclose(out[f"{arch}:decode"], decode, atol=TOL, rtol=TOL)


def _check_steps(arch, leg, reference):
    ref = reference[arch]
    cfg = _cfgs(arch)[1]
    for out in leg:
        np.testing.assert_allclose(out[f"{arch}:losses"], ref["losses"], rtol=STEP_RTOL)
        np.testing.assert_allclose(out[f"{arch}:grad_norms"], ref["grad_norms"],
                                   rtol=STEP_RTOL)
        t, tn, f, fn = (int(v) for v in out[f"{arch}:part"])
        m = TransformerLM(cfg, "meta", t, tn, f, fn)
        for name, full in ref["final"].items():
            got = out[f"{arch}:param:{name}"]
            want = full[m.part.index(full.shape, m.held.get(name, ()))]
            assert got.shape == want.shape, name
            atol = (2 * T_Adam().lr * STEPS if name in NOISE_LEAVES
                    else LEAF_TOL * float(np.abs(full).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_abi_step_at_one_by_two_matches_the_reference(arch, abi_leg, reference):
    _check_steps(arch, abi_leg, reference)


@pytest.mark.parametrize("arch", ARCHS)
def test_gspmd_step_with_fsdp_at_two_by_two_matches_the_reference(arch, fsdp_leg, reference):
    _check_steps(arch, fsdp_leg, reference)


def test_adamw_updates_a_large_leaf_slice_by_slice_bitwise(monkeypatch):
    """``adamw.update_tree`` takes a leaf above ``SLICE_ELEMENTS`` in runs
    of its leading axis (a rank's stacked FFN leaf of gemma-7b is 0.5 G
    elements): the same numbers, bitwise, as the whole-leaf update, for a
    stacked and a 2-D leaf and runs that do not divide the axis."""
    from repro_torch.optim import adamw

    gen = torch.Generator().manual_seed(0)
    shapes = {"w": (3, 5, 7), "tok": (11, 6)}
    p = {k: torch.randn(s, generator=gen).to(torch.bfloat16) for k, s in shapes.items()}
    g = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    state = adamw.AdamState(torch.zeros((), dtype=torch.int32),
                            {k: torch.randn(s, generator=gen).abs() for k, s in shapes.items()},
                            {k: torch.randn(s, generator=gen).abs() for k, s in shapes.items()})
    gnorm = torch.tensor(0.5)
    keys = sorted(shapes)

    def run():
        return adamw.update_tree(T_Adam(), [g[k] for k in keys], state, [p[k] for k in keys],
                                 gnorm)

    whole = run()
    monkeypatch.setattr(adamw, "SLICE_ELEMENTS", 20)   # runs of 1 of 3 and 3 of 11 rows
    sliced = run()
    for a, b in zip(whole[0], sliced[0]):
        assert torch.equal(a, b)
    for k in keys:
        assert torch.equal(whole[1].m[k], sliced[1].m[k])
        assert torch.equal(whole[1].v[k], sliced[1].v[k])
