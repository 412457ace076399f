"""Port parity for the hybrid family's quantize path
(``core/adapters/hybrid.py``), the port's counterpart of the reference's
``test_registry_quantizes_and_packs_every_family[hybrid]`` and
``tests/core/test_recipe.py::test_mixed_recipe_roundtrip_checkpoint_serve
[hybrid]``, on the ``zamba2-7b`` smoke config (f32, 2 groups of 2 Mamba
layers) at 2.25bpv_2d, on the reference's own weights (its LoRA B seeded
non-zero: numpy seed 0, std 0.02) and tokens:

* the same targets (the shared block's q/k/v/o, every layer's in_proj and
  out_proj), groups, rules, sizes and bpv; the LoRA factors, norms and
  conv and scan leaves left as they were;
* per-target errors within 10% (ROADMAP's rule for sweeps);
* the achieved bpv exactly;
* the packed checkpoint bit for bit both ways: a stackable trunk in the
  reference's stacked (n_groups, per, ...) layout, a heterogeneous one (a
  mixed recipe) as a list of lists;
* a mixed recipe through quantize -> checkpoint -> restore -> serve.

The reference's fixtures are built once for the module, as numpy.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten_with_names
from repro.configs import SMOKE as JSMOKE
from repro.core import pipeline as jpipeline
from repro.core import vq_linear as jvql
from repro.core.bpv import PAPER_SETTINGS as JSETTINGS
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import model_zoo as jzoo

from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten, _name
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax, vqlinear_from_jax
from repro_torch.core import adapters
from repro_torch.core import vq_linear as vql
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import KeepDense, QuantRecipe, Quantize, Rule
from repro_torch.models import model_zoo
from repro_torch.serve.engine import Engine, Request

ARCH = "zamba2-7b"
QUANT_KW = dict(em_iters=4, codebook_update_iters=2)
VQ_ARRAYS = ("words", "codebooks", "cb_scale", "scale_sint", "scale_a",
             "scale_z")
VQ_STATIC = ("r", "c", "d", "k", "group_cols", "rows_per_band",
             "scale_block", "rule")
NAMED_DENSE = "mamba.0.0.mixer.in_proj"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiny(setting: str) -> Quantize:
    return Quantize(dataclasses.replace(PAPER_SETTINGS[setting], **QUANT_KW))


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
            and a.tobytes() == b.tobytes())


def to_jax(tree):
    """A port tree as a reference tree of the same structure: lists kept,
    VQLinear leaves the reference's (uint32 words), values carried."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    if isinstance(tree, vql.VQLinear):
        arrs = {f: jnp.asarray(getattr(tree, f).numpy()) for f in VQ_ARRAYS}
        arrs["words"] = jnp.asarray(tree.words.numpy().view(np.uint32))
        return jvql.VQLinear(**arrs, **{f: getattr(tree, f)
                                        for f in VQ_STATIC})
    return jnp.asarray(tree.numpy())


def dense_leaves(params) -> dict:
    """The leaves the adapter leaves dense: LoRA, norms, conv and scan."""
    out = {f"lora.{n}.{f}": params["lora"][n][f]
           for n in ("q", "k", "v") for f in ("A", "B")}
    out["shared.norm"] = params["shared"]["norm"]
    for g, grp in enumerate(params["mamba"]):
        for j, lp in enumerate(grp):
            out[f"mamba.{g}.{j}.norm"] = lp["norm"]
            for w in ("conv_w", "conv_b", "A_log", "dt_bias", "D_skip",
                      "norm_scale"):
                out[f"mamba.{g}.{j}.mixer.{w}"] = lp["mixer"][w]
    return out


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    """The reference's weights, packed quantize report and checkpoint
    (stacked trunk), and the port's packed quantize of the same weights on
    the same tokens."""
    jcfg = JSMOKE[ARCH].scaled(dtype="float32")
    jmodel = jzoo.build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jparams = dict(jparams, lora={
        n: dict(f, B=jnp.asarray(rng.standard_normal(f["B"].shape).astype(
            np.float32) * 0.02)) for n, f in jparams["lora"].items()})
    calib = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(8, 32)).astype(np.int32)
    jq, jrep = jpipeline.quantize_model(
        jmodel, jparams, jnp.asarray(calib),
        recipe=JRecipe.uniform(JSETTINGS["2.25bpv_2d"], name="2.25bpv_2d"
                               ).with_quantize_overrides(**QUANT_KW),
        pack=True)
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    j_logits = jmodel.forward(jq, {"tokens": jnp.asarray(tokens)},
                              remat=False)[0]
    ck_dir = tmp_path_factory.mktemp("ref_hybrid_ckpt")
    JCheckpointer(str(ck_dir)).save(0, jq, {"tag": "ref"})
    j_named = dict(_flatten_with_names(jq)[0])

    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    recipe = QuantRecipe.uniform(PAPER_SETTINGS["2.25bpv_2d"],
                                 name="2.25bpv_2d"
                                 ).with_quantize_overrides(**QUANT_KW)
    qparams, rep = quantize_model(model, params,
                                  torch.from_numpy(calib).long(),
                                  recipe=recipe, pack=True, seed=7)
    return dict(
        cfg=cfg, model=model, params=params, qparams=qparams, rep=rep,
        ref_per_target={k: dict(v) for k, v in jrep.per_target.items()},
        ref_bpv=(jrep.achieved_bpv, jrep.bits_per_value), ckpt=str(ck_dir),
        ref_like=jax.tree.map(jnp.zeros_like, jq), ref_packed=jq,
        tokens=tokens, ref_logits=np.asarray(j_logits),
        ref_leaves={k: np.asarray(v) for k, v in j_named.items()})


def test_targets_and_dense_leaves_match_reference(fam):
    rep, ref = fam["rep"], fam["ref_per_target"]
    assert list(rep.per_target) == list(ref)
    for name, e in rep.per_target.items():
        r = ref[name]
        for key in ("action", "rule", "numel", "bpv", "group"):
            assert e[key] == r[key], (name, key)
    cfg = fam["cfg"]
    n_groups, per = cfg.n_layers // cfg.shared_attn_every, \
        cfg.shared_attn_every
    assert list(rep.per_target) == (
        [f"shared.attn.{w}" for w in ("wq", "wk", "wv", "wo")]
        + [f"mamba.{g}.{j}.mixer.{w}" for g in range(n_groups)
           for j in range(per) for w in ("in_proj", "out_proj")])
    assert all(e["action"] == "quantize" for e in rep.per_target.values())
    q = fam["qparams"]
    assert all(isinstance(q["shared"]["attn"][w], vql.VQLinear)
               for w in ("wq", "wk", "wv", "wo"))
    assert all(isinstance(lp["mixer"][w], vql.VQLinear)
               for grp in q["mamba"] for lp in grp
               for w in ("in_proj", "out_proj"))
    # LoRA factors, norms, conv and scan leaves stay as they were (the scan
    # parameters in f32)
    before, after = dense_leaves(fam["params"]), dense_leaves(q)
    assert list(before) == list(after)
    for name in before:
        assert torch.equal(before[name], after[name]), name
    assert after["mamba.0.0.mixer.A_log"].dtype == torch.float32


def test_per_target_errors_within_ten_percent(fam):
    rep, ref = fam["rep"], fam["ref_per_target"]
    for name, e in rep.per_target.items():
        want = ref[name]["error"]
        assert np.isfinite(e["error"])
        assert abs(e["error"] - want) <= 0.10 * want, (name, e["error"], want)


def test_effective_bpv_exact(fam):
    rep = fam["rep"]
    assert (rep.achieved_bpv, rep.bits_per_value) == fam["ref_bpv"]


def test_reference_packed_tree_runs_in_port(fam):
    """The reference's packed tree, its trunk stacked (n_groups, per, ...),
    carried leaf by leaf (``vqlinear_from_jax`` with the (g, j) index)
    into the port's list of groups: its logits are the reference's, in the
    gather form and the fused one."""
    jq, cfg = fam["ref_packed"], fam["cfg"]

    def conv(x, index=()):
        if isinstance(x, jvql.VQLinear):
            return vqlinear_from_jax(x, device="cpu", index=index)
        if isinstance(x, dict):
            return {k: conv(v, index) for k, v in x.items()}
        return torch.from_numpy(np.array(np.asarray(x)[index]))

    tree = {k: conv(v) for k, v in jq.items() if k != "mamba"}
    tree["mamba"] = [[conv(jq["mamba"], (g, j))
                      for j in range(cfg.shared_attn_every)]
                     for g in range(cfg.n_layers // cfg.shared_attn_every)]
    tokens = {"tokens": torch.from_numpy(fam["tokens"]).long()}
    for form in (tree, vql.prepare_fused_tree(tree)):
        np.testing.assert_allclose(
            fam["model"].forward(form, tokens)[0].numpy(),
            fam["ref_logits"], rtol=1e-4, atol=1e-4)


def test_adapter_blocks_and_finalize(fam):
    """The shared block first, then the trunk in order; the finalized trunk
    is the port's list of groups of layers, and stacks (a uniform
    recipe)."""
    from repro_torch.core.adapters.base import blocks_stackable

    cfg = fam["cfg"]
    adapter = adapters.get_adapter(fam["model"], fam["params"])
    names = [b.prefix for b in adapter.blocks()]
    assert names == ["shared"] + [f"mamba.{g}.{j}" for g in range(2)
                                  for j in range(cfg.shared_attn_every)]
    q = fam["qparams"]
    assert len(q["mamba"]) == 2 and all(len(g) == 2 for g in q["mamba"])
    assert blocks_stackable([lp for g in q["mamba"] for lp in g])


def test_checkpoint_stacked_trunk_both_ways(fam, tmp_path):
    """A stackable trunk is written as the reference writes it: one stacked
    (n_groups, per, ...) leaf an array. The port's checkpoint restores in
    the reference (into its own stacked tree) and the reference's in the
    port, bit for bit."""
    q = fam["qparams"]
    ck = Checkpointer(str(tmp_path))
    ck.save(1, q, {"tag": "port"})
    step = os.path.join(str(tmp_path), "step_0000000001")
    names = {f[:-4] for f in os.listdir(step) if f.endswith(".npy")}
    assert names == set(fam["ref_leaves"])
    restored, meta = ck.restore(q)
    assert meta == {"tag": "port"}
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for (_, a), (_, b) in zip(_flatten(q), _flatten(restored)))

    def ref_row(path, leaves):
        name = _name(path)
        if name in leaves:
            return leaves[name]
        # trunk leaf [mamba][g][j]...: row (g, j) of the stacked leaf
        g, j = (int(path[i][0][1:-1]) for i in (1, 2))
        return leaves[_name(path[:1] + path[3:])][g, j]

    j_restored, _ = JCheckpointer(str(tmp_path)).restore(fam["ref_like"])
    j_named = {k: np.asarray(v) for k, v in
               _flatten_with_names(j_restored)[0]}
    for path, leaf in _flatten(q):
        assert _same_bits(leaf.numpy(), ref_row(path, j_named)), _name(path)
    mine, meta = Checkpointer(fam["ckpt"]).restore(q)
    assert meta == {"tag": "ref"}
    for path, leaf in _flatten(mine):
        assert _same_bits(leaf.numpy(), ref_row(path, fam["ref_leaves"])), \
            _name(path)
    tokens = torch.randint(0, fam["cfg"].vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(fam["model"].forward(mine, {"tokens": tokens})[0]
                          ).all()


@pytest.fixture(scope="module")
def mixed(fam):
    """A mixed recipe (one in_proj kept dense, the attention group at
    2.25bpv_2d, the mlp group at 4.125bpv_1d): a heterogeneous trunk."""
    rec = QuantRecipe(
        rules=(Rule(NAMED_DENSE, KeepDense("round-trip ablation")),
               Rule("group:attn", _tiny("2.25bpv_2d")),
               Rule("group:mlp", _tiny("4.125bpv_1d"))),
        default=_tiny("2.25bpv_2d"), name="mixed-rt")
    calib = torch.randint(0, fam["cfg"].vocab_size, (8, 4),
                          generator=torch.Generator().manual_seed(9))
    return rec, *quantize_model(fam["model"], fam["params"], calib,
                                recipe=rec, pack=True, chunk=4)


def test_checkpoint_heterogeneous_trunk_both_ways(fam, mixed, tmp_path):
    """A trunk that does not stack stays a list of lists on disk, as the
    reference's heterogeneous trunk: the port's checkpoint restores in the
    reference bit for bit, and a reference checkpoint of the same tree in
    the port."""
    _, q, rep = mixed
    assert rep.per_target[NAMED_DENSE]["action"] == "keep_dense"
    Checkpointer(str(tmp_path / "port")).save(0, q, {"tag": "port"})
    names = {f[:-4] for f in os.listdir(tmp_path / "port" / "step_0000000000")
             if f.endswith(".npy")}
    flat = _flatten(q)
    assert names == {_name(path) for path, _ in flat}
    assert "__mamba___0__0___mixer____in_proj__" in names  # a list of lists
    j_restored, _ = JCheckpointer(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.zeros_like, to_jax(q)))
    j_named = dict(_flatten_with_names(j_restored)[0])
    for path, leaf in flat:
        assert _same_bits(leaf.numpy(), np.asarray(j_named[_name(path)]))
    JCheckpointer(str(tmp_path / "ref")).save(0, to_jax(q), {"tag": "ref"})
    mine, meta = Checkpointer(str(tmp_path / "ref")).restore(q)
    assert meta == {"tag": "ref"}
    for (_, a), (_, b) in zip(flat, _flatten(mine)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_mixed_recipe_roundtrip_checkpoint_serve(fam, mixed, tmp_path):
    """``tests/core/test_recipe.py::test_mixed_recipe_roundtrip_checkpoint_
    serve[hybrid]``: a mixed recipe round-trips quantize -> pack ->
    checkpoint -> engine serving."""
    rec, q, rep = mixed
    assert any(isinstance(lp["mixer"]["out_proj"], vql.VQLinear)
               for g in q["mamba"] for lp in g)
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(0, q, metadata={"recipe": rep.recipe,
                            "per_target": rep.per_target,
                            "achieved_bpv": rep.achieved_bpv})
    restored, meta = ck.restore(q)
    assert meta["recipe"]["name"] == "mixed-rt"
    assert meta["per_target"][NAMED_DENSE]["action"] == "keep_dense"
    for (_, a), (_, b) in zip(_flatten(q), _flatten(restored)):
        assert torch.equal(a, b)
    rng = np.random.RandomState(0)
    eng = Engine(fam["model"], restored, max_batch=2, max_len=64,
                 device="cpu")
    reqs = [Request(rid=i, prompt=rng.randint(0, fam["cfg"].vocab_size,
                                              size=6), max_new_tokens=4)
            for i in range(3)]
    eng.run(reqs)
    assert all(len(r.out_tokens) >= 4 for r in reqs)
