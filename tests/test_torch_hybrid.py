"""Port parity for ``models/hybrid.py`` (Zamba2: a Mamba2 trunk and one
shared attention block with per-group LoRA deltas) on the ``zamba2-7b``
smoke config (f32: 4 Mamba layers in 2 groups of 2, d_model 64, 4 heads of
32, state 16):

* forward logits against the reference's on carried weights, at 1e-4;
* a dense-cache prefill then one decode step against the full forward
  (``tests/models/test_smoke.py::test_decode_matches_prefill[zamba2-7b]``'s
  bar) and against the reference's decode at 1e-4;
* ``count_params`` of the full config equal to the reference's;
* ``fused_dequantize`` bit for bit equal to ``dequantize``
  (``tests/kernels/test_kernels.py``'s ``test_prepare_matches_dequantize``);
* a heterogeneous trunk (a mixed recipe: one layer's in_proj kept dense)
  against the reference's ``_loop_groups`` on the same packed leaves.

The LoRA B factors start at zeros in both packages, where a wrong group
slice adds nothing; these tests write the same non-zero B (numpy seed 0,
std 0.02) into the reference's tree before carrying it over. The
reference's outputs are computed once for the module, as numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, SMOKE as JSMOKE
from repro.core import vq_linear as jvql
from repro.models import model_zoo as jzoo

from repro_torch.configs import ARCHS, SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.core import vq_linear as vql
from repro_torch.core.adapters.base import blocks_stackable
from repro_torch.core.bpv import PAPER_SETTINGS, VQConfig
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import KeepDense, QuantRecipe, Quantize, Rule
from repro_torch.models import model_zoo

ARCH = "zamba2-7b"
B, S = 2, 16
VQ_ARRAYS = ("words", "codebooks", "cb_scale", "scale_sint", "scale_a",
             "scale_z")
VQ_STATIC = ("r", "c", "d", "k", "group_cols", "rows_per_band",
             "scale_block", "rule")
DENSE_IN_PROJ = "mamba.0.0.mixer.in_proj"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def seeded_lora_b(jparams):
    """The reference's tree with every LoRA B drawn from N(0, 0.02^2)
    (numpy seed 0) instead of zeros."""
    rng = np.random.default_rng(0)
    lora = {}
    for name in ("q", "k", "v"):
        shape = jparams["lora"][name]["B"].shape
        lora[name] = dict(jparams["lora"][name], B=jnp.asarray(
            rng.standard_normal(shape).astype(np.float32) * 0.02))
    return dict(jparams, lora=lora)


def to_jax(tree):
    """A port tree (list trunk, VQLinear leaves) as the reference's
    heterogeneous tree: lists kept, VQLinear leaves the reference's."""
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


def _cfg():
    return SMOKE[ARCH].scaled(dtype="float32")


@pytest.fixture(scope="module")
def ref():
    """The reference's weights (seeded LoRA B), tokens, logits, decode
    logits; and its _loop_groups logits on the port's mixed-recipe
    quantize of the same weights."""
    jcfg = JSMOKE[ARCH].scaled(dtype="float32")
    jmodel = jzoo.build(jcfg)
    jparams = seeded_lora_b(jmodel.init_params(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    logits = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)},
                            remat=False)[0]
    cache = jmodel.init_cache(B, S + 4, dtype=jnp.float32)
    _, cache, _ = jmodel.forward(
        jparams, {"tokens": jnp.asarray(tokens[:, :S - 1])}, cache=cache,
        pos=0, remat=False)
    dec = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens[:, S - 1:])},
                         cache=cache, pos=S - 1, remat=False)[0]
    np_params = jax.tree.map(np.asarray, jparams)

    # the heterogeneous trunk: the port's packed mixed-recipe quantize,
    # carried into the reference's list-of-lists form
    cfg = _cfg()
    model = model_zoo.build(cfg)
    params = params_from_jax(np_params, cfg, device="cpu")
    recipe = QuantRecipe(
        rules=(Rule(DENSE_IN_PROJ, KeepDense("heterogeneous trunk")),),
        default=Quantize(dataclasses.replace(
            PAPER_SETTINGS["2.25bpv_2d"], em_iters=4,
            codebook_update_iters=2)), name="hetero")
    calib = torch.randint(0, cfg.vocab_size, (4, 32),
                          generator=torch.Generator().manual_seed(9))
    qparams, rep = quantize_model(model, params, calib, recipe=recipe,
                                  pack=True)
    het = jmodel.forward(to_jax(qparams), {"tokens": jnp.asarray(tokens)},
                         remat=False)[0]
    return {"params": np_params, "tokens": tokens,
            "logits": np.asarray(logits), "decode": np.asarray(dec),
            "qparams": qparams, "rep": rep, "hetero": np.asarray(het)}


def _port(ref):
    cfg = _cfg()
    return cfg, model_zoo.build(cfg), params_from_jax(ref["params"], cfg,
                                                      device="cpu")


def test_forward_logits_match_reference(ref):
    cfg, model, params = _port(ref)
    assert float(params["lora"]["q"]["B"].abs().max()) > 0
    logits, cache, aux = model.forward(
        params, {"tokens": torch.from_numpy(ref["tokens"]).long()})
    assert cache is None and float(aux) == 0.0
    assert logits.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=1e-4,
                               atol=1e-4)


def test_lora_groups_are_sliced_per_group(ref):
    """Each group's invocation reads its own LoRA slice: swapping the two
    groups' B factors moves the logits."""
    _, model, params = _port(ref)
    tokens = {"tokens": torch.from_numpy(ref["tokens"]).long()}
    base = model.forward(params, tokens)[0]
    swapped = dict(params, lora={
        n: dict(f, B=f["B"].flip(0)) for n, f in params["lora"].items()})
    assert float((model.forward(swapped, tokens)[0] - base).abs().max()) \
        > 1e-3


def test_decode_matches_prefill(ref):
    """A dense-cache prefill of S - 1 tokens, then one decode step: the full
    forward's last row at the reference test's bar (2e-2), and the
    reference's decode at 1e-4."""
    cfg, model, params = _port(ref)
    tokens = torch.from_numpy(ref["tokens"]).long()
    full = model.forward(params, {"tokens": tokens})[0]
    cache = model.init_cache(B, S + 4, dtype=torch.float32, device="cpu")
    _, cache, _ = model.forward(params, {"tokens": tokens[:, :S - 1]},
                                cache=cache, pos=0)
    dec, cache, _ = model.forward(params, {"tokens": tokens[:, S - 1:]},
                                  cache=cache, pos=S - 1)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(dec.numpy(), ref["decode"], rtol=1e-4,
                               atol=1e-4)
    assert len(cache.attn) == 2 and len(cache.mamba) == 2
    assert all(len(g) == cfg.shared_attn_every for g in cache.mamba)


def test_count_params_of_the_full_config_equals_the_reference():
    got = model_zoo.count_params(model_zoo.build(ARCHS[ARCH]))
    want = jzoo.count_params(jzoo.build(JARCHS[ARCH]))
    assert got == want
    assert 6e9 <= got <= 9e9  # the reference test's nameplate band


@pytest.mark.parametrize("sb", [0, 8])
def test_fused_dequantize_equals_dequantize(sb):
    """fused_dequantize(prepare_fused(v)) == dequantize(v) bit for bit: the
    prep folds cb_scale and the exp2 scale plane without changing W."""
    g = torch.Generator().manual_seed(sb)
    W = torch.randn((64, 256), generator=g)
    X = torch.randn((512, 256), generator=g)
    cfg = VQConfig(d=2, bits_per_dim=2, group_size=2048, em_iters=8,
                   codebook_update_iters=0, scale_block=sb)
    v = vql.quantize_array(W, X.T @ X, cfg)
    f = vql.prepare_fused(v)
    assert (f.scales is not None) == bool(sb)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(vql.fused_dequantize(f, dtype),
                           vql.dequantize(v, dtype))
    # the densify the hybrid's forward runs on the shared block's leaves
    tree = vql.dequant_tree({"w": f}, torch.float32, densify_fused=True)
    assert torch.equal(tree["w"], vql.dequantize(v, torch.float32).T)
    assert vql.dequant_tree({"w": f}, torch.float32)["w"] is f


def test_heterogeneous_trunk_matches_reference_loop_groups(ref):
    """A mixed recipe (one in_proj kept dense) leaves a trunk that does not
    stack; the port's one loop over it gives the reference's
    ``_loop_groups`` logits on the same packed leaves, in the gather form
    and the fused one."""
    cfg = _cfg()
    model = model_zoo.build(cfg)
    q = ref["qparams"]
    assert ref["rep"].per_target[DENSE_IN_PROJ]["action"] == "keep_dense"
    assert not isinstance(q["mamba"][0][0]["mixer"]["in_proj"], vql.VQLinear)
    assert isinstance(q["mamba"][0][1]["mixer"]["in_proj"], vql.VQLinear)
    assert not blocks_stackable([lp for g in q["mamba"] for lp in g])
    tokens = {"tokens": torch.from_numpy(ref["tokens"]).long()}
    for tree in (q, vql.prepare_fused_tree(q)):
        np.testing.assert_allclose(model.forward(tree, tokens)[0].numpy(),
                                   ref["hetero"], rtol=1e-4, atol=1e-4)
