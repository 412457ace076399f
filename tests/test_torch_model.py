"""Port parity for the dense model and the quantize pipeline on the SKILL
smoke config: teacher-forced logits given the reference's own init_params
(carried over with ``params_from_jax``), also for the other dense archs,
``quantize_model`` per-target errors and achieved bpv on the same tokens,
the gather form of the reference's packed leaves, and, inside the port,
fused against gather logits.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.core import vq_linear as jvql
from repro.core.bpv import PAPER_SETTINGS as JSETTINGS
from repro.core.pipeline import quantize_model as j_quantize_model
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import model_zoo as jzoo

from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax, vqlinear_from_jax
from repro_torch.core import vq_linear as vql
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe
from repro_torch.models import model_zoo

SMOKE_KW = dict(dtype="float32", n_layers=2, d_model=64, vocab_size=256,
                max_seq_len=64)
QUANT_KW = dict(em_iters=4, codebook_update_iters=2)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _unstack_packed(qparams, n_layers):
    """Reference packed params (layers stacked, VQLinear leaves with a
    leading layer axis) -> the port's tree (layers a list)."""
    def conv(x, i):
        if isinstance(x, dict):
            return {k: conv(v, i) for k, v in x.items()}
        if isinstance(x, jvql.VQLinear):
            fields = {f: np.asarray(getattr(x, f))[i] for f in
                      ("words", "codebooks", "cb_scale", "scale_sint",
                       "scale_a", "scale_z")}
            meta = {f: getattr(x, f) for f in
                    ("r", "c", "d", "k", "group_cols", "rows_per_band",
                     "scale_block", "rule")}
            return vqlinear_from_jax(types.SimpleNamespace(**fields, **meta),
                                     device="cpu")
        return torch.from_numpy(np.array(x[i], dtype=np.float32))

    top = {k: torch.from_numpy(np.array(v, dtype=np.float32))
           for k, v in qparams.items() if k != "layers"}
    return dict(top, layers=[conv(qparams["layers"], i)
                             for i in range(n_layers)])


@pytest.fixture(scope="module")
def ref():
    """Reference init, forward logits and packed quantization, as numpy."""
    cfg = JSMOKE["llama2-7b"].scaled(**SMOKE_KW)
    model = jzoo.build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(4, 32)).astype(np.int32)
    calib = rng.integers(0, cfg.vocab_size, size=(8, 32)).astype(np.int32)
    logits = model.forward(params, {"tokens": jnp.asarray(tokens)},
                           remat=False)[0]
    recipe = JRecipe.uniform(JSETTINGS["2.25bpv_2d"], name="2.25bpv_2d")
    qparams, rep = j_quantize_model(
        model, params, jnp.asarray(calib),
        recipe=recipe.with_quantize_overrides(**QUANT_KW), pack=True)
    qlogits = model.forward(qparams, {"tokens": jnp.asarray(tokens)},
                            remat=False)[0]
    return dict(
        params=_np_tree(params), tokens=tokens, calib=calib,
        logits=np.asarray(logits), qlogits=np.asarray(qlogits),
        packed=_unstack_packed(qparams, cfg.n_layers),
        per_target={k: dict(v) for k, v in rep.per_target.items()},
        achieved_bpv=rep.achieved_bpv)


def _port_model():
    cfg = SMOKE["llama2-7b"].scaled(**SMOKE_KW)
    return cfg, model_zoo.build(cfg)


def test_dense_forward_matches_reference(ref):
    cfg, model = _port_model()
    params = params_from_jax(ref["params"], cfg, device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    assert model_zoo.count_params(model) == sum(
        x.size for x in jax.tree.leaves(ref["params"]))
    logits = model.forward(params, {"tokens": torch.from_numpy(
        ref["tokens"]).long()})[0]
    assert logits.dtype == torch.float32
    # f32 forward of 2 layers; matmul and softmax sums in another order
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-72b", "minitron-4b",
                                  "yi-34b"])
def test_other_dense_archs_forward_matches_reference(arch):
    """The rest of the dense family: qk-norm + tied embeddings (qwen3), QKV
    bias + GQA (qwen2), relu^2 (minitron), GQA (yi)."""
    jcfg = JSMOKE[arch].scaled(dtype="float32")
    jmodel = jzoo.build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(1))
    if jcfg.qkv_bias:  # zero-initialized: give the biases values to check
        rng = np.random.default_rng(2)
        jparams["layers"]["attn"] = {
            k: (jnp.asarray(rng.standard_normal(v.shape), v.dtype) * 0.1
                if k.startswith("b") else v)
            for k, v in jparams["layers"]["attn"].items()}
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    want = np.asarray(jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                     remat=False)[0])
    cfg = SMOKE[arch].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    got = model.forward(params_from_jax(_np_tree(jparams), cfg, device="cpu"),
                        {"tokens": torch.from_numpy(tokens).long()})[0]
    # f32 forward of 2 layers; matmul and softmax sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_gather_form_of_reference_packed_params(ref):
    """The reference's packed leaves, densified by the port's dequant_tree
    inside the block loop, give the reference's teacher-forced logits."""
    cfg, model = _port_model()
    before = vql.COUNTS["gather"]
    logits = model.forward(ref["packed"], {"tokens": torch.from_numpy(
        ref["tokens"]).long()})[0]
    assert vql.COUNTS["gather"] - before == 7 * cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), ref["qlogits"], rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def port_quant(ref):
    cfg, model = _port_model()
    params = params_from_jax(ref["params"], cfg, device="cpu")
    recipe = QuantRecipe.uniform(PAPER_SETTINGS["2.25bpv_2d"],
                                 name="2.25bpv_2d")
    qparams, rep = quantize_model(
        model, params, torch.from_numpy(ref["calib"]).long(),
        recipe=recipe.with_quantize_overrides(**QUANT_KW), pack=True)
    return cfg, model, qparams, rep


def test_quantize_model_matches_reference_report(ref, port_quant):
    _, _, _, rep = port_quant
    assert rep.achieved_bpv == ref["achieved_bpv"]  # exact: same accounting
    assert set(rep.per_target) == set(ref["per_target"])
    for name, e in rep.per_target.items():
        r = ref["per_target"][name]
        assert (e["bpv"], e["numel"], e["rule"]) == (r["bpv"], r["numel"],
                                                    r["rule"])
        # same algorithm in f32: a flipped near-tie in one layer changes the
        # next layer's Hessian, so per-target errors agree within 10%
        assert abs(e["error"] - r["error"]) <= 0.10 * r["error"], (
            name, e["error"], r["error"])


def test_fused_matches_gather_inside_port(port_quant):
    cfg, model, qparams, _ = port_quant
    assert all(isinstance(leaf, vql.VQLinear)
               for lp in qparams["layers"]
               for sub in (lp["attn"], lp["ffn"]) for leaf in sub.values())
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    fused = vql.prepare_fused_tree(qparams)
    before = vql.COUNTS["fused"]
    lf = model.forward(fused, {"tokens": tokens})[0]
    assert vql.COUNTS["fused"] - before == 7 * cfg.n_layers
    lg = model.forward(qparams, {"tokens": tokens})[0]
    # f32 everywhere: the two forms differ only in summation order
    torch.testing.assert_close(lf, lg, rtol=1e-4, atol=1e-4)
