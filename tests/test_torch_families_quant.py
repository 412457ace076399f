"""Port parity for the vlm and ssm families' quantize path, the port's
counterpart of
``tests/core/test_adapters.py::test_registry_quantizes_and_packs_every_family``
for ``vlm`` (``phi-3-vision-4.2b`` smoke: calibrated on text tokens) and
``ssm`` (``xlstm-125m`` smoke: mLSTM and sLSTM blocks), at 2.25bpv_2d on
the reference's own weights and tokens:

* the same targets, groups, rules, sizes and bpv, and the same keep-dense
  targets with the same reasons (mLSTM ``w_i``/``w_f``, sLSTM ``r_*``);
* per-target errors within 10% (ROADMAP's rule for sweeps). On ssm the
  rule holds target by target in the first mLSTM and the first sLSTM
  block, and for every block's summed error. Past them a near-tie flip
  (layer 0's ``wv`` differs on 0.3% of its entries) changes every later
  Hessian, so every later codebook; two sound quantizations of a small
  (128 x 128) ``down`` then read up to 16% apart (measured), while a
  block's sum stays within 4%;
* the achieved bpv exactly;
* a finite packed perplexity through the fused form;
* the packed checkpoint, bit for bit both ways: the port's restores in the
  reference, the reference's in the port, keep-dense leaves included.

The reference's fixtures are built once for the module, as numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten_with_names
from repro.configs import FAMILY_REPRESENTATIVE, SMOKE as JSMOKE
from repro.core import pipeline as jpipeline
from repro.core import vq_linear as jvql
from repro.core.bpv import PAPER_SETTINGS as JSETTINGS
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import model_zoo as jzoo

from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten, _name
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.core import adapters
from repro_torch.core import vq_linear as vql
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe
from repro_torch.models import model_zoo
from repro_torch.train.loss import perplexity

QUANT_KW = dict(em_iters=4, codebook_update_iters=2)
VQ_ARRAYS = ("words", "codebooks", "cb_scale", "scale_sint", "scale_a",
             "scale_z")
VQ_STATIC = ("r", "c", "d", "k", "group_cols", "rows_per_band",
             "scale_block", "rule")
# ssm: the blocks held target by target (the first mLSTM, the first sLSTM)
SSM_EXACT_BLOCKS = (0, 1)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _recipe(pkg):
    if pkg == "ref":
        return JRecipe.uniform(JSETTINGS["2.25bpv_2d"], name="2.25bpv_2d"
                               ).with_quantize_overrides(**QUANT_KW)
    return QuantRecipe.uniform(PAPER_SETTINGS["2.25bpv_2d"],
                               name="2.25bpv_2d"
                               ).with_quantize_overrides(**QUANT_KW)


@pytest.fixture(scope="module", params=["vlm", "ssm"])
def fam(request, tmp_path_factory):
    """One family: the reference's weights, tokens, packed quantize report
    and checkpoint, and the port's packed quantize of the same weights on
    the same tokens."""
    family = request.param
    arch = FAMILY_REPRESENTATIVE[family]
    jcfg = JSMOKE[arch].scaled(dtype="float32")
    jmodel = jzoo.build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    calib = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(8, 32)).astype(np.int32)
    jq, jrep = jpipeline.quantize_model(
        jmodel, jparams, jnp.asarray(calib), recipe=_recipe("ref"),
        pack=True)
    ck_dir = tmp_path_factory.mktemp(f"ref_{family}_ckpt")
    JCheckpointer(str(ck_dir)).save(0, jq, {"tag": "ref"})
    j_named = dict(_flatten_with_names(jq)[0])

    cfg = SMOKE[arch].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    qparams, rep = quantize_model(model, params,
                                  torch.from_numpy(calib).long(),
                                  recipe=_recipe("port"), pack=True, seed=7)
    return dict(
        family=family, cfg=cfg, model=model, params=params, qparams=qparams,
        rep=rep, ref_per_target={k: dict(v)
                                 for k, v in jrep.per_target.items()},
        ref_bpv=(jrep.achieved_bpv, jrep.bits_per_value), ckpt=str(ck_dir),
        ref_leaves={k: np.asarray(v) for k, v in j_named.items()})


def test_targets_and_keep_dense_reasons_match_reference(fam):
    rep, ref = fam["rep"], fam["ref_per_target"]
    assert list(rep.per_target) == list(ref)
    for name, e in rep.per_target.items():
        r = ref[name]
        for key in ("action", "rule", "numel", "bpv", "group"):
            assert e[key] == r[key], (name, key)
        assert e.get("reason") == r.get("reason"), name
    dense = {k for k, e in rep.per_target.items()
             if e["action"] == "keep_dense"}
    if fam["family"] == "ssm":
        cfg = fam["cfg"]
        want = set()
        for i in range(cfg.n_layers):
            ws = (("r_z", "r_i", "r_f", "r_o") if i in cfg.slstm_layers
                  else ("w_i", "w_f"))
            want |= {f"layers.{i}.core.{w}" for w in ws}
        assert dense == want
    else:
        assert not dense


def test_per_target_errors_within_ten_percent(fam):
    """Quantized targets' errors within 10% of the reference's; ssm: see
    the module docstring."""
    rep, ref = fam["rep"], fam["ref_per_target"]
    errs = {k: e["error"] for k, e in rep.per_target.items()
            if e["action"] == "quantize"}
    assert errs and all(np.isfinite(v) for v in errs.values())
    exact = (range(fam["cfg"].n_layers) if fam["family"] == "vlm"
             else SSM_EXACT_BLOCKS)
    block_sums: dict = {}
    for name, err in errs.items():
        want = ref[name]["error"]
        block = int(name.split(".")[1])
        got_sum, want_sum = block_sums.get(block, (0.0, 0.0))
        block_sums[block] = (got_sum + err, want_sum + want)
        if block in exact:
            assert abs(err - want) <= 0.10 * want, (name, err, want)
    for block, (got, want) in block_sums.items():
        assert abs(got - want) <= 0.10 * want, (block, got, want)


def test_effective_bpv_exact(fam):
    rep = fam["rep"]
    assert (rep.achieved_bpv, rep.bits_per_value) == fam["ref_bpv"]
    # keep-dense targets count at 16 bits, so ssm lands above 2.25
    assert (rep.achieved_bpv == 2.25) == (fam["family"] == "vlm")


def test_packed_tree_and_perplexity(fam):
    model, cfg = fam["model"], fam["cfg"]
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]

    n_vq = sum(isinstance(leaf, vql.VQLinear)
               for lp in fam["qparams"]["layers"] for leaf in leaves(lp))
    assert n_vq == sum(e["action"] == "quantize"
                       for e in fam["rep"].per_target.values())
    heldout = torch.randint(0, cfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(4))
    ppl = perplexity(model, vql.prepare_fused_tree(fam["qparams"]), heldout,
                     batch_extra=adapters.calib_extras(cfg, heldout))
    assert np.isfinite(ppl)


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
            and a.tobytes() == b.tobytes())


def _jax_like(tree):
    """A reference ``like`` tree with the structure and static fields of a
    port params tree (layers a list)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        if isinstance(x, vql.VQLinear):
            arrs = {f: jnp.zeros(tuple(getattr(x, f).shape),
                                 np.dtype(str(getattr(x, f).dtype)[6:]))
                    for f in VQ_ARRAYS}
            arrs["words"] = arrs["words"].astype(jnp.uint32)
            return jvql.VQLinear(**arrs, **{f: getattr(x, f)
                                            for f in VQ_STATIC})
        return jnp.zeros(tuple(x.shape), np.dtype(str(x.dtype)[6:]))

    return conv(tree)


def test_checkpoint_roundtrip_both_ways(fam, tmp_path):
    qparams = fam["qparams"]
    ck = Checkpointer(str(tmp_path))
    ck.save(1, qparams, {"tag": "port"})
    restored, meta = ck.restore(qparams)
    assert meta == {"tag": "port"}
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for (_, a), (_, b) in zip(_flatten(qparams),
                                         _flatten(restored)))
    # the port's checkpoint restores in the reference bit for bit
    j_restored, _ = JCheckpointer(str(tmp_path)).restore(_jax_like(qparams))
    j_named = dict(_flatten_with_names(j_restored)[0])
    flat = _flatten(qparams)
    assert set(j_named) == {_name(path) for path, _ in flat}
    for path, leaf in flat:
        assert _same_bits(leaf.numpy(), np.asarray(j_named[_name(path)]))
    # the reference's checkpoint restores in the port bit for bit, in the
    # reference's layout (the xLSTM's layer list, vlm's stacked layers)
    mine, meta = Checkpointer(fam["ckpt"]).restore(qparams)
    assert meta == {"tag": "ref"}
    ref_leaves = fam["ref_leaves"]
    n_dense = 0
    for path, leaf in _flatten(mine):
        name = _name(path)
        if name in ref_leaves:  # the xLSTM's list: names agree
            want = ref_leaves[name]
        else:  # vlm: the reference stacks layers on a leading axis
            i = int(path[1][0][1:-1])
            stacked = _name(path[:1] + path[2:])
            want = ref_leaves[stacked][i]
        assert _same_bits(leaf.numpy(), want), name
        n_dense += name.endswith(("r_z__", "w_i__")) and leaf.dim() >= 2
    if fam["family"] == "ssm":
        assert n_dense > 0  # keep-dense leaves came through too
    model, cfg = fam["model"], fam["cfg"]
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(model.forward(mine, {"tokens": tokens})[0]).all()


@pytest.mark.parametrize("family", ["vlm", "ssm", "hybrid", "audio"])
def test_registry_takes_vlm_and_ssm_and_refuses_the_pending(family):
    """model_zoo.build and adapters.get_adapter take vlm (the transformer
    adapter), ssm (the xLSTM one), hybrid (the Zamba2 one: the shared
    block, then n_groups x per Mamba layers) and audio (the whisper one:
    the encoder blocks, the enc->dec transition, the decoder blocks;
    calib_extras gives its frames). No family is pending any more."""
    from repro_torch.models import transformer

    assert transformer.PENDING == ()
    cfg = SMOKE[FAMILY_REPRESENTATIVE[family]].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    adapter = adapters.get_adapter(model, model.init_params(seed=0,
                                                            device="cpu"))
    want = {"vlm": "TransformerAdapter", "ssm": "XLSTMAdapter",
            "hybrid": "HybridAdapter", "audio": "EncDecAdapter"}[family]
    assert type(adapter).__name__ == want
    # the hybrid's n_layers counts its Mamba layers; the shared block is
    # one block more; audio adds its encoder layers and the transition
    extra = {"hybrid": 1, "audio": cfg.n_encoder_layers + 1}.get(family, 0)
    assert len(adapter.blocks()) == cfg.n_layers + extra
    assert model_zoo.count_params(model) > 0
    extras = adapters.calib_extras(cfg, torch.zeros((1, 4),
                                                    dtype=torch.long))
    if family == "audio":
        assert extras["frames"].shape == (1, cfg.encoder_seq, cfg.d_model)
    else:
        assert extras == {}
