"""Port parity for the MoE family's quantize and serve path on the SKILL
smoke config (``qwen3-moe-30b-a3b``: 2 layers, 8 experts, top-2, f32):

* ``quantize_model`` at 2.25bpv_2d on the reference's own weights and
  tokens: per-target errors within 10% (an expert stack's summed over its
  experts), the same bpv, numel and rule of every target, and the same
  achieved bpv;
* the pack round trip of an expert stack (the port's counterpart of
  ``tests/core/test_adapters.py::test_moe_pack_roundtrip_expert_stack``);
* a budgeted quantize whose allocation equals the reference's exactly;
* a packed checkpoint, bit for bit both ways: the port's restores in the
  reference, the reference's (layers stacked) in the port;
* serving inside the port: fused against gather VQ matmuls, interleaved
  against solo, greedy tokens identical;
* both launchers with ``--arch qwen3-moe-30b-a3b --smoke``.

The reference's fixtures are built once for the module, as numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten_with_names
from repro.configs import SMOKE as JSMOKE
from repro.core import adapters as jadapters
from repro.core import pipeline as jpipeline
from repro.core import vq_linear as jvql
from repro.core.bpv import PAPER_SETTINGS as JSETTINGS
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import model_zoo as jzoo

from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten, _name
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.core import vq_linear as vql
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe
from repro_torch.launch import quantize as launch_quantize
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model_zoo
from repro_torch.obs import dispatch
from repro_torch.serve.engine import Engine, Request

ARCH = "qwen3-moe-30b-a3b"
QUANT_KW = dict(em_iters=4, codebook_update_iters=2)
BUDGET_BPV = 2.5
VQ_ARRAYS = ("words", "codebooks", "cb_scale", "scale_sint", "scale_a",
             "scale_z")
VQ_STATIC = ("r", "c", "d", "k", "group_cols", "rows_per_band",
             "scale_block", "rule")


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


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's weights, tokens, packed quantize report and
    checkpoint (layers stacked), and its budget allocation."""
    cfg = JSMOKE[ARCH].scaled(dtype="float32")
    model = jzoo.build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    calib = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(8, 32)).astype(np.int32)
    qparams, rep = jpipeline.quantize_model(
        model, params, jnp.asarray(calib), recipe=_recipe("ref"), pack=True)
    ck_dir = tmp_path_factory.mktemp("ref_moe_ckpt")
    JCheckpointer(str(ck_dir)).save(0, qparams, {"tag": "ref"})
    # the budget allocation: the pre-pass and the allocator of
    # quantize_model(budget_bpv=...), without the quantize that follows
    adapter = jadapters.get_adapter(model, params)
    blocks = adapter.blocks()
    plan = _recipe("ref").resolve(jpipeline._collect_targets(blocks))
    diag, missed = jpipeline._budget_prepass(
        adapter, [jnp.asarray(calib)], plan, None)
    plan, _ = jpipeline._allocate(blocks, plan, diag, missed, BUDGET_BPV,
                                  None)
    return dict(
        params=jax.tree.map(np.asarray, params), calib=calib,
        per_target={k: dict(v) for k, v in rep.per_target.items()},
        achieved_bpv=rep.achieved_bpv, ckpt=str(ck_dir),
        packed={f: np.asarray(getattr(qparams["layers"]["ffn"]["w_in"], f))
                for f in VQ_ARRAYS},
        allocation={name: res.rule for name, res in plan.items()})


@pytest.fixture(scope="module")
def port(ref):
    """The port's model and its packed and fake-quant quantizations of the
    reference's weights on the reference's tokens."""
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = params_from_jax(ref["params"], cfg, device="cpu")
    calib = torch.from_numpy(ref["calib"]).long()
    qparams, rep = quantize_model(model, params, calib,
                                  recipe=_recipe("port"), pack=True, seed=7)
    fake, _ = quantize_model(model, params, calib, recipe=_recipe("port"),
                             seed=7)
    return dict(cfg=cfg, model=model, params=params, calib=calib,
                qparams=qparams, rep=rep, fake=fake)


def test_quantize_matches_reference_report(ref, port):
    rep = port["rep"]
    assert rep.achieved_bpv == ref["achieved_bpv"]  # exact: same accounting
    assert set(rep.per_target) == set(ref["per_target"])
    for name, e in rep.per_target.items():
        r = ref["per_target"][name]
        assert (e["bpv"], e["numel"], e["rule"]) == (r["bpv"], r["numel"],
                                                    r["rule"])
        # same algorithm in f32: a flipped near-tie in one layer changes the
        # next layer's Hessians, so per-target errors agree within 10%
        assert abs(e["error"] - r["error"]) <= 0.10 * r["error"], (
            name, e["error"], r["error"])


def test_pack_roundtrip_expert_stack(port):
    """Packed expert stacks (a leading E on every VQLinear array)
    dequantize to the fake-quant weights of the same seeded run."""
    cfg = port["cfg"]
    for lp, fp in zip(port["qparams"]["layers"], port["fake"]["layers"]):
        for w in ("w_in", "w_gate", "w_out"):
            leaf = lp["ffn"][w]
            assert isinstance(leaf, vql.VQLinear)
            assert leaf.words.shape[0] == cfg.n_experts
            assert leaf.codebooks.shape[0] == cfg.n_experts
            dense = vql.dequant_tree({"w": leaf}, torch.float32)["w"]
            assert dense.shape == fp["ffn"][w].shape
            np.testing.assert_allclose(dense.numpy(), fp["ffn"][w].numpy(),
                                       rtol=2e-2, atol=2e-2)


def test_budgeted_allocation_matches_reference(ref, port):
    _, rep = quantize_model(port["model"], port["params"], port["calib"],
                            recipe=_recipe("port"), budget_bpv=BUDGET_BPV,
                            pack=True)
    assert {k: e["rule"] for k, e in rep.per_target.items()} == (
        ref["allocation"])
    assert rep.achieved_bpv <= BUDGET_BPV + 1e-9
    # the allocator mixes settings on these weights, experts included
    assert len({e["rule"] for e in rep.per_target.values()}) >= 2


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


def test_checkpoint_roundtrip_both_ways(ref, port, tmp_path):
    qparams = port["qparams"]
    ck = Checkpointer(str(tmp_path))
    ck.save(1, qparams, {"tag": "port"})
    restored, meta = ck.restore(qparams)
    assert meta == {"tag": "port"}
    pairs = list(zip(_flatten(qparams), _flatten(restored)))
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for (_, a), (_, b) in pairs)
    # the port's checkpoint restores in the reference bit for bit
    j_restored, _ = JCheckpointer(str(tmp_path)).restore(_jax_like(qparams))
    j_named = dict(_flatten_with_names(j_restored)[0])
    for path, leaf in _flatten(qparams):
        assert _same_bits(leaf.numpy(), np.asarray(j_named[_name(path)]))
    assert np.asarray(
        j_named["__layers___0___ffn____w_in__.words"]).ndim == 3  # (E, r, w)
    # the reference's checkpoint (layers stacked on a leading axis, expert
    # stacks inside) restores in the port bit for bit
    mine, meta = Checkpointer(ref["ckpt"]).restore(qparams)
    assert meta == {"tag": "ref"}
    for i, lp in enumerate(mine["layers"]):
        leaf = lp["ffn"]["w_in"]
        for f in VQ_ARRAYS:
            assert _same_bits(getattr(leaf, f).numpy(), ref["packed"][f][i])
    model, cfg = port["model"], port["cfg"]
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(model.forward(mine, {"tokens": tokens})[0]).all()


def _serve(model, params, prompts, rid0=0, **kw):
    eng = Engine(model, params, max_batch=2, max_len=64, page_size=8,
                 device="cpu", **kw)
    reqs = [Request(rid=rid0 + i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(len(r.out_tokens) == 6 for r in reqs)
    return [r.out_tokens for r in reqs]


def _prompts(seed, sizes, V):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=s) for s in sizes]


def test_fused_matches_gather(port):
    """Greedy decode over the packed MoE checkpoint: the fused form
    (every expert stack one grouped matmul) gives the gather form's
    tokens (TestFusedVQServing::test_fused_matches_gather[moe-xla])."""
    model, qparams = port["model"], port["qparams"]
    prompts = _prompts(8, (5, 9, 3), port["cfg"].vocab_size - 1)
    ref_toks = _serve(model, qparams, prompts, vq_matmul_impl="gather")
    before = dispatch.snapshot_dispatch_counters()
    toks = _serve(model, qparams, prompts, rid0=300, vq_matmul_impl="fused",
                  paged_attn_impl="fused")
    after = dispatch.snapshot_dispatch_counters()
    assert after["vq"]["fused"] > before["vq"]["fused"]
    assert (after["matmul"]["expert_fused_vq"]
            > before["matmul"]["expert_fused_vq"])
    assert after["matmul"]["expert_dense"] == before["matmul"]["expert_dense"]
    assert toks == ref_toks


def test_interleaved_matches_solo(port):
    model, qparams = port["model"], port["qparams"]
    prompts = _prompts(9, (5, 9, 3, 12), port["cfg"].vocab_size - 1)
    kw = dict(vq_matmul_impl="fused", paged_attn_impl="fused")
    toks = _serve(model, qparams, prompts, **kw)
    for i, p in enumerate(prompts):
        assert _serve(model, qparams, [p], rid0=400 + i, **kw)[0] == toks[i]


def test_launchers_take_the_moe_arch(tmp_path, capsys):
    rep, ppl_fp, ppl_vq = launch_quantize.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--sequences", "4",
        "--seq-len", "32", "--em-iters", "2", "--update-iters", "1",
        "--out", str(tmp_path)])
    assert rep.achieved_bpv == 2.25 and np.isfinite(ppl_vq)
    assert len(rep.per_target) == 14
    eng, reqs = launch_serve.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--vq",
        "--vq-matmul-impl", "fused", "--paged-attn-impl", "fused",
        "--requests", "2", "--max-new", "3"])
    assert all(len(r.out_tokens) == 3 for r in reqs)
    assert f"arch={ARCH}" in capsys.readouterr().out
