"""Port parity for the audio family's quantize path
(``core/adapters/encdec.py``), the port's counterpart of the reference's
``tests/core/test_adapters.py::test_registry_quantizes_and_packs_every_family
[audio]``, on the ``whisper-small`` smoke config (f32: 2 encoder + 2
decoder layers) at 2.25bpv_2d, on the reference's own weights (q/k/v
biases seeded non-zero: numpy seed 0, std 0.02), tokens and frames:

* the blocks enc0, enc1, the enc->dec transition, dec0, dec1; the targets,
  their tap names and groups in the reference's order (the decoder's
  cross wk/wv on the ``memory`` tap);
* every tap's Hessian equal to the reference's on the same state;
* per-target errors within 10% (ROADMAP's rule for sweeps);
* the achieved bpv exactly;
* the reference's packed tree (stacks on a leading axis) running in the
  port with the reference's logits;
* the packed checkpoint bit for bit both ways, a uniform recipe's (the
  reference writes it stacked, the port as lists) and a mixed recipe's
  (lists on both sides);
* ``calib_extras`` giving the stub frontend's frames, and the generic
  registry run of ``test_adapters.py``.

The port's ``synth_frames`` draws from a ``torch.Generator``, whose stream
is not ``jax.random``'s; wherever the two packages are compared, the port
is fed the reference's frames (the adapter's ``synth_frames`` replaced for
the fixture). The reference's fixtures are built once for the module, as
numpy.
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
from repro.core import adapters as jadapters
from repro.core import hessian as jhes
from repro.core import pipeline as jpipeline
from repro.core import vq_linear as jvql
from repro.core.adapters.encdec import synth_frames as jsynth_frames
from repro.core.bpv import PAPER_SETTINGS as JSETTINGS
from repro.core.recipe import QuantRecipe as JRecipe
from repro.models import model_zoo as jzoo

from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten, _name
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax, vqlinear_from_jax
from repro_torch.core import adapters
from repro_torch.core import hessian as hes
from repro_torch.core import vq_linear as vql
from repro_torch.core.adapters import encdec as penc
from repro_torch.core.bpv import PAPER_SETTINGS, VQConfig
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import KeepDense, QuantRecipe, Quantize, Rule
from repro_torch.data.synthetic import sample_batch
from repro_torch.models import model_zoo
from repro_torch.train.loss import perplexity

from test_torch_encdec import seeded_biases, to_jax

ARCH = "whisper-small"
QUANT_KW = dict(em_iters=4, codebook_update_iters=2)
NAMED_DENSE = "dec.1.cross_attn.wk"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
            and a.tobytes() == b.tobytes())


def _tiny(setting: str) -> Quantize:
    return Quantize(dataclasses.replace(PAPER_SETTINGS[setting], **QUANT_KW))


def _ref_taps(adapter, tokens):
    """{block name: {tap: finalized Hessian}} of every block on one state,
    each block installed unquantized and advanced (either package)."""
    fin = jhes.finalize if isinstance(tokens, jax.Array) else hes.finalize
    state, out = adapter.calib_state(tokens, 0), {}
    for blk in adapter.blocks():
        taps = blk.capture(state, {}, frozenset({"attn", "mlp"}))
        out[blk.name] = {k: np.asarray(fin(v)) for k, v in taps.items()}
        blk.install(blk.params())
        state = blk.advance(state)
    return out


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    """The reference's weights, packed quantize report, logits and
    checkpoint; the port's packed quantize of the same weights on the same
    tokens and frames; both packages' tap Hessians."""
    jcfg = JSMOKE[ARCH].scaled(dtype="float32")
    jmodel = jzoo.build(jcfg)
    jparams = seeded_biases(jmodel.init_params(jax.random.PRNGKey(0)))
    calib = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(8, 32)).astype(np.int32)
    jq, jrep = jpipeline.quantize_model(
        jmodel, jparams, jnp.asarray(calib),
        recipe=JRecipe.uniform(JSETTINGS["2.25bpv_2d"], name="2.25bpv_2d"
                               ).with_quantize_overrides(**QUANT_KW),
        pack=True)
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    frames = np.array(jsynth_frames(jcfg, 2, 5))
    j_logits = jmodel.forward(jq, {"tokens": jnp.asarray(tokens),
                                   "frames": jnp.asarray(frames)},
                              remat=False)[0]
    ck_dir = tmp_path_factory.mktemp("ref_audio_ckpt")
    JCheckpointer(str(ck_dir)).save(0, jq, {"tag": "ref"})
    j_named = dict(_flatten_with_names(jq)[0])
    j_taps = _ref_taps(jadapters.get_adapter(jmodel, jparams),
                       jnp.asarray(calib))
    j_adapter = jadapters.get_adapter(jmodel, jparams)
    j_blocks = [(b.name, b.prefix,
                 [(s.name, s.path, s.tap, s.group) for s in b.targets()])
                for b in j_adapter.blocks()]

    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    own = penc.synth_frames
    penc.synth_frames = lambda c, b, ci=0, device=None: torch.from_numpy(
        np.array(jsynth_frames(jcfg, b, ci)))
    try:
        taps = _ref_taps(adapters.get_adapter(model, params),
                         torch.from_numpy(calib).long())
        recipe = QuantRecipe.uniform(PAPER_SETTINGS["2.25bpv_2d"],
                                     name="2.25bpv_2d"
                                     ).with_quantize_overrides(**QUANT_KW)
        qparams, rep = quantize_model(model, params,
                                      torch.from_numpy(calib).long(),
                                      recipe=recipe, pack=True, seed=7)
    finally:
        penc.synth_frames = own
    return dict(
        cfg=cfg, model=model, params=params, qparams=qparams, rep=rep,
        ref_per_target={k: dict(v) for k, v in jrep.per_target.items()},
        ref_bpv=(jrep.achieved_bpv, jrep.bits_per_value), ckpt=str(ck_dir),
        ref_like=jax.tree.map(jnp.zeros_like, jq), ref_packed=jq,
        tokens=tokens, frames=frames, ref_logits=np.asarray(j_logits),
        ref_leaves={k: np.asarray(v) for k, v in j_named.items()},
        ref_taps=j_taps, taps=taps, ref_blocks=j_blocks)


def test_adapter_blocks_targets_and_taps_in_reference_order(fam):
    cfg = fam["cfg"]
    adapter = adapters.get_adapter(fam["model"], fam["params"])
    assert type(adapter).__name__ == "EncDecAdapter"
    blocks = adapter.blocks()
    assert [b.prefix for b in blocks] == (
        [f"enc.{i}" for i in range(cfg.n_encoder_layers)] + ["enc_dec"]
        + [f"dec.{i}" for i in range(cfg.n_layers)])
    got = [(b.name, b.prefix,
            [(s.name, s.path, s.tap, s.group) for s in b.targets()])
           for b in blocks]
    assert got == fam["ref_blocks"]
    dec = dict((s[0], s[2]) for s in got[-1][2])
    assert dec["cross_attn.wk"] == dec["cross_attn.wv"] == "memory"
    assert dec["cross_attn.wq"] == "cross_q_in"
    assert dec["cross_attn.wo"] == "cross_out_in"


def test_tap_hessians_match_reference(fam):
    """Every block's taps on the same state (the reference's frames),
    including the decoder's ``memory`` tap from the encoder output."""
    ref, got = fam["ref_taps"], fam["taps"]
    assert list(got) == list(ref)
    assert got["enc→dec"] == {}
    for blk, taps in ref.items():
        assert list(got[blk]) == list(taps), blk
        for tap, H in taps.items():
            np.testing.assert_allclose(
                got[blk][tap], H, rtol=1e-4,
                atol=1e-5 * float(np.abs(H).max()), err_msg=f"{blk} {tap}")
    assert list(got["dec0"]) == ["self_in", "self_out_in", "cross_q_in",
                                 "memory", "cross_out_in", "ffn_in",
                                 "ffn_out_in"]


def test_targets_match_reference(fam):
    rep, ref = fam["rep"], fam["ref_per_target"]
    assert list(rep.per_target) == list(ref)
    for name, e in rep.per_target.items():
        for key in ("action", "rule", "numel", "bpv", "group"):
            assert e[key] == ref[name][key], (name, key)
    assert all(e["action"] == "quantize" for e in rep.per_target.values())
    q = fam["qparams"]
    assert all(isinstance(q["dec_layers"][i]["cross_attn"][w], vql.VQLinear)
               for i in range(2) for w in ("wq", "wk", "wv", "wo"))
    # biases, norms and positional embeddings stay as they were
    for i, lp in enumerate(q["dec_layers"]):
        for b in ("bq", "bk", "bv"):
            assert torch.equal(lp["cross_attn"][b],
                               fam["params"]["dec_layers"][i]["cross_attn"][b])
    for k in ("pos_enc", "pos_dec", "enc_norm", "embed"):
        assert torch.equal(q[k], fam["params"][k])


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
    """The reference's packed tree, both stacks on a leading axis, carried
    leaf by leaf (``vqlinear_from_jax`` with the layer index) into the
    port's lists: its logits are the reference's, in the gather form and
    the fused one."""
    jq, cfg = fam["ref_packed"], fam["cfg"]

    def conv(x, index=()):
        if isinstance(x, jvql.VQLinear):
            return vqlinear_from_jax(x, device="cpu", index=index)
        if isinstance(x, dict):
            return {k: conv(v, index) for k, v in x.items()}
        return torch.from_numpy(np.array(np.asarray(x)[index]))

    stacks = {"enc_layers": cfg.n_encoder_layers, "dec_layers": cfg.n_layers}
    tree = {k: conv(v) for k, v in jq.items() if k not in stacks}
    for k, n in stacks.items():
        assert isinstance(jq[k], dict)  # stacked by the reference
        tree[k] = [conv(jq[k], (i,)) for i in range(n)]
    batch = {"tokens": torch.from_numpy(fam["tokens"]).long(),
             "frames": torch.from_numpy(fam["frames"])}
    for form in (tree, vql.prepare_fused_tree(tree)):
        np.testing.assert_allclose(
            fam["model"].forward(form, batch)[0].numpy(),
            fam["ref_logits"], rtol=1e-4, atol=1e-4)


def _ref_row(path, leaves):
    """A port leaf's counterpart in the reference's stacked checkpoint:
    [enc_layers][i]... is row i of the stacked leaf."""
    name = _name(path)
    if name in leaves:
        return leaves[name]
    return leaves[_name(path[:1] + path[2:])][int(path[1][0][1:-1])]


def test_checkpoint_uniform_recipe_both_ways(fam, tmp_path):
    """The port writes its lists (one file a layer's leaf); the reference
    restores them into a list-form tree bit for bit. The reference writes
    its stacks on a leading axis; the port restores row i into layer i,
    bit for bit."""
    q = fam["qparams"]
    ck = Checkpointer(str(tmp_path))
    ck.save(1, q, {"tag": "port"})
    flat = _flatten(q)
    names = {f[:-4] for f in os.listdir(tmp_path / "step_0000000001")
             if f.endswith(".npy")}
    assert names == {_name(path) for path, _ in flat}
    assert "__dec_layers___1___cross_attn____wk__.words" in names
    restored, meta = ck.restore(q)
    assert meta == {"tag": "port"}
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for (_, a), (_, b) in zip(flat, _flatten(restored)))
    j_restored, _ = JCheckpointer(str(tmp_path)).restore(
        jax.tree.map(jnp.zeros_like, to_jax(q)))
    j_named = dict(_flatten_with_names(j_restored)[0])
    for path, leaf in flat:
        assert _same_bits(leaf.numpy(), np.asarray(j_named[_name(path)]))
    mine, meta = Checkpointer(fam["ckpt"]).restore(q)
    assert meta == {"tag": "ref"}
    for path, leaf in _flatten(mine):
        assert _same_bits(leaf.numpy(), _ref_row(path, fam["ref_leaves"])), \
            _name(path)
    batch = {"tokens": torch.from_numpy(fam["tokens"]).long(),
             "frames": torch.from_numpy(fam["frames"])}
    np.testing.assert_allclose(fam["model"].forward(mine, batch)[0].numpy(),
                               fam["ref_logits"], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def mixed(fam):
    """A mixed recipe (one cross wk kept dense, the attention group at
    2.25bpv_2d, the mlp group at 4.125bpv_1d): a heterogeneous decoder."""
    rec = QuantRecipe(
        rules=(Rule(NAMED_DENSE, KeepDense("round-trip ablation")),
               Rule("group:attn", _tiny("2.25bpv_2d")),
               Rule("group:mlp", _tiny("4.125bpv_1d"))),
        default=_tiny("2.25bpv_2d"), name="mixed-rt")
    calib = torch.randint(0, fam["cfg"].vocab_size, (8, 4),
                          generator=torch.Generator().manual_seed(9))
    return rec, *quantize_model(fam["model"], fam["params"], calib,
                                recipe=rec, pack=True, chunk=4)


def test_checkpoint_mixed_recipe_both_ways(fam, mixed, tmp_path):
    """A decoder stack that does not stack stays a list on disk on both
    sides: the port's checkpoint restores in the reference bit for bit, and
    a reference checkpoint of the same tree in the port; the restored tree
    serves through the engine."""
    from repro_torch.serve.engine import Engine, Request

    _, q, rep = mixed
    assert rep.per_target[NAMED_DENSE]["action"] == "keep_dense"
    assert not isinstance(q["dec_layers"][1]["cross_attn"]["wk"],
                          vql.VQLinear)
    Checkpointer(str(tmp_path / "port")).save(0, q, {"tag": "port"})
    flat = _flatten(q)
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
    rng = np.random.RandomState(0)
    eng = Engine(fam["model"], mine, max_batch=2, max_len=64, device="cpu")
    reqs = [Request(rid=i, prompt=rng.randint(0, fam["cfg"].vocab_size,
                                              size=6), max_new_tokens=4)
            for i in range(3)]
    eng.run(reqs)
    assert all(len(r.out_tokens) == 4 for r in reqs)


def test_calib_extras_gives_the_stub_frames(fam):
    cfg = fam["cfg"]
    tokens = torch.zeros((3, 8), dtype=torch.long)
    ex = adapters.calib_extras(cfg, tokens)
    assert list(ex) == ["frames"]
    f = ex["frames"]
    assert f.shape == (3, cfg.encoder_seq, cfg.d_model)
    assert f.dtype == torch.float32 and f.device == tokens.device
    assert 0.05 < float(f.std()) < 0.2
    assert torch.equal(adapters.calib_extras(cfg, tokens)["frames"], f)
    assert not torch.equal(adapters.calib_extras(cfg, tokens, 1)["frames"], f)
    # the calibration state reads the same frames, chunk by chunk
    adapter = adapters.get_adapter(fam["model"], fam["params"])
    from repro_torch.models import encdec

    assert torch.equal(adapter.calib_state(tokens, 1)["enc"],
                       encdec.embed_frames(fam["params"], cfg, adapters
                                           .calib_extras(cfg, tokens, 1)
                                           ["frames"]))


def test_registry_quantizes_and_packs_audio():
    """``tests/core/test_adapters.py::test_registry_quantizes_and_packs_
    every_family[audio]`` on the port: finite per-target errors, VQLinear
    leaves in both stacks, a finite perplexity of the packed model with
    the stub frames."""
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    calib = sample_batch(torch.Generator().manual_seed(9), cfg.vocab_size,
                         16, 4)
    tiny = VQConfig(d=2, bits_per_dim=3, group_size=4096, em_iters=4,
                    codebook_update_iters=2)
    qp, rep = quantize_model(model, params, calib, "gptvq", tiny, pack=True,
                             chunk=4, seed=1)
    errs = [v for row in rep.per_layer for k, v in row.items()
            if k not in ("layer", "block")]
    assert errs and all(np.isfinite(e) for e in errs)
    assert isinstance(qp["enc_layers"][0]["attn"]["wq"], vql.VQLinear)
    assert isinstance(qp["dec_layers"][1]["ffn"]["w_out"], vql.VQLinear)
    heldout = sample_batch(torch.Generator().manual_seed(4), cfg.vocab_size,
                           16, 2)
    extras = adapters.calib_extras(cfg, heldout)
    assert np.isfinite(perplexity(model, qp, heldout, batch_extra=extras))
