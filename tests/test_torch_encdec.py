"""Port parity for ``models/encdec.py`` (whisper: a bidirectional encoder
over stub frame embeddings, a decoder with causal self-attention and
cross-attention over the encoder memory, no RoPE on either side) and the
attention module's ``causal=`` / ``use_rope=`` / cross paths, on the
``whisper-small`` smoke config (f32: 2 encoder + 2 decoder layers,
d_model 64, 4 heads of 16, 32 frames):

* ``encode``, ``enc_block_apply``, ``dec_block_apply`` on the reference's
  memory and ``forward(frames=)`` logits against the reference's at 1e-4
  (f32 sums in another order);
* ``pre_out(causal=False, use_rope=False)``, ``cross_pre_out`` and
  ``cross_apply`` against the reference's;
* a dense-cache prefill with frames, then one decode step, against the
  full forward (``tests/models/test_smoke.py::test_decode_matches_prefill``'s
  bar) and against the reference's decode at 1e-4;
* ``cross_pre_out`` past ``flash_threshold`` refuses an Sk the flash
  chunks do not divide, in both packages;
* ``count_params`` of the full config equal to the reference's;
* a heterogeneous (mixed-recipe) pair of stacks against the reference's
  list path on the same packed leaves.

The q/k/v biases start at zeros in both packages, where a bias on the
wrong side goes unseen; these tests write the same non-zero biases (numpy
seed 0, std 0.02) into the reference's tree before carrying it over. The
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
from repro.models import attention as jattn, encdec as jencdec
from repro.models import model_zoo as jzoo

from repro_torch.configs import ARCHS, SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.core import vq_linear as vql
from repro_torch.core.adapters.base import blocks_stackable
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import KeepDense, QuantRecipe, Quantize, Rule
from repro_torch.models import attention, encdec, model_zoo

ARCH = "whisper-small"
B, S = 2, 16
VQ_ARRAYS = ("words", "codebooks", "cb_scale", "scale_sint", "scale_a",
             "scale_z")
VQ_STATIC = ("r", "c", "d", "k", "group_cols", "rows_per_band",
             "scale_block", "rule")
DENSE_TARGET = "enc.0.attn.wq"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def seeded_biases(jparams):
    """The reference's tree with every q/k/v bias drawn from N(0, 0.02^2)
    (numpy seed 0) instead of zeros."""
    rng = np.random.default_rng(0)

    def seed(attn):
        return dict(attn, **{b: jnp.asarray(rng.standard_normal(
            attn[b].shape).astype(np.float32) * 0.02)
            for b in ("bq", "bk", "bv")})

    enc = dict(jparams["enc_layers"], attn=seed(jparams["enc_layers"]["attn"]))
    dec = dict(jparams["dec_layers"],
               self_attn=seed(jparams["dec_layers"]["self_attn"]),
               cross_attn=seed(jparams["dec_layers"]["cross_attn"]))
    return dict(jparams, enc_layers=enc, dec_layers=dec)


def to_jax(tree):
    """A port tree (list stacks, VQLinear leaves) as the reference's
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
    """The reference's weights (seeded biases), tokens, frames and its
    outputs; and its list-path logits on the port's mixed-recipe quantize
    of the same weights."""
    jcfg = JSMOKE[ARCH].scaled(dtype="float32")
    jmodel = jzoo.build(jcfg)
    jp = seeded_biases(jmodel.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, jcfg.encoder_seq, jcfg.d_model))
              * 0.1).astype(np.float32)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jt, jf, jx = (jnp.asarray(a) for a in (tokens, frames, x))
    out = {"tokens": tokens, "frames": frames, "x": x}
    out["logits"] = jmodel.forward(jp, {"tokens": jt, "frames": jf},
                                   remat=False)[0]
    out["memory"] = jencdec.encode(jp, jcfg, jf, remat=False)
    enc0 = jax.tree.map(lambda a: a[0], jp["enc_layers"])
    dec1 = jax.tree.map(lambda a: a[1], jp["dec_layers"])
    emb = jencdec.embed_frames(jp, jcfg, jf)
    out["enc_block"] = jencdec.enc_block_apply(enc0, jcfg, emb)
    out["dec_block"] = jencdec.dec_block_apply(dec1, jcfg, jx,
                                               out["memory"])
    out["pre_out_bidir"] = jattn.pre_out(enc0["attn"], jcfg, jx,
                                         causal=False, use_rope=False)
    out["pre_out_causal"] = jattn.pre_out(dec1["self_attn"], jcfg, jx,
                                          use_rope=False)
    out["cross_pre_out"] = jattn.cross_pre_out(dec1["cross_attn"], jcfg, jx,
                                               out["memory"])
    out["cross_apply"] = jattn.cross_apply(dec1["cross_attn"], jcfg, jx,
                                           out["memory"])
    cache = jmodel.init_cache(B, S + 4, dtype=jnp.float32)
    _, cache, _ = jmodel.forward(
        jp, {"tokens": jt[:, :S - 1], "frames": jf}, cache=cache, pos=0,
        remat=False)
    out["decode"] = jmodel.forward(jp, {"tokens": jt[:, S - 1:]},
                                   cache=cache, pos=S - 1, remat=False)[0]
    out = {k: np.asarray(v) for k, v in out.items()}
    out["params"] = jax.tree.map(np.asarray, jp)

    # the heterogeneous stacks: the port's packed mixed-recipe quantize,
    # carried into the reference's list form
    cfg = _cfg()
    model = model_zoo.build(cfg)
    params = params_from_jax(out["params"], cfg, device="cpu")
    recipe = QuantRecipe(
        rules=(Rule(DENSE_TARGET, KeepDense("heterogeneous stack")),),
        default=Quantize(dataclasses.replace(
            PAPER_SETTINGS["2.25bpv_2d"], em_iters=4,
            codebook_update_iters=2)), name="hetero")
    calib = torch.randint(0, cfg.vocab_size, (4, 32),
                          generator=torch.Generator().manual_seed(9))
    qparams, rep = quantize_model(model, params, calib, recipe=recipe,
                                  pack=True)
    out["qparams"], out["rep"] = qparams, rep
    out["hetero"] = np.asarray(jmodel.forward(
        to_jax(qparams), {"tokens": jt, "frames": jf}, remat=False)[0])
    return out


def _port(ref):
    cfg = _cfg()
    return cfg, model_zoo.build(cfg), params_from_jax(ref["params"], cfg,
                                                      device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_forward_logits_match_reference(ref):
    cfg, model, params = _port(ref)
    assert float(params["dec_layers"][0]["cross_attn"]["bk"].abs().max()) > 0
    assert len(params["enc_layers"]) == cfg.n_encoder_layers
    assert len(params["dec_layers"]) == cfg.n_layers
    logits, cache, aux = model.forward(
        params, {"tokens": _t(ref["tokens"]).long(),
                 "frames": _t(ref["frames"])})
    assert cache is None and float(aux) == 0.0
    assert logits.shape == (B, S, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)


def test_encode_and_enc_block_match_reference(ref):
    cfg, _, params = _port(ref)
    frames = _t(ref["frames"])
    np.testing.assert_allclose(encdec.encode(params, cfg, frames).numpy(),
                               ref["memory"], **TOL)
    emb = encdec.embed_frames(params, cfg, frames)
    np.testing.assert_allclose(
        encdec.enc_block_apply(params["enc_layers"][0], cfg, emb).numpy(),
        ref["enc_block"], **TOL)


def test_dec_block_on_the_reference_memory(ref):
    cfg, _, params = _port(ref)
    got = encdec.dec_block_apply(params["dec_layers"][1], cfg, _t(ref["x"]),
                                 _t(ref["memory"]))
    np.testing.assert_allclose(got.numpy(), ref["dec_block"], **TOL)


@pytest.mark.parametrize("name", ["pre_out_bidir", "pre_out_causal",
                                  "cross_pre_out", "cross_apply"])
def test_attention_paths_match_reference(ref, name):
    """The encoder's bidirectional un-rotated pre_out, the decoder's causal
    un-rotated one, and the cross-attention from x to the memory."""
    cfg, _, params = _port(ref)
    enc0, dec1 = params["enc_layers"][0], params["dec_layers"][1]
    x, mem = _t(ref["x"]), _t(ref["memory"])
    got = {
        "pre_out_bidir": lambda: attention.pre_out(
            enc0["attn"], cfg, x, causal=False, use_rope=False),
        "pre_out_causal": lambda: attention.pre_out(
            dec1["self_attn"], cfg, x, use_rope=False),
        "cross_pre_out": lambda: attention.cross_pre_out(
            dec1["cross_attn"], cfg, x, mem),
        "cross_apply": lambda: attention.cross_apply(
            dec1["cross_attn"], cfg, x, mem),
    }[name]()
    np.testing.assert_allclose(got.numpy(), ref[name], **TOL)


def test_bidirectional_and_rope_switches_change_the_output(ref):
    """causal=False lets row 0 see the last row; use_rope=True rotates q
    and k: each switch moves pre_out, so neither is ignored."""
    cfg, _, params = _port(ref)
    p, x = params["enc_layers"][0]["attn"], _t(ref["x"])
    base = attention.pre_out(p, cfg, x, causal=False, use_rope=False)
    for kw in (dict(causal=True, use_rope=False),
               dict(causal=False, use_rope=True)):
        assert float((attention.pre_out(p, cfg, x, **kw) - base)
                     .abs().max()) > 1e-4, kw


def test_paged_self_attention_refuses_bidirectional(ref):
    """A page table's mask is kpos <= pos: ``apply`` with a
    ``PagedKVCache`` refuses ``causal=False`` instead of running causal."""
    cfg, model, params = _port(ref)
    cache = model.init_cache(B, S, dtype=torch.float32,
                             paged=attention.PagedLayout(2 * B + 1, 8),
                             device="cpu")
    p, x = params["dec_layers"][0]["self_attn"], _t(ref["x"])
    with pytest.raises(ValueError, match="causal=False"):
        attention.apply(p, cfg, x, pos=0, cache=cache.self_kv[0],
                        causal=False, use_rope=False)


def test_decode_matches_prefill(ref):
    """A dense-cache prefill of S - 1 tokens with frames, then one decode
    step on the cache's cross K/V: the full forward's last row at the
    reference test's bar (2e-2) and the reference's decode at 1e-4. The
    decode step returns the cache's own cross K/V tensors."""
    cfg, model, params = _port(ref)
    tokens, frames = _t(ref["tokens"]).long(), _t(ref["frames"])
    full = model.forward(params, {"tokens": tokens, "frames": frames})[0]
    cache = model.init_cache(B, S + 4, dtype=torch.float32, device="cpu")
    assert isinstance(cache, encdec.EncDecCache)
    assert float(cache.cross_k[0].abs().max()) == 0
    _, cache, _ = model.forward(
        params, {"tokens": tokens[:, :S - 1], "frames": frames}, cache=cache,
        pos=0)
    assert all(c.shape == (B, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
               and c.dtype == torch.float32 for c in cache.cross_k)
    assert float(cache.cross_k[1].abs().max()) > 0
    dec, new, _ = model.forward(params, {"tokens": tokens[:, S - 1:]},
                                cache=cache, pos=S - 1)
    assert all(a is b for a, b in zip(new.cross_k + new.cross_v,
                                      cache.cross_k + cache.cross_v))
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(dec.numpy(), ref["decode"], **TOL)


def test_forward_needs_frames_or_a_cache(ref):
    """As the reference asserts: frames, or a cache. ``memory=`` beside a
    cache stands in for the encoder: the same logits as frames, and the
    cross K/V filled from it."""
    cfg, model, params = _port(ref)
    tokens = _t(ref["tokens"]).long()
    with pytest.raises(ValueError, match="frames or a cache"):
        model.forward(params, {"tokens": tokens})
    mem = encdec.encode(params, cfg, _t(ref["frames"]))
    with pytest.raises(ValueError, match="frames or a cache"):
        encdec.forward(params, cfg, tokens, memory=mem)
    cache = model.init_cache(B, S, dtype=torch.float32, device="cpu")
    logits, cache, _ = encdec.forward(params, cfg, tokens, memory=mem,
                                      cache=cache)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    k0, _ = encdec._cross_kv(params["dec_layers"][0]["cross_attn"], cfg, mem)
    assert torch.equal(cache.cross_k[0], k0)


def test_cross_flash_refuses_whisper_frames_in_both_packages(ref):
    """Past ``flash_threshold`` the cross path takes flash, whose kv chunks
    of min(1024, Sk) do not divide Sk = 1,100 (or whisper's 1,500): the
    reference asserts, the port raises; neither falls back."""
    jcfg = JSMOKE[ARCH].scaled(dtype="float32")
    cfg, _, params = _port(ref)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((1, 1100, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]),
                      ref["params"]["dec_layers"]["cross_attn"])
    with pytest.raises(AssertionError):
        jattn.cross_pre_out(jp, jcfg, jnp.asarray(x), jnp.asarray(mem),
                            flash_threshold=1000)
    p = params["dec_layers"][1]["cross_attn"]
    with pytest.raises(ValueError, match="Sk=1100 of 1024"):
        attention.cross_pre_out(p, cfg, _t(x), _t(mem), flash_threshold=1000)
    # below the threshold the same shapes take the plain path
    assert attention.cross_pre_out(p, cfg, _t(x), _t(mem)).shape == (
        1, 4, cfg.n_heads * cfg.hd)


def test_count_params_of_the_full_config_equals_the_reference():
    got = model_zoo.count_params(model_zoo.build(ARCHS[ARCH]))
    want = jzoo.count_params(jzoo.build(JARCHS[ARCH]))
    assert got == want
    assert 0.2e9 <= got <= 0.45e9  # the reference test's nameplate band


def test_heterogeneous_stacks_match_reference_list_path(ref):
    """A mixed recipe (one encoder wq kept dense) leaves an encoder stack
    that does not stack; the port's loops over both lists give the
    reference's list-path logits on the same packed leaves, in the gather
    form and the fused one."""
    _, model, _ = _port(ref)
    q = ref["qparams"]
    assert ref["rep"].per_target[DENSE_TARGET]["action"] == "keep_dense"
    assert not isinstance(q["enc_layers"][0]["attn"]["wq"], vql.VQLinear)
    assert isinstance(q["enc_layers"][1]["attn"]["wq"], vql.VQLinear)
    assert not blocks_stackable(q["enc_layers"])
    assert blocks_stackable(q["dec_layers"])
    batch = {"tokens": _t(ref["tokens"]).long(), "frames": _t(ref["frames"])}
    for tree in (q, vql.prepare_fused_tree(q)):
        np.testing.assert_allclose(model.forward(tree, batch)[0].numpy(),
                                   ref["hetero"], **TOL)
