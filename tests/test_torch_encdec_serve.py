"""The port's paged engine on the audio family (``whisper-small`` smoke
config, f32): the port's counterparts of ``tests/serve/test_paged_serving.py``'s
``audio`` cases.

The engine serves the decoder from tokens alone, as the reference's does:
a request carries no frames, so the cross K/V stay the zeros the cache
starts from. They are slot-resident state (reset from the template on
admission, kept by the slots that do not decode in a tick), so the prefix
cache stays off; the self-attention K/V page, and prompts go in padded to
their power-of-two chunk as on the dense family.

* interleaved continuous batching gives each request's solo tokens, on f32
  and int8 pages, through both decode reads;
* fused VQ matmuls give the gather form's tokens over a packed model;
* a prefix cache asked for stays off, the tokens unchanged;
* an oversubscribed pool preempts and replays to the same tokens;
* admission resets a slot's cross K/V; a decode tick returns them as the
  same tensors;
* teacher-forced per-step logits through a paged cache against the
  reference's on its own weights (q/k/v biases seeded non-zero: numpy seed
  0, std 0.02) at 1e-4, and against a dense-``KVCache`` prefill of the same
  tokens with zero cross K/V (the card's anchor);
* a decode from the reference's ``EncDecCache`` (``paged_cache_from_jax``);
* both launchers at ``--arch whisper-small --smoke --device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.models import model_zoo as jzoo
from repro.models.attention import PagedLayout as JPagedLayout
from repro.serve import paged_cache as jpc

from repro_torch.configs import SMOKE
from repro_torch.convert import paged_cache_from_jax, params_from_jax
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe
from repro_torch.launch import quantize as launch_quantize
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model_zoo
from repro_torch.models.attention import PagedKVCache, PagedLayout
from repro_torch.models.encdec import EncDecCache
from repro_torch.obs import dispatch
from repro_torch.serve import paged_cache as pc
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.serve_step import teacher_forced_logits

from test_torch_encdec import seeded_biases

ARCH = "whisper-small"
_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def audio_model():
    """The smoke model, the port's own seeded weights."""
    if "model" not in _CACHE:
        cfg = SMOKE[ARCH].scaled(dtype="float32")
        model = model_zoo.build(cfg)
        _CACHE["model"] = (model, model.init_params(seed=0, device="cpu"))
    return _CACHE["model"]


def packed_params():
    """The smoke model GPTVQ-packed at 2.25bpv_2d."""
    if "packed" not in _CACHE:
        model, params = audio_model()
        calib = torch.randint(0, model.cfg.vocab_size, (4, 32),
                              generator=torch.Generator().manual_seed(9))
        recipe = QuantRecipe.uniform(
            PAPER_SETTINGS["2.25bpv_2d"]).with_quantize_overrides(
                em_iters=4, codebook_update_iters=2)
        _CACHE["packed"] = quantize_model(model, params, calib,
                                          recipe=recipe, pack=True)[0]
    return _CACHE["packed"]


def _serve(model, params, prompts, rid0=0, n=6, **kw):
    kw = {"max_batch": 2, "max_len": 64, "page_size": 8, **kw}
    eng = Engine(model, params, device="cpu", **kw)
    reqs = [Request(rid=rid0 + i, prompt=p, max_new_tokens=n)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(len(r.out_tokens) == n for r in reqs)
    return eng, [r.out_tokens for r in reqs]


@pytest.mark.parametrize("bits,impl", [
    (16, "gather"), (16, "fused"), (8, "gather"), (8, "fused")])
def test_interleaved_matches_solo(bits, impl):
    model, params = audio_model()
    rng = np.random.RandomState(1)
    V = model.cfg.vocab_size - 1
    prompts = [rng.randint(0, V, size=s) for s in (5, 9, 3, 12)]
    eng, toks = _serve(model, params, prompts, paged_attn_impl=impl,
                       kv_cache_bits=bits)
    # padded prefill chunks (audio is not a recurrent family); paged self
    # K/V with one table for every layer; slot-resident cross K/V
    assert eng.scheduler.pad_prefill
    assert isinstance(eng.cache, EncDecCache)
    assert all(isinstance(c, PagedKVCache) for c in eng.cache.self_kv)
    assert eng.cache.self_kv[0].page_table is eng.cache.self_kv[1].page_table
    cfg = model.cfg
    assert all(c.shape == (2, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
               and float(c.abs().max()) == 0
               for c in eng.cache.cross_k + eng.cache.cross_v)
    for i, p in enumerate(prompts):
        assert _serve(model, params, [p], rid0=200 + i, paged_attn_impl=impl,
                      kv_cache_bits=bits)[1][0] == toks[i], (bits, impl, i)


def test_fused_matches_gather():
    """Greedy decode over the packed model: fused VQ matmuls give the
    gather form's tokens, and the "vq" dispatch counter pins the fused
    path."""
    model, _ = audio_model()
    qparams = packed_params()
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, model.cfg.vocab_size - 1, size=s)
               for s in (5, 9, 3)]
    ref = _serve(model, qparams, prompts, vq_matmul_impl="gather")[1]
    before = dispatch.snapshot_dispatch_counters()["vq"]["fused"]
    toks = _serve(model, qparams, prompts, rid0=300, vq_matmul_impl="fused",
                  paged_attn_impl="fused")[1]
    assert dispatch.snapshot_dispatch_counters()["vq"]["fused"] > before
    assert toks == ref


def test_prefix_cache_stays_inert():
    """The cross K/V are detected structurally as slot state: the prefix
    cache stays off whatever the constructor asked, and the tokens are
    solo's."""
    model, params = audio_model()
    rng = np.random.RandomState(11)
    V = model.cfg.vocab_size - 1
    header = rng.randint(0, V, size=40)
    prompts = [np.concatenate([header, rng.randint(0, V, size=3 + i)])
               for i in range(4)]
    kw = dict(max_batch=2, max_len=96, page_size=16, paged_attn_impl="fused")
    warm, toks = _serve(model, params, prompts, prefix_cache=True, **kw)
    assert pc.has_slot_state(warm.cache)
    assert warm.prefix_cache is None
    assert warm.stats["prefix_hits"] == 0 and warm.stats["shared_blocks"] == 0
    for i, p in enumerate(prompts):
        assert _serve(model, params, [p], rid0=500 + i, **kw)[1][0] == toks[i]


def test_pool_exhaustion_preempts_and_replays():
    """The youngest request is evicted, recomputed from a reset slot, and
    every request's greedy tokens are the unpressured engine's."""
    model, params = audio_model()
    rng = np.random.RandomState(0)
    V = model.cfg.vocab_size - 1
    prompts = [rng.randint(0, V, size=s) for s in (10, 14, 7)]
    kw = dict(max_batch=2, max_len=64, page_size=4, paged_attn_impl="fused")
    big, ref = _serve(model, params, prompts, n=8, **kw)
    assert big.stats["preemptions"] == 0
    tight, out = _serve(model, params, prompts, rid0=10, n=8, num_blocks=9,
                        **kw)
    assert tight.stats["preemptions"] > 0
    assert out == ref


def test_admission_resets_cross_kv_and_ticks_keep_them():
    """A slot's cross K/V (written here by hand, as a frames prefill would
    leave them) are the template's zeros once the next request is admitted,
    in every layer, and the other slot's rows stay; a decode tick returns
    the cross K/V as the same tensors (``restore_masked`` skips them)."""
    model, params = audio_model()
    eng = Engine(model, params, max_batch=2, max_len=64, page_size=8,
                 device="cpu")
    for c in eng.cache.cross_k + eng.cache.cross_v:
        c.normal_(generator=torch.Generator().manual_seed(3))
    other = [c[1].clone() for c in eng.cache.cross_k]
    seq = eng.scheduler.try_place(Request(rid=9, prompt=np.arange(5),
                                          max_new_tokens=2))
    assert seq.slot == 0
    eng._admit_seq(seq)
    for c in eng.cache.cross_k + eng.cache.cross_v:
        assert float(c[0].abs().max()) == 0
    assert all(torch.equal(c[1], o) for c, o in zip(eng.cache.cross_k,
                                                    other))
    while seq.phase == "prefill":
        eng.step()
    held = list(eng.cache.cross_k)
    eng.step()  # a decode tick
    assert all(a is b for a, b in zip(eng.cache.cross_k, held))


@pytest.fixture(scope="module")
def ref_trace():
    """The reference's per-step logits on a forced token path through its
    own paged cache (f32 pages, zero cross K/V: no frames), its numpy
    weights (biases seeded), the prompt, the forced tokens and its cache
    after the prompt."""
    cfg = JSMOKE[ARCH].scaled(dtype="float32")
    model = jzoo.build(cfg)
    params = seeded_biases(model.init_params(jax.random.PRNGKey(0)))
    max_len, ps = 48, 8
    n_pages = max_len // ps
    prompt = np.random.RandomState(15).randint(0, cfg.vocab_size - 1, size=9)
    cache = model.init_cache(1, max_len, dtype=jnp.float32,
                             paged=JPagedLayout(n_pages + 1, ps))
    cache = jpc.push_page_table(
        cache, np.arange(1, n_pages + 1, dtype=np.int32)[None])
    logits, cache, _ = model.forward(
        params, {"tokens": jnp.asarray(prompt, jnp.int32)[None]},
        cache=cache, pos=jnp.zeros((1,), jnp.int32))
    after_prompt = jax.tree.map(np.asarray, cache)
    rows, toks, pos = [np.asarray(logits[0, -1])], [], len(prompt)
    for _ in range(6):
        tok = int(np.argmax(rows[-1]))
        toks.append(tok)
        logits, cache, _ = model.forward(
            params, {"tokens": jnp.asarray([[tok]], jnp.int32)},
            cache=cache, pos=jnp.full((1,), pos, jnp.int32),
            paged_impl="xla")
        rows.append(np.asarray(logits[0, -1]))
        pos += 1
    return {"params": jax.tree.map(np.asarray, params), "prompt": prompt,
            "forced": toks, "logits": np.stack(rows),
            "cache": after_prompt}


def _paged(model):
    cache = model.init_cache(1, 48, dtype=torch.float32,
                             paged=PagedLayout(7, 8), device="cpu")
    return pc.push_page_table(cache, np.arange(1, 7, dtype=np.int32)[None])


@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_teacher_forced_logits_match_reference(ref_trace, impl):
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = params_from_jax(ref_trace["params"], cfg, device="cpu")
    got = teacher_forced_logits(model, params, ref_trace["prompt"],
                                ref_trace["forced"], cache=_paged(model),
                                paged_impl=impl).numpy()
    np.testing.assert_allclose(got, ref_trace["logits"], rtol=1e-4,
                               atol=1e-4)


def test_paged_decode_matches_dense_prefill_with_zero_cross(ref_trace):
    """The anchor of the card's serve bars: a dense-``KVCache`` prefill of
    the prompt and the forced tokens, its cross K/V the cache's zeros (not
    ``memory=zeros``, whose projection adds the biases), gives the paged
    kernel decode's logits row by row."""
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = params_from_jax(ref_trace["params"], cfg, device="cpu")
    got = teacher_forced_logits(model, params, ref_trace["prompt"],
                                ref_trace["forced"], cache=_paged(model),
                                paged_impl="fused")
    seq = np.concatenate([ref_trace["prompt"], ref_trace["forced"]])
    dense = model.init_cache(1, 48, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        full = model.forward(params, {"tokens": torch.as_tensor(seq)[None]},
                             cache=dense, pos=0)[0][0]
    np.testing.assert_allclose(got.numpy(),
                               full[len(ref_trace["prompt"]) - 1:].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_decode_from_the_reference_cache(ref_trace):
    """The reference's EncDecCache after the prompt (a stacked paged KV,
    cross K/V (L, B, S_enc, KV, hd)), carried over by
    ``paged_cache_from_jax`` bit for bit: the port's decode steps from it
    give the reference's logits at 1e-4."""
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = params_from_jax(ref_trace["params"], cfg, device="cpu")
    ref_cache = ref_trace["cache"]
    cache = paged_cache_from_jax(ref_cache, device="cpu")
    assert isinstance(cache, EncDecCache) and len(cache.self_kv) == 2
    assert all(isinstance(c, PagedKVCache) for c in cache.self_kv)
    for i in range(cfg.n_layers):
        assert np.array_equal(cache.self_kv[i].k.numpy(),
                              ref_cache.self_kv.k[i])
        assert np.array_equal(cache.cross_k[i].numpy(), ref_cache.cross_k[i])
    pos, rows = len(ref_trace["prompt"]), []
    with torch.no_grad():
        for tok in ref_trace["forced"]:
            logits, cache, _ = model.forward(
                params, {"tokens": torch.tensor([[tok]])}, cache=cache,
                pos=torch.full((1,), pos), paged_impl="fused")
            rows.append(logits[0, -1])
            pos += 1
    np.testing.assert_allclose(torch.stack(rows).numpy(),
                               ref_trace["logits"][1:], rtol=1e-4, atol=1e-4)


def test_launchers_take_whisper(tmp_path, capsys):
    """Both launchers end to end with ``--arch whisper-small --smoke`` on
    the CPU: the quantize launcher packs and saves both stacks (its
    evaluation with the stub frames), the serve launcher serves the packed
    model on the fused paths and vq2 pages."""
    rep, ppl_fp, ppl_vq = launch_quantize.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--sequences", "4",
        "--seq-len", "32", "--em-iters", "2", "--update-iters", "1",
        "--out", str(tmp_path)])
    assert np.isfinite(ppl_fp) and np.isfinite(ppl_vq)
    assert all(e["action"] == "quantize" for e in rep.per_target.values())
    assert "enc.1.ffn.w_out" in rep.per_target
    assert "dec.1.cross_attn.wv" in rep.per_target
    eng, reqs = launch_serve.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--vq",
        "--vq-matmul-impl", "fused", "--paged-attn-impl", "fused",
        "--kv-cache-bits", "vq2", "--requests", "2", "--max-new", "3"])
    assert all(len(r.out_tokens) == 3 for r in reqs)
    assert all(c.k_codebook is not None for c in eng.cache.self_kv)
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "packed checkpoint written" in out
