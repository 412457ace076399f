"""The port's paged engine on the hybrid family (``zamba2-7b`` smoke config,
f32): the port's counterparts of ``tests/serve/test_paged_serving.py``'s
``hybrid`` cases.

The hybrid's cache is the first to mix both kinds of state: one paged KV
stack a group for the shared attention (one page table for all of them)
and slot-resident Mamba2 state a layer (reset on admission, kept by the
slots that do not decode in a tick). Prompts go in as exact power-of-two
chunks and the prefix cache stays off.

* interleaved continuous batching gives each request's solo tokens, on f32
  and int8 pages, through both decode reads (``:318``);
* int8 pages drift from the f32-page anchor by less than 0.25 (``:338``);
* fused VQ matmuls give the gather form's tokens over a packed model
  (``:605``);
* a prefix cache asked for stays off, the tokens unchanged (``:685``);
* an oversubscribed pool preempts and replays to the same tokens;
* teacher-forced per-step logits through a paged cache against the
  reference's on its own weights (LoRA B seeded non-zero in both: numpy
  seed 0, std 0.02) at 1e-4 (f32 sums in another order);
* both launchers at ``--arch zamba2-7b --smoke --device cpu``.
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
from repro_torch.models import model_zoo, ssm
from repro_torch.models.attention import KVQuantSpec, PagedKVCache, PagedLayout
from repro_torch.models.hybrid import HybridCache
from repro_torch.obs import dispatch
from repro_torch.serve import paged_cache as pc
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.serve_step import teacher_forced_logits

ARCH = "zamba2-7b"
_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def hybrid_model():
    """The smoke model, the port's own seeded weights."""
    if "model" not in _CACHE:
        cfg = SMOKE[ARCH].scaled(dtype="float32")
        model = model_zoo.build(cfg)
        _CACHE["model"] = (model, model.init_params(seed=0, device="cpu"))
    return _CACHE["model"]


def packed_params():
    """The smoke model GPTVQ-packed at 2.25bpv_2d."""
    if "packed" not in _CACHE:
        model, params = hybrid_model()
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
    model, params = hybrid_model()
    rng = np.random.RandomState(4)
    V = model.cfg.vocab_size - 1
    prompts = [rng.randint(0, V, size=s) for s in (5, 9, 3, 12)]
    eng, toks = _serve(model, params, prompts, paged_attn_impl=impl,
                       kv_cache_bits=bits)
    # exact power-of-two prefill chunks; the cache mixes both kinds
    assert not eng.scheduler.pad_prefill
    assert isinstance(eng.cache, HybridCache)
    assert all(isinstance(c, PagedKVCache) for c in eng.cache.attn)
    assert all(isinstance(c, ssm.SSMCache)
               for g in eng.cache.mamba for c in g)
    # one page table for every group's KV stack
    assert eng.cache.attn[0].page_table is eng.cache.attn[1].page_table
    for i, p in enumerate(prompts):
        assert _serve(model, params, [p], rid0=200 + i, paged_attn_impl=impl,
                      kv_cache_bits=bits)[1][0] == toks[i], (bits, impl, i)


def test_int8_logit_drift_vs_f32_anchor():
    """Greedy decode over int8 pages against the identical loop over f32
    pages, logits step by step: within the reference's 0.25."""
    model, params = hybrid_model()
    max_len, page_size = 48, 8
    n_pages = max_len // page_size
    prompt = np.random.RandomState(5).randint(0, model.cfg.vocab_size - 1,
                                              size=9)
    table = np.arange(1, n_pages + 1, dtype=np.int32)[None]

    def trace(bits):
        cache = model.init_cache(
            1, max_len, dtype=torch.float32, device="cpu",
            paged=PagedLayout(n_pages + 1, page_size, KVQuantSpec(bits)))
        cache = pc.push_page_table(cache, table)
        with torch.no_grad():
            logits, cache, _ = model.forward(
                params, {"tokens": torch.as_tensor(prompt)[None]},
                cache=cache, pos=torch.zeros((1,), dtype=torch.long))
            out, pos = [logits[0, -1]], len(prompt)
            for _ in range(6):
                tok = int(out[-1].argmax())
                logits, cache, _ = model.forward(
                    params, {"tokens": torch.tensor([[tok]])}, cache=cache,
                    pos=torch.full((1,), pos))
                out.append(logits[0, -1])
                pos += 1
        return out

    drift = max(float((a - b).abs().max())
                for a, b in zip(trace(16), trace(8)))
    assert 0 < drift < 0.25


def test_fused_matches_gather():
    """Greedy decode over the packed model: fused VQ matmuls on the trunk
    (the shared block densified every forward) give the gather form's
    tokens, and the "vq" dispatch counter pins the fused path."""
    model, _ = hybrid_model()
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
    """Slot-resident Mamba state is detected structurally: the prefix cache
    stays off whatever the constructor asked, and the tokens are solo's."""
    model, params = hybrid_model()
    rng = np.random.RandomState(11)
    V = model.cfg.vocab_size - 1
    header = rng.randint(0, V, size=40)
    prompts = [np.concatenate([header, rng.randint(0, V, size=3 + i)])
               for i in range(4)]
    kw = dict(max_batch=2, max_len=96, page_size=16, paged_attn_impl="fused")
    warm, toks = _serve(model, params, prompts, prefix_cache=True, **kw)
    assert warm.prefix_cache is None
    assert warm.stats["prefix_hits"] == 0 and warm.stats["shared_blocks"] == 0
    for i, p in enumerate(prompts):
        assert _serve(model, params, [p], rid0=500 + i, **kw)[1][0] == toks[i]


def test_pool_exhaustion_preempts_and_replays():
    """The youngest request is evicted, recomputed from a reset slot, and
    every request's greedy tokens are the unpressured engine's."""
    model, params = hybrid_model()
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


def test_admission_resets_the_slots_mamba_state():
    """A recycled slot's Mamba state is the template's once the next
    request is admitted, in every layer; the other slot's rows stay."""
    model, params = hybrid_model()
    eng = Engine(model, params, max_batch=2, max_len=64, page_size=8,
                 device="cpu")
    eng.run([Request(rid=0, prompt=np.arange(7) % 50, max_new_tokens=3)])
    assert float(eng.cache.mamba[1][1].h[0].abs().sum()) > 0
    other = [c.h[1].clone() for g in eng.cache.mamba for c in g]
    seq = eng.scheduler.try_place(Request(rid=9, prompt=np.arange(5),
                                          max_new_tokens=2))
    eng._admit_seq(seq)
    for g, grp in enumerate(eng.cache.mamba):
        for j, c in enumerate(grp):
            tmpl = eng._slot_template.mamba[g][j]
            assert torch.equal(c.h[seq.slot], tmpl.h[0])
            assert torch.equal(c.conv[seq.slot], tmpl.conv[0])
    rest = [c.h[1 - seq.slot] for g in eng.cache.mamba for c in g]
    if seq.slot == 0:
        assert all(torch.equal(a, b) for a, b in zip(rest, other))


@pytest.fixture(scope="module")
def ref_trace():
    """The reference's per-step logits on a forced token path through its
    own paged cache (f32 pages), its numpy weights (LoRA B seeded), the
    prompt and the forced tokens."""
    cfg = JSMOKE[ARCH].scaled(dtype="float32")
    model = jzoo.build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = dict(params, lora={
        n: dict(f, B=jnp.asarray(rng.standard_normal(f["B"].shape).astype(
            np.float32) * 0.02)) for n, f in params["lora"].items()})
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


@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_teacher_forced_logits_match_reference(ref_trace, impl):
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = params_from_jax(ref_trace["params"], cfg, device="cpu")
    cache = model.init_cache(1, 48, dtype=torch.float32,
                             paged=PagedLayout(7, 8), device="cpu")
    cache = pc.push_page_table(cache, np.arange(1, 7, dtype=np.int32)[None])
    got = teacher_forced_logits(model, params, ref_trace["prompt"],
                                ref_trace["forced"], cache=cache,
                                paged_impl=impl).numpy()
    np.testing.assert_allclose(got, ref_trace["logits"], rtol=1e-4,
                               atol=1e-4)


def test_decode_from_the_reference_cache(ref_trace):
    """The reference's HybridCache after the prompt (each group's paged KV
    stack, each layer's Mamba state), carried over by
    ``paged_cache_from_jax``: the port's decode steps from it give the
    reference's logits at 1e-4."""
    cfg = SMOKE[ARCH].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = params_from_jax(ref_trace["params"], cfg, device="cpu")
    cache = paged_cache_from_jax(ref_trace["cache"], device="cpu")
    assert isinstance(cache, HybridCache) and len(cache.attn) == 2
    assert all(isinstance(c, ssm.SSMCache) for g in cache.mamba for c in g)
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


def test_launchers_take_zamba(tmp_path, capsys):
    """Both launchers end to end with ``--arch zamba2-7b --smoke`` on the
    CPU: the quantize launcher packs and saves the hybrid tree, the serve
    launcher serves the packed model on the fused paths and vq2 pages."""
    rep, ppl_fp, ppl_vq = launch_quantize.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--sequences", "4",
        "--seq-len", "32", "--em-iters", "2", "--update-iters", "1",
        "--out", str(tmp_path)])
    assert np.isfinite(ppl_fp) and np.isfinite(ppl_vq)
    assert all(e["action"] == "quantize" for e in rep.per_target.values())
    assert "mamba.1.1.mixer.out_proj" in rep.per_target
    eng, reqs = launch_serve.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--vq",
        "--vq-matmul-impl", "fused", "--paged-attn-impl", "fused",
        "--kv-cache-bits", "vq2", "--requests", "2", "--max-new", "3"])
    assert all(len(r.out_tokens) == 3 for r in reqs)
    assert all(c.k_codebook is not None for c in eng.cache.attn)
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "packed checkpoint written" in out
