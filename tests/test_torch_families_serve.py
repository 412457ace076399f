"""The port's paged engine on the ssm and vlm families (SKILL smoke
configs, f32): the port's counterparts of ``tests/serve/
test_paged_serving.py``'s ``[ssm]`` and ``[vlm]`` cases.

ssm (xLSTM) is the first family whose cache is slot-resident state rather
than attention pages: a slot admitted after another request reset from the
engine's template, the slots that do not decode in a tick keeping their
rows, exact power-of-two prefill chunks, prefix sharing off, preemption
replayed from a reset state. vlm serves text only, as the reference's
engine does (it passes no patches).

* interleaved continuous batching gives each request's solo tokens;
* fused VQ matmuls give the gather form's tokens over a packed model;
* a prefix cache asked for on ssm stays off, the tokens unchanged;
* an oversubscribed pool preempts and replays to the same tokens;
* teacher-forced per-step logits of a forced token path through a paged
  cache, against the reference's on its own weights. Tolerance: vlm 1e-4
  as the dense family's (f32 sums in another order, measured max
  2.3e-6); ssm 1e-4 too: the recurrent state carries the same ulp-level
  differences through the steps (measured max 3.0e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FAMILY_REPRESENTATIVE, SMOKE as JSMOKE
from repro.models import model_zoo as jzoo
from repro.models.attention import PagedLayout as JPagedLayout
from repro.serve import paged_cache as jpc

from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.core.bpv import PAPER_SETTINGS
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe
from repro_torch.launch import quantize as launch_quantize
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model_zoo, xlstm
from repro_torch.models.attention import PagedLayout
from repro_torch.obs import dispatch
from repro_torch.serve import paged_cache as pc
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.serve_step import teacher_forced_logits

_MODELS: dict = {}
_PACKED: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # the recurrences run ~15-30 tiny ops a step: one thread a worker
    # beats a pool that the suite's other workers also want
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def family_model(family: str):
    """Cached smoke model per family, the port's own seeded weights."""
    if family not in _MODELS:
        cfg = SMOKE[FAMILY_REPRESENTATIVE[family]].scaled(dtype="float32")
        model = model_zoo.build(cfg)
        _MODELS[family] = (model, model.init_params(seed=0, device="cpu"))
    return _MODELS[family]


def packed_params(family: str):
    """The family's smoke model GPTVQ-packed at 2.25bpv_2d."""
    if family not in _PACKED:
        model, params = family_model(family)
        calib = torch.randint(0, model.cfg.vocab_size, (4, 32),
                              generator=torch.Generator().manual_seed(9))
        recipe = QuantRecipe.uniform(
            PAPER_SETTINGS["2.25bpv_2d"]).with_quantize_overrides(
                em_iters=4, codebook_update_iters=2)
        _PACKED[family] = quantize_model(model, params, calib,
                                         recipe=recipe, pack=True)[0]
    return _PACKED[family]


def greedy_reqs(prompts, n=6, rid0=0):
    return [Request(rid=rid0 + i, prompt=p, max_new_tokens=n)
            for i, p in enumerate(prompts)]


def _serve(model, params, prompts, rid0=0, n=6, **kw):
    kw = {"max_batch": 2, "max_len": 64, "page_size": 8, **kw}
    eng = Engine(model, params, device="cpu", **kw)
    reqs = greedy_reqs(prompts, n=n, rid0=rid0)
    eng.run(reqs)
    assert all(len(r.out_tokens) == n for r in reqs)
    return eng, [r.out_tokens for r in reqs]


@pytest.mark.parametrize("family,impl", [
    ("ssm", "gather"),  # no attention leaves: nothing to fuse
    ("vlm", "gather"),
    ("vlm", "fused"),
])
def test_interleaved_matches_solo(family, impl):
    model, params = family_model(family)
    rng = np.random.RandomState(1)
    V = model.cfg.vocab_size - 1
    prompts = [rng.randint(0, V, size=s) for s in (5, 9, 3, 12)]
    eng, toks = _serve(model, params, prompts, paged_attn_impl=impl)
    if family == "ssm":
        # recurrent state never pads: every chunk an exact power of two
        assert not eng.scheduler.pad_prefill
        assert all(isinstance(c, (xlstm.MLSTMCache, xlstm.SLSTMCache))
                   for c in eng.cache)
    for i, p in enumerate(prompts):
        assert _serve(model, params, [p], rid0=100 + i,
                      paged_attn_impl=impl)[1][0] == toks[i], (family, i)


def test_recycled_slot_is_reset_and_idle_slots_keep_their_state():
    """ssm: a slot's state after a request ends is the template's once the
    next request is admitted; during a tick, a slot that is mid-prefill
    keeps its rows (restore_masked with a real keep_mask)."""
    model, params = family_model("ssm")
    eng = Engine(model, params, max_batch=2, max_len=64, page_size=8,
                 device="cpu")
    eng.run(greedy_reqs([np.arange(7) % 50], n=3))
    used = eng.cache[0].C[0].clone()
    assert used.abs().sum() > 0  # slot 0 ran a request
    seq = eng.scheduler.try_place(Request(rid=9, prompt=np.arange(5),
                                          max_new_tokens=2))
    eng._admit_seq(seq)
    tmpl = eng._slot_template
    for got, want in zip(eng.cache[0], tmpl[0]):
        assert torch.equal(got[seq.slot], want[0])
    before = [t.clone() for t in eng.cache[0]]
    keep = torch.tensor([True, False])
    kept = pc.restore_masked(eng.cache, [c._replace(
        **{f: torch.full_like(getattr(c, f), 7.0) for f in c._fields})
        for c in eng.cache], eng.axes, keep)
    for b, k in zip(before, kept[0]):
        assert k.dtype == torch.float32
        assert torch.equal(k[0], b[0]) and bool((k[1] == 7.0).all())


@pytest.mark.parametrize("family", ["ssm", "vlm"])
def test_fused_matches_gather(family):
    """TestFusedVQServing::test_fused_matches_gather for ssm and vlm:
    greedy decode over the packed checkpoint, fused VQ matmuls against the
    gather form, and the "vq" dispatch counters pin the fused path."""
    model, _ = family_model(family)
    qparams = packed_params(family)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, model.cfg.vocab_size - 1, size=s)
               for s in (5, 9, 3)]
    ref = _serve(model, qparams, prompts, vq_matmul_impl="gather")[1]
    before = dispatch.snapshot_dispatch_counters()["vq"]["fused"]
    toks = _serve(model, qparams, prompts, rid0=300,
                  vq_matmul_impl="fused")[1]
    assert dispatch.snapshot_dispatch_counters()["vq"]["fused"] > before
    assert toks == ref


def test_prefix_sharing_stays_inert_on_ssm():
    """TestPrefixSharing::test_shared_prefix_matches_solo[hybrid]'s rule on
    ssm: slot-resident state is detected structurally, so the prefix cache
    stays off whatever the constructor asked, and tokens are solo's."""
    model, params = family_model("ssm")
    rng = np.random.RandomState(11)
    V = model.cfg.vocab_size - 1
    header = rng.randint(0, V, size=40)
    prompts = [np.concatenate([header, rng.randint(0, V, size=3 + i)])
               for i in range(4)]
    kw = dict(max_batch=2, max_len=96, page_size=16)
    warm, toks = _serve(model, params, prompts, prefix_cache=True, **kw)
    assert warm.prefix_cache is None
    assert warm.stats["prefix_hits"] == 0 and warm.stats["shared_blocks"] == 0
    for i, p in enumerate(prompts):
        assert _serve(model, params, [p], rid0=500 + i, **kw)[1][0] == toks[i]


@pytest.mark.parametrize("family", ["ssm", "vlm"])
def test_pool_exhaustion_preempts_and_replays(family):
    """TestPreemption::test_pool_exhaustion_preempts_and_completes on each
    family: the youngest request is evicted, recomputed from a reset slot,
    and every request's greedy tokens are the unpressured engine's."""
    model, params = family_model(family)
    rng = np.random.RandomState(0)
    V = model.cfg.vocab_size - 1
    prompts = [rng.randint(0, V, size=s) for s in (10, 14, 7)]
    kw = dict(max_batch=2, max_len=64, page_size=4)
    big, ref = _serve(model, params, prompts, n=8, **kw)
    assert big.stats["preemptions"] == 0
    tight, out = _serve(model, params, prompts, rid0=10, n=8, num_blocks=9,
                        **kw)
    assert tight.stats["preemptions"] > 0
    assert out == ref
    assert tight.stats["tokens"] == sum(len(t) for t in out)


@pytest.fixture(scope="module")
def ref_traces():
    """The reference's per-step logits on a forced token path through its
    own paged cache (the ssm's recurrent state; the vlm's f32 pages), and
    its numpy weights, prompt and forced tokens."""
    out = {}
    for family in ("ssm", "vlm"):
        cfg = JSMOKE[FAMILY_REPRESENTATIVE[family]].scaled(dtype="float32")
        model = jzoo.build(cfg)
        params = model.init_params(jax.random.PRNGKey(0))
        max_len, ps = 48, 8
        n_pages = max_len // ps
        prompt = np.random.RandomState(15).randint(0, cfg.vocab_size - 1,
                                                   size=9)
        cache = model.init_cache(1, max_len, dtype=jnp.float32,
                                 paged=JPagedLayout(n_pages + 1, ps))
        cache = jpc.push_page_table(
            cache, np.arange(1, n_pages + 1, dtype=np.int32)[None])
        logits, cache, _ = model.forward(
            params, {"tokens": jnp.asarray(prompt, jnp.int32)[None]},
            cache=cache, pos=jnp.zeros((1,), jnp.int32))
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
        out[family] = {"params": jax.tree.map(np.asarray, params),
                       "prompt": prompt, "forced": toks,
                       "logits": np.stack(rows)}
    return out


@pytest.mark.parametrize("family,impl", [
    ("ssm", "gather"), ("vlm", "gather"), ("vlm", "fused")])
def test_teacher_forced_logits_match_reference(ref_traces, family, impl):
    tr = ref_traces[family]
    cfg = SMOKE[FAMILY_REPRESENTATIVE[family]].scaled(dtype="float32")
    model = model_zoo.build(cfg)
    params = params_from_jax(tr["params"], cfg, device="cpu")
    cache = model.init_cache(1, 48, dtype=torch.float32,
                             paged=PagedLayout(7, 8), device="cpu")
    cache = pc.push_page_table(cache, np.arange(1, 7, dtype=np.int32)[None])
    got = teacher_forced_logits(model, params, tr["prompt"], tr["forced"],
                                cache=cache, paged_impl=impl).numpy()
    np.testing.assert_allclose(got, tr["logits"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["ssm", "vlm"])
def test_launchers_take_the_family_archs(family, tmp_path, capsys):
    """Both launchers end to end with ``--arch phi-3-vision-4.2b`` and
    ``--arch xlstm-125m --smoke`` on the CPU."""
    arch = FAMILY_REPRESENTATIVE[family]
    rep, ppl_fp, ppl_vq = launch_quantize.main([
        "--arch", arch, "--smoke", "--device", "cpu", "--sequences", "4",
        "--seq-len", "32", "--em-iters", "2", "--update-iters", "1",
        "--out", str(tmp_path)])
    assert np.isfinite(ppl_fp) and np.isfinite(ppl_vq)
    dense = [k for k, e in rep.per_target.items()
             if e["action"] == "keep_dense"]
    assert bool(dense) == (family == "ssm")
    eng, reqs = launch_serve.main([
        "--arch", arch, "--smoke", "--device", "cpu", "--vq",
        "--vq-matmul-impl", "fused", "--paged-attn-impl", "fused",
        "--requests", "2", "--max-new", "3"])
    assert all(len(r.out_tokens) == 3 for r in reqs)
    out = capsys.readouterr().out
    assert f"arch={arch}" in out
    if family == "ssm":
        assert "kept dense" in out
