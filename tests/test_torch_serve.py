"""Port parity for the paged serving engine on the SKILL smoke config (f32,
2 layers, d_model 64).

* Host decisions, exact against the reference on the same request trace:
  ``BlockAllocator``, ``Scheduler`` (admission, chunk plan, preemption)
  and ``PrefixCache`` (lookup, insert, LRU eviction) are driven through one
  engine-shaped loop in both packages and their decision logs compared.
* Token identities inside the port (mirroring the named classes of
  ``tests/serve/test_paged_serving.py``): interleaved vs solo, "fused" vs
  "gather", preemption replay, prefix-shared vs solo, forks with n > 1,
  fused vs gather VQ matmuls, the dense-cache decode anchor.
* Across frameworks: teacher-forced per-step logits of the paged decode
  path at kv 16 and vq2, weights carried over with ``params_from_jax`` and
  the reference's frozen vq2 codebooks with ``paged_cache_from_jax``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as JSMOKE
from repro.models import model_zoo as jzoo
from repro.models.attention import KVQuantSpec as JKVQuantSpec
from repro.models.attention import PagedLayout as JPagedLayout
from repro.serve import paged_cache as jpc
from repro.serve import prefix_cache as jprefix
from repro.serve import scheduler as jsched
from repro.data.calibration import calibration_tokens as jcalib_tokens
from repro.serve.engine import calibrate_vq_codebooks as jcalibrate

from repro_torch.configs import SMOKE
from repro_torch.convert import paged_cache_from_jax, params_from_jax
from repro_torch.core.bpv import VQConfig
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe
from repro_torch.models import attention, model_zoo
from repro_torch.models.attention import PagedLayout
from repro_torch.obs import dispatch
from repro_torch.serve import paged_cache as pc
from repro_torch.serve import prefix_cache as prefix
from repro_torch.serve import sampling
from repro_torch.serve import scheduler as sched
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.serve_step import (
    make_decode, make_prefill, teacher_forced_logits)

SMOKE_KW = dict(dtype="float32", n_layers=2, d_model=64, vocab_size=256,
                max_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dense():
    cfg = SMOKE["llama2-7b"].scaled(**SMOKE_KW)
    model = model_zoo.build(cfg)
    return model, model.init_params(seed=0, device="cpu")


@pytest.fixture(scope="module")
def packed(dense):
    model, params = dense
    calib = torch.randint(0, 256, (8, 32),
                          generator=torch.Generator().manual_seed(0))
    recipe = QuantRecipe.uniform(VQConfig(d=2, bits_per_dim=2,
                                          group_size=1024, em_iters=4,
                                          codebook_update_iters=2))
    return quantize_model(model, params, calib, recipe=recipe, pack=True)[0]


def greedy(prompts, n=6, rid0=0):
    return [Request(rid=rid0 + i, prompt=p, max_new_tokens=n)
            for i, p in enumerate(prompts)]


def serve(model, params, prompts, n=6, rid0=0, **kw):
    kw = {"max_batch": 2, "max_len": 64, "page_size": 8, **kw}
    eng = Engine(model, params, device="cpu", **kw)
    reqs = greedy(prompts, n, rid0)
    eng.run(reqs)
    return eng, [r.out_tokens for r in reqs]


def prompts_of(seed, sizes, V=255):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=s) for s in sizes]


def shared_prompts(V=254, n=4, header=40, seed=11):
    rng = np.random.RandomState(seed)
    head = rng.randint(0, V, size=header)
    return [np.concatenate([head, rng.randint(0, V, size=3 + i)])
            for i in range(n)]


# ---------------------------------------------------------------------------
# host decisions, exact against the reference
# ---------------------------------------------------------------------------

def drive(S, A, P, trace, *, max_batch, max_len, page_size, num_blocks,
          prefix_on, chunk=16):
    """The engine's host loop without a model: admissions, one chunk per
    prefilling slot, block supply with preemption, one token per decoding
    slot per tick. Returns the decision log."""
    alloc = A.BlockAllocator(num_blocks)
    cache = P.PrefixCache(alloc, page_size) if prefix_on else None
    s = S.Scheduler(max_batch=max_batch, max_len=max_len,
                    page_size=page_size, allocator=alloc,
                    prefill_chunk=chunk, pad_prefill=True,
                    prefix_cache=cache)
    log, made = [], {}
    for rid, (prompt, n_new) in enumerate(trace):
        req = types.SimpleNamespace(rid=rid, prompt=prompt,
                                    max_new_tokens=n_new)
        try:
            s.submit(req)
        except S.CapacityError as e:
            log.append(("reject", rid, str(e)))
    ticks = 0
    while s.has_work() and ticks < 400:
        ticks += 1
        for seq in s.admit_from_queue():
            made[seq.req.rid] = 0
            log.append(("admit", seq.req.rid, seq.slot, list(seq.pages),
                        seq.pos))
        for seq in sorted((q for q in s.active() if q.phase == "prefill"),
                          key=lambda q: q.order):
            size, real = s.prefill_chunk_len(seq)
            log.append(("chunk", seq.req.rid, seq.pos, size, real))
            seq.pos += real
            if seq.pos == seq.prompt_len:
                seq.phase = "decode"
                if cache is not None:
                    cache.insert(seq.req.prompt, seq.pages)
                made[seq.req.rid] += 1
                if made[seq.req.rid] >= seq.req.max_new_tokens:
                    s.finish(seq)
        for seq in sorted((q for q in s.active() if q.phase == "decode"),
                          key=lambda q: q.order):
            if s.running[seq.slot] is not seq:
                continue
            for v in s.ensure_block(seq):
                log.append(("preempt", v.req.rid))
                made[v.req.rid] = 0
        for seq in [q for q in s.active() if q.phase == "decode"]:
            seq.pos += 1
            made[seq.req.rid] += 1
            if made[seq.req.rid] >= seq.req.max_new_tokens:
                s.finish(seq)
                log.append(("finish", seq.req.rid))
        log.append(("tick", alloc.free_blocks, alloc.used_blocks,
                    alloc.shared_blocks, [r.rid for r in s.queue],
                    None if cache is None else (
                        cache.hits, cache.misses, cache.hit_tokens,
                        cache.evictions, sorted(cache.blocks()))))
    return log


TRACES = {
    # mixed lengths, one that can never fit, a pool tight enough to preempt
    "preempt": (dict(max_batch=3, max_len=64, page_size=4, num_blocks=10,
                     prefix_on=False),
                [(p, n) for p, n in zip(prompts_of(0, (10, 14, 7, 30, 3, 50)),
                                        (8, 12, 5, 20, 9, 30))]),
    # shared headers: hits, LRU evictions under pressure, preempted sharers
    "prefix": (dict(max_batch=2, max_len=96, page_size=8, num_blocks=13,
                    prefix_on=True),
               [(p, 8) for p in shared_prompts(n=6, header=32)]
               + [(p, 5) for p in shared_prompts(n=3, header=24, seed=3)]),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_scheduler_decisions_match_reference(name):
    kw, trace = TRACES[name]
    want = drive(jsched, jpc, jprefix, trace, **kw)
    got = drive(sched, pc, prefix, trace, **kw)
    assert got == want
    kinds = {e[0] for e in want}
    assert {"admit", "chunk", "finish"} <= kinds
    if name == "preempt":
        assert {"preempt", "reject"} <= kinds


def test_block_allocator_matches_reference():
    """A random alloc/share/release sequence: same results, same errors,
    same free-list order."""
    rng = np.random.RandomState(5)
    ja, ta = jpc.BlockAllocator(12), pc.BlockAllocator(12)
    held = []
    for _ in range(300):
        op = rng.randint(3)
        if op == 0:
            n = int(rng.randint(0, 4))
            got = ta.alloc(n)
            assert got == ja.alloc(n)
            held += got or []
        elif op == 1 and held:
            ids = [held[rng.randint(len(held))]]
            ta.share(ids)
            ja.share(ids)
            held += ids
        else:
            if held and rng.rand() < 0.8:
                ids = [held.pop(rng.randint(len(held)))]
            else:  # an id nobody holds: out of range, scratch, or free
                ids = [int(rng.choice([b for b in range(-1, 14)
                                       if b not in held]))]
            errs = []
            for a in (ja, ta):
                try:
                    a.release(ids)
                    errs.append(None)
                except ValueError:
                    errs.append("ValueError")
            assert errs[0] == errs[1]
        assert ta._free == ja._free and ta._ref == ja._ref
        assert (ta.free_blocks, ta.used_blocks, ta.shared_blocks) == (
            ja.free_blocks, ja.used_blocks, ja.shared_blocks)


def test_chunk_plan_and_capacity_errors_match_reference():
    for rem in range(1, 200):
        for mc in (1, 8, 64):
            assert sched.next_chunk_len(rem, mc) == jsched.next_chunk_len(
                rem, mc)
    with pytest.raises(ValueError):
        sched.Scheduler(max_batch=1, max_len=8, page_size=4,
                        allocator=pc.BlockAllocator(3), prefill_chunk=12)


def test_prefix_cache_lookup_insert_evict_match_reference():
    ps = 4
    ja, ta = jpc.BlockAllocator(40), pc.BlockAllocator(40)
    jc, tc = jprefix.PrefixCache(ja, ps), prefix.PrefixCache(ta, ps)
    rng = np.random.RandomState(2)
    heads = [rng.randint(0, 9, size=12) for _ in range(3)]
    for step in range(60):
        toks = np.concatenate([heads[rng.randint(3)],
                               rng.randint(0, 9, size=rng.randint(1, 9))])
        got, want = tc.lookup(toks), jc.lookup(toks)
        assert got == want
        need = -(-len(toks) // ps) - len(got)
        pages = got + (ta.alloc(need) or [])
        jpages = want + (ja.alloc(need) or [])
        assert pages == jpages
        tc.insert(toks, pages)
        jc.insert(toks, jpages)
        ta.release(pages)
        ja.release(jpages)
        if step % 7 == 0:
            assert tc.evict_one() == jc.evict_one()
        assert tc.blocks() == jc.blocks()
        assert (tc.hits, tc.misses, tc.hit_tokens, tc.evictions) == (
            jc.hits, jc.misses, jc.hit_tokens, jc.evictions)
    tc.clear()
    jc.clear()
    assert ta.free_blocks == ja.free_blocks == 39


# ---------------------------------------------------------------------------
# token identities inside the port
# ---------------------------------------------------------------------------

class TestMixedLengthContinuousBatching:
    @pytest.mark.parametrize("kv_bits,impl", [
        (16, "gather"), (16, "fused"), (8, "fused"), (4, "fused"),
        ("vq2", "fused")])
    def test_interleaved_matches_solo(self, dense, kv_bits, impl):
        model, params = dense
        prompts = prompts_of(1, (5, 9, 3, 12))
        _, toks = serve(model, params, prompts, paged_attn_impl=impl,
                        kv_cache_bits=kv_bits)
        assert all(len(t) == 6 for t in toks)
        for i, p in enumerate(prompts):
            _, solo = serve(model, params, [p], rid0=100 + i,
                            paged_attn_impl=impl, kv_cache_bits=kv_bits)
            assert solo[0] == toks[i], (kv_bits, impl, i)

    @pytest.mark.parametrize("kv_bits", [16, 8, "vq2"])
    def test_fused_matches_gather(self, dense, kv_bits):
        model, params = dense
        prompts = prompts_of(2, (5, 9, 3, 12))
        counts = dispatch.snapshot_dispatch_counters()["paged"]
        eng, fused = serve(model, params, prompts, paged_attn_impl="fused",
                           kv_cache_bits=kv_bits)
        after = dispatch.snapshot_dispatch_counters()["paged"]
        # every decode tick's layers, and nothing else, took the fused read
        assert after["fused"] - counts["fused"] == (
            eng.stats["decode_ticks"] * model.cfg.n_layers)
        _, gather = serve(model, params, prompts, paged_attn_impl="gather",
                          kv_cache_bits=kv_bits)
        assert fused == gather

    def test_width1_prefill_chunk_keeps_gather_path(self, dense):
        model, params = dense
        before = dispatch.snapshot_dispatch_counters()["paged"]
        eng = Engine(model, params, max_batch=1, max_len=64, page_size=8,
                     prefill_chunk=16, paged_attn_impl="fused", device="cpu")
        req = greedy([np.random.RandomState(7).randint(0, 255, 17)], 3)[0]
        eng.run([req])
        after = dispatch.snapshot_dispatch_counters()["paged"]
        assert len(req.out_tokens) == 3
        assert after["fused"] - before["fused"] == 2 * model.cfg.n_layers
        # 17 = 16 + a width-1 tail chunk: both prefill chunks gathered
        assert after["gather"] - before["gather"] == 2 * model.cfg.n_layers

    def test_padded_chunk_overhanging_max_len_matches_dense_anchor(self,
                                                                   dense):
        model, params = dense
        prompt = np.random.RandomState(3).randint(0, 255, size=40)
        eng = Engine(model, params, max_batch=1, max_len=48, page_size=16,
                     paged_attn_impl="fused", device="cpu")
        req = greedy([prompt])[0]
        eng.run([req])
        assert req.out_tokens == _dense_decode(model, params, prompt, 6, 48)

    def test_dense_reference_decode_anchor(self, dense):
        model, params = dense
        prompt = np.random.RandomState(2).randint(0, 255, size=7)
        eng = Engine(model, params, max_batch=3, max_len=48, page_size=4,
                     device="cpu")
        req = greedy([prompt])[0]
        eng.run([req])
        assert req.out_tokens == _dense_decode(model, params, prompt, 6, 48)

    def test_empty_prompt_and_capacity_rejected(self, dense):
        model, params = dense
        eng = Engine(model, params, max_batch=2, max_len=48, device="cpu")
        with pytest.raises(sched.CapacityError):
            eng.admit(Request(rid=0, prompt=np.zeros(0, np.int32)))
        big = Request(rid=1, prompt=np.zeros(40, np.int32),
                      max_new_tokens=20)
        eng.run([big])
        assert big.done and big.error and not big.out_tokens


def _dense_decode(model, params, prompt, n, max_len):
    """Greedy decode through the dense KVCache path (the anchor)."""
    cache = model.init_cache(1, max_len, dtype=torch.float32, device="cpu")
    logits, cache = make_prefill(model)(
        params, {"tokens": torch.as_tensor(prompt)[None]}, cache)
    decode = make_decode(model)
    tok = int(torch.argmax(logits[0, len(prompt) - 1]))
    out, pos = [tok], len(prompt)
    for _ in range(n - 1):
        logits, cache = decode(params, torch.tensor([[tok]]), cache, pos)
        tok = int(torch.argmax(logits[0, -1]))
        out.append(tok)
        pos += 1
    return out


class TestQuantizedKVPages:
    @pytest.mark.parametrize("bits", [16, 8, 4, "vq2"])
    def test_pool_sizing_matches_reference(self, dense, bits):
        """Byte-denominated pool sizing on the same config and budget:
        block counts and pool bytes equal the reference's."""
        model, _ = dense
        jcfg = JSMOKE["llama2-7b"].scaled(**SMOKE_KW)
        for budget in (1 << 18, 1 << 20):
            want = jpc.pool_blocks_for_bytes(budget, jcfg, 8, bits,
                                             jnp.float32)
            got = pc.pool_blocks_for_bytes(budget, model.cfg, 8, bits,
                                           torch.float32)
            assert got == want
            layout = PagedLayout(got, 8, attention.KVQuantSpec.of(bits))
            jlayout = JPagedLayout(want, 8, JKVQuantSpec.of(bits))
            assert pc.pool_bytes_of(model.cfg, layout, torch.float32) == \
                jpc.pool_bytes_of(jcfg, jlayout, jnp.float32)

    @pytest.mark.parametrize("bits", [8, "vq2"])
    def test_engine_pool_bytes_ctor(self, dense, bits):
        from repro_torch.kernels import kv_quant

        model, params = dense
        cfg = model.cfg
        budget = 40 * kv_quant.page_bytes(8, cfg.n_kv_heads, cfg.hd, 16,
                                          dtype_bytes=4)
        fp = Engine(model, params, max_batch=2, max_len=64, page_size=8,
                    pool_bytes=budget, device="cpu")
        q = Engine(model, params, max_batch=2, max_len=64, page_size=8,
                   pool_bytes=budget, kv_cache_bits=bits, device="cpu")
        assert fp.scheduler.allocator.capacity == 39
        assert q.scheduler.allocator.capacity >= (2 if bits == 8 else 7) * 39
        req = greedy([np.random.RandomState(6).randint(0, 255, size=7)],
                     4)[0]
        q.run([req])
        assert len(req.out_tokens) == 4
        with pytest.raises(ValueError, match="not both"):
            Engine(model, params, num_blocks=9, pool_bytes=budget,
                   device="cpu")

    def test_logit_drift_vs_f32_pages(self, ref_traces):
        """The reference's drift claim, rerun in the port on its weights,
        forced path and frozen vq2 codebooks: RMS logit drift per step
        (logits of ~1 RMS) against f32 pages stays under the reference's
        bars, int8 < 0.05 and vq2 < 1.0 (a broken read path decorrelates
        the logits, ~1.4)."""
        cfg = SMOKE["llama2-7b"].scaled(**SMOKE_KW)
        model = model_zoo.build(cfg)
        params = params_from_jax(ref_traces["params"], cfg, device="cpu")
        table = np.arange(1, 7, dtype=np.int32)[None]

        def trace(bits):
            if bits == "vq2":
                cache = paged_cache_from_jax(ref_traces["vq2_cache"],
                                             device="cpu")
            else:
                cache = model.init_cache(
                    1, 48, dtype=torch.float32, device="cpu",
                    paged=PagedLayout(7, 8, attention.KVQuantSpec.of(bits)))
            return teacher_forced_logits(
                model, params, ref_traces["prompt"], ref_traces["forced"],
                cache=pc.push_page_table(cache, table), paged_impl="fused")

        anchor = trace(16)
        for bits, bar in ((8, 0.05), ("vq2", 1.0)):
            drift = (trace(bits) - anchor).pow(2).mean(-1).sqrt()
            assert float(drift.max()) < bar, (bits, drift)

    def test_vq2_calibration_matches_reference(self, ref_traces,
                                               monkeypatch):
        """calibrate_vq_codebooks on the reference's weights and
        calibration tokens (the two packages' synthetic corpora differ)
        freezes the reference's codebooks: the Mahalanobis seeds are
        bitwise equal and EM on the same rows agrees to f32 rounding
        (measured 4e-7)."""
        from repro_torch.data import calibration
        from repro_torch.serve.engine import calibrate_vq_codebooks

        cfg = SMOKE["llama2-7b"].scaled(**SMOKE_KW)
        model = model_zoo.build(cfg)
        params = params_from_jax(ref_traces["params"], cfg, device="cpu")
        toks = torch.from_numpy(ref_traces["calib_tokens"]).long()
        monkeypatch.setattr(calibration, "calibration_tokens",
                            lambda *a, **k: toks)
        cache = model.init_cache(
            1, 48, dtype=torch.float32, device="cpu",
            paged=PagedLayout(7, 8, attention.KVQuantSpec.of("vq2")))
        got = calibrate_vq_codebooks(model, params, cache, page_size=8,
                                     calib_len=32)
        want = paged_cache_from_jax(ref_traces["vq2_cache"], device="cpu")
        for g, w in zip(got, want):
            for name in ("k_codebook", "v_codebook"):
                torch.testing.assert_close(getattr(g, name), getattr(w, name),
                                           rtol=1e-5, atol=1e-5)


class TestPreemption:
    @pytest.mark.parametrize("kv_bits", [16, "vq2"])
    def test_pool_exhaustion_preempts_and_replays(self, dense, kv_bits):
        model, params = dense
        prompts = prompts_of(0, (10, 14, 7))
        big, ref = serve(model, params, prompts, n=8, page_size=4,
                         paged_attn_impl="fused", kv_cache_bits=kv_bits)
        assert big.stats["preemptions"] == 0
        tight, out = serve(model, params, prompts, n=8, rid0=10,
                           page_size=4, num_blocks=9,
                           paged_attn_impl="fused", kv_cache_bits=kv_bits)
        assert tight.stats["preemptions"] > 0
        assert out == ref
        assert tight.stats["tokens"] == sum(len(t) for t in out)


class TestPrefixSharing:
    @pytest.mark.parametrize("impl", ["gather", "fused"])
    def test_shared_prefix_matches_solo(self, dense, impl):
        model, params = dense
        prompts = shared_prompts()
        warm, toks = serve(model, params, prompts, max_len=96, page_size=16,
                           paged_attn_impl=impl, prefix_cache=True)
        assert warm.stats["prefix_hits"] >= len(prompts) - 2
        assert warm.stats["prefix_hit_tokens"] >= 32
        for i, p in enumerate(prompts):
            _, solo = serve(model, params, [p], rid0=500 + i, max_len=96,
                            page_size=16, paged_attn_impl=impl)
            assert solo[0] == toks[i], (impl, i)

    def test_prefix_hit_skips_prefill_chunks(self, dense):
        model, params = dense
        prompts = shared_prompts(n=2, header=64)
        kw = dict(max_batch=1, max_len=128, page_size=16, prefill_chunk=16)
        cold, _ = serve(model, params, [prompts[1]], n=2, **kw)
        warm = Engine(model, params, prefix_cache=True, device="cpu", **kw)
        warm.run(greedy([prompts[0]], 2))
        before = warm.stats["prefill_chunks"]
        warm.run(greedy([prompts[1]], 2, rid0=1))
        warm_chunks = warm.stats["prefill_chunks"] - before
        assert warm_chunks <= cold.stats["prefill_chunks"] - 4
        hits = [e for e in warm.telemetry.events.events
                if e["event"] == "prefix_hit"]
        assert hits and hits[-1]["pages"] >= 4

    def test_preempted_sharer_releases_not_frees(self, dense):
        model, params = dense
        prompts = shared_prompts(n=3, header=32)
        ref = [serve(model, params, [p], n=8, rid0=600 + i, max_len=96)[1][0]
               for i, p in enumerate(prompts)]
        tight, out = serve(model, params, prompts, n=8, rid0=700, max_len=96,
                           num_blocks=13, prefix_cache=True,
                           paged_attn_impl="fused")
        assert out == ref
        alloc = tight.scheduler.allocator
        for b in tight.prefix_cache.blocks():
            assert alloc.refcount(b) == 1


class TestForkedSampling:
    def test_forks_greedy_identical_to_solo(self, dense):
        model, params = dense
        prompt = np.random.RandomState(12).randint(0, 254, size=40)
        _, solo = serve(model, params, [prompt], max_batch=1, max_len=96,
                        page_size=16)
        eng = Engine(model, params, max_batch=3, max_len=96, page_size=16,
                     prefix_cache=True, paged_attn_impl="fused",
                     device="cpu")
        parent = Request(rid=0, prompt=prompt, max_new_tokens=6, n=3)
        eng.run([parent])
        assert parent.done and len(parent.forks) == 2
        assert parent.out_tokens == solo[0]
        for child in parent.forks:
            assert child.done and child.out_tokens == solo[0], child.rid
        assert eng.stats["prefix_hits"] >= 2

    def test_forks_without_prefix_cache_still_serve(self, dense):
        model, params = dense
        prompt = np.random.RandomState(13).randint(0, 254, size=20)
        eng = Engine(model, params, max_batch=2, max_len=64, page_size=8,
                     device="cpu")
        parent = Request(rid=0, prompt=prompt, max_new_tokens=4, n=3)
        eng.run([parent])
        assert parent.done and all(c.done for c in parent.forks)
        for child in parent.forks:
            assert child.out_tokens == parent.out_tokens


class TestFusedVQServing:
    def test_fused_matches_gather(self, dense, packed):
        model, _ = dense
        prompts = prompts_of(8, (5, 9, 3))
        _, ref = serve(model, packed, prompts, vq_matmul_impl="gather")
        before = dispatch.snapshot_dispatch_counters()["vq"]["fused"]
        eng, got = serve(model, packed, prompts, rid0=300,
                         vq_matmul_impl="fused", paged_attn_impl="fused")
        after = dispatch.snapshot_dispatch_counters()["vq"]["fused"]
        assert after > before, "fused VQ path never ran"
        assert got == ref

    def test_interleaved_matches_solo_vq_fused(self, dense, packed):
        model, _ = dense
        prompts = prompts_of(9, (5, 9, 3, 12))
        _, toks = serve(model, packed, prompts, vq_matmul_impl="fused",
                        paged_attn_impl="fused")
        for i, p in enumerate(prompts):
            _, solo = serve(model, packed, [p], rid0=400 + i,
                            vq_matmul_impl="fused", paged_attn_impl="fused")
            assert solo[0] == toks[i], i

    def test_reference_impl_names_are_refused(self, dense, packed):
        model, params = dense
        for kw in ({"paged_attn_impl": "pallas"}, {"vq_matmul_impl": "xla"}):
            with pytest.raises(ValueError, match="fused"):
                Engine(model, packed, device="cpu", **kw)


def test_sampling_greedy_exact_and_temperature_by_distribution():
    g = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 1.0, 2.0, 0.5]]).repeat(20000, 1)
    temps = torch.zeros(20000)
    temps[::2] = 1.0
    out = sampling.sample(g, logits, temperature=temps)
    assert (out[1::2] == 2).all()  # greedy rows are the argmax
    freq = torch.bincount(out[::2].long(), minlength=4).float() / 10000
    want = torch.softmax(logits[0], -1)
    # 10,000 draws: 4 sigma of a binomial proportion is below 0.02
    assert float((freq - want).abs().max()) < 0.02
    top1 = sampling.sample(g, logits[:100], temperature=1.0, top_k=1)
    assert (top1 == 2).all()


# ---------------------------------------------------------------------------
# across frameworks: teacher-forced logits of the paged decode path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_traces():
    """The reference's per-step logits on a forced token path at kv 16 and
    vq2 (its own gather prefill + oracle decode), plus what the port needs
    to rerun it: numpy weights, the prompt, the forced tokens and the
    reference's calibrated vq2 cache."""
    cfg = JSMOKE["llama2-7b"].scaled(**SMOKE_KW)
    model = jzoo.build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    max_len, ps = 48, 8
    n_pages = max_len // ps
    prompt = np.random.RandomState(15).randint(0, 255, size=9)
    table = np.arange(1, n_pages + 1, dtype=np.int32)[None]
    out = {"params": jax.tree.map(np.asarray, params), "prompt": prompt}
    forced = None
    for bits in (16, "vq2"):
        layout = JPagedLayout(n_pages + 1, ps, JKVQuantSpec.of(bits))
        cache = model.init_cache(1, max_len, dtype=jnp.float32, paged=layout)
        if bits == "vq2":
            cache = jcalibrate(model, params, cache, page_size=ps,
                               calib_len=32)
            out["vq2_cache"] = jax.tree.map(np.asarray, cache)
        cache = jpc.push_page_table(cache, table)
        logits, cache, _ = model.forward(
            params, {"tokens": jnp.asarray(prompt, jnp.int32)[None]},
            cache=cache, pos=jnp.zeros((1,), jnp.int32))
        rows, toks, pos = [np.asarray(logits[0, -1])], [], len(prompt)
        for i in range(6):
            tok = (int(np.argmax(rows[-1])) if forced is None
                   else forced[i])
            toks.append(tok)
            logits, cache, _ = model.forward(
                params, {"tokens": jnp.asarray([[tok]], jnp.int32)},
                cache=cache, pos=jnp.full((1,), pos, jnp.int32),
                paged_impl="xla")
            rows.append(np.asarray(logits[0, -1]))
            pos += 1
        forced = toks if forced is None else forced
        out[bits] = np.stack(rows)
    out["forced"] = forced
    out["calib_tokens"] = np.asarray(jcalib_tokens(cfg.vocab_size,
                                                   n_sequences=1, seq_len=32))
    return out


@pytest.mark.parametrize("bits", [16, "vq2"])
@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_teacher_forced_logits_match_reference(ref_traces, bits, impl):
    """Per-step logits (scale ~1 RMS) of the same forced token path. kv 16:
    f32 sums in another order (measured max 2.9e-6), bar 1e-4. vq2 with
    the reference's frozen codebooks: a K/V row an ulp away could take the
    other side of a codebook near-tie, which would move logits by ~1e-2;
    on these inputs none does (measured max 3.7e-6), so the bar is 1e-3."""
    cfg = SMOKE["llama2-7b"].scaled(**SMOKE_KW)
    model = model_zoo.build(cfg)
    params = params_from_jax(ref_traces["params"], cfg, device="cpu")
    if bits == "vq2":  # the reference's calibrated, frozen codebooks
        cache = paged_cache_from_jax(ref_traces["vq2_cache"], device="cpu")
    else:
        cache = model.init_cache(1, 48, dtype=torch.float32,
                                 paged=PagedLayout(7, 8), device="cpu")
    cache = pc.push_page_table(cache, np.arange(1, 7, dtype=np.int32)[None])
    got = teacher_forced_logits(model, params, ref_traces["prompt"],
                                ref_traces["forced"], cache=cache,
                                paged_impl=impl).numpy()
    tol = 1e-4 if bits == 16 else 1e-3
    np.testing.assert_allclose(got, ref_traces[bits], rtol=tol, atol=tol)
