"""Paged-KV continuous-batching serving engine (port of
``repro/serve/engine.py``).

The KV cache is a pool of fixed-size blocks shared by all ``max_batch``
slots, one pool per layer (``models/attention.PagedKVCache``). Host policy
lives in ``serve/scheduler.py`` (FCFS admission, chunked prefill, preempt
youngest on pool exhaustion) and ``serve/paged_cache.py`` (allocator, slot
views, page tables). Each ``step`` is one tick: admissions, one prefill
chunk per prefilling slot (a B=1 view, pinned to the gather read path),
then one batched decode over every decoding slot with a per-slot position
vector, so interleaved greedy decode is token-identical to serving each
request alone. The reference compiles its tick functions with ``jax.jit``
and donates the cache; here they run eagerly and write pages in place.

Slot-resident state (the recurrent families' state, the audio family's
cross K/V, which the engine never fills: requests carry no frames, as the
reference's) is reset from a B=1 template on admission and kept by the
slots that do not decode in a tick; a cache that holds any keeps the
prefix cache off.

Pages may be stored low-bit (``kv_cache_bits`` 8/4, or "vq2" against
codebooks calibrated once at construction and then frozen). Every engine
owns an ``obs.Telemetry`` that records the request lifecycle (TTFT, ITL),
per-tick gauges and spans.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
the params must already be on that device.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    KVQuantSpec, PagedLayout, check_paged_impl)
from repro_torch.models.model_zoo import Model
from repro_torch.obs import COUNT_BUCKETS, Telemetry
from repro_torch.serve import paged_cache as pc
from repro_torch.serve import sampling
from repro_torch.serve.scheduler import CapacityError, Scheduler, Sequence
from repro_torch.serve.serve_step import make_paged_decode, make_slot_prefill


@dataclasses.dataclass
class Request:
    rid: int | str
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    n: int = 1                   # parallel samples: n-1 forked children
                                 # share the prompt's KV blocks
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: str | None = None     # set when rejected (CapacityError)
    forks: list = dataclasses.field(default_factory=list)
                                 # the n-1 child Requests (rid "rid.i")


def calibrate_vq_codebooks(model: Model, params, cache, *,
                           page_size: int = 16, calib_len: int = 64,
                           em_iters: int = 25):
    """Fit frozen vq2 KV-page codebooks from a short calibration capture
    and return ``cache`` with its codebook leaves replaced.

    One sequence of the deterministic calibration corpus runs through a
    small f32 passthrough paged cache with an identity page table; the K/V
    rows each layer wrote are amax-normalized per (row, kv head) — the
    normalization of the write path — split into d=2 vectors and EM-fit per
    (pool, kv head) with core/codebook.init_codebook (weights 1, i.e.
    k-means from the Mahalanobis seed; on CUDA its E-step is the
    ``vq_assign`` kernel). Deterministic, so two engines over the same
    model freeze the same codebooks."""
    from repro_torch.core.codebook import init_codebook
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.kernels import kv_quant as kvq

    dev = params["embed"].device
    npc = -(-calib_len // page_size)
    cap = model.init_cache(1, npc * page_size, dtype=torch.float32,
                           paged=PagedLayout(npc + 1, page_size), device=dev)
    cap = pc.push_page_table(cap, np.arange(1, npc + 1, dtype=np.int32)[None])
    toks = calibration_tokens(model.cfg.vocab_size, n_sequences=1,
                              seq_len=calib_len, device=dev)
    with torch.no_grad():
        _, cap, _ = model.forward(
            params, {"tokens": toks}, cache=cap,
            pos=torch.zeros((1,), dtype=torch.long, device=dev),
            paged_impl="gather")

    def fit(pool):
        # blocks 1..npc hold the capture's first calib_len rows in order
        nb, ps, KV, hd = pool.shape
        rows = pool[1:].reshape((nb - 1) * ps, KV, hd)[:calib_len]
        x = rows.transpose(0, 1)                       # (KV, calib_len, hd)
        amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        xn = x / torch.where(amax > 0, amax, torch.ones_like(amax))
        X = xn.reshape(KV, -1, kvq.VQ_D).contiguous()
        return init_codebook(X, torch.ones_like(X), k=kvq.VQ_K,
                             iters=em_iters).to(torch.float32).contiguous()

    return pc.map_paged(lambda dst, src: dst._replace(
        k_codebook=fit(src.k), v_codebook=fit(src.v)), cache, cap)


class Engine:
    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_len: int = 512, eos_id: int | None = None, seed: int = 0,
                 page_size: int = 16, num_blocks: int | None = None,
                 pool_bytes: int | None = None,
                 prefill_chunk: int = 64, paged_attn_impl: str = "gather",
                 kv_cache_bits: int = 16, vq_matmul_impl: str = "gather",
                 prefix_cache: bool = False,
                 telemetry: Telemetry | None = None, device=None):
        """``paged_attn_impl`` selects the decode attention read over the
        paged pool: "gather" (the materialized logical view, the reference
        default) or "fused" (``kernels/paged_attention``: the CUDA kernel
        on a CUDA engine, its plain version on a CPU one). The reference's
        "xla" and "pallas" both collapse into "fused". Prefill always
        reads through gather.

        ``kv_cache_bits``: 16 = passthrough f32 pages, 8/4 = int8/packed
        int4 code pages with per-row per-kv-head scales, "vq2" = 4-bit
        codebook indices over d=2 head-dim vectors; for "vq2" the
        codebooks are calibrated here once (calibrate_vq_codebooks) and
        frozen before any serving write.

        ``pool_bytes`` sizes the pool by a per-layer byte budget instead of
        ``num_blocks`` (not both).

        ``vq_matmul_impl`` for VQ-packed weights: "gather" (per-layer
        dense dequantization, core/vq_linear.dequant_tree) or "fused"
        (prepare_fused_tree once here, then every matmul in the
        ``vq_dequant_matmul`` kernel on CUDA, its plain version on the
        CPU); the reference's "xla" and "pallas" are both "fused".

        ``prefix_cache=True`` attaches a radix prefix cache over full pages
        (serve/prefix_cache.py). ``telemetry``: the obs.Telemetry sink (a
        private enabled one when None). ``device``: ``cuda`` unless
        ``"cpu"`` is passed; the params must live there."""
        from repro_torch.core import vq_linear as vql_mod

        self.device = resolve_device(device)
        leaf = params["embed"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine on "
                             f"{self.device}")
        self.paged_attn_impl = check_paged_impl(paged_attn_impl)
        params = vql_mod.retag(params, vq_matmul_impl)
        self.vq_matmul_impl = vq_matmul_impl
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        kv_spec = KVQuantSpec.of(kv_cache_bits)
        self.kv_cache_bits = kv_cache_bits

        dtype = torch.float32
        n_pages = -(-max_len // page_size)
        if pool_bytes is not None:
            if num_blocks is not None:
                raise ValueError("pass num_blocks or pool_bytes, not both")
            num_blocks = pc.pool_blocks_for_bytes(
                pool_bytes, model.cfg, page_size, kv_spec.fmt, dtype)
        elif num_blocks is None:
            # every slot at full depth (+ scratch); a smaller pool
            # oversubscribes and exercises preemption
            num_blocks = max_batch * n_pages + 1
        self.layout = PagedLayout(num_blocks=num_blocks,
                                  page_size=page_size, kv=kv_spec)
        self.n_pages = n_pages

        self.cache = model.init_cache(max_batch, max_len, dtype=dtype,
                                      paged=self.layout, device=self.device)
        if kv_spec.vq:
            # calibrate-then-freeze, before any serving write
            self.cache = calibrate_vq_codebooks(
                model, params, self.cache, page_size=page_size,
                calib_len=min(64, max_len))
        self.axes = pc.batch_axes(model, max_batch, max_len, dtype,
                                  self.layout)
        # B=1 template for resetting a slot's state on admission
        self._slot_template = model.init_cache(
            1, max_len, dtype=dtype, paged=PagedLayout(2, page_size,
                                                       kv=kv_spec),
            device=self.device)

        self.telemetry = telemetry if telemetry is not None else Telemetry()
        if self.telemetry.spans._step_ref is None:
            self.telemetry.spans._step_ref = lambda: self.ticks
        self._spans = self.telemetry.spans
        reg = self.telemetry.registry
        self._m_queue = reg.gauge("serve.queue_depth")
        self._m_used = reg.gauge("serve.pool_used_blocks")
        self._m_free = reg.gauge("serve.pool_free_blocks")
        self._m_occ = reg.gauge("serve.pool_occupancy")
        self._m_slots = reg.gauge("serve.slots_active")
        self._m_dec_batch = reg.histogram("serve.decode_batch",
                                          COUNT_BUCKETS)
        self._m_chunk = reg.histogram("serve.prefill_chunk_tokens",
                                      COUNT_BUCKETS)
        self._m_dev_hit = reg.counter("serve.dev_cache_hits")
        self._m_dev_miss = reg.counter("serve.dev_cache_misses")
        self._m_shared = reg.gauge("serve.shared_blocks")
        self._m_cached = reg.gauge("serve.prefix_cached_blocks")
        self._m_pfx_miss = reg.counter("serve.prefix_misses")

        allocator = pc.BlockAllocator(num_blocks)
        # any cache leaf outside the PagedKVCache pools would be per-slot
        # state a page-table share cannot replay: keep prefix sharing off
        self.prefix_cache = None
        if prefix_cache and not pc.has_slot_state(self.cache):
            from repro_torch.serve.prefix_cache import PrefixCache
            self.prefix_cache = PrefixCache(allocator, page_size)
        self._pending_forks: dict = {}   # parent rid -> child Requests

        self.scheduler = Scheduler(
            max_batch=max_batch, max_len=max_len, page_size=page_size,
            allocator=allocator, prefix_cache=self.prefix_cache,
            prefill_chunk=prefill_chunk,
            # attention-only families pad the final chunk to its
            # power-of-two bucket (masked out exactly)
            pad_prefill=model.cfg.family not in ("ssm", "hybrid"),
            on_submit=lambda req: self.telemetry.on_enqueue(
                req.rid, len(req.prompt), req.max_new_tokens))
        self._decode_fn = make_paged_decode(model, self.axes,
                                            paged_impl=self.paged_attn_impl)
        self._prefill_fn = make_slot_prefill(model, self.axes)

        self.last_tok = np.zeros(max_batch, np.int32)
        self.ticks = 0
        self._decode_ticks = 0
        self._tokens = 0
        self._prefill_chunks = 0
        self._preemptions = 0
        self._wall_s = 0.0
        # host->device upload cache for slow-changing tick inputs (page
        # tables, keep masks, temperatures)
        self._dev_cache: dict = {}

    def _dev(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """Device copy of ``arr``, uploaded again only when the host value
        changed since the last tick."""
        ent = self._dev_cache.get(name)
        if ent is None or not np.array_equal(ent[0], arr):
            self._m_dev_miss.inc()
            host = arr.copy()
            ent = (host, torch.as_tensor(host, device=self.device))
            self._dev_cache[name] = ent
        else:
            self._m_dev_hit.inc()
        return ent[1]

    @property
    def stats(self) -> dict:
        """Live counters, current whether driven by ``run`` or ``step``."""
        alloc = self.scheduler.allocator
        pfx = self.prefix_cache
        return {"wall_s": self._wall_s, "decode_ticks": self._decode_ticks,
                "tokens": self._tokens, "ticks": self.ticks,
                "prefill_chunks": self._prefill_chunks,
                "preemptions": self._preemptions,
                "queue_depth": len(self.scheduler.queue),
                "pool_used_blocks": alloc.used_blocks,
                "pool_free_blocks": alloc.free_blocks,
                "shared_blocks": alloc.shared_blocks,
                "prefix_hits": pfx.hits if pfx else 0,
                "prefix_misses": pfx.misses if pfx else 0,
                "prefix_hit_tokens": pfx.hit_tokens if pfx else 0,
                "prefix_evictions": pfx.evictions if pfx else 0,
                "prefix_cached_blocks": pfx.cached_blocks if pfx else 0}

    def drain_request_records(self):
        """Return-and-clear finished per-request lifecycle records
        (obs.RequestRecord: TTFT, mean ITL, tokens, preemptions, finish
        reason)."""
        return self.telemetry.drain_finished()

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request):
        """Queue a request. Raises CapacityError (after marking the request
        and emitting ``reject``) if it can never fit. ``req.n > 1`` creates
        n-1 forked children (rid "rid.i"), held back until the parent's
        prefill completes so that they share its full prompt pages."""
        try:
            self.scheduler.submit(req)
        except CapacityError as e:
            req.error = str(e)
            req.done = True
            self.telemetry.on_reject(req.rid, str(e))
            raise
        if req.n > 1:
            children = []
            for i in range(1, req.n):
                child = Request(rid=f"{req.rid}.{i}", prompt=req.prompt,
                                max_new_tokens=req.max_new_tokens,
                                temperature=req.temperature)
                children.append(child)
                self.telemetry.on_enqueue(child.rid, len(child.prompt),
                                          child.max_new_tokens)
            req.forks = children
            self._pending_forks[req.rid] = children

    def admit(self, req: Request) -> bool:
        """Place a request into a free slot (its prompt streams in during
        ``step``). Raises CapacityError if it can never fit; False when no
        slot or blocks are free right now."""
        try:
            self.scheduler.validate(req)
        except CapacityError as e:
            req.error = str(e)
            req.done = True
            self.telemetry.on_reject(req.rid, str(e))
            raise
        seq = self.scheduler.try_place(req)
        if seq is None:
            return False
        self._admit_seq(seq)
        return True

    def _admit_seq(self, seq: Sequence):
        self.telemetry.on_admit(seq.req.rid, seq.slot)
        if seq.shared_tokens:
            self.telemetry.on_prefix_hit(
                seq.req.rid, seq.shared_tokens // self.scheduler.page_size,
                seq.shared_tokens)
        elif self.prefix_cache is not None:
            self._m_pfx_miss.inc()
        self._reset_slot(seq)

    def _reset_slot(self, seq: Sequence):
        self.cache = pc.slot_merge(self.cache, self._slot_template,
                                   self.axes, seq.slot, shared=False)

    def _page_table(self, phases: tuple) -> np.ndarray:
        """Host page table with rows only for slots in ``phases``; every
        other entry points at the scratch block."""
        t = np.zeros((self.max_batch, self.n_pages), np.int32)
        for s in self.scheduler.active():
            if s.phase in phases:
                t[s.slot, : len(s.pages)] = s.pages
        return t

    # -- one tick ----------------------------------------------------------

    def step(self):
        t0 = time.perf_counter()
        for seq in self.scheduler.admit_from_queue():
            self._admit_seq(seq)
        prefilling = sorted(
            (s for s in self.scheduler.active() if s.phase == "prefill"),
            key=lambda s: s.order)
        done = []
        if prefilling:
            table = self._page_table(("prefill", "decode"))
            with self._spans.span("prefill"):
                for seq in prefilling:
                    last_logits = self._prefill_chunk(seq, table)
                    if last_logits is not None:
                        done.append((seq, last_logits))
        if done:
            # one batched draw for every prompt completed this tick
            with self._spans.span("prompt_sample"):
                temps = torch.tensor([s.req.temperature for s, _ in done],
                                     dtype=torch.float32, device=self.device)
                toks = sampling.sample(
                    self.gen, torch.stack([l for _, l in done]),
                    temperature=temps).cpu().numpy()
            for (seq, _), t in zip(done, toks):
                seq.phase = "decode"
                self._on_prompt_done(seq)
                self._emit(seq, int(t))
        self._decode_tick()
        self.ticks += 1
        alloc = self.scheduler.allocator
        used = alloc.used_blocks
        self._m_queue.set(len(self.scheduler.queue))
        self._m_used.set(used)
        self._m_free.set(alloc.free_blocks)
        self._m_occ.set(used / alloc.capacity if alloc.capacity else 0.0)
        self._m_slots.set(len(self.scheduler.active()))
        self._m_shared.set(alloc.shared_blocks)
        if self.prefix_cache is not None:
            self._m_cached.set(self.prefix_cache.cached_blocks)
        self._wall_s += time.perf_counter() - t0

    def _on_prompt_done(self, seq: Sequence):
        """Prefill completed: register the prompt's full pages in the prefix
        cache (before the first ``_emit``, so its references are taken even
        if the request finishes on that token) and release held forks to
        the queue front."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(seq.req.prompt, seq.pages)
        children = self._pending_forks.pop(seq.req.rid, None)
        if children:
            for child in reversed(children):
                self.scheduler.queue.appendleft(child)

    def _prefill_chunk(self, seq: Sequence, table: np.ndarray):
        """Feed the next chunk; returns the (V,) next-token logits when the
        prompt is complete, else None."""
        size, real = self.scheduler.prefill_chunk_len(seq)
        self._m_chunk.observe(real)
        start = seq.pos
        chunk = np.zeros(size, np.int64)
        chunk[:real] = np.asarray(seq.req.prompt[start:start + real])
        last_logits, self.cache = self._prefill_fn(
            self.params, torch.as_tensor(chunk[None], device=self.device),
            self.cache, seq.slot, start, real - 1,
            self._dev("table_pf", table))
        seq.pos += real
        self._prefill_chunks += 1
        return last_logits if seq.pos == seq.prompt_len else None

    def _emit(self, seq: Sequence, tok: int):
        req = seq.req
        req.out_tokens.append(tok)
        self.last_tok[seq.slot] = tok
        self._tokens += 1
        self.telemetry.on_token(req.rid)
        eos = self.eos_id is not None and tok == self.eos_id
        if len(req.out_tokens) >= req.max_new_tokens or eos:
            req.done = True
            self.scheduler.finish(seq)
            self.telemetry.on_finish(req.rid, "eos" if eos else "length")

    def _decode_tick(self):
        decoding = [s for s in self.scheduler.active()
                    if s.phase == "decode"]
        # a block for every decoding slot's write position, preempting
        # youngest-first when the pool runs dry
        for s in sorted(decoding, key=lambda s: s.order):
            if self.scheduler.running[s.slot] is not s:
                continue  # already preempted this tick
            for victim in self.scheduler.ensure_block(s):
                self._on_preempt(victim)
        decoding = [s for s in self.scheduler.active()
                    if s.phase == "decode"]
        if not decoding:
            return
        self._m_dec_batch.observe(len(decoding))
        with self._spans.span("decode_tick"):
            with self._spans.span("host_prep"):
                pos = np.zeros(self.max_batch, np.int64)
                temps = np.zeros(self.max_batch, np.float32)
                # slots mid-prefill decode on garbage this tick: their
                # table rows point at scratch, their state is kept
                keep = np.zeros(self.max_batch, bool)
                for s in self.scheduler.active():
                    if s.phase == "decode":
                        pos[s.slot] = s.pos
                        temps[s.slot] = s.req.temperature
                    else:
                        keep[s.slot] = True
                toks = torch.as_tensor(self.last_tok[:, None].astype(np.int64),
                                       device=self.device)
                args = (self.params, toks, self.cache,
                        torch.as_tensor(pos, device=self.device),
                        self._dev("table_dec", self._page_table(("decode",))),
                        self._dev("keep", keep), self.gen,
                        self._dev("temps", temps))
            with self._spans.span("device"):
                # closes after the (B,) token download, the one sync point
                # of the tick, so this span accounts device time
                nxt, self.cache = self._decode_fn(*args)
                nxt = nxt.cpu().numpy()
        for s in decoding:
            s.pos += 1
            self._emit(s, int(nxt[s.slot]))
        self._decode_ticks += 1

    def _on_preempt(self, victim: Sequence):
        self._preemptions += 1
        self._tokens -= len(victim.req.out_tokens)
        self.telemetry.on_preempt(victim.req.rid)
        victim.req.out_tokens.clear()
        victim.req.done = False

    # -- teardown ----------------------------------------------------------

    def close(self):
        """Release engine-held pool state: the prefix cache returns its
        block references and zeroes its counters. Idempotent."""
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self._dev_cache.clear()

    # -- driver ------------------------------------------------------------

    def run(self, requests: list[Request], max_ticks: int = 10_000):
        """Drive all requests to completion; returns them. Requests that
        can never fit are rejected gracefully (``req.error`` set)."""
        for req in requests:
            try:
                self.submit(req)
            except CapacityError:
                pass  # submit marked the request + emitted the reject
        self.telemetry.start_trace()
        try:
            while self.scheduler.has_work() and self.ticks < max_ticks:
                self.step()
        finally:
            self.telemetry.stop_trace()
            self.telemetry.events.flush()
        return requests
