"""Closed-loop serving of a GPTVQ-packed model on the port's paged engine.

Each of the mix's ``clients`` keeps one request in flight: it sends its
next one when the last one's final token comes back. The engine
(``repro_torch.serve.engine.Engine``) serves every client from its own
slot (``max_batch`` = clients), and the harness drives it tick by tick
(``Engine.step``, which ends by copying the tick's tokens to the host),
timing each tick on the host's clock.

A run: the weights and the requests are made from the seed on the device
(``perfbench/models/<arch>.py``, ``perfbench/inputs.py``), the engine is
built, warm-up runs the mix's
``warmup_ticks`` ticks (all slots filled, first requests cut short so that
completions are staggered), then the window measures ``seconds``; with
``trace`` a profiler slice of ``trace_ticks`` more ticks follows it. Then
the program's state is freed and the reference judges a sample of the
requests finished in the window (``perfbench/judge.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench import inputs, judge, models, trace as tracing

now = time.perf_counter


@dataclasses.dataclass(eq=False)
class Req:
    """One request as the client saw it."""
    key: tuple                  # (client, index)
    prompt: np.ndarray
    max_new: int
    t_submit: float
    handle: object = None       # the program's Request
    times: list = dataclasses.field(default_factory=list)  # token arrivals
    t_done: float | None = None
    error: str | None = None
    preempted: int = 0
    served: list | None = None  # the served ids, kept once the engine is gone

    @property
    def tokens(self) -> list:
        if self.served is not None:
            return self.served
        return list(self.handle.out_tokens) if self.handle else []


@dataclasses.dataclass
class Tick:
    t1: float                   # when the step returned
    decode_rows: int            # tokens the tick's decode produced
    first_tokens: int           # first tokens (from prefill logits)
    prefill_tokens: int | None  # prompt tokens prefilled (program counter)
    decode_ctx: int             # rows the decoding slots attended, summed
    first_prompt_sq: int        # sum of P(P+1)/2 over prompts completed


@dataclasses.dataclass
class ServeRun:
    cfg: dict
    mix: dict
    max_batch: int
    setup_s: float
    t_open: float
    t_close: float
    reqs: list
    ticks: list                 # the window's ticks
    slice_ticks: list           # the profiled ticks after it (traced runs)
    trace: object               # trace.Summary of the slice, or None
    memory_peak_bytes: int
    device_kind: str
    correct: bool = False
    attempted: int = 0
    failed: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)  # for stderr

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t) -> bool:
        return t is not None and self.t_open < t <= self.t_close

    def finished(self) -> list:
        """The requests whose last token arrived in the window."""
        return [r for r in self.reqs
                if r.error is None and self.in_window(r.t_done)]


class Loop:
    """The clients and the tick loop around ``Engine.step``."""

    def __init__(self, engine, plan: list):
        from repro_torch.serve.engine import Request

        self.Request = Request
        self.engine, self.plan = engine, plan
        self.next = [0] * len(plan)
        self.live: list = []
        self.reqs: list = []
        reg = engine.telemetry.registry
        self._chunks = (reg.histogram("serve.prefill_chunk_tokens")
                        if "serve.prefill_chunk_tokens" in reg.snapshot()
                        else None)

    def submit(self, client: int) -> None:
        from repro_torch.serve.scheduler import CapacityError

        i = self.next[client]
        if i >= len(self.plan[client]):
            return
        self.next[client] += 1
        prompt, max_new = self.plan[client][i]
        h = self.Request(rid=f"{client}.{i}", prompt=prompt,
                         max_new_tokens=max_new, temperature=0.0)
        r = Req(key=(client, i), prompt=prompt, max_new=max_new,
                t_submit=now(), handle=h)
        self.reqs.append(r)
        try:
            self.engine.submit(h)
        except CapacityError as e:
            r.error = str(e)
            r.t_done = now()
            self.submit(client)
            return
        self.live.append(r)

    def _prefilled(self):
        return None if self._chunks is None else self._chunks.sum

    def step(self) -> Tick:
        before = self._prefilled()
        self.engine.step()
        t1 = now()
        dec = first = ctx = first_sq = 0
        done = []
        for r in self.live:
            out = r.handle.out_tokens
            if len(out) < len(r.times):   # preempted: its tokens replay
                r.preempted += 1
                r.times.clear()
            b, n_new = len(r.times), len(out) - len(r.times)
            if n_new <= 0:
                continue
            P = len(r.prompt)
            for m in range(b, b + n_new):
                if m == 0:
                    first += 1
                    first_sq += P * (P + 1) // 2
                else:
                    dec += 1
                    ctx += P + m
            r.times.extend([t1] * n_new)
            if r.handle.done:
                r.t_done = t1
                done.append(r)
        for r in done:
            self.live.remove(r)
            self.submit(r.key[0])
        after = self._prefilled()
        return Tick(t1, dec, first,
                    None if before is None else int(after - before), ctx,
                    first_sq)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> ServeRun:
    from repro_torch.models.model_zoo import build
    from repro_torch.serve.engine import Engine

    cfg, mix = cell.config, cell.mix
    arch = models.get(cfg)
    serving = cfg["serving"]
    marks = {"imports": now()}
    if device.type == "cuda":
        from repro_torch.kernels import build as kbuild

        kbuild.build_all()
    marks["build"] = now()
    raw = arch.weights(cfg, seed, device)
    plan = inputs.requests(mix, cfg["vocab_size"], seed, device)
    _sync(device)
    marks["inputs"] = now()
    page = serving["page_size"]
    max_len = -(-(mix["prompt_tokens"]["hi"] + mix["output_tokens"]["hi"])
                // page) * page
    engine = Engine(
        build(arch.port_config(cfg)), arch.port_params(cfg, raw),
        max_batch=mix["clients"], max_len=max_len, eos_id=None,
        seed=seed % (2 ** 63), page_size=page,
        prefill_chunk=serving["prefill_chunk"],
        paged_attn_impl=serving["paged_attn_impl"],
        kv_cache_bits=serving["kv_cache_bits"],
        vq_matmul_impl=serving["vq_matmul_impl"],
        prefix_cache=serving["prefix_cache"], device=device)
    del raw
    _sync(device)
    marks["engine"] = now()
    loop = Loop(engine, plan)
    for client in range(len(plan)):
        loop.submit(client)
    for _ in range(mix["warmup_ticks"]):
        loop.step()
    _sync(device)
    marks["warm-up"] = now()
    gc.collect()
    gc.freeze()

    t_open = now()
    ticks = []
    while True:
        ticks.append(loop.step())
        if ticks[-1].t1 - t_open >= seconds:
            break
    t_close = ticks[-1].t1
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    summary, slice_ticks, trace_bytes = None, [], 0
    if trace:
        with tracing.profiled() as sl:
            for _ in range(mix["trace_ticks"]):
                slice_ticks.append(loop.step())
        summary, trace_bytes = sl.summary, sl.trace_bytes
    gc.unfreeze()

    result = ServeRun(
        cfg=cfg, mix=mix, max_batch=mix["clients"],
        setup_s=t_open - t_start, t_open=t_open, t_close=t_close,
        reqs=loop.reqs, ticks=ticks, slice_ticks=slice_ticks, trace=summary,
        memory_peak_bytes=memory_peak,
        device_kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"))
    finished = result.finished()
    active = [r for r in loop.reqs if r.t_submit <= t_close
              and (r.t_done is None or r.t_done > t_open)]
    result.attempted = len(active)
    result.failed = sum(r.error is not None for r in active)
    picked = judge.sample(finished, mix["check_requests"], seed)
    short = sum(len(r.tokens) != r.max_new for r in picked)
    for r in result.reqs:     # keep the served ids, drop the program's state
        r.served, r.handle = r.tokens, None
    del engine, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gap, t_ref = None, now()  # None: nothing finished in the window to judge
    if picked:
        raw = arch.weights(cfg, seed, device)
        gap = float(judge.served_gaps(cfg, raw, picked).max())
        del raw
    prev = t_start
    result.notes = {"setup_s": {}}
    for k, t in marks.items():
        result.notes["setup_s"][k] = round(t - prev, 3)
        prev = t
    result.notes.update(
        window_s=round(result.window_s, 3), ticks=len(ticks),
        tokens=sum(1 for r in result.reqs for t in r.times
                   if result.in_window(t)),
        first_tokens=sum(1 for r in result.reqs
                         if r.times and result.in_window(r.times[0])),
        finished=len(finished),
        preempted=sum(r.preempted for r in result.reqs),
        checked_requests=len(picked),
        checked_tokens=sum(len(r.tokens) for r in picked),
        trace_bytes=trace_bytes,
        reference_s=round(now() - t_ref, 3))
    lim = cell.limits
    result.checks = {
        "failed_requests": {"value": result.failed, "limit": 0},
        "short_outputs": {"value": short, "limit": 0},
        "logit_gap_max": {"value": gap, "limit": lim["logit_gap_max"]}}
    result.correct = all(c["value"] is not None and c["value"] <= c["limit"]
                         for c in result.checks.values())
    return result


def control(cell, run, seed: int, device) -> dict:
    """The control's readings on a finished run: at the same positions of
    the same sample, the gap of the token that the reference computed in
    float8 e4m3 puts first (``judge.control_gaps``)."""
    picked = judge.sample(run.finished(), cell.mix["check_requests"], seed)
    raw = models.get(cell.config).weights(cell.config, seed, device)
    ctrl = judge.control_gaps(cell.config, raw, picked)
    return {"program_gap_max": run.checks["logit_gap_max"]["value"],
            "control_gap_max": float(ctrl.max()),
            "control_gap_p50": float(ctrl.median()),
            "served_tokens": int(ctrl.numel())}
