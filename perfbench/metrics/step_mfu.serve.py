"""step_mfu.serve: the operations the window's tokens need, over the
window's seconds times the H100's bf16 peak, in percent.

Counted by ``perfbench/work`` from the tokens, not from the program's
calls: every prompt token prefilled and every token decoded meets each
packed matrix once (2 operations a weight), attends its context (q.k and
p.v), and every sampled position (a first or a decoded token) meets the
output head. Prompt tokens come from the engine's
``serve.prefill_chunk_tokens`` counter (real tokens, padding left out);
without it nothing is read."""
from perfbench import models, work


def read(run):
    if not run.ticks or any(t.prefill_tokens is None for t in run.ticks):
        return None
    arch = models.get(run.cfg)
    n = arch.dims(run.cfg)
    per_token = 2.0 * arch.matmul_params(run.cfg)
    attn = 4.0 * n["H"] * n["hd"] * n["L"]
    flops = 0.0
    for t in run.ticks:
        flops += per_token * (t.decode_rows + t.prefill_tokens)
        flops += attn * (t.decode_ctx + t.first_prompt_sq)
        flops += work.logits_flops(n["D"], n["V"],
                                   t.decode_rows + t.first_tokens)
    return 100.0 * flops / (run.window_s * work.PEAK_BF16)
