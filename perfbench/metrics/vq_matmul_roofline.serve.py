"""vq_matmul_roofline.serve: the least time the packed matmuls of the
traced ticks need, over the device time of the ``vq_dequant_matmul``
kernels (``vqdm_*``) in the profiler's slice, in percent.

A tick's tokens (prompt tokens prefilled plus tokens decoded) meet each
packed matrix once: ``perfbench/work``'s bound of one call with M = those
tokens, its int8 codebooks read once (bf16 x, f32 y), whatever number of
launches the program makes of it."""
from perfbench import inputs, models, work


def read(run):
    tr = run.trace
    if tr is None or not run.slice_ticks:
        return None
    if any(t.prefill_tokens is None for t in run.slice_ticks):
        return None
    dev_s = tr.kernel_seconds("vqdm_")
    if dev_s <= 0:
        return None
    mats = []
    for r, c in models.get(run.cfg).matrix_shapes(run.cfg).values():
        lo = inputs.packed_layout(run.cfg["quantization"], r, c)
        mats.append((r, c, lo["n_words"], lo["n_cb"] * (lo["k"] * lo["d"] + 4)))
    bound = 0.0
    for t in run.slice_ticks:
        M = t.decode_rows + t.prefill_tokens
        if M == 0:
            continue
        for N, K, n_words, cb_bytes in mats:
            bound += work.bound_seconds(work.vq_dequant_matmul_work(
                1, M, N, K, 2, n_words, cb_bytes, 0, 1))
    return 100.0 * bound * run.cfg["num_hidden_layers"] / dev_s
