"""paged_attn_roofline.serve: the least time the decode attention of the
traced ticks needs, over the device time of the ``paged_attention``
kernels (``paged_split*``, ``paged_combine*``) in the profiler's slice, in
percent.

Each decoding slot attends its whole context: ``perfbench/work``'s bound
with every attended row's K and V read once, bf16 q, one call a layer and
tick. Read for pass-through (``kv_cache_bits`` 16, f32) pages only."""
from perfbench import models, work


def read(run):
    tr = run.trace
    if tr is None or not run.slice_ticks:
        return None
    if run.cfg["serving"]["kv_cache_bits"] != 16:
        return None
    dev_s = tr.kernel_seconds("paged_split", "paged_combine")
    if dev_s <= 0:
        return None
    arch = models.get(run.cfg)
    n = arch.dims(run.cfg)
    page = run.cfg["serving"]["page_size"]
    bound = 0.0
    for t in run.slice_ticks:
        if t.decode_rows == 0:
            continue
        bound += work.bound_seconds(work.paged_attention_work(
            t.decode_ctx, t.decode_rows, n["H"], n["KV"], n["hd"],
            n["hd"] * 4, 2, -(-t.decode_ctx // page), False))
    return 100.0 * bound * n["L"] / dev_s
