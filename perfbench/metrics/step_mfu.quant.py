"""step_mfu.quant: the operations of the work the pipeline finished in the
window, over the window's seconds times the H100's bf16 peak, in percent.

Counted by ``perfbench/work`` from shapes, not from the program's calls:
each matrix whose ``quant_target`` event fell in the window costs GPTVQ's
operations at the setting (an expert stack, each expert's), and each
block whose ``hessian_capture`` or ``advance`` stage ended in it costs
that pass over every calibration token."""
from perfbench import models, work


def read(run):
    arch = models.get(run.cfg)
    n = arch.dims(run.cfg)
    quant = run.cfg["quantization"]
    shapes = arch.target_shapes(run.cfg)
    per = {t: e * work.gptvq_matrix_flops(r, c, quant)
           for t, (e, r, c) in shapes.items()}
    tokens, seq = run.mix["sequences"] * run.mix["tokens"], run.mix["tokens"]
    flops = sum(per[name.split(".", 2)[2]]
                for _, name, _ in run.window_targets())
    flops += len(run.window_stages("hessian_capture")) * \
        work.moe_block_flops(n, tokens, seq, capture=True)
    flops += len(run.window_stages("advance")) * \
        work.moe_block_flops(n, tokens, seq, capture=False)
    return 100.0 * flops / (run.window_s * work.PEAK_BF16) if flops else None
