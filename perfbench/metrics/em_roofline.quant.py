"""em_roofline.quant: the least time the EM codebook fits of the profiled
expert stack need (``perfbench/work``: every column group of each expert's
matrix in the profile, one ``vq_em`` call's work each), over
the device time of the ``vq_em`` kernels in the profile, in
percent."""
from perfbench import models, work


def read(run):
    tr = run.trace
    if tr is None:
        return None
    dev_s = tr.kernel_seconds("vq_em")
    if dev_s <= 0:
        return None
    quant = run.cfg["quantization"]
    shapes = models.get(run.cfg).target_shapes(run.cfg)
    bound = 0.0
    for name in run.slice_targets:
        e, r, c = shapes[name.split(".", 2)[2]]
        bound += e * sum(work.bound_seconds(m) for _, m, _ in
                         work.gptvq_groups(r, c, quant))
    return 100.0 * bound / dev_s if bound else None
