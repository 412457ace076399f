"""The frozen work arithmetic equals the port's ``obs/work`` at the cells'
shapes, so a later change to the program's formulas leaves the yardstick
where it was and shows as a difference here; the quantizer's groups are
the calls the port makes."""
import json

import pytest

from tiny import REPO
from perfbench import inputs, work
from perfbench.models import qwen2, qwen3_moe
from repro_torch.obs import work as pw

CFG = json.loads((REPO / "perfbench/configs/qwen2-72b.json").read_text())
MOE = json.loads((REPO / "perfbench/configs/qwen3-moe-30b-a3b.json")
                 .read_text())
SHAPES = sorted(qwen2.matrix_shapes(CFG).items())


@pytest.mark.parametrize("M", [1, 16, 64, 128])
@pytest.mark.parametrize("target,shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_vq_dequant_matmul_work(target, shape, M):
    r, c = shape
    lo = inputs.packed_layout(CFG["quantization"], r, c)
    cb = lo["n_cb"] * (lo["k"] * lo["d"] + 4)
    for terms in (1, 3):
        args = (1, M, r, c, 2, lo["n_words"], cb, 0, terms)
        assert work.vq_dequant_matmul_work(*args) == \
            pw.vq_dequant_matmul_work(*args)


@pytest.mark.parametrize("rows,B", [(64 * 300, 64), (64 * 1024, 64), (5, 1)])
def test_paged_attention_work(rows, B):
    args = (rows, B, 64, 8, 128, 512, 2, -(-rows // 16), False)
    assert work.paged_attention_work(*args) == pw.paged_attention_work(*args)
    vq2 = args[:-1] + (True,)
    assert work.paged_attention_work(*vq2) == pw.paged_attention_work(*vq2)


@pytest.mark.parametrize("target", sorted(qwen3_moe.target_shapes(MOE)))
def test_quantize_kernels_work(target):
    """Each column group's sweep and EM work as the port's wrappers count
    them, at a matrix of the cell (``kernels/vq_assign``: the sweep with
    the group's codebooks, EM with one weight row shared by the bands)."""
    _, r, c = qwen3_moe.target_shapes(MOE)[target]
    q = MOE["quantization"]
    cg, rg = inputs.packed_layout(q, r, c)["group_cols"], \
        inputs.packed_layout(q, r, c)["rows_per_band"]
    B, n = r // rg, rg * cg // 2
    groups = work.gptvq_groups(r, c, q)
    assert len(groups) == c // cg
    for sweep, em, tail in groups:
        assert sweep == pw.vq_group_sweep_work(r, cg, 2, 16, B * 32, 0)
        assert em == pw.vq_em_work(B, n, 2, 16, n * 2, q["em_iters"])
    assert groups[-1][2] == 0.0


def test_peaks():
    for rate, flops in work.FLOP_PER_S.items():
        assert pw.FLOP_PER_S[rate] == flops
    assert work.PEAK_BF16 == pw.FLOP_PER_S[work.RATE_BF16_TC]
