"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's: ``analytic_cell``'s FLOPs, HBM bytes and collective bytes
equal to the reference's for every arch x shape at (chips, dp, tp) of
(256, 16, 16), (256, 32, 8) and (512, 64, 8), its seconds the reference's
counts over the H100 figures (``launch/mesh.HARDWARE``), the model and
data axes' collective bytes summing to the reference's; and the
reference's three physics tests (``tests/launch/test_roofline.py``) on
H100 figures.
"""
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jrl
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import HARDWARE
from repro_torch.models import model_zoo

MESHES = [(256, 16, 16), (256, 32, 8), (512, 64, 8)]
COUNTS = {name: dryrun.active_param_counts(model_zoo.build(cfg))
          for name, cfg in ARCHS.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_cell_matches_reference(arch, shape, mesh):
    chips, dp, tp = mesh
    n_total, n_active = COUNTS[arch]
    kw = dict(chips=chips, dp=dp, tp=tp, n_total=n_total,
              n_active=n_active, microbatches=4)
    for extra in ({}, {"weight_payload_bytes": n_total * 0.28,
                       "kv_bytes": 1.0}):
        got = rl.analytic_cell(ARCHS[arch], SHAPES[shape], **kw, **extra)
        want = jrl.analytic_cell(JARCHS[arch], JSHAPES[shape], **kw, **extra)
        for key in ("flops", "hbm_bytes", "coll_bytes"):
            assert got[key] == want[key], key
        assert got["coll_model_bytes"] + got["coll_data_bytes"] == \
            want["coll_bytes"]
        assert got["compute_s"] == want["flops"] / HARDWARE["peak_flops_bf16"]
        assert got["memory_s"] == want["hbm_bytes"] / HARDWARE["hbm_bw"]
        assert got["collective_s"] == max(
            got["coll_model_bytes"] / HARDWARE["nvlink_bw"],
            got["coll_data_bytes"] / HARDWARE["net_bw"])
        # the reference's useful seconds are at the v5e's 197 TFLOP/s
        assert got["useful_compute_s"] == pytest.approx(
            want["useful_compute_s"] * 197e12 / HARDWARE["peak_flops_bf16"],
            rel=1e-12)


def test_analyze_terms():
    out = rl.analyze({"flops": 989e12, "bytes accessed": 3.35e12},
                     {"model": 450e9, "data": 100e9, "total": 550e9},
                     chips=8, model_flops=8 * 989e12)
    assert out.compute_s == pytest.approx(1.0)
    assert out.memory_s == pytest.approx(1.0)
    assert out.collective_s == pytest.approx(2.0)  # the network's 100 GB
    assert out.dominant == "collective"
    assert out.useful_flops_ratio == pytest.approx(1.0)


@pytest.fixture
def dense_cfg():
    return ModelConfig(name="x", family="dense", n_layers=32, d_model=4096,
                       n_heads=32, n_kv_heads=8, head_dim=128, d_ff=11008,
                       vocab_size=32000)


class TestAnalyticModel:
    def test_decode_weight_bound_improves_with_vq(self, dense_cfg):
        common = dict(chips=256, dp=32, tp=8, n_total=6_700_000_000,
                      n_active=6_700_000_000)
        base = rl.analytic_cell(dense_cfg, SHAPES["decode_32k"], **common)
        vq = rl.analytic_cell(dense_cfg, SHAPES["decode_32k"], **common,
                              weight_payload_bytes=6.7e9 * 0.28)
        assert base["dominant"] == "memory"
        assert vq["memory_s"] < base["memory_s"]
        # and an fp8 cache lowers it again
        vq8 = rl.analytic_cell(dense_cfg, SHAPES["decode_32k"], **common,
                               weight_payload_bytes=6.7e9 * 0.28,
                               kv_bytes=1.0)
        assert vq8["memory_s"] < vq["memory_s"]

    def test_train_is_compute_bound_at_scale(self, dense_cfg):
        out = rl.analytic_cell(dense_cfg, SHAPES["train_4k"], chips=256,
                               dp=32, tp=8, n_total=6_700_000_000,
                               n_active=6_700_000_000, microbatches=8)
        assert out["dominant"] == "compute"
        assert 0 < out["roofline_fraction"] <= 1.0

    def test_terms_positive_all_shapes(self, dense_cfg):
        for s in SHAPES.values():
            out = rl.analytic_cell(dense_cfg, s, chips=256, dp=32, tp=8,
                                   n_total=1e9, n_active=1e9)
            assert out["compute_s"] > 0 and out["hbm_bytes"] > 0
            assert out["collective_s"] > 0
            assert out["step_lower_bound_s"] >= max(
                out["compute_s"], out["memory_s"], out["collective_s"]) - 1e-12
