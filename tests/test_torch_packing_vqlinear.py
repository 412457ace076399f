"""Port parity: packing, bpv accounting, group plans, VQLinear leaves and the
fused VQ-dequant matmul's plain version against the JAX reference (whose
Pallas kernel runs in interpret mode). Inputs are numpy arrays from a seed
handed to both packages; the port runs on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bpv as jbpv
from repro.core import gptvq as jgptvq
from repro.core import packing as jpacking
from repro.core import vq_linear as jvql
from repro.kernels.vq_dequant_matmul import vq_dequant_matmul as j_vqdm

from repro_torch.convert import vqlinear_from_jax
from repro_torch.core import bpv, gptvq, packing
from repro_torch.core import vq_linear as vql
from repro_torch.kernels import vq_dequant_matmul as vqdm


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------- exact ----

@pytest.mark.parametrize("code_bits", [1, 2, 3, 4, 8, 16])
def test_pack_unpack_matches_reference_bitwise(code_bits):
    rng = np.random.default_rng(code_bits)
    lanes = 32 // jpacking.container_bits(code_bits)
    codes = rng.integers(0, 2**code_bits, size=lanes * 37).astype(np.int32)
    j_words = np.asarray(jpacking.pack(jnp.asarray(codes), code_bits))
    words = packing.pack(_t(codes), code_bits)
    # exact: same bit patterns (uint32 viewed as int32)
    np.testing.assert_array_equal(words.numpy(), j_words.view(np.int32))
    np.testing.assert_array_equal(
        packing.unpack(words, code_bits, codes.size).numpy(), codes)
    np.testing.assert_array_equal(
        packing.unpack(_t(j_words.view(np.int32)), code_bits,
                       codes.size).numpy(),
        np.asarray(jpacking.unpack(jnp.asarray(j_words), code_bits,
                                   codes.size)))


PLAN_SHAPES = [(32, 256), (4096, 4096), (11008, 4096), (4096, 11008),
               (72, 384), (64, 96), (11, 100), (128, 1000)]


@pytest.mark.parametrize("setting", sorted(jbpv.PAPER_SETTINGS))
def test_plan_groups_and_effective_bpv_exact(setting):
    jcfg = jbpv.PAPER_SETTINGS[setting]
    cfg = bpv.PAPER_SETTINGS[setting]
    assert cfg == bpv.VQConfig(**{f: getattr(jcfg, f)
                                  for f in jcfg.__dataclass_fields__})
    for r, c in PLAN_SHAPES:
        if c % cfg.d:
            continue
        assert gptvq.plan_groups(r, c, cfg) == jgptvq.plan_groups(r, c, jcfg)
        # exact: pure Python float arithmetic in the same order
        assert bpv.effective_bpv(cfg, r, c) == jbpv.effective_bpv(jcfg, r, c)
    items = [(r * c, bpv.effective_bpv(cfg, r, c)) for r, c in PLAN_SHAPES
             if c % cfg.d == 0]
    assert bpv.weighted_bpv(items) == jbpv.weighted_bpv(items)


# ----------------------------------------------- VQLinear from the JAX side --

LEAF_CFGS = {
    "sb0": jbpv.VQConfig(d=2, bits_per_dim=2, group_size=1024, em_iters=6,
                         codebook_update_iters=2),
    "sb16": jbpv.VQConfig(d=2, bits_per_dim=2, group_size=1024, em_iters=6,
                          codebook_update_iters=2, scale_block=16),
}


@pytest.fixture(scope="module")
def jax_leaves():
    """Reference quantize_array leaves + their dequantized and fused forms,
    built once as numpy."""
    rng = np.random.default_rng(0)
    W = rng.standard_normal((48, 256)).astype(np.float32)
    X = rng.standard_normal((512, 256)).astype(np.float32)
    H = (X.T @ X / 512).astype(np.float32)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    out = {}
    for name, cfg in LEAF_CFGS.items():
        leaf = jvql.quantize_array(jnp.asarray(W), jnp.asarray(H), cfg)
        fused = jvql.prepare_fused(leaf, impl="pallas")
        out[name] = {
            "leaf": jax.tree.map(np.asarray, leaf),
            "indices": np.asarray(jvql.unpack_indices(leaf)),
            "W32": np.asarray(jvql.dequantize(leaf, jnp.float32)),
            "Wbf": np.asarray(jvql.dequantize(leaf, jnp.bfloat16)
                              .astype(jnp.float32)),
            "codebooks_f": np.asarray(fused.codebooks_f),
            "scales": None if fused.scales is None
            else np.asarray(fused.scales),
            "y": np.asarray(jvql.fused_matmul(jnp.asarray(x), fused,
                                              impl="pallas", interpret=True)),
            "x": x,
        }
    return out


@pytest.mark.parametrize("name", sorted(LEAF_CFGS))
def test_unpack_and_dequantize_reference_leaves(jax_leaves, name):
    ref = jax_leaves[name]
    leaf = vqlinear_from_jax(ref["leaf"], device="cpu")
    # exact: shifts and masks on the same bit patterns
    np.testing.assert_array_equal(vql.unpack_indices(leaf).numpy(),
                                  ref["indices"])
    W32 = vql.dequantize(leaf, torch.float32).numpy()
    Wbf = vql.dequantize(leaf, torch.bfloat16).to(torch.float32).numpy()
    if leaf.scale_block == 0:
        # exact: the same f32 products gathered by the same indices
        np.testing.assert_array_equal(W32, ref["W32"])
        np.testing.assert_array_equal(Wbf, ref["Wbf"])
    else:
        # the scale plane goes through exp2, whose torch and XLA
        # implementations may differ in the last ulp
        np.testing.assert_allclose(W32, ref["W32"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(LEAF_CFGS))
def test_fused_prep_and_matmul_match_reference(jax_leaves, name):
    ref = jax_leaves[name]
    fused = vql.prepare_fused(vqlinear_from_jax(ref["leaf"], device="cpu"))
    assert isinstance(fused, vql.FusedVQLinear)
    # exact: int8 * f32 scale in f32
    np.testing.assert_array_equal(fused.codebooks_f.numpy(),
                                  ref["codebooks_f"])
    if ref["scales"] is not None:
        np.testing.assert_allclose(fused.scales.numpy(), ref["scales"],
                                   rtol=1e-6, atol=0)  # exp2 ulps
    # f32 sums over 256 terms in another order
    y = vql.fused_matmul(_t(ref["x"]), fused).numpy()
    np.testing.assert_allclose(y, ref["y"], rtol=1e-4, atol=1e-4)


# ------------------------------ plain vq_dequant_matmul vs Pallas interpret --

RAGGED = dict(N=72, K=384, d=2, bits=2, rows_per_band=8, group_cols=128)


@pytest.fixture(scope="module")
def ragged_case():
    """N=72, K=384 match neither the Pallas kernel's 128-row nor 256-column
    tiles (it snaps them); the port's plain version and kernel need no
    snapping. One layout with and one without a blockwise scale plane."""
    rng = np.random.default_rng(1)
    c = RAGGED
    k_c = 2 ** (c["d"] * c["bits"])
    code_bits = max(1, (k_c - 1).bit_length())
    n_cg, n_bands = c["K"] // c["group_cols"], c["N"] // c["rows_per_band"]
    codes = rng.integers(0, k_c, size=(c["N"], c["K"] // c["d"]))
    words = np.asarray(jax.vmap(lambda r: jpacking.pack(r, code_bits))(
        jnp.asarray(codes, jnp.int32)))
    C = rng.standard_normal((n_cg, n_bands, k_c, c["d"])).astype(np.float32)
    scales = (rng.uniform(0.5, 2.0, (c["N"], c["K"] // 32))
              .astype(np.float32))
    xs = {M: rng.standard_normal((M, c["K"])).astype(np.float32)
          for M in (1, 3, 8, 128)}
    ys = {}
    for sb in (0, 32):
        for M, x in xs.items():
            ys[sb, M] = np.asarray(j_vqdm(
                jnp.asarray(x), jnp.asarray(words), jnp.asarray(C),
                jnp.asarray(scales) if sb else None, d=c["d"], k_c=k_c,
                code_bits=code_bits,
                container_bits=jpacking.container_bits(code_bits),
                rows_per_band=c["rows_per_band"],
                group_cols=c["group_cols"], scale_block=sb,
                interpret=True))
    return dict(words=words.view(np.int32), C=C, scales=scales, xs=xs,
                ys=ys, k_c=k_c, code_bits=code_bits)


@pytest.mark.parametrize("M", [1, 3, 8, 128])
@pytest.mark.parametrize("sb", [0, 32])
def test_plain_vq_dequant_matmul_matches_pallas_interpret(ragged_case, M, sb):
    rc = ragged_case
    y = vqdm.vq_dequant_matmul(
        _t(rc["xs"][M]), _t(rc["words"]), _t(rc["C"]),
        _t(rc["scales"]) if sb else None, d=RAGGED["d"], k_c=rc["k_c"],
        code_bits=rc["code_bits"], rows_per_band=RAGGED["rows_per_band"],
        group_cols=RAGGED["group_cols"], scale_block=sb)
    assert y.dtype == torch.float32 and y.shape == (M, RAGGED["N"])
    # f32 sums over K=384 terms in another order than the tiled kernel
    np.testing.assert_allclose(y.numpy(), rc["ys"][sb, M], rtol=1e-4,
                               atol=1e-4)


def test_cpu_wrapper_counts_no_launch(ragged_case):
    rc = ragged_case
    before = vqdm.vq_dequant_matmul.launches
    vqdm.vq_dequant_matmul(
        _t(rc["xs"][1]), _t(rc["words"]), _t(rc["C"]), None, d=RAGGED["d"],
        k_c=rc["k_c"], code_bits=rc["code_bits"],
        rows_per_band=RAGGED["rows_per_band"],
        group_cols=RAGGED["group_cols"])
    assert vqdm.vq_dequant_matmul.launches == before
    with pytest.raises(ValueError, match="iff"):
        vqdm.vq_dequant_matmul(
            _t(rc["xs"][1]), _t(rc["words"]), _t(rc["C"]), None,
            d=RAGGED["d"], k_c=rc["k_c"], code_bits=rc["code_bits"],
            rows_per_band=RAGGED["rows_per_band"],
            group_cols=RAGGED["group_cols"], scale_block=32)


@pytest.mark.parametrize("sb", [0, 6])
def test_unaligned_rows_take_the_fused_form(sb):
    """Rows whose codes straddle words (the reference's flat (1, n_words)
    packing): the port densifies them exactly as the reference does, and
    prepare_fused turns them into a FusedVQLinear that the kernel's layout
    takes, so they too reach the fused matmul."""
    rng = np.random.default_rng(sb)
    r, c, d, k, cg = 4, 24, 2, 16, 12  # nspans 12, 8 lanes -> unaligned
    codes = rng.integers(0, k, size=(r * c // d,)).astype(np.int32)
    leaf = jvql.VQLinear(
        words=jpacking.pack(jnp.asarray(codes), 4).reshape(1, -1),
        codebooks=jnp.asarray(rng.integers(-127, 128, (2, 2, k, d)),
                              jnp.int8),
        cb_scale=jnp.full((2, 2), 0.05, jnp.float32),
        scale_sint=jnp.asarray(rng.integers(-8, 8, (2, r, cg // 6)),
                               jnp.int8),
        scale_a=jnp.full((2,), 0.25, jnp.float32),
        scale_z=jnp.full((2,), -0.5, jnp.float32),
        r=r, c=c, d=d, k=k, group_cols=cg, rows_per_band=2, scale_block=sb)
    W_ref = np.asarray(jvql.dequantize(leaf, jnp.float32))
    port = vqlinear_from_jax(jax.tree.map(np.asarray, leaf), device="cpu")
    # exact: same gather; the scale plane's exp2 may differ in the last ulp
    np.testing.assert_allclose(vql.dequantize(port, torch.float32).numpy(),
                               W_ref, rtol=1e-6 if sb else 0, atol=0)
    fused = vql.prepare_fused(port)
    assert isinstance(fused, vql.FusedVQLinear)
    x = rng.standard_normal((3, c)).astype(np.float32)
    before = vql.COUNTS["fused"]
    y = vql.fused_matmul(_t(x), fused).numpy()
    assert vql.COUNTS["fused"] == before + 1
    # f32 sums over 24 terms in another order
    np.testing.assert_allclose(y, x @ W_ref.T, rtol=1e-5, atol=1e-5)


def test_from_vq_result_packs_unaligned_rows_flat():
    """A quantizer output whose rows straddle words packs into one flat
    row-major run, and its fused form computes x @ W.T of its gather form."""
    rng = np.random.default_rng(7)
    W = _t(rng.standard_normal((4, 24)).astype(np.float32))
    cfg = bpv.VQConfig(d=2, bits_per_dim=2, group_size=96, em_iters=3,
                       codebook_update_iters=1)
    leaf = vql.quantize_array(W, None, cfg,
                              torch.Generator().manual_seed(0))
    assert tuple(leaf.words.shape) == (1, 4 * 12 // 8)
    x = _t(rng.standard_normal((2, 24)).astype(np.float32))
    y = vql.fused_matmul(x, vql.prepare_fused(leaf))
    # f32 sums over 24 terms in another order
    torch.testing.assert_close(
        y, x @ vql.dequantize(leaf, torch.float32).T, rtol=1e-5, atol=1e-5)
