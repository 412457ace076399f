"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes, plus the quantize pipeline on CUDA against the CPU.

Needs an NVIDIA GPU and nvcc (marker ``cuda``); each test skips without a
card. This file imports no jax, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.configs import SMOKE
from repro_torch.core import vq_linear as vql
from repro_torch.core.bpv import VQConfig
from repro_torch.core.pipeline import quantize_model
from repro_torch.core.recipe import QuantRecipe
from repro_torch.kernels.vq_assign import (
    span_metrics, vq_assign, vq_assign_plain, vq_em, vq_em_plain,
    vq_group_sweep, vq_group_sweep_plain)
from repro_torch.kernels.vq_dequant_matmul import (
    Prepared, vq_dequant_matmul, vq_dequant_matmul_experts_plain,
    vq_dequant_matmul_plain)
from repro_torch.models import model_zoo

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,n,d,k,shared_hw", [
    (3, 130, 2, 16, True), (37, 4, 2, 16, True), (5, 17, 1, 8, False),
    (9, 33, 4, 256, False), (1, 1, 2, 4, True)])
def test_vq_assign_matches_plain(dev, B, n, d, k, shared_hw):
    g = torch.Generator(device=dev).manual_seed(B + n + d + k)
    x = torch.randn((B, n, d), generator=g, device=dev)
    hw = torch.rand((n, d) if shared_hw else (B, n, d), generator=g,
                    device=dev) + 0.1
    cb = torch.randn((B, k, d), generator=g, device=dev)
    cb[:, 1] = cb[:, 0]  # exact ties must go to the lowest index
    before = vq_assign.launches
    idx = vq_assign(x, hw, cb)
    torch.cuda.synchronize()
    assert vq_assign.launches == before + 1
    ref = vq_assign_plain(x, hw, cb)
    diff = x[:, :, None, :] - cb[:, None, :, :]
    dist = torch.sum(hw.expand(x.shape)[:, :, None, :] * diff * diff, -1)
    chosen = dist.gather(2, idx.long()[..., None])
    best = dist.gather(2, ref.long()[..., None])
    torch.testing.assert_close(chosen, best, rtol=1e-5, atol=1e-6)
    assert not (idx == 1).any()  # centroid 1 duplicates centroid 0


@pytest.mark.parametrize("M,N,K,d,bits,rg,cg,sb,xdt", [
    (1, 72, 384, 2, 2, 8, 128, 0, torch.float32),
    (3, 72, 384, 2, 2, 8, 128, 32, torch.bfloat16),
    (70, 40, 96, 1, 3, 4, 48, 16, torch.float32),
    (17, 24, 256, 4, 2, 1, 256, 0, torch.float32),
    (128, 130, 320, 2, 4, 2, 160, 32, torch.bfloat16),
    # rows of 12 or 18 four-bit codes straddle 8-lane words: one flat run
    (3, 4, 24, 2, 2, 2, 12, 0, torch.float32),
    (20, 68, 36, 2, 2, 4, 12, 6, torch.float32),
    (5, 68, 36, 2, 2, 4, 12, 0, torch.bfloat16)])
def test_vq_dequant_matmul_matches_plain(dev, M, N, K, d, bits, rg, cg, sb,
                                         xdt):
    from repro_torch.core import packing

    g = torch.Generator(device=dev).manual_seed(M + N + K)
    k_c = 2 ** (d * bits)
    code_bits = max(1, (k_c - 1).bit_length())
    cbits = packing.container_bits(code_bits)
    words = torch.randint(-2**31, 2**31 - 1, (N * K // d * cbits // 32,),
                          generator=g, device=dev, dtype=torch.int32)
    if code_bits != cbits:  # keep codes < k_c inside wider containers
        codes = torch.randint(0, k_c, (N * K // d,), generator=g, device=dev)
        words = packing.pack(codes, code_bits)
    words = words.reshape(N if (K // d * cbits) % 32 == 0 else 1, -1)
    cb = torch.randn((K // cg, N // rg, k_c, d), generator=g, device=dev)
    scales = (torch.rand((N, K // sb), generator=g, device=dev) + 0.5
              if sb else None)
    x = torch.randn((M, K), generator=g, device=dev).to(xdt)
    kw = dict(d=d, code_bits=code_bits, rows_per_band=rg, group_cols=cg,
              scale_block=sb)
    before = vq_dequant_matmul.launches
    y = vq_dequant_matmul(x, words, cb, scales, k_c=k_c, **kw)
    torch.cuda.synchronize()
    assert vq_dequant_matmul.launches == before + 1
    ref = vq_dequant_matmul_plain(x, words, cb, scales, **kw)
    # f32 accumulation in another order than cuBLAS
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)


def _vq_case(dev, M, N, K, d, bits, rg, cg, sb, xdt, int8_form, seed=0):
    """Random packed words (per-row layout when rows fill whole words,
    else one flat run), codebooks either in the path's form (int8 values
    times a per-(group, band) f32 scale, as ``quantize_codebooks`` leaves
    them) or arbitrary f32, an optional scale plane and x."""
    from repro_torch.core import packing

    g = torch.Generator(device=dev).manual_seed(seed + M + N + K + d)
    k_c = 2 ** (d * bits)
    code_bits = max(1, (k_c - 1).bit_length())
    codes = torch.randint(0, k_c, (N * K // d,), generator=g, device=dev)
    words = packing.pack(codes, code_bits)
    cbits = packing.container_bits(code_bits)
    words = words.reshape(N if (K // d * cbits) % 32 == 0 else 1, -1)
    shape = (K // cg, N // rg, k_c, d)
    cb_i8 = cb_scale = None
    if int8_form:
        cb_i8 = torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
        cb_scale = torch.rand(shape[:2], generator=g, device=dev) * 0.02 + 1e-3
        cb = cb_i8.to(torch.float32) * cb_scale[..., None, None]
    else:
        cb = torch.randn(shape, generator=g, device=dev)
    scales = (torch.rand((N, K // sb), generator=g, device=dev) + 0.5
              if sb else None)
    x = torch.randn((M, K), generator=g, device=dev).to(xdt)
    kw = dict(d=d, k_c=k_c, code_bits=code_bits, rows_per_band=rg,
              group_cols=cg, scale_block=sb)
    return x, words, cb, scales, cb_i8, cb_scale, kw


@pytest.mark.parametrize("int8_form", [True, False])
@pytest.mark.parametrize("M,N,K,d,bits,rg,cg,sb,xdt,impl", [
    # split-K (M <= 16), both x dtypes
    (1, 72, 512, 2, 2, 4, 256, 0, torch.float32, "splitk"),
    (4, 130, 1024, 2, 2, 2, 256, 0, torch.bfloat16, "splitk"),
    (16, 64, 768, 1, 2, 4, 128, 32, torch.bfloat16, "splitk"),
    (7, 96, 512, 4, 2, 8, 256, 0, torch.float32, "splitk"),
    (3, 68, 36, 2, 2, 4, 12, 6, torch.float32, "splitk"),  # flat words
    (16, 40, 2048, 2, 2, 4, 2048, 0, torch.bfloat16, "splitk"),  # cg > 1024
    # bf16 tensor cores (M > 16); ragged N, d in {1, 2, 4}, scale plane
    (17, 130, 512, 2, 2, 2, 256, 0, torch.bfloat16, "tc"),
    (64, 256, 1024, 2, 2, 4, 256, 0, torch.bfloat16, "tc"),
    (128, 192, 768, 1, 2, 4, 128, 64, torch.bfloat16, "tc"),
    (512, 128, 512, 4, 2, 8, 256, 0, torch.bfloat16, "tc"),
    (64, 100, 384, 2, 2, 4, 96, 32, torch.bfloat16, "tc"),
    (20, 68, 36, 2, 2, 4, 12, 6, torch.bfloat16, "tc"),  # flat words
])
def test_vq_dequant_matmul_variants(dev, M, N, K, d, bits, rg, cg, sb, xdt,
                                    impl, int8_form):
    """Every variant against the plain version, on codebooks in the path's
    int8 form and on arbitrary f32 ones; launches_by_impl names the
    variant that ran (tensor cores: the int8 form where column groups and
    plane blocks are multiples of 64, else the exact 3-term split)."""
    x, words, cb, scales, cb_i8, cb_scale, kw = _vq_case(
        dev, M, N, K, d, bits, rg, cg, sb, xdt, int8_form)
    if impl == "tc":
        impl = ("tc_int8" if int8_form and cg % 64 == 0 and sb % 64 == 0
                else "tc_split3")
    by_impl = dict(vq_dequant_matmul.launches_by_impl)
    y = vq_dequant_matmul(x, words, cb, scales, codebooks_i8=cb_i8,
                          cb_scale=cb_scale, **kw)
    torch.cuda.synchronize()
    got = {k: v - by_impl.get(k, 0)
           for k, v in vq_dequant_matmul.launches_by_impl.items()
           if v != by_impl.get(k, 0)}
    assert got == {impl: 1}
    kw.pop("k_c")
    ref = vq_dequant_matmul_plain(x, words, cb, scales, **kw)
    # f32 sums in another order than cuBLAS (and, int8 form, the scale
    # applied to each column group's sum rather than to each W value)
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,sub", [(4, 1), (4, 3), (64, 17), (64, 40)])
def test_vq_dequant_matmul_rows_are_independent(dev, M, sub):
    """Row m of y is the same bit for bit whatever else x holds, within a
    variant (split-K at M = 4, tensor cores at M = 64), and from run to
    run: the engine's solo and interleaved runs give the same tokens only
    if a slot's row does not depend on the other slots."""
    x, words, cb, _, cb_i8, cb_scale, kw = _vq_case(
        dev, M, 192, 1024, 2, 2, 4, 256, 0, torch.bfloat16, True)
    run = lambda xx: vq_dequant_matmul(xx, words, cb, codebooks_i8=cb_i8,
                                       cb_scale=cb_scale, **kw)
    y = run(x)
    assert torch.equal(run(x), y)
    assert torch.equal(run(x[:sub].contiguous()), y[:sub])
    other = x.clone()
    other[sub:] = torch.randn_like(other[sub:].float()).to(other.dtype)
    assert torch.equal(run(other)[:sub], y[:sub])


def _stack(cases):
    """The per-expert inputs of ``_vq_case`` stacked on a leading E (None
    stays None); the layout keywords are the first case's."""
    cols = list(zip(*[c[:-1] for c in cases]))
    return [None if col[0] is None else torch.stack(col) for col in cols] + [
        cases[0][-1]]


@pytest.mark.parametrize("int8_form", [True, False])
@pytest.mark.parametrize("E,M,N,K,d,bits,rg,cg,sb,xdt,impl", [
    # split-K: the 16-byte path with splits, a Qwen3-MoE prefill chunk's
    # expert slab (C = 8 rows), flat words (generic path), one split
    (3, 4, 130, 1024, 2, 2, 2, 256, 0, torch.bfloat16, "splitk"),
    (4, 8, 768, 2048, 2, 2, 4, 256, 0, torch.bfloat16, "splitk"),
    (3, 3, 68, 36, 2, 2, 4, 12, 6, torch.float32, "splitk"),
    (2, 1, 72, 256, 2, 2, 4, 256, 64, torch.float32, "splitk"),
    # tensor cores: a decode tick's slab (max_batch 4 x C = 8 rows), a
    # scale plane at d = 1, flat words
    (3, 32, 192, 1024, 2, 2, 4, 256, 0, torch.bfloat16, "tc"),
    (2, 130, 192, 768, 1, 2, 4, 128, 64, torch.bfloat16, "tc"),
    (3, 20, 68, 36, 2, 2, 4, 12, 6, torch.bfloat16, "tc"),
    # FP32 CUDA cores (f32 x)
    (3, 40, 72, 384, 2, 2, 8, 128, 0, torch.float32, "fp32"),
])
def test_vq_dequant_matmul_expert_stack(dev, E, M, N, K, d, bits, rg, cg,
                                        sb, xdt, impl, int8_form):
    """An expert stack in one launch (the grid's expert axis): expert e's
    rows are bitwise a 2-D launch's on its slice, the same bits twice, and
    close to the plain per-expert loop; counted once, under its variant
    and its expert count."""
    x, words, cb, scales, cb_i8, cb_scale, kw = _stack([
        _vq_case(dev, M, N, K, d, bits, rg, cg, sb, xdt, int8_form, seed=e)
        for e in range(E)])
    if impl == "tc":
        impl = ("tc_int8" if int8_form and cg % 64 == 0 and sb % 64 == 0
                else "tc_split3")
    prep = Prepared(words, cb, scales, codebooks_i8=cb_i8,
                    cb_scale=cb_scale, **kw)
    n0 = vq_dequant_matmul.launches
    by_impl = dict(vq_dequant_matmul.launches_by_impl)
    by_e = dict(vq_dequant_matmul.launches_by_experts)
    y = prep(x)
    torch.cuda.synchronize()
    assert vq_dequant_matmul.launches == n0 + 1
    got = {k: v - by_impl.get(k, 0)
           for k, v in vq_dequant_matmul.launches_by_impl.items()
           if v != by_impl.get(k, 0)}
    assert got == {impl: 1}
    assert vq_dequant_matmul.launches_by_experts.get(E, 0) == (
        by_e.get(E, 0) + 1)
    assert y.shape == (E, M, N)
    for e in range(E):
        one = Prepared(words[e], cb[e], None if scales is None else scales[e],
                       codebooks_i8=None if cb_i8 is None else cb_i8[e],
                       cb_scale=None if cb_scale is None else cb_scale[e],
                       **kw)
        assert torch.equal(y[e], one(x[e])), e
    assert torch.equal(prep(x), y)
    kw.pop("k_c")
    ref = vq_dequant_matmul_experts_plain(x, words, cb, scales, **kw)
    # f32 sums in another order than cuBLAS, as the 2-D variants
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)


def test_expert_stack_rejects_what_the_grouped_launch_does_not_take(dev):
    """A stack the grouped launch cannot take raises before any launch: it
    is never split into 2-D launches."""
    x, words, cb, _, cb_i8, cb_scale, kw = _stack([
        _vq_case(dev, 4, 64, 256, 2, 2, 4, 256, 0, torch.bfloat16, True,
                 seed=e) for e in range(3)])
    n0 = vq_dequant_matmul.launches
    with pytest.raises(ValueError, match="same leading E"):
        Prepared(words[:2], cb, codebooks_i8=cb_i8, cb_scale=cb_scale, **kw)
    with pytest.raises(ValueError, match="same leading E"):
        Prepared(words, cb, codebooks_i8=cb_i8[:, 0], cb_scale=cb_scale,
                 **kw)
    prep = Prepared(words, cb, codebooks_i8=cb_i8, cb_scale=cb_scale, **kw)
    with pytest.raises(ValueError, match=r"\(3, M, 256\)"):
        prep(x[:2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        prep(x.transpose(0, 1).contiguous().transpose(0, 1))
    assert vq_dequant_matmul.launches == n0


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn((4, 8, 2), device=dev)
    cb = torch.randn((4, 16, 2), device=dev)
    hw = torch.ones((8, 2), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        vq_assign(x.transpose(0, 1).contiguous().transpose(0, 1), hw, cb)
    with pytest.raises(ValueError, match="float32"):
        vq_assign(x.double(), hw, cb)


# ---------------------------------------------------------------------------
# the quantizer's loops, one launch each: a group's sweep and the EM fit
# ---------------------------------------------------------------------------

def sweep_case(dev, seed, *, r, cg, d, k, rg, sb=0, identity_u=False):
    """A column group's inputs as the quantizer makes them: W (r, cg), U from
    the SPD Hessian of a seeded correlated activation sample (or I), the
    Cholesky weights, scales (ones, or blockwise at ``sb``) and each band's
    codebook from 10 EM steps on the normalized group. Returns them with H."""
    from repro_torch.core import hessian as hes
    from repro_torch.core import normalization as norm
    from repro_torch.core.codebook import mahalanobis_init

    g = torch.Generator(device=dev).manual_seed(seed)
    W = torch.randn((r, cg), generator=g, device=dev) * (
        1.0 + torch.rand((r, 1), generator=g, device=dev))
    A = torch.randn((cg, cg), generator=g, device=dev) / cg ** 0.5
    X = torch.randn((2 * cg, cg), generator=g, device=dev) @ (
        torch.eye(cg, device=dev) + 0.5 * A)
    H = hes.finalize(hes.accumulate(hes.init_hessian(cg, device=dev), X))
    U = (torch.eye(cg, device=dev) if identity_u
         else hes.inv_hessian_cholesky(H))
    wgt = hes.cholesky_diag_weights(hes.inv_hessian_cholesky(H))
    S = (norm.compute_block_scales(W, block=sb).expand(cg).contiguous()
         if sb else torch.ones_like(W))
    spans = cg // d
    Xb = (W / S).reshape(r // rg, rg * spans, d)
    Hw = wgt.reshape(1, spans, d).repeat(rg, 1, 1).reshape(rg * spans, d)
    C = vq_em_plain(Xb, Hw, mahalanobis_init(Xb, k), 10).contiguous()
    return W, U, S, C, wgt, H


def sweep_error(W0, Q, H):
    E = W0 - Q
    return float(torch.sum(E * (E @ H)))


# (r, cg, d, k, rows_per_band, scale_block, exact_span_solve): the presets'
# layouts (core/bpv.PAPER_SETTINGS on 256-column groups), then blockwise
# scales, the per-column solve, ragged rows and bands, a group wider than
# the kernel's threads, and one whose rows leave shared memory
SWEEP_LAYOUTS = [
    (512, 256, 2, 16, 4, 0, True),       # 2.25bpv_2d
    (512, 256, 2, 16, 8, 0, True),       # 2.125bpv_2d
    (256, 256, 4, 256, 128, 0, True),    # 2.25bpv_4d
    (256, 256, 2, 256, 128, 0, True),    # 4.125bpv_2d
    (256, 256, 2, 64, 32, 0, True),      # 3.125bpv_2d
    (256, 256, 1, 4, 1, 0, True),        # 2.125bpv_1d
    (256, 128, 1, 4, 1, 0, True),        # 2.25bpv_1d
    (256, 256, 1, 16, 4, 0, True),       # 4.125bpv_1d
    (512, 256, 2, 16, 4, 32, True),
    (512, 256, 2, 16, 4, 0, False),
    (72, 48, 2, 16, 3, 16, True),
    (40, 640, 2, 16, 4, 32, True),
    (8, 13000, 2, 4, 4, 0, True),
]


@pytest.mark.parametrize("r,cg,d,k,rg,sb,exact", SWEEP_LAYOUTS)
def test_vq_group_sweep_matches_plain(dev, r, cg, d, k, rg, sb, exact):
    W0, U, S, C, wgt, H = sweep_case(dev, r + cg + d, r=r, cg=cg, d=d, k=k,
                                     rg=rg, sb=sb)
    kw = dict(d=d, rows_per_band=rg, exact_span_solve=exact)
    Wk, Wp = W0.clone(), W0.clone()
    before = vq_group_sweep.launches
    Qk, ik, Ek = vq_group_sweep(Wk, U, S, C, wgt, **kw)
    torch.cuda.synchronize()
    assert vq_group_sweep.launches == before + 1
    Qp, ip, Ep = vq_group_sweep_plain(Wp, U, S, C, wgt, **kw)
    # f32 sums in another order can flip a near-tie, which feeds a different
    # error into that row's later columns: indices agree on >= 99% of spans
    # and the group's error tr(E H E^T) within 1%
    assert float((ik == ip).float().mean()) >= 0.99
    ek, ep = sweep_error(W0, Qk, H), sweep_error(W0, Qp, H)
    assert abs(ek - ep) <= 0.01 * ep, (ek, ep)
    rows = (ik == ip).all(dim=1)
    assert float(rows.float().mean()) >= 0.75
    torch.testing.assert_close(Qk[rows], Qp[rows], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(Ek[rows], Ep[rows], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(Wk[rows], Wp[rows], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("r,cg,d,k,rg,sb", [
    (512, 256, 2, 16, 4, 0), (512, 256, 2, 16, 4, 32),
    (256, 256, 4, 256, 128, 0), (256, 256, 1, 4, 1, 0)])
def test_vq_group_sweep_without_feedback_is_vq_assign(dev, r, cg, d, k, rg,
                                                      sb):
    """With U = I no error feeds forward, so every span is a plain
    assignment of the normalized weights: the indices are vq_assign's bits,
    Q is S * C[idx] bit for bit and W is left as it was."""
    from repro_torch.core.gptvq import gather_codebooks

    W0, U, S, C, wgt, _ = sweep_case(dev, 11 * r + d, r=r, cg=cg, d=d, k=k,
                                     rg=rg, sb=sb, identity_u=True)
    W = W0.clone()
    Q, idx, _ = vq_group_sweep(W, U, S, C, wgt, d=d, rows_per_band=rg,
                               exact_span_solve=True)
    spans = cg // d
    Hw = wgt.reshape(1, spans, d).repeat(rg, 1, 1).reshape(rg * spans, d)
    ref = vq_assign((W0 / S).reshape(r // rg, rg * spans, d), Hw, C)
    assert torch.equal(idx, ref.reshape(r, spans))
    assert torch.equal(Q, gather_codebooks(C[None], idx, cg, rg, d) * S)
    assert torch.equal(W, W0)


# (r, cg, d, k, rows_per_band, scale_block): the babai metric mode at the
# smoke config's 2.25bpv_2d and 4d layouts, the quantizer's 256-column
# groups at d = 2 and 4, blockwise scales, and a k = 256 codebook
BABAI_LAYOUTS = [
    (64, 64, 2, 16, 4, 0), (256, 64, 4, 256, 64, 0),
    (512, 256, 2, 16, 4, 0), (256, 256, 4, 256, 128, 0),
    (512, 256, 2, 16, 4, 32), (256, 256, 2, 256, 128, 0)]


@pytest.mark.parametrize("r,cg,d,k,rg,sb", BABAI_LAYOUTS)
def test_vq_group_sweep_babai_matches_plain(dev, r, cg, d, k, rg, sb):
    """The sweep's babai metric mode (y M_j y^T per span) against its plain
    version: indices on >= 99% of spans, the group's error within 1%, the
    same bits from call to call, counted under launches_by_impl["babai"]."""
    W0, U, S, C, wgt, H = sweep_case(dev, 5 * r + cg + d, r=r, cg=cg, d=d,
                                     k=k, rg=rg, sb=sb)
    metric = span_metrics(U, d)
    kw = dict(d=d, rows_per_band=rg, exact_span_solve=True, metric=metric)
    Wk, Wp, W2 = W0.clone(), W0.clone(), W0.clone()
    before = dict(vq_group_sweep.launches_by_impl)
    Qk, ik, Ek = vq_group_sweep(Wk, U, S, C, wgt, **kw)
    torch.cuda.synchronize()
    after = vq_group_sweep.launches_by_impl
    assert after.get("babai", 0) == before.get("babai", 0) + 1
    assert after.get("diag", 0) == before.get("diag", 0)
    Qp, ip, Ep = vq_group_sweep_plain(Wp, U, S, C, wgt, **kw)
    assert float((ik == ip).float().mean()) >= 0.99
    ek, ep = sweep_error(W0, Qk, H), sweep_error(W0, Qp, H)
    assert abs(ek - ep) <= 0.01 * ep, (ek, ep)
    again = vq_group_sweep(W2, U, S, C, wgt, **kw)
    assert all(torch.equal(a, b) for a, b in zip((W2, *again),
                                                 (Wk, Qk, ik, Ek)))
    # the diagonal metric gives another assignment on a correlated U
    _, idiag, _ = vq_group_sweep(W0.clone(), U, S, C, wgt, d=d,
                                 rows_per_band=rg, exact_span_solve=True)
    assert not torch.equal(idiag, ik)


def test_budgeted_quantize_on_cuda_matches_cpu(dev):
    """A budgeted smoke quantize (mixed settings by the allocator, babai on
    every target) on the card against the same run on the CPU: the same
    allocation, per-target errors within 10%, one sweep (babai where d > 1)
    and one EM launch a column group, and one vq_dequant_matmul launch a
    packed leaf in the evaluation."""
    from repro_torch.core.recipe import get_recipe

    cfg = SMOKE["llama2-7b"].scaled(dtype="float32", n_layers=2)
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (8, 32),
                           generator=torch.Generator().manual_seed(0))
    recipe = get_recipe("2.25bpv_2d").with_quantize_overrides(
        em_iters=4, codebook_update_iters=2).with_solver("babai")
    _, rep_cpu = quantize_model(model, params, tokens, recipe=recipe,
                                budget_bpv=2.5)
    params_gpu = {k: (v.to(dev) if torch.is_tensor(v) else
                      [{kk: ({n: t.to(dev) for n, t in vv.items()}
                             if isinstance(vv, dict) else vv.to(dev))
                        for kk, vv in lp.items()} for lp in v])
                  for k, v in params.items()}
    before = (vq_group_sweep.launches, dict(vq_group_sweep.launches_by_impl),
              vq_em.launches, vq_assign.launches)
    q, rep = quantize_model(model, params_gpu, tokens.to(dev), recipe=recipe,
                            budget_bpv=2.5, pack=True)
    torch.cuda.synchronize()
    assert rep.achieved_bpv == rep_cpu.achieved_bpv <= 2.5 + 1e-9
    for name, e in rep.per_target.items():
        assert e["rule"] == rep_cpu.per_target[name]["rule"]
        ref = rep_cpu.per_target[name]["error"]
        assert abs(e["error"] - ref) <= 0.10 * ref, (name, e["error"], ref)
    leaves = [leaf for lp in q["layers"] for sub in (lp["attn"], lp["ffn"])
              for leaf in sub.values()]
    assert len({leaf.d for leaf in leaves}) >= 2  # mixed settings
    want = {"diag": 0, "babai": 0}
    for leaf in leaves:
        want["babai" if leaf.d > 1 else "diag"] += leaf.n_cg
    n_groups = sum(want.values())
    got = {k: vq_group_sweep.launches_by_impl.get(k, 0) - before[1].get(k, 0)
           for k in want}
    assert got == want
    assert (vq_group_sweep.launches - before[0], vq_em.launches - before[2],
            vq_assign.launches - before[3]) == (n_groups, n_groups, 0)
    before = vq_dequant_matmul.launches
    tok = tokens[:2].to(dev)
    lf = model.forward(vql.prepare_fused_tree(q), {"tokens": tok})[0]
    assert vq_dequant_matmul.launches - before == 7 * cfg.n_layers
    lg = model.forward(q, {"tokens": tok})[0]
    torch.testing.assert_close(lf, lg, rtol=1e-4, atol=1e-4)


def em_distortion(X, Hw, C):
    """Per band: sum over points of the weighted distance to the nearest
    centroid."""
    diff = X[:, :, None, :] - C[:, None, :, :]
    dist = torch.sum(Hw.expand(X.shape)[:, :, None, :] * diff * diff, -1)
    return dist.min(dim=-1).values.sum(dim=-1)


# (B, n, d, k, shared hw): the quantizer's 2.25bpv_2d bands, the vq2 KV
# codebook fit, the 4-d and 256-centroid presets' bands, and bands too long
# for their indices to stay in shared memory
EM_SHAPES = [(37, 512, 2, 16, True), (4, 4096, 2, 16, False),
             (3, 8192, 4, 256, True), (2, 16384, 2, 256, True),
             (2, 60000, 1, 4, False)]


@pytest.mark.parametrize("B,n,d,k,shared", EM_SHAPES)
def test_vq_em_matches_plain(dev, B, n, d, k, shared):
    from repro_torch.core.codebook import mahalanobis_init

    g = torch.Generator(device=dev).manual_seed(B * n + k)
    X = torch.randn((B, n, d), generator=g, device=dev)
    Hw = torch.rand((n, d) if shared else (B, n, d), generator=g,
                    device=dev) + 0.1
    C0 = mahalanobis_init(X, k).contiguous()
    C0[0, -1] = 1e3  # no point picks it: it keeps its seed
    before = vq_em.launches
    Ck = vq_em(X, Hw, C0, 10)
    torch.cuda.synchronize()
    assert vq_em.launches == before + 1
    Cp = vq_em_plain(X, Hw, C0, 10)
    # 10 steps of f32 sums in another order (the test of the port against
    # the reference holds the same tolerance)
    torch.testing.assert_close(Ck, Cp, rtol=1e-4, atol=1e-5)
    assert torch.equal(Ck[0, -1], C0[0, -1])
    dk, dp = em_distortion(X, Hw, Ck), em_distortion(X, Hw, Cp)
    assert float(((dk - dp).abs() / dp).mean()) <= 1e-3


def test_vq_sweep_and_em_are_deterministic(dev):
    from repro_torch.core.codebook import mahalanobis_init

    W0, U, S, C, wgt, _ = sweep_case(dev, 3, r=1024, cg=256, d=2, k=16, rg=4)
    runs = []
    for _ in range(2):
        W = W0.clone()
        runs.append((W, *vq_group_sweep(W, U, S, C, wgt, d=2, rows_per_band=4,
                                        exact_span_solve=True)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    X = (W0 / S).reshape(256, 512, 2)
    Hw = wgt.reshape(1, 128, 2).repeat(4, 1, 1).reshape(512, 2)
    C0 = mahalanobis_init(X, 16).contiguous()
    assert torch.equal(vq_em(X, Hw, C0, 25), vq_em(X, Hw, C0, 25))


def test_quantize_on_cuda_matches_cpu(dev):
    cfg = SMOKE["llama2-7b"].scaled(dtype="float32", n_layers=1)
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(0))
    recipe = QuantRecipe.uniform(VQConfig(d=2, bits_per_dim=2,
                                          group_size=1024, em_iters=4,
                                          codebook_update_iters=2))
    _, rep_cpu = quantize_model(model, params, tokens, recipe=recipe)
    params_gpu = {k: (v.to(dev) if torch.is_tensor(v) else
                      [{kk: ({n: t.to(dev) for n, t in vv.items()}
                             if isinstance(vv, dict) else vv.to(dev))
                        for kk, vv in lp.items()} for lp in v])
                  for k, v in params.items()}
    before = (vq_assign.launches, vq_group_sweep.launches, vq_em.launches)
    q, rep = quantize_model(model, params_gpu, tokens.to(dev), recipe=recipe,
                            pack=True)
    # each column group: one EM launch and one sweep launch, no vq_assign
    n_groups = sum(leaf.n_cg for lp in q["layers"]
                   for sub in (lp["attn"], lp["ffn"]) for leaf in sub.values())
    assert n_groups > 0
    assert (vq_assign.launches, vq_group_sweep.launches,
            vq_em.launches) == (before[0], before[1] + n_groups,
                                before[2] + n_groups)
    for name, e in rep.per_target.items():
        ref = rep_cpu.per_target[name]["error"]
        assert abs(e["error"] - ref) <= 0.10 * ref, (name, e["error"], ref)
    before = vq_dequant_matmul.launches
    lf = model.forward(vql.prepare_fused_tree(q), {"tokens": tokens.to(dev)})[0]
    assert vq_dequant_matmul.launches - before == 7
    lg = model.forward(q, {"tokens": tokens.to(dev)})[0]
    torch.testing.assert_close(lf, lg, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

PAGE_FORMATS = ["f32", "bf16", 8, 4, "vq2"]


def paged_case(dev, seed, *, B, H, KV, hd, page_size, n_pages, num_blocks,
               fmt, pos=None, q_dtype=torch.float32):
    """Random pools in ``fmt`` (quantized through kernels/kv_quant), a page
    table mapping each slot's live pages to distinct blocks (scratch block 0
    past them), ragged positions; slots with pos 0 get an all-scratch row."""
    from repro_torch.kernels import kv_quant as kvq

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(q_dtype)
    shape = (num_blocks, page_size, KV, hd)
    kp = torch.randn(shape, generator=g, device=dev)
    vp = torch.randn(shape, generator=g, device=dev)
    kw = {}
    if fmt == "bf16":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    elif fmt == "vq2":
        kcb = torch.randn((KV, kvq.VQ_K, kvq.VQ_D), generator=g, device=dev)
        vcb = torch.randn((KV, kvq.VQ_K, kvq.VQ_D), generator=g, device=dev)
        kp, ks = kvq.vq_quantize_rows(kp, kcb)
        vp, vs = kvq.vq_quantize_rows(vp, vcb)
        kw = dict(k_scale=ks, v_scale=vs, k_codebook=kcb, v_codebook=vcb)
    elif fmt in (8, 4):
        kp, ks = kvq.quantize_kv(kp, fmt)
        vp, vs = kvq.quantize_kv(vp, fmt)
        kw = dict(k_scale=ks, v_scale=vs)
    if pos is None:
        pos = torch.randint(0, n_pages * page_size, (B,), generator=g,
                            device=dev).tolist()
    table = torch.zeros((B, n_pages), dtype=torch.int32)
    free = (torch.randperm(num_blocks - 1, generator=torch.Generator()
                           .manual_seed(seed)) + 1).tolist()
    for b in range(B):
        if pos[b] == 0:
            continue  # idle slot: all-scratch table row
        for p in range(min(pos[b] // page_size + 1, n_pages)):
            table[b, p] = free.pop() if free else 0
    return (q, kp.contiguous(), vp.contiguous(), table.to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev), kw)


@pytest.mark.parametrize("fmt", PAGE_FORMATS)
@pytest.mark.parametrize("B,H,KV,hd,page_size,n_pages,num_blocks,pos", [
    (4, 32, 32, 128, 16, 16, 65, [0, 37, 255, 16]),   # the serve shape
    (2, 64, 8, 128, 16, 16, 33, [100, 0]),            # G = 8 (qwen2-72b)
    (3, 8, 2, 64, 8, 6, 32, None),                    # G = 4, ragged
    (5, 4, 2, 32, 1, 16, 90, None),                   # page_size 1
    (2, 16, 4, 8, 32, 2, 6, [63, 5]),                 # narrow hd, 2 pages
    (1, 4, 1, 256, 64, 3, 4, [191]),                  # > 48 KB of smem
    (2, 4, 2, 512, 4, 40, 80, [150, 3]),              # hd > 256: wide
    # Llama-2-7B's 4096-token context: 256 pages a slot, many splits
    (3, 32, 32, 128, 16, 256, 520, [4095, 1234, 0]),  # G = 1
    (3, 64, 8, 128, 16, 256, 520, [4095, 0, 2900]),   # G = 8
    # pos on the edge of a split (256 rows at G = 1, 64 at G = 8), one row
    # short of it and one row past it
    (3, 8, 8, 128, 16, 32, 60, [256, 255, 257]),      # G = 1
    (3, 16, 2, 128, 16, 32, 20, [64, 63, 65])])       # G = 8
def test_paged_attention_matches_plain(dev, fmt, B, H, KV, hd, page_size,
                                       n_pages, num_blocks, pos):
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain)

    q, kp, vp, table, pos_t, kw = paged_case(
        dev, B + H + hd, B=B, H=H, KV=KV, hd=hd, page_size=page_size,
        n_pages=n_pages, num_blocks=num_blocks, fmt=fmt, pos=pos)
    before = paged_attention.launches
    got = paged_attention(q, kp, vp, table, pos_t, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_plain(q, kp, vp, table, pos_t, **kw)
    assert got.dtype == q.dtype and bool(torch.isfinite(got).all())
    # online softmax and FMA dot products: f32 sums in another order
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fmt", PAGE_FORMATS)
def test_paged_attention_bf16_query(dev, fmt):
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain)

    q, kp, vp, table, pos_t, kw = paged_case(
        dev, 7, B=3, H=16, KV=4, hd=128, page_size=16, n_pages=8,
        num_blocks=30, fmt=fmt, pos=[0, 50, 127], q_dtype=torch.bfloat16)
    got = paged_attention(q, kp, vp, table, pos_t, **kw)
    want = paged_attention_plain(q, kp, vp, table, pos_t, **kw)
    assert got.dtype == torch.bfloat16
    # both round f32 results ~1e-6 apart to bf16, so they differ by at
    # most one bf16 ulp, 2^-7 of the value
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7,
                               atol=1e-5)


@pytest.mark.parametrize("fmt", PAGE_FORMATS)
@pytest.mark.parametrize("H,KV", [(32, 32), (64, 8)])
def test_paged_attention_slot_is_bitwise_independent(dev, fmt, H, KV):
    """Slot b's output is the same bits alone (B = 1: its q row, table row
    and pos) as inside a batch with other positions, and from call to
    call: the split plan depends on no B, n_pages or other slot."""
    from repro_torch.kernels.paged_attention import paged_attention

    q, kp, vp, table, pos_t, kw = paged_case(
        dev, 11, B=4, H=H, KV=KV, hd=128, page_size=16, n_pages=256,
        num_blocks=700, fmt=fmt, pos=[4000, 17, 0, 2047])
    y = paged_attention(q, kp, vp, table, pos_t, **kw)
    assert torch.equal(paged_attention(q, kp, vp, table, pos_t, **kw), y)
    for b in range(4):
        alone = paged_attention(q[b:b + 1].contiguous(), kp, vp,
                                table[b:b + 1].contiguous(),
                                pos_t[b:b + 1].contiguous(), **kw)
        assert torch.equal(alone[0], y[b]), b


def test_paged_attention_unaligned_pools(dev):
    """Pools whose rows are not 16-byte multiples or start off a 16-byte
    boundary (8- and 4-byte copies, plain loads below 4 bytes)."""
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain)

    def shifted(pool, offset):
        """``pool``'s values in a buffer, ``offset`` elements in."""
        buf = torch.empty(pool.numel() + offset, dtype=pool.dtype,
                          device=pool.device)
        view = buf[offset:].view(pool.shape)
        view.copy_(pool)
        return view

    for fmt, hd in (("f32", 6), ("bf16", 6), (8, 12), (4, 6), ("vq2", 8)):
        q, kp, vp, table, pos_t, kw = paged_case(
            dev, 5, B=2, H=4, KV=2, hd=hd, page_size=8, n_pages=4,
            num_blocks=12, fmt=fmt, pos=[29, 3])
        want = paged_attention_plain(q, kp, vp, table, pos_t, **kw)
        for offset in (0, 1):
            got = paged_attention(q, shifted(kp, offset), shifted(vp, offset),
                                  table, pos_t, **kw)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_paged_attention_rejects_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.paged_attention import paged_attention

    q, kp, vp, table, pos_t, kw = paged_case(
        dev, 1, B=2, H=4, KV=2, hd=16, page_size=4, n_pages=4,
        num_blocks=10, fmt="vq2")
    before = paged_attention.launches
    with pytest.raises(ValueError, match="head_dim % 4"):
        paged_attention(torch.zeros((2, 4, 18), device=dev), kp, vp, table,
                        pos_t, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1), kp,
                        vp, table, pos_t, **kw)
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q, kp, vp, table.long(), pos_t, **kw)
    assert paged_attention.launches == before


def _to(tree, dev):
    """A param tree (dicts, lists, tensors, VQLinear leaves) on ``dev``."""
    import dataclasses

    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    if isinstance(tree, vql.VQLinear):
        return dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name).to(dev)
            for f in dataclasses.fields(tree)
            if torch.is_tensor(getattr(tree, f.name))})
    return tree.to(dev)


@pytest.mark.parametrize("kv_bits", [16, 8, 4, "vq2"])
def test_engine_on_cuda_matches_cpu(dev, kv_bits):
    """The smoke config, GPTVQ-packed on the CPU, served by the same engine
    on the card (fused paged attention and fused VQ matmul: both kernels)
    and on the CPU (their plain versions). Greedy tokens must agree; where
    a near-tie flips one, the teacher-forced logits of the CUDA run on the
    CPU run's tokens must stay within 1e-3 RMS (f32 sums in another
    order)."""
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serve import paged_cache as pc
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.serve_step import teacher_forced_logits

    cfg = SMOKE["llama2-7b"].scaled(dtype="float32", n_layers=2, d_model=64,
                                    vocab_size=256, max_seq_len=64)
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    calib = torch.randint(0, cfg.vocab_size, (8, 32),
                          generator=torch.Generator().manual_seed(0))
    recipe = QuantRecipe.uniform(VQConfig(d=2, bits_per_dim=2,
                                          group_size=1024, em_iters=4,
                                          codebook_update_iters=2))
    q, _ = quantize_model(model, params, calib, recipe=recipe, pack=True)
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 255, (s,), generator=rng).numpy()
               for s in (5, 9, 3, 12)]
    out = {}
    for where in ("cpu", dev):
        eng = Engine(model, _to(q, where), max_batch=2, max_len=64,
                     page_size=8, paged_attn_impl="fused",
                     vq_matmul_impl="fused", kv_cache_bits=kv_bits,
                     device=where)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        before = paged_attention.launches
        eng.run(reqs)
        launched = paged_attention.launches - before
        assert launched == (eng.stats["decode_ticks"] * cfg.n_layers
                            if where == dev else 0)
        out[str(where)] = (eng, [r.out_tokens for r in reqs])
    (eng_c, toks_c), (eng_g, toks_g) = out["cpu"], out[str(dev)]
    if toks_c == toks_g:
        return
    for p, tc in zip(prompts, toks_c):
        traces = []
        for eng in (eng_c, eng_g):
            cache = model.init_cache(1, 64, dtype=torch.float32,
                                     paged=eng.layout, device=eng.device)
            cache = pc.push_page_table(
                cache, torch.arange(1, 9, dtype=torch.int32)[None])
            if kv_bits == "vq2":  # the CPU engine's codebooks for both
                cache = [c._replace(k_codebook=e.k_codebook.to(eng.device),
                                    v_codebook=e.v_codebook.to(eng.device))
                         for c, e in zip(cache, eng_c.cache)]
            traces.append(teacher_forced_logits(
                model, eng.params, p, tc[:-1], cache=cache,
                paged_impl="fused").cpu())
        rms = float((traces[0] - traces[1]).pow(2).mean().sqrt())
        assert rms <= 1e-3, rms


# ---------------------------------------------------------------------------
# flash attention (sequences past 2048 tokens)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,q_offset,dt", [
    (2, 256, 256, 8, 4, 64, True, 0, torch.float32),
    (2, 256, 256, 8, 4, 64, False, 0, torch.float32),
    (1, 128, 128, 4, 4, 32, True, 0, torch.bfloat16),
    (2, 128, 128, 8, 2, 128, True, 0, torch.float32),   # hd 128, G = 4
    (1, 512, 512, 4, 4, 128, True, 0, torch.bfloat16),  # hd 128
    (2, 64, 192, 4, 2, 32, True, 128, torch.float32),   # q_offset
    (1, 1, 64, 4, 2, 16, True, 63, torch.float32),      # one row
    (1, 100, 900, 2, 1, 112, False, 0, torch.float32),  # ragged tiles
    (1, 3072, 3072, 2, 2, 96, True, 0, torch.bfloat16),  # past 2048
    (1, 512, 2048, 8, 1, 128, False, 0, torch.float32),  # G = 8, Sk != Sq
])
def test_flash_attention_matches_plain(dev, B, Sq, Sk, H, KV, hd, causal,
                                       q_offset, dt):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(Sq + Sk + hd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dt)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dt)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == dt and bool(torch.isfinite(got).all())
    # f32: online softmax over 64-column tiles and FMA dot products sum in
    # another order; bf16 output: both round f32 results ~1e-6 apart, so
    # they differ by at most one bf16 ulp, 2^-7 of the value
    rtol = 1e-5 if dt == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.bfloat16),   # f32 queries over a bf16 cache
    (torch.bfloat16, torch.float32),   # a bf16 model over an f32 cache
])
def test_flash_attention_mixed_dtypes(dev, q_dt, kv_dt):
    """Queries and the dense cache's k/v in different dtypes (the prefill
    through ``apply``); the output takes q's dtype."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((1, 256, 4, 64), generator=g, device=dev).to(q_dt)
    k = torch.randn((1, 256, 2, 64), generator=g, device=dev).to(kv_dt)
    v = torch.randn((1, 256, 2, 64), generator=g, device=dev).to(kv_dt)
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == q_dt
    rtol = 1e-5 if q_dt == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v, causal=True).float(), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,q_offset", [
    (1, 100, 900, 4, 2, 32, False, 0),   # ragged tiles, GQA
    (2, 256, 256, 8, 4, 64, True, 0),    # GQA
    (1, 96, 352, 4, 4, 96, True, 256),   # q_offset, ragged
    (1, 200, 200, 2, 1, 112, True, 0),   # ragged causal, G = 2
    (2, 512, 512, 4, 4, 128, True, 0),
    (1, 64, 1024, 8, 1, 128, False, 0),  # G = 8, Sk != Sq
    (1, 1, 64, 4, 2, 16, True, 63),      # one row
    (1, 2048, 2048, 2, 2, 128, True, 0),
])
def test_flash_attention_tensor_cores(dev, B, Sq, Sk, H, KV, hd, causal,
                                      q_offset):
    """bf16 q, k, v with head_dim a multiple of 16 take the tensor-core
    variant, within one bf16 ulp of the plain version (p kept exact as
    three bf16 terms)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(Sq + Sk + hd + H)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    before = dict(flash_attention.launches_by_impl)
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_impl.get("tc", 0) == before.get(
        "tc", 0) + 1
    assert flash_attention.launches_by_impl.get("fp32", 0) == before.get(
        "fp32", 0)
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    # both round f32 results ~1e-6 apart to bf16: one bf16 ulp at most
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7,
                               atol=1e-5)


def test_flash_attention_tensor_cores_keep_every_term_of_p(dev):
    """The tensor-core variant's p.v carries all three bf16 terms of the
    f32 p: as few of its bf16 outputs differ from bf16(plain) as of the
    FP32 variant's on the same values, and far fewer than of controls
    that keep only p1 = bf16(p), or p1 + p2 (f32 attention in one softmax
    pass)."""
    from repro_torch.kernels.flash_attention import (
        _scale, flash_attention, flash_attention_plain)

    S, H, hd = 4096, 4, 128
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((1, S, H, hd), generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    ref = flash_attention_plain(q, k, v, causal=True)
    before = dict(flash_attention.launches_by_impl)
    tc = flash_attention(q, k, v, causal=True)
    fp32 = flash_attention(q.float(), k, v, causal=True).to(torch.bfloat16)
    assert {n: c - before.get(n, 0) for n, c in
            flash_attention.launches_by_impl.items()} == {"tc": 1, "fp32": 1}
    qh, kh, vh = (t[0].float().transpose(0, 1) for t in (q, k, v))
    s = (qh @ kh.transpose(1, 2)) * _scale(hd)
    s = s.masked_fill(torch.ones((S, S), dtype=torch.bool,
                                 device=dev).triu(1), -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p1 = p.to(torch.bfloat16).float()
    p2 = (p - p1).to(torch.bfloat16).float()
    l = p.sum(dim=-1, keepdim=True)

    def out(pp):  # (H, S, S) probabilities -> (1, S, H, hd) in bf16
        return (pp @ vh / l).transpose(0, 1)[None].to(torch.bfloat16)

    n_tc, n_fp32, n_p1, n_p12 = (int((o != ref).sum()) for o in (
        tc, fp32, out(p1), out(p1 + p2)))
    assert n_tc <= 1.5 * n_fp32 + 16, (n_tc, n_fp32)
    # p2 and p3 both show: without them many more outputs move
    assert 10 * n_tc <= n_p1 and 2 * n_tc <= n_p12, (n_tc, n_p1, n_p12)


@pytest.mark.parametrize("q_dt,kv_dt,hd,impl", [
    (torch.bfloat16, torch.bfloat16, 64, "tc"),
    (torch.bfloat16, torch.bfloat16, 36, "fp32"),  # hd not a multiple of 16
    (torch.float32, torch.float32, 64, "fp32"),
    (torch.bfloat16, torch.float32, 64, "fp32"),
    (torch.float32, torch.bfloat16, 64, "fp32"),
])
def test_flash_attention_variant_by_dtype_and_head_dim(dev, q_dt, kv_dt, hd,
                                                       impl):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(hd)
    q = torch.randn((1, 128, 4, hd), generator=g, device=dev).to(q_dt)
    k = torch.randn((1, 128, 2, hd), generator=g, device=dev).to(kv_dt)
    v = torch.randn((1, 128, 2, hd), generator=g, device=dev).to(kv_dt)
    before = dict(flash_attention.launches_by_impl)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    got_impl = {k_: n - before.get(k_, 0)
                for k_, n in flash_attention.launches_by_impl.items()
                if n != before.get(k_, 0)}
    assert got_impl == {impl: 1}
    rtol = 1e-5 if q_dt == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v, causal=True).float(), rtol=rtol, atol=1e-5)


# the fp32 variant: every f32 operand split into three exact bf16 terms on
# the tensor cores. Each case at the zoo's head dims, a head dim that is
# not a multiple of 16 (72) and both mixed dtype pairs; held to the f32
# bars, the same bits twice, and each f32 output's error at most a tenth
# of the one-term TF32 plain version's (a split that dropped a needed term
# would sit near it)
SPLIT_CASES = [
    pytest.param(hd, q_dt, kv_dt, id=f"hd{hd}-{n}")
    for hd, q_dt, kv_dt, n in (
        (64, torch.float32, torch.float32, "f32"),
        (96, torch.float32, torch.float32, "f32"),
        (112, torch.float32, torch.float32, "f32"),
        (128, torch.float32, torch.float32, "f32"),
        (72, torch.float32, torch.float32, "f32"),
        (128, torch.float32, torch.bfloat16, "q_f32-kv_bf16"),
        (128, torch.bfloat16, torch.float32, "q_bf16-kv_f32"),
        (72, torch.float32, torch.bfloat16, "q_f32-kv_bf16"),
        (72, torch.bfloat16, torch.float32, "q_bf16-kv_f32"))]


def _one_term_tf32(fn):
    """``fn()`` with float32 matmuls in TF32 (one term of each operand),
    the flag restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("hd,q_dt,kv_dt", SPLIT_CASES)
def test_flash_attention_fp32_split(dev, hd, q_dt, kv_dt):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(hd + 5)
    q = torch.randn((2, 384, 4, hd), generator=g, device=dev).to(q_dt)
    k = torch.randn((2, 384, 2, hd), generator=g, device=dev).to(kv_dt)
    v = torch.randn((2, 384, 2, hd), generator=g, device=dev).to(kv_dt)
    before = dict(flash_attention.launches_by_impl)
    got = flash_attention(q, k, v, causal=True)
    again = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert {n: c - before.get(n, 0) for n, c in
            flash_attention.launches_by_impl.items()
            if c != before.get(n, 0)} == {"fp32": 2}
    assert torch.equal(got, again)
    want = flash_attention_plain(q, k, v, causal=True)
    rtol = 1e-5 if q_dt == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)
    if got.dtype == torch.float32:
        one_term = _one_term_tf32(lambda: flash_attention_plain(
            q, k, v, causal=True))
        err = float((got - want).abs().max())
        assert err <= 0.1 * float((one_term - want).abs().max()), err


def test_flash_attention_rejects_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.randn((1, 64, 4, 32), device=dev)
    k = torch.randn((1, 64, 2, 32), device=dev)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(torch.randn((1, 64, 2, 256), device=dev),
                        torch.randn((1, 64, 2, 256), device=dev),
                        torch.randn((1, 64, 2, 256), device=dev),
                        causal=True)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q.half(), k, k, causal=True)
    with pytest.raises(ValueError, match="one device|contiguous"):
        flash_attention(q, k.cpu(), k, causal=True)
    with pytest.raises(ValueError, match="reference's chunks"):
        flash_attention(torch.randn((1, 600, 4, 32), device=dev), k, k,
                        causal=False)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, k, causal=True, q_offset=-1)
    assert flash_attention.launches == before


def test_pre_out_past_2048_launches_the_kernel(dev):
    """On the card, pre_out and the dense-cache prefill take the kernel for
    S > 2048 (one launch each), and agree with the CPU (plain version)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention
    from repro_torch.obs import dispatch

    cfg = SMOKE["llama2-7b"].scaled(dtype="float32", max_seq_len=4096)
    params = model_zoo.build(cfg).init_params(seed=0, device="cpu")
    p_cpu = params["layers"][0]["attn"]
    p_gpu = {k: v.to(dev) for k, v in p_cpu.items()}
    x = torch.randn((1, 4096, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    dispatch.reset_dispatch_counters()
    before = flash_attention.launches
    got = attention.pre_out(p_gpu, cfg, x.to(dev))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert dispatch.snapshot_dispatch_counters()["flash"]["fused"] == 1
    want = attention.pre_out(p_cpu, cfg, x)
    assert flash_attention.launches == before + 1  # the CPU runs no kernel
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    cache = attention.init_cache(cfg, 1, 4096, dtype=torch.float32,
                                 device=dev)
    y, _ = attention.apply(p_gpu, cfg, x.to(dev), pos=0, cache=cache)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert bool(torch.isfinite(y).all())
    # short sequences stay on the dense softmax: no launch
    attention.pre_out(p_gpu, cfg, x[:, :2048].to(dev))
    assert flash_attention.launches == before + 2


# ---------------------------------------------------------------------------
# the vlm and ssm families' shapes: Phi-3-vision's head_dim 96 (32 heads,
# MHA) and xLSTM-125M's projection widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", PAGE_FORMATS)
def test_paged_attention_hd96(dev, fmt, q_dtype):
    """The vlm serve shape: 32 heads of 96 (24 of a row's 32 lanes hold
    dims; a vq2 row is 24 bytes), 16 pages a slot, an idle slot; bitwise
    the same alone and in the batch."""
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain)

    q, kp, vp, table, pos_t, kw = paged_case(
        dev, 96, B=4, H=32, KV=32, hd=96, page_size=16, n_pages=16,
        num_blocks=65, fmt=fmt, pos=[0, 57, 255, 135], q_dtype=q_dtype)
    y = paged_attention(q, kp, vp, table, pos_t, **kw)
    want = paged_attention_plain(q, kp, vp, table, pos_t, **kw)
    assert y.dtype == q_dtype and bool(torch.isfinite(y).all())
    # f32: sums in another order; bf16: at most one bf16 ulp
    rtol, atol = ((2e-5, 2e-5) if q_dtype == torch.float32
                  else (2.0**-7, 1e-5))
    torch.testing.assert_close(y.float(), want.float(), rtol=rtol, atol=atol)
    assert torch.equal(paged_attention(q, kp, vp, table, pos_t, **kw), y)
    for b in range(4):
        alone = paged_attention(q[b:b + 1].contiguous(), kp, vp,
                                table[b:b + 1].contiguous(),
                                pos_t[b:b + 1].contiguous(), **kw)
        assert torch.equal(alone[0], y[b]), b


@pytest.mark.parametrize("dt,impl", [(torch.bfloat16, "tc"),
                                     (torch.float32, "fp32")])
def test_flash_attention_hd96(dev, dt, impl):
    """Phi-3-vision's heads past 2048 tokens: the tensor-core body at
    HD = 96 (shared-memory rows of 104 bf16, 6 k-steps, 12 n-tiles) within
    one bf16 ulp of the plain version, the FP32 one at its own tolerance."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(96)
    q, k, v = (torch.randn((1, 3072, 4, 96), generator=g, device=dev).to(dt)
               for _ in range(3))
    before = dict(flash_attention.launches_by_impl)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_impl.get(impl, 0) == before.get(
        impl, 0) + 1
    want = flash_attention_plain(q, k, v, causal=True)
    rtol = 1e-5 if dt == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)


@pytest.mark.parametrize("N,K", [(1536, 768), (1536, 1536), (768, 1536),
                                 (768, 768), (768, 1024)])
@pytest.mark.parametrize("M,sub", [(4, 1), (64, 17)])
def test_vq_dequant_matmul_rows_independent_xlstm(dev, N, K, M, sub):
    """xLSTM-125M's widths (mLSTM up, q/k/v/o and down; the sLSTM's input
    projections and its FFN's w_out) at
    2.25bpv_2d's layout: allclose to the plain version, row m the same bits
    whatever the other rows hold (split-K at M = 4, tensor cores at 64)."""
    x, words, cb, _, cb_i8, cb_scale, kw = _vq_case(
        dev, M, N, K, 2, 2, 4, 256, 0, torch.bfloat16, True)
    run = lambda xx: vq_dequant_matmul(xx, words, cb, codebooks_i8=cb_i8,
                                       cb_scale=cb_scale, **kw)
    y = run(x)
    plain_kw = {k: v for k, v in kw.items() if k != "k_c"}
    torch.testing.assert_close(
        y, vq_dequant_matmul_plain(x, words, cb, None, **plain_kw),
        rtol=1e-4, atol=1e-4)
    assert torch.equal(run(x), y)
    assert torch.equal(run(x[:sub].contiguous()), y[:sub])
    other = x.clone()
    other[sub:] = -other[sub:]
    assert torch.equal(run(other)[:sub], y[:sub])


# ---------------------------------------------------------------------------
# the hybrid family's shapes: Zamba2-7B's shared attention (32 heads of 112,
# MHA) and its Mamba2 projections (in_proj 3584 -> 14,576, out_proj 7168 ->
# 3584)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", PAGE_FORMATS)
def test_paged_attention_hd112_zamba(dev, fmt, q_dtype):
    """The hybrid serve shape: 32 heads of 112 (28 of a row's 32 lanes hold
    dims; an int4 row is 56 bytes, a vq2 row 28, read 4 bytes at a time),
    16 pages a slot, an idle slot; bitwise the same alone and in the
    batch."""
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain)

    q, kp, vp, table, pos_t, kw = paged_case(
        dev, 112, B=4, H=32, KV=32, hd=112, page_size=16, n_pages=16,
        num_blocks=65, fmt=fmt, pos=[0, 57, 255, 135], q_dtype=q_dtype)
    y = paged_attention(q, kp, vp, table, pos_t, **kw)
    want = paged_attention_plain(q, kp, vp, table, pos_t, **kw)
    assert y.dtype == q_dtype and bool(torch.isfinite(y).all())
    rtol, atol = ((2e-5, 2e-5) if q_dtype == torch.float32
                  else (2.0**-7, 1e-5))
    torch.testing.assert_close(y.float(), want.float(), rtol=rtol, atol=atol)
    assert torch.equal(paged_attention(q, kp, vp, table, pos_t, **kw), y)
    for b in range(4):
        alone = paged_attention(q[b:b + 1].contiguous(), kp, vp,
                                table[b:b + 1].contiguous(),
                                pos_t[b:b + 1].contiguous(), **kw)
        assert torch.equal(alone[0], y[b]), b


@pytest.mark.parametrize("dt,impl", [(torch.bfloat16, "tc"),
                                     (torch.float32, "fp32")])
def test_flash_attention_hd112_zamba(dev, dt, impl):
    """Zamba2-7B's shared attention past 2048 tokens: the tensor-core body
    at HD = 112 (7 k-steps, 14 n-tiles) within one bf16 ulp of the plain
    version, the FP32 one at its own tolerance."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(112)
    q, k, v = (torch.randn((1, 3072, 4, 112), generator=g,
                           device=dev).to(dt) for _ in range(3))
    before = dict(flash_attention.launches_by_impl)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_impl.get(impl, 0) == before.get(
        impl, 0) + 1
    want = flash_attention_plain(q, k, v, causal=True)
    rtol = 1e-5 if dt == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)


@pytest.mark.parametrize("N,K", [(14576, 3584), (3584, 7168)])
@pytest.mark.parametrize("M,sub", [(4, 1), (64, 17), (512, 17)])
def test_vq_dequant_matmul_rows_independent_zamba(dev, N, K, M, sub):
    """Zamba2-7B's Mamba2 in_proj (N = 14,576: the last 64-row tile holds
    48 rows) and out_proj at 2.25bpv_2d's layout: within 1e-4 of the
    output's largest magnitude of the plain version (the kernels phase's
    bar: f32 sums over K = 3584-7168 products of O(1) in another order
    differ by ~eps x K near a cancellation, so a bar relative to each
    element would read rounding), row m the same bits whatever the other
    rows hold (split-K at M = 4, tensor cores at 64 and 512)."""
    x, words, cb, _, cb_i8, cb_scale, kw = _vq_case(
        dev, M, N, K, 2, 2, 4, 256, 0, torch.bfloat16, True)
    run = lambda xx: vq_dequant_matmul(xx, words, cb, codebooks_i8=cb_i8,
                                       cb_scale=cb_scale, **kw)
    y = run(x)
    plain_kw = {k: v for k, v in kw.items() if k != "k_c"}
    want = vq_dequant_matmul_plain(x, words, cb, None, **plain_kw)
    assert float((y - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(run(x), y)
    assert torch.equal(run(x[:sub].contiguous()), y[:sub])
    other = x.clone()
    other[sub:] = -other[sub:]
    assert torch.equal(run(other)[:sub], y[:sub])


# ---------------------------------------------------------------------------
# the audio family's shapes: whisper-small's attention (12 heads of 64, MHA:
# two page rows in a warp at lanes_per_row 16) and its MLP (w_in 768 ->
# 3072, w_out 3072 -> 768) at the decode tick's, a prefill chunk's and the
# encoder evaluation's rows (8 x 1,500)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", PAGE_FORMATS)
def test_paged_attention_hd64_whisper(dev, fmt, q_dtype):
    """The audio serve shape: 12 heads of 64 over 12 kv heads (G = 1), 16
    pages a slot, an idle slot: within the kernel's tolerance of the plain
    version, each slot bitwise the same alone and in the batch, and from
    call to call (the cross-unit merge of two rows a warp)."""
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_plain, split_plan)

    assert split_plan(16, 64, 1, 0).lanes_per_row == 16  # f32 pages
    q, kp, vp, table, pos_t, kw = paged_case(
        dev, 64, B=4, H=12, KV=12, hd=64, page_size=16, n_pages=16,
        num_blocks=65, fmt=fmt, pos=[0, 57, 255, 135], q_dtype=q_dtype)
    y = paged_attention(q, kp, vp, table, pos_t, **kw)
    want = paged_attention_plain(q, kp, vp, table, pos_t, **kw)
    assert y.dtype == q_dtype and bool(torch.isfinite(y).all())
    rtol, atol = ((2e-5, 2e-5) if q_dtype == torch.float32
                  else (2.0**-7, 1e-5))
    torch.testing.assert_close(y.float(), want.float(), rtol=rtol, atol=atol)
    assert torch.equal(paged_attention(q, kp, vp, table, pos_t, **kw), y)
    for b in range(4):
        alone = paged_attention(q[b:b + 1].contiguous(), kp, vp,
                                table[b:b + 1].contiguous(),
                                pos_t[b:b + 1].contiguous(), **kw)
        assert torch.equal(alone[0], y[b]), b


@pytest.mark.parametrize("N,K", [(3072, 768), (768, 3072)])
@pytest.mark.parametrize("M,sub", [(4, 1), (64, 17), (12000, 17)])
def test_vq_dequant_matmul_rows_independent_whisper(dev, N, K, M, sub):
    """whisper-small's w_in and w_out at 2.25bpv_2d's layout (256-column
    groups of 4 rows): within 1e-4 of the output's largest magnitude of the
    plain version, row m the same bits whatever the other rows hold
    (split-K at M = 4, tensor cores at 64 and at the encoder evaluation's
    12,000)."""
    x, words, cb, _, cb_i8, cb_scale, kw = _vq_case(
        dev, M, N, K, 2, 2, 4, 256, 0, torch.bfloat16, True)
    run = lambda xx: vq_dequant_matmul(xx, words, cb, codebooks_i8=cb_i8,
                                       cb_scale=cb_scale, **kw)
    y = run(x)
    plain_kw = {k: v for k, v in kw.items() if k != "k_c"}
    want = vq_dequant_matmul_plain(x, words, cb, None, **plain_kw)
    assert float((y - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(run(x), y)
    assert torch.equal(run(x[:sub].contiguous()), y[:sub])
    other = x.clone()
    other[sub:] = -other[sub:]
    assert torch.equal(run(other)[:sub], y[:sub])


# ---------------------------------------------------------------------------
# flash attention's backward (training past 2048 tokens): the backward
# kernel against its plain version on the same q, k, v, out, dout and lse
# (the forward kernel's), every dtype pair, GQA, q_offset, ragged tiles;
# `-k flash_bwd` runs these alone
# ---------------------------------------------------------------------------

def _flash_bwd_inputs(dev, B, Sq, Sk, H, KV, hd, causal, q_offset, q_dt,
                      kv_dt, seed=0):
    from repro_torch.kernels.flash_attention import _launch_forward

    g = torch.Generator(device=dev).manual_seed(seed + Sq + Sk + hd + H)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(q_dt)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(kv_dt)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(kv_dt)
    dout = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(q_dt)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    out = _launch_forward(q, k, v, causal, q_offset, lse)
    return q, k, v, out, dout, lse


def _bwd_rule(q_dt, kv_dt, hd):
    """The backward's variant for aligned inputs: tc for bf16 q, k, v with
    a head dim that is a multiple of 16, fp32 otherwise."""
    both_bf16 = q_dt == kv_dt == torch.bfloat16
    return "tc" if both_bf16 and hd % 16 == 0 else "fp32"


def _bwd_impl_delta(before):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    return {n: c - before.get(n, 0)
            for n, c in flash_attention_bwd.launches_by_impl.items()
            if c != before.get(n, 0)}


def _within_bwd_bars(got, want):
    """f32: rtol 1e-4, atol 1e-5 * max|g|; bf16: one bf16 rounding of the
    f32 plain result (2^-8 of it) plus 1e-3 * max|g|."""
    scale = float(want.abs().max())
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        err = (got.float() - want).abs()
        assert bool((err <= 2.0**-8 * want.abs() + 1e-3 * scale).all()), (
            float(err.max()), scale)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,q_offset", [
    (2, 256, 256, 8, 4, 64, True, 0),      # GQA
    (2, 256, 256, 4, 4, 128, False, 0),    # hd 128, non-causal
    (1, 64, 192, 4, 2, 32, True, 128),     # q_offset
    (1, 100, 900, 4, 1, 112, False, 0),    # ragged tiles, G = 4
    (1, 200, 200, 2, 1, 96, True, 0),      # ragged causal
    (1, 512, 2048, 8, 1, 128, True, 1536),  # q_offset, G = 8
    (1, 1, 64, 4, 2, 16, True, 63),        # one row
    (1, 128, 128, 2, 2, 36, True, 0),      # hd not a multiple of 16
])
@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_flash_bwd_matches_plain(dev, B, Sq, Sk, H, KV, hd, causal,
                                 q_offset, q_dt, kv_dt):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)

    q, k, v, out, dout, lse = _flash_bwd_inputs(
        dev, B, Sq, Sk, H, KV, hd, causal, q_offset, q_dt, kv_dt)
    before = flash_attention_bwd.launches
    by_impl = dict(flash_attention_bwd.launches_by_impl)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                     q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    assert _bwd_impl_delta(by_impl) == {_bwd_rule(q_dt, kv_dt, hd): 1}
    assert (dq.dtype, dk.dtype, dv.dtype) == (q_dt, kv_dt, kv_dt)
    # the f32 plain result on the same (upcast) values
    want = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), dout.float(), lse,
        causal=causal, q_offset=q_offset)
    for got, w in zip((dq, dk, dv), want):
        assert bool(torch.isfinite(got).all())
        _within_bwd_bars(got, w)


@pytest.mark.parametrize("q_dt", [torch.float32, torch.bfloat16])
def test_flash_bwd_same_bits_twice(dev, q_dt):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    args = _flash_bwd_inputs(dev, 2, 512, 512, 8, 2, 128, True, 0, q_dt,
                             q_dt)
    by_impl = dict(flash_attention_bwd.launches_by_impl)
    a = flash_attention_bwd(*args, causal=True)
    b = flash_attention_bwd(*args, causal=True)
    torch.cuda.synchronize()
    assert _bwd_impl_delta(by_impl) == {_bwd_rule(q_dt, q_dt, 128): 2}
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("q_dt,kv_dt,hd,misaligned,impl", [
    (torch.bfloat16, torch.bfloat16, 64, None, "tc"),
    (torch.bfloat16, torch.bfloat16, 128, None, "tc"),
    (torch.bfloat16, torch.bfloat16, 36, None, "fp32"),  # hd % 16 != 0
    (torch.float32, torch.float32, 64, None, "fp32"),
    (torch.bfloat16, torch.float32, 64, None, "fp32"),
    (torch.float32, torch.bfloat16, 64, None, "fp32"),
    (torch.bfloat16, torch.bfloat16, 64, "dout", "fp32"),  # 2 bytes off
    (torch.bfloat16, torch.bfloat16, 64, "out", "tc"),  # read by D only
])
def test_flash_bwd_variant_by_dtype_and_head_dim(dev, q_dt, kv_dt, hd,
                                                 misaligned, impl):
    """One call launches the variant the rule picks (a dout off 16-byte
    alignment takes fp32, an out off it does not), and either meets the
    bars."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)

    q, k, v, out, dout, lse = _flash_bwd_inputs(
        dev, 1, 192, 192, 4, 2, hd, True, 0, q_dt, kv_dt)
    if misaligned:
        t = {"out": out, "dout": dout}[misaligned]
        buf = torch.empty(t.numel() + 1, dtype=q_dt, device=dev)
        buf[1:].copy_(t.reshape(-1))
        t = buf[1:].view(t.shape)
        assert t.is_contiguous() and t.data_ptr() % 16 != 0
        if misaligned == "out":
            out = t
        else:
            dout = t
    by_impl = dict(flash_attention_bwd.launches_by_impl)
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal=True)
    torch.cuda.synchronize()
    assert _bwd_impl_delta(by_impl) == {impl: 1}
    want = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), dout.float(), lse,
        causal=True)
    for g, w in zip(got, want):
        _within_bwd_bars(g, w)


def _bf16_terms(x, terms: int):
    """x cut to the sum of its first ``terms`` bf16 terms (1: bf16(x); 2:
    hi + bf16(x - hi), the tensor-core backward's split)."""
    cut, rest = torch.zeros_like(x), x
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        cut, rest = cut + t, rest - t
    return cut


def _bwd_cut_terms(q, k, v, out, dout, lse, terms: int):
    """The f32 backward (causal, B 1, H = KV) with P and dS each cut to
    ``terms`` bf16 terms where they enter dV = P^T dO, dK = scale dS^T Q
    and dQ = scale dS K: one term is the control for a tensor-core kernel
    that dropped the lo terms, two the arithmetic the tc kernel is
    designed to. Returns (dq, dk, dv) f32."""
    from repro_torch.kernels.flash_attention import _scale

    S, H, hd = q.shape[1], q.shape[2], q.shape[3]
    scale = _scale(hd)
    masked = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    grads = [torch.empty((1, S, H, hd), device=q.device) for _ in range(3)]
    for h in range(H):
        qh, kh, vh, oh, doh = (t[0, :, h].float() for t in (q, k, v, out,
                                                             dout))
        s = (qh @ kh.T) * scale
        p = torch.exp(s - lse[0, h][:, None]).masked_fill(masked, 0.0)
        d = (doh * oh).sum(dim=-1, keepdim=True)
        ds = p * (doh @ vh.T - d)
        p, ds = _bf16_terms(p, terms), _bf16_terms(ds, terms)
        for g, val in zip(grads, (scale * ds @ kh, scale * ds.T @ qh,
                                  p.T @ doh)):
            g[0, :, h] = val
    return grads


def test_flash_bwd_tensor_cores_keep_the_low_terms(dev):
    """The tc backward's products carry both bf16 terms of P and dS: about
    as few of its bf16 dq, dk, dv differ from bf16(plain) as of the f32
    control that cuts P and dS to the same two terms (its tile sums add
    no error of their own), far fewer than of a control that cuts them to
    one term (2^-8 of each against 2^-16). The fp32 variant on the same
    values, exact in P and dS, moves fewer still."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)

    S, H, hd = 4096, 4, 128
    q, k, v, out, dout, lse = _flash_bwd_inputs(
        dev, 1, S, S, H, H, hd, True, 0, torch.bfloat16, torch.bfloat16,
        seed=7)
    by_impl = dict(flash_attention_bwd.launches_by_impl)
    tc = flash_attention_bwd(q, k, v, out, dout, lse, causal=True)
    fp32 = flash_attention_bwd(q.float(), k, v, out.float(), dout.float(),
                               lse, causal=True)
    torch.cuda.synchronize()
    assert _bwd_impl_delta(by_impl) == {"tc": 1, "fp32": 1}
    ref = [w.to(torch.bfloat16) for w in flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), dout.float(), lse,
        causal=True)]

    def n_off(grads):
        return sum(int((g.to(torch.bfloat16) != r).sum())
                   for g, r in zip(grads, ref))

    n = {"tc": n_off(tc), "fp32": n_off(fp32)}
    for terms in (1, 2):
        n[terms] = n_off(_bwd_cut_terms(q, k, v, out, dout, lse, terms))
    print(f"bf16 dq, dk, dv off bf16(plain), of {3 * q.numel()}: tc "
          f"{n['tc']}, fp32 {n['fp32']}, one term {n[1]}, two terms {n[2]}")
    assert n["tc"] <= 1.5 * n[2] + 16 and n["fp32"] <= n[2], n
    # the lo terms show: without them many more outputs move
    assert 10 * n["tc"] <= n[1], n


@pytest.mark.parametrize("dt,hd,impl", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 36, "fp32"),
    (torch.float32, 64, "fp32")])
def test_flash_bwd_forward_lse_keeps_out_bits(dev, dt, hd, impl):
    """The forward with its log-sum-exp output writes the same out as
    without it, and the lse is the plain scan's m + log(l)."""
    from repro_torch.kernels.flash_attention import (
        _launch_forward, flash_attention, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(hd)
    q, k, v = (torch.randn((2, 320, 4, hd), generator=g, device=dev).to(dt)
               for _ in range(3))
    before = dict(flash_attention.launches_by_impl)
    lse = torch.empty((2, 4, 320), dtype=torch.float32, device=dev)
    with_lse = _launch_forward(q, k, v, True, 0, lse)
    without = _launch_forward(q, k, v, True, 0)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_impl[impl] == before.get(impl, 0) + 2
    assert torch.equal(with_lse, without)
    _, want = flash_attention_plain(q, k, v, causal=True, with_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd,q_dt,kv_dt", SPLIT_CASES)
def test_flash_bwd_fp32_split(dev, hd, q_dt, kv_dt):
    """The fp32 backward on the split: the f32 bars (bf16 outputs one bf16
    rounding), the same bits twice, each f32 gradient's error at most a
    tenth of the one-term TF32 plain version's."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)

    q, k, v, out, dout, lse = _flash_bwd_inputs(
        dev, 2, 320, 320, 4, 2, hd, True, 0, q_dt, kv_dt)
    by_impl = dict(flash_attention_bwd.launches_by_impl)
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal=True)
    again = flash_attention_bwd(q, k, v, out, dout, lse, causal=True)
    torch.cuda.synchronize()
    assert _bwd_impl_delta(by_impl) == {"fp32": 2}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    args = (q.float(), k.float(), v.float(), out.float(), dout.float(), lse)
    want = flash_attention_bwd_plain(*args, causal=True)
    one_term = _one_term_tf32(lambda: flash_attention_bwd_plain(
        *args, causal=True))
    for g_, w, t in zip(got, want, one_term):
        _within_bwd_bars(g_, w)
        if g_.dtype == torch.float32:
            err = float((g_ - w).abs().max())
            assert err <= 0.1 * float((t - w).abs().max()), err


def test_flash_bwd_function_gradients_f32(dev):
    """FlashAttentionFn on the card (forward kernel with lse, backward
    kernel) against autograd through the plain scan, in f32."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(11)
    B, S, H, KV, hd = 1, 3072, 4, 2, 64
    q0 = torch.randn((B, S, H, hd), generator=g, device=dev)
    k0 = torch.randn((B, S, KV, hd), generator=g, device=dev)
    v0 = torch.randn((B, S, KV, hd), generator=g, device=dev)
    w = torch.randn((B, S, H, hd), generator=g, device=dev)
    grads = []
    for fn in (flash_attention, flash_attention_plain):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        before = (flash_attention.launches, flash_attention_bwd.launches)
        out = fn(q, k, v, causal=True)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        launched = (flash_attention.launches - before[0],
                    flash_attention_bwd.launches - before[1])
        assert launched == ((1, 1) if fn is flash_attention else (0, 0))
        if fn is flash_attention:
            assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
        grads.append((q.grad, k.grad, v.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


def test_flash_bwd_rejects_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v, out, dout, lse = _flash_bwd_inputs(
        dev, 1, 64, 64, 4, 2, 32, True, 0, torch.float32, torch.float32)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, dout, lse[:, :2].contiguous(),
                            causal=True)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, out, dout.to(torch.bfloat16), lse,
                            causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(*(torch.zeros((1, 64, 2, 256), device=dev)
                              for _ in range(5)),
                            torch.zeros((1, 2, 64), device=dev), causal=True)
    assert flash_attention_bwd.launches == before


def test_synthetic_stream_draws_on_the_card(dev):
    """A stream on the card draws there, and a restored stream repeats its
    batches bit for bit."""
    from repro_torch.data.synthetic import SyntheticStream

    a = SyntheticStream(512, seq_len=64, global_batch=4, seed=3, device=dev)
    first = [a.next() for _ in range(3)]
    assert first[0].device.type == "cuda"
    assert first[0].shape == (4, 64) and int(first[0].max()) < 512
    a.restore({"step": 1, "seed": 3})
    assert torch.equal(a.next(), first[1]) and torch.equal(a.next(),
                                                           first[2])


def _check_fwd_lse_and_bwd(dev, B, S, H, hd):
    """The causal bf16 flash pair at (B, S, H heads over H of ``hd``):
    the forward kernel's log-sum-exp against the plain forward's (rtol
    1e-5 plus 1e-5 * max|lse|), its out bitwise the same with and without
    the lse, and the tc backward fed it against the f32 plain backward at
    the backward's bars (``_within_bwd_bars``)."""
    from repro_torch.kernels.flash_attention import (
        _launch_forward, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)

    dt = torch.bfloat16
    before = dict(flash_attention_bwd.launches_by_impl)
    q, k, v, out, dout, lse = _flash_bwd_inputs(
        dev, B, S, S, H, H, hd, True, 0, dt, dt)
    assert torch.equal(out, _launch_forward(q, k, v, True, 0))
    _, lse_plain = flash_attention_plain(q, k, v, causal=True, with_lse=True)
    torch.testing.assert_close(
        lse, lse_plain.float(), rtol=1e-5,
        atol=1e-5 * float(lse_plain.abs().max()))
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal=True)
    torch.cuda.synchronize()
    assert _bwd_impl_delta(before) == {"tc": 1}
    want = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), dout.float(), lse,
        causal=True)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _within_bwd_bars(g, w)


def test_flash_fwd_lse_and_bwd_hd112_zamba_train(dev):
    """Zamba2-7B's shared attention in its train step (a microbatch of 2 x
    4096 tokens, 32 heads over 32 of head dim 112, bf16):
    ``_check_fwd_lse_and_bwd``."""
    _check_fwd_lse_and_bwd(dev, 2, 4096, 32, 112)


# ---------------------------------------------------------------------------
# the model axis: a tensor-parallel rank's flash pair, expert parallelism
# ---------------------------------------------------------------------------

def test_flash_fwd_lse_and_bwd_h16_llama_tp_rank(dev):
    """Full-width Llama-2-7B's attention on one rank of a model axis of 2
    (a microbatch of 2 x 4096 tokens, 16 heads over 16 of head dim 128,
    bf16): ``_check_fwd_lse_and_bwd``."""
    _check_fwd_lse_and_bwd(dev, 2, 4096, 16, 128)


def test_flash_fwd_lse_and_bwd_hd96_vlm_tp_rank(dev):
    """Phi-3-vision's attention on one rank of a model axis of 2 (a
    microbatch of 2 x (1,024 patches + 3,072 tokens), 16 heads over 16 of
    head dim 96, bf16): ``_check_fwd_lse_and_bwd``."""
    _check_fwd_lse_and_bwd(dev, 2, 4096, 16, 96)


def test_flash_fwd_lse_and_bwd_hd112_zamba_tp_rank(dev):
    """Zamba2-7B's shared attention on one rank of a model axis of 2 (a
    microbatch of 2 x 4096 tokens, 16 heads over 16 of head dim 112,
    bf16): ``_check_fwd_lse_and_bwd``."""
    _check_fwd_lse_and_bwd(dev, 2, 4096, 16, 112)


def test_apply_ep_shards_on_the_card_match_plain(dev):
    """The expert-parallel dispatch at tp 2 on one card: each shard's
    ``_ep_shard`` (its experts' stacks) summed equals ``_apply_ep_plain``
    on the card, and both equal ``_apply_ep_plain`` on the CPU: keep masks
    exactly, y and aux at rtol 1e-5, atol 1e-6 * max|y| (f32), with a
    capacity that drops pairs."""
    from repro_torch.models import moe

    cfg = SMOKE["qwen3-moe-30b-a3b"].scaled(dtype="float32")
    g = torch.Generator().manual_seed(0)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": torch.randn((D, E), generator=g) * 0.5,
         "w_in": torch.randn((E, D, F), generator=g) / D ** 0.5,
         "w_gate": torch.randn((E, D, F), generator=g) / D ** 0.5,
         "w_out": torch.randn((E, F, D), generator=g) / F ** 0.5}
    x = torch.randn((4, 16, D), generator=g)
    y_cpu, aux_cpu, keep_cpu = moe._apply_ep_plain(p, cfg, x, 2)
    pd = {k: v.to(dev) for k, v in p.items()}
    y, aux, keep = moe._apply_ep_plain(pd, cfg, x.to(dev), 2)
    C, n = moe.capacity(16, cfg), E // 2
    parts = [moe._ep_shard({k: v if k == "router" else v[s * n:(s + 1) * n]
                            for k, v in pd.items()}, cfg, x.to(dev),
                           s * n, n, C) for s in range(2)]
    assert not bool(keep_cpu.any(0).all())  # some pairs dropped
    assert torch.equal(keep.cpu(), keep_cpu)
    assert torch.equal(torch.stack([pt[2] for pt in parts]), keep)
    tol = dict(rtol=1e-5, atol=1e-6 * float(y_cpu.abs().max()))
    torch.testing.assert_close(y.cpu(), y_cpu, **tol)
    torch.testing.assert_close(parts[0][0] + parts[1][0], y, **tol)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=1e-5, atol=1e-7)


def test_device_span_reads_the_launch_time(dev, monkeypatch):
    """A device-clocked span (``obs.SpanTimer.span(device=)``) around a
    known launch reads within 10% of CUDA events placed around the same
    launch, and the timer never calls ``torch.cuda.synchronize``."""
    from repro_torch.obs import MetricsRegistry, SpanTimer

    x = torch.randn((4096, 4096), device=dev)
    for _ in range(3):
        x @ x
    torch.cuda.synchronize()

    def no_sync(*a, **k):
        raise AssertionError("the span timer synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    reg = MetricsRegistry()
    spans = SpanTimer(reg)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with spans.span("launch", device=dev):
        a.record()
        for _ in range(20):
            x @ x
        b.record()
    b.synchronize()
    spans.collect()
    assert spans.pending == 0
    got = reg.snapshot()["span_device.launch"]["sum"]
    want = a.elapsed_time(b) * 1e-3
    assert want > 1e-3 and abs(got - want) <= 0.1 * want, (got, want)
