"""Host side of the port's kernel variants, on the CPU: the fused leaf
carries the int8 codebooks and scales the kernel's split-K and int8
tensor-core variants read (against the reference's leaves through
``convert``), the split-K plan covers K in whole column groups and never
depends on M, the variant rules of ``vq_dequant_matmul`` and
``flash_attention``, the split plan of ``paged_attention`` (a slot's live
pages once each, in order; no dependence on the batch, the table or any
position; refusals before any launch), and CPU tensors never touch a
kernel counter.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bpv as jbpv
from repro.core import vq_linear as jvql

from repro_torch.convert import vqlinear_from_jax
from repro_torch.core import vq_linear as vql
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_quant as kvq
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import vq_dequant_matmul as vqdm

LEAF_CFGS = {
    "2d": jbpv.VQConfig(d=2, bits_per_dim=2, group_size=1024, em_iters=4,
                        codebook_update_iters=1),
    "2d_sb16": jbpv.VQConfig(d=2, bits_per_dim=2, group_size=1024,
                             em_iters=4, codebook_update_iters=1,
                             scale_block=16),
    "1d": jbpv.VQConfig(d=1, bits_per_dim=3, group_size=256, em_iters=4,
                        codebook_update_iters=1),
}


@pytest.fixture(scope="module")
def ref_leaves():
    """Reference quantize_array leaves and their fused forms, as numpy."""
    rng = np.random.default_rng(3)
    W = rng.standard_normal((32, 256)).astype(np.float32)
    out = {}
    for name, cfg in LEAF_CFGS.items():
        leaf = jvql.quantize_array(jnp.asarray(W), None, cfg)
        fused = jvql.prepare_fused(leaf, impl="xla")
        out[name] = (jax.tree.map(np.asarray, leaf),
                     np.asarray(fused.codebooks_f))
    return out


@pytest.mark.parametrize("name", sorted(LEAF_CFGS))
def test_prepare_fused_carries_the_int8_codebooks(ref_leaves, name):
    leaf, ref_codebooks_f = ref_leaves[name]
    fused = vql.prepare_fused(vqlinear_from_jax(leaf, device="cpu"))
    # exact: the same int8 values and f32 scales as the reference's leaf
    assert fused.codebooks.dtype == torch.int8
    np.testing.assert_array_equal(fused.codebooks.numpy(),
                                  np.asarray(leaf.codebooks))
    np.testing.assert_array_equal(fused.cb_scale.numpy(),
                                  np.asarray(leaf.cb_scale))
    # and their product is, bit for bit, the folded f32 codebooks that the
    # plain version and the reference's fused leaf read
    np.testing.assert_array_equal(
        (fused.codebooks.float() * fused.cb_scale[..., None, None]).numpy(),
        ref_codebooks_f)
    np.testing.assert_array_equal(fused.codebooks_f.numpy(), ref_codebooks_f)
    assert fused.codebooks.is_contiguous() and fused.cb_scale.is_contiguous()


LAYOUTS = [  # N, K, d, code_bits, k_c, rows_per_band, group_cols
    (4096, 4096, 2, 4, 16, 4, 256),     # Llama-2-7B wq at 2.25bpv_2d
    (11008, 4096, 2, 4, 16, 4, 256),    # w1, w3
    (4096, 11008, 2, 4, 16, 4, 256),    # w2 (43 column groups)
    (4096, 4096, 4, 8, 256, 128, 256),  # 2.25bpv_4d
    (4096, 4096, 1, 2, 4, 1, 128),      # 2.125bpv_1d
    (72, 384, 2, 4, 16, 8, 128),
    (68, 36, 2, 4, 16, 4, 12),          # flat words
    (40, 2048, 2, 4, 16, 4, 2048),      # a group wider than a segment
]


@pytest.mark.parametrize("N,K,d,code_bits,k_c,rpb,gc", LAYOUTS)
def test_splitk_plan_covers_k_in_whole_groups(N, K, d, code_bits, k_c, rpb,
                                              gc):
    plan = vqdm.splitk_plan(N, K, d=d, code_bits=code_bits, k_c=k_c,
                            rows_per_band=rpb, group_cols=gc)
    n_cg = K // gc
    gps, n = plan.groups_per_split, plan.n_splits
    # splits of whole column groups, the last possibly shorter, none empty
    assert gps >= 1 and (n - 1) * gps < n_cg <= n * gps
    # a split's columns are staged in whole segments of whole groups, or
    # (a group wider than a segment) in segments that divide into its spans
    if gc <= plan.seg_cols:
        assert plan.seg_cols % gc == 0 and plan.seg_cols <= gps * gc
    else:
        assert gps == 1 and plan.seg_cols % d == 0
    # 16-byte loads only where every row's chunks start on 16 bytes
    lanes = 32 // (1 << (code_bits - 1).bit_length())
    if plan.vec == 4:
        assert (K // d) % (4 * lanes) == 0 and (gc // d) % (4 * lanes) == 0
    assert vqdm.splitk_plan(N, K, d=d, code_bits=code_bits, k_c=k_c,
                            rows_per_band=rpb, group_cols=gc,
                            words_aligned=False).vec == 1


def test_splitk_plan_of_the_path_and_its_independence_of_m():
    """Llama-2-7B's projections split K into 1024-column splits of four
    256-column groups, staged in one segment, with 16-byte loads: 256, 688
    and 704 CTAs of 64 rows; the plan is a function of N, K and the layout
    (it has no M to depend on), and every M the engine decodes at takes the
    split-K variant."""
    for (N, K), splits in zip(((4096, 4096), (11008, 4096), (4096, 11008)),
                              (4, 4, 11)):
        plan = vqdm.splitk_plan(N, K, d=2, code_bits=4, k_c=16,
                                rows_per_band=4, group_cols=256)
        assert plan == vqdm.SplitPlan(4, splits, 1024, 4)
    assert "M" not in vqdm.splitk_plan.__wrapped__.__code__.co_varnames
    kw = dict(d=2, k_c=16, rows_per_band=4, n_bands=1024, group_cols=256,
              scale_block=0, has_int8=True)
    for M in range(1, vqdm.SPLITK_M_MAX + 1):
        for dt in (torch.float32, torch.bfloat16):
            assert vqdm.select_impl(M, dt, **kw) == "splitk"


@pytest.mark.parametrize("x_dtype,kw,impl", [
    (torch.bfloat16, {}, "tc_int8"),
    (torch.bfloat16, dict(has_int8=False), "tc_split3"),
    (torch.bfloat16, dict(group_cols=96), "tc_split3"),
    (torch.bfloat16, dict(scale_block=32), "tc_split3"),
    (torch.bfloat16, dict(scale_block=64), "tc_int8"),
    (torch.bfloat16, dict(d=8, k_c=256, rows_per_band=128), "fp32"),
    (torch.float32, {}, "fp32"),
    # a slice of 65 bands x 256 x 4 int8 bytes, three in flight, is too big
    (torch.bfloat16, dict(d=4, k_c=256, rows_per_band=1, n_bands=65),
     "tc_split3"),
])
def test_select_impl_above_the_split_k_rows(x_dtype, kw, impl):
    args = dict(d=2, k_c=16, rows_per_band=4, n_bands=1024, group_cols=256,
                scale_block=0, has_int8=True)
    args.update(kw)
    assert vqdm.select_impl(17, x_dtype, **args) == impl
    assert vqdm.select_impl(512, x_dtype, **args) == impl


def _vq_inputs(M=3, N=8, K=64, int8=True):
    g = torch.Generator().manual_seed(0)
    words = torch.randint(-2**31, 2**31 - 1, (N, K // 16), generator=g,
                          dtype=torch.int32)
    i8 = torch.randint(-127, 128, (K // 32, N // 4, 16, 2), generator=g,
                       dtype=torch.int32).to(torch.int8)
    scale = torch.rand((K // 32, N // 4), generator=g) + 0.01
    cb = i8.float() * scale[..., None, None]
    x = torch.randn((M, K), generator=g).to(torch.bfloat16)
    extra = dict(codebooks_i8=i8, cb_scale=scale) if int8 else {}
    return x, words, cb, extra, dict(d=2, k_c=16, code_bits=4,
                                     rows_per_band=4, group_cols=32)


def test_int8_codebooks_do_not_change_the_plain_result():
    x, words, cb, extra, kw = _vq_inputs()
    y = vqdm.vq_dequant_matmul(x, words, cb, **kw, **extra)
    y0 = vqdm.vq_dequant_matmul(x, words, cb, **kw)
    torch.testing.assert_close(y, y0, rtol=0, atol=0)


def test_int8_codebooks_are_checked():
    x, words, cb, extra, kw = _vq_inputs()
    with pytest.raises(ValueError, match="go together"):
        vqdm.vq_dequant_matmul(x, words, cb, codebooks_i8=extra[
            "codebooks_i8"], **kw)
    with pytest.raises(ValueError, match="codebooks_i8"):
        vqdm.vq_dequant_matmul(x, words, cb, codebooks_i8=extra[
            "codebooks_i8"][:1], cb_scale=extra["cb_scale"][:1], **kw)
    with pytest.raises(ValueError, match="int8"):
        vqdm.vq_dequant_matmul(x, words, cb, codebooks_i8=cb,
                               cb_scale=extra["cb_scale"], **kw)


def test_cpu_tensors_touch_no_kernel_counter():
    counters = lambda: (
        vqdm.vq_dequant_matmul.launches,
        dict(vqdm.vq_dequant_matmul.launches_by_m),
        dict(vqdm.vq_dequant_matmul.launches_by_impl),
        fa.flash_attention.launches,
        dict(fa.flash_attention.launches_by_impl))
    before = counters()
    for M in (1, 4, 17, 64):
        x, words, cb, extra, kw = _vq_inputs(M=M)
        vqdm.vq_dequant_matmul(x, words, cb, **kw, **extra)
    fused = vql.prepare_fused(vql.VQLinear(
        words=words, codebooks=extra["codebooks_i8"],
        cb_scale=extra["cb_scale"], scale_sint=torch.zeros((2, 8, 1),
                                                           dtype=torch.int8),
        scale_a=torch.zeros(2), scale_z=torch.zeros(2), r=8, c=64, d=2, k=16,
        group_cols=32, rows_per_band=4))
    vql.fused_matmul(torch.randn((2, 5, 64)), fused)
    q = torch.randn((1, 64, 2, 32), dtype=torch.bfloat16)
    fa.flash_attention(q, q, q, causal=True)
    assert counters() == before


@pytest.mark.parametrize("dts,hd,impl", [
    ((torch.bfloat16,) * 3, 64, "tc"),
    ((torch.bfloat16,) * 3, 128, "tc"),
    ((torch.bfloat16,) * 3, 36, "fp32"),
    ((torch.float32,) * 3, 64, "fp32"),
    ((torch.bfloat16, torch.float32, torch.float32), 64, "fp32"),
    ((torch.float32, torch.bfloat16, torch.bfloat16), 64, "fp32"),
])
def test_flash_select_impl(dts, hd, impl):
    q, k, v = (torch.zeros((1, 64, 2, hd), dtype=dt) for dt in dts)
    assert fa.select_impl(q, k, v) == impl


def test_fused_leaf_checks_its_inputs_once():
    """A fused leaf checks its kernel inputs (vqdm.Prepared) once, as it is
    made, and again when a tensor of it is replaced (dataclasses.replace);
    fused_matmul checks only x, on every call."""
    x, words, cb, extra, kw = _vq_inputs(M=2)
    fused = vql.FusedVQLinear(
        words=words, codebooks_f=cb, scales=None,
        codebooks=extra["codebooks_i8"], cb_scale=extra["cb_scale"], r=8,
        c=64, d=2, k=16, group_cols=32, rows_per_band=4)
    prep = fused.prepared
    assert isinstance(prep, vqdm.Prepared)
    y = vql.fused_matmul(x.float(), fused)
    vql.fused_matmul(x.float(), fused)
    assert fused.prepared is prep
    # exact: the same plain version on the same inputs
    torch.testing.assert_close(
        y, vqdm.vq_dequant_matmul_plain(x.float(), words, cb, d=2,
                                        code_bits=4, rows_per_band=4,
                                        group_cols=32), rtol=0, atol=0)
    other = dataclasses.replace(fused, codebooks_f=cb.clone())
    assert other.prepared is not prep
    assert other.prepared.codebooks is other.codebooks_f
    with pytest.raises(ValueError, match="inconsistent layout"):
        dataclasses.replace(fused, codebooks_f=cb[:, :1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fused.prepared(x.float()[:, :32])
    with pytest.raises(ValueError, match="contiguous"):
        fused.prepared(x.double())


PAGE_FMTS = [pa._FMT_F32, pa._FMT_BF16, pa._FMT_INT8, pa._FMT_INT4,
             pa._FMT_VQ2]


def _split_pages(pps: int, pos: int, page_size: int,
                 n_pages: int) -> list[range]:
    """The logical pages each live split of a slot at ``pos`` walks, in
    split order, for ``pps`` pages a split: the walk the kernel is given
    (csrc ``walk``: split s takes pages [s * pps, (s + 1) * pps) up to
    pos's page, clamped to the table, and a split past it writes nothing),
    over the wrapper's grid of ceil(n_pages / pps) splits. The card tests
    hold the kernel to it."""
    last = min(max(pos, 0) // page_size, n_pages - 1)
    splits = [range(s * pps, min((s + 1) * pps, last + 1))
              for s in range(-(-n_pages // pps))]
    return [r for r in splits if len(r)]


@pytest.mark.parametrize("page_size,hd,G", [
    (16, 128, 1), (16, 128, 8), (16, 128, 4), (1, 32, 2), (32, 8, 4),
    (64, 256, 4), (8, 64, 3), (16, 512, 1)])
@pytest.mark.parametrize("fmt", PAGE_FMTS)
def test_paged_split_plan_covers_live_pages_once_in_order(page_size, hd, G,
                                                          fmt):
    if fmt == pa._FMT_VQ2 and hd % 4:
        pytest.skip("vq2 pages need head_dim % 4 == 0")
    plan = pa.split_plan(page_size, hd, G, fmt)
    pps = plan.pages_per_split
    assert pps >= 1 and 1 <= plan.stages <= 2
    assert plan.smem_bytes <= pa._SMEM_LIMIT
    assert G % plan.heads_per_cta == 0
    for n_pages in (1, 2, pps, pps + 1, 3 * pps + 2, 256):
        for pos in sorted({0, 1, page_size - 1, page_size, pps * page_size - 1,
                           pps * page_size, pps * page_size + 1,
                           n_pages * page_size - 1, n_pages * page_size,
                           n_pages * page_size + 7}):
            splits = _split_pages(pps, pos, page_size, n_pages)
            live = min(pos // page_size, n_pages - 1) + 1
            # every live page once, in order; each split a nonempty run of
            # at most pps pages starting at a multiple of pps
            assert [p for r in splits for p in r] == list(range(live))
            assert all(0 < len(r) <= pps and r.start % pps == 0
                       for r in splits)
            assert len(splits) <= -(-n_pages // pps)


def test_paged_split_plan_depends_on_no_batch_table_or_position():
    """The plan is a function of the page size, the head dim, G and the
    page format: its signature has nothing else, so a slot's splits (and
    the order of its sums) are the same alone, in any batch and beside any
    other slot's position. Llama-2-7B's decode (G = 1, f32 pages, page size
    16) splits a 4096-token slot into 32 runs of 8 pages, and so does
    Qwen2-72B's (G = 8), 8 query heads a CTA."""
    params = list(inspect.signature(pa.split_plan.__wrapped__).parameters)
    assert params == ["page_size", "hd", "G", "fmt"]
    llama = pa.split_plan(16, 128, 1, pa._FMT_F32)
    assert llama == pa.SplitPlan(8, 2, 1, 4, 32, 33088)
    assert len(_split_pages(llama.pages_per_split, 4095, 16, 256)) == 32
    qwen = pa.split_plan(16, 128, 8, pa._FMT_F32)
    assert (qwen.pages_per_split, qwen.heads_per_cta) == (8, 8)
    assert len(_split_pages(qwen.pages_per_split, 4095, 16, 256)) == 32
    # a slot's splits never look at the table's width past its own pages
    for n_pages in (256, 300, 1024):
        assert _split_pages(llama.pages_per_split, 1500, 16, n_pages) == \
            _split_pages(llama.pages_per_split, 1500, 16, 256)
    # a slot of up to 128 tokens is one split
    assert len(_split_pages(llama.pages_per_split, 127, 16, 256)) == 1
    assert len(_split_pages(llama.pages_per_split, 128, 16, 256)) == 2


def _paged_inputs(B=2, H=4, KV=2, hd=16, page_size=4, n_pages=4,
                  num_blocks=10, fmt="f32"):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, H, hd), generator=g)
    kp = torch.randn((num_blocks, page_size, KV, hd), generator=g)
    vp = torch.randn((num_blocks, page_size, KV, hd), generator=g)
    kw = {}
    if fmt == "vq2":
        cb = torch.randn((KV, kvq.VQ_K, kvq.VQ_D), generator=g)
        (kp, ks), (vp, vs) = (kvq.vq_quantize_rows(kp, cb),
                              kvq.vq_quantize_rows(vp, cb))
        kw = dict(k_scale=ks, v_scale=vs, k_codebook=cb, v_codebook=cb)
    table = torch.arange(1, B * n_pages + 1, dtype=torch.int32).reshape(
        B, n_pages)
    pos = torch.tensor([n_pages * page_size - 1, 3][:B], dtype=torch.int32)
    return q, kp.contiguous(), vp.contiguous(), table, pos, kw


@pytest.mark.parametrize("case,match", [
    ("vq2 head_dim", "head_dim % 4"),
    ("int64 table", "int32"),
    ("strided q", "contiguous"),
    ("page beyond shared memory", "shared memory"),
    ("scales beside f32 pages", "int8"),
    ("bf16 table", "int32"),
])
def test_paged_wrapper_raises_before_any_launch(case, match):
    """Layouts the kernel does not take raise in the wrapper, on every
    device, before any launch (the counter does not move)."""
    q, kp, vp, table, pos, kw = _paged_inputs(
        fmt="vq2" if case == "vq2 head_dim" else "f32")
    if case == "vq2 head_dim":
        q = torch.zeros((2, 4, 18))
    elif case == "int64 table":
        table = table.long()
    elif case == "bf16 table":
        table = table.to(torch.bfloat16)
    elif case == "strided q":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "page beyond shared memory":
        # one page of K and V rows (256 x 1 KB each) exceeds 227 KB
        q, kp, vp, table, pos, kw = _paged_inputs(hd=256, page_size=256,
                                                  num_blocks=3, n_pages=1)
    elif case == "scales beside f32 pages":
        kw = dict(k_scale=torch.ones(kp.shape[:3]),
                  v_scale=torch.ones(kp.shape[:3]))
    before = pa.paged_attention.launches
    with pytest.raises(ValueError, match=match):
        pa.paged_attention(q, kp, vp, table, pos, **kw)
    assert pa.paged_attention.launches == before


def test_paged_cpu_tensors_touch_no_kernel_counter():
    q, kp, vp, table, pos, kw = _paged_inputs(fmt="vq2")
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, kp, vp, table, pos, **kw)
    assert pa.paged_attention.launches == before
    torch.testing.assert_close(
        got, pa.paged_attention_plain(q, kp, vp, table, pos, **kw),
        rtol=0, atol=0)
