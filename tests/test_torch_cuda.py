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
from repro_torch.kernels.vq_assign import vq_assign, vq_assign_plain
from repro_torch.kernels.vq_dequant_matmul import (
    vq_dequant_matmul, vq_dequant_matmul_plain)
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


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn((4, 8, 2), device=dev)
    cb = torch.randn((4, 16, 2), device=dev)
    hw = torch.ones((8, 2), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        vq_assign(x.transpose(0, 1).contiguous().transpose(0, 1), hw, cb)
    with pytest.raises(ValueError, match="float32"):
        vq_assign(x.double(), hw, cb)


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
    before = vq_assign.launches
    q, rep = quantize_model(model, params_gpu, tokens.to(dev), recipe=recipe,
                            pack=True)
    assert vq_assign.launches > before
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
    (1, 4, 1, 256, 64, 3, 4, [191])])                 # > 48 KB of smem
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
    # both round the same f32 result to bf16: at most one bf16 ulp apart
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=8e-3)


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
