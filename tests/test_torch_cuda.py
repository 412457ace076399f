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
