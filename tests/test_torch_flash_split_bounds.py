"""The bound the split ``fp32`` flash pair is held to (``obs/work``): f32
work runs exactly on the tensor cores through the bf16 split, so its least
time is the bf16 peak over the split's products, six for f32 x f32 and
three with a bf16 side; the wrapper records its launches at that rate."""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.obs import work


@pytest.mark.parametrize("q_bf16,kv_bf16,rate,flop_per_s", [
    (True, True, work.RATE_BF16_TC, 989e12),
    (False, False, work.RATE_SPLIT6, 989e12 / 6),
    (False, True, work.RATE_SPLIT3, 989e12 / 3),
    (True, False, work.RATE_SPLIT3, 989e12 / 3),
])
def test_flash_rate_by_dtypes(q_bf16, kv_bf16, rate, flop_per_s):
    assert work.flash_rate(q_bf16, kv_bf16) == rate
    assert work.FLOP_PER_S[rate] == pytest.approx(flop_per_s, rel=1e-12)


# the split bounds of the f32 rows (B, hd, with lse), ms: the FP32-core
# bound times 67 / 164.8
@pytest.mark.parametrize("B,hd,fwd,want_ms", [
    (8, 128, True, 6.67),   # long eval
    (4, 128, True, 3.34),   # calibration: the quantizer's advance
    (4, 112, True, 2.92),   # Zamba2-7B
    (2, 96, True, 1.25),    # Phi-3-vision
    (2, 128, True, 1.67),   # Llama-2-7B train microbatch
    (2, 112, True, 1.46),   # Zamba2-7B train microbatch
    (2, 128, False, 4.17),  # Llama-2-7B train microbatch, backward
])
def test_split_bound_at_the_path_shapes(B, hd, fwd, want_ms):
    args = (B, 4096, 4096, 32, 32, hd, 0, True)
    if fwd:
        flops, _, rate = work.flash_attention_work(
            *args, 4, work.flash_rate(False, False))
    else:
        flops, _, rate = work.flash_attention_bwd_work(
            *args, 4, 4, work.flash_rate(False, False))
    assert rate == work.RATE_SPLIT6
    ms = flops / work.FLOP_PER_S[rate] * 1e3
    assert ms == pytest.approx(want_ms, abs=0.006)
    fp32_ms = flops / work.FLOP_PER_S[work.RATE_FP32] * 1e3
    assert ms == pytest.approx(fp32_ms * 67 / (989 / 6), rel=1e-9)


@pytest.mark.parametrize("q_dt,kv_dt,impl,rate", [
    (torch.float32, torch.float32, "fp32", work.RATE_SPLIT6),
    (torch.float32, torch.bfloat16, "fp32", work.RATE_SPLIT3),
    (torch.bfloat16, torch.bfloat16, "tc", work.RATE_BF16_TC),
])
def test_wrapper_records_the_rate_of_its_dtypes(q_dt, kv_dt, impl, rate):
    """On CPU tensors the wrapper runs its plain version and records no
    launch; the rate its fake path would record is ``_rate``'s."""
    q = torch.zeros((1, 64, 4, 64), dtype=q_dt)
    k = torch.zeros((1, 64, 2, 64), dtype=kv_dt)
    assert fa._rate(q, k) == rate
    if q_dt == kv_dt:
        assert fa.select_impl(q, k, k) == impl
    with work.counting() as count:
        fa.flash_attention(q, k, k, causal=True)
    assert count.kernels == {}
