"""Fused VQ-decode + matmul: y = x @ dequant(words, codebooks).T in f32.

Port of ``repro/kernels/vq_dequant_matmul.py``. ``vq_dequant_matmul``
launches the CUDA kernel ``csrc/vq_dequant_matmul.cu`` for CUDA tensors
(every M: the reference's M-shaped XLA regimes are not used on the card)
and takes the plain PyTorch version ``vq_dequant_matmul_plain`` only for
CPU tensors. ``vq_dequant_matmul.launches`` counts kernel launches.

Layout (core/vq_linear.FusedVQLinear): x (M, K) f32 or bf16; words: the
N * K/d codes packed row-major into int32 words holding uint32 bit
patterns, (N, K/d * cbits/32) when rows fill whole words, else one flat
run (1, N * K/d * cbits/32); codebooks (n_cg, n_bands, k_c, d) f32 with the
int8 scale folded in; scales (N, K/scale_block) f32 or None;
N = n_bands * rows_per_band, K = n_cg * group_cols.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.gptvq import gather_codebooks
from repro_torch.kernels import build

_CB_SMEM_LIMIT = 200 * 1024
_BN_MAX = 64  # widest N tile of the kernel (its M > 16 configuration)


def reconstruct(words, codebooks, scales, *, d: int, code_bits: int,
                rows_per_band: int, group_cols: int,
                scale_block: int = 0) -> torch.Tensor:
    """Dense f32 W (N, K): unpack -> per-(group, band) codebook gather ->
    blockwise scale plane."""
    n_cg, n_bands = codebooks.shape[:2]
    N, K = n_bands * rows_per_band, n_cg * group_cols
    codes = packing.unpack(words, code_bits, N * (K // d)).reshape(N, K // d)
    W = gather_codebooks(codebooks, codes, group_cols, rows_per_band, d)
    if scale_block:
        W = (W.reshape(N, K // scale_block, scale_block)
             * scales[:, :, None]).reshape(N, K)
    return W


def vq_dequant_matmul_plain(x, words, codebooks, scales=None, *, d: int,
                            code_bits: int, rows_per_band: int,
                            group_cols: int,
                            scale_block: int = 0) -> torch.Tensor:
    """Plain version, the same math as ``ref.vq_dequant_matmul_ref``."""
    W = reconstruct(words, codebooks, scales, d=d, code_bits=code_bits,
                    rows_per_band=rows_per_band, group_cols=group_cols,
                    scale_block=scale_block)
    return x.to(torch.float32) @ W.T


def vq_dequant_matmul(x, words, codebooks, scales=None, *, d: int, k_c: int,
                      code_bits: int, rows_per_band: int, group_cols: int,
                      scale_block: int = 0) -> torch.Tensor:
    """y = x @ dequant(words, codebooks[, scales]).T ; returns (M, N) f32.
    Inputs are checked on every device, so CPU callers meet the kernel's
    contract too."""
    if (scales is not None) != bool(scale_block):
        raise ValueError("scales must be given iff scale_block != 0")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vq_dequant_matmul: unsupported device {x.device}")
    M, K = x.shape
    n_cg, n_bands, kc, dd = codebooks.shape
    N = n_bands * rows_per_band
    cbits = packing.container_bits(code_bits)
    lanes = 32 // cbits
    if (dd != d or kc != k_c or 32 % d or n_cg * group_cols != K
            or group_cols % d or words.dim() != 2
            or words.numel() * lanes != N * (K // d)):
        raise ValueError(
            f"vq_dequant_matmul: inconsistent layout x {tuple(x.shape)} "
            f"words {tuple(words.shape)} codebooks "
            f"{tuple(codebooks.shape)} d={d} k_c={k_c} "
            f"group_cols={group_cols} rows_per_band={rows_per_band}")
    nb_max = min(n_bands, (_BN_MAX + rows_per_band - 2) // rows_per_band + 1)
    if nb_max * k_c * d * 4 > _CB_SMEM_LIMIT:
        raise ValueError(f"vq_dequant_matmul: codebook slice of {nb_max} "
                         f"bands x {k_c} x {d} exceeds shared memory")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vq_dequant_matmul: x dtype {x.dtype}")
    checks = [("x", x, x.dtype), ("words", words, torch.int32),
              ("codebooks", codebooks, torch.float32)]
    if scale_block:
        if K % scale_block or tuple(scales.shape) != (N, K // scale_block):
            raise ValueError(f"vq_dequant_matmul: scales "
                             f"{tuple(scales.shape)} vs (N, K/{scale_block})")
        checks.append(("scales", scales, torch.float32))
    for name, t, dt in checks:
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"vq_dequant_matmul: {name} must be a "
                             f"contiguous {dt} tensor on {x.device}")
    if x.device.type == "cpu":
        return vq_dequant_matmul_plain(
            x, words, codebooks, scales, d=d, code_bits=code_bits,
            rows_per_band=rows_per_band, group_cols=group_cols,
            scale_block=scale_block)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return y
    fn = build.load("vq_dequant_matmul").vq_dequant_matmul_launch
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), words.data_ptr(),
            codebooks.data_ptr(), scales.data_ptr() if scale_block else None,
            y.data_ptr(), M, N, K, d, k_c, cbits, rows_per_band, group_cols,
            scale_block, n_bands,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "vq_dequant_matmul")
    vq_dequant_matmul.launches += 1
    return y


vq_dequant_matmul.launches = 0
