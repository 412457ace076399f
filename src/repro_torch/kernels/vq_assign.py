"""Band-batched Hessian-weighted nearest-centroid assignment (GPTVQ Eq. 4).

Port of ``repro/kernels/vq_assign.py``. ``vq_assign`` launches the CUDA
kernel ``csrc/vq_assign.cu`` for CUDA tensors and takes the plain PyTorch
version ``vq_assign_plain`` only for CPU tensors. ``vq_assign.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_THREADS = 128
_SMEM_LIMIT = 48 * 1024


def vq_assign_plain(x: torch.Tensor, hw: torch.Tensor,
                    codebooks: torch.Tensor) -> torch.Tensor:
    """Explicit (B, n, k, d) distances + argmin, as ``ref.vq_assign_ref``:
    x (B, n, d), hw broadcastable to x, codebooks (B, k, d) -> (B, n) int32.
    ``torch.argmin`` returns the first minimum, so ties go to the lowest
    index."""
    diff = x[:, :, None, :] - codebooks[:, None, :, :]
    hwb = hw.expand(x.shape)[:, :, None, :]
    dist = torch.sum(hwb * diff * diff, dim=-1)
    return torch.argmin(dist, dim=-1).to(torch.int32)


def _launch_shape(B: int, n: int, k: int, d: int) -> tuple[int, int]:
    """(bands_per_cta, rows_per_cta) for a 128-thread CTA: one band per CTA
    for long bands, many bands per CTA for short ones (the span sweep's
    n = rows_per_band), capped so the staged codebooks fit 48 KB."""
    if n >= _THREADS:
        return 1, _THREADS
    rows = 1
    while rows < n:
        rows *= 2
    bands = min(_THREADS // rows, B, max(1, _SMEM_LIMIT // (k * d * 4)))
    return bands, rows


def vq_assign(x: torch.Tensor, hw: torch.Tensor,
              codebooks: torch.Tensor) -> torch.Tensor:
    """x (B, n, d) f32; hw (n, d) shared by all bands or (B, n, d) f32;
    codebooks (B, k, d) f32 -> (B, n) int32 argmin of the weighted squared
    distance, ties to the lowest index. Inputs are checked on every device,
    so CPU callers meet the kernel's contract too."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vq_assign: unsupported device {x.device}")
    if x.dim() != 3 or codebooks.dim() != 3:
        raise ValueError(f"vq_assign: x {tuple(x.shape)}, codebooks "
                         f"{tuple(codebooks.shape)} must be (B, n, d), (B, k, d)")
    B, n, d = x.shape
    k = codebooks.shape[1]
    if codebooks.shape != (B, k, d) or not 1 <= d <= 4:
        raise ValueError(f"vq_assign: codebooks {tuple(codebooks.shape)} vs "
                         f"x {tuple(x.shape)} (d <= 4)")
    if k * d * 4 > _SMEM_LIMIT:
        raise ValueError(f"vq_assign: codebook of {k}x{d} exceeds 48 KB")
    if hw.dim() == 3 and hw.shape[0] == 1:
        hw = hw[0]
    if tuple(hw.shape) == (n, d):
        hw_stride = 0
    elif tuple(hw.shape) == (B, n, d):
        hw_stride = n * d
    else:
        raise ValueError(f"vq_assign: hw {tuple(hw.shape)} must be (n, d) "
                         f"or (B, n, d) for x {tuple(x.shape)}")
    for name, t in (("x", x), ("hw", hw), ("codebooks", codebooks)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"vq_assign: {name} must be float32 on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"vq_assign: {name} must be contiguous")
    if x.device.type == "cpu":
        return vq_assign_plain(x, hw, codebooks)
    out = torch.empty((B, n), dtype=torch.int32, device=x.device)
    if B == 0 or n == 0:
        return out
    bands, rows = _launch_shape(B, n, k, d)
    fn = build.load("vq_assign").vq_assign_launch
    rc = fn(x.data_ptr(), hw.data_ptr(), codebooks.data_ptr(),
            out.data_ptr(), B, n, d, k, hw_stride, bands, rows, _THREADS,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "vq_assign")
    vq_assign.launches += 1
    return out


vq_assign.launches = 0
