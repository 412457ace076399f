"""Online-softmax (flash) attention for long sequences.

Port of ``repro/kernels/flash_attention.py`` (the Pallas kernel) and of its
oracle, the two-level scan of ``repro/models/attention.py::flash_attention``.
For CUDA tensors ``flash_attention`` launches the CUDA kernel
``csrc/flash_attention.cu``; for CPU tensors it runs the plain PyTorch
version ``flash_attention_plain``. The kernel has two variants, picked by
``select_impl`` from the dtypes and the head dim (never by a failure):
``tc`` (q, k and v bf16, head_dim a multiple of 16 up to 128, 16-byte
aligned: both products on bf16 tensor cores, p split exactly into three
bf16 terms) and ``fp32`` (everything else: both products on the FP32 CUDA
cores). ``flash_attention.launches`` counts kernel launches and
``flash_attention.launches_by_impl`` the same by variant; CPU tensors
touch neither.

q (B, Sq, H, hd) and k/v (B, Sk, KV, hd), f32 or bf16, give (B, Sq, H, hd)
in q's dtype: query head h reads kv head h // (H // KV), and under
``causal`` row i sees the columns j <= q_offset + i (q_offset >= 0 places
q's rows at absolute positions in the kv range). Scores, probabilities and
the accumulator are f32; unlike the short-sequence path
(``models/attention._plain_attention``) the probabilities are not rounded
to v's dtype before the value contraction.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# the reference scan's chunks: Sq must split into min(512, Sq)-row query
# chunks and Sk into min(1024, Sk)-row kv chunks
Q_CHUNK, KV_CHUNK = 512, 1024
HD_MAX = 128  # the kernel's largest head dim (csrc/flash_attention.cu)
_DTYPES = (torch.float32, torch.bfloat16)
IMPLS = ("tc", "fp32")
_IMPL_CODE = {"fp32": 0, "tc": 1}


def select_impl(q, k, v) -> str:
    """The kernel variant for these (checked) inputs."""
    hd = q.shape[-1]
    if (all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
            for t in (q, k, v)) and hd % 16 == 0):
        return "tc"
    return "fp32"


def _scale(hd: int) -> float:
    """1 / sqrt(hd) in f32 arithmetic, as the reference and the kernel
    compute it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def flash_attention_plain(q, k, v, *, causal: bool, q_offset: int = 0):
    """Plain version: the reference's two-level scan with online softmax,
    query chunks of 512 rows and kv chunks of 1024 (skipping kv chunks
    wholly above the diagonal when there are at least 8, as the reference
    does; the result is the same either way)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    Tq, Ts = min(Q_CHUNK, Sq), min(KV_CHUNK, Sk)
    nq, nk = Sq // Tq, Sk // Ts
    scale = _scale(hd)
    dev = q.device
    qh = q.reshape(B, nq, Tq, KV, G, hd).permute(1, 0, 3, 4, 2, 5)
    kh = k.reshape(B, nk, Ts, KV, hd).permute(1, 0, 3, 2, 4)
    vh = v.reshape(B, nk, Ts, KV, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        qb = qh[qi].to(torch.float32)  # (B, KV, G, Tq, hd)
        q_pos = q_offset + qi * Tq + torch.arange(Tq, device=dev)
        m = torch.full((B, KV, G, Tq), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, Tq), device=dev)
        acc = torch.zeros((B, KV, G, Tq, hd), device=dev)
        for ki in range(nk):
            if causal and nk >= 8 and ki * Ts > q_offset + qi * Tq + Tq - 1:
                continue  # wholly masked chunk
            s = torch.einsum("bkgqh,bksh->bkgqs", qb,
                             kh[ki].to(torch.float32)) * scale
            if causal:
                k_pos = ki * Ts + torch.arange(Ts, device=dev)
                msk = k_pos[None, :] <= q_pos[:, None]  # (Tq, Ts)
                s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bksh->bkgqh", p, vh[ki].to(torch.float32))
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def _check(q, k, v, q_offset) -> None:
    """Raise ValueError on what neither the kernel nor the reference
    takes. The reference refuses Sq not a multiple of min(512, Sq) and Sk
    not a multiple of min(1024, Sk); the kernel also needs hd <= 128 with
    hd % 4 == 0, q_offset >= 0, f32/bf16 inputs (k and v of one dtype),
    contiguous, on one device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be 4-D")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (tuple(v.shape) != tuple(k.shape) or k.shape[0] != B
            or k.shape[3] != hd or KV < 1 or H % KV or Sq < 1 or Sk < 1):
        raise ValueError(f"flash_attention: inconsistent shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}")
    if Sq % min(Q_CHUNK, Sq) or Sk % min(KV_CHUNK, Sk):
        raise ValueError(f"flash_attention: Sq={Sq} must be a multiple of "
                         f"{min(Q_CHUNK, Sq)} and Sk={Sk} of "
                         f"{min(KV_CHUNK, Sk)} (the reference's chunks)")
    if hd > HD_MAX or hd % 4:
        raise ValueError(f"flash_attention: head_dim {hd} (the kernel takes "
                         f"multiples of 4 up to {HD_MAX})")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset!r} must be "
                         "an int >= 0")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtypes q {q.dtype}, k {k.dtype}")
    for name, t, dt in (("q", q, q.dtype), ("k", k, k.dtype),
                        ("v", v, k.dtype)):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"{dt} tensor on {q.device}")


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Flash attention; the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors. Inputs are checked on every device, so CPU callers
    meet the kernel's contract too."""
    _check(q, k, v, q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    impl = select_impl(q, k, v)
    fn = build.load("flash_attention").flash_attention_launch
    rc = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
            v.data_ptr(), int(k.dtype == torch.bfloat16), out.data_ptr(), B,
            Sq, Sk, H, KV, hd, int(bool(causal)), q_offset,
            _IMPL_CODE[impl],
            build.current_stream(q.device))
    build.check(rc, f"flash_attention ({impl})")
    flash_attention.launches += 1
    by_impl = flash_attention.launches_by_impl
    by_impl[impl] = by_impl.get(impl, 0) + 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_impl = {}  # variant (IMPLS) -> launches
