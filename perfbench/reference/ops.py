"""Plain operations the references share: RMSNorm, rotate-half rotary
embeddings, causal grouped-query attention of one sequence, and the
precision a product's operands are computed in: float32 (TF32 off, set by
``full_f32``), or float8 e4m3 with one scale a tensor, the control that a
program computing below its stated bf16 would look like."""
from __future__ import annotations

import contextlib
import math

import torch

PRECISIONS = ("f32", "fp8")
_FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp(min=1e-30) / _FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


@contextlib.contextmanager
def full_f32():
    """float32 products in float32: TF32 off inside, restored after."""
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = allow


def rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * w.to(torch.float32)


def rope(x, pos, theta):
    """x (S, H, hd) rotated at positions ``pos`` (S,): rotate-half form."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = pos.to(torch.float32)[:, None] * freqs          # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Ops:
    """Where a product's operands are rounded: nowhere at "f32", to float8
    e4m3 at "fp8"."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.low = precision == "fp8"

    def cast(self, t):
        return fp8(t) if self.low else t

    def linear(self, x, W):
        """x (..., c) @ W (r, c).T"""
        return self.cast(x) @ self.cast(W).T


def attention(q, k, v, ops: Ops):
    """Causal GQA of one sequence: q (S, H, hd), k/v (S, KV, hd); query
    head h reads key/value head h // (H / KV)."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("qhd,khd->hqk", ops.cast(q), ops.cast(k)) / math.sqrt(hd)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", ops.cast(p), ops.cast(v))
