"""Shared neural-net primitives (port of ``repro/models/common.py``): dense
init, the matmul dispatch on dense or fused-VQ weights (one matrix, or an
expert stack), norms, RoPE and activations.

Parameter convention: plain nested dicts of tensors; dense kernels are
(in, out), as in the reference. Mixed-dtype matmuls promote like jnp
(bf16 @ f32 -> f32).

``MATMUL_DISPATCH`` is the reference's "matmul" dispatch source: one count
a call, by the weight form each matmul site met (dense or fused VQ, one
matrix or an expert stack), so a leaf densified where it should have
stayed fused shows as a count moving.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.obs.dispatch import register_dispatch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MATMUL_DISPATCH = register_dispatch(
    "matmul", ("dense", "fused_vq", "expert_dense", "expert_fused_vq"))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=device)
            * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# weight application: dense tensors or fused VQ leaves
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a dense (in, out) kernel or a
    ``core/vq_linear.FusedVQLinear`` (the fused VQ-dequant matmul kernel on
    CUDA; the dense weight is never materialized)."""
    from repro_torch.core import vq_linear as vql_mod

    if isinstance(w, vql_mod.FusedVQLinear):
        MATMUL_DISPATCH["fused_vq"] += 1
        return vql_mod.fused_matmul(x, w).to(x.dtype)
    MATMUL_DISPATCH["dense"] += 1
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def expert_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Per-expert matmul: einsum('...ecd,edf->...ecf') for a dense (E, d, f)
    stack, or a stacked ``FusedVQLinear`` (leading E on every array)
    through the ``vq_dequant_matmul`` kernel's expert axis: one launch for
    the whole stack, the dense weights never materialized. x is (E, C, d)
    or (B, E, C, d); the result has x's dtype.

    The reference casts x to f32 before its fused expert matmul; here the
    kernel takes x as it comes. Every such x in the model is a bf16
    activation (or f32 in an f32 model), so the cast is exact and the
    bf16 tensor-core variants apply: the same products, summed in another
    order."""
    from repro_torch.core import vq_linear as vql_mod

    if not isinstance(w, vql_mod.FusedVQLinear):
        MATMUL_DISPATCH["expert_dense"] += 1
        eq = "ecd,edf->ecf" if x.dim() == 3 else "becd,edf->becf"
        return torch.einsum(eq, x, w.to(x.dtype))
    MATMUL_DISPATCH["expert_fused_vq"] += 1
    if x.dim() == 3:  # (E, C, D)
        return vql_mod.expert_fused_matmul(x, w).to(x.dtype)
    B, E, C, D = x.shape
    xt = x.transpose(0, 1).reshape(E, B * C, D)
    y = vql_mod.expert_fused_matmul(xt, w)
    return y.reshape(E, B, C, -1).transpose(0, 1).to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def position_ids(pos, batch: int, seq: int, device=None) -> torch.Tensor:
    """(B, S) absolute positions from a scalar or per-row (B,) offset."""
    p = torch.as_tensor(pos, device=device)
    if p.dim() == 0:
        p = p[None].expand(batch)
    return p[:, None] + torch.arange(seq, device=device)[None, :]


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); pos: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = pos[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def act_fn(name: str):
    if name in ("swiglu", "geglu"):
        # gate nonlinearity used by gated MLPs
        return F.silu if name == "swiglu" else _gelu_tanh
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    if name == "gelu":
        return _gelu_tanh
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")
