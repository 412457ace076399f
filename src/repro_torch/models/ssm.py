"""Mamba2 (SSD) mixer: chunk-parallel prefill and recurrent decode (port of
``repro/models/ssm.py``).

Single-group Mamba2 heads:
  d_inner = expand * d_model, heads P = d_inner / ssm_head_dim, state N.
  in_proj -> [z (gate, d_inner) | x (d_inner) | B (N) | C (N) | dt (P)]
  causal depthwise conv (width w) over [x|B|C]; A = -exp(A_log) per head.

Chunked SSD (Dao & Gu 2024), chunk Q:
  a_t = dt_t * A (log decay),  cum = within-chunk cumsum
  intra: Y[i] += sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
  state: S_k = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
  inter: H_{k+1} = exp(sum_k) H_k + S_k   (a loop over chunks)
         Y[i] += C_i . (exp(cum_i) H_k)

The reference computes this with XLA (einsums, ``lax.map`` over heads,
``lax.scan`` over chunks); no Pallas kernel is involved, so here it is
plain PyTorch, vectorised over blocks of heads (``_DECAY_ELEMS`` bounds
the (Q, Q) decay tiles of one block). The scan runs in f32 whatever the
model's dtype, and so do ``A_log``, ``dt_bias``, ``D_skip`` and the state.

Decode carries (h, conv) per layer, O(1) a token; the serving engine keeps
this ``SSMCache`` slot-resident.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm

# f32 elements of the (B, nc, heads, Q, Q) decay tiles built at once: 2^28
# (1 GiB); at B = 4, S = 4096, Q = 256 that is 16 of Zamba2-7B's 112 heads
_DECAY_ELEMS = 1 << 28


class SSMCache(NamedTuple):
    h: torch.Tensor     # (B, P, hd, N) recurrent state, f32
    conv: torch.Tensor  # (B, w-1, conv_ch) rolling conv inputs


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    conv_ch = d_inner + 2 * cfg.ssm_state
    return d_inner, heads, conv_ch


def init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    D = cfg.d_model
    d_inner, heads, conv_ch = _dims(cfg)
    N = cfg.ssm_state
    proj_out = 2 * d_inner + 2 * N + heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": cm.dense_init(gen, D, proj_out, dtype=dtype,
                                 device=device),
        "conv_w": (torch.randn((cfg.ssm_conv_width, conv_ch), generator=gen,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, heads, **f32)),
        "dt_bias": torch.zeros((heads,), **f32),
        "D_skip": torch.ones((heads,), **f32),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": cm.dense_init(gen, d_inner, D, dtype=dtype,
                                  device=device),
    }


def specs(cfg: ModelConfig) -> dict:
    """The reference's sharding specs of a Mamba-2 mixer."""
    P = cm.P
    return {"in_proj": P("data", "model"), "conv_w": P(None, "model"),
            "conv_b": P("model"), "A_log": P(None), "dt_bias": P(None),
            "D_skip": P(None), "norm_scale": P("model"),
            "out_proj": P("model", "data")}


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device=None) -> SSMCache:
    _, heads, conv_ch = _dims(cfg)
    return SSMCache(
        h=torch.zeros((batch, heads, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=dtype, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                         dtype=dtype, device=device))


def _split_proj(cfg: ModelConfig, proj):
    d_inner, heads, _ = _dims(cfg)
    N = cfg.ssm_state
    return torch.split(proj, [d_inner, d_inner, N, N, heads], dim=-1)


def _causal_conv(u, w, b):
    """u: (B, S + k - 1, C) already left-padded; depthwise width-k conv in
    f32."""
    k = w.shape[0]
    S = u.shape[1] - (k - 1)
    out = torch.zeros((u.shape[0], S, u.shape[2]), dtype=torch.float32,
                      device=u.device)
    wf = w.to(torch.float32)
    for i in range(k):
        out = out + u[:, i:i + S].to(torch.float32) * wf[i]
    return out + b.to(torch.float32)


def _ssd_chunked(xh, Bm, Cm, dt, A, chunk: int, h0=None):
    """Chunk-parallel SSD scan.

    xh: (B,S,P,hd)  Bm/Cm: (B,S,N)  dt: (B,S,P)  A: (P,) negative.
    ``h0`` (B,P,hd,N) resumes from a cached state (chunked prefill: the
    serving engine feeds a long prompt in several forward calls).
    Returns y: (B,S,P,hd) and the final state (B,P,hd,N), both f32.
    """
    Bsz, S, Ph, hd = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q
    a = dt * A[None, None, :]   # (B,S,P) log decay, <= 0
    xd = xh * dt[..., None]     # dt-weighted inputs

    def c(t):
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    ac, xc_, Bc, Cc = c(a), c(xd), c(Bm), c(Cm)
    cum = torch.cumsum(ac, dim=2)  # (B,nc,Q,P)

    # intra-chunk: W[b,n,p,i,j] = (C_i.B_j) exp(cum_i - cum_j), i >= j,
    # for a block of heads at a time
    cb = torch.einsum("bnqs,bnts->bnqt", Cc, Bc)[:, :, None]  # (B,nc,1,Q,Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))
    cum_t = cum.permute(0, 1, 3, 2)  # (B,nc,P,Q)
    hb = max(1, _DECAY_ELEMS // (Bsz * nc * Q * Q))
    y_intra = torch.empty((Bsz, nc, Q, Ph, hd), dtype=torch.float32,
                          device=xh.device)
    for p0 in range(0, Ph, hb):
        cp = cum_t[:, :, p0:p0 + hb]
        decay = cp[..., :, None] - cp[..., None, :]
        # mask the exponent (not the product): exp of the anti-causal half
        # would overflow
        decay.masked_fill_(~causal, -1e30)
        Wp = cb * torch.exp(decay)
        y_intra[:, :, :, p0:p0 + hb] = torch.einsum(
            "bnpqt,bntph->bnqph", Wp, xc_[:, :, :, p0:p0 + hb])

    # chunk-final states: S_k = sum_j exp(cum_last - cum_j) B_j (x) xd_j,
    # contracted in two steps (one 3-operand einsum would build a
    # (B,nc,Q,P,hd,N) intermediate)
    w_j = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,P)
    xw = xc_ * w_j[..., None]                  # (B,nc,Q,P,hd)
    Sk = torch.einsum("bnqs,bnqph->bnphs", Bc, xw)  # (B,nc,P,hd,N)

    # inter-chunk recurrence over the chunks
    seg = torch.exp(torch.sum(ac, dim=2))  # (B,nc,P) chunk total decay
    H = (torch.zeros((Bsz, Ph, hd, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.to(torch.float32))
    Hin = []
    for k in range(nc):
        Hin.append(H)  # the state entering chunk k
        H = H * seg[:, k, :, None, None] + Sk[:, k]
    Hin = torch.stack(Hin, dim=1)  # (B,nc,P,hd,N)

    # inter contribution: y[i] += (exp(cum_i) C_i) . H_in, contracted over
    # the state dim first
    y_inter = (torch.einsum("bnqs,bnphs->bnqph", Cc, Hin)
               * torch.exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(Bsz, S, Ph, hd)
    return y, H


def ssd_reference(xh, Bm, Cm, dt, A):
    """Sequential SSD recurrence (the oracle of ``_ssd_chunked``)."""
    Bsz, S, Ph, hd = xh.shape
    N = Bm.shape[-1]
    xh, Bm, Cm, dt = (t.to(torch.float32) for t in (xh, Bm, Cm, dt))
    h = torch.zeros((Bsz, Ph, hd, N), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t] * A[None, :])
        h = h * da[..., None, None] + torch.einsum(
            "bph,bs->bphs", xh[:, t] * dt[:, t, :, None], Bm[:, t])
        ys.append(torch.einsum("bphs,bs->bph", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def pre_out(p, cfg: ModelConfig, x, cache: SSMCache | None = None):
    """Mamba2 mixer up to (but not including) ``out_proj``.

    Returns (y, new_cache) with y: (B, S, d_inner), the gated, normalized
    scan output that feeds the output projection: the Hessian tap for
    quantizing ``out_proj`` (core/adapters/hybrid.py). The conv and scan
    parameters (conv_w, A_log, dt_bias, D_skip, norm_scale) are not matmul
    weights and stay dense.
    """
    Bsz, S, _ = x.shape
    d_inner, heads, conv_ch = _dims(cfg)
    N, hd, w = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv_width
    proj = cm.matmul(x, p["in_proj"])
    z, xc, Bc, Cc, dt = _split_proj(cfg, proj)
    A = -torch.exp(p["A_log"])  # (P,)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])

    u = torch.cat([xc, Bc, Cc], dim=-1)  # (B,S,conv_ch)
    pad = (cache.conv.to(u.dtype) if cache is not None
           else torch.zeros((Bsz, w - 1, conv_ch), dtype=u.dtype,
                            device=u.device))
    u_pad = torch.cat([pad, u], dim=1)
    new_conv = u_pad[:, -(w - 1):, :]
    conv = F.silu(_causal_conv(u_pad, p["conv_w"], p["conv_b"]))
    xcv, Bcv, Ccv = torch.split(conv, [d_inner, N, N], dim=-1)
    xh = xcv.reshape(Bsz, S, heads, hd)

    if S == 1 and cache is not None:
        # recurrent decode step
        h = cache.h.to(torch.float32)
        dt1 = dt[:, 0]  # (B,P)
        da = torch.exp(dt1 * A[None, :])
        Bx = torch.einsum("bph,bs->bphs", xh[:, 0] * dt1[..., None],
                          Bcv[:, 0])
        h = h * da[..., None, None] + Bx
        y = torch.einsum("bphs,bs->bph", h, Ccv[:, 0])[:, None]
        h_fin = h
    else:
        # chunk-parallel prefill, resuming from the cached state so the
        # engine can feed a prompt in several chunked calls
        y, h_fin = _ssd_chunked(xh, Bcv, Ccv, dt, A, cfg.ssm_chunk,
                                h0=cache.h if cache is not None else None)
    y = y + xh * p["D_skip"][None, None, :, None]
    y = y.reshape(Bsz, S, d_inner)
    y = cm.rmsnorm(y.to(x.dtype) * F.silu(z), p["norm_scale"], cfg.norm_eps)
    new_cache = (SSMCache(h=h_fin, conv=new_conv.to(cache.conv.dtype))
                 if cache is not None else None)
    return y, new_cache


def apply(p, cfg: ModelConfig, x, cache: SSMCache | None = None):
    """Mamba2 mixer. x: (B,S,D). Returns (y, new_cache)."""
    y, new_cache = pre_out(p, cfg, x, cache)
    return cm.matmul(y, p["out_proj"]).to(x.dtype), new_cache
