"""xLSTM blocks (Beck et al. 2024): mLSTM (matrix memory) and sLSTM (scalar
memory) with stabilised exponential gating (port of
``repro/models/xlstm.py``).

  * mLSTM block: x + down( mLSTM_core(up(x)) * silu(up_gate(x)) ), where the
    core keeps a per-head matrix state C (hd x hd), normaliser n and
    stabiliser m, updated one step at a time.
  * sLSTM block: x + core(norm(x)) followed by x + gated_ffn(norm(x)); the
    core has block-diagonal (per-head) recurrent connections.

Both recurrences run in f32 as plain time loops. The reference scans them
with ``lax.scan`` in 64-step chunks whose boundaries it checkpoints for
backpropagation; the chunks change no value, so a flat loop computes the
same thing. The state is O(1) a sequence (``MLSTMCache``, ``SLSTMCache``),
which the serving engine keeps slot-resident.

Under a model axis that divides the heads (``models/parallel``, set by the
sharded train step) each block runs the rank's heads: the mLSTM's q/k/v,
gates and output gate on its heads from the whole up-projection, ``down``
over its rows summed over the axis; the sLSTM's gate columns and
block-diagonal recurrences of its heads, its output gathered whole, and
the FFN's hidden units (when the axis divides them) as ``mlp`` splits
them. ``mlstm_split_modes`` / ``slstm_split_modes`` say how each leaf is
read.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import parallel as par

_M_INIT = -1e30  # the stabiliser's start: any first gate value exceeds it


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMCache(NamedTuple):
    C: torch.Tensor  # (B, H, hd, hd)
    n: torch.Tensor  # (B, H, hd)
    m: torch.Tensor  # (B, H)


def _mlstm_dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    H = cfg.n_heads
    return d_inner, H, d_inner // H


def mlstm_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    D = cfg.d_model
    d_inner, H, _ = _mlstm_dims(cfg)

    def dense(d_in, d_out, scale=None, dt=dtype):
        return cm.dense_init(gen, d_in, d_out, scale=scale, dtype=dt,
                             device=device)

    return {
        "up": dense(D, d_inner),
        "up_gate": dense(D, d_inner),
        "wq": dense(d_inner, d_inner),
        "wk": dense(d_inner, d_inner),
        "wv": dense(d_inner, d_inner),
        "w_i": dense(d_inner, H, scale=0.02, dt=torch.float32),
        "w_f": dense(d_inner, H, scale=0.02, dt=torch.float32),
        "b_i": torch.zeros((H,), dtype=torch.float32, device=device),
        # open forget gates at init
        "b_f": torch.full((H,), 3.0, dtype=torch.float32, device=device),
        "w_o": dense(d_inner, d_inner),
        "down": dense(d_inner, D),
    }


def mlstm_specs(cfg: ModelConfig) -> dict:
    """The reference's sharding specs of an mLSTM core."""
    P = cm.P
    return {"up": P("data", "model"), "up_gate": P("data", "model"),
            "wq": P("data", "model"), "wk": P("data", "model"),
            "wv": P("data", "model"), "w_i": P("data", None),
            "w_f": P("data", None), "b_i": P(None), "b_f": P(None),
            "w_o": P("data", "model"), "down": P("model", "data")}


def mlstm_split_modes(cfg: ModelConfig, axis) -> dict:
    """How a step on ``axis`` reads each leaf of ``mlstm_specs``: with the
    heads split, the columns of the rank's heads of ``up_gate``, q/k/v and
    ``w_o`` and ``down``'s rows (SPLIT); ``up`` whole (its output feeds
    every head: a contiguous block of its columns is no head's), the
    gates' weights and biases whole, sliced to the rank's heads
    (FULL_SUM). Else every leaf whole (FULL)."""
    if axis.units(cfg.n_heads) is None:
        return {k: par.FULL for k in mlstm_specs(cfg)}
    split = ("up_gate", "wq", "wk", "wv", "w_o", "down")
    return {k: par.SPLIT if k in split else par.FULL_SUM
            for k in mlstm_specs(cfg)}


def mlstm_cache(cfg: ModelConfig, batch: int, device=None,
                heads: int | None = None) -> MLSTMCache:
    _, H, hd = _mlstm_dims(cfg)
    H = H if heads is None else heads
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(C=torch.zeros((batch, H, hd, hd), **f32),
                      n=torch.zeros((batch, H, hd), **f32),
                      m=torch.full((batch, H), _M_INIT, **f32))


def _mlstm_core(q, k, v, i_raw, f_raw, state: MLSTMCache):
    """Sequential stabilised mLSTM. q/k/v: (B,S,H,hd); gates: (B,S,H).
    Returns (h (B,S,H,hd) f32, new state)."""
    hd = q.shape[-1]
    k = k / math.sqrt(hd)
    f_log = F.logsigmoid(f_raw.to(torch.float32))
    q, k, v, i_raw = (t.to(torch.float32) for t in (q, k, v, i_raw))
    C, n, m = state
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], i_raw[:, t], f_log[:, t]
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])  # (B,H,hd_v,hd_k)
        n = f_p[..., None] * n + i_p[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                          min=1.0)
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), MLSTMCache(C, n, m)


def mlstm_pre_down(p, cfg: ModelConfig, x, cache: MLSTMCache | None = None):
    """mLSTM block up to (but not including) ``down``.

    Returns (u, h, new_state): u is the up-projected stream feeding the
    q/k/v/o heads, h the gated core output feeding ``down``, the two
    Hessian taps the xLSTM adapter quantizes against (core/adapters/
    recurrent.py). Under a head split, h holds the rank's heads.
    """
    B, S, _ = x.shape
    _, H, hd = _mlstm_dims(cfg)
    heads = slice(None)
    split = par.unit_split(H)
    if split is not None:
        heads, group = split
        x, H = par.enter(x, group), heads.stop - heads.start
    u = cm.matmul(x, p["up"])
    g = cm.matmul(x, p["up_gate"])
    q = cm.matmul(u, p["wq"]).reshape(B, S, H, hd)
    k = cm.matmul(u, p["wk"]).reshape(B, S, H, hd)
    v = cm.matmul(u, p["wv"]).reshape(B, S, H, hd)
    # the gates in f32 (w_i / w_f start f32 and a bf16 train step stores
    # them bf16: the product promotes, as jnp's)
    uf = u.to(torch.float32)
    i_raw = cm.matmul(uf, p["w_i"][:, heads]) + p["b_i"][heads]
    f_raw = cm.matmul(uf, p["w_f"][:, heads]) + p["b_f"][heads]
    state = (cache if cache is not None
             else mlstm_cache(cfg, B, x.device, heads=H))
    h, new_state = _mlstm_core(q, k, v, i_raw, f_raw, state)
    o = torch.sigmoid(cm.matmul(u, p["w_o"]))
    h = (h.reshape(B, S, H * hd).to(x.dtype) * o) * F.silu(g)
    return u, h, new_state


def mlstm_apply(p, cfg: ModelConfig, x, cache: MLSTMCache | None = None):
    _, h, new_state = mlstm_pre_down(p, cfg, x, cache)
    y = cm.matmul(h, p["down"])
    split = par.unit_split(cfg.n_heads)
    if split is not None:
        y = par.reduce(y, split[1])
    return y.to(x.dtype), (new_state if cache is not None else None)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, D)
    n: torch.Tensor  # (B, D)
    h: torch.Tensor  # (B, D)
    m: torch.Tensor  # (B, D)


_GATES = ("z", "i", "f", "o")


def slstm_ffn_dim(cfg: ModelConfig) -> int:
    """The gated FFN's width: proj factor 4/3, rounded to 128 (1,024 at
    d_model 768)."""
    return max(128, int(round(cfg.d_model * 4 / 3 / 128)) * 128)


def slstm_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H

    def dense(d_in, d_out):
        return cm.dense_init(gen, d_in, d_out, dtype=dtype, device=device)

    p = {f"w_{g}": dense(D, D) for g in _GATES}
    # block-diagonal recurrent matrices, per head
    for g in _GATES:
        p[f"r_{g}"] = (torch.randn((H, hd, hd), generator=gen, device=device)
                       / math.sqrt(hd)).to(dtype)
    for g in _GATES:
        p[f"b_{g}"] = torch.full((D,), 3.0 if g == "f" else 0.0, dtype=dtype,
                                 device=device)
    ffdim = slstm_ffn_dim(cfg)
    p["ffn"] = {"w_in": dense(D, ffdim), "w_gate": dense(D, ffdim),
                "w_out": dense(ffdim, D)}
    p["ffn_norm"] = torch.ones((D,), dtype=dtype, device=device)
    return p


def slstm_specs(cfg: ModelConfig) -> dict:
    """The reference's sharding specs of an sLSTM core and its FFN."""
    P = cm.P
    s = {f"w_{g}": P("data", "model") for g in _GATES}
    s.update({f"r_{g}": P("model", None, None) for g in _GATES})
    s.update({f"b_{g}": P("model") for g in _GATES})
    s["ffn"] = {"w_in": P("data", "model"), "w_gate": P("data", "model"),
                "w_out": P("model", "data")}
    s["ffn_norm"] = P(None)
    return s


def slstm_split_modes(cfg: ModelConfig, axis) -> dict:
    """How a step on ``axis`` reads each leaf of ``slstm_specs``: the gate
    columns, biases and block-diagonal recurrences of the rank's heads
    (SPLIT) when the axis divides the heads, the FFN's hidden units
    (SPLIT) when it divides them; else whole (FULL)."""
    core = par.SPLIT if axis.units(cfg.n_heads) is not None else par.FULL
    ffn = (par.SPLIT if axis.units(slstm_ffn_dim(cfg)) is not None
           else par.FULL)
    modes = {k: core for k in slstm_specs(cfg) if k not in ("ffn",
                                                            "ffn_norm")}
    modes["ffn"] = {k: ffn for k in ("w_in", "w_gate", "w_out")}
    modes["ffn_norm"] = par.FULL
    return modes


def slstm_cache(cfg: ModelConfig, batch: int, device=None,
                width: int | None = None) -> SLSTMCache:
    D = cfg.d_model if width is None else width
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMCache(c=torch.zeros((batch, D), **f32),
                      n=torch.zeros((batch, D), **f32),
                      h=torch.zeros((batch, D), **f32),
                      m=torch.full((batch, D), _M_INIT, **f32))


def _blockdiag(h, R):
    """h: (B, D) -> per-head matmul with R: (H, hd, hd)."""
    B = h.shape[0]
    H, hd, _ = R.shape
    return torch.einsum("bhi,hij->bhj", h.reshape(B, H, hd),
                        R.to(h.dtype)).reshape(B, H * hd)


def slstm_apply(p, cfg: ModelConfig, x, cache: SLSTMCache | None = None):
    """The sLSTM core over x (B, S, D); under a head split the rank runs
    its heads' columns and the output is gathered whole."""
    B, S, D = x.shape
    split = par.unit_split(cfg.n_heads)
    if split is not None:
        heads, group = split
        hd = D // cfg.n_heads
        cols = slice(heads.start * hd, heads.stop * hd)
        x = par.enter(x, group)
    pre = {g: cm.matmul(x, p[f"w_{g}"]) + p[f"b_{g}"] for g in _GATES}
    width = pre["z"].shape[-1]
    c, n, h, m = cache if cache is not None else slstm_cache(
        cfg, B, x.device, width=width)
    hs = []
    for t in range(S):
        z_x, i_x, f_x, o_x = (pre[g][:, t].to(torch.float32) for g in _GATES)
        z = torch.tanh(z_x + _blockdiag(h, p["r_z"]))
        it = i_x + _blockdiag(h, p["r_i"])
        ft = F.logsigmoid(f_x + _blockdiag(h, p["r_f"]))
        ot = torch.sigmoid(o_x + _blockdiag(h, p["r_o"]))
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        h = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)  # (B,S,D)
    if split is not None:
        y = par.gather_units(y, cols, D, group)
    new_cache = SLSTMCache(c, n, h, m) if cache is not None else None
    return y, new_cache


def slstm_ffn_pre_out(p, cfg: ModelConfig, x):
    """Gated-FFN hidden state entering ``ffn.w_out`` (Hessian tap)."""
    return (F.silu(cm.matmul(x, p["ffn"]["w_gate"]))
            * cm.matmul(x, p["ffn"]["w_in"]))


def slstm_ffn(p, cfg: ModelConfig, x):
    """The gated FFN; under a split of its hidden units the rank's, its
    output summed over the model axis."""
    split = par.unit_split(slstm_ffn_dim(cfg))
    if split is None:
        h = slstm_ffn_pre_out(p, cfg, x)
        return cm.matmul(h, p["ffn"]["w_out"]).to(x.dtype)
    h = slstm_ffn_pre_out(p, cfg, par.enter(x, split[1]))
    return par.reduce(cm.matmul(h, p["ffn"]["w_out"]),
                      split[1]).to(x.dtype)
