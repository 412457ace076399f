"""Mixture-of-Experts layer with capacity-based scatter dispatch (port of
``repro/models/moe.py``).

Expert weights carry a leading ``n_experts`` axis: ``w_in`` / ``w_gate``
(E, D, F) and ``w_out`` (E, F, D), dense tensors or stacked VQ leaves
(core/vq_linear). The router (D, E) stays f32 whatever the model's dtype.
Tokens are scattered into a (B, E, C, D) buffer, the experts run as one
batched matmul a weight (``common.expert_matmul``: one ``vq_dequant_matmul``
launch a stack for fused leaves) and results are gathered back with the
top-k gate weights.

Capacity C = ceil(S * top_k / E * capacity_factor), rounded up to 8 (at
least 8), where S is the length of the sequence the forward sees (the
padded chunk under the engine's ``pad_prefill``). Slots are assigned per
batch row by an exclusive cumsum over (token, k) in order; a (token, k)
past C is dropped to the scratch row C and its gate weight zeroed, so the
kept gates of a token need not sum to one (Switch/GShard semantics). The
Shazeer load-balancing loss is returned beside the output.

``route`` is the one place tokens are routed (``apply`` and
``expert_hessians`` look it up in this module's namespace at each call),
so a caller can replace ``moe.route``, e.g. to replay one forward's expert
choices in another.

Expert parallelism (``_apply_ep``, the reference's shard_map path): under a
model axis (``models/parallel``, set by the sharded train and serving
steps) whose size tp > 1 divides n_experts, ``apply`` runs ``_apply_ep``
(a packed model's fused VQ stacks through ``_experts``, one grouped
``vq_dequant_matmul`` launch a stack; dense stacks through einsums):
every model rank routes
its data rank's tokens (replicated over the model axis) with the whole
router, computes the (token, k) pairs of its own E / tp experts, and the
partial outputs are summed over the model axis. ``_apply_ep.calls``
counts its calls (a checkpointed block's recompute included).
``_apply_ep_plain`` is the same arithmetic in one process, a loop over
the shards. The EP path is not the single-device path, and matches the
reference's, not ``apply``'s dispatch:

* capacity is ``capacity(S, cfg)`` a row, but the slot cumsum runs over
  all of a rank's Bl * S * K local (token, k) pairs in order, not a batch
  row at a time, so it drops more than ``apply`` once Bl > 1;
* a (token, k) that is not the shard's goes to the scratch expert
  E / tp (never kept);
* the expert weights are cast to x's dtype before the einsums;
* y is summed over the model axis;
* aux is the mean over the data ranks of each rank's own (one block of
  rows each; the reference's pmean when the batch divides the data axis).

Under a data axis the dispatch below averages the load-balancing means
over the data ranks, so aux is the whole batch's, as GSPMD's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import vq_linear as vql_mod
from repro_torch.models import common as cm
from repro_torch.models import parallel as par


def init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
         device=None) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": (torch.randn((D, E), generator=gen, device=device)
                   * 0.02).to(torch.float32),
        "w_in": (torch.randn((E, D, Fd), generator=gen, device=device)
                 / math.sqrt(D)).to(dtype),
        "w_out": (torch.randn((E, Fd, D), generator=gen, device=device)
                  / math.sqrt(Fd)).to(dtype),
    }
    if cm.is_gated(cfg.activation):
        p["w_gate"] = (torch.randn((E, D, Fd), generator=gen, device=device)
                       / math.sqrt(D)).to(dtype)
    return p


def specs(cfg: ModelConfig) -> dict:
    """The reference's sharding specs: experts over the model axis (the
    expert-parallel layout), the router's expert columns too."""
    s = {"router": cm.P(None, "model"),
         "w_in": cm.P("model", "data", None),
         "w_out": cm.P("model", None, "data")}
    if cm.is_gated(cfg.activation):
        s["w_gate"] = cm.P("model", "data", None)
    return s


def split_modes(cfg: ModelConfig, axis) -> dict:
    """How a step on ``axis`` (``parallel.ModelAxis``) reads each leaf of
    ``specs``: under expert parallelism the rank's expert stacks (SPLIT)
    and the router whole (FULL: every rank routes all its tokens), else
    every leaf whole."""
    ep = axis.experts(cfg)
    return {k: par.SPLIT if ep and k != "router" else par.FULL
            for k in specs(cfg)}


def capacity(tokens_per_row: int, cfg: ModelConfig) -> int:
    c = int(tokens_per_row * cfg.n_experts_active / cfg.n_experts
            * cfg.moe_capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """(probs (..., E), top-k probabilities (..., k), expert ids (..., k))
    of every token of x (..., D): an f32 softmax over the router logits,
    the k most probable experts in descending order."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, k, dim=-1)
    return probs, gate, ids


def _experts(p, cfg: ModelConfig, h):
    """The expert FFN on a (..., E, C, D) buffer: act(h @ w_gate) * (h @
    w_in) @ w_out for gated activations, act(h @ w_in) @ w_out otherwise."""
    act = cm.act_fn(cfg.activation)
    u = cm.expert_matmul(h, p["w_in"])
    if cm.is_gated(cfg.activation):
        u = act(cm.expert_matmul(h, p["w_gate"])) * u
    else:
        u = act(u)
    return cm.expert_matmul(u, p["w_out"])


def dispatch(expert_ids: torch.Tensor, n_experts: int, C: int):
    """Per-row slots of (B, S, K) expert choices: (slot (B, S, K), keep
    (B, S, K)). A (token, k) takes the next free slot of its expert's
    queue in its row, in (token, k) order; those past C are not kept."""
    B, S, K = expert_ids.shape
    onehot = F.one_hot(expert_ids, n_experts).reshape(B, S * K, n_experts)
    pos = torch.cumsum(onehot, dim=1) - onehot
    slot = (pos * onehot).sum(-1).reshape(B, S, K)
    return slot, slot < C


def apply(p, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux_loss f32 scalar).
    Under a model axis that splits the experts, ``_apply_ep``."""
    axis = par.current()
    if axis is not None and axis.experts(cfg):
        y, aux, _ = _apply_ep(p, cfg, x, axis)
        return y, aux
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.n_experts_active
    C = capacity(S, cfg)

    probs, gate_vals, expert_ids = route(x, p["router"], K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    slot, keep = dispatch(expert_ids, E, C)

    eid = expert_ids.reshape(B, S * K)
    sid = torch.where(keep, slot, C).reshape(B, S * K)
    bid = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    # dropped (token, k) all land in the scratch row C, which is discarded
    buf = torch.zeros((B, E, C + 1, D), dtype=x.dtype, device=x.device)
    buf[bid, eid, sid] = x.repeat_interleave(K, dim=1)
    out = _experts(p, cfg, buf[:, :, :C])  # (B, E, C, D)

    out_pad = torch.cat([out, out.new_zeros((B, E, 1, D))], dim=2)
    y_slots = out_pad[bid, eid, sid].reshape(B, S, K, D)
    w = (gate_vals * keep.to(gate_vals.dtype)).to(x.dtype)
    y = (y_slots * w[..., None]).sum(2)

    # Shazeer load-balance aux loss, over the whole batch
    me = par.data_mean(probs.reshape(-1, E).mean(0))
    ce = par.data_mean(F.one_hot(expert_ids[..., 0].reshape(-1), E).to(
        torch.float32).mean(0))
    aux = cfg.moe_aux_loss_coef * E * torch.sum(me * ce)
    return y.to(x.dtype), aux


def _ep_shard(p, cfg: ModelConfig, x, lo: int, n_local: int, C: int,
              enter=None):
    """One shard's expert-parallel dispatch (the reference's ``local_fn``):
    x (Bl, S, D) the data rank's rows, experts [lo, lo + n_local) this
    shard's (``p``'s stacks: this shard's experts only). Returns (y, the
    shard's part of the output, (Bl, S, D); aux; keep (Bl, S, K), the
    shard's kept pairs). ``enter`` marks the two tensors whose gradient
    the shard holds a part of (the tokens into its experts, the gate
    weights of its pairs): identity in one process."""
    enter = enter or (lambda t: t)
    Bl, S, D = x.shape
    E, K = cfg.n_experts, cfg.n_experts_active
    xf = x.reshape(Bl * S, D)
    probs, gate, ids = route(xf, p["router"], K)       # (N, E), (N, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    local = ids - lo
    mine = (local >= 0) & (local < n_local)
    eid = torch.where(mine, local, n_local).reshape(-1)  # n_local: scratch
    # slot within each local expert queue: exclusive cumsum over the N * K
    # local (token, k) pairs in order, across the rows
    oh = F.one_hot(eid, n_local + 1)
    slot = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)
    keep = (slot < C) & mine.reshape(-1)
    sid = torch.where(keep, slot, C)

    buf = x.new_zeros((n_local + 1, C + 1, D))
    buf[eid, sid] = enter(xf).repeat_interleave(K, dim=0)
    hbuf = buf[:n_local, :C]
    if isinstance(p["w_in"], vql_mod.FusedVQLinear):
        out = _experts(p, cfg, hbuf)  # a packed model's stacks, served
    else:
        act = cm.act_fn(cfg.activation)
        h = torch.einsum("ecd,edf->ecf", hbuf, p["w_in"].to(x.dtype))
        if "w_gate" in p:
            g = torch.einsum("ecd,edf->ecf", hbuf, p["w_gate"].to(x.dtype))
            h = act(g) * h
        else:
            h = act(h)
        out = torch.einsum("ecf,efd->ecd", h, p["w_out"].to(x.dtype))
    out_pad = F.pad(out, (0, 0, 0, 1, 0, 1))            # (n_local+1, C+1, D)
    y_slots = out_pad[eid, sid].reshape(Bl * S, K, D)
    w = (enter(gate) * keep.reshape(Bl * S, K)).to(x.dtype)
    y = (y_slots * w[..., None]).sum(1).reshape(Bl, S, D)

    me = probs.mean(0)
    ce = F.one_hot(ids[:, 0], E).to(torch.float32).mean(0)
    aux = cfg.moe_aux_loss_coef * E * torch.sum(me * ce)
    return y, aux, keep.reshape(Bl, S, K)


def _apply_ep(p, cfg: ModelConfig, x, axis):
    """Expert parallelism on a ``parallel.ModelAxis`` (see the module
    docstring): x (Bl, S, D) the data rank's rows, ``p``'s expert stacks
    this model rank's E / tp experts, the router whole. Returns (y in x's
    dtype, aux, keep (Bl, S, K): this rank's kept pairs)."""
    _apply_ep.calls += 1
    n_local = cfg.n_experts // axis.tp
    group = axis.model_group
    y, aux, keep = _ep_shard(p, cfg, x, axis.model_rank * n_local, n_local,
                             capacity(x.shape[1], cfg),
                             enter=lambda t: par.enter(t, group))
    y = par.reduce(y, group)
    aux = axis.data_mean(aux)
    return y.to(x.dtype), aux, keep


_apply_ep.calls = 0


def _apply_ep_plain(p, cfg: ModelConfig, x, tp: int, dp: int = 1):
    """``_apply_ep``'s arithmetic in one process: x (B, S, D) the whole
    batch and ``p`` whole; the rows in ``dp`` blocks (one when dp does not
    divide B, as the reference replicates such a batch), each block's
    dispatch run for every one of ``tp`` shards and summed. Returns (y,
    aux: the blocks' mean, keep (tp, B, S, K): each shard's kept pairs)."""
    B, S, _ = x.shape
    blocks = dp if B % dp == 0 else 1
    rows, n_local = B // blocks, cfg.n_experts // tp
    C = capacity(S, cfg)
    ys, auxes, keeps = [], [], []
    for b in range(blocks):
        xb = x[b * rows:(b + 1) * rows]
        parts = []
        for s in range(tp):
            ps = {k: (v if k == "router" else v[s * n_local:(s + 1) * n_local])
                  for k, v in p.items()}
            parts.append(_ep_shard(ps, cfg, xb, s * n_local, n_local, C))
        y = parts[0][0]
        for part in parts[1:]:
            y = y + part[0]
        ys.append(y)
        auxes.append(parts[0][1])
        keeps.append(torch.stack([part[2] for part in parts]))
    aux = torch.stack(auxes).sum() / blocks
    return torch.cat(ys).to(x.dtype), aux, torch.cat(keeps, dim=1)


def expert_hessians(p, cfg: ModelConfig, x: torch.Tensor,
                    diag_only: bool = False):
    """Per-expert GPTVQ Hessian statistics for one calibration chunk.

    x: (B, S, D) layer inputs. Routes every token with the layer's router
    (top-k, no capacity drop: calibration wants the true input
    distribution) and accumulates, in f32,

      * input side  H_e = sum over tokens routed to e of x x^T    (E, D, D)
      * output side H_e = sum over tokens routed to e of h_e h_e^T (E, F, F)

    with h_e the expert's activated hidden state. Returns ((Hin, n),
    (Hout, n)), n the (E,) f32 raw routed-token counts of this chunk (the
    consumer clamps once, after summing chunks). ``diag_only``: only the
    diagonals, (E, D) / (E, F) stacks.

    The routed tokens of each expert are gathered into an (E, n_max, D)
    buffer (zero rows past an expert's count), so the products cost the
    routed tokens, not all N of them a expert as the reference's masked
    einsums do; the sums are the same."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.n_experts_active
    xf = x.reshape(B * S, D).to(torch.float32)
    _, _, eids = route(xf, p["router"], K)
    n = torch.bincount(eids.reshape(-1), minlength=E).to(torch.float32)
    # routed-token buffer: a token appears once under each of its experts
    slot, _ = dispatch(eids[None], E, 0)
    n_max = max(int(n.max()), 1)
    buf = xf.new_zeros((E, n_max, D))
    tok = torch.arange(B * S, device=x.device).repeat_interleave(K)
    buf[eids.reshape(-1), slot.reshape(-1)] = xf[tok]
    w32 = {k: v.to(torch.float32) for k, v in p.items()
           if k in ("w_in", "w_gate")}
    act = cm.act_fn(cfg.activation)
    h = torch.bmm(buf, w32["w_in"])
    if cm.is_gated(cfg.activation):
        h = act(torch.bmm(buf, w32["w_gate"])) * h
    else:
        h = act(h)
    # rows past an expert's count are zero in buf; act(0) * 0 is zero for
    # gated activations, act(0) need not be for the others: mask them
    live = (torch.arange(n_max, device=x.device)[None, :]
            < n[:, None]).to(torch.float32)
    h = h * live[..., None]
    if diag_only:
        return ((buf * buf).sum(1), n), ((h * h).sum(1), n)
    Hin = torch.bmm(buf.transpose(1, 2), buf)
    Hout = torch.bmm(h.transpose(1, 2), h)
    return (Hin, n), (Hout, n)
