"""Token sampling: greedy / temperature / top-k / top-p (port of
``repro/serve/sampling.py``).

``temperature`` may be a Python scalar or a per-row (B,) tensor: the
batched engine mixes requests with different temperatures in one decode
tick. Rows with temperature <= 0 are greedy (argmax, exact). Draws come
from an explicit ``torch.Generator`` (Gumbel-max, as
``jax.random.categorical``); the two frameworks' random bits differ, so
sampled tokens agree with the reference in distribution, not in value.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row: argmax(logits + Gumbel noise)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(logits.to(torch.float32) + gumbel, dim=-1)


def _sample_scaled(gen, logits: torch.Tensor, top_k: int, top_p: float):
    """Categorical draw from already temperature-scaled logits."""
    if top_k > 0:
        # rank-based cut (exactly min(top_k, V) survivors; stable ranks, so
        # ties break toward the lowest vocab index)
        k = min(top_k, logits.shape[-1])
        order = torch.argsort(-logits, dim=-1, stable=True)
        ranks = torch.argsort(order, dim=-1, stable=True)
        logits = torch.where(ranks < k, logits,
                             torch.full_like(logits, NEG_INF))
    if top_p > 0.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, NEG_INF), logits)
    return _categorical(gen, logits).to(torch.int32)


def sample(gen: torch.Generator, logits: torch.Tensor, *, temperature=1.0,
           top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """logits (B, V); temperature scalar or (B,) -> (B,) int32."""
    if isinstance(temperature, (int, float)):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return _sample_scaled(gen, logits / temperature, top_k, top_p)
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device)
    if t.dim() == 0:
        t = t[None]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    safe_t = torch.where(t > 0.0, t, torch.ones_like(t))
    sampled = _sample_scaled(gen, logits / safe_t[:, None], top_k, top_p)
    return torch.where(t > 0.0, sampled, greedy)
