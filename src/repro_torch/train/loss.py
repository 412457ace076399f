"""Next-token cross-entropy with z-loss, computed in fp32 (port of
``repro/train/loss.py``). ``next_token_loss_split`` is the same loss over
logits whose vocabulary is split over a model axis (the reference
constrains the logits to ``P(dp, None, "model")`` and lets GSPMD reduce;
here the log-sum-exp and the target's logit are summed over the axis
explicitly)."""
from __future__ import annotations

import torch


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    z_loss: float = 1e-4):
    """logits: (B, S, V) fp32; tokens: (B, S). Predict token[t+1] from t.

    Returns (loss, metrics). Final position has no target and is masked.
    """
    S = logits.shape[1]
    targets = tokens[:, 1:].long()
    lg = logits[:, : S - 1]
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, targets[..., None])[..., 0]
    nll = lse - picked
    loss = torch.mean(nll + z_loss * torch.square(lse))
    return loss, {
        "nll": torch.mean(nll),
        "ppl_proxy": torch.exp(torch.clamp(torch.mean(nll), 0, 20.0)),
    }


def next_token_loss_split(logits: torch.Tensor, tokens: torch.Tensor,
                          lo: int, group, z_loss: float = 1e-4):
    """``next_token_loss`` of logits (B, S, V_local) f32 holding vocabulary
    columns [lo, lo + V_local) of every rank of ``group`` (a model axis,
    on which the loss is the same on every rank)."""
    import torch.distributed as dist

    from repro_torch.models import parallel as par

    S, V = logits.shape[1], logits.shape[2]
    targets = tokens[:, 1:].long()
    lg = logits[:, : S - 1]
    mx = par.all_reduce(lg.detach().amax(-1), group, dist.ReduceOp.MAX)
    lse = mx + torch.log(par.reduce(torch.exp(lg - mx[..., None]).sum(-1),
                                    group))
    local = targets - lo
    inside = (local >= 0) & (local < V)
    mine = torch.gather(lg, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    picked = par.reduce(torch.where(inside, mine, torch.zeros_like(mine)),
                        group)
    nll = lse - picked
    loss = torch.mean(nll + z_loss * torch.square(lse))
    return loss, {
        "nll": torch.mean(nll),
        "ppl_proxy": torch.exp(torch.clamp(torch.mean(nll), 0, 20.0)),
    }


@torch.no_grad()
def perplexity(model, params, tokens: torch.Tensor, batch_extra=None) -> float:
    """Eval-time token perplexity of a (possibly quantized) model."""
    batch = {"tokens": tokens}
    if batch_extra:
        batch.update(batch_extra)
    logits, _, _ = model.forward(params, batch)
    S = tokens.shape[1]
    logits = logits[:, -S:, :]
    _, metrics = next_token_loss(logits.to(torch.float32), tokens, z_loss=0.0)
    return float(torch.exp(metrics["nll"]))
